"""Dynamic namespaces: KV-watched namespace metadata.  The port's
counterpart of ``m3_tpu/cluster/namespace_registry.py`` (the same KV
document), over the port's ``cluster/kv.py``.

Equivalent of the reference's dynamic namespace registry
(`src/dbnode/namespace/dynamic.go` — namespaces live in KV; dbnode
watches and adds/readies them without restart; the coordinator's
database-create admin API writes them).  A NamespaceRegistry owns the
KV document, attach() wires a live Database so new namespaces
materialize as they are registered.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass

from m3_tpu_torch.cluster.kv import KVStore

KEY = "namespaces"


@dataclass(frozen=True)
class NamespaceMeta:
    """The KV form (namespace/options.go essentials)."""

    name: str
    retention_nanos: int = 48 * 3600 * 10**9
    block_size_nanos: int = 2 * 3600 * 10**9
    buffer_past_nanos: int = 10 * 60 * 10**9
    buffer_future_nanos: int = 2 * 60 * 10**9
    cold_writes_enabled: bool = True
    num_shards: int = 4


def _encode(metas: dict[str, NamespaceMeta]) -> bytes:
    return json.dumps({n: asdict(m) for n, m in sorted(metas.items())}).encode()


def _decode(raw: bytes) -> dict[str, NamespaceMeta]:
    return {n: NamespaceMeta(**d) for n, d in json.loads(raw).items()}


class NamespaceRegistry:
    def __init__(self, kv: KVStore):
        self.kv = kv
        self._dbs: list = []

    # -- CRUD (the coordinator admin API's storage) ------------------------

    def all(self) -> dict[str, NamespaceMeta]:
        vv = self.kv.get(KEY)
        return _decode(vv.data) if vv else {}

    def _cas_update(self, mutate) -> bool:
        """CAS-loop read-modify-write: concurrent admin requests must
        not lose each other's namespaces (PlacementService.set pattern)."""
        for _ in range(16):
            vv = self.kv.get(KEY)
            metas = _decode(vv.data) if vv else {}
            out = mutate(metas)
            if out is None:
                return False  # mutate declined (no-op)
            try:
                self.kv.check_and_set(KEY, vv.version if vv else 0,
                                      _encode(out))
                return True
            except ValueError:
                continue  # raced another writer; retry on fresh state
        raise RuntimeError("namespace registry CAS contention")

    def add(self, meta: NamespaceMeta) -> None:
        def mutate(metas):
            if meta.name in metas:
                raise ValueError(f"namespace {meta.name} exists")
            metas[meta.name] = meta
            return metas
        self._cas_update(mutate)

    def remove(self, name: str) -> bool:
        def mutate(metas):
            if name not in metas:
                return None
            del metas[name]
            return metas
        return self._cas_update(mutate)

    # -- dynamic attach (dbnode namespace watch) ---------------------------

    def attach(self, db) -> None:
        """Materialize current + future namespaces on a live Database
        (dynamic.go's watch loop).  Removal does NOT drop data — the
        reference also keeps data until cleanup policies apply."""
        self._dbs.append(db)
        self.kv.watch(KEY, lambda vv: self._sync(vv))
        vv = self.kv.get(KEY)
        if vv is not None:
            self._sync(vv)

    def _sync(self, vv) -> None:
        from m3_tpu_torch.storage.database import NamespaceOptions

        try:
            metas = _decode(vv.data)
        except (ValueError, TypeError):
            return
        for db in self._dbs:
            for name, m in metas.items():
                if name not in db.namespaces:
                    db.ensure_namespace(name, NamespaceOptions(
                        block_size_nanos=m.block_size_nanos,
                        retention_nanos=m.retention_nanos,
                        buffer_past_nanos=m.buffer_past_nanos,
                        buffer_future_nanos=m.buffer_future_nanos,
                        cold_writes_enabled=m.cold_writes_enabled,
                        num_shards=m.num_shards,
                    ))
