"""Versioned KV store with watches: the cluster control plane.

Reference parity: `src/cluster/kv` (`kv.Store`, `types.go:123`: Get/Set/
SetIfNotExists/CheckAndSet with monotonically versioned values, watchable
keys) and its in-memory fake (`kv/mem`) that backs every integration test.
The production reference binds this to etcd; the TPU framework's control
plane is host-side and deliberately etcd-compatible in shape — an etcd
binding would implement this same interface.  File persistence gives
single-host durability (placements/rules/flush-times survive restarts).

The port's copy of ``m3_tpu/cluster/kv.py`` (``KVStore``,
``LeaderElection``), for the aggregator's flush manager.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List


@dataclass(frozen=True)
class VersionedValue:
    version: int
    data: bytes


class KVStore:
    """In-memory versioned KV with watches; optionally file-backed."""

    def __init__(self, root: str | None = None):
        self._lock = threading.RLock()
        self._data: Dict[str, VersionedValue] = {}
        self._watchers: Dict[str, List[Callable[[VersionedValue], None]]] = {}
        self._path = Path(root) / "kv.json" if root else None
        if self._path and self._path.exists():
            raw = json.loads(self._path.read_text())
            self._data = {
                k: VersionedValue(v["version"], bytes.fromhex(v["data"]))
                for k, v in raw.items()
            }

    def _persist(self) -> None:
        if self._path is None:
            return
        tmp = self._path.with_suffix(".tmp")
        tmp.write_text(json.dumps({
            k: {"version": v.version, "data": v.data.hex()}
            for k, v in self._data.items()
        }))
        tmp.replace(self._path)

    def get(self, key: str) -> VersionedValue | None:
        with self._lock:
            return self._data.get(key)

    def set(self, key: str, data: bytes) -> int:
        """Unconditional set; returns the new version."""
        with self._lock:
            cur = self._data.get(key)
            v = (cur.version if cur else 0) + 1
            self._data[key] = VersionedValue(v, data)
            self._persist()
            self._notify(key)
            return v

    def set_if_not_exists(self, key: str, data: bytes) -> int:
        with self._lock:
            if key in self._data:
                raise KeyError(f"{key} already exists")
            return self.set(key, data)

    def check_and_set(self, key: str, expect_version: int, data: bytes) -> int:
        """CAS (reference kv.Store.CheckAndSet): version 0 = must not
        exist."""
        with self._lock:
            cur = self._data.get(key)
            cur_v = cur.version if cur else 0
            if cur_v != expect_version:
                raise ValueError(
                    f"version conflict on {key}: have {cur_v}, want {expect_version}"
                )
            return self.set(key, data)

    def delete(self, key: str) -> bool:
        """Returns whether the key existed."""
        with self._lock:
            existed = self._data.pop(key, None) is not None
            self._persist()
            return existed

    def keys(self) -> list[str]:
        with self._lock:
            return sorted(self._data)

    def watch(self, key: str, fn: Callable[[VersionedValue], None]) -> None:
        """Register a watcher; fired inline on every set (the reference
        delivers via watch channels)."""
        with self._lock:
            self._watchers.setdefault(key, []).append(fn)
            cur = self._data.get(key)
        if cur is not None:
            fn(cur)

    def unwatch(self, key: str, fn: Callable[[VersionedValue], None]) -> None:
        """Remove a watcher registered with watch() (no-op when absent)
        so short-lived watchers don't accumulate forever."""
        with self._lock:
            fns = self._watchers.get(key)
            if fns and fn in fns:
                fns.remove(fn)

    def _notify(self, key: str) -> None:
        cur = self._data[key]
        # Snapshot: a callback may unwatch() mid-delivery (the list is
        # shrinkable now), and mutating the live list would skip the
        # next watcher's notification.
        for fn in list(self._watchers.get(key, ())):
            fn(cur)


class LeaderElection:
    """Leader election over the KV store's CAS (reference
    `src/cluster/services/leader/client.go:32-70`, which campaigns via
    etcd concurrency.Election; same protocol shape: the leader key holds
    the leader's ID at a version, resign deletes it).

    With ``ttl_nanos`` set, the leadership is a *lease* (etcd's session
    TTL): the record carries an expiry, ``campaign(now)`` renews it for
    the incumbent, and any candidate may take over an expired lease via
    CAS — so a crashed leader is superseded after one TTL, the failover
    behavior `election_mgr.go` gets from etcd sessions.  Without a TTL
    the legacy hold-until-resign behavior is preserved.
    """

    def __init__(
        self,
        kv: KVStore,
        electionid: str,
        instance_id: str,
        ttl_nanos: int | None = None,
    ):
        self.kv = kv
        self.key = f"_election/{electionid}"
        self.instance_id = instance_id
        self.ttl_nanos = ttl_nanos

    def _record(self, now_nanos: int | None):
        cur = self.kv.get(self.key)
        if cur is None:
            return None, 0
        try:
            rec = json.loads(cur.data)
            holder, expires = rec["id"], rec.get("expires")
        except (ValueError, KeyError, TypeError):
            holder, expires = cur.data.decode(), None  # legacy raw-ID record
        if (
            expires is not None
            and now_nanos is not None
            and expires <= now_nanos
        ):
            return None, cur.version  # lease expired: claimable via CAS
        return holder, cur.version

    def _payload(self, now_nanos: int | None) -> bytes:
        if self.ttl_nanos is None:
            return self.instance_id.encode()
        return json.dumps(
            {"id": self.instance_id, "expires": now_nanos + self.ttl_nanos}
        ).encode()

    def _require_now(self, now_nanos: int | None) -> None:
        # A TTL election silently degrading to a never-expiring lease on a
        # legacy no-arg call would defeat failover — fail loudly instead.
        if self.ttl_nanos is not None and now_nanos is None:
            raise ValueError("ttl_nanos is set: pass now_nanos")

    def campaign(self, now_nanos: int | None = None) -> bool:
        """Try to become (or renew being) leader."""
        self._require_now(now_nanos)
        holder, version = self._record(now_nanos)
        payload = self._payload(now_nanos)
        if holder == self.instance_id and self.ttl_nanos is None:
            return True
        if holder is not None and holder != self.instance_id:
            return False
        try:
            if version == 0:
                self.kv.set_if_not_exists(self.key, payload)
            else:
                self.kv.check_and_set(self.key, version, payload)
            return True
        except (KeyError, ValueError):
            # Lost the CAS race; we're leader only if the winner was us.
            holder, _ = self._record(now_nanos)
            return holder == self.instance_id

    def leader(self, now_nanos: int | None = None) -> str | None:
        self._require_now(now_nanos)
        holder, _ = self._record(now_nanos)
        return holder

    def is_leader(self, now_nanos: int | None = None) -> bool:
        return self.leader(now_nanos) == self.instance_id

    def resign(self) -> None:
        holder, _ = self._record(None)
        if holder == self.instance_id:
            self.kv.delete(self.key)
