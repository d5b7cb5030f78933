"""Storage adapter: PromQL selectors → index query → raw series blocks.

Equivalent of `src/query/storage/m3` (FetchCompressed
`m3/storage.go:215-225`: label matchers → index FetchTagged → decoded
series) without the network hop — the engine and the database share a
process, as in the reference's embedded coordinator mode.

The counterpart of ``m3_tpu/query/storage_adapter.py``.  The engine over
either storage runs on its own device (``Engine(DatabaseStorage(db),
device=...)``, ``Engine(SessionStorage(session), device=...)``): the
adapters hand it host lists, as the database and the session read them.
"""

from __future__ import annotations

import contextlib

from m3_tpu_torch.index.search import (
    All, Conjunction, Negation, Query, Regexp, Term,
)
from m3_tpu_torch.query.block import RawBlock, SeriesMeta
from m3_tpu_torch.query.promql import LabelMatcher
from m3_tpu_torch.storage.database import Database, ShardNotOwnedError
from m3_tpu_torch.x import deadline as xdeadline
from m3_tpu_torch.x import fault

# reusable no-op scope for the unbound-deadline fast path
_NULL_PHASE = contextlib.nullcontext()


def matchers_to_query(name: bytes | None,
                      matchers: tuple[LabelMatcher, ...]) -> Query:
    """Label matchers → boolean index query (reference storage/m3
    FetchOptionsToM3Options + idx query conversion)."""
    parts: list[Query] = []
    if name is not None:
        parts.append(Term(b"__name__", name))
    for m in matchers:
        if m.op == "=":
            parts.append(Term(m.name, m.value))
        elif m.op == "!=":
            parts.append(Negation(Term(m.name, m.value)))
        elif m.op == "=~":
            parts.append(Regexp(m.name, m.value))
        elif m.op == "!~":
            parts.append(Negation(Regexp(m.name, m.value)))
        else:
            raise ValueError(f"bad matcher op {m.op}")
    if not parts:
        return All()
    if len(parts) == 1 and not isinstance(parts[0], Negation):
        return parts[0]
    return Conjunction(*parts)


class DatabaseStorage:
    """Engine Storage implementation over one Database namespace."""

    def __init__(self, db: Database, namespace: str = "default"):
        self.db = db
        self.namespace = namespace

    def fetch_raw(self, name, matchers, start_nanos, end_nanos) -> RawBlock:
        # The read path's deterministic injection point: delay = slow
        # storage/peer (the overload dtest arms this on one replica),
        # error = failed fetch.  Fired here so BOTH local engine reads
        # and federation-served remote fetches cross one boundary.
        fault.fire("query.fetch")
        dl = xdeadline.current()
        with (dl.phase("fetch") if dl is not None
              else _NULL_PHASE):
            return self._fetch_raw(name, matchers, start_nanos, end_nanos)

    def _fetch_raw(self, name, matchers, start_nanos, end_nanos) -> RawBlock:
        q = matchers_to_query(name, matchers)
        docs = self.db.query_ids(self.namespace, q, start_nanos, end_nanos)
        docs.sort(key=lambda d: d.id)
        pts = []
        metas = []
        for i, d in enumerate(docs):
            if i % 64 == 0:  # per-series read loop: cancellable
                xdeadline.check_current("fetch series")
            try:
                pts.append(
                    self.db.read(self.namespace, d.id, start_nanos, end_nanos))
            except ShardNotOwnedError:
                # "Reads answer only owned shards": the index still
                # knows series whose shard the placement moved away —
                # a local query answers from what this node owns, and
                # the cluster-level union comes from the session's
                # replica fan-out, not from this handle.
                continue
            metas.append(SeriesMeta(tuple(sorted(d.tags().items()))))
        return RawBlock.from_lists(pts, metas)


class SessionStorage:
    """Engine Storage over a ReplicatedSession: the coordinator-style
    deployment where the query engine reaches storage through the
    replica-merging client (`query/storage/m3/storage.go:215-225`
    FetchCompressed → session.FetchTagged)."""

    def __init__(self, session, namespace: str = "default"):
        self.session = session
        self.namespace = namespace

    def fetch_raw(self, name, matchers, start_nanos, end_nanos) -> RawBlock:
        fault.fire("query.fetch")
        q = matchers_to_query(name, matchers)
        docs = self.session.query_ids(self.namespace, q, start_nanos, end_nanos)
        pts = []
        for i, d in enumerate(docs):
            if i % 64 == 0:  # per-series replica fan-out: cancellable
                xdeadline.check_current("fetch series")
            pts.append(
                self.session.fetch(self.namespace, d.id, start_nanos,
                                   end_nanos))
        metas = [SeriesMeta(tuple(sorted(d.tags().items()))) for d in docs]
        return RawBlock.from_lists(pts, metas)
