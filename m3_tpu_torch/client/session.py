"""Replica-aware session: per-shard fan-out with quorum consistency.
The port's counterpart of ``m3_tpu/client/session.py``: the same levels,
errors, retries, breakers and merge (the port's ``storage/series_merge``).

Reference parity: `src/dbnode/client/session.go:1213-1400` (write fan-out
to every replica owning the shard, success accumulation against the
consistency level) and `src/dbnode/topology/consistency_level.go:36-46`
(One / Majority / All; unstrict majority for reads/bootstrap).  The
reference's per-host TChannel queues (`host_queue.go:1021`) become direct
calls against per-instance `Database` handles — in-process here exactly
like the reference's integration topology (fake cluster services,
`src/dbnode/integration/fake/cluster_services.go`); the socket transport
(server/rpc.py) carries the same session when instances are remote.

Reads fan out to the shard's replicas, each replica returns its merged
(buffer + fileset) series, and the session de-duplicates by timestamp —
the job `encoding/multi_reader_iterator.go` does stream-wise in Go is a
sorted dict-merge over (timestamp → value) here.
"""

from __future__ import annotations

import enum
import threading
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from m3_tpu_torch.cluster.placement import Placement, ShardState
from m3_tpu_torch.core.hash import shard_for
from m3_tpu_torch.instrument import tracing
from m3_tpu_torch.instrument.tracing import NOOP_SPAN, NOOP_TRACER, Tracepoint
from m3_tpu_torch.storage.database import ShardNotOwnedError
from m3_tpu_torch.storage.series_merge import merge_point_sources
from m3_tpu_torch.x import deadline as xdeadline
from m3_tpu_torch.x.breaker import BreakerOpenError, CircuitBreaker
from m3_tpu_torch.x.retry import Retrier, RetryOptions


class ConsistencyLevel(enum.Enum):
    """`topology/consistency_level.go:36-46`."""

    ONE = "one"
    UNSTRICT_MAJORITY = "unstrict_majority"
    MAJORITY = "majority"
    ALL = "all"

    def required(self, replicas: int) -> int:
        if self == ConsistencyLevel.ONE:
            return 1
        if self == ConsistencyLevel.ALL:
            return replicas
        return replicas // 2 + 1  # majority variants

    @property
    def strict(self) -> bool:
        return self != ConsistencyLevel.UNSTRICT_MAJORITY


class ConsistencyError(RuntimeError):
    """Raised when fewer replicas succeeded than the level requires
    (reference session write/fetch consistency errors)."""

    def __init__(self, op: str, got: int, need: int, errors: list):
        super().__init__(
            f"{op}: {got}/{need} replica successes (errors: {errors})"
        )
        self.got = got
        self.need = need
        self.errors = errors


class ReplicatedSession:
    """Shard-routed, replica-fanned session over per-instance databases.

    ``connections`` maps instance id → a Database-like handle (anything
    with write_batch/write_tagged_batch/read/query_ids).  A handle of
    None models a down instance; per-call exceptions count as replica
    errors exactly like the reference's per-host op failures.
    """

    def __init__(
        self,
        placement: Placement,
        connections: Dict[str, object],
        write_level: ConsistencyLevel = ConsistencyLevel.MAJORITY,
        read_level: ConsistencyLevel = ConsistencyLevel.UNSTRICT_MAJORITY,
        retry_options: RetryOptions | None = None,
        tracer=None,
    ):
        # Per-replica fan-out spans (session.writeReplica) are opened
        # only inside an already-sampled trace; with no tracer or no
        # bound context the fan-out pays one None-check per replica.
        self.tracer = tracer if tracer is not None else NOOP_TRACER
        # (placement, connections) swap together in ONE attribute so a
        # topology change mid-fan-out can never pair a new placement
        # with old handles (reference session.go:527-544 rebuilds its
        # host queues atomically on a topology watch fire).
        self._topo = (placement, dict(connections))
        self.write_level = write_level
        self.read_level = read_level
        # Per-replica transport retries (x/retry adoption for the
        # replication send path): a replica mid-bounce heals within one
        # fan-out instead of burning a consistency slot.  Application
        # errors (RemoteError etc.) are not retryable and still count
        # as that replica's failure immediately.
        self.retrier = Retrier(
            retry_options or RetryOptions(
                initial_backoff_s=0.05, max_backoff_s=0.5, max_attempts=3),
            name="replication")
        self.topology_version = 0
        self._closed = False
        self._retired: List[object] = []
        # Per-replica circuit breakers for the READ fan-out: a dead or
        # deadline-blowing replica fails fast (counted as that
        # replica's error toward the consistency level) instead of
        # eating the full deadline on every fetch.  Session-local
        # instances — replicas come and go with the placement, and a
        # session's read health must not leak across sessions/tests.
        # Writes keep the plain retry contract: shedding a write
        # replica would trade durability for latency.
        self._breakers: Dict[str, object] = {}
        self._breaker_mu = threading.Lock()
        self.breaker_failures = 5
        self.breaker_reset_s = 10.0
        self._kv = self._kv_key = self._on_change = self._resolve = None
        # Per-replica ShardNotOwnedError responses observed (stale
        # placement at one end of the conversation): routing misses,
        # never data errors.  Observable for tests/metrics.
        self.routing_misses = 0
        # Serializes topology swaps against close(): without it a
        # placement update racing close() could leak fresh handles or
        # close ones just installed as live.
        self._swap_mu = threading.Lock()

    @property
    def placement(self) -> Placement:
        return self._topo[0]

    @property
    def connections(self) -> Dict[str, object]:
        return self._topo[1]

    # ---- topology ----

    @classmethod
    def dynamic(
        cls,
        kv,
        resolve: Callable[[object], object],
        key: str = "placement",
        write_level: ConsistencyLevel = ConsistencyLevel.MAJORITY,
        read_level: ConsistencyLevel = ConsistencyLevel.UNSTRICT_MAJORITY,
    ) -> "ReplicatedSession":
        """Session bound to the LIVE placement: watches the KV key and
        atomically swaps routing whenever the control plane changes it
        (reference `dbnode/topology/dynamic.go` + the session's
        topology-watch rebuild, `client/session.go:527-544`).  A node
        add/replace/remove needs zero client restarts — in-flight
        fan-outs finish on the old topology, the next call routes on
        the new one.

        ``resolve(instance)`` returns a Database-like handle for a
        placement instance (e.g. a ``RemoteDatabase`` at its endpoint).
        It MUST be cheap and non-blocking (lazy connect like
        RemoteDatabase): the watch callback may fire inside the KV
        store's notification path.  Handles of retained instances are
        reused so their connections stay warm; dropped instances'
        handles are RETIRED, not closed — in-flight fan-outs holding
        the old topology snapshot finish undisturbed — and released by
        ``close()``.  Call ``close()`` when done with the session or
        the KV watch keeps it (and its handles) alive forever."""
        vv = kv.get(key)
        if vv is None:
            raise ValueError(f"no placement at KV key {key!r}")
        p = Placement.from_json(vv.data)
        sess = cls(p, cls._build_conns(p, resolve, {}),
                   write_level, read_level)
        sess.topology_version = vv.version
        sess._kv, sess._kv_key, sess._resolve = kv, key, resolve

        def on_change(v) -> None:
            if sess._closed or v.version <= sess.topology_version:
                return
            sess._apply_placement(Placement.from_json(v.data), resolve,
                                  v.version)

        sess._on_change = on_change
        kv.watch(key, on_change)
        return sess

    @staticmethod
    def _build_conns(p: Placement, resolve, old: Dict[str, object]):
        """Handles for instances that OWN shards (a decommissioned
        instance lingers in the placement with an empty shard map until
        the operator removes it — fanning queries at it would hit a
        dead host on every call).  A resolve() failure marks the
        instance down (None handle) instead of poisoning the swap."""
        conns: Dict[str, object] = {}
        for inst in p.instances.values():
            if not inst.shards:
                continue
            existing = old.get(inst.id)
            if existing is not None:
                conns[inst.id] = existing
                continue
            try:
                conns[inst.id] = resolve(inst)
            except Exception:  # noqa: BLE001 — treated as a down replica
                conns[inst.id] = None
        return conns

    def _apply_placement(self, p: Placement, resolve, version: int) -> None:
        with self._swap_mu:
            if self._closed:  # raced close(): don't resurrect handles
                return
            if version <= self.topology_version:
                return  # stale apply (watch and re-fan refresh race)
            old_p, old_conns = self._topo
            conns = self._build_conns(p, resolve, old_conns)
            self._topo = (p, conns)  # atomic swap
            self.topology_version = version
            # Retire (never close inline): a fan-out that snapshotted
            # the old topology may still be mid-call on these handles,
            # and the watch can fire inside the KV store's notify path
            # where a blocking close would stall every KV user.
            for iid, handle in old_conns.items():
                if iid not in conns and handle is not None:
                    self._retired.append(handle)

    def close(self) -> None:
        """Detach from the KV watch and release retired handles."""
        with self._swap_mu:
            self._closed = True
            retired, self._retired = self._retired, []
            _, conns = self._topo
        if self._kv is not None and hasattr(self._kv, "unwatch"):
            self._kv.unwatch(self._kv_key, self._on_change)
        for handle in list(conns.values()) + retired:
            if handle is not None and hasattr(handle, "close"):
                try:
                    handle.close()
                except Exception:  # noqa: BLE001
                    pass

    def _replicas_for_shard(self, shard: int, for_read: bool = False,
                            placement: Placement | None = None) -> List[str]:
        out = []
        if placement is None:
            placement = self.placement
        for inst in placement.instances_for_shard(shard):
            st = inst.shards[shard].state
            # Leaving instances still serve both paths.  Initializing
            # ones take writes but are excluded from reads: they may not
            # have bootstrapped yet, and counting their empty responses
            # toward read quorum would present data loss as a consistent
            # read (reference session.go readConsistencyAchieved counts
            # Available hosts only).
            ok_states = (ShardState.AVAILABLE, ShardState.LEAVING)
            if not for_read:
                ok_states += (ShardState.INITIALIZING,)
            if st in ok_states:
                out.append(inst.id)
        return out

    def _shard(self, sid: bytes) -> int:
        return shard_for(sid, self.placement.num_shards)

    def _breaker(self, iid: str) -> CircuitBreaker:
        with self._breaker_mu:
            br = self._breakers.get(iid)
            if br is None:
                br = CircuitBreaker(
                    f"session:{iid}",
                    failure_threshold=self.breaker_failures,
                    reset_timeout_s=self.breaker_reset_s)
                self._breakers[iid] = br
            return br

    def breaker_states(self) -> Dict[str, str]:
        """Per-replica read-breaker states (observability/tests)."""
        with self._breaker_mu:
            return {iid: br.state for iid, br in self._breakers.items()}

    # ---- write path (session.go:1213 Write → fan-out + accumulate) ----

    def _fan_out_once(
        self,
        op: str,
        shard: int,
        level: ConsistencyLevel,
        fn: Callable[[object], object],
        for_read: bool = False,
    ) -> List[object]:
        placement, connections = self._topo  # one consistent snapshot
        replicas = self._replicas_for_shard(shard, for_read, placement)
        need = level.required(len(replicas))
        results, errors = [], []
        # An expired query deadline aborts the retry schedule instead of
        # sleeping out backoff the caller will never see.
        dl = xdeadline.current()
        abort = (lambda: dl.expired) if dl is not None else None
        for iid in replicas:
            conn = connections.get(iid)
            if conn is None:
                errors.append(f"{iid}: down")
                continue
            br = self._breaker(iid) if for_read else None
            # the replica hop span: parents on the caller's active
            # span (api.write / a test's root), and every wire call
            # under it propagates ITS context (RPC_REQ_TR)
            span = (self.tracer.start_span(
                Tracepoint.SESSION_WRITE, {"replica": iid, "op": op})
                if not for_read and tracing.current() is not None
                else NOOP_SPAN)
            try:
                if br is not None:
                    # budget already spent: the query's failure, raised
                    # OUTSIDE the breaker — overload must not open a
                    # healthy replica's breaker
                    if dl is not None:
                        dl.check(f"fetch {iid}")
                    results.append(br.call(
                        lambda: self.retrier.run(lambda: fn(conn),
                                                 abort=abort)))
                else:
                    with span:
                        results.append(self.retrier.run(
                            lambda: fn(conn), abort=abort))
            except xdeadline.DeadlineExceeded:
                # The SHARED query budget is spent (or the query was
                # cancelled): not this replica's failure — surface
                # typed so the API maps 504, never a 400
                # ConsistencyError.
                raise
            except BreakerOpenError as e:
                # fail-fast replica: counted as its failure, no dial paid
                errors.append(f"{iid}: {e}")
            except ShardNotOwnedError as e:
                # Routing miss, not a data error: OUR placement said
                # this replica owns the shard, THEIRS says otherwise —
                # somebody is stale.  Counted distinctly so the caller
                # (_fan_out) knows a topology refresh may still satisfy
                # the consistency level (reference session retries on
                # errTryAgain-shaped host errors after a topology
                # update, client/session.go).
                with self._swap_mu:  # concurrent fan-outs share the counter
                    self.routing_misses += 1
                errors.append(f"{iid}: routing miss ({e})")
            except Exception as e:  # per-replica failure, keep fanning
                errors.append(f"{iid}: {e}")
        if len(results) < need and level.strict:
            raise ConsistencyError(op, len(results), need, errors)
        if not results and not level.strict:
            raise ConsistencyError(op, 0, 1, errors)
        return results

    def _fan_out(
        self,
        op: str,
        shard: int,
        level: ConsistencyLevel,
        fn: Callable[[object], object],
        for_read: bool = False,
    ) -> List[object]:
        """One fan-out attempt; on a strict consistency failure where
        the placement moved underneath us (a mark_available cutover
        racing this very call), refresh the topology ONCE from KV and
        re-fan before surfacing the error — a write racing a topology
        change succeeds without the caller retrying (the reference
        session's topology-watch + queued-op retry, session.go:527)."""
        version_before = self.topology_version
        try:
            return self._fan_out_once(op, shard, level, fn, for_read)
        except ConsistencyError:
            if self._kv is None or self._closed:
                raise
            try:
                vv = self._kv.get(self._kv_key)
            except Exception:  # noqa: BLE001 — a KV hiccup must surface
                vv = None      # the original consistency failure, not mask it
            if vv is None or vv.version <= version_before:
                raise  # nothing newer to route by
            if vv.version > self.topology_version:
                # The watch hasn't delivered it yet: apply directly
                # (idempotent with the watch — _apply_placement drops
                # stale versions).
                self._apply_placement(Placement.from_json(vv.data),
                                      self._resolve, vv.version)
            return self._fan_out_once(op, shard, level, fn, for_read)

    def write_batch(
        self,
        namespace: str,
        ids: Sequence[bytes],
        ts,
        vals,
        now_nanos: int | None = None,
    ) -> int:
        """Returns a rejected-samples count (new-series rate limit /
        slot capacity): per shard, the WORST replica's rejected count,
        summed across the shards the batch touched — a conservative
        upper bound on samples some replica refused, not an exact
        per-sample tally.  A successful fan-out with rejections is an
        ACK for the accepted samples only — callers holding a
        durability ledger (the soak driver) must treat rejected > 0 as
        a partially-unacked batch, not silent success."""
        ts = np.asarray(ts, np.int64)
        vals = np.asarray(vals, np.float64)
        by_shard: Dict[int, List[int]] = {}
        for i, sid in enumerate(ids):
            by_shard.setdefault(self._shard(sid), []).append(i)
        rejected = 0
        for shard, idxs in by_shard.items():
            sel = np.asarray(idxs)
            sub_ids = [ids[i] for i in idxs]
            results = self._fan_out(
                "write",
                shard,
                self.write_level,
                lambda db: db.write_batch(
                    namespace, sub_ids, ts[sel], vals[sel], now_nanos
                ),
            )
            rejected += max(
                (getattr(r, "rejected", 0) for r in results), default=0)
        return rejected

    def write_tagged_batch(
        self, namespace: str, docs, ts, vals, now_nanos: int | None = None
    ) -> int:
        """Same rejected-count contract as :meth:`write_batch`."""
        ts = np.asarray(ts, np.int64)
        vals = np.asarray(vals, np.float64)
        by_shard: Dict[int, List[int]] = {}
        for i, d in enumerate(docs):
            by_shard.setdefault(self._shard(d.id), []).append(i)
        rejected = 0
        for shard, idxs in by_shard.items():
            sel = np.asarray(idxs)
            sub = [docs[i] for i in idxs]
            results = self._fan_out(
                "write_tagged",
                shard,
                self.write_level,
                lambda db: db.write_tagged_batch(
                    namespace, sub, ts[sel], vals[sel], now_nanos
                ),
            )
            rejected += max(
                (getattr(r, "rejected", 0) for r in results), default=0)
        return rejected

    # ---- read path (session.go fetch fan-out + merge) ----

    def fetch(
        self, namespace: str, sid: bytes, start: int, end: int
    ) -> List[Tuple[int, float]]:
        """Fetch one series, merged across replicas, each point once."""
        shard = self._shard(sid)
        results = self._fan_out(
            "fetch",
            shard,
            self.read_level,
            lambda db: db.read(namespace, sid, start, end),
            for_read=True,
        )
        # One merge seam for every read path (series_merge): replicas
        # should agree post-repair, so precedence is a tie-break only.
        return merge_point_sources(results)

    def fetch_batch(
        self, namespace: str, sids: Sequence[bytes], start: int, end: int
    ) -> List[List[Tuple[int, float]]]:
        """Batched :meth:`fetch`: group by shard, ONE fan-out per shard
        (each replica answers the whole shard's id list through the
        read_batch wire method), merge per id across replicas.  Returns
        point lists aligned with ``sids``.  This is the soak harness's
        ledger-verify read — a million acked samples check at Majority
        in thousands of round trips instead of millions."""
        by_shard: Dict[int, List[int]] = {}
        for i, sid in enumerate(sids):
            by_shard.setdefault(self._shard(sid), []).append(i)
        out: List = [None] * len(sids)
        for shard, idxs in by_shard.items():
            sub = [sids[i] for i in idxs]
            results = self._fan_out(
                "fetch_batch",
                shard,
                self.read_level,
                lambda db: (db.read_batch(namespace, sub, start, end)
                            if hasattr(db, "read_batch")
                            else [db.read(namespace, s, start, end)
                                  for s in sub]),
                for_read=True,
            )
            for k, i in enumerate(idxs):
                out[i] = merge_point_sources([r[k] for r in results])
        return out

    def query_ids(self, namespace: str, query, start: int, end: int) -> List[object]:
        """Index query fanned out to all instances, de-duplicated by
        series ID; read_level applies to how many must answer (the
        reference applies the level per-shard over host responses)."""
        docs: Dict[bytes, object] = {}
        ok = 0
        errors: List[str] = []
        placement, connections = self._topo  # one consistent snapshot
        for iid, conn in connections.items():
            if conn is None:
                errors.append(f"{iid}: down")
                continue
            try:
                # pre-spent budget raises OUTSIDE the replica's breaker
                # (the query's failure, not the peer's)
                xdeadline.check_current(f"query_ids {iid}")
                for d in self._breaker(iid).call(
                        lambda: conn.query_ids(namespace, query, start, end)):
                    docs.setdefault(d.id, d)
                ok += 1
            except xdeadline.DeadlineExceeded:
                raise  # shared budget spent: the query's 504, not a replica error
            except Exception as e:
                errors.append(f"{iid}: {e}")
        need = self.read_level.required(placement.replica_factor)
        if (self.read_level.strict and ok < need) or ok == 0:
            raise ConsistencyError("query_ids", ok, max(need, 1), errors)
        return [docs[sid] for sid in sorted(docs)]

    def fetch_tagged(
        self, namespace: str, query, start: int, end: int
    ) -> Dict[bytes, List[Tuple[int, float]]]:
        """Index query + per-series fetch (session.go FetchTagged +
        fetchTaggedResultsAccumulator)."""
        return {
            d.id: self.fetch(namespace, d.id, start, end)
            for d in self.query_ids(namespace, query, start, end)
        }
