"""Leader/follower flush management with KV-persisted flush times: the
port's copy of ``m3_tpu/aggregator/flush_mgr.py``, over the port's
``Aggregator`` and ``cluster.kv``.

Reference parity: `src/aggregator/aggregator/leader_flush_mgr.go:71-190`
(the elected leader drives window consumption and persists per-shard
flush times to KV after every flush round) and `follower_flush_mgr.go`
(followers watch the leader's persisted flush times and *shadow-consume*
their replica of the same input stream up to those times without
emitting).  Election is `election_mgr.go` → etcd leases, here
`cluster.kv.LeaderElection` with a TTL lease.

Semantics preserved from the reference:

* Exactly one instance emits per window (the lease holder).
* Flush times are persisted AFTER emission, so a leader crash between
  emit and persist re-emits that window under the new leader —
  at-least-once, identical to the reference (downstream storage writes
  are idempotent per (id, timestamp)).  The same holds for a stale
  ex-leader resuming a paused tick after its lease expired: it may
  re-emit a window the new leader already flushed (unavoidable without
  fencing tokens threaded to the downstream sink), but it can never
  roll the persisted watermark back — writes are max-merged under CAS.
* A restarted instance resumes at the persisted window
  (`leader_flush_mgr.go:78-80` reads flush times back), never re-opening
  windows the previous leader already drained.
* Followers stay drained to the leader's watermark, so promotion after
  lease expiry continues with no lost and no duplicated window (tested
  in tests/test_flush_mgr.py by killing the leader between ticks).
"""

from __future__ import annotations

import functools
import json
from typing import Callable, Dict, List, Tuple

from m3_tpu_torch.aggregator.engine import Aggregator, FlushedMetric, MetricList
from m3_tpu_torch.cluster.kv import KVStore, LeaderElection

FlushHandler = Callable[[MetricList, FlushedMetric], None]

DEFAULT_LEASE_NANOS = 30 * 10**9


class FlushManager:
    """Drives an Aggregator's consume loop under a leadership lease."""

    def __init__(
        self,
        aggregator: Aggregator,
        kv: KVStore,
        instance_id: str,
        scope: str = "agg",
        flush_handler: FlushHandler | None = None,
        lease_nanos: int = DEFAULT_LEASE_NANOS,
    ):
        self.aggregator = aggregator
        self.kv = kv
        self.instance_id = instance_id
        self.flush_handler = flush_handler
        self.election = LeaderElection(
            kv, f"flush/{scope}", instance_id, ttl_nanos=lease_nanos
        )
        self._times_key = f"_flushtimes/{scope}"

    # ---- flush-times persistence (leader_flush_mgr.go:78-80,184) ----

    def _read_times(self) -> Tuple[Dict[Tuple[int, str], int], int]:
        cur = self.kv.get(self._times_key)
        if cur is None:
            return {}, 0
        raw = json.loads(cur.data)
        return {
            (int(sid), pol): int(t)
            for sid, pols in raw.items()
            for pol, t in pols.items()
        }, cur.version

    def _write_times(self, times: Dict[Tuple[int, str], int]) -> None:
        """Advance the shared watermark, never roll it back.

        A stale ex-leader resuming a paused tick must not overwrite a new
        leader's progress: merge with max() against the current record
        and CAS on its version, retrying on conflict — so whichever
        instance writes last, the persisted watermark is monotone.
        """
        for _ in range(8):
            existing, version = self._read_times()
            merged = dict(existing)
            for k, t in times.items():
                if merged.get(k, 0) < t:
                    merged[k] = t
            if merged == existing:
                return
            raw: Dict[str, Dict[str, int]] = {}
            for (sid, pol), t in merged.items():
                raw.setdefault(str(sid), {})[pol] = t
            try:
                self.kv.check_and_set(
                    self._times_key, version, json.dumps(raw).encode()
                )
                return
            except ValueError:
                continue  # concurrent writer: re-read and re-merge
        raise RuntimeError(
            f"flush-times CAS on {self._times_key} lost 8 straight races; "
            "watermark not persisted (restart would re-emit flushed windows)"
        )

    def _collect_times(self) -> Dict[Tuple[int, str], int]:
        out: Dict[Tuple[int, str], int] = {}
        for sh in self.aggregator.shards:
            for sp, ml in sh.lists.items():
                if ml.consumed_until is not None:
                    out[(sh.shard_id, str(sp))] = ml.consumed_until
        return out

    # ---- lifecycle ----

    def restore(self) -> None:
        """On startup, resume every list at the persisted watermark so a
        restart neither re-emits drained windows nor drops the open one."""
        times, _ = self._read_times()
        for sh in self.aggregator.shards:
            for sp, ml in sh.lists.items():
                t = times.get((sh.shard_id, str(sp)))
                if t is not None and (
                    ml.consumed_until is None or ml.consumed_until < t
                ):
                    ml.consumed_until = t

    def tick(self, now_nanos: int) -> str:
        """One flush round; returns the role played ("leader"/"follower").

        Leader: drain every closed window, emit through the flush
        handler, then persist the new flush times.  Follower: shadow-
        consume (no emission) up to the leader's persisted times.
        """
        if self.election.campaign(now_nanos):
            results: List[FlushedMetric] = []

            def emit(ml: MetricList, fm: FlushedMetric) -> None:
                results.append(fm)
                if self.flush_handler is not None:
                    self.flush_handler(ml, fm)

            # Route through the aggregator's forward sink: multi-stage
            # rollup outputs must land on the NEXT stage's owning shard,
            # not re-ingest into their source shard's list.
            for sh in self.aggregator.shards:
                sh.consume(now_nanos, emit,
                           forward_sink=self.aggregator._route_forwards)
            self._write_times(self._collect_times())
            return "leader"

        # Follower: drain to the leader's watermark, discarding output
        # (our replica aggregated the same stream; the leader emitted it).
        # Forwards still shard-route so the replica's stage-2 state
        # matches the leader's placement.
        times, _ = self._read_times()
        for sh in self.aggregator.shards:
            for sp, ml in sh.lists.items():
                t = times.get((sh.shard_id, str(sp)))
                if t is not None:
                    ml.consume(
                        t, None,
                        functools.partial(
                            self.aggregator._route_forwards, sp))
        return "follower"

    def resign(self) -> None:
        self.election.resign()
