"""Aggregator engine: host control plane over the device arenas.  The
counterpart of ``m3_tpu/aggregator/engine.py``, on either arena layout
(packed by default, as in the JAX package; ``layout="f64"`` for the
scatter-semantics oracle).

Re-design of the reference's object-per-metric engine
(``src/aggregator/aggregator/aggregator.go:263`` AddUntimed →
``shard.go:171`` → ``map.go:149`` find-or-create Entry →
``generic_elem.go:181`` AddUnion; flush via ``list.go:289``
baseMetricList.Flush → ``generic_elem.go:271`` Consume).

Per shard and storage policy, three fixed-capacity arenas (counter /
gauge / timer) live on one device.  The host owns:

* ``MetricMap`` — metric ID bytes → (slot, aggregation bitmask), the
  analogue of map.go's entry map;
* window bookkeeping — ring index = (aligned_nanos // resolution) % W;
* ``consume`` — drains every window whose end <= target, computes the
  (C, lanes) output matrix on the device, masks each slot's requested
  aggregation types, and emits (slot, type, time, value) batches.

Not ported yet, and rejected rather than ignored: pipeline tails and
forwarding (``pipeline=`` raises ``NotImplementedError``), the
new-series limiter (``new_series_limit_per_sec > 0`` raises), and the
native ID resolver (``MetricMap`` is the Python resolver).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

import numpy as np

from m3_tpu_torch import resolve_device
from m3_tpu_torch.aggregator.arena import make_arenas
from m3_tpu_torch.core.hash import shard_for
from m3_tpu_torch.metrics.aggregation import AggregationID, AggregationType
from m3_tpu_torch.metrics.policy import StoragePolicy
from m3_tpu_torch.metrics.types import MetricType


@dataclasses.dataclass(frozen=True)
class AggregatorOptions:
    """Sizing knobs (reference aggregator/options.go, collapsed to the
    arena geometry that matters on device).  Same fields and defaults as
    the JAX package's."""

    capacity: int = 1 << 20  # metric slots per type per shard
    num_windows: int = 2  # ring of open resolution windows
    timer_sample_capacity: int = 1 << 24
    quantiles: tuple = (0.5, 0.95, 0.99)
    # Timer drain sort mode: packed32 sorts ONE int64 (slot<<32 |
    # orderable-f32) key; quantile/min/max lanes then carry f32
    # precision, moments stay f64-exact (see arena.timer_consume).
    timer_packed32: bool = False
    # Arena layout: None / "auto" / "packed" build the packed arenas (the
    # default), "f64" the scatter-semantics arenas; anything else raises
    # ValueError (arena.resolve_layout_arg).  timer_packed32 applies to
    # the f64 timer.
    layout: str | None = None
    storage_policies: tuple = (StoragePolicy.parse("10s:2d"),)
    # New-metric creation rate cap (0 = unlimited); the limiter is not
    # ported, so a positive value raises NotImplementedError.
    new_series_limit_per_sec: float = 0.0


@dataclasses.dataclass
class FlushedMetric:
    """One flushed aggregate batch: parallel arrays."""

    policy: StoragePolicy
    timestamp_nanos: int
    slots: np.ndarray  # int32
    types: np.ndarray  # int8 AggregationType values
    values: np.ndarray  # float64
    metric_type: MetricType = MetricType.GAUGE  # which map owns `slots`


FlushHandler = Callable[["MetricList", FlushedMetric], None]


class MetricMap:
    """(ID, aggregation key) → slot allocator for one metric type.

    The reference keys aggregation elements by (id, aggregation key)
    (map.go:149 entry map), so the same metric ID written with two
    different aggregation sets produces both sets of outputs — mirrored
    here by keying slots on (id, mask).  Slots are dense int32; freed
    slots recycle through a free list (expiry drains the arena's
    last_at column through MetricList.expire)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._slots: Dict[tuple, int] = {}
        self._ids: List[bytes | None] = []
        self._free: List[int] = []
        self.agg_mask = np.zeros(capacity, np.uint64)

    def id_of(self, slot: int) -> bytes | None:
        return self._ids[slot] if slot < len(self._ids) else None

    def resolve(self, ids: Sequence[bytes], agg_id: AggregationID,
                mt: MetricType) -> np.ndarray:
        """Find-or-create slots for a batch of IDs.  All or nothing: a
        batch that exhausts the capacity allocates no slot and raises."""
        mask = self._mask_for(agg_id, mt)
        slots = np.empty(len(ids), np.int32)
        get = self._slots.get
        missing: List[int] = []
        for i, mid in enumerate(ids):
            s = get((mid, mask))
            if s is None:
                missing.append(i)
            else:
                slots[i] = s
        allocated: List[int] = []
        try:
            for i in missing:
                mid = ids[i]
                s = self._slots.get((mid, mask))
                if s is None:
                    s = self._allocate(mid, mask)
                    self.agg_mask[s] = np.uint64(mask)
                    allocated.append(s)
                slots[i] = s
        except RuntimeError:
            for s in allocated:
                self.release(s)
            raise
        return slots

    def _mask_for(self, agg_id: AggregationID, mt: MetricType) -> int:
        """Compressed mask of the requested types that are valid for this
        metric type (reference aggregation type.go IsValidFor*)."""
        m = 0
        for t in agg_id.types_for(mt):
            if t.is_valid_for(mt):
                m |= 1 << int(t)
        return m

    def _allocate(self, mid: bytes, mask: int) -> int:
        if self._free:
            s = self._free.pop()
            self._ids[s] = mid
        else:
            s = len(self._ids)
            if s >= self.capacity:
                raise RuntimeError(f"metric map capacity {self.capacity} exhausted")
            self._ids.append(mid)
        self._slots[(mid, mask)] = s
        return s

    def release(self, slot: int) -> None:
        mid = self._ids[slot]
        if mid is None:
            return
        mask = int(self.agg_mask[slot])
        self._slots.pop((mid, mask), None)
        self._ids[slot] = None
        self.agg_mask[slot] = 0
        self._free.append(slot)


class MetricList:
    """All state for one (shard, storage policy) pair: three arenas on
    ``device`` (None = CUDA) plus window bookkeeping (reference list.go
    baseMetricList keyed by (resolution, flushOffset))."""

    def __init__(self, policy: StoragePolicy, opts: AggregatorOptions,
                 device=None):
        if opts.new_series_limit_per_sec > 0:
            raise NotImplementedError(
                "new_series_limit_per_sec: the new-series limiter is not "
                "ported to m3_tpu_torch yet")
        self.policy = policy
        self.opts = opts
        self.device = resolve_device(device)
        self.resolution = policy.resolution.window_nanos
        W, C = opts.num_windows, opts.capacity
        self.counters, self.gauges, self.timers = make_arenas(
            W, C, opts.timer_sample_capacity, opts.quantiles,
            timer_packed32=opts.timer_packed32, layout=opts.layout,
            device=self.device)
        self.maps = {mt: MetricMap(C) for mt in
                     (MetricType.COUNTER, MetricType.GAUGE, MetricType.TIMER)}
        # Earliest window (aligned nanos) not yet consumed.  Windows in
        # [consumed_until, +W*resolution) are open; later ones rejected
        # (bufferFuture) and earlier dropped (bufferPast).
        self.consumed_until: int | None = None
        self.drops = 0
        self.timed_rejects = {"too_early": 0, "too_far_future": 0}

    def _arena(self, mt: MetricType):
        return {
            MetricType.COUNTER: self.counters,
            MetricType.GAUGE: self.gauges,
            MetricType.TIMER: self.timers,
        }[mt]

    def add_batch(
        self,
        mt: MetricType,
        ids: Sequence[bytes],
        values: np.ndarray,
        times: np.ndarray,
        agg_id: AggregationID = AggregationID.DEFAULT,
        pipeline=None,
    ) -> None:
        """Resolve + ingest.  A non-empty ``pipeline`` (a transform tail)
        raises: tails are not ported yet."""
        if pipeline is not None and len(getattr(pipeline, "ops", pipeline)):
            raise NotImplementedError(
                "pipeline tails are not ported to m3_tpu_torch yet")
        slots = self.maps[mt].resolve(ids, agg_id, mt)
        self.add_batch_slots(mt, slots, values, times)

    def _route_windows(self, times: np.ndarray):
        """Window-ring routing for a batch of timestamps.  Returns
        (windows int32 with the drop sentinel W for out-of-range,
        too_early mask, too_future mask)."""
        r = self.resolution
        W = self.opts.num_windows
        aligned = (times // r) * r
        if self.consumed_until is None:
            self.consumed_until = int(aligned.min())
        offset = (aligned - self.consumed_until) // r
        too_early = offset < 0
        too_future = offset >= W
        in_range = ~(too_early | too_future)
        windows = np.where(in_range, (aligned // r) % W, W).astype(np.int32)
        return windows, too_early, too_future

    def add_batch_slots(self, mt: MetricType, slots: np.ndarray,
                        values: np.ndarray, times: np.ndarray) -> None:
        """Slots already resolved: the hot loop."""
        if len(slots) == 0:
            return
        times = np.asarray(times)
        windows, too_early, too_future = self._route_windows(times)
        self.drops += int(too_early.sum()) + int(too_future.sum())
        self._arena(mt).ingest(windows, slots, values, times)

    def seed_windows(self, now_nanos: int) -> None:
        """Anchor an un-seeded window ring to the caller's clock: the
        ring becomes [now-(W-1)r, now+r).  No-op once seeded."""
        if self.consumed_until is None:
            r = self.resolution
            W = self.opts.num_windows
            self.consumed_until = (now_nanos // r) * r - (W - 1) * r

    def timed_check(self, times: np.ndarray):
        """Non-mutating window validation: (too_early, too_future)
        masks for a timed batch.  An un-seeded list accepts anything
        (ingest will seed from the batch)."""
        if self.consumed_until is None:
            z = np.zeros(len(times), bool)
            return z, z
        r = self.resolution
        W = self.opts.num_windows
        offset = ((times // r) * r - self.consumed_until) // r
        return offset < 0, offset >= W

    def add_timed_batch(
        self,
        mt: MetricType,
        ids: Sequence[bytes],
        values: np.ndarray,
        times: np.ndarray,
        agg_id: AggregationID = AggregationID.DEFAULT,
        now_nanos: int | None = None,
    ) -> np.ndarray:
        """Timed ingestion (reference aggregator.go:77 AddTimed): each
        sample lands in the window its own timestamp selects, and
        out-of-range samples are rejected back to the caller (returned
        accepted mask; counts in ``timed_rejects``).  ``now_nanos``
        anchors a fresh list's ring to the clock (see seed_windows).
        Windows are validated before resolving, so an out-of-window
        flood allocates no slots."""
        if now_nanos is not None:
            self.seed_windows(now_nanos)
        values = np.asarray(values, np.float64)
        times = np.asarray(times, np.int64)
        windows, too_early, too_future = self._route_windows(times)
        self.timed_rejects["too_early"] += int(too_early.sum())
        self.timed_rejects["too_far_future"] += int(too_future.sum())
        accepted = ~(too_early | too_future)
        sel = np.nonzero(accepted)[0]
        if sel.size == 0:
            return accepted
        slots = self.maps[mt].resolve([ids[i] for i in sel], agg_id, mt)
        self._arena(mt).ingest(windows[sel], slots, values[sel], times[sel])
        return accepted

    def open_windows(self, now_nanos: int) -> List[int]:
        """Closed windows that can actually hold data: only the first W
        windows past consumed_until (ingest accepts nothing later)."""
        if self.consumed_until is None:
            return []
        r = self.resolution
        out = []
        t = self.consumed_until
        while t + r <= now_nanos and len(out) < self.opts.num_windows:
            out.append(t)
            t += r
        return out

    def consume(self, target_nanos: int,
                flush_handler: FlushHandler | None = None) -> List[FlushedMetric]:
        """Drain every closed window (reference generic_elem.go:271
        Consume: windows with start+resolution <= target), then skip the
        watermark past any idle gap."""
        results = []
        for start in self.open_windows(target_nanos):
            w = (start // self.resolution) % self.opts.num_windows
            ts = start + self.resolution  # end-of-window timestamp
            for mt in (MetricType.COUNTER, MetricType.GAUGE, MetricType.TIMER):
                arena = self._arena(mt)
                lanes, counts = arena.consume(w)
                for flushed in self._emit(mt, arena, lanes, counts, ts):
                    results.append(flushed)
                    if flush_handler is not None:
                        flush_handler(self, flushed)
                arena.reset_window(w)
            self.consumed_until = start + self.resolution
        if self.consumed_until is not None:
            r = self.resolution
            floor_target = (target_nanos // r) * r
            if floor_target > self.consumed_until:
                self.consumed_until = floor_target
        return results

    def expire(self, now_nanos: int, ttl_nanos: int) -> int:
        """Release slots idle for longer than ttl (reference map.go
        deleteExpired / entry.go ShouldExpire): reads the device last_at
        column, frees matching slots in every map, and clears each freed
        slot's arena state, so a recycled slot starts empty."""
        released = 0
        for mt in (MetricType.COUNTER, MetricType.GAUGE, MetricType.TIMER):
            arena = self._arena(mt)
            last_at = arena.state.last_at.cpu().numpy()
            stale = np.nonzero((last_at > 0) & (last_at < now_nanos - ttl_nanos))[0]
            if stale.size == 0:
                continue
            m = self.maps[mt]
            for s in stale:
                m.release(int(s))
            arena.clear_slots(stale.astype(np.int32))
            released += stale.size
        return released

    def _emit(self, mt, arena, lanes, counts, ts) -> List[FlushedMetric]:
        """0 or 1 FlushedMetric for one drained window."""
        lanes = lanes.cpu().numpy()
        counts = counts.cpu().numpy()
        active = np.nonzero(counts > 0)[0]
        if active.size == 0:
            return []
        mask = self.maps[mt].agg_mask[active]
        out_slots: List[np.ndarray] = []
        out_types: List[np.ndarray] = []
        out_vals: List[np.ndarray] = []
        for t in AggregationType:
            if not t.is_valid():
                continue
            lane_i = arena.lane_for_type(t)
            if lane_i is None:
                continue
            want = (mask >> np.uint64(int(t))) & np.uint64(1)
            sel = np.nonzero(want.astype(bool))[0]
            if sel.size == 0:
                continue
            rows = active[sel]
            out_slots.append(rows.astype(np.int32))
            out_types.append(np.full(rows.size, int(t), np.int8))
            out_vals.append(lanes[rows, lane_i])
        if not out_slots:
            return []
        return [FlushedMetric(
            policy=self.policy,
            timestamp_nanos=ts,
            slots=np.concatenate(out_slots),
            types=np.concatenate(out_types),
            values=np.concatenate(out_vals),
            metric_type=mt,
        )]


@dataclasses.dataclass
class PassthroughBatch:
    """Pre-aggregated samples bypassing the arenas entirely (reference
    aggregator.go:86,422 AddPassthrough → passWriter.Write)."""

    policy: StoragePolicy
    ids: list
    values: np.ndarray
    times: np.ndarray


class AggregatorShard:
    """One aggregator shard: a MetricList per storage policy
    (reference shard.go:171 AddUntimed + list registry)."""

    def __init__(self, shard_id: int, opts: AggregatorOptions, device=None):
        self.shard_id = shard_id
        self.opts = opts
        self.lists = {sp: MetricList(sp, opts, device=device)
                      for sp in opts.storage_policies}

    def add_batch(self, mt, ids, values, times, agg_id=AggregationID.DEFAULT):
        for ml in self.lists.values():
            ml.add_batch(mt, ids, values, times, agg_id)

    def add_timed_batch(self, mt, ids, values, times,
                        agg_id=AggregationID.DEFAULT,
                        now_nanos: int | None = None) -> np.ndarray:
        """All-or-nothing across storage policies: a sample out of range
        for ANY list is ingested into none (pre-checked without
        mutation), so the returned mask is trustworthy."""
        lists = list(self.lists.values())
        if now_nanos is not None:
            for ml in lists:
                ml.seed_windows(now_nanos)
        accepted = np.ones(len(ids), bool)
        for ml in lists:
            early, future = ml.timed_check(times)
            accepted &= ~(early | future)
        pre_rejected = ~accepted
        sel = np.nonzero(accepted)[0]
        if sel.size:
            # The first list decides (an un-seeded list seeds from the
            # batch and may reject); followers ingest what it accepted.
            acc = lists[0].add_timed_batch(mt, [ids[i] for i in sel], values[sel],
                                           times[sel], agg_id)
            accepted[sel] &= acc
            sub = sel[acc]
            if sub.size:
                for ml in lists[1:]:
                    ml.add_timed_batch(mt, [ids[i] for i in sub], values[sub],
                                       times[sub], agg_id)
        if pre_rejected.any():
            # Count each pre-check reject once, on the first list that
            # classifies it out of range.
            rej_times = times[pre_rejected]
            remaining = np.ones(len(rej_times), bool)
            for ml in lists:
                early, future = ml.timed_check(rej_times)
                e = early & remaining
                f = future & remaining & ~e
                ml.timed_rejects["too_early"] += int(e.sum())
                ml.timed_rejects["too_far_future"] += int(f.sum())
                remaining &= ~(early | future)
                if not remaining.any():
                    break
        return accepted

    def consume(self, target_nanos: int, flush_handler=None):
        out = []
        for ml in self.lists.values():
            out.extend(ml.consume(target_nanos, flush_handler))
        return out


class Aggregator:
    """Top-level aggregator (reference aggregator.go:101): routes metrics
    to shards by murmur3 and drives consume across shards.  Every shard's
    arenas live on ``device`` (None = CUDA; raises without one)."""

    def __init__(self, num_shards: int = 1, opts: AggregatorOptions | None = None,
                 passthrough_handler=None, device=None):
        self.opts = opts or AggregatorOptions()
        self.device = resolve_device(device)
        self.shards = [AggregatorShard(i, self.opts, device=self.device)
                       for i in range(num_shards)]
        # Passthrough output (reference passWriter): pre-aggregated
        # samples skip the arenas and go straight here.
        self.passthrough_handler = passthrough_handler
        self.passthrough_samples = 0

    def shard_index(self, mid: bytes) -> int:
        # murmur3(id) % numShards (aggregator.go:505, shardset.go:148).
        return shard_for(mid, len(self.shards))

    def _by_shard(self, ids) -> Dict[int, List[int]]:
        by_shard: Dict[int, List[int]] = {}
        for i, mid in enumerate(ids):
            by_shard.setdefault(self.shard_index(mid), []).append(i)
        return by_shard

    def add_untimed_batch(self, mt, ids, values, times, agg_id=AggregationID.DEFAULT):
        if len(self.shards) == 1:
            self.shards[0].add_batch(mt, ids, values, times, agg_id)
            return
        values, times = np.asarray(values), np.asarray(times)
        for sid, idxs in self._by_shard(ids).items():
            sel = np.asarray(idxs)
            self.shards[sid].add_batch(
                mt, [ids[i] for i in idxs], values[sel], times[sel], agg_id)

    def add_timed_batch(self, mt, ids, values, times,
                        agg_id=AggregationID.DEFAULT,
                        now_nanos: int | None = None) -> np.ndarray:
        """Timed ingestion with per-sample accept/reject (reference
        aggregator.go:77 AddTimed; see MetricList.add_timed_batch)."""
        values = np.asarray(values, np.float64)
        times = np.asarray(times, np.int64)
        if len(self.shards) == 1:
            return self.shards[0].add_timed_batch(
                mt, ids, values, times, agg_id, now_nanos=now_nanos)
        accepted = np.ones(len(ids), bool)
        for sid, idxs in self._by_shard(ids).items():
            sel = np.asarray(idxs)
            accepted[sel] = self.shards[sid].add_timed_batch(
                mt, [ids[i] for i in idxs], values[sel], times[sel], agg_id,
                now_nanos=now_nanos)
        return accepted

    def add_passthrough_batch(self, ids, values, times,
                              policy: StoragePolicy) -> None:
        """Pre-aggregated metrics go straight to the output handler with
        their storage policy (reference aggregator.go:86,422) — no
        arenas, no windows.  Raises when no handler is configured:
        silently eating passthrough traffic would be data loss."""
        if self.passthrough_handler is None:
            raise RuntimeError("no passthrough handler configured on this aggregator")
        batch = PassthroughBatch(
            policy=policy, ids=list(ids),
            values=np.asarray(values, np.float64),
            times=np.asarray(times, np.int64))
        self.passthrough_samples += len(batch.ids)
        self.passthrough_handler(batch)

    def consume(self, target_nanos: int, flush_handler=None):
        out = []
        for sh in self.shards:
            out.extend(sh.consume(target_nanos, flush_handler))
        return out

    def counters(self) -> dict:
        """Operational-counter snapshot summed across every shard's lists
        (the JAX package's keys; forwarding and the limiter are not
        ported, so those two stay 0)."""
        out = {
            "drops": 0,
            "forward_errors": 0,
            "timed_rejects_too_early": 0,
            "timed_rejects_too_far_future": 0,
            "new_series_rejected": 0,
            "passthrough_samples": self.passthrough_samples,
        }
        for sh in self.shards:
            for ml in sh.lists.values():
                out["drops"] += ml.drops
                out["timed_rejects_too_early"] += ml.timed_rejects["too_early"]
                out["timed_rejects_too_far_future"] += (
                    ml.timed_rejects["too_far_future"])
        return out
