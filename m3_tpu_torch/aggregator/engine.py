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

* ``MetricMap`` — metric ID bytes → (slot, aggregation bitmask, tail
  signature), the analogue of map.go's entry map; the native resolver
  (``native/idmap``, built with g++ at first use) or the Python one, with
  an optional new-series limiter;
* window bookkeeping — ring index = (aligned_nanos // resolution) % W;
* ``consume`` — drains every window whose end <= target, computes the
  (C, lanes) output matrix on the device, masks each slot's requested
  aggregation types, applies each slot's pipeline tail (transforms, RESET's
  forced zero, forwarding to the next rollup stage) and emits (slot, type,
  time, value) batches;
* ``instrument_aggregator`` — the counters as registry gauges at scrape
  time, and the drain-latency histogram.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Callable, Dict, List, Sequence

import numpy as np

from m3_tpu_torch import resolve_device
from m3_tpu_torch.aggregator.arena import make_arenas
from m3_tpu_torch.core.hash import shard_for
from m3_tpu_torch.metrics.aggregation import AggregationID, AggregationType
from m3_tpu_torch.metrics.policy import StoragePolicy
from m3_tpu_torch.metrics.transformation import TransformationType
from m3_tpu_torch.metrics.types import MetricType

# Transform tails a MetricList can execute at consume.  RESET
# (unary_multi.go transformReset: the datapoint unchanged plus a forced
# zero half a resolution later) emits a SECOND FlushedMetric per consume
# carrying the zero rows at ts + max(resolution//2, 1).
_SUPPORTED_TAIL = frozenset({
    TransformationType.ABSOLUTE, TransformationType.ADD,
    TransformationType.PER_SECOND, TransformationType.INCREASE,
    TransformationType.RESET,
})


@dataclasses.dataclass(frozen=True)
class ForwardSpec:
    """Next pipeline stage for a forwarded metric (reference
    forwarded_writer.go:186 Register / aggregator.go:395 AddForwarded):
    the resolved next-stage output ID, its aggregation, and whatever
    ops remain after it."""

    id: bytes
    aggregation_id: "AggregationID"
    tail: tuple  # ops after this rollup (transforms / applied rollups)


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
    # New-metric creation rate cap, entries/sec across the aggregator
    # (reference entry.go rate limits; 0 = unlimited).  Samples whose
    # series creation exceeds it are dropped and counted in
    # ``new_series_rejected``.
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
    last_at column through MetricList.expire).

    ``use_native``: None resolves through the native resolver when it
    builds and through the Python one otherwise (the JAX package's
    default); True raises if it cannot build; False takes the Python
    resolver.  Both assign the same slots."""

    def __init__(self, capacity: int, use_native: bool | None = None,
                 limiter=None):
        self.capacity = capacity
        # Optional shared NewSeriesLimiter (storage/limits.py): entry
        # creations past the rate resolve to slot -1; callers drop
        # those samples and count them (reference entry.go
        # errWriteNewMetricRateLimitExceeded).
        self.limiter = limiter
        self._slots: Dict[tuple, int] = {}
        self._ids: List[bytes | None] = []
        self._free: List[int] = []
        self.agg_mask = np.zeros(capacity, np.uint64)
        # Per-slot pipeline-tail signature (0 = no tail).  Slots are keyed
        # on (id, mask), so a tail/no-tail or tail/other-tail collision on
        # one slot would silently mis-aggregate: resolve() raises instead.
        self.tail_sig = np.zeros(capacity, np.int32)
        self._native = None
        if use_native is not False:
            try:
                from m3_tpu_torch.native.idmap import NativeIdMap, available

                if available():
                    self._native = NativeIdMap(capacity)
                    self._native_ids: List[bytes | None] = [None] * capacity
                elif use_native is True:
                    raise RuntimeError("native idmap unavailable")
            except Exception:
                # None degrades to the Python path as the reference does;
                # an explicit True must not.
                if use_native is True:
                    raise
                self._native = None

    @property
    def native(self) -> bool:
        """Whether this map resolves through the native resolver."""
        return self._native is not None

    def __len__(self) -> int:
        return (len(self._native) if self._native is not None
                else len(self._slots))

    def id_of(self, slot: int) -> bytes | None:
        if self._native is not None:
            return (self._native_ids[slot]
                    if slot < len(self._native_ids) else None)
        return self._ids[slot] if slot < len(self._ids) else None

    def resolve(self, ids: Sequence[bytes], agg_id: AggregationID,
                mt: MetricType, tail_sig: int = 0) -> np.ndarray:
        """Find-or-create slots for a batch of IDs.  All or nothing: a
        batch that exhausts the capacity allocates no slot and raises.
        ``tail_sig`` is the MetricList-assigned signature of the batch's
        pipeline tail (0 = none); a resolve that lands on a live slot
        carrying a different signature raises."""
        mask = self._mask_for(agg_id, mt)
        if self._native is not None:
            try:
                slots, new_pos = self._native.resolve(ids, mask)
            except RuntimeError as e:
                raise RuntimeError(
                    f"metric map capacity {self.capacity} exhausted") from e
            if len(new_pos) and self.limiter is not None:
                # The native resolver allocated eagerly; release the
                # over-budget creations and mark every occurrence of a
                # released id rejected.
                granted = self.limiter.acquire_up_to(len(new_pos))
                released = set()
                for i in new_pos[granted:]:
                    self._native.release(ids[i], mask)
                    released.add(ids[i])
                if released:
                    for j in range(len(ids)):
                        if ids[j] in released:
                            slots[j] = -1
                new_pos = new_pos[:granted]
            for i in new_pos:
                s = int(slots[i])
                self._native_ids[s] = ids[i]
                self.agg_mask[s] = np.uint64(mask)
                self.tail_sig[s] = tail_sig
            self._check_tails(ids, slots, tail_sig)
            return slots
        slots = np.empty(len(ids), np.int32)
        get = self._slots.get
        missing: List[int] = []
        for i, mid in enumerate(ids):
            s = get((mid, mask))
            if s is None:
                missing.append(i)
                slots[i] = -1
            else:
                slots[i] = s
        # Charge per creation, not per occurrence (in-batch duplicates of
        # one new id take a single token).
        n_new = len({ids[i] for i in missing})
        budget = (n_new if self.limiter is None
                  else self.limiter.acquire_up_to(n_new))
        allocated: List[int] = []
        try:
            for i in missing:
                mid = ids[i]
                s = self._slots.get((mid, mask))
                if s is None:
                    if budget <= 0:
                        continue  # stays -1: rejected creation
                    budget -= 1
                    s = self._allocate(mid, mask)
                    self.agg_mask[s] = np.uint64(mask)
                    self.tail_sig[s] = tail_sig
                    allocated.append(s)
                slots[i] = s
        except RuntimeError:
            for s in allocated:
                self.release(s)
            raise
        self._check_tails(ids, slots, tail_sig)
        return slots

    def _check_tails(self, ids, slots: np.ndarray, tail_sig: int) -> None:
        valid = slots >= 0
        bad = np.nonzero(valid & (self.tail_sig[slots] != np.int32(tail_sig)))[0]
        if bad.size:
            i = int(bad[0])
            raise ValueError(
                f"metric {ids[i]!r} resolves to a slot whose pipeline "
                f"tail signature {int(self.tail_sig[slots[i]])} differs "
                f"from this batch's {tail_sig}; two rules producing the "
                "same output ID need distinct rollup IDs per tail")

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

    def to_entries(self) -> dict:
        """Checkpoint form: exact (slot, id, mask, tail_sig) rows plus
        the Python path's free list (aggregator/checkpoint.py)."""
        entries = []
        n = (len(self._native_ids) if self._native is not None
             else len(self._ids))
        for s in range(n):
            mid = self.id_of(s)
            if mid is not None:
                entries.append((s, mid, int(self.agg_mask[s]),
                                int(self.tail_sig[s])))
        free = [] if self._native is not None else list(self._free)
        return {"entries": entries, "free": free, "size": n}

    def load_entries(self, saved: dict) -> None:
        """Rebuild the exact slot→id assignment from a checkpoint into
        this (fresh) map.  Python path: the structures installed, free
        list preserved.  Native path: ids insert in slot order with hole
        placeholders released afterwards, as the reference does, one
        resolve per run of entries that share a mask (the resolver
        allocates a batch's new ids sequentially); a resolver that does
        not assign sequentially raises."""
        entries = sorted(saved["entries"])
        if self._native is not None:
            seq: List[tuple] = []  # (id, mask) for slots 0.. in order
            holes = []
            for slot, mid, mask, tail_sig in entries:
                while len(seq) < slot:
                    dummy = b"\x00ckpt-hole-%d" % len(seq)
                    holes.append(dummy)
                    seq.append((dummy, 0))
                seq.append((mid, mask))
                self._native_ids[slot] = mid
                self.agg_mask[slot] = np.uint64(mask)
                self.tail_sig[slot] = tail_sig
            start = 0
            while start < len(seq):
                end = start
                while end < len(seq) and seq[end][1] == seq[start][1]:
                    end += 1
                got, _ = self._native.resolve([m for m, _ in seq[start:end]], seq[start][1])
                bad = np.nonzero(got != np.arange(start, end))[0]
                if bad.size:
                    i = start + int(bad[0])
                    raise ValueError(
                        f"native idmap restored {seq[i][0]!r} at slot "
                        f"{int(got[bad[0]])}, checkpoint says {i}")
                start = end
            for dummy in holes:
                self._native.release(dummy, 0)
            return
        size = saved.get("size", (entries[-1][0] + 1 if entries else 0))
        self._ids = [None] * size
        self._slots = {}
        self.agg_mask[:] = 0
        self.tail_sig[:] = 0
        for slot, mid, mask, tail_sig in entries:
            self._ids[slot] = mid
            self._slots[(mid, mask)] = slot
            self.agg_mask[slot] = np.uint64(mask)
            self.tail_sig[slot] = tail_sig
        self._free = list(saved.get("free", ()))
        # A native-path checkpoint reports size == capacity with an empty
        # free list; rediscover its holes, or _allocate is exhausted for
        # new series.  A Python-path checkpoint's free list already holds
        # every hole, so this adds nothing there.
        known = set(self._free)
        known.update(slot for slot, _, _, _ in entries)
        self._free.extend(
            s for s in range(size - 1, -1, -1) if s not in known)

    def release(self, slot: int) -> None:
        if self._native is not None:
            mid = self._native_ids[slot] if slot < len(self._native_ids) else None
            if mid is None:
                return
            self._native.release(mid, int(self.agg_mask[slot]))
            self._native_ids[slot] = None
            self.agg_mask[slot] = 0
            self.tail_sig[slot] = 0
            return
        mid = self._ids[slot]
        if mid is None:
            return
        mask = int(self.agg_mask[slot])
        self._slots.pop((mid, mask), None)
        self._ids[slot] = None
        self.agg_mask[slot] = 0
        self.tail_sig[slot] = 0
        self._free.append(slot)


class MetricList:
    """All state for one (shard, storage policy) pair: three arenas on
    ``device`` (None = CUDA) plus window bookkeeping (reference list.go
    baseMetricList keyed by (resolution, flushOffset))."""

    def __init__(self, policy: StoragePolicy, opts: AggregatorOptions,
                 new_series_limiter=None, device=None):
        self.policy = policy
        self.opts = opts
        self.device = resolve_device(device)
        self.resolution = policy.resolution.window_nanos
        W, C = opts.num_windows, opts.capacity
        if new_series_limiter is None and opts.new_series_limit_per_sec > 0:
            from m3_tpu_torch.storage.limits import NewSeriesLimiter

            new_series_limiter = NewSeriesLimiter(opts.new_series_limit_per_sec)
        self.new_series_limiter = new_series_limiter
        self.new_series_rejected = 0
        self.counters, self.gauges, self.timers = make_arenas(
            W, C, opts.timer_sample_capacity, opts.quantiles,
            timer_packed32=opts.timer_packed32, layout=opts.layout,
            device=self.device)
        self.maps = {mt: MetricMap(C, limiter=new_series_limiter)
                     for mt in (MetricType.COUNTER, MetricType.GAUGE,
                                MetricType.TIMER)}
        # Earliest window (aligned nanos) not yet consumed.  Windows in
        # [consumed_until, +W*resolution) are open; later ones rejected
        # (bufferFuture) and earlier dropped (bufferPast).
        self.consumed_until: int | None = None
        self.drops = 0
        self.timed_rejects = {"too_early": 0, "too_far_future": 0}
        self.forward_errors = 0
        # Pipeline tails: (metric type, slot) -> transformation tuple,
        # applied to that slot's window aggregates at consume with
        # per-(slot, aggregation type, op) previous-value state
        # (reference generic_elem.go:114 prevValues, :271-380 Consume).
        self._pipelines: Dict[tuple, tuple] = {}
        self._tf_state: Dict[tuple, tuple] = {}
        # tail ops tuple -> small stable signature (0 = no tail)
        self._tail_sigs: Dict[tuple, int] = {}
        # Stage outputs awaiting delivery to their next-stage owner:
        # (ForwardSpec, value, window-end ts), drained per window by
        # consume into its forward sink.
        self._forward_buffer: List[tuple] = []

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
    ):
        """Resolve + ingest.  ``pipeline`` (rules.py RollupResult
        .pipeline, the ops after the rule's rollup op) attaches a
        transform tail to the batch's output slots.  Unsupported tail ops
        raise, and so does a batch whose tail differs from what its slot
        already carries (tail vs no tail included).  Returns the accepted
        mask when the new-series limiter rejected some samples, else
        None."""
        sig, key_ops = 0, ()
        if pipeline is not None and not pipeline.is_empty():
            key_ops = self._validate_tail(pipeline)
            if any(isinstance(op, ForwardSpec) for op in key_ops):
                mask = self.maps[mt]._mask_for(agg_id, mt)
                if bin(mask).count("1") != 1:
                    raise ValueError(
                        "a pipeline stage that forwards to a next rollup "
                        "must aggregate exactly ONE type (got mask "
                        f"{mask:#x}): multiple aggregate kinds would "
                        "conflate into one next-stage series")
            sig = self._tail_sigs.setdefault(key_ops, len(self._tail_sigs) + 1)
        slots = self.maps[mt].resolve(ids, agg_id, mt, tail_sig=sig)
        if sig:
            for s in np.unique(slots).tolist():
                if s >= 0:
                    self._pipelines[(mt, int(s))] = key_ops
        rej = slots < 0
        acc = None
        if rej.any():
            # Rate-limited series creations: drop those samples, counted.
            self.new_series_rejected += int(rej.sum())
            acc = ~rej
            slots = slots[acc]
            values = np.asarray(values)[acc]
            times = np.asarray(times)[acc]
        self.add_batch_slots(mt, slots, values, times)
        return acc

    @staticmethod
    def _validate_tail(pipeline) -> tuple:
        """Parse a pipeline tail into (transform types...,
        ForwardSpec?): transforms up to the first applied rollup op
        become this stage's consume-time transforms; the rollup op and
        everything after it become the forward target, validated here in
        full so a bad op deep in the chain fails at registration, never
        mid-consume."""
        from m3_tpu_torch.metrics.pipeline import (
            AppliedRollupOp, Pipeline, RollupOp, TransformationOp)

        tail = []
        ops = list(pipeline.ops)
        for i, op in enumerate(ops):
            if isinstance(op, TransformationOp):
                if op.type not in _SUPPORTED_TAIL:
                    raise ValueError(
                        f"unsupported pipeline transformation {op.type!r} "
                        "in rollup tail (see metrics/transformation.py)")
                if tail and tail[-1] == TransformationType.RESET:
                    # RESET's forced zero is emitted raw, past every later
                    # transform, so it must end its stage.
                    raise ValueError(
                        "RESET must be the last transformation of its "
                        "pipeline stage (its forced zero bypasses "
                        "subsequent transforms)")
                tail.append(op.type)
            elif isinstance(op, AppliedRollupOp):
                MetricList._validate_tail(Pipeline(tuple(ops[i + 1:])))
                tail.append(ForwardSpec(op.id, op.aggregation_id,
                                        tuple(ops[i + 1:])))
                break
            elif isinstance(op, RollupOp):
                raise ValueError(
                    "unapplied RollupOp in tail: rules must resolve "
                    "downstream rollups to AppliedRollupOp (rules.py "
                    "forward_match) before registration")
            else:
                raise ValueError(f"unsupported pipeline op {op!r} in tail")
        return tuple(tail)

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
        if len(slots) == 0:  # e.g. a batch fully rejected by rate limits
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
        flood allocates no slots and spends no limiter budget; a
        rate-limited creation rejects like a window violation."""
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
        rej = slots < 0
        if rej.any():
            self.new_series_rejected += int(rej.sum())
            accepted[sel[rej]] = False
            sel = sel[~rej]
            slots = slots[~rej]
            if sel.size == 0:
                return accepted
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

    def consume(self, target_nanos: int, flush_handler: FlushHandler | None = None,
                forward_sink=None) -> List[FlushedMetric]:
        """Drain every closed window (reference generic_elem.go:271
        Consume: windows with start+resolution <= target).

        Forwarded stage outputs are delivered per drained window, right
        after the window that produced them: a stage-1 aggregate of
        window t carries timestamp t+r, the window the ring just opened.
        ``forward_sink`` (the Aggregator's shard router) receives the
        entries; by default they re-ingest into this list.  The loop runs
        until no closed window remains, so after a long idle gap the
        forward chain settles before the watermark jumps the gap."""
        results = []
        deliver = forward_sink if forward_sink is not None else self.add_forwarded
        while True:
            starts = self.open_windows(target_nanos)
            if not starts:
                break
            delivered = False
            for start in starts:
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
                if self._forward_buffer:
                    buf = self._forward_buffer
                    self._forward_buffer = []
                    delivered = True
                    deliver(buf)
            if not delivered:
                break
        if self.consumed_until is not None:
            r = self.resolution
            floor_target = (target_nanos // r) * r
            if floor_target > self.consumed_until:
                # Idle gap beyond the ring: every window ingest could have
                # filled was drained above.
                self.consumed_until = floor_target
        return results

    def add_forwarded(self, entries: List[tuple]) -> None:
        """Ingest forwarded stage outputs (reference aggregator.go:395
        AddForwarded): each (ForwardSpec, value, ts) lands under the
        spec's output ID and aggregation, with any remaining ops as this
        stage's tail, on the gauge arena.  Arrivals outside the open ring
        clamp into the nearest open window (the reference's
        maxAllowedForwardingDelay: bounded skew, never silent loss).  A
        tail-signature conflict drops that group, counted in
        ``forward_errors``: raising would wedge the whole consume pass."""
        from m3_tpu_torch.metrics.pipeline import Pipeline

        groups: Dict[tuple, List[tuple]] = {}
        r = self.resolution
        hi = (None if self.consumed_until is None else
              self.consumed_until + (self.opts.num_windows - 1) * r)
        for spec, v, ts in entries:
            if self.consumed_until is not None:
                ts = min(max(ts, self.consumed_until), hi)
            groups.setdefault((spec.aggregation_id, spec.tail), []).append(
                (spec.id, v, ts))
        for (agg_id, tail), items in groups.items():
            try:
                self.add_batch(
                    MetricType.GAUGE,
                    [mid for mid, _, _ in items],
                    np.asarray([v for _, v, _ in items], np.float64),
                    np.asarray([ts for _, _, ts in items], np.int64),
                    agg_id,
                    pipeline=Pipeline(tail) if tail else None,
                )
            except ValueError:
                self.forward_errors += len(items)

    def expire(self, now_nanos: int, ttl_nanos: int) -> int:
        """Release slots idle for longer than ttl (reference map.go
        deleteExpired / entry.go ShouldExpire): reads the device last_at
        column, frees matching slots in every map, and clears each freed
        slot's arena state, tail and transform state, so a recycled slot
        starts empty."""
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
            if self._pipelines or self._tf_state:
                dead = set(stale.tolist())
                for k in [k for k in self._pipelines
                          if k[0] == mt and k[1] in dead]:
                    del self._pipelines[k]
                for k in [k for k in self._tf_state
                          if k[0] == mt and k[1] in dead]:
                    del self._tf_state[k]
        return released

    def _emit(self, mt, arena, lanes, counts, ts) -> List[FlushedMetric]:
        """0, 1 or 2 FlushedMetrics for one drained window: the window's
        aggregates, plus (when some slot's tail carries RESET) the
        forced-zero batch half a resolution later."""
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
        flushed = FlushedMetric(
            policy=self.policy,
            timestamp_nanos=ts,
            slots=np.concatenate(out_slots),
            types=np.concatenate(out_types),
            values=np.concatenate(out_vals),
            metric_type=mt,
        )
        if self._pipelines:
            return self._apply_tails(flushed)
        return [flushed]

    def _apply_tails(self, fm: FlushedMetric) -> List[FlushedMetric]:
        """Run each pipeline-carrying slot's transform tail over its
        window aggregates (reference generic_elem.go:271-380), row by row
        on the host as the reference does.  Rows whose binary transform
        has no usable previous value (first window, time going
        backwards, negative delta for monotonic transforms) are dropped;
        a forwarding row leaves for the next stage instead of flushing.
        RESET rows add a forced zero half a resolution later
        (unary_multi.go transformReset), on the local path only."""
        mt, ts = fm.metric_type, fm.timestamp_nanos
        piped = np.fromiter(
            (s for (m, s) in self._pipelines if m == mt), np.int64)
        if piped.size == 0:
            return [fm]
        hits = np.nonzero(np.isin(fm.slots, piped))[0]
        if hits.size == 0:
            return [fm]
        values = fm.values.copy()
        keep = np.ones(len(values), bool)
        reset_rows: List[int] = []
        state = self._tf_state
        for i in hits:
            slot, t_ = fm.slots[i], fm.types[i]
            tail = self._pipelines[(mt, int(slot))]
            v = float(values[i])
            want_reset = False
            for k, tt in enumerate(tail):
                skey = (mt, int(slot), int(t_), k)
                if isinstance(tt, ForwardSpec):
                    # this stage's (transformed) aggregate goes to the next
                    # stage's owner; the extra RESET datapoint never does
                    self._forward_buffer.append((tt, v, ts))
                    keep[i] = False
                    break
                if tt == TransformationType.RESET:
                    want_reset = True
                elif tt == TransformationType.ABSOLUTE:
                    v = abs(v)
                elif tt == TransformationType.ADD:
                    run = state.get(skey, (0.0,))[0]
                    if not np.isnan(v):
                        run += v
                    state[skey] = (run,)
                    v = run
                else:  # PER_SECOND / INCREASE (binary, one step back)
                    # The first window has no previous value: INCREASE
                    # takes it as (NaN @ t=0), so the whole first
                    # aggregate emits; PER_SECOND drops it.
                    prev = state.get(skey)
                    state[skey] = (v, ts)
                    if prev is None:
                        if tt == TransformationType.PER_SECOND:
                            keep[i] = False
                            break
                        prev = (np.nan, 0)
                    pv, pt = prev
                    if pt >= ts or np.isnan(v):
                        keep[i] = False
                        break
                    if tt == TransformationType.PER_SECOND:
                        if np.isnan(pv) or v - pv < 0:
                            keep[i] = False
                            break
                        v = (v - pv) * 1e9 / (ts - pt)
                    else:  # INCREASE: NaN prev treated as 0
                        pv = 0.0 if np.isnan(pv) else pv
                        if v - pv < 0:
                            keep[i] = False
                            break
                        v = v - pv
            values[i] = v
            if want_reset and keep[i]:
                reset_rows.append(i)
        out: List[FlushedMetric] = []
        if not keep.all():
            if keep.any():
                out.append(FlushedMetric(
                    policy=fm.policy, timestamp_nanos=ts,
                    slots=fm.slots[keep], types=fm.types[keep],
                    values=values[keep], metric_type=mt,
                ))
        else:
            fm.values = values
            out.append(fm)
        if reset_rows:
            rows = np.asarray(reset_rows)
            out.append(FlushedMetric(
                policy=fm.policy,
                timestamp_nanos=ts + max(self.resolution // 2, 1),
                slots=fm.slots[rows].copy(),
                types=fm.types[rows].copy(),
                values=np.zeros(rows.size, np.float64),
                metric_type=mt,
            ))
        return out


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

    def __init__(self, shard_id: int, opts: AggregatorOptions,
                 new_series_limiter=None, device=None):
        self.shard_id = shard_id
        self.opts = opts
        self.lists = {sp: MetricList(sp, opts, new_series_limiter=new_series_limiter,
                                     device=device)
                      for sp in opts.storage_policies}

    def add_batch(self, mt, ids, values, times, agg_id=AggregationID.DEFAULT):
        """The first list's resolve charges the creation budget and
        decides which samples are series-rejected; follower lists ingest
        the accepted subset under a limiter bypass (one charge per
        creation across policies)."""
        lists = list(self.lists.values())
        if not lists:
            return
        acc = lists[0].add_batch(mt, ids, values, times, agg_id)
        rest = lists[1:]
        if not rest:
            return
        if acc is not None:
            sel = np.nonzero(acc)[0]
            if sel.size == 0:
                return
            ids = [ids[i] for i in sel]
            values = np.asarray(values)[sel]
            times = np.asarray(times)[sel]
        lim = lists[0].new_series_limiter
        ctx = lim.bypass() if lim is not None else contextlib.nullcontext()
        with ctx:
            for ml in rest:
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
            # The first list charges the creation budget and decides (an
            # un-seeded list seeds from the batch and may reject);
            # followers ingest what it accepted, under a bypass.
            acc = lists[0].add_timed_batch(mt, [ids[i] for i in sel], values[sel],
                                           times[sel], agg_id)
            accepted[sel] &= acc
            if len(lists) > 1:
                sub = np.nonzero(acc)[0]
                lim = lists[0].new_series_limiter
                ctx = (lim.bypass() if lim is not None
                       else contextlib.nullcontext())
                if sub.size:
                    sel2 = sel[sub]
                    ids2 = [ids[i] for i in sel2]
                    with ctx:
                        for ml in lists[1:]:
                            ml.add_timed_batch(mt, ids2, values[sel2],
                                               times[sel2], agg_id)
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

    def consume(self, target_nanos: int, flush_handler=None, forward_sink=None):
        out = []
        for sp, ml in self.lists.items():
            sink = (None if forward_sink is None
                    else functools.partial(forward_sink, sp))
            out.extend(ml.consume(target_nanos, flush_handler, sink))
        return out


class Aggregator:
    """Top-level aggregator (reference aggregator.go:101): routes metrics
    to shards by murmur3 and drives consume across shards.  Every shard's
    arenas live on ``device`` (None = CUDA; raises without one)."""

    def __init__(self, num_shards: int = 1, opts: AggregatorOptions | None = None,
                 passthrough_handler=None, device=None):
        self.opts = opts or AggregatorOptions()
        self.device = resolve_device(device)
        # One aggregator-wide creation budget shared by every shard's maps
        # (the reference rate-limits at the options level); None when
        # unlimited.
        self.new_series_limiter = None
        if self.opts.new_series_limit_per_sec > 0:
            from m3_tpu_torch.storage.limits import NewSeriesLimiter

            self.new_series_limiter = NewSeriesLimiter(
                self.opts.new_series_limit_per_sec)
        self.shards = [AggregatorShard(i, self.opts,
                                       new_series_limiter=self.new_series_limiter,
                                       device=self.device)
                       for i in range(num_shards)]
        # Passthrough output (reference passWriter): pre-aggregated
        # samples skip the arenas and go straight here.
        self.passthrough_handler = passthrough_handler
        self.passthrough_samples = 0
        # rollup-drain latency histogram, attached by
        # instrument_aggregator (None = uninstrumented)
        self._hist_drain = None

    def shard_index(self, mid: bytes) -> int:
        # murmur3(id) % numShards (aggregator.go:505, shardset.go:148).
        return shard_for(mid, len(self.shards))

    def shard_for(self, mid: bytes) -> AggregatorShard:
        return self.shards[self.shard_index(mid)]

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

    def _route_forwards(self, policy: StoragePolicy, entries: List[tuple]) -> None:
        """Per-window forward sink (consume context): add_forwarded_batch,
        non-strict — consume must not raise on a policy mismatch."""
        self.add_forwarded_batch(policy, entries, strict=False)

    def add_forwarded_batch(self, policy: StoragePolicy, entries: List[tuple],
                            strict: bool = True) -> None:
        """AddForwarded (aggregator.go:395): deliver stage outputs — from
        this process's consume pass or another aggregator — to the owning
        shard's list for ``policy``, routed by the NEXT stage's metric ID
        (forwarded_writer.go)."""
        by_shard: Dict[int, List[tuple]] = {}
        for spec, v, ts in entries:
            by_shard.setdefault(self.shard_index(spec.id), []).append((spec, v, ts))
        for sidx, items in by_shard.items():
            ml = self.shards[sidx].lists.get(policy)
            if ml is None:
                if strict:
                    raise ValueError(f"no metric list for storage policy {policy}")
                continue
            ml.add_forwarded(items)

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
        """Consume every shard in shard order; forwards route to the next
        stage's shard, so a stage-2 total lands in this pass when its
        shard comes after the source's, else in the next pass."""
        t0 = time.perf_counter()
        out = []
        for sh in self.shards:
            out.extend(sh.consume(target_nanos, flush_handler,
                                  forward_sink=self._route_forwards))
        if self._hist_drain is not None:
            self._hist_drain.record(time.perf_counter() - t0)
        return out

    def counters(self) -> dict:
        """Operational-counter snapshot summed across every shard's lists
        (reference aggregator metrics scope, aggregator.go:101 / entry.go
        reject counters)."""
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
                out["forward_errors"] += ml.forward_errors
                out["timed_rejects_too_early"] += ml.timed_rejects["too_early"]
                out["timed_rejects_too_far_future"] += (
                    ml.timed_rejects["too_far_future"])
                out["new_series_rejected"] += ml.new_series_rejected
        return out


def instrument_aggregator(instrument, aggregator: "Aggregator"):
    """Mirror the aggregator's counters into gauges under
    ``<scope>.aggregator.*`` at every registry scrape, via the registry's
    collector hook, and attach the drain-latency histogram.  Returns the
    collector fn; pass it to ``registry.unregister_collector`` at
    shutdown (the registry holds a strong reference to the aggregator
    through it)."""
    scope = instrument.scope("aggregator")
    # window-drain latency, interned once here, recorded inside
    # Aggregator.consume
    aggregator._hist_drain = scope.histogram("drain_seconds")

    def collect():
        for name, v in aggregator.counters().items():
            scope.gauge(name).update(v)

    scope.registry.register_collector(collect)
    return collect
