"""Packed arena layout: sort/segment ingest and adaptive-width counter
state.  The counterpart of ``m3_tpu/aggregator/packed.py`` and the
port's default layout (``arena.resolve_layout_arg``).

Each ingest batch is one int64 key sort, then cumulative-sum
differences, one segmented scan and dense merges over the (W*C,) state:

    key    = flat_idx << AB | arrival          (AB = batch-size bits)
    sorted -> permutation + per-slot segment boundaries
    sum/sum_sq/count  = cumulative-sum differences at the boundaries
    min/max/last      = one segmented associative scan
    state update      = dense merge over the (W*C,) arena

Boundaries come from one scatter-min over the sorted slots plus a
reverse cummin.  No hand-written kernel runs here: every op is a
PyTorch tensor op on the arena's device, as the reference's are plain
XLA ops.  The scan is ``parallel.segmented.associative_scan``, which
mirrors jax's tree order, so float lanes round as the reference's do.

Counter state (SALSA / Counter Pools, arXiv:2102.12531, 2502.14699):

    base   count:CB | sum:SB (biased), a u64 word carried in int64
           (default 16/48; shifts through ``_bits.shr``)
    sq     int64 sum of squares (wraps mod 2^64)
    minmax o16(min) << 16 | o16(max): the reference's u32 word, held as
           its non-negative value in int64 (``state_from_numpy`` /
           ``state_to_numpy`` convert it exactly)

with a shared overflow pool of full-width int64 rows: a slot whose count
or sum lane would saturate, or that sees a value outside int16, moves
its exact running stats to a pool row.  Promotion is a bounded-K
compaction (``_first_k``, the reference's ``jnp.nonzero(size=K)``) with
no host sync; more than K promotions, or a full pool, set the sticky
``err`` lane, and the next ``consume`` raises ``DeviceStateError``.

Gauge state keeps f64 sum/sum_sq/min/max and the f64 bits of ``last``.
Timer state is one u64 word per buffered sample, ``slot << 32 |
orderable_f32(value)``: ingest appends words, the drain sorts them and
recovers moments with the same scan (f32 value precision, exact counts).

State tensors live on the arena's device.  The ingest, reset and clear
functions may update the state they are given in place, and return the
new state (the reference donates its state to the same functions);
consume only reads.  As in the f64 layout, each arena reserves its
footprint with ``x.membudget`` and runs its ingest, drain, reset and
clear behind ``x.devguard``'s stages, with no fallback.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from m3_tpu_torch import resolve_device
from m3_tpu_torch._bits import shr
from m3_tpu_torch.aggregator.arena import (
    I64_MAX,
    I64_MIN,
    _Arena,
    _clear_index,
    _grown,
    _guarded_consume,
    _guarded_ingest,
    _guarded_state_op,
    _mean,
    _sanitize_slots,
    _scatter_max_drop,
    _ScalarLanesMixin,
    _stdev,
    _TimerLanesMixin,
    decode_orderable_f32,
    orderable_f32,
    timer_append_plan,
)
from m3_tpu_torch.parallel.segmented import associative_scan
from m3_tpu_torch.x import membudget
from m3_tpu_torch.x.devguard import DeviceStateError

# (count bits, sum bits) of the counter base word; tests pass narrower
# widths to exercise promotion.
DEFAULT_WIDTHS = (16, 48)
# Bounded promotion fan-out per ingest batch.
PROMOTE_K = 4096
# int16-exact min/max range of the base minmax word.
_MM_LO = -(1 << 15)
_MM_HI = (1 << 15) - 1
_MM_NEUTRAL = 0xFFFF0000  # min lane 0xFFFF (+32767), max lane 0 (-32768)

_ERR_PROMOTE_K = 1  # more than K promotions/active pool slots in a batch
_ERR_POOL_FULL = 2  # overflow pool exhausted
# timer sample-buffer overflow: raised only in the sharded step's
# lanes["err"] (the host PackedTimerArena grows its buffer instead)
_ERR_TIMER_OVERFLOW = 4


# ---------------------------------------------------------------------------
# Masked writes without a host sync (the reference's mode="drop").
# ---------------------------------------------------------------------------


def _first_k(mask, k: int, fill: int):
    """``jnp.nonzero(mask, size=k, fill_value=fill)[0]``: the first k
    positions where ``mask`` holds, ascending, padded with ``fill``.
    The rank of each hit comes from a cumsum; the hits scatter into a
    (k + 1)-long buffer whose last entry takes the rest."""
    rank = torch.cumsum(mask, 0) - 1
    dst = torch.where(mask & (rank < k), rank, k)
    out = torch.full((k + 1,), fill, dtype=torch.int64, device=mask.device)
    out.scatter_(0, dst, torch.arange(mask.shape[0], dtype=torch.int64, device=mask.device))
    return out[:k]


def _set_drop(col, idx, vals):
    """``col.at[idx].set(vals, mode="drop")`` in place for idx >= 0 with
    unique kept indices.  A dropped entry rewrites the first kept
    entry's target with that entry's value (or ``col[0]`` with itself
    when none is kept), so duplicate writes always agree."""
    keep = idx < col.shape[0]
    i0 = torch.argmax(keep.to(torch.uint8))
    t0 = torch.where(keep[i0], idx[i0], 0)
    v0 = torch.where(keep[i0], vals[i0], col[0])
    col.index_put_((torch.where(keep, idx, t0),), torch.where(keep, vals, v0).to(col.dtype))


def _add_drop(col, idx, vals):
    """``col.at[idx].add(vals, mode="drop")`` in place for idx >= 0."""
    keep = idx < col.shape[0]
    col.index_add_(0, torch.where(keep, idx, 0), torch.where(keep, vals, 0))


def _reduce_drop(col, idx, vals, op: str, identity: int):
    """``col.at[idx].min/max(vals, mode="drop")`` in place for idx >= 0."""
    keep = idx < col.shape[0]
    col.scatter_reduce_(0, torch.where(keep, idx, 0), torch.where(keep, vals, identity), op,
                        include_self=True)


def _fmin(a, b):
    """``jnp.minimum`` on f64: NaN if either is NaN, and -0 below +0
    (``torch.minimum`` on the CPU picks either zero)."""
    r = torch.where((a < b) | ((a == b) & torch.signbit(a)), a, b)
    return torch.where(torch.isnan(a) | torch.isnan(b), a + b, r)


def _fmax(a, b):
    """``jnp.maximum`` on f64: NaN if either is NaN, and +0 above -0."""
    r = torch.where((a > b) | ((a == b) & ~torch.signbit(a)), a, b)
    return torch.where(torch.isnan(a) | torch.isnan(b), a + b, r)


# ---------------------------------------------------------------------------
# Shared sort/segment machinery
# ---------------------------------------------------------------------------


class _Segments(NamedTuple):
    """One sorted batch view: permutation + dense per-slot boundaries."""

    perm: torch.Tensor  # i64 (N,) original position of sorted element
    head: torch.Tensor  # bool (N,) first element of its segment
    start: torch.Tensor  # i64 (WC,) first sorted position per dense slot
    end: torch.Tensor  # i64 (WC,) one past last sorted position
    cnt: torch.Tensor  # i64 (WC,) segment length (0 for empty slots)
    has: torch.Tensor  # bool (WC,)


def _arrival_bits(n: int) -> int:
    return max(1, (max(n - 1, 1)).bit_length())


def packed_flat_index(windows, slots, num_windows: int, capacity: int):
    """Flat index with a slot-only GHOST region: [0, W*C) carries stats;
    [W*C, W*C+C) holds samples whose slot is valid but whose window
    dropped (they only move the slot's ``last_at``, as in the f64
    arenas); W*C+C drops entirely."""
    valid_s = (slots >= 0) & (slots < capacity)
    valid_w = (windows >= 0) & (windows < num_windows)
    wc = num_windows * capacity
    s = slots.long()
    return torch.where(valid_w & valid_s, windows.long() * capacity + s,
                       torch.where(valid_s, wc + s, wc + capacity))


def _segment_view(idx, n_flat: int) -> _Segments:
    """Sort a batch of flat indices into dense per-slot segments.  An
    index == n_flat is the drop sentinel: it sorts to the tail, outside
    every dense slot's [start, end)."""
    n = idx.shape[0]
    ab = _arrival_bits(n)
    if (n_flat + 1).bit_length() + ab > 63:
        raise ValueError(
            f"arena of {n_flat} flat slots with batches of {n} needs "
            f"{(n_flat + 1).bit_length() + ab} key bits > 63; shrink the "
            "batch or the arena")
    dev = idx.device
    ar = torch.arange(n, dtype=torch.int64, device=dev)
    # the key fits 63 bits (checked above), so the int64 sort is the
    # reference's u64 sort
    ks = torch.sort((idx.long() << ab) | ar).values
    perm = ks & ((1 << ab) - 1)
    sslot = ks >> ab
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = sslot[1:] != sslot[:-1]
    # Dense boundaries: a scatter-min marks each slot's first sorted
    # position (every sslot, the sentinel included, is in range); a
    # reverse cummin over the NEXT slots' starts yields the ends (empty
    # slots collapse to start > end -> cnt 0).
    bpos = torch.full((n_flat + 1,), n, dtype=torch.int64, device=dev)
    bpos.scatter_reduce_(0, sslot, ar, "amin", include_self=True)
    start = bpos[:n_flat]
    end = torch.cummin(bpos[1:].flip(0), 0).values.flip(0)
    cnt = (end - start).clamp_min(0)
    return _Segments(perm, head, start, end, cnt, cnt > 0)


def _seg_sum_i64(seg: _Segments, v_sorted):
    """Per-slot sums of a sorted int64 lane by cumulative-sum differences
    (wrapping mod 2^64, as the scatter path's int64 adds)."""
    cs = torch.zeros(v_sorted.shape[0] + 1, dtype=torch.int64, device=v_sorted.device)
    torch.cumsum(v_sorted, 0, out=cs[1:])
    return torch.where(seg.has, cs[seg.end] - cs[seg.start], 0)


def _seg_scan(seg: _Segments, lanes: tuple, combine) -> tuple:
    """Segmented associative scan over the sorted batch: ``combine``
    merges two within-segment prefixes; segment heads reset the carry.
    Returns the raw scanned lanes (gather with ``_at_ends``)."""
    def op(a, b):
        fb = b[0]
        merged = combine(a[1:], b[1:])
        return (a[0] | fb,) + tuple(torch.where(fb, nb, m) for nb, m in zip(b[1:], merged))

    return associative_scan(op, (seg.head,) + tuple(lanes))[1:]


def _at_ends(end, lane):
    """The scanned lane at each segment's last element (callers mask
    empty slots via their ``has``)."""
    return lane[(end - 1).clamp(0, lane.shape[0] - 1)]


def _stats_view(seg: _Segments, wc: int) -> _Segments:
    """The [0, W*C) stats region of a ghost-extended segment view."""
    return seg._replace(start=seg.start[:wc], end=seg.end[:wc],
                        cnt=seg.cnt[:wc], has=seg.has[:wc])


def _merge_last_at(last_at, d_tmax, num_windows: int, capacity: int):
    """Fold per-flat-slot batch max-times (the ghost region included)
    into the per-slot expiry column."""
    return torch.maximum(last_at, d_tmax.reshape(num_windows + 1, capacity).amax(0))


# ---------------------------------------------------------------------------
# Packed counter arena
# ---------------------------------------------------------------------------


class PackedCounterState(NamedTuple):
    base: torch.Tensor  # i64 (W*C,) u64 bits: count | sum (biased)
    sq: torch.Tensor  # i64 (W*C,) sum of squares (wraps mod 2^64)
    minmax: torch.Tensor  # i64 (W*C,) the u32 o16(min)<<16 | o16(max)
    pool_cnt: torch.Tensor  # i64 (P,)
    pool_sum: torch.Tensor  # i64 (P,)
    pool_sq: torch.Tensor  # i64 (P,)
    pool_min: torch.Tensor  # i64 (P,)
    pool_max: torch.Tensor  # i64 (P,)
    pool_owner: torch.Tensor  # i32 (P,) flat owner idx, -1 free
    pool_idx: torch.Tensor  # i32 (W*C,) pool row, -1 unpromoted
    pool_n: torch.Tensor  # i32 () live pool rows (derived from pool_owner)
    err: torch.Tensor  # i32 () sticky error bits
    last_at: torch.Tensor  # i64 (C,)


def _neutral_base(widths: tuple) -> int:
    return 1 << (widths[1] - 1)  # count 0, sum at the bias


def _unpack_base(base, widths: tuple):
    cb, sb = widths
    return shr(base, sb), (base & ((1 << sb) - 1)) - (1 << (sb - 1))


def _pack_base(cnt, s, widths: tuple):
    cb, sb = widths
    return (cnt << sb) | (s + (1 << (sb - 1)))


def _unpack_minmax(mm):
    return (mm >> 16) - (1 << 15), (mm & 0xFFFF) - (1 << 15)


def _pack_minmax(mn, mx):
    return ((mn + (1 << 15)) << 16) | (mx + (1 << 15))


def counter_init(num_windows: int, capacity: int, pool_capacity: int | None = None,
                 widths: tuple = DEFAULT_WIDTHS, device=None) -> PackedCounterState:
    dev = resolve_device(device)
    n = num_windows * capacity
    P = pool_capacity if pool_capacity is not None else max(64, n // 16)
    full = lambda size, v, dt=torch.int64: torch.full((size,), v, dtype=dt, device=dev)
    return PackedCounterState(
        base=full(n, _neutral_base(widths)), sq=full(n, 0), minmax=full(n, _MM_NEUTRAL),
        pool_cnt=full(P, 0), pool_sum=full(P, 0), pool_sq=full(P, 0),
        pool_min=full(P, I64_MAX), pool_max=full(P, I64_MIN),
        pool_owner=full(P, -1, torch.int32), pool_idx=full(n, -1, torch.int32),
        pool_n=torch.zeros((), dtype=torch.int32, device=dev),
        err=torch.zeros((), dtype=torch.int32, device=dev),
        last_at=full(capacity, 0),
    )


def _counter_sums(seg: _Segments, v):
    """(d_sum, d_sq, d_wide) for a sorted counter value column: d_wide
    counts the values outside int16.  (The reference packs such flag
    counts into one cumsum; with its one flag that is this cumsum.)"""
    wide = (v < _MM_LO) | (v > _MM_HI)
    return _seg_sum_i64(seg, v), _seg_sum_i64(seg, v * v), _seg_sum_i64(seg, wide.long())


def _counter_batch_segments(sview: _Segments, seg: _Segments, values, times):
    """Per-dense-slot batch aggregates for a counter batch: stats over
    the (W*C,) region, max-time over the ghost-extended domain."""
    v = values[seg.perm]
    t = times[seg.perm]
    d_sum, d_sq, d_wide = _counter_sums(sview, v)
    s_min, s_max, s_t = _seg_scan(
        seg, (v, v, t),
        lambda a, b: (torch.minimum(a[0], b[0]), torch.maximum(a[1], b[1]),
                      torch.maximum(a[2], b[2])))
    d_min = torch.where(sview.has, _at_ends(sview.end, s_min), I64_MAX)
    d_max = torch.where(sview.has, _at_ends(sview.end, s_max), I64_MIN)
    d_tmax = torch.where(seg.has, _at_ends(seg.end, s_t), I64_MIN)
    return (sview.cnt, d_sum, d_sq, d_min, d_max, d_wide), d_tmax


def _counter_merge(state: PackedCounterState, segs, last_at, num_windows: int,
                   capacity: int, widths: tuple, promote_k: int) -> PackedCounterState:
    """Dense merge of batch aggregates into the packed counter state,
    with bounded-K overflow-pool promotion."""
    cb, sb = widths
    d_cnt, d_sum, d_sq, d_min, d_max, d_wide = segs
    wc = num_windows * capacity
    K = min(promote_k, wc)
    P = state.pool_cnt.shape[0]
    dev = d_cnt.device

    b_cnt, b_sum = _unpack_base(state.base, widths)
    b_min, b_max = _unpack_minmax(state.minmax)
    # a slot with no base samples holds the int16 neutral sentinels:
    # mask them to the true identities before merging
    b_min = torch.where(b_cnt > 0, b_min, I64_MAX)
    b_max = torch.where(b_cnt > 0, b_max, I64_MIN)
    n_cnt = b_cnt + d_cnt
    n_sum = b_sum + d_sum
    n_sq = state.sq + d_sq  # full-width column: never a promote trigger
    n_min = torch.minimum(b_min, d_min)
    n_max = torch.maximum(b_max, d_max)

    promoted = state.pool_idx >= 0
    lane_over = ((n_cnt >= (1 << cb)) | (n_sum >= (1 << (sb - 1)))
                 | (n_sum < -(1 << (sb - 1))) | (d_wide > 0))
    seg_has = d_cnt > 0
    to_pool = seg_has & ~promoted & lane_over
    active = seg_has & promoted

    # The reference runs this block under lax.cond(to_pool.any() |
    # active.any()).  Here it runs every batch, to keep the host from
    # waiting on the card: with no slot to promote and none active,
    # every write below drops and pool_n / err come out unchanged.
    pool_cnt, pool_sum, pool_sq = state.pool_cnt, state.pool_sum, state.pool_sq
    pool_min, pool_max = state.pool_min, state.pool_max
    pool_owner, pool_idx = state.pool_owner, state.pool_idx
    num_new = to_pool.sum()
    kn = _first_k(to_pool, K, wc)
    valid = torch.arange(K, dtype=torch.int64, device=dev) < num_new
    # allocate from FREE rows (owner < 0): rows released by clear_slots
    # are reused; a candidate with no free row keeps pool_idx == -1
    free = _first_k(pool_owner < 0, K, P)
    room = free < P
    take = valid & room
    pids = torch.where(take, free, P)
    _set_drop(pool_idx, kn, torch.where(take, pids, -1))
    _set_drop(pool_owner, pids, kn)
    kc = kn.clamp(0, wc - 1)
    for col, lane in ((pool_cnt, n_cnt), (pool_sum, n_sum), (pool_sq, n_sq),
                      (pool_min, n_min), (pool_max, n_max)):
        _set_drop(col, pids, lane[kc])
    # already-promoted slots with batch data: add deltas to their rows
    num_act = active.sum()
    ka = _first_k(active, K, wc)
    kac = ka.clamp(0, wc - 1)
    pid_a = torch.where(ka < wc, pool_idx[kac].long(), P)
    _add_drop(pool_cnt, pid_a, d_cnt[kac])
    _add_drop(pool_sum, pid_a, d_sum[kac])
    _add_drop(pool_sq, pid_a, d_sq[kac])
    _reduce_drop(pool_min, pid_a, d_min[kac], "amin", I64_MAX)
    _reduce_drop(pool_max, pid_a, d_max[kac], "amax", I64_MIN)
    err = (state.err
           | torch.where(num_new > K, _ERR_PROMOTE_K, 0)
           | torch.where(num_act > K, _ERR_PROMOTE_K, 0)
           | torch.where((valid & ~room).any(), _ERR_POOL_FULL, 0)).to(torch.int32)
    pool_n = (pool_owner >= 0).sum().to(torch.int32)

    in_pool = pool_idx >= 0
    # pooled slots keep a neutral base word; the rest repack
    base = torch.where(
        in_pool, _neutral_base(widths),
        _pack_base(n_cnt.clamp(0, (1 << cb) - 1),
                   n_sum.clamp(-(1 << (sb - 1)), (1 << (sb - 1)) - 1), widths))
    minmax = torch.where(in_pool, _MM_NEUTRAL,
                         _pack_minmax(n_min.clamp(_MM_LO, _MM_HI), n_max.clamp(_MM_LO, _MM_HI)))
    return PackedCounterState(
        base=base, sq=torch.where(in_pool, 0, n_sq), minmax=minmax,
        pool_cnt=pool_cnt, pool_sum=pool_sum, pool_sq=pool_sq,
        pool_min=pool_min, pool_max=pool_max, pool_owner=pool_owner,
        pool_idx=pool_idx, pool_n=pool_n, err=err, last_at=last_at)


def counter_ingest(state: PackedCounterState, idx, values, times, num_windows: int,
                   capacity: int, widths: tuple = DEFAULT_WIDTHS,
                   promote_k: int = PROMOTE_K) -> PackedCounterState:
    """``idx``: int64 (N,) from ``packed_flat_index``; ``values`` int64."""
    wc = num_windows * capacity
    seg = _segment_view(idx, wc + capacity)
    d, d_tmax = _counter_batch_segments(_stats_view(seg, wc), seg, values, times)
    last_at = _merge_last_at(state.last_at, d_tmax, num_windows, capacity)
    return _counter_merge(state, d, last_at, num_windows, capacity, widths, promote_k)


def _counter_lanes(state: PackedCounterState, widths: tuple):
    """Dense (W*C,) full-precision stat lanes merging base and pool."""
    b_cnt, b_sum = _unpack_base(state.base, widths)
    b_min, b_max = _unpack_minmax(state.minmax)
    in_pool = state.pool_idx >= 0
    pidx = state.pool_idx.long().clamp(0, state.pool_cnt.shape[0] - 1)
    cnt = torch.where(in_pool, state.pool_cnt[pidx], b_cnt)
    s = torch.where(in_pool, state.pool_sum[pidx], b_sum)
    sq = torch.where(in_pool, state.pool_sq[pidx], state.sq)
    mn = torch.where(in_pool, state.pool_min[pidx], torch.where(b_cnt > 0, b_min, I64_MAX))
    mx = torch.where(in_pool, state.pool_max[pidx], torch.where(b_cnt > 0, b_max, I64_MIN))
    return cnt, s, sq, mn, mx


def counter_consume(state: PackedCounterState, window: int, capacity: int,
                    widths: tuple = DEFAULT_WIDTHS):
    """Drain one window row -> ((C, 8) f64 lanes, (C,) int64 counts)."""
    off = window * capacity
    sl = lambda a: a[off:off + capacity]
    cnt_a, s_a, sq_a, mn_a, mx_a = _counter_lanes(state, widths)
    cnt = sl(cnt_a)
    s = sl(s_a).double()
    ssq = sl(sq_a).double()
    cntf = cnt.double()
    lanes = torch.stack(
        [
            torch.full((capacity,), float("nan"), dtype=torch.float64, device=s.device),
            torch.where(cnt == 0, 0.0, sl(mn_a).double()),
            torch.where(cnt == 0, 0.0, sl(mx_a).double()),
            _mean(s, cnt),
            cntf,
            s,
            ssq,
            _stdev(cntf, ssq, s),
        ],
        dim=1,
    )
    return lanes, cnt


def counter_reset_window(state: PackedCounterState, window: int, num_windows: int,
                         capacity: int, widths: tuple = DEFAULT_WIDTHS) -> PackedCounterState:
    off = window * capacity
    state.base[off:off + capacity] = _neutral_base(widths)
    state.sq[off:off + capacity] = 0
    state.minmax[off:off + capacity] = _MM_NEUTRAL
    # pool rows owned by this window reset densely over P
    own_w = torch.where(state.pool_owner >= 0, state.pool_owner // capacity, -1)
    hit = own_w == window
    for col, v in ((state.pool_cnt, 0), (state.pool_sum, 0), (state.pool_sq, 0),
                   (state.pool_min, I64_MAX), (state.pool_max, I64_MIN)):
        col.masked_fill_(hit, v)
    return state


def _sorted_hit(slots, keys):
    """Which ``keys`` equal one of ``slots`` (the reference's sorted
    membership probe: sort, searchsorted, compare)."""
    ss = torch.sort(slots.to(torch.int32)).values
    pos = torch.searchsorted(ss, keys.to(torch.int32)).clamp(0, ss.shape[0] - 1)
    return ss[pos] == keys


def counter_clear_slots(state: PackedCounterState, slots, num_windows: int, capacity: int,
                        widths: tuple = DEFAULT_WIDTHS) -> PackedCounterState:
    """Clear slots in every window row, as the reference does: a
    negative slot wraps (``arena._clear_index``); pool rows whose owner
    slot is cleared are released (owner -1) for reuse — matched on the
    slots as given, so a wrapped negative slot releases none."""
    at, idx = _clear_index(slots, num_windows, capacity)
    own_slot = torch.where(state.pool_owner >= 0, state.pool_owner % capacity, -1)
    hit = _sorted_hit(slots, own_slot) & (state.pool_owner >= 0)
    state.base[idx] = _neutral_base(widths)
    state.sq[idx] = 0
    state.minmax[idx] = _MM_NEUTRAL
    for col, v in ((state.pool_cnt, 0), (state.pool_sum, 0), (state.pool_sq, 0),
                   (state.pool_min, I64_MAX), (state.pool_max, I64_MIN),
                   (state.pool_owner, -1)):
        col.masked_fill_(hit, v)
    state.pool_idx[idx] = -1
    state.last_at[at] = 0
    return state._replace(pool_n=(state.pool_owner >= 0).sum().to(torch.int32))


# ---------------------------------------------------------------------------
# Packed gauge arena
# ---------------------------------------------------------------------------


class PackedGaugeState(NamedTuple):
    sum: torch.Tensor  # f64 (W*C,)
    sum_sq: torch.Tensor  # f64
    count: torch.Tensor  # i64
    min: torch.Tensor  # f64, identity +inf
    max: torch.Tensor  # f64, identity -inf
    last_bits: torch.Tensor  # i64 (W*C,) f64 bit pattern of `last`
    last_time: torch.Tensor  # i64
    last_at: torch.Tensor  # i64 (C,)


def gauge_init(num_windows: int, capacity: int, device=None) -> PackedGaugeState:
    dev = resolve_device(device)
    n = num_windows * capacity
    f = lambda v: torch.full((n,), v, dtype=torch.float64, device=dev)
    i = lambda size: torch.zeros(size, dtype=torch.int64, device=dev)
    return PackedGaugeState(sum=f(0.0), sum_sq=f(0.0), count=i(n), min=f(float("inf")),
                            max=f(float("-inf")), last_bits=i(n), last_time=i(n),
                            last_at=i(capacity))


def _gauge_scan_lanes(v, t):
    """Scan input lanes (sum, sum_sq, min, max, tmax, last-bits).  Sum
    lanes exclude NaN (count still carries it) and pass ±inf through."""
    nan = torch.isnan(v)
    safe = torch.where(nan, 0.0, v)
    return (safe, safe * safe, torch.where(nan, float("inf"), v),
            torch.where(nan, float("-inf"), v), t, v.view(torch.int64))


def _gauge_scan_combine(a, b):
    """(sum, sum_sq, min, max, tmax, last-bits) segmented combine; last
    is the value of the strictly-greatest time (sorted ties: the first
    arrival wins).  The min/max lanes hold no NaN, and which zero wins
    a -0/+0 tie cannot show (the scan returns +0 for every zero)."""
    return (
        a[0] + b[0],
        a[1] + b[1],
        torch.minimum(a[2], b[2]),
        torch.maximum(a[3], b[3]),
        torch.maximum(a[4], b[4]),
        torch.where(b[4] > a[4], b[5], a[5]),
    )


def _gauge_gather(sview: _Segments, seg: _Segments, scanned: tuple):
    """Per-slot gauge aggregates from the raw scanned lanes."""
    s_sum, s_sq, s_min, s_max, s_t, s_lastb = scanned
    at = lambda lane: _at_ends(sview.end, lane)
    d_sum = torch.where(sview.has, at(s_sum), 0.0)
    d_sq = torch.where(sview.has, at(s_sq), 0.0)
    d_min = torch.where(sview.has, at(s_min), float("inf"))
    d_max = torch.where(sview.has, at(s_max), float("-inf"))
    d_t = torch.where(sview.has, at(s_t), I64_MIN)
    d_lastb = at(s_lastb)
    d_tmax = torch.where(seg.has, _at_ends(seg.end, s_t), I64_MIN)
    return (sview.cnt, d_sum, d_sq, d_min, d_max, d_t, d_lastb), d_tmax


def _gauge_merge(state: PackedGaugeState, segs, last_at) -> PackedGaugeState:
    d_cnt, d_sum, d_sq, d_min, d_max, d_t, d_lastb = segs
    has = d_cnt > 0
    replace = has & (d_t > state.last_time)
    return PackedGaugeState(
        sum=torch.where(has, state.sum + d_sum, state.sum),
        sum_sq=torch.where(has, state.sum_sq + d_sq, state.sum_sq),
        count=state.count + d_cnt,
        min=_fmin(state.min, d_min),
        max=_fmax(state.max, d_max),
        last_bits=torch.where(replace, d_lastb, state.last_bits),
        last_time=torch.where(replace, d_t, state.last_time),
        last_at=last_at,
    )


def gauge_ingest(state: PackedGaugeState, idx, values, times, num_windows: int,
                 capacity: int) -> PackedGaugeState:
    """``idx``: int64 (N,) from ``packed_flat_index``; ``values`` f64."""
    wc = num_windows * capacity
    seg = _segment_view(idx, wc + capacity)
    v = values[seg.perm]
    t = times[seg.perm]
    scanned = _seg_scan(seg, _gauge_scan_lanes(v, t), _gauge_scan_combine)
    d, d_tmax = _gauge_gather(_stats_view(seg, wc), seg, scanned)
    last_at = _merge_last_at(state.last_at, d_tmax, num_windows, capacity)
    return _gauge_merge(state, d, last_at)


def gauge_consume(state: PackedGaugeState, window: int, capacity: int):
    off = window * capacity
    sl = lambda a: a[off:off + capacity]
    s, ssq, cnt = sl(state.sum), sl(state.sum_sq), sl(state.count)
    cntf = cnt.double()
    mx, mn = sl(state.max), sl(state.min)
    lanes = torch.stack(
        [
            sl(state.last_bits).view(torch.float64),
            torch.where(torch.isinf(mn), float("nan"), mn),
            torch.where(torch.isinf(mx), float("nan"), mx),
            _mean(s, cnt),
            cntf,
            s,
            ssq,
            _stdev(cntf, ssq, s),
        ],
        dim=1,
    )
    return lanes, cnt.clone()  # no view of the state: resets write in place


def gauge_reset_window(state: PackedGaugeState, window: int, capacity: int) -> PackedGaugeState:
    off = window * capacity
    for col, v in ((state.sum, 0.0), (state.sum_sq, 0.0), (state.count, 0),
                   (state.min, float("inf")), (state.max, float("-inf")),
                   (state.last_bits, 0), (state.last_time, 0)):
        col[off:off + capacity] = v
    return state


def gauge_clear_slots(state: PackedGaugeState, slots, num_windows: int,
                      capacity: int) -> PackedGaugeState:
    at, idx = _clear_index(slots, num_windows, capacity)
    for col, v in ((state.sum, 0.0), (state.sum_sq, 0.0), (state.count, 0),
                   (state.min, float("inf")), (state.max, float("-inf")),
                   (state.last_bits, 0), (state.last_time, 0)):
        col[idx] = v
    state.last_at[at] = 0
    return state


# ---------------------------------------------------------------------------
# Fused counter+gauge rollup ingest (one sort serves both arenas)
# ---------------------------------------------------------------------------


def rollup_ingest(cstate: PackedCounterState, gstate: PackedGaugeState, idx, cvalues, gvalues,
                  times, num_windows: int, capacity: int, widths: tuple = DEFAULT_WIDTHS,
                  promote_k: int = PROMOTE_K):
    """One routed batch into both a counter and a gauge state: one sort
    and one scan (counter min/max lanes prepended to the gauge lanes)."""
    wc = num_windows * capacity
    seg = _segment_view(idx, wc + capacity)
    sview = _stats_view(seg, wc)
    cv = cvalues[seg.perm]
    gv = gvalues[seg.perm]
    t = times[seg.perm]
    c_sum, c_sq, d_wide = _counter_sums(sview, cv)

    def combine(a, b):
        return ((torch.minimum(a[0], b[0]), torch.maximum(a[1], b[1]))
                + _gauge_scan_combine(a[2:], b[2:]))

    scanned = _seg_scan(seg, (cv, cv) + _gauge_scan_lanes(gv, t), combine)
    c_min = torch.where(sview.has, _at_ends(sview.end, scanned[0]), I64_MAX)
    c_max = torch.where(sview.has, _at_ends(sview.end, scanned[1]), I64_MIN)
    gd, d_tmax = _gauge_gather(sview, seg, scanned[2:])
    c_last = _merge_last_at(cstate.last_at, d_tmax, num_windows, capacity)
    g_last = _merge_last_at(gstate.last_at, d_tmax, num_windows, capacity)
    cd = (sview.cnt, c_sum, c_sq, c_min, c_max, d_wide)
    return (_counter_merge(cstate, cd, c_last, num_windows, capacity, widths, promote_k),
            _gauge_merge(gstate, gd, g_last))


# ---------------------------------------------------------------------------
# Packed timer arena: u64 sample words, moments recovered at drain
# ---------------------------------------------------------------------------


class PackedTimerState(NamedTuple):
    sample: torch.Tensor  # i64 (W, S) u64 bits: slot<<32 | orderable_f32(value)
    sample_n: torch.Tensor  # i64 (W,) write offsets (> S = overflow)
    last_at: torch.Tensor  # i64 (C,)


def _timer_empty_word(capacity: int) -> int:
    """The empty sample word: slot == capacity sorts past every slot."""
    return capacity << 32


def timer_init(num_windows: int, capacity: int, sample_capacity: int,
               device=None) -> PackedTimerState:
    dev = resolve_device(device)
    return PackedTimerState(
        sample=torch.full((num_windows, sample_capacity), _timer_empty_word(capacity),
                          dtype=torch.int64, device=dev),
        sample_n=torch.zeros(num_windows, dtype=torch.int64, device=dev),
        last_at=torch.zeros(capacity, dtype=torch.int64, device=dev),
    )


def timer_ingest(state: PackedTimerState, windows, slots, values, times,
                 capacity: int) -> PackedTimerState:
    """Append a batch as packed words (the shared append plan; dropped
    samples take no room) and fold its times into ``last_at``."""
    num_w, scap = state.sample.shape
    _drop, flat, per_w_counts = timer_append_plan(windows, slots, state.sample_n, capacity, scap)
    word = (slots.long() << 32) | orderable_f32(values)
    _set_drop(state.sample.view(-1), flat, word)
    _scatter_max_drop(state.last_at, _sanitize_slots(slots, capacity), times)
    return state._replace(sample_n=state.sample_n + per_w_counts)


def timer_consume(state: PackedTimerState, window: int, capacity: int, quantiles: tuple):
    """Drain one window: sort the words (slot asc, value asc in f32
    order), counts from boundaries, sum/sum_sq from a segmented scan of
    the decoded values, min/max/quantiles from rank positions
    ``ceil(q*n) - 1``."""
    scap = state.sample.shape[1]
    keys = torch.sort(state.sample[window]).values
    s_slot = (keys >> 32).to(torch.int32)  # words are non-negative
    s_val = decode_orderable_f32(keys & 0xFFFFFFFF)

    qs = torch.arange(capacity, dtype=torch.int32, device=keys.device)
    seg_start = torch.searchsorted(s_slot, qs)
    seg_end = torch.searchsorted(s_slot, qs, right=True)
    seg_n = seg_end - seg_start
    empty = seg_n == 0

    # Moments from a segmented scan over the sorted words; empty words
    # decode to NaN and are masked out.
    v = torch.where(s_slot < capacity, s_val, 0.0)
    head = torch.ones(scap, dtype=torch.bool, device=keys.device)
    head[1:] = s_slot[1:] != s_slot[:-1]

    def op(a, b):
        fb = b[0]
        return (a[0] | fb, torch.where(fb, b[1], a[1] + b[1]),
                torch.where(fb, b[2], a[2] + b[2]))

    _, s_sums, s_sqs = associative_scan(op, (head, v, v * v))
    lp = (seg_end - 1).clamp(0, scap - 1)
    s = torch.where(empty, 0.0, s_sums[lp])
    ssq = torch.where(empty, 0.0, s_sqs[lp])
    cntf = seg_n.double()
    mean = torch.where(empty, 0.0, s / torch.where(empty, 1.0, cntf))
    at = lambda pos: s_val[pos.clamp(0, scap - 1)]
    mn = torch.where(empty, 0.0, at(seg_start))
    mx = torch.where(empty, 0.0, at(seg_end - 1))

    qlanes = []
    for q in quantiles:
        ranks = torch.ceil(q * cntf).long() - 1
        ranks = torch.minimum(ranks.clamp(min=0), (seg_n - 1).clamp(min=0))
        qlanes.append(torch.where(empty, 0.0, at(seg_start + ranks)))

    lanes = torch.stack(
        [
            torch.full((capacity,), float("nan"), dtype=torch.float64, device=keys.device),
            mn,
            mx,
            mean,
            cntf,
            s,
            ssq,
            _stdev(cntf, ssq, s),
            *qlanes,
        ],
        dim=1,
    )
    return lanes, seg_n


def timer_reset_window(state: PackedTimerState, window: int, capacity: int) -> PackedTimerState:
    state.sample[window] = _timer_empty_word(capacity)
    state.sample_n[window] = 0
    return state


def timer_clear_slots(state: PackedTimerState, slots, num_windows: int,
                      capacity: int) -> PackedTimerState:
    """Retarget cleared slots' buffered words to the empty word, so a
    recycled slot's quantiles can't include the previous occupant (a
    negative slot wraps for ``last_at`` only, as in the reference)."""
    at, _ = _clear_index(slots, num_windows, capacity)
    hit = _sorted_hit(slots, shr(state.sample, 32))
    state.sample.masked_fill_(hit, _timer_empty_word(capacity))
    state.last_at[at] = 0
    return state


# ---------------------------------------------------------------------------
# Host wrappers (drop-in for arena.CounterArena / GaugeArena / TimerArena)
# ---------------------------------------------------------------------------


class PackedCounterArena(_ScalarLanesMixin, _Arena):
    """Packed counter slots: adaptive-width base + overflow pool."""

    def __init__(self, num_windows: int, capacity: int, pool_capacity: int | None = None,
                 widths: tuple = DEFAULT_WIDTHS, promote_k: int = PROMOTE_K, device=None):
        super().__init__(num_windows, capacity, device)
        self.widths = tuple(widths)
        self.promote_k = promote_k
        self.state = self._alloc(
            "aggregator.counter",
            membudget.counter_arena_bytes("packed", num_windows, capacity,
                                          pool_capacity),
            lambda: counter_init(num_windows, capacity, pool_capacity, self.widths,
                                 self.device))

    def _check_err(self):
        err = int(self.state.err)
        if err:
            what = []
            if err & _ERR_PROMOTE_K:
                what.append(f"more than promote_k={self.promote_k} pool "
                            "promotions/updates in one batch")
            if err & _ERR_POOL_FULL:
                what.append("overflow pool exhausted")
            # Raise once, then clear: the window ring's drain+reset
            # washes the clipped rows out within W drains; a recurring
            # condition sets the flag again and raises again.
            self.state = self.state._replace(err=torch.zeros_like(self.state.err))
            raise DeviceStateError(
                "arena.consume",
                "packed counter arena overflow-pool error: " + "; ".join(what)
                + " — grow pool_capacity/promote_k or use the f64 layout"
                " (layout='f64'); stats since the previous consume are "
                "unreliable (flag cleared: the window ring washes the damage "
                "out over the next drains)")

    def ingest(self, windows, slots, values, times):
        def call():
            w, s, v, t = self._batch(windows, slots, values, times, torch.int64)
            idx = packed_flat_index(w, s, self.num_windows, self.capacity)
            return counter_ingest(self.state, idx, v, t, self.num_windows,
                                  self.capacity, self.widths, self.promote_k)

        self.state = _guarded_ingest(call)

    def consume(self, window: int):
        self._check_err()
        return _guarded_consume(lambda: counter_consume(
            self.state, window, self.capacity, self.widths))

    def reset_window(self, window: int):
        self.state = _guarded_state_op(lambda: counter_reset_window(
            self.state, window, self.num_windows, self.capacity, self.widths))

    def clear_slots(self, slots):
        self.state = _guarded_state_op(lambda: counter_clear_slots(
            self.state, self._slots(slots), self.num_windows, self.capacity,
            self.widths))


class PackedGaugeArena(_ScalarLanesMixin, _Arena):
    def __init__(self, num_windows: int, capacity: int, device=None):
        super().__init__(num_windows, capacity, device)
        self.state = self._alloc(
            "aggregator.gauge",
            membudget.gauge_arena_bytes("packed", num_windows, capacity),
            lambda: gauge_init(num_windows, capacity, self.device))

    def ingest(self, windows, slots, values, times):
        def call():
            w, s, v, t = self._batch(windows, slots, values, times, torch.float64)
            idx = packed_flat_index(w, s, self.num_windows, self.capacity)
            return gauge_ingest(self.state, idx, v, t, self.num_windows,
                                self.capacity)

        self.state = _guarded_ingest(call)

    def consume(self, window: int):
        return _guarded_consume(lambda: gauge_consume(
            self.state, window, self.capacity))

    def reset_window(self, window: int):
        self.state = _guarded_state_op(lambda: gauge_reset_window(
            self.state, window, self.capacity))

    def clear_slots(self, slots):
        self.state = _guarded_state_op(lambda: gauge_clear_slots(
            self.state, self._slots(slots), self.num_windows, self.capacity))


class PackedTimerArena(_TimerLanesMixin, _Arena):
    DEFAULT_QUANTILES = (0.5, 0.95, 0.99)

    def __init__(self, num_windows: int, capacity: int, sample_capacity: int,
                 quantiles: tuple = DEFAULT_QUANTILES, device=None):
        super().__init__(num_windows, capacity, device)
        self.sample_capacity = sample_capacity
        self.quantiles = tuple(quantiles)
        self.state = self._alloc(
            "aggregator.timer",
            membudget.timer_arena_bytes("packed", num_windows, capacity,
                                        sample_capacity),
            lambda: timer_init(num_windows, capacity, sample_capacity, self.device))
        # Host shadow of state.sample_n: the growth check needs no device
        # round trip per ingest batch.
        self._sample_n_host = np.zeros(num_windows, np.int64)

    def ingest(self, windows, slots, values, times):
        # the host sample counts read the batch's windows and slots, which
        # callers hand in from the host (a tensor argument is copied here)
        host = lambda x: x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)  # m3lint: disable=transfer-hygiene
        windows_np, slots_np = host(windows), host(slots)
        in_range = ((windows_np >= 0) & (windows_np < self.num_windows)
                    & (slots_np >= 0) & (slots_np < self.capacity))
        per_w = np.bincount(windows_np[in_range], minlength=self.num_windows)
        # commit the shadow only after the grow and the append succeed
        new_n = self._sample_n_host + per_w
        needed = int(new_n.max())
        if needed > self.sample_capacity:
            self._grow(needed)

        def call():
            w, s, v, t = self._batch(windows_np, slots_np, values, times,
                                     torch.float64)
            return timer_ingest(self.state, w, s, v, t, self.capacity)

        self.state = _guarded_ingest(call)
        self._sample_n_host = new_n

    def _grow(self, needed: int) -> None:
        new_cap = self.sample_capacity
        while new_cap < needed:
            new_cap *= 2
        self._mem.resize(membudget.timer_arena_bytes(
            "packed", self.num_windows, self.capacity, new_cap))
        st = self.state
        self.state = _grown(self._mem, membudget.timer_arena_bytes(
            "packed", self.num_windows, self.capacity, self.sample_capacity),
            lambda: st._replace(sample=torch.nn.functional.pad(
                st.sample, (0, new_cap - self.sample_capacity),
                value=_timer_empty_word(self.capacity))))
        self.sample_capacity = new_cap

    def consume(self, window: int):
        return _guarded_consume(lambda: timer_consume(
            self.state, window, self.capacity, self.quantiles))

    def reset_window(self, window: int):
        self.state = _guarded_state_op(lambda: timer_reset_window(
            self.state, window, self.capacity))
        self._sample_n_host[window] = 0

    def clear_slots(self, slots):
        self.state = _guarded_state_op(lambda: timer_clear_slots(
            self.state, self._slots(slots), self.num_windows, self.capacity))
