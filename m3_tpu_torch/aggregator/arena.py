"""Aggregation arenas, the f64 layout: per-(window, slot) statistic
tensors.  The counterpart of ``m3_tpu/aggregator/arena.py``.

Each metric type owns flat statistic tensors of shape ``(W * C,)`` — a
ring of W resolution windows by C metric slots — and an ingest batch is a
handful of segmented reductions straight into those tensors:

    sum/count/sumsq  ->  kernel ``segment_ingest`` into the state's
                         columns, each lane's points in arrival order
    min/max          ->  kernel ``segment_minmax`` into the state's
                         columns (counters, gauges)
    last (by time)   ->  stable sorts on (slot, time, -arrival) +
                         a masked write of the per-slot winners

Timer quantiles are exact: samples append into a per-window buffer and
the drain sorts (slot, value) pairs and reads ranks ``ceil(q*n) - 1``.

State tuples hold tensors on the arena's device.  The ingest, reset and
clear functions update the state they are given in place and return it
(the JAX package donates its state to the same functions); consume only
reads.  Every out-of-range index of an ingest drops, negative ones
included: the drop sentinels of the JAX package (``W*C``, ``C``,
``num_w*scap``) become masks here, since PyTorch's scatters have no
``mode="drop"``.  The ``*_clear_slots`` functions wrap a negative slot
as the reference does (see ``_clear_index``).

This is one of two layouts.  ``make_arenas`` builds the packed one
(``packed.py``) by default, as the JAX package does, and this one for
``layout="f64"``: the reference's parity oracle.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from m3_tpu_torch import resolve_device
from m3_tpu_torch.metrics.aggregation import AggregationType
from m3_tpu_torch.parallel import segment_ingest as si

I64_MIN = int(np.iinfo(np.int64).min)
I64_MAX = int(np.iinfo(np.int64).max)

# Fixed output-lane order for non-quantile statistics.  Quantile lanes are
# appended after these, in the order of the arena's `quantiles` tuple.
SCALAR_LANES = (
    AggregationType.LAST,
    AggregationType.MIN,
    AggregationType.MAX,
    AggregationType.MEAN,
    AggregationType.COUNT,
    AggregationType.SUM,
    AggregationType.SUM_SQ,
    AggregationType.STDEV,
)

LAYOUTS = ("packed", "f64", "auto")


def resolve_layout_arg(layout: str | None) -> str:
    """A layout argument -> the concrete layout.  ``None``, ``""`` and
    ``"auto"`` resolve to ``"packed"`` (the JAX package's default, which
    it also reaches through its ``M3_ARENA_LAYOUT`` seam; the port has
    no environment seam).  Anything but a known layout raises: a typo
    must not silently select another layout."""
    if not layout or layout == "auto":
        return "packed"
    if layout not in LAYOUTS:
        raise ValueError(f"unknown arena layout {layout!r}: must be one of {LAYOUTS}")
    return layout


def make_arenas(num_windows: int, capacity: int, sample_capacity: int,
                quantiles: tuple, timer_packed32: bool = False,
                layout: str | None = None, device=None):
    """(counter, gauge, timer) arenas of ``layout`` (None = packed) on
    ``device`` (None = CUDA).  ``timer_packed32`` applies to the f64
    timer only: the packed timer's words are f32-keyed already."""
    dev = resolve_device(device)
    if resolve_layout_arg(layout) == "packed":
        from m3_tpu_torch.aggregator import packed

        return (packed.PackedCounterArena(num_windows, capacity, device=dev),
                packed.PackedGaugeArena(num_windows, capacity, device=dev),
                packed.PackedTimerArena(num_windows, capacity, sample_capacity,
                                        quantiles, device=dev))
    return (CounterArena(num_windows, capacity, device=dev),
            GaugeArena(num_windows, capacity, device=dev),
            TimerArena(num_windows, capacity, sample_capacity, quantiles,
                       packed32=timer_packed32, device=dev))


def _seg3(sum_col, sq_col, cnt_col, idx, values):
    """The sum / sum² / count accumulation every arena shares: one
    ``segment_ingest`` launch into the state's own columns, each lane's
    points added in arrival order, as the reference's scatter adds them.
    ``idx`` >= len(sum_col) drops."""
    si.segment_ingest_into(sum_col, cnt_col, sq_col, idx, values)


def _minmax(max_col, min_col, idx, values):
    """Fold the batch into the state's max and min columns: one
    ``segment_minmax`` launch, the kernel's order (IEEE total order for
    floats).  The same result as a drop-mode scatter max / min."""
    si.segment_minmax_into(min_col, max_col, idx, values)


def _scatter_max_drop(col, slots, vals):
    """``col.at[slots].max(vals, mode="drop")`` for int64 columns: slots
    outside [0, len(col)) drop (negative ones too)."""
    ok = (slots >= 0) & (slots < col.shape[0])
    col.scatter_reduce_(0, torch.where(ok, slots, 0).long(),
                        torch.where(ok, vals, I64_MIN), "amax", include_self=True)


def saturating_int64(v):
    """Float to int64 as XLA converts (the reference's ``astype(int64)`` of
    counter values): toward zero, NaN to 0, out of range to the nearest
    bound.  torch's own cast leaves NaN and out-of-range values
    implementation-defined (INT64_MIN on the CPU).  A numpy array is cast
    on the host, a tensor where it lies."""
    if isinstance(v, np.ndarray):
        big = v >= 2.0**63
        small = v <= -(2.0**63)
        out = np.where(np.isnan(v) | big | small, 0.0, v).astype(np.int64)
        out[big] = I64_MAX
        out[small] = I64_MIN
        return out
    big = v >= 2.0**63
    small = v <= -(2.0**63)
    out = torch.where(torch.isnan(v) | big | small, torch.zeros_like(v), v).to(torch.int64)
    out = torch.where(big, torch.full_like(out, I64_MAX), out)
    return torch.where(small, torch.full_like(out, I64_MIN), out)


def pad_slots(slots: np.ndarray, capacity: int) -> np.ndarray:
    """Pad a slot array to the next power of two with the drop sentinel
    ``capacity`` (the JAX package bounds its jit shapes this way; the
    ``*_clear_slots`` functions here drop the pad like any slot >= C)."""
    n = max(1, len(slots))
    padded = 1 << (n - 1).bit_length()
    out = np.full(padded, capacity, np.int32)
    out[: len(slots)] = slots
    return out


def flat_window_index(windows, slots, num_windows: int, capacity: int):
    """Flatten (window ring index, slot) to the arena's (W*C,) int64 index;
    out-of-ring windows AND out-of-range slots (negative ones too) map to
    the drop sentinel W*C, so a slot >= C never aliases window w+1."""
    oob = ((windows < 0) | (windows >= num_windows)
           | (slots < 0) | (slots >= capacity))
    return torch.where(oob, num_windows * capacity,
                       windows.long() * capacity + slots.long())


def _sanitize_slots(slots, capacity: int):
    """Negative slots -> the drop sentinel C (slots >= C already drop)."""
    return torch.where(slots < 0, capacity, slots)


_F32_TINY = float(np.finfo(np.float32).tiny)


def orderable_f32(v):
    """f64 -> int64 holding order-preserving f32 bits in the low 32 (IEEE
    total order as unsigned; negatives flip entirely, positives flip the
    sign bit).  The JAX package returns the same bits as u64.  f32
    subnormals flush to a zero of their sign, as the reference's f64 ->
    f32 convert does (XLA flushes them on its CPU and TPU backends)."""
    f = v.to(torch.float32)
    f = torch.where(f.abs() < _F32_TINY, f * 0.0, f)
    b = f.view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(b >= 0x80000000, 0xFFFFFFFF - b, b | 0x80000000)


def decode_orderable_f32(bits):
    """Inverse of orderable_f32 -> f64 (carries f32 precision)."""
    b = torch.where(bits >= 0x80000000, bits & 0x7FFFFFFF, 0xFFFFFFFF - bits)
    return b.to(torch.int32).view(torch.float32).to(torch.float64)


def _sqrt(x):
    """Correctly rounded f64 square root, as XLA's and the card's are.
    PyTorch's vectorised CPU kernel is only within 1 ulp (it differs
    from ``np.sqrt`` on ~0.7 % of random inputs, sqrt(2.0) among them),
    so a CPU tensor goes through numpy."""
    if x.device.type == "cpu":
        return torch.as_tensor(np.sqrt(x.detach().numpy()))
    return torch.sqrt(x)


def _stdev(count, sum_sq, sum_):
    """Sample stdev from moments (reference aggregation/common.go:29-36),
    with ``count*sum_sq - sum^2`` clamped at 0: cancellation can round
    the true difference to a small negative number."""
    div = count * (count - 1)
    num = torch.clamp(count * sum_sq - sum_ * sum_, min=0.0)
    return torch.where(div <= 0, 0.0,
                       _sqrt(num / torch.where(div == 0, 1.0, div)))


def _mean(s, cnt):
    return torch.where(cnt == 0, 0.0, s / torch.where(cnt == 0, 1, cnt))


def _window_slice(a, window: int, capacity: int):
    off = window * capacity
    return a[off:off + capacity]


def _clear_index(slots, num_windows: int, capacity: int):
    """(``last_at`` index, flat (W*len,) index of every window row) of the
    slots to clear.  This is the reference's behaviour
    (``m3_tpu.aggregator.arena.*_clear_slots``): the flat index
    ``w*C + s`` with slots >= C sent to the drop sentinel, and a negative
    index wrapped once by the column's length as numpy indexes (dropped
    if still negative).  So slot -1 clears slot C-1 of every window and
    ``last_at[C-1]``; a slot below -C clears only some windows and
    leaves ``last_at`` alone."""
    s = slots.long()
    n = num_windows * capacity
    rows = torch.arange(num_windows, dtype=torch.int64, device=slots.device)
    flat = torch.where(s[None, :] >= capacity, n, rows[:, None] * capacity + s[None, :])

    def wrapped(i, size):
        i = torch.where(i < 0, i + size, i)
        return i[(i >= 0) & (i < size)]

    return wrapped(s, capacity), wrapped(flat.reshape(-1), n)


# ---------------------------------------------------------------------------
# Counter arena (int64 values; reference aggregation/counter.go).
# ---------------------------------------------------------------------------


class CounterState(NamedTuple):
    sum: torch.Tensor  # i64 (W*C,)
    sum_sq: torch.Tensor  # i64
    count: torch.Tensor  # i64
    max: torch.Tensor  # i64, identity I64_MIN
    min: torch.Tensor  # i64, identity I64_MAX
    last_at: torch.Tensor  # i64 (C,) — per-slot last write time, for expiry


def counter_init(num_windows: int, capacity: int, device=None) -> CounterState:
    dev = resolve_device(device)
    n = num_windows * capacity
    z = lambda: torch.zeros(n, dtype=torch.int64, device=dev)
    return CounterState(
        sum=z(), sum_sq=z(), count=z(),
        max=torch.full((n,), I64_MIN, dtype=torch.int64, device=dev),
        min=torch.full((n,), I64_MAX, dtype=torch.int64, device=dev),
        last_at=torch.zeros(capacity, dtype=torch.int64, device=dev),
    )


def counter_ingest(state: CounterState, idx, slots, values, times) -> CounterState:
    """Counter.Update for a batch (reference counter.go:53-76).  ``idx``
    is the flat window index (>= W*C drops); ``values`` int64 (v*v
    wraps, as in the reference)."""
    _seg3(state.sum, state.sum_sq, state.count, idx, values)
    _minmax(state.max, state.min, idx, values)
    _scatter_max_drop(state.last_at, _sanitize_slots(slots, state.last_at.shape[0]), times)
    return state


def counter_consume(state: CounterState, window: int, capacity: int):
    """Drain one window row -> ((C, L) f64 lanes, (C,) int64 counts).
    Last is invalid for counters and emitted as NaN."""
    sl = lambda a: _window_slice(a, window, capacity)
    s = sl(state.sum).double()
    ssq = sl(state.sum_sq).double()
    cnt = sl(state.count)
    cntf = cnt.double()
    lanes = torch.stack(
        [
            torch.full((capacity,), float("nan"), dtype=torch.float64, device=s.device),
            torch.where(cnt == 0, 0.0, sl(state.min).double()),
            torch.where(cnt == 0, 0.0, sl(state.max).double()),
            _mean(s, cnt),
            cntf,
            s,
            ssq,
            _stdev(cntf, ssq, s),
        ],
        dim=1,
    )
    return lanes, cnt.clone()  # no view of the state: resets write in place


def counter_reset_window(state: CounterState, window: int, capacity: int) -> CounterState:
    sl = lambda a: _window_slice(a, window, capacity)
    for col in (state.sum, state.sum_sq, state.count):
        sl(col).zero_()
    sl(state.max).fill_(I64_MIN)
    sl(state.min).fill_(I64_MAX)
    return state


def counter_clear_slots(state: CounterState, slots, num_windows: int,
                        capacity: int) -> CounterState:
    """Zero a set of slots across every window ring row (slot free: a
    recycled slot must not inherit un-drained window stats)."""
    at, idx = _clear_index(slots, num_windows, capacity)
    for col in (state.sum, state.sum_sq, state.count):
        col[idx] = 0
    state.max[idx] = I64_MIN
    state.min[idx] = I64_MAX
    state.last_at[at] = 0
    return state


# ---------------------------------------------------------------------------
# Gauge arena (float64 values; reference aggregation/gauge.go).
# ---------------------------------------------------------------------------


class GaugeState(NamedTuple):
    last: torch.Tensor  # f64 (W*C,)
    last_time: torch.Tensor  # i64 (W*C,) — timestamp backing `last`
    sum: torch.Tensor  # f64
    sum_sq: torch.Tensor  # f64
    count: torch.Tensor  # i64
    max: torch.Tensor  # f64, identity -inf (NaN surfaced when count==0)
    min: torch.Tensor  # f64, identity +inf
    last_at: torch.Tensor  # i64 (C,)


def gauge_init(num_windows: int, capacity: int, device=None) -> GaugeState:
    dev = resolve_device(device)
    n = num_windows * capacity
    f = lambda v: torch.full((n,), v, dtype=torch.float64, device=dev)
    i = lambda: torch.zeros(n, dtype=torch.int64, device=dev)
    return GaugeState(
        last=f(0.0), last_time=i(), sum=f(0.0), sum_sq=f(0.0), count=i(),
        max=f(float("-inf")), min=f(float("inf")),
        last_at=torch.zeros(capacity, dtype=torch.int64, device=dev),
    )


def gauge_ingest(state: GaugeState, idx, slots, values, times) -> GaugeState:
    """Gauge.Update for a batch (reference gauge.go:53-104).

    ``last`` tracks the value with the greatest timestamp, first arrival
    winning ties, and replaces the stored one only when strictly newer
    (gauge.go:82-91); count includes NaN values but sum/min/max ignore
    them (gauge.go:57-63,95-103)."""
    n = values.shape[0]
    n_flat = state.last.shape[0]
    nan = torch.isnan(values)

    # Per-lane winner for `last`: order by (idx asc, time asc, arrival
    # desc) with stable sorts, least significant key first; the final
    # element of each idx run is (max time, first arrival).
    order = torch.arange(n - 1, -1, -1, device=values.device)
    order = order[torch.argsort(times[order], stable=True)]
    order = order[torch.argsort(idx[order], stable=True)]
    s_idx, s_val, s_times = idx[order], values[order], times[order]
    is_winner = torch.ones_like(s_idx, dtype=torch.bool)
    is_winner[:-1] = s_idx[1:] != s_idx[:-1]
    old_time = state.last_time[s_idx.clamp(0, n_flat - 1)]
    take = is_winner & (s_times > old_time) & (s_idx >= 0) & (s_idx < n_flat)
    widx = s_idx[take]
    state.last[widx] = s_val[take]
    state.last_time[widx] = s_times[take]

    _seg3(state.sum, state.sum_sq, state.count, idx, torch.where(nan, 0.0, values))
    # NaN points drop out of min/max: the drop-mode scatter of -inf / +inf
    _minmax(state.max, state.min, torch.where(nan, n_flat, idx), values)
    _scatter_max_drop(state.last_at, _sanitize_slots(slots, state.last_at.shape[0]), times)
    return state


def gauge_consume(state: GaugeState, window: int, capacity: int):
    sl = lambda a: _window_slice(a, window, capacity)
    s, ssq, cnt = sl(state.sum), sl(state.sum_sq), sl(state.count)
    cntf = cnt.double()
    mx, mn = sl(state.max), sl(state.min)
    lanes = torch.stack(
        [
            sl(state.last),
            torch.where(torch.isinf(mn), float("nan"), mn),  # NaN until a value seen
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


def gauge_reset_window(state: GaugeState, window: int, capacity: int) -> GaugeState:
    sl = lambda a: _window_slice(a, window, capacity)
    for col in (state.last, state.last_time, state.sum, state.sum_sq, state.count):
        sl(col).zero_()
    sl(state.max).fill_(float("-inf"))
    sl(state.min).fill_(float("inf"))
    return state


def gauge_clear_slots(state: GaugeState, slots, num_windows: int,
                      capacity: int) -> GaugeState:
    at, idx = _clear_index(slots, num_windows, capacity)
    for col in (state.last, state.last_time, state.sum, state.sum_sq, state.count):
        col[idx] = 0
    state.max[idx] = float("-inf")
    state.min[idx] = float("inf")
    state.last_at[at] = 0
    return state


# ---------------------------------------------------------------------------
# Timer arena (float64 values + exact quantiles; reference
# aggregation/timer.go + quantile/cm/stream.go).
# ---------------------------------------------------------------------------


class TimerState(NamedTuple):
    sum: torch.Tensor  # f64 (W*C,)
    sum_sq: torch.Tensor  # f64
    count: torch.Tensor  # i64
    sample_slot: torch.Tensor  # i32 (W, S) — slot per buffered sample
    sample_val: torch.Tensor  # f64 (W, S)
    sample_n: torch.Tensor  # i64 (W,) — write offsets (may exceed S: overflow)
    last_at: torch.Tensor  # i64 (C,)


def timer_append_plan(windows, slots, sample_n, capacity: int, scap: int):
    """Destination plan for appending a timer batch into per-window
    sample buffers: (drop mask, flat destination offsets with the drop
    sentinel num_w*scap, per-window appended counts).  Ranks come from
    one cumsum per window over the membership mask; buffer order is
    irrelevant (consume sorts the whole window)."""
    num_w = sample_n.shape[0]
    oob = (windows < 0) | (windows >= num_w)
    drop = oob | (slots < 0) | (slots >= capacity)
    order_key = torch.where(drop, num_w, windows).long()
    onehot = order_key[None, :] == torch.arange(num_w, device=windows.device)[:, None]
    ranks_all = torch.cumsum(onehot.long(), dim=1) - 1  # (W, N)
    w_clip = order_key.clamp(0, num_w - 1)
    rank = ranks_all.gather(0, w_clip[None, :])[0]
    dst = sample_n[w_clip] + rank
    flat = torch.where(~drop & (dst < scap), w_clip * scap + dst, num_w * scap)
    per_w_counts = onehot.sum(dim=1).to(sample_n.dtype)
    return drop, flat, per_w_counts


def timer_init(num_windows: int, capacity: int, sample_capacity: int,
               device=None) -> TimerState:
    dev = resolve_device(device)
    n = num_windows * capacity
    return TimerState(
        sum=torch.zeros(n, dtype=torch.float64, device=dev),
        sum_sq=torch.zeros(n, dtype=torch.float64, device=dev),
        count=torch.zeros(n, dtype=torch.int64, device=dev),
        sample_slot=torch.full((num_windows, sample_capacity), capacity,
                               dtype=torch.int32, device=dev),
        sample_val=torch.zeros((num_windows, sample_capacity), dtype=torch.float64,
                               device=dev),
        sample_n=torch.zeros(num_windows, dtype=torch.int64, device=dev),
        last_at=torch.zeros(capacity, dtype=torch.int64, device=dev),
    )


def timer_ingest(state: TimerState, windows, slots, values, times,
                 capacity: int) -> TimerState:
    """Timer.AddBatch for a batch of (slot, value) samples (reference
    timer.go:55-76): moments plus sample append at offsets
    ``sample_n[w] + rank-within-batch``.  Offsets beyond S drop (moments
    stay exact; quantiles degrade — visible as sample_n overflow).
    Out-of-range windows and slots drop from both, and a dropped sample
    takes no buffer room."""
    num_w, scap = state.sample_slot.shape
    drop, flat, per_w_counts = timer_append_plan(
        windows, slots, state.sample_n, capacity, scap)
    idx = torch.where(drop, num_w * capacity, windows.long() * capacity + slots.long())
    _seg3(state.sum, state.sum_sq, state.count, idx, values)
    keep = flat < num_w * scap
    dst = flat[keep]
    state.sample_slot.view(-1)[dst] = slots[keep].to(torch.int32)
    state.sample_val.view(-1)[dst] = values[keep]
    state.sample_n.add_(per_w_counts)
    _scatter_max_drop(state.last_at, _sanitize_slots(slots, capacity), times)
    return state


def timer_consume(state: TimerState, window: int, capacity: int,
                  quantiles: tuple, packed32: bool = False):
    """Drain one timer window -> ((C, L + Q) lanes, (C,) counts).

    Exact quantiles via a (slot, value) sort and per-segment rank reads
    at ``ceil(q*n) - 1``.  ``packed32`` sorts one int64 key per sample,
    ``slot << 32 | orderable_f32(value)`` (non-negative, since slot <=
    C < 2^31), so quantile/min/max lanes carry f32 precision; moments
    stay exact either way.  Without it, two stable sorts (value, then
    slot) order equal values — and -0 against +0 — by buffer position,
    as the JAX package's sort treats them as equal too."""
    scap = state.sample_slot.shape[1]
    sl = lambda a: _window_slice(a, window, capacity)
    s, ssq, cnt = sl(state.sum), sl(state.sum_sq), sl(state.count)
    cntf = cnt.double()

    slots_w = state.sample_slot[window]
    vals_w = state.sample_val[window]
    if packed32:
        keys = torch.sort((slots_w.long() << 32) | orderable_f32(vals_w)).values
        s_slot = (keys >> 32).to(torch.int32)
        s_val = decode_orderable_f32(keys & 0xFFFFFFFF)
    else:
        order = torch.argsort(vals_w, stable=True)
        order = order[torch.argsort(slots_w[order], stable=True)]
        s_slot, s_val = slots_w[order], vals_w[order]

    ar = torch.arange(capacity, dtype=torch.int32, device=s_slot.device)
    seg_start = torch.searchsorted(s_slot, ar)
    seg_end = torch.searchsorted(s_slot, ar, right=True)
    seg_len = seg_end - seg_start
    seg_n = seg_len.double()
    empty = seg_len == 0
    at = lambda pos: s_val[pos.clamp(0, scap - 1)]
    mn = torch.where(empty, 0.0, at(seg_start))
    mx = torch.where(empty, 0.0, at(seg_end - 1))

    qlanes = []
    for q in quantiles:
        ranks = torch.ceil(q * seg_n).long() - 1
        ranks = torch.minimum(ranks.clamp(min=0), (seg_len - 1).clamp(min=0))
        qlanes.append(torch.where(empty, 0.0, at(seg_start + ranks)))

    lanes = torch.stack(
        [
            torch.full((capacity,), float("nan"), dtype=torch.float64, device=s.device),
            mn,
            mx,
            _mean(s, cnt),
            cntf,
            s,
            ssq,
            _stdev(cntf, ssq, s),
            *qlanes,
        ],
        dim=1,
    )
    return lanes, cnt.clone()  # no view of the state: resets write in place


def timer_reset_window(state: TimerState, window: int, capacity: int) -> TimerState:
    sl = lambda a: _window_slice(a, window, capacity)
    for col in (state.sum, state.sum_sq, state.count):
        sl(col).zero_()
    state.sample_slot[window].fill_(capacity)
    state.sample_n[window] = 0
    return state


def timer_clear_slots(state: TimerState, slots, num_windows: int,
                      capacity: int) -> TimerState:
    """Clear freed timer slots: zero the moment rows and retarget their
    buffered samples to the drop sentinel, so a recycled slot's
    quantiles don't include the previous occupant's samples.  As in the
    reference, a sample is retargeted when its slot equals one of
    ``slots`` as given (a negative slot wraps for the moments and
    ``last_at`` but matches no sample)."""
    at, idx = _clear_index(slots, num_windows, capacity)
    for col in (state.sum, state.sum_sq, state.count):
        col[idx] = 0
    hit = torch.isin(state.sample_slot, slots.to(torch.int32))
    state.sample_slot.masked_fill_(hit, capacity)
    state.last_at[at] = 0
    return state


# ---------------------------------------------------------------------------
# Weights and state carried across: the JAX state's fields <-> tensors.
# ---------------------------------------------------------------------------

_FIELD_DTYPES = {
    "counter": dict.fromkeys(CounterState._fields, np.int64),
    "gauge": {**dict.fromkeys(GaugeState._fields, np.float64),
              "last_time": np.int64, "count": np.int64, "last_at": np.int64},
    "timer": {**dict.fromkeys(TimerState._fields, np.int64), "sum": np.float64,
              "sum_sq": np.float64, "sample_slot": np.int32,
              "sample_val": np.float64},
    "packed_counter": {"base": np.uint64, "sq": np.int64, "minmax": np.uint32,
                       "pool_cnt": np.int64, "pool_sum": np.int64, "pool_sq": np.int64,
                       "pool_min": np.int64, "pool_max": np.int64,
                       "pool_owner": np.int32, "pool_idx": np.int32,
                       "pool_n": np.int32, "err": np.int32, "last_at": np.int64},
    "packed_gauge": {"sum": np.float64, "sum_sq": np.float64, "count": np.int64,
                     "min": np.float64, "max": np.float64, "last_bits": np.int64,
                     "last_time": np.int64, "last_at": np.int64},
    "packed_timer": {"sample": np.uint64, "sample_n": np.int64, "last_at": np.int64},
}


def _state_classes() -> dict:
    from m3_tpu_torch.aggregator import packed

    return {"counter": CounterState, "gauge": GaugeState, "timer": TimerState,
            "packed_counter": packed.PackedCounterState,
            "packed_gauge": packed.PackedGaugeState,
            "packed_timer": packed.PackedTimerState}


def state_from_numpy(kind: str, arrays: Mapping[str, np.ndarray], device=None):
    """A ``kind`` state on ``device`` from the JAX state's fields as numpy
    arrays by name (``state._asdict()``).  Kinds: "counter", "gauge",
    "timer" (f64 layout) and "packed_counter", "packed_gauge",
    "packed_timer".  Each field must already have the JAX dtype.
    Lossless: a uint64 field becomes the int64 tensor of the same bits,
    a uint32 field (the packed ``minmax`` word) its int64 value.  For
    the f64 layout only, a NaN in a float ``max`` / ``min`` column takes
    its side's sign (clear in ``max``, set in ``min``): the
    ``segment_minmax`` kernel keeps only such a stored NaN sticky.  The
    JAX arenas store no NaN there."""
    cls = _state_classes()[kind]
    dev = resolve_device(device)
    fields = {}
    for name in cls._fields:
        a = np.asarray(arrays[name])
        want = _FIELD_DTYPES[kind][name]
        if a.dtype != want:
            raise TypeError(f"{kind}.{name}: want {np.dtype(want)}, got {a.dtype}")
        if kind in ("counter", "gauge") and a.dtype == np.float64 and name in ("max", "min"):
            sign = np.uint64(1 << 63)
            bits = a.view(np.uint64)
            a = np.where(np.isnan(a), bits | sign if name == "min" else bits & ~sign,
                         bits).view(np.float64)
        if a.dtype == np.uint64:
            a = a.view(np.int64)
        elif a.dtype == np.uint32:
            a = a.astype(np.int64)
        fields[name] = torch.tensor(a, device=dev)
    return cls(**fields)


def state_to_numpy(state) -> dict:
    """The state's fields as numpy arrays by name, in the JAX dtypes
    (lossless; the inverse of ``state_from_numpy``)."""
    kind = next(k for k, c in _state_classes().items() if isinstance(state, c))
    out = {}
    for name, t in state._asdict().items():
        a = t.detach().cpu().numpy().copy()
        want = _FIELD_DTYPES[kind][name]
        out[name] = a.view(np.uint64) if want == np.uint64 else a.astype(want, copy=False)
    return out


# ---------------------------------------------------------------------------
# Thin stateful wrappers used by the engine.
# ---------------------------------------------------------------------------


class _ScalarLanesMixin:
    @property
    def lane_types(self):
        return SCALAR_LANES

    def lane_for_type(self, t: AggregationType) -> int | None:
        return SCALAR_LANES.index(t) if t in SCALAR_LANES else None


class _TimerLanesMixin:
    """Quantile-extended lane mapping (requires a ``quantiles`` tuple)."""

    @property
    def lane_types(self):
        """Primary type per lane; quantile-aliased types (e.g. MEDIAN ==
        P50) resolve through lane_for_type."""
        qtypes = []
        for q in self.quantiles:
            primary = next(
                (
                    t
                    for t in AggregationType
                    if t is not AggregationType.MEDIAN and t.quantile() == q
                ),
                AggregationType.UNKNOWN,
            )
            qtypes.append(primary)
        return SCALAR_LANES + tuple(qtypes)

    def lane_for_type(self, t: AggregationType) -> int | None:
        if t in SCALAR_LANES:
            return SCALAR_LANES.index(t)
        q = t.quantile()
        if q is not None and q in self.quantiles:
            return len(SCALAR_LANES) + self.quantiles.index(q)
        return None


class _Arena:
    """Shared plumbing: host arrays or tensors in, tensors on the arena's
    device for the functions above."""

    def __init__(self, num_windows: int, capacity: int, device=None):
        self.num_windows = num_windows
        self.capacity = capacity
        self.device = resolve_device(device)

    def _t(self, x, dtype):
        return torch.as_tensor(x, device=self.device).to(dtype)

    def _batch(self, windows, slots, values, times, value_dtype):
        if isinstance(values, torch.Tensor):
            floating = values.is_floating_point()
        else:
            values = np.asarray(values)
            floating = values.dtype.kind == "f"
        if value_dtype == torch.int64 and floating:
            values = saturating_int64(values)
        v = self._t(values, value_dtype)
        return (self._t(windows, torch.int32), self._t(slots, torch.int32),
                v, self._t(times, torch.int64))

    def _slots(self, slots):
        return self._t(pad_slots(np.asarray(slots), self.capacity), torch.int32)


class CounterArena(_ScalarLanesMixin, _Arena):
    """Counter slots over a W-window ring (reference counter.go semantics)."""

    def __init__(self, num_windows: int, capacity: int, device=None):
        super().__init__(num_windows, capacity, device)
        self.state = counter_init(num_windows, capacity, self.device)

    def ingest(self, windows, slots, values, times):
        w, s, v, t = self._batch(windows, slots, values, times, torch.int64)
        idx = flat_window_index(w, s, self.num_windows, self.capacity)
        self.state = counter_ingest(self.state, idx, s, v, t)

    def consume(self, window: int):
        return counter_consume(self.state, window, self.capacity)

    def reset_window(self, window: int):
        self.state = counter_reset_window(self.state, window, self.capacity)

    def clear_slots(self, slots):
        self.state = counter_clear_slots(self.state, self._slots(slots),
                                         self.num_windows, self.capacity)


class GaugeArena(_ScalarLanesMixin, _Arena):
    def __init__(self, num_windows: int, capacity: int, device=None):
        super().__init__(num_windows, capacity, device)
        self.state = gauge_init(num_windows, capacity, self.device)

    def ingest(self, windows, slots, values, times):
        w, s, v, t = self._batch(windows, slots, values, times, torch.float64)
        idx = flat_window_index(w, s, self.num_windows, self.capacity)
        self.state = gauge_ingest(self.state, idx, s, v, t)

    def consume(self, window: int):
        return gauge_consume(self.state, window, self.capacity)

    def reset_window(self, window: int):
        self.state = gauge_reset_window(self.state, window, self.capacity)

    def clear_slots(self, slots):
        self.state = gauge_clear_slots(self.state, self._slots(slots),
                                       self.num_windows, self.capacity)


class TimerArena(_TimerLanesMixin, _Arena):
    DEFAULT_QUANTILES = (0.5, 0.95, 0.99)

    def __init__(self, num_windows: int, capacity: int, sample_capacity: int,
                 quantiles: tuple = DEFAULT_QUANTILES, packed32: bool = False,
                 device=None):
        super().__init__(num_windows, capacity, device)
        self.sample_capacity = sample_capacity
        self.quantiles = tuple(quantiles)
        self.packed32 = packed32
        self.state = timer_init(num_windows, capacity, sample_capacity, self.device)
        # Host shadow of state.sample_n: the growth check needs no device
        # round trip per ingest batch.
        self._sample_n_host = np.zeros(num_windows, np.int64)

    def ingest(self, windows, slots, values, times):
        """Append a batch; grows the per-window sample buffer first if the
        batch would overflow it (the reference CM stream never drops
        samples — stream.go AddBatch — so neither do we; growth is
        geometric)."""
        host = lambda x: x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        windows_np, slots_np = host(windows), host(slots)
        # Mirror the device-side drop mask: samples dropped for an
        # out-of-range window or slot take no buffer room.
        in_range = ((windows_np >= 0) & (windows_np < self.num_windows)
                    & (slots_np >= 0) & (slots_np < self.capacity))
        per_w = np.bincount(windows_np[in_range], minlength=self.num_windows)
        new_n = self._sample_n_host + per_w
        needed = int(new_n.max())
        if needed > self.sample_capacity:
            self._grow(needed)
        w, s, v, t = self._batch(windows_np, slots_np, values, times, torch.float64)
        self.state = timer_ingest(self.state, w, s, v, t, self.capacity)
        self._sample_n_host = new_n

    def _grow(self, needed: int) -> None:
        new_cap = self.sample_capacity
        while new_cap < needed:
            new_cap *= 2
        pad = new_cap - self.sample_capacity
        st = self.state
        self.state = st._replace(
            sample_slot=torch.nn.functional.pad(st.sample_slot, (0, pad),
                                                value=self.capacity),
            sample_val=torch.nn.functional.pad(st.sample_val, (0, pad)),
        )
        self.sample_capacity = new_cap

    def consume(self, window: int):
        return timer_consume(self.state, window, self.capacity, self.quantiles,
                             self.packed32)

    def reset_window(self, window: int):
        self.state = timer_reset_window(self.state, window, self.capacity)
        self._sample_n_host[window] = 0

    def clear_slots(self, slots):
        self.state = timer_clear_slots(self.state, self._slots(slots),
                                       self.num_windows, self.capacity)
