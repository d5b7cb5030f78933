"""Temporal (sliding-window) functions as batched stencils.  The
counterpart of ``m3_tpu/query/temporal.py``.

rate/irate/delta/idelta/increase with Prometheus extrapolation,
*_over_time, deriv/predict_linear, resets/changes, holt_winters and
last_over_time, each computed for every (series, step) window at once:

* window bounds from two batched ``torch.searchsorted`` calls over the
  sorted per-series int64 timestamps -> (S, T) lo/hi index matrices;
* sum/count/avg/stddev, the rate family and the regression read prefix
  sums and boundary gathers, O(S*(P+T)) with no window materialized;
* min/max/quantile and holt_winters gather a bounded (S, T, W) window
  tensor (W = the densest window's sample count, from
  ``window_pad_for``).

Every function takes its tensors on the caller's device: ``ts`` (S, P)
int64 (padded with int64 max), ``vals`` (S, P) float, ``step_times``
(T,) int64.  The prefix sums are ``torch.cumsum``, which rounds
differently from XLA's blocked scan, so the prefix-difference families
agree with the reference to a few ulp of the row's largest prefix, not
bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

NAN = float("nan")
INF = float("inf")


def _window_bounds(ts, step_times, range_nanos):
    """(S, T) int64 lo/hi: half-open [lo, hi) indices of the samples in
    (step - range, step] of each series."""
    S = ts.shape[0]
    starts = (step_times - range_nanos).expand(S, -1).contiguous()
    ends = step_times.expand(S, -1).contiguous()
    lo = torch.searchsorted(ts, starts, right=True)
    hi = torch.searchsorted(ts, ends, right=True)
    return lo, hi


def _prefix(vals):
    """Exclusive prefix sum with a leading zero: (S, P+1)."""
    return torch.cat([torch.zeros((vals.shape[0], 1), dtype=vals.dtype,
                                  device=vals.device),
                      torch.cumsum(vals, dim=1)], dim=1)


def _gather_rows(a, idx):
    """a (S, P), idx (S, T) -> a[s, idx[s, t]]."""
    return torch.gather(a, 1, idx)


def _where_not_zero(n):
    return torch.where(n == 0, 1.0, n)


def true_div(x, d: float):
    """``x / d`` rounded once, as IEEE division.  PyTorch's CUDA kernel
    multiplies by the reciprocal when the divisor is a Python number (a
    CPU scalar), which can move the quotient by an ulp and the card
    apart from the CPU and the reference; a divisor tensor on ``x``'s
    device takes the true division on every device."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def sum_count_family(ts, vals, step_times, range_nanos, func: str):
    """sum/count/avg/stddev/stdvar_over_time via prefix sums."""
    lo, hi = _window_bounds(ts, step_times, range_nanos)
    n = (hi - lo).to(vals.dtype)
    c1 = _prefix(vals)
    c2 = _prefix(vals * vals)
    s1 = _gather_rows(c1, hi) - _gather_rows(c1, lo)
    s2 = _gather_rows(c2, hi) - _gather_rows(c2, lo)
    empty = n == 0
    if func == "sum_over_time":
        out = s1
    elif func == "count_over_time":
        out = n
    elif func == "avg_over_time":
        out = s1 / _where_not_zero(n)
    else:  # stddev/stdvar: population (Prometheus semantics)
        mean = s1 / _where_not_zero(n)
        var = torch.clamp_min(s2 / _where_not_zero(n) - mean * mean, 0.0)
        out = torch.sqrt(var) if func == "stddev_over_time" else var
    return torch.where(empty, NAN, out)


def _gather_window(vals, lo, hi, W: int):
    """(S, T, W) stencil gather of each window's samples plus the valid
    mask: the shared idiom of every W-bounded function."""
    S, P = vals.shape
    T = lo.shape[1]
    idx = lo[:, :, None] + torch.arange(W, device=vals.device)[None, None, :]
    valid = idx < hi[:, :, None]
    idx = idx.clamp_(0, P - 1)
    g = torch.gather(vals, 1, idx.reshape(S, T * W)).reshape(S, T, W)
    return g, valid


def minmax_quantile_family(ts, vals, step_times, range_nanos, func: str,
                           window_pad: int, q: float = 0.0):
    """min/max/quantile_over_time via the (S, T, W) gathered stencil."""
    lo, hi = _window_bounds(ts, step_times, range_nanos)
    g, valid = _gather_window(vals, lo, hi, window_pad)
    W = window_pad
    n = hi - lo
    empty = n == 0
    if func == "min_over_time":
        out = torch.amin(torch.where(valid, g, INF), dim=2)
    elif func == "max_over_time":
        out = torch.amax(torch.where(valid, g, -INF), dim=2)
    else:  # quantile_over_time (Prometheus: linear interpolation)
        gs = torch.sort(torch.where(valid, g, INF), dim=2).values
        del g
        rank = q * (n.to(vals.dtype) - 1.0)
        lo_r = torch.minimum(torch.floor(rank).long(), n - 1).clamp(0, W - 1)
        hi_r = torch.minimum(lo_r + 1, n - 1).clamp(0, W - 1)
        frac = rank - lo_r.to(vals.dtype)
        v_lo = torch.gather(gs, 2, lo_r[:, :, None])[:, :, 0]
        v_hi = torch.gather(gs, 2, hi_r[:, :, None])[:, :, 0]
        out = v_lo + (v_hi - v_lo) * frac
    return torch.where(empty, NAN, out)


def rate_family(ts, vals, step_times, range_nanos, func: str,
                narrow: bool = False):
    """rate/increase/delta/irate/idelta with Prometheus extrapolation
    (reference rate.go standardRateFunc); the counter functions apply
    the cumulative-reset correction.

    ``narrow`` is the f32 policy's entry point: ``vals`` stays float64
    through the reset correction and the last - first difference, and
    only the differences (delta, durations) narrow for the extrapolation
    arithmetic, where the error is relative to the delta itself."""
    dt_ = torch.float32 if narrow else vals.dtype
    lo, hi = _window_bounds(ts, step_times, range_nanos)
    n = hi - lo
    has2 = n >= 2
    P = vals.shape[1]
    last_i = (hi - 1).clamp(0, P - 1)
    first_i = lo.clamp(0, P - 1)

    is_counter = func in ("rate", "increase", "irate")
    if is_counter:
        prev = torch.cat([vals[:, :1], vals[:, :-1]], dim=1)
        # on a reset (v < prev) add the full previous value (the counter
        # restarted from zero)
        resets = torch.where(vals < prev, prev, 0.0)
        resets = torch.where(torch.isnan(resets), 0.0, resets)
        adj = vals + torch.cumsum(resets, dim=1)
    else:
        adj = vals

    # Duration math in int64 nanos first; only the differences narrow.
    # Gathered pad entries (int64 max) wrap to garbage, and every lane
    # that can read one is masked below (has2 / sampled > 0 / dt > 0).
    v_first = _gather_rows(adj, first_i)
    v_last = _gather_rows(adj, last_i)
    ti_first = _gather_rows(ts, first_i)
    ti_last = _gather_rows(ts, last_i)

    if func in ("irate", "idelta"):
        prev_i = (hi - 2).clamp(0, P - 1)
        v_prev = _gather_rows(adj, prev_i)
        dv = (v_last - v_prev).to(dt_)
        dt = true_div((ti_last - _gather_rows(ts, prev_i)).to(dt_), 1e9)
        out = torch.where(dt > 0, dv / dt if func == "irate" else dv, NAN)
        return torch.where(has2, out, NAN)

    range_f = torch.tensor(range_nanos, dtype=dt_, device=vals.device)
    window_start = step_times - range_nanos

    delta_v = (v_last - v_first).to(dt_)
    sampled = (ti_last - ti_first).to(dt_)  # nanos, <= range
    avg_dur = sampled / torch.clamp_min(n.to(dt_) - 1.0, 1.0)
    dur_start = (ti_first - window_start[None, :]).to(dt_)
    dur_end = (step_times[None, :] - ti_last).to(dt_)

    # extend to the window edge unless the gap exceeds 1.1x the average
    # sample spacing, then cap at avg/2
    extrap_start = torch.where(dur_start < avg_dur * 1.1, dur_start, avg_dur / 2.0)
    extrap_end = torch.where(dur_end < avg_dur * 1.1, dur_end, avg_dur / 2.0)
    if is_counter:
        # a counter cannot extrapolate below zero: cap the start-side
        # extension at the time to reach zero, from the RAW first sample
        v_first_raw = _gather_rows(vals, first_i)
        delta64 = v_last - v_first
        ratio = (v_first_raw / torch.where(delta64 == 0, 1.0, delta64)).to(dt_)
        zero_dur = torch.where((delta_v > 0) & (v_first_raw.to(dt_) >= 0),
                               sampled * ratio, INF)
        extrap_start = torch.minimum(extrap_start, zero_dur)
    factor = ((sampled + extrap_start + extrap_end)
              / torch.where(sampled == 0, 1.0, sampled))
    extrapolated = delta_v * factor

    if func == "rate":
        out = extrapolated / true_div(range_f, 1e9)
    else:  # increase, delta
        out = extrapolated
    return torch.where(has2 & (sampled > 0), out, NAN)


def regression_family(ts, vals, step_times, range_nanos, func: str,
                      predict_offset_s: float = 0.0):
    """deriv / predict_linear: least-squares slope over each window via
    prefix sums of (t, v, t*v, t^2), times centred on the first step
    before the sums and re-centred on each step after.  Always float64,
    whatever the precision policy."""
    vals = vals.to(torch.float64)
    lo, hi = _window_bounds(ts, step_times, range_nanos)
    n = (hi - lo).to(torch.float64)
    g_ref = step_times[0]
    tsec = true_div((ts - g_ref).to(torch.float64), 1e9)
    ref = true_div((step_times - g_ref).to(torch.float64), 1e9)[None, :]  # (1, T)

    def window_sum(x):
        c = _prefix(x)
        return _gather_rows(c, hi) - _gather_rows(c, lo)

    S_v = window_sum(vals)
    S_t = window_sum(tsec)
    S_tv = window_sum(tsec * vals)
    S_tt = window_sum(tsec * tsec)
    S_t_c = S_t - n * ref
    S_tt_c = S_tt - 2 * ref * S_t + n * ref * ref
    S_tv_c = S_tv - ref * S_v
    denom = n * S_tt_c - S_t_c * S_t_c
    slope = torch.where(denom != 0, (n * S_tv_c - S_t_c * S_v) / denom, NAN)
    intercept = (S_v - slope * S_t_c) / _where_not_zero(n)  # value at ref
    ok = n >= 2
    if func == "deriv":
        return torch.where(ok, slope, NAN)
    return torch.where(ok, intercept + slope * predict_offset_s, NAN)


def transitions_family(ts, vals, step_times, range_nanos, func: str):
    """resets / changes: the transitions between consecutive samples
    inside each window (resets counts v[i] < v[i-1], changes counts
    v[i] != v[i-1]), prefix-summed over the adjacent-pair indicator;
    the pairs with both ends in [lo, hi) are those with i in
    [lo+1, hi)."""
    lo, hi = _window_bounds(ts, step_times, range_nanos)
    prev = torch.cat([vals[:, :1], vals[:, :-1]], dim=1)
    if func == "resets":
        ind = (vals < prev).to(vals.dtype)
    else:  # changes
        ind = (vals != prev).to(vals.dtype)
    c = _prefix(ind)
    P = vals.shape[1]
    count = _gather_rows(c, hi) - _gather_rows(c, (lo + 1).clamp(0, P))
    n = hi - lo
    # >= 1 sample emits (0 transitions for a single sample); empty -> NaN
    return torch.where(n >= 1, torch.clamp_min(count, 0.0), NAN)


def holt_winters(ts, vals, step_times, range_nanos, window_pad: int,
                 sf: float, tf: float):
    """holt_winters (Prometheus funcHoltWinters): per window, level and
    trend smoothing over the gathered (S, T, W) stencil, a loop of W - 1
    masked steps: s1 seeds from x0, the trend from x1 - x0, and each
    in-window sample advances (s1, b) as the sequential loop does."""
    lo, hi = _window_bounds(ts, step_times, range_nanos)
    W = window_pad
    g, valid = _gather_window(vals, lo, hi, W)
    g = torch.where(valid, g, 0.0)
    del valid
    n = hi - lo

    x0 = g[:, :, 0]
    x1 = g[:, :, 1] if W > 1 else x0
    s1 = x0
    b = x1 - x0
    for i in range(1, W):
        x = g[:, :, i]
        active = i < n
        xs = sf * x
        y = (1.0 - sf) * (s1 + b)
        s0_new, s1_new = s1, xs + y
        b_new = tf * (s1_new - s0_new) + (1.0 - tf) * b
        s1 = torch.where(active, s1_new, s1)
        b = torch.where(active, b_new, b)
    return torch.where(n >= 2, s1, NAN)


def last_over_time(ts, vals, step_times, range_nanos):
    lo, hi = _window_bounds(ts, step_times, range_nanos)
    P = vals.shape[1]
    out = _gather_rows(vals, (hi - 1).clamp(0, P - 1))
    return torch.where(hi > lo, out, NAN)


def window_pad_for(counts: np.ndarray, ts: np.ndarray, range_nanos: int) -> int:
    """Static W bound for the stencil functions (host numpy): the exact
    largest number of samples any range-length window can contain, from
    a sliding searchsorted per series.  No cap: the (S, T, W) gather is
    as wide as the densest window requires."""
    best = 1
    for s in range(len(counts)):
        n = int(counts[s])
        if n == 0:
            continue
        row = ts[s, :n]
        lo = np.searchsorted(row, row - range_nanos, side="right")
        best = max(best, int((np.arange(1, n + 1) - lo).max()))
    return best
