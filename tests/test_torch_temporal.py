"""m3_tpu_torch.query.temporal against m3_tpu.query.temporal: the same
seeded numpy rows through both, under both precision policies.

The rows are irregular and right-padded (int64 max), and hold counters
with resets, gauges, counters near 1e10 (where the sum of squares
cancels), NaN-bearing gauges, an empty row and a one-sample row; the
steps start before the first sample, so windows are empty, hold one
sample or many.  As in the engine, NaN values are zeroed before the
call.

Tolerances (``eps`` is the machine epsilon of the policy's dtype):

* exact: count/last/min/max_over_time, resets, changes, delta, idelta,
  ``window_pad_for``;
* prefix-difference families (sum/avg/stddev/stdvar_over_time, the rate
  family's reset correction, deriv/predict_linear): ``torch.cumsum``
  rounds differently from XLA's blocked scan, so each output may be off
  by 16 eps of the row's largest prefix, carried through the function's
  own arithmetic (bounds below per family);
* rate/increase/irate additionally ``rtol`` 1e-12 (f64) or 4e-6 (f32):
  XLA may contract the extrapolation into FMAs and rewrite divisions;
* quantile_over_time: (2 W + 4) eps of the row's largest |value| (the
  interpolation weight carries the rank's rounding), holt_winters:
  4 W eps of it (W smoothing steps).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from m3_tpu.query import temporal as jt
from m3_tpu_torch.query import temporal as tt

STEP = 15 * 10**9
RANGE = 5 * 60 * 10**9
T0 = 1_700_000_000 * 10**9
I64 = np.iinfo(np.int64).max
POLICIES = {"f64": np.float64, "f32": np.float32}


def _rows(S=48, P=300, seed=0):
    rng = np.random.default_rng(seed)
    ts = np.full((S, P), I64, np.int64)
    vals = np.full((S, P), np.nan)
    counts = np.zeros(S, np.int64)
    for s in range(S):
        kind = s % 4
        n = int(rng.integers(P // 2, P + 1))
        n = {5: 0, 6: 1}.get(s, n)  # an empty row, a one-sample row
        t = T0 + np.cumsum(rng.integers(5, 15, n) * 10**9)
        if kind == 0:  # counter with resets
            v = np.cumsum(rng.integers(0, 100, n)).astype(float)
            for r in rng.integers(1, max(n, 2), 2):
                if r < n:
                    v[r:] = v[r:] - v[r] + rng.integers(0, 5)
        elif kind == 1:  # gauge
            v = rng.normal(50, 10, n)
        elif kind == 2:  # large counter: stddev cancels
            v = 1e10 + np.cumsum(rng.integers(0, 1000, n)).astype(float)
        else:  # small gauge with NaN gaps (zeroed below)
            v = np.round(rng.normal(0, 3, n), 1)
            v[rng.random(n) < 0.05] = np.nan
        ts[s, :n] = t
        vals[s, :n] = v
        counts[s] = n
    steps = np.arange(T0 - 4 * STEP, T0 + 250 * STEP, STEP, dtype=np.int64)
    return ts, np.nan_to_num(vals), counts, steps


TS, VALS, COUNTS, STEPS = _rows()
W = jt.window_pad_for(COUNTS, TS, RANGE)


def _run(jfn, tfn, *args, vdt, **kw):
    j = np.asarray(jfn(jnp.asarray(TS), jnp.asarray(VALS, vdt), jnp.asarray(STEPS),
                       RANGE, *args, **kw))
    t = tfn(torch.from_numpy(TS), torch.from_numpy(VALS.astype(vdt)),
            torch.from_numpy(STEPS), RANGE, *args, **kw).numpy()
    assert t.dtype == j.dtype and t.shape == j.shape == (len(TS), len(STEPS))
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    return j, t


def _close(t, j, atol_row, rtol=0.0):
    """|t - j| <= rtol |j| + atol, atol per row (S, 1) or scalar."""
    ok = ~np.isnan(j)
    bound = rtol * np.abs(j) + np.broadcast_to(atol_row, j.shape)
    bad = ok & ~(np.abs(t - j) <= bound)
    assert not bad.any(), (int(bad.sum()), t[bad][:4], j[bad][:4], bound[bad][:4])


def _prefix_scale(x):
    """(S, 1) largest |prefix sum| of |x| per row."""
    return np.abs(x).cumsum(axis=1).max(axis=1, keepdims=True)


def _eps(vdt):
    return float(np.finfo(vdt).eps)


def test_window_pad_for_is_the_reference_copy():
    assert tt.window_pad_for(COUNTS, TS, RANGE) == W
    assert W > 20
    assert tt.window_pad_for(np.zeros(2, np.int64), TS[:2], RANGE) == 1


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("func", ["sum_over_time", "count_over_time", "avg_over_time",
                                  "stddev_over_time", "stdvar_over_time"])
def test_sum_count_family(policy, func):
    vdt = POLICIES[policy]
    j, t = _run(jt.sum_count_family, tt.sum_count_family, func, vdt=vdt)
    v = VALS.astype(vdt).astype(np.float64)
    eps = _eps(vdt)
    if func == "count_over_time":
        np.testing.assert_array_equal(t, j)
        return
    if func in ("sum_over_time", "avg_over_time"):
        # avg divides the sum by n >= 1
        _close(t, j, 16 * eps * _prefix_scale(v), rtol=2 * eps)
        return
    # var = s2/n - mean^2: both terms carry at most 16 eps of max|v| x
    # the largest prefix of |v| (sum v^2 <= max|v| sum |v|); stddev's
    # sqrt moves by at most sqrt of that
    atol_var = 64 * eps * np.abs(v).max(axis=1, keepdims=True) * _prefix_scale(v)
    if func == "stdvar_over_time":
        _close(t, j, atol_var, rtol=2 * eps)
    else:
        _close(t, j, np.sqrt(atol_var), rtol=2 * eps)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("func,q", [("min_over_time", 0.0), ("max_over_time", 0.0),
                                    ("quantile_over_time", 0.9),
                                    ("quantile_over_time", 0.0),
                                    ("quantile_over_time", 0.5)])
def test_minmax_quantile_family(policy, func, q):
    vdt = POLICIES[policy]
    j, t = _run(jt.minmax_quantile_family, tt.minmax_quantile_family, func, W, q,
                vdt=vdt)
    if func != "quantile_over_time":
        np.testing.assert_array_equal(t, j)
        return
    # the rank q*(n-1) may round differently (XLA contracts it): the
    # weight moves by up to W eps, times |v_hi - v_lo| <= 2 max|v|
    scale = np.abs(VALS.astype(vdt)).max(axis=1, keepdims=True).astype(np.float64)
    _close(t, j, (2 * W + 4) * _eps(vdt) * scale)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("func", ["rate", "increase", "delta", "irate", "idelta"])
def test_rate_family(policy, func):
    narrow = policy == "f32"
    j, t = _run(jt.rate_family, tt.rate_family, func, vdt=np.float64, narrow=narrow)
    if func in ("delta", "idelta"):
        np.testing.assert_array_equal(t, j)
        return
    # the reset correction is a float64 cumsum: its differences may be off
    # by 16 eps64 of the row's largest correction, times the extrapolation
    # factor (< 4) and, for rate, over the range in seconds
    prev = np.concatenate([VALS[:, :1], VALS[:, :-1]], axis=1)
    resets = np.where(VALS < prev, prev, 0.0)
    atol = 64 * _eps(np.float64) * _prefix_scale(resets)
    if func == "rate":
        atol = atol / (RANGE / 1e9)
    if func == "irate":
        atol = atol / 5.0  # the shortest sample spacing, seconds
    _close(t, j, atol, rtol=4e-6 if narrow else 1e-12)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("func", ["deriv", "predict_linear"])
def test_regression_family(policy, func):
    """Always f64.  Bound: each of the four window sums (v, t, t*v, t^2)
    may be off by 16 eps64 of its row's largest prefix; the bound carries
    those through the slope's first-order sensitivities."""
    vdt = POLICIES[policy]
    off = 600.0
    j, t = _run(jt.regression_family, tt.regression_family, func, off, vdt=vdt)
    v = VALS.astype(vdt).astype(np.float64)
    tsec = (TS - STEPS[0]).astype(np.float64) / 1e9
    ref = (STEPS - STEPS[0]).astype(np.float64)[None, :] / 1e9
    lo = np.stack([np.searchsorted(r, STEPS - RANGE, side="right") for r in TS])
    hi = np.stack([np.searchsorted(r, STEPS, side="right") for r in TS])

    def wsum(x):
        c = np.concatenate([np.zeros((len(x), 1)), np.cumsum(x, axis=1)], axis=1)
        # the scale counts real samples only: no window reaches the pad
        return (np.take_along_axis(c, hi, 1) - np.take_along_axis(c, lo, 1),
                16 * _eps(np.float64) * _prefix_scale(np.where(TS == I64, 0.0, x)))

    (Sv, Ev), (St, Et), (Stv, Etv), (Stt, Ett) = (
        wsum(v), wsum(tsec), wsum(tsec * v), wsum(tsec * tsec))
    n = (hi - lo).astype(np.float64)
    Stc = St - n * ref
    D = n * (Stt - 2 * ref * St + n * ref * ref) - Stc * Stc
    with np.errstate(all="ignore"):
        slope = (n * (Stv - ref * Sv) - Stc * Sv) / D
        d_slope = (n * Etv + np.abs(n * ref + Stc) * Ev
                   + np.abs(Sv + slope * (2 * n * ref + 2 * Stc)) * Et
                   + np.abs(slope) * n * Ett) / np.abs(D)
        if func == "deriv":
            atol = 2 * d_slope
        else:
            atol = 2 * (Ev / n + (np.abs(Stc) / n + off) * d_slope
                        + np.abs(slope) * Et / n)
    _close(t, j, np.nan_to_num(atol, nan=np.inf), rtol=1e-12)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("func", ["resets", "changes"])
def test_transitions_family(policy, func):
    j, t = _run(jt.transitions_family, tt.transitions_family, func,
                vdt=POLICIES[policy])
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("policy", POLICIES)
def test_holt_winters(policy):
    vdt = POLICIES[policy]
    Wh = max(W, 2)
    j, t = _run(jt.holt_winters, tt.holt_winters, Wh, 0.3, 0.6, vdt=vdt)
    scale = np.abs(VALS.astype(vdt)).max(axis=1, keepdims=True).astype(np.float64)
    _close(t, j, 4 * Wh * _eps(vdt) * scale)


@pytest.mark.parametrize("policy", POLICIES)
def test_last_over_time(policy):
    j, t = _run(jt.last_over_time, tt.last_over_time, vdt=POLICIES[policy])
    np.testing.assert_array_equal(t, j)


def test_edge_windows_are_covered():
    """The rows above reach every window shape the functions branch on."""
    lo = np.stack([np.searchsorted(r, STEPS - RANGE, side="right") for r in TS])
    hi = np.stack([np.searchsorted(r, STEPS, side="right") for r in TS])
    n = hi - lo
    assert (n == 0).any() and (n == 1).any() and (n >= 20).any()
    assert (TS == I64).any() and COUNTS.min() == 0
    prev = np.concatenate([VALS[:, :1], VALS[:, :-1]], axis=1)
    assert (VALS < prev).any()  # counter resets
