"""m3_tpu_torch.query.device_fns against m3_tpu.query.device_fns: the
same seeded numpy inputs through both, under both precision policies
(each package's policy set alike).

Tolerances:

* exact: ``group_plan``, topk/bottomk masks, comparisons (always
  float64), ``+ - *`` and the selection edges of the quantiles;
* grouped quantile and histogram_quantile: ``rtol`` 1e-12 (f64) or 4e-6
  (f32) plus 4 eps of the largest |value|: XLA may contract the
  interpolation ``lo + (hi - lo) * frac`` into an FMA;
* ``/ % ^``: ``rtol`` 4 eps (``^`` goes through each library's ``pow``);
* the unary transcendentals: 2 ulp of numpy's libm (see below).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from m3_tpu.query import device_fns as jd
from m3_tpu.query import functions as jfn
from m3_tpu.query import precision as jprec
from m3_tpu_torch.query import device_fns as td
from m3_tpu_torch.query import functions as tfn
from m3_tpu_torch.query import precision as tprec

POLICIES = {"f64": np.float64, "f32": np.float32}


@pytest.fixture(params=list(POLICIES))
def policy(request):
    jprec.set_compute_dtype(request.param)
    tprec.set_compute_dtype(request.param)
    yield POLICIES[request.param]
    jprec.set_compute_dtype("f64")
    tprec.set_compute_dtype("f64")


def _block(S, T, nan_frac, seed=3):
    rng = np.random.default_rng(seed)
    v = np.round(rng.normal(0, 10, (S, T)), 3)
    v[rng.random((S, T)) < nan_frac] = np.nan
    return v


def _close(t, j, vdt, rtol64=1e-12):
    t, j = np.asarray(t), np.asarray(j)
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    eps = float(np.finfo(vdt).eps)
    rtol = rtol64 if vdt == np.float64 else 4e-6
    ok = ~np.isnan(j)
    scale = np.abs(j[ok]).max(initial=0.0)
    np.testing.assert_allclose(t[ok], j[ok], rtol=rtol, atol=4 * eps * scale)


def _gids(S, G, seed=5):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, G, S).astype(np.int32)
    g[g == G - 1] = 0  # group G-1 is empty
    return g


def test_group_plan_is_the_reference_copy():
    for S, G in ((200, 23), (1, 1), (0, 3)):
        g = _gids(S, G)
        for a, b in zip(td.group_plan(g, G), jd.group_plan(g, G)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("q", [0.0, 0.25, 0.9, 1.0])
def test_group_quantile(policy, q):
    v = _block(200, 13, 0.15)
    v[0] = np.nan  # a fully missing row
    g = _gids(200, 23)
    j = np.asarray(jd.group_quantile(v, g, 23, q))
    t = td.group_quantile(torch.from_numpy(v), g, 23, q).numpy()
    assert t.dtype == np.float64 and np.isnan(t[22]).all()  # empty group
    _close(t, j, policy)


@pytest.mark.parametrize("top", [True, False])
@pytest.mark.parametrize("k", [1, 3, 40])
def test_topk_mask(top, k):
    v = _block(120, 11, 0.2)
    v[3, ::2] = np.inf  # Inf competes for rank slots
    v[4, 1::2] = -np.inf
    v[7] = v[8]  # exact ties
    g = _gids(120, 9)
    j = np.asarray(jd.topk_mask(v, g, 9, k, top))
    t = td.topk_mask(torch.from_numpy(v), g, 9, k, top).numpy()
    np.testing.assert_array_equal(t, j)
    assert t.any() and not t.all()


def _histograms(G=30, B=6, T=9, seed=7):
    """Cumulative bucket rows per group (ragged: the last groups hold
    fewer buckets), the edge cases of the reference's tests appended."""
    rng = np.random.default_rng(seed)
    ubs_all = np.array([0.1, 0.5, 1.0, 5.0, 10.0, np.inf])
    mat, rows, ubs = [], [], []
    for g in range(G):
        b = B if g < G - 5 else 3
        raw = rng.random((b, T)).cumsum(axis=0) * (g + 1)
        rows.append(list(range(len(mat), len(mat) + b)))
        mat.extend(raw)
        ubs.append(np.concatenate([ubs_all[:b - 1], [np.inf]]))
    edge = [
        ([[10.0, 10.0], [20.0, 20.0], [20.0, np.nan]], [1.0, 2.0, np.inf]),  # NaN total
        ([[7.0, 7.0]], [np.inf]),  # only the +Inf bucket
        ([[0.0, 0.0], [0.0, 0.0]], [1.0, np.inf]),  # zero total
        ([[np.nan, 3.0], [4.0, 4.0], [4.0, 4.0]], [1.0, 2.0, np.inf]),  # NaN bucket
        ([[5.0, 5.0], [4.0, 9.0], [9.0, 9.0]], [1.0, 2.0, np.inf]),  # non-monotone
    ]
    for vals, u in edge:
        vals = np.asarray(vals)
        full = np.full((len(vals), T), np.nan)
        full[:, :2] = vals
        rows.append(list(range(len(mat), len(mat) + len(vals))))
        mat.extend(full)
        ubs.append(np.asarray(u))
    return np.asarray(mat), rows, ubs


@pytest.mark.parametrize("q", [0.0, 0.5, 0.99, 1.0])
def test_histogram_quantile_groups(policy, q):
    values, rows, ubs = _histograms()
    j = np.asarray(jd.histogram_quantile_groups(values, rows, ubs, q))
    t = td.histogram_quantile_groups(torch.from_numpy(values), rows, ubs, q).numpy()
    assert t.shape == (35, 9)
    _close(t, j, policy)
    assert t[31, 0] == 0.0 and np.isnan(t[30, 1]) and np.isnan(t[32, :2]).all()


OPERANDS = np.array([7.5, -7.5, 7.5, -7.5, -0.0, 0.0, 5.0, -5.0, 3.0, 2.0, np.inf,
                     -np.inf, 1e300, 16777217.0, np.nan, 4.0])
RIGHT = np.array([-2.0, 2.0, 2.0, -2.0, 3.0, -3.0, np.inf, np.inf, 0.0, -0.5, 2.0,
                  3.0, 1e10, 16777216.5, 1.0, np.nan])


@pytest.mark.parametrize("op", sorted(td.BINOPS))
@pytest.mark.parametrize("bool_mode", [False, True])
def test_vector_binary_matched(policy, op, bool_mode):
    rng = np.random.default_rng(9)
    lv = np.concatenate([OPERANDS[None, :], _block(6, 16, 0.1, seed=1)])
    rv = np.concatenate([RIGHT[None, :], _block(6, 16, 0.1, seed=2)])
    rows_l = [0, 1, 2, 3, 4, 5, 6, 2]
    rows_r = list(rng.permutation(7)) + [0]
    rows_r[0] = 0
    with np.errstate(all="ignore"):
        j = np.asarray(jd.vector_binary_matched(lv, rv, rows_l, rows_r, op, bool_mode))
    t = td.vector_binary_matched(torch.from_numpy(lv), torch.from_numpy(rv),
                                 rows_l, rows_r, op, bool_mode).numpy()
    assert t.dtype == np.float64
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    if op in td.COMPARISONS or op in "+-*" or policy == np.float32 and op != "^":
        np.testing.assert_array_equal(t, j)
    else:
        eps = float(np.finfo(policy).eps)
        np.testing.assert_allclose(t, j, rtol=4 * eps, atol=0.0)
    ok = ~np.isnan(j)  # a NaN's sign bit carries nothing
    np.testing.assert_array_equal(np.signbit(t[ok]), np.signbit(j[ok]))
    if op == ">" and bool_mode:
        assert t[0, 13] == 1.0  # 16777217.0 > 16777216.5 survives the f32 policy


def _ulps(a, b):
    """Elementwise distance in units in the last place (finite f64)."""
    def key(x):
        i = x.view(np.int64)
        return np.where(i < 0, np.int64(-2**63) - i, i)
    return np.abs(key(a) - key(b))


@pytest.mark.parametrize("name", sorted(tfn._UNARY))
def test_unary_math_ulp_bound(name):
    """Each unary function of the port against numpy's libm: within 2 ulp.
    XLA's CPU versions of exp, sinh, cosh, tanh and atanh sit up to
    hundreds of ulp from libm, so against the reference the bound is the
    reference's own distance from libm plus 2 ulp, elementwise."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, 1, 500), rng.normal(0, 100, 500),
                        rng.uniform(-1, 1, 500), rng.uniform(1, 50, 500),
                        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e300, -1e-300, 700.0,
                         710.0, 0.5, -0.5]])
    with np.errstate(all="ignore"):
        j = np.asarray(jfn._J_UNARY[name](jnp.asarray(x)))
        n = jfn._UNARY[name](x)
    t = tfn._UNARY[name](torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    fin = np.isfinite(j)
    np.testing.assert_array_equal(t[~fin], j[~fin])
    assert (_ulps(t[fin], n[fin]) <= 2).all()
    assert (_ulps(t[fin], j[fin]) <= _ulps(j[fin], n[fin]) + 2).all()
