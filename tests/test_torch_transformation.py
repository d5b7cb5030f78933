"""The port's transformations (``m3_tpu_torch/metrics/transformation.py``)
against ``m3_tpu.metrics.transformation`` on the same seeded inputs.

Scalar forms (``absolute``, ``make_add``, ``per_second``, ``increase``,
``reset``): exact, over pairs that include NaN on either side, time going
backwards or standing still, a negative delta and the first window (a
NaN previous value at t=0).  Batched forms on CPU tensors against the
``jnp`` functions: ``batched_absolute``, ``batched_per_second`` and
``batched_increase`` bit for bit (NaN as one NaN); ``batched_add`` within
the prefix-sum bound ``tests/test_torch_temporal.py`` states (64 eps of
the row's largest absolute prefix): ``jnp.cumsum`` is an XLA blocked scan,
``torch.cumsum`` a sequential one.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import m3_tpu.metrics.transformation as jtf
import m3_tpu.metrics.types as jtypes
import m3_tpu_torch.metrics.transformation as ttf
import m3_tpu_torch.metrics.types as ttypes

SEC = 10**9
EPS = np.finfo(np.float64).eps


def _pairs(seed=3, n=400):
    rng = np.random.default_rng(seed)
    vals = [math.nan, 0.0, -0.0, 1.5, -3.25, 1e300, 7.0, 7.0000000001, -1e-300]
    out = []
    for _ in range(n):
        pt = int(rng.integers(0, 5)) * SEC
        ct = pt + int(rng.integers(-2, 3)) * SEC  # backwards, equal, forwards
        out.append(((pt, vals[rng.integers(len(vals))]), (ct, vals[rng.integers(len(vals))])))
    out.append(((0, math.nan), (10 * SEC, 4.0)))  # the first window
    return out


def _dp(types, t, v):
    return types.Datapoint(t, v)


def _same(a, b):
    return a.time_nanos == b.time_nanos and (
        np.float64(a.value).view(np.uint64) == np.float64(b.value).view(np.uint64)
        or (math.isnan(a.value) and math.isnan(b.value)))


@pytest.mark.parametrize("name", ["per_second", "increase"])
def test_binary_scalar_transforms_match_jax(name):
    jf, tf = getattr(jtf, name), getattr(ttf, name)
    for (pt, pv), (ct, cv) in _pairs():
        j = jf(_dp(jtypes, pt, pv), _dp(jtypes, ct, cv))
        t = tf(_dp(ttypes, pt, pv), _dp(ttypes, ct, cv))
        assert _same(j, t), (pt, pv, ct, cv)


def test_unary_scalar_transforms_match_jax():
    jadd, tadd = jtf.make_add(), ttf.make_add()
    for (pt, pv), _ in _pairs(4):
        assert _same(jtf.absolute(_dp(jtypes, pt, pv)), ttf.absolute(_dp(ttypes, pt, pv)))
        assert _same(jadd(_dp(jtypes, pt, pv)), tadd(_dp(ttypes, pt, pv)))
        for res in (1, 2, 3, 10 * SEC):
            ja, jb = jtf.reset(_dp(jtypes, pt, pv), res)
            ta, tb = ttf.reset(_dp(ttypes, pt, pv), res)
            assert _same(ja, ta) and _same(jb, tb)
    assert ttf.EMPTY_DATAPOINT.time_nanos == jtypes.EMPTY_DATAPOINT.time_nanos == 0
    assert [t.name for t in ttf.TransformationType] == [t.name for t in jtf.TransformationType]
    for t in ttf.TransformationType:
        jt = jtf.TransformationType(int(t))
        assert (t.is_unary(), t.is_binary(), t.is_unary_multi()) == (
            jt.is_unary(), jt.is_binary(), jt.is_unary_multi())


def _batch(seed, shape=(6, 33)):
    rng = np.random.default_rng(seed)
    vals = np.cumsum(rng.normal(1.0, 3.0, shape), axis=-1)
    vals[rng.random(shape) < 0.08] = np.nan
    dt = rng.integers(-1, 4, shape) * SEC  # steps backwards and standing still
    times = 10**12 + np.cumsum(dt, axis=-1)
    prev_v = rng.normal(0.0, 5.0, shape[:-1])
    prev_v[0] = np.nan  # a row with no previous value
    prev_t = times[..., 0] - rng.integers(-1, 3, shape[:-1]) * SEC
    return vals, times.astype(np.int64), prev_v, prev_t.astype(np.int64)


def _bits_equal(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    both_nan = np.isnan(a) & np.isnan(b)
    return bool(np.all(both_nan | (a.view(np.uint64) == b.view(np.uint64))))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_batched_transforms_match_jax(seed):
    vals, times, pv, pt = _batch(seed)
    T = {k: torch.from_numpy(np.ascontiguousarray(x)) for k, x in
         dict(v=vals, t=times, pv=pv, pt=pt).items()}
    assert _bits_equal(ttf.batched_absolute(T["v"]).numpy(), jtf.batched_absolute(jnp.asarray(vals)))
    for name in ("batched_per_second", "batched_increase"):
        j = getattr(jtf, name)(jnp.asarray(vals), jnp.asarray(times), jnp.asarray(pv),
                               jnp.asarray(pt))
        t = getattr(ttf, name)(T["v"], T["t"], T["pv"], T["pt"])
        assert t.dtype == torch.float64 and t.shape == vals.shape
        assert _bits_equal(t.numpy(), j), name
    jo, jl = jtf.batched_add(jnp.asarray(vals), jnp.asarray(np.nan_to_num(pv)))
    to, tl = ttf.batched_add(T["v"], torch.from_numpy(np.nan_to_num(pv)))
    contrib = np.where(np.isnan(vals), 0.0, vals)
    scale = np.abs(np.cumsum(contrib, axis=-1)).max(axis=-1) + np.abs(np.nan_to_num(pv))
    bound = 64 * EPS * scale[..., None]
    assert np.all(np.abs(to.numpy() - np.asarray(jo)) <= bound)
    assert np.all(np.abs(tl.numpy() - np.asarray(jl)) <= bound[..., 0])


def test_batched_matches_scalar_semantics():
    """Each batched lane equals the scalar transform on the same pair (a
    NaN output is the empty datapoint)."""
    vals, times, pv, pt = _batch(9, (3, 12))
    out = ttf.batched_per_second(*(torch.from_numpy(x) for x in (vals, times, pv, pt)))
    inc = ttf.batched_increase(*(torch.from_numpy(x) for x in (vals, times, pv, pt)))
    for r in range(3):
        prev = (int(pt[r]), float(pv[r]))
        for c in range(12):
            cur = (int(times[r, c]), float(vals[r, c]))
            for got, fn in ((out, ttf.per_second), (inc, ttf.increase)):
                want = fn(ttypes.Datapoint(*prev), ttypes.Datapoint(*cur))
                g = float(got[r, c])
                assert (math.isnan(g) and math.isnan(want.value)) or g == want.value
            prev = cur
