"""The port's segmented scans (``m3_tpu_torch/parallel/segmented.py``) on
the CPU against ``jax.lax.associative_scan`` and
``m3_tpu.parallel.segmented``, on numpy inputs from a seed.

Bit for bit everywhere (NaN as one NaN): the mirror follows jax's tree
order, so adds of materialised inputs round the same, and it returns
``+0.0`` for every zero as jax's pad-and-add interleave does.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from m3_tpu.parallel import segmented as js
from m3_tpu_torch.parallel import segmented as ts

SIZES = (1, 2, 3, 7, 1000, 65539)


def _data(n, seed=0):
    """Head flags plus two float lanes with ±0, ±inf and NaN, values
    spread over twelve decades (so the add order shows)."""
    rng = np.random.default_rng(seed + n)
    head = rng.random(n) < 0.1
    head[0] = True
    lanes = []
    for _ in range(2):
        v = rng.normal(0, 1, n) * 10.0 ** rng.integers(-6, 7, n)
        for val, p in ((0.0, 0.05), (-0.0, 0.05), (np.inf, 0.002), (-np.inf, 0.002),
                       (np.nan, 0.002)):
            v[rng.random(n) < p] = val
        lanes.append(v)
    return head, lanes


def _same(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if want.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
        ok = ~np.isnan(want)
        np.testing.assert_array_equal(got[ok].view(np.uint64), want[ok].view(np.uint64),
                                      err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _combines(mod):
    """Segmented combines in each package's ops: add, min, max, and a
    ``where`` that keeps the value of the later head (a last-wins)."""
    where, mn, mx = ((jnp.where, jnp.minimum, jnp.maximum) if mod is jnp
                     else (torch.where, torch.minimum, torch.maximum))

    def seg(f):
        return lambda a, b: (a[0] | b[0], where(b[0], b[1], f(a[1], b[1])))

    return {
        "add": seg(lambda x, y: x + y),
        "min": seg(mn),
        "max": seg(mx),
        "where": lambda a, b: (a[0] | b[0], where(b[2] > a[2], b[1], a[1]), mx(a[2], b[2])),
    }


@pytest.mark.parametrize("kind", ["add", "min", "max", "where"])
@pytest.mark.parametrize("n", SIZES)
def test_associative_scan_matches_jax(n, kind):
    head, (v, w) = _data(n)
    jfn, tfn = _combines(jnp)[kind], _combines(torch)[kind]
    elems = (head, v, w) if kind == "where" else (head, v)
    want = jax.jit(lambda *e: jax.lax.associative_scan(jfn, e))(*elems)
    got = ts.associative_scan(tfn, tuple(torch.from_numpy(e) for e in elems))
    assert len(got) == len(want)
    for i, (g, x) in enumerate(zip(got, want)):
        _same(g, x, f"n={n} {kind} lane {i}")
    if n > 1:
        assert not np.signbit(got[1].numpy()[got[1].numpy() == 0]).any()


def test_associative_scan_integer_lanes_and_trailing_dims():
    """int64 lanes (wrapping adds) and (N, 3) lanes go through unchanged."""
    rng = np.random.default_rng(3)
    n = 1001
    a = rng.integers(-(1 << 62), 1 << 62, n)
    m = rng.normal(size=(n, 3))
    jfn = lambda x, y: (x[0] + y[0], jnp.maximum(x[1], y[1]))
    tfn = lambda x, y: (x[0] + y[0], torch.maximum(x[1], y[1]))
    want = jax.jit(lambda *e: jax.lax.associative_scan(jfn, e))(a, m)
    got = ts.associative_scan(tfn, (torch.from_numpy(a), torch.from_numpy(m)))
    for g, x in zip(got, want):
        _same(g, x, "int/trailing")


@pytest.mark.parametrize("n", SIZES)
def test_head_flag_scan_matches_jax(n):
    head, (v, w) = _data(n, seed=5)
    m = np.stack([w, -w], axis=1)  # a trailing lane dim
    want = jax.jit(js.head_flag_scan)(jnp.asarray(head), adds=(jnp.asarray(v), jnp.asarray(m)),
                                      mins=(jnp.asarray(w),),
                                      maxs=(jnp.asarray(v), jnp.asarray(m)))
    got = ts.head_flag_scan(torch.from_numpy(head), adds=(torch.from_numpy(v), torch.from_numpy(m)),
                            mins=(torch.from_numpy(w),),
                            maxs=(torch.from_numpy(v), torch.from_numpy(m)))
    assert [len(g) for g in got] == [2, 1, 2]
    for group, (gs, xs) in enumerate(zip(got, want)):
        for i, (g, x) in enumerate(zip(gs, xs)):
            _same(g, x, f"n={n} group {group} lane {i}")


def test_last_occurrence_matches_jax():
    rng = np.random.default_rng(9)
    keys = np.sort(rng.integers(0, 50, 200)).astype(np.int64)
    queries = np.concatenate([rng.integers(-5, 60, 300), [0, 49, -1, 50]]).astype(np.int64)
    for k in (keys, keys[:1]):
        jpos, jfound = js.last_occurrence(jnp.asarray(k), jnp.asarray(queries))
        tpos, tfound = ts.last_occurrence(torch.from_numpy(k), torch.from_numpy(queries))
        _same(tfound, jfound, "found")
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        hit = tfound.numpy()
        assert (k[tpos.numpy()[hit]] == queries[hit]).all()
    pos, found = ts.last_occurrence(torch.zeros(0, dtype=torch.int64), torch.from_numpy(queries))
    assert not found.any() and (pos == 0).all()
