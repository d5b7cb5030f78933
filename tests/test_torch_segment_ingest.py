"""The port's segment reductions (``m3_tpu_torch/parallel/segment_ingest.py``)
against the JAX package's ``pallas_ingest`` (its Pallas kernels in
interpret mode, and the XLA scatter oracle), on the CPU, where the
wrappers take their plain versions.  The CUDA kernels are held against
the same plain versions on a card by tests/test_torch_gpu.py.

Tolerances: counts, integer lanes and min/max exact; f64 sums and sums
of squares ``atol=1e-9`` (tests/test_pallas_ingest.py's own).  Sizes
are test_pallas_ingest.py's: interpret mode is slow.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from m3_tpu.parallel import pallas_ingest as pi
from m3_tpu_torch.parallel import segment_ingest as si

GRID = [(100, 257, 0), (3000, 5000, 1), (1024, 1024, 2), (17, 10_000, 3)]


def _inputs(C, N, seed):
    rng = np.random.default_rng(seed)
    slots = rng.integers(-3, C + 3, N).astype(np.int32)  # incl. out of range
    vals = np.round(rng.normal(0, 10, N), 6)
    vals[::97] = np.nan  # a NaN poisons only its own slot
    return slots, vals


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _close(port, ref, exact=False):
    ref = np.asarray(ref)
    got = port.numpy()
    assert got.dtype == ref.dtype
    if exact or not np.issubdtype(ref.dtype, np.floating):
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-9)


@pytest.mark.parametrize("C,N,seed", GRID)
def test_sum_count_matches_pallas_and_scatter(C, N, seed):
    slots, vals = _inputs(C, N, seed)
    ps, pc = si.pallas_segment_ingest(*_t(slots, vals), C)
    js, jc = pi.pallas_segment_ingest(*_j(slots, vals), C, interpret=True)
    xs, xc = pi.xla_segment_ingest(*_j(slots, vals), C)
    _close(ps, js)
    _close(pc, jc)
    _close(ps, xs)
    _close(pc, xc)
    os_, oc = si.xla_segment_ingest(*_t(slots, vals), C)
    _close(os_, xs)
    _close(oc, xc)


@pytest.mark.parametrize("C,N,seed", GRID[:2])
def test_moments_match_pallas(C, N, seed):
    slots, vals = _inputs(C, N, seed)
    got = si.pallas_segment_moments(*_t(slots, vals), C)
    want = pi.pallas_segment_moments(*_j(slots, vals), C, interpret=True)
    for g, w in zip(got, want):
        _close(g, w)


def test_int64_lanes_exact_and_wrap():
    """Integer sums and squares wrap as int64 does, exactly."""
    rng = np.random.default_rng(5)
    C, N = 64, 3000
    slots = rng.integers(-2, C + 2, N).astype(np.int32)
    vals = rng.integers(-(1 << 40), 1 << 40, N, dtype=np.int64)
    vals[:5] = np.iinfo(np.int64).max
    got = si.pallas_segment_moments(*_t(slots, vals), C)
    want = pi.pallas_segment_moments(*_j(slots, vals), C, interpret=True)
    for g, w in zip(got, want):
        _close(g, w, exact=True)


def test_high_collision_all_one_slot():
    N, C = 4096, 128
    ps, pc = si.pallas_segment_ingest(torch.zeros(N, dtype=torch.int32),
                                      torch.ones(N, dtype=torch.float64), C)
    assert float(ps[0]) == N and int(pc[0]) == N
    assert float(ps[1:].sum()) == 0.0 and int(pc[1:].sum()) == 0


def test_empty_batch():
    e_s, e_v = torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.float64)
    ps, pc = si.pallas_segment_ingest(e_s, e_v, 64)
    assert ps.shape == (64,) and float(ps.abs().sum()) == 0 and int(pc.sum()) == 0
    mn, mx = si.pallas_segment_minmax(e_s, e_v, 64)
    assert bool(torch.isinf(mn).all()) and bool((mn > 0).all()) and bool((mx < 0).all())
    for fn in (si.segment_ingest_chunked, si.segment_moments_chunked,
               si.segment_minmax_chunked):
        assert all(o.shape == (64,) for o in fn(e_s, e_v, 64))


@pytest.mark.parametrize("fn", ["pallas_segment_ingest", "pallas_segment_moments",
                                "pallas_segment_minmax"])
def test_oversized_batch_rejected(fn):
    n = si.MAX_BATCH + 1
    with pytest.raises(ValueError, match="MAX_BATCH"):
        getattr(si, fn)(torch.zeros(n, dtype=torch.int32),
                        torch.zeros(n, dtype=torch.float64), 64)


def test_chunked_matches_across_real_boundaries(monkeypatch):
    """MAX_BATCH shrunk to 2048 so the 7000-point batch spans 4 chunks in
    both packages."""
    monkeypatch.setattr(si, "MAX_BATCH", 2048)
    monkeypatch.setattr(pi, "MAX_BATCH", 2048)
    rng = np.random.default_rng(9)
    N, C = 7000, 256
    slots = rng.integers(-2, C + 2, N).astype(np.int32)
    vals = rng.normal(0, 5, N)
    pairs = [
        (si.segment_ingest_chunked(*_t(slots, vals), C),
         pi.segment_ingest_chunked(*_j(slots, vals), C, interpret=True)),
        (si.segment_moments_chunked(*_t(slots, vals), C),
         pi.segment_moments_chunked(*_j(slots, vals), C, interpret=True)),
        (si.segment_minmax_chunked(*_t(slots, vals), C),
         pi.segment_minmax_chunked(*_j(slots, vals), C, interpret=True)),
    ]
    for got, want in pairs:
        for g, w in zip(got, want):
            _close(g, w)
    xs, xc = pi.xla_segment_ingest(*_j(slots, vals), C)
    _close(pairs[0][0][0], xs)
    _close(pairs[0][0][1], xc)


def test_minmax_f64_with_out_of_range_slots():
    rng = np.random.default_rng(21)
    C, N = 300, 4000
    slots = rng.integers(-3, C + 5, N).astype(np.int32)
    vals = np.round(rng.normal(0, 100, N), 3)
    got = si.pallas_segment_minmax(*_t(slots, vals), C)
    want = pi.pallas_segment_minmax(*_j(slots, vals), C, interpret=True)
    for g, w in zip(got, want):
        _close(g, w, exact=True)


def test_minmax_int64_identities():
    slots = np.asarray([3, 3, 10, -1, 64], np.int32)
    vals = np.asarray([-7, 9, 2, 100, 100], np.int64)
    got = si.pallas_segment_minmax(*_t(slots, vals), 64)
    want = pi.pallas_segment_minmax(*_j(slots, vals), 64, interpret=True)
    for g, w in zip(got, want):
        _close(g, w, exact=True)
    info = np.iinfo(np.int64)
    assert int(got[0][0]) == info.max and int(got[1][0]) == info.min


def test_minmax_nan_and_signed_zero_rule():
    """A NaN makes both its slot's min and max NaN; a slot holding -0 and
    +0 gets min -0 and max +0 in either order (the reference's order)."""
    slots = np.asarray([0, 0, 0, 1, 1, 2, 2, 3], np.int32)
    vals = np.asarray([1.0, np.nan, 3.0, -0.0, 0.0, 0.0, -0.0, np.nan])
    got = si.pallas_segment_minmax(*_t(slots, vals), 5)
    want = pi.pallas_segment_minmax(*_j(slots, vals), 5, interpret=True)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(np.signbit(g[1:3]), np.signbit(w[1:3]))
    assert np.isnan(got[0][[0, 3]].numpy()).all() and np.isnan(got[1][[0, 3]].numpy()).all()


def test_total_order_minimum_maximum():
    a = torch.tensor([-0.0, 0.0, 1.0, np.nan, 2.0])
    b = torch.tensor([0.0, -0.0, np.nan, 1.0, 3.0])
    mn, mx = si.minimum(a, b).numpy(), si.maximum(a, b).numpy()
    assert np.signbit(mn[:2]).all() and not np.signbit(mx[:2]).any()
    assert np.isnan(mn[2:4]).all() and np.isnan(mx[2:4]).all()
    assert mn[4] == 2.0 and mx[4] == 3.0


def test_wrappers_route_cpu_to_plain_and_reject_bad_inputs():
    slots, vals = _t(*_inputs(50, 400, 7))
    before = dict(si.launches)
    a = si.segment_ingest(slots, vals, 50, with_sq=True)
    b = si.segment_ingest_plain(slots, vals, 50, with_sq=True)
    for x, y in zip(a, b):
        assert torch.equal(x.nan_to_num(), y.nan_to_num())
    assert si.launches == before  # the plain path is not a launch
    with pytest.raises(TypeError):
        si.segment_ingest(slots.long(), vals, 50)
    with pytest.raises(ValueError):
        si.segment_minmax(slots[:5], vals, 50)
    meta = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        si.segment_minmax(meta, torch.empty(4, device="meta"), 8)
