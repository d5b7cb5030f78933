"""The port's segment reductions (``m3_tpu_torch/parallel/segment_ingest.py``)
against the JAX package: the fresh-output forms against ``pallas_ingest``
(its Pallas kernels in interpret mode, and the XLA scatter oracle), the
in-place forms against the reference's drop-mode scatters into non-zero
columns; on the CPU, where the wrappers take their plain versions.  The
CUDA kernels are held against the same plain versions on a card by
tests/test_torch_gpu.py.

Tolerances: the in-place forms bit for bit, float sums included (each
lane's points are added in arrival order, as the reference's scatter
adds them); the fresh forms' counts, integer lanes and min/max exact,
their f64 sums and sums of squares ``atol=1e-9`` against the Pallas
kernels (tests/test_pallas_ingest.py's own).  Sizes are
test_pallas_ingest.py's: interpret mode is slow.
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
    """Folding b into columns holding a, lane by lane, is the elementwise
    min and max in IEEE total order with NaN sticky."""
    a = torch.tensor([-0.0, 0.0, 1.0, np.nan, 2.0])
    b = torch.tensor([0.0, -0.0, np.nan, 1.0, 3.0])
    mn, mx = a.clone(), a.clone()
    si.segment_minmax_into(mn, mx, torch.arange(5), b)
    mn, mx = mn.numpy(), mx.numpy()
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


# ---- the in-place forms, against the reference's drop-mode scatters ----

INTO_DTYPES = [np.float64, np.float32, np.int64, np.int32]


def _into_inputs(dtype, idx_dtype, seed, L=300, N=5000):
    """Heavy collisions (~17 points a lane), out-of-range and negative
    lanes, columns that start non-zero; floats spread over 16 decades (so
    the order of the adds shows in the bits) with NaN and +-0; integers
    near the extremes (so the sums wrap)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-5, L + 5, N).astype(idx_dtype)
    if np.issubdtype(dtype, np.floating):
        vals = (rng.normal(0, 1, N) * 10.0 ** rng.integers(-8, 8, N)).astype(dtype)
        vals[::101] = np.nan
        vals[1::53] = -0.0
        vals[2::53] = 0.0
        col = (rng.normal(0, 1, L) * 10.0 ** rng.integers(-4, 4, L)).astype(dtype)
        col[::37] = -0.0
        col[5] = np.nan
    else:
        info = np.iinfo(dtype)
        vals = rng.integers(info.min, info.max, N, dtype=dtype, endpoint=True)
        col = rng.integers(info.min, info.max, L, dtype=dtype, endpoint=True)
    return idx, vals, col


def _seed(dtype, idx_dtype):
    return 2 * INTO_DTYPES.index(dtype) + int(idx_dtype == np.int64)


def _ref_idx(idx, L):
    """The reference wraps a negative index; the into-forms drop it (as
    the arena's flat_window_index does before every ingest)."""
    return jnp.asarray(np.where(idx < 0, L, idx))


def _same(got, want):
    """Bit for bit, every NaN taken as one NaN."""
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        np.testing.assert_array_equal(got[ok].view(f"u{got.itemsize}"),
                                      want[ok].view(f"u{want.itemsize}"))
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cnt_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("dtype", INTO_DTYPES)
def test_ingest_into_matches_reference_scatter(dtype, idx_dtype, cnt_dtype):
    idx, vals, col = _into_inputs(dtype, idx_dtype, seed=_seed(dtype, idx_dtype))
    L = col.shape[0]
    cnt = np.arange(L, dtype=cnt_dtype) * 3
    sq = col[::-1].copy()
    t_sum, t_cnt, t_sq = (x.clone() for x in _t(col, cnt, sq))  # numpy stays the start
    si.segment_ingest_into(t_sum, t_cnt, t_sq, *_t(idx, vals))
    ji, jv = _ref_idx(idx, L), jnp.asarray(vals)
    _same(t_sum, jnp.asarray(col).at[ji].add(jv, mode="drop"))
    _same(t_cnt, jnp.asarray(cnt).at[ji].add(1, mode="drop"))
    _same(t_sq, jnp.asarray(sq).at[ji].add(jv * jv, mode="drop"))
    # sq_col may be None: the sum/count form
    t_sum2, t_cnt2 = (x.clone() for x in _t(col, cnt))
    si.segment_ingest_into(t_sum2, t_cnt2, None, *_t(idx, vals))
    assert torch.equal(t_sum2.view(torch.uint8), t_sum.view(torch.uint8))
    assert torch.equal(t_cnt2, t_cnt)


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("dtype", INTO_DTYPES)
def test_minmax_into_matches_reference_scatter(dtype, idx_dtype):
    idx, vals, col = _into_inputs(dtype, idx_dtype, seed=_seed(dtype, idx_dtype) + 10)
    L = col.shape[0]
    mx = col[::-1].copy()
    t_mn, t_mx = (x.clone() for x in _t(col, mx))
    si.segment_minmax_into(t_mn, t_mx, *_t(idx, vals))
    ji, jv = _ref_idx(idx, L), jnp.asarray(vals)
    want_mn = jnp.asarray(col).at[ji].min(jv, mode="drop")
    want_mx = jnp.asarray(mx).at[ji].max(jv, mode="drop")
    _same(t_mn, want_mn)
    _same(t_mx, want_mx)
    if np.issubdtype(dtype, np.floating):
        assert np.isnan(t_mn.numpy()).any() and np.isnan(t_mx.numpy()).any()


def test_minmax_into_signed_zeros_and_sticky_nan():
    """-0 < +0 whatever the order; a stored NaN of either sign stays."""
    mn = torch.tensor([0.0, -0.0, np.nan, -np.nan, 1.0], dtype=torch.float64)
    mx = torch.tensor([-0.0, 0.0, np.nan, -np.nan, 1.0], dtype=torch.float64)
    idx = torch.tensor([0, 1, 0, 1, 2, 3, 4, -1, 5])
    vals = torch.tensor([-0.0, 0.0, 0.0, -0.0, 5.0, -5.0, np.nan, -9.0, 9.0],
                        dtype=torch.float64)
    si.segment_minmax_into(mn, mx, idx, vals)
    assert np.signbit(mn[:2].numpy()).all() and not np.signbit(mx[:2].numpy()).any()
    assert torch.isnan(mn[2:]).all() and torch.isnan(mx[2:]).all()


def test_into_rejects_bad_arguments():
    idx, vals = torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.float64)
    col = torch.zeros(8, dtype=torch.float64)
    cnt = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(TypeError):
        si.segment_ingest_into(col, cnt, None, idx.to(torch.int16), vals)
    with pytest.raises(TypeError):
        si.segment_ingest_into(col.float(), cnt, None, idx, vals)
    with pytest.raises(TypeError):
        si.segment_ingest_into(col, cnt.double(), None, idx, vals)
    with pytest.raises(ValueError):
        si.segment_ingest_into(col, cnt[:4], None, idx, vals)
    with pytest.raises(TypeError):
        si.segment_minmax_into(col, col.float(), idx, vals)
    before = dict(si.launches)
    si.segment_ingest_into(col, cnt, col.clone(), idx, vals)
    assert si.launches == before  # the plain path is not a launch
