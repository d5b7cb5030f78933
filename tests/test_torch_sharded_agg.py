"""m3_tpu_torch.parallel.sharded_agg against m3_tpu.parallel.sharded_agg
on the CPU: the JAX step on the eight virtual CPU devices, the port's on
a mesh of repeated ``cpu`` devices, the batch of
``tests/test_parallel.py`` through both, on (8, 1) and (4, 2) meshes and
both arena layouts.

Bounds: every counter lane, count, the rollup, ``err`` and the remaining
window-1 counts exactly (the f64 rollup sums too: the port's psum adds
in shard order and came out bit-equal to XLA's).  STDEV within
``rtol=1e-12`` on every lane family (XLA contracts ``count * sum_sq -
sum^2`` into an FMA; ``tests/test_torch_arena.py`` holds it the same
way), and the packed gauge ``sum_sq`` within ``rtol=2e-15`` (its FMA in
the scan, ROADMAP Queue C); every other lane bit for bit.  Each shard
also equals the port's own one-device arena run on its samples, bit for
bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3_tpu.aggregator import packed as jpacked
from m3_tpu.parallel import make_mesh as jax_make_mesh
from m3_tpu.parallel import sharded_agg as jsa
from m3_tpu_torch.aggregator import arena as tarena
from m3_tpu_torch.aggregator import packed as tpacked
from m3_tpu_torch.parallel import mesh
from m3_tpu_torch.parallel import sharded_agg as tsa

QUANTILES = (0.5, 0.95, 0.99)
STDEV = tarena.SCALAR_LANES.index(tarena.AggregationType.STDEV)
SUM_SQ = tarena.SCALAR_LANES.index(tarena.AggregationType.SUM_SQ)


def _batch(D, W, C, N, seed=0):
    """tests/test_parallel.py's ``_mk_batch`` as numpy arrays."""
    rng = np.random.default_rng(seed)
    return tsa.ShardedBatch(
        windows=rng.integers(0, W, (D, N)).astype(np.int32),
        slots=rng.integers(0, C, (D, N)).astype(np.int32),
        counter_values=rng.integers(0, 1000, (D, N)).astype(np.int64),
        gauge_values=rng.normal(100.0, 10.0, (D, N)),
        timer_values=np.abs(rng.normal(0.1, 0.02, (D, N))),
        times=np.tile(np.arange(1, N + 1), (D, 1)).astype(np.int64))


def _jax_step(shards, replicas, batch, W, C, scap, layout, window=0):
    topo = jax_make_mesh(shards, replicas, devices=jax.devices()[:shards * replicas])
    put = lambda a: jax.device_put(jnp.asarray(a), topo.sharded(None))
    state, lanes = jsa.sharded_ingest_consume(
        topo, jsa.sharded_init(topo, W, C, scap, layout=layout),
        jsa.ShardedBatch(*map(put, batch)), jnp.int32(window), W, C, QUANTILES,
        layout=layout)
    return state, jax.tree.map(np.asarray, lanes)


def _port_step(shards, replicas, batch, W, C, scap, layout, window=0):
    topo = mesh.make_mesh(shards, replicas, ["cpu"] * (shards * replicas))
    state, lanes = tsa.sharded_ingest_consume(
        topo, tsa.sharded_init(topo, W, C, scap, layout=layout), batch,
        torch.tensor(window, dtype=torch.int32), W, C, QUANTILES, layout=layout)
    return topo, state, lanes


def _assert_lanes(got, want, kind, layout):
    assert got.shape == want.shape, (kind, got.shape, want.shape)
    for lane in range(want.shape[-1]):
        g, w = got[..., lane], want[..., lane]
        if lane == STDEV:
            np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=kind)
        elif kind == "gauge" and layout == "packed" and lane == SUM_SQ:
            np.testing.assert_allclose(g, w, rtol=2e-15, err_msg=kind)
        else:
            assert np.array_equal(g.view(np.int64), w.view(np.int64)), (kind, lane)


def _remaining(state, layout) -> int:
    """Samples left in the counter arenas after the drain (replica 0)."""
    total = 0
    for row in state.counters:
        st = row[0]
        if layout == "f64":
            total += int(st.count.sum())
        else:
            cnt, _ = tpacked._unpack_base(st.base, tpacked.DEFAULT_WIDTHS)
            total += int(cnt.sum())
    return total


@pytest.mark.parametrize("layout", ["packed", "f64"])
@pytest.mark.parametrize("shards,replicas", [(8, 1), (4, 2)])
def test_sharded_step_matches_jax(shards, replicas, layout):
    W, C, N = 2, 32, 64
    batch = _batch(shards, W, C, N)
    j_state, want = _jax_step(shards, replicas, batch, W, C, 4 * N, layout)
    topo, state, got = _port_step(shards, replicas, batch, W, C, 4 * N, layout)
    for kind in ("counter", "gauge", "timer"):
        _assert_lanes(got[kind][0].numpy(), want[kind][0], kind, layout)
        assert np.array_equal(got[kind][1].numpy(), want[kind][1]), kind
    assert got["counter"][0].shape == (shards, C, 8)
    assert np.array_equal(got["rollup"].numpy(), want["rollup"], equal_nan=True)
    assert np.isnan(got["rollup"].numpy()[:, 2:]).any() == np.isnan(want["rollup"][:, 2:]).any()
    assert got["err"].dtype == torch.int32
    assert np.array_equal(got["err"].numpy(), want["err"]) and not want["err"].any()
    if layout == "f64":
        j_left = int(np.asarray(j_state.counters.count).sum())
    else:
        cnt, _ = jpacked._unpack_base(jnp.asarray(np.asarray(j_state.counters.base)),
                                      jpacked.DEFAULT_WIDTHS)
        j_left = int(np.asarray(cnt).sum())
    assert _remaining(state, layout) == j_left == int((batch.windows == 1).sum())


@pytest.mark.parametrize("layout", ["packed", "f64"])
def test_each_shard_equals_a_one_device_arena_run(layout):
    W, C, N = 2, 32, 64
    batch = _batch(4, W, C, N, seed=1)
    _, state, got = _port_step(4, 1, batch, W, C, 4 * N, layout)
    for d in range(4):
        arenas = tarena.make_arenas(W, C, 4 * N, QUANTILES, layout=layout, device="cpu")
        for arena, kind, vals in zip(arenas, ("counter", "gauge", "timer"),
                                     (batch.counter_values, batch.gauge_values,
                                      batch.timer_values)):
            arena.ingest(batch.windows[d], batch.slots[d], vals[d], batch.times[d])
            lanes, cnt = arena.consume(0)
            assert np.array_equal(got[kind][0][d].numpy().view(np.int64),
                                  lanes.numpy().view(np.int64)), (kind, d)
            assert np.array_equal(got[kind][1][d].numpy(), cnt.numpy()), (kind, d)


@pytest.mark.parametrize("layout", ["packed", "f64"])
def test_shard_states_do_not_alias(layout):
    """Samples for shard 0 only: every other shard's state stays equal to
    a fresh one, field by field, and no two blocks share storage."""
    W, C, N = 2, 16, 48
    batch = _batch(4, W, C, N, seed=2)
    batch.slots[1:] = C  # out of range: dropped, from last_at too
    _, state, _ = _port_step(4, 2, batch, W, C, 4 * N, layout, window=1)
    fresh = tsa.sharded_init(mesh.make_mesh(1, 1, ["cpu"]), W, C, 4 * N, layout=layout)
    for field in tsa.ShardedAggregatorState._fields:
        blocks = getattr(state, field)
        ptrs = {t.data_ptr() for row in blocks for st in row for t in st if t.numel()}
        assert len(ptrs) == 8 * sum(1 for t in blocks[0][0] if t.numel()), field
        zero = getattr(fresh, field)[0][0]
        for d in range(1, 4):
            for r in range(2):
                for a, b in zip(blocks[d][r], zero):
                    assert torch.equal(a, b), (field, d, r)
        assert any(not torch.equal(a, b) for a, b in zip(blocks[0][0], zero)), field


def test_timer_overflow_surfaces_in_err():
    """A fixed-capacity packed timer buffer that overflows loses moments:
    the step flags it per shard, as the reference does, and raises
    nothing."""
    W, C, N = 2, 16, 64
    batch = _batch(1, W, C, N, seed=3)
    _, want = _jax_step(1, 1, batch, W, C, 8, "packed")
    _, _, got = _port_step(1, 1, batch, W, C, 8, "packed")
    assert np.array_equal(got["err"].numpy(), want["err"])
    assert (got["err"].numpy() & tpacked._ERR_TIMER_OVERFLOW).all()
    assert tpacked._ERR_TIMER_OVERFLOW == jpacked._ERR_TIMER_OVERFLOW


def test_layout_is_validated():
    topo = mesh.make_mesh(1, 1, ["cpu"])
    with pytest.raises(ValueError, match="unknown arena layout"):
        tsa.sharded_init(topo, 2, 8, 32, layout="packd")
    state = tsa.sharded_init(topo, 2, 8, 32, layout="f64")
    with pytest.raises(ValueError, match="layout 'packed' but the state is CounterState"):
        tsa.sharded_ingest_consume(topo, state, _batch(1, 2, 8, 4), 0, 2, 8)


def test_package_exports_match_the_reference():
    import m3_tpu.parallel as jp
    import m3_tpu_torch.parallel as tp

    assert sorted(tp.__all__) == sorted(jp.__all__)
    assert tp.sharded_ingest_consume is tsa.sharded_ingest_consume
    assert tp.make_mesh is mesh.make_mesh
