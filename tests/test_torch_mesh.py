"""m3_tpu_torch.parallel.mesh on the CPU: a mesh is a repeated device
list here, as the JAX suite's eight virtual CPU devices are there.

* ``make_mesh`` shapes, and its errors with the messages of
  ``m3_tpu.parallel.make_mesh``;
* ``split`` / ``replicate`` give every block its own storage;
* each collective against numpy on (8, 1) and (4, 2) meshes, exactly:
  the reductions add left to right in axis order, as ``functools.reduce``
  does.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from m3_tpu.parallel import make_mesh as jax_make_mesh
from m3_tpu_torch.parallel import mesh

MESHES = [(8, 1), (4, 2)]


def _cpu(n):
    return ["cpu"] * n


@pytest.mark.parametrize("shards,replicas", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_make_mesh_shapes(shards, replicas):
    topo = mesh.make_mesh(shards, replicas, _cpu(8))
    assert (topo.num_shards, topo.num_replicas) == (shards, replicas)
    assert topo.first == torch.device("cpu")
    ref = jax_make_mesh(shards, replicas, devices=jax.devices()[:8])
    assert (ref.num_shards, ref.num_replicas) == (shards, replicas)
    default = mesh.make_mesh(num_replicas=replicas, devices=_cpu(8))
    assert (default.num_shards, default.num_replicas) == (8 // replicas, replicas)


@pytest.mark.parametrize("shards,replicas", [(3, 2), (None, 3), (5, 1)])
def test_make_mesh_errors_match_jax(shards, replicas):
    with pytest.raises(ValueError) as want:
        jax_make_mesh(shards, replicas, devices=jax.devices()[:8])
    with pytest.raises(ValueError) as got:
        mesh.make_mesh(shards, replicas, _cpu(8))
    assert str(got.value) == str(want.value)


def test_default_devices_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()


def test_split_and_replicate_own_their_storage():
    topo = mesh.make_mesh(4, 2, _cpu(8))
    x = torch.arange(24, dtype=torch.float64).reshape(4, 6)
    blocks = mesh.split(topo, x)
    ptrs = {b.data_ptr() for row in blocks for b in row}
    assert len(ptrs) == 8 and x.data_ptr() not in ptrs
    for d in range(4):
        for r in range(2):
            assert torch.equal(blocks[d][r], x[d])
    blocks[1][0].add_(1)
    assert torch.equal(blocks[1][1], x[1]) and torch.equal(x[1], torch.arange(6, 12.0))
    y = np.arange(16).reshape(4, 2, 2)
    per = mesh.split(topo, y, replica_axis=True, dtype=torch.int32)
    assert per[2][1].dtype == torch.int32 and per[2][1].tolist() == y[2, 1].tolist()
    rep = mesh.replicate(topo, x)
    assert len({b.data_ptr() for row in rep for b in row}) == 8
    want = x.clone()
    want[1] += 1  # replica 0 of shard 1, added to above
    assert torch.equal(mesh.stack(topo, blocks), want)
    with pytest.raises(ValueError, match="leading axes"):
        mesh.split(topo, x[:3])


def test_run_takes_each_devices_block():
    topo = mesh.make_mesh(4, 2, _cpu(8))
    x = mesh.split(topo, np.arange(8.0).reshape(4, 2), replica_axis=True)
    tree = {"x": x, "k": 10}
    out = mesh.run(topo, lambda t, c: (t["x"] * t["k"] + c, t["k"]), tree, 1.0)
    vals, ks = mesh.unzip(out)
    assert [[float(v) for v in row] for row in vals] == [
        [10 * (2 * d + r) + 1.0 for r in range(2)] for d in range(4)]
    assert all(k == 10 for row in ks for k in row)


def _values(topo, rng, shape):
    """(D, R, *shape) values whose sum depends on the order of adds."""
    D, R = topo.num_shards, topo.num_replicas
    return rng.normal(size=(D, R) + shape) * 10.0 ** rng.integers(-8, 9, (D, R) + shape)


@pytest.mark.parametrize("shards,replicas", MESHES)
@pytest.mark.parametrize("op", ["psum", "pmin", "pmax"])
def test_shard_axis_collectives_match_numpy(shards, replicas, op):
    topo = mesh.make_mesh(shards, replicas, _cpu(8))
    rng = np.random.default_rng(shards + 3 * len(op))
    x = _values(topo, rng, (5, 3))
    if op != "psum":
        x[0, 0, 1, 1] = np.nan  # propagates, as in XLA
    blocks = mesh.split(topo, x, replica_axis=True)
    fold = {"psum": np.add, "pmin": np.minimum, "pmax": np.maximum}[op]
    out = getattr(mesh, op)(topo, blocks, mesh.SHARD_AXIS)
    for r in range(replicas):
        want = functools.reduce(fold, [x[d, r] for d in range(shards)])
        for d in range(shards):
            assert np.array_equal(out[d][r].numpy(), want, equal_nan=True), (op, d, r)
    assert len({b.data_ptr() for row in out for b in row}) == shards * replicas


@pytest.mark.parametrize("shards,replicas", MESHES)
def test_replica_axis_psum_and_ring_ppermute_match_numpy(shards, replicas):
    topo = mesh.make_mesh(shards, replicas, _cpu(8))
    rng = np.random.default_rng(7)
    x = _values(topo, rng, (4,))
    blocks = mesh.split(topo, x, replica_axis=True)
    out = mesh.psum(topo, blocks, mesh.REPLICA_AXIS)
    ring = mesh.ppermute(topo, blocks, [(i, (i + 1) % replicas) for i in range(replicas)],
                         mesh.REPLICA_AXIS)
    for d in range(shards):
        want = functools.reduce(np.add, [x[d, r] for r in range(replicas)])
        for r in range(replicas):
            assert np.array_equal(out[d][r].numpy(), want)
            assert np.array_equal(ring[d][r].numpy(), x[d, (r - 1) % replicas])
    half = mesh.ppermute(topo, blocks, [(0, replicas - 1)], mesh.REPLICA_AXIS)
    for d in range(shards):
        assert np.array_equal(half[d][replicas - 1].numpy(), x[d, 0])
        if replicas > 1:  # a block that receives nothing becomes zeros, as in JAX
            assert not half[d][0].any()


def test_unknown_axis_raises():
    topo = mesh.make_mesh(4, 2, _cpu(8))
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh.psum(topo, mesh.replicate(topo, torch.zeros(2)), "rows")
