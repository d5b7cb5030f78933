"""m3_tpu_torch.parallel.replication against m3_tpu.parallel.replication
on the CPU, the same numpy pytrees through both:

* ``fingerprint_tree`` bit for bit (the JAX package's u64 against the
  port's int64 carrying the same bits), over every leaf dtype the
  states hold, with negative ints, NaNs, nesting and ``None``;
* ``replica_divergence`` equal on a clean and on a corrupted (4, 2)
  state (``tests/test_replication.py``'s), and on the port's own sharded
  aggregator state with one bit flipped in one replica;
* ``quorum_ack`` equal for ``required`` of 1, R and R + 1;
* both entries fire the ``replication.collective`` faultpoint.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from m3_tpu.parallel import make_mesh as jax_make_mesh
from m3_tpu.parallel import replication as jrep
from m3_tpu_torch.parallel import mesh, sharded_agg
from m3_tpu_torch.parallel import replication as trep
from m3_tpu_torch.x import fault


class _Pair(NamedTuple):
    b: object
    a: object


def _leaves(seed):
    rng = np.random.default_rng(seed)
    f64 = rng.normal(size=(3, 5))
    f64[1, 2] = np.nan
    f64[0, 0] = -0.0
    f32 = rng.normal(size=7).astype(np.float32)
    f32[3] = np.nan
    return {
        "bool": rng.random(9) < 0.5,
        "i8": rng.integers(-128, 128, 11).astype(np.int8),
        "i16": rng.integers(-2**15, 2**15, 6).astype(np.int16),
        "i32": rng.integers(-2**31, 2**31, (2, 4)).astype(np.int32),
        "i64": rng.integers(-2**63, 2**63 - 1, 5, dtype=np.int64),
        "u8": rng.integers(0, 256, 13).astype(np.uint8),
        "f32": f32,
        "f64": f64,
    }


def _jax_fp(tree):
    return int(np.asarray(jrep.fingerprint_tree(jax.tree.map(jnp.asarray, tree))))


def _port_fp(tree):
    return int(trep.fingerprint_tree(tree).numpy().view(np.uint64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fingerprint_bit_equal_to_jax(seed):
    leaves = _leaves(seed)
    tree = {"z": _Pair(b=leaves["f64"], a=[leaves["i8"], None, leaves["bool"]]),
            "a": (leaves["i16"], {"k": leaves["i32"], "c": leaves["u8"]}),
            "m": [leaves["i64"], leaves["f32"]]}
    assert _port_fp(tree) == _jax_fp(tree)
    for name, leaf in leaves.items():  # one leaf at a time, every dtype
        assert _port_fp([leaf]) == _jax_fp([leaf]), name
    scalar = {"n": np.asarray(-7, np.int32), "x": np.asarray(np.nan)}
    assert _port_fp(scalar) == _jax_fp(scalar)
    moved = dict(tree, m=[leaves["f32"], leaves["i64"]])  # leaf order matters
    assert _port_fp(moved) == _jax_fp(moved) != _jax_fp(tree)


def _state(S=4, R=2):
    """tests/test_replication.py's (shard, replica) state."""
    rng = np.random.default_rng(0)
    base = rng.normal(size=(S, 16))
    return {"buf": np.broadcast_to(base[:, None], (S, R, 16)).copy(),
            "cnt": np.tile(np.arange(S)[:, None, None], (1, R, 4))}


def _both_divergence(state):
    jt = jax_make_mesh(4, 2, devices=jax.devices()[:8])
    want = np.asarray(jrep.replica_divergence(jt, jax.tree.map(jnp.asarray, state)))
    tt = mesh.make_mesh(4, 2, ["cpu"] * 8)
    blocks = {k: mesh.split(tt, v, replica_axis=True) for k, v in state.items()}
    return trep.replica_divergence(tt, blocks).numpy(), want


def test_replica_divergence_equal_to_jax():
    got, want = _both_divergence(_state())
    assert got.shape == (4, 2) and np.array_equal(got, want) and not got.any()
    bad = _state()
    bad["buf"][2, 1, 7] += 1e-9  # shard 2, replica 1: one element
    got, want = _both_divergence(bad)
    assert np.array_equal(got, want)
    assert got[2].all() and not got[[0, 1, 3]].any()


def test_divergence_of_a_sharded_aggregator_state():
    """Each replica ran the step on its own copy, so all agree; one bit
    flipped in one replica's counter state turns exactly that replica's
    edge and its successor's True."""
    topo = mesh.make_mesh(2, 4, ["cpu"] * 8)
    W, C, N = 2, 16, 40
    rng = np.random.default_rng(5)
    batch = sharded_agg.ShardedBatch(
        windows=rng.integers(0, W, (2, N)), slots=rng.integers(0, C, (2, N)),
        counter_values=rng.integers(0, 100, (2, N)), gauge_values=rng.normal(size=(2, N)),
        timer_values=rng.random((2, N)), times=np.tile(np.arange(1, N + 1), (2, 1)))
    state = sharded_agg.sharded_init(topo, W, C, 4 * N, layout="f64")
    state, _ = sharded_agg.sharded_ingest_consume(topo, state, batch, 0, W, C, layout="f64")
    assert not trep.replica_divergence(topo, state).any()
    state.counters[1][2].sum[C + 3] ^= 1 << 20  # shard 1, replica 2: one bit
    want = np.zeros((2, 4), bool)
    want[1, [2, 3]] = True
    assert np.array_equal(trep.replica_divergence(topo, state).numpy(), want)


@pytest.mark.parametrize("required", [1, 2, 3])
def test_quorum_ack_equal_to_jax(required):
    acks = np.asarray([[1, 1], [1, 0], [0, 0], [0, 1]], np.int32)
    jt = jax_make_mesh(4, 2, devices=jax.devices()[:8])
    jok, jgot = jrep.quorum_ack(jt, jnp.asarray(acks), required=required)
    ok, got = trep.quorum_ack(mesh.make_mesh(4, 2, ["cpu"] * 8), acks, required)
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    assert np.array_equal(got.numpy(), np.asarray(jgot)) and got.dtype.itemsize == 4
    bools = trep.quorum_ack(mesh.make_mesh(4, 2, ["cpu"] * 8), acks.astype(bool), required)
    assert np.array_equal(bools[0].numpy(), np.asarray(jok))


def test_entries_fire_the_collective_faultpoint():
    topo = mesh.make_mesh(4, 2, ["cpu"] * 8)
    state = {k: mesh.split(topo, v, replica_axis=True) for k, v in _state().items()}
    acks = np.ones((4, 2), np.int32)
    before = fault.counters().get("replication.collective.passes", 0)
    with fault.armed("replication.collective", "error"):
        with pytest.raises(fault.FaultInjected):
            trep.replica_divergence(topo, state)
        with pytest.raises(fault.FaultInjected):
            trep.quorum_ack(topo, acks, 2)
    assert fault.counters()["replication.collective.passes"] == before + 2
    assert trep.quorum_ack(topo, acks, 2)[0].all()  # disarmed again
