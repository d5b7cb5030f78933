"""Replica-axis collectives, divergence detection and quorum: the
counterpart of ``m3_tpu/parallel/replication.py``.

The reference compares replicas with a metadata RPC sweep and counts
write quorum in the client session.  On a (shard x replica) mesh both
are one collective each:

* **checksum compare**: each replica fingerprints its own copy of its
  shard's state (every tensor of the pytree, bit-cast and mix-reduced),
  a ring ``ppermute`` along the replica axis hands each replica its
  neighbour's fingerprint, and equality around the ring means every
  replica agrees;
* **quorum**: per-replica ack bits ``psum``'d over the replica axis and
  compared with the consistency level's requirement.

The fingerprint is bit-equal to the JAX package's for the same pytree of
arrays: the JAX package's u64 arithmetic is done here on int64, whose
wraparound gives the same bits (as ``_bits.py`` does for u64 lanes), and
the value is returned as an int64 carrying those bits.
"""

from __future__ import annotations

import numpy as np
import torch

from m3_tpu_torch.parallel import mesh
from m3_tpu_torch.parallel.mesh import REPLICA_AXIS, MeshTopology
from m3_tpu_torch.x import fault

_MIX = 0x9E3779B97F4A7C15 - (1 << 64)  # the Fibonacci hashing constant, as int64
# a leaf's same-width integer view and the mask that zero-extends it
_SAME_SIZE = {1: (torch.int8, 0xFF), 2: (torch.int16, 0xFFFF),
              4: (torch.int32, 0xFFFFFFFF), 8: (torch.int64, None)}


def _tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order: tuples,
    NamedTuples and lists in order, dicts by sorted key, ``None``
    dropped."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _tree_leaves(v)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _tree_leaves(tree[k])]
    return [tree]


def _fingerprint_leaf(a: torch.Tensor) -> torch.Tensor:
    """Order-sensitive 64-bit mix-reduce of one tensor's raw bits: each
    element's bits zero-extended to 64, mixed with its position, summed
    (mod 2^64)."""
    if a.dtype == torch.bool:
        a = a.to(torch.uint8)
    view, mask = _SAME_SIZE[a.element_size()]
    bits = a.contiguous().view(view).reshape(-1).to(torch.int64)
    if mask is not None:
        bits = bits & mask
    pos = torch.arange(bits.shape[0], dtype=torch.int64, device=bits.device)
    return ((bits ^ (pos * _MIX)) * _MIX).sum()


def fingerprint_tree(tree) -> torch.Tensor:
    """The 0-d int64 fingerprint of every leaf of ``tree`` (tensors or
    numpy arrays), on the first leaf's device; its bits equal
    ``m3_tpu.parallel.replication.fingerprint_tree``'s u64."""
    leaves = [torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray)
              else torch.as_tensor(x) for x in _tree_leaves(tree)]
    dev = leaves[0].device if leaves else torch.device("cpu")
    fp = torch.zeros((), dtype=torch.int64, device=dev)
    for i, leaf in enumerate(leaves):
        fp = fp * _MIX + _fingerprint_leaf(leaf).to(dev) + (i + 1)
    return fp


def replica_divergence(topo: MeshTopology, state) -> torch.Tensor:
    """(num_shards, num_replicas) bool on the mesh's first device: True
    where a replica's state fingerprint differs from its ring
    predecessor's.  All False means every replica of every shard is bit
    for bit the same; one corrupt replica flips exactly two entries (its
    own edge and its successor's).

    ``state``: a pytree holding ``Blocks`` (``mesh.split(...,
    replica_axis=True)`` of (D, R, ...) arrays, or a sharded aggregator
    state), where each device holds its own replica's copy.  The
    ``replication.collective`` faultpoint fires first, before any
    device work (delay: a stalled round; error: an aborted one)."""
    fault.fire("replication.collective")
    R = topo.num_replicas
    fps = mesh.run(topo, fingerprint_tree, state)
    neighbour = mesh.ppermute(topo, fps, [(i, (i + 1) % R) for i in range(R)],
                              REPLICA_AXIS)
    return torch.stack([
        torch.stack([(fps[d][r] != neighbour[d][r]).to(topo.first) for r in range(R)])
        for d in range(topo.num_shards)])


def quorum_ack(topo: MeshTopology, acks, required: int):
    """Consistency accumulation over the replica axis: ``acks`` (num_shards,
    num_replicas) bool or int per-replica success bits of one replicated
    write round -> ((num_shards,) bool quorum met, (num_shards,) int32
    counts) on the mesh's first device.  Same faultpoint as
    :func:`replica_divergence`."""
    fault.fire("replication.collective")
    a = mesh.split(topo, acks, replica_axis=True, dtype=torch.int32)
    got = mesh.psum(topo, a, REPLICA_AXIS)
    counts = torch.stack([row[0].to(topo.first) for row in got])
    return counts >= required, counts
