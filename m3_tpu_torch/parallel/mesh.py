"""Device-mesh topology for the distribution axes: the counterpart of
``m3_tpu/parallel/mesh.py``.

The reference distributes work along two axes, **virtual shards** (the
murmur3 hash of a series ID, mapped to instances by a placement) and
**replicas** (RF copies of every shard), and maps both onto one
``jax.sharding.Mesh`` driven from a single controller: one process calls
a sharded step and ``shard_map`` runs the per-shard program on every
device.  The port keeps that contract, in one process and without
``torch.distributed``:

* a mesh is a list of ``torch.device``s reshaped to (shards x replicas).
  The list may repeat a device: ``[torch.device("cpu")] * 8`` plays the
  role of the JAX suite's eight virtual CPU devices, ``["cuda:0"] * 8``
  that of eight devices on one card; distinct cards are used where a
  machine has them.  (So ``enable_cpu_core_devices`` has no counterpart:
  a CPU mesh is a repeated device list.)
* a value laid out over the mesh is a ``Blocks``: one block for every
  (shard, replica) device, each with its own storage.  ``split`` cuts a
  (D, ...) tensor into them, ``replicate`` copies one tensor to every
  device, and ``run`` calls a per-shard function once for every mesh
  device, on that device (under ``torch.cuda.device`` for a card), in
  place of ``shard_map``;
* a collective copies the blocks of one group to the group's first
  device, reduces them there left to right in axis order (so the result
  does not depend on the device list: a card and the CPU give the same
  bits), and copies the result back to every device of the group.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch

SHARD_AXIS = "shard"
REPLICA_AXIS = "replica"


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """A (shard x replica) grid of devices: ``devices[d][r]``."""

    devices: tuple

    @property
    def num_shards(self) -> int:
        return len(self.devices)

    @property
    def num_replicas(self) -> int:
        return len(self.devices[0])

    @property
    def first(self) -> torch.device:
        """The mesh's first device, where stacked outputs are gathered."""
        return self.devices[0][0]


def make_mesh(num_shards: int | None = None, num_replicas: int = 1,
              devices=None) -> MeshTopology:
    """Build the (shard, replica) mesh over ``devices`` (None = every
    visible CUDA card; raises without one).  Defaults to all devices on
    the shard axis, RF = 1; the reference's RF = 3 is
    ``num_replicas=3``."""
    if devices is None:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not n_cards:
            raise RuntimeError("no CUDA device: pass devices=['cpu', ...] "
                               "to build a mesh on the CPU")
        devices = [f"cuda:{i}" for i in range(n_cards)]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if num_shards is None:
        if n % num_replicas != 0:
            raise ValueError(f"{n} devices not divisible by RF={num_replicas}")
        num_shards = n // num_replicas
    if num_shards * num_replicas != n:
        raise ValueError(f"mesh {num_shards}x{num_replicas} != {n} devices")
    grid = tuple(tuple(devices[d * num_replicas:(d + 1) * num_replicas])
                 for d in range(num_shards))
    return MeshTopology(grid)


class Blocks(tuple):
    """A value laid out over a mesh: ``blocks[d][r]`` lives on device
    (d, r).  A tuple of D tuples of R blocks."""


def _on_device(dev: torch.device):
    """The context a mesh device's work runs in: ``torch.cuda.device``
    for a card (launches go to the current device), nothing otherwise."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _own_copy(x, dev: torch.device, dtype=None) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x).to(dev, dtype=dtype, copy=True).contiguous()


def split(topo: MeshTopology, x, replica_axis: bool = False, dtype=None) -> Blocks:
    """Blocks of ``x``: block (d, r) is ``x[d]`` (``x[d, r]`` with
    ``replica_axis``) copied to device (d, r) with its own storage, so
    no two blocks alias.  ``x``: a numpy array or a tensor with leading
    (D,) or (D, R) axes."""
    lead = (topo.num_shards, topo.num_replicas) if replica_axis else (topo.num_shards,)
    if tuple(x.shape[:len(lead)]) != lead:
        raise ValueError(f"split: leading axes {tuple(x.shape[:len(lead)])} != mesh {lead}")
    return Blocks(
        tuple(_own_copy(x[d, r] if replica_axis else x[d], dev, dtype)
              for r, dev in enumerate(row))
        for d, row in enumerate(topo.devices))


def replicate(topo: MeshTopology, x, dtype=None) -> Blocks:
    """Blocks holding a copy of ``x`` on every mesh device."""
    return Blocks(tuple(_own_copy(x, dev, dtype) for dev in row) for row in topo.devices)


def take(tree, d: int, r: int):
    """``tree`` with each ``Blocks`` in it replaced by its block (d, r).
    Walks tuples, NamedTuples, lists and dicts; other values pass as
    they are."""
    if isinstance(tree, Blocks):
        return tree[d][r]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(take(v, d, r) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(take(v, d, r) for v in tree)
    if isinstance(tree, dict):
        return {k: take(v, d, r) for k, v in tree.items()}
    return tree


def run(topo: MeshTopology, fn: Callable, *args) -> Blocks:
    """``fn`` once for every (shard, replica) device, on that device,
    with each ``Blocks`` in ``args`` replaced by that device's block:
    the Blocks of its outputs.  Each replica runs on its own copy."""
    out = []
    for d, row in enumerate(topo.devices):
        outs = []
        for r, dev in enumerate(row):
            with _on_device(dev):
                outs.append(fn(*take(args, d, r)))
        out.append(tuple(outs))
    return Blocks(out)


def unzip(blocks: Blocks) -> tuple:
    """Blocks of k-tuples -> k Blocks."""
    k = len(blocks[0][0])
    return tuple(Blocks(tuple(tuple(b[i] for b in row) for row in blocks))
                 for i in range(k))


def stack(topo: MeshTopology, blocks: Blocks) -> torch.Tensor:
    """The (D, ...) tensor of every shard's block (replica 0), gathered
    to the mesh's first device."""
    return torch.stack([row[0].to(topo.first) for row in blocks])


def _groups(topo: MeshTopology, axis: str):
    """The device groups a collective over ``axis`` reduces within, each
    a list of (d, r) in axis order."""
    D, R = topo.num_shards, topo.num_replicas
    if axis == SHARD_AXIS:
        return [[(d, r) for d in range(D)] for r in range(R)]
    if axis == REPLICA_AXIS:
        return [[(d, r) for r in range(R)] for d in range(D)]
    raise ValueError(f"unknown mesh axis {axis!r}: must be {SHARD_AXIS!r} or {REPLICA_AXIS!r}")


def _reduce(topo: MeshTopology, x: Blocks, axis: str, op) -> Blocks:
    out = [[None] * topo.num_replicas for _ in range(topo.num_shards)]
    for group in _groups(topo, axis):
        d0, r0 = group[0]
        dest = topo.devices[d0][r0]
        acc = x[d0][r0].to(dest, copy=True)
        for d, r in group[1:]:  # left to right, in axis order
            acc = op(acc, x[d][r].to(dest))
        for d, r in group:
            out[d][r] = acc.to(topo.devices[d][r], copy=True)
    return Blocks(tuple(row) for row in out)


def psum(topo: MeshTopology, x: Blocks, axis: str = SHARD_AXIS) -> Blocks:
    """``jax.lax.psum`` over ``axis``: every block becomes its group's sum."""
    return _reduce(topo, x, axis, torch.add)


def pmin(topo: MeshTopology, x: Blocks, axis: str = SHARD_AXIS) -> Blocks:
    """``jax.lax.pmin`` over ``axis`` (NaN propagates, as in XLA)."""
    return _reduce(topo, x, axis, torch.minimum)


def pmax(topo: MeshTopology, x: Blocks, axis: str = SHARD_AXIS) -> Blocks:
    """``jax.lax.pmax`` over ``axis`` (NaN propagates, as in XLA)."""
    return _reduce(topo, x, axis, torch.maximum)


def ppermute(topo: MeshTopology, x: Blocks, perm, axis: str = REPLICA_AXIS) -> Blocks:
    """``jax.lax.ppermute`` over ``axis``: ``perm`` lists (source,
    destination) positions along the axis; a block that receives nothing
    becomes zeros, as in JAX."""
    out = [[None] * topo.num_replicas for _ in range(topo.num_shards)]
    for group in _groups(topo, axis):
        for src, dst in perm:
            (ds, rs), (dd, rd) = group[src], group[dst]
            out[dd][rd] = x[ds][rs].to(topo.devices[dd][rd], copy=True)
        for d, r in group:
            if out[d][r] is None:
                out[d][r] = torch.zeros_like(x[d][r])
    return Blocks(tuple(row) for row in out)
