"""Multi-device aggregator: the ingest -> drain -> rollup step over a
mesh.  The counterpart of ``m3_tpu/parallel/sharded_agg.py``.

* every logical shard's arenas live on that shard's mesh devices, one
  copy for each replica, each allocated there with its own storage;
* an ingest batch arrives routed by shard (the host router, murmur3 %
  num_shards) and each device folds only its own block into its own
  arenas, with the port's functional arena ops on either layout (packed:
  the fused rollup sort and scan, no hand kernel; f64: kernels #3 and #4
  in place);
* the window drain computes each shard's lanes on its devices, then the
  cross-shard rollup (the reference forwards partial aggregates between
  aggregator instances) is a ``psum`` / ``pmin`` / ``pmax`` over the
  shard axis (``parallel/mesh.py``).

Every replica runs the step on its own copy, so replicas stay bit for
bit the same because the step is deterministic, and
``replication.replica_divergence`` can check that they do.

The JAX package donates ``state`` to its step; here the arena ops update
the blocks in place and the step returns the new state, so the caller's
old state is not to be read again.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from m3_tpu_torch.aggregator import arena as _arena
from m3_tpu_torch.aggregator import packed as _packed
from m3_tpu_torch.parallel import mesh
from m3_tpu_torch.parallel.mesh import SHARD_AXIS, Blocks, MeshTopology


class ShardedAggregatorState(NamedTuple):
    """Each field is ``Blocks`` of per-device arena states (f64 layout:
    ``arena.CounterState`` / ``GaugeState`` / ``TimerState``; packed:
    ``packed.Packed*State``)."""

    counters: Blocks
    gauges: Blocks
    timers: Blocks


class ShardedBatch(NamedTuple):
    """One routed ingest batch: leading axis = logical shard (numpy
    arrays or tensors)."""

    windows: object  # int32 (D, N) ring index per sample; out of range drops
    slots: object  # int32 (D, N)
    counter_values: object  # int64 (D, N)
    gauge_values: object  # float64 (D, N)
    timer_values: object  # float64 (D, N)
    times: object  # int64 (D, N)


_BATCH_DTYPES = ShardedBatch(torch.int32, torch.int32, torch.int64, torch.float64,
                             torch.float64, torch.int64)


def sharded_init(topo: MeshTopology, num_windows: int, capacity: int,
                 sample_capacity: int, layout: str | None = None) -> ShardedAggregatorState:
    """Per-device arenas of ``layout`` (None and "auto" = packed; an
    unknown string raises, as ``arena.resolve_layout_arg`` does)."""
    layout = _arena.resolve_layout_arg(layout)
    mod = _packed if layout == "packed" else _arena

    def init(dev):
        return (mod.counter_init(num_windows, capacity, device=dev),
                mod.gauge_init(num_windows, capacity, device=dev),
                mod.timer_init(num_windows, capacity, sample_capacity, device=dev))

    blocks = Blocks(tuple(init(dev) for dev in row) for row in topo.devices)
    return ShardedAggregatorState(*mesh.unzip(blocks))


def _packed_step(st, b, window, num_windows, capacity, quantiles):
    pidx = _packed.packed_flat_index(b.windows, b.slots, num_windows, capacity)
    counters, gauges = _packed.rollup_ingest(st.counters, st.gauges, pidx, b.counter_values,
                                             b.gauge_values, b.times, num_windows, capacity)
    timers = _packed.timer_ingest(st.timers, b.windows, b.slots, b.timer_values, b.times,
                                  capacity)
    # The packed states degrade loudly on the engine path (its consume
    # raises); here the same conditions surface in ``err``: the counter
    # pool's bits, and a fixed-capacity timer buffer that overflowed
    # (which loses moments as well as quantiles on this layout).
    scap = timers.sample.shape[1]
    err = counters.err | torch.where((timers.sample_n > scap).any(),
                                     _packed._ERR_TIMER_OVERFLOW, 0).to(torch.int32)
    c = _packed.counter_consume(counters, window, capacity)
    g = _packed.gauge_consume(gauges, window, capacity)
    t = _packed.timer_consume(timers, window, capacity, quantiles)
    state = ShardedAggregatorState(
        _packed.counter_reset_window(counters, window, num_windows, capacity),
        _packed.gauge_reset_window(gauges, window, capacity),
        _packed.timer_reset_window(timers, window, capacity))
    return state, c, g, t, err


def _f64_step(st, b, window, num_windows, capacity, quantiles, timer_packed32):
    idx = _arena.flat_window_index(b.windows, b.slots, num_windows, capacity)
    counters = _arena.counter_ingest(st.counters, idx, b.slots, b.counter_values, b.times)
    gauges = _arena.gauge_ingest(st.gauges, idx, b.slots, b.gauge_values, b.times)
    timers = _arena.timer_ingest(st.timers, b.windows, b.slots, b.timer_values, b.times,
                                 capacity)
    c = _arena.counter_consume(counters, window, capacity)
    g = _arena.gauge_consume(gauges, window, capacity)
    t = _arena.timer_consume(timers, window, capacity, quantiles, timer_packed32)
    # the drained window's ring row resets for reuse, as the engine's
    # consume pairs every drain with reset_window
    state = ShardedAggregatorState(
        _arena.counter_reset_window(counters, window, capacity),
        _arena.gauge_reset_window(gauges, window, capacity),
        _arena.timer_reset_window(timers, window, capacity))
    err = torch.zeros((), dtype=torch.int32, device=c[0].device)  # no degraded mode
    return state, c, g, t, err


def sharded_ingest_consume(topo: MeshTopology, state: ShardedAggregatorState,
                           batch: ShardedBatch, window, num_windows: int, capacity: int,
                           quantiles: tuple = (0.5, 0.95, 0.99),
                           timer_packed32: bool = False, layout: str | None = None):
    """Ingest a routed batch into every shard's arenas, drain one window
    (then reset its ring row), and roll the drained lanes up across
    shards.  ``window`` is an int or a 0-d tensor (read once on the
    host); ``layout`` as in :func:`sharded_init` and the state's own.

    Returns (new_state, lanes) with lanes a dict, every tensor on the
    mesh's first device (replica 0 of each shard):
      counter/gauge/timer -> ((D, C, L) lanes, (D, C) counts)
      rollup              -> (C, 4) [sum, count, min, max] across shards
                             (``psum`` / ``pmin`` / ``pmax``); min and max
                             are NaN for slots no shard saw a gauge in
      err                 -> (D,) int32 degraded-state bits: nonzero means
                             the packed layout's stats are unreliable
                             (overflow-pool truncation, timer sample
                             overflow).  Nothing raises here: callers
                             check it.
    The caller's ``state`` is updated in place and is not to be read
    again."""
    layout = _arena.resolve_layout_arg(layout)
    want = _packed.PackedCounterState if layout == "packed" else _arena.CounterState
    if not isinstance(state.counters[0][0], want):
        raise ValueError(f"sharded_ingest_consume: layout {layout!r} but the state is "
                         f"{type(state.counters[0][0]).__name__}")
    window = int(window)
    blocks = ShardedBatch(*(mesh.split(topo, a, dtype=dt)
                            for a, dt in zip(batch, _BATCH_DTYPES)))

    def local(st, b):
        if layout == "packed":
            return _packed_step(st, b, window, num_windows, capacity, quantiles)
        return _f64_step(st, b, window, num_windows, capacity, quantiles, timer_packed32)

    new_state, c, g, t, err = mesh.unzip(mesh.run(topo, local, state, blocks))

    # The cross-shard rollup: sum and count by psum, min and max by pmin /
    # pmax over real values, the all-shards-empty NaN sentinel put back.
    part = mesh.run(topo, lambda c, g: (
        torch.nan_to_num(g[0][:, 5]) + c[0][:, 5],
        c[0][:, 4] + g[0][:, 4],
        torch.where(torch.isnan(g[0][:, 1]), float("inf"), g[0][:, 1]),
        torch.where(torch.isnan(g[0][:, 2]), float("-inf"), g[0][:, 2])), c, g)
    p_sum, p_cnt, p_min, p_max = mesh.unzip(part)
    g_sum = mesh.psum(topo, p_sum, SHARD_AXIS)[0][0]
    g_cnt = mesh.psum(topo, p_cnt, SHARD_AXIS)[0][0]
    g_min = mesh.pmin(topo, p_min, SHARD_AXIS)[0][0]
    g_max = mesh.pmax(topo, p_max, SHARD_AXIS)[0][0]
    g_min = torch.where(torch.isposinf(g_min), float("nan"), g_min)
    g_max = torch.where(torch.isneginf(g_max), float("nan"), g_max)

    def lanes_of(blocks):
        lanes, cnt = mesh.unzip(blocks)
        return mesh.stack(topo, lanes), mesh.stack(topo, cnt)

    lanes = {
        "counter": lanes_of(c),
        "gauge": lanes_of(g),
        "timer": lanes_of(t),
        "rollup": torch.stack([g_sum, g_cnt, g_min, g_max], dim=1),
        "err": mesh.stack(topo, err),
    }
    return ShardedAggregatorState(*mesh.unzip(new_state)), lanes
