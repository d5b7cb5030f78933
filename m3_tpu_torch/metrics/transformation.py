"""Transformations applied inside rollup pipelines: the port's copy of
``m3_tpu/metrics/transformation.py``.

Reference parity: ``src/metrics/transformation/type.go:39-49`` (enum:
Absolute/PerSecond/Increase/Add/Reset), ``unary.go`` (absolute, add),
``binary.go`` (perSecond, increase), ``unary_multi.go`` (reset: emits the
datapoint plus a zero half a resolution later).

Two forms of every transform:

* scalar — Datapoint -> Datapoint, faithful to the reference; the
  aggregator's consume applies the same semantics row by row
  (``aggregator/engine.py _apply_tails``);
* batched — tensors of shape (..., T) of values + timestamps, with a
  carried ``prev`` lane for binary transforms.  NaN marks "empty
  datapoint" exactly as the reference uses an empty datapoint sentinel.
  In the JAX package these are plain ``jnp`` expressions (no Pallas), so
  their faithful form here is plain torch on the tensors' own device.
  ``batched_add``'s running sum is ``torch.cumsum`` against the
  reference's ``jnp.cumsum`` (an XLA blocked scan): the two agree within
  the prefix-sum bound the query path states, not bit for bit.
"""

from __future__ import annotations

import enum
import math
from typing import Callable, Tuple

import torch

from m3_tpu_torch.metrics.types import EMPTY_DATAPOINT, Datapoint

_NANOS_PER_SECOND = 1_000_000_000


class TransformationType(enum.IntEnum):
    """Reference src/metrics/transformation/type.go:39-49."""

    UNKNOWN = 0
    ABSOLUTE = 1
    PER_SECOND = 2
    INCREASE = 3
    ADD = 4
    RESET = 5

    def is_unary(self) -> bool:
        return self in (TransformationType.ABSOLUTE, TransformationType.ADD)

    def is_binary(self) -> bool:
        return self in (TransformationType.PER_SECOND, TransformationType.INCREASE)

    def is_unary_multi(self) -> bool:
        return self is TransformationType.RESET


# ---------------------------------------------------------------------------
# Scalar forms.
# ---------------------------------------------------------------------------

def absolute(dp: Datapoint) -> Datapoint:
    """Reference unary.go:35-40."""
    return Datapoint(dp.time_nanos, abs(dp.value))


def make_add() -> Callable[[Datapoint], Datapoint]:
    """Stateful running sum; NaN treated as zero (reference unary.go:42-54)."""
    state = {"curr": 0.0}

    def add(dp: Datapoint) -> Datapoint:
        if not math.isnan(dp.value):
            state["curr"] += dp.value
        return Datapoint(dp.time_nanos, state["curr"])

    return add


def per_second(prev: Datapoint, curr: Datapoint) -> Datapoint:
    """Reference binary.go perSecond: skips NaN, requires increasing time
    and non-decreasing value, rate per second."""
    if (
        prev.time_nanos >= curr.time_nanos
        or math.isnan(prev.value)
        or math.isnan(curr.value)
    ):
        return EMPTY_DATAPOINT
    diff = curr.value - prev.value
    if diff < 0:
        return EMPTY_DATAPOINT
    rate = diff * _NANOS_PER_SECOND / (curr.time_nanos - prev.time_nanos)
    return Datapoint(curr.time_nanos, rate)


def increase(prev: Datapoint, curr: Datapoint) -> Datapoint:
    """Reference binary.go increase: NaN prev treated as 0."""
    if prev.time_nanos >= curr.time_nanos:
        return EMPTY_DATAPOINT
    if math.isnan(curr.value):
        return EMPTY_DATAPOINT
    prev_value = 0.0 if math.isnan(prev.value) else prev.value
    diff = curr.value - prev_value
    if diff < 0:
        return EMPTY_DATAPOINT
    return Datapoint(curr.time_nanos, diff)


def reset(dp: Datapoint,
          resolution_nanos: int = _NANOS_PER_SECOND) -> Tuple[Datapoint, Datapoint]:
    """Reference unary_multi.go transformReset: the datapoint unchanged
    plus a zero datapoint half a resolution period later (min 1ns)."""
    gap = max(resolution_nanos // 2, 1)
    return dp, Datapoint(dp.time_nanos + gap, 0.0)


# ---------------------------------------------------------------------------
# Batched forms.  values/times shaped (..., T); prev_* shaped (...).
# out[t] = f(prev_chain[t], curr[t]) where prev_chain is the shifted series
# seeded with the carried prev lane: both binary transforms look one step
# back, so no scan is needed.
# ---------------------------------------------------------------------------

def batched_absolute(values: torch.Tensor) -> torch.Tensor:
    return torch.abs(values)


def batched_add(values: torch.Tensor,
                prev_sum: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running sum along the trailing axis seeded with prev_sum."""
    contrib = torch.where(torch.isnan(values), torch.zeros_like(values), values)
    out = torch.cumsum(contrib, dim=-1) + prev_sum[..., None]
    return out, out[..., -1]


def _shift_with_prev(arr: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    return torch.cat([prev[..., None].to(arr.dtype), arr[..., :-1]], dim=-1)


def batched_per_second(values: torch.Tensor, times: torch.Tensor,
                       prev_value: torch.Tensor,
                       prev_time: torch.Tensor) -> torch.Tensor:
    prev_v = _shift_with_prev(values, prev_value)
    prev_t = _shift_with_prev(times, prev_time)
    diff = values - prev_v
    dt = times - prev_t
    bad = (dt <= 0) | torch.isnan(prev_v) | torch.isnan(values) | (diff < 0)
    # the reference's float(1e9) times the diff, over the int64 dt
    # promoted to the values' float type
    rate = diff * float(_NANOS_PER_SECOND) / torch.where(
        dt == 0, torch.ones_like(dt), dt).to(values.dtype)
    return torch.where(bad, torch.full_like(rate, math.nan), rate)


def batched_increase(values: torch.Tensor, times: torch.Tensor,
                     prev_value: torch.Tensor,
                     prev_time: torch.Tensor) -> torch.Tensor:
    prev_v = _shift_with_prev(values, prev_value)
    prev_t = _shift_with_prev(times, prev_time)
    prev_v = torch.where(torch.isnan(prev_v), torch.zeros_like(prev_v), prev_v)
    diff = values - prev_v
    bad = (times - prev_t <= 0) | torch.isnan(values) | (diff < 0)
    return torch.where(bad, torch.full_like(diff, math.nan), diff)
