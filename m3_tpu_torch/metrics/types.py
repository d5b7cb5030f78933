"""Core metric types: the port's copy of ``m3_tpu/metrics/types.py``
(``MetricType``, ``Datapoint``,
``EMPTY_DATAPOINT``).

Reference parity: ``src/metrics/metric/types.go:31-45`` defines the metric
type enum (unknown/counter/timer/gauge).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class MetricType(enum.IntEnum):
    """Metric type enum (reference src/metrics/metric/types.go:31-45)."""

    UNKNOWN = 0
    COUNTER = 1
    TIMER = 2
    GAUGE = 3


@dataclass(frozen=True)
class Datapoint:
    """A (timestamp, value) pair (reference src/metrics/transformation/types.go)."""

    time_nanos: int
    value: float


EMPTY_DATAPOINT = Datapoint(0, float("nan"))
