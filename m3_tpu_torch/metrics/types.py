"""Core metric types: the port's copy of ``m3_tpu/metrics/types.py``.

Reference parity: ``src/metrics/metric/types.go:31-45`` defines the metric
type enum (unknown/counter/timer/gauge); unaggregated metric unions live in
``src/metrics/metric/unaggregated/types.go``.  Here the union collapses to a
single dataclass carrying a type tag — on device, batches of metrics are
struct-of-arrays (ids, types, values, timestamps), not arrays of structs.
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


@dataclass
class Metric:
    """A single untimed/timed metric sample.

    Collapses the reference's unaggregated Counter/BatchTimer/Gauge union
    (src/metrics/metric/unaggregated/types.go) — a batch timer carries
    multiple values, counters/gauges exactly one.
    """

    id: bytes
    type: MetricType
    value: float = 0.0
    values: tuple = ()  # batch-timer values
    time_nanos: int = 0
    annotation: bytes = b""

    @property
    def timer_values(self):
        if self.type is MetricType.TIMER:
            return self.values if self.values else (self.value,)
        return ()


@dataclass(frozen=True)
class ChunkedID:
    """ID with a pooled prefix/suffix, used for rollup IDs
    (reference src/metrics/metric/id/types.go)."""

    prefix: bytes
    data: bytes
    suffix: bytes

    def bytes(self) -> bytes:
        return self.prefix + self.data + self.suffix
