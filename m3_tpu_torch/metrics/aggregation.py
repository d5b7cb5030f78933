"""Aggregation types and compressed aggregation-type IDs: the port's copy
of ``m3_tpu/metrics/aggregation.py``.

Reference parity: ``src/metrics/aggregation/type.go:34-55`` (enum),
``type.go:201-229`` (quantile mapping), ``src/metrics/aggregation/id.go``
(bitmask-compressed ID: one uint64 holds the whole set since
maxTypeID <= 63).

On device, an aggregation set is exactly this uint64 bitmask; selecting
which aggregate outputs to emit at flush is a mask over a fixed-order
output lane axis, so a flush of mixed aggregation keys is still one
vectorized gather.
"""

from __future__ import annotations

import enum
from typing import Iterable, Tuple

from m3_tpu_torch.metrics.types import MetricType


class AggregationType(enum.IntEnum):
    """Reference src/metrics/aggregation/type.go:34-55."""

    UNKNOWN = 0
    LAST = 1
    MIN = 2
    MAX = 3
    MEAN = 4
    MEDIAN = 5
    COUNT = 6
    SUM = 7
    SUM_SQ = 8
    STDEV = 9
    P10 = 10
    P20 = 11
    P30 = 12
    P40 = 13
    P50 = 14
    P60 = 15
    P70 = 16
    P80 = 17
    P90 = 18
    P95 = 19
    P99 = 20
    P999 = 21
    P9999 = 22

    def is_valid(self) -> bool:
        return AggregationType.LAST <= self <= AggregationType.P9999

    def quantile(self) -> float | None:
        """Quantile for percentile types (reference type.go:201-229)."""
        return _QUANTILES.get(self)

    def is_valid_for(self, mt: MetricType) -> bool:
        """Reference type.go IsValidForGauge/Counter/Timer."""
        if mt is MetricType.COUNTER:
            return self in _COUNTER_VALID
        if mt is MetricType.TIMER:
            return self.is_valid()
        if mt is MetricType.GAUGE:
            return self in _GAUGE_VALID
        return False

    @property
    def suffix(self) -> bytes:
        """Metric-name suffix appended to aggregated output IDs
        (reference src/metrics/aggregation/types_options.go defaults,
        e.g. ``.p99`` / ``.upper`` naming is configurable; we use the
        lower-case type name which matches the default type strings)."""
        return b"." + self.name.lower().encode()


_QUANTILES = {
    AggregationType.P10: 0.1,
    AggregationType.P20: 0.2,
    AggregationType.P30: 0.3,
    AggregationType.P40: 0.4,
    AggregationType.P50: 0.5,
    AggregationType.MEDIAN: 0.5,
    AggregationType.P60: 0.6,
    AggregationType.P70: 0.7,
    AggregationType.P80: 0.8,
    AggregationType.P90: 0.9,
    AggregationType.P95: 0.95,
    AggregationType.P99: 0.99,
    AggregationType.P999: 0.999,
    AggregationType.P9999: 0.9999,
}

_COUNTER_VALID = frozenset(
    {
        AggregationType.MIN,
        AggregationType.MAX,
        AggregationType.MEAN,
        AggregationType.COUNT,
        AggregationType.SUM,
        AggregationType.SUM_SQ,
        AggregationType.STDEV,
    }
)
_GAUGE_VALID = frozenset(
    {
        AggregationType.LAST,
        AggregationType.MIN,
        AggregationType.MAX,
        AggregationType.MEAN,
        AggregationType.COUNT,
        AggregationType.SUM,
        AggregationType.SUM_SQ,
        AggregationType.STDEV,
    }
)

MAX_TYPE_ID = int(AggregationType.P9999)

# Defaults per metric type (reference src/metrics/aggregation/type.go
# DefaultTypesForCounter/Timer/Gauge).
DEFAULT_COUNTER_TYPES: Tuple[AggregationType, ...] = (AggregationType.SUM,)
DEFAULT_TIMER_TYPES: Tuple[AggregationType, ...] = (
    AggregationType.SUM,
    AggregationType.SUM_SQ,
    AggregationType.MEAN,
    AggregationType.MIN,
    AggregationType.MAX,
    AggregationType.COUNT,
    AggregationType.STDEV,
    AggregationType.MEDIAN,
    AggregationType.P50,
    AggregationType.P95,
    AggregationType.P99,
)
DEFAULT_GAUGE_TYPES: Tuple[AggregationType, ...] = (AggregationType.LAST,)


class AggregationID(int):
    """Bitmask-compressed aggregation-type set.

    Reference: ``src/metrics/aggregation/id.go`` — ID is [1]uint64 since
    maxTypeID <= 63; bit i set means type with enum value i is present.
    The default (empty) ID means "use defaults for the metric type".
    """

    DEFAULT: "AggregationID"

    @classmethod
    def compress(cls, types: Iterable[AggregationType]) -> "AggregationID":
        v = 0
        for t in types:
            if not AggregationType(t).is_valid():
                raise ValueError(f"invalid aggregation type {t}")
            v |= 1 << int(t)
        return cls(v)

    def decompress(self) -> Tuple[AggregationType, ...]:
        return tuple(
            AggregationType(i)
            for i in range(1, MAX_TYPE_ID + 1)
            if self & (1 << i)
        )

    def is_default(self) -> bool:
        return int(self) == 0

    def contains(self, t: AggregationType) -> bool:
        return bool(self & (1 << int(t)))

    def merge(self, other: "AggregationID") -> "AggregationID":
        return AggregationID(int(self) | int(other))

    def types_for(self, mt: MetricType) -> Tuple[AggregationType, ...]:
        """Resolve to a concrete type list (defaults when empty)."""
        if not self.is_default():
            return self.decompress()
        if mt is MetricType.COUNTER:
            return DEFAULT_COUNTER_TYPES
        if mt is MetricType.TIMER:
            return DEFAULT_TIMER_TYPES
        return DEFAULT_GAUGE_TYPES


AggregationID.DEFAULT = AggregationID(0)
