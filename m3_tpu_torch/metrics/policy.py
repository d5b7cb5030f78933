"""Storage policies: resolution + retention.  The port's copy of
``m3_tpu/metrics/policy.py``.

Reference parity: ``src/metrics/policy/storage_policy.go:49`` (StoragePolicy
struct), ``resolution.go`` / ``retention.go`` (duration-string forms like
``10s:2d`` or ``1m:40d``), ``src/metrics/policy/policy.go`` (policy =
storage policy + aggregation ID), and staged metadata
(``src/metrics/metadata/metadata.go``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Tuple

from m3_tpu_torch.metrics.aggregation import AggregationID

_NANOS = {
    "ns": 1,
    "us": 1_000,
    "ms": 1_000_000,
    "s": 1_000_000_000,
    "m": 60 * 1_000_000_000,
    "h": 3600 * 1_000_000_000,
    "d": 24 * 3600 * 1_000_000_000,
}

_DUR_RE = re.compile(r"(\d+)(ns|us|ms|s|m|h|d)")


def parse_duration(s: str) -> int:
    """Parse a Go-style duration string ('10s', '2d', '1h30m') to nanos."""
    pos = 0
    total = 0
    for m in _DUR_RE.finditer(s):
        if m.start() != pos:
            raise ValueError(f"invalid duration {s!r}")
        total += int(m.group(1)) * _NANOS[m.group(2)]
        pos = m.end()
    if pos != len(s) or pos == 0:
        raise ValueError(f"invalid duration {s!r}")
    return total


def format_duration(nanos: int) -> str:
    """Format nanos compactly, largest unit that divides evenly first."""
    for unit in ("d", "h", "m", "s", "ms", "us", "ns"):
        n = _NANOS[unit]
        if nanos % n == 0 and nanos >= n:
            return f"{nanos // n}{unit}"
    return f"{nanos}ns"


@dataclass(frozen=True, order=True)
class Resolution:
    """Sampling resolution (reference src/metrics/policy/resolution.go).

    window_nanos is the sample window; precision is kept as nanos of the
    truncation unit (the reference stores an xtime.Unit).
    """

    window_nanos: int
    precision_nanos: int = 1_000_000_000

    def __str__(self) -> str:
        return format_duration(self.window_nanos)


@dataclass(frozen=True, order=True)
class StoragePolicy:
    """resolution:retention pair (reference storage_policy.go:49)."""

    resolution: Resolution
    retention_nanos: int

    @classmethod
    def parse(cls, s: str) -> "StoragePolicy":
        """Parse 'resolution:retention' like '10s:2d' or '1m@1s:40d'
        (reference storage_policy.go ParseStoragePolicy)."""
        parts = s.split(":")
        if len(parts) != 2:
            raise ValueError(f"invalid storage policy {s!r}")
        res_part, ret_part = parts
        if "@" in res_part:
            win, prec = res_part.split("@", 1)
            resolution = Resolution(parse_duration(win), parse_duration(prec))
        else:
            win_nanos = parse_duration(res_part)
            resolution = Resolution(win_nanos, _default_precision(win_nanos))
        return cls(resolution, parse_duration(ret_part))

    def __str__(self) -> str:
        return f"{self.resolution}:{format_duration(self.retention_nanos)}"


def _default_precision(window_nanos: int) -> int:
    """Largest standard unit <= window (reference resolution parsing
    infers the precision unit from the window's magnitude)."""
    for unit in ("d", "h", "m", "s", "ms", "us", "ns"):
        if window_nanos >= _NANOS[unit]:
            return _NANOS[unit]
    return 1


@dataclass(frozen=True)
class Policy:
    """StoragePolicy + aggregation set (reference src/metrics/policy/policy.go)."""

    storage_policy: StoragePolicy
    aggregation_id: AggregationID = AggregationID.DEFAULT


DEFAULT_STORAGE_POLICIES: Tuple[StoragePolicy, ...] = (
    StoragePolicy.parse("10s:2d"),
    StoragePolicy.parse("1m:40d"),
)


@dataclass(frozen=True)
class PipelineMetadata:
    """One aggregation-key worth of metadata: aggregation set + storage
    policies + (optional) pipeline ops
    (reference src/metrics/metadata/metadata.go PipelineMetadata)."""

    aggregation_id: AggregationID = AggregationID.DEFAULT
    storage_policies: Tuple[StoragePolicy, ...] = DEFAULT_STORAGE_POLICIES
    pipeline: tuple = ()  # tuple of pipeline ops (metrics.pipeline)
    drop_policy: int = 0  # 0 = none, 1 = drop (reference policy/drop_policy.go)


@dataclass(frozen=True)
class Metadata:
    """Set of pipeline metadatas for one metric
    (reference metadata.go Metadata)."""

    pipelines: Tuple[PipelineMetadata, ...] = (PipelineMetadata(),)


@dataclass(frozen=True)
class StagedMetadata:
    """Metadata staged with a cutover time
    (reference metadata.go StagedMetadata)."""

    metadata: Metadata = Metadata()
    cutover_nanos: int = 0
    tombstoned: bool = False


DEFAULT_STAGED_METADATA = StagedMetadata()
