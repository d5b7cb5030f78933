"""Time units and UnixNano helpers.

TPU-native port-of-capability for the reference's ``src/x/time`` package
(unit enum: ``src/x/time/unit.go:31-41``; normalized-duration conversion:
``src/x/time/time.go:49-56``).  Wire-format byte values of units must match
the reference exactly because time-unit changes are encoded into M3TSZ
streams as a raw unit byte (``src/dbnode/encoding/m3tsz/timestamp_encoder.go:133``).

The port's copy of ``m3_tpu/core/xtime.py`` (it imports nothing of ``m3_tpu``).
"""

from __future__ import annotations

import enum

NANOS_PER_SECOND = 1_000_000_000


class Unit(enum.IntEnum):
    """Time units; int values are the on-the-wire byte values."""

    NONE = 0
    SECOND = 1
    MILLISECOND = 2
    MICROSECOND = 3
    NANOSECOND = 4
    MINUTE = 5
    HOUR = 6
    DAY = 7
    YEAR = 8

    def is_valid(self) -> bool:
        return self != Unit.NONE

    def nanos(self) -> int:
        """Duration of one unit in nanoseconds (0 for NONE, like the reference)."""
        return _UNIT_NANOS[self]


_UNIT_NANOS = {
    Unit.NONE: 0,
    Unit.SECOND: 1_000_000_000,
    Unit.MILLISECOND: 1_000_000,
    Unit.MICROSECOND: 1_000,
    Unit.NANOSECOND: 1,
    Unit.MINUTE: 60 * 1_000_000_000,
    Unit.HOUR: 3_600 * 1_000_000_000,
    Unit.DAY: 24 * 3_600 * 1_000_000_000,
    Unit.YEAR: 365 * 24 * 3_600 * 1_000_000_000,
}


def unit_from_byte(b: int) -> Unit:
    try:
        return Unit(b)
    except ValueError:
        return Unit.NONE


def to_normalized_duration(d_nanos: int, unit_nanos: int) -> int:
    """Integer division truncating toward zero (Go semantics)."""
    q = abs(d_nanos) // unit_nanos
    return q if d_nanos >= 0 else -q


def from_normalized_duration(nd: int, unit_nanos: int) -> int:
    return nd * unit_nanos


def initial_time_unit(start_nanos: int, unit: Unit) -> Unit:
    """Mirror of ``m3tsz.initialTimeUnit`` (timestamp_encoder.go:248-259)."""
    if not unit.is_valid():
        return Unit.NONE
    tv = unit.nanos()
    if tv == 0:
        return Unit.NONE
    if start_nanos % tv == 0:
        return unit
    return Unit.NONE


def truncate_to(nanos: int, window_nanos: int) -> int:
    """Floor a UnixNano to a window boundary (block starts)."""
    return nanos - (nanos % window_nanos)
