"""Transformation types of rollup pipelines: the port's copy of the
``TransformationType`` enum of ``m3_tpu/metrics/transformation.py``.

Reference parity: ``src/metrics/transformation/type.go:39-49``.  The
scalar and batched transforms themselves are not ported yet: the port's
aggregator rejects pipeline tails (``aggregator/engine.py``).
"""

from __future__ import annotations

import enum


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
