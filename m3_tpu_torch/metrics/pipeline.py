"""Pipeline AST: aggregate -> transform -> rollup op sequences.

Reference parity: ``src/metrics/pipeline/type.go`` (OpUnion of
AggregationOp/TransformationOp/RollupOp, Pipeline), and the applied form
(``src/metrics/pipeline/applied/type.go``) where rollup ops carry the
resolved output metric ID.

The port's copy of ``m3_tpu/metrics/pipeline.py``, with the same
class names, so a pickled pipeline op of either package maps onto the
other's (``aggregator/checkpoint.py``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Tuple

from m3_tpu_torch.metrics.aggregation import AggregationID, AggregationType
from m3_tpu_torch.metrics.transformation import TransformationType


class OpType(enum.IntEnum):
    UNKNOWN = 0
    AGGREGATION = 1
    TRANSFORMATION = 2
    ROLLUP = 3


@dataclass(frozen=True)
class AggregationOp:
    """Reference pipeline/type.go AggregationOp."""

    type: AggregationType


@dataclass(frozen=True)
class TransformationOp:
    """Reference pipeline/type.go TransformationOp."""

    type: TransformationType


@dataclass(frozen=True)
class RollupOp:
    """Rollup to a new metric ID over selected tags
    (reference pipeline/type.go RollupOp)."""

    new_name: bytes
    tags: Tuple[bytes, ...] = ()
    aggregation_id: AggregationID = AggregationID.DEFAULT


@dataclass(frozen=True)
class AppliedRollupOp:
    """Rollup with resolved output ID (reference pipeline/applied/type.go)."""

    id: bytes
    aggregation_id: AggregationID = AggregationID.DEFAULT


Op = AggregationOp | TransformationOp | RollupOp | AppliedRollupOp


@dataclass(frozen=True)
class Pipeline:
    """Sequence of ops (reference pipeline/type.go Pipeline)."""

    ops: Tuple[Op, ...] = ()

    def is_empty(self) -> bool:
        return not self.ops

    def at(self, i: int) -> Op:
        return self.ops[i]

    def skip(self, n: int) -> "Pipeline":
        return Pipeline(self.ops[n:])

    def transformation_types(self) -> Tuple[TransformationType, ...]:
        return tuple(
            op.type for op in self.ops if isinstance(op, TransformationOp)
        )
