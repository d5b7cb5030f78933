"""RuleSet ↔ JSON: the wire/storage form of rules.

Equivalent of the reference's rule views/serialization
(`src/metrics/rules/view` + the proto forms under
`src/metrics/generated/proto/rulepb` that r2 stores in KV): a stable
document format for rule management APIs, carrying filter spec strings,
policies as "resolution:retention" strings, aggregation type names, and
rollup pipelines as op lists.

The port's copy of ``m3_tpu/metrics/rules_json.py``.
"""

from __future__ import annotations

from m3_tpu_torch.metrics.aggregation import AggregationID, AggregationType
from m3_tpu_torch.metrics.filters import TagFilter, TagsFilter
from m3_tpu_torch.metrics.pipeline import (
    AggregationOp, Pipeline, RollupOp, TransformationOp,
)
from m3_tpu_torch.metrics.rules import (
    MappingRule, RollupRule, RollupTarget, RuleSet,
)
from m3_tpu_torch.metrics.policy import StoragePolicy
from m3_tpu_torch.metrics.transformation import TransformationType


def filter_to_spec(f: TagsFilter) -> str:
    parts = []
    for tf in f.filters:
        neg = "!" if tf.negate else ""
        parts.append(f"{tf.name.decode()}:{neg}{tf.pattern.decode()}")
    return " ".join(parts)


def _agg_id_to_json(aid: AggregationID) -> list[str]:
    return [t.name for t in aid.decompress()]


def _agg_id_from_json(names: list[str]) -> AggregationID:
    if not names:
        return AggregationID.DEFAULT
    return AggregationID.compress([AggregationType[n] for n in names])


def _op_to_json(op) -> dict:
    if isinstance(op, AggregationOp):
        return {"aggregation": op.type.name}
    if isinstance(op, TransformationOp):
        return {"transformation": op.type.name}
    if isinstance(op, RollupOp):
        return {
            "rollup": {
                "new_name": op.new_name.decode(),
                "tags": [t.decode() for t in op.tags],
                "aggregation": _agg_id_to_json(op.aggregation_id),
            }
        }
    raise ValueError(f"unsupported pipeline op {op!r}")


def _op_from_json(d: dict):
    if "aggregation" in d and isinstance(d["aggregation"], str):
        return AggregationOp(AggregationType[d["aggregation"]])
    if "transformation" in d:
        return TransformationOp(TransformationType[d["transformation"]])
    if "rollup" in d:
        r = d["rollup"]
        return RollupOp(
            r["new_name"].encode(),
            tuple(t.encode() for t in r.get("tags", [])),
            _agg_id_from_json(r.get("aggregation", [])),
        )
    raise ValueError(f"unsupported pipeline op json {d!r}")


def mapping_rule_to_json(r: MappingRule) -> dict:
    return {
        "name": r.name,
        "filter": filter_to_spec(r.filter),
        "policies": [str(p) for p in r.policies],
        "aggregation": _agg_id_to_json(r.aggregation_id),
        "drop": r.drop,
        "cutover_nanos": r.cutover_nanos,
        "tombstoned": r.tombstoned,
    }


def mapping_rule_from_json(d: dict) -> MappingRule:
    return MappingRule(
        name=d["name"],
        filter=TagsFilter.parse(d["filter"]),
        policies=tuple(StoragePolicy.parse(p) for p in d.get("policies", [])),
        aggregation_id=_agg_id_from_json(d.get("aggregation", [])),
        drop=d.get("drop", False),
        cutover_nanos=d.get("cutover_nanos", 0),
        tombstoned=d.get("tombstoned", False),
    )


def rollup_rule_to_json(r: RollupRule) -> dict:
    return {
        "name": r.name,
        "filter": filter_to_spec(r.filter),
        "targets": [
            {
                "pipeline": [_op_to_json(op) for op in t.pipeline.ops],
                "policies": [str(p) for p in t.policies],
            }
            for t in r.targets
        ],
        "cutover_nanos": r.cutover_nanos,
        "tombstoned": r.tombstoned,
    }


def rollup_rule_from_json(d: dict) -> RollupRule:
    return RollupRule(
        name=d["name"],
        filter=TagsFilter.parse(d["filter"]),
        targets=tuple(
            RollupTarget(
                pipeline=Pipeline(tuple(_op_from_json(o) for o in t["pipeline"])),
                policies=tuple(
                    StoragePolicy.parse(p) for p in t.get("policies", [])
                ),
            )
            for t in d.get("targets", [])
        ),
        cutover_nanos=d.get("cutover_nanos", 0),
        tombstoned=d.get("tombstoned", False),
    )


def ruleset_to_json(rs: RuleSet) -> dict:
    return {
        "namespace": rs.namespace,
        "version": rs.version,
        "mapping_rules": [mapping_rule_to_json(r) for r in rs.mapping_rules],
        "rollup_rules": [rollup_rule_to_json(r) for r in rs.rollup_rules],
    }


def ruleset_from_json(d: dict) -> RuleSet:
    return RuleSet(
        namespace=d.get("namespace", "default"),
        version=d.get("version", 1),
        mapping_rules=[
            mapping_rule_from_json(r) for r in d.get("mapping_rules", [])
        ],
        rollup_rules=[
            rollup_rule_from_json(r) for r in d.get("rollup_rules", [])
        ],
    )
