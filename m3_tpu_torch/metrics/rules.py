"""Rules engine: mapping + rollup rules matched against metric tag sets.

Reference parity: `src/metrics/rules` — mapping rules (ID filter →
storage policies + aggregation, rules/mapping.go), rollup rules (filter →
rollup targets carrying a pipeline + policies, rules/rollup.go), and the
active rule set (`rules/active_ruleset.go:120` ForwardMatch →
`mappingsForNonRollupID` :254 + `rollupResultsFor` :301).  Rules are
versioned snapshots with cutover times; a match at time t uses the last
snapshot whose cutover <= t.

The port's copy of ``m3_tpu/metrics/rules.py``.  As in the reference,
``forward_match`` resolves only aggregation and rollup ops while it looks
for a target's leading rollup: a transformation ahead of that rollup is
skipped (kept for parity; ROADMAP Queue C).
"""

from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass, field

from m3_tpu_torch.metrics.aggregation import AggregationID
from m3_tpu_torch.metrics.filters import TagsFilter
from m3_tpu_torch.metrics.pipeline import (
    AggregationOp, AppliedRollupOp, Pipeline, RollupOp, TransformationOp,
)
from m3_tpu_torch.metrics.policy import StoragePolicy


@dataclass(frozen=True)
class MappingRule:
    """Filter → policies (reference rules/mapping.go mappingRuleSnapshot)."""

    name: str
    filter: TagsFilter
    policies: tuple[StoragePolicy, ...]
    aggregation_id: AggregationID = AggregationID.DEFAULT
    drop: bool = False  # drop policy: matched metrics are not stored raw
    cutover_nanos: int = 0
    tombstoned: bool = False


@dataclass(frozen=True)
class RollupTarget:
    """One output of a rollup rule (reference rules/rollup_target.go)."""

    pipeline: Pipeline
    policies: tuple[StoragePolicy, ...]


@dataclass(frozen=True)
class RollupRule:
    name: str
    filter: TagsFilter
    targets: tuple[RollupTarget, ...]
    cutover_nanos: int = 0
    tombstoned: bool = False


@dataclass(frozen=True)
class MappingResult:
    policies: tuple[StoragePolicy, ...]
    aggregation_id: AggregationID
    drop: bool


@dataclass(frozen=True)
class RollupResult:
    """Resolved rollup: the new metric ID plus its pipeline tail
    (reference active_ruleset.go rollupResultsFor + toRollupResults).

    The tail is the APPLIED form (pipeline/applied/type.go): any further
    rollup ops are resolved against the source metric's tags into
    AppliedRollupOp — multi-stage pipelines forward stage-N window
    aggregates to those IDs (forwarded_writer.go:186).  ``stage_tags``
    carries each downstream stage's (id, tags) so callers can index the
    eventual outputs."""

    id: bytes
    tags: dict
    pipeline: Pipeline
    policies: tuple[StoragePolicy, ...]
    aggregation_id: AggregationID
    stage_tags: tuple = ()


@dataclass(frozen=True)
class MatchResult:
    mappings: tuple[MappingResult, ...]
    rollups: tuple[RollupResult, ...]
    drop: bool = False


def rollup_id(new_name: bytes, tags: dict[bytes, bytes],
              keep: tuple[bytes, ...]) -> tuple[bytes, dict]:
    """Generate the rolled-up metric's ID from the kept tags (reference
    rollup ID fns in `src/cmd/services/m3coordinator/downsample` /
    metric ID schemes): name{k1=v1,k2=v2} over the sorted kept tags."""
    kept = {k: tags[k] for k in keep if k in tags}
    kept[b"__name__"] = new_name
    inner = b",".join(k + b"=" + v for k, v in sorted(kept.items())
                      if k != b"__name__")
    return new_name + b"{" + inner + b"}", kept


@dataclass
class RuleSet:
    """Versioned rule set (reference rules/ruleset.go): lists of rule
    snapshots; active_at builds the matcher view for a timestamp."""

    namespace: str = "default"
    version: int = 1
    mapping_rules: list[MappingRule] = field(default_factory=list)
    rollup_rules: list[RollupRule] = field(default_factory=list)

    def active_at(self, t_nanos: int) -> "ActiveRuleSet":
        def latest(rules):
            by_name: dict[str, list] = {}
            for r in rules:
                by_name.setdefault(r.name, []).append(r)
            out = []
            for snaps in by_name.values():
                snaps.sort(key=lambda r: r.cutover_nanos)
                cut = [r.cutover_nanos for r in snaps]
                i = bisect_right(cut, t_nanos) - 1
                if i >= 0 and not snaps[i].tombstoned:
                    out.append(snaps[i])
            return out

        return ActiveRuleSet(
            latest(self.mapping_rules), latest(self.rollup_rules)
        )


@dataclass
class ActiveRuleSet:
    """reference rules/active_ruleset.go activeRuleSet."""

    mapping_rules: list[MappingRule]
    rollup_rules: list[RollupRule]

    def forward_match(self, tags: dict[bytes, bytes]) -> MatchResult:
        """Match one metric's tag set (reference ForwardMatch
        active_ruleset.go:120)."""
        mappings = []
        drop = False
        for r in self.mapping_rules:
            if r.filter.matches(tags):
                if r.drop:
                    drop = True
                    continue
                mappings.append(
                    MappingResult(r.policies, r.aggregation_id, r.drop)
                )
        rollups = []
        for r in self.rollup_rules:
            if not r.filter.matches(tags):
                continue
            for target in r.targets:
                ops = target.pipeline.ops
                # The leading aggregation/rollup op resolves here; the
                # remaining ops execute in the aggregator pipeline
                # (reference applied pipelines).
                agg_id = AggregationID.DEFAULT
                rollup = None
                tail_start = 0
                for j, op in enumerate(ops):
                    if isinstance(op, AggregationOp):
                        agg_id = AggregationID.compress([op.type])
                        tail_start = j + 1
                    elif isinstance(op, RollupOp):
                        rollup = op
                        if op.aggregation_id != AggregationID.DEFAULT:
                            agg_id = op.aggregation_id
                        tail_start = j + 1
                        break
                if rollup is None:
                    continue
                rid, rtags = rollup_id(rollup.new_name, tags, rollup.tags)
                # Apply the tail: downstream RollupOps resolve their
                # output IDs against the SOURCE metric's tags now
                # (reference pipeline/applied — forwarding needs the
                # concrete next-stage ID, not a tag selector).
                tail_ops: list = []
                stage_tags: list = []
                for op in ops[tail_start:]:
                    if isinstance(op, RollupOp):
                        sid2, stags2 = rollup_id(op.new_name, tags, op.tags)
                        tail_ops.append(
                            AppliedRollupOp(sid2, op.aggregation_id))
                        stage_tags.append((sid2, stags2))
                    else:
                        tail_ops.append(op)
                rollups.append(
                    RollupResult(
                        id=rid,
                        tags=rtags,
                        pipeline=Pipeline(tuple(tail_ops)),
                        policies=target.policies,
                        aggregation_id=agg_id,
                        stage_tags=tuple(stage_tags),
                    )
                )
        return MatchResult(tuple(mappings), tuple(rollups), drop)


class Matcher:
    """Caching matcher (reference `src/metrics/matcher`): rule-set watch
    + per-ID match cache invalidated on rule-set version bumps."""

    def __init__(self, ruleset: RuleSet, now_nanos: int = 0):
        self._ruleset = ruleset
        self._now = now_nanos
        self._active = ruleset.active_at(now_nanos)
        self._version = ruleset.version
        self._cache: dict[bytes, MatchResult] = {}

    def update(self, ruleset: RuleSet, now_nanos: int) -> None:
        if ruleset.version != self._version or now_nanos != self._now:
            self._ruleset = ruleset
            self._active = ruleset.active_at(now_nanos)
            self._version = ruleset.version
            self._now = now_nanos
            self._cache.clear()

    def match(self, sid: bytes, tags: dict[bytes, bytes]) -> MatchResult:
        r = self._cache.get(sid)
        if r is None:
            r = self._active.forward_match(tags)
            self._cache[sid] = r
        return r
