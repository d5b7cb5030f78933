"""The port's rules stack (``m3_tpu_torch/metrics/{filters,pipeline,rules,
rules_json}.py``) against ``m3_tpu.metrics``, field by field, exactly.

The rule sets are those of ``tests/test_rules_downsample.py`` (mapping,
drop, cutover and tombstone rules; rollups with transform tails; two
stages), plus globs, negations and a transformation ahead of the first
rollup; each JAX rule set goes to JSON with the JAX ``rules_json`` and
comes back through the port's, which must write the same JSON again.
Over a seeded corpus of tag sets, each match at several times must give
the same mappings, rollup ids, tags, applied tails, ``stage_tags``,
policies, aggregation ids and drop flag, and the caching ``Matcher``
must give the same results before and after a version bump.
"""

import json

import numpy as np
import pytest

import m3_tpu.metrics.filters as jfilt
import m3_tpu.metrics.pipeline as jpipe
import m3_tpu.metrics.rules as jrules
import m3_tpu.metrics.rules_json as jrj
from m3_tpu.metrics.transformation import TransformationType as JTT
import m3_tpu_torch.metrics.filters as tfilt
import m3_tpu_torch.metrics.pipeline as tpipe
import m3_tpu_torch.metrics.rules as trules
import m3_tpu_torch.metrics.rules_json as trj
from tests import test_rules_downsample as ref

CUT = 10**18


def _extra_ruleset():
    """Globs, alternation, negation, ranges, a tombstoned snapshot after a
    live one, several targets, and an INCREASE ahead of the first rollup
    (skipped by forward_match in both packages)."""
    return {
        "namespace": "default", "version": 3,
        "mapping_rules": [
            {"name": "web", "filter": "__name__:cpu.* role:!db dc:{us,eu}-*",
             "policies": ["10s:2d", "1m:40d"], "aggregation": ["MAX", "P99"]},
            {"name": "hosts", "filter": "host:h[0-4]", "policies": ["1m:40d"]},
            {"name": "q", "filter": "host:h?", "policies": ["10s:2d"], "cutover_nanos": 5},
            {"name": "q", "filter": "host:h?", "policies": [], "cutover_nanos": CUT,
             "tombstoned": True},
        ],
        "rollup_rules": [
            {"name": "multi", "filter": "__name__:req.* dc:*", "targets": [
                {"pipeline": [{"aggregation": "SUM"},
                              {"rollup": {"new_name": "req.by_dc", "tags": ["dc", "zz"],
                                          "aggregation": []}},
                              {"transformation": "PER_SECOND"}],
                 "policies": ["10s:2d"]},
                {"pipeline": [{"transformation": "INCREASE"},
                              {"rollup": {"new_name": "req.by_host",
                                          "tags": ["host", "dc"], "aggregation": ["MAX"]}},
                              {"transformation": "ADD"},
                              {"rollup": {"new_name": "req.top", "tags": [],
                                          "aggregation": ["SUM"]}},
                              {"transformation": "RESET"}],
                 "policies": ["1m:40d"]},
                {"pipeline": [{"aggregation": "LAST"}], "policies": ["10s:2d"]},
            ], "cutover_nanos": 0},
        ],
    }


def _rulesets():
    return {
        "mapping": ref._ruleset(),
        "tail": ref._rollup_rule_with_tail(JTT.ABSOLUTE, JTT.ADD, JTT.RESET),
        "two_stage": ref._two_stage_ruleset(),
        "two_stage_mid": ref._two_stage_ruleset(mid_transform=JTT.PER_SECOND),
        "extra": jrj.ruleset_from_json(_extra_ruleset()),
    }


def _corpus(seed=5, n=400):
    rng = np.random.default_rng(seed)
    names = [b"cpu.util", b"cpu.x", b"mem.used", b"debug.heap", b"req.count",
             b"req.latency", b"cpux"]
    dcs = [b"us", b"eu", b"ap", b"us-east", b"eu-west", b"ap-south-1"]
    out = []
    for _ in range(n):
        tags = {b"__name__": names[rng.integers(len(names))]}
        if rng.random() < 0.9:
            tags[b"dc"] = dcs[rng.integers(len(dcs))]
        if rng.random() < 0.8:
            tags[b"host"] = b"h%d" % rng.integers(0, 12)
        if rng.random() < 0.3:
            tags[b"role"] = (b"db", b"web")[rng.integers(2)]
        out.append(tags)
    return out


def _canon_op(op):
    d = {k: getattr(op, k) for k in op.__dataclass_fields__}
    return (type(op).__name__,) + tuple(
        (k, int(v) if isinstance(v, int) else v) for k, v in sorted(d.items()))


def _canon(res):
    return {
        "drop": res.drop,
        "mappings": [(tuple(str(p) for p in m.policies), int(m.aggregation_id), m.drop)
                     for m in res.mappings],
        "rollups": [(r.id, sorted(r.tags.items()), [_canon_op(o) for o in r.pipeline.ops],
                     tuple(str(p) for p in r.policies), int(r.aggregation_id),
                     [(sid, sorted(t.items())) for sid, t in r.stage_tags])
                    for r in res.rollups],
    }


@pytest.mark.parametrize("name", ["mapping", "tail", "two_stage", "two_stage_mid", "extra"])
def test_forward_match_matches_jax(name):
    jrs = _rulesets()[name]
    doc = jrj.ruleset_to_json(jrs)
    trs = trj.ruleset_from_json(json.loads(json.dumps(doc)))
    assert trj.ruleset_to_json(trs) == doc
    hits = 0
    for t in (0, 7, CUT - 1, 2 * CUT):
        ja, ta = jrs.active_at(t), trs.active_at(t)
        assert [r.name for r in ta.mapping_rules] == [r.name for r in ja.mapping_rules]
        assert [r.name for r in ta.rollup_rules] == [r.name for r in ja.rollup_rules]
        for tags in _corpus():
            jc, tc = _canon(ja.forward_match(tags)), _canon(ta.forward_match(tags))
            assert tc == jc, tags
            hits += bool(jc["mappings"] or jc["rollups"] or jc["drop"])
    assert hits > 100


def test_transform_before_first_rollup_is_skipped_in_both():
    """forward_match resolves only aggregation and rollup ops while it
    looks for the leading rollup: the INCREASE ahead of req.by_host is
    dropped by the reference, and by the port for parity."""
    tags = {b"__name__": b"req.count", b"dc": b"us", b"host": b"h1"}
    for rj in (jrj, trj):
        res = rj.ruleset_from_json(_extra_ruleset()).active_at(0).forward_match(tags)
        by_host = [r for r in res.rollups if r.id.startswith(b"req.by_host")]
        assert len(by_host) == 1
        kinds = [type(op).__name__ for op in by_host[0].pipeline.ops]
        assert kinds == ["TransformationOp", "AppliedRollupOp", "TransformationOp"]
        assert by_host[0].pipeline.ops[0].type.name == "ADD"


def test_matcher_cache_and_version_bump_match_jax():
    jrs = jrj.ruleset_from_json(_extra_ruleset())
    trs = trj.ruleset_from_json(_extra_ruleset())
    jm, tm = jrules.Matcher(jrs, 0), trules.Matcher(trs, 0)
    corpus = _corpus(9, 200)
    for k, tags in enumerate(corpus):
        sid = b"id%d" % (k % 50)  # repeated ids hit the per-id cache
        assert _canon(tm.match(sid, tags)) == _canon(jm.match(sid, tags))
    for P, m, rs in ((jrules, jm, jrs), (trules, tm, trs)):
        rs.version += 1
        rs.mapping_rules = rs.mapping_rules[:1]
        m.update(rs, CUT)
    for k, tags in enumerate(corpus):
        sid = b"id%d" % (k % 50)
        assert _canon(tm.match(sid, tags)) == _canon(jm.match(sid, tags))


@pytest.mark.parametrize("spec", ["__name__:cpu.* dc:{us,eu}-* role:!db", "host:h[0-4]",
                                  "a:x?z b:!{p,q}* c:*", "name:[unclosed {also"])
def test_tags_filter_and_globs_match_jax(spec):
    jf, tf = jfilt.TagsFilter.parse(spec), tfilt.TagsFilter.parse(spec)
    assert [(f.name, f.pattern, f.negate) for f in tf.filters] == \
        [(f.name, f.pattern, f.negate) for f in jf.filters]
    for f in tf.filters:
        assert tfilt.glob_to_regex(f.pattern).pattern == jfilt.glob_to_regex(f.pattern).pattern
    rng = np.random.default_rng(1)
    vals = [b"cpu.util", b"us-east", b"eu-1", b"db", b"web", b"h3", b"h7", b"xyz", b"xz",
            b"p1", b"q", b"r", b"[unclosed", b"{also"]
    for _ in range(300):
        tags = {k: vals[rng.integers(len(vals))]
                for k in (b"__name__", b"dc", b"role", b"host", b"a", b"b", b"c", b"name")
                if rng.random() < 0.7}
        assert tf.matches(tags) == jf.matches(tags)


def test_rollup_id_bytes_match_jax():
    rng = np.random.default_rng(2)
    for _ in range(200):
        tags = {b"k%d" % rng.integers(8): b"v%d" % rng.integers(5) for _ in range(5)}
        keep = tuple(b"k%d" % i for i in rng.integers(0, 10, 3))
        assert trules.rollup_id(b"out", tags, keep) == jrules.rollup_id(b"out", tags, keep)


def test_pipeline_ops_keep_the_reference_names():
    for name in ("AggregationOp", "TransformationOp", "RollupOp", "AppliedRollupOp",
                 "Pipeline", "OpType"):
        assert getattr(tpipe, name).__qualname__ == getattr(jpipe, name).__qualname__
    p = tpipe.Pipeline((tpipe.TransformationOp(tpipe.TransformationType.ADD),))
    assert p.skip(1).is_empty() and p.transformation_types() == (
        tpipe.TransformationType.ADD,)
