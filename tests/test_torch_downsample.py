"""m3_tpu_torch.coordinator.downsample over the port's Database against
the JAX package's pair, on the CPU.

Each case builds the same rule set (from one JSON document, through each
package's ``rules_json``), writes the same seeded documents through
``Downsampler.write_batch`` into a JAX and a port ``Database``, flushes,
and ticks past the block: keep masks, written counts and reads of every
output series must be equal (values bit for bit, the f64 and packed
arenas alike), and every file the two databases wrote (commit logs, the
output namespaces' fileset volumes, index segments) must have the same
sha256.  Cases: mapping rules with a drop policy, a rollup under each
transform tail, two forwarding stages with a transform between them, a
single flush across an idle gap, and ``checkpoint_to`` / ``restore_from``
mid-stream (also across packages: a JAX checkpoint restored by the port).
"""

import hashlib
import pathlib
import types

import numpy as np
import pytest

import m3_tpu.coordinator.downsample as jds
import m3_tpu.index.doc as jdoc
import m3_tpu.index.search as jsearch
import m3_tpu.metrics.rules_json as jrj
import m3_tpu.metrics.types as jtypes
import m3_tpu.storage.database as jdb
import m3_tpu_torch.coordinator.downsample as tds
import m3_tpu_torch.index.doc as tdoc
import m3_tpu_torch.index.search as tsearch
import m3_tpu_torch.metrics.rules_json as trj
import m3_tpu_torch.metrics.types as ttypes
import m3_tpu_torch.storage.database as tdb

BLOCK = 2 * 3600 * 10**9
START = (1_700_000_000 * 10**9) // BLOCK * BLOCK
SEC = 10**9
R = 10 * SEC

J = types.SimpleNamespace(ds=jds, doc=jdoc, search=jsearch, rj=jrj, types=jtypes, db=jdb,
                          open=lambda *a, **kw: jdb.Database(*a, **kw),
                          dsopen=lambda *a, **kw: jds.Downsampler(*a, **kw))
T = types.SimpleNamespace(ds=tds, doc=tdoc, search=tsearch, rj=trj, types=ttypes, db=tdb,
                          open=lambda *a, **kw: tdb.Database(*a, device="cpu", **kw),
                          dsopen=lambda *a, **kw: tds.Downsampler(*a, device="cpu", **kw))


def _rollup(name, filt, pipeline, policies=("10s:2d",)):
    return {"name": name, "filter": filt,
            "targets": [{"pipeline": pipeline, "policies": list(policies)}]}





def _rules(*, mapping=(), rollups=()):
    return {"namespace": "default", "version": 1,
            "mapping_rules": list(mapping), "rollup_rules": list(rollups)}


SUM_BY_DC = [{"aggregation": "SUM"},
             {"rollup": {"new_name": "req.by_dc", "tags": ["dc"], "aggregation": []}}]

RULES = {
    "mapping": _rules(mapping=[
        {"name": "cpu-10s", "filter": "__name__:cpu.*", "policies": ["10s:2d"]},
        {"name": "cpu-1m-max", "filter": "__name__:cpu.* dc:{us,eu}",
         "policies": ["1m:40d"], "aggregation": ["MAX", "LAST", "COUNT"]},
        {"name": "dropped", "filter": "__name__:debug.*", "policies": [], "drop": True},
    ]),
    # one rollup per tail chain, each under its own name
    "tails": _rules(rollups=[_rollup(
        "per-dc-" + "-".join(t), "__name__:req.count",
        [{"aggregation": "SUM"},
         {"rollup": {"new_name": "req.by_dc." + ".".join(t).lower(), "tags": ["dc"],
                     "aggregation": []}}] + [{"transformation": x} for x in t])
        for t in (("PER_SECOND",), ("INCREASE",), ("ABSOLUTE", "ADD"), ("RESET",),
                  ("ADD", "RESET"))]),
    "two_stage": _rules(rollups=[_rollup(
        "two-stage", "__name__:req.count",
        [{"aggregation": "SUM"},
         {"rollup": {"new_name": "req.by_host", "tags": ["dc", "host"], "aggregation": []}},
         {"transformation": "PER_SECOND"},
         {"rollup": {"new_name": "req.total", "tags": ["dc"], "aggregation": ["SUM"]}}])]),
    "mixed": _rules(
        mapping=[{"name": "req-raw", "filter": "__name__:req.count", "policies": ["10s:2d"]}],
        rollups=[_rollup("per-dc", "__name__:req.count", SUM_BY_DC + [{"transformation": "ADD"}]),
                 _rollup("two", "__name__:req.count",
                         [{"aggregation": "SUM"},
                          {"rollup": {"new_name": "req.by_host", "tags": ["dc", "host"],
                                      "aggregation": []}},
                          {"rollup": {"new_name": "req.total", "tags": ["dc"],
                                      "aggregation": ["SUM"]}}])]),
}


def _docs(P, n_hosts=6):
    """Counters req.count over three dcs, gauges cpu.util (one dc outside the
    1m rule's filter) and debug.x, in a shuffled order."""
    docs = []
    for h in range(n_hosts):
        dc = (b"us", b"eu", b"ap")[h % 3]
        docs.append(P.doc.Document.from_tags(
            b"req:%s:h%d" % (dc, h),
            {b"__name__": b"req.count", b"dc": dc, b"host": b"h%d" % h}))
        docs.append(P.doc.Document.from_tags(
            b"cpu:h%d" % h, {b"__name__": b"cpu.util", b"dc": dc, b"host": b"h%d" % h}))
    docs.append(P.doc.Document.from_tags(b"debug:x", {b"__name__": b"debug.x"}))
    return docs


def _traffic(seed, n_docs, windows):
    """Per window: one or two samples per doc at seeded offsets, values
    that include decreases (a counter reset), negatives and a NaN."""
    rng = np.random.default_rng(seed)
    out = []
    for w in windows:
        k = int(rng.integers(1, 3))
        idx = np.repeat(np.arange(n_docs), k)
        rng.shuffle(idx)
        ts = START + w * R + rng.integers(0, R, idx.size)
        vals = rng.integers(-5, 40, idx.size).astype(np.float64)
        if w == windows[len(windows) // 2]:
            vals[0] = np.nan
        out.append((idx, ts.astype(np.int64), vals))
    return out


def _db(P, root):
    db = P.open(P.db.DatabaseOptions(root=str(root)),
                {"default": P.db.NamespaceOptions(num_shards=2, slot_capacity=1 << 10,
                                                  sample_capacity=1 << 10)})
    # the output namespaces provisioned small, as a deployment sizes them
    for name in ("10s:2d", "1m:40d"):
        db.ensure_namespace(name, P.db.NamespaceOptions(
            num_shards=2, slot_capacity=1 << 10, sample_capacity=1 << 10))
    return db


def _digests(root) -> dict:
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _bits(pts):
    return [(t, np.float64(v).view(np.uint64).item()) for t, v in pts]


def _run(P, root, rules, *, windows=(0, 1, 2, 3), flushes=(5, 6), ckpt_after=None,
         from_ckpt=None, mt="COUNTER"):
    """Drive one package: write every window, checkpoint after window
    ``ckpt_after`` and go on in a fresh Downsampler restored from it (or,
    with ``from_ckpt``, start from that file and write only the windows
    after ``ckpt_after``), flush, tick past the block.  Returns (keep
    masks, written counts, reads of every output id by namespace, file
    digests)."""
    db = _db(P, root)
    rs = P.rj.ruleset_from_json(rules)
    opts = dict(capacity=1 << 8, timer_sample_capacity=1 << 10)
    ds = P.dsopen(db, rs, opts=P.ds.DownsamplerOptions(**opts))
    if from_ckpt is not None:
        ds.restore_from(from_ckpt)
    docs = _docs(P)
    keeps, written = [], []
    for k, (idx, ts, vals) in enumerate(_traffic(7, len(docs), windows)):
        if from_ckpt is not None and k <= ckpt_after:
            continue
        keeps.append(ds.write_batch([docs[i] for i in idx], ts, vals,
                                    metric_type=P.types.MetricType[mt]).tolist())
        if k == ckpt_after and from_ckpt is None:
            ck = pathlib.Path(str(root) + ".ckpt")
            ds.checkpoint_to(ck)
            ds = P.dsopen(db, rs, opts=P.ds.DownsamplerOptions(**opts))
            ds.restore_from(ck)
    for w in flushes:
        written.append(ds.flush(START + w * R))
    db.tick(START + BLOCK + 11 * 60 * SEC)
    reads = {}
    for name in sorted(db.namespaces):
        if name == "default":
            continue
        ids = sorted(d.id for d in db.query_ids(name, P.search.All(), START,
                                                START + 2 * BLOCK))
        reads[name] = {sid: _bits(db.read(name, sid, START, START + 2 * BLOCK))
                       for sid in ids}
    db.close()
    return keeps, written, reads, _digests(root)


def _both(tmp_path, rules, **kw):
    return _run(J, tmp_path / "jax", rules, **kw), _run(T, tmp_path / "port", rules, **kw)


def _same(j, t):
    jk, jw, jr, jd = j
    tk, tw, tr, td = t
    assert tk == jk
    assert tw == jw
    assert tr == jr
    assert any(reads for reads in jr.values())
    assert td == jd
    assert any("fileset" in k for k in jd)


@pytest.mark.parametrize("case", sorted(RULES))
def test_downsampler_matches_jax(case, tmp_path):
    j, t = _both(tmp_path, RULES[case])
    _same(j, t)


def test_gauges_through_mapping_and_tails_match_jax(tmp_path):
    rules = _rules(mapping=RULES["mapping"]["mapping_rules"],
                   rollups=RULES["tails"]["rollup_rules"][:1])
    j, t = _both(tmp_path, rules, mt="GAUGE")
    _same(j, t)


def test_idle_gap_single_flush_matches_jax(tmp_path):
    """One flush forty windows on: the settle loop surfaces stage 2."""
    j, t = _both(tmp_path, RULES["two_stage"], windows=(0, 1), flushes=(40,))
    _same(j, t)


@pytest.mark.parametrize("case", ["two_stage", "tails", "mixed"])
def test_checkpoint_restore_mid_stream_matches_jax(case, tmp_path):
    """Each package checkpoints after window 1 and goes on in a restored
    Downsampler; both must equal the other package's run, and the
    uninterrupted run."""
    j, t = _both(tmp_path, RULES[case], ckpt_after=1)
    _same(j, t)
    (tmp_path / "u").mkdir()
    _same(_run(J, tmp_path / "u" / "jax", RULES[case]), t)


@pytest.mark.parametrize("case", ["two_stage", "mixed"])
def test_jax_checkpoint_restored_by_port(case, tmp_path):
    """The JAX package checkpoints after window 1; a fresh port Database
    and Downsampler restore that file and take the remaining windows: the
    outputs and every file equal the JAX run's (keep masks compared over
    the windows both wrote)."""
    j = _run(J, tmp_path / "jax", RULES[case], ckpt_after=1)
    t = _run(T, tmp_path / "port", RULES[case], ckpt_after=1,
             from_ckpt=str(tmp_path / "jax") + ".ckpt")
    _same((j[0][2:],) + j[1:], t)


def test_downsampler_needs_a_device_or_cpu(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db = T.open(T.db.DatabaseOptions(root=str(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tds.Downsampler(db, trj.ruleset_from_json(RULES["mapping"]))
    db.close()


def test_ensure_namespace_matches_jax(tmp_path):
    """Create-if-missing: an existing namespace comes back unchanged; a new
    one takes the given options (or the defaults), the database's device,
    its new-series limiter and its corruption hook."""
    got = {}
    for tag, P in (("jax", J), ("port", T)):
        db = P.open(P.db.DatabaseOptions(root=str(tmp_path / tag)))
        first = db.namespaces["default"]
        assert db.ensure_namespace("default", P.db.NamespaceOptions(num_shards=9)) is first
        ns = db.ensure_namespace("agg", P.db.NamespaceOptions(num_shards=3))
        assert db.ensure_namespace("agg") is ns
        dflt = db.ensure_namespace("dflt")
        got[tag] = (sorted(db.namespaces), ns.opts.num_shards, dflt.opts.num_shards,
                    len(ns.shards))
        shard = ns.shards[0]
        assert shard._corruption_cb == db._note_corruption
        if tag == "port":
            assert ns.device == db.device
            assert shard.slots.limiter is db.new_series_limiter
        db.close()
    assert got["port"] == got["jax"]
