"""m3_tpu_torch.storage.database and query.storage_adapter against the
JAX package's on the CPU.

One write sequence goes into a JAX ``Database`` and a port
``Database(device="cpu")``, each under its own root: tagged and untagged
writes, last-write-wins duplicates, writes too late and too far ahead,
a new-series limit (a shared token bucket on a frozen clock, so both
runs admit the same creations), an ownership change, a cold write into
a flushed block.  After each step the write results, ``read`` and
``read_batch`` must be equal, and every file the two nodes wrote
(fileset volumes 0 and 1, commit logs, index segments, snapshots) must
have the same sha256.  Then a "crash" (a new ``Database`` on the same
root and ``bootstrap()``), and a snapshot + bootstrap, with equal reads
and equal files again.  PromQL over ``DatabaseStorage`` answers within
config #5's ``rtol`` 1e-12 of the JAX engine's, before and after the
flush.  The cases of ``tests/test_storage.py`` and the database cases of
``tests/test_corruption.py`` run through both packages.
"""

import hashlib
import pathlib
import types

import numpy as np
import pytest
import torch

import m3_tpu.index.doc as jdoc
import m3_tpu.index.search as jsearch
import m3_tpu.persist.fs as jfs
import m3_tpu.persist.quarantine as jquar
import m3_tpu.persist.snapshot as jsnap
import m3_tpu.query.engine as jengine
import m3_tpu.query.storage_adapter as jadapter
import m3_tpu.storage.database as jdb
import m3_tpu.storage.limits as jlimits
import m3_tpu_torch.index.doc as tdoc
import m3_tpu_torch.index.search as tsearch
import m3_tpu_torch.persist.fs as tfs
import m3_tpu_torch.persist.quarantine as tquar
import m3_tpu_torch.persist.snapshot as tsnap
import m3_tpu_torch.query.engine as tengine
import m3_tpu_torch.query.storage_adapter as tadapter
import m3_tpu_torch.storage.database as tdb
import m3_tpu_torch.storage.limits as tlimits

BLOCK = 2 * 3600 * 10**9
START = (1_700_000_000 * 10**9) // BLOCK * BLOCK
SEC = 10**9
MIN = 60 * SEC

J = types.SimpleNamespace(
    db=jdb, doc=jdoc, search=jsearch, fs=jfs, quar=jquar, snap=jsnap,
    limits=jlimits, adapter=jadapter,
    engine=lambda storage: jengine.Engine(storage),
    open=lambda *a, **kw: jdb.Database(*a, **kw))
T = types.SimpleNamespace(
    db=tdb, doc=tdoc, search=tsearch, fs=tfs, quar=tquar, snap=tsnap,
    limits=tlimits, adapter=tadapter,
    engine=lambda storage: tengine.Engine(storage, device="cpu"),
    open=lambda *a, **kw: tdb.Database(*a, device="cpu", **kw))
PKGS = {"jax": J, "port": T}


def _ns_opts(P, **kw):
    d = dict(block_size_nanos=BLOCK, retention_nanos=48 * 3600 * 10**9,
             buffer_past_nanos=10 * MIN, buffer_future_nanos=2 * MIN,
             num_shards=2, slot_capacity=1 << 10, sample_capacity=1 << 6)
    d.update(kw)
    return P.db.NamespaceOptions(**d)


def _mkdb(P, root, limiter=None, **ns_kw):
    return P.open(P.db.DatabaseOptions(root=str(root)),
                  {"default": _ns_opts(P, **ns_kw)}, new_series_limiter=limiter)


def _digests(root) -> dict:
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and p.parts[len(root.parts)] != "quarantine"}


def _wres(r):
    acc = None if r.accepted is None else np.asarray(r.accepted).tolist()
    return (int(r), r.rejected, getattr(r, "not_owned", 0), acc)


def _bits(pts):
    return [(t, np.float64(v).view(np.uint64).item()) for t, v in pts]


# -- the write sequence -----------------------------------------------------

UNTAGGED = [f"host{i:03d}.cpu.util".encode() for i in range(40)]
LES = (b"0.1", b"0.5", b"1", b"+Inf")


def _tagged_docs(P):
    docs = []
    for g in range(3):
        base = {b"job": b"api", b"instance": b"i%d" % g}
        docs.append(P.doc.Document.from_tags(b"reqs{i%d}" % g,
                                             {**base, b"__name__": b"reqs"}))
        for le in LES:
            docs.append(P.doc.Document.from_tags(
                b"lat_bucket{i%d,le=%s}" % (g, le),
                {**base, b"__name__": b"lat_bucket", b"le": le}))
    return docs


def _untagged_batch(rng):
    """30 scrapes of 40 gauges over the first 5 minutes, shuffled, with
    10 % of the points written twice (the second value wins)."""
    ids, ts, vals = [], [], []
    for j in range(30):
        for sid in UNTAGGED:
            ids.append(sid)
            ts.append(START + j * 10 * SEC + 7 * SEC)
            vals.append(round(float(rng.normal(50, 5)), 2))
    dup = rng.choice(len(ids), len(ids) // 10, replace=False)
    ids += [ids[i] for i in dup]
    ts += [ts[i] for i in dup]
    vals += [round(float(rng.normal(80, 5)), 2) for _ in dup]
    order = rng.permutation(len(ids))
    return ([ids[i] for i in order], np.asarray(ts, np.int64)[order],
            np.asarray(vals)[order])


def _tagged_scrapes(rng, n_docs, n=60):
    """Cumulative counters every 15 s from minute 1."""
    incs = rng.gamma(2.0, 3.0, (n, n_docs)).round(0)
    incs[:, 1::5] *= 0.3  # lower buckets fill slower
    cum = np.cumsum(incs, axis=0)
    return [(START + MIN + k * 15 * SEC, cum[k]) for k in range(n)]


class Sequence:
    """The write sequence, one step at a time, against one package."""

    def __init__(self, P, root):
        self.P = P
        self.root = root
        self.limiter = P.limits.NewSeriesLimiter(60, now=lambda: 0.0)
        self.db = _mkdb(P, root, self.limiter)
        self.docs = _tagged_docs(P)
        self.out = []

    def reads(self, tag, ids=None, start=START - BLOCK, end=START + 2 * BLOCK):
        ids = ids or (UNTAGGED + [d.id for d in self.docs] + [b"new-%02d" % i for i in range(10)])
        self.out.append((tag, "read_batch", [_bits(p) for p in
                                             self.db.read_batch("default", ids, start, end)]))
        self.out.append((tag, "read", [_bits(self.db.read("default", sid, start, end))
                                       for sid in ids[::7]]))

    def query(self, tag):
        eng = self.P.engine(self.P.adapter.DatabaseStorage(self.db))
        qs, qe = START + 6 * MIN, START + 16 * MIN
        for q in ("sum(rate(reqs[5m]))", "histogram_quantile(0.9, rate(lat_bucket[5m]))",
                  "rate(lat_bucket{instance=~\"i[01]\", le!=\"+Inf\"}[2m])"):
            b = eng.execute_range(q, qs, qe, 30 * SEC)
            self.out.append(("q_" + tag, q, ([m.tags for m in b.series],
                                              np.asarray(b.values))))

    def step_writes(self, seed):
        rng = np.random.default_rng(seed)
        ids, ts, vals = _untagged_batch(rng)
        self.out.append(("untagged", _wres(self.db.write_batch("default", ids, ts, vals))))
        for t, cum in _tagged_scrapes(rng, len(self.docs)):
            r = self.db.write_tagged_batch("default", self.docs, np.full(len(self.docs), t),
                                           cum)
            self.out.append(("tagged", _wres(r)))
        now = START + 16 * MIN
        # the new-series limit: 60 creations allowed, 55 made so far
        new = [b"new-%02d" % i for i in range(10)]
        r = self.db.write_batch("default", new, np.full(10, now - SEC),
                                np.arange(10.0), now_nanos=now)
        self.out.append(("limited", _wres(r), self.db.namespaces["default"].new_series_rejected))
        # too late (the block before), inside the open block, and too far
        # ahead (a block beyond bufferFuture)
        late = np.asarray([START - 30 * MIN, now + 3 * MIN, now + BLOCK + MIN], np.int64)
        r = self.db.write_batch("default", UNTAGGED[:3], late, np.asarray([1.5, 2.5, 3.5]),
                                now_nanos=now)
        self.out.append(("late_future", _wres(r)))
        self.reads("buffered")

    def step_ownership(self):
        db = self.db
        owned = {0}
        db.set_shard_ownership("default", owned)
        shards = [self.P.db.shard_for_id(s, 2) for s in UNTAGGED]
        mixed = UNTAGGED[:8]
        r = db.write_batch("default", mixed, np.full(8, START + 15 * MIN),
                           np.arange(8.0), now_nanos=START + 16 * MIN)
        self.out.append(("ownership_mixed", _wres(r)))
        unowned = [s for s, sh in zip(UNTAGGED, shards) if sh not in owned][:3]
        try:
            db.write_batch("default", unowned, np.full(3, START + 15 * MIN), np.ones(3))
            self.out.append(("ownership_all_unowned", "accepted"))
        except self.P.db.ShardNotOwnedError as e:
            self.out.append(("ownership_all_unowned", e.shard))
        try:
            db.read("default", unowned[0], START, START + BLOCK)
        except self.P.db.ShardNotOwnedError as e:
            self.out.append(("ownership_read", e.shard))
        self.out.append(("owned", sorted(db.owned_shards("default"))))
        db.set_shard_ownership(None, None)

    def step_flush(self):
        db = self.db
        now = START + BLOCK + 11 * MIN
        self.out.append(("tick1", db.tick(now)))
        self.reads("flushed")
        # a cold write into the flushed block: volume 1 on the next tick
        r = db.write_batch("default", UNTAGGED[:5] + [self.docs[0].id],
                           np.full(6, START + 20 * SEC), np.full(6, 99.25), now_nanos=now)
        self.out.append(("cold", _wres(r)))
        self.reads("cold_buffered")
        self.out.append(("tick2", db.tick(now + SEC)))
        self.reads("cold_flushed")

    def step_open_block(self):
        """Points in the next block, left in the buffer for the snapshot."""
        rng = np.random.default_rng(5)
        t = START + BLOCK + 12 * MIN
        r = self.db.write_batch("default", UNTAGGED[::2], np.full(20, t),
                                np.round(rng.normal(size=20), 3), now_nanos=t)
        self.out.append(("next_block", _wres(r)))

    def reopen(self, tag):
        self.db.close()
        self.db = _mkdb(self.P, self.root, self.limiter)
        self.out.append((tag, "before", self.db.read("default", UNTAGGED[0], START, START + BLOCK)))
        self.out.append((tag, self.db.bootstrap()))
        self.reads(tag)


def _run_both(tmp_path, steps):
    seqs = {name: Sequence(P, tmp_path / name) for name, P in PKGS.items()}
    for name, s in seqs.items():
        for step in steps:
            step(s)
        s.db.close()  # the commit log's buffered tail reaches the disk
    return seqs


def _same_outputs(seqs):
    a, b = seqs["jax"].out, seqs["port"].out
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x[-1], tuple) and len(x[-1]) == 2 and isinstance(x[-1][1], np.ndarray):
            (jt, jv), (tt, tv) = x[-1], y[-1]
            assert x[:-1] == y[:-1] and jt == tt, x[:2]
            assert jv.shape == tv.shape and jv.size > 0, x[:2]
            np.testing.assert_array_equal(np.isnan(jv), np.isnan(tv), err_msg=str(x[:2]))
            np.testing.assert_allclose(tv, jv, rtol=1e-12, atol=0, equal_nan=True,
                                       err_msg=str(x[:2]))
        else:
            assert x == y, x[:2]


def _same_files(tmp_path):
    ja, po = _digests(tmp_path / "jax"), _digests(tmp_path / "port")
    assert ja == po
    return ja


def test_write_sequence_matches_jax(tmp_path):
    seqs = _run_both(tmp_path, [lambda s: s.step_writes(1), lambda s: s.query("open"),
                                Sequence.step_ownership])
    _same_outputs(seqs)
    files = _same_files(tmp_path)
    assert any("commitlog" in f for f in files)
    out = dict((o[0], o[1:]) for o in seqs["port"].out if len(o) <= 3)
    assert out["limited"][0][1] == 5 and out["limited"][1] == 5  # 5 of 10 admitted
    assert out["late_future"][0][0] == 2                         # two go cold
    assert out["ownership_mixed"][0][2] > 0                       # some dropped
    assert out["ownership_all_unowned"][0] == 1


def test_flush_and_cold_volume_match_jax(tmp_path):
    seqs = _run_both(tmp_path, [lambda s: s.step_writes(2), lambda s: s.query("open"),
                                Sequence.step_flush, lambda s: s.query("flushed")])
    _same_outputs(seqs)
    files = _same_files(tmp_path)
    vols = {f.split("-")[2] for f in files if "-data.db" in f and f.startswith("data/")}
    assert vols == {"0", "1"}
    # the port answers the same before and after the flush
    port = [o for o in seqs["port"].out if o[0] in ("q_open", "q_flushed")]
    assert len(port) == 6
    half = len(port) // 2
    for (_, q, (t0, v0)), (_, q1, (t1, v1)) in zip(port[:half], port[half:]):
        assert q == q1 and t0 == t1
        np.testing.assert_allclose(v1, v0, rtol=1e-12, equal_nan=True)


def test_crash_and_bootstrap_match_jax(tmp_path):
    """Unflushed and cold points replayed from the commit log after a
    "crash" (a new Database on the same root), then the same after a
    snapshot."""
    seqs = _run_both(tmp_path, [
        lambda s: s.step_writes(3), lambda s: s.reopen("crash_open"),
        lambda s: s.query("replayed"),
        Sequence.step_flush, Sequence.step_open_block, lambda s: s.reopen("crash_flushed"),
        lambda s: s.out.append(("snapshot", s.db.snapshot())),
        lambda s: s.reopen("after_snapshot"),
        lambda s: s.out.append(("cleanup", s.db.cleanup(START + BLOCK + 13 * MIN))),
        lambda s: s.reopen("after_cleanup")])
    _same_outputs(seqs)
    files = _same_files(tmp_path)
    assert any(f.startswith("snapshots/") for f in files)
    out = [o for o in seqs["port"].out if o[0].startswith(("crash", "after")) and
           isinstance(o[1], dict)]
    assert out[0][1]["commitlog_replayed"] > 0
    assert any(o[1]["snapshot_restored"] > 0 for o in out)


def test_entry_points_need_a_device_or_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdb.Database(tdb.DatabaseOptions(root=str(tmp_path / "a")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from m3_tpu_torch.storage.buffer import ShardBuffer
        ShardBuffer(BLOCK, 2, 64, 64)
    db = tdb.Database(tdb.DatabaseOptions(root=str(tmp_path / "b")), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.Engine(tadapter.DatabaseStorage(db))
    with pytest.raises(NotImplementedError, match="instrument"):
        tdb.Database(tdb.DatabaseOptions(root=str(tmp_path / "c")), device="cpu",
                     instrument=object())
    db.close()


# -- the cases of tests/test_storage.py -------------------------------------

def _case_flush_read(P, root):
    db = _mkdb(P, root)
    ids = [f"cpu.util.host{i:03d}".encode() for i in range(200)]
    rng = np.random.default_rng(7)
    base = rng.uniform(10, 100, len(ids))
    all_ids, all_ts, all_vals = [], [], []
    for j in range(60):
        all_ids += ids
        all_ts += [START + (j + 1) * 10 * SEC] * len(ids)
        all_vals += np.round(base + rng.normal(0, 1, len(ids)), 2).tolist()
    order = rng.permutation(len(all_ids))
    db.write_batch("default", [all_ids[i] for i in order], np.asarray(all_ts)[order],
                   np.asarray(all_vals)[order])
    want = sorted((all_ts[i], all_vals[i]) for i in range(len(all_ids)) if all_ids[i] == ids[5])
    got = db.read("default", ids[5], START, START + BLOCK)
    assert got == want
    stats = db.tick(START + BLOCK + 10 * MIN + SEC)
    assert stats["default"]["warm_flushed"] == len(ids)
    assert db.read("default", ids[5], START, START + BLOCK) == want
    sh = P.db.shard_for_id(ids[5], 2)
    seg = P.fs.DataFileSetReader(root, "default", sh, START, 0).read(ids[5])
    db.close()
    return [got, stats, seg]


def _case_float_series_flush(P, root):
    """Raw doubles (the XOR path, ~70 bits a point) overflow the JAX
    package's flush sizing, which sends them to the scalar encoder; the
    port sizes its one device pass to the longest stream.  The volume
    bytes must be the same."""
    db = _mkdb(P, root)
    rng = np.random.default_rng(13)
    ids = [b"float-%02d" % i for i in range(24)]
    for j in range(300):
        vals = rng.normal(0, 1e3, len(ids))
        vals[j % 24] = np.round(vals[j % 24], 1)  # an int-path point now and then
        db.write_batch("default", ids, np.full(len(ids), START + (j + 1) * 10 * SEC), vals)
    db.tick(START + BLOCK + 10 * MIN + SEC)
    out = [db.read("default", ids[3], START, START + BLOCK)]
    db.close()
    return out


def _case_commitlog_bootstrap(P, root):
    db1 = _mkdb(P, root)
    ts = np.array([START + 10**10, START + 2 * 10**10], np.int64)
    db1.write_batch("default", [b"m1", b"m2"], ts, np.array([1.25, 2.5]))
    db1.close()
    db2 = _mkdb(P, root)
    out = [db2.read("default", b"m1", START, START + BLOCK), db2.bootstrap(),
           db2.read("default", b"m1", START, START + BLOCK)]
    assert out[1]["commitlog_replayed"] == 2 and out[2] == [(START + 10**10, 1.25)]
    db2.close()
    return out


def _case_cold_volume(P, root):
    db = _mkdb(P, root)
    t_warm = START + 10 * SEC
    db.write_batch("default", [b"s"], np.array([t_warm]), np.array([1.0]))
    now = START + BLOCK + 10 * MIN + SEC
    db.tick(now)
    ncold = db.write_batch("default", [b"s"], np.array([START + 20 * SEC]),
                           np.array([2.0]), now_nanos=now)
    db.tick(now + SEC)
    sh = P.db.shard_for_id(b"s", 2)
    out = [int(ncold), P.fs.list_filesets(root, "default", sh),
           db.read("default", b"s", START, START + BLOCK)]
    assert out[0] == 1 and out[1] == [(START, 1)]
    assert out[2] == [(t_warm, 1.0), (START + 20 * SEC, 2.0)]
    db.close()
    return out


def _case_order_and_duplicates(P, root):
    db = _mkdb(P, root)
    ts = np.array([START + 3 * 10**10, START + 1 * 10**10, START + 2 * 10**10])
    db.write_batch("default", [b"x"] * 3, ts, np.array([3.0, 1.0, 2.0]))
    t = START + 10**10
    db.write_batch("default", [b"d", b"d"], np.array([t, t]), np.array([1.0, 9.0]))
    out = [db.read("default", b"x", START, START + BLOCK),
           db.read("default", b"d", START, START + BLOCK)]
    assert [v for _, v in out[0]] == [1.0, 2.0, 3.0] and out[1] == [(t, 9.0)]
    db.close()
    return out


def _case_tagged_query(P, root):
    db = _mkdb(P, root)
    docs = [P.doc.Document.from_tags(f"cpu.util.host{i:03d}".encode(),
                                     {b"__name__": b"cpu_util",
                                      b"dc": b"us-east" if i % 2 == 0 else b"eu-west"})
            for i in range(10)]
    t = START + 10**10
    db.write_tagged_batch("default", docs, np.full(10, t, np.int64), np.arange(10.0))
    hits = db.query_ids("default", P.search.Term(b"dc", b"eu-west"), START, START + BLOCK)
    out = [sorted(d.id for d in hits),
           [db.read("default", d.id, START, START + BLOCK) for d in hits]]
    assert len(out[0]) == 5
    db.close()
    return out


# -- the database cases of tests/test_corruption.py ------------------------

def _flip(path, offset=None):
    raw = bytearray(path.read_bytes())
    i = len(raw) // 2 if offset is None else offset
    raw[i] ^= 0xFF
    path.write_bytes(bytes(raw))


def _case_read_degradation(P, root):
    db = _mkdb(P, root)
    sid = b"deg-series"
    sh = db.namespaces["default"].shards[P.db.shard_for_id(sid, 2)]
    db.write_batch("default", [sid], np.array([START + 10 * SEC]), np.array([1.0]))
    now = START + BLOCK + 10 * MIN + SEC
    db.tick(now)
    db.write_batch("default", [sid], np.array([START + 20 * SEC]), np.array([2.0]),
                   now_nanos=now)
    _flip(P.fs.fileset_path(root, "default", sh.shard_id, START, 0, "data"))
    got = db.read("default", sid, START, START + BLOCK)
    inv = P.quar.list_quarantined(root)
    out = [got, [e["shard"] for e in inv], START in sh.flushed_blocks]
    assert got == [(START + 20 * SEC, 2.0)] and not out[2]
    if P is T:  # the JAX package counts these on its instrument scope
        assert (db.corruption_detected, db.corruption_quarantined) == (1, 1)
    db.close()
    return out


def _case_lower_volume(P, root):
    sid = b"vol-series"
    sh = P.db.shard_for_id(sid, 2)
    m3 = (__import__("m3_tpu.encoding.m3tsz", fromlist=["x"]) if P is J
          else __import__("m3_tpu_torch.encoding.m3tsz", fromlist=["x"]))
    for vol, v in ((0, 1.5), (1, 9.5)):
        P.fs.DataFileSetWriter(root, "default", sh, START, BLOCK, volume=vol).write_all(
            [(sid, m3.encode_series([(START + 5 * SEC, v)], start=START))])
    _flip(P.fs.fileset_path(root, "default", sh, START, 1, "data"))
    db = _mkdb(P, root)
    out = [db.read("default", sid, START, START + BLOCK),
           dict(P.fs.list_filesets(root, "default", sh)),
           [e["volume"] for e in P.quar.list_quarantined(root)]]
    assert out[0] == [(START + 5 * SEC, 1.5)] and out[2] == [1]
    db.close()
    return out


def _bootstrap_after(ftype):
    def case(P, root):
        db1 = _mkdb(P, root)
        sid = b"boot-series"
        sh = P.db.shard_for_id(sid, 2)
        ts = np.array([START + (k + 1) * SEC for k in range(6)], np.int64)
        db1.write_batch("default", [sid] * 6, ts, np.arange(6.0))
        db1.tick(START + BLOCK + 10 * MIN + SEC)
        db1.close()
        p = P.fs.fileset_path(root, "default", sh, START, 0, ftype)
        if ftype == "index":
            p.write_bytes(p.read_bytes()[: len(p.read_bytes()) // 2])
        else:
            _flip(p)
        db2 = _mkdb(P, root)
        out = [db2.bootstrap(), db2.read("default", sid, START, START + BLOCK),
               [e["block_start"] for e in P.quar.list_quarantined(root)]]
        assert out[0]["commitlog_replayed"] == 6 and out[2] == [START]
        if P is T:
            assert db2.corruption_detected == 1
        db2.close()
        return out
    return case


def _case_corrupt_snapshot(P, root):
    db1 = _mkdb(P, root)
    db1.write_batch("default", [b"snap-series"], np.array([START + SEC]), np.array([1.0]))
    out = [db1.snapshot()]
    db1.close()
    files = sorted(P.snap.snapshot_data_root(root, out[0]["seq"]).rglob("fileset-*-data.db"))
    _flip(files[0])
    db2 = _mkdb(P, root)
    out.append(db2.bootstrap())
    out.append(sorted(e["label"] for e in P.quar.list_quarantined(root)))
    assert f"snapshot-{out[0]['seq']}" in out[2]
    if P is T:
        assert db2.corruption_quarantined == 1
    db2.close()
    return out


def _case_corrupt_snapshot_meta(P, root):
    db = _mkdb(P, root)
    db.write_batch("default", [b"s2"], np.array([START + SEC]), np.array([1.0]))
    db.snapshot()
    db.write_batch("default", [b"s2"], np.array([START + 2 * SEC]), np.array([2.0]))
    db.snapshot()
    _flip(P.snap.meta_path(root, 1), offset=10)
    out = [P.snap.latest_snapshot(root).seq, db.cleanup(START + 2 * SEC),
           P.snap.meta_path(root, 1).exists()]
    db.close()
    return out


def _case_corrupt_index_segment(P, root):
    seg_dir = pathlib.Path(root) / "index" / "default"
    seg_dir.mkdir(parents=True)
    (seg_dir / f"segment-{START}.db").write_bytes(b"\x00garbage\xff" * 8)
    db = _mkdb(P, root)
    out = [db.bootstrap(), db.namespaces["default"].index.sealed]
    db.close()
    return out


CASES = {
    "flush_read_bit_identical": _case_flush_read,
    "float_series_flush": _case_float_series_flush,
    "commitlog_bootstrap": _case_commitlog_bootstrap,
    "cold_write_new_volume": _case_cold_volume,
    "order_and_duplicates": _case_order_and_duplicates,
    "tagged_query_read": _case_tagged_query,
    "read_degrades_on_corrupt_fileset": _case_read_degradation,
    "falls_back_to_lower_volume": _case_lower_volume,
    "bootstrap_corrupt_checkpoint": _bootstrap_after("checkpoint"),
    "bootstrap_corrupt_digest": _bootstrap_after("digest"),
    "bootstrap_corrupt_data": _bootstrap_after("data"),
    "bootstrap_torn_index": _bootstrap_after("index"),
    "bootstrap_corrupt_snapshot_fileset": _case_corrupt_snapshot,
    "cleanup_reaps_corrupt_snapshot_meta": _case_corrupt_snapshot_meta,
    "corrupt_index_segment_does_not_crash": _case_corrupt_index_segment,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_storage_cases_match_jax(case, tmp_path):
    got = {name: CASES[case](P, tmp_path / name) for name, P in PKGS.items()}
    assert got["jax"] == got["port"]
    _same_files(tmp_path)


def test_matchers_to_query_matches_jax():
    from m3_tpu.query.promql import LabelMatcher as JM
    from m3_tpu_torch.query.promql import LabelMatcher as TM
    specs = [(b"a", "=", b"1"), (b"b", "!=", b"2"), (b"c", "=~", b"x.*"), (b"d", "!~", b"y")]
    for name in (None, b"m"):
        for k in range(len(specs) + 1):
            jq = jadapter.matchers_to_query(name, tuple(JM(*s) for s in specs[:k]))
            tq = tadapter.matchers_to_query(name, tuple(TM(*s) for s in specs[:k]))
            assert repr(jq) == repr(tq)
    with pytest.raises(ValueError):
        tadapter.matchers_to_query(None, (TM(b"a", "~", b"1"),))
