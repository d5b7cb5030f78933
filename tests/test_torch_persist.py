"""m3_tpu_torch.persist and the scalar codec against m3_tpu on the CPU.

Every byte written to disk is compared exactly: the same series go
through the JAX package's and the port's ``DataFileSetWriter``,
``CommitLogWriter`` and snapshot metadata, and every file of the volume
directory must have the same sha256; each package's reader reads both
trees.  Corruption detection (``fault.mangle`` and flipped or truncated
bytes) must raise the same typed errors with the same ``check``.  The
port's scalar M3TSZ codec re-encodes the Go golden streams byte for
byte.
"""

import base64
import hashlib
import json
import pathlib
import types

import numpy as np
import pytest

import m3_tpu.encoding.m3tsz as jm3
import m3_tpu.persist.bloom as jbloom
import m3_tpu.persist.commitlog as jcl
import m3_tpu.persist.corruption as jcor
import m3_tpu.persist.fs as jfs
import m3_tpu.persist.quarantine as jquar
import m3_tpu.persist.snapshot as jsnap
import m3_tpu.x.fault as jfault
import m3_tpu_torch.encoding.m3tsz as tm3
import m3_tpu_torch.persist.bloom as tbloom
import m3_tpu_torch.persist.commitlog as tcl
import m3_tpu_torch.persist.corruption as tcor
import m3_tpu_torch.persist.fs as tfs
import m3_tpu_torch.persist.quarantine as tquar
import m3_tpu_torch.persist.snapshot as tsnap
import m3_tpu_torch.x.fault as tfault

BLOCK = 2 * 3600 * 10**9
START = (1_700_000_000 * 10**9) // BLOCK * BLOCK
SEC = 10**9
DATA = pathlib.Path(__file__).resolve().parent / "data"

J = types.SimpleNamespace(m3=jm3, fs=jfs, cl=jcl, cor=jcor, snap=jsnap,
                          quar=jquar, fault=jfault, bloom=jbloom)
T = types.SimpleNamespace(m3=tm3, fs=tfs, cl=tcl, cor=tcor, snap=tsnap,
                          quar=tquar, fault=tfault, bloom=tbloom)
PKGS = {"jax": J, "port": T}


def _digests(root) -> dict:
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _series(P, n=300, T_=50, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sid = f"series-{i:04d}".encode()
        ts = START + np.cumsum(rng.integers(1, 20, T_)) * SEC
        kind = i % 3
        vals = (np.round(rng.normal(50, 5, T_), 2) if kind == 0
                else np.cumsum(rng.integers(0, 9, T_)).astype(float) if kind == 1
                else rng.normal(size=T_))
        out.append((sid, P.m3.encode_series(list(zip(ts.tolist(), vals.tolist())),
                                            start=START)))
    return out


# -- scalar codec -----------------------------------------------------------

def test_scalar_codec_reencodes_go_golden_streams():
    gold = [base64.b64decode(s)
            for s in json.loads((DATA / "m3tsz_sample_series.json").read_text())]
    for data in gold:
        enc = tm3.Encoder(int.from_bytes(data[:8], "big"))
        dps = tm3.decode_series(data)
        for d in dps:
            enc.encode(d)
        assert enc.stream() == data
        assert [(d.timestamp, d.value, d.unit, d.annotation) for d in dps] == [
            (d.timestamp, d.value, d.unit, d.annotation) for d in jm3.decode_series(data)]


@pytest.mark.parametrize("seed", range(3))
def test_scalar_codec_bytes_match_jax(seed):
    rng = np.random.default_rng(seed)
    for kind in range(5):
        n = int(rng.integers(1, 300))
        ts = (START + np.cumsum(rng.integers(1, 4000, n)) * 10**6).tolist()
        vals = ([float(v) for v in np.round(rng.normal(0, 100, n), kind)] if kind < 3
                else [float("nan") if k % 7 == 0 else float(rng.normal()) for k in range(n)]
                if kind == 3 else [float(v) for v in rng.integers(-2**40, 2**40, n)])
        pts = list(zip(ts, vals))
        a = tm3.encode_series(pts, start=START)
        assert a == jm3.encode_series(pts, start=START)
        got = [(d.timestamp, d.value) for d in tm3.decode_series(a)]
        want = [(d.timestamp, d.value) for d in jm3.decode_series(a)]
        assert [t for t, _ in got] == [t for t, _ in want] == ts
        # bits as the reference decodes them (the int path writes -0 as 0)
        assert np.asarray([v for _, v in got]).view(np.uint64).tolist() == \
            np.asarray([v for _, v in want]).view(np.uint64).tolist()


def test_istream_matches_jax():
    from m3_tpu.encoding.bitstream import IStream as JI
    from m3_tpu_torch.encoding.bitstream import IStream as TI
    data = bytes(np.random.default_rng(1).integers(0, 256, 40, dtype=np.uint8))
    a, b = JI(data), TI(data)
    for w in (1, 7, 13, 64, 3, 0, 33, 64, 8):
        assert a.peek_bits(w) == b.peek_bits(w)
        assert a.read_bits(w) == b.read_bits(w)
        assert a.remaining_bits() == b.remaining_bits()
    assert a.try_peek_bits(200) is None and b.try_peek_bits(200) is None
    with pytest.raises(EOFError):
        b.read_bits(200)


# -- filesets ---------------------------------------------------------------

def test_fileset_bytes_identical_and_cross_readable(tmp_path):
    series = _series(J)
    assert series == _series(T)
    for name, P in PKGS.items():
        P.fs.DataFileSetWriter(tmp_path / name, "ns", 3, START, BLOCK).write_all(series)
        P.fs.DataFileSetWriter(tmp_path / name, "ns", 3, START, BLOCK,
                               volume=1).write_all(series[::7])
    assert _digests(tmp_path / "jax") == _digests(tmp_path / "port")
    assert len(_digests(tmp_path / "jax")) >= 14
    want = dict(series)
    for P in PKGS.values():
        for name in PKGS:
            assert P.fs.list_filesets(tmp_path / name, "ns", 3) == [(START, 1)]
            r = P.fs.DataFileSetReader(tmp_path / name, "ns", 3, START, 0)
            assert len(r) == 300 and r.info.num_series == 300
            assert r.read(b"series-0123") == want[b"series-0123"]
            assert r.read(b"missing-id") is None
            assert dict(r.read_all()) == want
            assert [(e.id, e.checksum) for e in r.entries()] == [
                (e.id, e.checksum) for e in jfs.DataFileSetReader(
                    tmp_path / "jax", "ns", 3, START, 0).entries()]
            r.close()


def test_bloom_bytes_match_jax():
    ids = [f"metric-{i}".encode() for i in range(5000)]
    blooms = []
    for P in PKGS.values():
        bf = P.bloom.BloomFilter.from_estimate(len(ids))
        bf.add_batch(ids)
        assert bf.contains_batch(ids).all()
        blooms.append(bf.to_bytes())
    assert blooms[0] == blooms[1]
    other = [f"absent-{i}".encode() for i in range(5000)]
    assert tbloom.BloomFilter.from_bytes(blooms[1]).contains_batch(other).mean() < 0.05


def _write_small(P, root, ns="ns", shard=0, volume=0, n=5):
    series = [
        (b"series-%03d" % i,
         P.m3.encode_series([(START + (j + 1) * SEC, float(i + j)) for j in range(4)],
                            start=START))
        for i in range(n)
    ]
    P.fs.DataFileSetWriter(root, ns, shard, START, BLOCK, volume=volume).write_all(series)
    return series


def _flip(path, offset=None):
    raw = bytearray(path.read_bytes())
    i = len(raw) // 2 if offset is None else offset
    raw[i] ^= 0xFF
    path.write_bytes(bytes(raw))


def _truncate(path, frac=0.5):
    raw = path.read_bytes()
    path.write_bytes(raw[: max(1, int(len(raw) * frac))])


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # the typed error and its fields are compared
        return (type(e).__name__, getattr(e, "component", None),
                getattr(e, "check", None), isinstance(e, ValueError))


@pytest.mark.parametrize("ftype,mangle", [
    ("checkpoint", _flip), ("digest", _flip), ("data", _flip),
    ("index", _truncate), ("info", _flip), ("summaries", _flip),
    ("bloom", _flip), ("checkpoint_short", None), ("data_missing", None),
])
def test_reader_corruption_matches_jax(tmp_path, ftype, mangle):
    got = {}
    for name, P in PKGS.items():
        root = tmp_path / name
        _write_small(P, root)
        if ftype == "checkpoint_short":
            p = P.fs.fileset_path(root, "ns", 0, START, 0, "checkpoint")
            p.write_bytes(p.read_bytes()[:2])
        elif ftype == "data_missing":
            P.fs.fileset_path(root, "ns", 0, START, 0, "data").unlink()
        else:
            mangle(P.fs.fileset_path(root, "ns", 0, START, 0, ftype))
        got[name] = _outcome(lambda: P.fs.DataFileSetReader(root, "ns", 0, START, 0))
    assert got["jax"] == got["port"]
    assert got["port"][0] != "ok" and got["port"][3]


def test_fileset_read_corrupt_faultpoint(tmp_path):
    """``fault.mangle`` at ``fileset.read``: the same typed error in both
    packages (each arms its own registry), the disk untouched."""
    got = {}
    for name, P in PKGS.items():
        series = _write_small(P, tmp_path / name)
        r = P.fs.DataFileSetReader(tmp_path / name, "ns", 0, START, 0)
        sid = series[0][0]
        assert r.read(sid) == series[0][1]
        with P.fault.armed("fileset.read", "corrupt", seed=3):
            one = _outcome(lambda: r.read(sid))
            every = _outcome(lambda: list(r.read_all()))
        got[name] = (one, every, P.fault.counters().get("fileset.read.corrupt_triggers"))
        assert r.read(sid) == series[0][1]
        r.close()
    assert got["jax"][:2] == got["port"][:2]
    assert got["port"][0][0] == "ChecksumMismatch" and got["port"][0][2] == "segment-checksum"


def test_checkpoint_gates_visibility(tmp_path):
    _write_small(T, tmp_path)
    tfs.fileset_path(tmp_path, "ns", 0, START, 0, "checkpoint").unlink()
    with pytest.raises(FileNotFoundError):
        tfs.DataFileSetReader(tmp_path, "ns", 0, START, 0)
    assert tfs.list_filesets(tmp_path, "ns", 0) == []


# -- commit log -------------------------------------------------------------

def _commitlog(P, root, rotate_bytes=0):
    w = P.cl.CommitLogWriter(root, fsync=P.cl.FsyncPolicy.EVERY_WRITE,
                             rotate_bytes=rotate_bytes)
    rng = np.random.default_rng(4)
    for b in range(6):
        n = int(rng.integers(1, 40))
        ids = [b"cl-%d-%d" % (b, i) for i in range(n)]
        ts = START + rng.integers(0, 10**12, n)
        vals = rng.normal(size=n)
        vals[::5] = np.nan
        ann = [b"tags-%d" % i if i % 2 else b"" for i in range(n)] if b % 2 else None
        w.write_batch(ids, ts, vals, annotations=ann,
                      namespace=b"nsx" if b % 3 else b"default")
    w.close()
    return P.cl.list_commitlogs(root)


@pytest.mark.parametrize("rotate_bytes", [0, 900])
def test_commitlog_bytes_identical_and_cross_readable(tmp_path, rotate_bytes):
    logs = {name: _commitlog(P, tmp_path / name, rotate_bytes) for name, P in PKGS.items()}
    assert _digests(tmp_path / "jax") == _digests(tmp_path / "port")
    assert len(logs["port"]) == len(logs["jax"]) == (1 if rotate_bytes == 0 else 4)

    def entries(P, name):
        return [(e.series_id, e.timestamp, np.float64(e.value).view(np.uint64),
                 e.namespace, e.annotation)
                for log in P.cl.list_commitlogs(tmp_path / name)
                for e in P.cl.read_commitlog(log)]

    want = entries(J, "jax")
    assert len(want) > 30
    for P in PKGS.values():
        for name in PKGS:
            assert entries(P, name) == want


@pytest.mark.parametrize("damage", ["torn_tail", "corrupt_header", "torn_header",
                                    "flip_payload"])
def test_commitlog_damage_matches_jax(tmp_path, damage):
    """The reader's truncation contract and strict mode's typed error,
    the same in both packages (``test_corruption.py``'s commit-log
    cases)."""
    got = {}
    for name, P in PKGS.items():
        log = _commitlog(P, tmp_path / name)[0]
        raw = bytearray(log.read_bytes())
        if damage == "torn_tail":
            raw = raw[:-5]
        elif damage == "corrupt_header":
            import struct
            plen = struct.unpack_from("<I", raw, 0)[0]
            raw[12 + plen] ^= 0xFF
        elif damage == "torn_header":
            raw += b"\x01\x02"
        else:
            raw[len(raw) // 3] ^= 0x10
        log.write_bytes(bytes(raw))
        lenient = [(e.series_id, e.timestamp) for e in P.cl.read_commitlog(log)]
        got[name] = (lenient, _outcome(lambda: len(list(P.cl.read_commitlog(log, strict=True)))))
    assert got["jax"] == got["port"]
    assert got["port"][1][0] != "ok"


def test_commitlog_flush_drop_faultpoint(tmp_path):
    """``commitlog.flush`` armed to drop skips the fsync; the bytes on
    disk after close are those of the JAX package's writer."""
    for name, P in PKGS.items():
        with P.fault.armed("commitlog.flush", "drop"):
            _commitlog(P, tmp_path / name)
    assert _digests(tmp_path / "jax") == _digests(tmp_path / "port")


# -- snapshots and quarantine ----------------------------------------------

def test_snapshot_metadata_bytes_identical(tmp_path):
    for name, P in PKGS.items():
        root = tmp_path / name
        for seq, cl_seq in ((0, 3), (1, 7), (2, 7)):
            P.snap.commit_snapshot(root, seq, cl_seq)
        assert P.snap.next_snapshot_seq(root) == 3
        assert P.snap.latest_snapshot(root).commitlog_seq == 7
    assert _digests(tmp_path / "jax") == _digests(tmp_path / "port")
    got = {}
    for name, P in PKGS.items():
        root = tmp_path / name
        _flip(P.snap.meta_path(root, 2), offset=10)
        got[name] = (_outcome(lambda: P.snap.SnapshotMetadata.from_bytes(
            P.snap.meta_path(root, 2).read_bytes(), path=P.snap.meta_path(root, 2))),
            [m.seq for m in P.snap.list_snapshots(root)],
            P.snap.prune_snapshots(root, keep=1))
    assert got["jax"] == got["port"]
    assert _digests(tmp_path / "jax").keys() == _digests(tmp_path / "port").keys()


def _reason(d):
    r = json.loads((pathlib.Path(d) / "reason.json").read_text())
    r.pop("quarantined_at", None)
    r.pop("dir", None)
    return r


def test_quarantine_matches_jax(tmp_path):
    got = {}
    for name, P in PKGS.items():
        root = tmp_path / name
        _write_small(P, root)
        err = P.cor.ChecksumMismatch("digest mismatch for data file", path="x",
                                     component="fileset", check="digest:data")
        q1 = P.quar.quarantine_fileset(root, "ns", 0, START, 0, err)
        _write_small(P, root)
        q2 = P.quar.quarantine_fileset(root, "ns", 0, START, 0, None)
        got[name] = (q1.relative_to(root), q2.relative_to(root),
                     P.fs.list_filesets(root, "ns", 0),
                     sorted(p.name for p in q1.iterdir()),
                     _reason(q1), _reason(q2),
                     len(P.quar.list_quarantined(root)),
                     P.quar.quarantine_fileset(root, "ns", 0, START, 5))
    assert got["jax"] == got["port"]
    assert got["port"][1].name.endswith("-2")
