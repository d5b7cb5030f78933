"""m3_tpu_torch.storage.repair (and the scrubber's peer repair) against
the JAX package's on the CPU.

The repair and peers-bootstrap cases of ``tests/test_replication.py``
run once through each package, the port's ``Database`` on
``device="cpu"``: the reference's assertions hold on both, the reports
are equal, and every file on every replica is sha256-equal to the JAX
package's.  Divergent series merge through each package's scalar host
codec, so a repaired volume is byte-identical too.  Beside them: a
replica restarted from its own commit log after missing writes, repaired
over RPC; a port replica repaired from a JAX replica and the reverse;
the scrubber healing a quarantined volume from its peers."""

import hashlib
import shutil
import types

import numpy as np
import pytest

import m3_tpu.client.session as jsess
import m3_tpu.cluster.placement as jpl
import m3_tpu.persist.fs as jfs
import m3_tpu.server.rpc as jrpc
import m3_tpu.storage.database as jdb
import m3_tpu.storage.repair as jrep
import m3_tpu.storage.scrub as jscrub
import m3_tpu_torch.client.session as tsess
import m3_tpu_torch.cluster.placement as tpl
import m3_tpu_torch.persist.fs as tfs
import m3_tpu_torch.server.rpc as trpc
import m3_tpu_torch.storage.database as tdb
import m3_tpu_torch.storage.repair as trep
import m3_tpu_torch.storage.scrub as tscrub

SEC = 10**9
HOUR = 3600 * SEC
BLOCK = 2 * HOUR
T0 = (1_600_000_000 * SEC) // BLOCK * BLOCK

PKGS = {
    "jax": types.SimpleNamespace(sess=jsess, pl=jpl, fs=jfs, rpc=jrpc, db=jdb, rep=jrep,
                                 scrub=jscrub, dev={}),
    "torch": types.SimpleNamespace(sess=tsess, pl=tpl, fs=tfs, rpc=trpc, db=tdb, rep=trep,
                                   scrub=tscrub, dev={"device": "cpu"}),
}


def both(scenario, tmp_path):
    out = {}
    for side, P in PKGS.items():
        root = tmp_path / side
        root.mkdir()
        out[side] = scenario(P, root)
    assert out["torch"] == out["jax"]
    return out["torch"]


def _mk_db(P, root, name, commitlog=False):
    return P.db.Database(
        P.db.DatabaseOptions(root=str(root / name), commitlog_enabled=commitlog),
        namespaces={"default": P.db.NamespaceOptions(num_shards=4, slot_capacity=256,
                                                     sample_capacity=2048)}, **P.dev)


def _write_corpus(target, ids=None, n_pts=10):
    ids = ids or [b"series-%d" % i for i in range(8)]
    for k in range(n_pts):
        t = np.full(len(ids), T0 + (k + 1) * 10 * SEC, np.int64)
        v = np.arange(len(ids), dtype=np.float64) + k
        target.write_batch("default", ids, t, v, now_nanos=int(t[0]))
    return ids


def _flushed_cluster(P, root, ids=None, n=3):
    dbs = {f"i{k}": _mk_db(P, root, f"i{k}") for k in range(n)}
    p = P.pl.initial_placement([P.pl.Instance(iid) for iid in dbs], num_shards=4, rf=n)
    s = P.sess.ReplicatedSession(p, dbs, write_level=P.sess.ConsistencyLevel.ALL)
    ids = _write_corpus(s, ids=ids)
    for db in dbs.values():
        db.tick(T0 + BLOCK + P.db.NamespaceOptions().buffer_past_nanos + SEC)
    return dbs, ids


def _digests(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "data").rglob("*")) if p.is_file()}


def _files(dbs) -> dict:
    out = {}
    for iid, db in dbs.items():
        db.close()
        out[iid] = _digests(__import__("pathlib").Path(db.opts.root))
    return out


def _wipe_shard(db, shard):
    shutil.rmtree(f"{db.opts.root}/data/default/{shard}", ignore_errors=True)
    db.namespaces["default"].shards[shard].flushed_blocks.clear()


def _drop_series(P, db, shard, drop_idx):
    """Rewrite a replica's block at volume+1 without one series."""
    filesets = dict(P.fs.list_filesets(db.opts.root, "default", shard))
    r = P.fs.DataFileSetReader(db.opts.root, "default", shard, T0, filesets[T0])
    series = list(r.read_all())
    dropped = series[drop_idx % len(series)][0]
    P.fs.DataFileSetWriter(db.opts.root, "default", shard, T0, BLOCK,
                           volume=filesets[T0] + 1).write_all(
        [sv for sv in series if sv[0] != dropped])
    return dropped


class _Sick:
    """A handle whose ``fail_on`` method fails at the application level."""

    def __init__(self, P, inner, fail_on="read_block",
                 msg="ChecksumMismatch: segment checksum mismatch"):
        self._P, self._inner, self._fail_on, self._msg = P, inner, fail_on, msg

    def __getattr__(self, name):
        if name == self._fail_on:
            def boom(*a, **k):
                raise self._P.rpc.RemoteError(self._msg)
            return boom
        return getattr(self._inner, name)


# ---- TestRepairAndPeersBootstrap -----------------------------------------


def test_replicas_flush_bit_identical_blocks(tmp_path):
    def run(P, root):
        dbs, _ = _flushed_cluster(P, root)
        metas = []
        for sh in range(4):
            per = [P.rep.block_metadata(db, "default", sh, T0) for db in dbs.values()]
            assert per[0] == per[1] == per[2]
            metas.append(sorted((per[0] or {}).items()))
        files = _files(dbs)
        assert files["i0"] == files["i1"] == files["i2"]
        return metas, files
    both(run, tmp_path)


def test_wipe_peers_bootstrap_repair_converges(tmp_path):
    def run(P, root):
        dbs, ids = _flushed_cluster(P, root)
        victim = dbs["i1"]
        _wipe_shard(victim, 0)
        assert P.rep.block_metadata(victim, "default", 0, T0) is None
        rep = P.rep.repair_shard_block(list(dbs.values()), "default", 0, T0)
        assert rep["blocks_missing"] in (0, 1)
        stats = P.rep.peers_bootstrap(victim, list(dbs.values()), "default")
        rep2 = P.rep.repair_namespace(list(dbs.values()), "default")
        assert rep2.converged, rep2
        m = [P.rep.block_metadata(db, "default", 0, T0) for db in dbs.values()]
        assert m[0] == m[1] == m[2] is not None
        return dict(rep), stats, dict(rep2), _files(dbs)
    both(run, tmp_path)


def test_divergent_series_repaired_by_union_merge(tmp_path):
    def run(P, root):
        dbs, _ = _flushed_cluster(P, root)
        victim = dbs["i2"]
        shard = next(sh for sh in range(4) if P.rep.block_metadata(victim, "default", sh, T0))
        dropped = _drop_series(P, victim, shard, 0)
        rep = P.rep.repair_shard_block(list(dbs.values()), "default", shard, T0)
        assert rep["series_diff"] >= 1 and rep["repaired_replicas"] >= 1
        rep2 = P.rep.repair_shard_block(list(dbs.values()), "default", shard, T0)
        assert rep2.converged
        pts = victim.read("default", dropped, T0, T0 + BLOCK)
        assert len(pts) == 10
        return dict(rep), dict(rep2), pts, _files(dbs)
    both(run, tmp_path)


# ---- TestBadReplicaDoesNotAbortSweep --------------------------------------


def test_remote_error_on_metadata_demotes_not_aborts(tmp_path):
    def run(P, root):
        dbs, _ = _flushed_cluster(P, root)
        handles = list(dbs.values())
        handles[1] = _Sick(P, handles[1], fail_on="block_metadata")
        rep = P.rep.repair_namespace(handles, "default")
        assert rep["blocks_missing"] > 0 and rep["series_checked"] > 0
        return dict(rep), _files(dbs)
    both(run, tmp_path)


def test_remote_error_on_read_demotes_not_aborts(tmp_path):
    def run(P, root):
        dbs, _ = _flushed_cluster(P, root)
        handles = list(dbs.values())
        handles[2] = _Sick(P, handles[2], fail_on="read_block")
        victim = handles[0]
        _wipe_shard(victim, 0)
        rep = P.rep.repair_shard_block(handles, "default", 0, T0)
        assert rep["blocks_missing"] >= 1
        assert P.rep.block_metadata(victim, "default", 0, T0) is not None
        return dict(rep), _files(dbs)
    both(run, tmp_path)


def test_peers_bootstrap_skips_sick_peer(tmp_path):
    def run(P, root):
        dbs, _ = _flushed_cluster(P, root)
        victim = dbs["i1"]
        _wipe_shard(victim, 0)
        peers = [_Sick(P, db) if name == "i2" else db for name, db in dbs.items()]
        stats = P.rep.peers_bootstrap(victim, peers, "default")
        assert stats["blocks"] >= 1
        assert P.rep.block_metadata(victim, "default", 0, T0) is not None
        return stats, _files(dbs)
    both(run, tmp_path)


# ---- TestRepairDemotionBranches --------------------------------------------


def _rd_cluster(P, root):
    return _flushed_cluster(P, root, ids=[b"rd-%02d" % i for i in range(16)])


def test_corrupt_block_mid_merge_demotes_and_heals_the_rest(tmp_path):
    def run(P, root):
        dbs, _ = _rd_cluster(P, root)
        handles = list(dbs.values())
        shard = next(sh for sh in range(4) if P.rep.block_metadata(handles[0], "default", sh, T0))
        dropped = _drop_series(P, handles[0], shard, 0)
        sick_inner = handles[2]
        handles[2] = _Sick(P, handles[2])
        rep = P.rep.repair_shard_block(handles, "default", shard, T0)
        assert rep["series_diff"] >= 1 and rep["blocks_missing"] == 1
        assert rep["repaired_replicas"] >= 1
        m0 = P.rep.block_metadata(handles[0], "default", shard, T0)
        m1 = P.rep.block_metadata(handles[1], "default", shard, T0)
        assert m0 == m1 and dropped in m0
        assert dict(P.fs.list_filesets(sick_inner.opts.root, "default", shard))[T0] == 0
        assert dict(P.fs.list_filesets(handles[0].opts.root, "default", shard))[T0] == 2
        return dict(rep), _files(dbs)
    both(run, tmp_path)


def test_missing_block_on_reachable_replica_gets_merged_write(tmp_path):
    def run(P, root):
        dbs, _ = _rd_cluster(P, root)
        handles = list(dbs.values())
        shard = next(sh for sh in range(4) if P.rep.block_metadata(handles[0], "default", sh, T0))
        _wipe_shard(handles[1], shard)
        rep = P.rep.repair_shard_block(handles, "default", shard, T0)
        assert rep["blocks_missing"] == 1 and rep["repaired_replicas"] >= 1
        assert P.rep.block_metadata(handles[1], "default", shard, T0) is not None
        assert P.rep.repair_shard_block(handles, "default", shard, T0).converged
        return dict(rep), _files(dbs)
    both(run, tmp_path)


def test_all_replicas_divergent_union_rewrites_every_one(tmp_path):
    def run(P, root):
        dbs, _ = _rd_cluster(P, root)
        handles = list(dbs.values())
        shard = next(sh for sh in range(4)
                     if len(P.rep.block_metadata(handles[0], "default", sh, T0) or ()) >= 3)
        dropped = [_drop_series(P, h, shard, k) for k, h in enumerate(handles)]
        assert len(set(dropped)) == 3
        rep = P.rep.repair_shard_block(handles, "default", shard, T0)
        assert rep["series_diff"] >= 3 and rep["repaired_replicas"] == 3
        metas = [P.rep.block_metadata(h, "default", shard, T0) for h in handles]
        assert metas[0] == metas[1] == metas[2] and all(d in metas[0] for d in dropped)
        assert P.rep.repair_shard_block(handles, "default", shard, T0).converged
        return dict(rep), _files(dbs)
    both(run, tmp_path)


def test_every_stream_dead_returns_without_write(tmp_path):
    def run(P, root):
        dbs, _ = _rd_cluster(P, root)
        handles = list(dbs.values())
        shard = next(sh for sh in range(4) if P.rep.block_metadata(handles[0], "default", sh, T0))
        _drop_series(P, handles[0], shard, 0)  # force the merge pass
        before = [P.rep.block_metadata(h, "default", shard, T0) for h in handles]
        rep = P.rep.repair_shard_block([_Sick(P, h) for h in handles], "default", shard, T0)
        assert rep["blocks_missing"] == 3 and rep["repaired_replicas"] == 0
        assert [P.rep.block_metadata(h, "default", shard, T0) for h in handles] == before
        return dict(rep), _files(dbs)
    both(run, tmp_path)


def test_local_corrupt_replica_typed_error_demotes(tmp_path):
    def run(P, root):
        dbs, _ = _rd_cluster(P, root)
        handles = list(dbs.values())
        victim = handles[2]
        shard = next(sh for sh in range(4)
                     if P.fs.list_filesets(victim.opts.root, "default", sh))
        dp = P.fs.fileset_path(victim.opts.root, "default", shard, T0, 0, "data")
        raw = bytearray(dp.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        dp.write_bytes(bytes(raw))
        rep = P.rep.repair_namespace(handles, "default")
        assert rep["blocks_missing"] >= 1 and rep["series_checked"] > 0
        return dict(rep), _files(dbs)
    both(run, tmp_path)


# ---- over RPC, across packages, and the scrubber ---------------------------


def test_replica_rejoining_from_its_commit_log_is_repaired_over_rpc(tmp_path):
    """A replica closed for the last scrapes and restarted on its own root
    replays its commit log, flushes a shorter block, and is rewritten with
    the union by ``repair_namespace`` over three ``RemoteDatabase``
    handles; a second pass finds the replicas converged."""
    def run(P, root):
        dbs = {f"i{k}": _mk_db(P, root, f"i{k}", commitlog=True) for k in range(3)}
        ids = [b"cl-%02d" % i for i in range(12)]
        p = P.pl.initial_placement([P.pl.Instance(i) for i in dbs], num_shards=4, rf=3)
        s = P.sess.ReplicatedSession(p, dbs)
        conns = dict(dbs)
        conns["i2"] = None
        s_down = P.sess.ReplicatedSession(p, conns)
        for k in range(10):
            if k == 2:
                dbs["i2"].close()
            t = np.full(len(ids), T0 + (k + 1) * 10 * SEC, np.int64)
            (s if k < 2 else s_down).write_batch("default", ids, t, np.arange(12.0) * k,
                                                 now_nanos=int(t[0]))
        dbs["i2"] = _mk_db(P, root, "i2", commitlog=True)
        boot = dbs["i2"].bootstrap()
        flush_at = T0 + BLOCK + P.db.NamespaceOptions().buffer_past_nanos + SEC
        for db in dbs.values():
            db.tick(flush_at)
        srvs = {i: P.rpc.serve_rpc_background(db) for i, db in dbs.items()}
        remotes = [P.rpc.RemoteDatabase(("127.0.0.1", srv.port), timeout_s=30.0)
                   for srv in srvs.values()]
        try:
            rep = P.rep.repair_namespace(remotes, "default", num_shards=4)
            rep2 = P.rep.repair_namespace(remotes, "default", num_shards=4)
        finally:
            for r in remotes:
                r.close()
            for srv in srvs.values():
                srv.shutdown()
                srv.server_close()
        assert rep["series_diff"] == len(ids) and rep2.converged
        reads = dbs["i2"].read_batch("default", ids, T0, T0 + BLOCK)
        assert all(len(x) == 10 for x in reads)
        return (boot["commitlog_replayed"], dict(rep), dict(rep2), reads, _files(dbs))
    both(run, tmp_path)


@pytest.mark.parametrize("healthy", ["jax", "torch"])
def test_repair_across_packages(tmp_path, healthy):
    """A replica of one package repaired over RPC from two of the other
    (the healthy pair wrote every point, the third missed some): the
    repaired volume is the bytes the healthy pair's package writes."""
    other = "torch" if healthy == "jax" else "jax"
    sides = {"i0": healthy, "i1": healthy, "i2": other}
    dbs = {i: _mk_db(PKGS[s], tmp_path, i) for i, s in sides.items()}
    ids = [b"x-%02d" % i for i in range(10)]
    for k in range(6):
        t = np.full(len(ids), T0 + (k + 1) * 10 * SEC, np.int64)
        v = np.round(np.sin(np.arange(len(ids)) + k) * 100, 2)
        for i, db in dbs.items():
            if i != "i2" or k < 3:
                db.write_batch("default", ids, t, v, now_nanos=int(t[0]))
    for db in dbs.values():
        db.tick(T0 + 2 * BLOCK)
    servers = {i: PKGS[s].rpc.serve_rpc_background(dbs[i]) for i, s in sides.items()}
    remotes = [PKGS[healthy].rpc.RemoteDatabase(("127.0.0.1", srv.port), timeout_s=30.0)
               for srv in servers.values()]
    try:
        rep = PKGS[healthy].rep.repair_namespace(remotes, "default", num_shards=4)
        rep2 = PKGS[other].rep.repair_namespace(
            [PKGS[other].rpc.RemoteDatabase(("127.0.0.1", srv.port), timeout_s=30.0)
             for srv in servers.values()], "default", num_shards=4)
    finally:
        for r in remotes:
            r.close()
        for srv in servers.values():
            srv.shutdown()
            srv.server_close()
    assert rep["series_diff"] == len(ids) and rep["repaired_replicas"] == 4
    assert rep2.converged
    for sh in range(4):
        metas = [db.block_metadata("default", sh, T0) for db in dbs.values()]
        assert metas[0] == metas[1] == metas[2]
    files = _files(dbs)
    assert files["i0"] == files["i1"]


def test_scrubber_heals_a_quarantined_volume_from_peers(tmp_path):
    def run(P, root):
        dbs, ids = _flushed_cluster(P, root)
        victim = dbs["i0"]
        shard = next(sh for sh in range(4) if P.fs.list_filesets(victim.opts.root, "default", sh))
        dp = P.fs.fileset_path(victim.opts.root, "default", shard, T0, 0, "data")
        raw = bytearray(dp.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        dp.write_bytes(bytes(raw))
        scrubber = P.scrub.Scrubber(victim, peers=[dbs["i1"], dbs["i2"]])
        stats = scrubber.run_once(budget=0, repair=True)
        assert stats["corrupt"] == 1 and stats["repaired"] == 1
        again = scrubber.run_once(budget=0, repair=True)
        reads = victim.read_batch("default", ids, T0, T0 + BLOCK)
        assert all(len(x) == 10 for x in reads)
        inv = [{k: e.get(k) for k in ("label", "namespace", "shard", "block_start", "volume")}
               for e in victim.quarantine_inventory()]
        return stats, again, reads, inv, _files(dbs)
    both(run, tmp_path)
