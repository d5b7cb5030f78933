"""m3_tpu_torch.cluster.topology, storage.migration and the Database's
ownership surface against the JAX package's on the CPU.

Each case of ``tests/test_topology.py`` runs once through each package
(the port's ``Database`` on ``device="cpu"``) on the same inputs: the
reference's assertions hold on both, and what each run observes
(views, placements, errors, counters, block metadata, the files on
disk) is equal between the two."""

import hashlib
import threading
import types

import numpy as np
import pytest

import m3_tpu.client.session as jsess
import m3_tpu.cluster.kv as jkv
import m3_tpu.cluster.placement as jpl
import m3_tpu.cluster.topology as jtopo
import m3_tpu.index.doc as jdoc
import m3_tpu.index.search as jsearch
import m3_tpu.server.rpc as jrpc
import m3_tpu.storage.database as jdb
import m3_tpu.storage.migration as jmig
import m3_tpu.storage.repair as jrep
import m3_tpu.x.fault as jfault
import m3_tpu_torch.client.session as tsess
import m3_tpu_torch.cluster.kv as tkv
import m3_tpu_torch.cluster.placement as tpl
import m3_tpu_torch.cluster.topology as ttopo
import m3_tpu_torch.index.doc as tdoc
import m3_tpu_torch.index.search as tsearch
import m3_tpu_torch.server.rpc as trpc
import m3_tpu_torch.storage.database as tdb
import m3_tpu_torch.storage.migration as tmig
import m3_tpu_torch.storage.repair as trep
import m3_tpu_torch.x.fault as tfault

SEC = 10**9
BLOCK = 2 * 3600 * SEC
T0 = (1_600_000_000 * SEC) // BLOCK * BLOCK
NSHARDS = 4

PKGS = {
    "jax": types.SimpleNamespace(kv=jkv, pl=jpl, topo=jtopo, db=jdb, sess=jsess, rpc=jrpc,
                                 mig=jmig, rep=jrep, doc=jdoc, search=jsearch, fault=jfault,
                                 dev={}),
    "torch": types.SimpleNamespace(kv=tkv, pl=tpl, topo=ttopo, db=tdb, sess=tsess, rpc=trpc,
                                   mig=tmig, rep=trep, doc=tdoc, search=tsearch, fault=tfault,
                                   dev={"device": "cpu"}),
}


def both(scenario, tmp_path=None):
    """Run ``scenario(P, root)`` through each package; the observations
    must be equal.  Returns them."""
    out = {}
    for side, P in PKGS.items():
        root = None
        if tmp_path is not None:
            root = tmp_path / side
            root.mkdir()
        out[side] = scenario(P, root)
    assert out["torch"] == out["jax"]
    return out["torch"]


def _mk_db(P, root, name, commitlog=False):
    return P.db.Database(
        P.db.DatabaseOptions(root=str(root / name), commitlog_enabled=commitlog),
        namespaces={"default": P.db.NamespaceOptions(num_shards=NSHARDS, slot_capacity=256,
                                                     sample_capacity=2048)}, **P.dev)


def _ids_for_shard(shard, n=3, tag=b"tp"):
    """n series ids that hash onto ``shard``."""
    out, i = [], 0
    while len(out) < n:
        sid = b"%s-%d" % (tag, i)
        if jdb.shard_for_id(sid, NSHARDS) == shard:
            out.append(sid)
        i += 1
    return out


def _write_all_shards(db, rounds=4):
    ids = [sid for s in range(NSHARDS) for sid in _ids_for_shard(s)]
    for k in range(rounds):
        t = np.full(len(ids), T0 + (k + 1) * 10 * SEC, np.int64)
        v = np.arange(len(ids), dtype=np.float64) + k
        db.write_batch("default", ids, t, v, now_nanos=int(t[0]))
    return ids


def _digests(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "data").rglob("*")) if p.is_file()}


def _states(p) -> dict:
    return {iid: {s: (a.state.value, a.source_id) for s, a in sorted(i.shards.items())}
            for iid, i in sorted(p.instances.items())}


# ---------------------------------------------------------------------------
# TopologyWatcher
# ---------------------------------------------------------------------------


def test_no_placement_means_own_everything():
    def run(P, _):
        w = P.topo.TopologyWatcher(P.kv.KVStore(), "i0")
        v = w.view()
        assert v.placement is None and v.version == 0
        assert v.owned_shards() is None and not v.in_placement
        w.close()
        return v.version
    both(run)


def test_view_tracks_versions_and_my_shards():
    def run(P, _):
        kv = P.kv.KVStore()
        ps = P.pl.PlacementService(kv)
        w = P.topo.TopologyWatcher(kv, "i1")
        seen = []
        w.on_change(lambda view: seen.append(view.version))
        ps.set(P.pl.initial_placement([P.pl.Instance("i0"), P.pl.Instance("i1")],
                                      num_shards=NSHARDS, rf=2))
        v = w.view()
        assert v.in_placement and v.owned_shards() == frozenset(range(NSHARDS))
        assert seen == [1]
        ps.update(lambda p: P.pl.add_instance(p, P.pl.Instance("i2")))
        assert w.view().version == 2 and seen == [1, 2]
        out = (seen, {s.value: w.view().shards_in_state(s) for s in P.pl.ShardState})
        w.close()
        return out
    both(run)


def test_not_in_placement_owns_nothing():
    def run(P, _):
        kv = P.kv.KVStore()
        P.pl.PlacementService(kv).set(
            P.pl.initial_placement([P.pl.Instance("i0")], num_shards=NSHARDS, rf=1))
        w = P.topo.TopologyWatcher(kv, "ghost")
        v = w.view()
        assert v.placement is not None and not v.in_placement
        assert v.owned_shards() == frozenset()
        w.close()
        return sorted(v.owned_shards())
    both(run)


def test_malformed_placement_keeps_last_good_view():
    def run(P, _):
        kv = P.kv.KVStore()
        ps = P.pl.PlacementService(kv)
        ps.set(P.pl.initial_placement([P.pl.Instance("i0")], num_shards=NSHARDS, rf=1))
        w = P.topo.TopologyWatcher(kv, "i0")
        assert w.view().version == 1
        kv.set("placement", b"{not json")  # corrupted control-plane write
        assert w.view().version == 1       # the previous good view survives
        out = sorted(w.view().owned_shards())
        w.close()
        return out
    both(run)


def test_listener_replay_on_register():
    def run(P, _):
        kv = P.kv.KVStore()
        P.pl.PlacementService(kv).set(
            P.pl.initial_placement([P.pl.Instance("i0")], num_shards=NSHARDS, rf=1))
        w = P.topo.TopologyWatcher(kv, "i0")
        seen = []
        w.on_change(lambda view: seen.append(view.version))
        assert seen == [1]  # current state replayed to the late listener
        w.close()
        return seen
    both(run)


# ---------------------------------------------------------------------------
# Database ownership
# ---------------------------------------------------------------------------


def test_write_to_unowned_shard_raises_typed(tmp_path):
    def run(P, root):
        db = _mk_db(P, root, "own")
        db.set_shard_ownership("default", {0, 1})
        db.write_batch("default", _ids_for_shard(0, 1), np.array([T0 + SEC]),
                       np.array([1.0]), now_nanos=T0 + SEC)
        with pytest.raises(P.db.ShardNotOwnedError) as ei:
            db.write_batch("default", _ids_for_shard(2, 1), np.array([T0 + SEC]),
                           np.array([1.0]), now_nanos=T0 + SEC)
        assert ei.value.shard == 2 and ei.value.namespace == "default"
        db.close()
        return str(ei.value)
    both(run, tmp_path)


def test_mixed_batch_partial_accepts_owned_shards(tmp_path):
    def run(P, root):
        db = _mk_db(P, root, "mix")
        db.set_shard_ownership("default", {0})
        ids = _ids_for_shard(0, 1) + _ids_for_shard(3, 1)
        res = db.write_batch("default", ids, np.full(2, T0 + SEC, np.int64),
                             np.array([1.0, 2.0]), now_nanos=T0 + SEC)
        assert res.not_owned == 1 and list(res.accepted) == [True, False]
        assert db.read("default", ids[0], T0, T0 + BLOCK) == [(T0 + SEC, 1.0)]
        with pytest.raises(P.db.ShardNotOwnedError):
            db.read("default", ids[1], T0, T0 + BLOCK)
        db.close()
        return int(res), res.not_owned, list(res.accepted)
    both(run, tmp_path)


def test_new_namespace_inherits_ownership_template(tmp_path):
    def run(P, root):
        db = _mk_db(P, root, "tpl")
        db.set_shard_ownership("default", {0, 1})
        db.set_ownership_template(NSHARDS, {0, 1})
        ns = db.ensure_namespace("agg_5m", P.db.NamespaceOptions(
            num_shards=NSHARDS, slot_capacity=256, sample_capacity=2048))
        assert ns.owned == frozenset({0, 1})
        with pytest.raises(P.db.ShardNotOwnedError) as ei:
            db.write_batch("agg_5m", _ids_for_shard(2, 1), np.array([T0 + SEC]),
                           np.array([1.0]), now_nanos=T0 + SEC)
        # a differently sharded namespace is outside the placement's
        # shard space: it stays own-all
        ns2 = db.ensure_namespace("other", P.db.NamespaceOptions(
            num_shards=8, slot_capacity=256, sample_capacity=2048))
        assert ns2.owned is None
        db.close()
        return sorted(ns.owned), str(ei.value)
    both(run, tmp_path)


def test_read_answers_only_owned_shards(tmp_path):
    def run(P, root):
        db = _mk_db(P, root, "rd")
        ids = _write_all_shards(db)
        db.set_shard_ownership("default", {0})
        got = [db.read("default", _ids_for_shard(0, 1)[0], T0, T0 + BLOCK)]
        with pytest.raises(P.db.ShardNotOwnedError):
            db.read("default", _ids_for_shard(1, 1)[0], T0, T0 + BLOCK)
        db.set_shard_ownership("default", None)  # None: own everything again
        got.append(db.read("default", _ids_for_shard(1, 1)[0], T0, T0 + BLOCK))
        assert all(got) and ids
        db.close()
        return got
    both(run, tmp_path)


def test_write_block_rejected_on_unowned_shard(tmp_path):
    def run(P, root):
        db = _mk_db(P, root, "wb")
        db.set_shard_ownership("default", {0})
        with pytest.raises(P.db.ShardNotOwnedError) as ei:
            db.write_block("default", 1, T0, [(b"x", b"seg")])
        db.close()
        return str(ei.value), _digests(root / "wb") if (root / "wb" / "data").exists() else {}
    both(run, tmp_path)


def test_tagged_write_unowned_shard_skips_index_too(tmp_path):
    def run(P, root):
        db = _mk_db(P, root, "tag")
        db.set_shard_ownership("default", {0})
        doc = P.doc.Document.from_tags(_ids_for_shard(1, 1)[0], {b"__name__": b"m"})
        with pytest.raises(P.db.ShardNotOwnedError):
            db.write_tagged_batch("default", [doc], np.array([T0 + SEC]), np.array([1.0]),
                                  now_nanos=T0 + SEC)
        got = db.query_ids("default", P.search.All(), T0, T0 + BLOCK)
        assert got == []
        db.close()
        return len(got)
    both(run, tmp_path)


def test_wal_replay_scoped_to_owned_shards(tmp_path):
    def run(P, root):
        db = _mk_db(P, root, "wal", commitlog=True)
        _write_all_shards(db)
        db.close()
        # restart as an ex-donor that now owns only shards {0, 1}
        db2 = _mk_db(P, root, "wal", commitlog=True)
        db2.set_shard_ownership("default", {0, 1})
        boot = db2.bootstrap()
        got = db2.read("default", _ids_for_shard(0, 1)[0], T0, T0 + BLOCK)
        assert got
        with pytest.raises(P.db.ShardNotOwnedError):
            db2.read("default", _ids_for_shard(2, 1)[0], T0, T0 + BLOCK)
        sh = db2.namespaces["default"].shards[2]
        assert not sh.buffer.open_blocks and not sh.buffer.cold
        db2.close()
        return got, {k: v for k, v in boot.items() if not k.endswith("_s")}
    both(run, tmp_path)


def test_drop_shard_deletes_filesets_and_buffers(tmp_path):
    def run(P, root):
        db = _mk_db(P, root, "drop")
        _write_all_shards(db)
        db.tick(T0 + 2 * BLOCK)  # flush filesets
        assert db.list_block_filesets("default", 1)
        removed = db.drop_shard("default", 1)
        assert removed >= 1 and db.list_block_filesets("default", 1) == []
        sh = db.namespaces["default"].shards[1]
        assert not sh.buffer.open_blocks and not sh.flushed_blocks
        # the fresh shard takes writes again, on the database's device
        db.write_batch("default", _ids_for_shard(1, 1), np.array([T0 + BLOCK + SEC]),
                       np.array([7.0]), now_nanos=T0 + BLOCK + SEC)
        after = db.read("default", _ids_for_shard(1, 1)[0], T0, T0 + 2 * BLOCK)
        db.close()
        return removed, after, _digests(root / "drop")
    both(run, tmp_path)


# ---------------------------------------------------------------------------
# shard-state routing matrix (session side)
# ---------------------------------------------------------------------------


def _matrix_placement(P, shard=0):
    """One shard in all three states: AVAILABLE on ia, LEAVING on il,
    INITIALIZING on ii (streaming from il)."""
    S, A = P.pl.ShardState, P.pl.ShardAssignment
    insts = {"ia": P.pl.Instance("ia", shards={shard: A(shard, S.AVAILABLE)}),
             "il": P.pl.Instance("il", shards={shard: A(shard, S.LEAVING)}),
             "ii": P.pl.Instance("ii", shards={shard: A(shard, S.INITIALIZING, "il")})}
    return P.pl.Placement(insts, num_shards=1, replica_factor=2, version=3)


def test_writes_fan_to_I_A_L_reads_to_A_L_only():
    def run(P, _):
        sess = P.sess.ReplicatedSession(_matrix_placement(P), {"ia": None, "il": None,
                                                               "ii": None})
        w = sorted(sess._replicas_for_shard(0, for_read=False))
        r = sorted(sess._replicas_for_shard(0, for_read=True))
        assert w == ["ia", "ii", "il"] and r == ["ia", "il"]
        return w, r
    both(run)


def test_mark_available_clears_the_donors_leaving_entry():
    def run(P, _):
        p2 = P.pl.mark_available(_matrix_placement(P), "ii", 0)
        assert p2.instances["ii"].shards[0].state == P.pl.ShardState.AVAILABLE
        assert 0 not in p2.instances["il"].shards  # the donor's entry is gone
        sess = P.sess.ReplicatedSession(p2, {"ia": None, "il": None, "ii": None})
        assert sess._replicas_for_shard(0, for_read=True) == ["ia", "ii"]
        return p2.to_json()
    both(run)


def test_remove_instance_when_leaver_is_already_dead():
    def run(P, _):
        p = P.pl.initial_placement([P.pl.Instance(f"i{k}") for k in range(3)],
                                   num_shards=NSHARDS, rf=2)
        p2 = P.pl.remove_instance(p, "i0")
        assert all(a.state == P.pl.ShardState.LEAVING for a in p2.instances["i0"].shards.values())
        takers = [(iid, s) for iid, inst in p2.instances.items()
                  for s, a in inst.shards.items() if a.state == P.pl.ShardState.INITIALIZING]
        assert takers and all(p2.instances[i].shards[s].source_id == "i0" for i, s in takers)
        for iid, s in takers:
            p2 = P.pl.mark_available(p2, iid, s)
        p3 = P.pl.forget_instance(p2, "i0")
        assert "i0" not in p3.instances
        return p3.to_json()
    both(run)


def test_forget_refuses_while_instance_owns_live_shards():
    def run(P, _):
        p = P.pl.initial_placement([P.pl.Instance("i0"), P.pl.Instance("i1")], num_shards=2,
                                   rf=2)
        with pytest.raises(ValueError) as ei:
            P.pl.forget_instance(p, "i0")
        return str(ei.value)
    both(run)


# ---------------------------------------------------------------------------
# the typed error over the wire + routing-miss accounting
# ---------------------------------------------------------------------------


def test_remote_rejection_arrives_typed(tmp_path):
    def run(P, root):
        db = _mk_db(P, root, "wire")
        db.set_shard_ownership("default", {0})
        srv = P.rpc.serve_rpc_background(db)
        remote = P.rpc.RemoteDatabase(("127.0.0.1", srv.port), timeout_s=30.0)
        sid = _ids_for_shard(3, 1)[0]
        try:
            with pytest.raises(P.db.ShardNotOwnedError) as ei:
                remote.write_batch("default", [sid], np.array([T0 + SEC]), np.array([1.0]),
                                   now_nanos=T0 + SEC)
            assert ei.value.shard == 3 and ei.value.namespace == "default"
            with pytest.raises(P.db.ShardNotOwnedError) as ei2:
                remote.read("default", sid, T0, T0 + BLOCK)
        finally:
            remote.close()
            srv.shutdown()
            srv.server_close()
            db.close()
        return str(ei.value), str(ei2.value)
    both(run, tmp_path)


def test_session_counts_stale_placement_as_routing_miss(tmp_path):
    def run(P, root):
        db = _mk_db(P, root, "stale")
        db.set_shard_ownership("default", set())  # owns nothing anymore
        p = P.pl.initial_placement([P.pl.Instance("i0")], num_shards=NSHARDS, rf=1)
        sess = P.sess.ReplicatedSession(p, {"i0": db})  # stale: still routes to i0
        with pytest.raises(P.sess.ConsistencyError) as ei:
            sess.write_batch("default", _ids_for_shard(0, 1), np.array([T0 + SEC]),
                             np.array([1.0]), now_nanos=T0 + SEC)
        assert sess.routing_misses == 1 and "routing miss" in str(ei.value)
        db.close()
        return sess.routing_misses, str(ei.value)
    both(run, tmp_path)


def test_write_racing_cutover_succeeds_without_caller_retry(tmp_path):
    def run(P, root):
        kv = P.kv.KVStore()
        ps = P.pl.PlacementService(kv)
        dbs = {"i0": _mk_db(P, root, "old"), "i1": _mk_db(P, root, "new")}
        p1 = P.pl.initial_placement([P.pl.Instance("i0")], num_shards=NSHARDS, rf=1)
        ps.set(p1)
        sess = P.sess.ReplicatedSession.dynamic(
            kv, lambda inst: dbs[inst.id], write_level=P.sess.ConsistencyLevel.MAJORITY)
        # the undelivered watch: detach it, then cut the whole topology
        # over to i1 (placement v2 and node-side ownership)
        kv.unwatch("placement", sess._on_change)
        p2 = P.pl.replace_instance(p1, "i0", P.pl.Instance("i1"))
        for s in range(NSHARDS):
            p2 = P.pl.mark_available(p2, "i1", s)
        ps.set(p2)
        dbs["i0"].set_shard_ownership("default", set())
        dbs["i1"].set_shard_ownership("default", set(range(NSHARDS)))
        assert sess.placement.instances.keys() == {"i0"}  # genuinely stale
        sid = _ids_for_shard(0, 1)[0]
        sess.write_batch("default", [sid], np.array([T0 + SEC]), np.array([2.5]),
                         now_nanos=T0 + SEC)  # no raise
        assert sess.routing_misses >= 1
        assert sess.topology_version == kv.get("placement").version
        assert set(sess.connections) == {"i1"}
        got = dbs["i1"].read("default", sid, T0, T0 + BLOCK)
        assert got == [(T0 + SEC, 2.5)]
        sess.close()
        for db in dbs.values():
            db.close()
        return sess.routing_misses, sess.topology_version, got
    both(run, tmp_path)


# ---------------------------------------------------------------------------
# the migrator lifecycle
# ---------------------------------------------------------------------------


def _drive_until(migrators, ps, pred, max_ticks=12):
    for _ in range(max_ticks):
        for m in migrators:
            m.tick()
        p = ps.get()
        if pred(p):
            return p
    return ps.get()


def _no_initializing(P):
    return lambda p: not any(a.state == P.pl.ShardState.INITIALIZING
                             for inst in p.instances.values() for a in inst.shards.values())


def _bootstrap_pair(P, root, kv):
    """Two nodes owning everything (rf=2), a flushed corpus, watchers and
    migrators wired over local handles."""
    ps = P.pl.PlacementService(kv)
    dbs = {"i0": _mk_db(P, root, "i0"), "i1": _mk_db(P, root, "i1")}
    ps.set(P.pl.initial_placement([P.pl.Instance(iid) for iid in dbs], num_shards=NSHARDS,
                                  rf=2))

    def resolve(inst):
        db = dbs.get(inst.id)
        if db is None:
            raise ConnectionError(f"{inst.id} is dead")
        return db

    rig = {iid: P.mig.ShardMigrator(db, P.topo.TopologyWatcher(kv, iid),
                                    P.pl.PlacementService(kv), resolve=resolve, grace_ticks=1)
           for iid, db in dbs.items()}
    ids = _write_all_shards(dbs["i0"])
    for sid in ids:  # mirror onto the replica
        pts = dbs["i0"].read("default", sid, T0, T0 + BLOCK)
        t = np.array([p[0] for p in pts], np.int64)
        v = np.array([p[1] for p in pts], np.float64)
        dbs["i1"].write_batch("default", [sid] * len(pts), t, v, now_nanos=int(t.max()))
    for db in dbs.values():
        db.tick(T0 + 2 * BLOCK)
    return ps, dbs, rig, resolve, ids


def _close(dbs, rig):
    for m in rig.values():
        m.close()
    for db in dbs.values():
        db.close()


def test_add_instance_streams_cuts_over_and_donors_drop(tmp_path):
    def run(P, root):
        kv = P.kv.KVStore()
        ps, dbs, rig, resolve, ids = _bootstrap_pair(P, root, kv)
        dbs["i2"] = _mk_db(P, root, "i2")
        rig["i2"] = P.mig.ShardMigrator(dbs["i2"], P.topo.TopologyWatcher(kv, "i2"),
                                        P.pl.PlacementService(kv), resolve=resolve,
                                        grace_ticks=1)
        ps.update(lambda p: P.pl.add_instance(p, P.pl.Instance("i2")))
        moved = [s for s, a in ps.get().instances["i2"].shards.items()
                 if a.state == P.pl.ShardState.INITIALIZING]
        donors = {s: ps.get().instances["i2"].shards[s].source_id for s in moved}
        assert moved
        p = _drive_until(list(rig.values()), ps, _no_initializing(P))
        for s in moved:
            assert p.instances["i2"].shards[s].state == P.pl.ShardState.AVAILABLE
            assert s not in p.instances[donors[s]].shards
        metas = {}
        for s in moved:  # compared BEFORE the donors' grace drop
            got = dbs["i2"].block_metadata("default", s, T0)
            assert got and got == dbs[donors[s]].block_metadata("default", s, T0)
            metas[s] = sorted(got.items())
        status = rig["i2"].status()
        for _ in range(4):
            for m in rig.values():
                m.tick()
        for s in moved:
            donor = dbs[donors[s]]
            assert donor.list_block_filesets("default", s) == []
            with pytest.raises(P.db.ShardNotOwnedError):
                donor.read("default", _ids_for_shard(s, 1)[0], T0, T0 + BLOCK)
            for sid in _ids_for_shard(s):
                assert dbs["i2"].read("default", sid, T0, T0 + BLOCK)
        files = {iid: _digests(root / iid) for iid in dbs}
        _close(dbs, rig)
        return moved, donors, metas, _states(p), status, files
    both(run, tmp_path)


def test_replace_with_unreachable_donor_falls_back(tmp_path):
    def run(P, root):
        kv = P.kv.KVStore()
        ps, dbs, rig, resolve, ids = _bootstrap_pair(P, root, kv)
        rig.pop("i0").close()
        dbs.pop("i0").close()  # resolve("i0") now raises ConnectionError
        dbs["i9"] = _mk_db(P, root, "i9")
        rig["i9"] = P.mig.ShardMigrator(dbs["i9"], P.topo.TopologyWatcher(kv, "i9"),
                                        P.pl.PlacementService(kv), resolve=resolve,
                                        grace_ticks=1)
        ps.update(lambda p: P.pl.replace_instance(p, "i0", P.pl.Instance("i9")))
        p = _drive_until(list(rig.values()), ps, _no_initializing(P))
        assert _no_initializing(P)(p)
        assert all(a.state == P.pl.ShardState.AVAILABLE
                   for a in p.instances["i9"].shards.values())
        for s in range(NSHARDS):
            got = dbs["i9"].block_metadata("default", s, T0)
            assert got and got == dbs["i1"].block_metadata("default", s, T0)
        files = _digests(root / "i9")
        _close(dbs, rig)
        return _states(p), files
    both(run, tmp_path)


def test_stream_faultpoint_corruption_is_verify_rejected(tmp_path):
    def run(P, root):
        kv = P.kv.KVStore()
        ps, dbs, rig, resolve, ids = _bootstrap_pair(P, root, kv)
        dbs["i2"] = _mk_db(P, root, "i2")
        m2 = rig["i2"] = P.mig.ShardMigrator(dbs["i2"], P.topo.TopologyWatcher(kv, "i2"),
                                             P.pl.PlacementService(kv), resolve=resolve,
                                             grace_ticks=1)
        ps.update(lambda p: P.pl.add_instance(p, P.pl.Instance("i2")))
        moved = [s for s, a in ps.get().instances["i2"].shards.items()
                 if a.state == P.pl.ShardState.INITIALIZING]
        try:
            with P.fault.armed("topology.stream", "corrupt", p=1.0, seed=5):
                stats = m2.tick()
            assert stats["verify_failures"] >= 1 and stats["blocks_streamed"] == 0
            for s in moved:
                assert dbs["i2"].list_block_filesets("default", s) == []
            assert not _no_initializing(P)(ps.get())
        finally:
            P.fault.disarm()
        p = _drive_until(list(rig.values()), ps, _no_initializing(P))
        assert _no_initializing(P)(p)
        for s in moved:
            got = dbs["i2"].block_metadata("default", s, T0)
            assert got and got == dbs["i0"].block_metadata("default", s, T0)
        _close(dbs, rig)
        return stats, _states(p)
    both(run, tmp_path)


def test_remove_dead_leaver_rehomes_shards_to_survivors(tmp_path):
    def run(P, root):
        kv = P.kv.KVStore()
        ps, dbs, rig, resolve, ids = _bootstrap_pair(P, root, kv)
        dbs["i2"] = _mk_db(P, root, "i2")
        rig["i2"] = P.mig.ShardMigrator(dbs["i2"], P.topo.TopologyWatcher(kv, "i2"),
                                        P.pl.PlacementService(kv), resolve=resolve,
                                        grace_ticks=1)
        ps.update(lambda p: P.pl.add_instance(p, P.pl.Instance("i2")))
        _drive_until(list(rig.values()), ps, _no_initializing(P))
        rig.pop("i0").close()
        dbs.pop("i0").close()
        ps.update(lambda p: P.pl.remove_instance(p, "i0"))
        p = _drive_until(list(rig.values()), ps, _no_initializing(P))
        assert _no_initializing(P)(p)
        leaver = p.instances.get("i0")
        assert leaver is None or not leaver.shards or all(
            a.state == P.pl.ShardState.LEAVING for a in leaver.shards.values())
        for s in range(NSHARDS):
            owners = [i.id for i in p.instances_for_shard(s)
                      if i.shards[s].state == P.pl.ShardState.AVAILABLE]
            assert len(owners) == 2 and "i0" not in owners
        if "i0" in p.instances:
            p = ps.update(lambda pp: P.pl.forget_instance(pp, "i0"))
            assert "i0" not in p.instances
        _close(dbs, rig)
        return _states(p)
    both(run, tmp_path)


def test_reacquired_shard_cancels_pending_drop(tmp_path):
    def run(P, root):
        kv = P.kv.KVStore()
        ps = P.pl.PlacementService(kv)
        db = _mk_db(P, root, "i0")
        ps.set(P.pl.initial_placement([P.pl.Instance("i0")], num_shards=NSHARDS, rf=1))
        w = P.topo.TopologyWatcher(kv, "i0")
        m = P.mig.ShardMigrator(db, w, P.pl.PlacementService(kv), resolve=lambda inst: db,
                                grace_ticks=3)
        _write_all_shards(db)
        db.tick(T0 + 2 * BLOCK)

        def edit(p, give):
            insts = {iid: P.pl.Instance(i.id, i.isolation_group, i.weight, dict(i.shards),
                                        i.shard_set_id, i.endpoint)
                     for iid, i in p.instances.items()}
            if give:
                insts["i0"].shards[0] = P.pl.ShardAssignment(0, P.pl.ShardState.AVAILABLE)
            else:
                del insts["i0"].shards[0]
            return P.pl.Placement(insts, p.num_shards, p.replica_factor, p.version + 1)

        ps.update(lambda p: edit(p, False))
        first = m.tick()  # the grace countdown starts (3 ticks)
        pending = m.status()["pending_drops"]
        ps.update(lambda p: edit(p, True))
        for _ in range(5):
            m.tick()
        assert db.list_block_filesets("default", 0)  # the data survived
        got = db.read("default", _ids_for_shard(0, 1)[0], T0, T0 + BLOCK)
        assert got
        m.close()
        w.close()
        db.close()
        return first, pending, got
    both(run, tmp_path)


# ---------------------------------------------------------------------------
# placement-scoped peers bootstrap
# ---------------------------------------------------------------------------


def test_non_owned_shards_stay_empty_on_disk(tmp_path):
    def run(P, root):
        src = _mk_db(P, root, "src")
        _write_all_shards(src)
        src.tick(T0 + 2 * BLOCK)
        dst = _mk_db(P, root, "dst")
        dst.set_shard_ownership("default", {0, 1})
        out = P.rep.peers_bootstrap(dst, [src], "default")
        assert out["blocks"] >= 2
        for s in (0, 1):
            assert dst.list_block_filesets("default", s)
        for s in (2, 3):
            assert dst.list_block_filesets("default", s) == []
            shard_dir = root / "dst" / "data" / "default" / str(s)
            assert not shard_dir.exists() or not any(shard_dir.iterdir())
        dst2 = _mk_db(P, root, "dst2")
        out2 = P.rep.peers_bootstrap(dst2, [src], "default", shards={3})
        assert out2["blocks"] >= 1 and dst2.list_block_filesets("default", 3)
        assert dst2.list_block_filesets("default", 0) == []
        for db in (src, dst, dst2):
            db.close()
        return out, out2, _digests(root / "dst"), _digests(root / "dst2")
    both(run, tmp_path)


# ---------------------------------------------------------------------------
# PlacementService.update CAS retry
# ---------------------------------------------------------------------------


def test_retries_version_conflict_once_then_lands():
    def run(P, _):
        kv = P.kv.KVStore()
        ps = P.pl.PlacementService(kv)
        ps.set(P.pl.initial_placement([P.pl.Instance("i0")], num_shards=2, rf=1))
        real_cas = kv.check_and_set

        def flaky_cas(key, expect, data):
            # a competing writer slips in between update()'s get and its
            # CAS once; our CAS then conflicts and must retry
            kv.check_and_set = real_cas
            real_cas(key, expect, ps.get().to_json())
            return real_cas(key, expect, data)

        kv.check_and_set = flaky_cas
        p2 = ps.update(lambda p: P.pl.add_instance(p, P.pl.Instance("i1")))
        assert "i1" in p2.instances and kv.get("placement").version == 3
        return kv.get("placement").data
    both(run)


def test_mutate_errors_do_not_retry():
    def run(P, _):
        kv = P.kv.KVStore()
        ps = P.pl.PlacementService(kv)
        ps.set(P.pl.initial_placement([P.pl.Instance("i0")], num_shards=2, rf=1))
        calls = {"n": 0}

        def bad_mutate(p):
            calls["n"] += 1
            raise ValueError("no such instance")

        with pytest.raises(ValueError, match="no such instance"):
            ps.update(bad_mutate)
        assert calls["n"] == 1
        return calls["n"]
    both(run)


def test_concurrent_updates_both_land():
    def run(P, _):
        kv = P.kv.KVStore()
        ps = P.pl.PlacementService(kv)
        ps.set(P.pl.initial_placement([P.pl.Instance("i0")], num_shards=2, rf=1))
        barrier = threading.Barrier(2, timeout=10)
        real_cas = kv.check_and_set
        first_two = {"n": 0}
        lock = threading.Lock()

        def synced_cas(key, expect, data):
            with lock:
                first_two["n"] += 1
                n = first_two["n"]
            if n <= 2:
                barrier.wait()  # both threads read the same base version
            return real_cas(key, expect, data)

        kv.check_and_set = synced_cas
        errs = []

        def add(iid):
            try:
                ps.update(lambda p: P.pl.add_instance(p, P.pl.Instance(iid)))
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=add, args=(iid,)) for iid in ("ia", "ib")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
        assert not any(t.is_alive() for t in threads) and not errs
        final = ps.get()
        assert {"ia", "ib"} <= set(final.instances)
        return sorted(final.instances)
    both(run)
