"""m3_tpu_torch.client.session against m3_tpu.client.session on the CPU.

The session cases of ``tests/test_replication.py`` (quorum levels with
replicas down, reads merged across replicas, node replace under
sustained MAJORITY writes through ``ReplicatedSession.dynamic``) run
once through each package, the port's ``Database`` on ``device="cpu"``;
the reference's assertions hold on both and every observation (errors,
reads, routing, files) is equal.  Beside them: the client defaults,
``fetch_batch``/``query_ids``/``fetch_tagged``, the per-replica read
breakers, the write retrier and deadlines in the fan-out."""

import hashlib
import types

import numpy as np
import pytest

import m3_tpu.client as jclient
import m3_tpu.client.session as jsess
import m3_tpu.cluster.kv as jkv
import m3_tpu.cluster.placement as jpl
import m3_tpu.index.doc as jdoc
import m3_tpu.index.search as jsearch
import m3_tpu.query.engine as jengine
import m3_tpu.query.storage_adapter as jadapter
import m3_tpu.server.rpc as jrpc
import m3_tpu.storage.database as jdb
import m3_tpu.storage.repair as jrep
import m3_tpu.x.deadline as jdl
import m3_tpu.x.retry as jretry
import m3_tpu_torch.client as tclient
import m3_tpu_torch.client.session as tsess
import m3_tpu_torch.cluster.kv as tkv
import m3_tpu_torch.cluster.placement as tpl
import m3_tpu_torch.index.doc as tdoc
import m3_tpu_torch.index.search as tsearch
import m3_tpu_torch.query.block as tblock
import m3_tpu_torch.query.engine as tengine
import m3_tpu_torch.query.storage_adapter as tadapter
import m3_tpu_torch.server.rpc as trpc
import m3_tpu_torch.storage.database as tdb
import m3_tpu_torch.storage.repair as trep
import m3_tpu_torch.x.deadline as tdl
import m3_tpu_torch.x.retry as tretry

SEC = 10**9
HOUR = 3600 * SEC
BLOCK = 2 * HOUR
T0 = (1_600_000_000 * SEC) // BLOCK * BLOCK

PKGS = {
    "jax": types.SimpleNamespace(client=jclient, sess=jsess, kv=jkv, pl=jpl, doc=jdoc,
                                 search=jsearch, rpc=jrpc, db=jdb, rep=jrep, dl=jdl,
                                 retry=jretry, dev={}),
    "torch": types.SimpleNamespace(client=tclient, sess=tsess, kv=tkv, pl=tpl, doc=tdoc,
                                   search=tsearch, rpc=trpc, db=tdb, rep=trep, dl=tdl,
                                   retry=tretry, dev={"device": "cpu"}),
}


def both(scenario, tmp_path=None):
    out = {}
    for side, P in PKGS.items():
        root = None
        if tmp_path is not None:
            root = tmp_path / side
            root.mkdir()
        out[side] = scenario(P, root)
    assert out["torch"] == out["jax"]
    return out["torch"]


def _mk_db(P, root, name):
    return P.db.Database(
        P.db.DatabaseOptions(root=str(root / name), commitlog_enabled=False),
        namespaces={"default": P.db.NamespaceOptions(num_shards=4, slot_capacity=256,
                                                     sample_capacity=2048)}, **P.dev)


def _cluster(P, root, n=3):
    """n replica databases and a placement where every instance owns every
    shard (RF = n)."""
    dbs = {f"i{k}": _mk_db(P, root, f"i{k}") for k in range(n)}
    return P.pl.initial_placement([P.pl.Instance(iid) for iid in dbs], num_shards=4, rf=n), dbs


def _write_corpus(target, ids=None, n_pts=10):
    ids = ids or [b"series-%d" % i for i in range(8)]
    for k in range(n_pts):
        t = np.full(len(ids), T0 + (k + 1) * 10 * SEC, np.int64)
        v = np.arange(len(ids), dtype=np.float64) + k
        target.write_batch("default", ids, t, v, now_nanos=int(t[0]))
    return ids


def _close(dbs):
    for db in dbs.values():
        db.close()


def test_client_exports_and_defaults():
    for P in PKGS.values():
        assert P.client.ReplicatedSession is P.sess.ReplicatedSession
    CL = tsess.ConsistencyLevel
    assert [c.value for c in CL] == [c.value for c in jsess.ConsistencyLevel]
    assert [(CL(c.value).required(n), CL(c.value).strict) for c in jsess.ConsistencyLevel
            for n in (1, 2, 3, 5)] == [(c.required(n), c.strict)
                                       for c in jsess.ConsistencyLevel for n in (1, 2, 3, 5)]
    s = tsess.ReplicatedSession(tpl.initial_placement([tpl.Instance("i0")], 1, 1), {"i0": None})
    # M3's client defaults: writes at MAJORITY, reads at UNSTRICT_MAJORITY
    assert s.write_level is CL.MAJORITY and s.read_level is CL.UNSTRICT_MAJORITY
    e = tsess.ConsistencyError("write", 1, 2, ["i1: down"])
    assert str(e) == str(jsess.ConsistencyError("write", 1, 2, ["i1: down"]))


def test_write_majority_with_one_down(tmp_path):
    def run(P, root):
        p, dbs = _cluster(P, root)
        conns = dict(dbs)
        conns["i2"] = None  # down
        s = P.sess.ReplicatedSession(p, conns, write_level=P.sess.ConsistencyLevel.MAJORITY)
        _write_corpus(s)
        got = [dbs[i].read("default", b"series-0", T0, T0 + BLOCK) for i in dbs]
        assert got[0] and got[1] and not got[2]
        _close(dbs)
        return got
    both(run, tmp_path)


def test_write_all_fails_with_one_down(tmp_path):
    def run(P, root):
        p, dbs = _cluster(P, root)
        conns = dict(dbs)
        conns["i1"] = None
        s = P.sess.ReplicatedSession(p, conns, write_level=P.sess.ConsistencyLevel.ALL)
        with pytest.raises(P.sess.ConsistencyError) as e:
            _write_corpus(s)
        _close(dbs)
        return str(e.value)
    both(run, tmp_path)


def test_write_one_succeeds_with_two_down(tmp_path):
    def run(P, root):
        p, dbs = _cluster(P, root)
        conns = dict(dbs)
        conns["i1"] = conns["i2"] = None
        s = P.sess.ReplicatedSession(p, conns, write_level=P.sess.ConsistencyLevel.ONE)
        _write_corpus(s)
        got = dbs["i0"].read("default", b"series-0", T0, T0 + BLOCK)
        assert got
        _close(dbs)
        return got
    both(run, tmp_path)


def test_majority_fails_with_two_down(tmp_path):
    def run(P, root):
        p, dbs = _cluster(P, root)
        conns = dict(dbs)
        conns["i1"] = conns["i2"] = None
        s = P.sess.ReplicatedSession(p, conns, write_level=P.sess.ConsistencyLevel.MAJORITY)
        with pytest.raises(P.sess.ConsistencyError) as e:
            _write_corpus(s)
        _close(dbs)
        return e.value.got, e.value.need, str(e.value)
    both(run, tmp_path)


def test_read_merges_replicas_each_point_once(tmp_path):
    def run(P, root):
        p, dbs = _cluster(P, root)
        s = P.sess.ReplicatedSession(p, dbs)
        ids = _write_corpus(s)
        pts = s.fetch("default", ids[0], T0, T0 + BLOCK)
        assert len(pts) == 10 and pts == sorted(pts)  # not 30
        conns = dict(dbs)
        conns["i0"] = None
        s2 = P.sess.ReplicatedSession(p, conns)  # unstrict majority survives one down
        assert s2.fetch("default", ids[0], T0, T0 + BLOCK) == pts
        batch = s2.fetch_batch("default", ids + [b"absent"], T0, T0 + BLOCK)
        assert batch[0] == pts and batch[-1] == []
        _close(dbs)
        return pts, batch
    both(run, tmp_path)


def test_query_ids_and_fetch_tagged(tmp_path):
    def run(P, root):
        p, dbs = _cluster(P, root)
        s = P.sess.ReplicatedSession(p, dbs)
        docs = [P.doc.Document.from_tags(b"cpu{host=h%d}" % i,
                                         {b"__name__": b"cpu", b"host": b"h%d" % i})
                for i in range(6)]
        for k in range(3):
            s.write_tagged_batch("default", docs, np.full(6, T0 + (k + 1) * SEC, np.int64),
                                 np.arange(6.0) + k, now_nanos=T0 + (k + 1) * SEC)
        q = P.search.Conjunction(P.search.Term(b"__name__", b"cpu"),
                                 P.search.Regexp(b"host", b"h[0-2]"))
        ids = [d.id for d in s.query_ids("default", q, T0, T0 + BLOCK)]
        tagged = s.fetch_tagged("default", q, T0, T0 + BLOCK)
        dbs["i1"].close()
        conns = dict(dbs)
        conns["i1"] = conns["i2"] = None
        with pytest.raises(P.sess.ConsistencyError) as e:  # strict: 1 of 2 needed
            P.sess.ReplicatedSession(p, conns, read_level=P.sess.ConsistencyLevel.MAJORITY
                                     ).query_ids("default", q, T0, T0 + BLOCK)
        for iid in ("i0", "i2"):
            dbs[iid].close()
        return ids, sorted(tagged.items()), str(e.value)
    both(run, tmp_path)


class _Flaky:
    """A replica handle whose first ``n`` calls fail like a dropped
    connection, then answer."""

    def __init__(self, inner, n):
        self.inner, self.n = inner, n

    def __getattr__(self, name):
        fn = getattr(self.inner, name)

        def call(*a, **k):
            if self.n > 0:
                self.n -= 1
                raise ConnectionError("dropped")
            return fn(*a, **k)
        return call


def test_write_retrier_absorbs_a_transient_drop(tmp_path):
    def run(P, root):
        p, dbs = _cluster(P, root)
        conns = dict(dbs)
        conns["i2"] = _Flaky(dbs["i2"], 2)  # two drops: the third attempt lands
        s = P.sess.ReplicatedSession(
            p, conns, write_level=P.sess.ConsistencyLevel.ALL,
            retry_options=P.retry.RetryOptions(initial_backoff_s=0.001, max_backoff_s=0.002,
                                               max_attempts=3))
        s.write_batch("default", [b"x"], np.array([T0 + SEC]), np.array([1.0]),
                      now_nanos=T0 + SEC)
        got = dbs["i2"].read("default", b"x", T0, T0 + BLOCK)
        conns["i2"] = _Flaky(dbs["i2"], 3)  # three: the retries run out
        s2 = P.sess.ReplicatedSession(
            p, conns, write_level=P.sess.ConsistencyLevel.ALL,
            retry_options=P.retry.RetryOptions(initial_backoff_s=0.001, max_backoff_s=0.002,
                                               max_attempts=3))
        with pytest.raises(P.sess.ConsistencyError) as e:
            s2.write_batch("default", [b"y"], np.array([T0 + SEC]), np.array([1.0]),
                           now_nanos=T0 + SEC)
        _close(dbs)
        return got, str(e.value)
    both(run, tmp_path)


def test_read_breaker_opens_on_a_failing_replica(tmp_path):
    def run(P, root):
        p, dbs = _cluster(P, root)
        s = P.sess.ReplicatedSession(p, dbs)
        ids = _write_corpus(s, n_pts=2)
        conns = dict(dbs)
        conns["i1"] = _Flaky(dbs["i1"], 10**6)
        s2 = P.sess.ReplicatedSession(
            p, conns, retry_options=P.retry.RetryOptions(max_attempts=1))
        s2.breaker_failures = 2
        reads = [s2.fetch("default", ids[0], T0, T0 + BLOCK) for _ in range(4)]
        states = s2.breaker_states()
        assert states["i1"] == "open" and states["i0"] == "closed"
        _close(dbs)
        return reads, states
    both(run, tmp_path)


def test_spent_deadline_is_the_queries_failure_not_a_replicas(tmp_path):
    def run(P, root):
        p, dbs = _cluster(P, root)
        s = P.sess.ReplicatedSession(p, dbs)
        _write_corpus(s, n_pts=1)
        dl = P.dl.Deadline(0.0)
        with P.dl.bind(dl), pytest.raises(P.dl.DeadlineExceeded) as e:
            s.fetch("default", b"series-0", T0, T0 + BLOCK)
        states = s.breaker_states()
        assert all(v == "closed" for v in states.values())
        _close(dbs)
        return str(e.value), states
    both(run, tmp_path)


def _digests(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "data").rglob("*")) if p.is_file()}


def test_node_replace_under_sustained_majority_writes(tmp_path):
    """The session watches the placement and swaps routing live: a node
    replace under sustained MAJORITY writes needs no client restart and
    fails no write."""
    def run(P, root):
        dbs = {iid: _mk_db(P, root, iid) for iid in ("i0", "i1", "i2")}
        servers = {iid: P.rpc.serve_rpc_background(db) for iid, db in dbs.items()}
        kv = P.kv.KVStore(str(root))
        ps = P.pl.PlacementService(kv)
        ps.set(P.pl.initial_placement([P.pl.Instance(iid, isolation_group=f"g{k}")
                                       for k, iid in enumerate(dbs)], num_shards=4, rf=3))

        def resolve(inst):
            return P.rpc.RemoteDatabase(("127.0.0.1", servers[inst.id].port), timeout_s=30.0)

        sess = P.sess.ReplicatedSession.dynamic(
            kv, resolve, write_level=P.sess.ConsistencyLevel.MAJORITY)
        v0 = sess.topology_version
        written, failures = [], []

        def write_round(r):
            ids = [b"dyn-%d-%d" % (r, j) for j in range(4)]
            try:
                sess.write_batch("default", ids, np.full(4, T0 + r * SEC, np.int64),
                                 np.full(4, float(r)))
                written.extend(ids)
            except P.sess.ConsistencyError as e:  # pragma: no cover
                failures.append((r, str(e)))

        try:
            for r in range(10):
                write_round(r)
            dbs["i3"] = _mk_db(P, root, "i3")
            servers["i3"] = P.rpc.serve_rpc_background(dbs["i3"])
            ps.set(P.pl.replace_instance(ps.get(), "i1",
                                         P.pl.Instance("i3", isolation_group="g1")))
            assert sess.topology_version > v0 and "i3" in sess.connections
            for r in range(10, 20):
                write_round(r)
            P.rep.peers_bootstrap(dbs["i3"], [dbs["i0"], dbs["i2"]], "default")
            p3 = ps.get()
            for shard in range(4):
                p3 = P.pl.mark_available(p3, "i3", shard)
            ps.set(p3)
            servers["i1"].shutdown()
            for r in range(20, 30):
                write_round(r)
            assert failures == [] and len(written) == 120
            post = [sid for sid in written if int(sid.split(b"-")[1]) >= 20]
            assert all(dbs["i3"].read("default", sid, T0, T0 + BLOCK) for sid in post)
            pts = sess.fetch("default", written[0], T0, T0 + BLOCK)
            assert pts and pts[0][1] == 0.0 and "i1" not in sess.connections
            out = (pts, sorted(sess.connections), sess.topology_version,
                   [dbs[i].read_batch("default", written, T0, T0 + BLOCK)
                    for i in ("i0", "i2", "i3")])
        finally:
            sess.close()
            for srv in servers.values():
                srv.shutdown()
                srv.server_close()
            _close(dbs)
        return out
    both(run, tmp_path)


def test_engine_over_session_storage(tmp_path):
    """PromQL through ``SessionStorage``: the engine reaches the replicas
    through the session (one replica down at UNSTRICT_MAJORITY reads); the
    port's answer equals the JAX engine's over its session within config
    #5's rtol 1e-12, and equals the port engine over one replica's
    ``DatabaseStorage``."""
    out = {}
    for side, P in PKGS.items():
        root = tmp_path / side
        root.mkdir()
        eng_mod, adapter = (jengine, jadapter) if side == "jax" else (tengine, tadapter)
        p, dbs = _cluster(P, root)
        s = P.sess.ReplicatedSession(p, dbs)
        docs = [P.doc.Document.from_tags(b"reqs{host=h%d}" % i,
                                         {b"__name__": b"reqs", b"host": b"h%d" % i})
                for i in range(6)]
        for k in range(40):
            s.write_tagged_batch("default", docs, np.full(6, T0 + k * 15 * SEC, np.int64),
                                 np.arange(6.0) * k, now_nanos=T0 + k * 15 * SEC)
        conns = dict(dbs)
        conns["i2"] = None
        storage = adapter.SessionStorage(P.sess.ReplicatedSession(p, conns))
        kw = {} if side == "jax" else {"device": "cpu"}
        q = 'sum(rate(reqs{host=~"h[0-4]"}[2m]))'
        blk = eng_mod.Engine(storage, **kw).execute_range(q, T0 + 120 * SEC, T0 + 585 * SEC,
                                                          15 * SEC)
        vals = np.asarray(blk.values) if side == "jax" else tblock.to_host(blk.values)
        if side == "torch":
            local = tengine.Engine(tadapter.DatabaseStorage(dbs["i0"]), device="cpu")
            want = tblock.to_host(local.execute_range(q, T0 + 120 * SEC, T0 + 585 * SEC,
                                                      15 * SEC).values)
            assert np.array_equal(vals, want)
        out[side] = vals
        _close(dbs)
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=1e-12)
    assert np.isfinite(out["torch"]).any()
