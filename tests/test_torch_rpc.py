"""m3_tpu_torch.server.rpc against m3_tpu.server.rpc on the CPU.

The cases of ``tests/test_rpc.py`` run through the port's server and
client (its ``Database`` on ``device="cpu"``) and across the packages in
both directions: a port ``RemoteDatabase`` against a JAX
``DbNodeRpcServer`` and the reverse.  Answers, error types and messages
are held equal to the JAX package's; the frames each package's client
and server send for the same calls are byte-identical; files written
through the wire (flushes, peers bootstrap, repair) are sha256-equal to
the JAX package's.  A mixed cluster, one JAX replica and two port
replicas under one session, flushes sha256-equal filesets.  Every
server is shut down in a ``finally`` or a fixture, every handle closed,
every thread joined with a bound."""

import hashlib
import threading

import numpy as np
import pytest

import m3_tpu.client.session as jsess
import m3_tpu.cluster.placement as jpl
import m3_tpu.index.doc as jdoc
import m3_tpu.index.search as jsearch
import m3_tpu.server.rpc as jrpc
import m3_tpu.storage.database as jdb
import m3_tpu.storage.limits as jlim
import m3_tpu.storage.repair as jrep
import m3_tpu.x.deadline as jdl
import m3_tpu_torch.client.session as tsess
import m3_tpu_torch.cluster.placement as tpl
import m3_tpu_torch.index.doc as tdoc
import m3_tpu_torch.index.search as tsearch
import m3_tpu_torch.server.rpc as trpc
import m3_tpu_torch.storage.database as tdb
import m3_tpu_torch.storage.limits as tlim
import m3_tpu_torch.storage.repair as trep
import m3_tpu_torch.x.deadline as tdl

SEC = 10**9
BLOCK = 2 * 3600 * SEC
T0 = (1_600_000_000 * SEC) // BLOCK * BLOCK

PKG = {
    "jax": dict(db=jdb, rpc=jrpc, doc=jdoc, search=jsearch, sess=jsess, pl=jpl, rep=jrep,
                dl=jdl, lim=jlim),
    "torch": dict(db=tdb, rpc=trpc, doc=tdoc, search=tsearch, sess=tsess, pl=tpl, rep=trep,
                  dl=tdl, lim=tlim),
}
PAIRS = [("torch", "torch"), ("jax", "torch"), ("torch", "jax")]
IDS = [f"{s}-server-{c}-client" for s, c in PAIRS]


def _mk_db(side, root, commitlog=False, shards=2):
    m = PKG[side]["db"]
    kw = {"device": "cpu"} if side == "torch" else {}
    return m.Database(
        m.DatabaseOptions(root=str(root), commitlog_enabled=commitlog),
        namespaces={"default": m.NamespaceOptions(num_shards=shards, slot_capacity=256,
                                                  sample_capacity=2048)}, **kw)


def _stop(srv):
    srv.shutdown()
    srv.server_close()


def _digests(root) -> dict:
    root = root if hasattr(root, "rglob") else __import__("pathlib").Path(root)
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "data").rglob("*")) if p.is_file()}


@pytest.fixture(params=PAIRS, ids=IDS)
def served(request, tmp_path):
    srv_side, cli_side = request.param
    db = _mk_db(srv_side, tmp_path / "n0")
    srv = PKG[srv_side]["rpc"].serve_rpc_background(db)
    remote = PKG[cli_side]["rpc"].RemoteDatabase(("127.0.0.1", srv.port), timeout_s=30.0)
    try:
        yield db, srv, remote, PKG[cli_side]
    finally:
        remote.close()
        _stop(srv)
        db.close()


def test_write_read_roundtrip(served):
    db, _, remote, _ = served
    ids = [b"a", b"b"]
    ts = np.array([T0 + SEC, T0 + 2 * SEC], np.int64)
    res = remote.write_batch("default", ids, ts, np.array([1.5, 2.5]), now_nanos=int(ts[0]))
    assert (int(res), res.rejected) == (0, 0)
    assert db.read("default", b"a", T0, T0 + BLOCK) == [(T0 + SEC, 1.5)]
    assert remote.read("default", b"b", T0, T0 + BLOCK) == [(T0 + 2 * SEC, 2.5)]
    assert remote.read_batch("default", [b"b", b"zz", b"a"], T0, T0 + BLOCK) == [
        [(T0 + 2 * SEC, 2.5)], [], [(T0 + SEC, 1.5)]]


def test_write_tagged_and_query_ids(served):
    _, _, remote, cli = served
    Document, search = cli["doc"].Document, cli["search"]
    docs = [Document.from_tags(b"m1", {b"__name__": b"m", b"h": b"1"}),
            Document.from_tags(b"m2", {b"__name__": b"m", b"h": b"2"})]
    ts = np.array([T0 + SEC, T0 + SEC], np.int64)
    remote.write_tagged_batch("default", docs, ts, np.array([1.0, 2.0]), now_nanos=T0 + SEC)
    got = remote.query_ids("default", search.Conjunction(search.Term(b"__name__", b"m")),
                           T0, T0 + BLOCK)
    assert sorted(d.id for d in got) == [b"m1", b"m2"]
    only2 = remote.query_ids("default", search.Term(b"h", b"2"), T0, T0 + BLOCK)
    assert [d.id for d in only2] == [b"m2"]
    assert only2[0].tags()[b"h"] == b"2"
    neg = remote.query_ids("default", search.Conjunction(
        search.Regexp(b"h", b"[12]"), search.Negation(search.Term(b"h", b"1"))), T0, T0 + BLOCK)
    assert [d.id for d in neg] == [b"m2"]


def test_application_error_propagates_and_conn_survives(served):
    _, _, remote, cli = served
    with pytest.raises(cli["rpc"].RemoteError, match="nope") as e:
        remote.read("nope", b"x", T0, T0 + BLOCK)
    assert str(e.value) == "KeyError: 'nope'"
    assert remote.health()  # the connection is still usable


def test_block_surface_over_wire(served, tmp_path):
    db, _, remote, _ = served
    ids = [b"s1", b"s2"]
    ts = np.array([T0 + SEC, T0 + SEC], np.int64)
    db.write_batch("default", ids, ts, np.array([1.0, 2.0]), now_nanos=int(ts[0]))
    db.tick(T0 + 2 * BLOCK)  # seal + flush
    listing = {sh: remote.list_block_filesets("default", sh) for sh in (0, 1)}
    assert any(listing.values())
    # the same writes into a JAX Database give the same blocks
    ref = _mk_db("jax", tmp_path / "ref")
    try:
        ref.write_batch("default", ids, ts, np.array([1.0, 2.0]), now_nanos=int(ts[0]))
        ref.tick(T0 + 2 * BLOCK)
        for sh, pairs in listing.items():
            assert pairs == ref.list_block_filesets("default", sh)
            for bs, _vol in pairs:
                meta = remote.block_metadata("default", sh, bs)
                series = dict(remote.read_block("default", sh, bs))
                assert set(meta) == set(series)
                assert meta == ref.block_metadata("default", sh, bs)
                assert sorted(series.items()) == ref.read_block("default", sh, bs)
    finally:
        ref.close()
    assert remote.block_metadata("default", 0, T0 + 10 * BLOCK) is None
    assert remote.read_block("default", 0, T0 + 10 * BLOCK) == []


@pytest.mark.parametrize("srv_side,cli_side", PAIRS, ids=IDS)
def test_reconnect_after_server_bounce(tmp_path, srv_side, cli_side):
    db = _mk_db(srv_side, tmp_path / "n1")
    rpc = PKG[srv_side]["rpc"]
    srv = rpc.serve_rpc_background(db)
    port = srv.port
    remote = PKG[cli_side]["rpc"].RemoteDatabase(("127.0.0.1", port), timeout_s=30.0)
    srv2 = None
    try:
        assert remote.health()
        # bounce: stop accepting AND sever the live connection (a real
        # process death does both)
        _stop(srv)
        remote._sock.close()
        with pytest.raises(ConnectionError):
            remote.health()
        srv2 = rpc.serve_rpc_background(db, port=port)
        assert remote.health()  # lazy reconnect on the next call
    finally:
        remote.close()
        if srv2 is not None:
            _stop(srv2)
        db.close()


def _wire_cluster(side, root, n=3, shards=2):
    m = PKG[side]
    dbs, srvs, remotes = {}, {}, {}
    for k in range(n):
        iid = f"i{k}"
        dbs[iid] = _mk_db(side, root / iid, shards=shards)
        srvs[iid] = m["rpc"].serve_rpc_background(dbs[iid])
        remotes[iid] = m["rpc"].RemoteDatabase(("127.0.0.1", srvs[iid].port), timeout_s=30.0)
    p = m["pl"].initial_placement([m["pl"].Instance(i) for i in dbs], num_shards=shards, rf=n)
    return p, dbs, srvs, remotes


def _close_cluster(dbs, srvs, remotes):
    for iid in dbs:
        remotes[iid].close()
        try:
            _stop(srvs[iid])
        except OSError:
            pass
        dbs[iid].close()


@pytest.fixture
def wire_clusters(tmp_path):
    """The same 3-replica cluster in each package, over real sockets."""
    out = {side: _wire_cluster(side, tmp_path / side) for side in ("jax", "torch")}
    try:
        yield out
    finally:
        for _, dbs, srvs, remotes in out.values():
            _close_cluster(dbs, srvs, remotes)


def test_quorum_write_read_with_one_replica_down(wire_clusters):
    got = {}
    for side, (p, dbs, srvs, remotes) in wire_clusters.items():
        _stop(srvs["i2"])
        s = PKG[side]["sess"].ReplicatedSession(
            p, dict(remotes), write_level=PKG[side]["sess"].ConsistencyLevel.MAJORITY,
            read_level=PKG[side]["sess"].ConsistencyLevel.MAJORITY)
        ids = [b"q-%d" % i for i in range(6)]
        ts = np.full(len(ids), T0 + SEC, np.int64)
        s.write_batch("default", ids, ts, np.arange(len(ids), dtype=np.float64),
                      now_nanos=T0 + SEC)
        got[side] = ([s.fetch("default", sid, T0, T0 + BLOCK) for sid in ids],
                     [bool(dbs[i].read("default", ids[0], T0, T0 + BLOCK))
                      for i in ("i0", "i1", "i2")])
        assert all(got[side][0]) and got[side][1] == [True, True, False]
    assert got["torch"] == got["jax"]


def test_all_level_fails_with_one_down(wire_clusters):
    errs = {}
    for side, (p, _, srvs, remotes) in wire_clusters.items():
        _stop(srvs["i1"])
        sess = PKG[side]["sess"]
        s = sess.ReplicatedSession(p, dict(remotes), write_level=sess.ConsistencyLevel.ALL)
        with pytest.raises(sess.ConsistencyError) as e:
            s.write_batch("default", [b"x"], np.array([T0 + SEC], np.int64),
                          np.array([1.0]), now_nanos=T0 + SEC)
        errs[side] = (e.value.got, e.value.need, len(e.value.errors))
    assert errs["torch"] == errs["jax"] == (2, 3, 1)


def test_peers_bootstrap_streams_blocks_over_sockets(wire_clusters):
    out = {}
    for side, (p, dbs, srvs, remotes) in wire_clusters.items():
        ids = [b"r-%d" % i for i in range(8)]
        ts = np.full(len(ids), T0 + SEC, np.int64)
        vals = np.arange(len(ids), dtype=np.float64)
        for iid in ("i0", "i1"):
            dbs[iid].write_batch("default", ids, ts, vals, now_nanos=T0 + SEC)
            dbs[iid].tick(T0 + 2 * BLOCK)
        # i2 lost its disk: bootstrap from peers purely over the wire
        stats = PKG[side]["rep"].peers_bootstrap(dbs["i2"], [remotes["i0"], remotes["i1"]],
                                                 "default")
        assert stats["blocks"] > 0 and stats["series"] == len(ids)
        for sid in ids:
            assert (dbs["i2"].read("default", sid, T0, T0 + BLOCK)
                    == dbs["i0"].read("default", sid, T0, T0 + BLOCK))
        rep = PKG[side]["rep"].repair_namespace(list(remotes.values()), "default", num_shards=2)
        assert rep.converged
        out[side] = (stats, dict(rep), {i: _digests(db.opts.root) for i, db in dbs.items()})
    assert out["torch"] == out["jax"]
    assert out["torch"][2]["i2"] == out["torch"][2]["i0"]


def test_wire_repair_fixes_divergent_replica(wire_clusters):
    out = {}
    for side, (p, dbs, srvs, remotes) in wire_clusters.items():
        ids = [b"d-%d" % i for i in range(4)]
        ts = np.full(len(ids), T0 + SEC, np.int64)
        for iid, bump in (("i0", 0.0), ("i1", 0.0), ("i2", 100.0)):
            dbs[iid].write_batch("default", ids, ts,
                                 np.arange(len(ids), dtype=np.float64) + bump, now_nanos=T0 + SEC)
            dbs[iid].tick(T0 + 2 * BLOCK)
        rep = PKG[side]["rep"].repair_namespace(list(remotes.values()), "default", num_shards=2)
        assert rep["series_diff"] > 0 and rep["repaired_replicas"] > 0
        rep2 = PKG[side]["rep"].repair_namespace(list(remotes.values()), "default", num_shards=2)
        assert rep2.converged
        a = dbs["i0"].read("default", ids[0], T0, T0 + BLOCK)
        b = dbs["i2"].read("default", ids[0], T0, T0 + BLOCK)
        assert a and a == b
        out[side] = (dict(rep), dict(rep2), a,
                     {i: _digests(db.opts.root) for i, db in dbs.items()})
    assert out["torch"] == out["jax"]


def test_parallel_writers(served):
    """Each client thread holds its own connection (the session model);
    the threaded server serializes on the db lock."""
    db, srv, _, cli = served
    errs = []

    def worker(k):
        r = cli["rpc"].RemoteDatabase(("127.0.0.1", srv.port), timeout_s=30.0)
        try:
            ids = [b"c-%d-%d" % (k, i) for i in range(20)]
            ts = np.full(len(ids), T0 + SEC * (k + 1), np.int64)
            r.write_batch("default", ids, ts, np.full(len(ids), float(k)), now_nanos=int(ts[0]))
        except Exception as e:  # pragma: no cover
            errs.append(e)
        finally:
            r.close()

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errs
    assert db.read("default", b"c-3-7", T0, T0 + BLOCK) == [(T0 + 4 * SEC, 3.0)]


def _record_frames(mod, monkeypatch) -> list:
    sent = []
    real = mod.send_frame

    def rec(sock, ftype, payload):
        sent.append((ftype, bytes(payload)))
        return real(sock, ftype, payload)

    monkeypatch.setattr(mod, "send_frame", rec)
    return sent


def _rpc_script(remote, m):
    """One call of every method (the block surface after a tick), an
    application error, and a deadline-carrying call."""
    Document, search = m["doc"].Document, m["search"]
    out = [remote.health()]
    res = remote.write_batch("default", [b"a", b"bb"], np.array([T0 + SEC, T0 + 2 * SEC]),
                             np.array([1.25, -2.5]), now_nanos=T0 + 2 * SEC)
    out.append((int(res), res.rejected))
    docs = [Document.from_tags(b"t{h=1}", {b"__name__": b"t", b"h": b"1"}),
            Document.from_tags(b"t{h=2}", {b"__name__": b"t", b"h": b"2"})]
    res = remote.write_tagged_batch("default", docs, np.array([T0 + SEC, T0 + SEC]),
                                    np.array([3.0, 4.0]))
    out.append((int(res), res.rejected))
    out.append(remote.read("default", b"a", T0, T0 + BLOCK))
    out.append(remote.read_batch("default", [b"bb", b"a", b"none"], T0, T0 + BLOCK))
    out.append([(d.id, [(f.name, f.value) for f in d.fields]) for d in remote.query_ids(
        "default", search.Disjunction(search.Term(b"h", b"1"), search.FieldExists(b"zz"),
                                      search.All()), T0, T0 + BLOCK)])
    try:
        remote.read("missing", b"a", T0, T0 + BLOCK)
    except m["rpc"].RemoteError as e:
        out.append(str(e))
    remote.tick(T0 + 2 * BLOCK)
    for sh in (0, 1):
        blocks = remote.list_block_filesets("default", sh)
        out.append(blocks)
        for bs, _ in blocks:
            out.append(sorted(remote.block_metadata("default", sh, bs).items()))
            series = remote.read_block("default", sh, bs)
            out.append(series)
            remote.write_block("default", sh, bs, series)
    with m["dl"].bind(m["dl"].Deadline(3600.0)):
        out.append(remote.read("default", b"bb", T0, T0 + BLOCK))
    return out


def test_frames_byte_identical(tmp_path, monkeypatch):
    """The same calls through each package's own client and server send
    the same frames, byte for byte (the deadline-carrying call's budget
    field aside, a clock reading), and give the same answers; each
    package's client gets those answers from the other's server too."""
    frames, answers = {}, {}
    for side in ("jax", "torch"):
        m = PKG[side]
        sent = _record_frames(m["rpc"], monkeypatch)
        db = _mk_db(side, tmp_path / side)
        srv = m["rpc"].serve_rpc_background(db)
        remote = m["rpc"].RemoteDatabase(("127.0.0.1", srv.port), timeout_s=30.0)
        try:
            answers[side] = _rpc_script(remote, m)
        finally:
            remote.close()
            _stop(srv)
            db.close()
        frames[side] = [(f, p[:1] + p[9:] if f == trpc.RPC_REQ_DL and
                         int.from_bytes(p[1:9], "little", signed=True) >= 0 else p)
                        for f, p in sent]
        # every request but the last carries "no deadline" (-1)
        assert sum(1 for f, p in sent if f == trpc.RPC_REQ_DL
                   and p[1:9] != (-1).to_bytes(8, "little", signed=True)) == 1
    assert frames["torch"] == frames["jax"]
    assert answers["torch"] == answers["jax"]
    assert [f for f, _ in frames["jax"]].count(trpc.RPC_ERR) == 1
    for srv_side, cli_side in PAIRS[1:]:
        db = _mk_db(srv_side, tmp_path / f"x{srv_side}")
        srv = PKG[srv_side]["rpc"].serve_rpc_background(db)
        remote = PKG[cli_side]["rpc"].RemoteDatabase(("127.0.0.1", srv.port), timeout_s=30.0)
        try:
            assert _rpc_script(remote, PKG[cli_side]) == answers["jax"]
        finally:
            remote.close()
            _stop(srv)
            db.close()


def test_query_codec_bytes_identical():
    """The query AST and document codecs, both directions."""
    def tree(search):
        return search.Conjunction(
            search.Term(b"__name__", b"m"),
            search.Disjunction(search.Regexp(b"h", b"a.*"), search.FieldExists(b"x"),
                               search.Negation(search.Term(b"h", b"z"))),
            search.All())

    jraw, traw = jrpc._enc_query(tree(jsearch)), trpc._enc_query(tree(tsearch))
    assert traw == jraw
    q, pos = trpc._dec_query(jraw)
    assert pos == len(jraw) and trpc._enc_query(q) == jraw
    d = tdoc.Document.from_tags(b"m{h=1}", {b"__name__": b"m", b"h": b"1"})
    jd = jdoc.Document.from_tags(b"m{h=1}", {b"__name__": b"m", b"h": b"1"})
    assert trpc._enc_doc(d) == jrpc._enc_doc(jd)
    pts = [(T0, 1.5), (T0 + SEC, float("nan"))]
    assert trpc._enc_points(pts) == jrpc._enc_points(pts)
    sl = [(b"a", b"\x01\x02"), (b"b", b"")]
    assert trpc._enc_series_list(sl) == jrpc._enc_series_list(sl)
    with pytest.raises(trpc.ProtocolError, match="bad query node kind 9"):
        trpc._dec_query(b"\x09")


@pytest.mark.parametrize("srv_side,cli_side", PAIRS, ids=IDS)
def test_typed_errors_cross_the_wire(tmp_path, srv_side, cli_side):
    """ShardNotOwnedError, QueryLimitExceeded and DeadlineExceeded from
    a server of either package arrive as the client package's own
    classes, with the reference's messages."""
    cm = PKG[cli_side]
    db = _mk_db(srv_side, tmp_path / "n", shards=2)
    srv = PKG[srv_side]["rpc"].serve_rpc_background(db)
    remote = cm["rpc"].RemoteDatabase(("127.0.0.1", srv.port), timeout_s=30.0)
    try:
        db.set_shard_ownership("default", [])
        with pytest.raises(cm["db"].ShardNotOwnedError) as e:
            remote.write_batch("default", [b"a"], np.array([T0 + SEC]), np.array([1.0]),
                               now_nanos=T0 + SEC)
        assert (e.value.namespace, e.value.shard) == ("default", cm["db"].shard_for_id(b"a", 2))
        db.set_shard_ownership("default", None)
        db.limits.docs.limit = 1
        remote.write_tagged_batch("default", [cm["doc"].Document.from_tags(
            b"m%d" % i, {b"__name__": b"m"}) for i in range(3)],
            np.full(3, T0 + SEC), np.ones(3), now_nanos=T0 + SEC)
        with pytest.raises(cm["lim"].QueryLimitExceeded) as e:
            remote.query_ids("default", cm["search"].Term(b"__name__", b"m"), T0, T0 + BLOCK)
        assert "docs-matched" in str(e.value)
        db.limits.docs.limit = 0
        dl = cm["dl"].Deadline(0.0)
        with cm["dl"].bind(dl), pytest.raises(cm["dl"].DeadlineExceeded):
            remote.read("default", b"a", T0, T0 + BLOCK)
        assert remote.health()
    finally:
        remote.close()
        _stop(srv)
        db.close()


def test_mixed_cluster_flushes_equal_filesets(tmp_path):
    """One JAX replica and two port replicas under one port session (and
    under one JAX session): quorum writes, a read merged across the three,
    and each replica's flushed filesets sha256-equal to the others'."""
    out = {}
    for sess_side in ("torch", "jax"):
        root = tmp_path / sess_side
        sides = {"i0": "jax", "i1": "torch", "i2": "torch"}
        dbs = {iid: _mk_db(side, root / iid, shards=4) for iid, side in sides.items()}
        srvs = {iid: PKG[side]["rpc"].serve_rpc_background(dbs[iid])
                for iid, side in sides.items()}
        sm = PKG[sess_side]
        remotes = {iid: sm["rpc"].RemoteDatabase(("127.0.0.1", srvs[iid].port), timeout_s=30.0)
                   for iid in sides}
        try:
            p = sm["pl"].initial_placement([sm["pl"].Instance(i) for i in sides], num_shards=4,
                                           rf=3)
            s = sm["sess"].ReplicatedSession(p, dict(remotes))
            rng = np.random.default_rng(5)
            ids = [b"mixed-%02d" % i for i in range(24)]
            for k in range(20):
                t = np.full(len(ids), T0 + (k + 1) * 10 * SEC, np.int64)
                v = np.round(rng.normal(10, 2, len(ids)), 2)
                assert s.write_batch("default", ids, t, v, now_nanos=int(t[0])) == 0
            pts = s.fetch_batch("default", ids, T0, T0 + BLOCK)
            assert all(len(x) == 20 for x in pts)
            for r in remotes.values():
                r.tick(T0 + BLOCK + 11 * 60 * SEC)
            files = {iid: _digests(db.opts.root) for iid, db in dbs.items()}
            assert files["i0"] == files["i1"] == files["i2"] and files["i0"]
            out[sess_side] = (pts, files["i0"])
        finally:
            _close_cluster(dbs, srvs, remotes)
    assert out["torch"] == out["jax"]


def test_wire_deadline_parts_match():
    """``x/deadline``'s wire parts: the same decoded error type and text
    for every wire message, and the same socket timeouts and budgets."""
    msgs = ["QueryLimitExceeded: query aborted: docs-matched limit exceeded (3 > 1)",
            "DeadlineExceeded: fetch: deadline exceeded", "QueryCancelled: query cancelled",
            "KeyError: 'nope'", "ShardNotOwnedError: x"]
    got = {}
    for side, dl in (("jax", jdl), ("torch", tdl)):
        decoded = [(type(e).__name__, str(e)) if e is not None else None
                   for e in map(dl.decode_wire_error, msgs)]
        none = (dl.socket_timeout(7.5), dl.remaining_ms())
        with dl.bind(dl.Deadline(3600.0)):
            bound = (dl.socket_timeout(7.5), dl.remaining_ms() > 3_000_000)
        with dl.bind(dl.Deadline(0.0)), pytest.raises(dl.DeadlineExceeded) as e:
            dl.socket_timeout(7.5)
        got[side] = (decoded, none, bound, str(e.value))
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == (7.5, -1) and got["torch"][2] == (7.5, True)
