"""The port's remote query wire (``m3_tpu_torch.query.remote``) against the
JAX package's (``m3_tpu.query.remote``) on the CPU.

``QUERY_FETCH`` and ``QUERY_RESULT`` payloads are byte-identical in both
directions (each package decodes the other's); server-side errors cross
the wire typed and with the same messages; and a mixed federation, a JAX
``QueryServer`` read by a port ``RemoteStorage`` and the reverse, gives
the blocks each package's own pair gives, and the same PromQL answers
through ``FederatedStorage``.  The client's deadline trailer, pooled
reconnects and per-peer breaker behave as the reference's.
"""

import threading
import types

import numpy as np
import pytest

import m3_tpu.index.doc as jdoc
import m3_tpu.instrument.tracing as jtr
import m3_tpu.msg.protocol as jwire
import m3_tpu.query.block as jblock
import m3_tpu.query.engine as jeng
import m3_tpu.query.fanout as jfan
import m3_tpu.query.promql as jpromql
import m3_tpu.query.remote as jrem
import m3_tpu.query.storage_adapter as jsa
import m3_tpu.storage.database as jdb
import m3_tpu.storage.limits as jlim
import m3_tpu.x.breaker as jbr
import m3_tpu.x.deadline as jdl
import m3_tpu_torch.index.doc as tdoc
import m3_tpu_torch.instrument.tracing as ttr
import m3_tpu_torch.msg.protocol as twire
import m3_tpu_torch.query.block as tblock
import m3_tpu_torch.query.engine as teng
import m3_tpu_torch.query.fanout as tfan
import m3_tpu_torch.query.promql as tpromql
import m3_tpu_torch.query.remote as trem
import m3_tpu_torch.query.storage_adapter as tsa
import m3_tpu_torch.storage.database as tdb
import m3_tpu_torch.storage.limits as tlim
import m3_tpu_torch.x.breaker as tbr
import m3_tpu_torch.x.deadline as tdl

BLOCK = 2 * 3600 * 10**9
START = (1_700_000_000 * 10**9) // BLOCK * BLOCK
SEC = 10**9

SIDES = {
    "torch": types.SimpleNamespace(
        rem=trem, block=tblock, promql=tpromql, tr=ttr, wire=twire, dl=tdl,
        lim=tlim, br=tbr, db=tdb, doc=tdoc, sa=tsa, fan=tfan, eng=teng,
        engine_kw={"device": "cpu"}, db_kw={"device": "cpu"}),
    "jax": types.SimpleNamespace(
        rem=jrem, block=jblock, promql=jpromql, tr=jtr, wire=jwire, dl=jdl,
        lim=jlim, br=jbr, db=jdb, doc=jdoc, sa=jsa, fan=jfan, eng=jeng,
        engine_kw={}, db_kw={}),
}
T, J = SIDES["torch"], SIDES["jax"]


def _matchers(pkg, rng, n):
    ops = ["=", "!=", "=~", "!~"]
    return tuple(pkg.promql.LabelMatcher(
        b"l%d" % rng.integers(0, 100), ops[rng.integers(0, 4)],
        bytes(rng.integers(97, 123, rng.integers(0, 20)).astype(np.uint8)))
        for _ in range(n))


FETCH_CASES = [
    dict(name=b"reqs", n=2, dl=-1, traced=False),
    dict(name=None, n=0, dl=1500, traced=False),
    dict(name=b"", n=1, dl=0, traced=True),
    dict(name=b"x" * 300, n=7, dl=-1, traced=True),
    dict(name=b"http_requests_total", n=3, dl=2**40, traced=False),
]


@pytest.mark.parametrize("case", range(len(FETCH_CASES)))
def test_fetch_frames_identical_both_ways(case):
    c = FETCH_CASES[case]
    raws = {}
    for side, pkg in SIDES.items():
        m = _matchers(pkg, np.random.default_rng(case), c["n"])
        ctx = (pkg.tr.TraceContext(trace_id=0xABCD + case, span_id=7,
                                   sampled=True).to_wire()
               if c["traced"] else b"")
        raws[side] = pkg.rem.encode_fetch(c["name"], m, START - case,
                                          START + 100 * case, deadline_ms=c["dl"],
                                          trace_ctx=ctx)
    assert raws["torch"] == raws["jax"]
    # each package decodes the other's bytes to the same fields
    out = {}
    for side, pkg in SIDES.items():
        name, m, s, e, dl_ms, tctx = pkg.rem.decode_fetch(raws["jax"])
        out[side] = (name, [(x.name, x.op, x.value) for x in m], s, e, dl_ms,
                     None if tctx is None else tctx.to_wire())
    assert out["torch"] == out["jax"]
    assert out["torch"][4] == c["dl"]


def test_fetch_trailerless_frames_decode_equal():
    raw = J.rem.encode_fetch(b"reqs", (), 1, 2)[:-8]  # pre-deadline encoder
    assert T.rem.decode_fetch(raw)[2:] == J.rem.decode_fetch(raw)[2:] == \
        (1, 2, -1, None)


def _block(pkg, rng, S):
    metas, pts = [], []
    for i in range(S):
        tags = tuple(sorted({b"k%d" % rng.integers(0, 9): b"v%d" % i
                             for _ in range(rng.integers(0, 4))}.items()))
        metas.append(pkg.block.SeriesMeta(tags))
        n = int(rng.integers(0, 12))
        ts = np.sort(rng.choice(10**6, n, replace=False)) + START
        vals = rng.normal(0, 1e3, n)
        vals[rng.random(n) < 0.1] = np.nan
        pts.append(list(zip(ts.tolist(), vals.tolist())))
    return pkg.block.RawBlock.from_lists(pts, metas)


@pytest.mark.parametrize("seed", range(6))
def test_result_frames_identical_both_ways(seed):
    raws = {side: pkg.rem.encode_result(_block(pkg, np.random.default_rng(seed),
                                                seed * 3))
            for side, pkg in SIDES.items()}
    assert raws["torch"] == raws["jax"]
    for raw in raws.values():
        a, b = T.rem.decode_result(raw), J.rem.decode_result(raw)
        assert [m.tags for m in a.series] == [m.tags for m in b.series]
        for x in ("ts", "values", "counts"):
            np.testing.assert_array_equal(getattr(a, x), getattr(b, x))
        assert T.rem.encode_result(a) == raw


@pytest.mark.parametrize("msg", [
    "QueryLimitExceeded: query limit exceeded: docs-matched (1000 > 100 within window)",
    "DeadlineExceeded: fetch: deadline exceeded",
    "QueryCancelled: query cancelled",
    "RuntimeError: storage exploded",
    "ValueError: bad",
    "garbage",
])
def test_query_errors_decode_typed_and_equal(msg):
    a, b = T.rem._decode_query_error(msg), J.rem._decode_query_error(msg)
    assert type(a).__name__ == type(b).__name__ and str(a) == str(b)
    if msg.startswith("QueryLimitExceeded"):
        assert isinstance(a, tlim.QueryLimitExceeded) and a.name == b.name


# -- servers and clients, mixed --------------------------------------------


def _seed_db(pkg, root, tag: bytes, n=10):
    db = pkg.db.Database(pkg.db.DatabaseOptions(root=str(root)),
                         namespaces={"default": pkg.db.NamespaceOptions(
                             num_shards=2, slot_capacity=1 << 10,
                             sample_capacity=1 << 12)}, **pkg.db_kw)
    rng = np.random.default_rng(int.from_bytes(tag, "little"))
    for h in range(3):
        docs = [pkg.doc.Document.from_tags(
            b"reqs{host=h%d,region=%s}" % (h, tag),
            {b"__name__": b"reqs", b"region": tag, b"host": b"h%d" % h})] * n
        ts = START + np.arange(n, dtype=np.int64) * SEC
        db.write_tagged_batch("default", docs, ts, rng.normal(100, 30, n))
    return db


@pytest.fixture
def regions(tmp_path):
    """One database per (package, region); closed at the end."""
    made = {}

    def get(side, tag):
        if (side, tag) not in made:
            made[(side, tag)] = _seed_db(SIDES[side], tmp_path / f"{side}-{tag.decode()}", tag)
        return made[(side, tag)]

    yield get
    for db in made.values():
        db.close()


def _pairs():
    return [(s, c) for s in SIDES for c in SIDES]


@pytest.mark.parametrize("server,client", _pairs())
def test_remote_fetch_mixed_equals_local(regions, server, client):
    sp, cp = SIDES[server], SIDES[client]
    local = sp.sa.DatabaseStorage(regions(server, b"eu"))
    srv = sp.rem.serve_query_background(local)
    remote = cp.rem.RemoteStorage(("127.0.0.1", srv.port))
    try:
        for m in ((cp.promql.LabelMatcher(b"region", "=", b"eu"),),
                  (cp.promql.LabelMatcher(b"host", "=~", b"h[12]"),), ()):
            lm = tuple(sp.promql.LabelMatcher(x.name, x.op, x.value) for x in m)
            a = local.fetch_raw(b"reqs", lm, START, START + BLOCK)
            b = remote.fetch_raw(b"reqs", m, START, START + BLOCK)
            assert [s.tags for s in a.series] == [s.tags for s in b.series]
            for x in ("ts", "values", "counts"):
                np.testing.assert_array_equal(getattr(a, x), getattr(b, x))
    finally:
        remote.close()
        srv.shutdown()
        srv.server_close()


QUERIES = ["sum(reqs)", "sum(reqs) by (region)", "max by (host) (reqs)",
           "rate(reqs[5s])"]


def _federated_answers(regions, side, remote_side, required):
    """PromQL through FederatedStorage(local us + remote eu) with the
    client of ``side`` and the server of ``remote_side``."""
    pkg, rp = SIDES[side], SIDES[remote_side]
    srv = rp.rem.serve_query_background(rp.sa.DatabaseStorage(regions(remote_side, b"eu")))
    remote = pkg.rem.RemoteStorage(("127.0.0.1", srv.port))
    try:
        fed = pkg.fan.FederatedStorage(
            [pkg.sa.DatabaseStorage(regions(side, b"us")), remote],
            required=required)
        eng = pkg.eng.Engine(fed, **pkg.engine_kw)
        out = []
        for q in QUERIES:
            blk = eng.execute_range(q, START, START + 9 * SEC, SEC)
            out.append(([s.tags for s in blk.series],
                        np.asarray(blk.values, np.float64)))
        return out
    finally:
        remote.close()
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("required", [(), (0, 1)])
def test_mixed_federation_answers_equal(regions, required):
    ref = _federated_answers(regions, "jax", "jax", required)
    for side, remote_side in (("torch", "torch"), ("torch", "jax"),
                              ("jax", "torch")):
        got = _federated_answers(regions, side, remote_side, required)
        for (tags_a, va), (tags_b, vb) in zip(got, ref):
            assert tags_a == tags_b
            np.testing.assert_allclose(va, vb, rtol=1e-12, atol=0)
    assert len(ref[1][0]) == 2  # both regions answered


class _Raises:
    def __init__(self, err):
        self.err = err

    def fetch_raw(self, *a):
        raise self.err


def _server_errors(pkg):
    return [RuntimeError("storage exploded"),
            pkg.lim.QueryLimitExceeded("docs-matched", 1000, 100),
            pkg.dl.DeadlineExceeded("server side budget spent"),
            ValueError("x" * 5000)]


@pytest.mark.parametrize("server,client", _pairs())
def test_remote_errors_cross_typed_and_equal(server, client):
    sp, cp = SIDES[server], SIDES[client]
    seen = []
    for err in _server_errors(sp):
        srv = sp.rem.serve_query_background(_Raises(err))
        remote = cp.rem.RemoteStorage(("127.0.0.1", srv.port))
        try:
            with pytest.raises(Exception) as ei:
                remote.fetch_raw(b"x", (), START, START + 1)
            seen.append((type(ei.value).__name__, str(ei.value)))
        finally:
            remote.close()
            srv.shutdown()
            srv.server_close()
    ref = []
    for err in _server_errors(J):
        ref.append((type(J.rem._decode_query_error(
            f"{type(err).__name__}: {err}"[:4096])).__name__,
            str(J.rem._decode_query_error(f"{type(err).__name__}: {err}"[:4096]))))
    assert seen == ref
    assert [s[0] for s in seen] == ["RuntimeError", "QueryLimitExceeded",
                                    "DeadlineExceeded", "RuntimeError"]


@pytest.mark.parametrize("server", list(SIDES))
def test_spent_budget_refused_before_storage(server):
    sp = SIDES[server]
    calls = []

    class MustNotRun:
        def fetch_raw(self, *a):
            calls.append(a)
            return sp.block.RawBlock.from_lists([], [])

    srv = sp.rem.serve_query_background(MustNotRun())
    bodies = []
    try:
        for pkg in SIDES.values():  # either package's frame
            sock = pkg.wire.connect(("127.0.0.1", srv.port), timeout=5.0)
            pkg.wire.send_frame(sock, pkg.rem.QUERY_FETCH, pkg.rem.encode_fetch(
                b"x", (), START, START + 1, deadline_ms=0))
            bodies.append(pkg.wire.recv_frame(sock))
            sock.close()
    finally:
        srv.shutdown()
        srv.server_close()
    assert bodies[0] == bodies[1]
    assert bodies[0][0] == twire.ERROR == jwire.ERROR
    assert bodies[0][1].startswith(b"DeadlineExceeded")
    assert not calls


def test_frame_constants_equal():
    assert (trem.QUERY_FETCH, trem.QUERY_RESULT) == (jrem.QUERY_FETCH,
                                                     jrem.QUERY_RESULT) == (8, 9)


def test_reconnect_after_server_restart(regions):
    local = tsa.DatabaseStorage(regions("torch", b"eu"))
    srv = trem.serve_query_background(local)
    port = srv.port
    remote = trem.RemoteStorage(("127.0.0.1", port))
    m = (tpromql.LabelMatcher(b"region", "=", b"eu"),)
    try:
        assert remote.fetch_raw(b"reqs", m, START, START + BLOCK).series
        srv.shutdown()
        srv.server_close()
        srv = trem.serve_query_background(local, port=port)
        assert remote.fetch_raw(b"reqs", m, START, START + BLOCK).series
    finally:
        remote.close()
        srv.shutdown()
        srv.server_close()


def test_retry_dials_fresh_not_another_stale_pooled_socket(regions):
    class _DeadSock:
        def settimeout(self, t):
            pass

        def sendall(self, b):
            raise OSError("connection reset by stale peer")

        def close(self):
            pass

    srv = trem.serve_query_background(tsa.DatabaseStorage(regions("torch", b"eu")))
    remote = trem.RemoteStorage(("127.0.0.1", srv.port))
    try:
        remote._pool._idle = [_DeadSock(), _DeadSock()]
        m = (tpromql.LabelMatcher(b"region", "=", b"eu"),)
        assert remote.fetch_raw(b"reqs", m, START, START + BLOCK).series
    finally:
        remote.close()
        srv.shutdown()
        srv.server_close()


def test_concurrent_fetches_do_not_serialize():
    """A fetch completes while another is still in flight on the same
    peer (the pool hands each its own connection)."""
    first_in = threading.Event()
    release = threading.Event()

    class SlowFirst:
        def __init__(self):
            self.calls = 0
            self._mu = threading.Lock()

        def fetch_raw(self, *a):
            with self._mu:
                self.calls += 1
                first = self.calls == 1
            if first:
                first_in.set()
                release.wait(20)
            return tblock.RawBlock.from_lists([], [])

    srv = trem.serve_query_background(SlowFirst())
    remote = trem.RemoteStorage(("127.0.0.1", srv.port))
    try:
        t_slow = threading.Thread(target=remote.fetch_raw,
                                  args=(b"x", (), START, START + 1))
        t_slow.start()
        assert first_in.wait(10)
        remote.fetch_raw(b"x", (), START, START + 1)  # the slow one still waits
        assert t_slow.is_alive()
        release.set()
        t_slow.join(10)
        assert not t_slow.is_alive()
    finally:
        release.set()
        remote.close()
        srv.shutdown()
        srv.server_close()


def _breaker_story(pkg):
    """A dead peer: failures open the breaker, then it fails fast; a
    budget spent upstream never counts against a healthy peer."""
    pkg.br.reset_registry()
    try:
        srv = pkg.rem.serve_query_background(_Raises(RuntimeError("x")))
        port = srv.port
        srv.shutdown()
        srv.server_close()  # nothing listens on the port any more
        br = pkg.br.breaker_for(f"query:127.0.0.1:{port}", failure_threshold=3,
                                reset_timeout_s=60.0)
        remote = pkg.rem.RemoteStorage(("127.0.0.1", port), timeout_s=2.0,
                                       breaker=br)
        seen = []
        for _ in range(5):
            try:
                remote.fetch_raw(b"x", (), START, START + 1)
            except Exception as e:  # noqa: BLE001 — the observation
                seen.append((type(e).__name__, br.state))
        remote.close()
        healthy = pkg.br.CircuitBreaker("query:healthy", failure_threshold=2,
                                        reset_timeout_s=30.0)
        r2 = pkg.rem.RemoteStorage(("127.0.0.1", 1), breaker=healthy)
        with pkg.dl.bind(pkg.dl.Deadline(0.0)):
            for _ in range(4):
                with pytest.raises(pkg.dl.DeadlineExceeded):
                    r2.fetch_raw(b"x", (), START, START + 1)
        r2.close()
        return seen, healthy.state, remote.peer == f"127.0.0.1:{port}"
    finally:
        pkg.br.reset_registry()


def test_breaker_opens_and_fails_fast_equal():
    t, j = _breaker_story(T), _breaker_story(J)
    assert [x[1] for x in t[0]] == [x[1] for x in j[0]]
    assert [x[0] for x in t[0]][-1] == [x[0] for x in j[0]][-1] == "BreakerOpenError"
    assert t[0][2][1] == "open" and t[1:] == j[1:] == ("closed", True)
