"""The port's carbon line protocol (``m3_tpu_torch.metrics.carbon``)
against the JAX package's (``m3_tpu.metrics.carbon``) on the CPU.

Each line parses to the same sample or is rejected by both; a buffer of
lines gives the same samples and the same count of bad lines; paths and
tag documents translate the same both ways; and the TCP listener, fed
the same bytes by each package's server, hands its sink the same
documents, timestamps and values and counts the same samples, bad lines
and oversized lines.
"""

import socket
import time

import numpy as np
import pytest

import m3_tpu.index.doc as jdoc
import m3_tpu.instrument as jinst
import m3_tpu.metrics.carbon as jc
import m3_tpu_torch.index.doc as tdoc
import m3_tpu_torch.instrument as tinst
import m3_tpu_torch.metrics.carbon as tc

LINES = [
    b"foo.bar.baz 42.5 1700000000",
    b"foo.bar.baz 42.5 1700000000.25",
    b"  a.b  -1e3  1700000001  ",
    b"a.b 1 -1",
    b"a.b inf 1700000000",
    b"a.b -inf 1700000000",
    b"", b"# comment", b"noval 1", b"a..b 1 2", b".lead 1 2", b"trail. 1 2",
    b"x nanb 2", b"x 1 notts", b"x nan 1700000000", b"x 1 nan", b"x 1 inf",
    b"x 1 1e30", b"x 1 -5", b"a b c d", b"a.b 1 2 3", b"x 0x10 5",
    b"x 1_000 5", b"servers.web-01.cpu_user 3.25 1700000000",
    b"\xff\xfe.bad 1 2",
]


def _sample(s):
    return None if s is None else (s.path, s.value, s.timestamp_nanos)


@pytest.mark.parametrize("line", LINES)
def test_parse_line_equal(line):
    assert _sample(tc.parse_line(line, now_nanos=123)) == \
        _sample(jc.parse_line(line, now_nanos=123))


def test_parse_lines_equal_with_bad_counts():
    rng = np.random.default_rng(3)
    data = b"\n".join(LINES[i] for i in rng.integers(0, len(LINES), 400))
    t_out, t_bad = tc.parse_lines(data, now_nanos=7)
    j_out, j_bad = jc.parse_lines(data, now_nanos=7)
    assert [_sample(s) for s in t_out] == [_sample(s) for s in j_out]
    assert t_bad == j_bad and t_bad > 0 and t_out


@pytest.mark.parametrize("path", [b"servers.web01.cpu", b"a", b"a.b.c.d.e.f",
                                  b"m3.dc0.host249.cpu_user"])
def test_path_document_roundtrip_equal(path):
    td, jd = tc.path_to_document(path), jc.path_to_document(path)
    assert td.id == jd.id
    assert [(f.name, f.value) for f in td.fields] == \
        [(f.name, f.value) for f in jd.fields]
    assert td.tags() == jd.tags()
    assert tc.document_to_path(td) == jc.document_to_path(jd) == path


@pytest.mark.parametrize("tags", [
    {b"__name__": b"cpu"}, {b"__g0__": b"a", b"__g2__": b"c"}, {},
    {b"__g0__": b"a", b"__g1__": b"b"}])
def test_document_to_path_of_other_docs_equal(tags):
    td = tdoc.Document.from_tags(b"id", tags)
    jd = jdoc.Document.from_tags(b"id", tags)
    assert tc.document_to_path(td) == jc.document_to_path(jd)


def _serve(mod, inst, payloads):
    """Feed each payload on its own connection to the package's carbon
    listener, one connection at a time (the next once the listener has
    taken the last); returns what its sink saw and its counters."""
    got = []
    reg = inst.new_registry()
    srv = mod.serve_carbon_background(
        lambda d, t, v: got.append((
            [x.id for x in d], [[(f.name, f.value) for f in x.fields] for x in d],
            t.copy(), v.copy())),
        instrument=reg.scope("m3"), now_nanos=lambda: 99)

    def taken():
        snap = reg.snapshot()
        return sum(v for k, v in snap.items()
                   if "carbon" in k and ("samples" in k or "oversized" in k))

    try:
        want = 0
        for p in payloads:
            with socket.create_connection(("127.0.0.1", srv.port)) as s:
                for k in range(0, len(p), 777):  # split mid-line
                    s.sendall(p[k:k + 777])
            want += (1 if len(p.split(b"\n")[-1]) > mod.MAX_LINE
                     else len(mod.parse_lines(p, 99)[0]))
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and taken() < want:
                time.sleep(0.01)
        counters = {k: v for k, v in reg.snapshot().items() if "carbon" in k}
    finally:
        srv.shutdown()
        srv.server_close()
    return got, counters


def test_tcp_listener_equal():
    rng = np.random.default_rng(5)
    good = b"".join(b"servers.web%02d.cpu %r %d\n" % (i % 7, float(v), 1_700_000_000 + i)
                    for i, v in enumerate(rng.normal(0, 100, 3000)))
    mixed = b"a.b 1 2\nbogus line\nc.d 3 -1\nx nan 5\ne.f 4 5"  # no final newline
    huge = b"y" * (tc.MAX_LINE + 10)                            # newline-free
    payloads = [good, mixed, huge]
    t_got, t_ctr = _serve(tc, tinst, payloads)
    j_got, j_ctr = _serve(jc, jinst, payloads)

    def flat(got):
        ids = [i for g in got for i in g[0]]
        fields = [f for g in got for f in g[1]]
        ts = np.concatenate([g[2] for g in got])
        vals = np.concatenate([g[3] for g in got])
        return ids, fields, ts, vals

    ti, tf, tt, tv = flat(t_got)
    ji, jf, jt, jv = flat(j_got)
    assert ti == ji and tf == jf and len(ti) == 3000 + 3
    assert tt.dtype == jt.dtype == np.int64 and (tt == jt).all()
    assert tv.dtype == jv.dtype == np.float64
    np.testing.assert_array_equal(tv, jv)
    assert t_ctr == j_ctr
    assert any("oversized" in k for k in t_ctr)


def test_server_attributes_equal():
    for mod in (tc, jc):
        srv = mod.CarbonServer(lambda *a: None)
        try:
            assert srv.port > 0 and srv.daemon_threads and srv.allow_reuse_address
            assert srv.scope is None
        finally:
            srv.server_close()
    assert tc.MAX_LINE == jc.MAX_LINE
