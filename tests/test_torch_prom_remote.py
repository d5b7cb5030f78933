"""m3_tpu_torch.server.{snappy, prom_remote, influx} against the JAX
package's modules on the CPU.

``snappy.decompress`` must give the same bytes on the copies fixture of
``tests/test_prom_remote.py`` and on seeded random streams that use every
element form (short and long literals, 1-, 2- and 4-byte-offset copies,
overlapping copies); both packages must reject the same corrupt streams;
``compress`` must be byte-equal.  Write and read requests and read
responses built by one package must be byte-equal to the other's and
parse to equal values both ways.  Influx lines must parse to equal points
and equal tagged writes.
"""

import numpy as np
import pytest

from m3_tpu.server import influx as jinflux
from m3_tpu.server import prom_remote as jpr
from m3_tpu.server import snappy as jsnappy
from m3_tpu_torch.server import influx as tinflux
from m3_tpu_torch.server import prom_remote as tpr
from m3_tpu_torch.server import snappy as tsnappy

BLOCK = 2 * 3600 * 10**9
START = (1_700_000_000 * 10**9) // BLOCK * BLOCK


def _copies_fixture() -> bytes:
    """tests/test_prom_remote.py's stream: a literal, a copy of it, and
    an overlapping run-length copy (15 bytes out)."""
    body = bytearray(jsnappy._write_uvarint(15))
    body += bytes([3 << 2]) + b"abcd"
    body += bytes([(0 << 5) | (0 << 2) | 1, 4])
    body += bytes([0 << 2]) + b"x"
    body += bytes([(2 << 2) | 1, 1])
    return bytes(body)


def _random_stream(seed: int) -> tuple[bytes, bytes]:
    """A valid snappy stream with every element form, and its output."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    body = bytearray()
    for _ in range(60):
        kind = int(rng.integers(0, 5)) if out else 0
        if kind == 0:  # literal, short or long length
            n = int(rng.choice([1, 7, 60, 61, 200, 300, 70000 // 64]))
            lit = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            m = n - 1
            if m < 60:
                body.append(m << 2)
            elif m < 256:
                body += bytes([60 << 2, m])
            else:
                body += bytes([61 << 2]) + m.to_bytes(2, "little")
            body += lit
            out += lit
            continue
        off = int(rng.integers(1, min(len(out), 2047) + 1))
        if kind == 1:  # copy, 1-byte offset (11 bits), length 4..11
            ln = int(rng.integers(4, 12))
            body += bytes([((off >> 8) << 5) | ((ln - 4) << 2) | 1, off & 0xFF])
        elif kind in (2, 4):  # copy, 2-byte offset, length 1..64
            ln = int(rng.integers(1, 65))
            if kind == 4:
                off = int(rng.integers(1, 4))  # overlapping run
            body += bytes([((ln - 1) << 2) | 2]) + off.to_bytes(2, "little")
        else:  # copy, 4-byte offset
            ln = int(rng.integers(1, 65))
            off = int(rng.integers(1, len(out) + 1))
            body += bytes([((ln - 1) << 2) | 3]) + off.to_bytes(4, "little")
        for i in range(ln):
            out.append(out[len(out) - off])
    return jsnappy._write_uvarint(len(out)) + bytes(body), bytes(out)


def test_decompress_copies_fixture():
    data = _copies_fixture()
    assert tsnappy.decompress(data) == jsnappy.decompress(data) == \
        b"abcdabcdx" + b"x" * 6


@pytest.mark.parametrize("seed", range(6))
def test_decompress_every_element_form(seed):
    data, want = _random_stream(seed)
    assert jsnappy.decompress(data) == want
    assert tsnappy.decompress(data) == want


@pytest.mark.parametrize("bad", [
    b"\x0b" + bytes([3 << 2]) + b"ab",            # truncated literal
    jsnappy._write_uvarint(4) + bytes([1, 9]),       # copy before output
    jsnappy._write_uvarint(9) + bytes([0]) + b"a",   # length mismatch
    jsnappy._write_uvarint(70) + bytes([62 << 2, 1]),  # truncated length
])
def test_corrupt_streams_raise_the_same(bad):
    with pytest.raises(jsnappy.SnappyError) as je:
        jsnappy.decompress(bad)
    with pytest.raises(tsnappy.SnappyError) as te:
        tsnappy.decompress(bad)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("n", [0, 1, 59, 60, 255, 256, 65536, 65537, 200_000])
def test_compress_byte_equal(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert tsnappy.compress(data) == jsnappy.compress(data)
    assert tsnappy.decompress(tsnappy.compress(data)) == data


def _series(mod, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        labels = {b"__name__": b"m3_req_bucket", b"group": b"g%03d" % i,
                  b"le": [b"0.1", b"1", b"+Inf"][i % 3], b"\xc3\xa9": b"\x00v"}
        ts = START + np.cumsum(rng.integers(1, 20_000, 9)) * 10**6
        vals = rng.normal(0, 1e6, 9)
        vals[::4] = [np.nan, -0.0, np.inf][i % 3]
        out.append(mod.PromTimeSeries(labels, list(zip(ts.tolist(), vals.tolist()))))
    out.append(mod.PromTimeSeries({b"x": b"y"}, [(-5 * 10**6, 1.5)]))  # pre-1970
    return out


def _same_series(a, b) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.labels == y.labels
        assert np.array_equal(np.array(x.samples, dtype=object)[:, 0].astype(np.int64),
                              np.array(y.samples, dtype=object)[:, 0].astype(np.int64))
        xv = np.array([v for _, v in x.samples]).view(np.uint64)
        yv = np.array([v for _, v in y.samples]).view(np.uint64)
        assert np.array_equal(xv, yv)


def test_write_request_bytes_and_parse_both_ways():
    tb = tpr.build_write_request(_series(tpr, 1))
    jb = jpr.build_write_request(_series(jpr, 1))
    assert tb == jb
    _same_series(tpr.parse_write_request(jb), jpr.parse_write_request(tb))
    _same_series(tpr.parse_write_request(tb), _series(tpr, 1))


def _read_request(mod, queries) -> bytes:
    out = b""
    for start, end, matchers in queries:
        mparts = b"".join(
            mod._emit_len(3, mod._emit_field(1, 0, mod._emit_varint(t))
                          + mod._emit_len(2, n) + mod._emit_len(3, v))
            for t, n, v in matchers)
        q = (mod._emit_field(1, 0, mod._emit_varint(start // 10**6 & (2**64 - 1)))
             + mod._emit_field(2, 0, mod._emit_varint(end // 10**6)) + mparts)
        out += mod._emit_len(1, q)
    return mod.snappy.compress(out)


def test_read_request_and_response_both_ways():
    queries = [(START, START + 60 * 10**9,
                [(0, b"__name__", b"m3_req_bucket"), (2, b"group", b"g0[0-4]")]),
               (-10**9, START, [(1, b"le", b"+Inf"), (3, b"x", b".*")])]
    tb, jb = _read_request(tpr, queries), _read_request(jpr, queries)
    assert tb == jb
    tq, jq = tpr.parse_read_request(jb), jpr.parse_read_request(tb)
    assert [(q.start_nanos, q.end_nanos,
             [(m.type, m.name, m.value) for m in q.matchers]) for q in tq] == \
        [(q.start_nanos, q.end_nanos,
          [(m.type, m.name, m.value) for m in q.matchers]) for q in jq]
    assert tq[1].start_nanos == -10**9
    tr = tpr.build_read_response([_series(tpr, 2), [], _series(tpr, 3)[:2]])
    jr = jpr.build_read_response([_series(jpr, 2), [], _series(jpr, 3)[:2]])
    assert tr == jr


INFLUX = """
# comment line
cpu,host=a,region=us\\ west usage_user=12.5,usage_sys=3i 1700000000000000000
cpu,host=b value=1,ok=true,msg="quoted \\" str",f=-1.5e3 1700000001000000000
mem\\,x,host=a used=1u
weather,loc=x\\=y temp=20.1,__name__=9 1700000002000000000
"""


@pytest.mark.parametrize("precision", ["ns", "us", "ms", "s"])
def test_influx_lines_parse_the_same(precision):
    body = INFLUX
    if precision != "ns":
        body = body.replace("000000000 ", " ").replace("000000000\n", "\n")
    now = 1_700_000_050 * 10**9
    jp = jinflux.parse_lines(body, precision, now_nanos=now)
    tp = tinflux.parse_lines(body, precision, now_nanos=now)
    assert [(p.measurement, p.tags, p.fields, p.timestamp_nanos) for p in tp] == \
        [(p.measurement, p.tags, p.fields, p.timestamp_nanos) for p in jp]
    jd, jts, jv = jinflux.points_to_writes(jp)
    td, tts, tv = tinflux.points_to_writes(tp)
    assert [(d.id, sorted(d.tags().items())) for d in td] == \
        [(d.id, sorted(d.tags().items())) for d in jd]
    assert tts == jts and tv == jv


@pytest.mark.parametrize("bad", ["cpu", "cpu,host=a", "cpu x=", "cpu x=1 notatime",
                                 "cpu x=\"open"])
def test_influx_errors_the_same(bad):
    with pytest.raises(jinflux.LineProtocolError) as je:
        jinflux.parse_lines(bad, now_nanos=1)
    with pytest.raises(tinflux.LineProtocolError) as te:
        tinflux.parse_lines(bad, now_nanos=1)
    assert str(te.value) == str(je.value)
