"""The port's wire data plane against the JAX package's: the framed
protocol (``m3_tpu_torch/msg/protocol.py``), the TCP ingest server
(``server/ingest_tcp.py``), the shard-routed client
(``client/aggregator_client.py``) and the trace preamble.

Every payload is compared byte for byte with ``m3_tpu.msg.protocol``'s
on the same inputs, and every decoder outcome — the decoded fields bit
for bit, or the exception's type and message — on valid, truncated,
padded and forged payloads.  The socket paths run both packages' servers
and clients on the same traffic (the port's aggregator on the CPU) and
compare what each aggregator flushes, exactly: routing, replica fan-out,
acks and backoff, the corrupt-frame reconnect, timed batches on an
injected server clock, passthrough and forwarded batches, and a frame's
``agg_id``, which both servers ignore.
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest

import m3_tpu.aggregator.engine as je
import m3_tpu.client.aggregator_client as jclient
import m3_tpu.cluster.placement as jplace
import m3_tpu.instrument as jinst
import m3_tpu.instrument.tracing as jtr
import m3_tpu.metrics.aggregation as jagg
import m3_tpu.metrics.pipeline as jpipe
import m3_tpu.metrics.policy as jpol
import m3_tpu.metrics.transformation as jtf
import m3_tpu.metrics.types as jtypes
import m3_tpu.msg.protocol as jwire
import m3_tpu.server.ingest_tcp as jingest
import m3_tpu_torch.aggregator.engine as te
import m3_tpu_torch.client.aggregator_client as tclient
import m3_tpu_torch.cluster.placement as tplace
import m3_tpu_torch.instrument as tinst
import m3_tpu_torch.instrument.tracing as ttr
import m3_tpu_torch.metrics.aggregation as tagg
import m3_tpu_torch.metrics.pipeline as tpipe
import m3_tpu_torch.metrics.policy as tpol
import m3_tpu_torch.metrics.transformation as ttf
import m3_tpu_torch.metrics.types as ttypes
import m3_tpu_torch.msg.protocol as twire
import m3_tpu_torch.server.ingest_tcp as tingest
from m3_tpu_torch.x import lockcheck
from m3_tpu_torch.x import fault as tfault

SEC = 10**9
WINDOW = 10 * SEC
T0 = 1_700_000_000 * SEC // WINDOW * WINDOW

PKGS = {
    "jax": dict(eng=je, client=jclient, place=jplace, inst=jinst, tr=jtr, agg=jagg,
                pipe=jpipe, pol=jpol, tf=jtf, types=jtypes, wire=jwire, ingest=jingest,
                kw={}),
    "port": dict(eng=te, client=tclient, place=tplace, inst=tinst, tr=ttr, agg=tagg,
                 pipe=tpipe, pol=tpol, tf=ttf, types=ttypes, wire=twire, ingest=tingest,
                 kw={"device": "cpu"}),
}


def outcome(fn, *a):
    """("ok", result) or ("raise", type name, message)."""
    try:
        return ("ok", fn(*a))
    except Exception as e:  # noqa: BLE001 — the outcome is the datum
        return ("raise", type(e).__name__, str(e))


def batch_key(b):
    return (np.asarray(b.metric_types).dtype.str, np.asarray(b.metric_types).tolist(),
            [(type(i).__name__, bytes(i)) for i in b.ids],
            np.asarray(b.values).dtype.str, np.asarray(b.values).view(np.uint64).tolist(),
            np.asarray(b.times).dtype.str, np.asarray(b.times).tolist(), b.agg_id)


def same_decode(fn_j, fn_t, raw, key=batch_key):
    j, t = outcome(fn_j, raw), outcome(fn_t, raw)
    if j[0] == "ok" and t[0] == "ok":
        return key(j[1]) == key(t[1])
    return j == t


def random_ids(rng, n, uniform):
    if uniform:
        L = int(rng.integers(0, 40))
        return [rng.bytes(L) for _ in range(n)]
    return [rng.bytes(int(k)) for k in rng.integers(0, 40, n)]


def random_values(rng, n):
    v = rng.normal(0, 1e6, n)
    bits = rng.integers(0, 1 << 63, n, dtype=np.int64).view(np.float64)
    special = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 5e-324, 1.7976931348623157e308])
    pick = rng.integers(0, 3, n)
    return np.where(pick == 0, v, np.where(pick == 1, bits, special[rng.integers(0, 7, n)]))


def random_batch(P, rng, n, uniform=False, agg_id=None):
    w = P["wire"]
    return w.MetricBatch(
        rng.integers(0, 256, n).astype(np.uint8), random_ids(rng, n, uniform),
        random_values(rng, n),
        rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64),
        int(rng.integers(0, 1 << 63)) if agg_id is None else agg_id)


CASES = [  # (seed, samples, uniform id lengths)
    (0, 0, False), (1, 1, False), (2, 7, True), (3, 64, False), (4, 1000, True),
    (5, 1000, False), (6, 100_000, True), (7, 30_000, False),
]


# -- the framed protocol ---------------------------------------------------


def test_frame_type_numbers_match():
    names = ("METRIC_BATCH", "BUS_HELLO", "BUS_PUBLISH", "BUS_DELIVER", "BUS_ACK", "OK",
             "ERROR", "TIMED_BATCH", "PASSTHROUGH_BATCH", "FORWARDED_BATCH",
             "INGEST_HELLO", "INGEST_ACK", "INGEST_BACKOFF", "INGEST_TRACE",
             "HELLO_WANT_ACKS", "MAX_FRAME")
    assert {n: getattr(twire, n) for n in names} == {n: getattr(jwire, n) for n in names}
    assert issubclass(twire.ProtocolError, ConnectionError)


def _sent_bytes(w, ftype, payload):
    a, b = socket.socketpair()
    try:
        w.send_frame(a, ftype, payload)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while chunk := b.recv(1 << 20):
            out += chunk
        return out
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("payload", [b"", b"hello", bytes(range(256)) * 300])
def test_send_frame_bytes_and_cross_recv(payload):
    assert _sent_bytes(twire, 5, payload) == _sent_bytes(jwire, 5, payload)
    for tx, rx in ((jwire, twire), (twire, jwire)):
        a, b = socket.socketpair()
        tx.send_frame(a, twire.METRIC_BATCH, payload)
        assert rx.recv_frame(b) == (twire.METRIC_BATCH, payload)
        a.close()
        assert rx.recv_frame(b) is None  # clean EOF
        b.close()


@pytest.mark.parametrize("raw", [
    struct.pack("<IBI", 3, 1, 0xDEADBEEF) + b"xyz",           # checksum
    struct.pack("<IBI", (64 << 20) + 1, 1, 0),                  # too large
    struct.pack("<IBI", 10, 1, 0) + b"abc",                     # EOF mid-frame
    b"\x01\x02",                                                # torn header
])
def test_recv_frame_errors_match(raw):
    got = []
    for w in (jwire, twire):
        a, b = socket.socketpair()
        a.sendall(raw)
        a.close()
        got.append(outcome(w.recv_frame, b))
        b.close()
    assert got[0] == got[1]
    assert got[1][0] == "raise" or got[1] == ("ok", None)


# -- payload codecs ---------------------------------------------------------


@pytest.mark.parametrize("seed,n,uniform", CASES)
def test_metric_batch_bytes_and_decode(seed, n, uniform):
    bj = random_batch(PKGS["jax"], np.random.default_rng(seed), n, uniform)
    bt = random_batch(PKGS["port"], np.random.default_rng(seed), n, uniform)
    raw = jwire.encode_metric_batch(bj)
    assert twire.encode_metric_batch(bt) == raw
    assert same_decode(jwire.decode_metric_batch, twire.decode_metric_batch, raw)
    got = twire.decode_metric_batch(raw)
    assert batch_key(got)[2] == [("bytes", i) for i in bt.ids]
    assert np.array_equal(got.values.view(np.uint64), bt.values.view(np.uint64))


def test_metric_batch_lists_and_other_dtypes_encode_alike():
    rng = np.random.default_rng(11)
    ids = random_ids(rng, 50, False)
    forms = [
        (list(range(50)), ids, [float(x) for x in random_values(rng, 50)],
         list(range(T0, T0 + 50))),
        (np.arange(50, dtype=np.int64), ids, rng.normal(0, 1e3, 50).astype(np.float32),
         np.arange(50, dtype=np.int32)),
        (np.arange(50, dtype=np.uint16), [bytearray(i) for i in ids],
         np.arange(50, dtype=np.int64), np.arange(50, dtype=np.uint64)),
        (np.ones(50, bool), ids, random_values(rng, 50), np.arange(50, dtype=np.int64)),
    ]
    for mts, i, v, t in forms:
        a = outcome(jwire.encode_metric_batch, jwire.MetricBatch(mts, i, v, t, 3))
        b = outcome(twire.encode_metric_batch, twire.MetricBatch(mts, i, v, t, 3))
        assert a == b and a[0] == "ok"


@pytest.mark.parametrize("form", ["arrays", "lists", "int_values"])
def test_array_form_takes_lists_and_uniform_ids_without_the_loop(form, monkeypatch):
    """The per-sample loops run only for what the array form refuses:
    arrays and lists encode, and payloads of one id length decode,
    with the loops disabled, into the reference's bytes and batches."""
    def refuse(*a):
        raise AssertionError("the per-sample loop ran")

    for name in ("_encode_metric_batch_loop", "_decode_metric_batch_loop",
                 "_encode_passthrough_loop", "_decode_passthrough_loop"):
        monkeypatch.setattr(twire, name, refuse)
    rng = np.random.default_rng(12)
    for uniform in (True, False):
        ids = random_ids(rng, 300, uniform)
        mts = rng.integers(0, 256, 300)
        vals = (rng.integers(-(1 << 62), 1 << 62, 300) if form == "int_values"
                else random_values(rng, 300))
        ts = rng.integers(-(1 << 63), (1 << 63) - 1, 300, dtype=np.int64)
        if form == "lists":
            mts, vals, ts = mts.tolist(), vals.tolist(), ts.tolist()
        raw = jwire.encode_metric_batch(jwire.MetricBatch(mts, ids, vals, ts, 9))
        assert twire.encode_metric_batch(twire.MetricBatch(mts, ids, vals, ts, 9)) == raw
        raw_pt = jwire.encode_passthrough_batch("1m:40d", ids, vals, ts)
        assert twire.encode_passthrough_batch("1m:40d", ids, vals, ts) == raw_pt
        if uniform:
            assert batch_key(twire.decode_metric_batch(raw)) == \
                batch_key(jwire.decode_metric_batch(raw))
            assert pt_key(twire.decode_passthrough_batch(raw_pt)) == \
                pt_key(jwire.decode_passthrough_batch(raw_pt))


@pytest.mark.parametrize("bad", ["mt256", "mt_neg", "long_id", "str_id", "time_u64",
                                 "agg_neg", "agg_big", "short_values"])
def test_metric_batch_encode_errors_match(bad):
    def make(P):
        b = random_batch(P, np.random.default_rng(3), 20)
        mts, ids, vals, ts, agg = b.metric_types, list(b.ids), b.values, b.times, 0
        if bad == "mt256":
            mts = mts.astype(np.int64)
            mts[7] = 256
        elif bad == "mt_neg":
            mts = mts.astype(np.int64)
            mts[3] = -1
        elif bad == "long_id":
            ids[5] = b"x" * 70_000
        elif bad == "str_id":
            ids[2] = "text"
        elif bad == "time_u64":
            ts = ts.astype(np.uint64)
            ts[9] = np.uint64(1 << 63)
        elif bad == "agg_neg":
            agg = -1
        elif bad == "agg_big":
            agg = 1 << 64
        elif bad == "short_values":
            vals = vals[:10]
        return P["wire"].MetricBatch(mts, ids, vals, ts, agg)

    a = outcome(jwire.encode_metric_batch, make(PKGS["jax"]))
    b = outcome(twire.encode_metric_batch, make(PKGS["port"]))
    assert a == b and a[0] == "raise", (a, b)


def _forged(raw):
    """Truncations, trailing bytes and forged counts of one payload."""
    out = [raw[:k] for k in range(len(raw))] + [raw + b"\x00", raw + b"\x00" * 19]
    n = struct.unpack_from("<I", raw, 0)[0]
    for m in (n + 1, max(n - 1, 0), n + 1000, 10**6):
        out.append(struct.pack("<I", m) + raw[4:])
    return out


def test_metric_batch_decoder_rejects_what_jax_rejects():
    rng = np.random.default_rng(5)
    for uniform in (True, False):
        raw = jwire.encode_metric_batch(random_batch(PKGS["jax"], rng, 6, uniform))
        forged = _forged(raw)
        # an id length that points past the payload, and one that shrinks it
        forged += [raw[:13] + b"\xff\x7f" + raw[15:], raw[:13] + b"\x00\x00" + raw[15:]]
        for f in forged:
            assert same_decode(jwire.decode_metric_batch, twire.decode_metric_batch, f), f
        assert same_decode(jwire.decode_metric_batch, twire.decode_metric_batch,
                           bytearray(raw))


def pt_key(r):
    policy, ids, values, times = r
    return (policy, [(type(i).__name__, bytes(i)) for i in ids],
            np.asarray(values).dtype.str, np.asarray(values).view(np.uint64).tolist(),
            np.asarray(times).dtype.str, np.asarray(times).tolist())


@pytest.mark.parametrize("seed,n,uniform", CASES)
def test_passthrough_batch_bytes_and_decode(seed, n, uniform):
    rng = np.random.default_rng(seed)
    ids, vals = random_ids(rng, n, uniform), random_values(rng, n)
    ts = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    raw = jwire.encode_passthrough_batch("1m:40d", ids, vals, ts)
    assert twire.encode_passthrough_batch("1m:40d", ids, vals, ts) == raw
    assert twire.encode_passthrough_batch("1m:40d", ids, list(vals), list(ts)) == raw
    assert same_decode(jwire.decode_passthrough_batch, twire.decode_passthrough_batch,
                       raw, pt_key)
    if n <= 64:
        for f in _forged_pt(raw):
            assert same_decode(jwire.decode_passthrough_batch,
                               twire.decode_passthrough_batch, f, pt_key), f


def _forged_pt(raw):
    lp, n = struct.unpack_from("<HI", raw, 0)
    out = [raw[:k] for k in range(len(raw))] + [raw + b"\x00"]
    for m in (n + 1, max(n - 1, 0), 10**6):
        out.append(raw[:2] + struct.pack("<I", m) + raw[6:])
    out += [struct.pack("<H", lp + 3) + raw[2:], struct.pack("<H", 60000) + raw[2:],
            raw[:6] + b"\xff\xfe" + raw[8:]]  # a policy that is not UTF-8
    return out


def test_passthrough_encode_errors_match():
    for args in (("p", [b"a", "b"], [1.0, 2.0], [1, 2]),
                 ("p", [b"a", b"b"], [1.0], [1, 2]),
                 ("x" * 70_000, [b"a"], [1.0], [1]),
                 ("p", [b"a"], np.array([1.0]), np.array([1 << 63], np.uint64))):
        a = outcome(jwire.encode_passthrough_batch, *args)
        b = outcome(twire.encode_passthrough_batch, *args)
        assert a == b and a[0] == "raise", (a, b)


def _entries(P):
    sum_id = P["agg"].AggregationID.compress([P["agg"].AggregationType.SUM])
    pipe, tf = P["pipe"], P["tf"].TransformationType
    return [
        (P["eng"].ForwardSpec(b"r2{dc=us}", sum_id, (
            pipe.TransformationOp(tf.PER_SECOND), pipe.AppliedRollupOp(b"r3{}", sum_id))),
         2.5, T0),
        (P["eng"].ForwardSpec(b"", P["agg"].AggregationID.DEFAULT, ()), float("nan"),
         T0 + 1),
        (P["eng"].ForwardSpec(b"x" * 300, sum_id, (pipe.TransformationOp(tf.INCREASE),)),
         -0.0, -5),
    ]


def fw_key(r):
    policy, entries = r
    return (policy, [(s.id, int(s.aggregation_id),
                      tuple((type(o).__name__, getattr(o, "id", None),
                             int(getattr(o, "aggregation_id", 0)),
                             int(getattr(o, "type", 0))) for o in s.tail),
                      np.float64(v).view(np.uint64).item(), ts)
                     for s, v, ts in entries])


def test_forwarded_batch_bytes_and_decode():
    raw = jwire.encode_forwarded_batch("10s:2d", _entries(PKGS["jax"]))
    assert twire.encode_forwarded_batch("10s:2d", _entries(PKGS["port"])) == raw
    assert fw_key(twire.decode_forwarded_batch(raw)) == fw_key(
        jwire.decode_forwarded_batch(raw))
    for f in [raw[:k] for k in range(0, len(raw), 7)] + [raw + b"\x00",
                                                         raw[:6 + 6 + 2] + b"\x07" + raw[15:]]:
        a, b = outcome(jwire.decode_forwarded_batch, f), outcome(twire.decode_forwarded_batch, f)
        if a[0] == "ok":
            assert b[0] == "ok" and fw_key(a[1]) == fw_key(b[1])
        else:
            assert a == b


def test_small_payload_codecs_match():
    for name, args in [("encode_ingest_hello", ()), ("encode_ingest_hello", (0,)),
                       ("encode_ingest_ack", (65536,)), ("encode_ingest_backoff", (50,)),
                       ("encode_ingest_trace", (b"\x01" * 17,)),
                       ("encode_bus_hello", ("coordinator", "c-1")),
                       ("encode_bus_publish", (7, b"body")),
                       ("encode_bus_deliver", (1 << 40, 3, b"body")),
                       ("encode_bus_ack", (12345,)), ("encode_ingest_ack", (-1,))]:
        assert outcome(getattr(twire, name), *args) == outcome(getattr(jwire, name), *args)
    for name, raw in [("decode_ingest_hello", b"\x01\x00\x00\x00"),
                      ("decode_ingest_ack", b"\x05\x00"), ("decode_ingest_backoff", b"\x32\0\0\0"),
                      ("decode_bus_hello", jwire.encode_bus_hello("s", "i")),
                      ("decode_bus_hello", b"\x05\x00\x01\x00ab"),
                      ("decode_bus_publish", b"\x01\0\0\0xyz"), ("decode_bus_deliver", b"\0" * 11),
                      ("decode_bus_deliver", jwire.encode_bus_deliver(9, 2, b"p")),
                      ("decode_bus_ack", b"\0" * 8), ("decode_bus_ack", b"\0" * 7)]:
        assert outcome(getattr(twire, name), raw) == outcome(getattr(jwire, name), raw), name


def test_trace_context_wire_form_and_preamble():
    ctx_j = jtr.TraceContext((1 << 64) + 77, 5, True)
    ctx_t = ttr.TraceContext((1 << 64) + 77, 5, True)
    assert ttr.TraceContext.WIRE_SIZE == jtr.TraceContext.WIRE_SIZE == 17
    assert ctx_t.to_wire() == ctx_j.to_wire()
    assert ttr.TraceContext(3, 4, False).to_wire() == jtr.TraceContext(3, 4, False).to_wire()
    raw = ctx_j.to_wire()
    assert twire.decode_ingest_trace(raw) == ttr.TraceContext(77, 5, True)
    assert ttr.TraceContext.from_wire(b"\0" + raw, 1) == ttr.TraceContext(77, 5, True)
    assert outcome(twire.decode_ingest_trace, raw[:16])[:2] == \
        outcome(jwire.decode_ingest_trace, raw[:16])[:2] == ("raise", "ProtocolError")
    for P in PKGS.values():
        tr = P["tr"]
        assert tr.current_wire() == b"" and tr.current_wire(b"d") == b"d"
        with tr.bind(tr.TraceContext(9, 8, False)):
            assert tr.current_wire() == b""
        with tr.bind(tr.TraceContext(9, 8, True)):
            assert tr.current_wire() == jtr.TraceContext(9, 8).to_wire()


# -- the socket paths: both packages, the same traffic -----------------------


def small_opts(P, **kw):
    return P["eng"].AggregatorOptions(
        capacity=256, num_windows=4, timer_sample_capacity=1 << 12,
        storage_policies=(P["pol"].StoragePolicy.parse("10s:2d"),), **kw)


def wait_samples(reg, n, timeout=120.0):
    """The samples counter moves only after the sink returned."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if reg.snapshot().get("ingest_tcp.samples", 0) >= n:
            return
        time.sleep(0.02)
    raise AssertionError(f"server never processed {n} samples: {reg.snapshot()}")


def flushed(agg, target):
    """Every flushed row as (id, timestamp, metric type, aggregation
    type, value bits), sorted."""
    rows = []

    def handler(ml, f):
        m = ml.maps[f.metric_type]
        for slot, at, v in zip(f.slots.tolist(), f.types.tolist(), f.values.tolist()):
            rows.append((m.id_of(int(slot)), f.timestamp_nanos, int(f.metric_type),
                         int(at), np.float64(v).view(np.uint64).item()))

    agg.consume(target, handler)
    return sorted(rows)


def traffic(n=40, seed=0):
    rng = np.random.default_rng(seed)
    ids = [b"svc.req{host=h%02d}" % (i % 13) + b".%d" % i for i in range(n)]
    mts = np.array([1, 2, 3])[np.arange(n) % 3].astype(np.uint8)  # counter, timer, gauge
    vals = np.round(rng.normal(50, 20, n), 3)
    ts = T0 + 1 + rng.integers(0, 2 * WINDOW, n)
    return mts, ids, vals, ts.astype(np.int64)


def cluster(P, rf, n_inst=2, num_shards=4, clock=None, **agg_kw):
    insts = [P["place"].Instance(f"i{k}", isolation_group=f"g{k}") for k in range(n_inst)]
    placement = P["place"].initial_placement(insts, num_shards=num_shards, rf=rf)
    aggs, servers, regs = {}, {}, {}
    for inst in insts:
        agg = P["eng"].Aggregator(num_shards=num_shards, opts=small_opts(P), **agg_kw, **P["kw"])
        reg = P["inst"].new_registry()
        sink = (P["ingest"].aggregator_sink(agg) if clock is None
                else P["ingest"].aggregator_sink(agg, clock=clock))
        servers[inst.id] = P["ingest"].serve_ingest_background(sink, instrument=reg.scope(""))
        aggs[inst.id], regs[inst.id] = agg, reg
    return placement, aggs, servers, regs, lambda iid: ("127.0.0.1", servers[iid].port)


def close_all(servers, *clients):
    for c in clients:
        c.close()
    for s in servers.values():
        s.shutdown()
        s.server_close()


@pytest.mark.parametrize("rf,n_inst", [(1, 2), (2, 2), (2, 3)])
def test_client_routes_replicates_and_flushes_like_jax(rf, n_inst):
    got = {}
    for name, P in PKGS.items():
        placement, aggs, servers, regs, resolve = cluster(P, rf, n_inst)
        client = P["client"].AggregatorClient(placement, resolve)
        mts, ids, vals, ts = traffic()
        reached = client.write_batch(mts, ids, vals, ts)
        queued = {k: list(q._ids) for k, q in client.queues.items()}
        sent = client.flush()
        per = {}
        for iid in aggs:
            expect = sum(1 for i in ids
                         if iid in {x.id for x in placement.instances_for_shard(
                             P["client"].shard_for(i, placement.num_shards))})
            wait_samples(regs[iid], expect)
            per[iid] = flushed(aggs[iid], T0 + 4 * WINDOW)
        got[name] = (reached, queued, sent, per,
                     {k: (q.sent, q.dropped, q.backoffs) for k, q in client.queues.items()})
        close_all(servers, client)
    assert got["port"] == got["jax"]
    reached, queued, sent, per, _ = got["port"]
    assert reached == sent == rf * 40 and all(per.values())


def test_write_batch_drop_oldest_matches_per_sample_loop():
    """A batch larger than the queue keeps its newest samples and counts
    the rest as dropped, as the per-sample drop-oldest does."""
    insts = [tplace.Instance("i0"), tplace.Instance("i1")]
    placement = tplace.initial_placement(insts, num_shards=8, rf=2)
    a = tclient.AggregatorClient(placement, lambda iid: ("127.0.0.1", 1))
    b = tclient.AggregatorClient(placement, lambda iid: ("127.0.0.1", 1))
    for c in (a, b):
        for inst in insts:
            c._queue_for(inst.id).max_queue_size = 100
    mts, ids, vals, ts = traffic(300, seed=4)
    a.write_batch(mts, ids, vals, ts)
    for i in range(300):
        b.write_untimed(int(mts[i]), ids[i], float(vals[i]), int(ts[i]))
    assert list(a.queues) == list(b.queues)
    for k in a.queues:
        qa, qb = a.queues[k], b.queues[k]
        assert (qa._mts, qa._ids, qa._values, qa._times, qa.dropped) == \
            (qb._mts, qb._ids, qb._values, qb._times, qb.dropped)
        assert qa.dropped == 200


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_hash_and_shard_grouping_match_the_per_id_hash(seed):
    """``core.hash.shards_for`` (the batch routing of the client and of
    ``Aggregator._by_shard``) equals the reference's per-id murmur3 on
    ids of every length 0-40, and ``_by_shard`` equals its loop."""
    import m3_tpu.core.hash as jhash
    from m3_tpu_torch.core import hash as thash

    rng = np.random.default_rng(seed)
    ids = [rng.bytes(int(k)) for k in rng.integers(0, 41, 5000)] + [b"", b"abc"]
    for ns in (1, 7, 64, 1024):
        want = [jhash.shard_for(i, ns) for i in ids]
        assert thash.shards_for(ids, ns).tolist() == want
    assert thash.murmur3_32_many(ids, 99).tolist() == [jhash.murmur3_32(i, 99) for i in ids]
    agg = te.Aggregator(num_shards=7, opts=small_opts(PKGS["port"]), device="cpu")
    loop = {}
    for i, mid in enumerate(ids):
        loop.setdefault(jhash.shard_for(mid, 7), []).append(i)
    assert list(agg._by_shard(ids).items()) == list(loop.items())


def test_shard_routing_matches_murmur3():
    for P in PKGS.values():
        placement, aggs, servers, regs, resolve = cluster(P, 1)
        client = P["client"].AggregatorClient(placement, resolve)
        mid = b"some.metric"
        shard = tclient.shard_for(mid, placement.num_shards)
        assert shard == jclient.shard_for(mid, placement.num_shards)
        owners = [i.id for i in placement.instances_for_shard(shard)]
        assert client.write_untimed(1, mid, 1.0, T0 + 1) == len(owners) == 1
        assert {k[0] for k in client.queues} == set(owners)
        close_all(servers, client)


def _batch(P, ids, agg_id=0, t=T0):
    return P["wire"].encode_metric_batch(P["wire"].MetricBatch(
        np.full(len(ids), 1, np.uint8), list(ids), np.ones(len(ids)),
        np.full(len(ids), t, np.int64), agg_id))


def _backoff_scenario(P):
    gate = threading.Event()
    got = []

    def slow_sink(batch, kind=P["wire"].METRIC_BATCH):
        gate.wait(30)
        got.extend(batch.ids)

    reg = P["inst"].new_registry()
    srv = P["ingest"].serve_ingest_background(
        slow_sink, instrument=reg.scope(""), max_queue_frames=8, per_conn_inflight=1,
        backoff_hint_ms=30)
    w = P["wire"]
    s = socket.create_connection(("127.0.0.1", srv.port))
    s.settimeout(10)
    seen = []
    try:
        w.send_frame(s, w.INGEST_HELLO, w.encode_ingest_hello())
        w.send_frame(s, w.METRIC_BATCH, _batch(P, [b"a"]))
        w.send_frame(s, w.METRIC_BATCH, _batch(P, [b"b"]))
        seen.append(w.recv_frame(s))
        snap = reg.snapshot()
        seen.append((snap.get("ingest_tcp.shed_frames"), snap.get("ingest_tcp.shed_samples")))
        gate.set()
        seen.append(w.recv_frame(s))
        w.send_frame(s, w.METRIC_BATCH, _batch(P, [b"b", b"c"]))
        seen.append(w.recv_frame(s))
        seen.append(list(got))
    finally:
        s.close()
        srv.shutdown()
        srv.server_close()
    return seen


def test_backoff_on_overload_then_acks_like_jax():
    seen = {name: _backoff_scenario(P) for name, P in PKGS.items()}
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == (twire.INGEST_BACKOFF, twire.encode_ingest_backoff(30))
    assert seen["port"][2] == (twire.INGEST_ACK, twire.encode_ingest_ack(1))
    assert seen["port"][4] == [b"a", b"b", b"c"]  # acked == ingested, in order


def _park_scenario(P):
    gate = threading.Event()
    got = []

    def slow_sink(batch, kind=P["wire"].METRIC_BATCH):
        gate.wait(30)
        got.extend(batch.ids)

    reg = P["inst"].new_registry()
    srv = P["ingest"].serve_ingest_background(
        slow_sink, instrument=reg.scope(""), max_queue_frames=1, per_conn_inflight=1,
        backoff_hint_ms=300)
    s = socket.create_connection(("127.0.0.1", srv.port))
    q = None
    try:
        P["wire"].send_frame(s, P["wire"].METRIC_BATCH, _batch(P, [b"x"]))
        deadline = time.monotonic() + 5
        while (reg.snapshot().get("ingest_tcp.queue_depth", 0) < 1
               and time.monotonic() < deadline):
            time.sleep(0.01)
        q = P["client"].InstanceQueue(("127.0.0.1", srv.port))
        q.enqueue(1, b"q1", 1.0, T0)
        q.enqueue(1, b"q2", 2.0, T0)
        first = (q.flush(), q.backoffs, q.sent, q.flush())
        gate.set()
        deadline = time.monotonic() + 10
        n = 0
        while n == 0 and time.monotonic() < deadline:
            n = q.flush()
            time.sleep(0.01)
        return first, n, q.sent, q.backoffs, list(got)
    finally:
        if q is not None:
            q.close()
        s.close()
        srv.shutdown()
        srv.server_close()


def test_instance_queue_parks_on_backoff_no_acked_loss_like_jax():
    got = {name: _park_scenario(P) for name, P in PKGS.items()}
    assert got["port"] == got["jax"] == ((0, 1, 0, 0), 2, 2, 1, [b"x", b"q1", b"q2"])


def _corrupt_then_recover(P):
    placement, aggs, servers, regs, resolve = cluster(P, 1, n_inst=1)
    port = servers["i0"].port
    s = socket.create_connection(("127.0.0.1", port))
    s.sendall(struct.pack("<IBI", 3, P["wire"].METRIC_BATCH, 0xBAD) + b"xyz")
    s.settimeout(5)
    closed = s.recv(1) == b""
    s.close()
    client = P["client"].AggregatorClient(placement, resolve)
    mts, ids, vals, ts = traffic(12, seed=2)
    client.write_batch(mts, ids, vals, ts)
    sent = client.flush()
    wait_samples(regs["i0"], 12)
    out = (closed, sent, regs["i0"].snapshot().get("ingest_tcp.decode_errors"),
           flushed(aggs["i0"], T0 + 4 * WINDOW))
    close_all(servers, client)
    return out


def test_corrupt_frame_closes_conn_and_client_recovers_like_jax():
    got = {name: _corrupt_then_recover(P) for name, P in PKGS.items()}
    assert got["port"] == got["jax"]
    assert got["port"][:3] == (True, 12, 1)


def test_frame_faultpoint_drop_then_client_retries():
    """``ingest_tcp.frame=drop`` kills the connection before decode; the
    client's retrier reconnects and the frame lands once."""
    P = PKGS["port"]
    placement, aggs, servers, regs, resolve = cluster(P, 1, n_inst=1)
    client = P["client"].AggregatorClient(placement, resolve)
    mts, ids, vals, ts = traffic(9, seed=3)
    with tfault.armed("ingest_tcp.frame", "drop", n=1):
        client.write_batch(mts, ids, vals, ts)
        assert client.flush() == 9
    wait_samples(regs["i0"], 9)
    assert regs["i0"].snapshot()["ingest_tcp.samples"] == 9
    assert tfault.counters().get("ingest_tcp.frame.drop_triggers", 0) >= 1
    close_all(servers, client)


def _timed_scenario(P):
    placement, aggs, servers, regs, resolve = cluster(
        P, 1, n_inst=1, clock=lambda: T0 + WINDOW + 1)
    client = P["client"].AggregatorClient(placement, resolve)
    client.write_timed(1, b"timed.c", 3.0, T0 + WINDOW + 1)
    client.write_timed(1, b"timed.c", 4.0, T0 + 1)
    n = client.write_timed_batch(np.array([1, 3, 1], np.uint8), [b"timed.c", b"g", b"old"],
                                 np.array([5.0, 6.0, 7.0]),
                                 np.array([T0 + 2, T0 + 3, T0 - 3600 * SEC], np.int64))
    client.flush()
    wait_samples(regs["i0"], 5)
    out = (n, flushed(aggs["i0"], T0 + 3 * WINDOW), aggs["i0"].counters())
    close_all(servers, client)
    return out


def test_timed_batches_on_the_server_clock_like_jax():
    got = {name: _timed_scenario(P) for name, P in PKGS.items()}
    assert got["port"] == got["jax"]
    rows = got["port"][1]
    sums = {(r[0], r[1]): np.uint64(r[4]).view(np.float64) for r in rows
            if r[3] == int(tagg.AggregationType.SUM)}
    assert sums[(b"timed.c", T0 + WINDOW)] == 9.0
    assert sums[(b"timed.c", T0 + 2 * WINDOW)] == 3.0
    assert got["port"][2]["timed_rejects_too_early"] == 1


def _passthrough_scenario(P):
    got = []
    placement, aggs, servers, regs, resolve = cluster(P, 2, n_inst=2,
                                                      passthrough_handler=got.append)
    client = P["client"].AggregatorClient(placement, resolve)
    sp = P["pol"].StoragePolicy.parse("1m:40d")
    ids = [b"pre.agg.%d" % i for i in range(30)]
    n = client.write_passthrough(ids, np.arange(30) * 0.5, np.full(30, T0), sp)
    deadline = time.monotonic() + 10
    while len(got) < 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    out = (n, sorted((str(b.policy), list(b.ids), b.values.tolist(), b.times.tolist())
                     for b in got),
           [aggs[i].consume(10**30) for i in aggs])
    close_all(servers, client)
    return out


def test_passthrough_over_socket_like_jax():
    got = {name: _passthrough_scenario(P) for name, P in PKGS.items()}
    assert got["port"] == got["jax"]
    n, batches, consumed = got["port"]
    assert n == 2 and len(batches) == 2 and consumed == [[], []]


def _forwarded_scenario(P):
    sp = P["pol"].StoragePolicy.parse("10s:2d")
    placement, aggs, servers, regs, resolve = cluster(P, 1, n_inst=1)
    sum_id = P["agg"].AggregationID.compress([P["agg"].AggregationType.SUM])
    entries = [(P["eng"].ForwardSpec(b"stage2.%d" % (i % 3), sum_id, ()), float(i), T0 + i)
               for i in range(12)]
    s = socket.create_connection(("127.0.0.1", servers["i0"].port))
    P["wire"].send_frame(s, P["wire"].FORWARDED_BATCH,
                         P["wire"].encode_forwarded_batch(str(sp), entries))
    wait_samples(regs["i0"], 12)
    out = flushed(aggs["i0"], T0 + 2 * WINDOW)
    s.close()
    close_all(servers)
    return out


def test_forwarded_over_socket_like_jax():
    got = {name: _forwarded_scenario(P) for name, P in PKGS.items()}
    assert got["port"] == got["jax"] and len(got["port"]) == 3


def _agg_id_scenario(P, agg_id):
    placement, aggs, servers, regs, resolve = cluster(P, 1, n_inst=1)
    s = socket.create_connection(("127.0.0.1", servers["i0"].port))
    ids = [b"c.%d" % i for i in range(6)]
    P["wire"].send_frame(s, P["wire"].METRIC_BATCH, _batch(P, ids, agg_id, T0 + 1))
    wait_samples(regs["i0"], 6)
    out = flushed(aggs["i0"], T0 + 2 * WINDOW)
    s.close()
    close_all(servers)
    return out


def test_frame_agg_id_is_ignored_by_both_servers():
    """``aggregator_sink`` never passes a frame's ``agg_id`` on: a frame
    asking for Max and Count flushes the counter default (Sum) in both
    packages, as a frame with ``agg_id`` 0 does."""
    want = int(jagg.AggregationID.compress([jagg.AggregationType.MAX,
                                            jagg.AggregationType.COUNT]))
    got = {name: (_agg_id_scenario(P, want), _agg_id_scenario(P, 0))
           for name, P in PKGS.items()}
    assert got["port"] == got["jax"]
    asked, default = got["port"]
    assert asked == default
    assert {r[3] for r in asked} == {int(tagg.AggregationType.SUM)}


def _sink_error_scenario(P):
    agg = P["eng"].Aggregator(num_shards=1, opts=small_opts(P), **P["kw"])
    reg = P["inst"].new_registry()
    srv = P["ingest"].serve_ingest_background(P["ingest"].aggregator_sink(agg),
                                              instrument=reg.scope(""))
    s = socket.create_connection(("127.0.0.1", srv.port))
    P["wire"].send_frame(s, P["wire"].PASSTHROUGH_BATCH,
                         P["wire"].encode_passthrough_batch("1m:40d", [b"x"], [1.0], [T0]))
    deadline = time.monotonic() + 5
    while (reg.snapshot().get("ingest_tcp.sink_errors", 0) < 1
           and time.monotonic() < deadline):
        time.sleep(0.02)
    s.settimeout(2)
    closed = s.recv(1) == b""
    s.close()
    srv.shutdown()
    srv.server_close()
    return reg.snapshot().get("ingest_tcp.sink_errors"), closed


def test_sink_error_counted_and_connection_closed_like_jax():
    got = {name: _sink_error_scenario(P) for name, P in PKGS.items()}
    assert got["port"] == got["jax"] == (1, True)


def test_sampled_client_trace_joins_the_server_batch_span():
    P = PKGS["port"]
    agg = te.Aggregator(num_shards=1, opts=small_opts(P), device="cpu")
    reg = tinst.new_registry()
    tracer = ttr.Tracer()
    srv = tingest.serve_ingest_background(tingest.aggregator_sink(agg),
                                          instrument=reg.scope(""), tracer=tracer)
    q = tclient.InstanceQueue(("127.0.0.1", srv.port))
    q.enqueue(1, b"traced", 1.0, T0 + 1)
    ctx = ttr.TraceContext(0xABC, 0xDEF, True)
    with ttr.bind(ctx):
        assert q.flush() == 1
    spans = tracer.finished(ttr.Tracepoint.INGEST_TCP_BATCH)
    assert len(spans) == 1
    assert spans[0].trace_id == 0xABC and spans[0].parent_id == 0xDEF
    q.enqueue(1, b"untraced", 1.0, T0 + 1)
    assert q.flush() == 1  # unsampled: no preamble, no span
    assert len(tracer.finished(ttr.Tracepoint.INGEST_TCP_BATCH)) == 1
    q.close()
    srv.shutdown()
    srv.server_close()


# tests run with the port's lock-order sanitizer armed (raise mode)
LOCKCHECKED = ("test_concurrent_clients_and_ticks_equal_a_serial_run",)


@pytest.fixture(autouse=True)
def lock_order_sanitizer(request):
    """The tests in ``LOCKCHECKED`` run with the port's lock-order
    sanitizer armed in raise mode over every lock they make, and fail on
    any finding."""
    if request.node.originalname not in LOCKCHECKED:
        yield
        return
    lockcheck.reset()
    lockcheck.install(raise_on_cycle=True)
    try:
        yield
        found = lockcheck.findings()
    finally:
        lockcheck.uninstall()
        lockcheck.reset()
    assert not found, "\n".join(map(str, found))


def test_concurrent_clients_and_ticks_equal_a_serial_run():
    """Four clients send three windows while a flush manager, holding
    the sink's lock, ticks each window as soon as every client's frames
    for it are acknowledged: the flushed rows, in emission order, equal
    a serial run's (ingest everything of a window, tick it)."""
    import sys

    from m3_tpu_torch.aggregator.flush_mgr import FlushManager
    from m3_tpu_torch.cluster.kv import KVStore

    P = PKGS["port"]
    n_clients, n_windows = 4, 3

    def frames(c, w):
        rng = np.random.default_rng(100 * c + w)
        ids = [b"cc%d.s%d" % (c, i) for i in range(25)]
        return [(np.full(25, 1 + (c % 2) * 2, np.uint8), ids,
                 np.round(rng.normal(10, 3, 25), 2),
                 np.full(25, T0 + 1 + k + w * WINDOW, np.int64)) for k in range(2)]

    def node():
        agg = te.Aggregator(num_shards=4, opts=small_opts(P), device="cpu")
        rows = []

        def on_flush(ml, f):
            m = ml.maps[f.metric_type]
            rows.extend((m.id_of(slot), f.timestamp_nanos, int(at), v) for slot, at, v in
                        zip(f.slots.tolist(), f.types.tolist(), f.values.tolist()))

        return agg, FlushManager(agg, KVStore(), "i0", flush_handler=on_flush), rows

    agg, fm, rows_conc = node()
    lock = threading.Lock()
    reg = tinst.new_registry()
    srv = tingest.serve_ingest_background(tingest.aggregator_sink(agg, lock),
                                          instrument=reg.scope(""))
    placement = tplace.initial_placement([tplace.Instance("i0")], 4, 1)
    done = [0] * n_windows
    cv = threading.Condition()
    errors = []

    def run_client(c):
        try:
            cl = tclient.AggregatorClient(placement, lambda iid: ("127.0.0.1", srv.port))
            for w in range(n_windows):
                for f in frames(c, w):
                    cl.write_batch(*f)
                    assert cl.flush() == 25
                with cv:
                    done[w] += 1
                    cv.notify_all()
            cl.close()
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    def ticker():
        for w in range(n_windows):
            with cv:
                assert cv.wait_for(lambda: done[w] == n_clients, timeout=60)
            with lock:
                assert fm.tick(T0 + (w + 1) * WINDOW) == "leader"

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run_client, args=(c,)) for c in range(n_clients)]
        threads.append(threading.Thread(target=ticker))
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads) and not errors, errors
    finally:
        sys.setswitchinterval(old)
        srv.shutdown()
        srv.server_close()

    ser, sfm, rows_ser = node()
    for w in range(n_windows):
        for c in range(n_clients):
            for mts, ids, vals, ts in frames(c, w):
                ser.add_untimed_batch(ttypes.MetricType(int(mts[0])), ids, vals, ts)
        assert sfm.tick(T0 + (w + 1) * WINDOW) == "leader"
    assert len(rows_ser) == n_windows * n_clients * 25
    # within a window the emission order follows slot allocation, which
    # follows arrival order across clients: compare each window as a set
    key = lambda r: (r[1], r)
    assert sorted(rows_conc, key=key) == sorted(rows_ser, key=key)
