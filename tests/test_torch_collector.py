"""The port's collector reporter (``m3_tpu_torch/collector/reporter.py``)
against the JAX package's: the same calls give the same sink calls in
the same order (counters folded to one sum an interval, gauges to the
last value, timers raw), the same drop count when the timer buffer is
full, and the same flushed aggregates when the sink is an aggregator,
in process or over the wire through ``AggregatorClient.write_untimed``.
"""

import time

import numpy as np

import m3_tpu.aggregator.engine as je
import m3_tpu.client.aggregator_client as jclient
import m3_tpu.cluster.placement as jplace
import m3_tpu.collector.reporter as jrep
import m3_tpu.instrument as jinst
import m3_tpu.metrics.policy as jpol
import m3_tpu.metrics.types as jtypes
import m3_tpu.server.ingest_tcp as jingest
import m3_tpu_torch.aggregator.engine as te
import m3_tpu_torch.client.aggregator_client as tclient
import m3_tpu_torch.cluster.placement as tplace
import m3_tpu_torch.collector.reporter as trep
import m3_tpu_torch.instrument as tinst
import m3_tpu_torch.metrics.policy as tpol
import m3_tpu_torch.metrics.types as ttypes
import m3_tpu_torch.server.ingest_tcp as tingest

SEC = 10**9
W = 10 * SEC
T0 = 1_700_000_000 * SEC // W * W

PKGS = {
    "jax": dict(rep=jrep, eng=je, types=jtypes, pol=jpol, client=jclient, place=jplace,
                inst=jinst, ingest=jingest, kw={}),
    "port": dict(rep=trep, eng=te, types=ttypes, pol=tpol, client=tclient, place=tplace,
                 inst=tinst, ingest=tingest, kw={"device": "cpu"}),
}


def script(r):
    """Three intervals of calls; returns each flush's count."""
    out = []
    rng = np.random.default_rng(1)
    for interval in range(3):
        for k in range(40):
            mid = b"m.%d" % (k % 7)
            kind = k % 3
            if kind == 0:
                r.count(mid, float(rng.integers(-3, 5)))
            elif kind == 1 and interval != 1:
                r.gauge(mid + b".g", float(rng.normal()))
            else:
                r.timer(mid + b".t", float(rng.random()))
        out.append(r.flush())
    out.append(r.flush())  # an idle interval sends nothing
    return out


def test_sink_calls_match():
    got = {}
    for name, P in PKGS.items():
        sent = []
        r = P["rep"].Reporter(lambda mt, mid, v, t: sent.append((mt, mid, v, t)),
                              now_nanos=lambda: 42, max_timer_buffer=20)
        counts = script(r)
        got[name] = (counts, sent, r.dropped_timers)
    assert got["port"] == got["jax"]
    counts, sent, dropped = got["port"]
    assert counts[-1] == 0 and dropped > 0
    assert sent[0][0] == int(ttypes.MetricType.COUNTER) and sent[0][3] == 42


def test_background_loop_flushes_and_close_flushes_the_rest():
    got = {}
    for name, P in PKGS.items():
        sent = []
        r = P["rep"].Reporter(lambda *a: sent.append(a), interval_s=0.01,
                              now_nanos=lambda: 7)
        r.start()
        r.count(b"x", 2)
        deadline = time.monotonic() + 5
        while not sent and time.monotonic() < deadline:
            time.sleep(0.005)
        try:
            r.start()
            again = None
        except RuntimeError as e:
            again = str(e)
        r.gauge(b"g", 3.0)
        r.close()
        got[name] = (sent, again)
    assert got["port"] == got["jax"]
    assert got["port"] == ([(int(ttypes.MetricType.COUNTER), b"x", 2.0, 7),
                            (int(ttypes.MetricType.GAUGE), b"g", 3.0, 7)],
                           "reporter already started")


def _opts(P):
    return P["eng"].AggregatorOptions(capacity=64, num_windows=4, timer_sample_capacity=1 << 10,
                                      storage_policies=(P["pol"].StoragePolicy.parse("10s:2d"),))


def _rows(agg, target):
    rows = []

    def handler(ml, f):
        m = ml.maps[f.metric_type]
        rows.extend((m.id_of(int(s)), f.timestamp_nanos, int(f.metric_type), int(a),
                     np.float64(v).view(np.uint64).item())
                    for s, a, v in zip(f.slots.tolist(), f.types.tolist(), f.values.tolist()))

    agg.consume(target, handler)
    return sorted(rows)


def test_reporter_into_an_aggregator_matches():
    got = {}
    for name, P in PKGS.items():
        agg = P["eng"].Aggregator(num_shards=2, opts=_opts(P), **P["kw"])

        def sink(mt, mid, v, t):
            agg.add_untimed_batch(P["types"].MetricType(mt), [mid], np.asarray([v]),
                                  np.asarray([t], np.int64))

        r = P["rep"].Reporter(sink, now_nanos=lambda: T0 + SEC)
        for _ in range(5):
            r.count(b"hits", 2)
        r.gauge(b"depth", 4.5)
        r.timer(b"lat", 0.25)
        r.timer(b"lat", 0.75)
        r.flush()
        got[name] = _rows(agg, T0 + 2 * W)
    assert got["port"] == got["jax"]
    sums = {r[0]: np.uint64(r[4]).view(np.float64) for r in got["port"]
            if r[2] == int(ttypes.MetricType.COUNTER)}
    assert sums == {b"hits": 10.0}


def test_reporter_over_the_wire_matches():
    got = {}
    for name, P in PKGS.items():
        agg = P["eng"].Aggregator(num_shards=2, opts=_opts(P), **P["kw"])
        reg = P["inst"].new_registry()
        srv = P["ingest"].serve_ingest_background(P["ingest"].aggregator_sink(agg),
                                                  instrument=reg.scope(""))
        placement = P["place"].initial_placement([P["place"].Instance("i0")], 2, 1)
        client = P["client"].AggregatorClient(placement, lambda iid: ("127.0.0.1", srv.port))
        r = P["rep"].Reporter(client.write_untimed, now_nanos=lambda: T0 + SEC)
        for k in range(12):
            r.count(b"req.%d" % (k % 4), 1.0)
            r.gauge(b"q.%d" % (k % 3), float(k))
        assert r.flush() == 7
        assert client.flush() == 7
        deadline = time.monotonic() + 30
        while reg.snapshot().get("ingest_tcp.samples", 0) < 7 and time.monotonic() < deadline:
            time.sleep(0.02)
        got[name] = _rows(agg, T0 + 2 * W)
        client.close()
        srv.shutdown()
        srv.server_close()
    assert got["port"] == got["jax"] and len(got["port"]) == 7
