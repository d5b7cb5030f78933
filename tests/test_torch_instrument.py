"""m3_tpu_torch.instrument (the registry), instrument.procstats and
x.register_metrics against the JAX package's on the CPU.

The same operations on both registries (counters, gauges, timers,
histograms on a frozen clock, collectors, tagged and nested scopes) must
render byte-identical Prometheus text and equal snapshots and histogram
summaries; ``quantile_from_buckets`` must agree exactly on random bucket
vectors.  ``register_metrics`` and ``install_process_collector`` must
give the same metric names (values of the process gauges excluded),
less the reference's device-boundary gauges (``devguard``,
``membudget``), which the port does not have.  ``instrument_aggregator``
must count the same on the same traffic.
"""

import re

import numpy as np
import pytest

import m3_tpu.instrument as jinst
import m3_tpu.instrument.procstats as jproc
import m3_tpu.x as jx
from m3_tpu.aggregator import engine as je
from m3_tpu.metrics import aggregation as jagg
from m3_tpu.metrics.types import MetricType as JMT
from m3_tpu.x import breaker as jbreaker
from m3_tpu.x import fault as jfault
from m3_tpu.x import retry as jretry
import m3_tpu_torch.instrument as tinst
import m3_tpu_torch.instrument.procstats as tproc
import m3_tpu_torch.x as tx
from m3_tpu_torch.aggregator import engine as te
from m3_tpu_torch.metrics import aggregation as tagg
from m3_tpu_torch.metrics.types import MetricType as TMT
from m3_tpu_torch.x import breaker as tbreaker
from m3_tpu_torch.x import fault as tfault
from m3_tpu_torch.x import retry as tretry

SEC = 10**9
T0 = 1_700_000_040 * SEC


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _drive_registry(mod, clock):
    """One fixed sequence of registry operations."""
    rng = np.random.default_rng(5)
    reg = mod.new_registry()
    root = reg.scope("m3tpu")
    root.counter("writes").inc(7)
    root.counter("writes").inc(3)
    root.scope("db").counter("reads").inc()
    root.gauge("queue.depth").update(12.5)
    root.tagged({"shard": "3", "ns": 'we"ird\\name'}).gauge("slots").update(4)
    root.tagged({"shard": "1"}).scope("flush").counter("n").inc(2)
    sub = root.subscope("mediator")
    tm = sub.timer("tick_wall_seconds")
    for v in rng.gamma(2.0, 0.01, 40):
        tm.record(float(v))
    # histograms on a frozen clock: windowed summaries are deterministic
    h = mod.Histogram(window_s=60.0, clock=clock)
    reg._histograms[("m3tpu.ingest.seconds", ())] = h
    for v in rng.exponential(0.002, 300):
        h.record(float(v))
    clock.t += 70.0  # rotate one window
    for v in rng.exponential(0.02, 50):
        h.record(float(v))
    q = root.scope("query").tagged({"phase": "fetch"}).histogram("phase_seconds")
    for v in (0.0, 1e-9, 0.5, 3.0, 1e6):
        q.record(v)
    state = {"n": 0}

    def collect():
        state["n"] += 1
        root.gauge("collected").update(state["n"])

    reg.register_collector(collect)
    return reg


def test_prometheus_text_byte_equal():
    cj, ct = _Clock(), _Clock()
    rj, rt = _drive_registry(jinst, cj), _drive_registry(tinst, ct)
    assert rt.render_prometheus() == rj.render_prometheus()
    assert rt.render_prometheus() == rj.render_prometheus()  # collectors ran twice
    assert rt.snapshot() == rj.snapshot()
    assert rt.histogram_summaries() == rj.histogram_summaries()
    # every render and snapshot ran the collector once more: 5 in all
    assert "m3tpu_collected 5.0" in rt.render_prometheus()


def test_root_scope_and_logger_names():
    assert tinst.root_scope("a", {"k": "v"}).counter("c") is not None
    assert tinst.logger("x").name == "m3_tpu_torch.x"
    assert jinst.logger("x").name == "m3_tpu.x"


@pytest.mark.parametrize("seed", range(4))
def test_quantile_from_buckets_equal(seed):
    rng = np.random.default_rng(seed)
    n = len(jinst.HISTOGRAM_BOUNDS) + 1
    counts = rng.integers(0, 50, n).tolist()
    if seed == 3:
        counts = [0] * n
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert tinst.quantile_from_buckets(counts, q) == \
            jinst.quantile_from_buckets(counts, q)


def _names(text: str) -> set:
    out = set()
    for line in text.splitlines():
        if line and not line.startswith("#"):
            out.add(re.split(r"[{ ]", line, 1)[0])
    return out


# the reference's device-boundary gauges (x/devguard, x/membudget)
_DEVICE_ONLY = re.compile(r"^m3tpu_device_|^device_")


def _reset_substrate():
    for f in (jfault, tfault):
        f.disarm()
        f.reset_counters()
    for r in (jretry, tretry):
        r.reset_counters()
    for b in (jbreaker, tbreaker):
        b.reset_registry()
        b.reset_counters()


def test_register_metrics_and_process_collector_names():
    _reset_substrate()
    try:
        for f in (jfault, tfault):
            with f.armed("x.p", "drop", p=1.0):
                f.fire("x.p")
        for b in (jbreaker, tbreaker):
            b.breaker_for("query:h:1").record_failure()
        names = []
        for inst, x, proc in ((jinst, jx, jproc), (tinst, tx, tproc)):
            reg = inst.new_registry()
            x.register_metrics(reg)
            proc.install_process_collector(reg, reg.scope("m3tpu"))
            names.append({n for n in _names(reg.render_prometheus())
                          if not _DEVICE_ONLY.search(n)})
        assert names[1] == names[0]
        assert {"fault_drop_triggers", "fault_passes", "breaker_state",
                "m3tpu_process_threads"} <= names[1]
        assert "m3tpu_process_resident_memory_bytes" in names[1]
    finally:
        _reset_substrate()


def _agg_drive(eng, agg_mod, mt_cls, inst, **kw):
    reg = inst.new_registry()
    agg = eng.Aggregator(opts=eng.AggregatorOptions(
        capacity=64, num_windows=2, layout="f64",
        storage_policies=(eng.StoragePolicy.parse("10s:2d"),)),
        passthrough_handler=lambda b: None, **kw)
    collect = eng.instrument_aggregator(reg.scope("m3tpu"), agg)
    gid = agg_mod.AggregationID.DEFAULT
    rng = np.random.default_rng(3)
    for r in range(3):
        base = T0 + r * 10 * SEC
        ids = [b"g.%d" % i for i in rng.integers(0, 20, 50)]
        agg.add_untimed_batch(mt_cls.GAUGE, ids, rng.normal(0, 1, 50),
                              base + rng.integers(0, 10 * SEC, 50), gid)
        times = np.concatenate([np.full(4, base + 3 * SEC),
                                np.full(3, base - 600 * SEC),
                                np.full(2, base + 600 * SEC)])
        agg.add_timed_batch(mt_cls.GAUGE, [b"t.%d" % i for i in range(9)],
                            np.arange(9.0), times, gid, now_nanos=base + 3 * SEC)
        agg.add_passthrough_batch([b"p"], [1.0], [base],
                                  eng.StoragePolicy.parse("10s:2d"))
        agg.consume(base + 10 * SEC)
    text = reg.render_prometheus()
    reg.unregister_collector(collect)
    return text


def test_instrument_aggregator_counts_equal():
    jt = _agg_drive(je, jagg, JMT, jinst)
    tt = _agg_drive(te, tagg, TMT, tinst, device="cpu")

    def gauges(text):
        return sorted(l for l in text.splitlines()
                      if l.startswith("m3tpu_aggregator_")
                      and "drain_seconds" not in l)

    assert gauges(tt) == gauges(jt)
    assert "m3tpu_aggregator_timed_rejects_too_early 9" in tt
    assert "m3tpu_aggregator_passthrough_samples 3" in tt
    # one drain observation per consume in both
    assert re.search(r"^m3tpu_aggregator_drain_seconds_count 3$", tt, re.M)
    assert re.search(r"^m3tpu_aggregator_drain_seconds_count 3$", jt, re.M)
