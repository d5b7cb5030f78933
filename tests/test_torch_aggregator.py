"""The port's aggregator (``m3_tpu_torch/aggregator/engine.py``) on the CPU
against ``m3_tpu.aggregator.engine.Aggregator``, both on the f64 arenas,
over one multi-window drive: untimed and timed batches (with too-early
and too-far rejects), custom aggregation IDs and one ID under two
aggregation keys, two storage policies, expiry with
slot recycling, timer buffer growth and passthrough; and a smaller
drive over four murmur3 shards.  Plus the host
copies (murmur3, policies, aggregation IDs) and the error cases.

Flushed output is compared by (policy, metric type, metric id,
aggregation mask, aggregation type, timestamp), never by slot number.  Values: exact,
sums, sums of squares and means included (both arenas add each slot's
points in arrival order: the port's kernel as the reference's default
scatter path does), except stdev (``rtol=1e-12``).
"""

import numpy as np
import pytest
import torch

from m3_tpu.aggregator import engine as je
from m3_tpu.core import hash as jhash
from m3_tpu.metrics import aggregation as jagg
from m3_tpu.metrics import policy as jpol
from m3_tpu.metrics.pipeline import Pipeline, TransformationOp
from m3_tpu.metrics.transformation import TransformationType as JTT
from m3_tpu.metrics.types import MetricType as JMT
from m3_tpu_torch.aggregator import engine as te
from m3_tpu_torch.core import hash as thash
from m3_tpu_torch.metrics import aggregation as tagg
from m3_tpu_torch.metrics import policy as tpol
from m3_tpu_torch.metrics.transformation import TransformationType as TTT
from m3_tpu_torch.metrics.types import MetricType as TMT

SEC = 10**9
T0 = 1_700_000_040 * SEC  # a minute boundary
POLICIES = ("10s:2d", "1m:40d")


def _opts(mod, pol, **kw):
    base = dict(capacity=256, num_windows=2, timer_sample_capacity=64, layout="f64",
                quantiles=(0.1, 0.5, 0.95, 0.99, 0.9999),
                storage_policies=tuple(pol.StoragePolicy.parse(p) for p in POLICIES))
    base.update(kw)
    return mod.AggregatorOptions(**base)


class _Side:
    """One package's aggregator plus everything it emitted."""

    def __init__(self, eng, agg_mod, pol, num_shards=1, **kw):
        self.agg_mod = agg_mod
        self.passed = []
        self.out = {}
        self.agg = eng.Aggregator(num_shards=num_shards, opts=_opts(eng, pol),
                                  passthrough_handler=self.passed.append, **kw)

    def handler(self, ml, fm):
        ids = ml.maps[fm.metric_type]
        for s, t, v in zip(fm.slots.tolist(), fm.types.tolist(), fm.values.tolist()):
            key = (str(ml.policy), int(fm.metric_type), ids.id_of(s),
                   int(ids.agg_mask[s]), self.agg_mod.AggregationType(t).name,
                   fm.timestamp_nanos)
            assert key not in self.out, key
            self.out[key] = v


def _drive(side, eng, agg_mod, mt_cls):
    rng = np.random.default_rng(17)
    agg = side.agg
    C, G, T = mt_cls.COUNTER, mt_cls.GAUGE, mt_cls.TIMER
    cid = agg_mod.AggregationID.compress(
        [agg_mod.AggregationType.SUM, agg_mod.AggregationType.MIN,
         agg_mod.AggregationType.MAX, agg_mod.AggregationType.STDEV])
    gid = agg_mod.AggregationID.compress(
        [agg_mod.AggregationType.LAST, agg_mod.AggregationType.MAX,
         agg_mod.AggregationType.COUNT, agg_mod.AggregationType.MEAN])
    tid = agg_mod.AggregationID.compress(
        [agg_mod.AggregationType.P10, agg_mod.AggregationType.P50,
         agg_mod.AggregationType.MEDIAN, agg_mod.AggregationType.P9999,
         agg_mod.AggregationType.MIN, agg_mod.AggregationType.MAX])
    accepted = []
    released = []
    for r in range(14):
        base = T0 + r * 10 * SEC
        pool = 60 if r < 8 else 90  # new series late: recycled slots
        for mt, aid, n in ((C, cid, 200), (G, agg_mod.AggregationID.DEFAULT, 200),
                           (T, tid, 300)):
            ids = [b"m.%d.%d" % (int(mt), i) for i in rng.integers(0, pool, n)]
            times = base + rng.integers(0, 10 * SEC, n)
            if mt is C:
                vals = rng.integers(-20, 100, n).astype(np.float64)
            else:
                vals = np.round(rng.gamma(2.0, 5.0, n), 3)
                vals[rng.random(n) < 0.03] = np.nan if mt is G else 0.0
            agg.add_untimed_batch(mt, ids, vals, times, aid if r % 2 else
                                  agg_mod.AggregationID.DEFAULT)
        # the same gauge ids under a second aggregation key
        ids = [b"m.3.%d" % i for i in range(10)]
        agg.add_untimed_batch(G, ids, np.arange(10.0) - 4.5,
                              np.full(10, base + 5 * SEC), gid)
        # timed: in range, too early, too far in the future
        times = np.concatenate([np.full(20, base + 3 * SEC),
                                np.full(5, base - 600 * SEC),
                                np.full(5, base + 600 * SEC)])
        ids = [b"timed.%d" % (i % 7) for i in range(30)]
        acc = agg.add_timed_batch(G, ids, np.arange(30.0), times, gid,
                                  now_nanos=base + 3 * SEC)
        accepted.append(acc.tolist())
        agg.add_passthrough_batch([b"p.%d" % r], [float(r)], [base],
                                  eng.StoragePolicy.parse("1m:40d"))
        agg.consume(base + 10 * SEC, flush_handler=side.handler)
        if r in (7, 11):
            n = 0
            for sh in agg.shards:
                for ml in sh.lists.values():
                    n += ml.expire(base + 10 * SEC, 35 * SEC)
            released.append(n)
    return accepted, released


@pytest.fixture(scope="module")
def drives():
    jside = _Side(je, jagg, jpol)
    tside = _Side(te, tagg, tpol, device="cpu")
    jres = _drive(jside, je, jagg, JMT)
    tres = _drive(tside, te, tagg, TMT)
    return jside, jres, tside, tres


def test_flushed_output_matches_jax(drives):
    jside, _, tside, _ = drives
    assert set(tside.out) == set(jside.out)
    assert len(jside.out) > 2000
    types = {k[4] for k in jside.out}
    assert {"P10", "P9999", "MEDIAN", "LAST", "STDEV", "SUM_SQ"} <= types
    for k, want in jside.out.items():
        got = tside.out[k]
        if k[4] == "STDEV":
            np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=str(k))
        else:
            np.testing.assert_array_equal(got, want, err_msg=str(k))


def test_rejects_expiry_counters_and_passthrough_match_jax(drives):
    jside, (jacc, jrel), tside, (tacc, trel) = drives
    assert tacc == jacc and any(False in a for a in jacc)
    assert trel == jrel and all(n > 0 for n in jrel)
    tc, jc = tside.agg.counters(), jside.agg.counters()
    assert tc == jc
    assert jc["timed_rejects_too_early"] > 0 and jc["timed_rejects_too_far_future"] > 0
    assert len(tside.passed) == len(jside.passed) == 14
    for a, b in zip(tside.passed, jside.passed):
        assert str(a.policy) == str(b.policy) and a.ids == b.ids
        np.testing.assert_array_equal(a.values, b.values)
        np.testing.assert_array_equal(a.times, b.times)


def test_timer_growth_and_list_state_match_jax(drives):
    jside, _, tside, _ = drives
    for tsh, jsh in zip(tside.agg.shards, jside.agg.shards):
        for (tp, tml), (jp, jml) in zip(tsh.lists.items(), jsh.lists.items()):
            assert str(tp) == str(jp)
            assert tml.timers.sample_capacity == jml.timers.sample_capacity > 64
            assert tml.drops == jml.drops and tml.consumed_until == jml.consumed_until


def test_four_shard_routing_matches_jax():
    """Untimed and timed gauges over 4 murmur3 shards: same shard per id,
    same flushed output."""
    sides = [_Side(je, jagg, jpol, num_shards=4),
             _Side(te, tagg, tpol, num_shards=4, device="cpu")]
    ids = [b"shard.%d" % i for i in range(64)]
    for side, mt in zip(sides, (JMT.GAUGE, TMT.GAUGE)):
        rng = np.random.default_rng(5)
        for r in range(3):
            base = T0 + r * 10 * SEC
            side.agg.add_untimed_batch(mt, ids, np.round(rng.normal(0, 9, 64), 2),
                                       base + rng.integers(0, 10 * SEC, 64))
            side.agg.add_timed_batch(mt, ids[:8], np.arange(8.0),
                                     np.full(8, base + 2 * SEC), now_nanos=base)
            side.agg.consume(base + 10 * SEC, flush_handler=side.handler)
    j, t = sides
    route = [t.agg.shard_index(m) for m in ids]
    assert route == [j.agg.shard_index(m) for m in ids] and len(set(route)) == 4
    assert len(j.out) == 3 * 64 and t.out == j.out


def test_murmur3_and_policies_match_jax():
    rng = np.random.default_rng(3)
    for n in range(0, 40):
        b = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert thash.murmur3_32(b) == jhash.murmur3_32(b)
        assert thash.murmur3_32(b, 7) == jhash.murmur3_32(b, 7)
        assert thash.shard_for(b, 4) == jhash.shard_for(b, 4)
    for s in ("10s:2d", "1m:40d", "1m@1s:40d", "1h30m:720h", "500ms:1d"):
        t, j = tpol.StoragePolicy.parse(s), jpol.StoragePolicy.parse(s)
        assert (t.resolution.window_nanos, t.resolution.precision_nanos,
                t.retention_nanos, str(t)) == (
            j.resolution.window_nanos, j.resolution.precision_nanos,
            j.retention_nanos, str(j))
    with pytest.raises(ValueError):
        tpol.parse_duration("10x")
    for t in tagg.AggregationType:
        j = jagg.AggregationType(int(t))
        assert t.name == j.name and t.quantile() == j.quantile()
        for mt in TMT:
            assert t.is_valid_for(mt) == j.is_valid_for(JMT(int(mt)))
    aid = tagg.AggregationID.compress([tagg.AggregationType.P99, tagg.AggregationType.SUM])
    assert int(aid) == int(jagg.AggregationID.compress(
        [jagg.AggregationType.P99, jagg.AggregationType.SUM]))
    assert [t.name for t in tagg.AggregationID.DEFAULT.types_for(TMT.TIMER)] == [
        t.name for t in jagg.DEFAULT_TIMER_TYPES]
    assert [(t.name, int(t)) for t in TTT] == [(t.name, int(t)) for t in JTT]


def test_unported_options_raise():
    """The layouts: None, "auto" and "packed" build the packed arenas, an
    unknown layout raises ValueError.  Then the options still unported
    raise, and passthrough without a handler."""
    from m3_tpu_torch.aggregator import packed as tp

    pols = (tpol.StoragePolicy.parse("10s:2d"),)
    for layout in (None, "auto", "packed"):
        agg = te.Aggregator(opts=te.AggregatorOptions(capacity=8, layout=layout,
                                                      storage_policies=pols),
                            device="cpu")
        ml = agg.shards[0].lists[pols[0]]
        assert isinstance(ml.counters, tp.PackedCounterArena), layout
        assert isinstance(ml.gauges, tp.PackedGaugeArena), layout
        assert isinstance(ml.timers, tp.PackedTimerArena), layout
    with pytest.raises(ValueError, match="unknown arena layout"):
        te.Aggregator(opts=te.AggregatorOptions(capacity=8, layout="packd",
                                                storage_policies=pols), device="cpu")
    with pytest.raises(NotImplementedError, match="limiter"):
        te.Aggregator(opts=te.AggregatorOptions(capacity=8, layout="f64",
                                                new_series_limit_per_sec=5.0),
                      device="cpu")
    ml = te.MetricList(pols[0], te.AggregatorOptions(capacity=8, layout="f64"),
                       device="cpu")
    with pytest.raises(NotImplementedError, match="pipeline"):
        ml.add_batch(TMT.GAUGE, [b"a"], np.ones(1), np.full(1, T0),
                     pipeline=Pipeline((TransformationOp(JTT.PER_SECOND),)))
    ml.add_batch(TMT.GAUGE, [b"a"], np.ones(1), np.full(1, T0), pipeline=Pipeline(()))
    agg = te.Aggregator(opts=te.AggregatorOptions(capacity=8, layout="f64"), device="cpu")
    with pytest.raises(RuntimeError, match="passthrough"):
        agg.add_passthrough_batch([b"a"], [1.0], [T0], pols[0])


def test_no_device_means_cuda_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opts = te.AggregatorOptions(capacity=8, layout="f64")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.Aggregator(opts=opts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.MetricList(opts.storage_policies[0], opts)
