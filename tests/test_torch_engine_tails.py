"""The port's pipeline tails, forwarding and new-series limiter
(``m3_tpu_torch/aggregator/engine.py``) on the CPU against
``m3_tpu.aggregator.engine``, under both arena layouts.

Every case drives a JAX ``MetricList`` (or ``Aggregator``) and a port one
with the same seeded batches and compares the ``FlushedMetric`` lists of
every ``consume`` in order: policy, timestamp, metric type, slots and
aggregation types exactly, values bit for bit (NaN as one NaN) except
the sum-of-squares and stdev lanes (``rtol`` 2e-15 and 1e-12, the
envelopes ``tests/test_torch_packed.py`` states).  Cases: each tail
type and chain on counters and gauges, RESET's forced zero, a RESET
that is not last rejected, a tail/no-tail collision raising, ``expire``
dropping a slot's tail and state, two forwarding stages with a transform
between them, an idle gap that must not strand forwards, a multi-type
stage before a forward rejected, the limiter on a frozen clock (accepted
masks, reject counts, dropped samples, untimed and timed), and the
4-shard ``Aggregator`` of ``test_aggregator_shard_routed_forwarding``
compared pass by pass.
"""

import numpy as np
import pytest

import m3_tpu.aggregator.engine as je
import m3_tpu.metrics.aggregation as jagg
import m3_tpu.metrics.pipeline as jpipe
import m3_tpu.metrics.policy as jpol
import m3_tpu.metrics.transformation as jtf
import m3_tpu.metrics.types as jtypes
import m3_tpu.storage.limits as jlim
import m3_tpu_torch.aggregator.engine as te
import m3_tpu_torch.metrics.aggregation as tagg
import m3_tpu_torch.metrics.pipeline as tpipe
import m3_tpu_torch.metrics.policy as tpol
import m3_tpu_torch.metrics.transformation as ttf
import m3_tpu_torch.metrics.types as ttypes
import m3_tpu_torch.storage.limits as tlim

SEC = 10**9
R = 10 * SEC
T0 = 1_700_000_040 * SEC
LAYOUTS = ("f64", "packed")
RTOL = {"SUM_SQ": 2e-15, "STDEV": 1e-12}


class _Pkg:
    def __init__(self, eng, agg, pipe, pol, tf, types, lim, **kw):
        self.eng, self.agg, self.pipe, self.pol = eng, agg, pipe, pol
        self.tf, self.types, self.lim, self.kw = tf, types, lim, kw

    def opts(self, layout, **kw):
        base = dict(capacity=64, num_windows=4, timer_sample_capacity=256, layout=layout,
                    storage_policies=(self.pol.StoragePolicy.parse("10s:2d"),))
        base.update(kw)
        return self.eng.AggregatorOptions(**base)

    def mlist(self, layout, **kw):
        lim = kw.pop("new_series_limiter", None)
        opts = self.opts(layout, **kw)
        return self.eng.MetricList(opts.storage_policies[0], opts,
                                   new_series_limiter=lim, **self.kw)

    def aggregator(self, layout, n, **kw):
        return self.eng.Aggregator(num_shards=n, opts=self.opts(layout, **kw), **self.kw)

    def agg_id(self, *names):
        return self.agg.AggregationID.compress(
            [self.agg.AggregationType[n] for n in names])

    def pipeline(self, spec):
        """("T", name) a transformation, ("R", id, [agg types]) an applied
        rollup."""
        ops = []
        for s in spec:
            if s[0] == "T":
                ops.append(self.pipe.TransformationOp(self.tf.TransformationType[s[1]]))
            else:
                ops.append(self.pipe.AppliedRollupOp(s[1], self.agg_id(*s[2])))
        return self.pipe.Pipeline(tuple(ops))

    def mt(self, name):
        return self.types.MetricType[name]


J = _Pkg(je, jagg, jpipe, jpol, jtf, jtypes, jlim)
T = _Pkg(te, tagg, tpipe, tpol, ttf, ttypes, tlim, device="cpu")


def _canon(P, out):
    rows = []
    for fm in out:
        rows.append((str(fm.policy), fm.timestamp_nanos, int(fm.metric_type),
                     fm.slots.astype(np.int64).tolist(),
                     [P.agg.AggregationType(int(t)).name for t in fm.types],
                     np.asarray(fm.values, np.float64)))
    return rows


def _same_flush(jout, tout):
    j, t = _canon(J, jout), _canon(T, tout)
    assert [r[:5] for r in t] == [r[:5] for r in j]
    for jr, tr in zip(j, t):
        for name, jv, tv in zip(jr[4], jr[5], tr[5]):
            if name in RTOL:
                np.testing.assert_allclose(tv, jv, rtol=RTOL[name])
            else:
                assert np.array_equal(np.float64(tv).view(np.uint64),
                                      np.float64(jv).view(np.uint64)) or (
                    np.isnan(tv) and np.isnan(jv)), (name, tv, jv)


def _batches(seed, ids, n_windows, k=3):
    """Per window k samples per id, shuffled, with seeded values: negatives,
    a decrease between windows, a NaN."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(n_windows):
        idx = np.repeat(np.arange(len(ids)), k)
        rng.shuffle(idx)
        vals = np.round(rng.normal(5.0, 20.0, idx.size), 3)
        if w == 2:
            vals[0] = np.nan
        ts = T0 + w * R + rng.integers(0, R, idx.size)
        out.append(([ids[i] for i in idx], vals, ts.astype(np.int64)))
    return out


TAILS = {
    "ABSOLUTE": (("T", "ABSOLUTE"),),
    "ADD": (("T", "ADD"),),
    "PER_SECOND": (("T", "PER_SECOND"),),
    "INCREASE": (("T", "INCREASE"),),
    "RESET": (("T", "RESET"),),
    "ADD_RESET": (("T", "ADD"), ("T", "RESET")),
    "ABSOLUTE_PER_SECOND": (("T", "ABSOLUTE"), ("T", "PER_SECOND")),
    "INCREASE_ADD": (("T", "INCREASE"), ("T", "ADD")),
}


def _drive_tails(P, layout, tail, mt, agg):
    ml = P.mlist(layout)
    ids = [b"out.%d" % i for i in range(5)]
    outs = []
    for k, (bid, vals, ts) in enumerate(_batches(3, ids, 6)):
        pl = P.pipeline(TAILS[tail])
        ml.add_batch(P.mt(mt), bid, vals, ts, P.agg_id(*agg), pipeline=pl)
        # untailed ids beside them in the same arena
        ml.add_batch(P.mt(mt), [b"plain.%d" % i for i in range(3)], vals[:3], ts[:3])
        if k >= 1:
            outs.append(ml.consume(T0 + k * R))
    outs.append(ml.consume(T0 + 8 * R))
    return outs


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("tail", sorted(TAILS))
def test_tail_flushes_match_jax(tail, layout):
    for mt, agg in (("COUNTER", ("SUM",)), ("GAUGE", ("SUM", "MAX", "LAST")),
                    ("TIMER", ("P50", "COUNT"))):
        jo = _drive_tails(J, layout, tail, mt, agg)
        to = _drive_tails(T, layout, tail, mt, agg)
        assert len(jo) == len(to)
        for a, b in zip(jo, to):
            _same_flush(a, b)
        if tail.endswith("RESET"):
            assert any(fm.values.size and not fm.values.any() for o in to for fm in o)


def _both(fn):
    """Run fn(P) on both packages; both must raise the same error type and
    message, or both return equal values."""
    res = []
    for P in (J, T):
        try:
            res.append(("ok", fn(P)))
        except (ValueError, RuntimeError) as e:
            res.append((type(e).__name__, str(e)))
    assert res[0][0] == res[1][0], res
    if res[0][0] != "ok":
        assert res[0][1] == res[1][1]
    return res


def test_reset_not_last_and_collisions_raise_as_jax():
    def reset_not_last(P):
        ml = P.mlist("f64")
        ml.add_batch(P.mt("COUNTER"), [b"x"], np.ones(1), np.full(1, T0),
                     pipeline=P.pipeline((("T", "RESET"), ("T", "ADD"))))

    def tail_then_plain(P):
        ml = P.mlist("packed")
        pl = P.pipeline((("T", "PER_SECOND"),))
        ml.add_batch(P.mt("COUNTER"), [b"out"], np.ones(1), np.full(1, T0), pipeline=pl)
        ml.add_batch(P.mt("COUNTER"), [b"out"], np.ones(1), np.full(1, T0))

    def plain_then_tail(P):
        ml = P.mlist("f64")
        ml.add_batch(P.mt("COUNTER"), [b"out2"], np.ones(1), np.full(1, T0))
        ml.add_batch(P.mt("COUNTER"), [b"out2"], np.ones(1), np.full(1, T0),
                     pipeline=P.pipeline((("T", "ADD"),)))

    def multi_type_forward(P):
        ml = P.mlist("f64")
        ml.add_batch(P.mt("COUNTER"), [b"x"], np.ones(1), np.full(1, T0),
                     P.agg_id("SUM", "MAX"), pipeline=P.pipeline((("R", b"next", ["SUM"]),)))

    for fn in (reset_not_last, tail_then_plain, plain_then_tail, multi_type_forward):
        (kind, _), _ = _both(fn)
        assert kind == "ValueError", fn.__name__


@pytest.mark.parametrize("layout", LAYOUTS)
def test_expire_drops_tail_and_state(layout):
    def run(P):
        ml = P.mlist(layout)
        pl = P.pipeline((("T", "ADD"),))
        outs = []
        ml.add_batch(P.mt("COUNTER"), [b"a", b"b"], np.asarray([3.0, 4.0]),
                     np.asarray([T0, T0], np.int64), pipeline=pl)
        outs.append(ml.consume(T0 + R))
        ml.add_batch(P.mt("COUNTER"), [b"b"], np.asarray([5.0]),
                     np.asarray([T0 + 5 * R], np.int64), pipeline=pl)
        released = ml.expire(T0 + 5 * R, ttl_nanos=3 * R)
        # a's slot is free again: a plain (untailed) id may take it, and b
        # keeps its running sum
        ml.add_batch(P.mt("COUNTER"), [b"c"], np.asarray([7.0]),
                     np.asarray([T0 + 5 * R], np.int64))
        outs.append(ml.consume(T0 + 7 * R))
        tails = sorted((int(k[0]), k[1], len(v)) for k, v in ml._pipelines.items())
        state = sorted((int(k[0]),) + k[1:] for k in ml._tf_state)
        return released, tails, state, outs

    (_, j), (_, t) = _both(run)
    assert t[:3] == j[:3] and t[0] == 1
    for a, b in zip(j[3], t[3]):
        _same_flush(a, b)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mid", [(), (("T", "PER_SECOND"),), (("T", "INCREASE"), ("T", "ABSOLUTE"))])
def test_two_stage_forward_matches_jax(mid, layout):
    def run(P):
        ml = P.mlist(layout)
        hosts = [b"stage1.h%d" % i for i in range(4)]
        pl = P.pipeline(mid + (("R", b"total", ["SUM"]), ("T", "ADD")))
        outs = []
        for k, (bid, vals, ts) in enumerate(_batches(5, hosts, 4, k=2)):
            ml.add_batch(P.mt("COUNTER"), bid, np.abs(np.nan_to_num(vals)) * (k + 1), ts,
                         P.agg_id("SUM"), pipeline=pl)
            outs.append(ml.consume(T0 + k * R))
        outs.append(ml.consume(T0 + 6 * R))
        outs.append(ml.consume(T0 + 7 * R))
        return outs, ml.forward_errors

    (_, (jo, je_)), (_, (to, te_)) = _both(run)
    assert te_ == je_
    assert len(jo) == len(to)
    for a, b in zip(jo, to):
        _same_flush(a, b)
    assert any(fm.metric_type == ttypes.MetricType.GAUGE for o in to for fm in o)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_idle_gap_does_not_strand_forwards(layout):
    def run(P):
        ml = P.mlist(layout)
        pl = P.pipeline((("R", b"s2", ["SUM"]), ("R", b"s3", ["SUM"])))
        ml.add_batch(P.mt("COUNTER"), [b"s1"], np.asarray([7.0]),
                     np.asarray([T0 + 1], np.int64), P.agg_id("SUM"), pipeline=pl)
        return ml.consume(T0 + 40 * R), ml.consumed_until

    (_, (jo, jc)), (_, (to, tc)) = _both(run)
    assert tc == jc
    _same_flush(jo, to)
    assert [fm.values.tolist() for fm in to] == [[7.0]]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_forward_tail_conflict_counts_forward_errors(layout):
    """A forwarded group whose remaining tail conflicts with the
    destination slot's is dropped and counted, in both packages."""
    def run(P):
        ml = P.mlist(layout)
        ml.add_batch(P.mt("GAUGE"), [b"dest"], np.ones(1), np.full(1, T0),
                     P.agg_id("SUM"))
        ml.add_batch(P.mt("COUNTER"), [b"src"], np.ones(1), np.full(1, T0),
                     P.agg_id("SUM"),
                     pipeline=P.pipeline((("R", b"dest", ["SUM"]), ("T", "ADD"))))
        out = ml.consume(T0 + 3 * R)
        return out, ml.forward_errors

    (_, (jo, je_)), (_, (to, te_)) = _both(run)
    assert te_ == je_ == 1
    _same_flush(jo, to)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_limiter_rejections_match_jax(layout):
    """A token bucket of 5 creations a second on a frozen clock, shared by
    the three maps: untimed and timed batches of new and known ids, with
    in-batch duplicates; accepted masks, reject counts and the flushed
    aggregates must match."""
    def run(P):
        clock = [100.0]
        lim = P.lim.NewSeriesLimiter(5, now=lambda: clock[0])
        ml = P.mlist(layout, new_series_limiter=lim)
        seen = []
        ids = [b"s%d" % i for i in range(8)] + [b"s0", b"s1", b"s9"]
        seen.append(ml.add_batch(P.mt("COUNTER"), ids, np.arange(11.0),
                                 np.full(11, T0, np.int64)))
        seen.append(ml.add_batch(P.mt("GAUGE"), ids[:4], np.arange(4.0),
                                 np.full(4, T0, np.int64)))
        clock[0] += 0.4  # two more tokens
        seen.append(ml.add_timed_batch(P.mt("GAUGE"), ids[3:7], np.arange(4.0),
                                       np.full(4, T0 + 1, np.int64)))
        seen.append(ml.add_batch(P.mt("COUNTER"), ids, np.arange(11.0) + 1,
                                 np.full(11, T0 + 2, np.int64)))
        masks = [None if m is None else np.asarray(m).tolist() for m in seen]
        return masks, ml.new_series_rejected, lim.rejected_total, ml.consume(T0 + 3 * R)

    (_, j), (_, t) = _both(run)
    assert t[:3] == j[:3]
    assert t[1] > 0
    _same_flush(j[3], t[3])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_aggregator_limiter_and_policies_match_jax(layout):
    """``new_series_limit_per_sec`` on the options: one limiter shared by
    every shard, the first policy's list decides, the second follows."""
    def run(P):
        pols = tuple(P.pol.StoragePolicy.parse(p) for p in ("10s:2d", "1m:40d"))
        agg = P.aggregator(layout, 2, new_series_limit_per_sec=1e9,
                           storage_policies=pols)
        lim = agg.new_series_limiter  # frozen clock, three tokens
        lim._now, lim._last, lim._tokens, lim.per_sec = (lambda: 0.0), 0.0, 3.0, 3.0
        ids = [b"m%d" % i for i in range(6)]
        agg.add_untimed_batch(P.mt("COUNTER"), ids, np.ones(6), np.full(6, T0, np.int64))
        out = agg.consume(T0 + 7 * R)
        return agg.counters(), out

    (_, (jc, jo)), (_, (tc, to)) = _both(run)
    assert tc == jc and tc["new_series_rejected"] == 3
    _same_flush(jo, to)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_aggregator_shard_routed_forwarding_pass_by_pass(layout):
    """The 4-shard case of tests/test_rules_downsample.py: stage-1 ids
    spread over shards forward by the stage-2 id's hash; each consume pass
    must flush the same rows in both packages (whether stage 2 lands in
    the first pass or the next depends on shard order), and no stage-1
    aggregate flushes locally."""
    def run(P):
        agg = P.aggregator(layout, 4, capacity=256, timer_sample_capacity=1 << 12)
        sp = agg.opts.storage_policies[0]
        pl = P.pipeline((("R", b"stage2.total", ["SUM"]),))
        for k, sid in enumerate((b"s1.a", b"s1.b", b"s1.c", b"s1.d", b"s1.e")):
            agg.shard_for(sid).lists[sp].add_batch(
                P.mt("COUNTER"), [sid], np.asarray([5.0 + k]), np.asarray([T0 + 1], np.int64),
                P.agg_id("SUM"), pipeline=pl)
        passes = [agg.consume(T0 + k * R) for k in (2, 3, 4)]
        owner = agg.shard_index(b"stage2.total")
        return passes, owner, agg.counters()

    (_, (jp, jown, jc)), (_, (tp, town, tc)) = _both(run)
    assert town == jown and tc == jc
    for a, b in zip(jp, tp):
        _same_flush(a, b)
    total = sum(float(v) for p in tp for fm in p for v in fm.values)
    assert total == 35.0
    assert all(fm.metric_type != ttypes.MetricType.COUNTER for p in tp for fm in p)


def test_forwarded_batch_strict_policy_raises_as_jax():
    def run(P):
        agg = P.aggregator("f64", 2)
        spec = P.eng.ForwardSpec(b"x", P.agg_id("SUM"), ())
        agg.add_forwarded_batch(P.pol.StoragePolicy.parse("1m:40d"),
                                [(spec, 1.0, T0)], strict=False)
        agg.add_forwarded_batch(P.pol.StoragePolicy.parse("1m:40d"), [(spec, 1.0, T0)])

    (kind, _), _ = _both(run)
    assert kind == "ValueError"


def test_nan_and_out_of_range_counter_values_match_jax():
    """Counter values are cast to int64 as XLA casts them (NaN to 0, out of
    range to the nearest bound), on both layouts."""
    vals = np.asarray([np.nan, np.inf, -np.inf, 1e300, -1e300, 2.7, -2.7, 2.0**63])
    for layout in LAYOUTS:
        def run(P):
            ml = P.mlist(layout)
            ml.add_batch(P.mt("COUNTER"), [b"c%d" % i for i in range(vals.size)], vals,
                         np.full(vals.size, T0, np.int64), P.agg_id("SUM", "MIN", "MAX"))
            return ml.consume(T0 + 2 * R)

        (_, jo), (_, to) = _both(run)
        _same_flush(jo, to)
