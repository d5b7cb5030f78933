"""On a card: each CUDA kernel of m3_tpu_torch against its plain PyTorch
version, the codec's card bytes against its CPU bytes, an aggregator
drive on the card against the same drive on the CPU, and the query
engine and ``decode_rate_hq`` on the card against the CPU.  Exact
comparisons, float sums included: the ``segment_ingest`` kernel adds
each lane's points in arrival order, as the plain version does on the
CPU (on the card ``index_add_`` adds floats with atomics in no fixed
order, so the plain side of a float comparison runs on CPU copies).
The aggregator drive's MEAN and STDEV, elementwise arithmetic on two
devices, keep relative 1e-12 and absolute 1e-9; the query tests state
their tolerances (the card's cumsum and reductions add in other
orders).  Without a CUDA device every test here skips.

This file imports no JAX (the card's machine need not have it), so it
runs there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from m3_tpu_torch._bits import torch_to_u64, u64_to_torch
from m3_tpu_torch.aggregator import engine as te
from m3_tpu_torch.encoding import m3tsz_torch as mt
from m3_tpu_torch.metrics.aggregation import AggregationID, AggregationType
from m3_tpu_torch.metrics.policy import StoragePolicy
from m3_tpu_torch.metrics.types import MetricType
from m3_tpu_torch.parallel import decode_gather as dg
from m3_tpu_torch.parallel import encode_place as ep
from m3_tpu_torch.parallel import segment_ingest as si

SEC = 10**9
START = 1_600_000_000 * SEC


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    return torch.device("cuda")


def _mixed_batch(seed, S, T):
    """Counters, 2-decimal gauges, raw floats, constants and NaN/Inf
    gauges on a jittered whole-second cadence."""
    rng = np.random.default_rng(seed)
    step = 10 + rng.integers(-4, 5, (S, T))
    step[:, ::37] += 300
    ts = START + np.cumsum(step, axis=1) * SEC
    fam = np.arange(S) % 5
    vals = np.where(fam[:, None] == 0, np.cumsum(rng.integers(0, 99, (S, T)), axis=1),
           np.where(fam[:, None] == 1, np.round(rng.normal(50, 9, (S, T)), 2),
           np.where(fam[:, None] == 2, rng.normal(0, 1, (S, T)),
           np.where(fam[:, None] == 3, 7.0, np.round(rng.normal(9, 1, (S, T)), 1)))))
    vals[4::5, ::11] = np.nan
    vals[4::5, 5::23] = np.inf
    return ts.astype(np.int64), vals + 0.0, np.full(S, START, np.int64)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_place_words_kernel_matches_plain(seed):
    dev = _cuda_or_skip()
    rng = np.random.default_rng(seed)
    S, F, W = 257, 2000, 40
    # one bit slot per fragment within each key group (disjoint bits);
    # the per-series offset pushes some keys below 0 and past W
    s_col = torch.arange(S, device=dev)[:, None]
    keys = ((torch.arange(F, device=dev) // 64) * 2 + s_col % 5 - 2).to(torch.int32)
    frags = torch.ones((), dtype=torch.int64, device=dev) << (
        torch.arange(F, device=dev) % 64)
    frags = torch.where(torch.from_numpy(rng.random((S, F)) < 0.3).to(dev), 0, frags)
    before = ep.launches
    got = ep.place_words(frags, keys, W)
    assert ep.launches == before + 1
    assert torch.equal(got, ep.place_words_plain(frags, keys, W))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_extract_kernel_matches_plain(seed):
    dev = _cuda_or_skip()
    rng = np.random.default_rng(seed)
    S, W, F = 301, 90, 700
    w64 = np.pad(rng.integers(0, 1 << 64, (W, S), dtype=np.uint64), ((0, 16), (0, 0)))
    wt = u64_to_torch(w64, dev)
    offs = torch.from_numpy(rng.integers(-70, (W + 16) * 64 + 70, (F, S))
                            .astype(np.int32)).to(dev)
    widths = torch.from_numpy(rng.integers(-2, 67, (F, S)).astype(np.int32)).to(dev)
    widths[0] = 0
    widths[1] = 64
    before = dg.launches
    got = dg.extract_fields64_t(wt, offs, widths)
    assert dg.launches == before + 1
    assert torch.equal(got, dg.extract_fields64_t_plain(wt, offs, widths))


@pytest.mark.gpu
def test_card_codec_equals_cpu_codec():
    dev = _cuda_or_skip()
    ts, vals, starts = _mixed_batch(4, 64, 120)
    a, fa = mt.encode_batch(ts, vals, starts, out_words=256, device=dev)
    b, fb = mt.encode_batch(ts, vals, starts, out_words=256, device="cpu")
    assert a == b and np.array_equal(fa, fb) and not fa.any()
    da = mt.decode_batch(a, 121, device=dev)
    db = mt.decode_batch(b, 121, device="cpu")
    for x, y in zip(da, db):
        assert np.array_equal(np.ascontiguousarray(x).view(np.uint8),
                              np.ascontiguousarray(y).view(np.uint8))
    assert np.array_equal(da[0][:, :120], ts)
    res = mt.encode_batch_device(torch.from_numpy(ts), torch.from_numpy(vals.view(np.int64)),
                                 torch.from_numpy(starts),
                                 torch.ones(ts.shape, dtype=torch.bool),
                                 out_words=256)
    assert res["words"].device.type == "cuda"  # device=None means the card
    assert np.array_equal(torch_to_u64(res["words"][:, 0]), starts.view(np.uint64))


def _segment_inputs(seed, C, N, dtype):
    """Slots with out-of-range and negative entries; NaN and +-0 floats.
    With N <= C / 4, the arena's traffic (distinct slots) with a few
    duplicate slots and one slot hit 300 times."""
    rng = np.random.default_rng(seed)
    if 4 * N <= C:
        slots = rng.permutation(C)[:N]
        slots[rng.integers(0, N, 40)] = slots[rng.integers(0, N, 40)]
        slots[rng.integers(0, N, 300)] = slots[0]
        slots[rng.integers(0, N, 16)] = rng.integers(-3, 0, 16)
        slots[rng.integers(0, N, 16)] = rng.integers(C, C + 3, 16)
        slots = slots.astype(np.int32)
    else:
        slots = rng.integers(-3, C + 3, N).astype(np.int32)
    if dtype.is_floating_point:
        vals = np.round(rng.normal(0, 50, N), 3)
        vals[::97] = np.nan
        vals[1::89] = -0.0
        vals[2::89] = 0.0
    else:
        info = torch.iinfo(dtype)
        vals = rng.integers(info.min, info.max, N, dtype=np.int64, endpoint=True)
    return (torch.from_numpy(slots),
            torch.from_numpy(vals).to(dtype))


def _same_bits(a, b):
    """Bit-equal, every NaN taken as one NaN."""
    if a.dtype.is_floating_point:
        a = torch.where(torch.isnan(a), float("nan"), a).double()
        b = torch.where(torch.isnan(b), float("nan"), b).double()
        return torch.equal(a.view(torch.int64), b.view(torch.int64))
    return torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32, torch.float64])
@pytest.mark.parametrize("C,N", [(1 << 15, 20_000), (64, 1 << 16), (1 << 20, 1 << 18)])
def test_segment_kernels_match_plain(dtype, C, N):
    dev = _cuda_or_skip()
    slots, vals = (x.to(dev) for x in _segment_inputs(C + N, C, N, dtype))
    before = dict(si.launches)
    got = si.segment_ingest(slots, vals, C, with_sq=True)
    mn, mx = si.segment_minmax(slots, vals, C)
    assert si.launches[si.INGEST_KERNEL] == before[si.INGEST_KERNEL] + 5  # five grids
    assert si.launches[si.MINMAX_KERNEL] == before[si.MINMAX_KERNEL] + 1
    want = si.segment_ingest_plain(slots.cpu(), vals.cpu(), C, with_sq=True)
    for g, w in zip(got, want):
        assert _same_bits(g.cpu(), w)
    pmn, pmx = si.segment_minmax_plain(slots, vals, C)
    assert _same_bits(mn, pmn) and _same_bits(mx, pmx)
    e = torch.zeros(0, dtype=torch.int32, device=dev)
    s0, c0 = si.segment_ingest(e, torch.zeros(0, dtype=dtype, device=dev), C)
    assert int(c0.sum()) == 0 and float(s0.double().abs().sum()) == 0.0
    with pytest.raises(TypeError):
        si.segment_minmax(slots, vals.to(torch.int16), C)


def _into_columns(seed, C, dtype):
    """Non-zero starting columns: sum, int64 count, sum of squares, min
    and max; float min/max hold a few NaNs of their side's sign."""
    rng = np.random.default_rng(seed)
    if dtype.is_floating_point:
        cols = [np.round(rng.normal(0, 1e3, C), 2) for _ in range(5)]
        cols[3][::17] = -np.float64(np.nan)
        cols[4][::19] = np.float64(np.nan)
        cols[0][::23] = -0.0
    else:
        info = torch.iinfo(dtype)
        cols = [rng.integers(info.min, info.max, C, endpoint=True) for _ in range(5)]
    cnt = rng.integers(0, 1 << 40, C)
    out = [torch.from_numpy(c).to(dtype) for c in cols]
    return out[0], torch.from_numpy(cnt), out[2], out[3], out[4]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32, torch.float64])
@pytest.mark.parametrize("C,N", [(1 << 15, 20_000), (64, 1 << 16), (1 << 20, 1 << 18)])
def test_into_kernels_match_plain_twice(dtype, C, N):
    """Both into-kernels on non-zero columns, bit for bit against their
    plain versions (run on the CPU), twice; int64 index and count, then
    int32 index and count."""
    dev = _cuda_or_skip()
    slots, vals = _segment_inputs(C + N + 7, C, N, dtype)
    start = _into_columns(C + N, C, dtype)
    for idx_dtype, cnt_dtype in ((torch.int64, torch.int64), (torch.int32, torch.int32)):
        idx = slots.to(idx_dtype)
        want = [c.clone() for c in start]
        want[1] = want[1].to(cnt_dtype)
        si.segment_ingest_into(want[0], want[1], want[2], idx, vals)
        si.segment_minmax_into(want[3], want[4], idx, vals)
        for _ in range(2):
            cols = [c.to(dev) for c in start]
            cols[1] = cols[1].to(cnt_dtype)
            before = dict(si.launches)
            si.segment_ingest_into(cols[0], cols[1], cols[2], idx.to(dev), vals.to(dev))
            si.segment_minmax_into(cols[3], cols[4], idx.to(dev), vals.to(dev))
            assert si.launches[si.INGEST_KERNEL] == before[si.INGEST_KERNEL] + 5
            assert si.launches[si.MINMAX_KERNEL] == before[si.MINMAX_KERNEL] + 1
            torch.cuda.synchronize()
            for name, g, w in zip(("sum", "count", "sq", "min", "max"), cols, want):
                assert _same_bits(g.cpu(), w), (name, idx_dtype)


@pytest.mark.gpu
def test_ingest_scratch_per_stream_and_graph_capture():
    """Kernel #3 keeps its scratch per stream: a call on a second stream
    gives the same bits; a CUDA graph captures on a stream whose scratch
    an eager call has made, and raises on one that has none."""
    dev = _cuda_or_skip()
    slots, vals = _segment_inputs(5, 64, 1 << 12, torch.float64)
    idx, vals = slots.to(dev).long(), vals.to(dev)
    start = [c.to(dev) for c in _into_columns(6, 64, torch.float64)[:3]]
    want = [c.clone() for c in start]
    si.segment_ingest_into(*want, idx, vals)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = [c.clone() for c in start]
        si.segment_ingest_into(*got, idx, vals)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            si.segment_ingest_into(*got, idx, vals)
    torch.cuda.current_stream().wait_stream(side)
    assert all(_same_bits(a, b) for a, b in zip(got, want))
    g.replay()
    si.segment_ingest_into(*want, idx, vals)
    torch.cuda.synchronize()
    assert all(_same_bits(a, b) for a, b in zip(got, want))
    fresh = torch.cuda.Stream()
    with pytest.raises(RuntimeError, match="capturing stream"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=fresh):
            si.segment_ingest_into(*got, idx, vals)


def _agg_drive(device, layout="f64"):
    """A few windows of counters, gauges and timers through the engine;
    the flushed output keyed by (policy, type, id, agg type, time)."""
    rng = np.random.default_rng(23)
    opts = te.AggregatorOptions(
        capacity=512, num_windows=2, timer_sample_capacity=256, layout=layout,
        storage_policies=(StoragePolicy.parse("10s:2d"), StoragePolicy.parse("1m:40d")))
    agg = te.Aggregator(opts=opts, device=device)
    out = {}

    def handler(ml, fm):
        ids = ml.maps[fm.metric_type]
        for sl, t, v in zip(fm.slots.tolist(), fm.types.tolist(), fm.values.tolist()):
            out[(str(ml.policy), int(fm.metric_type), ids.id_of(sl),
                 AggregationType(t).name, fm.timestamp_nanos)] = v

    aid = {MetricType.COUNTER: AggregationID.compress(
               [AggregationType.SUM, AggregationType.MIN, AggregationType.MAX]),
           MetricType.GAUGE: AggregationID.compress(
               [AggregationType.LAST, AggregationType.SUM, AggregationType.MIN,
                AggregationType.MAX, AggregationType.STDEV]),
           MetricType.TIMER: AggregationID.DEFAULT}
    for r in range(8):
        base = START + r * 10 * SEC
        for mt in aid:
            ids = [b"%d.%d" % (int(mt), i) for i in rng.integers(0, 300, 400)]
            times = base + rng.integers(0, 10 * SEC, 400)
            vals = (rng.integers(0, 1000, 400).astype(np.float64) if mt is MetricType.COUNTER
                    else np.round(rng.gamma(2.0, 5.0, 400), 3))
            agg.add_untimed_batch(mt, ids, vals, times, aid[mt])
        agg.consume(base + 10 * SEC, flush_handler=handler)
    return out, agg.counters()


@pytest.mark.gpu
def test_aggregator_on_card_equals_cpu():
    dev = _cuda_or_skip()
    before = dict(si.launches)
    card, card_counters = _agg_drive(dev)
    assert all(si.launches[k] > before[k] for k in si.KERNELS)
    cpu, cpu_counters = _agg_drive("cpu")
    assert set(card) == set(cpu) and len(cpu) > 1000 and card_counters == cpu_counters
    for k, want in cpu.items():
        if k[3] in ("MEAN", "STDEV"):
            np.testing.assert_allclose(card[k], want, rtol=1e-12, atol=1e-9,
                                       err_msg=str(k))
        else:
            np.testing.assert_array_equal(card[k], want, err_msg=str(k))


@pytest.mark.gpu
def test_packed_aggregator_on_card_equals_cpu():
    """The default (packed) layout: every flushed value bit-equal between
    the card and the CPU (every op is an integer op or IEEE f64
    arithmetic in its own launch), and none of the four kernels runs."""
    dev = _cuda_or_skip()
    before = dict(si.launches)
    card, card_counters = _agg_drive(dev, layout=None)
    assert si.launches == before
    cpu, cpu_counters = _agg_drive("cpu", layout=None)
    assert set(card) == set(cpu) and len(cpu) > 1000 and card_counters == cpu_counters
    for k, want in cpu.items():
        np.testing.assert_array_equal(card[k], want, err_msg=str(k))


@pytest.mark.gpu
def test_packed_arena_states_on_card_equal_cpu():
    """Packed counter, gauge and timer arenas driven with the same
    batches on the card and on the CPU (out-of-range windows and slots,
    NaN/±inf/±0 gauges, duplicate slots, values outside int16 that
    promote into a narrow pool, clears with negative slots, resets):
    every state field bit-equal (NaN as one NaN) after every op."""
    from m3_tpu_torch.aggregator import arena
    from m3_tpu_torch.aggregator import packed as tp

    dev = _cuda_or_skip()
    W, C = 2, 1000
    rng = np.random.default_rng(31)
    pairs = [(tp.PackedCounterArena(W, C, pool_capacity=64, widths=(8, 20), device=d),
              tp.PackedGaugeArena(W, C, device=d), tp.PackedTimerArena(W, C, 64, device=d))
             for d in (dev, "cpu")]

    def same(what):
        for a, b in zip(*pairs):
            x, y = arena.state_to_numpy(a.state), arena.state_to_numpy(b.state)
            for name in y:
                if y[name].dtype.kind == "f":
                    ok = ~np.isnan(y[name])
                    np.testing.assert_array_equal(np.isnan(x[name]), ~ok, err_msg=what)
                    np.testing.assert_array_equal(x[name][ok].view(np.uint64),
                                                  y[name][ok].view(np.uint64), err_msg=what)
                else:
                    np.testing.assert_array_equal(x[name], y[name], err_msg=f"{what} {name}")

    for i in range(6):
        n = int(rng.integers(1, 5000))
        w = rng.integers(-1, W + 1, n).astype(np.int32)
        s = rng.integers(-2, C + 2, n).astype(np.int32)
        s[: n // 3] = rng.integers(0, 20, n // 3)  # hot, duplicate slots
        cv = rng.integers(-3000, 3000, n).astype(np.float64)
        cv[rng.random(n) < 0.01] = 2.0 ** 41
        gv = np.round(rng.normal(0, 9, n), 2)
        for val, p in ((np.nan, 0.02), (np.inf, 0.01), (-np.inf, 0.01), (-0.0, 0.05)):
            gv[rng.random(n) < p] = val
        t = START + rng.integers(0, 50, n) * SEC
        for c, g, tm in pairs:
            c.ingest(w, s, cv, t)
            g.ingest(w, s, gv, t)
            tm.ingest(w, s, np.abs(np.nan_to_num(gv, posinf=7.0, neginf=-7.0)), t)
        same(f"ingest {i}")
        if i == 3:
            clear = np.asarray([-1, 5, 17, C - 1, -C - 2], np.int32)
            for arenas in pairs:
                for a in arenas:
                    a.clear_slots(clear)
            same("clear")
    assert int(pairs[1][0].state.pool_n) > 0
    for arenas in pairs:
        for a in arenas:
            a.reset_window(0)
    same("reset")


class _QueryStorage:
    """Series in memory; the name and the matchers applied, points kept
    in [start, end)."""

    def __init__(self, series):
        self.series = series

    def fetch_raw(self, name, matchers, start_nanos, end_nanos):
        from m3_tpu_torch.query.block import RawBlock, SeriesMeta

        pts, metas = [], []
        for tags, ts, vals in self.series:
            if tags[b"__name__"] != name or any(tags.get(m.name) != m.value
                                                for m in matchers):
                continue
            keep = (ts >= start_nanos) & (ts < end_nanos)
            pts.append(list(zip(ts[keep].tolist(), vals[keep].tolist())))
            metas.append(SeriesMeta(tuple(sorted(tags.items()))))
        return RawBlock.from_lists(pts, metas)


def _query_corpus(seed=8, N=200):
    rng = np.random.default_rng(seed)
    out = []
    for host in range(6):
        ts = START + np.cumsum(rng.integers(10, 20, N)) * SEC
        v = np.cumsum(rng.integers(0, 50, N)).astype(float)
        v[N // 2:] -= v[N // 2] - 1.0  # a counter reset
        out.append(({b"__name__": b"req", b"host": b"h%d" % host}, ts, v))
        g = np.round(rng.normal(50, 8, N), 2)
        g[rng.random(N) < 0.05] = np.nan
        out.append(({b"__name__": b"temp", b"host": b"h%d" % host}, ts, g))
        for le in (b"0.1", b"1", b"+Inf"):
            out.append(({b"__name__": b"lat", b"host": b"h%d" % host, b"le": le}, ts,
                        v * {b"0.1": 0.3, b"1": 0.7, b"+Inf": 1.0}[le]))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("q", [
    "histogram_quantile(0.9, rate(lat[5m]))", "rate(req[5m])", "irate(req[2m])",
    "sum_over_time(temp[5m])", "stddev_over_time(temp[5m])",
    "quantile_over_time(0.7, temp[5m])", "max_over_time(temp[5m])", "deriv(req[10m])",
    "resets(req[10m])", "holt_winters(temp[5m], 0.3, 0.6)",
    "topk(2, rate(req[5m]))", "quantile(0.5, temp)", "sum by (le) (rate(lat[5m]))",
    'rate(lat{le="0.1"}[5m]) / ignoring (le) rate(lat{le="+Inf"}[5m])',
    "temp > bool 50", "sgn(temp - 50) ^ 2", "temp and temp > 50", "day_of_week()",
    'max_over_time(rate(req{host="h0"}[5m])[10m:1m])'])
@pytest.mark.parametrize("policy", ["f64", "f32"])
def test_query_engine_card_matches_cpu(q, policy):
    """The engine on the card against the engine on the CPU.  The card's
    parallel cumsum and reductions add in other orders: rtol 1e-9 plus
    1e-9 of the block's largest |value| (f64), 1e-5 (f32)."""
    from m3_tpu_torch.query import engine as qe
    from m3_tpu_torch.query import precision

    dev = _cuda_or_skip()
    storage = _QueryStorage(_query_corpus())
    t0, t1 = START + 20 * 60 * SEC, START + 45 * 60 * SEC
    precision.set_compute_dtype(policy)
    try:
        a = qe.Engine(storage, device=dev).execute_range(q, t0, t1, 60 * SEC)
        b = qe.Engine(storage, device="cpu").execute_range(q, t0, t1, 60 * SEC)
    finally:
        precision.set_compute_dtype("f64")
    assert a.series == b.series and a.values.shape == b.values.shape
    np.testing.assert_array_equal(np.isnan(a.values), np.isnan(b.values))
    ok = np.isfinite(b.values)
    rtol = 1e-9 if policy == "f64" else 1e-5
    scale = np.abs(b.values[ok]).max(initial=0.0)
    np.testing.assert_allclose(a.values[ok], b.values[ok], rtol=rtol, atol=rtol * scale)


@pytest.mark.gpu
def test_decode_rate_hq_card_matches_cpu():
    """Bytes to quantiles on the card against the CPU: decoded values and
    timestamps exact, rates bit for bit (the reset correction adds one
    non-zero term a row), hq rtol 1e-12 (the bucket sums add in other
    orders); kernel #2 launches."""
    from m3_tpu_torch.parallel import sharded_query as sq

    dev = _cuda_or_skip()
    rng = np.random.default_rng(2)
    S, T, B = 96, 120, 4
    ts = np.tile(START + np.arange(T, dtype=np.int64) * 15 * SEC, (S, 1))
    vals = np.cumsum(rng.gamma(2.0, 3.0, (S, T)), axis=1)
    vals[5, T // 2:] -= vals[5, T // 2] - 1.0
    streams, fb = mt.encode_batch(ts, vals, ts[:, 0].copy(), out_words=T * 80 // 64 + 8,
                                  device="cpu")
    assert not fb.any()
    words, nbits = mt.pack_streams(streams)
    bid = (np.arange(S) % B).astype(np.int32)
    steps = START + np.arange(30, T, 4, dtype=np.int64) * 15 * SEC
    ubs = np.array([0.1, 1.0, 5.0, np.inf])
    args = (words, nbits, bid, steps, ubs, 5 * 60 * SEC, 0.9, T + 1, B)
    before = dg.launches
    r_c, h_c, e_c = sq.decode_rate_hq(*args, device=dev)
    assert dg.launches > before
    r_h, h_h, e_h = sq.decode_rate_hq(*args, device="cpu")
    assert torch.equal(e_c.cpu(), e_h) and not bool(e_h.any())
    assert _same_bits(r_c.cpu(), r_h)
    np.testing.assert_allclose(h_c.cpu().numpy(), h_h.numpy(), rtol=1e-12)
    w = torch.from_numpy(words.view(np.int64))
    d_c = sq.decode_to_step_series(w.to(dev), torch.from_numpy(nbits).to(dev), T + 1)
    d_h = sq.decode_to_step_series(w, torch.from_numpy(nbits), T + 1)
    assert torch.equal(d_c[0].cpu(), d_h[0]) and _same_bits(d_c[1].cpu(), d_h[1])


def _f64_bits_equal(a, b):
    return torch.equal(a.cpu().view(torch.int64), b.cpu().view(torch.int64))


@pytest.mark.gpu
def test_decode_rate_hq_many_buckets_bit_equal_on_two_runs():
    """B = 66 buckets (past the masked sum's 64): kernel #3 adds each
    (bucket, step) lane's rates in series order, so two card runs and
    the CPU give the same rates and bucket sums bit for bit."""
    from m3_tpu_torch.parallel import sharded_query as sq

    dev = _cuda_or_skip()
    rng = np.random.default_rng(6)
    S, T, B = 66 * 40, 60, 66
    ts = np.tile(START + np.arange(T, dtype=np.int64) * 15 * SEC, (S, 1))
    vals = np.cumsum(rng.gamma(2.0, 3.0, (S, T)), axis=1)
    streams, fb = mt.encode_batch(ts, vals, ts[:, 0].copy(), out_words=T * 80 // 64 + 8,
                                  device="cpu")
    assert not fb.any()
    words, nbits = mt.pack_streams(streams)
    bid = (np.arange(S) % B).astype(np.int32)
    steps = START + np.arange(21, T, 3, dtype=np.int64) * 15 * SEC
    ubs = np.concatenate([np.arange(1, B, dtype=np.float64), [np.inf]])
    args = (words, nbits, bid, steps, ubs, 5 * 60 * SEC, 0.9, T + 1, B)
    r_c, h_c, _ = sq.decode_rate_hq(*args, device="cpu")
    sums = []
    for _ in range(2):
        before = si.launches["segment_ingest"]
        r_g, h_g, _ = sq.decode_rate_hq(*args, device=dev)
        assert si.launches["segment_ingest"] > before
        assert _f64_bits_equal(r_g, r_c)
        sums.append(sq._bucket_sum(r_g, torch.from_numpy(bid).to(dev), B))
    want = sq._bucket_sum(r_c, torch.from_numpy(bid), B)
    assert _f64_bits_equal(sums[0], want) and _f64_bits_equal(sums[1], want)
    np.testing.assert_array_equal(h_g.cpu().numpy(), h_c.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(3))
def test_buffer_append_and_drain_card_equal_cpu(seed):
    """buffer_append and buffer_drain on the card against the CPU, bit
    for bit: out-of-range windows, overflow past the capacity and
    duplicate (slot, ts) pairs included."""
    from m3_tpu_torch.storage import buffer as bf

    dev = _cuda_or_skip()
    rng = np.random.default_rng(seed)
    W, S, C = 3, 1 << 9, 1000
    states = {}
    for d in ("cpu", dev):
        states[str(d)] = bf.buffer_init(W, S, C, d)
    for _ in range(3):
        n = int(rng.integers(1000, 3000))
        cols = (rng.integers(-1, W + 1, n).astype(np.int32),
                rng.integers(0, C, n).astype(np.int32),
                rng.integers(0, 200, n).astype(np.int64),
                rng.normal(size=n))
        for d, st in states.items():
            states[d] = bf.buffer_append(st, *(torch.from_numpy(a).to(d) for a in cols))
    c, g = states["cpu"], states[str(dev)]
    assert int(c.n.max()) > S  # overflow reached
    for a, b in zip(c, g):
        assert torch.equal(a.view(torch.int64) if a.dtype == torch.float64 else a,
                           (b.view(torch.int64) if b.dtype == torch.float64 else b).cpu())
    for w in range(W):
        for a, b in zip(bf.buffer_drain(c, w), bf.buffer_drain(g, w)):
            assert torch.equal(a.view(torch.int64) if a.dtype == torch.float64 else a,
                               (b.view(torch.int64) if b.dtype == torch.float64 else b).cpu())


@pytest.mark.gpu
def test_database_flush_on_card_writes_cpu_bytes(tmp_path):
    """A small Database fed the same writes on the card and on the CPU
    writes identical fileset volumes (warm volume 0 through kernel #1,
    cold volume 1) and reads back the same points."""
    import hashlib
    import pathlib

    from m3_tpu_torch.storage.database import Database, DatabaseOptions

    dev = _cuda_or_skip()
    block = 2 * 3600 * SEC
    start = START // block * block
    ids = [b"s%04d" % i for i in range(500)]
    out = {}
    for d in ("cpu", dev):
        root = tmp_path / str(d)
        db = Database(DatabaseOptions(root=str(root)), device=d)
        rng = np.random.default_rng(1)
        for k in range(40):
            db.write_batch("default", ids, np.full(500, start + k * 10 * SEC),
                           rng.normal(size=500).round(1))
        before = ep.launches
        now = start + block + 11 * 60 * SEC
        db.tick(now)
        if d == dev:
            assert ep.launches > before
        db.write_batch("default", ids[:50], np.full(50, start + 5 * SEC), np.ones(50),
                       now_nanos=now)
        db.tick(now + SEC)
        reads = db.read_batch("default", ids, start, start + block)
        db.close()
        files = {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
                 for p in sorted(pathlib.Path(root, "data").rglob("*")) if p.is_file()}
        out[str(d)] = (files, reads)
    (fc, rc), (fg, rg) = out.values()
    assert fc == fg and any("-1-data" in f for f in fc)
    assert rc == rg


_DS_RULES = {
    "mapping_rules": [{"name": "M", "filter": "__name__:reqs", "policies": ["1m:48h"]}],
    "rollup_rules": [
        {"name": "R1", "filter": "__name__:reqs", "targets": [{"pipeline": [
            {"aggregation": "SUM"},
            {"rollup": {"new_name": "reqs_by_app", "tags": ["app"], "aggregation": []}},
            {"transformation": "ADD"}], "policies": ["1m:48h"]}]},
        {"name": "R2", "filter": "__name__:reqs", "targets": [{"pipeline": [
            {"aggregation": "SUM"},
            {"rollup": {"new_name": "stage1", "tags": ["app", "code"], "aggregation": []}},
            {"rollup": {"new_name": "reqs_total", "tags": [], "aggregation": ["SUM"]}}],
            "policies": ["1m:48h"]}]}]}


@pytest.mark.gpu
def test_downsampler_on_card_writes_cpu_bytes(tmp_path):
    """The coordinator Downsampler over a Database, on the card and on the
    CPU, fed the same counters under a mapping rule, a Sum-then-Add
    rollup and a two-stage rollup, with a checkpoint restored mid-stream:
    the same flushed batches, and identical files after the output
    namespace's warm flush (kernel #1)."""
    import hashlib
    import pathlib

    from m3_tpu_torch.coordinator.downsample import Downsampler, DownsamplerOptions
    from m3_tpu_torch.index.doc import Document
    from m3_tpu_torch.metrics.rules_json import ruleset_from_json
    from m3_tpu_torch.storage.database import Database, DatabaseOptions, NamespaceOptions

    dev = _cuda_or_skip()
    block = 2 * 3600 * SEC
    start = START // block * block
    docs = [Document.from_tags(b"reqs{app=a%d,code=%d,i=%d}" % (i % 7, i % 3, i),
                               {b"__name__": b"reqs", b"app": b"a%d" % (i % 7),
                                b"code": b"%d" % (i % 3), b"i": b"%d" % i})
            for i in range(3000)]
    out = {}
    for d in ("cpu", dev):
        root = tmp_path / str(d)
        db = Database(DatabaseOptions(root=str(root)), device=d)
        db.ensure_namespace("1m:2d", NamespaceOptions(slot_capacity=1 << 13,
                                                      sample_capacity=1 << 15))
        opts = DownsamplerOptions(capacity=1 << 13)
        ds = Downsampler(db, ruleset_from_json(_DS_RULES), opts=opts, device=d)
        rng = np.random.default_rng(2)
        flushed = []
        for k in range(6):
            ds.write_batch(docs, np.full(len(docs), start + k * 20 * SEC + SEC),
                           rng.integers(0, 1000, len(docs)).astype(np.float64),
                           metric_type=MetricType.COUNTER)
            if k == 2:
                ds.checkpoint_to(root / "agg.ckpt")
                ds = Downsampler(db, ruleset_from_json(_DS_RULES), opts=opts, device=d)
                ds.restore_from(root / "agg.ckpt")
            if k % 3 == 2:
                flushed.append(ds.flush(start + (k + 1) // 3 * 60 * SEC))
        flushed.append(ds.flush(start + 3 * 60 * SEC))
        before = ep.launches
        db.tick(start + block + 11 * 60 * SEC)
        if d == dev:
            assert ep.launches > before
        db.close()
        files = {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
                 for p in sorted(pathlib.Path(root, "data").rglob("*")) if p.is_file()}
        out[str(d)] = (files, flushed)
    (fc, wc), (fg, wg) = out.values()
    assert wc == wg and fc == fg and any("1m:2d" in f for f in fc)


@pytest.mark.gpu
def test_forwarding_on_card_equals_cpu():
    """Four shards on the f64 layout, counters whose two-stage Sum tails
    forward across shards (kernels #3 and #4 on the card): every consume
    pass flushes the same rows on the card as on the CPU."""
    from m3_tpu_torch.metrics.pipeline import AppliedRollupOp, Pipeline

    dev = _cuda_or_skip()
    sp = StoragePolicy.parse("10s:2d")
    sum_id = AggregationID.compress([AggregationType.SUM])
    rng = np.random.default_rng(3)
    vals = rng.normal(5, 3, (2, 4000)).round(3)
    passes = {}
    for d in ("cpu", dev):
        agg = te.Aggregator(num_shards=4, opts=te.AggregatorOptions(
            capacity=1 << 12, num_windows=4, timer_sample_capacity=1 << 10, layout="f64",
            storage_policies=(sp,)), device=d)
        before = dict(si.launches)
        for w in range(2):
            for g in range(40):
                rows = [i for i in range(4000) if i % 40 == g]
                sids = [b"s1.%d" % i for i in rows]
                for sh in {agg.shard_index(s) for s in sids}:
                    sel = [j for j, s in enumerate(sids) if agg.shard_index(s) == sh]
                    agg.shards[sh].lists[sp].add_batch(
                        MetricType.COUNTER, [sids[j] for j in sel], vals[w][[rows[j] for j in sel]],
                        np.full(len(sel), START + w * 10 * SEC + SEC), sum_id,
                        pipeline=Pipeline((AppliedRollupOp(b"s2.%d" % g, sum_id),)))
        got = []
        for k in range(1, 5):
            got.append([(fm.timestamp_nanos, fm.slots.tolist(), fm.values.tolist())
                        for fm in agg.consume(START + k * 10 * SEC)])
        if d == dev:
            assert all(si.launches[k] > before[k] for k in si.KERNELS)
        passes[str(d)] = got
    assert passes["cpu"] == passes[str(dev)]
    assert sum(len(p) for p in passes["cpu"]) > 0


@pytest.mark.gpu
def test_node_on_card_equals_node_on_cpu(tmp_path):
    """A small node (m3_tpu_torch.server.assembly.run_node) on the card
    and one on the CPU get the same Prometheus remote writes and
    queries: bit-equal answers (selectors and max_over_time, elementwise
    on both devices; the remote read body byte for byte), then a
    mediator pass past the block whose warm flush launches kernel #1 on
    the card, and every fileset and commit-log file sha256-equal."""
    import hashlib
    import json
    import urllib.request
    from pathlib import Path

    from m3_tpu_torch.server import prom_remote as pr
    from m3_tpu_torch.server.assembly import run_node

    dev = _cuda_or_skip()
    block = 2 * 3600 * SEC
    t0 = START // block * block
    series = [pr.PromTimeSeries(
        {b"__name__": b"reqs", b"host": b"h%d" % i},
        [(t0 + k * 10 * SEC, float(i * 1000 + k * (i + 1))) for k in range(60)])
        for i in range(40)]
    body = pr.build_write_request(series)
    end = (t0 + 590 * SEC) // SEC
    queries = [f"/api/v1/query_range?query=reqs&start={t0 // SEC}&end={end}&step=10",
               f"/api/v1/query_range?query=max_over_time(reqs[1m])"
               f"&start={t0 // SEC + 60}&end={end}&step=30"]
    read = pr.snappy.compress(pr._emit_len(1, pr._emit_field(1, 0, pr._emit_varint(
        t0 // 10**6)) + pr._emit_field(2, 0, pr._emit_varint(end * 1000)) + pr._emit_len(
        3, pr._emit_field(1, 0, pr._emit_varint(0)) + pr._emit_len(2, b"__name__")
        + pr._emit_len(3, b"reqs"))))
    answers, digests = {}, {}
    for d in ("cpu", dev):
        root = tmp_path / str(d).replace(":", "")
        asm = run_node(f"db: {{root: {root}, namespaces: {{default: {{num_shards: 2}}}}}}\n"
                       "coordinator: {listen_port: 0}\nmediator: {tick_interval: 1h}\n",
                       device=d)
        try:
            base = f"http://127.0.0.1:{asm.port}"
            req = urllib.request.Request(base + "/api/v1/prom/remote/write", data=body)
            assert urllib.request.urlopen(req).status == 204
            got = [urllib.request.urlopen(base + q).read() for q in queries]
            got.append(urllib.request.urlopen(urllib.request.Request(
                base + "/api/v1/prom/remote/read", data=read)).read())
            before = ep.launches
            asm.mediator.run_once(t0 + block + 11 * 60 * SEC)
            if d == dev:
                assert ep.launches > before
            got += [urllib.request.urlopen(base + q).read() for q in queries]
            answers[str(d)] = got
        finally:
            asm.close()
        digests[str(d)] = {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
                           for p in sorted(Path(root).rglob("*"))
                           if p.is_file() and ("fileset" in p.name or "commitlog" in p.name)}
    assert answers["cpu"] == answers[str(dev)]
    assert json.loads(answers["cpu"][0])["data"]["result"]
    assert digests["cpu"] == digests[str(dev)] and any("fileset" in k for k in digests["cpu"])
