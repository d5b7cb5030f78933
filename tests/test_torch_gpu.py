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


def _tier_rows(d, frames, timed, passthrough, forwarded, clock):
    """One aggregator on ``d`` behind an IngestServer, fed by an
    AggregatorClient (METRIC_BATCH and TIMED_BATCH frames, passthrough)
    and a raw FORWARDED_BATCH frame: its flushed rows (value bits) and
    passthrough batches."""
    import socket
    import time

    from m3_tpu_torch import instrument
    from m3_tpu_torch.client.aggregator_client import AggregatorClient
    from m3_tpu_torch.cluster.placement import Instance, initial_placement
    from m3_tpu_torch.msg import protocol as wire
    from m3_tpu_torch.server.ingest_tcp import aggregator_sink, serve_ingest_background

    got_pt = []
    agg = te.Aggregator(num_shards=8, opts=te.AggregatorOptions(
        capacity=1 << 12, num_windows=2, timer_sample_capacity=1 << 14,
        storage_policies=(StoragePolicy.parse("1m:48h"),)),
        passthrough_handler=got_pt.append, device=d)
    reg = instrument.new_registry()
    srv = serve_ingest_background(aggregator_sink(agg, clock=clock), instrument=reg.scope(""))
    try:
        client = AggregatorClient(initial_placement([Instance("i0")], 64, 1),
                                  lambda _: ("127.0.0.1", srv.port))
        n = 0
        for f in frames:
            n += client.write_batch(*f)
            client.flush()
        n += client.write_timed_batch(*timed)
        client.flush()
        client.write_passthrough(*passthrough)
        n += len(passthrough[0])
        s = socket.create_connection(("127.0.0.1", srv.port))
        wire.send_frame(s, wire.FORWARDED_BATCH, wire.encode_forwarded_batch("1m:48h", forwarded))
        n += len(forwarded)
        deadline = time.monotonic() + 300
        while reg.snapshot().get("ingest_tcp.samples", 0) < n:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        s.close()
        client.close()
    finally:
        srv.shutdown()
        srv.server_close()
    rows = []

    def handler(ml, f):
        m = ml.maps[f.metric_type]
        rows.extend((m.id_of(int(s_)), f.timestamp_nanos, int(f.metric_type), int(a),
                     np.float64(v).view(np.int64).item())
                    for s_, a, v in zip(f.slots.tolist(), f.types.tolist(), f.values.tolist()))

    agg.consume(START + 10 * 60 * SEC, handler)
    return sorted(rows), [(str(b.policy), b.ids, b.values.view(np.int64).tolist(),
                           b.times.tolist()) for b in got_pt], agg.counters()


@pytest.mark.gpu
def test_ingest_server_on_card_equals_cpu():
    """The aggregator tier's front door on the card and on the CPU: the
    same METRIC_BATCH frames (counters, gauges, timers over two
    windows), a TIMED_BATCH frame on an injected server clock (some
    samples too early), a passthrough batch and a FORWARDED_BATCH frame
    give bit-equal flushed rows, passthrough batches and counters."""
    dev = _cuda_or_skip()
    rng = np.random.default_rng(5)
    t0 = START // (60 * SEC) * 60 * SEC
    n = 3000
    ids = [b"tier.%d.%05d" % (i % 3, i) for i in range(n)]
    mts = np.array([1, 3, 2], np.uint8)[np.arange(n) % 3]
    frames = []
    for k in range(9):
        p = rng.permutation(n)
        frames.append((mts[p], [ids[i] for i in p], np.round(rng.gamma(2, 30, n), 3)[p],
                       (t0 + k * 10 * SEC + rng.integers(0, 10, n) * SEC)[p]))
    tt = t0 + rng.integers(0, 120, n) * SEC
    tt[::50] = t0 - 3600 * SEC
    timed = (mts, ids, np.round(rng.normal(0, 9, n), 2), tt)
    passthrough = (ids[:500], rng.normal(size=500), np.full(500, t0, np.int64),
                   StoragePolicy.parse("1m:40d"))
    sum_id = AggregationID.compress([AggregationType.SUM])
    forwarded = [(te.ForwardSpec(b"fwd.%02d" % (i % 40), sum_id, ()), float(i % 7),
                  int(t0 + (i % 90) * SEC)) for i in range(2000)]
    clock = lambda: t0 + 30 * SEC  # noqa: E731
    card = _tier_rows(dev, frames, timed, passthrough, forwarded, clock)
    cpu = _tier_rows("cpu", frames, timed, passthrough, forwarded, clock)
    assert card == cpu
    rows, pts, counters = card
    assert len(rows) > n and len(pts) == 1 and counters["timed_rejects_too_early"] == n // 50


@pytest.mark.gpu
def test_threaded_ingest_and_ticks_on_card_equal_serial():
    """Four clients stream three windows into an IngestServer in front
    of the aggregator on the card while a FlushManager ticks each
    window under the sink's lock as soon as every client's frames for it
    are acknowledged: the flushed rows equal a serial run's on the card
    and on the CPU (the worker, the handlers and the flush thread all
    launch on the default stream)."""
    import threading

    from m3_tpu_torch import instrument
    from m3_tpu_torch.aggregator.flush_mgr import FlushManager
    from m3_tpu_torch.client.aggregator_client import AggregatorClient
    from m3_tpu_torch.cluster.kv import KVStore
    from m3_tpu_torch.cluster.placement import Instance, initial_placement
    from m3_tpu_torch.server.ingest_tcp import aggregator_sink, serve_ingest_background

    dev = _cuda_or_skip()
    W = 10 * SEC
    t0 = START // W * W
    n_clients, n_windows, per = 4, 3, 400

    def frames(c, w):
        rng = np.random.default_rng(100 * c + w)
        ids = [b"cc%d.s%d" % (c, i) for i in range(per)]
        return [(np.full(per, 1 + (c % 2) * 2, np.uint8), ids,
                 np.round(rng.normal(10, 3, per), 2),
                 np.full(per, t0 + 1 + k + w * W, np.int64)) for k in range(2)]

    def node(d):
        agg = te.Aggregator(num_shards=4, opts=te.AggregatorOptions(
            capacity=1 << 12, num_windows=4, timer_sample_capacity=1 << 10,
            storage_policies=(StoragePolicy.parse("10s:2d"),)), device=d)
        rows = []

        def on_flush(ml, f):
            m = ml.maps[f.metric_type]
            rows.extend((m.id_of(s), f.timestamp_nanos, int(a),
                         np.float64(v).view(np.int64).item()) for s, a, v in
                        zip(f.slots.tolist(), f.types.tolist(), f.values.tolist()))

        return agg, FlushManager(agg, KVStore(), "i0", flush_handler=on_flush), rows

    agg, fm, rows_conc = node(dev)
    lock = threading.Lock()
    reg = instrument.new_registry()
    srv = serve_ingest_background(aggregator_sink(agg, lock), instrument=reg.scope(""))
    placement = initial_placement([Instance("i0")], 4, 1)
    done = [0] * n_windows
    cv = threading.Condition()
    errors = []

    def run_client(c):
        try:
            cl = AggregatorClient(placement, lambda _: ("127.0.0.1", srv.port))
            for w in range(n_windows):
                for f in frames(c, w):
                    cl.write_batch(*f)
                    assert cl.flush() == per
                with cv:
                    done[w] += 1
                    cv.notify_all()
            cl.close()
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    def ticker():
        try:
            for w in range(n_windows):
                with cv:
                    assert cv.wait_for(lambda: done[w] == n_clients, timeout=300)
                with lock:
                    assert fm.tick(t0 + (w + 1) * W) == "leader"
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run_client, args=(c,)) for c in range(n_clients)]
    threads.append(threading.Thread(target=ticker))
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        assert not any(t.is_alive() for t in threads) and not errors, errors
    finally:
        srv.shutdown()
        srv.server_close()
    key = lambda r: (r[1], r)  # noqa: E731 — window, then the row
    for d in (dev, "cpu"):
        ser, sfm, rows_ser = node(d)
        for w in range(n_windows):
            for c in range(n_clients):
                for mts, ids, vals, ts in frames(c, w):
                    ser.add_untimed_batch(MetricType(int(mts[0])), ids, vals, ts)
            assert sfm.tick(t0 + (w + 1) * W) == "leader"
        assert sorted(rows_conc, key=key) == sorted(rows_ser, key=key)
    assert len(rows_conc) == n_windows * n_clients * per


@pytest.mark.gpu
def test_hops_pipeline_on_card_writes_cpu_bytes(tmp_path):
    """The HOPS pipeline (m3_tpu_torch.tools.hops) on a reduced corpus:
    the card's volume (kernel #1 in its encode) equals the CPU's, sha256."""
    from m3_tpu_torch.tools import hops

    dev = _cuda_or_skip()
    before = ep.launches
    card = hops.run_pipeline(96, 60, root=str(tmp_path / "card"), device=dev)
    assert ep.launches > before
    cpu = hops.run_pipeline(96, 60, root=str(tmp_path / "cpu"), device="cpu")
    assert card["volume_sha256"] == cpu["volume_sha256"] == card["cold_volume_sha256"]


# ---- the device mesh (parallel/mesh.py and the sharded paths) ----


def _mesh_batch(D, W, C, N, seed):
    rng = np.random.default_rng(seed)
    from m3_tpu_torch.parallel.sharded_agg import ShardedBatch

    return ShardedBatch(
        windows=rng.integers(0, W, (D, N)).astype(np.int32),
        slots=rng.integers(-2, C + 2, (D, N)).astype(np.int32),
        counter_values=rng.integers(0, 1000, (D, N)).astype(np.int64),
        gauge_values=np.where(rng.random((D, N)) < 0.02, np.nan, rng.normal(100, 10, (D, N))),
        timer_values=np.abs(rng.normal(0.1, 0.02, (D, N))),
        times=np.tile(np.arange(1, N + 1), (D, 1)).astype(np.int64))


def _mesh_step(devices, layout, shards, replicas=1, seed=4):
    """Two sharded steps (ingest + drain of window 0, then of window 1):
    (lanes of each, the final state's tensors of replica 0, as numpy)."""
    from m3_tpu_torch.parallel import mesh, sharded_agg as sa

    topo = mesh.make_mesh(shards, replicas, devices)
    W, C, N = 2, 512, 4096
    state = sa.sharded_init(topo, W, C, 4 * N, layout=layout)
    out = []
    for window in (0, 1):
        batch = _mesh_batch(shards, W, C, N, seed + window)
        state, lanes = sa.sharded_ingest_consume(topo, state, batch, window, W, C,
                                                 layout=layout)
        out.append({k: [x.cpu().numpy() for x in (v if isinstance(v, tuple) else (v,))]
                    for k, v in lanes.items()})
    fields = [t.cpu().numpy() for f in state for row in f for t in row[0]]
    return out, fields


def _same_arrays(a, b):
    return all(x.dtype == y.dtype and np.array_equal(
        x.view(np.int64) if x.dtype == np.float64 else x,
        y.view(np.int64) if y.dtype == np.float64 else y) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["f64", "packed"])
def test_sharded_step_on_card_equals_cpu(layout):
    """Four shards on one card (a repeated device list) against four on
    the CPU: every lane, the rollup, ``err`` and every state tensor bit
    for bit; the f64 layout launches kernels #3 and #4, the packed none."""
    dev = _cuda_or_skip()
    before = dict(si.launches)
    card, card_state = _mesh_step([dev] * 4, layout, 4)
    moved = {k: si.launches[k] - before[k] for k in si.KERNELS}
    assert all(moved.values()) if layout == "f64" else not any(moved.values())
    cpu, cpu_state = _mesh_step(["cpu"] * 4, layout, 4)
    for c, w in zip(card, cpu):
        for k in w:
            assert _same_arrays(c[k], w[k]), k
    assert _same_arrays(card_state, cpu_state)


@pytest.mark.gpu
def test_sharded_f64_step_over_two_cards_equals_one_card():
    """Each kernel wrapper launches on its tensor's card: two shards on
    two cards equal two shards on one, bit for bit."""
    _cuda_or_skip()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    two, two_state = _mesh_step(["cuda:0", "cuda:1"], "f64", 2)
    one, one_state = _mesh_step(["cuda:0", "cuda:0"], "f64", 2)
    for a, b in zip(two, one):
        for k in b:
            assert _same_arrays(a[k], b[k]), k
    assert _same_arrays(two_state, one_state)


@pytest.mark.gpu
def test_sharded_codec_over_two_cards_equals_one_card():
    """Kernels #1 and #2 on the second card: the sharded encode and decode
    over two cards equal the one-card codec."""
    from m3_tpu_torch.parallel.sharded_decode import decode_batch_device_sharded
    from m3_tpu_torch.parallel.sharded_encode import encode_batch_device_sharded

    dev = _cuda_or_skip()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    ts, vals, starts = _mixed_batch(9, 301, 60)
    valid = np.ones(ts.shape, bool)
    vb = vals.view(np.int64)
    enc = encode_batch_device_sharded(ts, vb, starts, valid, out_words=80,
                                      devices=["cuda:0", "cuda:1"])
    one = mt.encode_batch_device(ts, vb, starts, valid, out_words=80, device=dev)
    for k in ("words", "total_bits", "fallback"):
        assert torch.equal(enc[k], one[k]), k
    dec = decode_batch_device_sharded(one["words"], one["total_bits"], 61,
                                      devices=["cuda:0", "cuda:1"])
    want = mt.decode_batch_device(one["words"], one["total_bits"], 61, device=dev)
    assert all(torch.equal(a, b) for a, b in zip(dec, want))


@pytest.mark.gpu
def test_sharded_query_on_card_equals_cpu():
    """The D-shard query on four shards of one card against the same on
    the CPU, bit for bit (the psum adds in shard order on both)."""
    from m3_tpu_torch.parallel import mesh
    from m3_tpu_torch.parallel import sharded_query as sq

    dev = _cuda_or_skip()
    D, S, T = 4, 50, 64
    rng = np.random.default_rng(2)
    ts = np.tile(START + np.arange(1, T + 1) * 15 * SEC, (D * S, 1)).astype(np.int64)
    bid = rng.integers(0, 4, (D, S)).astype(np.int32)
    vals = np.cumsum(np.tile(np.round(10.0 * (bid.reshape(-1, 1) + 1) / 4, 1), (1, T)), axis=1)
    streams, fb = mt.encode_batch(ts, vals, np.full(D * S, START, np.int64), out_words=300,
                                  device="cpu")
    assert not fb.any()
    words, nbits = mt.pack_streams(streams)
    args = (words.reshape(D, S, -1), nbits.reshape(D, S), bid,
            np.asarray(START + np.arange(8, 56, 4) * 15 * SEC, np.int64),
            np.asarray([0.1, 0.5, 1.0, np.inf]), 5 * 60 * SEC, 0.9, T + 1, 4)
    before = dg.launches
    card = sq.sharded_decode_rate_hq(mesh.make_mesh(4, 1, [dev] * 4), *args)
    assert dg.launches - before == 4
    cpu = sq.sharded_decode_rate_hq(mesh.make_mesh(4, 1, ["cpu"] * 4), *args)
    assert _same_arrays([x.cpu().numpy() for x in card], [x.numpy() for x in cpu])


def _cluster_on(devs, root, S, K, down_after):
    """Three dbnodes (``Database`` + ``DbNodeRpcServer`` on loopback) on
    ``devs``, a placement of 64 shards at RF 3, a session at MAJORITY
    writing K scrapes of S series with node C down after ``down_after``,
    a flush, then ``repair_namespace`` over RPC.  Returns (each node's
    files, the session's reads, the repair report)."""
    import hashlib

    from m3_tpu_torch.client.session import ReplicatedSession
    from m3_tpu_torch.cluster.placement import Instance, initial_placement
    from m3_tpu_torch.server.rpc import RemoteDatabase, serve_rpc_background
    from m3_tpu_torch.storage.database import Database, DatabaseOptions, NamespaceOptions
    from m3_tpu_torch.storage.repair import repair_namespace

    block = 2 * 3600 * SEC
    t0 = START // block * block
    dbs = {n: Database(DatabaseOptions(root=str(root / n)), {"default": NamespaceOptions(
        num_shards=64, slot_capacity=1 << 10, sample_capacity=1 << 12)}, device=d)
        for n, d in zip("ABC", devs)}
    srvs = {n: serve_rpc_background(db) for n, db in dbs.items()}
    remotes = {n: RemoteDatabase(("127.0.0.1", s.port), timeout_s=120.0) for n, s in srvs.items()}
    try:
        p = initial_placement([Instance(n, isolation_group=n) for n in dbs], 64, 3)
        sess = ReplicatedSession(p, dict(remotes))
        rng = np.random.default_rng(21)
        ids = [b"gpu%05d" % i for i in range(S)]
        vals = np.round(rng.normal(50, 5, (K, S)), 2)
        for k in range(K):
            if k == down_after:
                srvs["C"].shutdown()
                srvs["C"].server_close()
                remotes["C"].close()
            ts = np.full(S, t0 + k * 10 * SEC, np.int64)
            assert sess.write_batch("default", ids, ts, vals[k],
                                    now_nanos=t0 + (k + 1) * 10 * SEC) == 0
        srvs["C"] = serve_rpc_background(dbs["C"], port=srvs["C"].port)
        for db in dbs.values():
            db.tick(t0 + block + 11 * 60 * SEC)
        rep = repair_namespace(list(remotes.values()), "default", num_shards=64)
        assert repair_namespace(list(remotes.values()), "default", num_shards=64).converged
        reads = sess.fetch_batch("default", ids, t0, t0 + block)
        assert all(len(r) == K for r in reads)
    finally:
        for n in dbs:
            remotes[n].close()
            srvs[n].shutdown()
            srvs[n].server_close()
            dbs[n].close()
    files = {n: {str(q.relative_to(root / n)): hashlib.sha256(q.read_bytes()).hexdigest()
                 for q in sorted((root / n / "data").rglob("*")) if q.is_file()}
             for n in dbs}
    return files, [[(t, float(v).hex()) for t, v in r] for r in reads], dict(rep)


@pytest.mark.gpu
def test_three_node_cluster_on_card_equals_cpu(tmp_path):
    """The replicated cluster at 2^12 series: the nodes on the card (on
    three distinct cards where the machine has them) and on the CPU write
    sha256-equal files and answer equal reads; repair converges both."""
    dev = _cuda_or_skip()
    n = torch.cuda.device_count()
    devs = [torch.device("cuda", k) for k in range(3)] if n >= 3 else [dev] * 3
    S, K = 1 << 12, 6
    card = _cluster_on(devs, tmp_path / "card", S, K, down_after=4)
    cpu = _cluster_on([torch.device("cpu")] * 3, tmp_path / "cpu", S, K, down_after=4)
    assert card == cpu
    assert card[2]["series_diff"] == S and card[2]["repaired_replicas"] == 64


@pytest.mark.gpu
def test_card_oom_through_a_guarded_stage():
    """A buffer ring larger than the card: one allocation that cannot
    land raises DeviceOOM caused by torch's OutOfMemoryError, counted on
    storage.buffer_append, with nothing left allocated or reserved."""
    from m3_tpu_torch.storage.buffer import ShardBuffer
    from m3_tpu_torch.x import breaker, devguard, membudget

    dev = _cuda_or_skip()
    _free, total = torch.cuda.mem_get_info(dev)
    breaker.reset_registry()
    devguard.reset_stages()
    before, used = torch.cuda.memory_allocated(dev), membudget.used()
    try:
        with pytest.raises(devguard.DeviceOOM) as e:
            ShardBuffer(3600 * SEC, 2, total // 8 + 1, 1 << 17, device=dev)
        assert isinstance(e.value.__cause__, torch.cuda.OutOfMemoryError)
        assert torch.cuda.memory_allocated(dev) == before and membudget.used() == used
        assert devguard.counters() == {"device.storage.buffer_append.errors.oom": 1}
    finally:
        breaker.reset_registry()
        devguard.reset_stages()


_FOOTPRINTS = """
import json, torch
from m3_tpu_torch.aggregator import arena, packed
from m3_tpu_torch.storage.buffer import ShardBuffer
from m3_tpu_torch.x import membudget as mb
dev = torch.device("cuda")
W, C, S = 2, 1_000_000, 1 << 20
builds = {
    "packed counter": (lambda: packed.PackedCounterArena(W, C, device=dev),
                       mb.counter_arena_bytes("packed", W, C)),
    "packed timer": (lambda: packed.PackedTimerArena(W, C, S, device=dev),
                     mb.timer_arena_bytes("packed", W, C, S)),
    "f64 gauge": (lambda: arena.GaugeArena(W, C, device=dev),
                  mb.gauge_arena_bytes("f64", W, C)),
    "f64 timer": (lambda: arena.TimerArena(W, C, S, device=dev),
                  mb.timer_arena_bytes("f64", W, C, S)),
    "buffer": (lambda: ShardBuffer(7200 * 10**9, 2, 1 << 21, 1 << 17, device=dev),
               mb.buffer_bytes(2, 1 << 21)),
}
out = {}
for name, (build, need) in builds.items():
    before = torch.cuda.memory_allocated()
    obj = build()
    torch.cuda.synchronize()
    out[name] = (torch.cuda.memory_allocated() - before, need, obj._mem.nbytes)
    del obj
print(json.dumps(out))
"""


@pytest.mark.gpu
def test_resident_footprints_equal_the_allocators_bytes():
    """In a process whose caching allocator splits every block to its
    request (expandable segments), building each structure grows
    memory_allocated() by its reservation, to the byte."""
    import json
    import os
    import subprocess
    import sys

    _cuda_or_skip()
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _FOOTPRINTS], env=env, cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for name, (delta, need, reserved) in got.items():
        assert delta == need == reserved, (name, delta, need, reserved)


@pytest.mark.gpu
def test_codec_stages_count_on_card():
    """encode and decode on the card run as guarded stages: each call
    counted once, the transient lane reservations released after."""
    from m3_tpu_torch.x import devguard, membudget

    dev = _cuda_or_skip()
    devguard.reset_stages()
    ts, vals, starts = _mixed_batch(5, 64, 50)
    used = membudget.used()
    try:
        streams, fb = mt.encode_batch(ts, vals, starts, device=dev)
        mt.decode_batch(streams, 50, device=dev)
        got = devguard.counters()
        assert got["device.encode.calls"] == 1 and got["device.decode.calls"] == 1
        assert membudget.used() - used in (0, 1 << 20)  # the control table, once
    finally:
        devguard.reset_stages()


@pytest.mark.gpu
def test_carbon_flush_render_and_federation_on_card_equal_cpu(tmp_path):
    """A node on the card and one on the CPU, each with
    ``coordinator.carbon_listen_port``, take the same carbon lines: the
    /render and /metrics/find bodies are byte-equal before and after a
    mediator pass past the block (whose warm flush launches kernel #1
    on the card).  Then a second node on each device federates the
    first through ``query.remotes``: one federated query byte-equal
    between the two devices."""
    import json
    import socket
    import time
    import urllib.parse
    import urllib.request

    from m3_tpu_torch.server.assembly import run_node

    dev = _cuda_or_skip()
    block = 2 * 3600 * SEC
    t0 = START // block * block
    rng = np.random.default_rng(23)
    lines = "".join(f"m3.dc{i % 4}.host{i // 4}.cpu {float(v)!r} {(t0 + k * 10 * SEC) // SEC}\n"
                    for k in range(30) for i, v in enumerate(rng.normal(50, 10, 64)))
    win = f"&from={t0 // SEC}&until={(t0 + 300 * SEC) // SEC}&step=10s"
    reads = ["/render?target=" + urllib.parse.quote(t) + win for t in (
        "m3.*.*.cpu", "sumSeries(m3.dc0.*.cpu)", 'groupByNode(m3.*.*.cpu, 1, "sum")',
        "aliasByNode(highestAverage(m3.dc1.*.cpu, 3), 2)",
        'summarize(m3.dc3.*.cpu, "1min", "sum")')] + ["/metrics/find?query=m3.dc0.*"]
    fed_q = (f"/api/v1/query_range?query=sum+by+(host)+(reqs)&start={t0 // SEC}"
             f"&end={(t0 + 50 * SEC) // SEC}&step=10")
    rows = json.dumps([{"tags": {"__name__": "reqs", "host": f"h{i}"},
                        "timestamp": (t0 + k * 10 * SEC) // SEC, "value": float(i + k)}
                       for k in range(6) for i in range(8)]).encode()
    answers = {}
    for d in ("cpu", dev):
        tag = str(d).replace(":", "")
        a = run_node(f"db: {{root: {tmp_path / (tag + 'a')}}}\n"
                     "coordinator: {listen_port: 0, carbon_listen_port: 0}\n"
                     "query: {listen_port: 0}\nmediator: {tick_interval: 1h}\n", device=d)
        b = None
        try:
            base = f"http://127.0.0.1:{a.port}"
            with socket.create_connection(("127.0.0.1", a.carbon_port)) as s:
                s.sendall(lines.encode())
            deadline = time.monotonic() + 120
            while sum(v is not None for r in json.loads(urllib.request.urlopen(
                    base + reads[0]).read()) for v, _ in r["datapoints"]) < 30 * 64:
                assert time.monotonic() < deadline
                time.sleep(0.05)
            got = [urllib.request.urlopen(base + r).read() for r in reads]
            before = ep.launches
            a.mediator.run_once(t0 + block + 11 * 60 * SEC)
            if d == dev:
                assert ep.launches > before
            got += [urllib.request.urlopen(base + r).read() for r in reads]
            urllib.request.urlopen(urllib.request.Request(
                base + "/api/v1/json/write", data=rows)).read()
            b = run_node(f"db: {{root: {tmp_path / (tag + 'b')}}}\n"
                         "coordinator: {listen_port: 0}\n"
                         f"query: {{remotes: ['127.0.0.1:{a.query_port}']}}\n"
                         "mediator: {enabled: false}\n", device=d)
            got.append(urllib.request.urlopen(f"http://127.0.0.1:{b.port}" + fed_q).read())
            answers[str(d)] = got
        finally:
            if b is not None:
                b.close()
            a.close()
    assert answers["cpu"] == answers[str(dev)]
    assert answers["cpu"][:len(reads)] == answers["cpu"][len(reads):2 * len(reads)]
    assert len(json.loads(answers["cpu"][-1])["data"]["result"]) == 8
