"""On a card: each CUDA kernel of m3_tpu_torch against its plain PyTorch
version, the codec's card bytes against its CPU bytes, and an aggregator
drive on the card against the same drive on the CPU.  Exact comparisons,
except float sums that several points of one launch add into one slot
(the kernel's atomics add in another order): relative 1e-12 and absolute
1e-9 for f64 (stdev too), relative 1e-5 and absolute 1e-2 for f32.  Without a CUDA device every test
here skips.

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
    """Slots with out-of-range and negative entries; NaN and +-0 floats."""
    rng = np.random.default_rng(seed)
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
@pytest.mark.parametrize("C,N", [(1 << 15, 20_000), (64, 1 << 16)])
def test_segment_kernels_match_plain(dtype, C, N):
    dev = _cuda_or_skip()
    slots, vals = (x.to(dev) for x in _segment_inputs(C + N, C, N, dtype))
    before = dict(si.launches)
    got = si.segment_ingest(slots, vals, C, with_sq=True)
    mn, mx = si.segment_minmax(slots, vals, C)
    assert si.launches[si.INGEST_KERNEL] == before[si.INGEST_KERNEL] + 1
    assert si.launches[si.MINMAX_KERNEL] == before[si.MINMAX_KERNEL] + 1
    want = si.segment_ingest_plain(slots, vals, C, with_sq=True)
    assert torch.equal(got[1], want[1])
    for g, w in (got[0], want[0]), (got[2], want[2]):
        if dtype.is_floating_point:
            rtol, atol = (1e-12, 1e-9) if dtype == torch.float64 else (1e-5, 1e-2)
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol, equal_nan=True)
        else:
            assert torch.equal(g, w)
    pmn, pmx = si.segment_minmax_plain(slots, vals, C)
    assert _same_bits(mn, pmn) and _same_bits(mx, pmx)
    e = torch.zeros(0, dtype=torch.int32, device=dev)
    s0, c0 = si.segment_ingest(e, torch.zeros(0, dtype=dtype, device=dev), C)
    assert int(c0.sum()) == 0 and float(s0.double().abs().sum()) == 0.0
    with pytest.raises(TypeError):
        si.segment_minmax(slots, vals.to(torch.int16), C)


def _agg_drive(device):
    """A few windows of counters, gauges and timers through the engine;
    the flushed output keyed by (policy, type, id, agg type, time)."""
    rng = np.random.default_rng(23)
    opts = te.AggregatorOptions(
        capacity=512, num_windows=2, timer_sample_capacity=256, layout="f64",
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
        if k[3] in ("SUM", "SUM_SQ", "MEAN", "STDEV"):
            np.testing.assert_allclose(card[k], want, rtol=1e-12, atol=1e-9,
                                       err_msg=str(k))
        else:
            np.testing.assert_array_equal(card[k], want, err_msg=str(k))
