#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``m3_tpu_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py [--seed 0] [--series 100000] [--points 720]
                          [--agg-series 1000000] [--drain-series 100000]

Phases (any failure exits non-zero; nothing is caught and passed over):

1. print the card's name and power limit; build the four CUDA kernels
   from ``m3_tpu_torch/csrc`` with nvcc for sm_90a (in parallel) and
   print their ``-Xptxas -v`` reports;
2. hold each kernel against its plain PyTorch version on the card, bit
   for bit, at the main path's shapes, with the edge cases (keys out of
   range, widths 0 and 64 and out of range, offsets in the zero pad and
   negative, words with bit 63 set);
3. the main path: ``encode_batch`` then ``decode_batch`` on the card at
   S series x T points (storage's flush setting ``out_words = max(16,
   T*40//64 + 8)``) over a seeded mix of counters, decimal gauges,
   dyadic random walks, constants and NaN-bearing series with jittered
   timestamps; every non-fallback series must round-trip exactly, the
   fallback share must stay under 5 %, both kernels must have launched,
   and a slice must give the same bytes as the CPU path;
4. golden bytes: the Go-encoded streams in ``tests/data`` decode and
   re-encode to identical bytes, and the arithmetic batch hashes to the
   pinned digest;
5. times: datapoints/s of each pass with its phase split; each kernel,
   on the very inputs the timed pass handed it, held bit-equal to its
   plain version once more and timed beside its bound, its plain
   version and the library call; peak device memory;
6. the aggregator's two kernels (``segment_ingest``, ``segment_minmax``)
   against their plain versions, int64 and float64, at the path's shape
   (10^6 unique slots of 2^21) and at a collision shape (2^20 points in
   4096 slots), with out-of-range and negative slots, NaN, an empty batch
   and empty slots; each run twice, and the largest ulp difference of the
   f64 collision sums between the two runs printed (the kernel's float
   atomics add in no fixed order);
7. the aggregator at full width (BASELINE configs #3 and #4): f64
   arenas, capacity 2^20, one 1 m window of 10^6 counters and 10^6
   gauges (six 10 s scrapes each) and 10^6 timers (ten scrapes), one
   scrape into the next window and a few samples too early or too far
   ahead; the first scrape through ``Aggregator.add_untimed_batch``, the
   rest through ``MetricList.add_batch_slots``; ``consume`` checked
   against a numpy oracle built from the same samples, and both kernels
   must have launched;
8. drain -> encode -> decode: 10^5 gauges at 10 s under 1m:2d through
   120 windows (a 2 h block), the drained LAST values encoded and
   decoded on the card, exact round trip, fallback under 5 %;
9. times: samples/s through the entry point and the hot loop, one
   scrape per type under torch.profiler (host routing, device busy and
   idle share), consume split into device lanes and host ``_emit``, each
   new kernel on the path's own inputs from CUDA events around a CUDA
   graph of 20 calls, beside its bound, its plain version and the
   library calls; peak device memory.

The last three lines are a JSON line of kernel records, the card's name
and power limit, and the result line ``{"ok": true, "device": {...}}``.
Exact comparisons throughout, except where a phase names its tolerance.
"""

from __future__ import annotations

import argparse
import base64
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
PINNED_ENCODE_DIGEST = (
    "27ea67c4b75585a1e2bffa6cfeae5e5faeefbaca75de4d5c4c559f15d89ccc18")
SEC = 10**9


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn`` in ms from CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` in ms from CUDA events around one replay
    of a CUDA graph that holds ``reps`` calls: no host launch gaps
    between the calls, so a call of tens of microseconds is timed on the
    card rather than on the host's launch rate."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def make_batch(seed: int, S: int, T: int):
    """The main path's seeded data mix: ~40 % monotonic integer counters,
    ~30 % gauges with 1-2 decimals, ~25 % random walks on a 2^-7 grid in [16, 32)
    (no decimal multiplier finds them: the XOR path), and the rest
    constants and NaN-bearing gauges; 10 s cadence with whole-second
    jitter and rare long gaps so that every delta-of-delta bucket is
    hit."""
    rng = np.random.default_rng(seed)
    start = 1_700_000_000 * SEC
    step = 10 + rng.integers(-3, 4, (S, T))
    gap = rng.random((S, T))
    step = np.where(gap < 0.002, 200, step)      # 9-bit bucket
    step = np.where(gap < 0.001, 1500, step)     # 12-bit bucket
    step = np.where(gap < 0.0003, 4000, step)    # 32-bit default bucket
    ts = start + np.cumsum(step, axis=1, dtype=np.int64) * SEC
    fam = rng.random(S)
    vals = np.empty((S, T))
    c = fam < 0.40
    vals[c] = np.cumsum(rng.integers(0, 1000, (int(c.sum()), T)), axis=1)
    g = (fam >= 0.40) & (fam < 0.70)
    n = int(g.sum())
    x = 50 + rng.normal(0, 10, (n, T))
    vals[g] = np.where(rng.random(n)[:, None] < 0.5, np.round(x, 1), np.round(x, 2))
    w = (fam >= 0.70) & (fam < 0.95)
    n = int(w.sum())
    m = np.mod(512 + np.cumsum(rng.choice([-2, -1, 1, 2], (n, T)), axis=1), 1024)
    vals[w] = 16 + (2 * m + 1) / 128  # odd multiples of 2^-7: 7 decimals
    k = (fam >= 0.95) & (fam < 0.97)
    vals[k] = rng.integers(-5, 5, int(k.sum()))[:, None]
    nn = fam >= 0.97
    n = int(nn.sum())
    v = np.round(20 + rng.normal(0, 2, (n, T)), 1)
    v[rng.random((n, T)) < 0.01] = np.nan
    vals[nn] = v
    vals = vals + 0.0  # no -0.0: the int path canonicalizes it
    return ts, vals, np.full(S, start, np.int64)


def pinned_batch():
    """The arithmetic batch whose packed bytes the JAX suite pins."""
    S0 = 1_600_000_000 * SEC
    S, T = 8, 64
    i = np.arange(S, dtype=np.int64)[:, None]
    j = np.arange(T, dtype=np.int64)[None, :]
    ts = S0 + np.cumsum(((i * 37 + j * 11) % 29 + 1) * SEC, axis=1)
    vals = ((i * 131 + j * 17) % 4001 - 2000) / 8.0
    vals[2] = np.float64((j[0] * 7) % 1000)
    vals[5, 10:] = vals[5, 9]
    return ts, vals, np.full(S, S0, np.int64)


T0_AGG = 1_700_000_040 * SEC  # a minute boundary
MINUTE = 60 * SEC


def same_bits(a, b) -> bool:
    """Bit-equal, every NaN taken as one NaN."""
    import torch

    if a.dtype.is_floating_point:
        a = torch.where(torch.isnan(a), float("nan"), a).double()
        b = torch.where(torch.isnan(b), float("nan"), b).double()
        return torch.equal(a.view(torch.int64), b.view(torch.int64))
    return torch.equal(a, b)


def max_abs_err(a, b) -> float:
    """Largest |a - b| over the entries where both are finite."""
    import torch

    a, b = a.double(), b.double()
    ok = torch.isfinite(a) & torch.isfinite(b)
    return float((a[ok] - b[ok]).abs().max()) if bool(ok.any()) else 0.0


def max_ulp(a, b) -> int:
    """Largest distance in units in the last place between two f64
    tensors of finite values of one sign (0 when bit-equal)."""
    import torch

    ok = torch.isfinite(a) & torch.isfinite(b)
    d = (a[ok].view(torch.int64) - b[ok].view(torch.int64)).abs()
    return int(d.max()) if d.numel() else 0


def profiled(fn):
    """(wall s, device busy s) of ``fn`` run once under torch.profiler:
    the wall clock around it ends in a synchronize; busy time is the sum
    of the device's own kernel and copy times from the trace.  The
    profiler's host-side recording makes the wall time a little longer
    than unprofiled."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            busy_us += getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    assert busy_us > 0, "the profiler saw no device time"
    return wall, busy_us * 1e-6


def segment_kernel_checks(seed: int, dev) -> None:
    """Phase 6: both aggregator kernels against their plain versions."""
    import torch

    from m3_tpu_torch.parallel import segment_ingest as si

    rng = np.random.default_rng(seed + 11)
    C_path, N_path = 1 << 21, 1_000_000
    shapes = {
        # the path: each series once per scrape, so unique slots
        "path": (C_path, np.concatenate([rng.permutation(C_path)[:N_path - 64],
                                         rng.integers(-9, 0, 32),
                                         rng.integers(C_path, C_path + 9, 32)])),
        "collision": (4096, rng.integers(-10, 4096 + 10, 1 << 20)),
    }
    for shape, (C, slots_np) in shapes.items():
        slots = torch.from_numpy(slots_np.astype(np.int32)).to(dev)
        N = slots.shape[0]
        for dtype in (torch.int64, torch.float64):
            if dtype == torch.int64:
                v = rng.integers(-(1 << 62), 1 << 62, N)
            else:
                v = np.round(rng.uniform(0, 1000, N), 3)  # no cancellation
                v[::997] = np.nan
            vals = torch.from_numpy(v).to(dtype).to(dev)
            runs = [si.segment_ingest(slots, vals, C, with_sq=True) for _ in range(2)]
            mm = [si.segment_minmax(slots, vals, C) for _ in range(2)]
            plain = si.segment_ingest_plain(slots, vals, C, with_sq=True)
            pmn, pmx = si.segment_minmax_plain(slots, vals, C)
            for run in runs:
                assert torch.equal(run[1], plain[1]), f"{shape} {dtype} counts"
                for got, want in ((run[0], plain[0]), (run[2], plain[2])):
                    if dtype == torch.int64 or shape == "path":
                        assert same_bits(got, want), f"{shape} {dtype} sums"
                    else:
                        torch.testing.assert_close(got, want, rtol=1e-12, atol=0,
                                                   equal_nan=True)
            for mn, mx in mm:
                assert same_bits(mn, pmn) and same_bits(mx, pmx), f"{shape} {dtype} minmax"
            empty = int((plain[1] == 0).sum())
            assert empty > 0 or shape == "collision"
            assert bool(torch.isnan(pmn).any()) == dtype.is_floating_point
            msg = f"phase6 {shape} {str(dtype)[6:]}: N={N} C={C}, {empty} empty slots"
            if dtype == torch.float64:
                ulp = max(max_ulp(runs[0][0], runs[1][0]), max_ulp(runs[0][2], runs[1][2]))
                msg += f", run-to-run f64 sums differ by at most {ulp} ulp"
            log(msg + ": kernels == plain")
    e = torch.zeros(0, dtype=torch.int32, device=dev)
    s0, c0 = si.segment_ingest(e, torch.zeros(0, dtype=torch.float64, device=dev), 8)
    mn0, mx0 = si.segment_minmax(e, torch.zeros(0, dtype=torch.int64, device=dev), 8)
    assert float(s0.abs().sum()) == 0 and int(c0.sum()) == 0
    assert int(mn0.min()) == np.iinfo(np.int64).max and int(mx0.max()) == np.iinfo(np.int64).min
    log("phase6 empty batch: zeros and identities")


def agg_drive(seed: int, n: int, dev, card: str, tag: str) -> dict:
    """Phase 7: one 1 m window of n counters, n gauges (six 10 s scrapes
    each) and n timers (ten scrapes) through the aggregator on the card,
    plus a scrape into the next window with a few samples too early and
    too far ahead; consume checked against a numpy oracle.  Returns the
    phase's times."""
    import torch

    from m3_tpu_torch.aggregator import engine as te
    from m3_tpu_torch.metrics.aggregation import AggregationID, AggregationType as AT
    from m3_tpu_torch.metrics.policy import StoragePolicy
    from m3_tpu_torch.metrics.types import MetricType as MT

    rng = np.random.default_rng(seed)
    policy = StoragePolicy.parse("1m:2d")
    opts = te.AggregatorOptions(capacity=1 << 20, num_windows=2,
                                timer_sample_capacity=1 << 24, layout="f64",
                                storage_policies=(policy,))
    agg = te.Aggregator(num_shards=1, opts=opts, device=dev)
    ml = agg.shards[0].lists[policy]
    kinds = {
        MT.COUNTER: (6, AggregationID.compress([AT.SUM, AT.MIN, AT.MAX]), b"cnt"),
        MT.GAUGE: (6, AggregationID.compress([AT.LAST, AT.SUM, AT.MIN, AT.MAX]), b"gau"),
        MT.TIMER: (10, AggregationID.DEFAULT, b"tim"),
    }
    data = {}
    for mt, (k, aid, prefix) in kinds.items():
        step = MINUTE // k
        times = (T0_AGG + np.arange(k, dtype=np.int64)[:, None] * step
                 + rng.integers(0, step, (k, n)))
        if mt is MT.COUNTER:
            vals = rng.integers(0, 1000, (k, n)).astype(np.float64)
        elif mt is MT.GAUGE:
            vals = np.round(rng.normal(50, 20, (k, n)), 3) + 0.0
            vals[rng.random((k, n)) < 0.001] = np.nan
        else:
            vals = np.round(rng.gamma(2.0, 40.0, (k, n)), 3)
        perms = [rng.permutation(n) for _ in range(k + 1)]
        nxt_t = T0_AGG + MINUTE + rng.integers(0, MINUTE, n)
        data[mt] = (times, vals, perms, nxt_t, [prefix + b".%07d" % i for i in range(n)])

    t = {"n_series": n}
    emitted = {}
    # first scrape of each type: the entry point, which creates the series
    slot_of = {}
    for mt, (times, vals, perms, _, ids) in data.items():
        p = perms[0]
        ids_p = [ids[i] for i in p]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agg.add_untimed_batch(mt, ids_p, vals[0, p], times[0, p], kinds[mt][1])
        torch.cuda.synchronize()
        t[f"{mt.name.lower()}_entry_samples_per_s"] = n / (time.perf_counter() - t0)
        slot_of[mt] = ml.maps[mt].resolve(ids, kinds[mt][1], mt)
    assert ml.consumed_until == T0_AGG
    # the rest: the hot loop, with the slots the entry point resolved
    n_bad = 100
    for mt, (times, vals, perms, nxt_t, _) in data.items():
        sl = slot_of[mt]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for j in range(1, vals.shape[0]):
            p = perms[j]
            ml.add_batch_slots(mt, sl[p], vals[j, p], times[j, p])
        torch.cuda.synchronize()
        t[f"{mt.name.lower()}_hot_samples_per_s"] = (vals.shape[0] - 1) * n / (
            time.perf_counter() - t0)
        p = perms[-1]
        bad = rng.integers(0, n, 2 * n_bad)
        bad_t = np.concatenate([np.full(n_bad, T0_AGG - MINUTE),
                                np.full(n_bad, T0_AGG + 2 * MINUTE + 7 * SEC)])
        ml.add_batch_slots(mt, np.concatenate([sl[p], sl[bad]]),
                           np.concatenate([vals[0, p], vals[0, bad]]),
                           np.concatenate([nxt_t[p], bad_t]))
    assert agg.counters()["drops"] == 3 * 2 * n_bad, agg.counters()

    # consume at the window's end: device lanes and host _emit timed apart
    split = {"lanes": 0.0, "emit": 0.0}
    counts = {}

    def timed(key, fn, keep=None):
        def run(*a):
            t1 = time.perf_counter()
            out = fn(*a)
            if keep is not None:
                counts[keep] = out[1].cpu().numpy()
            torch.cuda.synchronize()
            split[key] += time.perf_counter() - t1
            return out
        return run

    for mt in kinds:
        arena = ml._arena(mt)
        arena.consume = timed("lanes", arena.consume, keep=mt)
    ml._emit = timed("emit", ml._emit)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flushed = agg.consume(T0_AGG + MINUTE)
    torch.cuda.synchronize()
    t["consume_s"] = time.perf_counter() - t0
    t["consume_device_lanes_s"] = split["lanes"]
    t["consume_host_emit_s"] = split["emit"]
    assert ml.consumed_until == T0_AGG + MINUTE

    # the numpy oracle, in scrape order
    q = opts.quantiles
    for fm in flushed:
        assert fm.timestamp_nanos == T0_AGG + MINUTE
        times, vals, perms, _, _ = data[fm.metric_type]
        k = vals.shape[0]
        inv = np.full(opts.capacity, -1, np.int64)
        inv[slot_of[fm.metric_type]] = np.arange(n)
        assert (counts[fm.metric_type][slot_of[fm.metric_type]] == k).all()
        if fm.metric_type is MT.COUNTER:
            iv = vals.astype(np.int64)
            want = {AT.SUM: iv.sum(axis=0), AT.MIN: iv.min(axis=0), AT.MAX: iv.max(axis=0)}
        elif fm.metric_type is MT.GAUGE:
            nan = np.isnan(vals)
            acc = np.zeros(n)
            for j in range(k):
                acc = acc + np.where(nan[j], 0.0, vals[j])
            allnan = nan.all(axis=0)
            lo = np.where(nan, np.inf, vals).min(axis=0)
            hi = np.where(nan, -np.inf, vals).max(axis=0)
            want = {AT.LAST: vals[np.argmax(times, axis=0), np.arange(n)], AT.SUM: acc,
                    AT.MIN: np.where(allnan, np.nan, lo),
                    AT.MAX: np.where(allnan, np.nan, hi)}
        else:
            acc = np.zeros(n)
            acc_sq = np.zeros(n)
            for j in range(k):
                acc = acc + vals[j]
                acc_sq = acc_sq + vals[j] * vals[j]
            srt = np.sort(vals, axis=0)
            rank = lambda qq: int(np.ceil(qq * float(k))) - 1
            cnt = float(k)
            want = {AT.SUM: acc, AT.SUM_SQ: acc_sq, AT.MEAN: acc / k,
                    AT.COUNT: np.full(n, cnt), AT.MIN: srt[0], AT.MAX: srt[-1],
                    AT.MEDIAN: srt[rank(0.5)],
                    AT.STDEV: np.sqrt(np.maximum(cnt * acc_sq - acc * acc, 0.0)
                                      / (cnt * (cnt - 1)))}
            for qq, at in zip(q, (AT.P50, AT.P95, AT.P99)):
                want[at] = srt[rank(qq)]
        for at, w in want.items():
            sel = fm.types == int(at)
            idx = inv[fm.slots[sel]]
            assert sel.sum() == n and (idx >= 0).all(), (fm.metric_type, at)
            got = np.empty(n)
            got[idx] = fm.values[sel]
            w = np.asarray(w, np.float64)
            if at is AT.STDEV:
                np.testing.assert_allclose(got, w, rtol=1e-12, err_msg=at.name)
            else:
                assert np.array_equal(got, w, equal_nan=True), (fm.metric_type, at)
        emitted[fm.metric_type.name] = int(fm.values.size)
    assert set(emitted) == {"COUNTER", "GAUGE", "TIMER"}, emitted

    # where a hot-loop scrape's time goes: one more scrape of each type
    # into the open next window, under the profiler
    for mt, (times, vals, perms, _, _) in data.items():
        p = perms[1]
        args = (slot_of[mt][p], vals[1, p], times[1, p] + MINUTE)
        route = []
        for _ in range(3):  # the host clock is noisy: median of three
            t0 = time.perf_counter()
            ml._route_windows(args[2])
            route.append(time.perf_counter() - t0)
        route_s = sorted(route)[1]
        wall_s, busy_s = profiled(lambda: ml.add_batch_slots(mt, *args))
        name = mt.name.lower()
        t[f"{name}_scrape_wall_ms"] = wall_s * 1e3
        t[f"{name}_scrape_host_routing_ms"] = route_s * 1e3
        t[f"{name}_scrape_device_busy_ms"] = busy_s * 1e3
        t[f"{name}_scrape_device_idle_share"] = 1 - busy_s / wall_s
    c = agg.counters()
    log(f"{tag} n={n}: consume exact against the numpy oracle "
        f"(stdev rtol 1e-12) for {emitted} rows; drops {c['drops']} "
        f"(too early {n_bad} + too far {n_bad} per type)")
    for key, v in t.items():
        if key != "n_series":
            log(f"{tag} [{card}] {key}: {v:,.3f}")
    return t


def drain_encode_decode(seed: int, S: int, dev, card: str) -> None:
    """Phase 8: S gauges at 10 s raw under 1m:2d for 120 windows (2 h)
    through the hot loop, each window consumed; the drained LAST values
    become (S, 120) matrices (as tools/hops.py builds them) and go
    through encode and decode on the card."""
    import torch

    from m3_tpu_torch.aggregator import engine as te
    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.metrics.policy import StoragePolicy
    from m3_tpu_torch.metrics.types import MetricType as MT

    rng = np.random.default_rng(seed)
    T, k = 120, 6
    policy = StoragePolicy.parse("1m:2d")
    opts = te.AggregatorOptions(capacity=1 << 17, num_windows=2,
                                timer_sample_capacity=1 << 10, layout="f64",
                                storage_policies=(policy,))
    agg = te.Aggregator(num_shards=1, opts=opts, device=dev)
    ml = agg.shards[0].lists[policy]
    ids = [b"hop.%06d" % i for i in range(S)]
    walk = np.round(50 + np.cumsum(rng.normal(0, 0.5, (T * k, S)), axis=0), 2) + 0.0
    step = 10 * SEC
    tmat = np.zeros((S, T), np.int64)
    vmat = np.zeros((S, T))
    agg.add_untimed_batch(MT.GAUGE, ids, walk[0], np.full(S, T0_AGG))
    slots = ml.maps[MT.GAUGE].resolve(ids, te.AggregationID.DEFAULT, MT.GAUGE)
    inv = np.full(opts.capacity, -1, np.int64)
    inv[slots] = np.arange(S)
    ingest_s = consume_s = 0.0
    for w in range(T):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for j in range(0 if w else 1, k):
            i = w * k + j
            p = rng.permutation(S)
            ml.add_batch_slots(MT.GAUGE, slots[p], walk[i, p],
                               T0_AGG + i * step + rng.integers(0, step, S))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        flushed = agg.consume(T0_AGG + (w + 1) * MINUTE)
        t2 = time.perf_counter()
        ingest_s += t1 - t0
        consume_s += t2 - t1
        (fm,) = flushed
        rows = inv[fm.slots]
        assert fm.values.size == S and (rows >= 0).all()
        tmat[rows, w] = fm.timestamp_nanos
        vmat[rows, w] = fm.values
    assert np.array_equal(vmat, walk[k - 1::k].T), "drained LAST != last scrape"
    n_samples = T * k * S - S
    log(f"phase8 [{card}] {S} gauges x {T} windows: hot loop "
        f"{n_samples / ingest_s:,.0f} samples/s, consume {consume_s / T * 1e3:.1f} ms/window")
    W = max(16, T * 40 // 64 + 8)
    t0 = time.perf_counter()
    streams, fb = mt.encode_batch(tmat, vmat, np.full(S, T0_AGG, np.int64),
                                  out_words=W, device=dev)
    dts, dvals, cnts, dfb = mt.decode_batch(streams, T, device=dev)
    torch.cuda.synchronize()
    share = float(fb.mean())
    keep = ~fb
    assert share < 0.05, share
    assert not dfb[keep].any() and (cnts[keep] == T).all()
    assert np.array_equal(dts[keep], tmat[keep])
    assert np.array_equal(dvals[keep].view(np.uint64), vmat[keep].view(np.uint64))
    log(f"phase8 drain -> encode -> decode: fallback share {share:.5f} "
        f"({int(fb.sum())} of {S}), {int(keep.sum())} series round-trip exactly "
        f"({time.perf_counter() - t0:.1f} s)")


def segment_kernel_times(seen: dict, launches: dict, card: str) -> list:
    """Phase 9: each aggregator kernel on the inputs the main path handed
    it, held against its plain version once more and timed beside its
    bound, its plain version and the library calls, each from a CUDA
    graph of 20 calls (``graph_ms``: the wrappers' host launch overhead
    is larger than these kernels)."""
    import torch

    from m3_tpu_torch.parallel import segment_ingest as si

    (slots, vals, C), kw = seen["segment_ingest"]
    assert kw == {"with_sq": True}
    N = slots.shape[0]
    got = si.segment_ingest(slots, vals, C, with_sq=True)
    want = si.segment_ingest_plain(slots, vals, C, with_sq=True)
    err = max(max_abs_err(a, b) for a, b in zip(got, want))
    assert all(same_bits(a, b) for a, b in zip(got, want)), "segment_ingest != plain"
    idx = torch.where((slots < 0) | (slots >= C), C, slots).long()
    ones = torch.ones(N, dtype=torch.int32, device=vals.device)
    vv = vals * vals
    bufs = [torch.zeros(C + 1, dtype=d, device=vals.device)
            for d in (vals.dtype, torch.int32, vals.dtype)]
    forms = {}
    for form, with_sq, n_out in (("moments", True, 3), ("sum_count", False, 2)):
        srcs = (vals, ones, vv)[:n_out]

        def lib():
            # accumulates into buffers made once: no zeroing inside the timing
            for b, x in zip(bufs, srcs):
                b.index_add_(0, idx, x)
        out_bytes = C * (vals.element_size() * (n_out - 1) + 4)
        forms[form] = {
            "ms": graph_ms(lambda: si.segment_ingest(slots, vals, C, with_sq=with_sq)),
            # back-to-back eager calls: bound by the host's launch rate
            "eager_ms": cuda_ms(lambda: si.segment_ingest(slots, vals, C, with_sq=with_sq)),
            "plain_ms": graph_ms(lambda: si.segment_ingest_plain(slots, vals, C, with_sq)),
            "library_ms": graph_ms(lib),
            "library": f"index_add_ x{n_out}",
            "bound_ms": (N * (4 + vals.element_size()) + out_bytes) / HBM_BYTES_PER_S * 1e3,
        }
    (mslots, mvals, mC), _ = seen["segment_minmax"]
    Nm = mslots.shape[0]
    mn, mx = si.segment_minmax(mslots, mvals, mC)
    pmn, pmx = si.segment_minmax_plain(mslots, mvals, mC)
    assert same_bits(mn, pmn) and same_bits(mx, pmx), "segment_minmax != plain"
    mm_err = max(max_abs_err(mn, pmn), max_abs_err(mx, pmx))
    midx = torch.where((mslots < 0) | (mslots >= mC), mC, mslots).long()
    lo = torch.full((mC + 1,), float("inf"), dtype=mvals.dtype, device=mvals.device)
    hi = torch.full((mC + 1,), float("-inf"), dtype=mvals.dtype, device=mvals.device)
    mm = {
        "ms": graph_ms(lambda: si.segment_minmax(mslots, mvals, mC)),
        "eager_ms": cuda_ms(lambda: si.segment_minmax(mslots, mvals, mC)),
        "plain_ms": graph_ms(lambda: si.segment_minmax_plain(mslots, mvals, mC)),
        "library_ms": graph_ms(lambda: (lo.scatter_reduce_(0, midx, mvals, "amin"),
                                       hi.scatter_reduce_(0, midx, mvals, "amax"))),
        "bound_ms": (Nm * (4 + mvals.element_size()) + 2 * mC * mvals.element_size())
        / HBM_BYTES_PER_S * 1e3,
    }
    for form, r in forms.items():
        log(f"phase9 [{card}] segment_ingest ({form}) N={N} C={C}: {r['ms']:.4f} ms "
            f"(eager back-to-back {r['eager_ms']:.4f} ms), "
            f"bound {r['bound_ms']:.4f} ms (bytes), plain {r['plain_ms']:.3f} ms, "
            f"{r['library']} {r['library_ms']:.3f} ms")
    log(f"phase9 [{card}] segment_minmax N={Nm} C={mC}: {mm['ms']:.4f} ms "
        f"(eager back-to-back {mm['eager_ms']:.4f} ms), bound "
        f"{mm['bound_ms']:.4f} ms (bytes), plain {mm['plain_ms']:.3f} ms, "
        f"scatter_reduce_ x2 {mm['library_ms']:.3f} ms")
    mom = forms["moments"]
    return [
        {"name": "segment_ingest", "route": "cuda",
         "source": "m3_tpu_torch/csrc/segment_ingest.cu",
         "replaces": "m3_tpu/parallel/pallas_ingest.py:65",
         "launches": launches[si.INGEST_KERNEL], "max_abs_err": err,
         "ms": mom["ms"], "plain_ms": mom["plain_ms"], "bound_ms": mom["bound_ms"],
         "bound_by": "bytes", "library_ms": mom["library_ms"], "eager_ms": mom["eager_ms"],
         "library": "index_add_ x3 (several calls)", "form": "moments",
         "forms": {"sum_count": forms["sum_count"]}},
        {"name": "segment_minmax", "route": "cuda",
         "source": "m3_tpu_torch/csrc/segment_minmax.cu",
         "replaces": "m3_tpu/parallel/pallas_ingest.py:191",
         "launches": launches[si.MINMAX_KERNEL], "max_abs_err": mm_err,
         "ms": mm["ms"], "plain_ms": mm["plain_ms"], "bound_ms": mm["bound_ms"],
         "bound_by": "bytes", "library_ms": mm["library_ms"], "eager_ms": mm["eager_ms"],
         "library": "scatter_reduce_ x2 (several calls)"},
    ]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--series", type=int, default=100_000)
    ap.add_argument("--points", type=int, default=720)
    ap.add_argument("--agg-series", type=int, default=1_000_000)
    ap.add_argument("--drain-series", type=int, default=100_000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from m3_tpu_torch.core.xtime import Unit
    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.parallel import _cuda, decode_gather, encode_place
    from m3_tpu_torch.parallel import segment_ingest as si

    dev = torch.device("cuda")
    S, T = args.series, args.points
    W = max(16, T * 40 // 64 + 8)
    card = card_line()
    t_start = time.perf_counter()

    # ---- phase 1: card, builds ----
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    names = [encode_place.KERNEL, decode_gather.KERNEL, *si.KERNELS]
    _cuda.build(names)
    log(f"phase1 build: {time.perf_counter() - t0:.1f} s ({len(names)} nvcc in parallel)")
    for name in names:
        log(f"--- ptxas {name} ---\n{_cuda.ptxas_report(name).strip()}")

    # ---- phase 2: kernels vs plain versions at the main path's shapes ----
    rng = np.random.default_rng(args.seed + 1)
    F = 2 * 4 * T                                  # [hi | lo] fragments
    f = torch.arange(F, device=dev)
    s_col = torch.arange(S, device=dev)[:, None]
    keys = ((f // 64) * 6 + (s_col % 5) - 2).to(torch.int32)   # some < 0, some >= W
    onebit = torch.ones((), dtype=torch.int64, device=dev) << (f % 64)
    frags = torch.where(torch.rand((S, F), device=dev) < 0.5, onebit, 0)
    a = encode_place.place_words(frags, keys, W)
    b = encode_place.place_words_plain(frags, keys, W)
    place_err = int((a ^ b).abs().max())
    assert torch.equal(a, b), "place_words kernel != plain"
    assert bool(((keys < 0) | (keys >= W)).any()) and bool((a < 0).any())
    log(f"phase2 place_words: bit-equal on ({S}, {F}) -> ({S}, {W})")

    Wd = W + mt._PAD_WORDS
    Fx = 2 * T
    wnp = rng.integers(0, 1 << 64, (Wd, S), dtype=np.uint64)
    wnp[W:] = 0                                   # the decoder's zero pad
    words_t = torch.from_numpy(wnp.view(np.int64)).to(dev)
    offs = torch.from_numpy(rng.integers(-100, Wd * 64 + 200, (Fx, S))
                            .astype(np.int32)).to(dev)
    widths = torch.from_numpy(rng.integers(-2, 67, (Fx, S)).astype(np.int32)).to(dev)
    widths[0] = 0
    widths[1] = 64
    a = decode_gather.extract_fields64_t(words_t, offs, widths)
    b = decode_gather.extract_fields64_t_plain(words_t, offs, widths)
    ext_err = int((a ^ b).abs().max())
    assert torch.equal(a, b), "extract_fields64_t kernel != plain"
    assert bool((a < 0).any()) and bool((offs >= W * 64).any())
    log(f"phase2 extract_fields64_t: bit-equal on ({Wd}, {S}) words, ({Fx}, {S}) lanes")

    del frags, keys, onebit, words_t, offs, widths, a, b
    torch.cuda.empty_cache()

    # ---- phase 3: the main path ----
    ts, vals, starts = make_batch(args.seed, S, T)
    log(f"phase3 data: S={S} T={T} out_words={W} seed={args.seed}")
    t0 = time.perf_counter()
    streams, fb = mt.encode_batch(ts, vals, starts, out_words=W, device=dev)
    mt.decode_batch(streams, T, device=dev)
    log(f"phase3 warm-up pass: {time.perf_counter() - t0:.1f} s")

    # the timed pass keeps each kernel's inputs, to time the kernels on
    # exactly what the main path hands them (phase 5)
    seen: dict = {}

    def keep_args(name, fn):
        def rec(*a):
            seen[name] = a
            return fn(*a)
        return rec

    orig = (mt.place_words, mt.extract_fields64_t)
    mt.place_words = keep_args("place_words", orig[0])
    mt.extract_fields64_t = keep_args("extract_fields64_t", orig[1])
    torch.cuda.reset_peak_memory_stats()
    encode_place.launches = 0
    decode_gather.launches = 0
    enc_t: dict = {}
    dec_t: dict = {}
    t0 = time.perf_counter()
    streams, fb = mt.encode_batch(ts, vals, starts, out_words=W, device=dev,
                                  timings=enc_t)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dts, dvals, counts, dfb = mt.decode_batch(streams, T, device=dev,
                                              timings=dec_t)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    launches = {"place_words": encode_place.launches,
                "extract_fields64_t": decode_gather.launches}
    peak = torch.cuda.max_memory_allocated()
    mt.place_words, mt.extract_fields64_t = orig
    log(f"phase3 launches on the main path: {launches}")
    assert all(v > 0 for v in launches.values()), launches

    share = float(fb.mean())
    log(f"phase3 fallback share: {share:.5f} ({int(fb.sum())} of {S})")
    assert share < 0.05, share
    keep = ~fb
    assert not dfb[keep].any(), "decode flagged encoded series"
    assert (counts[keep] == T).all()
    assert np.array_equal(dts[keep], ts[keep]), "timestamps did not round-trip"
    assert np.array_equal(dvals[keep].view(np.uint64), vals[keep].view(np.uint64)), \
        "value bits did not round-trip"
    log(f"phase3 round trip exact for {int(keep.sum())} series")

    n = 64
    cpu_streams, cpu_fb = mt.encode_batch(ts[:n], vals[:n], starts[:n],
                                          out_words=W, device="cpu")
    assert cpu_streams == streams[:n] and np.array_equal(cpu_fb, fb[:n])
    log(f"phase3 card bytes == CPU bytes on {n} series")

    # ---- phase 4: golden bytes ----
    with open(ROOT / "tests" / "data" / "m3tsz_sample_series.json") as fh:
        gold = [base64.b64decode(s) for s in json.load(fh)]
    gts, gvals, gcounts, gfb = mt.decode_batch(gold, 1500, device=dev)
    assert not gfb.any()
    Tg = int(gcounts.max())
    gwords, _ = mt.pack_streams(gold)
    # the Go encoder's default unit is SECOND; its points are in ms
    re, rfb = mt.encode_batch(gts[:, :Tg], gvals[:, :Tg], gwords[:, 0].view(np.int64),
                              counts=gcounts, unit=Unit.MILLISECOND,
                              default_unit=Unit.SECOND, out_words=W, device=dev)
    assert not rfb.any() and re == gold, "Go golden streams not reproduced"
    log(f"phase4 Go golden streams: {len(gold)} of {len(gold)} byte-identical")
    pts, pvals, pstarts = pinned_batch()
    pstreams, pfb = mt.encode_batch(pts, pvals, pstarts, out_words=200, device=dev)
    assert not pfb.any()
    pw, pn = mt.pack_streams(pstreams)
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(pw).tobytes())
    h.update(np.ascontiguousarray(pn).tobytes())
    assert h.hexdigest() == PINNED_ENCODE_DIGEST, h.hexdigest()
    log("phase4 pinned encode digest: match")

    # ---- phase 5: times (kernel launches here do not count) ----
    frags, keys, w_out = seen["place_words"]
    a = encode_place.place_words(frags, keys, w_out)
    b = encode_place.place_words_plain(frags, keys, w_out)
    place_err = max(place_err, int((a ^ b).abs().max()))
    assert torch.equal(a, b), "place_words kernel != plain on main-path inputs"
    place_ms = cuda_ms(lambda: encode_place.place_words(frags, keys, w_out))
    place_plain_ms = cuda_ms(lambda: encode_place.place_words_plain(frags, keys, w_out))
    kl = keys.clamp(0, w_out - 1).long()
    fm = torch.where((keys >= 0) & (keys < w_out), frags, 0)
    out0 = torch.zeros_like(a)
    place_lib_ms = cuda_ms(lambda: out0.scatter_add_(1, kl, fm))
    place_bytes = frags.numel() * (8 + 4) + a.numel() * 8
    del a, b, kl, fm, out0, frags, keys
    words_t, offs, widths = seen["extract_fields64_t"]
    a = decode_gather.extract_fields64_t(words_t, offs, widths)
    b = decode_gather.extract_fields64_t_plain(words_t, offs, widths)
    ext_err = max(ext_err, int((a ^ b).abs().max()))
    assert torch.equal(a, b), "extract_fields64_t kernel != plain on main-path inputs"
    ext_ms = cuda_ms(lambda: decode_gather.extract_fields64_t(words_t, offs, widths))
    ext_plain_ms = cuda_ms(
        lambda: decode_gather.extract_fields64_t_plain(words_t, offs, widths))
    # each input read once, the output written once
    ext_bytes = offs.numel() * (4 + 4 + 8) + words_t.numel() * 8
    log("phase5 both kernels bit-equal to their plain versions on the "
        "main path's own inputs")
    dp = S * T
    log(f"phase5 [{card}] encode {dp / enc_s:,.0f} dp/s ({enc_s:.2f} s: "
        f"phase1 {enc_t['phase1']:.2f} s, phase2 {enc_t['phase2']:.3f} s, "
        f"host {enc_t['host']:.2f} s)")
    log(f"phase5 [{card}] decode {dp / dec_s:,.0f} dp/s ({dec_s:.2f} s: "
        f"host pack+unpack {dec_t['host']:.2f} s, phase1 {dec_t['phase1']:.2f} s, "
        f"phase2 {dec_t['phase2']:.3f} s)")
    log(f"phase5 [{card}] peak device memory {peak / 2**30:.2f} GiB")
    kernels = [
        {"name": "place_words", "route": "cuda",
         "source": "m3_tpu_torch/csrc/place_words.cu",
         "replaces": "m3_tpu/parallel/pallas_encode.py:52",
         "launches": launches["place_words"], "max_abs_err": place_err,
         "ms": place_ms, "plain_ms": place_plain_ms,
         "bound_ms": place_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": place_lib_ms},
        {"name": "extract_fields64_t", "route": "cuda",
         "source": "m3_tpu_torch/csrc/extract_fields.cu",
         "replaces": "m3_tpu/parallel/pallas_decode.py:95",
         "launches": launches["extract_fields64_t"], "max_abs_err": ext_err,
         "ms": ext_ms, "plain_ms": ext_plain_ms,
         "bound_ms": ext_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": None},
    ]
    for k in kernels:
        log(f"phase5 [{card}] {k['name']}: {k['ms']:.3f} ms, bound "
            f"{k['bound_ms']:.3f} ms ({k['bound_by']}), plain {k['plain_ms']:.3f} ms, "
            f"library {k['library_ms']}, launches/pass {k['launches']}")
    del seen, a, b, words_t, offs, widths, streams, dts, dvals
    torch.cuda.empty_cache()

    # ---- phases 6-9: the aggregator ----
    t0 = time.perf_counter()
    segment_kernel_checks(args.seed, dev)
    log(f"phase6 done in {time.perf_counter() - t0:.1f} s")
    agg_drive(args.seed + 7, 20_000, dev, card, "warm-up")  # lazy inits, same path
    seen_agg: dict = {}
    orig_agg = (si.segment_ingest, si.segment_minmax)

    def keep_first(name, fn):
        def rec(*a, **kw):
            # the path's shape: a gauge scrape into the (W*C,) arena
            if (name not in seen_agg and a[1].dtype == torch.float64
                    and a[0].shape[0] == args.agg_series):
                seen_agg[name] = (a, kw)
            return fn(*a, **kw)
        return rec

    si.segment_ingest = keep_first("segment_ingest", orig_agg[0])
    si.segment_minmax = keep_first("segment_minmax", orig_agg[1])
    torch.cuda.reset_peak_memory_stats()
    for k in si.KERNELS:
        si.launches[k] = 0
    agg_t = agg_drive(args.seed, args.agg_series, dev, card, "phase7")
    agg_launches = dict(si.launches)
    agg_peak = torch.cuda.max_memory_allocated()
    si.segment_ingest, si.segment_minmax = orig_agg
    log(f"phase7 launches on the aggregator path: {agg_launches}")
    assert all(agg_launches[k] > 0 for k in si.KERNELS), agg_launches
    log(f"phase7 [{card}] peak device memory {agg_peak / 2**30:.2f} GiB")
    drain_encode_decode(args.seed + 3, args.drain_series, dev, card)
    kernels += segment_kernel_times(seen_agg, agg_launches, card)
    log(f"phase9 [{card}] aggregator: " + json.dumps(agg_t))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
