"""Card/CPU bit-exactness bisector for the batched M3TSZ codec: the
counterpart of ``m3_tpu/tools/tpu_bisect.py``, renamed for the card.

The CPU tests cannot catch a divergence that only the card's code shows
(a mis-built 64-bit op, a kernel's indexing, a dtype a CUDA path
promotes differently).  This tool runs the port's codec pipeline stage
by stage on the card and on the CPU over one synthetic corpus and
reports the first diverging stage, array and element.

Stages, in pipeline order (the reference's six):

  1. primitives  — the u64-on-int64 helpers of ``m3_tpu_torch._bits``
                   (logical shifts, clz/ctz, unsigned compare, the funnel),
                   u64 div/mod/mul on int64, the ``f64_emul`` kernels and a
                   wrapping int64 scatter-add, on random operand grids.
  2. encode      — ``encode_batch_device`` words / total_bits / fallback
                   (kernel #1 on the card).
  3. finalize    — host trim + EOS tail (shared host code; sanity only).
  4. decode      — ``decode_batch_device`` ts / payload / meta / err /
                   prec / ann on the finalized streams (kernel #2).
  5. to_values   — the int -> float conversion on the device (f64
                   division by 10^mult, kept as int64 bits), also held
                   against the corpus and the host's ``payload_value_bits``.
  6. f64_output  — an f64 result made on the device (informational: f64
                   is native on the card, so it reads EQUAL there; the
                   reference's accelerator emulated it and did not).

Usage (on a machine with a card):
    python -m m3_tpu_torch.tools.card_bisect [-S 512] [-T 720]

Exit code 0 when stages 1-5 are bit-exact on the card, 1 otherwise, 2
without a card.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from m3_tpu_torch import _bits
from m3_tpu_torch.encoding import f64_emul as fe
from m3_tpu_torch.encoding import m3tsz_torch as mt

START = 1_600_000_000 * 10**9


def _log(*a) -> None:
    print("[card_bisect]", *a, file=sys.stderr, flush=True)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _diff_report(name: str, a: np.ndarray, b: np.ndarray) -> bool:
    """Compare two host arrays bitwise; report and return True on a diff."""
    if a.dtype == np.float64:
        a, b = a.view(np.uint64), b.view(np.uint64)
    if a.shape == b.shape and np.array_equal(a, b):
        _log(f"  {name}: EQUAL")
        return False
    if a.shape != b.shape:
        _log(f"  {name}: DIFF in shape: cpu {a.shape} card {b.shape}")
        return True
    d = np.argwhere(a != b) if a.shape else np.zeros((1, 0), np.int64)
    idx = tuple(int(i) for i in d[0])
    fmt = (lambda v: f"0x{int(v) & (2**64 - 1):016x}") if a.dtype in (
        np.uint64, np.int64) else str
    _log(f"  {name}: DIFF at {idx} ({len(d)} of {a.size} elements): "
         f"cpu={fmt(a[idx])} card={fmt(b[idx])}")
    return True


def _on(dev, fn, *args):
    """``fn`` on ``dev`` over host arrays -> host array(s)."""
    out = fn(*[torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in args])
    if isinstance(out, dict):
        return {k: _host(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return [_host(x) for x in out]
    return _host(out)


def _compare(name, cpu_out, dev_out) -> list[str]:
    if isinstance(cpu_out, dict):
        pairs = [(k, cpu_out[k], dev_out[k]) for k in cpu_out]
    elif isinstance(cpu_out, list):
        pairs = [(str(i), a, b) for i, (a, b) in enumerate(zip(cpu_out, dev_out))]
    else:
        pairs = [("out", cpu_out, dev_out)]
    return [f"{name}.{sub}" for sub, a, b in pairs if _diff_report(f"{name}.{sub}", a, b)]


def make_corpus(S: int, T: int, seed: int = 42):
    """The bench corpus shape: regular 10 s timestamps, 2-decimal gauges,
    with the codec's other regimes mixed in (float-mode series, constant
    series, jittered timestamps) so every decoder branch runs."""
    rng = np.random.default_rng(seed)
    ts = np.tile(START + np.arange(1, T + 1) * 10 * 10**9, (S, 1)).astype(np.int64)
    base = rng.uniform(10, 1000, (S, 1))
    vals = np.round(base + rng.normal(0, base * 0.05, (S, T)), 2)
    vals[1::7] += rng.standard_normal((vals[1::7].shape))  # float (XOR) mode
    vals[2::11, :] = vals[2::11, :1]  # constant series (repeat opcode)
    ts[3::13, 1::2] += 10**9  # jittered timestamps (non-zero dod)
    starts = np.full(S, START, np.int64)
    return ts, vals, starts


def primitive_cases() -> list:
    """(name, fn, host args) of stage 1, on one seeded operand grid."""
    rng = np.random.default_rng(0)
    N = 4096
    a = rng.integers(0, 1 << 63, N, dtype=np.uint64).view(np.int64)
    small = rng.integers(0, 1 << 52, N, dtype=np.int64)
    d = np.asarray([10 ** (i % 7) for i in range(N)], np.int64)
    sh = a % 64
    k = (np.arange(N) % 7).astype(np.int64)
    ii = rng.integers(-(1 << 53), 1 << 53, N, dtype=np.int64)
    hi = rng.integers(-(1 << 62), 1 << 62, N, dtype=np.int64)
    return [
        ("u64_shl", _bits.shl, (a, sh)),
        ("u64_shr", _bits.shr, (a, sh)),
        ("u64_div", lambda x, y: x // y, (small, d)),
        ("u64_mod", lambda x, y: x % y, (small, d)),
        ("u64_mul", lambda x, y: x * y, (small, d)),
        ("i64_clz", _bits.clz, (a,)),
        ("i64_ctz", _bits.ctz, (a | 1 << 40,)),
        ("u64_lt", lambda x, y: _bits.ult(x, y), (a, hi)),
        ("funnel", lambda x, y, r: _bits.funnel(x, y, r), (a, hi, sh)),
        ("uint_to_f64_bits", lambda x: x.to(torch.float64).view(torch.int64), (a,)),
        ("mul_pow10", fe.mul_pow10, (small | (1 << 62), k % 7)),
        ("floor_parts", lambda x: list(fe.floor_parts(x)), (a,)),
        ("int_div_pow10", lambda x, y: (x.to(torch.float64) / 10.0 ** y).view(torch.int64),
         (ii, k)),
        ("u64_scatter_add",
         lambda v, i: torch.zeros(64, dtype=torch.int64, device=v.device).index_add_(0, i, v),
         (a, a % 64)),
    ]


def stage_primitives(cpu, dev) -> list[str]:
    _log("stage 1: primitives")
    bad = []
    for name, f, args in primitive_cases():
        bad += _compare(name, _on(cpu, f, *args), _on(dev, f, *args))
    return bad


def encode_on(dev, ts, vals, starts, out_words: int) -> dict:
    """Stage 2 on one device: the device encode's host outputs."""
    S, T = ts.shape
    return _on(dev, lambda t, v, s, va: mt.encode_batch_device(
        t, v, s, va, unit=1, out_words=out_words, device=t.device),
        ts, vals.view(np.int64), starts, np.ones((S, T), bool))


def decode_on(dev, words, nbits, max_points: int) -> list:
    """Stage 4 on one device: (ts, payload, meta, err, prec, ann)."""
    return _on(dev, lambda w, n: mt.decode_batch_device(w, n, max_points, device=w.device),
               words.view(np.int64), nbits)


def to_bits(payload, meta):
    """Stage 5's conversion on the tensors' device: float payloads are
    their bits; int payloads divide by 10^mult in f64 (native on the
    card), returned as int64 bits."""
    isf = (meta & 8) != 0
    mult = (meta & 7).to(torch.int64)
    pow10 = torch.tensor([10.0 ** k for k in range(8)], dtype=torch.float64,
                         device=payload.device)
    ibits = (payload.to(torch.float64) / pow10[mult]).view(torch.int64)
    return torch.where(isf, payload, ibits)


def stage_codec(cpu, dev, S: int, T: int) -> list[str]:
    ts, vals, starts = make_corpus(S, T)
    ow = T * 40 // 64 + 8

    _log(f"stage 2: encode_batch_device (S={S}, T={T})")
    ec = encode_on(cpu, ts, vals, starts, ow)
    ed = encode_on(dev, ts, vals, starts, ow)
    bad = _compare("encode", ec, ed)
    if bad:
        return bad  # downstream comparisons would just cascade

    _log("stage 3: finalize_streams (host)")
    streams = mt.finalize_streams(ec["words"], ec["total_bits"])
    words, nbits = mt.pack_streams(streams)
    _log(f"  {len(streams)} streams, max {max(map(len, streams))} bytes")

    _log("stage 4: decode_batch_device")
    dc = decode_on(cpu, words, nbits, T + 1)
    dd = decode_on(dev, words, nbits, T + 1)
    for n, a, b in zip(["ts", "payload", "meta", "err", "prec", "ann"], dc, dd):
        if _diff_report(f"decode.{n}", a, b):
            bad.append(f"decode.{n}")
    if bad:
        return bad

    _log("stage 5: int -> float bits (f64 division on the device, int64 output)")
    bc = _on(cpu, to_bits, dc[1], dc[2])
    bd = _on(dev, to_bits, dd[1], dd[2])
    if _diff_report("to_values.bits", bc, bd):
        bad.append("to_values.bits")
    host = mt.payload_value_bits(dc[1].view(np.uint64), dc[2]).view(np.int64)
    if _diff_report("to_values.vs_host", bc, host):
        bad.append("to_values.vs_host")
    # against the corpus, for the series the device codec owns (fallback
    # rows re-encode through the scalar codec by contract)
    ok_rows = ~(ec["fallback"] | dc[3] | dc[4])
    _log(f"  corpus check on {int(ok_rows.sum())}/{S} device-path series")
    if not np.array_equal(bc[ok_rows, :T], vals.view(np.int64)[ok_rows]):
        _diff_report("to_values.vs_corpus", bc[ok_rows, :T], vals.view(np.int64)[ok_rows])
        bad.append("to_values.vs_corpus")
    return bad


def stage_f64_output(cpu, dev) -> bool:
    """Informational, not gated: is an f64 made on the device the CPU's?"""
    _log("stage 6: f64 output materialization (informational)")
    v = np.asarray([802.18, 3.141592653589793, 1.0000000000000002], np.float64)
    return not _diff_report("f64_roundtrip", _on(cpu, lambda x: x + 0.0, v),
                            _on(dev, lambda x: x + 0.0, v))


def bisect(cpu, dev, S: int, T: int) -> dict:
    """Every stage on ``cpu`` against ``dev``: the diverging arrays of
    stages 1-5 (``bad``) and whether stage 6 read equal."""
    bad = stage_primitives(cpu, dev)
    bad += stage_codec(cpu, dev, S, T)
    return {"bad": bad, "f64_output_equal": stage_f64_output(cpu, dev)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-S", type=int, default=512, help="series count")
    p.add_argument("-T", type=int, default=720, help="points per series")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        _log("no CUDA device; nothing to bisect")
        return 2
    cpu, dev = torch.device("cpu"), torch.device("cuda")
    _log(f"comparing {cpu} vs {dev} ({torch.cuda.get_device_name(dev)})")
    res = bisect(cpu, dev, args.S, args.T)
    if res["bad"]:
        _log(f"FAIL: diverging stages: {res['bad']}")
        return 1
    _log("OK: the codec pipeline is bit-exact on the card")
    return 0


if __name__ == "__main__":
    sys.exit(main())
