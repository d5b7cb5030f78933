"""Codec hot-loop cost breakdown: where the port's decode and encode time
goes — the counterpart of ``m3_tpu/tools/decode_profile.py``.

The method is the reference's: decompose a codec pass into structural
layers by running PROXY loops that share the real codec's carry and
replay the true per-step work, each layer adding one structural cost,
so that the deltas between consecutive layers attribute the time.  Where
the port's phase 1 is a Python loop of torch ops (one step per
datapoint), its proxies are Python loops of torch ops too, over the
carries of ``m3tsz_torch._decode_step`` and ``_encode_step``.

``--mode decode`` (the default) on the CPU, where the decode's scan is
the loop of ``_decode_step``:

  carry    the loop and the carry round-trip only: the cursor advances
           by the TRUE per-step advances captured from a real decode
           (:func:`capture_cursors`), the gather tail's twelve narrow
           lanes ride along untouched
  reads    + the step's read machinery at the true cursor: the 4-word
           register file gather, the W0 funnel behind its in-register
           reads, the value-control table gather and the two 64-bit
           payload funnels
  full     the production decode (``chains="gather"``, scan-major): phase
           1, then the gather tail, whose own seconds are ``gather_tail``

On a card the scan is one launch of the scan kernel
(``parallel/decode_scan``), so no loop is left to take apart: ``scan``
is that launch alone on the same streams, and ``full`` the production
decode (the scan, then the gather tail with kernel #2); the attribution
keys are ``scan_kernel`` and ``gather_tail_and_rest``.

``--mode encode`` on the CPU, where the encode's scan is the loop of
``_encode_step``: ``carry`` (the loop with live lane outputs),
``classify`` (+ the decimal search, ``classify_value``), ``phase1`` (the
production lane-emission loop), ``prefix_frags`` (+ the exclusive prefix
sums and the fragments) and ``full`` (the production encode); the
attribution keys are ``scan_carry_roundtrip``,
``classify_decimal_search``, ``lane_emission_rest_of_step``,
``prefix_sum_and_fragments`` and ``word_placement``.  On a card the scan
is one launch of the encode scan kernel (``parallel/encode_scan``), so,
as in the decode mode, ``scan`` is that launch alone on the same corpus
and ``full`` the production encode (the scan, then the prefix sums and
kernel #1's placement); the attribution keys are ``scan_kernel`` and
``placement_and_rest``.

Each layer is timed on the device, ending in a synchronize (best of
``reps``), and reports its dispatches per step from ``x/costwatch``'s
census: two counted runs of the layer at ``COUNT_STEPS`` steps give the
per-step count and the fixed one, so the profile says both where the
time goes and how many launches each layer costs.

The reference's output keys are kept where the layer exists in the port.
Dropped, because they name things only the reference has:
``old_r05_single_scan`` and ``vs_old_r05``, ``element_ops_r05``,
``full_1device`` and ``full_all_devices`` (the port profiles one
device), ``old_r07_wide_carry_scan``, ``vs_old_r07``,
``element_ops_r07_wide_carry``, ``full_<place>`` for other placement
tails (the port has one), and ``compile_s`` (nothing compiles).

Both modes also time the native C++ codec (``m3_tpu_torch.native``,
threaded on the host) over the same corpus, as ``native_cpp_dps``,
whenever it is available: the host yardstick beside the card's ``full``.

    python -m m3_tpu_torch.tools.decode_profile [--mode encode] \\
        [-S 10000] [-T 720] [--device cpu] [-o PROFILE.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from m3_tpu_torch import native, resolve_device
from m3_tpu_torch._bits import shl, shr
from m3_tpu_torch.encoding import m3tsz_torch as mt
from m3_tpu_torch.parallel import decode_scan, encode_scan
from m3_tpu_torch.x import costwatch

I32 = mt.I32
I64 = mt.I64
REPS = 4
COUNT_STEPS = (2, 4)  # the two step counts the per-step census takes


def _count_ops(fn, *args, **kwargs) -> int:
    """One home: ``x/costwatch`` owns the per-step dispatch counter."""
    return costwatch.count_step_ops(fn, *args, **kwargs)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time(fn, dev, reps: int = REPS) -> float:
    """Best wall of ``reps`` runs of ``fn``, each ending in a synchronize."""
    best = float("inf")
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def _per_step(layer) -> dict:
    """``layer(steps)`` counted at the two ``COUNT_STEPS``: dispatches per
    step and the fixed dispatches around the loop."""
    (k1, k2) = COUNT_STEPS
    n1, n2 = _count_ops(layer, k1), _count_ops(layer, k2)
    per = (n2 - n1) / (k2 - k1)
    return {"per_step": per, "fixed": n1 - k1 * per}


def encoded(ts, vals, starts, device):
    """The corpus's streams, packed for the decoder (corpus prep, never
    timed): (words (S, W) int64 tensor, nbits (S,) int64 tensor) on
    ``device``."""
    dev = resolve_device(device)
    S, T = ts.shape
    res = mt._encode_batch_device(torch.from_numpy(ts), torch.from_numpy(vals.view(np.int64)),
                                  torch.from_numpy(starts), torch.ones((S, T), dtype=torch.bool),
                                  fit_words=True, device=dev)
    if bool(res["fallback"].any()):
        raise RuntimeError("the profile corpus has fallback series")
    streams = mt.finalize_streams(res["words"].cpu().numpy(), res["total_bits"].cpu().numpy())
    words, nbits = mt.pack_streams(streams)
    return (torch.from_numpy(words.view(np.int64)).to(dev),
            torch.from_numpy(nbits).to(dev))


def _host_timed(fn):
    """``fn()``'s result and its wall seconds, for host work alone (the
    native codec touches no device, so no synchronize is owed)."""
    t0 = time.perf_counter()
    res = fn()
    return res, time.perf_counter() - t0


def _streams_of(words, nbits) -> list[bytes]:
    """The byte streams behind packed ``(words, nbits)`` (``pack_streams``
    keeps every stream whole bytes, so each is its words' first
    ``nbits // 8`` big-endian bytes)."""
    rows = words.cpu().numpy().view(np.uint64).astype(">u8")
    return [rows[i].tobytes()[:n // 8] for i, n in enumerate(nbits.cpu().tolist())]


def _prep(words, nbits):
    """The decoder's padded words, its (S,) bit lengths and initial units,
    as ``_decode_batch_device`` makes them (default unit SECOND)."""
    wpad = torch.nn.functional.pad(words, (0, mt._PAD_WORDS))
    aligned = (wpad[:, 0] % 10**9) == 0
    return wpad, nbits, torch.where(aligned, 1, 0)


def capture_cursors(words, nbits, max_points: int):
    """Run the real phase-1 step, capturing the cursor after every step:
    (max_points, S) int64 (the reference's ``_capture_cursors``).  The
    plain step runs on CPU tensors only: on a card the decode's steps
    are the scan kernel's, and no ``_decode_step`` runs there."""
    if words.device.type != "cpu":
        raise ValueError("capture_cursors replays the plain step: CPU tensors only")
    S = words.shape[0]
    wpad, nb, unit0 = _prep(words, nbits)
    tbl = mt.value_ctrl_table(words.device)
    carry = mt._decode_carry0(S, words.device)
    out = torch.empty((max_points, S), dtype=I64, device=words.device)
    for i in range(max_points):
        carry, _ = mt._decode_step(carry, wpad, nb, unit0, tbl)
        out[i] = carry[0]
    return out


def _rd3(o, r0, r1, r2, r3):
    """A 64-bit funnel read at bit offset ``o`` (< 192) of the 4-word
    register file."""
    k2 = o >> 6
    r = o & 63
    hi = torch.where(k2 == 0, r0, torch.where(k2 == 1, r1, r2))
    lo = torch.where(k2 == 0, r1, torch.where(k2 == 1, r2, r3))
    return shl(hi, r) | torch.where(r > 0, shr(lo, (64 - r) & 63), 0)


def proxy_decode(wpad, advances, tbl, mode: str, steps: int | None = None):
    """Structural proxy over the gather tail's carry: replays the true
    cursor ``advances`` ((P, S)) through the carry (``mode="carry"``) plus
    the real read machinery (``mode="reads"``)."""
    S = wpad.shape[0]
    carry = mt._decode_carry0(S, wpad.device)
    P = advances.shape[0] if steps is None else steps
    for i in range(P):
        cursor, rest = carry[0], carry[1:]
        if mode == "reads":
            w0i = cursor >> 6
            r0, r1, r2, r3 = mt._regfile4(wpad, w0i)
            rf_base = w0i << 6
            off0 = cursor - rf_base
            W0 = shl(r0, off0) | torch.where(off0 > 0, shr(r1, (64 - off0) & 63), 0)
            # ~8 in-register reads (marker, 4 varint bytes, unit byte,
            # opcode) are shifts of W0; the control read uses its top 16
            a = W0
            for k, w in enumerate((11, 8, 8, 8, 8, 8, 4)):
                a = a ^ shr(shl(W0, 3 * k), 64 - w)
            tv = tbl[a & 0xFFFF]  # the value-control table gather
            raw = _rd3(cursor + 35 - rf_base, r0, r1, r2, r3)
            draw = _rd3(cursor + 19 - rf_base, r0, r1, r2, r3)
            a = a ^ raw ^ draw ^ tv.to(I64)
            # fold into a carried lane (keeps the chain live)
            rest = rest[:-2] + (rest[-2] | (a == 1), rest[-1])
        carry = (cursor + advances[i],) + rest
    return carry[0], carry[-2]


def profile(S: int, T: int, device=None, corpus=None, packed=None,
            reps: int = REPS) -> dict:
    """The decode attribution on ``device`` (None = CUDA).  ``corpus`` is
    (ts, values, starts) host arrays (default: the bench corpus of S x T);
    ``packed`` the (words, nbits) of already encoded streams on the
    device.  The series-major layout and the fused tail are timed once
    each beside it."""
    dev = resolve_device(device)
    if packed is None:
        packed = encoded(*(corpus or costwatch.bench_corpus(S, T)), dev)
    words, nbits = packed
    S = words.shape[0]
    max_points = T + 1
    out: dict = {
        "S": S, "T": T, "platform": dev.type,
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "total_datapoints": S * T, "decoder": "two-phase", "chains": "gather",
        "layout": "scan_major (the production decode_batch_device path)", "reps": reps,
    }

    split: dict = {}

    def full(steps=max_points, timings=None):
        return mt._decode_batch_device(words, nbits, steps, device=dev, chains="gather",
                                       scan_major=True, timings=timings)

    full(2)  # the lazy inits
    layers = {"full": _time(lambda: full(timings=split), dev, reps)}
    gather_tail = split["phase2"] / reps  # mean of the timed runs

    t_series_major = _time(lambda: mt._decode_batch_device(
        words, nbits, max_points, device=dev, chains="gather", scan_major=False), dev, 1)
    t_fused = _time(lambda: mt._decode_batch_device(
        words, nbits, max_points, device=dev, chains="fused", scan_major=True), dev, 1)

    wpad, nb, unit0 = _prep(words, nbits)
    tbl = mt.value_ctrl_table(dev)
    ops = {}
    if dev.type == "cuda":  # phase 1 is one launch of the scan kernel
        def scan(steps=max_points):
            return decode_scan.decode_scan(wpad, nb, unit0, tbl, steps)

        layers["scan"] = _time(scan, dev, reps)
        ops["scan"] = _per_step(scan)
        parts = (("scan_kernel", layers["scan"]),
                 ("gather_tail_and_rest", layers["full"] - layers["scan"]))
        ceilings = {"ceiling_if_scan_only": round(S * T / max(layers["scan"], 1e-9))}
    else:
        # true per-step advances, replayed by every proxy
        cursors = capture_cursors(words, nbits, max_points)
        advances = torch.diff(cursors, dim=0, prepend=torch.zeros_like(cursors[:1]))
        for mode in ("carry", "reads"):
            layers[mode] = _time(lambda m=mode: proxy_decode(wpad, advances, tbl, m), dev,
                                 reps)
            ops[mode] = _per_step(lambda k, m=mode: proxy_decode(wpad, advances, tbl, m, k))
        t_carry = layers["carry"]
        parts = (("scan_carry_roundtrip", t_carry),
                 ("bit_read_funnels", layers["reads"] - layers["carry"]),
                 ("parse_arithmetic_and_outputs", layers["full"] - layers["reads"]))
        ceilings = {"ceiling_if_arith_free": round(S * T / max(layers["reads"], 1e-9)),
                    "ceiling_if_only_carry": round(S * T / max(t_carry, 1e-9))}
    ops["full"] = _per_step(lambda k: full(k))

    out["seconds"] = {k: round(v, 4) for k, v in layers.items()}
    out["seconds"]["gather_tail"] = round(gather_tail, 4)
    out["seconds"]["full_series_major"] = round(t_series_major, 4)
    out["seconds"]["full_fused_tail"] = round(t_fused, 4)
    out["attribution_s"] = {k: round(v, 4) for k, v in parts}
    out["attribution_pct"] = {k: round(100 * v / layers["full"], 1) for k, v in parts}
    out["dispatches_per_step"] = {k: v["per_step"] for k, v in ops.items()}
    out["dispatches_fixed"] = {k: v["fixed"] for k, v in ops.items()}
    out["dps"] = {
        "full": round(S * T / layers["full"]),
        **ceilings,
        "full_series_major": round(S * T / t_series_major),
        "full_fused_tail": round(S * T / t_fused),
    }
    # the native C++ yardstick on the same streams
    if native.available():
        streams = _streams_of(words, nbits)
        _, t = _host_timed(lambda: native.decode_batch(streams, max_points))
        out["native_cpp_dps"] = round(S * T / t)
    # the step's structural op count: every lane through every branch (on
    # a card, one slot of the scan kernel)
    step_ops = costwatch.decode_step_ops(wpad, nb, unit0, tbl)
    out["step_ops"] = step_ops
    out["element_ops_per_datapoint"] = step_ops
    out["sustained_element_ops_per_sec"] = round(step_ops * S * max_points / layers["full"])
    return out


def _encode_inputs(corpus, dev):
    ts, vals, starts = corpus
    S, T = ts.shape
    return (torch.from_numpy(ts).to(dev), torch.from_numpy(vals.view(np.int64)).to(dev),
            torch.from_numpy(starts).to(dev), torch.ones((S, T), dtype=torch.bool, device=dev))


def proxy_encode(ts, vb, start, valid, mode: str, steps: int | None = None):
    """A prefix of the production encode over its carry and lane tables:
    ``carry`` (the loop, outputs live), ``classify`` (+ the decimal
    search), ``phase1`` (the production step), ``prefix_frags`` (+ the
    prefix sums and the fragments, all but the placement)."""
    S, T = ts.shape
    T = T if steps is None else steps
    dev = ts.device
    ts_t, vb_t, va_t = (x.t().contiguous() for x in (ts, vb, valid))
    lv = torch.empty((T, 4, S), dtype=I64, device=dev)
    lw = torch.empty((T, 4, S), dtype=I32, device=dev)
    carry = mt._encode_carry0(S, start, 1, 1)
    for i in range(T):
        t, v = ts_t[i], vb_t[i]
        if mode == "carry":
            z = t + v
            zi = torch.zeros(S, dtype=I32, device=dev)
            lv[i] = torch.stack([z, z, z, z])
            lw[i] = torch.stack([zi, zi, zi, zi])
        elif mode == "classify":
            val, mult, isf, prec = mt.classify_value(v, carry[4])
            z = t + val
            zi = mult + torch.where(isf | prec, 1, 0)
            lv[i] = torch.stack([z, z, z, z])
            lw[i] = torch.stack([zi, zi, zi, zi])
        else:
            carry, lanes = mt._encode_step(carry, t, v, va_t[i], unit=1,
                                           default_unit_is_32bit=True)
            lv[i] = torch.stack(lanes[:4])
            lw[i] = torch.stack(lanes[4:])
    if mode != "prefix_frags":
        return lv.sum() + lw.sum(dtype=I64) + carry[0].sum()
    lens = lw.sum(dim=1, dtype=I32)
    off_dp = torch.cumsum(lens, dim=0, dtype=I32) - lens + 64
    pos = off_dp[:, None, :] + (torch.cumsum(lw, dim=1, dtype=I32) - lw)
    F = 4 * T
    hi, lo, gw = mt._lane_frags(lv.reshape(F, S), pos.reshape(F, S), lw.reshape(F, S))
    return hi.sum() + lo.sum() + gw.sum(dtype=I64)


def profile_encode(S: int, T: int, device=None, corpus=None, reps: int = REPS,
                   keep: dict | None = None) -> dict:
    """The encode attribution on ``device`` (None = CUDA) over ``corpus``
    ((ts, values, starts) host arrays; default the bench corpus of
    S x T).  ``keep``, if given, receives the full layer's packed streams
    under ``"packed"`` (for :func:`profile`)."""
    dev = resolve_device(device)
    corpus = corpus or costwatch.bench_corpus(S, T)
    S, T = corpus[0].shape
    out_words = T * 40 // 64 + 8
    args = _encode_inputs(corpus, dev)
    out: dict = {
        "S": S, "T": T, "platform": dev.type,
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "total_datapoints": S * T, "encoder": "two-phase lane emission",
        "place": "kernel #1 (place_words)" if dev.type == "cuda" else "plain place_words",
        "reps": reps,
    }

    def full(steps=T):
        a = args if steps == T else tuple(x[:, :steps] if x.dim() == 2 else x for x in args)
        return mt._encode_batch_device(*a, unit=1, out_words=out_words, device=dev)

    layers: dict = {}
    ops: dict = {}
    ts, vb, start, valid = args
    if dev.type == "cuda":  # phase 1 is one launch of the scan kernel
        cols = [x.t().contiguous() for x in (ts, vb, valid)]
        carry0 = mt._encode_carry0(S, start, 1, 1)

        def scan(steps=T):
            return encode_scan.encode_scan(*(x[:steps] for x in cols), carry0, 1, True)

        scan(2)  # the kernel's build and load
        layers["scan"] = _time(scan, dev, reps)
        ops["scan"] = _per_step(scan)
    else:
        for mode in ("carry", "classify", "phase1", "prefix_frags"):
            proxy_encode(*(x[:, :2] if x.dim() == 2 else x for x in args), mode)  # lazy inits
            layers[mode] = _time(lambda m=mode: proxy_encode(*args, m), dev, reps)
            ops[mode] = _per_step(lambda k, m=mode: proxy_encode(
                *(x[:, :k] if x.dim() == 2 else x for x in args), m))
    res = full()
    if bool(res["fallback"].any()):
        raise RuntimeError("the profile corpus has fallback series")
    layers["full"] = _time(full, dev, reps)
    ops["full"] = _per_step(full)
    if keep is not None:
        streams = mt.finalize_streams(res["words"].cpu().numpy(),
                                      res["total_bits"].cpu().numpy())
        words, nbits = mt.pack_streams(streams)
        keep["packed"] = (torch.from_numpy(words.view(np.int64)).to(dev),
                          torch.from_numpy(nbits).to(dev))
    del res

    if dev.type == "cuda":
        parts = (("scan_kernel", layers["scan"]),
                 ("placement_and_rest", layers["full"] - layers["scan"]))
        ceilings = {"ceiling_if_scan_only": round(S * T / max(layers["scan"], 1e-9))}
    else:
        t_classify = layers["classify"] - layers["carry"]
        parts = (("scan_carry_roundtrip", layers["carry"]),
                 ("classify_decimal_search", t_classify),
                 ("lane_emission_rest_of_step", layers["phase1"] - layers["classify"]),
                 ("prefix_sum_and_fragments", layers["prefix_frags"] - layers["phase1"]),
                 ("word_placement", layers["full"] - layers["prefix_frags"]))
        ceilings = {
            "ceiling_if_placement_free": round(S * T / layers["prefix_frags"]),
            "ceiling_if_scan_only": round(S * T / layers["phase1"]),
            "ceiling_if_classify_free": round(S * T / max(layers["phase1"] - t_classify,
                                                          1e-9)),
        }
    out["seconds"] = {k: round(v, 4) for k, v in layers.items()}
    out["attribution_s"] = {k: round(v, 4) for k, v in parts}
    out["attribution_pct"] = {k: round(100 * v / layers["full"], 1) for k, v in parts}
    out["dispatches_per_step"] = {k: v["per_step"] for k, v in ops.items()}
    out["dispatches_fixed"] = {k: v["fixed"] for k, v in ops.items()}
    out["dps"] = {"full": round(S * T / layers["full"]), **ceilings}
    # the native C++ yardstick on the same corpus
    if native.available():
        (_, fallback), t = _host_timed(lambda: native.encode_batch(*corpus))
        if not fallback.any():
            out["native_cpp_dps"] = round(S * T / t)
    # the step's structural op count (on a card, one step of the scan kernel)
    if dev.type == "cuda":
        step_ops = costwatch.encode_step_ops(ts, vb, start, valid)
    else:
        carry0 = mt._encode_carry0(S, start, 1, 1)
        step_ops = _count_ops(mt._encode_step, carry0, ts[:, 0], vb[:, 0], valid[:, 0], unit=1,
                              default_unit_is_32bit=True)
        out["classify_ops"] = _count_ops(mt.classify_value, vb[:, 0], torch.zeros_like(start))
    out["step_ops"] = step_ops
    out["element_ops_per_datapoint_phase1"] = step_ops
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("decode", "encode"), default="decode")
    ap.add_argument("-S", type=int, default=10_000)
    ap.add_argument("-T", type=int, default=720)
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default)")
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("-o", default=None, help="also write JSON here")
    args = ap.parse_args(argv)
    res = (profile(args.S, args.T, args.device, reps=args.reps) if args.mode == "decode"
           else profile_encode(args.S, args.T, args.device, reps=args.reps))
    line = json.dumps(res, indent=2)
    print(line)
    if args.o:
        with open(args.o, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
