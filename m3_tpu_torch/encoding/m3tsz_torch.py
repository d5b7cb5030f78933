"""Batched M3TSZ encode/decode in PyTorch: the port of
``m3_tpu.encoding.m3tsz_jax``.

Same two-phase formulation as the JAX reference, with the same names:

* **Encode.**  Phase 1 (``_encode_step``) resolves each datapoint's
  format into four (value, width) lanes; the reference's ``lax.scan``
  over it is ``m3_tpu_torch.parallel.encode_scan`` (one CUDA kernel
  launch on the card, the Python loop of steps on the CPU).  Phase 2
  turns the widths into bit offsets with one exclusive prefix sum, cuts
  each lane into two word fragments (``_lane_frags``) and places them
  (``m3_tpu_torch.parallel.encode_place.place_words``: a CUDA kernel on
  the card, its plain version on the CPU).
* **Decode.**  Phase 1 (``_decode_step``) walks the control bits and
  emits per-datapoint (offset, width, flags) lane tables; the
  reference's ``lax.scan`` over it is ``m3_tpu_torch.parallel
  .decode_scan`` (one CUDA kernel launch on the card, the Python loop of
  steps on the CPU).  Phase 2 (``_phase2``, the reference's ``gather``
  chains tail) extracts every field at once
  (``m3_tpu_torch.parallel.decode_gather``: a CUDA kernel on the card)
  and rebuilds the three value chains.  The reference's other tail,
  ``fused``, rebuilds the chains inside the scan itself from the words
  the step has read (``decode_batch_device(chains=...)``; the scan
  kernel's second form on the card).

All u64 words ride ``int64`` tensors (``m3_tpu_torch._bits``), and the
float64 arithmetic of the format runs as exact integer emulation
(``f64_emul``), so the bytes are the reference's bit for bit.

Series that would hit the reference's float64 rounding (|val| > 2^53),
or whose deltas leave the fixed time unit, are flagged ``fallback``;
callers re-run those through a scalar codec.  There is no silent
fallback anywhere: a CUDA tensor goes to the kernel or raises.

``encode_batch_device`` and ``decode_batch_device`` run as the ``encode``
and ``decode`` stages of ``x.devguard`` (typed errors, counted, no
fallback) under an ``x.membudget`` transient reservation of their lane
tables, and the decoder's resident control table reserves its bytes
once per device (``decode.ctrl_table``), as in the reference.
"""

from __future__ import annotations

import functools
import threading
import time

import numpy as np
import torch

from m3_tpu_torch import resolve_device
from m3_tpu_torch._bits import (
    MIN64, clz, ctz, funnel, num_sig, shl, shr, ult)
from m3_tpu_torch.core.xtime import Unit
from m3_tpu_torch.encoding import f64_emul as fe
from m3_tpu_torch.encoding.bitstream import OStream
from m3_tpu_torch.encoding.scheme import (
    ANNOTATION_MARKER, tail_bytes, write_special_marker)
from m3_tpu_torch.parallel.decode_gather import extract_fields64_t
from m3_tpu_torch.parallel.decode_scan import decode_scan
from m3_tpu_torch.parallel.encode_place import place_words
from m3_tpu_torch.parallel.encode_scan import encode_scan
from m3_tpu_torch.x import devguard, membudget

I64 = torch.int64
I32 = torch.int32

# time-unit byte -> nanos (0 = invalid/None)
_UNIT_NANOS = np.zeros(16, dtype=np.int64)
for _u_ in Unit:
    _UNIT_NANOS[int(_u_)] = _u_.nanos()

_BITS_1E13 = int(np.float64(10.0**13).view(np.int64))
_BITS_2_63 = int(np.float64(2.0**63).view(np.int64))
_PRECISION_LIMIT = 1 << 53  # beyond this the reference's f64 math rounds
_W = torch.where


def _mark(timings, name, device, t0):
    """Record ``name`` = seconds since ``t0`` once the device is idle;
    returns the new origin.  A no-op unless the caller passed a dict."""
    if timings is None:
        return t0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # the timings= dict's host clock: it feeds no tensor
    now = time.perf_counter()  # m3lint: disable=jit-purity
    timings[name] = timings.get(name, 0.0) + (now - t0)
    return now


# ---------------------------------------------------------------------------
# Value classification: exact convertToIntFloat (m3tsz.go:78-118)
# ---------------------------------------------------------------------------


def _mul10_me(mant, exp2):
    """Exact IEEE float64 multiply by 10 in the (mantissa, exp2)
    representation (value = mant * 2^exp2, mant < 2^53)."""
    p = mant * 10  # < 2^57: never overflows
    L = fe.msb_index(p.clamp_min(1))
    sh = L.clamp_min(52) - 52
    # sh > 0 only when p >= 2^53: the result is normal and RNE rounds
    # at its 53-bit ulp; below that it stays exact.
    q = fe._round_shift_right_even(p, sh)
    carried = q >= (1 << 53)
    q = _W(carried, q >> 1, q)
    exp2p = exp2 + sh + carried.to(I64)
    return q, _W(mant == 0, exp2, exp2p)


def classify_value(v_bits, cur_mult):
    """Returns (val int64 scaled, mult, is_float bool, precision_flag bool)
    for float64 bit patterns ``v_bits`` (int64) under the carried
    multiplier ``cur_mult``.

    ``precision_flag`` marks values whose downstream encoding would hit
    float64 rounding in the reference (|val| > 2^53).
    """
    sign = v_bits < 0
    abs_b = v_bits & fe.MASK63
    _, exp, _ = fe.split(abs_b)
    special = exp == 0x7FF  # NaN / Inf never take the int paths

    # Quick path: already integral and v < 2^63 (float compare).
    ipart0, frac_zero0 = fe.floor_parts(abs_b)
    v_lt_maxint = sign | (abs_b < _BITS_2_63)
    quick_ok = (cur_mult == 0) & v_lt_maxint & frac_zero0 & ~special
    # Go's uint64(int64(v)) saturation for out-of-range magnitudes.
    sat = abs_b >= _BITS_2_63
    quick_mag = _W(sat, MIN64, ipart0)
    quick_val = _W(sign & ~sat, -quick_mag, quick_mag)

    # Multiplier loop in the (mantissa, exp2) domain: "within one ulp of
    # an integer" is ``frac <= 1`` / ``frac >= 2^s - 1`` with s = -exp2
    # (the reference's Modf/Nextafter conditions; see m3tsz_jax).
    val_bits0 = fe.mul_pow10(abs_b, cur_mult)
    mant, exp2 = fe._mantissa_and_exp2(val_bits0)
    found = torch.zeros_like(sign)
    res_i = torch.zeros_like(abs_b)
    res_mult = torch.zeros_like(cur_mult)
    for k in range(7):
        # the value's bit pattern (monotone compare key): normals
        # re-pack from (mant, exp2); subnormals ARE their bit pattern.
        vb_cur = _W(mant < fe.IMPLICIT, mant,
                    ((exp2 + 1075) << 52) | (mant & fe.MASK52))
        active = (~quick_ok & ~found & (cur_mult <= k)
                  & ult(vb_cur, _BITS_1E13) & ~special)
        s = (-exp2).clamp(0, 63)
        big_s = -exp2 > 63  # val << 1: ip == 0, frac == mant
        low = (1 << s) - 1
        frac = _W(big_s, mant, mant & low)
        ip = _W(big_s, 0, mant >> s)
        take_i = frac <= 1
        take_i1 = ~take_i & (frac >= low)
        hit = active & (take_i | take_i1)
        res_i = _W(hit, _W(take_i, ip, ip + 1), res_i)
        res_mult = _W(hit, k, res_mult)
        found = found | hit
        advance = active & ~hit
        m10, e10 = _mul10_me(mant, exp2)
        mant = _W(advance, m10, mant)
        exp2 = _W(advance, e10, exp2)

    loop_val = _W(sign, -res_i, res_i)
    is_float = ~quick_ok & ~found
    val = _W(quick_ok, quick_val, _W(found, loop_val, 0))
    mult = _W(found & ~quick_ok, res_mult, 0)
    # Signed compares so INT64_MIN saturations are caught too.
    precision_flag = ~is_float & ((val > _PRECISION_LIMIT)
                                  | (val < -_PRECISION_LIMIT))
    return val, mult, is_float, precision_flag


# ---------------------------------------------------------------------------
# Encoder phase 1: per-datapoint lane emission (see m3tsz_jax's lane-table
# comment: t0 timestamp control+payload, t1 64-bit dod payload, v0 value
# control, v1 value payload; each <= 64 bits, widths beside them)
# ---------------------------------------------------------------------------


def _cat(acc, add_val, add_n, enable=None):
    """Append the low ``add_n`` (< 64) bits of ``add_val`` to the
    (value, nbits) accumulator, MSB-first."""
    val, n = acc
    if enable is not None:
        add_n = _W(enable, add_n, 0)
    val = (val << add_n) | (add_val & ((1 << add_n) - 1))
    return val, n + add_n


# Non-default delta-of-delta buckets: (opcode, num_opcode_bits, num_value_bits).
_DOD_BUCKETS = ((0b10, 2, 7), (0b110, 3, 9), (0b1110, 4, 12))


def _dod_lanes(dod, default_unit_is_32bit: bool):
    """Bucketed delta-of-delta (timestamp_encoder.go:131-221) as lane
    fields: (t0, n_t0, need64, overflow)."""
    is_zero = dod == 0
    fits = [(dod >= -(1 << (nvb - 1))) & (dod <= (1 << (nvb - 1)) - 1)
            for _, _, nvb in _DOD_BUCKETS]
    t1_ = ~is_zero & fits[0]
    t2_ = ~is_zero & ~fits[0] & fits[1]
    t3_ = ~is_zero & ~fits[1] & fits[2]
    take_def = ~is_zero & ~fits[2]
    if default_unit_is_32bit:
        t0_def = (0b1111 << 32) | (dod & 0xFFFFFFFF)
        n_def = 36
        need64 = torch.zeros_like(is_zero)
        overflow = take_def & ((dod < -(2**31)) | (dod > 2**31 - 1))
    else:
        t0_def = 0b1111
        n_def = 4
        need64 = take_def
        overflow = torch.zeros_like(is_zero)
    t0 = _W(is_zero, 0,
         _W(t1_, (0b10 << 7) | (dod & 0x7F),
         _W(t2_, (0b110 << 9) | (dod & 0x1FF),
         _W(t3_, (0b1110 << 12) | (dod & 0xFFF), t0_def))))
    n_t0 = _W(is_zero, 1, _W(t1_, 9, _W(t2_, 12, _W(t3_, 16, n_def))))
    return t0, n_t0, need64, overflow


def _int_sig_mult_ctrl(acc, num_sig_st, max_mult, sig, mult, float_changed):
    """writeIntSigMult (encoder.go:235-250) as control-field composition
    onto ``acc``.  Returns (acc, new num_sig, new max_mult)."""
    sig_changed = num_sig_st != sig
    zero_sig = sig == 0
    acc = _cat(acc, sig_changed.to(I64), 1)
    acc = _cat(acc, (~zero_sig).to(I64), 1, enable=sig_changed)
    acc = _cat(acc, sig - 1, 6, enable=sig_changed & ~zero_sig)
    mult_up = mult > max_mult
    # after WriteIntSig num_sig == sig, so the condition reduces to:
    float_only = ~mult_up & (max_mult == mult) & float_changed
    wr = mult_up | float_only
    acc = _cat(acc, wr.to(I64), 1)
    acc = _cat(acc, mult, 3, enable=wr)
    return acc, sig, _W(mult_up, mult, max_mult)


def _track_new_sig(num_sig_st, cur_hl, num_lower, sig):
    """IntSigBitsTracker.TrackNewSig (int_sig_bits_tracker.go:68-91)."""
    grow = sig > num_sig_st
    new_sig = _W(grow, sig, num_sig_st)
    shrink = ~grow & ((num_sig_st - sig) >= 3)
    chl = _W(shrink & (num_lower == 0), sig,
             _W(shrink & (sig > cur_hl), sig, cur_hl))
    # the lower-sig streak resets only on the within-threshold branch:
    # a grow step leaves it intact (Go keeps t.NumLowerSig)
    nl = _W(shrink, num_lower + 1, _W(grow, num_lower, 0))
    fire = shrink & (nl >= 5)
    new_sig = _W(fire, chl, new_sig)
    nl = _W(fire, 0, nl)
    return new_sig, chl, nl


def _encode_step(carry, t, v_bits, valid, unit: int,
                 default_unit_is_32bit: bool):
    """One datapoint for every series: resolve the format (field values
    and widths) without assembling bits.  Returns the new carry and the
    lanes (t0, t1, v0, v1, n_t0, n_t1, n_v0, n_v1)."""
    (prev_time, prev_delta, tu_none, int_val, max_mult, is_float,
     prev_fbits, prev_xor, num_sig_st, cur_hl, num_lower, is_first,
     fallback) = carry

    # ---- timestamp (timestamp_encoder.go:72-129) ----
    # a first datapoint whose unit differs from the stream's initial
    # unit writes the time-unit marker + unit byte (one 19-bit
    # constant) and then the full 64-bit nanosecond dod on t1.
    emit_tu = is_first & tu_none
    time_delta = t - prev_time
    dod_ns = time_delta - prev_delta
    unit_nanos = Unit(unit).nanos()
    dod_units = dod_ns // unit_nanos  # deltas divisible (checked below)
    div_ok = (dod_ns % unit_nanos) == 0
    t0_b, n_t0_b, need64, dod_overflow = _dod_lanes(dod_units,
                                                    default_unit_is_32bit)
    tu_const = (0x100 << 10) | (0b10 << 8) | (unit & 0xFF)
    t0 = _W(emit_tu, tu_const, t0_b)
    n_t0 = _W(emit_tu, 19, n_t0_b)
    t1 = _W(emit_tu, dod_ns, dod_units)
    n_t1 = _W(emit_tu | need64, 64, 0)
    new_prev_delta = _W(emit_tu, 0, time_delta)

    # ---- value ----
    val, mult, v_is_float, prec = classify_value(v_bits, max_mult)

    # first value (encoder.go:112-146): float '1' + raw 64 bits; int
    # '0' + sig/mult cascade + sign, magnitude on v1.
    neg_diff = val >= 0  # inverted: diff = 0 - val
    mag = val.abs()
    sig_f = num_sig(mag)

    # next value (encoder.go:148-231)
    val_diff = int_val - val
    go_float = v_is_float
    was_int = ~is_float

    # writeFloatVal: int->float '001'+float64; repeat '01'; else '1' +
    # Gorilla XOR: zero '0', contained '10'+window, uncontained
    # '11'+lead6+meaningful6+window.
    repeat_f = is_float & (v_bits == prev_fbits)
    cur_xor = prev_fbits ^ v_bits
    xor_zero = cur_xor == 0
    pl = clz(prev_xor)
    pt = _W(prev_xor == 0, 0, ctz(prev_xor))
    cl = clz(_W(xor_zero, 1, cur_xor))
    ct = num_sig(cur_xor & -cur_xor) - 1
    contained = ~xor_zero & (cl >= pl) & (ct >= pt)
    meaningful = 64 - cl - ct
    v0_unc = (0b111 << 12) | (cl << 6) | (meaningful - 1)
    v0_f = _W(was_int, 0b001, _W(repeat_f, 0b01,
           _W(xor_zero, 0b10, _W(contained, 0b110, v0_unc))))
    n_v0_f = _W(was_int, 3, _W(repeat_f | xor_zero, 2,
                               _W(contained, 3, 15)))
    v1_f = _W(was_int, v_bits,
              _W(contained, shr(cur_xor, pt), shr(cur_xor, ct)))
    n_v1_f = _W(was_int, 64, _W(repeat_f | xor_zero, 0,
                                _W(contained, 64 - pl - pt, meaningful)))
    nxor = _W(xor_zero, 0, cur_xor)
    st_float = dict(
        int_val=int_val,
        is_float=torch.ones_like(is_float),
        max_mult_i=_W(was_int, mult, max_mult),
        prev_fbits=v_bits,
        prev_xor=_W(was_int, v_bits, _W(repeat_f, prev_xor, nxor)),
        num_sig=num_sig_st, cur_hl=cur_hl, num_lower=num_lower,
    )

    # writeIntVal: repeat '01'; update '000'+cascade+sign+diff;
    # no-update '1'+sign+diff
    repeat_i = (val_diff == 0) & ~is_float & (mult == max_mult)
    neg = val_diff < 0
    diff_mag = val_diff.abs()
    sig_n = num_sig(diff_mag)
    new_sig, t_chl, t_nl = _track_new_sig(num_sig_st, cur_hl, num_lower, sig_n)
    float_changed = is_float  # is_float state true: mode changes to int
    need_update = (mult > max_mult) | (num_sig_st != new_sig) | float_changed

    # the shared writeIntSigMult cascade: both opcode prefixes are zero
    # ('0' first-value mode bit / '000' update escape), so only the
    # prefix width and the cascade inputs select per path.
    acc_sh = (torch.zeros_like(v_bits), _W(is_first, 1, 3))
    acc_sh, ns_sh, mm_sh = _int_sig_mult_ctrl(
        acc_sh, num_sig_st, max_mult, _W(is_first, sig_f, new_sig), mult,
        ~is_first & float_changed)
    acc_sh = _cat(acc_sh, _W(is_first, neg_diff, neg).to(I64), 1)

    v0_first = _W(v_is_float, 1, acc_sh[0])
    n_v0_first = _W(v_is_float, 1, acc_sh[1])
    v1_first = _W(v_is_float, v_bits, mag)
    n_v1_first = _W(v_is_float, 64, ns_sh)
    st_first = dict(
        int_val=_W(v_is_float, int_val, val),
        is_float=v_is_float,
        max_mult_i=_W(v_is_float, mult, mm_sh),
        prev_fbits=_W(v_is_float, v_bits, prev_fbits),
        prev_xor=_W(v_is_float, v_bits, prev_xor),
        num_sig=_W(v_is_float, num_sig_st, ns_sh),
        cur_hl=cur_hl, num_lower=num_lower,
    )

    v0_i = _W(repeat_i, 0b01, _W(need_update, acc_sh[0], 0b10 | neg.to(I64)))
    n_v0_i = _W(repeat_i | ~need_update, 2, acc_sh[1])
    n_v1_i = _W(repeat_i, 0, _W(need_update, ns_sh, num_sig_st))
    st_int = dict(
        int_val=_W(repeat_i, int_val, val),
        is_float=repeat_i & is_float,
        max_mult_i=_W(repeat_i | ~need_update, max_mult, mm_sh),
        prev_fbits=prev_fbits, prev_xor=prev_xor,
        num_sig=_W(repeat_i | ~need_update, num_sig_st, ns_sh),
        cur_hl=_W(repeat_i, cur_hl, t_chl),
        num_lower=_W(repeat_i, num_lower, t_nl),
    )

    def pick(first, flt, itg):
        return _W(is_first, first, _W(go_float, flt, itg))

    v0 = pick(v0_first, v0_f, v0_i)
    n_v0 = pick(n_v0_first, n_v0_f, n_v0_i)
    v1 = pick(v1_first, v1_f, diff_mag)
    n_v1 = pick(n_v1_first, n_v1_f, n_v1_i)
    st = {k: pick(st_first[k], st_float[k], st_int[k]) for k in st_first}

    # inactive (padding) steps emit nothing (all widths 0) and keep state
    def keep(new, old):
        return _W(valid, new, old)

    n_t0, n_t1, n_v0, n_v1 = (_W(valid, n, 0) for n in (n_t0, n_t1, n_v0, n_v1))
    fallback = (fallback | (valid & prec) | (valid & ~div_ok & ~emit_tu)
                | (valid & dod_overflow & ~emit_tu))
    new_carry = (
        keep(t, prev_time),
        keep(new_prev_delta, prev_delta),
        keep(tu_none & ~emit_tu, tu_none),
        keep(st["int_val"], int_val),
        keep(st["max_mult_i"], max_mult),
        keep(st["is_float"], is_float),
        keep(st["prev_fbits"], prev_fbits),
        keep(st["prev_xor"], prev_xor),
        keep(st["num_sig"], num_sig_st),
        keep(st["cur_hl"], cur_hl),
        keep(st["num_lower"], num_lower),
        is_first & ~valid,
        fallback,
    )
    return new_carry, (t0, t1, v0, v1, n_t0, n_t1, n_v0, n_v1)


def _encode_carry0(S: int, start, unit: int, default_unit: int):
    """Phase-1 initial carry.  The stream's initial unit is
    ``default_unit`` when the start is aligned to it, else None
    (``initialTimeUnit``, timestamp_encoder.go:248-259); the first
    datapoint writes a time-unit marker when that differs from ``unit``."""
    dev = start.device
    tu_none = (start % Unit(default_unit).nanos() != 0) | (default_unit != unit)
    z64 = torch.zeros(S, dtype=I64, device=dev)
    zb = torch.zeros(S, dtype=torch.bool, device=dev)
    return (start.clone(), z64, tu_none, z64, z64, zb, z64, z64, z64, z64,
            z64, torch.ones(S, dtype=torch.bool, device=dev), zb)


def _lane_frags(valq, pos, n):
    """One (value, bit offset, width) lane class -> its two word
    fragments: the MSB-aligned 64-bit image of the right-aligned field
    splits across stream words ``pos >> 6`` and ``pos >> 6 + 1``.
    Returns (hi, lo, gw)."""
    vm = _W(n > 0, valq << ((64 - n) & 63), 0)
    sh = pos & 63
    hi = shr(vm, sh)
    lo = _W(sh > 0, vm << ((64 - sh) & 63), 0)
    return hi, lo, pos >> 6


def encode_batch_device(timestamps, value_bits, start, valid, unit: int = 1,
                        out_words: int = 0, prefix_bits=None,
                        default_unit: int | None = None, device=None,
                        timings: dict | None = None, fit_words: bool = False):
    """Encode (S, T) series on one device, as the ``encode`` stage of
    the device guard under a transient reservation of the pass's lane
    tables (``membudget.encode_lane_bytes``; an admission reject raises
    typed before the guard, as in the reference).  The arguments and
    result are :func:`_encode_batch_device`'s."""
    S, T = np.shape(timestamps)
    W = out_words if out_words else (T * 16) // 64 + 4
    with membudget.transient("encode.lanes",
                             membudget.encode_lane_bytes(S, T, W)):
        return devguard.run_guarded("encode", lambda: _encode_batch_device(
            timestamps, value_bits, start, valid, unit=unit,
            out_words=out_words, prefix_bits=prefix_bits,
            default_unit=default_unit, device=device, timings=timings,
            fit_words=fit_words))


def _encode_batch_device(timestamps, value_bits, start, valid, unit: int = 1,
                         out_words: int = 0, prefix_bits=None,
                         default_unit: int | None = None, device=None,
                         timings: dict | None = None, fit_words: bool = False):
    """Encode (S, T) series on one device (the unguarded pass).

    Args:
      timestamps: (S, T) int64 UnixNanos, padded entries arbitrary.
      value_bits: (S, T) int64 float64 bit patterns.
      start: (S,) int64 encoder start times.
      valid: (S, T) bool mask of real datapoints (prefix True).
      unit: time unit (wire byte value).
      out_words: output width in 64-bit words per series
        (0 -> T * 16 bits / 64 + 4).
      prefix_bits: optional (S,) int32 — bits reserved after the start
        word for a host-composed prefix (see ``encode_batch``).
      default_unit: the encoder's default unit, which decides the
        stream's initial unit from the start's alignment (Go's
        ``DefaultTimeUnit``); None means ``unit``, the JAX contract.
      device: None = CUDA (raises without one); "cpu" on request.
      timings: optional dict; gains host-clock seconds per phase.
      fit_words: size the output to the longest stream instead of
        ``out_words`` (one device-to-host read after phase 1), so that
        no series falls back for its length.

    Returns dict with packed words (S, W) int64 (u64 bits, starting with
    the 64-bit start time), total_bits (S,) int64, fallback (S,) bool.
    """
    dev = resolve_device(device)
    t0 = time.perf_counter()  # m3lint: disable=jit-purity — timings= origin; feeds no tensor
    ts = torch.as_tensor(timestamps, dtype=I64).to(dev)
    vb = torch.as_tensor(value_bits, dtype=I64).to(dev)
    start = torch.as_tensor(start, dtype=I64).to(dev)
    valid = torch.as_tensor(valid, dtype=torch.bool).to(dev)
    S, T = ts.shape
    W = out_words if out_words else (T * 16) // 64 + 4
    u = Unit(unit)
    default_32 = u in (Unit.SECOND, Unit.MILLISECOND)

    # ---- phase 1: the per-series scan (one kernel launch on the card,
    # the loop of _encode_step on the CPU) into stream-order (T, 4, S)
    # tables whose (4T, S) reshape is free ----
    ts_t, vb_t, valid_t = (x.t().contiguous() for x in (ts, vb, valid))
    carry = _encode_carry0(S, start, unit,
                           unit if default_unit is None else int(default_unit))
    lv, lw, carry = encode_scan(ts_t, vb_t, valid_t, carry, unit, default_32)
    t0 = _mark(timings, "phase1", dev, t0)

    # ---- phase 2: one exclusive prefix sum over the per-datapoint bit
    # counts gives every lane's absolute offset (i32, as the reference)
    lens = lw.sum(dim=1, dtype=I32)  # (T, S)
    base = 64 if prefix_bits is None else (
        64 + torch.as_tensor(prefix_bits, dtype=I32).to(dev)[None, :])
    off_dp = torch.cumsum(lens, dim=0, dtype=I32) - lens + base
    total_bits = (off_dp[-1] + lens[-1]).to(I64)
    if fit_words:
        # fit_words's documented one read after phase 1 (the node's paths
        # pass out_words and never take it)
        W = int(total_bits.max()) // 64 + 1 if S else 1  # m3lint: disable=retrace-risk
    pos = off_dp[:, None, :] + (torch.cumsum(lw, dim=1, dtype=I32) - lw)
    F = 4 * T
    hi, lo, gw = _lane_frags(lv.reshape(F, S), pos.reshape(F, S),
                             lw.reshape(F, S))
    del lv, pos
    # fragments series-major: [hi | lo] at keys [gw | gw + 1]
    frags = torch.cat([hi.t(), lo.t()], dim=1)
    del hi, lo
    gw_t = gw.t()
    keys = torch.cat([gw_t, gw_t + 1], dim=1)
    del gw, gw_t
    words = place_words(frags, keys, W)
    words[:, 0] = start  # offsets start at bit 64: word 0 got nothing
    fallback = carry[12] | (total_bits > W * 64)
    _mark(timings, "phase2", dev, t0)
    return {"words": words, "total_bits": total_bits, "fallback": fallback}


def finalize_streams(words: np.ndarray, total_bits: np.ndarray) -> list[bytes]:
    """Host finalization: trim to byte length and append the EOS tail."""
    out = []
    raw_all = np.ascontiguousarray(np.asarray(words, dtype=np.uint64)
                                   .astype(">u8"))
    for i in range(raw_all.shape[0]):
        nbits = int(total_bits[i])
        raw = raw_all[i].tobytes()
        nbytes = (nbits + 7) // 8
        head = raw[:nbytes]
        pos = nbits - (nbytes - 1) * 8  # bits used in last byte, 1..8
        out.append(head[:-1] + tail_bytes(head[-1], pos))
    return out


def pack_streams(streams: list[bytes], pad_words: int = 0):
    """Pack finalized byte streams into the decoder's input layout:
    (S, pad_words) big-endian uint64 word arrays + per-stream bit lengths.

    ``pad_words`` of 0 sizes the array to the longest stream plus two
    slack words (the decoder pads further with ``_PAD_WORDS`` zeros).
    """
    S = len(streams)
    if pad_words == 0:
        pad_words = max((len(s) for s in streams), default=0) // 8 + 2
    words = np.zeros((S, pad_words), np.uint64)
    nbits = np.zeros(S, np.int64)
    for i, s in enumerate(streams):
        nbits[i] = len(s) * 8
        padded = s + b"\x00" * (-len(s) % 8)
        w = np.frombuffer(padded, dtype=">u8").astype(np.uint64)
        words[i, : len(w)] = w
    return words, nbits


def _put_varint(x: int) -> bytes:
    """Go binary.PutVarint: zigzag + LEB128 (``m3tsz._put_varint``)."""
    ux = (x << 1) ^ (x >> 63) if x < 0 else x << 1
    out = bytearray()
    while ux >= 0x80:
        out.append((ux & 0x7F) | 0x80)
        ux >>= 7
    out.append(ux)
    return bytes(out)


def _annotation_prefix(ann: bytes):
    """The first-datapoint annotation wire prefix (marker + varint +
    bytes) as (uint64 big-endian words, bit length)."""
    os_ = OStream()
    write_special_marker(os_, ANNOTATION_MARKER)
    os_.write_bytes(_put_varint(len(ann) - 1))
    os_.write_bytes(ann)
    raw, _ = os_.raw_bytes()
    padded = raw + b"\x00" * (-len(raw) % 8)
    return np.frombuffer(padded, dtype=">u8").astype(np.uint64), os_.bit_length


def encode_batch(timestamps, values, start, counts=None, unit: Unit = Unit.SECOND,
                 out_words: int = 0, annotations=None,
                 default_unit: Unit | None = None, device=None,
                 timings: dict | None = None, fit_words: bool = False):
    """Host-facing batched encode.

    Returns (streams: list[bytes], fallback: np.ndarray[bool]); fallback
    series contain b"" and must be encoded with a scalar codec.  An
    empty series encodes to b"".

    ``annotations`` (optional list[bytes|None], len S) attaches an
    annotation to each series' FIRST datapoint: the device output shifts
    by the prefix width and the host splices marker+varint+bytes in.
    ``default_unit`` is the encoder's default time unit and
    ``fit_words`` sizes the output to the longest stream (see
    ``encode_batch_device``).
    """
    timestamps = np.asarray(timestamps, dtype=np.int64)
    values = np.ascontiguousarray(values, dtype=np.float64)
    S, T = timestamps.shape
    if counts is None:
        counts = np.full(S, T, dtype=np.int64)
    counts = np.asarray(counts)
    valid = np.arange(T, dtype=np.int64)[None, :] < counts[:, None]

    prefix_bits = None
    prefix_words: dict[int, np.ndarray] = {}
    if annotations is not None:
        pb = np.zeros(S, np.int32)
        for i, ann in enumerate(annotations):
            if ann:
                prefix_words[i], pb[i] = _annotation_prefix(ann)
        prefix_bits = torch.from_numpy(pb) if prefix_words else None

    res = encode_batch_device(
        torch.from_numpy(timestamps), torch.from_numpy(values.view(np.int64)),
        torch.as_tensor(np.asarray(start, dtype=np.int64)),
        torch.from_numpy(valid), unit=int(unit), out_words=out_words,
        prefix_bits=prefix_bits,
        default_unit=None if default_unit is None else int(default_unit),
        device=device, timings=timings, fit_words=fit_words)
    t0 = time.perf_counter()
    # encode_batch is the codec's host API (streams are bytes): its reads
    # of the device result are the host boundary
    fallback = res["fallback"].cpu().numpy()  # m3lint: disable=transfer-hygiene
    words_out = res["words"].cpu().numpy().view(np.uint64)  # m3lint: disable=transfer-hygiene
    total_bits = res["total_bits"].cpu().numpy()  # m3lint: disable=transfer-hygiene
    # Splice each prefix in after the start word (bit 64 is a word
    # boundary, so this is a plain OR into untouched zero bits).
    for i, pw in prefix_words.items():
        words_out[i, 1:1 + len(pw)] |= pw
    streams = finalize_streams(words_out, total_bits)
    streams = [b"" if (fallback[i] or counts[i] == 0) else streams[i]
               for i in range(S)]
    if timings is not None:
        timings["host"] = timings.get("host", 0.0) + time.perf_counter() - t0
    return streams, fallback


# ---------------------------------------------------------------------------
# Batched decode
# ---------------------------------------------------------------------------

_PAD_WORDS = 16          # zero padding after the longest stream (words)


def _peek(words, cursor, n: int):
    """Read ``n`` (<= 64) bits at per-series bit position ``cursor`` from
    the (S, W+1) word array (at least one zero pad word)."""
    W = words.shape[1] - 1
    w = (cursor >> 6).clamp(0, W - 1)
    off = cursor & 63
    w0 = torch.gather(words, 1, w[:, None])[:, 0]
    w1 = torch.gather(words, 1, (w + 1)[:, None])[:, 0]
    window = shl(w0, off) | _W(off > 0, shr(w1, 64 - off), 0)
    return shr(window, 64 - n)


def _regfile4(words, w0i):
    """The 4 consecutive u64 stream words starting at per-lane word index
    ``w0i`` of the padded (S, W) array: every read of one phase-1 step
    lies in them (see m3tsz_jax's register-file comment)."""
    idx = w0i[:, None] + torch.arange(4, dtype=I64, device=words.device)
    R = torch.gather(words, 1, idx)
    return R[:, 0], R[:, 1], R[:, 2], R[:, 3]


# -- Value-control lookup table (m3tsz_jax's layout, rows u32-packed) --------
#
#   bits  0-4   ctrl: control bits consumed before the payload/diff field
#   bits  5-11  sig7: new significand width 0..64, 127 = keep carried
#   bits 12-14  mult3: new decimal multiplier (valid when bit 15 clear)
#   bit   15    mult_keep          bit 16  sign of the int diff
#   bit   17    got_float_full     bit 18  xor_nz      bit 19  contained
#   bit   20    uncont             bit 21  diff_active
#   bit   22    nfloat_set         bit 23  nfloat_keep
#   bit   24    mult_err           bit 25  xor_zero

_VC_KEEP_SIG = 127


def _build_value_ctrl_table() -> np.ndarray:
    """The (2^18,) u32 value-control table.  Index = first << 17 |
    is_float << 16 | next-16-bits (MSB-first).  Mirrors the reference
    decoder's branch structure (readIntSigMult / XOR paths)."""
    idx = np.arange(1 << 18, dtype=np.int64)
    X = idx & 0xFFFF
    isf = ((idx >> 16) & 1) == 1
    first = ((idx >> 17) & 1) == 1

    def bit(k):  # k-th stream bit of the window, 0 = first read
        return (X >> (15 - k)) & 1

    def cascade(k0: int):
        """The sig/mult update cascade starting at control offset k0:
        sb1 [sb2 sig6] mb1 [mult3] sign."""
        sb1 = bit(k0)
        sb2 = bit(k0 + 1)
        sig6 = np.zeros_like(X)
        for j in range(6):
            sig6 = (sig6 << 1) | bit(k0 + 2 + j)
        sig = np.where(sb1 == 0, _VC_KEEP_SIG,
                       np.where(sb2 == 0, 0, sig6 + 1))
        k_m = np.where(sb1 == 0, k0 + 1, np.where(sb2 == 0, k0 + 2, k0 + 8))
        mb1 = bit(k_m)
        m3 = (bit(k_m + 1) << 2) | (bit(k_m + 2) << 1) | bit(k_m + 3)
        mult = np.where(mb1 == 1, m3, 0)
        mult_keep = mb1 == 0
        mult_err = (mb1 == 1) & (m3 > 6)  # MAX_MULT
        k_s = k_m + np.where(mb1 == 1, 4, 1)
        sign = bit(k_s)
        return k_s + 1, sig, mult, mult_keep, mult_err, sign

    c1 = cascade(1)   # first-value int: after the mode bit
    c3 = cascade(3)   # next-value to-int-update: after nb1 nb2 nb3

    p_a2 = first & (bit(0) == 1)                                # full float
    p_a1 = first & (bit(0) == 0)                                # first int
    nfirst = ~first
    p_rep = nfirst & (bit(0) == 0) & (bit(1) == 1)              # repeat
    p_tofl = nfirst & (bit(0) == 0) & (bit(1) == 0) & (bit(2) == 1)
    p_toint = nfirst & (bit(0) == 0) & (bit(1) == 0) & (bit(2) == 0)
    p_xz = nfirst & (bit(0) == 1) & isf & (bit(1) == 0)         # zero XOR
    p_cont = nfirst & (bit(0) == 1) & isf & (bit(1) == 1) & (bit(2) == 0)
    p_unc = nfirst & (bit(0) == 1) & isf & (bit(1) == 1) & (bit(2) == 1)
    p_ino = nfirst & (bit(0) == 1) & ~isf                       # int no-upd

    def sel(pairs, default):
        out = np.full_like(X, default)
        for mask, val in pairs:
            out = np.where(mask, val, out)
        return out

    ctrl = sel([(p_a2, 1), (p_a1, c1[0]), (p_rep, 2), (p_tofl, 3),
                (p_toint, c3[0]), (p_xz, 2), (p_cont, 3), (p_unc, 15),
                (p_ino, 2)], 0)
    sig7 = sel([(p_a1, c1[1]), (p_toint, c3[1])], _VC_KEEP_SIG)
    mult3 = sel([(p_a1, c1[2]), (p_toint, c3[2])], 0)
    mult_keep = ~((p_a1 & ~c1[3]) | (p_toint & ~c3[3]))
    mult_err = (p_a1 & c1[4]) | (p_toint & c3[4])
    sign = sel([(p_a1, c1[5]), (p_toint, c3[5]), (p_ino, bit(1))], 0)

    flags = ((p_a2 | p_tofl).astype(np.int64) << 17
             | (p_cont | p_unc).astype(np.int64) << 18
             | p_cont.astype(np.int64) << 19
             | p_unc.astype(np.int64) << 20
             | (p_a1 | p_toint | p_ino).astype(np.int64) << 21
             | (p_a2 | p_tofl).astype(np.int64) << 22
             | (p_rep | p_xz | p_cont | p_unc | p_ino).astype(np.int64) << 23
             | mult_err.astype(np.int64) << 24
             | p_xz.astype(np.int64) << 25)
    packed = (ctrl | (sig7 << 5) | (mult3 << 12)
              | mult_keep.astype(np.int64) << 15 | (sign << 16) | flags)
    return packed.astype(np.uint32)


_VALUE_CTRL_TBL = _build_value_ctrl_table()


@functools.lru_cache(maxsize=None)
def value_ctrl_table(device: torch.device) -> torch.Tensor:
    """The table as an int32 tensor on ``device``, uploaded once per
    device (every row fits 26 bits, so int32 holds the u32 values).  Its
    bytes are one permanent ``decode.ctrl_table`` reservation per device,
    taken before the upload (the cache serializes nothing, so the lock
    keeps two first decoders from reserving twice)."""
    with _CTRL_TBL_LOCK:
        if device not in _CTRL_TBL_RESERVED:
            _CTRL_TBL_RESERVED[device] = membudget.reserve(
                "decode.ctrl_table",
                membudget.block_bytes(_VALUE_CTRL_TBL.size * 4))
    return torch.from_numpy(_VALUE_CTRL_TBL.astype(np.int32)).to(device)


_CTRL_TBL_LOCK = threading.Lock()
_CTRL_TBL_RESERVED: dict = {}  # device -> its permanent Reservation


def _bit(p, n: int):
    return (p & (1 << n)) != 0


def _decode_step(carry, words, nbits, unit0, ctrl_tbl, unit_tbl=None):
    """Phase 1 of the two-phase decode: ONE datapoint slot for every
    series at once, resolving only control bits, field widths and the
    bit cursor; emits (ts_off, p1, val_off, p2) for ``_phase2``.  Given
    ``unit_tbl`` (the unit nanos on the device), the fused tail instead:
    the carry has the seven chain lanes of ``_decode_carry0(base_time=)``
    and the step emits the point's (ts, payload, meta)."""
    (cursor, done, err, need_start, first_val, saw_ann, unit_idx,
     sig, mult, is_float, pl, pt) = carry[:12]
    active = ~done & ~err

    # ---- the 64-bit start word: only its alignment matters (unit0) ----
    cur = cursor + _W(active & need_start, 64, 0)
    unit_eff = _W(need_start, unit0, unit_idx)
    first = first_val

    # ---- register file: one 4-word gather covers every read ----
    c0 = cur
    w0i = c0 >> 6
    r0, r1, r2, r3 = _regfile4(words, w0i)
    rf_base = w0i << 6
    W0 = funnel(r0, r1, c0 - rf_base)

    def rd0(cur_abs, n: int):
        # static width n (1..64); cur_abs - c0 <= 43 < 64
        chunk = W0 << (cur_abs - c0)
        return shr(chunk, 64 - n)

    def rd3(cur_abs, n: int):
        """Up to 64 bits anywhere in [c0, rf_base + 192): 3-way funnel."""
        o = cur_abs - rf_base
        k = o >> 6
        hi = _W(k == 0, r0, _W(k == 1, r1, r2))
        lo = _W(k == 0, r1, _W(k == 1, r2, r3))
        return shr(funnel(hi, lo, o & 63), 64 - n)

    # ---- marker peek (11 bits) ----
    can_peek = (cur + 11) <= nbits
    peek11 = _W(active & can_peek, rd0(cur, 11), 0)
    is_marker = (peek11 >> 2) == 0x100
    mval = peek11 & 3
    eos = active & is_marker & (mval == 0)
    ann = active & is_marker & (mval == 1)
    is_tu = active & is_marker & (mval == 2)
    done = done | eos
    proceed = active & ~eos & ~ann

    # ---- annotation skip: marker + zigzag varint of (len-1) + bytes ----
    acur = cur + 11
    vb = [rd0(acur + 8 * k, 8) for k in range(4)]
    t1 = (vb[0] & 0x80) != 0
    t2 = t1 & ((vb[1] & 0x80) != 0)
    t3 = t2 & ((vb[2] & 0x80) != 0)
    ux = ((vb[0] & 0x7F)
          | _W(t1, (vb[1] & 0x7F) << 7, 0)
          | _W(t2, (vb[2] & 0x7F) << 14, 0)
          | _W(t3, (vb[3] & 0x7F) << 21, 0))
    abits = 8 + 8 * (t1.to(I64) + t2.to(I64) + t3.to(I64))
    ann_len = (ux >> 1) + 1
    err = err | (ann & t3 & ((vb[3] & 0x80) != 0))  # varint > 4B
    ann_end = acur + abits + ann_len * 8
    err = err | (ann & (ann_end > nbits))
    saw_ann = saw_ann | (ann & ~err)

    # ---- time-unit marker ----
    cur = cur + _W(is_tu, 11, 0)
    ub = _W(is_tu, rd0(cur, 8), 0)
    cur = cur + _W(is_tu, 8, 0)
    ub_valid = (ub >= 1) & (ub <= 8)
    tu_changed = is_tu & ub_valid & (ub != unit_eff)
    new_unit = _W(is_tu, ub, unit_eff)
    unit_ok = (new_unit >= 1) & (new_unit <= 8)
    err = err | (proceed & ~unit_ok & ~tu_changed)

    # ---- delta of delta: widths only (payload bits are phase 2's) ----
    full64 = tu_changed
    rd_dod64 = _W(proceed & full64, 64, 0)
    cur = cur + rd_dod64
    dod64_off = cur - rd_dod64
    bucket_active = proceed & ~full64
    op4 = _W(bucket_active, rd0(cur, 4), 0)
    b3, b2, b1, b0 = (((op4 >> k) & 1) == 0 for k in (3, 2, 1, 0))
    default_is32 = (new_unit == 1) | (new_unit == 2)
    nop = _W(b3, 1, _W(b2, 2, _W(b1, 3, 4)))
    nv = _W(b3, 0, _W(b2, 7, _W(b1, 9, _W(b0, 12,
                                              _W(default_is32, 32, 64)))))
    nop = _W(bucket_active, nop, 0)
    nv = _W(bucket_active, nv, 0)
    cur = cur + nop
    ts_off = _W(full64, dod64_off, cur)
    ts_w = _W(full64, 64, nv)
    cur = cur + nv

    # ---- value section: one 16-bit read + one table gather ----
    v0 = cur
    X = rd3(v0, 16)
    tidx = X | _W(is_float, 1 << 16, 0) | _W(first, 1 << 17, 0)
    tv = ctrl_tbl[tidx].to(I64)

    ctrl = tv & 0x1F
    sig7 = (tv >> 5) & 0x7F
    mult3 = (tv >> 12) & 0x7
    mult_keep = _bit(tv, 15)
    sign_v = _bit(tv, 16)
    got_float_full = proceed & _bit(tv, 17)
    xor_nz = proceed & _bit(tv, 18)
    contained = proceed & _bit(tv, 19)
    uncont = proceed & _bit(tv, 20)
    diff_active = proceed & _bit(tv, 21)
    nfloat_set = _bit(tv, 22)
    nfloat_keep = _bit(tv, 23)
    xor_zero = proceed & _bit(tv, 25)
    err = err | (proceed & _bit(tv, 24))

    eff_sig = _W(sig7 == _VC_KEEP_SIG, sig, sig7)
    meaningful_c = 64 - pl - pt
    u_lead = (X >> 7) & 0x3F
    u_meaningful = ((X >> 1) & 0x3F) + 1
    u_trail = 64 - u_lead - u_meaningful
    # lead + meaningful > 64 never leaves a valid encoder
    err = err | (uncont & (u_trail < 0))

    val_w = _W(got_float_full, 64, _W(contained, meaningful_c,
               _W(uncont, u_meaningful, _W(diff_active, eff_sig, 0))))
    val_off = v0 + ctrl
    cur = v0 + _W(proceed, ctrl + val_w, 0)

    # ---- leading/trailing update for the next step: the full-float
    # word and the contained window both start at val_off ----
    need_payload = got_float_full | contained
    c_w = _W(contained, meaningful_c, 0)
    raw = rd3(val_off, 64)
    cb = shr(raw, 64 - c_w.clamp(0, 64))
    nx = _W(got_float_full, raw, shl(cb, pt))
    pl_c = clz(nx)
    pt_c = _W(nx == 0, 0, ctz(nx))
    n_pl = _W(need_payload, pl_c, _W(uncont, u_lead, _W(xor_zero, 64, pl)))
    n_pt = _W(need_payload, pt_c, _W(uncont, u_trail, _W(xor_zero, 0, pt)))

    # ---- narrow state update (every predicate already has proceed) ----
    n_is_float = _W(proceed, nfloat_set | (nfloat_keep & is_float), is_float)
    n_sig = _W(proceed & (sig7 != _VC_KEEP_SIG), sig7, sig)
    n_mult = _W(proceed & ~mult_keep, mult3, mult)

    err = err | (proceed & (cur > nbits))
    emit = proceed & ~err

    # ---- cursor: datapoints advance to cur; annotation slots jump
    # past the payload (consuming the slot without a datapoint) ----
    ann_ok = ann & ~err
    new_cursor = _W(ann_ok, ann_end, _W(proceed, cur, cursor))
    consumed = proceed | ann_ok
    new_carry = (
        new_cursor, done, err,
        need_start & ~consumed,
        first_val & ~proceed,
        saw_ann,
        _W(proceed, new_unit, _W(ann_ok & need_start, unit0, unit_idx)),
        n_sig, n_mult, n_is_float, n_pl, n_pt,
    )

    if unit_tbl is not None:
        # ---- the fused tail (the reference's ``emit_chains=True``): the
        # three value chains advance with this point, from the words this
        # step already read, and the point's (ts, payload, meta) is
        # emitted; bit for bit the gather tail's outputs ----
        time_, csum, csum_rst, fb, iv, prec, err2 = carry[12:]

        # timestamps: running delta = csum - csum at the last unit reset
        dod = _sign_extend(shr(rd3(ts_off, 64), 64 - ts_w.clamp(0, 64)), ts_w)
        d_k = _W(emit, _W(full64, dod, dod * unit_tbl[new_unit.clamp(0, 15)]), 0)
        csum2 = csum + d_k
        time2 = time_ + _W(emit, csum2 - csum_rst, 0)
        csum_rst2 = _W(emit & full64, csum2, csum_rst)

        # float bits: running XOR, reset at full-float writes (``nx`` is
        # the XOR word of the full-float and contained forms already)
        pay_unc = shr(raw, 64 - u_meaningful.clamp(1, 64))
        xv = _W(xor_nz & emit, _W(uncont, shl(pay_unc, u_trail.clamp(0, 63)), nx), 0)
        fb2 = _W(emit & got_float_full, raw, fb ^ xv)

        # int values; sign: opcodeNegative(1) -> +, opcodePositive(0) -> -
        dv = shr(raw, 64 - eff_sig.clamp(0, 64))
        iv2 = iv + _W(emit & diff_active, _W(sign_v, dv, -dv), 0)
        prec2 = prec | (emit & diff_active
                        & (ult(_PRECISION_LIMIT, dv) | (iv2.abs() > _PRECISION_LIMIT)))

        # the canonical-XOR guard of the gather tail's phase 2
        top_ok = shr(pay_unc, (u_meaningful - 1).clamp(0, 63)) == 1
        bot_ok = (pay_unc & 1) == 1
        err2_2 = err2 | (emit & uncont & ~(top_ok & bot_ok))

        meta_o = ((emit.to(I64) << 4) | (n_is_float.to(I64) << 3)
                  | n_mult.clamp(0, 7)).to(torch.uint8)
        return (new_carry + (time2, csum2, csum_rst2, fb2, iv2, prec2, err2_2),
                (_W(emit, time2, 0), _W(n_is_float, fb2, iv2), meta_o))

    # ---- lane-table emission (the gather tail) ----
    shift = _W(contained, pt, _W(uncont, u_trail.clamp(0, 63), 0))
    out_p1 = (_W(emit, ts_w, 0)
              | ((emit & full64).to(I64) << 7)
              | (new_unit.clamp(0, 15) << 8)
              | (emit.to(I64) << 12))
    out_p2 = (_W(emit, val_w, 0)
              | (shift.clamp(0, 63) << 7)
              | (n_mult.clamp(0, 7) << 13)
              | (n_is_float.to(I64) << 16)
              | ((emit & xor_nz).to(I64) << 17)
              | ((emit & got_float_full).to(I64) << 18)
              | ((emit & diff_active).to(I64) << 19)
              | (sign_v.to(I64) << 20)
              | ((emit & uncont).to(I64) << 21))
    return new_carry, (ts_off, out_p1, val_off, out_p2)


def _decode_carry0(S: int, device, base_time=None):
    """Phase 1's initial carry; ``base_time`` (the start words) adds the
    fused tail's seven chain lanes."""
    z = torch.zeros(S, dtype=I64, device=device)
    f = torch.zeros(S, dtype=torch.bool, device=device)
    t = torch.ones(S, dtype=torch.bool, device=device)
    # cursor, done, err, need_start, first_val, saw_ann, unit, sig,
    # mult, is_float, pl/pt of prev_xor == 0
    base = (z, f, f, t, t, f, z, z, z, f, torch.full_like(z, 64), z)
    if base_time is None:
        return base
    # time, csum, csum at the last reset, float bits, int value, prec, err2
    return base + (base_time.clone(), z, z, z, z, f, f)


def _sign_extend(v, nbits):
    """Sign-extend the low ``nbits`` (1..64) of u64 v to int64."""
    shift = 64 - nbits
    return shl(v, shift) >> shift.clamp_max(63)


def _phase2(wpad, ts_off, p1, val_off, p2):
    """Phase 2 (the reference's ``gather`` chains tail): extract both
    fields of every datapoint in one call, then rebuild the three value
    chains over the point axis:

      timestamps — running delta + running sum, the delta reset at
        time-unit changes;
      float bits — running XOR, reset at full-float writes;
      int values — running sum of the signed significand diffs.

    Returns (ts, payload, meta, prec, err2), outputs scan-major (P, S);
    err2 flags non-canonical uncontained XOR fields.
    """
    P, S = ts_off.shape
    dev = wpad.device
    offs = torch.cat([ts_off, val_off], dim=0)
    widths = torch.cat([p1 & 0x7F, p2 & 0x7F], dim=0)
    fields = extract_fields64_t(wpad.t().contiguous(), offs, widths)
    dod_bits = fields[:P]
    payload = fields[P:]

    p1 = p1.to(I64)
    p2 = p2.to(I64)
    emit = _bit(p1, 12)
    full = _bit(p1, 7)
    isf = _bit(p2, 16)
    diff = _bit(p2, 19)
    unc = _bit(p2, 21)

    # per-point increments, vectorized over (P, S): none of them depends
    # on the chains, so only the three running sums ride the loop
    tsw = p1 & 0x7F
    dod = _W(tsw > 0, _sign_extend(dod_bits, tsw.clamp_min(1)), 0)
    unit_tbl = torch.from_numpy(_UNIT_NANOS).to(dev)
    d_k = _W(full, dod, dod * unit_tbl[(p1 >> 8) & 0xF])
    sh = (p2 >> 7) & 0x3F
    ff = _bit(p2, 18)
    xv = _W(ff, payload, _W(_bit(p2, 17), shl(payload, sh), 0))
    sd = _W(diff, _W(_bit(p2, 20), payload, -payload), 0)
    iv_o = torch.cumsum(sd, dim=0)

    time_o = torch.empty_like(d_k)
    fb_o = torch.empty_like(xv)
    t_ = wpad[:, 0].clone()
    csum = torch.zeros(S, dtype=I64, device=dev)
    csum_rst = torch.zeros(S, dtype=I64, device=dev)
    fb = torch.zeros(S, dtype=I64, device=dev)
    for i in range(P):
        csum2 = csum + d_k[i]
        t_ = t_ + _W(emit[i], csum2 - csum_rst, 0)
        csum_rst = _W(full[i], csum2, csum_rst)
        csum = csum2
        fb = _W(ff[i], xv[i], fb ^ xv[i])  # XOR chain, full resets
        time_o[i] = t_
        fb_o[i] = fb

    # Canonical-XOR guard: a valid encoder sets the top and bottom bits
    # of an uncontained meaningful window.
    vw = p2 & 0x7F
    top_ok = shr(payload, (vw - 1).clamp_min(0)) == 1
    bot_ok = (payload & 1) == 1
    err2 = (unc & ~(top_ok & bot_ok)).any(dim=0)
    prec = (diff & (ult(_PRECISION_LIMIT, payload)
                    | (iv_o.abs() > _PRECISION_LIMIT))).any(dim=0)
    ts = _W(emit, time_o, 0)
    out_payload = _W(isf, fb_o, iv_o)
    meta = ((emit.to(I64) << 4) | (isf.to(I64) << 3)
            | ((p2 >> 13) & 0x7)).to(torch.uint8)
    return ts, out_payload, meta, prec, err2


CHAIN_IMPLS = ("fused", "gather")


def resolved_chains(chains: str = "auto") -> str:
    """A ``chains`` argument -> the tail that runs.  ``"auto"`` is
    ``"gather"`` on every device: that tail's field extraction is the
    port's kernel #2 on the card.  (The reference picks ``fused`` on its
    CPU and reads an ``M3_DECODE_CHAINS`` override; the port has no
    environment seam.)"""
    if chains == "auto":
        return "gather"
    if chains not in CHAIN_IMPLS:
        raise ValueError(f"chains={chains!r}: expected one of {CHAIN_IMPLS + ('auto',)}")
    return chains


def decode_batch_device(words, nbits, max_points: int, default_unit: int = 1,
                        device=None, timings: dict | None = None, chains: str = "auto",
                        scan_major: bool = False):
    """The ``decode`` stage of the device guard, under a transient
    reservation of the pass's lane tables
    (``membudget.decode_lane_bytes``), around
    :func:`_decode_batch_device`, whose arguments and result it has."""
    ch = resolved_chains(chains)
    S, Wn = np.shape(words)
    with membudget.transient("decode.lanes", membudget.decode_lane_bytes(
            S, Wn, max_points, chains=ch)):
        return devguard.run_guarded("decode", lambda: _decode_batch_device(
            words, nbits, max_points, default_unit=default_unit,
            device=device, timings=timings, chains=ch,
            scan_major=scan_major))


def _decode_batch_device(words, nbits, max_points: int, default_unit: int = 1,
                         device=None, timings: dict | None = None,
                         chains: str = "auto", scan_major: bool = False,
                         ctrl_tbl=None):
    """Decode (S, W) stream words (int64 carriers of big-endian u64
    words) in two phases: the bit-boundary scan
    (``parallel/decode_scan``: the scan kernel on the card, the loop of
    ``_decode_step`` on the CPU), then field extraction + chain
    reconstruction, by one of two tails that give the same bits
    (``chains``, see ``resolved_chains``):

    ``gather``  ``_phase2`` after the scan: every field extracted at once
                (kernel #2 on the card), then the chains over the point
                axis.
    ``fused``   the chains ride the scan itself (``_decode_step`` with
                ``unit_tbl``; the scan kernel's fused form on the card),
                from the words each step has read.

    Returns (ts (S, P) int64, payload (S, P) int64 (u64 bits),
    meta (S, P) uint8, err (S,), prec (S,), ann (S,)); the three (S, P)
    outputs are transposed views of scan-major (P, S) tensors (a
    ``.t()`` gives the contiguous layout back), or those (P, S) tensors
    themselves with ``scan_major``.  meta: bit4 = valid, bit3 = is_float,
    bits0-2 = multiplier.  ``ann`` marks streams that carried annotation
    markers (each consumed one point slot).
    """
    chains = resolved_chains(chains)
    dev = resolve_device(device)
    t0 = time.perf_counter()  # m3lint: disable=jit-purity — timings= origin; feeds no tensor
    words = torch.as_tensor(words, dtype=I64).to(dev)
    nbits = torch.as_tensor(nbits, dtype=I64).to(dev).contiguous()
    wpad = torch.nn.functional.pad(words, (0, _PAD_WORDS))
    # the per-series initial unit depends only on the start's alignment
    aligned = (wpad[:, 0] % Unit(default_unit).nanos()) == 0
    unit0 = _W(aligned, int(default_unit), 0)
    if ctrl_tbl is None:
        ctrl_tbl = value_ctrl_table(dev)

    fused = chains == "fused"
    # phase 1: the scan (kernel on the card, the step loop on the CPU);
    # its done already holds the EOS peek after the last slot
    lanes, carry = decode_scan(wpad, nbits, unit0, ctrl_tbl, max_points, fused=fused)
    err = carry[2] | ~carry[1]  # not done after max_points -> error
    t0 = _mark(timings, "phase1", dev, t0)

    if fused:
        (ts, payload, meta), prec, err2 = lanes, carry[17], carry[18]
    else:
        ts, payload, meta, prec, err2 = _phase2(wpad, *lanes)
    _mark(timings, "phase2", dev, t0)
    if not scan_major:
        ts, payload, meta = ts.t(), payload.t(), meta.t()
    return ts, payload, meta, err | err2, prec, carry[5]


def payload_value_bits(payload: np.ndarray, meta: np.ndarray) -> np.ndarray:
    """Host-side float64 BIT reconstruction from raw decode outputs.

    Float payloads (meta bit 3) ARE the bits; int payloads divide by
    10^mult (meta bits 0-2) in numpy's IEEE f64, bit-identical to the
    reference's own f64 division.  Elementwise, any layout.
    """
    isf = (meta & 8) != 0
    mult = (meta & 7).astype(np.int64)
    ivals = (payload.astype(np.int64).astype(np.float64)
             / np.power(10.0, mult))
    return np.where(isf, payload, ivals.view(np.uint64))


def decode_batch(streams: list[bytes], max_points: int,
                 default_unit: Unit = Unit.SECOND,
                 annotations_fallback: bool = True, device=None,
                 timings: dict | None = None):
    """Host-facing batched decode.

    Returns (timestamps (S, P) int64, values (S, P) float64,
    counts (S,), fallback (S,) bool).  Fallback series (>2^53
    magnitudes, errors) need a scalar reader.  Annotated streams decode
    (each annotation consumes one point slot) but their annotation bytes
    are skipped, so by default they flag fallback too.
    """
    t0 = time.perf_counter()
    words, nbits = pack_streams(streams)
    if timings is not None:
        timings["host"] = timings.get("host", 0.0) + time.perf_counter() - t0
    ts, payload, meta, err, prec, ann = decode_batch_device(
        torch.from_numpy(words.view(np.int64)), torch.from_numpy(nbits),
        max_points=max_points, default_unit=int(default_unit),
        device=device, timings=timings)
    t0 = time.perf_counter()
    # the value rebuild is elementwise: run it on the contiguous (P, S)
    # layout and transpose the two results once
    # decode_batch is the codec's host API (it returns numpy): its reads
    # of the device result are the host boundary
    payload_pm = payload.t().cpu().numpy().view(np.uint64)  # m3lint: disable=transfer-hygiene
    meta_pm = meta.t().cpu().numpy()  # m3lint: disable=transfer-hygiene
    valid_pm = (meta_pm & 16) != 0
    ts = ts.t().cpu().numpy().T.copy()  # m3lint: disable=transfer-hygiene
    values = payload_value_bits(payload_pm, meta_pm).view(np.float64).T.copy()
    valid = valid_pm.T
    counts = valid_pm.sum(axis=0)
    ann_np = ann.cpu().numpy()  # m3lint: disable=transfer-hygiene
    # annotation slots leave holes: compact each annotated row's valid
    # datapoints to a prefix (the contract counts rely on)
    for i in np.nonzero(ann_np)[0]:
        m = valid[i]
        k = int(m.sum())
        ts[i, :k] = ts[i, m]
        values[i, :k] = values[i, m]
        ts[i, k:] = 0
        values[i, k:] = 0.0
    fallback = err.cpu().numpy() | prec.cpu().numpy()  # m3lint: disable=transfer-hygiene
    if annotations_fallback:
        fallback = fallback | ann_np
    if timings is not None:
        timings["host"] = timings.get("host", 0.0) + time.perf_counter() - t0
    return ts, values, counts, fallback
