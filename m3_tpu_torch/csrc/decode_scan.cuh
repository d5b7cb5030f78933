// The M3TSZ decode scan's per-series logic, shared by the CUDA kernel
// (decode_scan.cu) and a host build of the same code (decode_scan_host.cc,
// built with g++ for the CPU tests).  Every function here is
// __host__ __device__; without nvcc the two qualifiers are defined empty.
//
// One call of m3_scan_series walks one series' stream through max_points
// datapoint slots: each slot is one step of m3tsz_torch._decode_step (the
// reference's m3tsz_jax._decode_step under lax.scan), with the carry in
// registers, and the EOS peek after the last slot.  Integer arithmetic
// only: the bit scans are count-leading/trailing-zero instructions where
// the plain version reads a float64 exponent (_bits.msb_index).
//
// u64 stream words travel as int64 in the port; here they are uint64_t.
// Signed values (cursors, widths, the int chain) are int64_t, and every
// add, subtract, multiply and negate of the chains wraps through uint64_t,
// as torch's int64 arithmetic does.  Every variable shift goes through
// shl64/shr64: a shift by 64 or more (or a negative amount) gives 0, as
// _bits.shl/shr do; C's own shift by >= 64 is undefined.

#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

namespace m3scan {

typedef uint64_t u64;
typedef int64_t i64;

// carry rows of the kernel's (C, S) carry output, in _decode_carry0's order
enum {
  C_CURSOR, C_DONE, C_ERR, C_NEED_START, C_FIRST_VAL, C_SAW_ANN, C_UNIT, C_SIG,
  C_MULT, C_IS_FLOAT, C_PL, C_PT,
  // the fused tail's chains
  C_TIME, C_CSUM, C_CSUM_RST, C_FB, C_IV, C_PREC, C_ERR2,
  C_GATHER = 12, C_FUSED = 19
};

static const i64 KEEP_SIG = 127;          // value-control table: keep the sig
static const u64 PRECISION_LIMIT = 1ull << 53;

// time-unit byte -> nanos (0 = invalid): core/xtime.Unit
__host__ __device__ inline i64 unit_nanos(i64 u) {
  switch (u) {
    case 1: return 1000000000ll;
    case 2: return 1000000ll;
    case 3: return 1000ll;
    case 4: return 1ll;
    case 5: return 60ll * 1000000000ll;
    case 6: return 3600ll * 1000000000ll;
    case 7: return 86400ll * 1000000000ll;
    case 8: return 365ll * 86400ll * 1000000000ll;
    default: return 0;
  }
}

__host__ __device__ inline u64 shl64(u64 v, i64 s) {
  return (s < 0 || s >= 64) ? 0ull : v << s;
}

__host__ __device__ inline u64 shr64(u64 v, i64 s) {  // logical
  return (s < 0 || s >= 64) ? 0ull : v >> s;
}

// the 64 bits starting r (0..63) bits into the 128-bit hi:lo (_bits.funnel)
__host__ __device__ inline u64 funnel(u64 hi, u64 lo, i64 r) {
  return r ? (hi << r) | (lo >> (64 - r)) : hi;
}

__host__ __device__ inline i64 clamp64(i64 v, i64 lo, i64 hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__host__ __device__ inline i64 clz64(u64 v) {  // 64 for 0
#ifdef __CUDA_ARCH__
  return __clzll((long long)v);
#else
  return v ? __builtin_clzll(v) : 64;
#endif
}

__host__ __device__ inline i64 ctz64(u64 v) {  // 0 for 0 (callers guard it)
#ifdef __CUDA_ARCH__
  return v ? __ffsll((long long)v) - 1 : 0;
#else
  return v ? __builtin_ctzll(v) : 0;
#endif
}

__host__ __device__ inline i64 wrap_add(i64 a, i64 b) { return (i64)((u64)a + (u64)b); }
__host__ __device__ inline i64 wrap_sub(i64 a, i64 b) { return (i64)((u64)a - (u64)b); }
__host__ __device__ inline i64 wrap_mul(i64 a, i64 b) { return (i64)((u64)a * (u64)b); }
__host__ __device__ inline i64 wrap_abs(i64 a) { return a < 0 ? (i64)(0ull - (u64)a) : a; }

__host__ __device__ inline i64 ctrl_entry(const int32_t* tbl, i64 i) {
#ifdef __CUDA_ARCH__
  return (i64)__ldg(tbl + i);  // the 1 MB table through the read-only cache
#else
  return (i64)tbl[i];
#endif
}

__host__ __device__ inline u64 word_at(const u64* row, i64 i) {
#ifdef __CUDA_ARCH__
  return __ldg(row + i);
#else
  return row[i];
#endif
}

// The carry of one series (_decode_carry0; the chains only in the fused form).
struct Carry {
  i64 cursor, unit, sig, mult, pl, pt;
  bool done, err, need_start, first_val, saw_ann, is_float;
  i64 time, csum, csum_rst, fb, iv;
  bool prec, err2;
};

__host__ __device__ inline void carry0(Carry& c, i64 base_time) {
  c.cursor = 0; c.unit = 0; c.sig = 0; c.mult = 0; c.pl = 64; c.pt = 0;
  c.done = false; c.err = false; c.need_start = true; c.first_val = true;
  c.saw_ann = false; c.is_float = false;
  c.time = base_time; c.csum = 0; c.csum_rst = 0; c.fb = 0; c.iv = 0;
  c.prec = false; c.err2 = false;
}

// One step's outputs: the gather tail's four lanes, or the fused tail's point.
struct Lanes {
  i64 ts_off, p1, val_off, p2;   // gather
  i64 ts, payload;               // fused
  uint8_t meta;
};

// One datapoint slot of one series: m3tsz_torch._decode_step, line for
// line (its comments name each section).  ``row`` is the series' padded
// words (Wp of them), ``nbits`` its stream length, ``unit0`` its initial
// unit.
template <bool FUSED>
__host__ __device__ inline void step(Carry& c, Lanes& out, const u64* row, i64 Wp,
                                     i64 nbits, i64 unit0, const int32_t* tbl) {
  const bool active = !c.done && !c.err;
  bool err = c.err;
  bool done = c.done;

  // ---- the 64-bit start word: only its alignment matters (unit0) ----
  i64 cur = c.cursor + ((active && c.need_start) ? 64 : 0);
  const i64 unit_eff = c.need_start ? unit0 : c.unit;
  const bool first = c.first_val;

  // ---- register file: the 4 words at the cursor's word (reads clamped
  // to the row, as _peek clamps) ----
  const i64 c0 = cur;
  const i64 w0i = c0 >> 6;
  const u64 r0 = word_at(row, clamp64(w0i, 0, Wp - 1));
  const u64 r1 = word_at(row, clamp64(w0i + 1, 0, Wp - 1));
  const u64 r2 = word_at(row, clamp64(w0i + 2, 0, Wp - 1));
  const u64 r3 = word_at(row, clamp64(w0i + 3, 0, Wp - 1));
  const i64 rf_base = (i64)((u64)w0i << 6);
  const u64 W0 = funnel(r0, r1, c0 - rf_base);

  // static width n (1..64) at cur_abs - c0 bits into W0
  auto rd0 = [&](i64 cur_abs, int n) -> u64 {
    return shr64(shl64(W0, cur_abs - c0), 64 - n);
  };
  // up to 64 bits anywhere in [c0, rf_base + 192): a 3-way funnel
  auto rd3 = [&](i64 cur_abs, int n) -> u64 {
    const i64 o = cur_abs - rf_base;
    const i64 k = o >> 6;
    const u64 hi = k == 0 ? r0 : (k == 1 ? r1 : r2);
    const u64 lo = k == 0 ? r1 : (k == 1 ? r2 : r3);
    return shr64(funnel(hi, lo, o & 63), 64 - n);
  };

  // ---- marker peek (11 bits) ----
  const bool can_peek = (cur + 11) <= nbits;
  const u64 peek11 = (active && can_peek) ? rd0(cur, 11) : 0;
  const bool is_marker = (peek11 >> 2) == 0x100;
  const u64 mval = peek11 & 3;
  const bool eos = active && is_marker && mval == 0;
  const bool ann = active && is_marker && mval == 1;
  const bool is_tu = active && is_marker && mval == 2;
  done = done || eos;
  const bool proceed = active && !eos && !ann;

  // ---- annotation skip: marker + zigzag varint of (len-1) + bytes ----
  const i64 acur = cur + 11;
  const u64 vb0 = rd0(acur, 8), vb1 = rd0(acur + 8, 8);
  const u64 vb2 = rd0(acur + 16, 8), vb3 = rd0(acur + 24, 8);
  const bool t1 = (vb0 & 0x80) != 0;
  const bool t2 = t1 && (vb1 & 0x80) != 0;
  const bool t3 = t2 && (vb2 & 0x80) != 0;
  const u64 ux = (vb0 & 0x7F) | (t1 ? (vb1 & 0x7F) << 7 : 0)
               | (t2 ? (vb2 & 0x7F) << 14 : 0) | (t3 ? (vb3 & 0x7F) << 21 : 0);
  const i64 abits = 8 + 8 * ((i64)t1 + (i64)t2 + (i64)t3);
  const i64 ann_len = (i64)(ux >> 1) + 1;
  err = err || (ann && t3 && (vb3 & 0x80) != 0);  // varint > 4B
  const i64 ann_end = acur + abits + ann_len * 8;
  err = err || (ann && ann_end > nbits);
  const bool saw_ann = c.saw_ann || (ann && !err);

  // ---- time-unit marker ----
  cur += is_tu ? 11 : 0;
  const i64 ub = is_tu ? (i64)rd0(cur, 8) : 0;
  cur += is_tu ? 8 : 0;
  const bool ub_valid = ub >= 1 && ub <= 8;
  const bool tu_changed = is_tu && ub_valid && ub != unit_eff;
  const i64 new_unit = is_tu ? ub : unit_eff;
  const bool unit_ok = new_unit >= 1 && new_unit <= 8;
  err = err || (proceed && !unit_ok && !tu_changed);

  // ---- delta of delta: widths only ----
  const bool full64 = tu_changed;
  const i64 rd_dod64 = (proceed && full64) ? 64 : 0;
  cur += rd_dod64;
  const i64 dod64_off = cur - rd_dod64;
  const bool bucket_active = proceed && !full64;
  const u64 op4 = bucket_active ? rd0(cur, 4) : 0;
  const bool b3 = ((op4 >> 3) & 1) == 0, b2 = ((op4 >> 2) & 1) == 0;
  const bool b1 = ((op4 >> 1) & 1) == 0, b0 = (op4 & 1) == 0;
  const bool default_is32 = new_unit == 1 || new_unit == 2;
  i64 nop = b3 ? 1 : (b2 ? 2 : (b1 ? 3 : 4));
  i64 nv = b3 ? 0 : (b2 ? 7 : (b1 ? 9 : (b0 ? 12 : (default_is32 ? 32 : 64))));
  nop = bucket_active ? nop : 0;
  nv = bucket_active ? nv : 0;
  cur += nop;
  const i64 ts_off = full64 ? dod64_off : cur;
  const i64 ts_w = full64 ? 64 : nv;
  cur += nv;

  // ---- value section: one 16-bit read + one table lookup ----
  const i64 v0 = cur;
  const i64 X = (i64)rd3(v0, 16);
  const i64 tidx = X | (c.is_float ? 1 << 16 : 0) | (first ? 1 << 17 : 0);
  const i64 tv = ctrl_entry(tbl, tidx);

  const i64 ctrl = tv & 0x1F;
  const i64 sig7 = (tv >> 5) & 0x7F;
  const i64 mult3 = (tv >> 12) & 0x7;
  const bool mult_keep = (tv >> 15) & 1;
  const bool sign_v = (tv >> 16) & 1;
  const bool got_float_full = proceed && ((tv >> 17) & 1);
  const bool xor_nz = proceed && ((tv >> 18) & 1);
  const bool contained = proceed && ((tv >> 19) & 1);
  const bool uncont = proceed && ((tv >> 20) & 1);
  const bool diff_active = proceed && ((tv >> 21) & 1);
  const bool nfloat_set = (tv >> 22) & 1;
  const bool nfloat_keep = (tv >> 23) & 1;
  const bool xor_zero = proceed && ((tv >> 25) & 1);
  err = err || (proceed && ((tv >> 24) & 1));

  const i64 eff_sig = sig7 == KEEP_SIG ? c.sig : sig7;
  const i64 meaningful_c = 64 - c.pl - c.pt;
  const i64 u_lead = (X >> 7) & 0x3F;
  const i64 u_meaningful = ((X >> 1) & 0x3F) + 1;
  const i64 u_trail = 64 - u_lead - u_meaningful;
  err = err || (uncont && u_trail < 0);

  const i64 val_w = got_float_full ? 64 : (contained ? meaningful_c
                    : (uncont ? u_meaningful : (diff_active ? eff_sig : 0)));
  const i64 val_off = v0 + ctrl;
  cur = v0 + (proceed ? ctrl + val_w : 0);

  // ---- leading/trailing update for the next step ----
  const bool need_payload = got_float_full || contained;
  const i64 c_w = contained ? meaningful_c : 0;
  const u64 raw = rd3(val_off, 64);
  const u64 cb = shr64(raw, 64 - clamp64(c_w, 0, 64));
  const u64 nx = got_float_full ? raw : shl64(cb, c.pt);
  const i64 pl_c = clz64(nx);
  const i64 pt_c = nx == 0 ? 0 : ctz64(nx);
  const i64 n_pl = need_payload ? pl_c : (uncont ? u_lead : (xor_zero ? 64 : c.pl));
  const i64 n_pt = need_payload ? pt_c : (uncont ? u_trail : (xor_zero ? 0 : c.pt));

  // ---- narrow state update ----
  const bool n_is_float = proceed ? (nfloat_set || (nfloat_keep && c.is_float)) : c.is_float;
  const i64 n_sig = (proceed && sig7 != KEEP_SIG) ? sig7 : c.sig;
  const i64 n_mult = (proceed && !mult_keep) ? mult3 : c.mult;

  err = err || (proceed && cur > nbits);
  const bool emit = proceed && !err;

  // ---- cursor: datapoints advance to cur; annotation slots jump ----
  const bool ann_ok = ann && !err;
  const i64 new_cursor = ann_ok ? ann_end : (proceed ? cur : c.cursor);
  const bool consumed = proceed || ann_ok;
  const i64 new_unit_carry = proceed ? new_unit
                             : ((ann_ok && c.need_start) ? unit0 : c.unit);

  if (FUSED) {
    // ---- the fused tail: the three value chains ----
    const u64 draw = rd3(ts_off, 64);
    const u64 dmag = shr64(draw, 64 - clamp64(ts_w, 0, 64));
    const i64 sx = 64 - ts_w;  // _sign_extend
    const i64 dod = (i64)shl64(dmag, sx) >> (sx > 63 ? 63 : sx);
    const i64 d_k = emit ? (full64 ? dod : wrap_mul(dod, unit_nanos(clamp64(new_unit, 0, 15))))
                         : 0;
    const i64 csum2 = wrap_add(c.csum, d_k);
    const i64 time2 = wrap_add(c.time, emit ? wrap_sub(csum2, c.csum_rst) : 0);
    const i64 csum_rst2 = (emit && full64) ? csum2 : c.csum_rst;

    const u64 pay_unc = shr64(raw, 64 - clamp64(u_meaningful, 1, 64));
    const u64 xv = (xor_nz && emit)
                   ? (uncont ? shl64(pay_unc, clamp64(u_trail, 0, 63)) : nx) : 0;
    const i64 fb2 = (emit && got_float_full) ? (i64)raw : (i64)((u64)c.fb ^ xv);

    const u64 dv = shr64(raw, 64 - clamp64(eff_sig, 0, 64));
    const i64 iv2 = wrap_add(c.iv, (emit && diff_active)
                                       ? (sign_v ? (i64)dv : (i64)(0ull - dv)) : 0);
    const bool prec2 = c.prec || (emit && diff_active
                                  && (PRECISION_LIMIT < dv
                                      || wrap_abs(iv2) > (i64)PRECISION_LIMIT));
    const bool top_ok = shr64(pay_unc, clamp64(u_meaningful - 1, 0, 63)) == 1;
    const bool bot_ok = (pay_unc & 1) == 1;
    const bool err2_2 = c.err2 || (emit && uncont && !(top_ok && bot_ok));

    out.ts = emit ? time2 : 0;
    out.payload = n_is_float ? fb2 : iv2;
    out.meta = (uint8_t)(((i64)emit << 4) | ((i64)n_is_float << 3) | clamp64(n_mult, 0, 7));
    c.time = time2; c.csum = csum2; c.csum_rst = csum_rst2; c.fb = fb2; c.iv = iv2;
    c.prec = prec2; c.err2 = err2_2;
  } else {
    // ---- lane-table emission (the gather tail) ----
    const i64 shift = contained ? c.pt : (uncont ? clamp64(u_trail, 0, 63) : 0);
    out.ts_off = ts_off;
    out.p1 = (emit ? ts_w : 0) | ((i64)(emit && full64) << 7)
             | (clamp64(new_unit, 0, 15) << 8) | ((i64)emit << 12);
    out.val_off = val_off;
    out.p2 = (emit ? val_w : 0) | (clamp64(shift, 0, 63) << 7)
             | (clamp64(n_mult, 0, 7) << 13) | ((i64)n_is_float << 16)
             | ((i64)(emit && xor_nz) << 17) | ((i64)(emit && got_float_full) << 18)
             | ((i64)(emit && diff_active) << 19) | ((i64)sign_v << 20)
             | ((i64)(emit && uncont) << 21);
  }

  c.cursor = new_cursor;
  c.done = done;
  c.err = err;
  c.need_start = c.need_start && !consumed;
  c.first_val = c.first_val && !proceed;
  c.saw_ann = saw_ann;
  c.unit = new_unit_carry;
  c.sig = n_sig;
  c.mult = n_mult;
  c.is_float = n_is_float;
  c.pl = n_pl;
  c.pt = n_pt;
}

// The EOS peek after the last slot: a stream whose EOS marker sits exactly
// after max_points datapoints never sets done inside the scan (_peek).
__host__ __device__ inline bool eos_after(const u64* row, i64 Wp, i64 cursor, i64 nbits) {
  const i64 W = Wp - 1;
  const i64 w = clamp64(cursor >> 6, 0, W - 1);
  const i64 off = cursor & 63;
  const u64 window = shl64(word_at(row, w), off)
                     | (off > 0 ? shr64(word_at(row, w + 1), 64 - off) : 0);
  const u64 peek11 = shr64(window, 64 - 11);
  return (cursor + 11) <= nbits && (peek11 >> 2) == 0x100 && (peek11 & 3) == 0;
}

// The whole scan of series s of S: max_points steps, each writing its
// lanes at slot i (scan-major: lane[i * S + s]), then the EOS peek folded
// into done and the final carry written to carry_out[row * S + s].
// gather: lanes = {int32 ts_off, int32 p1, int32 val_off, int32 p2};
// fused:  lanes = {int64 ts, int64 payload, uint8 meta}.
template <bool FUSED>
__host__ __device__ inline void scan_series(const u64* wpad, i64 Wp, const i64* nbits,
                                            const i64* unit0, const int32_t* tbl,
                                            i64 max_points, i64 S, i64 s, void* lane0,
                                            void* lane1, void* lane2, void* lane3,
                                            i64* carry_out) {
  const u64* row = wpad + s * Wp;
  const i64 nb = nbits[s];
  const i64 u0 = unit0[s];
  Carry c;
  carry0(c, (i64)row[0]);
  Lanes o;
  for (i64 i = 0; i < max_points; ++i) {
    step<FUSED>(c, o, row, Wp, nb, u0, tbl);
    const i64 at = i * S + s;
    if (FUSED) {
      ((i64*)lane0)[at] = o.ts;
      ((i64*)lane1)[at] = o.payload;
      ((uint8_t*)lane2)[at] = o.meta;
    } else {
      ((int32_t*)lane0)[at] = (int32_t)o.ts_off;
      ((int32_t*)lane1)[at] = (int32_t)o.p1;
      ((int32_t*)lane2)[at] = (int32_t)o.val_off;
      ((int32_t*)lane3)[at] = (int32_t)o.p2;
    }
  }
  c.done = c.done || eos_after(row, Wp, c.cursor, nb);
  const i64 vals[C_FUSED] = {
      c.cursor, c.done, c.err, c.need_start, c.first_val, c.saw_ann, c.unit, c.sig,
      c.mult, c.is_float, c.pl, c.pt,
      c.time, c.csum, c.csum_rst, c.fb, c.iv, c.prec, c.err2};
  const int rows = FUSED ? C_FUSED : C_GATHER;
  for (int k = 0; k < rows; ++k) carry_out[k * S + s] = vals[k];
}

}  // namespace m3scan
