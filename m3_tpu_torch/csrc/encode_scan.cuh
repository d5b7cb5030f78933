// The M3TSZ encode scan's per-series logic, shared by the CUDA kernel
// (encode_scan.cu) and a host build of the same code (encode_scan_host.cc,
// built with g++ for the CPU tests).  Every function here is
// __host__ __device__; without nvcc the two qualifiers are defined empty
// (decode_scan.cuh, whose bit and wrap helpers this file reuses).
//
// One call of scan_series walks one series through its T datapoint slots:
// each slot is one step of m3tsz_torch._encode_step (the reference's
// m3tsz_jax._encode_step under lax.scan), with the 13-value carry in
// registers.  The step resolves the datapoint's format into four
// (value, width) lanes: t0 the timestamp's control and payload, t1 a
// 64-bit delta-of-delta, v0 the value's control, v1 its payload.
//
// Integer arithmetic only, as the plain version's f64_emul: the float64
// multiply by 10^k and the Modf/Nextafter tests of convertToIntFloat run
// on (mantissa, exponent) pairs with round-to-nearest-even.  Bit scans are
// count-leading-zero instructions where the plain version reads a float64
// exponent (_bits.msb_index); zero is guarded where the plain version
// guards it (clz(0) == 64, num_sig(0) == 0, msb_index(0) == -1023).
//
// Every value is an int64_t or a uint64_t holding the bits torch's int64
// tensor would hold: adds, subtracts, multiplies and negates wrap through
// uint64_t; every variable shift goes through shl64/shr64 (0 for amounts
// >= 64 or < 0, as _bits.shl/shr); compares are signed unless the plain
// version calls ult.  Lanes of padding steps (valid false) are computed
// as the plain step computes them, so the tables are equal bit for bit.

#pragma once

#include <stdint.h>

#include "decode_scan.cuh"

namespace m3enc {

using m3scan::clz64;
using m3scan::shl64;
using m3scan::shr64;
using m3scan::wrap_abs;
using m3scan::wrap_add;
using m3scan::wrap_mul;
using m3scan::wrap_sub;

typedef uint64_t u64;
typedef int64_t i64;

// carry rows of the kernel's (13, S) carry input and output, in
// m3tsz_torch._encode_carry0's order
enum {
  C_PREV_TIME, C_PREV_DELTA, C_TU_NONE, C_INT_VAL, C_MAX_MULT, C_IS_FLOAT,
  C_PREV_FBITS, C_PREV_XOR, C_NUM_SIG, C_CUR_HL, C_NUM_LOWER, C_IS_FIRST,
  C_FALLBACK, C_ROWS
};

static const i64 MIN64 = (i64)(1ull << 63);
static const i64 MASK52 = (1ll << 52) - 1;
static const i64 MASK63 = (i64)((1ull << 63) - 1);
static const i64 IMPLICIT = 1ll << 52;
static const i64 BITS_1E13 = 0x42A2309CE5400000ll;  // float64 bits of 1e13
static const i64 BITS_2_63 = 0x43E0000000000000ll;  // float64 bits of 2^63
static const i64 PRECISION_LIMIT = 1ll << 53;

__host__ __device__ inline i64 ishl(i64 v, i64 s) { return (i64)shl64((u64)v, s); }
__host__ __device__ inline i64 ishr(i64 v, i64 s) { return (i64)shr64((u64)v, s); }
__host__ __device__ inline i64 neg(i64 v) { return (i64)(0ull - (u64)v); }
__host__ __device__ inline i64 imin(i64 a, i64 b) { return a < b ? a : b; }
__host__ __device__ inline i64 imax(i64 a, i64 b) { return a > b ? a : b; }
__host__ __device__ inline i64 iclamp(i64 v, i64 lo, i64 hi) { return imin(imax(v, lo), hi); }
__host__ __device__ inline bool ult(i64 a, i64 b) { return (u64)a < (u64)b; }

// _bits.msb_index / clz / num_sig / ctz
__host__ __device__ inline i64 msb_index(i64 v) { return v ? 63 - clz64((u64)v) : -1023; }
__host__ __device__ inline i64 clz(i64 v) { return clz64((u64)v); }
__host__ __device__ inline i64 num_sig(i64 v) { return 64 - clz64((u64)v); }
__host__ __device__ inline i64 ctz(i64 v) { return msb_index(v & neg(v)); }

// (1 << s) - 1 for s in 0..63, as torch computes it on int64 (wraps at 63)
__host__ __device__ inline i64 low_mask(i64 s) { return (i64)((1ull << s) - 1ull); }

// ---- f64_emul: exact float64 arithmetic on u64 bit patterns ----

__host__ __device__ inline void mantissa_and_exp2(i64 bits, i64& mant, i64& exp2) {
  const i64 exp = ishr(bits, 52) & 0x7FF;
  const i64 frac = bits & MASK52;
  mant = exp == 0 ? frac : (frac | IMPLICIT);
  exp2 = exp == 0 ? -1074 : exp - 1075;
}

// round-to-nearest-even right shift of u64 m by k (0 <= k <= 63)
__host__ __device__ inline i64 round_shift_right_even(i64 m, i64 k) {
  if (k <= 0) return m;
  const i64 q = ishr(m, k);
  const i64 rem = m & low_mask(k);
  const i64 half = 1ll << (k - 1);
  const bool up = rem > half || (rem == half && (q & 1) == 1);
  return wrap_add(q, up ? 1 : 0);
}

// (mantissa, exp2) with value = mant * 2^exp2 -> positive float64 bits, RNE
__host__ __device__ inline i64 pack(i64 mant, i64 exp2) {
  const i64 L = msb_index(mant == 0 ? 1 : mant);
  const i64 shift = L - 52;
  i64 eb = exp2 + shift + 1075;
  const i64 extra = eb < 1 ? 1 - eb : 0;
  const i64 total_r = imin(shift + extra, 63);
  eb = eb < 1 ? 0 : eb;
  const i64 left = iclamp(-total_r, 0, 63);
  const i64 right = iclamp(total_r, 0, 63);
  i64 m = total_r >= 0 ? round_shift_right_even(mant, right) : ishl(mant, left);
  const bool carried = m >= (1ll << 53);
  m = carried ? m >> 1 : m;
  eb = carried ? eb + 1 : eb;
  const bool is_norm = m >= IMPLICIT;
  const i64 bits = (is_norm && eb >= 1) ? (ishl(eb, 52) | (m & MASK52)) : m;
  return mant == 0 ? 0 : bits;
}

__host__ __device__ inline i64 pow10(i64 k) {
  switch (k) {
    case 0: return 1;
    case 1: return 10;
    case 2: return 100;
    case 3: return 1000;
    case 4: return 10000;
    case 5: return 100000;
    default: return 1000000;  // k == 6: the carried multiplier never exceeds it
  }
}

// exact float64 multiply of positive finite bits by 10^k, k in [0, 6]: the
// 53 x 20-bit product in two u64 halves, reduced with a sticky bit
__host__ __device__ inline i64 mul_pow10(i64 bits, i64 k) {
  i64 mant, exp2;
  mantissa_and_exp2(bits, mant, exp2);
  const i64 p10 = pow10(k);
  const i64 lo32 = mant & 0xFFFFFFFFll;
  const i64 hi32 = mant >> 32;
  const i64 p_lo = wrap_mul(lo32, p10);
  const i64 p_hi = wrap_mul(hi32, p10);
  const i64 lo = wrap_add(p_lo, ishl(p_hi & 0xFFFFFFFFll, 32));
  const i64 carry = ult(lo, p_lo) ? 1 : 0;
  const i64 hi = wrap_add(p_hi >> 32, carry);
  const bool nz_hi = hi != 0;
  const i64 s = nz_hi ? msb_index(hi) + 1 : 0;
  const i64 dropped = s > 0 ? (lo & low_mask(s)) : 0;
  const i64 lshift = s > 0 ? 64 - s : 0;
  i64 merged = nz_hi ? (ishr(lo, s) | ishl(hi, imin(lshift, 63))) : lo;
  merged |= dropped != 0 ? 1 : 0;
  return pack(merged, exp2 + s);
}

// positive finite bits -> (floor as u64, fraction is zero); floor < 2^63
__host__ __device__ inline void floor_parts(i64 bits, i64& ipart, bool& frac_zero) {
  const i64 exp = ishr(bits, 52) & 0x7FF;
  i64 mant, exp2;
  mantissa_and_exp2(bits, mant, exp2);
  const i64 e = exp - 1023;
  const bool lt_one = e < 0;
  const bool big = e >= 52;
  const i64 shift_r = iclamp(52 - e, 0, 63);
  const i64 shift_l = iclamp(e - 52, 0, 63);
  ipart = lt_one ? 0 : (big ? ishl(mant, shift_l) : mant >> shift_r);
  const i64 frac_bits = (lt_one || big) ? 0 : (mant & low_mask(shift_r));
  frac_zero = lt_one ? bits == 0 : frac_bits == 0;
}

// ---- value classification: convertToIntFloat (m3tsz_torch.classify_value) ----

// exact float64 multiply by 10 in the (mantissa, exp2) form (mant < 2^53)
__host__ __device__ inline void mul10_me(i64& mant, i64& exp2) {
  const i64 p = mant * 10;  // < 2^57
  const i64 L = msb_index(p < 1 ? 1 : p);
  const i64 sh = imax(L, 52) - 52;
  i64 q = round_shift_right_even(p, sh);
  const bool carried = q >= (1ll << 53);
  q = carried ? q >> 1 : q;
  exp2 = mant == 0 ? exp2 : exp2 + sh + (carried ? 1 : 0);
  mant = q;
}

struct Classified {
  i64 val, mult;
  bool is_float, prec;
};

__host__ __device__ inline Classified classify_value(i64 v_bits, i64 cur_mult) {
  const bool sign = v_bits < 0;
  const i64 abs_b = v_bits & MASK63;
  const bool special = (ishr(abs_b, 52) & 0x7FF) == 0x7FF;  // NaN / Inf

  // quick path: already integral and v < 2^63 (Go's uint64(int64(v))
  // saturation for larger magnitudes)
  i64 ipart0;
  bool frac_zero0;
  floor_parts(abs_b, ipart0, frac_zero0);
  const bool v_lt_maxint = sign || abs_b < BITS_2_63;
  const bool quick_ok = cur_mult == 0 && v_lt_maxint && frac_zero0 && !special;
  const bool sat = abs_b >= BITS_2_63;
  const i64 quick_mag = sat ? MIN64 : ipart0;
  const i64 quick_val = (sign && !sat) ? neg(quick_mag) : quick_mag;

  // the multiplier search from cur_mult: a lane that is not active at a
  // k >= cur_mult never becomes active again (its mantissa stops moving),
  // so the loop ends there
  bool found = false;
  i64 res_i = 0, res_mult = 0;
  if (!quick_ok && !special) {
    i64 mant, exp2;
    mantissa_and_exp2(mul_pow10(abs_b, cur_mult), mant, exp2);
    for (i64 k = cur_mult < 0 ? 0 : cur_mult; k < 7; ++k) {
      const i64 vb_cur = mant < IMPLICIT ? mant : (ishl(exp2 + 1075, 52) | (mant & MASK52));
      if (!ult(vb_cur, BITS_1E13)) break;
      const i64 s = iclamp(-exp2, 0, 63);
      const bool big_s = -exp2 > 63;
      const i64 low = low_mask(s);
      const i64 frac = big_s ? mant : (mant & low);
      const i64 ip = big_s ? 0 : mant >> s;
      const bool take_i = frac <= 1;
      const bool take_i1 = !take_i && frac >= low;
      if (take_i || take_i1) {
        res_i = take_i ? ip : wrap_add(ip, 1);
        res_mult = k;
        found = true;
        break;
      }
      mul10_me(mant, exp2);
    }
  }

  Classified c;
  const i64 loop_val = sign ? neg(res_i) : res_i;
  c.is_float = !quick_ok && !found;
  c.val = quick_ok ? quick_val : (found ? loop_val : 0);
  c.mult = (found && !quick_ok) ? res_mult : 0;
  c.prec = !c.is_float && (c.val > PRECISION_LIMIT || c.val < -PRECISION_LIMIT);
  return c;
}

// ---- phase-1 helpers (m3tsz_torch._cat, _dod_lanes, _int_sig_mult_ctrl,
// _track_new_sig) ----

struct Acc {
  i64 val, n;
};

// append the low add_n (< 64) bits of add_val, MSB-first
__host__ __device__ inline void cat(Acc& acc, i64 add_val, i64 add_n, bool enable = true) {
  add_n = enable ? add_n : 0;
  acc.val = ishl(acc.val, add_n) | (add_val & low_mask(add_n));
  acc.n += add_n;
}

struct Dod {
  i64 t0, n_t0;
  bool need64, overflow;
};

// bucketed delta-of-delta (timestamp_encoder.go:131-221)
__host__ __device__ inline Dod dod_lanes(i64 dod, bool default32) {
  const bool is_zero = dod == 0;
  const bool fits7 = dod >= -64 && dod <= 63;
  const bool fits9 = dod >= -256 && dod <= 255;
  const bool fits12 = dod >= -2048 && dod <= 2047;
  const bool t1_ = !is_zero && fits7;
  const bool t2_ = !is_zero && !fits7 && fits9;
  const bool t3_ = !is_zero && !fits9 && fits12;
  const bool take_def = !is_zero && !fits12;
  i64 t0_def, n_def;
  Dod d;
  if (default32) {
    t0_def = (0xFll << 32) | (dod & 0xFFFFFFFFll);
    n_def = 36;
    d.need64 = false;
    d.overflow = take_def && (dod < -(1ll << 31) || dod > (1ll << 31) - 1);
  } else {
    t0_def = 0xF;
    n_def = 4;
    d.need64 = take_def;
    d.overflow = false;
  }
  d.t0 = is_zero ? 0
         : t1_ ? ((0x2ll << 7) | (dod & 0x7F))
         : t2_ ? ((0x6ll << 9) | (dod & 0x1FF))
         : t3_ ? ((0xEll << 12) | (dod & 0xFFF))
         : t0_def;
  d.n_t0 = is_zero ? 1 : t1_ ? 9 : t2_ ? 12 : t3_ ? 16 : n_def;
  return d;
}

// writeIntSigMult (encoder.go:235-250) onto acc; sets the new num_sig
// (sig) and max_mult
__host__ __device__ inline void int_sig_mult_ctrl(Acc& acc, i64 num_sig_st, i64 max_mult,
                                                  i64 sig, i64 mult, bool float_changed,
                                                  i64& out_sig, i64& out_max_mult) {
  const bool sig_changed = num_sig_st != sig;
  const bool zero_sig = sig == 0;
  cat(acc, sig_changed ? 1 : 0, 1);
  cat(acc, zero_sig ? 0 : 1, 1, sig_changed);
  cat(acc, wrap_sub(sig, 1), 6, sig_changed && !zero_sig);
  const bool mult_up = mult > max_mult;
  const bool float_only = !mult_up && max_mult == mult && float_changed;
  const bool wr = mult_up || float_only;
  cat(acc, wr ? 1 : 0, 1);
  cat(acc, mult, 3, wr);
  out_sig = sig;
  out_max_mult = mult_up ? mult : max_mult;
}

// IntSigBitsTracker.TrackNewSig (int_sig_bits_tracker.go:68-91)
__host__ __device__ inline void track_new_sig(i64 num_sig_st, i64 cur_hl, i64 num_lower,
                                              i64 sig, i64& new_sig, i64& chl, i64& nl) {
  const bool grow = sig > num_sig_st;
  new_sig = grow ? sig : num_sig_st;
  const bool shrink = !grow && wrap_sub(num_sig_st, sig) >= 3;
  chl = (shrink && num_lower == 0) ? sig : ((shrink && sig > cur_hl) ? sig : cur_hl);
  // the lower-sig streak resets only on the within-threshold branch: a
  // grow step leaves it intact (Go keeps t.NumLowerSig)
  nl = shrink ? wrap_add(num_lower, 1) : (grow ? num_lower : 0);
  const bool fire = shrink && nl >= 5;
  new_sig = fire ? chl : new_sig;
  nl = fire ? 0 : nl;
}

// floor division and "divisible" of torch's int64 // and % (d > 0)
__host__ __device__ inline i64 floor_div(i64 a, i64 d) {
  if (d == 1) return a;
  i64 q = a / d;
  if ((a % d) != 0 && a < 0) q -= 1;
  return q;
}

// ---- one step ----

// The carry of one series (_encode_carry0's rows).
struct Carry {
  i64 prev_time, prev_delta, int_val, max_mult, prev_fbits, prev_xor, num_sig, cur_hl,
      num_lower;
  bool tu_none, is_float, is_first, fallback;
};

struct Lanes {
  i64 v[4];  // t0, t1, v0, v1
  i64 n[4];  // their widths
};

// One datapoint of one series: m3tsz_torch._encode_step, line for line
// (its comments name each section).  unit is the wire byte, unit_nanos
// its nanoseconds.
__host__ __device__ inline void step(Carry& c, Lanes& out, i64 t, i64 v_bits, bool valid,
                                     i64 unit, i64 unit_nanos, bool default32) {
  const i64 prev_time = c.prev_time, prev_delta = c.prev_delta, int_val = c.int_val;
  const i64 max_mult = c.max_mult, prev_fbits = c.prev_fbits, prev_xor = c.prev_xor;
  const i64 num_sig_st = c.num_sig, cur_hl = c.cur_hl, num_lower = c.num_lower;
  const bool tu_none = c.tu_none, is_float = c.is_float, is_first = c.is_first;

  // ---- timestamp (timestamp_encoder.go:72-129) ----
  const bool emit_tu = is_first && tu_none;
  const i64 time_delta = wrap_sub(t, prev_time);
  const i64 dod_ns = wrap_sub(time_delta, prev_delta);
  const i64 dod_units = floor_div(dod_ns, unit_nanos);
  const bool div_ok = (dod_ns % unit_nanos) == 0;
  const Dod d = dod_lanes(dod_units, default32);
  const i64 tu_const = (0x100ll << 10) | (0x2ll << 8) | (unit & 0xFF);
  const i64 t0 = emit_tu ? tu_const : d.t0;
  const i64 n_t0 = emit_tu ? 19 : d.n_t0;
  const i64 t1 = emit_tu ? dod_ns : dod_units;
  const i64 n_t1 = (emit_tu || d.need64) ? 64 : 0;
  const i64 new_prev_delta = emit_tu ? 0 : time_delta;

  // ---- value ----
  const Classified cv = classify_value(v_bits, max_mult);
  const i64 val = cv.val, mult = cv.mult;
  const bool v_is_float = cv.is_float;

  // first value (encoder.go:112-146)
  const bool neg_diff = val >= 0;  // inverted: diff = 0 - val
  const i64 mag = wrap_abs(val);
  const i64 sig_f = num_sig(mag);

  // next value (encoder.go:148-231)
  const i64 val_diff = wrap_sub(int_val, val);
  const bool go_float = v_is_float;
  const bool was_int = !is_float;

  // writeFloatVal
  const bool repeat_f = is_float && v_bits == prev_fbits;
  const i64 cur_xor = prev_fbits ^ v_bits;
  const bool xor_zero = cur_xor == 0;
  const i64 pl = clz(prev_xor);
  const i64 pt = prev_xor == 0 ? 0 : ctz(prev_xor);
  const i64 cl = clz(xor_zero ? 1 : cur_xor);
  const i64 ct = num_sig(cur_xor & neg(cur_xor)) - 1;
  const bool contained = !xor_zero && cl >= pl && ct >= pt;
  const i64 meaningful = 64 - cl - ct;
  const i64 v0_unc = (0x7ll << 12) | ishl(cl, 6) | (meaningful - 1);
  const i64 v0_f = was_int ? 1 : (repeat_f ? 1 : (xor_zero ? 2 : (contained ? 6 : v0_unc)));
  const i64 n_v0_f = was_int ? 3 : ((repeat_f || xor_zero) ? 2 : (contained ? 3 : 15));
  const i64 v1_f = was_int ? v_bits : (contained ? ishr(cur_xor, pt) : ishr(cur_xor, ct));
  const i64 n_v1_f = was_int ? 64
                     : ((repeat_f || xor_zero) ? 0 : (contained ? 64 - pl - pt : meaningful));
  const i64 nxor = xor_zero ? 0 : cur_xor;

  // writeIntVal
  const bool repeat_i = val_diff == 0 && !is_float && mult == max_mult;
  const bool negv = val_diff < 0;
  const i64 diff_mag = wrap_abs(val_diff);
  const i64 sig_n = num_sig(diff_mag);
  i64 new_sig, t_chl, t_nl;
  track_new_sig(num_sig_st, cur_hl, num_lower, sig_n, new_sig, t_chl, t_nl);
  const bool float_changed = is_float;
  const bool need_update = mult > max_mult || num_sig_st != new_sig || float_changed;

  // the shared writeIntSigMult cascade
  Acc acc;
  acc.val = 0;
  acc.n = is_first ? 1 : 3;
  i64 ns_sh, mm_sh;
  int_sig_mult_ctrl(acc, num_sig_st, max_mult, is_first ? sig_f : new_sig, mult,
                    !is_first && float_changed, ns_sh, mm_sh);
  cat(acc, (is_first ? neg_diff : negv) ? 1 : 0, 1);

  // the three paths' lanes and state; pick(first, float, int)
  i64 v0, n_v0, v1, n_v1;
  i64 s_int_val, s_max_mult, s_prev_fbits, s_prev_xor, s_num_sig, s_cur_hl, s_num_lower;
  bool s_is_float;
  if (is_first) {
    v0 = v_is_float ? 1 : acc.val;
    n_v0 = v_is_float ? 1 : acc.n;
    v1 = v_is_float ? v_bits : mag;
    n_v1 = v_is_float ? 64 : ns_sh;
    s_int_val = v_is_float ? int_val : val;
    s_is_float = v_is_float;
    s_max_mult = v_is_float ? mult : mm_sh;
    s_prev_fbits = v_is_float ? v_bits : prev_fbits;
    s_prev_xor = v_is_float ? v_bits : prev_xor;
    s_num_sig = v_is_float ? num_sig_st : ns_sh;
    s_cur_hl = cur_hl;
    s_num_lower = num_lower;
  } else if (go_float) {
    v0 = v0_f;
    n_v0 = n_v0_f;
    v1 = v1_f;
    n_v1 = n_v1_f;
    s_int_val = int_val;
    s_is_float = true;
    s_max_mult = was_int ? mult : max_mult;
    s_prev_fbits = v_bits;
    s_prev_xor = was_int ? v_bits : (repeat_f ? prev_xor : nxor);
    s_num_sig = num_sig_st;
    s_cur_hl = cur_hl;
    s_num_lower = num_lower;
  } else {
    v0 = repeat_i ? 1 : (need_update ? acc.val : (2 | (negv ? 1 : 0)));
    n_v0 = (repeat_i || !need_update) ? 2 : acc.n;
    v1 = diff_mag;
    n_v1 = repeat_i ? 0 : (need_update ? ns_sh : num_sig_st);
    s_int_val = repeat_i ? int_val : val;
    s_is_float = repeat_i && is_float;
    s_max_mult = (repeat_i || !need_update) ? max_mult : mm_sh;
    s_prev_fbits = prev_fbits;
    s_prev_xor = prev_xor;
    s_num_sig = (repeat_i || !need_update) ? num_sig_st : ns_sh;
    s_cur_hl = repeat_i ? cur_hl : t_chl;
    s_num_lower = repeat_i ? num_lower : t_nl;
  }

  // inactive (padding) steps emit nothing (all widths 0) and keep state
  out.v[0] = t0;
  out.v[1] = t1;
  out.v[2] = v0;
  out.v[3] = v1;
  out.n[0] = valid ? n_t0 : 0;
  out.n[1] = valid ? n_t1 : 0;
  out.n[2] = valid ? n_v0 : 0;
  out.n[3] = valid ? n_v1 : 0;
  c.fallback = c.fallback || (valid && cv.prec) || (valid && !div_ok && !emit_tu)
               || (valid && d.overflow && !emit_tu);
  if (valid) {
    c.prev_time = t;
    c.prev_delta = new_prev_delta;
    c.tu_none = tu_none && !emit_tu;
    c.int_val = s_int_val;
    c.max_mult = s_max_mult;
    c.is_float = s_is_float;
    c.prev_fbits = s_prev_fbits;
    c.prev_xor = s_prev_xor;
    c.num_sig = s_num_sig;
    c.cur_hl = s_cur_hl;
    c.num_lower = s_num_lower;
    c.is_first = false;
  }
}

// The whole scan of series s of S over T steps: inputs scan-major
// (ts_t[i * S + s]), lanes written at lv[(i * 4 + k) * S + s] (int64
// values) and lw[...] (int32 widths), the carry read from and written to
// row-major (13, S) tables.
__host__ __device__ inline void scan_series(const i64* ts_t, const i64* vb_t,
                                            const uint8_t* valid_t, const i64* carry0,
                                            i64 T, i64 S, i64 s, i64 unit, i64 unit_nanos,
                                            bool default32, i64* lv, int32_t* lw,
                                            i64* carry_out) {
  Carry c;
  c.prev_time = carry0[C_PREV_TIME * S + s];
  c.prev_delta = carry0[C_PREV_DELTA * S + s];
  c.tu_none = carry0[C_TU_NONE * S + s] != 0;
  c.int_val = carry0[C_INT_VAL * S + s];
  c.max_mult = carry0[C_MAX_MULT * S + s];
  c.is_float = carry0[C_IS_FLOAT * S + s] != 0;
  c.prev_fbits = carry0[C_PREV_FBITS * S + s];
  c.prev_xor = carry0[C_PREV_XOR * S + s];
  c.num_sig = carry0[C_NUM_SIG * S + s];
  c.cur_hl = carry0[C_CUR_HL * S + s];
  c.num_lower = carry0[C_NUM_LOWER * S + s];
  c.is_first = carry0[C_IS_FIRST * S + s] != 0;
  c.fallback = carry0[C_FALLBACK * S + s] != 0;
  Lanes o;
  for (i64 i = 0; i < T; ++i) {
    const i64 at = i * S + s;
    step(c, o, ts_t[at], vb_t[at], valid_t[at] != 0, unit, unit_nanos, default32);
    for (int k = 0; k < 4; ++k) {
      lv[(i * 4 + k) * S + s] = o.v[k];
      lw[(i * 4 + k) * S + s] = (int32_t)o.n[k];
    }
  }
  const i64 vals[C_ROWS] = {
      c.prev_time, c.prev_delta, c.tu_none, c.int_val, c.max_mult, c.is_float,
      c.prev_fbits, c.prev_xor, c.num_sig, c.cur_hl, c.num_lower, c.is_first, c.fallback};
  for (int k = 0; k < C_ROWS; ++k) carry_out[k * S + s] = vals[k];
}

}  // namespace m3enc
