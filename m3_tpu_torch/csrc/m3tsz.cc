// Native host M3TSZ codec: the fast scalar encode/decode path.
//
// C++ port-of-capability of the framework's scalar codec
// (m3_tpu_torch/encoding/m3tsz.py), which is golden-validated against the
// reference stream format (src/dbnode/encoding/m3tsz/{encoder.go,
// timestamp_encoder.go,float_encoder_iterator.go,int_sig_bits_tracker.go,
// m3tsz.go} and src/dbnode/encoding/scheme.go).  The reference's hot
// scalar loop is Go; ours is this translation unit, loaded via ctypes
// (m3_tpu_torch/native/__init__.py).  It covers fixed-time-unit streams
// without annotations — the overwhelmingly common shape — and reports -2
// when it meets a stream feature it does not handle so callers fall back
// to the Python oracle.
//
// The port's copy of native/m3tsz.cc: the same source, so both packages'
// host codecs write the same bytes.  It shares no code with the card's
// codec (encoding/m3tsz_torch.py and kernels #1 and #2), which makes it
// an independent check of that path's streams.
//
// Bit-exactness contract: byte-identical output to the Python encoder for
// every supported input (tests/test_torch_native_codec.py holds both
// directions).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kMarkerOpcode = 0x100;
constexpr int kNumMarkerOpcodeBits = 9;
constexpr int kNumMarkerValueBits = 2;
constexpr int kEndOfStream = 0;

constexpr int kOpcodeZeroSig = 0x0;
constexpr int kOpcodeNonZeroSig = 0x1;
constexpr int kNumSigBits = 6;
constexpr int kOpcodeZeroValueXor = 0x0;
constexpr int kOpcodeContainedValueXor = 0x2;
constexpr int kOpcodeUncontainedValueXor = 0x3;
constexpr int kOpcodeUpdateSig = 0x1;
constexpr int kOpcodeUpdate = 0x0;
constexpr int kOpcodeNoUpdate = 0x1;
constexpr int kOpcodeUpdateMult = 0x1;
constexpr int kOpcodeNoUpdateMult = 0x0;
constexpr int kOpcodeNegative = 0x1;
constexpr int kOpcodeRepeat = 0x1;
constexpr int kOpcodeNoRepeat = 0x0;
constexpr int kOpcodeFloatMode = 0x1;
constexpr int kOpcodeIntMode = 0x0;

constexpr int kSigDiffThreshold = 3;
constexpr int kSigRepeatThreshold = 5;
constexpr int kMaxMult = 6;
constexpr int kNumMultBits = 3;

const double kMaxInt = 9223372036854775808.0;  // 2^63
const double kMinInt = -9223372036854775808.0;
const double kMaxOptInt = 1e13;
const double kMultipliers[] = {1., 1e1, 1e2, 1e3, 1e4, 1e5, 1e6};

int64_t unit_nanos(int unit) {
  switch (unit) {
    case 1: return 1000000000LL;        // SECOND
    case 2: return 1000000LL;           // MILLISECOND
    case 3: return 1000LL;              // MICROSECOND
    case 4: return 1LL;                 // NANOSECOND
    case 5: return 60LL * 1000000000LL;
    case 6: return 3600LL * 1000000000LL;
    case 7: return 86400LL * 1000000000LL;
    case 8: return 365LL * 86400LL * 1000000000LL;
    default: return 0;
  }
}

// Default dod bucket schemes (encoding/scheme.go:42-52): buckets
// 10+7bit, 110+9bit, 1110+12bit, default 1111 + 32 or 64 bits.
struct Scheme {
  int default_bits;  // 32 (s, ms) or 64 (us, ns)
};

bool scheme_for_unit(int unit, Scheme* out) {
  if (unit == 1 || unit == 2) { out->default_bits = 32; return true; }
  if (unit == 3 || unit == 4) { out->default_bits = 64; return true; }
  return false;
}

constexpr int kBucketBits[3] = {7, 9, 12};

struct OStream {
  std::vector<uint8_t> buf;
  int pos = 8;  // bits used in final byte (1..8)

  void write_bits(uint64_t v, int n) {
    if (n <= 0) return;
    if (n < 64) v &= (1ULL << n) - 1;
    while (n > 0) {
      if (pos == 8) { buf.push_back(0); pos = 0; }
      int take = 8 - pos;
      if (take > n) take = n;
      uint8_t chunk = (uint8_t)((v >> (n - take)) & ((1U << take) - 1));
      buf.back() |= (uint8_t)(chunk << (8 - pos - take));
      pos += take;
      n -= take;
    }
  }
  void write_bit(int v) { write_bits((uint64_t)(v & 1), 1); }
};

struct IStream {
  const uint8_t* data;
  int64_t nbits;
  int64_t bitpos = 0;
  bool eof = false;

  uint64_t peek(int n) {
    // caller checked bounds; an unaligned 64-bit read spans 9 bytes, so
    // accumulate in 128 bits
    int64_t start = bitpos, end = bitpos + n;
    int64_t fb = start >> 3, lb = (end + 7) >> 3;
    unsigned __int128 word = 0;
    for (int64_t i = fb; i < lb; i++) word = (word << 8) | data[i];
    int tail = (int)((lb << 3) - end);
    word >>= tail;
    uint64_t out = (uint64_t)word;
    if (n < 64) out &= (1ULL << n) - 1;
    return out;
  }
  uint64_t read(int n) {
    if (n == 0) return 0;
    if (bitpos + n > nbits) { eof = true; return 0; }
    uint64_t v = peek(n);
    bitpos += n;
    return v;
  }
  bool can(int n) const { return bitpos + n <= nbits; }
};

// Buffered bit reader for the batched path: maintains a 64-bit window
// of upcoming bits so a field read is usually two shifts, with ONE
// unaligned 8-byte refill per ~56 consumed bits (vs IStream's byte
// loop per field).  Requires >= 16 readable bytes past the stream end
// (refill loads 8 bytes at the current byte position, which can sit at
// the last stream byte; the ctypes binding pads the batch buffer).
struct BufferedIStream {
  static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
                "load+bswap word reads assume a little-endian host");
  const uint8_t* data;
  int64_t nbits;
  int64_t bitpos = 0;
  bool eof = false;
  uint64_t buf = 0;   // upcoming bits, left-aligned (MSB first)
  int avail = 0;      // valid bits in buf

  inline void refill() {
    // reload the full window at the current position: byte-aligned load
    // of 8 bytes starting at bitpos>>3, discard the sub-byte offset
    int64_t byte = bitpos >> 3;
    int off = (int)(bitpos & 7);
    uint64_t w;
    std::memcpy(&w, data + byte, 8);
    w = __builtin_bswap64(w);
    buf = w << off;
    avail = 64 - off;
  }

  uint64_t peek(int n) {  // n <= 56: refill guarantees >= 57 bits
    if (n > avail) refill();
    return buf >> (64 - n);
  }
  uint64_t read(int n) {
    if (n == 0) return 0;
    if (bitpos + n > nbits) { eof = true; return 0; }
    if (n > 56) {
      // A refill at byte offset 7 yields only 57 valid bits, so wide
      // reads (57..64, e.g. full XOR windows and 64-bit dods) split
      // into two halves of <= 32 bits each; also dodges the n==64
      // shift UB.
      int half = n / 2;
      uint64_t hi = read_small(half);
      uint64_t lo = read_small(n - half);
      return (hi << (n - half)) | lo;
    }
    return read_small(n);
  }
  inline uint64_t read_small(int n) {  // n in [1, 56]
    if (n > avail) refill();
    uint64_t v = buf >> (64 - n);
    buf <<= n;
    avail -= n;
    bitpos += n;
    return v;
  }
  bool can(int n) const { return bitpos + n <= nbits; }
};

// Run fn(lo, hi) over [0, B) split across up to nthreads OS threads.
template <typename Fn>
void parallel_for(long B, int nthreads, Fn fn) {
  if (nthreads <= 1 || B <= 1) { fn(0, B); return; }
  if (nthreads > B) nthreads = (int)B;
  std::vector<std::thread> pool;
  long chunk = (B + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; t++) {
    long lo = t * chunk, hi = lo + chunk < B ? lo + chunk : B;
    if (lo >= hi) break;
    pool.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

inline int num_sig(uint64_t v) { return v ? 64 - __builtin_clzll(v) : 0; }

inline void lead_trail(uint64_t v, int* lead, int* trail) {
  if (v == 0) { *lead = 64; *trail = 0; return; }
  *lead = __builtin_clzll(v);
  *trail = __builtin_ctzll(v);
}

inline uint64_t f2b(double v) { uint64_t b; std::memcpy(&b, &v, 8); return b; }
inline double b2f(uint64_t b) { double v; std::memcpy(&v, &b, 8); return v; }

// Go's uint64(int64(val)): cvttsd2si semantics (m3tsz.py
// _float_to_uint64_via_int64).
inline uint64_t f2u_via_i64(double val) {
  if (std::isnan(val) || val >= kMaxInt || val < kMinInt) return 1ULL << 63;
  return (uint64_t)(int64_t)val;
}

// float -> (scaled int, multiplier, is_float); reference m3tsz.go:78-118.
void convert_to_int_float(double v, int cur_max_mult, double* out_val,
                          int* out_mult, bool* out_is_float) {
  if (cur_max_mult == 0 && v < kMaxInt) {
    double r = std::fmod(v, 1.0);
    if (r == 0) { *out_val = v - r; *out_mult = 0; *out_is_float = false; return; }
  }
  double val = v * kMultipliers[cur_max_mult];
  double sign = 1.0;
  if (v < 0) { sign = -1.0; val = -val; }
  int mult = cur_max_mult;
  while (mult <= kMaxMult && val < kMaxOptInt) {
    double i;
    double r = std::modf(val, &i);
    if (r == 0) { *out_val = sign * i; *out_mult = mult; *out_is_float = false; return; }
    if (r < 0.1) {
      if (std::nextafter(val, 0.0) <= i) {
        *out_val = sign * i; *out_mult = mult; *out_is_float = false; return;
      }
    } else if (r > 0.9) {
      double nxt = i + 1;
      if (std::nextafter(val, nxt) >= nxt) {
        *out_val = sign * nxt; *out_mult = mult; *out_is_float = false; return;
      }
    }
    val *= 10.0;
    mult += 1;
  }
  *out_val = v; *out_mult = 0; *out_is_float = true;
}

struct FloatXOR {
  uint64_t prev_xor = 0, prev_bits = 0;

  void write_full(OStream& os, uint64_t bits) {
    prev_bits = bits; prev_xor = bits;
    os.write_bits(bits, 64);
  }
  void write_next(OStream& os, uint64_t bits) {
    uint64_t x = prev_bits ^ bits;
    if (x == 0) {
      os.write_bits(kOpcodeZeroValueXor, 1);
    } else {
      int pl, pt, cl, ct;
      lead_trail(prev_xor, &pl, &pt);
      lead_trail(x, &cl, &ct);
      if (cl >= pl && ct >= pt) {
        os.write_bits(kOpcodeContainedValueXor, 2);
        os.write_bits(x >> pt, 64 - pl - pt);
      } else {
        os.write_bits(kOpcodeUncontainedValueXor, 2);
        os.write_bits((uint64_t)cl, 6);
        int nm = 64 - cl - ct;
        os.write_bits((uint64_t)(nm - 1), 6);
        os.write_bits(x >> ct, nm);
      }
    }
    prev_xor = x; prev_bits = bits;
  }
  template <typename IS>
  void read_full(IS& is) {
    prev_bits = is.read(64); prev_xor = prev_bits;
  }
  template <typename IS>
  void read_next(IS& is) {
    uint64_t cb = is.read(1);
    if (cb == kOpcodeZeroValueXor) { prev_xor = 0; return; }
    cb = (cb << 1) | is.read(1);
    if (cb == kOpcodeContainedValueXor) {
      int pl, pt;
      lead_trail(prev_xor, &pl, &pt);
      int nm = 64 - pl - pt;
      uint64_t bits = is.read(nm);
      prev_xor = bits << pt;
      prev_bits ^= prev_xor;
      return;
    }
    uint64_t packed = is.read(12);
    int nl = (int)((packed >> 6) & 0x3F);
    int nm = (int)(packed & 0x3F) + 1;
    uint64_t bits = is.read(nm);
    int nt = 64 - nl - nm;
    prev_xor = bits << nt;
    prev_bits ^= prev_xor;
  }
};

struct SigTracker {
  int sig = 0, cur_highest_lower = 0, num_lower = 0;

  void write_diff(OStream& os, uint64_t bits, bool neg) {
    os.write_bit(neg ? kOpcodeNegative : 0);
    if (sig < 64 && sig > 0) bits &= (1ULL << sig) - 1;
    os.write_bits(bits, sig);
  }
  void write_sig(OStream& os, int s) {
    if (sig != s) {
      os.write_bit(kOpcodeUpdateSig);
      if (s == 0) {
        os.write_bit(kOpcodeZeroSig);
      } else {
        os.write_bit(kOpcodeNonZeroSig);
        os.write_bits((uint64_t)(s - 1), kNumSigBits);
      }
    } else {
      os.write_bit(0);
    }
    sig = s;
  }
  int track(int s) {
    int ns = sig;
    if (s > sig) {
      ns = s;
    } else if (sig - s >= kSigDiffThreshold) {
      if (num_lower == 0) cur_highest_lower = s;
      else if (s > cur_highest_lower) cur_highest_lower = s;
      if (++num_lower >= kSigRepeatThreshold) {
        ns = cur_highest_lower;
        num_lower = 0;
      }
    } else {
      num_lower = 0;
    }
    return ns;
  }
};

void write_dod_bucketed(OStream& os, int64_t dod, int default_bits) {
  if (dod == 0) { os.write_bits(0, 1); return; }
  int opcode = 0, opcode_bits = 1;
  for (int i = 0; i < 3; i++) {
    opcode = (1 << (i + 1)) | opcode;
    opcode_bits += 1;
    int nbits = kBucketBits[i];
    int64_t lo = -(1LL << (nbits - 1)), hi = (1LL << (nbits - 1)) - 1;
    if (dod >= lo && dod <= hi) {
      os.write_bits((uint64_t)opcode, opcode_bits);
      os.write_bits((uint64_t)dod & ((1ULL << nbits) - 1), nbits);
      return;
    }
  }
  os.write_bits((uint64_t)(opcode | 1), opcode_bits);
  if (default_bits < 64)
    os.write_bits((uint64_t)dod & ((1ULL << default_bits) - 1), default_bits);
  else
    os.write_bits((uint64_t)dod, 64);
}

inline int64_t sign_extend(uint64_t v, int n) {
  uint64_t sb = 1ULL << (n - 1);
  return (int64_t)((v ^ sb) - sb);
}

}  // namespace

extern "C" {

// Encode n datapoints; returns bytes written, -1 on small buffer, -2 on
// unsupported input (caller falls back to the Python codec).
long m3tsz_encode(const int64_t* ts, const double* vals, long n,
                  int64_t start, int unit, uint8_t* out, long out_cap) {
  Scheme scheme;
  if (!scheme_for_unit(unit, &scheme)) return -2;
  int64_t u_nanos = unit_nanos(unit);
  if (n <= 0) return 0;
  // initial_time_unit (timestamp_encoder.go:248-259): misaligned start
  // would need a time-unit marker mid-stream — Python path handles it.
  if (start % u_nanos != 0) return -2;

  OStream os;
  FloatXOR fx;
  SigTracker st;
  double int_val = 0.0;
  int max_mult = 0;
  bool is_float = false;
  int64_t prev_time = start, prev_delta = 0;

  for (long k = 0; k < n; k++) {
    // -- timestamp (timestamp_encoder.go:72-246) --
    if (k == 0) os.write_bits((uint64_t)prev_time, 64);
    int64_t delta = ts[k] - prev_time;
    prev_time = ts[k];
    int64_t dod_n = delta - prev_delta;
    int64_t dod = dod_n >= 0 ? dod_n / u_nanos : -((-dod_n) / u_nanos);
    // Sub-unit precision needs a time-unit switch (markers) — the
    // Python codec's path.  Truncating here would silently round the
    // timestamp (the round-4 flush-precision bug).
    if (dod * u_nanos != dod_n) return -2;
    if (scheme.default_bits == 32 && (dod < -(1LL << 31) || dod >= (1LL << 31)))
      return -2;  // overflow error in the reference
    write_dod_bucketed(os, dod, scheme.default_bits);
    prev_delta = delta;

    // -- value (encoder.go:112-250) --
    double v = vals[k];
    if (k == 0) {
      double val; int mult; bool isf;
      convert_to_int_float(v, 0, &val, &mult, &isf);
      if (isf) {
        os.write_bit(kOpcodeFloatMode);
        fx.write_full(os, f2b(v));
        is_float = true;
        max_mult = mult;
      } else {
        os.write_bit(kOpcodeIntMode);
        int_val = val;
        bool neg_diff = true;
        if (val < 0) { neg_diff = false; val = -val; }
        uint64_t vb = f2u_via_i64(val);
        int sig = num_sig(vb);
        // _write_int_sig_mult(sig, mult, false)
        st.write_sig(os, sig);
        if (mult > max_mult) {
          os.write_bit(kOpcodeUpdateMult);
          os.write_bits((uint64_t)mult, kNumMultBits);
          max_mult = mult;
        } else {
          os.write_bit(kOpcodeNoUpdateMult);
        }
        st.write_diff(os, vb, neg_diff);
      }
    } else {
      double val; int mult; bool isf;
      convert_to_int_float(v, max_mult, &val, &mult, &isf);
      double val_diff = 0.0;
      if (!isf) val_diff = int_val - val;
      if (isf || val_diff >= kMaxInt || val_diff <= kMinInt) {
        // _write_float_val
        uint64_t bits = f2b(val);
        if (!is_float) {
          os.write_bit(kOpcodeUpdate);
          os.write_bit(kOpcodeNoRepeat);
          os.write_bit(kOpcodeFloatMode);
          fx.write_full(os, bits);
          is_float = true;
          max_mult = mult;
        } else if (bits == fx.prev_bits) {
          os.write_bit(kOpcodeUpdate);
          os.write_bit(kOpcodeRepeat);
        } else {
          os.write_bit(kOpcodeNoUpdate);
          fx.write_next(os, bits);
        }
      } else {
        // _write_int_val
        if (val_diff == 0 && isf == is_float && mult == max_mult) {
          os.write_bit(kOpcodeUpdate);
          os.write_bit(kOpcodeRepeat);
        } else {
          bool neg = false;
          double vd = val_diff;
          if (vd < 0) { neg = true; vd = -vd; }
          uint64_t diff_bits = (uint64_t)vd;
          int sig = num_sig(diff_bits);
          int new_sig = st.track(sig);
          bool float_changed = isf != is_float;
          if (mult > max_mult || st.sig != new_sig || float_changed) {
            os.write_bit(kOpcodeUpdate);
            os.write_bit(kOpcodeNoRepeat);
            os.write_bit(kOpcodeIntMode);
            // _write_int_sig_mult(new_sig, mult, float_changed)
            st.write_sig(os, new_sig);
            if (mult > max_mult) {
              os.write_bit(kOpcodeUpdateMult);
              os.write_bits((uint64_t)mult, kNumMultBits);
              max_mult = mult;
            } else if (st.sig == new_sig && max_mult == mult && float_changed) {
              os.write_bit(kOpcodeUpdateMult);
              os.write_bits((uint64_t)max_mult, kNumMultBits);
            } else {
              os.write_bit(kOpcodeNoUpdateMult);
            }
            st.write_diff(os, diff_bits, neg);
            is_float = false;
          } else {
            os.write_bit(kOpcodeNoUpdate);
            st.write_diff(os, diff_bits, neg);
          }
          int_val = val;
        }
      }
    }
  }

  // Finalize: head bytes + tail (last byte's used bits + EOS marker).
  if (os.buf.empty()) return 0;
  OStream tail;
  tail.write_bits((uint64_t)(os.buf.back() >> (8 - os.pos)), os.pos);
  tail.write_bits(kMarkerOpcode, kNumMarkerOpcodeBits);
  tail.write_bits(kEndOfStream, kNumMarkerValueBits);
  long total = (long)(os.buf.size() - 1 + tail.buf.size());
  if (total > out_cap) return -1;
  std::memcpy(out, os.buf.data(), os.buf.size() - 1);
  std::memcpy(out + os.buf.size() - 1, tail.buf.data(), tail.buf.size());
  return total;
}

}  // extern "C"

// Decode a stream; returns count, -1 on small buffer, -2 unsupported
// (annotation/time-unit markers), -3 corrupt.  Trace pointers may be null.
template <typename IS>
static long decode_impl(const uint8_t* data, long nbytes, int default_unit,
                        int64_t* out_ts, double* out_vals, uint8_t* out_isf,
                        uint8_t* out_sig, uint8_t* out_mult,
                        double* out_intval, long cap) {
  if (nbytes == 0) return 0;
  IS is{data, (int64_t)nbytes * 8};
  Scheme scheme;

  int64_t prev_time = 0, prev_delta = 0;
  int unit = 0;
  FloatXOR fx;
  double int_val = 0.0;
  int mult = 0, sig = 0;
  bool is_float = false;
  long count = 0;

  for (;;) {
    bool first = (prev_time == 0);
    int64_t nt = 0;
    if (first) {
      nt = sign_extend(is.read(64), 64);
      if (is.eof) return -3;
      int64_t u_nanos = unit_nanos(default_unit);
      unit = (u_nanos != 0 && nt % u_nanos == 0) ? default_unit : 0;
    }
    // marker check (11 bits)
    if (is.can(kNumMarkerOpcodeBits + kNumMarkerValueBits)) {
      uint64_t peek = is.peek(kNumMarkerOpcodeBits + kNumMarkerValueBits);
      if ((peek >> kNumMarkerValueBits) == kMarkerOpcode) {
        int marker = (int)(peek & 0x3);
        if (marker == kEndOfStream) return count;
        return -2;  // annotation / time-unit change: python fallback
      }
    }
    if (!scheme_for_unit(unit, &scheme)) return -2;
    int64_t u_nanos = unit_nanos(unit);
    // dod
    int64_t dod;
    uint64_t cb = is.read(1);
    if (cb == 0) {
      dod = 0;
    } else {
      int opcode = 1;
      int matched = -1;
      for (int i = 0; i < 3; i++) {
        cb = (cb << 1) | is.read(1);
        opcode = (opcode << 1);
        uint64_t want = ((1ULL << (i + 2)) - 2);  // 10, 110, 1110 pattern
        if (cb == want) { matched = i; break; }
      }
      if (matched >= 0) {
        int nbits = kBucketBits[matched];
        dod = sign_extend(is.read(nbits), nbits) * u_nanos;
      } else {
        int nbits = scheme.default_bits;
        dod = sign_extend(is.read(nbits), nbits) * u_nanos;
      }
    }
    if (is.eof) return -3;
    prev_delta += dod;
    prev_time = first ? nt + prev_delta : prev_time + prev_delta;

    // value
    if (first) {
      if (is.read(1) == kOpcodeFloatMode) {
        fx.read_full(is);
        is_float = true;
      } else {
        // _read_int_sig_mult + diff
        if (is.read(1) == kOpcodeUpdateSig) {
          if (is.read(1) == kOpcodeZeroSig) sig = 0;
          else sig = (int)is.read(kNumSigBits) + 1;
        }
        if (is.read(1) == kOpcodeUpdateMult) {
          mult = (int)is.read(kNumMultBits);
          if (mult > kMaxMult) return -3;
        }
        goto read_diff;
      }
    } else {
      if (is.read(1) == kOpcodeUpdate) {
        if (is.read(1) == kOpcodeRepeat) goto emit;
        if (is.read(1) == kOpcodeFloatMode) {
          fx.read_full(is);
          is_float = true;
        } else {
          if (is.read(1) == kOpcodeUpdateSig) {
            if (is.read(1) == kOpcodeZeroSig) sig = 0;
            else sig = (int)is.read(kNumSigBits) + 1;
          }
          if (is.read(1) == kOpcodeUpdateMult) {
            mult = (int)is.read(kNumMultBits);
            if (mult > kMaxMult) return -3;
          }
          is_float = false;
          goto read_diff;
        }
      } else if (is_float) {
        fx.read_next(is);
      } else {
        goto read_diff;
      }
    }
    goto emit;

  read_diff:
    if (sig == 64) {
      double sgn = is.read(1) == kOpcodeNegative ? 1.0 : -1.0;
      int_val += sgn * (double)is.read(64);
    } else {
      uint64_t bits = is.read(sig + 1);
      double sgn = -1.0;
      if ((bits >> sig) == kOpcodeNegative) {
        sgn = 1.0;
        bits ^= 1ULL << sig;
      }
      int_val += sgn * (double)bits;
    }

  emit:
    if (is.eof) return -3;
    if (count >= cap) return -1;
    out_ts[count] = prev_time;
    out_vals[count] = is_float ? b2f(fx.prev_bits)
                               : (mult == 0 ? int_val : int_val / kMultipliers[mult]);
    if (out_isf) out_isf[count] = is_float ? 1 : 0;
    if (out_sig) out_sig[count] = (uint8_t)sig;
    if (out_mult) out_mult[count] = (uint8_t)mult;
    if (out_intval) out_intval[count] = int_val;
    count++;
  }
}

extern "C" long m3tsz_decode(const uint8_t* data, long nbytes, int default_unit,
                             int64_t* out_ts, double* out_vals, long cap) {
  return decode_impl<IStream>(data, nbytes, default_unit, out_ts, out_vals,
                              nullptr, nullptr, nullptr, nullptr, cap);
}

// Debug trace: per-element (is_float, sig, mult, int_val) for parity
// triage against the Python oracle.  Not part of the public surface.
extern "C" long m3tsz_decode_trace(const uint8_t* data, long nbytes,
                                   int default_unit, int64_t* out_ts,
                                   double* out_vals, uint8_t* out_isf,
                                   uint8_t* out_sig, uint8_t* out_mult,
                                   double* out_intval, long cap) {
  return decode_impl<IStream>(data, nbytes, default_unit, out_ts, out_vals,
                              out_isf, out_sig, out_mult, out_intval, cap);
}

// Batched decode: B streams concatenated in `data` at
// [offsets[i], offsets[i+1]) byte ranges.  The buffer MUST stay readable
// for >= 16 bytes past offsets[B] (BufferedIStream refills with 8-byte
// loads at arbitrary byte positions); the Python binding pads.  Series i's datapoints land in
// out_ts/out_vals[i*max_points ...]; counts[i] gets the datapoint count
// or the negative status (-1 cap, -2 unsupported, -3 corrupt).  Returns
// the number of series with negative status.  `nthreads` <= 1 runs
// inline; more splits series ranges across OS threads (the batch is
// embarrassingly parallel).
extern "C" long m3tsz_decode_batch(const uint8_t* data, const int64_t* offsets,
                                   long B, int default_unit, int64_t* out_ts,
                                   double* out_vals, long max_points,
                                   int64_t* counts, int nthreads) {
  parallel_for(B, nthreads, [=](long lo, long hi) {
    for (long i = lo; i < hi; i++) {
      counts[i] = decode_impl<BufferedIStream>(
          data + offsets[i], offsets[i + 1] - offsets[i], default_unit,
          out_ts + i * max_points, out_vals + i * max_points, nullptr,
          nullptr, nullptr, nullptr, max_points);
    }
  });
  long bad = 0;
  for (long i = 0; i < B; i++) bad += counts[i] < 0;
  return bad;
}

// Batched encode: series i is ts/vals[i*T .. i*T+ns[i]) started at
// starts[i]; its stream is written at out[i*stride] and lens[i] gets the
// byte length or negative status (-1 stride too small, -2 unsupported —
// callers fall back per series).  Returns the number of negative lens.
extern "C" long m3tsz_encode_batch(const int64_t* ts, const double* vals,
                                   const int64_t* ns, long B, long T,
                                   const int64_t* starts, int unit,
                                   uint8_t* out, long stride, int64_t* lens,
                                   int nthreads) {
  parallel_for(B, nthreads, [=](long lo, long hi) {
    for (long i = lo; i < hi; i++) {
      lens[i] = m3tsz_encode(ts + i * T, vals + i * T, ns[i], starts[i], unit,
                             out + i * stride, stride);
    }
  });
  long bad = 0;
  for (long i = 0; i < B; i++) bad += lens[i] < 0;
  return bad;
}
