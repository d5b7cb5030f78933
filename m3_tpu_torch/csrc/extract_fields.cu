// M3TSZ decode phase-2 field extraction for Hopper (sm_90a).
//
// Replaces: m3_tpu/parallel/pallas_decode.py, _gather_kernel (launched by
// _gather3_pallas, public as extract_fields / extract_fields_t), together
// with the _funnel64 shift that runs outside it.  The TPU kernel gathers
// the three u32 words under each bit offset as masked sums over word
// tiles, because Mosaic has no per-lane gather, and funnels outside the
// kernel because Mosaic has no 64-bit integers.  Here each lane loads the
// two u64 words under its offset, funnel-shifts them and right-aligns the
// field: the semantics of extract_fields64_t, clipping included (word
// index clamp(off >> 6, 0, W - 2); width 0 -> 0; width 64 or outside
// [0, 64] -> the whole window).
//
// Bound: memory.  Per lane it reads a 4-byte offset and a 4-byte width and
// writes an 8-byte field; the W x S stream words are read once between
// all lanes: at S = 100000, P = 720 (F = 2P lanes) and ~270 words per
// stream ~2.5 GB, ~0.75 ms at 3.35 TB/s.
//
// What held the first design (one thread per lane, neighbouring threads on
// neighbouring series at one field) at half that rate: its two word loads
// land in as many rows of the (W, S) array as the warp has series, so each
// 8-byte word costs a 32-byte sector of its own and one L1 wavefront per
// thread, and every word is loaded again by each of the ~4 fields that
// read it; a 64-bit modulo a lane found the series.
//
// This design: one thread per series (neighbouring threads on neighbouring
// series, so offsets, widths and fields stay coalesced) walks that series'
// fields in chunks of FC fields of each half of F (the decoder's ts_off
// rows, then its val_off rows: the chunk holds the same points' two
// fields).  For each chunk the thread stages the words its fields need,
// from the chunk's lowest word index up to NW words, into its own column
// of shared memory with cp.async, so each stream word crosses from L2 about
// once and is then read from shared memory by every field that needs it;
// the next chunk's words load while this chunk extracts (double
// buffering).  A lane whose two words lie outside the staged window
// (offsets that fall, jump or run past the words; a chunk wider than NW
// words) reads them from global memory in the same kernel: the result
// never depends on which way a lane went.  Offsets and widths are read
// once and fields written once, so they go with evict-first cache hints
// (__ldcs, __stcs) and leave L2 to the words.  Blocks split the chunks of
// F (grid y) into many short blocks, so that the last wave is a small
// share of the run.  FC, NW, the hints and the split were chosen by
// timing variants on the card at the codec shape.
//
// Contract: words_t (W, S) int64 (u64 bits), offs and widths (F, S) int32,
// out (F, S) int64; all contiguous; W >= 2 (the decoder pads 16 words).

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int TPB = 128;  // threads (series) a block
constexpr int FC = 4;     // fields of each half a chunk
constexpr int NW = 8;     // words of a series' staged window

typedef unsigned long long u64;

__device__ __forceinline__ u64 field_bits(u64 wa, u64 wb, int off, int wd) {
  const unsigned r = (unsigned)off & 63u;
  const u64 big = r ? (wa << r) | (wb >> (64u - r)) : wa;
  const unsigned width = (wd < 0 || wd > 64) ? 64u : (unsigned)wd;
  return width == 0u ? 0ull : big >> (64u - width);
}

// field j (0..2FC) of chunk c: j < FC in the first half, else the second
// half's (when F is even); -1 past the half's end
__device__ __forceinline__ long long field_of(long long c, int j, long long H, int halves) {
  long long f = c * FC + (j % FC);
  if (f >= H || (j >= FC && halves < 2)) return -1;
  return j >= FC ? f + H : f;
}

__global__ void __launch_bounds__(TPB)
extract_fields_kernel(const u64* __restrict__ words, const int* __restrict__ offs,
                      const int* __restrict__ widths, u64* __restrict__ out, long long W,
                      long long S, long long H, int halves, long long nch,
                      long long chunks_per_y) {
  __shared__ u64 win[2][NW][TPB];
  const int t = threadIdx.x;
  const long long s = (long long)blockIdx.x * TPB + t;
  const long long c0 = (long long)blockIdx.y * chunks_per_y;
  const long long c1 = c0 + chunks_per_y < nch ? c0 + chunks_per_y : nch;
  if (s >= S || c0 >= c1) return;  // no barrier below: threads are independent

  int off_cur[2 * FC], off_nxt[2 * FC];
  long long lo_cur = 0, lo_nxt = 0;
  int n_cur = 0, n_nxt = 0;

  // read chunk c's offsets, stage its window into buffer b
  auto prepare = [&](long long c, int* o, int b, long long& lo, int& n) {
    long long mn = W, mx = 0;
#pragma unroll
    for (int j = 0; j < 2 * FC; ++j) {
      const long long f = field_of(c, j, H, halves);
      o[j] = f >= 0 ? __ldcs(offs + f * S + s) : 0;
      if (f >= 0) {
        long long w = (long long)(o[j] >> 6);  // arithmetic, as the i32 reference
        w = w < 0 ? 0 : (w > W - 2 ? W - 2 : w);
        mn = w < mn ? w : mn;
        mx = w + 1 > mx ? w + 1 : mx;
      }
    }
    lo = mn;
    const long long hi = mx < lo + NW - 1 ? mx : lo + NW - 1;
    n = (int)(hi - lo + 1);
#pragma unroll
    for (int k = 0; k < NW; ++k)
      if (k < n) __pipeline_memcpy_async(&win[b][k][t], words + (lo + k) * S + s, 8);
    __pipeline_commit();
  };

  int buf = 0;
  prepare(c0, off_cur, buf, lo_cur, n_cur);
  for (long long c = c0; c < c1; ++c) {
    if (c + 1 < c1) {
      prepare(c + 1, off_nxt, buf ^ 1, lo_nxt, n_nxt);
      __pipeline_wait_prior(1);  // this chunk's window has landed
    } else {
      __pipeline_wait_prior(0);
    }
    int wd[2 * FC];
#pragma unroll
    for (int j = 0; j < 2 * FC; ++j) {
      const long long f = field_of(c, j, H, halves);
      wd[j] = f >= 0 ? __ldcs(widths + f * S + s) : 0;
    }
#pragma unroll
    for (int j = 0; j < 2 * FC; ++j) {
      const long long f = field_of(c, j, H, halves);
      if (f < 0) continue;
      const int off = off_cur[j];
      long long w = (long long)(off >> 6);
      w = w < 0 ? 0 : (w > W - 2 ? W - 2 : w);
      const long long rel = w - lo_cur;
      u64 wa, wb;
      if (rel + 1 < n_cur) {
        wa = win[buf][rel][t];
        wb = win[buf][rel + 1][t];
      } else {
        wa = __ldg(words + w * S + s);
        wb = __ldg(words + (w + 1) * S + s);
      }
      __stcs(out + f * S + s, field_bits(wa, wb, off, wd[j]));
    }
#pragma unroll
    for (int j = 0; j < 2 * FC; ++j) off_cur[j] = off_nxt[j];
    lo_cur = lo_nxt;
    n_cur = n_nxt;
    buf ^= 1;
  }
}

}  // namespace

extern "C" int m3_extract_fields64_t(const void* words_t, const void* offs,
                                     const void* widths, void* out,
                                     long long W, long long F, long long S,
                                     void* stream) {
  if (F * S == 0) return 0;
  const int halves = F % 2 == 0 ? 2 : 1;
  const long long H = F / halves;
  const long long nch = (H + FC - 1) / FC;
  const long long gx = (S + TPB - 1) / TPB;
  // split the chunks over grid y until there are ~32768 blocks
  long long gy = (32768 + gx - 1) / gx;
  gy = gy < 1 ? 1 : (gy > nch ? nch : gy);
  const long long per_y = (nch + gy - 1) / gy;
  gy = (nch + per_y - 1) / per_y;
  extract_fields_kernel<<<dim3((unsigned)gx, (unsigned)gy), TPB, 0, (cudaStream_t)stream>>>(
      (const u64*)words_t, (const int*)offs, (const int*)widths, (u64*)out, W, S, H, halves,
      nch, per_y);
  return (int)cudaGetLastError();
}

extern "C" const char* m3_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
