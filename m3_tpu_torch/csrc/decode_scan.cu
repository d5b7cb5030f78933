// The M3TSZ decode scan for Hopper (sm_90a): phase 1 of the batched
// decode, every datapoint slot of every series in one launch.
//
// Replaces no Pallas kernel.  It is the port's form of the reference's
// device loop lax.scan(_decode_step, ..., length=max_points)
// (m3_tpu/encoding/m3tsz_jax.py:1785, step at :1134), which the port ran
// as a Python loop of max_points steps of ~444 tensor ops each: at
// S = 100,000 x 720 points that is ~320,000 launches a decode pass.  One
// thread walks one series: the carry of m3tsz_torch._decode_carry0 stays
// in registers, each step reads its <= 4 stream words from the thread's own
// row of the padded (S, W + 16) words and one entry of the 1 MB
// value-control table through the read-only cache, and writes its lanes
// coalesced into the scan-major (P, S) tables.  After the last step it
// peeks for an EOS marker right after max_points and writes the final
// carry.  The per-step logic is decode_scan.cuh's, shared with a host
// build that the CPU tests hold against the plain loop.
//
// Two instantiations, one per tail of m3tsz_torch._decode_batch_device:
// gather (the four int32 lane tables ts_off, p1, val_off, p2 for phase 2,
// whose field extraction is kernel #2) and fused (the three value chains
// ride the scan: int64 ts and payload, uint8 meta).
//
// Bound: bytes and the serial chain.  The work needs each stream word read
// once and each lane written once: at S = 100,000, P = 720 (~148 MB of
// streams, 4 x 4 B lanes a slot) ~1.3 GB, ~0.39 ms at 3.35 TB/s.  Each
// thread's steps depend on each other (the cursor), so the card hides a
// step's latency only across threads: S = 100,000 gives ~760 threads an SM.
// Lane stores are coalesced (neighbouring threads, neighbouring series);
// word reads are not (each thread reads its own row), but a step reads
// the same few words as the one before it, so they hit L1.
//
// Contract: wpad (S, Wp) int64 (u64 bits, Wp >= 2, contiguous), nbits and
// unit0 (S,) int64, tbl (2^18,) int32; gather lanes (P, S) int32 x 4,
// fused lanes (P, S) int64, int64, uint8; carry (C, S) int64 with C = 12
// (gather) or 19 (fused), rows in _decode_carry0's order, done with the
// EOS peek folded in.

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_scan.cuh"

namespace {

template <bool FUSED>
__global__ void __launch_bounds__(128)
decode_scan_kernel(const unsigned long long* __restrict__ wpad, long long Wp,
                   const long long* __restrict__ nbits, const long long* __restrict__ unit0,
                   const int* __restrict__ tbl, long long P, long long S, void* lane0,
                   void* lane1, void* lane2, void* lane3, long long* carry) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  m3scan::scan_series<FUSED>((const uint64_t*)wpad, Wp, (const int64_t*)nbits,
                             (const int64_t*)unit0, (const int32_t*)tbl, P, S, s, lane0,
                             lane1, lane2, lane3, (int64_t*)carry);
}

}  // namespace

extern "C" int m3_decode_scan(const void* wpad, long long Wp, const void* nbits,
                              const void* unit0, const void* tbl, long long P, long long S,
                              int fused, void* lane0, void* lane1, void* lane2, void* lane3,
                              void* carry, void* stream) {
  const int threads = 128;
  const long long blocks = (S + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  if (fused) {
    decode_scan_kernel<true><<<(unsigned)blocks, threads, 0, st>>>(
        (const unsigned long long*)wpad, Wp, (const long long*)nbits,
        (const long long*)unit0, (const int*)tbl, P, S, lane0, lane1, lane2, lane3,
        (long long*)carry);
  } else {
    decode_scan_kernel<false><<<(unsigned)blocks, threads, 0, st>>>(
        (const unsigned long long*)wpad, Wp, (const long long*)nbits,
        (const long long*)unit0, (const int*)tbl, P, S, lane0, lane1, lane2, lane3,
        (long long*)carry);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* m3_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
