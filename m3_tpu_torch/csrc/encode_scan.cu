// The M3TSZ encode scan for Hopper (sm_90a): phase 1 of the batched
// encode, every datapoint of every series in one launch.
//
// Replaces no Pallas kernel.  It is the port's form of the reference's
// device loop lax.scan(scan_fn, carry0, xs) over jax.vmap(_encode_step)
// (m3_tpu/encoding/m3tsz_jax.py:722, step at :365), which the port ran as
// a Python loop of T steps of ~1,326 tensor ops each: at S = 100,000 x
// 720 points that is ~955,000 launches an encode pass.  One thread walks
// one series: the 13-value carry of m3tsz_torch._encode_carry0 stays in
// registers, each step reads the series' timestamp, value bits and valid
// flag of that slot from the scan-major (T, S) inputs and writes its four
// lane values and widths into the scan-major (T, 4, S) tables, so
// neighbouring threads read and write neighbouring addresses.  After the
// last step it writes the final carry.  The per-step logic is
// encode_scan.cuh's, shared with a host build that the CPU tests hold
// against the plain loop.
//
// Bound: the serial chain, then bytes.  The work needs 17 B read (8 B
// timestamp, 8 B value bits, 1 B flag) and 48 B written (four 8 B lane
// values and four 4 B widths) a datapoint: at S = 100,000, T = 720 ~4.7 GB,
// ~1.4 ms at 3.35 TB/s.  But each step is a few hundred dependent integer
// operations (the decimal search: up to seven rounds of a multiply by 10
// with round-to-nearest-even on 64-bit integers the card emulates with
// 32-bit ones, plus 64-bit divisions by the unit), and a thread's steps
// depend on each other through the carry, so the card hides one step's
// latency only across threads (S = 100,000 gives ~760 threads an SM).
// The design does nothing more about it than keep the carry in registers
// and every access coalesced: a simple kernel that is right first.
//
// Contract: ts_t, vb_t (T, S) int64 (value bits as u64), valid_t (T, S)
// bool, carry0 (13, S) int64 (flags 0/1), all contiguous; lv (T, 4, S)
// int64, lw (T, 4, S) int32, carry (13, S) int64, rows in _encode_carry0's
// order.  unit is the wire byte of the time unit and unit_nanos its
// nanoseconds (> 0); default32 selects the 36-bit default dod bucket
// (SECOND and MILLISECOND) over the 64-bit one.

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_scan.cuh"
#include "encode_scan.cuh"

namespace {

__global__ void __launch_bounds__(128)
encode_scan_kernel(const long long* __restrict__ ts_t, const long long* __restrict__ vb_t,
                   const unsigned char* __restrict__ valid_t,
                   const long long* __restrict__ carry0, long long T, long long S,
                   long long unit, long long unit_nanos, int default32, long long* lv,
                   int* lw, long long* carry) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  m3enc::scan_series((const int64_t*)ts_t, (const int64_t*)vb_t, (const uint8_t*)valid_t,
                     (const int64_t*)carry0, T, S, s, unit, unit_nanos, default32 != 0,
                     (int64_t*)lv, (int32_t*)lw, (int64_t*)carry);
}

}  // namespace

extern "C" int m3_encode_scan(const void* ts_t, const void* vb_t, const void* valid_t,
                              const void* carry0, long long T, long long S, long long unit,
                              long long unit_nanos, int default32, void* lv, void* lw,
                              void* carry, void* stream) {
  const int threads = 128;
  const long long blocks = (S + threads - 1) / threads;
  encode_scan_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)ts_t, (const long long*)vb_t, (const unsigned char*)valid_t,
      (const long long*)carry0, T, S, unit, unit_nanos, default32, (long long*)lv, (int*)lw,
      (long long*)carry);
  return (int)cudaGetLastError();
}

extern "C" const char* m3_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
