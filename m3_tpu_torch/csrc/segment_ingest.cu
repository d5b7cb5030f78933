// Aggregator segment ingest (per-slot sum, count, sum of squares) for
// Hopper (sm_90a).
//
// Replaces: m3_tpu/parallel/pallas_ingest.py, _ingest_kernel (launched by
// _segment_call, public as pallas_segment_ingest and, with the third
// output, pallas_segment_moments).  The TPU kernel builds (SLAB, TILE)
// hit masks of every batch slab against every slot tile, O(N * C / TILE)
// vector work, because Mosaic has no scatter.  Hopper has atomics in L2:
// one thread per (slot, value) point adds its value into sum[slot], 1
// into the int32 count[slot] and, in the moments form (with_sq), v*v
// into sq[slot].  Slots outside [0, C) drop; negative slots never wrap.
// A NaN value poisons only its own slot, as in the TPU kernel.
//
// Types: int32, int64, float32 and float64 values.  Integer lanes wrap
// exactly as the reference's two's-complement sums do (int64 goes
// through the unsigned long long atomicAdd; v*v is formed unsigned), so
// they are exact in any order.  Float lanes depend on the order of the
// atomics when two points of one launch share a slot: the result can
// differ from run to run in the last bits.  The arena's traffic sends
// each series once per scrape batch, so each output slot receives at
// most one value per launch (0 + v is exact) and the arena's float lanes
// are exact there too.  A deterministic form is later work.
//
// Bound: memory.  The call reads N * (4 + sizeof(T)) bytes of slots and
// values and writes the C outputs; the arena calls it with fresh (C,)
// accumulators each launch, so at N = 10^6 points, C = 2^21 slots, f64
// values it moves 12 MB in and 42 MB out (the wrapper's zeroing), about
// 16 us at 3.35 TB/s.  Reads coalesce (thread i reads point i); the
// atomics scatter over 16 MB of f64 sums, most of which fit the 50 MB L2.
//
// Contract: outputs zeroed by the caller; slots int32 (N,), values (N,)
// of the named dtype, sum and sq (C,) of that dtype, count (C,) int32,
// all contiguous; sq may be null (the sum/count form).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
struct Acc;

template <>
struct Acc<int> {
  __device__ static void add(int* p, int v) { atomicAdd(p, v); }
  __device__ static int sq(int v) {
    return (int)((unsigned)v * (unsigned)v);  // wraps like int32 v*v
  }
};

template <>
struct Acc<long long> {
  __device__ static void add(long long* p, long long v) {
    atomicAdd((unsigned long long*)p, (unsigned long long)v);
  }
  __device__ static long long sq(long long v) {
    return (long long)((unsigned long long)v * (unsigned long long)v);
  }
};

template <>
struct Acc<float> {
  __device__ static void add(float* p, float v) { atomicAdd(p, v); }
  __device__ static float sq(float v) { return v * v; }
};

template <>
struct Acc<double> {
  __device__ static void add(double* p, double v) { atomicAdd(p, v); }
  __device__ static double sq(double v) { return v * v; }
};

template <typename T>
__global__ void segment_ingest_kernel(const int* __restrict__ slots,
                                      const T* __restrict__ values,
                                      T* __restrict__ sum, int* __restrict__ cnt,
                                      T* __restrict__ sq, long long n,
                                      long long C) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long s = slots[i];
    if (s < 0 || s >= C) continue;
    const T v = values[i];
    Acc<T>::add(sum + s, v);
    atomicAdd(cnt + s, 1);
    if (sq != nullptr) Acc<T>::add(sq + s, Acc<T>::sq(v));
  }
}

template <typename T>
int launch(const void* slots, const void* values, void* sum, void* cnt,
           void* sq, long long n, long long C, cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  segment_ingest_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      (const int*)slots, (const T*)values, (T*)sum, (int*)cnt, (T*)sq, n, C);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 int32, 1 int64, 2 float32, 3 float64.  Returns a cudaError_t
// (cudaErrorInvalidValue for an unknown dtype).
extern "C" int m3_segment_ingest(const void* slots, const void* values,
                                 void* sum, void* cnt, void* sq, long long n,
                                 long long C, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<int>(slots, values, sum, cnt, sq, n, C, st);
    case 1: return launch<long long>(slots, values, sum, cnt, sq, n, C, st);
    case 2: return launch<float>(slots, values, sum, cnt, sq, n, C, st);
    case 3: return launch<double>(slots, values, sum, cnt, sq, n, C, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* m3_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
