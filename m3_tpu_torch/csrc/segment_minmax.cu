// Aggregator segment min/max (per-slot minimum and maximum) for Hopper
// (sm_90a).
//
// Replaces: m3_tpu/parallel/pallas_ingest.py, _minmax_kernel (public as
// pallas_segment_minmax).  The TPU kernel reduces (SLAB, TILE) hit masks
// of every batch slab against every slot tile, O(N * C / TILE) work,
// because Mosaic has no scatter.  Here one thread per (slot, value)
// point does one atomic min and one atomic max on its slot.  Slots
// outside [0, C) drop; negative slots never wrap.  Empty slots keep the
// identities the caller filled in (+-inf, or the integer extremes).
//
// Integers use the signed 32- and 64-bit atomicMin / atomicMax.  Floats
// have no native atomic min/max, so they ride the integer atomics on
// their bits: a value with the sign bit clear orders like a signed
// integer of its bits, a value with the sign bit set orders backwards
// like an unsigned integer of its bits.  So max is a signed atomicMax
// for sign-clear values and an unsigned atomicMin for sign-set ones (min
// the mirror), and both meet correctly across signs.  This is IEEE's
// total order: -0 < +0, so a slot holding both gets min -0 and max +0 in
// any order, which is what the reference's min/max reductions return.  A
// NaN makes both its slot's min and max NaN (the reference's jnp.min /
// jnp.max propagate it): every NaN is written as the one NaN that wins
// its side of the order (+NaN, bits 0x7ff8..., above +inf for max; -NaN,
// bits 0xfff8..., below -inf for min) and, once in, no value displaces
// it.  The result does not depend on the order of the atomics.
//
// Bound: memory.  The call reads N * (4 + sizeof(T)) bytes and writes two
// (C,) outputs; at N = 10^6, C = 2^21, 64-bit values that is 12 MB in and
// 34 MB out (the wrapper's identity fill), about 14 us at 3.35 TB/s.
// Reads coalesce; the atomics scatter over 2 x 16 MB, inside the 50 MB L2.
//
// Contract: mn and mx (C,) of the value dtype filled with the
// identities by the caller; slots int32 (N,), values (N,); all
// contiguous.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
struct MinMax;

template <>
struct MinMax<int> {
  __device__ static void apply(int* mn, int* mx, int v) {
    atomicMin(mn, v);
    atomicMax(mx, v);
  }
};

template <>
struct MinMax<long long> {
  __device__ static void apply(long long* mn, long long* mx, long long v) {
    atomicMin(mn, v);
    atomicMax(mx, v);
  }
};

template <>
struct MinMax<double> {
  __device__ static void apply(double* mn, double* mx, double v) {
    long long b = __double_as_longlong(v);
    long long bmax = b, bmin = b;
    if (v != v) {                                  // NaN
      bmax = 0x7ff8000000000000LL;                 // +NaN: wins max
      bmin = (long long)0xfff8000000000000ULL;     // -NaN: wins min
    }
    if (bmax >= 0) atomicMax((long long*)mx, bmax);
    else atomicMin((unsigned long long*)mx, (unsigned long long)bmax);
    if (bmin >= 0) atomicMin((long long*)mn, bmin);
    else atomicMax((unsigned long long*)mn, (unsigned long long)bmin);
  }
};

template <>
struct MinMax<float> {
  __device__ static void apply(float* mn, float* mx, float v) {
    int b = __float_as_int(v);
    int bmax = b, bmin = b;
    if (v != v) {
      bmax = 0x7fc00000;
      bmin = (int)0xffc00000u;
    }
    if (bmax >= 0) atomicMax((int*)mx, bmax);
    else atomicMin((unsigned*)mx, (unsigned)bmax);
    if (bmin >= 0) atomicMin((int*)mn, bmin);
    else atomicMax((unsigned*)mn, (unsigned)bmin);
  }
};

template <typename T>
__global__ void segment_minmax_kernel(const int* __restrict__ slots,
                                      const T* __restrict__ values,
                                      T* __restrict__ mn, T* __restrict__ mx,
                                      long long n, long long C) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long s = slots[i];
    if (s < 0 || s >= C) continue;
    MinMax<T>::apply(mn + s, mx + s, values[i]);
  }
}

template <typename T>
int launch(const void* slots, const void* values, void* mn, void* mx,
           long long n, long long C, cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  segment_minmax_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      (const int*)slots, (const T*)values, (T*)mn, (T*)mx, n, C);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 int32, 1 int64, 2 float32, 3 float64.  Returns a cudaError_t
// (cudaErrorInvalidValue for an unknown dtype).
extern "C" int m3_segment_minmax(const void* slots, const void* values,
                                 void* mn, void* mx, long long n, long long C,
                                 int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<int>(slots, values, mn, mx, n, C, st);
    case 1: return launch<long long>(slots, values, mn, mx, n, C, st);
    case 2: return launch<float>(slots, values, mn, mx, n, C, st);
    case 3: return launch<double>(slots, values, mn, mx, n, C, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* m3_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
