// Aggregator segment min/max (per-lane minimum and maximum) for Hopper
// (sm_90a), folded in place into the arena's state columns.
//
// Replaces: m3_tpu/parallel/pallas_ingest.py, _minmax_kernel (public as
// pallas_segment_minmax), and the arena's drop-mode .at[idx].min / .max
// into its state (m3_tpu/aggregator/arena.py counter_ingest,
// gauge_ingest).  The TPU kernel reduces (SLAB, TILE) hit masks of every
// batch slab against every slot tile, O(N * C / TILE) work, because
// Mosaic has no scatter.  Here one thread per (lane, value) point does
// one atomic min on mn[lane] and one atomic max on mx[lane], straight
// into the stored values.  Lanes outside [0, L) drop; negative lanes
// never wrap.
//
// Integers use the signed 32- and 64-bit atomicMin / atomicMax.  Floats
// have no native atomic min/max, so they ride the integer atomics on
// their bits: a value with the sign bit clear orders like a signed
// integer of its bits, a value with the sign bit set orders backwards
// like an unsigned integer of its bits.  So max is a signed atomicMax
// for sign-clear values and an unsigned atomicMin for sign-set ones (min
// the mirror), and both meet correctly across signs.  This is IEEE's
// total order: -0 < +0, so a lane holding both gets min -0 and max +0 in
// any order, which is what the reference's min/max return.  A NaN value
// makes both its lane's min and max NaN: it is written as the NaN that
// wins its side of the order (+NaN, bits 0x7ff8..., above +inf for max;
// -NaN, bits 0xfff8..., below -inf for min) and, once in, no value
// displaces it.  The result does not depend on the order of the atomics.
//
// Stored NaNs: the sign trick keeps a stored NaN sticky only if it has
// its side's sign, a sign-clear NaN in mx and a sign-set NaN in mn (a
// sign-clear NaN in mn would lose to any sign-clear value).  The kernel
// writes only such NaNs; the JAX arenas never store a NaN in min/max
// (gauges map NaN points to -+inf); and the port's state_from_numpy
// gives any NaN in a float min/max column its side's sign.  That is the
// contract for the columns: the kernel does not test the stored value.
//
// Bound: memory.  The points are read once (idx 4 or 8 bytes, value
// sizeof(T)) and each 32-byte sector of mn and mx that the batch touches
// is read and written once.  Reads coalesce; the atomics land in L2.
//
// Contract: idx (N,) int32 or int64, values (N,), mn and mx (L,) of the
// value dtype, stored NaNs as above, all contiguous.

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

template <typename T, typename I>
__global__ void segment_minmax_kernel(const I* __restrict__ idx,
                                      const T* __restrict__ values,
                                      T* __restrict__ mn, T* __restrict__ mx,
                                      long long n, long long L) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long s = idx[i];
    if (s < 0 || s >= L) continue;
    MinMax<T>::apply(mn + s, mx + s, values[i]);
  }
}

template <typename T, typename I>
int launch(const void* idx, const void* values, void* mn, void* mx, long long n,
           long long L, cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride beyond this
  segment_minmax_kernel<T, I><<<(unsigned)blocks, threads, 0, stream>>>(
      (const I*)idx, (const T*)values, (T*)mn, (T*)mx, n, L);
  return (int)cudaGetLastError();
}

template <typename T>
int by_index(bool idx64, const void* idx, const void* values, void* mn, void* mx,
             long long n, long long L, cudaStream_t st) {
  return idx64 ? launch<T, long long>(idx, values, mn, mx, n, L, st)
               : launch<T, int>(idx, values, mn, mx, n, L, st);
}

}  // namespace

// dtype: 0 int32, 1 int64, 2 float32, 3 float64; idx64: the index is
// int64 (else int32).  n == 0 launches nothing.  Returns a cudaError_t
// (cudaErrorInvalidValue for an unknown dtype).
extern "C" int m3_segment_minmax_into(const void* idx, const void* values, void* mn,
                                      void* mx, long long n, long long L, int dtype,
                                      int idx64, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return by_index<int>(idx64, idx, values, mn, mx, n, L, st);
    case 1: return by_index<long long>(idx64, idx, values, mn, mx, n, L, st);
    case 2: return by_index<float>(idx64, idx, values, mn, mx, n, L, st);
    case 3: return by_index<double>(idx64, idx, values, mn, mx, n, L, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* m3_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
