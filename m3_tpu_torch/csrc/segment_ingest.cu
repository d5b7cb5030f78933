// Aggregator segment ingest (per-lane sum, count, sum of squares) for
// Hopper (sm_90a), accumulated in place into the arena's state columns,
// deterministic.
//
// Replaces: m3_tpu/parallel/pallas_ingest.py, _ingest_kernel (launched by
// _segment_call, public as pallas_segment_ingest and, with the third
// output, pallas_segment_moments), and the add of its fresh outputs into
// the state (m3_tpu/aggregator/arena.py _seg3).  The TPU kernel builds
// (SLAB, TILE) hit masks of every batch slab against every slot tile,
// O(N * C / TILE) vector work, because Mosaic has no scatter.  Here the
// (lane, value) points add straight into sum[lane], cnt[lane] and, when
// sq is given, sq[lane] += v*v.  Lanes outside [0, L) drop; negative
// lanes never wrap.
//
// Order: each lane's points are added into its stored value one by one,
// in arrival (index) order, the order of the reference's scatter
// (jnp .at[idx].add) and of index_add_ on the CPU.  So every run gives
// the same bits, equal to the plain version, collisions included.  No
// float atomics.  Five launches, no host synchronisation (a CUDA graph
// can hold them), no pass over all L lanes:
//
//  (a) count: one thread per point, atomicAdd 1 into hits[lane], a
//      persistent int32 scratch of L lanes that the wrapper makes once
//      with zeros; a point that finds its lane already hit adds one to
//      ctrl[0] (warp-aggregated);
//  (b) apply: a point whose lane has hits == 1 is its lane's only writer
//      in this batch: a plain read-modify-write of sum, cnt and sq, then
//      hits = 0.  This is the arena's whole traffic (each series once
//      per scrape).  Each 256-point tile also writes how many of its
//      points are collided (hits >= 2) to tiles[t];
//  (c) collided points, three launches that read ctrl[0] and exit at
//      once when it is 0.  Otherwise: one block scans tiles[] into
//      offsets (the total, M, into ctrl[4]); a stable compaction writes
//      the index of every collided point, in index order, to order[0, M)
//      (collided lanes still have hits != 0 after (b), unique ones 0);
//      then a persistent grid draws 1024-point tiles of order[] from a
//      ticket counter, sorts each by (lane, position) in shared memory
//      (bitonic), waits until the tile before it has applied, and one
//      thread per run of a lane adds the run into the state in order and
//      subtracts the run's length from hits.  Tiles apply in order, runs
//      in order inside a tile: arrival order per lane.  The wait is
//      deadlock-free: a tile's predecessor was drawn earlier, by a block
//      that is already running.  The last block to finish resets the
//      control words, and hits is zero again.
//
// Cost of (c): two parallel passes over the batch's tile counts and
// index, then a chain of ceil(M / 1024) tiles, each an apply behind its
// predecessor (serial, a few microseconds a tile): a few duplicate ids
// in a scrape cost one tile; 2^20 points in 4096 lanes cost 1024.  The
// scratch serves one stream: the wrapper keeps one per (device, stream).
//
// Arithmetic: integers wrap as the reference's two's-complement sums do
// (adds and v*v formed unsigned).  Floats use __fadd_rn / __dadd_rn and
// __fmul_rn / __dmul_rn so that v*v is rounded before it is added: nvcc
// would otherwise fuse the two into an FMA, which the reference does not
// do.  A NaN value poisons only its own lane.
//
// Bound: memory.  The points are read once (idx 4 or 8 bytes, value
// sizeof(T)) and each 32-byte sector of sum, cnt and sq that the batch
// touches is read and written once.  The kernel adds the hits scratch
// (4 bytes a touched lane, read and written in (a) and (b)) and reads
// idx twice (three times, and the values twice, for collided points).
//
// Contract: idx (N,) int32 or int64, values (N,) of the named dtype,
// sum and sq (L,) of that dtype, cnt (L,) int32 or int64, hits (L,)
// int32 all zero, ctrl (8,) int32 all zero, tiles (ceil(N / 256),) and
// order (N,) int32, all contiguous; sq may be null; N < 2^31 and
// L < 2^32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 1024;  // points per tile of the collided pass
constexpr int UNIQ = 256;   // points per tile of the unique pass
constexpr unsigned long long NONE = ~0ull;

template <typename T>
struct Acc;

template <>
struct Acc<int> {
  __device__ static int add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
  __device__ static int sq(int v) { return (int)((unsigned)v * (unsigned)v); }
};

template <>
struct Acc<long long> {
  __device__ static long long add(long long a, long long b) {
    return (long long)((unsigned long long)a + (unsigned long long)b);
  }
  __device__ static long long sq(long long v) {
    return (long long)((unsigned long long)v * (unsigned long long)v);
  }
};

template <>
struct Acc<float> {
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sq(float v) { return __fmul_rn(v, v); }
};

template <>
struct Acc<double> {
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double sq(double v) { return __dmul_rn(v, v); }
};

template <typename I>
__global__ void count_kernel(const I* __restrict__ idx, long long n, long long L,
                             int* __restrict__ hits, int* __restrict__ ctrl) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long s = idx[i];
    int old = 0;
    if (s >= 0 && s < L) old = atomicAdd(hits + s, 1);
    const unsigned active = __activemask();
    const unsigned hit = __ballot_sync(active, old != 0);
    if (hit != 0 && (threadIdx.x & 31) == __ffs(active) - 1)
      atomicAdd(ctrl, __popc(hit));
  }
}

template <typename T, typename I, typename C>
__global__ void apply_unique(const I* __restrict__ idx, const T* __restrict__ val,
                             long long n, long long L, T* __restrict__ sum,
                             C* __restrict__ cnt, T* __restrict__ sq,
                             int* __restrict__ hits, int* __restrict__ tiles) {
  for (long long t = blockIdx.x; t * UNIQ < n; t += gridDim.x) {
    const long long i = t * UNIQ + threadIdx.x;
    bool collided = false;
    if (i < n) {
      const long long s = idx[i];
      if (s >= 0 && s < L) {
        if (hits[s] == 1) {
          const T v = val[i];
          sum[s] = Acc<T>::add(sum[s], v);
          cnt[s] = Acc<C>::add(cnt[s], (C)1);
          if (sq != nullptr) sq[s] = Acc<T>::add(sq[s], Acc<T>::sq(v));
          hits[s] = 0;
        } else {
          collided = true;
        }
      }
    }
    const int c = __syncthreads_count(collided);
    if (threadIdx.x == 0) tiles[t] = c;
  }
}

// One block: tiles[] (collided points per 256-point tile) becomes its
// exclusive prefix sum; the total goes to ctrl[4].
__global__ void __launch_bounds__(TILE) scan_tiles(int* tiles, long long n_tiles, int* ctrl) {
  __shared__ int go, carry, ws[TILE / 32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    go = *(volatile int*)ctrl != 0;
    carry = 0;
  }
  __syncthreads();
  if (!go) return;
  for (long long base = 0; base < n_tiles; base += TILE) {
    const long long j = base + threadIdx.x;
    const int v = j < n_tiles ? tiles[j] : 0;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) ws[w] = x;
    __syncthreads();
    if (w == 0) {
      int z = ws[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, z, o);
        if (lane >= o) z += y;
      }
      ws[lane] = z;
    }
    __syncthreads();
    const int excl = carry + (w ? ws[w - 1] : 0) + x - v;
    if (j < n_tiles) tiles[j] = excl;
    __syncthreads();
    if (threadIdx.x == TILE - 1) carry = excl + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) ctrl[4] = carry;
}

// Stable compaction: the index of every collided point, in index order,
// to order[tiles[t] + rank inside the tile].
template <typename I>
__global__ void __launch_bounds__(UNIQ)
compact_collided(const I* __restrict__ idx, long long n, long long L,
                 const int* __restrict__ hits, const int* __restrict__ tiles,
                 int* __restrict__ order, const int* ctrl) {
  __shared__ int go, woff[UNIQ / 32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (threadIdx.x == 0) go = *(volatile const int*)ctrl != 0;
  __syncthreads();
  if (!go) return;
  for (long long t = blockIdx.x; t * UNIQ < n; t += gridDim.x) {
    const long long i = t * UNIQ + threadIdx.x;
    bool flag = false;
    if (i < n) {
      const long long s = idx[i];
      flag = s >= 0 && s < L && hits[s] != 0;
    }
    const unsigned b = __ballot_sync(0xffffffffu, flag);
    if (lane == 0) woff[w] = __popc(b);
    __syncthreads();
    if (threadIdx.x == 0) {
      int acc = tiles[t];
      for (int k = 0; k < UNIQ / 32; ++k) {
        const int c = woff[k];
        woff[k] = acc;
        acc += c;
      }
    }
    __syncthreads();
    if (flag) order[woff[w] + __popc(b & ((1u << lane) - 1u))] = (int)i;
    __syncthreads();
  }
}

template <typename T, typename I, typename C>
__global__ void __launch_bounds__(TILE)
apply_collided(const I* __restrict__ idx, const T* __restrict__ val,
               const int* __restrict__ order, long long L, T* sum, C* cnt, T* sq,
               int* hits, int* ctrl) {
  __shared__ unsigned long long key[TILE];
  __shared__ T sval[TILE];
  __shared__ int tile;
  __shared__ int go;
  __shared__ int m;
  if (threadIdx.x == 0) {
    go = *(volatile int*)ctrl != 0;
    m = *(volatile int*)(ctrl + 4);
  }
  __syncthreads();
  if (!go) return;
  const int n_tiles = (m + TILE - 1) / TILE;
  for (;;) {
    if (threadIdx.x == 0) tile = atomicAdd(ctrl + 1, 1);
    __syncthreads();
    const int t = tile;
    if (t >= n_tiles) break;
    const long long p = (long long)t * TILE + threadIdx.x;
    unsigned long long k = NONE;
    if (p < m) {
      const int i = order[p];
      const long long s = idx[i];
      k = ((unsigned long long)s << 32) | threadIdx.x;
      sval[threadIdx.x] = val[i];
    }
    key[threadIdx.x] = k;
    __syncthreads();
    for (int size = 2; size <= TILE; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const int j = threadIdx.x ^ stride;
        if (j > (int)threadIdx.x) {
          const unsigned long long a = key[threadIdx.x], b = key[j];
          if ((a > b) == ((threadIdx.x & size) == 0)) {
            key[threadIdx.x] = b;
            key[j] = a;
          }
        }
        __syncthreads();
      }
    }
    if (threadIdx.x == 0) {
      while (*(volatile int*)(ctrl + 2) != t) __nanosleep(32);
      __threadfence();
    }
    __syncthreads();
    const unsigned long long kj = key[threadIdx.x];
    if (kj != NONE &&
        (threadIdx.x == 0 || (key[threadIdx.x - 1] >> 32) != (kj >> 32))) {
      const long long s = (long long)(kj >> 32);
      T a = __ldcg(sum + s);
      T q = sq != nullptr ? __ldcg(sq + s) : T(0);
      int r = threadIdx.x;
      for (; r < TILE && key[r] != NONE && (key[r] >> 32) == (kj >> 32); ++r) {
        const T v = sval[key[r] & 0xffffffffull];
        a = Acc<T>::add(a, v);
        q = Acc<T>::add(q, Acc<T>::sq(v));
      }
      const int len = r - threadIdx.x;
      __stcg(sum + s, a);
      __stcg(cnt + s, Acc<C>::add(__ldcg(cnt + s), (C)len));
      if (sq != nullptr) __stcg(sq + s, q);
      __stcg(hits + s, __ldcg(hits + s) - len);
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) atomicExch(ctrl + 2, t + 1);
  }
  if (threadIdx.x == 0 && atomicAdd(ctrl + 3, 1) == (int)gridDim.x - 1) {
    for (int k = 0; k < 5; ++k) ctrl[k] = 0;
    __threadfence();
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms < 1) sms = 1;
  }
  return sms;
}

long long at_most(long long a, long long b) { return a < b ? a : b; }

template <typename T, typename I, typename C>
int launch(const void* idx, const void* values, void* sum, void* cnt, void* sq,
           int* hits, int* ctrl, int* tiles, int* order, long long n, long long L,
           cudaStream_t st, int* launched) {
  const int threads = 256;
  const long long blocks = at_most((n + threads - 1) / threads, 1048576);  // grid-stride beyond
  const long long n_tiles = (n + UNIQ - 1) / UNIQ;
  const I* ix = (const I*)idx;
  count_kernel<I><<<(unsigned)blocks, threads, 0, st>>>(ix, n, L, hits, ctrl);
  apply_unique<T, I, C><<<(unsigned)at_most(n_tiles, 1048576), UNIQ, 0, st>>>(
      ix, (const T*)values, n, L, (T*)sum, (C*)cnt, (T*)sq, hits, tiles);
  scan_tiles<<<1, TILE, 0, st>>>(tiles, n_tiles, ctrl);
  compact_collided<I><<<(unsigned)at_most(n_tiles, 8 * sm_count()), UNIQ, 0, st>>>(
      ix, n, L, hits, tiles, order, ctrl);
  // two 1024-thread blocks fit one SM
  apply_collided<T, I, C><<<(unsigned)at_most((n + TILE - 1) / TILE, 2 * sm_count()), TILE,
                            0, st>>>(ix, (const T*)values, order, L, (T*)sum, (C*)cnt,
                                     (T*)sq, hits, ctrl);
  *launched = 5;
  return (int)cudaGetLastError();
}

struct Scratch {
  int* hits;
  int* ctrl;
  int* tiles;
  int* order;
  int* launched;
};

template <typename T, typename I>
int by_count(bool cnt64, const void* idx, const void* values, void* sum, void* cnt,
             void* sq, const Scratch& w, long long n, long long L, cudaStream_t st) {
  return cnt64 ? launch<T, I, long long>(idx, values, sum, cnt, sq, w.hits, w.ctrl, w.tiles,
                                         w.order, n, L, st, w.launched)
               : launch<T, I, int>(idx, values, sum, cnt, sq, w.hits, w.ctrl, w.tiles,
                                   w.order, n, L, st, w.launched);
}

template <typename T>
int by_index(bool idx64, bool cnt64, const void* idx, const void* values, void* sum,
             void* cnt, void* sq, const Scratch& w, long long n, long long L,
             cudaStream_t st) {
  return idx64 ? by_count<T, long long>(cnt64, idx, values, sum, cnt, sq, w, n, L, st)
               : by_count<T, int>(cnt64, idx, values, sum, cnt, sq, w, n, L, st);
}

}  // namespace

// dtype: 0 int32, 1 int64, 2 float32, 3 float64; idx64 / cnt64: the
// index and count columns are int64 (else int32).  *launched is set to
// the number of grids launched (n == 0 launches nothing).  Returns a
// cudaError_t (cudaErrorInvalidValue for an unknown dtype).
extern "C" int m3_segment_ingest_into(const void* idx, const void* values, void* sum,
                                      void* cnt, void* sq, void* hits, void* ctrl,
                                      void* tiles, void* order, long long n, long long L,
                                      int dtype, int idx64, int cnt64, void* stream,
                                      int* launched) {
  *launched = 0;
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const Scratch w{(int*)hits, (int*)ctrl, (int*)tiles, (int*)order, launched};
  switch (dtype) {
    case 0: return by_index<int>(idx64, cnt64, idx, values, sum, cnt, sq, w, n, L, st);
    case 1: return by_index<long long>(idx64, cnt64, idx, values, sum, cnt, sq, w, n, L, st);
    case 2: return by_index<float>(idx64, cnt64, idx, values, sum, cnt, sq, w, n, L, st);
    case 3: return by_index<double>(idx64, cnt64, idx, values, sum, cnt, sq, w, n, L, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* m3_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
