// A host build of the decode scan's per-series logic (decode_scan.cuh),
// compiled with g++ for the CPU tests, which hold it against the plain
// loop of m3_tpu_torch/parallel/decode_scan.py: the CUDA kernel runs only
// on the card, so this is how its arithmetic is checked here.  No wrapper
// of the port calls it.  Same contract as m3_decode_scan in decode_scan.cu.

#include <cstdint>

#include "decode_scan.cuh"

extern "C" int m3_decode_scan_host(const void* wpad, long long Wp, const void* nbits,
                                   const void* unit0, const void* tbl, long long P,
                                   long long S, int fused, void* lane0, void* lane1,
                                   void* lane2, void* lane3, void* carry) {
  for (long long s = 0; s < S; ++s) {
    if (fused) {
      m3scan::scan_series<true>((const uint64_t*)wpad, Wp, (const int64_t*)nbits,
                                (const int64_t*)unit0, (const int32_t*)tbl, P, S, s, lane0,
                                lane1, lane2, lane3, (int64_t*)carry);
    } else {
      m3scan::scan_series<false>((const uint64_t*)wpad, Wp, (const int64_t*)nbits,
                                 (const int64_t*)unit0, (const int32_t*)tbl, P, S, s, lane0,
                                 lane1, lane2, lane3, (int64_t*)carry);
    }
  }
  return 0;
}
