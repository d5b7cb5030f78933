// A host build of the encode scan's per-series logic (encode_scan.cuh),
// compiled with g++ for the CPU tests, which hold it against the plain
// loop of m3_tpu_torch/parallel/encode_scan.py: the CUDA kernel runs only
// on the card, so this is how its arithmetic is checked here.  No wrapper
// of the port calls it.  Same contract as m3_encode_scan in encode_scan.cu.

#include <cstdint>

#include "decode_scan.cuh"
#include "encode_scan.cuh"

extern "C" int m3_encode_scan_host(const void* ts_t, const void* vb_t, const void* valid_t,
                                   const void* carry0, long long T, long long S,
                                   long long unit, long long unit_nanos, int default32,
                                   void* lv, void* lw, void* carry) {
  for (long long s = 0; s < S; ++s) {
    m3enc::scan_series((const int64_t*)ts_t, (const int64_t*)vb_t, (const uint8_t*)valid_t,
                       (const int64_t*)carry0, T, S, s, unit, unit_nanos, default32 != 0,
                       (int64_t*)lv, (int32_t*)lw, (int64_t*)carry);
  }
  return 0;
}
