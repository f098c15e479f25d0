// Id arrays read in the caller's dtype (K5 in proposal_iou.cu, K12 in
// mask_label.cu): instance ids, sizes and classes come as int16, int32 or
// int64, and a kernel reads them where they lie rather than from a cast
// copy. The width is a runtime argument, the same for every thread, so the
// branch in at() never diverges.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace ms3d {

// An int16, int32 or int64 array.
struct Ints {
  const void* p;
  int bytes;  // 2, 4 or 8
};

__device__ __forceinline__ int64_t at(const Ints& v, int64_t i) {
  if (v.bytes == 8) return __ldg(static_cast<const long long*>(v.p) + i);
  if (v.bytes == 4) return __ldg(static_cast<const int*>(v.p) + i);
  return __ldg(static_cast<const short*>(v.p) + i);
}

// True where w is an element size at() reads.
inline bool ints_width(int w) { return w == 2 || w == 4 || w == 8; }

}  // namespace ms3d
