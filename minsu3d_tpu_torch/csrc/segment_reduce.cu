// K6 segment_reduce: per-segment sum, max or min over the rows of a CSR.
//
//   perm    (R',) row ids sorted stably by segment (rows of the padding
//           segment S are left out, so they are never reduced);
//   offsets (S+1,) segment s owns perm[offsets[s] : offsets[s+1]];
//   out[s, c] = x[r0, c] op x[r1, c] op ...   over s's rows in row order.
//
// sum (f32): (((+0.0 + x[r0]) + x[r1]) + ...) with __fadd_rn, the order of
// XLA:CPU's scatter-add and of torch's CPU index_add_, so the card's sums
// equal the CPU's bit for bit and repeat from run to run (no atomics).
// max/min (f32, int32 or bf16) are order-free and propagate NaN; an empty
// segment reads `fill` (a sum reads +0.0). A bf16 max/min is one of the
// rows' own values, so it equals the plain version's bit for bit. A bf16
// sum rounds after every add, in row order: widen, add in f32 with
// __fadd_rn, round with __float2bfloat16_rn. That is XLA:CPU's bf16
// scatter-add, the transpose of every bf16 row gather in the JAX package's
// bf16 train step (the devoxelization, the point-feature gather into
// proposal rows): its result depends on the order, and so does this one's.
//
// Replaces the float scatter-adds and scatter-max/min of
// minsu3d_tpu/ops/cluster.py:230 (_unit_table), minsu3d_tpu/ops/segment.py:
// 40-72 (sec_mean/sec_min/sec_max/roipool), the per-cluster centers and
// class/batch max of minsu3d_tpu/model/hais.py:31, and the transpose of
// every row gather (gather_rows' backward).
//
// What bounds it on an H100: one read of each reduced row and of its perm
// entry, one write of (S, C): bytes. Design, simple first: one warp per
// segment, lanes over channels; each lane issues the loads of 8 rows before
// it adds them in order, so the serial add chain does not wait on one load
// at a time. A segment is serial in its length, and a narrow C leaves most
// lanes idle (C = 4 for the unit table); splitting long segments into
// ordered partials is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;

enum Op { kSum = 0, kMax = 1, kMin = 2 };

template <typename T, int OP>
__device__ __forceinline__ T combine(T acc, T v);

template <>
__device__ __forceinline__ float combine<float, kSum>(float acc, float v) {
  return __fadd_rn(acc, v);
}
// a NaN row makes the segment's max/min NaN, as torch.maximum/minimum and
// the JAX segment_max/min propagate it (a NaN acc stays: no compare is true)
template <>
__device__ __forceinline__ float combine<float, kMax>(float acc, float v) {
  return (v > acc || v != v) ? v : acc;
}
template <>
__device__ __forceinline__ float combine<float, kMin>(float acc, float v) {
  return (v < acc || v != v) ? v : acc;
}
// bf16 compares in f32, which orders bf16 values exactly
template <>
__device__ __forceinline__ __nv_bfloat16 combine<__nv_bfloat16, kMax>(__nv_bfloat16 acc,
                                                                      __nv_bfloat16 v) {
  const float a = __bfloat162float(acc), b = __bfloat162float(v);
  return (b > a || b != b) ? v : acc;
}
template <>
__device__ __forceinline__ __nv_bfloat16 combine<__nv_bfloat16, kMin>(__nv_bfloat16 acc,
                                                                      __nv_bfloat16 v) {
  const float a = __bfloat162float(acc), b = __bfloat162float(v);
  return (b < a || b != b) ? v : acc;
}
// bf16 sum: one rounding per add, as XLA:CPU's bf16 scatter-add
template <>
__device__ __forceinline__ __nv_bfloat16 combine<__nv_bfloat16, kSum>(__nv_bfloat16 acc,
                                                                      __nv_bfloat16 v) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(acc), __bfloat162float(v)));
}
template <>
__device__ __forceinline__ int32_t combine<int32_t, kSum>(int32_t acc, int32_t v) {
  return acc + v;
}
template <>
__device__ __forceinline__ int32_t combine<int32_t, kMax>(int32_t acc, int32_t v) {
  return v > acc ? v : acc;
}
template <>
__device__ __forceinline__ int32_t combine<int32_t, kMin>(int32_t acc, int32_t v) {
  return v < acc ? v : acc;
}

template <typename T>
__device__ __forceinline__ T zero() {
  return T(0);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

template <typename T, int OP>
__global__ void segment_reduce_kernel(const T* __restrict__ x, int c_dim,
                                      const int32_t* __restrict__ perm,
                                      const int32_t* __restrict__ offsets, int n_seg, T fill,
                                      T* __restrict__ out) {
  const int seg = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (seg >= n_seg) return;
  const int beg = offsets[seg], end = offsets[seg + 1];
  for (int c = lane; c < c_dim; c += 32) {
    T acc;
    int r = beg;
    if constexpr (OP == kSum) {
      acc = zero<T>();   // +0.0, as the scatter's zeros operand
    } else {
      if (beg < end) {
        acc = x[static_cast<int64_t>(perm[beg]) * c_dim + c];
        r = beg + 1;
      } else {
        acc = fill;
      }
    }
    for (; r + kUnroll <= end; r += kUnroll) {
      T v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) v[k] = x[static_cast<int64_t>(perm[r + k]) * c_dim + c];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) acc = combine<T, OP>(acc, v[k]);
    }
    for (; r < end; ++r) acc = combine<T, OP>(acc, x[static_cast<int64_t>(perm[r]) * c_dim + c]);
    out[static_cast<int64_t>(seg) * c_dim + c] = acc;
  }
}

template <typename T>
int launch(const T* x, int c_dim, const int32_t* perm, const int32_t* offsets, int n_seg,
           int op, T fill, T* out, cudaStream_t stream) {
  if (n_seg <= 0 || c_dim <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (n_seg + kWarps - 1) / kWarps;
  switch (op) {
    case kSum:
      segment_reduce_kernel<T, kSum><<<blocks, kThreads, 0, stream>>>(x, c_dim, perm, offsets,
                                                                      n_seg, fill, out);
      break;
    case kMax:
      segment_reduce_kernel<T, kMax><<<blocks, kThreads, 0, stream>>>(x, c_dim, perm, offsets,
                                                                      n_seg, fill, out);
      break;
    case kMin:
      segment_reduce_kernel<T, kMin><<<blocks, kThreads, 0, stream>>>(x, c_dim, perm, offsets,
                                                                      n_seg, fill, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (rows, c_dim) row-major; out (n_seg, c_dim); op 0 sum, 1 max, 2 min.
extern "C" int ms3d_segment_reduce_f32(const float* x, int c_dim, const int32_t* perm,
                                       const int32_t* offsets, int n_seg, int op, float fill,
                                       float* out, cudaStream_t stream) {
  return launch<float>(x, c_dim, perm, offsets, n_seg, op, fill, out, stream);
}

extern "C" int ms3d_segment_reduce_i32(const int32_t* x, int c_dim, const int32_t* perm,
                                       const int32_t* offsets, int n_seg, int op, int32_t fill,
                                       int32_t* out, cudaStream_t stream) {
  return launch<int32_t>(x, c_dim, perm, offsets, n_seg, op, fill, out, stream);
}

// bf16 rows: sum (op 0, rounded after every add), max (op 1), min (op 2)
extern "C" int ms3d_segment_reduce_bf16(const __nv_bfloat16* x, int c_dim, const int32_t* perm,
                                        const int32_t* offsets, int n_seg, int op, float fill,
                                        __nv_bfloat16* out, cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, c_dim, perm, offsets, n_seg, op, __float2bfloat16_rn(fill),
                               out, stream);
}
