// K19-K21, the gather probe's kernels: probe_double, window_gather and
// onehot_gather.
//
// Replace the three pl.pallas_call kernels of tools/probe_pallas.py, which
// ask whether a row gather whose sources lie in a window (a tile of `tile`
// rows, out[i] = x[(i / tile) * tile + idx[i]], idx in [0, tile)) is served
// faster from fast on-chip memory than by a plain gather, and what the
// one-hot matrix-product route costs:
//   * K19 probe_double (P1, k_double :55): y = x * 2, elementwise. Bound by
//     bytes (read x, write y); float4 loads and stores, grid-stride.
//   * K20 window_gather (P2, tiled_gather :72): a 4608-row f32 window of
//     128 channels is 2.36 MB and does not fit the 227 KB of shared memory,
//     so each block stages one channel slice of one tile's window (4608 x 8
//     f32 = 147 KB) with cp.async, then gathers its output rows of that
//     slice from shared memory. Bound by bytes (x once, y once, idx once);
//     x's 32-byte slice of a row is one DRAM sector. Against it: the plain
//     gather, whose window is served from the 50 MB L2.
//   * K21 onehot_gather (P3, onehot_gather :110): the same gather as a
//     (tile x tile) one-hot matrix times the tile's window, on the tensor
//     cores with mma.sync m16n8k8 TF32. The one-hot operand is built in
//     registers from idx and never written to memory. A single TF32 pass
//     would round x, so each x is split into three TF32 terms hi + mid +
//     lo (truncations, exact for finite f32), each multiplied into its own
//     f32 accumulator; a row has one nonzero product over the whole window,
//     so each accumulator holds its term exactly and (hi + mid) + lo gives
//     x back bit for bit where every term is normal or zero, which holds
//     for |x| >= 2^-103 (lo's lowest bit is 2^-23 of x's exponent). Below
//     that the sum can lose a flushed subnormal term, and a -0.0 comes back
//     +0.0 (the accumulators start at +0.0), so an output under 2^-100 in
//     magnitude, which only such an x gives, is read from x instead. So the
//     result is the gather's bit for bit for every finite x (0 * inf would
//     be NaN). Dense, as
//     P3 is: 3 x 2 x tile^2 x C operations a tile, bound by the tensor
//     cores (495 TFLOP/s TF32) rather than by bytes. Design: 8 warps a
//     block, 16 output rows a warp (128 rows) and 64 channels; the window
//     is staged 32 rows at a time into shared memory, already split, with a
//     row stride of 72 words so that the B fragments' loads hit 32 distinct
//     banks.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void double_vec_kernel(const float4* __restrict__ x, float4* __restrict__ y,
                                  int64_t n4) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float4 v = x[i];
    y[i] = make_float4(v.x * 2.0f, v.y * 2.0f, v.z * 2.0f, v.w * 2.0f);
  }
}

__global__ void double_kernel(const float* __restrict__ x, float* __restrict__ y,
                              int64_t begin, int64_t n) {
  for (int64_t i = begin + static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    y[i] = x[i] * 2.0f;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(gmem));
}

// One block per (tile, channel slice of 4 * Q floats): stage the slice of
// the tile's window, then write the tile's output rows of that slice.
template <int Q>
__global__ void window_gather_kernel(const float* __restrict__ x,
                                     const int32_t* __restrict__ idx, int c, int tile,
                                     float* __restrict__ out) {
  extern __shared__ float4 win[];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int c0 = blockIdx.y * 4 * Q;
  const int n = tile * Q;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / Q, q = i % Q;
    cp_async16(&win[i], x + (row0 + r) * c + c0 + 4 * q);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / Q, q = i % Q;
    const int32_t j = idx[row0 + r];
    const float4 v = (j >= 0 && j < tile) ? win[j * Q + q] : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(out + (row0 + r) * c + c0 + 4 * q) = v;
  }
}

constexpr int kWarps = 8;            // onehot_gather: 16 output rows a warp
constexpr int kRows = 16 * kWarps;   // output rows a block
constexpr int kCols = 64;            // channels a block
constexpr int kChunk = 32;           // window rows staged a step
constexpr int kStride = 72;          // shared row stride in words (conflict-free B loads)
constexpr uint32_t kOne = 0x3f800000u;
constexpr uint32_t kTf32 = 0xffffe000u;

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// grid (ceil(tile / kRows), ceil(c / kCols), tiles), kWarps * 32 threads.
__global__ void __launch_bounds__(kWarps * 32)
    onehot_gather_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx, int c,
                         int tile, float* __restrict__ out) {
  __shared__ uint32_t s_part[3][kChunk][kStride];
  const int64_t base = static_cast<int64_t>(blockIdx.z) * tile;
  const int c0 = blockIdx.y * kCols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int r0 = blockIdx.x * kRows + warp * 16;   // the warp's first row in the tile
  const bool rows_live = r0 < tile;
  const int32_t ia = rows_live ? idx[base + r0 + g] : -1;
  const int32_t ib = rows_live ? idx[base + r0 + g + 8] : -1;
  float acc[3][kCols / 8][4];
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int t = 0; t < kCols / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][t][e] = 0.f;

  for (int kc = 0; kc < tile; kc += kChunk) {
    __syncthreads();
    for (int e = threadIdx.x; e < kChunk * kCols; e += blockDim.x) {
      const int r = e / kCols, col = e % kCols;
      const float v = (kc + r < tile && c0 + col < c) ? x[(base + kc + r) * c + c0 + col] : 0.f;
      const uint32_t hi = __float_as_uint(v) & kTf32;
      const float rem = v - __uint_as_float(hi);
      const uint32_t mid = __float_as_uint(rem) & kTf32;
      const float lo = rem - __uint_as_float(mid);
      s_part[0][r][col] = hi;
      s_part[1][r][col] = mid;
      s_part[2][r][col] = __float_as_uint(lo) & kTf32;
    }
    __syncthreads();
    if (!rows_live) continue;
#pragma unroll
    for (int k8 = 0; k8 < kChunk; k8 += 8) {
      const int k = kc + k8 + q;   // the window row of this thread's A columns q, q + 4
      const uint32_t a0 = ia == k ? kOne : 0u, a1 = ib == k ? kOne : 0u;
      const uint32_t a2 = ia == k + 4 ? kOne : 0u, a3 = ib == k + 4 ? kOne : 0u;
#pragma unroll
      for (int t = 0; t < kCols / 8; ++t) {
        const int col = t * 8 + g;
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          mma_tf32(acc[p][t], a0, a1, a2, a3, s_part[p][k8 + q][col],
                   s_part[p][k8 + q + 4][col]);
        }
      }
    }
  }
  if (!rows_live) return;
#pragma unroll
  for (int t = 0; t < kCols / 8; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c0 + t * 8 + 2 * q + (e & 1);
      const int64_t row = base + r0 + g + (e >> 1) * 8;
      if (col >= c) continue;
      float r = (acc[0][t][e] + acc[1][t][e]) + acc[2][t][e];
      if (fabsf(r) < 0x1p-100f) {   // a zero or tiny x: its terms may not be exact
        const int32_t j = (e >> 1) ? ib : ia;
        if (j >= 0 && j < tile) r = x[(base + j) * c + col];
      }
      out[row * c + col] = r;
    }
  }
}

}  // namespace

// x, y (n,) f32.
extern "C" int ms3d_probe_double(const float* x, int64_t n, float* y, cudaStream_t stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  const int64_t n4 = aligned ? n / 4 : 0;
  // one float4 a thread (grid-stride beyond 2^20 blocks)
  const auto blocks = [](int64_t items) {
    return static_cast<unsigned>(std::min<int64_t>((items + kThreads - 1) / kThreads, 1 << 20));
  };
  if (n4 > 0) {
    double_vec_kernel<<<blocks(n4), kThreads, 0, stream>>>(reinterpret_cast<const float4*>(x),
                                                           reinterpret_cast<float4*>(y), n4);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (4 * n4 < n) {
    double_kernel<<<blocks(n - 4 * n4), kThreads, 0, stream>>>(x, y, 4 * n4, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// Widest channel slice (floats) window_gather can stage for this tile and
// channel count: 8 or 4, or 0 when none fits (c % 4 != 0 or tile too big).
extern "C" int ms3d_window_gather_slice(int c, int tile) {
  for (int s = 8; s >= 4; s /= 2) {
    if (c % s == 0 && static_cast<int64_t>(tile) * s * 4 <= 232448) return s;
  }
  return 0;
}

// x (v, c) f32, idx (v,) int32 in [0, tile), v % tile == 0, x and out
// 16-byte aligned -> out (v, c).
extern "C" int ms3d_window_gather(const float* x, const int32_t* idx, int v, int c, int tile,
                                  float* out, cudaStream_t stream) {
  const int s = ms3d_window_gather_slice(c, tile);
  if (tile <= 0 || v % tile != 0 || s == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (v == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(v / tile, c / s);
  const size_t smem = static_cast<size_t>(tile) * s * sizeof(float);
  cudaError_t err;
  if (s == 8) {
    err = cudaFuncSetAttribute(window_gather_kernel<2>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    window_gather_kernel<2><<<grid, 512, smem, stream>>>(x, idx, c, tile, out);
  } else {
    err = cudaFuncSetAttribute(window_gather_kernel<1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    window_gather_kernel<1><<<grid, 512, smem, stream>>>(x, idx, c, tile, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// x (v, c) f32, idx (v,) int32 in [0, tile), v % tile == 0, tile % 16 == 0
// -> out (v, c).
extern "C" int ms3d_onehot_gather(const float* x, const int32_t* idx, int v, int c, int tile,
                                  float* out, cudaStream_t stream) {
  if (tile <= 0 || tile % 16 != 0 || v % tile != 0 || v / tile > 65535 || c <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (v == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((tile + kRows - 1) / kRows, (c + kCols - 1) / kCols, v / tile);
  onehot_gather_kernel<<<grid, kWarps * 32, 0, stream>>>(x, idx, c, tile, out);
  return static_cast<int>(cudaGetLastError());
}
