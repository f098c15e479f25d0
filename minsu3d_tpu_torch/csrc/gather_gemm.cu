// K1 gather_gemm: out[r] = sum_t x[idx[r, t]] . W[t]   (f32 sum)
//
// Two element types, one kernel body: f32 x/W/out, and bf16 x/W/out (the
// JAX package's compute_dtype=bfloat16: bf16 x bf16 products accumulated in
// f32 by dot_general's preferred_element_type, the f32 sum rounded once to
// bf16 at the end, minsu3d_tpu/ops/sparse_conv.py:30-43, :63, :77, :91).
// bf16 inputs are widened to f32 as they are staged into shared memory (the
// product of two bf16 values is exact in f32), the FMAs run in f32, and the
// output is rounded once with __float2bfloat16_rn.
//
// Replaces the gather + dot_general chains of the JAX package's sparse convs:
//   minsu3d_tpu/ops/sparse_conv.py:50 subm_conv  (T = 27, idx = nbr_idx)
//   minsu3d_tpu/ops/sparse_conv.py:66 down_conv  (T = 8, gather form: the
//        wrapper inverts (parent_idx, child_kid) into child_of[parent, kid])
//   minsu3d_tpu/ops/sparse_conv.py:80 up_conv    (T = 8, one live tap per row)
// idx is (R, T) int32; any value outside [0, n_rows) -- the plan writes
// n_rows, the level capacity -- is an absent neighbour and reads a zero row.
//
// What bounds it on an H100: at the main path's shapes (R <= 98304,
// Cin, Cout <= 112, about 1/5 of the 27 taps live at level 0) a call does
// 2 * live_pairs * Cin * Cout flops over a few MB of x/idx/out, so the f32
// CUDA-core rate (67 TFLOP/s) and the gathered-row reads bound it, not HBM.
// Design, simple for now: one block computes a 64-row x 32-column output
// tile; per tap it stages the 64 gathered input rows and the tap's weight
// slice through shared memory in 32-channel chunks and accumulates with
// fmaf in registers (8 outputs per thread). A tap that no row of the tile
// uses is skipped block-wide, which is what keeps up_conv (1 live tap of 8)
// cheap. No atomics: every output row is owned by one thread column, so the
// result is deterministic. wgmma/TMA and a compacted pair list are later work
// (in bf16 the tensor cores' 989 TFLOP/s would be the roof: mma.sync/wgmma).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int kBM = 64;        // output rows per block
constexpr int kBN = 32;        // output columns per block
constexpr int kKC = 32;        // input channels per shared-memory chunk
constexpr int kThreads = 256;  // 8 row groups x 32 columns
constexpr int kRowsPerThread = kBM / (kThreads / kBN);

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_gemm_kernel(const T* __restrict__ x, int n_rows, int cin,
                   const int32_t* __restrict__ idx, int rows, int taps,
                   const T* __restrict__ w, int cout, T* __restrict__ out) {
  __shared__ float xs[kBM][kKC + 1];
  __shared__ float ws[kKC][kBN];
  __shared__ int32_t src[kBM];

  const int r0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tx = threadIdx.x % kBN;
  const int ty = threadIdx.x / kBN;

  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;

  for (int t = 0; t < taps; ++t) {
    int live = 0;
    if (threadIdx.x < kBM) {
      const int r = r0 + threadIdx.x;
      const int s = r < rows ? idx[static_cast<int64_t>(r) * taps + t] : -1;
      src[threadIdx.x] = (s >= 0 && s < n_rows) ? s : -1;
      live = src[threadIdx.x] >= 0;
    }
    // barrier + block-wide "any row uses this tap"
    if (!__syncthreads_or(live)) continue;

    for (int c0 = 0; c0 < cin; c0 += kKC) {
      for (int i = threadIdx.x; i < kBM * kKC; i += kThreads) {
        const int rr = i / kKC, cc = i % kKC;
        const int s = src[rr], c = c0 + cc;
        xs[rr][cc] = (s >= 0 && c < cin) ? to_f32(x[static_cast<int64_t>(s) * cin + c]) : 0.f;
      }
      for (int i = threadIdx.x; i < kKC * kBN; i += kThreads) {
        const int kk = i / kBN, nn = i % kBN;
        const int c = c0 + kk, n = n0 + nn;
        ws[kk][nn] = (c < cin && n < cout)
                         ? to_f32(w[(static_cast<int64_t>(t) * cin + c) * cout + n])
                         : 0.f;
      }
      __syncthreads();
      const int kmax = min(kKC, cin - c0);
      for (int k = 0; k < kmax; ++k) {
        const float wv = ws[k][tx];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          acc[i] = fmaf(xs[ty * kRowsPerThread + i][k], wv, acc[i]);
      }
      __syncthreads();
    }
  }

  const int n = n0 + tx;
  if (n >= cout) return;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = r0 + ty * kRowsPerThread + i;
    if (r < rows) out[static_cast<int64_t>(r) * cout + n] = from_f32<T>(acc[i]);
  }
}

template <typename T>
int launch(const T* x, int n_rows, int cin, const int32_t* idx, int rows, int taps,
           const T* w, int cout, T* out, cudaStream_t stream) {
  if (rows == 0 || cout == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((rows + kBM - 1) / kBM, (cout + kBN - 1) / kBN);
  gather_gemm_kernel<T><<<grid, kThreads, 0, stream>>>(x, n_rows, cin, idx, rows, taps, w,
                                                       cout, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ms3d_gather_gemm(const float* x, int n_rows, int cin, const int32_t* idx,
                                int rows, int taps, const float* w, int cout, float* out,
                                cudaStream_t stream) {
  return launch<float>(x, n_rows, cin, idx, rows, taps, w, cout, out, stream);
}

// the same with bf16 x, w and out (f32 accumulation, one rounding per output)
extern "C" int ms3d_gather_gemm_bf16(const __nv_bfloat16* x, int n_rows, int cin,
                                     const int32_t* idx, int rows, int taps,
                                     const __nv_bfloat16* w, int cout, __nv_bfloat16* out,
                                     cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, n_rows, cin, idx, rows, taps, w, cout, out, stream);
}
