// K4 gather_wgrad: dW[t] = sum_r x~[idx[r, t]]^T . dout[r]   (f32 sum)
//
// Two element types: f32 x and dout (ms3d_gather_wgrad), or bf16 x and a
// bf16 cotangent (ms3d_gather_wgrad_bf16), widened to f32 (exact: the
// products of two bf16 values are exact in f32, so fmaf adds each one with
// a single rounding). The bf16 variant rounds the total once to bf16 and
// writes it widened to f32: the JAX package's bf16 train step computes dW
// as an f32 dot of the bf16 gathered rows with the widened cotangent,
// rounds it to the bf16 weight's dtype (the transpose of _mm's
// b.astype(bf16), minsu3d_tpu/ops/sparse_conv.py:38) and widens it back
// for the f32 parameter, which Adam then reads.
//
// The weight gradient of the sparse convs (K1's forward out[r] = sum_t
// x~[idx[r, t]] . W[t], x~ = x with a zero row appended). Replaces the dW
// half of the JAX package's conv backward: the gathered-table contraction
// of minsu3d_tpu/ops/sparse_conv.py:306-376 (subm_conv_blocked_vjp) and the
// autodiff of subm_conv / down_conv / up_conv (:50, :66, :80). The dx half
// runs on K1 itself with the transposed index and weights.
// idx is (R, T) int32; any value outside [0, n_rows) is an absent pair and
// contributes nothing.
//
// What bounds it on an H100: 2 * live_pairs * Cin * Cout flops over the
// gathered x rows and the dout rows, so the f32 CUDA-core rate (67 TFLOP/s)
// at wide levels and the row gathers at the narrow level 0.
// Design, simple for now: a block owns one tap, one chunk of kChunk rows and
// one kBI x kBO tile of (Cin, Cout). It walks its chunk 256 rows at a time,
// compacts the rows whose tap is live into a shared list (warp ballots, in
// row order), then stages kR gathered x rows and the matching dout rows
// through shared memory and accumulates the tile in registers (4 outputs
// per thread). Absent pairs cost one index read and nothing else, which
// matters at level 0, where about 1/5 of the 27 taps of a row are live.
// Each block writes its tile to a per-chunk partial; a second kernel sums
// the partials in chunk order. No float atomics: dW is the same run to run.
// wgmma/TMA come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 2048;    // rows per block
constexpr int kThreads = 256;   // one row per thread in the compaction pass
constexpr int kBI = 32;         // Cin tile
constexpr int kBO = 32;         // Cout tile
constexpr int kR = 32;          // live pairs per shared-memory stage
constexpr int kPerThread = kBI * kBO / kThreads;  // 4 outputs per thread
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// the value written for an f32 total: itself, or rounded once to bf16
template <bool kRound>
__device__ __forceinline__ float finish(float s) {
  if constexpr (kRound) return __bfloat162float(__float2bfloat16_rn(s));
  return s;
}

// kRound: write finish<true>(acc) when the block's tile is the whole sum
// (one chunk, partial == out)
template <typename T, bool kRound>
__global__ void __launch_bounds__(kThreads)
gather_wgrad_kernel(const T* __restrict__ x, int n_rows, int cin,
                    const int32_t* __restrict__ idx, int rows, int taps,
                    const T* __restrict__ dout, int cout,
                    float* __restrict__ partial) {
  __shared__ int32_t live_r[kThreads];
  __shared__ int32_t live_s[kThreads];
  __shared__ int warp_count[kWarps];
  __shared__ float xs[kR][kBI];
  __shared__ float ds[kR][kBO];

  const int chunk = blockIdx.x;
  const int t = blockIdx.y;
  const int co_tiles = (cout + kBO - 1) / kBO;
  const int ci0 = (blockIdx.z / co_tiles) * kBI;
  const int co0 = (blockIdx.z % co_tiles) * kBO;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int tx = threadIdx.x % kBO;          // output column of this thread
  const int ty = threadIdx.x / kBO;          // group of kPerThread input rows

  float acc[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) acc[i] = 0.f;

  const int r_begin = chunk * kChunk;
  const int r_end = min(r_begin + kChunk, rows);
  for (int base = r_begin; base < r_end; base += kThreads) {
    const int r = base + threadIdx.x;
    int s = -1;
    if (r < r_end) s = idx[static_cast<int64_t>(r) * taps + t];
    const bool live = s >= 0 && s < n_rows;
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      offset += (w < warp) ? warp_count[w] : 0;
      total += warp_count[w];
    }
    if (live) {
      const int pos = offset + __popc(ballot & ((1u << lane) - 1u));
      live_r[pos] = r;
      live_s[pos] = s;
    }
    __syncthreads();

    for (int k0 = 0; k0 < total; k0 += kR) {
      const int nk = min(kR, total - k0);
      for (int i = threadIdx.x; i < kR * kBI; i += kThreads) {
        const int kk = i / kBI, cc = i % kBI, c = ci0 + cc;
        xs[kk][cc] = (kk < nk && c < cin)
                         ? widen(x[static_cast<int64_t>(live_s[k0 + kk]) * cin + c]) : 0.f;
      }
      for (int i = threadIdx.x; i < kR * kBO; i += kThreads) {
        const int kk = i / kBO, oo = i % kBO, o = co0 + oo;
        ds[kk][oo] = (kk < nk && o < cout)
                         ? widen(dout[static_cast<int64_t>(live_r[k0 + kk]) * cout + o]) : 0.f;
      }
      __syncthreads();
      for (int kk = 0; kk < nk; ++kk) {
        const float dv = ds[kk][tx];
#pragma unroll
        for (int i = 0; i < kPerThread; ++i)
          acc[i] = fmaf(xs[kk][ty * kPerThread + i], dv, acc[i]);
      }
      __syncthreads();
    }
  }

  const int o = co0 + tx;
  if (o >= cout) return;
  float* dst = partial + (static_cast<int64_t>(chunk) * taps + t) * cin * cout;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int c = ci0 + ty * kPerThread + i;
    if (c < cin) dst[static_cast<int64_t>(c) * cout + o] = finish<kRound>(acc[i]);
  }
}

// out[e] = sum over chunks, in chunk order, of partial[chunk][e]
template <bool kRound>
__global__ void sum_partials_kernel(const float* __restrict__ partial, int n_chunks,
                                    int64_t n_out, float* __restrict__ out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s = __fadd_rn(s, partial[c * n_out + e]);
  out[e] = finish<kRound>(s);
}

template <typename T, bool kRound>
int launch(const T* x, int n_rows, int cin, const int32_t* idx, int rows, int taps,
           const T* dout, int cout, float* partial, float* out, cudaStream_t stream) {
  const int64_t n_out = static_cast<int64_t>(taps) * cin * cout;
  if (n_out == 0) return static_cast<int>(cudaSuccess);
  const int n_chunks = rows <= 0 ? 0 : (rows + kChunk - 1) / kChunk;
  if (n_chunks == 0) {
    return static_cast<int>(cudaMemsetAsync(out, 0, n_out * sizeof(float), stream));
  }
  const int tiles = ((cin + kBI - 1) / kBI) * ((cout + kBO - 1) / kBO);
  const dim3 grid(n_chunks, taps, tiles);
  const bool whole = partial == out;   // one chunk: the tiles are the sum
  if (whole) {
    gather_wgrad_kernel<T, kRound><<<grid, kThreads, 0, stream>>>(x, n_rows, cin, idx, rows,
                                                                  taps, dout, cout, partial);
  } else {
    gather_wgrad_kernel<T, false><<<grid, kThreads, 0, stream>>>(x, n_rows, cin, idx, rows,
                                                                 taps, dout, cout, partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || whole) return static_cast<int>(err);
  const int threads = 256;
  const int64_t blocks = (n_out + threads - 1) / threads;
  sum_partials_kernel<kRound><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      partial, n_chunks, n_out, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ms3d_gather_wgrad_chunks(int rows) {
  return rows <= 0 ? 0 : (rows + kChunk - 1) / kChunk;
}

// partial: (n_chunks, taps, cin, cout) f32 scratch, n_chunks =
// ms3d_gather_wgrad_chunks(rows); with one chunk it may alias out.
extern "C" int ms3d_gather_wgrad(const float* x, int n_rows, int cin, const int32_t* idx,
                                 int rows, int taps, const float* dout, int cout,
                                 float* partial, float* out, cudaStream_t stream) {
  return launch<float, false>(x, n_rows, cin, idx, rows, taps, dout, cout, partial, out,
                              stream);
}

// bf16 x and dout; out (f32) holds the total rounded once to bf16
extern "C" int ms3d_gather_wgrad_bf16(const __nv_bfloat16* x, int n_rows, int cin,
                                      const int32_t* idx, int rows, int taps,
                                      const __nv_bfloat16* dout, int cout, float* partial,
                                      float* out, cudaStream_t stream) {
  return launch<__nv_bfloat16, true>(x, n_rows, cin, idx, rows, taps, dout, cout, partial,
                                     out, stream);
}
