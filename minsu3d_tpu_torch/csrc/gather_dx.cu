// K13 gather_dx_bf16: the input gradient of a bf16 sparse conv, rounded where
// the JAX package's bf16 train step rounds it.
//
//   dout  (R, Cout) bf16, the conv's output cotangent;
//   idx_t (N, T) int32, the transposed index: row j of x is read at tap t by
//         output row idx_t[j, t]; a value outside [0, R) is absent;
//   w     (T, Cout, Cin) bf16, the conv's weight with each tap transposed
//         (and the taps flipped for the submanifold conv);
//   out   (N, Cin) bf16.
//
// Replaces the dx half of jax.grad through minsu3d_tpu/ops/sparse_conv.py:50
// subm_conv, :66 down_conv and :80 up_conv with compute_dtype=bfloat16. There
// XLA computes, for every (source row i, tap) pair, one contribution: an f32
// dot over Cout of the widened cotangent with the bf16 weight, rounded to
// bf16. A bf16 scatter-add then adds the contributions into a zeros operand
// one at a time, in update order (source row major), rounding after every
// add. Both roundings, and the order, are part of the result: K1's "sum all
// taps in f32, round once" is another function. So, per target row j:
//   * the live sources i = idx_t[j, t] are sorted by (i, t): the row order
//     of the scatter's updates (a source reaches a row through one tap);
//   * each contribution is a serial __fmul_rn/__fadd_rn chain over Cout in
//     index order from +0.0 (no FMA contraction), rounded with
//     __float2bfloat16_rn;
//   * the accumulator starts at +0.0 and takes each contribution in that
//     order: widen, __fadd_rn, __float2bfloat16_rn.
// The plain version (ops/sparse_conv.py gather_dx_bf16_plain) repeats these
// steps with elementwise torch ops and equals the kernel bit for bit.
//
// What bounds it on an H100: one read of dout's live rows, the weight, the
// index and one write of out (bytes), or 2 * live_pairs * Cin * Cout flops;
// the serial chains put it far above both: each output element is a chain
// of live_taps x Cout dependent adds. Design, simple first: one warp per
// (target row, group of 32 input channels), so that a wide level puts
// Cin / 32 warps on each row and more chains in flight. Lane t < T
// loads idx_t[j, t]; each lane ranks its entry against the others with warp
// shuffles (T <= 32) and writes it to its place in a shared list, so the
// sort costs T shuffles (each channel group of a row repeats it). Lane l
// then owns channel 32 g + l: per live source in order, the dot reads the
// source's dout row (one address for the whole warp) and the tap's weight
// column (coalesced across lanes), unrolled so that loads run ahead of the
// chain. Every output element is written by one thread: no atomics, the
// same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTaps = 32;

__global__ void __launch_bounds__(kThreads)
gather_dx_bf16_kernel(const __nv_bfloat16* __restrict__ dout, int rows, int cout,
                      const int32_t* __restrict__ idx_t, int n, int taps,
                      const __nv_bfloat16* __restrict__ w, int cin,
                      __nv_bfloat16* __restrict__ out) {
  __shared__ int32_t s_src[kWarps][kMaxTaps];
  __shared__ int32_t s_tap[kWarps][kMaxTaps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int groups = (cin + 31) / 32;
  const int64_t task = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (task >= static_cast<int64_t>(n) * groups) return;   // warp-uniform
  const int j = static_cast<int>(task / groups);
  const int c = static_cast<int>(task % groups) * 32 + lane;

  int src = rows;       // absent sorts last
  if (lane < taps) {
    const int s = idx_t[static_cast<int64_t>(j) * taps + lane];
    if (s >= 0 && s < rows) src = s;
  }
  int rank = 0;
  for (int k = 0; k < taps; ++k) {
    const int sk = __shfl_sync(0xffffffffu, src, k);
    rank += (sk < src) || (sk == src && k < lane);
  }
  const int n_live = __popc(__ballot_sync(0xffffffffu, lane < taps && src < rows));
  if (lane < taps) {
    s_src[warp][rank] = src;
    s_tap[warp][rank] = lane;
  }
  __syncwarp();

  if (c >= cin) return;
  float acc = 0.f;    // always a bf16 value, held widened
  for (int k = 0; k < n_live; ++k) {
    const __nv_bfloat16* drow = dout + static_cast<int64_t>(s_src[warp][k]) * cout;
    const __nv_bfloat16* wcol = w + static_cast<int64_t>(s_tap[warp][k]) * cout * cin + c;
    float dot = 0.f;
#pragma unroll 8
    for (int o = 0; o < cout; ++o) {
      dot = __fadd_rn(dot, __fmul_rn(__bfloat162float(drow[o]),
                                     __bfloat162float(wcol[static_cast<int64_t>(o) * cin])));
    }
    const float contrib = __bfloat162float(__float2bfloat16_rn(dot));
    acc = __bfloat162float(__float2bfloat16_rn(__fadd_rn(acc, contrib)));
  }
  out[static_cast<int64_t>(j) * cin + c] = __float2bfloat16_rn(acc);
}

}  // namespace

extern "C" int ms3d_gather_dx_bf16(const __nv_bfloat16* dout, int rows, int cout,
                                   const int32_t* idx_t, int n, int taps,
                                   const __nv_bfloat16* w, int cin, __nv_bfloat16* out,
                                   cudaStream_t stream) {
  if (taps > kMaxTaps || taps < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || cin <= 0) return static_cast<int>(cudaSuccess);
  const int64_t tasks = static_cast<int64_t>(n) * ((cin + 31) / 32);
  const int blocks = static_cast<int>((tasks + kWarps - 1) / kWarps);
  gather_dx_bf16_kernel<<<blocks, kThreads, 0, stream>>>(dout, rows, cout, idx_t, n, taps, w,
                                                         cin, out);
  return static_cast<int>(cudaGetLastError());
}
