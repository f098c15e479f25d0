// K10 stable_partition: the stable partition of a flag vector, true first.
//
// Replaces the two stable argsorts of SoftGroup's grouping,
// minsu3d_tpu/model/softgroup.py:124 (soft_grouping_packed:
// jnp.argsort(~act_kn, stable=True)[:pair_cap], the (point, class) pair
// packing over K*N class-major flags) and :183 (compact_rows:
// jnp.argsort(~rows.valid, stable=True)[:r_cap]). For L flags and a cap:
//   order[j], j < min(cap, L): the indices of the true flags in ascending
//     order, then those of the false flags in ascending order (the false
//     tail is part of the result: an invalid pair's point is order % N);
//   *n_true: the count of true flags.
// Integer-only and deterministic; equal to the argsort bit for bit.
//
// What bounds it on an H100: bytes -- L flag bytes read and 4 * min(cap, L)
// bytes written (1.03 MB and 0.46 MB on SoftGroup's main path, L =
// 18 x 57344, cap = 2 x 57344: about half a microsecond), so at this size
// the two launches' latency is the real cost. Design: tiles of kTile
// flags. partition_count_kernel: each block counts its tile's trues (a
// warp ballot and popc per 32 flags). partition_scatter_kernel: each block
// sums the counts of the tiles before it (its base) and of all tiles
// (n_true), a block reduction over L / kTile ints, then walks its tile in
// rounds of kThreads flags: a
// flag's rank among the trues before it is base + the trues of the earlier
// rounds + the exclusive prefix of the warp counts + popc of its warp's
// ballot below its lane. A true flag i goes to that rank, a false one to
// n_true + (i - that rank); only slots below cap are written. No sort,
// no atomics, no data-dependent pass count.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;
constexpr int kTile = kThreads * kRounds;

// Sum of v over the block, returned to every thread; s_warp holds kWarps ints.
__device__ int block_sum(int v, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_add_sync(0xffffffffu, v);
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += s_warp[w];
  __syncthreads();  // s_warp is reused by the next call
  return total;
}

__global__ void partition_count_kernel(const bool* __restrict__ flags, int64_t n,
                                       int32_t* __restrict__ tile_count) {
  __shared__ int s_warp[kWarps];
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kTile;
  int c = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = start + r * kThreads + threadIdx.x;
    c += (i < n && flags[i]) ? 1 : 0;
  }
  c = block_sum(c, s_warp);
  if (threadIdx.x == 0) tile_count[blockIdx.x] = c;
}

__global__ void partition_scatter_kernel(const bool* __restrict__ flags, int64_t n,
                                         const int32_t* __restrict__ tile_count, int n_tiles,
                                         int64_t cap, int32_t* __restrict__ order,
                                         int32_t* __restrict__ n_true) {
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int before = 0, total = 0;
  for (int t = threadIdx.x; t < n_tiles; t += kThreads) {
    const int v = tile_count[t];
    total += v;
    if (t < static_cast<int>(blockIdx.x)) before += v;
  }
  before = block_sum(before, s_warp);
  total = block_sum(total, s_warp);
  if (blockIdx.x == 0 && threadIdx.x == 0) *n_true = total;

  const int64_t start = static_cast<int64_t>(blockIdx.x) * kTile;
  int64_t run = before;  // trues before this round's first flag
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = start + r * kThreads + threadIdx.x;
    const bool f = i < n && flags[i];
    const unsigned ball = __ballot_sync(0xffffffffu, f);
    if (lane == 0) s_warp[warp] = __popc(ball);
    __syncthreads();
    int warp_before = 0, round_total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_warp[w];
      warp_before += w < warp ? c : 0;
      round_total += c;
    }
    __syncthreads();
    if (i < n) {
      const int64_t rank = run + warp_before + __popc(ball & ((1u << lane) - 1u));
      const int64_t slot = f ? rank : total + (i - rank);
      if (slot < cap) order[slot] = static_cast<int32_t>(i);
    }
    run += round_total;
  }
}

}  // namespace

// tile_count: scratch of ms3d_stable_partition_tiles(n) int32.
extern "C" int ms3d_stable_partition_tiles(int64_t n) {
  return static_cast<int>((n + kTile - 1) / kTile);
}

extern "C" int ms3d_stable_partition(const bool* flags, int64_t n, int64_t cap,
                                     int32_t* tile_count, int32_t* order, int32_t* n_true,
                                     cudaStream_t stream) {
  if (n < 0 || n > INT32_MAX || cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaMemsetAsync(n_true, 0, sizeof(int32_t), stream));
  const int n_tiles = ms3d_stable_partition_tiles(n);
  partition_count_kernel<<<n_tiles, kThreads, 0, stream>>>(flags, n, tile_count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  partition_scatter_kernel<<<n_tiles, kThreads, 0, stream>>>(flags, n, tile_count, n_tiles,
                                                             cap, order, n_true);
  return static_cast<int>(cudaGetLastError());
}
