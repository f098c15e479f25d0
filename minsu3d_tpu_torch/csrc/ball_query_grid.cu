// K14 ball_query_grid: up to K same-(batch, group) neighbours within r per
// query unit of a single-occupancy grid, in cell-offset order.
//
// Replaces minsu3d_tpu/ops/ballquery.py:176 ball_query_grid (the sorted-
// union exact-match lookup over every pruned cell offset, the distance test
// and the positional K cap). It computes what that function computes, not
// its schedule. The wrapper (minsu3d_tpu_torch/ops/ballquery.py) hashes the
// cells in torch and hands this kernel:
//   cell[u]     the unit's cell, each axis in [0, 1024),
//   key_hi[u]   batch << 16 | group,
//   s_key       the units' int64 keys (key_hi << 31 | packed cell, invalid
//               units as the SENTINEL pair) in stable sorted order, and
//   perm        sorted row -> unit,
//   offs        the pruned cell offsets (n_off, 3), in the JAX enumeration
//               order, computed on the host in Python floats.
// Per query unit u and offset o in order: the neighbour cell's key is
// searched in s_key; on an exact match the LAST row of the equal-key run
// (upper_bound - 1) is the candidate, as lookup_sorted_union's idx = cnt - 1
// (minsu3d_tpu/ops/hashing.py:150-154) -- that decides the result when two
// units share a cell (a centroid rounded onto its cell's far face). The
// candidate is kept when |c - q|^2 <= r^2, computed with explicitly rounded
// f32 operations (no fused multiply-add) as the plain version's separate
// tensor ops compute it; the first K kept fill the row, the rest is n.
//
// What bounds it on an H100: one thread per unit reads its cell and key,
// then per offset ~log2(U) = 16 dependent 8-byte loads of the binary search
// and, on a match, perm + 12 B of coordinates: HBM / L2 latency of the
// scattered searches bounds it (the sorted keys, 0.3 MB at U = 40960, sit in
// L2); the flops are negligible. Design, simple for now: one thread per
// unit, the offsets staged in shared memory tile by tile (any m works),
// early exit once K neighbours are found. A warp per query and shared-memory
// key tiles are later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kOffTile = 512;  // offsets staged per pass (m = 2 gives <= 125)
constexpr int kCoordMax = 1024;

__device__ __forceinline__ int64_t upper_bound(const int64_t* __restrict__ s_key, int n,
                                               int64_t q) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_key[mid] <= q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void ball_query_grid_kernel(const float* __restrict__ coords,
                                       const bool* __restrict__ valid,
                                       const int32_t* __restrict__ cell,
                                       const int64_t* __restrict__ key_hi,
                                       const int64_t* __restrict__ s_key,
                                       const int32_t* __restrict__ perm,
                                       const int32_t* __restrict__ offs, int n, int n_off,
                                       int k, float r2, int32_t* __restrict__ nbr) {
  __shared__ int32_t s_off[3 * kOffTile];
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = u < n && valid[u];
  int cx = 0, cy = 0, cz = 0;
  int64_t hi = 0;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    cx = cell[3 * static_cast<int64_t>(u)];
    cy = cell[3 * static_cast<int64_t>(u) + 1];
    cz = cell[3 * static_cast<int64_t>(u) + 2];
    hi = key_hi[u] << 31;
    qx = coords[3 * static_cast<int64_t>(u)];
    qy = coords[3 * static_cast<int64_t>(u) + 1];
    qz = coords[3 * static_cast<int64_t>(u) + 2];
  }
  int32_t* row = nbr + static_cast<int64_t>(u) * k;
  int cnt = 0;
  // every thread of the block takes part in each tile's barriers
  for (int base = 0; base < n_off; base += kOffTile) {
    const int tile = min(kOffTile, n_off - base);
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * tile; i += blockDim.x) s_off[i] = offs[3 * base + i];
    __syncthreads();
    for (int o = 0; o < tile && live && cnt < k; ++o) {
      const int x = cx + s_off[3 * o], y = cy + s_off[3 * o + 1], z = cz + s_off[3 * o + 2];
      if (x < 0 || x >= kCoordMax || y < 0 || y >= kCoordMax || z < 0 || z >= kCoordMax) {
        continue;
      }
      const int64_t q = hi | (static_cast<int64_t>(x) << 20) |
                        (static_cast<int64_t>(y) << 10) | static_cast<int64_t>(z);
      const int64_t idx = upper_bound(s_key, n, q) - 1;
      if (idx < 0 || s_key[idx] != q) continue;
      const int32_t c = perm[idx];
      const float dx = __fsub_rn(coords[3 * static_cast<int64_t>(c)], qx);
      const float dy = __fsub_rn(coords[3 * static_cast<int64_t>(c) + 1], qy);
      const float dz = __fsub_rn(coords[3 * static_cast<int64_t>(c) + 2], qz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (d2 <= r2) row[cnt++] = c;
    }
  }
  if (u < n) {
    for (; cnt < k; ++cnt) row[cnt] = n;
  }
}

}  // namespace

// coords (n, 3) f32; valid (n,) bool; cell (n, 3) int32; key_hi, s_key (n,)
// int64; perm (n,) int32; offs (n_off, 3) int32 in device memory; nbr (n, k)
// int32 written in full.
extern "C" int ms3d_ball_query_grid(const float* coords, const bool* valid, const int32_t* cell,
                                    const int64_t* key_hi, const int64_t* s_key,
                                    const int32_t* perm, const int32_t* offs, int n, int n_off,
                                    int k, float r2, int32_t* nbr, cudaStream_t stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  if (n_off <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  ball_query_grid_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      coords, valid, cell, key_hi, s_key, perm, offs, n, n_off, k, r2, nbr);
  return static_cast<int>(cudaGetLastError());
}
