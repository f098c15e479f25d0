// K17 unique_compact: the unique keys of a sorted key column and, on
// request, the compacted fixed-capacity table they make.
//
// Replaces minsu3d_tpu/ops/hashing.py:158 unique_sorted (first-occurrence
// flags, segment ids, n_unique) and the compaction scatters of
// minsu3d_tpu/ops/sparse.py:111-131 build_base (the sorted table with
// SENTINEL padding, row2voxel, the representative rows). Inputs: the
// sorted int64 keys (khi << 31 | klo, from K15), their valid flags in
// sorted order, the permutation (sorted position -> input row) and the
// table capacity. Outputs, per sorted row i:
//   first[i] = valid[i] && (i == 0 || key[i] != key[i - 1]);
//   seg[i]   = valid[i] ? (firsts in [0, i]) - 1 : n_unique;
//   *n_unique = the count of first flags;
// and with a table (row2voxel not null), with u = seg[i]:
//   row2voxel[perm[i]] = valid[i] && u < cap ? u : cap;
//   for a first row with u < cap: khi[u] = key >> 31, klo[u] = key &
//     (2^31 - 1), coords[u] = (klo >> 20, klo >> 10, klo) & 1023, batch[u]
//     = khi, valid[u] = 1, src[u] = perm[i] (the representative input row:
//     the first in key order, the lowest row of a duplicate run because K15
//     is stable); slots min(n_unique, cap) .. cap - 1 read khi = klo =
//     SENTINEL, coords 0, batch 0, valid 0, src -1;
//   *count = min(n_unique, cap), *n_dropped = max(n_unique - cap, 0).
// Every count stays on the device: no host read.
//
// What bounds it on an H100: bytes -- the flags and permutation read once
// (5 bytes a row), a key only where its row or the next is valid (8 bytes
// a live row: is_first never reads an invalid row's key), flags, segment
// ids and row2voxel written once (9 bytes a row), the table written once
// (29 bytes a slot): ~4.6 MB for 98304 rows, 41610 of them live, into a
// 98304-slot table, about 1.4 us. Two
// launches, as K10's stable partition (csrc/stable_partition.cu):
// unique_count_kernel counts each tile's first flags (a warp ballot and
// popc); unique_scatter_kernel sums the earlier tiles' counts (its base)
// and all of them (n_unique) with a block reduction, then walks its tile
// in rounds of kThreads rows, a row's inclusive rank being the base + the
// earlier rounds + the earlier warps + popc of its warp's ballot up to its
// lane. No atomics; integer-only, so equal to its plain version bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;
constexpr int kTile = kThreads * kRounds;
constexpr int32_t kSentinel = 0x7fffffff;

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

__device__ __forceinline__ bool is_first(const int64_t* __restrict__ key,
                                         const bool* __restrict__ valid, int64_t i) {
  return valid[i] && (i == 0 || key[i] != key[i - 1]);
}

__global__ void unique_count_kernel(const int64_t* __restrict__ key,
                                    const bool* __restrict__ valid, int64_t n,
                                    int32_t* __restrict__ tile_count) {
  __shared__ int s_warp[kWarps];
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kTile;
  int c = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = start + r * kThreads + threadIdx.x;
    c += (i < n && is_first(key, valid, i)) ? 1 : 0;
  }
  c = block_sum(c, s_warp);
  if (threadIdx.x == 0) tile_count[blockIdx.x] = c;
}

struct Table {
  int32_t* row2voxel;
  int32_t* khi;
  int32_t* klo;
  int32_t* coords;
  int32_t* batch;
  bool* valid;
  int32_t* src;
  int32_t* count;
  int32_t* n_dropped;
};

__global__ void unique_scatter_kernel(const int64_t* __restrict__ key,
                                      const bool* __restrict__ valid,
                                      const int32_t* __restrict__ perm, int64_t n, int32_t cap,
                                      const int32_t* __restrict__ tile_count, int n_tiles,
                                      bool* __restrict__ first_out, int32_t* __restrict__ seg_out,
                                      int32_t* __restrict__ n_unique, Table tab) {
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
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *n_unique = total;
    if (tab.row2voxel) {
      *tab.count = total < cap ? total : cap;
      *tab.n_dropped = total > cap ? total - cap : 0;
    }
  }

  const int64_t start = static_cast<int64_t>(blockIdx.x) * kTile;
  int run = before;  // first flags before this round's first row
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = start + r * kThreads + threadIdx.x;
    const bool f = i < n && is_first(key, valid, i);
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
      const int incl = run + warp_before + __popc(ball & ((2u << lane) - 1u));
      const bool v = valid[i];
      const int32_t u = v ? incl - 1 : total;
      first_out[i] = f;
      seg_out[i] = u;
      if (tab.row2voxel) {
        const int32_t p = perm[i];
        tab.row2voxel[p] = (v && u < cap) ? u : cap;
        if (f && u < cap) {
          const int64_t k = key[i];
          const int32_t hi = static_cast<int32_t>(k >> 31);
          const int32_t lo = static_cast<int32_t>(k & 0x7fffffff);
          tab.khi[u] = hi;
          tab.klo[u] = lo;
          tab.coords[3 * u] = (lo >> 20) & 1023;
          tab.coords[3 * u + 1] = (lo >> 10) & 1023;
          tab.coords[3 * u + 2] = lo & 1023;
          tab.batch[u] = hi;
          tab.valid[u] = true;
          tab.src[u] = p;
        }
      }
    }
    run += round_total;
  }

  if (tab.row2voxel) {  // the padding slots
    const int32_t used = total < cap ? total : cap;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    for (int64_t u = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; u < cap;
         u += stride) {
      if (u < used) continue;
      tab.khi[u] = kSentinel;
      tab.klo[u] = kSentinel;
      tab.coords[3 * u] = tab.coords[3 * u + 1] = tab.coords[3 * u + 2] = 0;
      tab.batch[u] = 0;
      tab.valid[u] = false;
      tab.src[u] = -1;
    }
  }
}

}  // namespace

// tile_count: scratch of ms3d_unique_compact_tiles(n) int32.
extern "C" int ms3d_unique_compact_tiles(int64_t n) {
  const int64_t t = (n + kTile - 1) / kTile;
  return static_cast<int>(t > 0 ? t : 1);
}

// row2voxel null: no table (perm, khi, ..., n_dropped are then not read or
// written); else perm and every table pointer must be set.
extern "C" int ms3d_unique_compact(const int64_t* s_key, const bool* s_valid,
                                   const int32_t* perm, int64_t n, int32_t cap,
                                   int32_t* tile_count, bool* first, int32_t* seg,
                                   int32_t* n_unique, int32_t* row2voxel, int32_t* khi,
                                   int32_t* klo, int32_t* coords, int32_t* batch, bool* valid,
                                   int32_t* src, int32_t* count, int32_t* n_dropped,
                                   cudaStream_t stream) {
  if (n < 0 || n > INT32_MAX || cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = ms3d_unique_compact_tiles(n);
  unique_count_kernel<<<n_tiles, kThreads, 0, stream>>>(s_key, s_valid, n, tile_count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Table tab{row2voxel, khi, klo, coords, batch, valid, src, count, n_dropped};
  unique_scatter_kernel<<<n_tiles, kThreads, 0, stream>>>(s_key, s_valid, perm, n, cap,
                                                          tile_count, n_tiles, first, seg,
                                                          n_unique, tab);
  return static_cast<int>(cudaGetLastError());
}
