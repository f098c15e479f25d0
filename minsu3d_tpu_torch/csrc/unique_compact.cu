// K17 unique_compact: the unique keys of a sorted key column and, on
// request, the compacted fixed-capacity table they make.
//
// Replaces minsu3d_tpu/ops/hashing.py:158 unique_sorted (first-occurrence
// flags, segment ids, n_unique) and the compaction scatters of
// minsu3d_tpu/ops/sparse.py:111-131 build_base (the sorted table with
// SENTINEL padding, row2voxel, the representative rows). Inputs: the
// sorted int64 keys (khi << 31 | klo, from K15), the valid flags, the
// permutation (sorted position -> input row, or null) and the table
// capacity. With a permutation the flags are in input-row order and the
// kernel reads valid[perm[i]] (build_base's gather, done here); without
// one they are in sorted order. With v(i) the valid flag of sorted row i,
// the outputs are, per sorted row i:
//   first[i] = v(i) && (i == 0 || key[i] != key[i - 1]);
//   seg[i]   = v(i) ? (firsts in [0, i]) - 1 : n_unique;
//   *n_unique = the count of first flags;
// and with a table (cap >= 0), with u = seg[i]:
//   row2voxel[perm[i]] = v(i) && u < cap ? u : cap;
//   for a first row with u < cap: khi[u] = key >> 31, klo[u] = key &
//     (2^31 - 1), coords[u] = (klo >> 20, klo >> 10, klo) & 1023, batch[u]
//     = khi, src[u] = perm[i] (the representative input row: the first in
//     key order, the lowest row of a duplicate run because K15 is stable);
//   valid[u] = u < min(n_unique, cap); slots min(n_unique, cap) .. cap - 1
//     read khi = klo = SENTINEL, coords 0, batch 0, src -1;
//   *count = min(n_unique, cap), *n_dropped = max(n_unique - cap, 0).
// Every count stays on the device: no host read.
//
// What bounds it on an H100: bytes -- the flags and permutation read once
// (5 bytes a row), a key only where its row is valid (8 bytes a live row:
// an invalid row's first flag never reads a key), flags, segment ids and
// row2voxel written once (9 bytes a row), the table written once (29 bytes
// a slot): ~4.6 MB for 98304 rows, 41610 of them live, into a 98304-slot
// table, about 1.4 us. The time is latency: one pass counts, the next
// needs every earlier count. So the call is one cooperative launch (every
// block resident, grid barrier of grid_sync.cuh on a __device__ word pair,
// no memset) whose grid fills the card: each block takes one contiguous
// chunk of ceil(n / grid) rows,
//   1  counts its chunk's first flags (a block reduction) into its tile
//      count;
//   2  after the barrier sums the tile counts before it (its base) and all
//      of them (n_unique), then walks its chunk in rounds of kThreads rows,
//      a row's inclusive rank being the base + the earlier rounds + the
//      earlier warps + popc of its warp's ballot up to its lane, and
//      writes the row's outputs and its first row's slot; then every block
//      writes its share of the padding slots and the valid flags with
//      16-byte stores, so each slot is written once.
// No atomics; integer-only, so equal to its plain version bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

#include "grid_sync.cuh"

namespace {

using ms3d::grid_sync;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocksPerSm = 2;
constexpr int kMaxGrid = 1024;     // tile counts of the scratch (UNIQUE_GRID_MAX)
constexpr int32_t kSentinel = 0x7fffffff;

__device__ uint32_t g_bar[2];     // the grid barrier: zero at load, zero after each use

struct Args {
  const int64_t* key;    // (n,) sorted
  const bool* valid;     // (n,) in input order with perm, else in sorted order
  const int32_t* perm;   // (n,) sorted position -> input row, or null
  int64_t n;
  int32_t cap;
  int32_t* tile_count;   // (grid,) scratch
  bool* first;           // (n,)
  int32_t* seg;          // (n,)
  int32_t* scalars;      // (3,) n_unique, count, n_dropped
  bool table;            // else nothing below is read or written
  int32_t* row2voxel;    // (n,)
  int32_t* khi;          // (cap,) each
  int32_t* klo;
  int32_t* coords;       // (cap, 3)
  int32_t* batch;
  int32_t* src;
  bool* tvalid;          // (cap,)
};

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

// Sorted row i: its input row (p), its valid flag and its first flag.
struct Row {
  int32_t p;
  bool v, f;
};

__device__ __forceinline__ Row load_row(const Args& a, int64_t i) {
  Row r;
  r.p = a.perm ? __ldg(a.perm + i) : static_cast<int32_t>(i);
  r.v = __ldg(reinterpret_cast<const unsigned char*>(a.valid) + r.p) != 0;
  r.f = r.v && (i == 0 || __ldg(a.key + i) != __ldg(a.key + i - 1));
  return r;
}

// p[lo, hi) = v by this thread's share (t of stride): scalar stores up to
// the first 16-byte boundary and after the last, 16-byte stores between.
template <typename T>
__device__ void fill(T* p, int64_t lo, int64_t hi, T v, int64_t t, int64_t stride) {
  if (lo >= hi) return;
  constexpr int kPer = 16 / sizeof(T);
  const int64_t mis = (reinterpret_cast<uintptr_t>(p + lo) & 15) / sizeof(T);
  const int64_t a0 = lo + min(static_cast<int64_t>((kPer - mis) % kPer), hi - lo);
  const int64_t a1 = a0 + (hi - a0) / kPer * kPer;
  for (int64_t j = lo + t; j < a0; j += stride) p[j] = v;
  union {
    T e[kPer];
    uint4 w;
  } u;
#pragma unroll
  for (int e = 0; e < kPer; ++e) u.e[e] = v;
  uint4* q = reinterpret_cast<uint4*>(p + a0);
  for (int64_t j = t; j < (a1 - a0) / kPer; j += stride) q[j] = u.w;
  for (int64_t j = a1 + t; j < hi; j += stride) p[j] = v;
}

__global__ void __launch_bounds__(kThreads) unique_compact_kernel(Args a) {
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t chunk = (a.n + gridDim.x - 1) / gridDim.x;
  const int64_t lo = min(a.n, static_cast<int64_t>(blockIdx.x) * chunk);
  const int64_t hi = min(a.n, lo + chunk);

  int c = 0;  // phase 1: this chunk's first flags
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) c += load_row(a, i).f ? 1 : 0;
  c = block_sum(c, s_warp);
  if (threadIdx.x == 0) a.tile_count[blockIdx.x] = c;
  grid_sync(g_bar);

  int before = 0, total = 0;  // phase 2
  for (int t = threadIdx.x; t < static_cast<int>(gridDim.x); t += kThreads) {
    const int v = __ldcg(a.tile_count + t);
    total += v;
    if (t < static_cast<int>(blockIdx.x)) before += v;
  }
  before = block_sum(before, s_warp);
  total = block_sum(total, s_warp);
  const int32_t cap = a.cap;
  const int32_t used = total < cap ? total : cap;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.scalars[0] = total;
    if (a.table) {
      a.scalars[1] = used;
      a.scalars[2] = total > cap ? total - cap : 0;
    }
  }

  int run = before;  // first flags before this round's first row
  for (int64_t base = lo; base < hi; base += kThreads) {
    const int64_t i = base + threadIdx.x;
    Row r{0, false, false};
    if (i < hi) r = load_row(a, i);
    const unsigned ball = __ballot_sync(0xffffffffu, r.f);
    if (lane == 0) s_warp[warp] = __popc(ball);
    __syncthreads();
    int warp_before = 0, round_total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int cw = s_warp[w];
      warp_before += w < warp ? cw : 0;
      round_total += cw;
    }
    __syncthreads();
    if (i < hi) {
      const int incl = run + warp_before + __popc(ball & ((2u << lane) - 1u));
      const int32_t u = r.v ? incl - 1 : total;
      a.first[i] = r.f;
      a.seg[i] = u;
      if (a.table) {
        a.row2voxel[r.p] = (r.v && u < cap) ? u : cap;
        if (r.f && u < cap) {
          const int64_t k = __ldg(a.key + i);
          const int32_t khi = static_cast<int32_t>(k >> 31);
          const int32_t klo = static_cast<int32_t>(k & 0x7fffffff);
          a.khi[u] = khi;
          a.klo[u] = klo;
          a.coords[3 * static_cast<int64_t>(u)] = (klo >> 20) & 1023;
          a.coords[3 * static_cast<int64_t>(u) + 1] = (klo >> 10) & 1023;
          a.coords[3 * static_cast<int64_t>(u) + 2] = klo & 1023;
          a.batch[u] = khi;
          a.src[u] = r.p;
        }
      }
    }
    run += round_total;
  }

  if (a.table) {  // the padding slots and the valid flags, once each
    const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    fill<int32_t>(a.khi, used, cap, kSentinel, t, stride);
    fill<int32_t>(a.klo, used, cap, kSentinel, t, stride);
    fill<int32_t>(a.batch, used, cap, 0, t, stride);
    fill<int32_t>(a.src, used, cap, -1, t, stride);
    fill<int32_t>(a.coords, 3 * static_cast<int64_t>(used), 3 * static_cast<int64_t>(cap), 0,
                  t, stride);
    fill<uint8_t>(reinterpret_cast<uint8_t*>(a.tvalid), 0, used, 1, t, stride);
    fill<uint8_t>(reinterpret_cast<uint8_t*>(a.tvalid), used, cap, 0, t, stride);
  }
}

// Kernel launches enqueued so far, for the tests' count of a call's launches.
int64_t g_device_ops = 0;

}  // namespace

extern "C" int64_t ms3d_unique_compact_device_ops() { return g_device_ops; }

// s_key (n,) int64 sorted; valid (n,) bool, in input order when perm (n,)
// int32 is set, else in sorted order; tile_count scratch of 1024 int32;
// first (n,) bool, seg (n,) int32, scalars (3,) int32. cap < 0: no table
// (row2voxel ... tvalid are then not read or written); else row2voxel (n,),
// khi, klo, batch, src (cap,), coords (cap, 3) int32 and tvalid (cap,)
// bool, and perm must be set (where n > 0). One cooperative launch on
// `stream`, no memset.
extern "C" int ms3d_unique_compact(const int64_t* s_key, const bool* valid, const int32_t* perm,
                                   int64_t n, int32_t cap, int32_t* tile_count, bool* first,
                                   int32_t* seg, int32_t* scalars, int32_t* row2voxel,
                                   int32_t* khi, int32_t* klo, int32_t* coords, int32_t* batch,
                                   int32_t* src, bool* tvalid, cudaStream_t stream) {
  const bool table = cap >= 0;
  if (n < 0 || n > INT32_MAX || (table && n > 0 && !perm)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int grid[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (grid[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, unique_compact_kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    const int g = sms * (per_sm < kMaxBlocksPerSm ? per_sm : kMaxBlocksPerSm);
    grid[dev] = g < kMaxGrid ? g : kMaxGrid;
  }
  Args a{s_key, valid, perm, n, cap, tile_count, first, seg, scalars,
         table, row2voxel, khi, klo, coords, batch, src, tvalid};
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(unique_compact_kernel),
                                    dim3(grid[dev]), dim3(kThreads), params, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++g_device_ops;
  return static_cast<int>(err);
}
