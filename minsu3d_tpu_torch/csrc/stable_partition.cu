// K10 stable_partition: the stable partition of a flag matrix, true first,
// with the packing of SoftGroup's (point, class) pairs or the gather of
// compact_rows as its epilogue, in one cooperative launch.
//
// Replaces the two stable argsorts of SoftGroup's grouping and what
// surrounds them: minsu3d_tpu/model/softgroup.py:121-127 (the pair
// packing: the class-major flags act_kn = active.T of the (N, K) class
// flags, order = argsort(~act_kn, stable=True)[:pair_cap], pair_valid =
// act_kn[order], pair_class = where(pair_valid, order // N, 0), pair_point
// = order % N, pairs_dropped = max(sum(act_kn) - pair_cap, 0)) and :181-189
// (compact_rows: order = argsort(~rows.valid, stable=True)[:r_cap] and the
// rows' point_idx, prop_id and valid at order). For the flags f of an (n,
// k) bool matrix, read in class-major order i = c * n + p, and m =
// min(cap, n * k) slots:
//   slot(i) = rank(i), the trues before i, for a true flag; n_true + (i -
//   rank(i)) for a false one (the false tail is part of the result: an
//   invalid pair's point is order % n); slot j < m receives flag i:
//   out_a[j] = p (pairs) or src_a[i] (compact_rows, k = 1),
//   out_b[j] = f ? c : 0 (pairs) or src_b[i] (compact_rows),
//   out_valid[j] = f; *dropped = max(n_true - cap, 0) (pairs).
// Integer-only and deterministic; equal to the argsort and gathers bit for
// bit.
//
// What bounds it on an H100: bytes -- n * k flag bytes read and 17 bytes a
// slot written (SoftGroup's main path: 1.03 MB of flags, 114688 slots, 1.9
// MB, about 0.0009 ms), so the time is latency. One cooperative launch
// (every block resident, the grid barrier of grid_sync.cuh on a __device__
// word pair, no memset) of one block an SM, each block over a contiguous
// chunk of points (a multiple of 32), in tiles whose k flags a point are
// contiguous in the matrix: a tile (32 KB of flags at most) is staged in
// shared memory by 16-byte loads, no transposed copy, and taken in rounds
// of kTilePoints points. Warp w owns a round's points 32w .. 32w + 31 and
// takes every class in turn, a ballot a class.
//   1  each block counts its chunk's trues a class (popc of the ballots)
//      and writes them, class-major; one grid barrier;
//   2  each block reads the (class, block) counts: its base in class c is
//      the trues of every lower class and of class c in earlier blocks. A
//      flag's rank is that base + the trues of class c in earlier rounds
//      and warps of its block + popc of its ballot below its lane. The
//      block writes its slots below the cap (a tile that is its block's
//      only one stays staged across the barrier).
// No sort, no atomics outside shared memory, no cast, no host sync.

#include <cuda_runtime.h>

#include <cstdint>

#include "grid_sync.cuh"

namespace {

using ms3d::grid_sync;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTilePoints = 32 * kWarps;
constexpr int kMaxK = 64;      // classes (columns of the flag matrix)
constexpr int kMaxGrid = 256;  // count columns of the scratch

__device__ uint32_t g_bar[2];  // the grid barrier: zero at load, zero after each use

struct Args {
  const unsigned char* flags;  // (n, k) bool, row-major
  int64_t n;
  int k;
  int64_t cap;
  const int64_t* src_a;        // compact_rows: (n,) gathered into out_a (k == 1); else null
  const int64_t* src_b;
  int64_t* out_a;              // (m,)
  int64_t* out_b;              // (m,)
  bool* out_valid;             // (m,)
  int64_t* dropped;            // () for the pairs; null for compact_rows
  int32_t* count;              // (kMaxK, grid) scratch, class-major
};

// Stage the flags of points [p0, p0 + np) into s (np * k bytes), 16 bytes
// a load where the rows start aligned.
__device__ void load_tile(const Args& a, int64_t p0, int np, unsigned char* s) {
  const unsigned char* g = a.flags + p0 * a.k;
  const int nb = np * a.k;
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    head = nb & ~15;
    const uint4* g4 = reinterpret_cast<const uint4*>(g);
    uint4* s4 = reinterpret_cast<uint4*>(s);
    for (int i = threadIdx.x; i < head / 16; i += kThreads) s4[i] = __ldg(g4 + i);
  }
  for (int i = head + threadIdx.x; i < nb; i += kThreads) s[i] = __ldg(g + i);
}

__global__ void __launch_bounds__(kThreads) stable_partition_kernel(Args a) {
  __shared__ __align__(16) unsigned char s_flags[kTilePoints * kMaxK];
  __shared__ uint32_t s_ball[kMaxK][kWarps];
  __shared__ int32_t s_off[kMaxK][kWarps];
  __shared__ int32_t s_base[kMaxK];    // 1: the block's counts; 2: the running base
  __shared__ int64_t s_total[kMaxK];
  __shared__ int64_t s_ntrue;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = a.k, grid = static_cast<int>(gridDim.x);
  const int64_t chunk = ((a.n + grid - 1) / grid + 31) & ~static_cast<int64_t>(31);
  const int64_t lo = min(a.n, static_cast<int64_t>(blockIdx.x) * chunk);
  const int64_t hi = min(a.n, lo + chunk);
  // a tile is `rounds` rounds of kTilePoints points, as many as its flags
  // fill s_flags (64 rounds at k = 1, 3 at k = 18)
  const int64_t tile = static_cast<int64_t>(kTilePoints) * (kMaxK / k);
  const int tiles = static_cast<int>((hi - lo + tile - 1) / tile);
  for (int c = threadIdx.x; c < k; c += kThreads) s_base[c] = 0;
  __syncthreads();

  // 1: this chunk's trues a class
  for (int t = 0; t < tiles; ++t) {
    const int64_t p0 = lo + t * tile;
    const int np = static_cast<int>(min(tile, hi - p0));
    if (t > 0) __syncthreads();  // the previous tile's flags are read
    load_tile(a, p0, np, s_flags);
    __syncthreads();
    for (int pl = 32 * warp + lane; pl - lane < np; pl += kTilePoints) {
      for (int c = 0; c < k; ++c) {
        const bool f = pl < np && s_flags[pl * k + c] != 0;
        const int cnt = __popc(__ballot_sync(0xffffffffu, f));
        if (lane == 0 && cnt != 0) atomicAdd(&s_base[c], cnt);
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < k; c += kThreads) a.count[c * grid + blockIdx.x] = s_base[c];
  grid_sync(g_bar);

  // 2: every class's total and its trues in the blocks before this one
  for (int c = warp; c < k; c += kWarps) {
    const int32_t* row = a.count + c * grid;
    int tot = 0, before = 0;
    for (int b = lane; b < grid; b += 32) {
      const int x = __ldcg(row + b);
      tot += x;
      before += b < static_cast<int>(blockIdx.x) ? x : 0;
    }
    tot = __reduce_add_sync(0xffffffffu, tot);
    before = __reduce_add_sync(0xffffffffu, before);
    if (lane == 0) {
      s_total[c] = tot;
      s_base[c] = before;
    }
  }
  __syncthreads();
  if (warp == 0) {  // base[c] += the trues of the classes below c; 2 classes a lane
    int64_t t[2], sum = 0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = 2 * lane + j;
      t[j] = c < k ? s_total[c] : 0;
      sum += t[j];
    }
    int64_t incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t x = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += x;
    }
    int64_t run = incl - sum;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = 2 * lane + j;
      if (c < k) s_base[c] += static_cast<int32_t>(run);
      run += t[j];
    }
    if (lane == 31) s_ntrue = incl;
  }
  __syncthreads();
  const int64_t n_true = s_ntrue;
  if (a.dropped && blockIdx.x == 0 && threadIdx.x == 0) {
    *a.dropped = n_true > a.cap ? n_true - a.cap : 0;
  }

  for (int t = 0; t < tiles; ++t) {
    const int64_t p0 = lo + t * tile;
    const int np = static_cast<int>(min(tile, hi - p0));
    if (tiles > 1) {  // else the tile is still staged from phase 1
      load_tile(a, p0, np, s_flags);
      __syncthreads();
    }
    for (int r0 = 0; r0 < np; r0 += kTilePoints) {  // a round of kTilePoints points
      const int pl = r0 + 32 * warp + lane;
      for (int c = 0; c < k; ++c) {
        const unsigned ball = __ballot_sync(0xffffffffu, pl < np && s_flags[pl * k + c] != 0);
        if (lane == 0) s_ball[c][warp] = ball;
      }
      __syncthreads();
      for (int c = threadIdx.x; c < k; c += kThreads) {  // offsets of the warps a class
        int32_t run = s_base[c];
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          s_off[c][w] = run;
          run += __popc(s_ball[c][w]);
        }
        s_base[c] = run;
      }
      __syncthreads();
      if (pl < np) {
        const int64_t p = p0 + pl;
        for (int c = 0; c < k; ++c) {
          const unsigned ball = s_ball[c][warp];
          const bool f = (ball >> lane) & 1u;
          const int64_t rank = s_off[c][warp] + __popc(ball & ((1u << lane) - 1u));
          const int64_t i = static_cast<int64_t>(c) * a.n + p;
          const int64_t slot = f ? rank : n_true + (i - rank);
          if (slot < a.cap) {
            a.out_a[slot] = a.src_a ? __ldg(reinterpret_cast<const long long*>(a.src_a) + i) : p;
            a.out_b[slot] = a.src_b ? __ldg(reinterpret_cast<const long long*>(a.src_b) + i)
                                    : (f ? c : 0);
            a.out_valid[slot] = f;
          }
        }
      }
      __syncthreads();  // s_ball and s_off are rewritten by the next round
    }
  }
}

// Kernel launches enqueued so far, for the tests' count of a call's launches.
int64_t g_device_ops = 0;

}  // namespace

extern "C" int64_t ms3d_stable_partition_device_ops() { return g_device_ops; }

// flags (n, k) bool, row-major (k <= 64); src_a, src_b (n,) int64 or null
// (both null: the pair packing; both given: compact_rows, k == 1); out_a,
// out_b (min(cap, n * k),) int64, out_valid bool, dropped () int64 (the
// pairs) or null (compact_rows); scratch
// of kMaxK * kMaxGrid int32. One cooperative launch on `stream`, no memset.
extern "C" int ms3d_stable_partition(const bool* flags, int64_t n, int k, int64_t cap,
                                     const int64_t* src_a, const int64_t* src_b, int64_t* out_a,
                                     int64_t* out_b, bool* out_valid, int64_t* dropped,
                                     int32_t* scratch, cudaStream_t stream) {
  if (n < 0 || k < 1 || k > kMaxK || cap < 0 || n * k > INT32_MAX ||
      (src_a != nullptr) != (src_b != nullptr) || (src_a != nullptr && k != 1) ||
      (src_a != nullptr) == (dropped != nullptr)) {
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
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stable_partition_kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    grid[dev] = sms < kMaxGrid ? sms : kMaxGrid;
  }
  Args a{reinterpret_cast<const unsigned char*>(flags), n, k, cap, src_a, src_b, out_a, out_b,
         out_valid, dropped, scratch};
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(stable_partition_kernel),
                                    dim3(grid[dev]), dim3(kThreads), params, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++g_device_ops;
  return static_cast<int>(err);
}
