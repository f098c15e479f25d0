// K22 tap_orders: the tap orders of several index tables in one launch, the
// tile order K1 reads (ops/sparse_conv.py tap_orders, conv_tables), and the
// k2s2 tables of a plan's level boundaries built in the same launch.
//
// Part of K1's design (csrc/gather_gemm.cu, point 2), so it stands for the
// same JAX code: minsu3d_tpu/ops/sparse_conv.py:50 subm_conv, :66
// down_conv and :80 up_conv, which gather every tap of every row and need
// no order; the k2s2 tables stand for down_conv's scatter-add
// `.at[child.parent_idx].add` and up_conv's gather at `child.parent_idx`.
// For table i (idx_i (R_i, T_i) int32, any value >= n_i absent) the order
// is its rows sorted stably by
//   key_i[r] = the bits t with idx_i[r, t] >= n_i
// (a row with no live tap has all T_i bits set and sorts last), with the
// sorted keys. A table is given (a kernel map, or any caller's table), or
// built here from a child level's links (parent_idx, child_kid, valid):
//   down (parent_cap, 8): child c at (parent_idx[c], child_kid[c]) for each
//        valid child with a parent under the cap (the pairs are unique, so
//        plain stores), the child cap elsewhere;
//   up   (child_cap, 8): parent_idx[c] in column child_kid[c] of valid
//        rows, the parent cap everywhere else.
//
// The sort is a stable LSD radix sort a table, every table in the same
// passes: digits of min(T, 9) bits (a kernel map's 27 bits in 3 passes, an
// 8-tap table's in 1; an up row has one live tap or none, 9 key values),
// each table histogrammed over its own tiles of kTile rows, so no table-id
// bits and no pass that maps a global order back to each table. The first
// phase computes every row's key, 32 rows a warp, the tables' row groups
// dealt over all the grid's warps (a given table's rows staged through
// shared memory by cp.async, so that its reads coalesce), and counts each
// row's first digit into its tile's histogram (int32 atomics,
// warp-aggregated: order-free, so exact). Then a phase a pass: every tile
// finds where its digits start (the table's digit totals and the tiles
// before it, summed from the histograms), ranks its rows in one round (4
// rows a thread; warp match against per-warp running digit counts, the
// warps' counts scanned a digit a thread), scatters them stably and counts
// each into the next pass's histogram of the tile it lands in. The launch
// is cooperative, its phases separated by the grid barrier of
// grid_sync.cuh, whose words are a __device__ variable (back at zero after
// every barrier); a memset zeroes the histograms before it. A down table
// is filled in phase 0, its children written in phase 1 and sorted from
// phase 2, while the kernel maps run their passes. The 7-level backbone's
// 19 tables: a memset, one launch of 4 phases and 3 barriers. Integer-only
// and stable, so equal bit for bit to one stable sort a table (the plain
// version).
//
// What bounds it on an H100: bytes. The given tables are read once (4 T
// bytes a row), the links and flags once, the k2s2 tables written once,
// each row's sorted key and permutation entry written once: 38 MB, 11 us,
// for PointGroup's 19 tables (485376 rows). The passes' key columns and
// their barriers (~1.5 us each) come on top; a phase's time is its slowest
// block's. What a forward pass felt before was the host's work: ~70 small
// torch ops building the k2s2 tables around a K22 call of three launches
// (PERF.md).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "grid_sync.cuh"

namespace {

using ms3d::grid_sync;

constexpr int kMaxTables = 32;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;                   // rows a thread in a scatter
constexpr int kTile = kThreads * kItems;    // rows a tile (the wrapper's TAP_TILE)
constexpr int kBuckets = 512;               // 9-bit digits at most (TAP_BUCKETS)
constexpr int kDescWords = 9;               // int64 words of a table's descriptor
constexpr int kMaxBlocksPerSm = 1;
constexpr int kStageBytes = kWarps * 32 * 32 * 4;   // dynamic: a warp's 32 rows of <= 32 taps

enum Kind : int { kGiven = 0, kDown = 1, kUp = 2 };

__device__ uint32_t g_bar[2];     // the grid barrier: zero at load, zero after each use

struct Table {
  int32_t* idx;            // the table: read, or written first when built
  const int32_t* parent;   // a built table's child level: parent_idx,
  const int32_t* kid;      // child_kid
  const bool* valid;       // and valid, each (children,)
  int kind, start, rows, taps, n_rows, children, tile0, tiles, bits, passes, first;
  int group0;              // its first 32-row group in the launch's sequence
};

struct Params {
  Table t[kMaxTables];
  int count, total_tiles, total_groups, phases;
  int32_t* hist;       // (passes, total_tiles, kBuckets) a tile's digit counts a pass, zeroed
  uint32_t* key[2];    // (total rows,) the passes' keys
  int32_t* val[2];     // (total rows,) and rows
  int64_t* key_out;    // (total rows,) sorted keys
  int32_t* perm_out;   // (total rows,) the table's rows in key order
};

// Exclusive scan of v over the block (every thread calls it).
__device__ int block_exclusive_scan(int v) {
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? s_warp[lane] : 0;
    int wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, wi, d);
      if (lane >= d) wi += t;
    }
    if (lane < kWarps) s_warp[lane] = wi - w;
  }
  __syncthreads();
  const int out = s_warp[warp] + incl - v;
  __syncthreads();   // s_warp is reused by the next call
  return out;
}

__device__ __forceinline__ int32_t* pass_hist(const Params& P, int pass) {
  return P.hist + static_cast<int64_t>(pass) * P.total_tiles * kBuckets;
}

__device__ __forceinline__ int digit(uint32_t key, int pass, int bits) {
  return static_cast<int>((key >> (pass * bits)) & ((1u << bits) - 1u));
}

// Adds each live lane's row to hist[slot] (slot < 0: no row), one atomic
// for the lanes of the warp that share a slot.
__device__ __forceinline__ void count_rows(int32_t* hist, int slot) {
  const unsigned same = __match_any_sync(0xffffffffu, slot);
  if (slot >= 0 && (threadIdx.x & 31) == __ffs(same) - 1) atomicAdd(hist + slot, __popc(same));
}

// Every row's key of the tables that take their keys in `phase` into the
// first key column, and its first digit into pass 0's histogram of its
// tile. The tables' 32-row groups are dealt to the grid's warps in one
// sequence, so every warp gets a like share. An up row is written here; a
// given table's rows are staged through shared memory by cp.async, so that
// their reads coalesce and are in flight together.
__device__ void table_keys(const Params& P, int phase, int32_t* stage) {
  const int lane = threadIdx.x & 31;
  for (int g = blockIdx.x * kWarps + (threadIdx.x >> 5); g < P.total_groups;
       g += gridDim.x * kWarps) {
    int i = 0;
    while (i + 1 < P.count && g >= P.t[i + 1].group0) ++i;
    const Table& t = P.t[i];
    if (t.first != phase) continue;
    const int32_t absent = t.n_rows;
    const int r0 = (g - t.group0) * 32, r = r0 + lane;
    const bool live = r < t.rows;
    uint32_t key = 0;
    if (t.kind == kGiven) {   // 16-byte copies where the table is aligned
      const int n = min(32, t.rows - r0) * t.taps;
      const int32_t* src = t.idx + static_cast<int64_t>(r0) * t.taps;
      const int n16 = (reinterpret_cast<uintptr_t>(t.idx) & 15) == 0 ? n / 4 : 0;
      for (int e = lane; e < n16; e += 32) __pipeline_memcpy_async(stage + 4 * e, src + 4 * e, 16);
      for (int e = 4 * n16 + lane; e < n; e += 32) __pipeline_memcpy_async(stage + e, src + e, 4);
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncwarp();
      if (live) {
        const int32_t* row = stage + lane * t.taps;
        for (int q = 0; q < t.taps; ++q) key |= static_cast<uint32_t>(row[q] >= absent) << q;
      }
      __syncwarp();   // the stage is refilled by the next rows
    } else if (live && t.kind == kUp) {
      const int32_t par = t.valid[r] ? t.parent[r] : absent;
      const int k = t.kid[r];
      int v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = q == k ? par : absent;
      int4* row = reinterpret_cast<int4*>(t.idx + static_cast<int64_t>(r) * 8);
      row[0] = make_int4(v[0], v[1], v[2], v[3]);
      row[1] = make_int4(v[4], v[5], v[6], v[7]);
      key = 0xffu ^ (par < absent && k >= 0 && k < 8 ? 1u << k : 0u);
    } else if (live) {   // a down row, written in phases 0 and 1
      const int4* row = reinterpret_cast<const int4*>(t.idx + static_cast<int64_t>(r) * 8);
      const int4 a = row[0], b = row[1];
      const int v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int q = 0; q < 8; ++q) key |= static_cast<uint32_t>(v[q] >= absent) << q;
    }
    if (live) P.key[0][t.start + r] = key;
    count_rows(pass_hist(P, 0) + static_cast<int64_t>(t.tile0) * kBuckets,
               live ? (r / kTile) * kBuckets + digit(key, 0, t.bits) : -1);
  }
}

// Tile j's rows of pass `pass` scattered stably by digit: into the other
// key column, each counted into the next pass's histogram of the tile it
// lands in, or into the outputs at the table's last pass. Warp w holds
// the tile's rows w * 128 + k * 32 + lane (k < kItems), so the order of
// (warp, k, lane) is the rows' order: a warp ranks its rows against its
// running count of each digit, the warps' counts are scanned a digit a
// thread, and every row's place is known in one round.
__device__ void tile_scatter(const Params& P, const Table& t, int j, int pass) {
  __shared__ int s_run[kWarps * kBuckets];
  const int nb = 1 << t.bits, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool last = pass + 1 == t.passes;
  const uint32_t* kin = P.key[pass & 1] + t.start;
  const int32_t* vin = P.val[pass & 1] + t.start;
  const int lo = j * kTile, hi = min(t.rows, lo + kTile);
  uint32_t key[kItems];
  int32_t val[kItems];
  int dig[kItems], rank[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = lo + warp * 32 * kItems + k * 32 + lane;
    const bool live = i < hi;
    key[k] = live ? kin[i] : 0u;
    val[k] = live ? (pass == 0 ? i : vin[i]) : 0;
    dig[k] = live ? digit(key[k], pass, t.bits) : -1;
  }
  // where each digit of this tile starts: the table's smaller digits, then
  // this digit's rows in the table's tiles before this one (8 loads in flight)
  int tot = 0, pre = 0;
  if (tid < nb) {
    const int32_t* col = pass_hist(P, pass) + static_cast<int64_t>(t.tile0) * kBuckets + tid;
    for (int i = 0; i < t.tiles; i += 8) {
      int v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        v[q] = i + q < t.tiles ? col[static_cast<int64_t>(i + q) * kBuckets] : 0;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        tot += v[q];
        pre += i + q < j ? v[q] : 0;
      }
    }
  }
  for (int e = tid; e < kWarps * nb; e += kThreads) s_run[e] = 0;
  __syncthreads();
  int* run = s_run + warp * nb;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const unsigned peers = __match_any_sync(0xffffffffu, dig[k]);
    const int before = dig[k] >= 0 ? run[dig[k]] : 0;
    rank[k] = before + __popc(peers & below);
    __syncwarp();
    if (dig[k] >= 0 && lane == __ffs(peers) - 1) run[dig[k]] = before + __popc(peers);
    __syncwarp();
  }
  const int start = block_exclusive_scan(tot) + pre;   // its barriers order s_run
  if (tid < nb) {
    int acc = start;
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_run[w * nb + tid];
      s_run[w * nb + tid] = acc;
      acc += c;
    }
  }
  __syncthreads();
  int32_t* next =
      last ? nullptr : pass_hist(P, pass + 1) + static_cast<int64_t>(t.tile0) * kBuckets;
  uint32_t* kout = P.key[(pass + 1) & 1] + t.start;
  int32_t* vout = P.val[(pass + 1) & 1] + t.start;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool live = dig[k] >= 0;
    const int pos = live ? run[dig[k]] + rank[k] : 0;
    if (last) {
      if (live) {
        P.key_out[t.start + pos] = key[k];
        P.perm_out[t.start + pos] = val[k];
      }
    } else {
      if (live) {
        kout[pos] = key[k];
        vout[pos] = val[k];
      }
      count_rows(next, live ? (pos / kTile) * kBuckets + digit(key[k], pass + 1, t.bits) : -1);
    }
  }
  __syncthreads();   // s_run is reused by the next tile
}

__global__ void __launch_bounds__(kThreads, 1) tap_tables_kernel(const __grid_constant__ Params P) {
  extern __shared__ int32_t s_stage[];   // kStageBytes
  int32_t* stage = s_stage + (threadIdx.x >> 5) * 32 * 32;
  const int64_t gtid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t gstride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int phase = 0; phase < P.phases; ++phase) {
    if (phase > 0) grid_sync(g_bar);
    if (phase == 0 || phase == 2) table_keys(P, phase, stage);
    for (int i = 0; i < P.count; ++i) {
      const Table& t = P.t[i];
      if (t.kind != kDown || phase > 1) continue;
      // a down table: absent everywhere (phase 0), then each child at its
      // (parent, kid) (phase 1)
      if (phase == 0) {
        const int4 fill = make_int4(t.n_rows, t.n_rows, t.n_rows, t.n_rows);
        int4* out = reinterpret_cast<int4*>(t.idx);
        for (int64_t e = gtid; e < static_cast<int64_t>(t.rows) * 2; e += gstride) out[e] = fill;
      } else {
        for (int64_t c = gtid; c < t.children; c += gstride) {
          const int32_t par = t.parent[c], k = t.kid[c];
          if (t.valid[c] && par >= 0 && par < t.rows && k >= 0 && k < 8) {
            t.idx[static_cast<int64_t>(par) * 8 + k] = static_cast<int32_t>(c);
          }
        }
      }
    }
    for (int g = blockIdx.x; g < P.total_tiles; g += gridDim.x) {
      int i = 0;
      while (i + 1 < P.count && g >= P.t[i + 1].tile0) ++i;
      const Table& t = P.t[i];
      const int pass = phase - t.first - 1;
      if (pass >= 0 && pass < t.passes) tile_scatter(P, t, g - t.tile0, pass);
    }
  }
}

}  // namespace

// Memsets and kernel launches enqueued so far, for the tests' count of a
// call's launches.
static int64_t g_device_ops = 0;

extern "C" int64_t ms3d_tap_tables_device_ops() { return g_device_ops; }

// count tables (1..32), each kDescWords int64 in `desc`: kind (0 given, 1
// down, 2 up), the table's pointer (a built table is written there: (rows,
// 8) int32, 16-byte aligned), rows, taps (1..32; 8 for a built table), the
// absent marker, then for a built table its child level's parent_idx and
// child_kid (int32) and valid (bool) pointers and the child count.
// key_out (sum of rows,) int64 and perm_out int32 take the tables' orders
// one after another; work holds 4 (passes * tiles * 512 + 4 * sum of rows)
// bytes, tiles the sum of ceil(rows / 2048), passes the most of any table
// (ceil(taps / min(taps, 9))). One memset (the histograms) and one
// cooperative launch on `stream`.
extern "C" int ms3d_tap_tables(const int64_t* desc, int count, int64_t* key_out,
                               int32_t* perm_out, void* work, int64_t work_bytes,
                               cudaStream_t stream) {
  if (count < 1 || count > kMaxTables) return static_cast<int>(cudaErrorInvalidValue);
  Params P{};
  P.count = count;
  int64_t total = 0;
  int tiles = 0, phases = 0, passes = 0, groups = 0;
  for (int i = 0; i < count; ++i) {
    const int64_t* d = desc + static_cast<int64_t>(i) * kDescWords;
    Table& t = P.t[i];
    t.kind = static_cast<int>(d[0]);
    t.idx = reinterpret_cast<int32_t*>(d[1]);
    const int64_t rows = d[2];
    t.taps = static_cast<int>(d[3]);
    t.n_rows = static_cast<int>(d[4]);
    const bool built = t.kind == kDown || t.kind == kUp;
    if ((!built && t.kind != kGiven) || t.taps < 1 || t.taps > 32 || rows < 0 ||
        rows >= (int64_t{1} << 31) || (rows > 0 && t.idx == nullptr) || (built && t.taps != 8)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (built) {
      t.parent = reinterpret_cast<const int32_t*>(d[5]);
      t.kid = reinterpret_cast<const int32_t*>(d[6]);
      t.valid = reinterpret_cast<const bool*>(d[7]);
      if (d[8] < 0 || d[8] >= (int64_t{1} << 31) || (reinterpret_cast<uintptr_t>(t.idx) & 15) ||
          (d[8] > 0 && (!t.parent || !t.kid || !t.valid)) ||
          (t.kind == kUp && d[8] != rows)) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      t.children = static_cast<int>(d[8]);
    }
    t.rows = static_cast<int>(rows);
    t.start = static_cast<int>(total);
    t.tile0 = tiles;
    t.tiles = static_cast<int>((rows + kTile - 1) / kTile);
    t.bits = t.taps < 9 ? t.taps : 9;
    t.passes = (t.taps + t.bits - 1) / t.bits;
    t.first = t.kind == kDown ? 2 : 0;
    t.group0 = groups;
    groups += static_cast<int>((rows + 31) / 32);
    total += rows;
    tiles += t.tiles;
    phases = phases > t.first + 1 + t.passes ? phases : t.first + 1 + t.passes;
    passes = passes > t.passes ? passes : t.passes;
    if (total >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total == 0) return 0;
  const int64_t hist_ints = static_cast<int64_t>(passes) * tiles * kBuckets;
  if (work_bytes < 4 * (hist_ints + 4 * total) || work == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  P.total_tiles = tiles;
  P.total_groups = groups;
  P.phases = phases;
  P.hist = static_cast<int32_t*>(work);
  P.key[0] = reinterpret_cast<uint32_t*>(P.hist + hist_ints);
  P.key[1] = P.key[0] + total;
  P.val[0] = reinterpret_cast<int32_t*>(P.key[1] + total);
  P.val[1] = P.val[0] + total;
  P.key_out = key_out;
  P.perm_out = perm_out;

  static int grid[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (grid[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(tap_tables_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kStageBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tap_tables_kernel, kThreads,
                                                        kStageBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    grid[dev] = sms * (per_sm < kMaxBlocksPerSm ? per_sm : kMaxBlocksPerSm);
  }
  err = cudaMemsetAsync(P.hist, 0, sizeof(int32_t) * hist_ints, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  ++g_device_ops;
  void* params[] = {&P};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(tap_tables_kernel),
                                    dim3(grid[dev]), dim3(kThreads), params, kStageBytes,
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++g_device_ops;
  return static_cast<int>(err);
}
