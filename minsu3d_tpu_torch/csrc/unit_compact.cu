// K9 unit_compact: connected-component labels of clustering units ->
// size-ranked cluster ids per point; one cooperative launch a call.
//
// Replaces minsu3d_tpu/ops/cluster.py:261 (_unit_points_compact with
// u_counts): argsort of the labels, run starts, per-component point counts,
// the stable size ranking argsort(-seg_sizes, stable=True), the per-unit
// cluster id and the per-point gather. Integer-only, equal to the JAX order
// bit for bit. The labels lie in [0, U) for an active unit and are U for an
// inactive one; they need not be roots (a truncated CC loop leaves some
// that are not), since the JAX argsort groups units by label value:
//   * every value that an active unit holds is flagged (flag[label[u]] = 1,
//     a plain store); the ascending values of the JAX argsort's runs are
//     the flagged values in index order, and a run's index (seg) is the
//     exclusive prefix count of the flags at its value: no sort;
//   * seg_sizes[seg] = sum of u_counts over the run, an int32 atomicAdd
//     into its value's slot (exact in any order);
//   * the stable ranking by size, descending, is a stable LSD radix sort of
//     (size, seg) pairs, 8-bit digits with the buckets taken from the
//     highest digit down, so ties keep ascending seg order, as the stable
//     argsort does;
//   * point_cluster[p] = rank[seg(label[uid[p]])] if < c_cap else c_cap
//     (c_cap for uid = U or an inactive unit); sizes[rank] = its size for
//     rank < c_cap; n_big = #{seg: size >= big_thre}.
//
// What bounds it on an H100: bytes are small (a few int32 arrays of U and
// the N points' ids and cluster ids, ~2-3 MB: < 1 us at 3.35 TB/s); the
// time is latency: phases that each wait on all of the previous one. So the
// call is one cooperative launch (every block resident) whose phases are
// separated by the grid barrier of grid_sync.cuh, with nothing read back by
// the host; the component count n is read from device memory inside:
//   1  flags and per-value sizes (int32 atomics);
//   2  each block counts the flags of its tile of values;
//   3  each block scans the tile counts before it, numbers its flagged
//      values (seg, seg_sizes) and takes its tile's digit-0 histogram;
//   4  the radix passes (one a digit of the largest size, at most 3 for
//      sizes under 2^24): the histograms, kept digit-major (digit, block),
//      are scanned a digit a block, then every block scatters its tile
//      stably (warp match + per-warp digit counts); the next pass's
//      histogram follows the scatter's barrier;
//   5  rank, sizes, seg_sizes and the counts; then the points.
// 6 + 3 (passes - 1) barriers: 6 for sizes under 2^8, 9 under 2^16.

#include <cuda_runtime.h>

#include <cstdint>

#include "grid_sync.cuh"

namespace {

using ms3d::grid_sync;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kDigits = 256;
constexpr int kMaxGrid = 512;   // blocks; the histogram table is sized for it

// int32 control words at the start of the workspace (zeroed with the
// flags and sizes by the launcher's one memset)
enum : int { kBar = 0, kMaxSize = 2, kNBig = 3, kCtrlWords = 8 };

struct Args {
  const int64_t* label;    // (U,) in [0, U]: U for an inactive unit
  const int64_t* counts;   // (U,) points a unit
  const int64_t* uid;      // (N,) in [0, U]: U for no unit
  int n_units, n_points, c_cap, big_thre;
  uint32_t* ctrl;          // kCtrlWords
  int32_t* tile_count;     // (kMaxGrid,) flags a block tile
  int32_t* flag;           // (U,) zeroed
  int32_t* value_size;     // (U,) zeroed
  int32_t* hist;           // (kDigits, kMaxGrid) digit-major
  int32_t* digit_total;    // (kDigits,)
  int32_t* seg_of_value;   // (U,)
  int32_t* key[2];         // (U,) sizes, in the two buffers of the passes
  int32_t* val[2];         // (U,) segs
  int32_t* rank;           // (U,)
  int64_t* point_cluster;  // (N,) output
  int64_t* sizes;          // (c_cap,) output
  int64_t* seg_sizes;      // (U,) output
  int64_t* result;         // (2,) output: count, n_big (count when big_thre <= 1)
};

// Exclusive scan of v over the block; *total gets the block's sum. Every
// thread of the block calls it.
__device__ int block_exclusive_scan(int v, int* total) {
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
    const int w = s_warp[lane];
    int wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, wi, d);
      if (lane >= d) wi += t;
    }
    s_warp[lane] = wi - w;
    if (lane == 31 && total != nullptr) *total = wi;
  }
  __syncthreads();
  const int out = s_warp[warp] + incl - v;
  __syncthreads();   // s_warp is reused by the next call
  return out;
}

__device__ __forceinline__ int bucket(int32_t size, int shift) {
  return kDigits - 1 - ((size >> shift) & (kDigits - 1));   // the highest digit first
}

// The [lo, hi) slice of n items that block b of g takes.
__device__ __forceinline__ void tile_of(int n, int b, int g, int* lo, int* hi) {
  const int per = (n + g - 1) / g;
  *lo = min(n, b * per);
  *hi = min(n, *lo + per);
}

// The histogram of one pass over keys[lo, hi) into hist[., blockIdx].
__device__ void tile_histogram(const int32_t* keys, int lo, int hi, int shift, int32_t* hist) {
  __shared__ int s_hist[kDigits];
  for (int d = threadIdx.x; d < kDigits; d += kThreads) s_hist[d] = 0;
  __syncthreads();
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) atomicAdd(&s_hist[bucket(keys[i], shift)], 1);
  __syncthreads();
  for (int d = threadIdx.x; d < kDigits; d += kThreads) hist[d * kMaxGrid + blockIdx.x] = s_hist[d];
}

// Every digit's row of the histogram, scanned over the blocks in order
// (a digit a block), and its total.
__device__ void scan_histograms(const Args& a) {
  __shared__ int s_total;
  for (int d = blockIdx.x; d < kDigits; d += gridDim.x) {
    int32_t* row = a.hist + d * kMaxGrid;
    const int v = threadIdx.x < static_cast<int>(gridDim.x) ? row[threadIdx.x] : 0;
    const int ex = block_exclusive_scan(v, &s_total);
    if (threadIdx.x < static_cast<int>(gridDim.x)) row[threadIdx.x] = ex;
    if (threadIdx.x == 0) a.digit_total[d] = s_total;
    __syncthreads();
  }
}

// Stable scatter of the block's tile [lo, hi) of (key, val) by bucket.
__device__ void tile_scatter(const Args& a, const int32_t* kin, const int32_t* vin,
                             int32_t* kout, int32_t* vout, int lo, int hi, int shift) {
  __shared__ int s_base[kDigits];
  __shared__ int s_tile[kDigits];
  __shared__ int s_cnt[kWarps][kDigits];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // where each bucket of this block starts: the buckets before it, then
  // this bucket's items in the blocks before this one
  const int tot = tid < kDigits ? a.digit_total[tid] : 0;
  const int before = block_exclusive_scan(tot, nullptr);
  if (tid < kDigits) s_base[tid] = before + a.hist[tid * kMaxGrid + blockIdx.x];
  __syncthreads();
  for (int base = lo; base < hi; base += kThreads) {
    const int i = base + tid;
    const bool live = i < hi;
    const int32_t key = live ? kin[i] : 0;
    const int32_t val = live ? vin[i] : 0;
    const int dig = live ? bucket(key, shift) : kDigits;
    const unsigned peers = __match_any_sync(0xffffffffu, dig);
    const int before_in_warp = __popc(peers & ((1u << lane) - 1u));
    for (int e = tid; e < kWarps * kDigits; e += kThreads) (&s_cnt[0][0])[e] = 0;
    __syncthreads();
    if (live && before_in_warp == 0) s_cnt[warp][dig] = __popc(peers);
    __syncthreads();
    if (tid < kDigits) {
      int run = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int t = s_cnt[w][tid];
        s_cnt[w][tid] = run;
        run += t;
      }
      s_tile[tid] = run;
    }
    __syncthreads();
    if (live) {
      const int pos = s_base[dig] + s_cnt[warp][dig] + before_in_warp;
      kout[pos] = key;
      vout[pos] = val;
    }
    __syncthreads();
    if (tid < kDigits) s_base[tid] += s_tile[tid];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 1) unit_compact_kernel(Args a) {
  __shared__ int s_sum;
  __shared__ int s_max, s_big;
  const int tid = threadIdx.x, b = blockIdx.x, g = gridDim.x;
  const int stride = g * kThreads;
  const int U = a.n_units;

  // 1. flags and sizes by label value
  for (int u = b * kThreads + tid; u < U; u += stride) {
    const int64_t l = a.label[u];
    if (l >= 0 && l < U) {
      a.flag[l] = 1;
      atomicAdd(a.value_size + l, static_cast<int32_t>(a.counts[u]));
    }
  }
  grid_sync(a.ctrl + kBar);

  // 2. flags a tile of values
  int vlo, vhi;
  tile_of(U, b, g, &vlo, &vhi);
  {
    int c = 0;
    for (int v = vlo + tid; v < vhi; v += kThreads) c += a.flag[v];
    c = __reduce_add_sync(0xffffffffu, c);
    if (tid == 0) s_sum = 0;
    __syncthreads();
    if ((tid & 31) == 0) atomicAdd(&s_sum, c);
    __syncthreads();
    if (tid == 0) a.tile_count[b] = s_sum;
  }
  grid_sync(a.ctrl + kBar);

  // 3. seg ids of the tile's flagged values, their sizes, pass 0's histogram
  int seg0, n;
  {
    const int tc = tid < g ? a.tile_count[tid] : 0;
    const int ex = block_exclusive_scan(tc, &s_sum);
    __shared__ int s_seg0;
    if (tid == b) s_seg0 = ex;
    if (tid == 0) {
      s_max = 0;
      s_big = 0;
    }
    __syncthreads();
    seg0 = s_seg0;
    n = s_sum;
    int run = seg0, mx = 0, big = 0;
    for (int base = vlo; base < vhi; base += kThreads) {
      const int v = base + tid;
      const int f = v < vhi ? a.flag[v] : 0;
      int tile_total;
      __shared__ int s_tt;
      const int seg = run + block_exclusive_scan(f, &s_tt);
      tile_total = s_tt;
      if (f) {
        const int32_t size = a.value_size[v];
        a.seg_of_value[v] = seg;
        a.seg_sizes[seg] = size;
        a.key[0][seg] = size;
        a.val[0][seg] = seg;
        mx = max(mx, size);
        big += size >= a.big_thre;
      }
      run += tile_total;
    }
    mx = __reduce_max_sync(0xffffffffu, mx);
    big = __reduce_add_sync(0xffffffffu, big);
    if ((tid & 31) == 0) {
      atomicMax(&s_max, mx);
      atomicAdd(&s_big, big);
    }
    __syncthreads();
    if (tid == 0) {
      atomicMax(a.ctrl + kMaxSize, static_cast<uint32_t>(s_max));
      atomicAdd(a.ctrl + kNBig, static_cast<uint32_t>(s_big));
    }
    tile_histogram(a.key[0], seg0, run, 0, a.hist);
    // pass 0 scatters this same tile: [seg0, run)
    vlo = seg0;
    vhi = run;
  }
  grid_sync(a.ctrl + kBar);

  // 4. radix passes over the sizes, 8 bits a pass
  const int max_size = static_cast<int>(ms3d::ld_acquire(a.ctrl + kMaxSize));
  int passes = 1;
  while (passes < 4 && (max_size >> (8 * passes)) != 0) ++passes;
  int cur = 0;
  for (int p = 0; p < passes; ++p) {
    if (p > 0) {
      tile_of(n, b, g, &vlo, &vhi);
      tile_histogram(a.key[cur], vlo, vhi, 8 * p, a.hist);
      grid_sync(a.ctrl + kBar);
    }
    scan_histograms(a);
    grid_sync(a.ctrl + kBar);
    tile_scatter(a, a.key[cur], a.val[cur], a.key[cur ^ 1], a.val[cur ^ 1], vlo, vhi, 8 * p);
    cur ^= 1;
    grid_sync(a.ctrl + kBar);
  }

  // 5. ranks, sizes by rank, seg_sizes past n, the counts
  for (int i = b * kThreads + tid; i < U; i += stride) {
    if (i < n) a.rank[a.val[cur][i]] = i;
    else a.seg_sizes[i] = 0;
    if (i < a.c_cap) a.sizes[i] = i < n ? a.key[cur][i] : 0;
  }
  for (int i = U + b * kThreads + tid; i < a.c_cap; i += stride) a.sizes[i] = 0;
  if (b == 0 && tid == 0) {
    a.result[0] = n;
    a.result[1] = a.big_thre > 1 ? static_cast<int64_t>(ms3d::ld_acquire(a.ctrl + kNBig)) : n;
  }
  grid_sync(a.ctrl + kBar);

  for (int p = b * kThreads + tid; p < a.n_points; p += stride) {
    const int64_t u = a.uid[p];
    int64_t cid = a.c_cap;
    if (u >= 0 && u < U) {
      const int64_t l = a.label[u];
      if (l >= 0 && l < U) {
        const int r = a.rank[a.seg_of_value[l]];
        if (r < a.c_cap) cid = r;
      }
    }
    a.point_cluster[p] = cid;
  }
}

// int32 words of the workspace for U units (the wrapper's unit_compact_words
// mirrors it)
int64_t workspace_words(int64_t n_units) {
  return kCtrlWords + kMaxGrid + 2 * n_units + static_cast<int64_t>(kDigits) * kMaxGrid +
         kDigits + 6 * n_units;
}

}  // namespace

// label, counts (n_units,) and uid (n_points,) int64; work: int32 scratch
// of workspace_words(n_units) (checked); out: int64 (n_points + c_cap +
// n_units + 2): point_cluster, sizes, seg_sizes, then (count, n_big). One
// memset and one cooperative launch on `stream`; a grid that cannot be
// co-resident is an error (cudaErrorCooperativeLaunchTooLarge).
// Memsets and kernel launches enqueued so far, for the tests' count of a
// call's launches.
static int64_t g_device_ops = 0;

extern "C" int64_t ms3d_unit_compact_device_ops() { return g_device_ops; }

extern "C" int ms3d_unit_compact(const int64_t* label, const int64_t* counts, int n_units,
                                 const int64_t* uid, int n_points, int c_cap, int big_thre,
                                 int32_t* work, int64_t words, int64_t* out,
                                 cudaStream_t stream) {
  if (n_units <= 0 || n_points < 0 || c_cap < 0 || words < workspace_words(n_units)) {
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
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, unit_compact_kernel, kThreads,
                                                        0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    grid[dev] = sms < kMaxGrid ? sms : kMaxGrid;   // one block an SM
  }
  Args a;
  a.label = label;
  a.counts = counts;
  a.uid = uid;
  a.n_units = n_units;
  a.n_points = n_points;
  a.c_cap = c_cap;
  a.big_thre = big_thre;
  a.ctrl = reinterpret_cast<uint32_t*>(work);
  a.tile_count = work + kCtrlWords;
  a.flag = a.tile_count + kMaxGrid;
  a.value_size = a.flag + n_units;
  a.hist = a.value_size + n_units;
  a.digit_total = a.hist + kDigits * kMaxGrid;
  a.seg_of_value = a.digit_total + kDigits;
  a.key[0] = a.seg_of_value + n_units;
  a.key[1] = a.key[0] + n_units;
  a.val[0] = a.key[1] + n_units;
  a.val[1] = a.val[0] + n_units;
  a.rank = a.val[1] + n_units;
  a.point_cluster = out;
  a.sizes = out + n_points;
  a.seg_sizes = a.sizes + c_cap;
  a.result = a.seg_sizes + n_units;
  // the control words, the tile counts, the flags and the value sizes
  err = cudaMemsetAsync(work, 0, sizeof(int32_t) * (kCtrlWords + kMaxGrid + 2 * n_units),
                        stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  ++g_device_ops;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(unit_compact_kernel),
                                    dim3(grid[dev]), dim3(kThreads), params, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++g_device_ops;
  return static_cast<int>(err);
}
