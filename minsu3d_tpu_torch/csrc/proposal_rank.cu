// K11 proposal_rank: SoftGroup's class-major proposal ids.
//
// Replaces minsu3d_tpu/model/softgroup.py:156-175 (soft_grouping_packed
// after the clustering): the per-class size threshold, the stable argsort
// of the clusters by class and its inverse (the rank), the proposal cap and
// every pair's proposal id:
//   thr[c]  = npoint_thr * pna_fg[clip(ccls[c], 0, k - 1)]   (f32, __fmul_rn)
//   ok[c]   = valid[c] && f32(sizes[c]) >= thr[c]
//   rank[c] = stable rank of c by key (ok ? ccls : k): the ok clusters of a
//             lower class, plus those of its class with a lower id
//   prop[c] = ok && rank < limit ? rank : p_cap
//   pid[i]  = pair_valid[i] ? prop[clip(pc[i], 0, c_cap)] : p_cap (p_cap
//             past the last cluster)
//   prop_id = min(pid, p_cap), valid = pid < p_cap, n_proposals =
//   min(#ok, limit).
// Only the ok clusters' ranks are read, so the kernel ranks only them
// (their keys, ccls in [-1, k), all lie below the non-ok clusters' k; a key
// outside that range is clamped into it). Integer-only apart from the
// threshold product, which rounds as the JAX line does; equal to it bit for
// bit. The cluster class (int32, K6's output), the sizes and the pairs'
// cluster ids (int64, the clustering's) are read as the caller holds them;
// prop_id and n_proposals are written in int64, as the heads read them.
//
// What bounds it on an H100: bytes, and they are few: c_cap = 16384
// clusters (class, size, valid: 213 KB) and 114688 pairs (cluster id
// and flag in, id and flag out: 2 MB), about 0.7 microseconds. The time is
// latency: a cluster's rank needs the counts of every earlier cluster. So a
// call is one cooperative launch (every block resident, the grid barrier of
// grid_sync.cuh on a __device__ word pair, no memset) of one block an SM,
// each block over one contiguous chunk of ceil(c_cap / grid) clusters:
//   A  each block counts its ok clusters a key (warp-aggregated shared
//      atomics over __match_any_sync) and writes its histogram, key-major;
//   B  after the barrier each block reads the (key, block) histograms:
//      a warp a key sums the key's count in every block and in the blocks
//      before its own, and one warp scans the totals over the keys. A
//      cluster's rank is its key's base (the clusters of every lower key,
//      plus those of its key in earlier blocks) + the clusters of its key
//      in earlier rounds and warps of its block + its lanes below it with
//      the same key (__match_any_sync); its proposal goes to a scratch
//      array;
//   C  after the second barrier every pair reads its cluster's proposal.
// No sort, no host sync; the number of clusters is not capped.

#include <cuda_runtime.h>

#include <cstdint>

#include "grid_sync.cuh"

namespace {

using ms3d::grid_sync;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxKeys = 128;               // key values ccls + 1 = 0 .. k
constexpr int kMaxClasses = kMaxKeys - 1;
constexpr int kMaxGrid = 256;               // histogram columns of the scratch

__device__ uint32_t g_bar[2];  // the grid barrier: zero at load, zero after each use

struct Args {
  const int32_t* ccls;     // (c_cap,)
  const int64_t* sizes;    // (c_cap,)
  const bool* valid;       // (c_cap,)
  const float* pna;        // (k,)
  const int64_t* pc;       // (n_pairs,)
  const bool* pair_valid;  // (n_pairs,)
  int k;
  float npoint_thr;
  int64_t c_cap, n_pairs, limit, p_cap;
  int32_t* hist;           // (kMaxKeys, grid) scratch, key-major
  int32_t* prop;           // (c_cap,) scratch
  int64_t* prop_id;        // (n_pairs,)
  bool* row_valid;         // (n_pairs,)
  int64_t* n_props;        // ()
};

// Cluster c's key ccls + 1 in [0, k] when it is ok, -1 when it is not.
__device__ __forceinline__ int cluster_key(const Args& a, int64_t c) {
  const int cls = __ldg(a.ccls + c);
  const int ci = cls < 0 ? 0 : (cls > a.k - 1 ? a.k - 1 : cls);
  const float thr = __fmul_rn(a.npoint_thr, __ldg(a.pna + ci));
  const float size = __ll2float_rn(__ldg(reinterpret_cast<const long long*>(a.sizes) + c));
  const bool ok = __ldg(reinterpret_cast<const unsigned char*>(a.valid) + c) != 0 && size >= thr;
  if (!ok) return -1;
  return static_cast<int>(cls < -1 ? 0 : (cls > a.k - 1 ? a.k : cls + 1));
}

__global__ void __launch_bounds__(kThreads) proposal_rank_kernel(Args a) {
  __shared__ int s_base[kMaxKeys];           // A: the block's counts; B: the running base
  __shared__ int s_wc[kWarps][kMaxKeys];     // a round's count a (warp, key)
  __shared__ int s_off[kWarps][kMaxKeys];    // ... and its exclusive offset
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k1 = a.k + 1;
  const int grid = static_cast<int>(gridDim.x);
  const int64_t chunk = (a.c_cap + grid - 1) / grid;
  const int64_t lo = min(a.c_cap, static_cast<int64_t>(blockIdx.x) * chunk);
  const int64_t hi = min(a.c_cap, lo + chunk);
  for (int v = threadIdx.x; v < kMaxKeys; v += kThreads) s_base[v] = 0;
  for (int i = threadIdx.x; i < kWarps * kMaxKeys; i += kThreads) (&s_wc[0][0])[i] = 0;
  __syncthreads();

  // A: this chunk's ok clusters a key
  for (int64_t base = lo; base < hi; base += kThreads) {
    const int64_t c = base + threadIdx.x;
    const int key = c < hi ? cluster_key(a, c) : -1;
    const unsigned same = __match_any_sync(0xffffffffu, key);
    if (key >= 0 && lane == __ffs(same) - 1) atomicAdd(&s_base[key], __popc(same));
  }
  __syncthreads();
  for (int v = threadIdx.x; v < k1; v += kThreads) a.hist[v * grid + blockIdx.x] = s_base[v];
  grid_sync(g_bar);

  // B: every key's total and its count in the blocks before this one
  __shared__ int s_total[kMaxKeys];
  for (int v = warp; v < k1; v += kWarps) {
    const int32_t* row = a.hist + v * grid;
    int tot = 0, before = 0;
    for (int b = lane; b < grid; b += 32) {
      const int x = __ldcg(row + b);
      tot += x;
      before += b < static_cast<int>(blockIdx.x) ? x : 0;
    }
    tot = __reduce_add_sync(0xffffffffu, tot);
    before = __reduce_add_sync(0xffffffffu, before);
    if (lane == 0) {
      s_total[v] = tot;
      s_base[v] = before;
    }
  }
  __syncthreads();
  if (warp == 0) {  // base[v] += the totals of the keys below v; 4 keys a lane
    int t[4], sum = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = 4 * lane + j;
      t[j] = v < k1 ? s_total[v] : 0;
      sum += t[j];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += x;
    }
    int run = incl - sum;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = 4 * lane + j;
      if (v < k1) s_base[v] += run;
      run += t[j];
    }
    if (blockIdx.x == 0 && lane == 31) *a.n_props = min(static_cast<int64_t>(incl), a.limit);
  }
  __syncthreads();

  // B: the ranks of this chunk's clusters, in rounds of kThreads clusters
  const int32_t none = static_cast<int32_t>(a.p_cap);
  for (int64_t base = lo; base < hi; base += kThreads) {
    const int64_t c = base + threadIdx.x;
    const int key = c < hi ? cluster_key(a, c) : -1;
    const unsigned same = __match_any_sync(0xffffffffu, key);
    const bool leader = key >= 0 && lane == __ffs(same) - 1;
    if (leader) s_wc[warp][key] = __popc(same);
    __syncthreads();
    for (int v = threadIdx.x; v < k1; v += kThreads) {
      int acc = s_base[v];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        s_off[w][v] = acc;
        acc += s_wc[w][v];
      }
      s_base[v] = acc;
    }
    __syncthreads();
    if (c < hi) {
      int32_t p = none;
      if (key >= 0) {
        const int64_t r = s_off[warp][key] + __popc(same & ((1u << lane) - 1u));
        if (r < a.limit) p = static_cast<int32_t>(r);
      }
      a.prop[c] = p;
    }
    if (leader) s_wc[warp][key] = 0;  // read only before the last barrier
    __syncwarp();                     // before the next round's leaders write
  }
  grid_sync(g_bar);

  // C: every pair's proposal
  const int64_t stride = static_cast<int64_t>(grid) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < a.n_pairs;
       i += stride) {
    int64_t pid = a.p_cap;
    if (__ldg(reinterpret_cast<const unsigned char*>(a.pair_valid) + i) != 0) {
      int64_t c = __ldg(reinterpret_cast<const long long*>(a.pc) + i);
      c = c < 0 ? 0 : c;
      if (c < a.c_cap) pid = __ldcg(a.prop + c);
    }
    a.prop_id[i] = pid < a.p_cap ? pid : a.p_cap;
    a.row_valid[i] = pid < a.p_cap;
  }
}

// Kernel launches enqueued so far, for the tests' count of a call's launches.
int64_t g_device_ops = 0;

}  // namespace

extern "C" int64_t ms3d_proposal_rank_device_ops() { return g_device_ops; }

// ccls (c_cap,) int32, sizes (c_cap,) and pc (n_pairs,) int64; valid
// (c_cap,) and pair_valid (n_pairs,) bool; pna_fg (k,) f32; scratch of
// kMaxKeys * kMaxGrid + c_cap int32 (the wrapper's _HIST_SCRATCH + c_cap);
// prop_id (n_pairs,) int64, row_valid (n_pairs,) bool, n_props () int64.
// One cooperative launch on `stream`, no memset.
extern "C" int ms3d_proposal_rank(const int32_t* ccls, const int64_t* sizes, const bool* valid,
                                  const float* pna_fg, int k, float npoint_thr, int64_t c_cap,
                                  int64_t limit, int64_t p_cap, const int64_t* pc,
                                  const bool* pair_valid, int64_t n_pairs, int32_t* scratch, int64_t* prop_id,
                                  bool* row_valid, int64_t* n_props, cudaStream_t stream) {
  if (c_cap < 0 || c_cap > INT32_MAX || k <= 0 || k > kMaxClasses || n_pairs < 0 ||
      p_cap < 0 || p_cap > INT32_MAX) {
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
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, proposal_rank_kernel, kThreads,
                                                        0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    grid[dev] = sms < kMaxGrid ? sms : kMaxGrid;
  }
  Args a{ccls, sizes, valid, pna_fg, pc, pair_valid, k, npoint_thr, c_cap, n_pairs, limit, p_cap, scratch,
         scratch + static_cast<int64_t>(kMaxKeys) * kMaxGrid, prop_id, row_valid, n_props};
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(proposal_rank_kernel),
                                    dim3(grid[dev]), dim3(kThreads), params, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++g_device_ops;
  return static_cast<int>(err);
}
