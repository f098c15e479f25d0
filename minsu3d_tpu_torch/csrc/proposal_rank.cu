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
//   pid[i]  = pair_valid[i] && pc[i] < c_cap ? prop[pc[i]] : p_cap
//   prop_id = pid, valid = pid < p_cap, n_proposals = min(#ok, limit).
// Only the ok clusters' ranks are read, so the kernel ranks only them
// (their keys, ccls in [-1, k), all lie below the non-ok clusters' k).
// Integer-only apart from the threshold product, which rounds as the JAX
// line does; equal to it bit for bit.
//
// What bounds it on an H100: bytes, and they are few: c_cap = 16384
// clusters (class, size, valid: 144 KB) and 114688 pairs (cluster id and
// flag in, id and flag out: 1.1 MB), about 0.4 microseconds. The ranking
// is a counting rank over at most k + 1 <= 127 keys in one block
// (class_rank_kernel): the keys go to shared memory as bytes; for each key
// value in ascending order, every thread counts its contiguous chunk's
// clusters of that key, a block exclusive scan of the counts gives each
// chunk its start, and the chunk's clusters get base + start + running
// count. k + 1 block scans (19 for ScanNet's classes), no sort.
// pair_proposal_kernel is one thread per pair.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxClusters = 32768;  // shared key bytes of class_rank_kernel
constexpr int kMaxClasses = 126;
constexpr uint8_t kNotOk = 255;
constexpr int kPairThreads = 256;

// Exclusive prefix of v over the block in thread order, and the block total.
__device__ int block_exclusive_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_warp[w];
    before += w < warp ? c : 0;
    sum += c;
  }
  __syncthreads();  // s_warp is reused by the next call
  *total = sum;
  return before + incl - v;
}

// One block of kThreads. prop (c_cap,) and *n_props.
__global__ void class_rank_kernel(const int32_t* __restrict__ ccls,
                                  const int32_t* __restrict__ sizes,
                                  const bool* __restrict__ valid, const float* __restrict__ pna_fg,
                                  int k, float npoint_thr, int c_cap, int limit, int p_cap,
                                  int32_t* __restrict__ prop, int32_t* __restrict__ n_props) {
  __shared__ uint8_t s_key[kMaxClusters];
  __shared__ int s_warp[kWarps];
  const int chunk = (c_cap + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * chunk;
  const int hi = min(lo + chunk, c_cap);
  for (int c = lo; c < hi; ++c) {
    const int32_t cls = ccls[c];
    const float thr = __fmul_rn(npoint_thr, pna_fg[min(max(cls, 0), k - 1)]);
    const bool ok = valid[c] && __int2float_rn(sizes[c]) >= thr;
    s_key[c] = ok ? static_cast<uint8_t>(cls + 1) : kNotOk;  // -1 -> 0
    prop[c] = p_cap;
  }
  __syncthreads();
  int base = 0;
  for (int v = 0; v <= k; ++v) {  // key values ccls + 1 = 0 .. k
    int mine = 0;
    for (int c = lo; c < hi; ++c) mine += s_key[c] == v ? 1 : 0;
    int total;
    int r = base + block_exclusive_scan(mine, s_warp, &total);
    if (mine) {
      for (int c = lo; c < hi; ++c) {
        if (s_key[c] != v) continue;
        if (r < limit) prop[c] = r;
        ++r;
      }
    }
    base += total;
  }
  if (threadIdx.x == 0) *n_props = min(base, limit);
}

__global__ void pair_proposal_kernel(const int32_t* __restrict__ pc,
                                     const bool* __restrict__ pair_valid, int n_pairs,
                                     const int32_t* __restrict__ prop, int c_cap, int p_cap,
                                     int32_t* __restrict__ prop_id, bool* __restrict__ row_valid) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pairs) return;
  const int32_t c = pc[i];
  const int32_t pid = (pair_valid[i] && c >= 0 && c < c_cap) ? prop[c] : p_cap;
  prop_id[i] = pid;
  row_valid[i] = pid < p_cap;
}

}  // namespace

extern "C" int ms3d_proposal_rank(const int32_t* ccls, const int32_t* sizes, const bool* valid,
                                  const float* pna_fg, int k, float npoint_thr, int c_cap,
                                  int limit, int p_cap, const int32_t* pc,
                                  const bool* pair_valid, int n_pairs, int32_t* prop,
                                  int32_t* n_props, int32_t* prop_id, bool* row_valid,
                                  cudaStream_t stream) {
  if (c_cap <= 0 || c_cap > kMaxClusters || k <= 0 || k > kMaxClasses || n_pairs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  class_rank_kernel<<<1, kThreads, 0, stream>>>(ccls, sizes, valid, pna_fg, k, npoint_thr,
                                                c_cap, limit, p_cap, prop, n_props);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_pairs == 0) return static_cast<int>(err);
  pair_proposal_kernel<<<(n_pairs + kPairThreads - 1) / kPairThreads, kPairThreads, 0, stream>>>(
      pc, pair_valid, n_pairs, prop, c_cap, p_cap, prop_id, row_valid);
  return static_cast<int>(cudaGetLastError());
}
