// K9 unit_compact: connected-component labels of clustering units ->
// size-ranked cluster ids per unit and per point.
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
//     (maxsize - size, seg) pairs, 4-bit digits, in one block: ties keep
//     ascending seg order, as the stable argsort does;
//   * unit_cid[u] = rank[seg(label[u])] if < c_cap else c_cap;
//     point_cluster[p] = unit_cid[uid[p]] (c_cap for uid = u_cap);
//     sizes[rank] = seg_sizes[seg] for rank < c_cap.
//
// What bounds it on an H100: bytes are small (a few int32 arrays of U =
// 65536 and N points); the single-block scan and radix sort over the
// components (at most U keys) are latency-bound: a few passes of U / 1024
// tiles with block barriers. Fine for now; a multi-block onesweep sort is
// later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 1024;  // the one block of rank_kernel
constexpr int kWarps = kBlock / 32;
constexpr int kRadix = 16;

// flag (zeroed by the launcher) and root_size indexed by label value.
__global__ void root_sizes_kernel(const int32_t* __restrict__ label,
                                  const int32_t* __restrict__ counts, int n_units,
                                  int32_t* __restrict__ root_size, int32_t* __restrict__ flag) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= n_units) return;
  const int32_t l = label[u];
  if (l >= 0 && l < n_units) {
    flag[l] = 1;
    atomicAdd(root_size + l, counts[u]);
  }
}

// Inclusive scan of v over the block; every thread gets its value.
__device__ int block_inclusive_scan(int v, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += t;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += t;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  const int before = warp > 0 ? s_warp[warp - 1] : 0;
  __syncthreads();  // s_warp is reused by the next call
  return v + before;
}

// One block of kBlock threads. seg_of_root[v] for flagged values; seg_sizes[seg];
// *count; rank[seg]; sizes[rank] for rank < c_cap (zeroed by the caller).
__global__ void rank_kernel(const int32_t* __restrict__ flag,
                            const int32_t* __restrict__ root_size, int n_units, int c_cap,
                            int32_t* __restrict__ seg_of_root, int32_t* __restrict__ seg_sizes,
                            int32_t* __restrict__ count, int32_t* keys_a, int32_t* vals_a,
                            int32_t* keys_b, int32_t* vals_b, int32_t* __restrict__ rank,
                            int32_t* __restrict__ sizes) {
  __shared__ int s_warp[32];
  __shared__ int s_run, s_max;
  __shared__ int s_base[kRadix], s_hist[kRadix], s_tile[kRadix];
  __shared__ int s_warp_cnt[kWarps][kRadix];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    s_run = 0;
    s_max = 0;
  }
  __syncthreads();

  // segment ids of the flagged values in ascending order; seg sizes as keys
  for (int base = 0; base < n_units; base += kBlock) {
    const int u = base + tid;
    const int f = u < n_units ? flag[u] : 0;
    const int incl = block_inclusive_scan(f, s_warp);
    const int seg = s_run + incl - f;
    if (f) {
      const int32_t size = root_size[u];
      seg_of_root[u] = seg;
      seg_sizes[seg] = size;
      keys_a[seg] = size;
      vals_a[seg] = seg;
      atomicMax(&s_max, size);
    }
    __syncthreads();
    if (tid == kBlock - 1) s_run += incl;
    __syncthreads();
  }
  const int n = s_run;
  const int max_size = s_max;
  if (tid == 0) *count = n;
  // ascending keys = descending sizes
  for (int i = tid; i < n; i += kBlock) keys_a[i] = max_size - keys_a[i];
  __syncthreads();

  int bits = 0;
  while (bits < 31 && (max_size >> bits) != 0) ++bits;
  int32_t *kin = keys_a, *vin = vals_a, *kout = keys_b, *vout = vals_b;
  for (int shift = 0; shift < bits; shift += 4) {
    if (tid < kRadix) s_hist[tid] = 0;
    __syncthreads();
    for (int i = tid; i < n; i += kBlock) atomicAdd(&s_hist[(kin[i] >> shift) & (kRadix - 1)], 1);
    __syncthreads();
    if (tid == 0) {
      int run = 0;
      for (int d = 0; d < kRadix; ++d) {
        s_base[d] = run;
        run += s_hist[d];
      }
    }
    __syncthreads();
    for (int base = 0; base < n; base += kBlock) {
      const int i = base + tid;
      const bool live = i < n;
      const int32_t key = live ? kin[i] : 0;
      const int32_t val = live ? vin[i] : 0;
      const int digit = live ? (key >> shift) & (kRadix - 1) : kRadix;
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      const int before_in_warp = __popc(peers & ((1u << lane) - 1u));
      for (int e = tid; e < kWarps * kRadix; e += kBlock) s_warp_cnt[e / kRadix][e % kRadix] = 0;
      __syncthreads();
      if (live && before_in_warp == 0) s_warp_cnt[warp][digit] = __popc(peers);
      __syncthreads();
      if (tid < kRadix) {
        int run = 0;
        for (int w = 0; w < kWarps; ++w) {
          const int t = s_warp_cnt[w][tid];
          s_warp_cnt[w][tid] = run;
          run += t;
        }
        s_tile[tid] = run;
      }
      __syncthreads();
      if (live) {
        const int pos = s_base[digit] + s_warp_cnt[warp][digit] + before_in_warp;
        kout[pos] = key;
        vout[pos] = val;
      }
      __syncthreads();
      if (tid < kRadix) s_base[tid] += s_tile[tid];
      __syncthreads();
    }
    int32_t* t = kin;
    kin = kout;
    kout = t;
    t = vin;
    vin = vout;
    vout = t;
  }
  for (int i = tid; i < n; i += kBlock) {
    const int32_t seg = vin[i];
    rank[seg] = i;
    if (i < c_cap) sizes[i] = max_size - kin[i];
  }
}

__global__ void unit_cid_kernel(const int32_t* __restrict__ label,
                                const int32_t* __restrict__ seg_of_root,
                                const int32_t* __restrict__ rank, int n_units, int c_cap,
                                int32_t* __restrict__ unit_cid) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= n_units) return;
  const int32_t l = label[u];
  int32_t cid = c_cap;
  if (l >= 0 && l < n_units) {
    const int32_t r = rank[seg_of_root[l]];
    if (r < c_cap) cid = r;
  }
  unit_cid[u] = cid;
}

__global__ void point_cluster_kernel(const int32_t* __restrict__ uid, int n_points, int u_cap,
                                     const int32_t* __restrict__ unit_cid, int c_cap,
                                     int32_t* __restrict__ point_cluster) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_points) return;
  const int32_t u = uid[p];
  point_cluster[p] = (u >= 0 && u < u_cap) ? unit_cid[u] : c_cap;
}

}  // namespace

// label, counts (n_units,) int32; uid (n_points,) int32 with u_cap = none
// (u_cap == n_units). root_size (n_units,) and sizes (c_cap,) zeroed by the
// caller; flag (zeroed here), seg_of_root, keys/vals a/b, rank, unit_cid scratch of
// n_units; seg_sizes (n_units,) zeroed; count (1,).
extern "C" int ms3d_unit_compact(const int32_t* label, const int32_t* counts, int n_units,
                                 const int32_t* uid, int n_points, int c_cap,
                                 int32_t* root_size, int32_t* flag, int32_t* seg_of_root,
                                 int32_t* seg_sizes, int32_t* count, int32_t* keys_a,
                                 int32_t* vals_a, int32_t* keys_b, int32_t* vals_b,
                                 int32_t* rank, int32_t* sizes, int32_t* unit_cid,
                                 int32_t* point_cluster, cudaStream_t stream) {
  if (n_units <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int ublocks = (n_units + kThreads - 1) / kThreads;
  cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int32_t) * n_units, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  root_sizes_kernel<<<ublocks, kThreads, 0, stream>>>(label, counts, n_units, root_size, flag);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rank_kernel<<<1, kBlock, 0, stream>>>(flag, root_size, n_units, c_cap, seg_of_root, seg_sizes,
                                        count, keys_a, vals_a, keys_b, vals_b, rank, sizes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  unit_cid_kernel<<<ublocks, kThreads, 0, stream>>>(label, seg_of_root, rank, n_units, c_cap,
                                                    unit_cid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_points > 0) {
    point_cluster_kernel<<<(n_points + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        uid, n_points, n_units, unit_cid, c_cap, point_cluster);
  }
  return static_cast<int>(cudaGetLastError());
}
