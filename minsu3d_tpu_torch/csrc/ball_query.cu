// K2 ball_query_edge: up to K same-(batch, group) neighbours within r per
// query point, in the edge-buffer schedule's candidate order; one
// cooperative launch a call that reads its own inputs.
//
// Replaces minsu3d_tpu/ops/ballquery.py:268 ball_query_edge (the run bounds
// of :300-330, edge slots, distance test, (w, o) re-interleave sort,
// positional K cap) and, given an edge cap that no total reaches, the fused
// ball_query (:42). The wrapper (minsu3d_tpu_torch/ops/ballquery.py) hashes
// the cells and sorts the keys (K15) and hands this kernel the table as
// K14 takes it: cell (N, 3) int32, key_hi (N,) int64 = batch << 16 |
// group, valid (N,), s_key (N,) int64 sorted and perm (sorted row -> point).
// The cell offsets are (dx, dy, dz) = (f / 9 - 1, f / 3 % 3 - 1, f % 3 - 1)
// for f = 27 - n_off .. 26: the 27 offsets in JAX's order, or with
// half_space the 14 from (0, 0, 0) on (f >= 13), which are exactly those
// >= (0, 0, 0); the kernel is compiled for each count.
//
// One launch, its phases split by one grid barrier (grid_sync.cuh on a
// __device__ word pair: no memset). The points are cut into chunks of
// kChunk, dealt round robin over the blocks of a grid that fills the card,
// so the valid points (a unit table keeps them first) keep every SM busy;
// within a block the warps run free over its chunks, with no block barrier:
//   A  n_off lanes a point, kPer points a lane at once (their searches
//      interleaved), each (point, offset) forms the neighbour cell's key
//      (out of range, or an invalid point: no run), finds the run's lower
//      bound by binary search (kSamples rows staged in shared memory pick a
//      bucket, then global memory, as K16's bounds mode) and its length
//      clipped to the window by a second search in [lower, lower + window);
//      the lanes' sum is the point's candidate count, and a warp adds its
//      round's sum to its chunk's total (an integer atomic; the block zeroes
//      its chunks' totals first). Then every block writes a share of the
//      points in sorted order, pts[i] = (coords[perm[i]], perm[i]), so that
//      a candidate costs one 16-byte load and not two dependent ones;
//   B  after the barrier, every block sums the chunk totals: block 0 writes
//      the total and edges_dropped = max(total - edge_cap, 0) -- no host
//      read. Only where the total exceeds the cap does a point need its edge
//      slots: then a block scans the chunk totals for the counts before its
//      chunks, and a point's base adds its chunk's earlier points' counts;
//   C  a warp a point scans the candidates window-position-major (w outer,
//      o inner, the order of the JAX sort), 32 consecutive ones a round:
//      candidate (w, o) exists when w < run_len[o] and its edge slot
//      point_base + sum_{o' < o} run_len[o'] + w -- the JAX code's
//      point-major extent -- is < edge_cap; it is kept when |c - q|^2 <=
//      r^2, computed with explicitly rounded f32 operations (no fused
//      multiply-add) as the plain version's separate tensor ops compute it;
//      a ballot and popc place the survivors in order, the warp stops once
//      K are kept, and the rest of the row is N (nbr_valid false); an
//      invalid point's row, and every row of a chunk with no candidate, is
//      written empty without reading its runs.
// So it equals its plain version (the torch chain of run bounds, scan and
// candidate scan) bit for bit.
//
// What bounds it on an H100: bytes -- each point's valid flag, and a valid
// point's cell, key_hi and coords, read once; the sorted key, perm and
// coordinates once at each sorted row some run covers; the (N, K) table and
// its flags written once: 1.9 us at PointGroup's heads graph (chip_smoke.py
// computes it from the run). The time is latency: a point's searches are
// chains of dependent loads and its candidate fetches follow them; the
// design keeps them in flight on every warp of a full grid.

#include <cuda_runtime.h>

#include <cstdint>

#include "grid_sync.cuh"

namespace {

using ms3d::grid_sync;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocksPerSm = 4;
constexpr int kMaxGrid = 1024;    // blocks at most
constexpr int kChunk = 32;         // points a chunk; the chunks are dealt round robin
constexpr int kMaxOwn = 64;        // chunks a block at most (the launcher checks)
constexpr int kSamples = 1024;     // 8 KB of int64 a block
constexpr int kPer = 2;            // points a lane takes at once in phase A
constexpr int kCoordMax = 1024;
// an invalid point's key (the SENTINEL pair); no query key equals it, since
// a packed cell is below 2^30
constexpr int64_t kSentinelKey = (int64_t{0x7fffffff} << 31) | 0x7fffffff;

__device__ uint32_t g_bar[2];     // the grid barrier: zero at load, zero after each use

struct Args {
  const float* coords;     // (n, 3)
  const bool* valid;       // (n,)
  const int32_t* cell;     // (n, 3)
  const int64_t* key_hi;   // (n,)
  const int64_t* s_key;    // (n,) sorted
  const int32_t* perm;     // (n,) sorted row -> point
  int n, window, k;
  int64_t edge_cap;
  float r2;
  int64_t step;            // sample spacing: samples s_key[0], s_key[step], ...
  int2* run;               // (n, n_off) scratch: run start, run length
  int64_t* point_base;     // (n,) scratch: each point's candidate count
  int64_t* chunk_total;    // (ceil(n / kChunk),) scratch
  float4* pts;             // (n,) scratch: sorted points and their rows
  int32_t* nbr;            // (n, k)
  bool* nbr_valid;         // (n, k)
  int64_t* result;         // (2,) total, edges dropped
};

// For each of kPer queries: the first row in [lo, hi) of s with s[row] >=
// q (upper: > q), else hi, left in lo. The searches advance together, so a
// thread keeps kPer loads in flight; an empty range issues none.
__device__ __forceinline__ void search(const int64_t* __restrict__ s, int64_t (&lo)[kPer],
                                       const int64_t (&hi_in)[kPer], const int64_t (&q)[kPer],
                                       bool upper) {
  int64_t hi[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) hi[e] = hi_in[e];
  bool more = true;
  while (more) {
    more = false;
    int64_t v[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) v[e] = lo[e] < hi[e] ? __ldg(s + ((lo[e] + hi[e]) >> 1)) : 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (lo[e] < hi[e]) {
        const int64_t mid = (lo[e] + hi[e]) >> 1;
        if (upper ? v[e] <= q[e] : v[e] < q[e]) {
          lo[e] = mid + 1;
        } else {
          hi[e] = mid;
        }
        more |= lo[e] < hi[e];
      }
    }
  }
}

// Inclusive scan of v over the block; *total gets the block's sum. Every
// thread calls it; s holds kWarps int64.
__device__ int64_t block_scan(int64_t v, int64_t* s, int64_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t t = __shfl_up_sync(0xffffffffu, static_cast<long long>(v), d);
    if (lane >= d) v += t;
  }
  if (lane == 31) s[warp] = v;
  __syncthreads();
  int64_t before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int64_t x = s[w];
    before += w < warp ? x : 0;
    sum += x;
  }
  __syncthreads();  // s is reused by the next call
  *total = sum;
  return before + v;
}

// Sum of v over the warp, to every lane.
__device__ __forceinline__ int64_t warp_sum(int64_t v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, static_cast<long long>(v), d);
  return v;
}

// kOff offsets: 14 (half space, from f = 13) or 27 (from f = 0)
template <int kOff>
__global__ void __launch_bounds__(kThreads) ball_query_edge_kernel(Args a) {
  constexpr int n_off = kOff, ppw = 32 / kOff;  // ppw: points a warp takes at once, kPer times
  constexpr int kIters = (kChunk + kPer * ppw - 1) / (kPer * ppw);  // warp rounds a chunk
  __shared__ int64_t samp[kSamples];
  __shared__ int64_t s_scan[kWarps];
  __shared__ int64_t s_before[kMaxOwn];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = a.n;
  const int n_chunks = (n + kChunk - 1) / kChunk;
  const int first = static_cast<int>(blockIdx.x), stride = static_cast<int>(gridDim.x);
  const int own = first < n_chunks ? (n_chunks - first + stride - 1) / stride : 0;

  // ---- A: samples, this block's chunk totals zeroed, then its chunks' runs
  const int n_samp = static_cast<int>((n + a.step - 1) / a.step);
  for (int j = threadIdx.x; j < n_samp; j += kThreads) samp[j] = __ldg(a.s_key + j * a.step);
  for (int i = threadIdx.x; i < own; i += kThreads) a.chunk_total[first + i * stride] = 0;
  __syncthreads();

  const int g = lane / n_off, o = lane - g * n_off;
  const int f = 27 - kOff + o;
  const int ddx = f / 9 - 1, ddy = f / 3 % 3 - 1, ddz = f % 3 - 1;
  // a warp's rounds run free over the block's chunks: no block barrier
  for (int it = warp; it < own * kIters; it += kWarps) {
    const int c = first + it / kIters * stride;
    const int c_hi = min(n, (c + 1) * kChunk);
    const int p0 = c * kChunk + it % kIters * kPer * ppw;
    int p[kPer];
    bool here[kPer], v[kPer], live[kPer];
    int64_t q[kPer], lo[kPer], hi[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {  // the point's flag, cell and key_hi, loaded together
      p[e] = p0 + g + e * ppw;
      here[e] = g < ppw && p[e] < c_hi;
      v[e] = false;
      int x = 0, y = 0, z = 0;
      int64_t hi_key = 0;
      if (here[e]) {
        const int32_t* cp = a.cell + 3 * static_cast<int64_t>(p[e]);
        v[e] = __ldg(reinterpret_cast<const unsigned char*>(a.valid) + p[e]) != 0;
        x = __ldg(cp) + ddx;
        y = __ldg(cp + 1) + ddy;
        z = __ldg(cp + 2) + ddz;
        hi_key = __ldg(a.key_hi + p[e]);
      }
      live[e] = v[e] && x >= 0 && x < kCoordMax && y >= 0 && y < kCoordMax && z >= 0 &&
                z < kCoordMax;
      q[e] = (hi_key << 31) | (static_cast<int64_t>(x) << 20) |
             (static_cast<int64_t>(y) << 10) | static_cast<int64_t>(z);
      lo[e] = hi[e] = 0;
      if (live[e]) {
        int l = 0, h = n_samp;  // m = the first sample >= q
        while (l < h) {
          const int mid = (l + h) >> 1;
          if (samp[mid] < q[e]) {
            l = mid + 1;
          } else {
            h = mid;
          }
        }
        // rows before (m - 1) * step + 1 are < q, row m * step (if any) >= q
        lo[e] = l == 0 ? 0 : (l - 1) * a.step + 1;
        hi[e] = min(static_cast<int64_t>(l) * a.step, static_cast<int64_t>(n));
      }
    }
    bool any = false;
#pragma unroll
    for (int e = 0; e < kPer; ++e) any |= v[e];
    if (!__any_sync(0xffffffffu, any)) {  // no valid point: no run, no candidate
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        if (here[e] && o == 0) a.point_base[p[e]] = 0;
      }
      continue;
    }
    int64_t lb[kPer];
    search(a.s_key, lo, hi, q, false);   // lower bounds
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      lb[e] = lo[e];
      hi[e] = live[e] ? min(lb[e] + a.window, static_cast<int64_t>(n)) : lb[e];
    }
    search(a.s_key, lo, hi, q, true);    // upper bounds within the window
    int64_t mine = 0;                    // this round's candidates, at lanes o == 0
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int len = static_cast<int>(lo[e] - lb[e]);
      if (v[e]) a.run[static_cast<int64_t>(p[e]) * n_off + o] =
          make_int2(static_cast<int>(lb[e]), len);
      int s = len;  // inclusive scan over the warp, then each point's sum
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, s, d);
        if (lane >= d) s += t;
      }
      const int s_last = __shfl_sync(0xffffffffu, s, min(g * n_off + n_off - 1, 31));
      const int s_before = __shfl_sync(0xffffffffu, s, max(g * n_off - 1, 0));
      if (here[e] && o == 0) {
        const int count = s_last - (g > 0 ? s_before : 0);
        a.point_base[p[e]] = count;
        mine += count;
      }
    }
    mine = warp_sum(mine);
    if (lane == 0 && mine > 0) {
      atomicAdd(reinterpret_cast<unsigned long long*>(a.chunk_total + c),
                static_cast<unsigned long long>(mine));
    }
  }
  // the points in sorted order, pts[i] = (coords[perm[i]], perm[i])
  const int64_t gtid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (int64_t i = gtid; i < n; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    if (__ldg(a.s_key + i) == kSentinelKey) continue;   // an invalid row: never a candidate
    const int32_t r = __ldg(a.perm + i);
    const float* cr = a.coords + 3 * static_cast<int64_t>(r);
    a.pts[i] = make_float4(__ldg(cr), __ldg(cr + 1), __ldg(cr + 2), __int_as_float(r));
  }
  grid_sync(g_bar);

  // ---- B: the candidate total; where the cap binds, the counts before each
  // of this block's chunks
  int64_t all = 0;
  for (int t = threadIdx.x; t < n_chunks; t += kThreads) {
    all += __ldcg(reinterpret_cast<const long long*>(a.chunk_total) + t);
  }
  int64_t total = 0;
  block_scan(all, s_scan, &total);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.result[0] = total;
    a.result[1] = total > a.edge_cap ? total - a.edge_cap : 0;
  }
  // the edge cap drops no candidate unless the total exceeds it: then no
  // point needs its base
  const bool capped = total > a.edge_cap;
  if (capped) {
    int64_t carry = 0;
    for (int base = 0; base < n_chunks; base += kThreads) {
      const int t = base + static_cast<int>(threadIdx.x);
      const int64_t v = t < n_chunks
                            ? __ldcg(reinterpret_cast<const long long*>(a.chunk_total) + t) : 0;
      int64_t round = 0;
      const int64_t excl = carry + block_scan(v, s_scan, &round) - v;
      if (t < n_chunks && t >= first && (t - first) % stride == 0) {
        s_before[(t - first) / stride] = excl;
      }
      carry += round;
    }
    __syncthreads();
  }

  // ---- C: a warp a point of this block's chunks, the candidates in (w, o)
  // order; the warps run free
  const int k = a.k;
  for (int it = warp; it < own * kChunk; it += kWarps) {
    const int i = it / kChunk;
    const int c = first + i * stride;
    const int p = c * kChunk + it % kChunk;
    if (p >= n) continue;
    int32_t* row = a.nbr + static_cast<int64_t>(p) * k;
    bool* vrow = a.nbr_valid + static_cast<int64_t>(p) * k;
    if (__ldcg(reinterpret_cast<const long long*>(a.chunk_total) + c) == 0 ||
        !__ldg(reinterpret_cast<const unsigned char*>(a.valid) + p)) {  // an empty row
      for (int e = lane; e < k; e += 32) {
        row[e] = n;
        vrow[e] = false;
      }
      continue;
    }
    int start = 0, len = 0;
    if (lane < n_off) {
      const int2 rl = a.run[static_cast<int64_t>(p) * n_off + lane];
      start = rl.x;
      len = rl.y;
    }
    const float* qc = a.coords + 3 * static_cast<int64_t>(p);
    const float qx = __ldg(qc), qy = __ldg(qc + 1), qz = __ldg(qc + 2);
    int64_t pre = 0;        // lane o: its run's first edge slot, where the cap binds
    int64_t cap = INT64_MAX;
    if (capped) {
      int64_t before = 0;   // the chunk's points before p
      for (int j = c * kChunk + lane; j < p; j += 32) before += a.point_base[j];
      pre = s_before[i] + warp_sum(before);
      cap = a.edge_cap;
    }
    int s = len;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += t;
    }
    pre += s - len;
    const int n_cand = __reduce_max_sync(0xffffffffu, len) * n_off;
    int cnt_p = 0;
    for (int j0 = 0; j0 < n_cand && cnt_p < k; j0 += 32) {
      const int j = j0 + lane;
      const int w = j / n_off, oj = j - w * n_off;
      const int len_o = __shfl_sync(0xffffffffu, len, oj);
      const int start_o = __shfl_sync(0xffffffffu, start, oj);
      const int64_t pre_o = __shfl_sync(0xffffffffu, static_cast<long long>(pre), oj);
      bool ok = false;
      int32_t cand = 0;
      if (j < n_cand && w < len_o && pre_o + w < cap) {
        const float4 t = a.pts[start_o + w];
        cand = __float_as_int(t.w);
        const float dx = __fsub_rn(t.x, qx);
        const float dy = __fsub_rn(t.y, qy);
        const float dz = __fsub_rn(t.z, qz);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        ok = d2 <= a.r2;
      }
      const unsigned ball = __ballot_sync(0xffffffffu, ok);
      const int slot = cnt_p + __popc(ball & ((1u << lane) - 1u));
      if (ok && slot < k) row[slot] = cand;
      cnt_p += __popc(ball);
    }
    cnt_p = min(cnt_p, k);
    for (int e = lane; e < k; e += 32) {
      if (e >= cnt_p) row[e] = n;
      vrow[e] = e < cnt_p;
    }
  }
}

// Kernel launches enqueued so far, for the tests' count of a call's launches.
int64_t g_device_ops = 0;

}  // namespace

extern "C" int64_t ms3d_ball_query_edge_device_ops() { return g_device_ops; }

// Bytes of scratch for n points and n_off offsets: the sorted points (16
// bytes a point), the runs (8 a (point, offset)), the bases (8 a point) and
// the chunk totals (8 a chunk), each 16-byte aligned.
extern "C" int64_t ms3d_ball_query_edge_scratch(int64_t n, int n_off) {
  return 16 * n + 8 * n * n_off + 8 * n + 8 * ((n + kChunk - 1) / kChunk) + 64;
}

// coords (n, 3) f32, valid (n,) bool, cell (n, 3) int32, key_hi and s_key
// (n,) int64, perm (n,) int32; half_space picks the 14 forward offsets,
// else all 27; work of ms3d_ball_query_edge_scratch(n, n_off) bytes;
// nbr (n, k) int32, nbr_valid (n, k) bool and result (2,) int64 written in
// full. One cooperative launch on `stream`, no memset.
extern "C" int ms3d_ball_query_edge(const float* coords, const bool* valid, const int32_t* cell,
                                    const int64_t* key_hi, const int64_t* s_key,
                                    const int32_t* perm, int n, int half_space, int window,
                                    int k, int64_t edge_cap, float r2, void* work,
                                    int64_t work_bytes, int32_t* nbr, bool* nbr_valid,
                                    int64_t* result, cudaStream_t stream) {
  const int n_off = half_space ? 14 : 27;
  if (n < 0 || window < 0 || k < 1 || edge_cap < 0 || work == nullptr ||
      work_bytes < ms3d_ball_query_edge_scratch(n, n_off)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* kernel = half_space ? reinterpret_cast<const void*>(ball_query_edge_kernel<14>)
                                  : reinterpret_cast<const void*>(ball_query_edge_kernel<27>);
  static int grid[64][2] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  int& g = grid[dev][half_space ? 1 : 0];
  if (g == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    const int blocks = sms * (per_sm < kMaxBlocksPerSm ? per_sm : kMaxBlocksPerSm);
    g = blocks < kMaxGrid ? blocks : kMaxGrid;
  }
  if ((static_cast<int64_t>(n) + kChunk - 1) / kChunk > static_cast<int64_t>(kMaxOwn) * g) {
    return static_cast<int>(cudaErrorInvalidValue);   // more chunks than the grid takes
  }
  auto align = [](uintptr_t x) { return (x + 15) & ~uintptr_t{15}; };
  uintptr_t w = align(reinterpret_cast<uintptr_t>(work));
  Args a{};
  a.coords = coords;
  a.valid = valid;
  a.cell = cell;
  a.key_hi = key_hi;
  a.s_key = s_key;
  a.perm = perm;
  a.n = n;
  a.window = window;
  a.k = k;
  a.edge_cap = edge_cap;
  a.r2 = r2;
  a.step = n > kSamples ? (static_cast<int64_t>(n) + kSamples - 1) / kSamples : 1;
  a.pts = reinterpret_cast<float4*>(w);
  w = align(w + 16 * static_cast<uintptr_t>(n));
  a.run = reinterpret_cast<int2*>(w);
  w = align(w + 8 * static_cast<uintptr_t>(n) * n_off);
  a.point_base = reinterpret_cast<int64_t*>(w);
  w = align(w + 8 * static_cast<uintptr_t>(n));
  a.chunk_total = reinterpret_cast<int64_t*>(w);
  a.nbr = nbr;
  a.nbr_valid = nbr_valid;
  a.result = result;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(g), dim3(kThreads), params, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++g_device_ops;
  return static_cast<int>(err);
}
