// K8 set_aggregation: HAIS's fragment -> nearest-primary absorption.
//
// Replaces the use_set_aggr branch of minsu3d_tpu/model/hais.py:82-108
// (hierarchical_aggregation): the compact table of the first p2 = min(C,
// 512) primaries in cluster order (centre, class, batch, size, proposal;
// the JAX lines' .at[slot].set), the masked (C, P2) distance matrix from
// every cluster centre to the table, its argmin and min along the slots,
// the absorb test and the primary-path proposal of each cluster:
//
//   d2[c, j]  = ((dx*dx + dy*dy) + dz*dz), dx = centers[c] - centers_p[j];
//               1e10 where c is no fragment, j is not live, or the class or
//               batch differ
//   nearest   = first j of the smallest d2 (jnp.argmin's tie rule)
//   absorbed  = fragment[c] && near_d2 < max(0.01 * sqrt(size_p[nearest]),
//               r_cls[c])^2 && near_d2 < 1e9
//   prim_path = prim_prop[c] for a primary, prop_p[nearest] if absorbed,
//               else p_cap.
// Every f32 operation is explicitly rounded (__fsub_rn, __fmul_rn,
// __fadd_rn, __fsqrt_rn), as the plain version's separate tensor
// operations round, so both agree bit for bit. A slot that reads 1e10 can
// never be the one that absorbs (1e10 > 1e9), so only the live slots of the
// fragment's class and batch are scanned; a NaN distance among them makes
// the plain min NaN, and the fragment stays unabsorbed here too.
//
// What bounds it on an H100: operations, and they are few -- a distance
// (9 flops) for each pair of a fragment and a live primary of its class
// and batch -- against about 0.6 MB of bytes (16384 clusters' centres,
// classes, batches, flags, sizes, radii, proposals and the int64 output),
// about 0.2 microseconds. The time is latency. So a call is one launch
// with no memset and no grid barrier, a grid of up to two blocks an SM:
//   1  every block finds the first p2 primaries itself: a block scan over
//      the primary flags (16 flags a thread a round, until p2 are found);
//   2  it buckets those slots by a hash of (class, batch), stably (warp
//      match, per-warp counts, an exclusive scan over the buckets), and
//      stages each slot's centre, class, batch, size and proposal in
//      shared memory in bucket order, so a bucket holds its slots in slot
//      order;
//   3  its warps take batches of consecutive clusters (a lane a cluster:
//      the flags, centre, class, batch and radius read coalesced); for
//      each fragment of the batch the whole warp scans its bucket, 32
//      slots a round, and a (distance, position) lexicographic min across
//      the lanes keeps jnp.argmin's first index among exact ties; the
//      batch's results go out in one coalesced int64 store.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPrimaries = 512;
constexpr int kBuckets = 128;          // 7 bits of the (class, batch) hash
constexpr int kMaxBlocksPerSm = 2;
constexpr float kFar = 1e10f;

struct Args {
  int64_t n;                 // clusters
  int p2;                    // slots of the table: min(n, 512)
  const float* centers;      // (n, 3)
  const int32_t* cls;        // (n,)
  const int32_t* cbatch;     // (n,)
  const bool* primary;       // (n,)
  const bool* fragment;      // (n,)
  const int64_t* prim_prop;  // (n,)
  const float* size_f;       // (n,)
  const float* r_cls;        // (n,)
  int64_t p_cap;
  int64_t* prim_path;        // (n,)
};

__device__ __forceinline__ int bucket_of(int32_t cls, int32_t batch) {
  const uint32_t h = static_cast<uint32_t>(cls) * 0x9E3779B1u ^
                     static_cast<uint32_t>(batch) * 0x85EBCA77u;
  return static_cast<int>(h >> 25);
}

// The 16 primary flags from i0 as 4 words of bytes (0 past n).
__device__ __forceinline__ uint4 load_flags(const bool* p, int64_t i0, int64_t n, bool aligned) {
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (i0 >= n) return w;
  if (aligned && i0 + 16 <= n) return __ldg(reinterpret_cast<const uint4*>(p + i0));
  uint32_t b[4] = {0u, 0u, 0u, 0u};
  const unsigned char* q = reinterpret_cast<const unsigned char*>(p);
  for (int e = 0; e < 16 && i0 + e < n; ++e) b[e >> 2] |= (__ldg(q + i0 + e) ? 1u : 0u)
                                                         << (8 * (e & 3));
  return make_uint4(b[0], b[1], b[2], b[3]);
}

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

__global__ void __launch_bounds__(kThreads) set_aggregation_kernel(Args a) {
  __shared__ int s_cluster[kMaxPrimaries];         // slot -> cluster
  __shared__ float s_x[kMaxPrimaries], s_y[kMaxPrimaries], s_z[kMaxPrimaries];
  __shared__ float s_size[kMaxPrimaries];
  __shared__ int32_t s_cls[kMaxPrimaries], s_batch[kMaxPrimaries];
  __shared__ int64_t s_prop[kMaxPrimaries];        // by bucket position
  __shared__ int s_wc[kWarps][kBuckets], s_off[kWarps][kBuckets];
  __shared__ int s_start[kBuckets], s_count[kBuckets];
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kWarps * kBuckets; i += kThreads) (&s_wc[0][0])[i] = 0;

  // 1: the first p2 primaries in cluster order
  const bool aligned = (reinterpret_cast<uintptr_t>(a.primary) & 15) == 0;
  int found = 0;
  for (int64_t r0 = 0; r0 < a.n && found < a.p2; r0 += 16 * kThreads) {
    const int64_t i0 = r0 + 16 * static_cast<int64_t>(threadIdx.x);
    const uint4 w = load_flags(a.primary, i0, a.n, aligned);
    const int mine = __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
    int total;
    int rank = found + block_exclusive_scan(mine, s_warp, &total);
    if (mine && rank < a.p2) {
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
      for (int e = 0; e < 16 && rank < a.p2; ++e) {
        if ((words[e >> 2] >> (8 * (e & 3))) & 0xffu) s_cluster[rank++] = static_cast<int>(i0 + e);
      }
    }
    found += total;
  }
  const int live = min(found, a.p2);
  __syncthreads();

  // 2: the live slots bucketed by (class, batch), slot order kept in a bucket
  const int j = threadIdx.x;  // kThreads == kMaxPrimaries: a slot a thread
  int h = -1, c = 0;
  int32_t kc = 0, kb = 0;
  if (j < live) {
    c = s_cluster[j];
    kc = __ldg(a.cls + c);
    kb = __ldg(a.cbatch + c);
    h = bucket_of(kc, kb);
  }
  const unsigned same = __match_any_sync(0xffffffffu, h);
  if (h >= 0 && lane == __ffs(same) - 1) s_wc[warp][h] = __popc(same);
  __syncthreads();
  if (threadIdx.x < kBuckets) {
    const int v = threadIdx.x;
    int acc = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      s_off[w][v] = acc;
      acc += s_wc[w][v];
    }
    s_count[v] = acc;
  }
  __syncthreads();
  if (warp == 0) {  // bucket starts: an exclusive scan of the counts, 4 a lane
    int t[4], sum = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      t[e] = s_count[4 * lane + e];
      sum += t[e];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += x;
    }
    int run = incl - sum;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s_start[4 * lane + e] = run;
      run += t[e];
    }
  }
  __syncthreads();
  if (h >= 0) {
    const int q = s_start[h] + s_off[warp][h] + __popc(same & ((1u << lane) - 1u));
    s_x[q] = __ldg(a.centers + 3 * static_cast<int64_t>(c));
    s_y[q] = __ldg(a.centers + 3 * static_cast<int64_t>(c) + 1);
    s_z[q] = __ldg(a.centers + 3 * static_cast<int64_t>(c) + 2);
    s_cls[q] = kc;
    s_batch[q] = kb;
    s_size[q] = __ldg(a.size_f + c);
    s_prop[q] = __ldg(reinterpret_cast<const long long*>(a.prim_prop) + c);
  }
  __syncthreads();

  // 3: batches of consecutive clusters, a warp a batch, a lane a cluster
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t per = (a.n + warps - 1) / warps;
  const int batch = static_cast<int>(per < 1 ? 1 : (per > 32 ? 32 : per));
  const int64_t tasks = (a.n + batch - 1) / batch;
  const unsigned char* prim = reinterpret_cast<const unsigned char*>(a.primary);
  const unsigned char* frag = reinterpret_cast<const unsigned char*>(a.fragment);
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + warp; t < tasks; t += warps) {
    const int64_t cc = t * batch + lane;
    const bool mine = lane < batch && cc < a.n;
    int64_t out = a.p_cap;
    bool is_frag = false;
    float qx = 0.f, qy = 0.f, qz = 0.f, rc = 0.f;
    int32_t fc = 0, fb = 0;
    if (mine) {
      if (__ldg(prim + cc)) {
        out = __ldg(reinterpret_cast<const long long*>(a.prim_prop) + cc);
      } else if (__ldg(frag + cc)) {
        is_frag = true;
        qx = __ldg(a.centers + 3 * cc);
        qy = __ldg(a.centers + 3 * cc + 1);
        qz = __ldg(a.centers + 3 * cc + 2);
        fc = __ldg(a.cls + cc);
        fb = __ldg(a.cbatch + cc);
        rc = __ldg(a.r_cls + cc);
      }
    }
    unsigned todo = __ballot_sync(0xffffffffu, is_frag);
    while (todo) {
      const int f = __ffs(todo) - 1;
      todo &= todo - 1;
      const float x = __shfl_sync(0xffffffffu, qx, f);
      const float y = __shfl_sync(0xffffffffu, qy, f);
      const float z = __shfl_sync(0xffffffffu, qz, f);
      const int32_t k = __shfl_sync(0xffffffffu, fc, f);
      const int32_t b = __shfl_sync(0xffffffffu, fb, f);
      const int hb = bucket_of(k, b);
      const int q0 = s_start[hb], q1 = q0 + s_count[hb];
      float best = kFar;
      int pos = kMaxPrimaries;
      bool nan = false;
      for (int q = q0 + lane; q < q1; q += 32) {
        if (s_cls[q] != k || s_batch[q] != b) continue;
        const float dx = __fsub_rn(x, s_x[q]);
        const float dy = __fsub_rn(y, s_y[q]);
        const float dz = __fsub_rn(z, s_z[q]);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        if (d != d) nan = true;
        if (d < best) {  // a lane's positions ascend: the first of its ties stays
          best = d;
          pos = q;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, o);
        const int op = __shfl_xor_sync(0xffffffffu, pos, o);
        if (ob < best || (ob == best && op < pos)) {
          best = ob;
          pos = op;
        }
      }
      nan = __any_sync(0xffffffffu, nan);
      if (lane == f && !nan && pos < kMaxPrimaries) {
        const float r_size = __fmul_rn(0.01f, __fsqrt_rn(s_size[pos]));
        // torch.maximum: NaN if either is NaN
        const float r_set = (r_size != r_size || rc != rc) ? r_size + rc : fmaxf(r_size, rc);
        if (best < __fmul_rn(r_set, r_set) && best < 1e9f) out = s_prop[pos];
      }
    }
    if (mine) a.prim_path[cc] = out;
  }
}

// Kernel launches enqueued so far, for the tests' count of a call's launches.
int64_t g_device_ops = 0;

}  // namespace

extern "C" int64_t ms3d_set_aggregation_device_ops() { return g_device_ops; }

// n clusters: centers (n, 3) f32, cls and cbatch (n,) int32, primary and
// fragment (n,) bool, prim_prop (n,) int64, size_f and r_cls (n,) f32;
// prim_path (n,) int64. One launch on `stream` (none for n = 0), no memset.
extern "C" int ms3d_set_aggregation(int64_t n, const float* centers, const int32_t* cls,
                                    const int32_t* cbatch, const bool* primary,
                                    const bool* fragment, const int64_t* prim_prop,
                                    const float* size_f, const float* r_cls, int64_t p_cap,
                                    int64_t* prim_path, cudaStream_t stream) {
  if (n < 0 || n > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  static int grid[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (grid[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, set_aggregation_kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    grid[dev] = sms * (per_sm < kMaxBlocksPerSm ? per_sm : kMaxBlocksPerSm);
  }
  const int64_t want = (n + 31) / 32;  // no more blocks than batches of 32 clusters a warp
  const int blocks = static_cast<int>(want < grid[dev] ? want : grid[dev]);
  const int p2 = static_cast<int>(n < kMaxPrimaries ? n : kMaxPrimaries);
  Args a{n, p2, centers, cls, cbatch, primary, fragment, prim_prop, size_f, r_cls, p_cap,
         prim_path};
  set_aggregation_kernel<<<blocks, kThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++g_device_ops;
  return static_cast<int>(err);
}
