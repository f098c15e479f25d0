// K16 sorted_lookup: binary searches of a sorted int64 key table, one
// thread per query. Two entry points:
//
// * ms3d_sorted_bounds (bounds mode): for each query key, the lower bound
//   (first row >= key) and the upper bound (first row > key), int32.
//   Replaces minsu3d_tpu/ops/hashing.py:62 lower_bound, :85 lookup and :103
//   lookup_sorted_union (whose idx is upper - 1 where found, its
//   upper_bound the upper bound), the ball query's run starts and ends
//   (ops/ballquery.py:81, :103, :322) and the offsets of every segment CSR
//   (segment.segment_csr: the lower bound of each segment id).
// * ms3d_neighbor_map (neighbour mode): the (V, 27) kernel map of one grid
//   level, minsu3d_tpu/ops/sparse.py:141 add_neighbors. Thread (v, k) forms
//   the key of row v's neighbour cell at offset KERNEL_OFFSETS[k] =
//   (k / 9 - 1, k / 3 % 3 - 1, k % 3 - 1) from the row's batch and coords,
//   tests that the cell lies in [0, 1024)^3, searches the level's
//   (khi, klo) table and writes the matching row or cap. The centre tap
//   (k = 13) is the row itself; an invalid row reads cap everywhere. No
//   (26, V) query tensor is ever materialised.
//
// What bounds it on an H100: the table reads. A search touches log2(n)
// rows, the first levels of which every thread shares (they stay in L1/L2),
// so the bytes that must move are the queries read once and the results
// written once: 16 bytes a bounds query, 108 bytes a kernel-map row. The
// random row fetches of the last levels are the real cost; a merge of
// sorted queries, or a hash table, would cut them, later. Integer-only:
// equal to torch.searchsorted and to the JAX lookups bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t search(const int64_t* __restrict__ s, int64_t n, int64_t q,
                                          bool upper) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const int64_t v = __ldg(s + mid);
    if (upper ? v <= q : v < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void bounds_kernel(const int64_t* __restrict__ s_key, int64_t n,
                              const int64_t* __restrict__ q_key, int64_t nq,
                              int32_t* __restrict__ lower, int32_t* __restrict__ upper) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const int64_t q = q_key[i];
  if (lower) lower[i] = static_cast<int32_t>(search(s_key, n, q, false));
  if (upper) upper[i] = static_cast<int32_t>(search(s_key, n, q, true));
}

__device__ __forceinline__ int64_t pair_key(int32_t hi, int32_t lo) {
  return (static_cast<int64_t>(hi) << 31) | static_cast<int64_t>(lo);
}

__global__ void neighbor_kernel(const int32_t* __restrict__ khi, const int32_t* __restrict__ klo,
                                const int32_t* __restrict__ coords,
                                const int32_t* __restrict__ batch,
                                const bool* __restrict__ valid, int32_t cap,
                                int32_t* __restrict__ nbr) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(cap) * 27) return;
  const int32_t v = static_cast<int32_t>(t / 27);
  const int k = static_cast<int>(t - static_cast<int64_t>(v) * 27);
  int32_t out = cap;
  if (valid[v]) {
    if (k == 13) {
      out = v;
    } else {
      const int32_t qx = coords[3 * v] + k / 9 - 1;
      const int32_t qy = coords[3 * v + 1] + (k / 3) % 3 - 1;
      const int32_t qz = coords[3 * v + 2] + k % 3 - 1;
      if (qx >= 0 && qx < 1024 && qy >= 0 && qy < 1024 && qz >= 0 && qz < 1024) {
        const int64_t q = pair_key(batch[v], (qx << 20) | (qy << 10) | qz);
        int32_t lo = 0, hi = cap;
        while (lo < hi) {
          const int32_t mid = (lo + hi) >> 1;
          if (pair_key(__ldg(khi + mid), __ldg(klo + mid)) < q) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        if (lo < cap && pair_key(khi[lo], klo[lo]) == q) out = lo;
      }
    }
  }
  nbr[t] = out;
}

}  // namespace

// lower or upper may be null (that bound is not written).
extern "C" int ms3d_sorted_bounds(const int64_t* s_key, int64_t n, const int64_t* q_key,
                                  int64_t nq, int32_t* lower, int32_t* upper,
                                  cudaStream_t stream) {
  if (n < 0 || n > INT32_MAX || nq < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return 0;
  const int64_t blocks = (nq + kThreads - 1) / kThreads;
  bounds_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(s_key, n, q_key, nq,
                                                                         lower, upper);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ms3d_neighbor_map(const int32_t* khi, const int32_t* klo, const int32_t* coords,
                                 const int32_t* batch, const bool* valid, int32_t cap,
                                 int32_t* nbr, cudaStream_t stream) {
  if (cap < 0 || static_cast<int64_t>(cap) * 27 > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cap == 0) return 0;
  const int64_t blocks = (static_cast<int64_t>(cap) * 27 + kThreads - 1) / kThreads;
  neighbor_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(khi, klo, coords,
                                                                           batch, valid, cap,
                                                                           nbr);
  return static_cast<int>(cudaGetLastError());
}
