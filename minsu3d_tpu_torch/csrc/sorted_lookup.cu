// K16 sorted_lookup: searches of a sorted int64 key table. Three entry
// points:
//
// * ms3d_sorted_bounds (bounds mode): for each query key, the lower bound
//   (first row >= key) and the upper bound (first row > key), int32.
//   Replaces minsu3d_tpu/ops/hashing.py:62 lower_bound, :85 lookup and :103
//   lookup_sorted_union (whose idx is upper - 1 where found, its
//   upper_bound the upper bound) and the ball query's run starts and ends
//   (ops/ballquery.py:81, :103, :322).
// * ms3d_run_offsets (sorted-query route): the lower bounds of the queries
//   0, 1, ..., S in a sorted table, i.e. the offsets of a segment CSR
//   (segment.segment_csr); the JAX package's segment sums need none.
// * ms3d_neighbor_map (neighbour mode): the (V, 27) kernel map of one grid
//   level, minsu3d_tpu/ops/sparse.py:141 add_neighbors. Thread (v, k) forms
//   the key of row v's neighbour cell at offset KERNEL_OFFSETS[k] =
//   (k / 9 - 1, k / 3 % 3 - 1, k % 3 - 1) from the row's batch and coords,
//   tests that the cell lies in [0, 1024)^3, searches the level's
//   (khi, klo) table and writes the matching row or cap. The centre tap
//   (k = 13) is the row itself; an invalid row reads cap everywhere. No
//   (26, V) query tensor is ever materialised.
//
// What bounds it on an H100: the bytes that must move are the queries read
// once and the results written once (16 bytes a bounds query, 108 bytes a
// kernel-map row, 12 bytes a table row of run_offsets), but a binary
// search is a chain of dependent loads, and the last levels of it miss L1.
// The bounds mode shortens the chain: each block stages kSamples evenly
// spaced rows of the table in shared memory, a query finds its bucket
// there and searches only the bucket's ceil(n / kSamples) rows in global
// memory; the upper bound gallops forward from the lower bound (doubling
// steps, then a binary search in the bracket), exact, which costs one load
// where the key is absent and a few where its run is short, instead of a
// second full search. The grid is one block of 1024 threads an SM, each
// thread taking several queries, so the staging is paid 132 times and not
// once per 1024 queries (on the card, 512 samples and this grid beat 256 to
// 4096 samples and two blocks an SM or one query a thread). run_offsets reads each row once, no search: a
// row whose value differs from its predecessor's writes the offsets of the
// ids in between; a block fills a long gap (empty segments, the padding id)
// with all its threads. Integer-only: equal to torch.searchsorted and to
// the JAX lookups bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBoundsThreads = 1024;
constexpr int kSamples = 512;  // 4 KB of int64 a block
constexpr int kShortRun = 16;   // run_offsets: longer gaps are filled by the block

// first row in [lo, hi) of s with s[row] >= q (upper: > q), else hi
__device__ __forceinline__ int64_t search(const int64_t* __restrict__ s, int64_t lo, int64_t hi,
                                          int64_t q, bool upper) {
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

__global__ void __launch_bounds__(kBoundsThreads)
bounds_kernel(const int64_t* __restrict__ s_key, int64_t n, int64_t step,
              const int64_t* __restrict__ q_key, int64_t nq, int32_t* __restrict__ lower,
              int32_t* __restrict__ upper) {
  __shared__ int64_t samp[kSamples];  // samp[j] = s_key[j * step]
  const int n_samp = static_cast<int>((n + step - 1) / step);
  for (int j = threadIdx.x; j < n_samp; j += blockDim.x) samp[j] = __ldg(s_key + j * step);
  __syncthreads();
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < nq;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t q = q_key[i];
    int lo = 0, hi = n_samp;  // m = the first sample >= q
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (samp[mid] < q) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    // rows before (m - 1) * step + 1 are < q, row m * step (if any) is >= q
    const int64_t row_lo = lo == 0 ? 0 : (lo - 1) * step + 1;
    const int64_t row_hi = min(static_cast<int64_t>(lo) * step, n);
    const int64_t lb = search(s_key, row_lo, row_hi, q, false);
    if (lower) lower[i] = static_cast<int32_t>(lb);
    if (upper) {
      int64_t ub = lb;
      if (lb < n && __ldg(s_key + lb) == q) {
        // s[a] == q; gallop to the first b with s[b] > q (or n)
        int64_t a = lb, gap = 1, b = lb + 1;
        while (b < n && __ldg(s_key + b) <= q) {
          a = b;
          gap <<= 1;
          b = a + gap;
        }
        ub = search(s_key, a + 1, min(b, n), q, true);
      }
      upper[i] = static_cast<int32_t>(ub);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
run_offsets_kernel(const int64_t* __restrict__ s, int64_t n, int64_t num_segments,
                   int32_t* __restrict__ offsets) {
  __shared__ int64_t gap_lo[kThreads], gap_hi[kThreads];
  __shared__ int32_t gap_row[kThreads];
  __shared__ int n_gaps;
  if (threadIdx.x == 0) n_gaps = 0;
  __syncthreads();
  // row i (i = n: past the last row) is the lower bound of the ids in
  // (s[i - 1], s[i]], clipped to [0, num_segments]
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i <= n) {
    int64_t lo = 0, hi = num_segments;
    if (i > 0) {
      const int64_t prev = s[i - 1];
      lo = prev < 0 ? 0 : (prev >= num_segments ? num_segments + 1 : prev + 1);
    }
    if (i < n) hi = min(s[i], num_segments);
    if (hi - lo >= kShortRun) {
      const int slot = atomicAdd(&n_gaps, 1);
      gap_lo[slot] = lo;
      gap_hi[slot] = hi;
      gap_row[slot] = static_cast<int32_t>(i);
    } else {
      for (int64_t id = lo; id <= hi; ++id) offsets[id] = static_cast<int32_t>(i);
    }
  }
  __syncthreads();
  for (int e = 0; e < n_gaps; ++e) {
    for (int64_t id = gap_lo[e] + threadIdx.x; id <= gap_hi[e]; id += kThreads) {
      offsets[id] = gap_row[e];
    }
  }
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

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      count = 132;
    }
  }
  return count;
}

}  // namespace

// lower or upper may be null (that bound is not written).
extern "C" int ms3d_sorted_bounds(const int64_t* s_key, int64_t n, const int64_t* q_key,
                                  int64_t nq, int32_t* lower, int32_t* upper,
                                  cudaStream_t stream) {
  if (n < 0 || n > INT32_MAX || nq < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return 0;
  const int64_t step = n > kSamples ? (n + kSamples - 1) / kSamples : 1;
  const int64_t blocks = min((nq + kBoundsThreads - 1) / kBoundsThreads,
                             static_cast<int64_t>(sm_count()));
  bounds_kernel<<<static_cast<unsigned>(blocks), kBoundsThreads, 0, stream>>>(
      s_key, n, step, q_key, nq, lower, upper);
  return static_cast<int>(cudaGetLastError());
}

// offsets (num_segments + 1,) int32: offsets[id] = the first row of the
// ascending s_key (n,) that is >= id.
extern "C" int ms3d_run_offsets(const int64_t* s_key, int64_t n, int64_t num_segments,
                                int32_t* offsets, cudaStream_t stream) {
  if (n < 0 || n > INT32_MAX || num_segments < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n + 1 + kThreads - 1) / kThreads;
  run_offsets_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      s_key, n, num_segments, offsets);
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
