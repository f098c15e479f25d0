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
// * ms3d_neighbor_maps (neighbour mode): the (V, 27) kernel map of every
//   level of a grid plan in one launch, minsu3d_tpu/ops/sparse.py:141
//   add_neighbors (called once a level by :192 build_plan). Tap k of row v
//   is the row of the neighbour cell at offset KERNEL_OFFSETS[k] = (k / 9 -
//   1, k / 3 % 3 - 1, k % 3 - 1) where that cell lies in [0, 1024)^3 and is
//   in the level's (khi, klo) table, else cap; the centre tap (k = 13) is
//   the row itself; an invalid row reads cap everywhere. The levels'
//   pointers and caps travel in the kernel's parameters (no copy to the
//   card); a block finds its level from the prefix of the levels' tile
//   counts. One search a (row, (dx, dy)) column instead of one a tap, in a
//   bracket staged by the tile (neighbor_maps_kernel below). The valid rows' keys are unique and their
//   batch and coords pack them, as in every level table.
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
// 4096 samples and two blocks an SM or one query a thread). The
// neighbour mode's bytes are mostly its output: 108 bytes a row, padding
// rows included (7 levels of the golden PointGroup plan: 193536 rows, 21 MB,
// 0.0069 ms), so it writes by 16-byte stores from a staged tile; its keys'
// searches (8 a valid row) run in shared memory. run_offsets reads each
// row once, no search: a row whose value differs from its predecessor's
// writes the offsets of the ids in between; a block fills a long gap
// (empty segments, the padding id) with all its threads. Integer-only:
// equal to torch.searchsorted and to the JAX lookups bit for bit.

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

// ---- neighbour mode --------------------------------------------------------

constexpr int kMapThreads = 256;
constexpr int kMapRows = 128;                 // rows a tile (a multiple of 4)
constexpr int kMaxLevels = 8;
constexpr int kColumns = 8;                   // the (dx, dy) columns that need a search
constexpr int kBracket = 2 * kMapRows + 8;    // table rows staged a column
constexpr int32_t kSentinel = 0x7fffffff;

// One level of a plan: its sorted table, the fields its rows' queries are
// built from, its (cap, 27) map, and the first tile of the launch's grid
// that belongs to it.
struct MapLevel {
  const int32_t* khi;
  const int32_t* klo;
  const int32_t* coords;  // (cap, 3)
  const int32_t* batch;
  const bool* valid;
  int32_t* nbr;           // (cap, 27), 16-byte aligned
  int32_t cap;
  int32_t tile0;          // the level's first block
};

struct MapArgs {
  MapLevel lv[kMaxLevels];
  int n_levels;
};

__device__ __forceinline__ int64_t table_key(const MapLevel& L, int64_t r) {
  return pair_key(__ldg(L.khi + r), __ldg(L.klo + r));
}

// The key delta of column ci = (dx + 1) * 3 + (dy + 1): a sum, not an OR
// (a negative field delta borrows from the field above, which the range
// checks reject).
__device__ __forceinline__ int64_t column_delta(int ci) {
  return (static_cast<int64_t>(ci / 3 - 1) << 20) + (static_cast<int64_t>(ci % 3 - 1) << 10);
}

// Lower bound of q among the table rows [lo, hi) by the 16 lanes of a half
// warp, 16 probes a step (the two halves of a warp search at once, each for
// its own q); every lane of the warp calls it.
__device__ int32_t half_warp_lower_bound(const MapLevel& L, int64_t q, int32_t lo, int32_t hi) {
  const int lane = threadIdx.x & 31, j = lane & 15, shift = lane & 16;
  bool done = false;
  while (__any_sync(0xffffffffu, !done)) {
    const int32_t n = hi - lo;
    const int32_t step = (n + 15) >> 4;
    const int32_t pos = lo + j * step;
    const bool below = !done && n > 0 && pos < hi && table_key(L, pos) < q;
    const int c = __popc((__ballot_sync(0xffffffffu, below) >> shift) & 0xffffu);
    if (done) continue;
    if (n == 0) {
      done = true;
    } else if (step == 1) {  // every row of [lo, hi) was probed
      lo += c;
      done = true;
    } else if (c == 0) {     // the row at lo is >= q
      done = true;
    } else {
      const int probes = (n + step - 1) / step;
      if (c < probes) hi = lo + c * step;
      lo += (c - 1) * step + 1;
    }
  }
  return lo;
}

// first row in [lo, hi) of the table >= q, else hi (global memory)
__device__ __forceinline__ int32_t table_lower_bound(const MapLevel& L, int32_t lo, int32_t hi,
                                                     int64_t q) {
  while (lo < hi) {
    const int32_t mid = (lo + hi) >> 1;
    if (table_key(L, mid) < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// A block is a tile of kMapRows consecutive rows of one level. A valid row v
// asks, for each column (dx, dy), the keys q0 - 1, q0 and q0 + 1 of its three
// dz taps, q0 = key(v) + (dx << 20) + (dy << 10); present keys sit in
// consecutive table rows, so one lower bound of q0 - 1 and a walk of at most
// three rows settle them (the walk matches q0 - 1, q0, q0 + 1 in turn and steps
// one row past each match: keys are unique). Over the tile a column's q0 - 1
// ascend, so the tile brackets the column's lower bounds by those of its first
// and last valid rows (a half warp each, 16-ary over the whole table), stages
// the bracket's keys in shared memory and searches there (in global memory
// within the bracket where it is longer than kBracket). Column (0, 0) reads
// rows v - 1 and v + 1. Every tap keeps neighbor_map_plain's range checks: a z
// = 1023 row does not take the next column's z = 0 row (key + 1) for its
// neighbour, nor a y = 1023 row the next slab's y = 0 row. The tile's kMapRows
// x 27 results are staged in shared memory and written by 16-byte stores; a
// tile with no valid row writes cap and reads nothing but its valid flags.
__global__ void __launch_bounds__(kMapThreads) neighbor_maps_kernel(const MapArgs a) {
  __shared__ __align__(16) int32_t s_out[kMapRows * 27];
  __shared__ int64_t s_br[kColumns][kBracket];
  __shared__ int64_t s_key[kMapRows];      // key(v) from batch and coords
  __shared__ int64_t s_tab[kMapRows + 2];  // table keys of rows t0 - 1 .. t0 + kMapRows
  __shared__ int32_t s_xyz[3][kMapRows];
  __shared__ int8_t s_state[kMapRows];     // 0 invalid, 1 valid with a SENTINEL batch, 2 valid
  __shared__ int32_t s_lo[kColumns], s_hi[kColumns];
  __shared__ int s_first, s_last;

  MapLevel L = a.lv[0];  // the last level whose first block is at or before this one
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (i < a.n_levels && static_cast<int32_t>(blockIdx.x) >= a.lv[i].tile0) L = a.lv[i];
  }
  const int32_t cap = L.cap;
  const int32_t t0 = (static_cast<int32_t>(blockIdx.x) - L.tile0) * kMapRows;
  const int n = min(kMapRows, cap - t0);
  const int tid = threadIdx.x;
  int32_t* out = L.nbr + static_cast<int64_t>(t0) * 27;
  int4* out4 = reinterpret_cast<int4*>(out);
  const int n4 = n * 27 / 4;

  const bool mine_valid = tid < n && L.valid[t0 + tid];
  if (!__syncthreads_or(mine_valid)) {  // padding: cap everywhere
    const int4 fill = make_int4(cap, cap, cap, cap);
    for (int i = tid; i < n4; i += kMapThreads) out4[i] = fill;
    for (int i = 4 * n4 + tid; i < n * 27; i += kMapThreads) out[i] = cap;
    return;
  }
  if (tid == 0) {
    s_first = kMapRows;
    s_last = -1;
  }
  __syncthreads();
  if (tid < n) {
    int8_t state = 0;
    if (mine_valid) {
      const int64_t v = t0 + tid;
      const int32_t b = __ldg(L.batch + v);
      const int32_t x = __ldg(L.coords + 3 * v), y = __ldg(L.coords + 3 * v + 1),
                    z = __ldg(L.coords + 3 * v + 2);
      s_xyz[0][tid] = x;
      s_xyz[1][tid] = y;
      s_xyz[2][tid] = z;
      state = b == kSentinel ? 1 : 2;
      if (state == 2) {
        s_key[tid] = (static_cast<int64_t>(b) << 31) + (static_cast<int64_t>(x) << 20) +
                     (static_cast<int64_t>(y) << 10) + z;
        atomicMin(&s_first, tid);
        atomicMax(&s_last, tid);
      }
    }
    s_state[tid] = state;
  }
  __syncthreads();
  const int first = s_first, last = s_last;
  if (last >= 0) {
    for (int i = tid; i < n + 2; i += kMapThreads) {
      const int32_t r = t0 - 1 + i;
      if (r >= 0 && r < cap) s_tab[i] = table_key(L, r);
    }
    // the brackets: warp w's half warps find the lower bounds of search
    // column w's first and last queries (columns 0-3 and 5-8)
    const int warp = tid >> 5, lane = tid & 31;
    for (int j = warp; j < kColumns; j += kMapThreads / 32) {
      const int ci = j < 4 ? j : j + 1;
      const int64_t q = s_key[lane < 16 ? first : last] + column_delta(ci) - 1;
      const int32_t lb = half_warp_lower_bound(L, q, 0, cap);
      if (lane == 0) s_lo[j] = lb;
      if (lane == 16) s_hi[j] = lb;
    }
    __syncthreads();
    for (int j = 0; j < kColumns; ++j) {
      const int32_t lo = s_lo[j], m = min(s_hi[j] + 3, cap) - lo;
      if (m <= kBracket) {
        for (int i = tid; i < m; i += kMapThreads) s_br[j][i] = table_key(L, lo + i);
      }
    }
  }
  __syncthreads();

  // every (row, column) of the tile, consecutive threads on consecutive rows
  for (int item = tid; item < 9 * kMapRows; item += kMapThreads) {
    const int ci = item / kMapRows, row = item - ci * kMapRows;
    if (row >= n) continue;
    const int state = s_state[row];
    const int32_t v = t0 + row;
    int32_t tap[3] = {cap, cap, cap};
    if (ci == 4 && state != 0) tap[1] = v;
    if (state == 2) {
      const int32_t qx = s_xyz[0][row] + ci / 3 - 1, qy = s_xyz[1][row] + ci % 3 - 1;
      const int32_t z = s_xyz[2][row];
      if (qx >= 0 && qx < 1024 && qy >= 0 && qy < 1024) {
        const int64_t q0 = s_key[row] + column_delta(ci);
        bool z_ok[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) z_ok[d] = z + d - 1 >= 0 && z + d - 1 < 1024;
        if (ci == 4 && s_tab[row + 1] == q0) {
          // the row holds its own key: key - 1 and key + 1 can only be its
          // neighbours in the table
          if (z_ok[0] && v >= 1 && s_tab[row] == q0 - 1) tap[0] = v - 1;
          if (z_ok[2] && v + 1 < cap && s_tab[row + 2] == q0 + 1) tap[2] = v + 1;
        } else {
          // a search column, or column (0, 0) of a row whose fields do not
          // pack its own table key
          // (a row outside the first and last keys, which only fields that
          // do not pack the table's keys make, searches the whole table too)
          const int j = ci < 4 ? ci : ci - 1;
          const bool in_br = ci != 4 && s_key[row] >= s_key[first] && s_key[row] <= s_key[last];
          const int32_t lo = in_br ? s_lo[j] : 0;
          const int32_t hi = in_br ? min(s_hi[j] + 3, cap) : cap;
          const bool staged = in_br && hi - lo <= kBracket;
          int32_t r;
          if (staged) {
            int32_t a0 = 0, a1 = hi - lo;
            while (a0 < a1) {
              const int32_t mid = (a0 + a1) >> 1;
              if (s_br[j][mid] < q0 - 1) {
                a0 = mid + 1;
              } else {
                a1 = mid;
              }
            }
            r = lo + a0;
          } else {
            r = table_lower_bound(L, lo, in_br ? min(s_hi[j] + 1, cap) : cap, q0 - 1);
          }
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            if (r < hi) {
              const int64_t k = staged ? s_br[j][r - lo] : table_key(L, r);
              if (k == q0 + d - 1) {
                if (z_ok[d]) tap[d] = r;
                ++r;
              }
            }
          }
        }
      }
    }
    int32_t* o = s_out + row * 27 + 3 * ci;
    o[0] = tap[0];
    o[1] = tap[1];
    o[2] = tap[2];
  }
  __syncthreads();
  const int4* s4 = reinterpret_cast<const int4*>(s_out);
  for (int i = tid; i < n4; i += kMapThreads) out4[i] = s4[i];
  for (int i = 4 * n4 + tid; i < n * 27; i += kMapThreads) out[i] = s_out[i];
}

// Kernel launches enqueued so far, for the tests' count of a call's launches.
int64_t g_map_device_ops = 0;

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

extern "C" int64_t ms3d_neighbor_maps_device_ops() { return g_map_device_ops; }

// The (cap, 27) kernel maps of n_levels (1 to 8) levels in one launch.
// fields: 6 pointers a level, in order khi, klo, coords, batch, valid and
// nbr (16-byte aligned); caps: each level's rows. No memset, no sync.
extern "C" int ms3d_neighbor_maps(int n_levels, void* const* fields, const int32_t* caps,
                                  cudaStream_t stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  MapArgs a{};
  a.n_levels = n_levels;
  int64_t tiles = 0;
  for (int l = 0; l < n_levels; ++l) {
    const int32_t cap = caps[l];
    MapLevel& L = a.lv[l];
    L.khi = static_cast<const int32_t*>(fields[6 * l]);
    L.klo = static_cast<const int32_t*>(fields[6 * l + 1]);
    L.coords = static_cast<const int32_t*>(fields[6 * l + 2]);
    L.batch = static_cast<const int32_t*>(fields[6 * l + 3]);
    L.valid = static_cast<const bool*>(fields[6 * l + 4]);
    L.nbr = static_cast<int32_t*>(fields[6 * l + 5]);
    if (cap < 0 || static_cast<int64_t>(cap) * 27 > INT32_MAX ||
        (cap > 0 && (reinterpret_cast<uintptr_t>(L.nbr) & 15) != 0)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    L.cap = cap;
    L.tile0 = static_cast<int32_t>(tiles);
    tiles += (cap + kMapRows - 1) / kMapRows;
  }
  if (tiles == 0) return 0;
  neighbor_maps_kernel<<<static_cast<unsigned>(tiles), kMapThreads, 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++g_map_device_ops;
  return static_cast<int>(err);
}
