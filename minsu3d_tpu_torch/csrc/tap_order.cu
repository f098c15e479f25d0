// K22 tap_orders: the tap orders of several index tables in one call, the
// tile order K1 reads (ops/sparse_conv.py tap_orders).
//
// Part of K1's design (csrc/gather_gemm.cu, point 2), so it stands for the
// same JAX code: minsu3d_tpu/ops/sparse_conv.py:50 subm_conv, :66
// down_conv and :80 up_conv, which gather every tap of every row and need
// no order. For table i (idx_i (R_i, T_i) int32, any value >= n_i absent)
// the order is its rows sorted stably by
//   key_i[r] = the bits t with idx_i[r, t] >= n_i
// (a row with no live tap has all T_i bits set and sorts last), with the
// sorted keys. One call orders every table a forward pass reads (the
// 7-level backbone's 7 kernel maps and 12 k2s2 tables):
//   tap_keys_kernel   writes key_i[r] | i << shift, shift the widest
//                     table's taps, for every row of every table into one
//                     column, a thread a row;
//   K15 (key_sort.cu) sorts that column stably on its shift + id bits, so
//                     each table's rows come out together, in table order,
//                     and sorted by their own keys;
//   tap_local_kernel  takes the table id off each sorted key and maps each
//                     permutation entry back to its table's own rows.
// Table i's order is then positions [start_i, start_i + R_i) of the two
// sorted columns. Integer-only and stable, so equal bit for bit to one
// stable sort a table (the plain version).
//
// What bounds it on an H100: bytes. The tables are read once (4 T bytes a
// row) and each row's sorted key and permutation entry written once: 36 MB,
// 11 us, for PointGroup's 19 tables (485376 rows); K15's passes and the
// key column come on top. What a forward pass felt of one order per table
// was the host's work, 19 chains of small torch ops and 19 K15 calls: a
// few ms of a host-bound forward, now one call (PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

extern "C" int ms3d_key_sort(const int64_t* keys, int64_t n, int bits, int64_t* s_key,
                             int32_t* perm, void* scratch, int64_t scratch_bytes,
                             cudaStream_t stream);

namespace {

constexpr int kMaxTables = 32;
constexpr int kThreads = 256;

// the tables, passed by value in the launch's parameter space
struct TapTables {
  const int32_t* idx[kMaxTables];
  int64_t start[kMaxTables + 1];  // first row of each table in the key column
  int taps[kMaxTables];
  int n_rows[kMaxTables];
  int count;
  int shift;
};

__device__ __forceinline__ int table_of(const TapTables& t, int64_t r) {
  int i = 0;
  while (i + 1 < t.count && r >= t.start[i + 1]) ++i;
  return i;
}

__global__ void tap_keys_kernel(const __grid_constant__ TapTables t, int64_t* keys) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= t.start[t.count]) return;
  const int i = table_of(t, r);
  const int taps = t.taps[i], n = t.n_rows[i];
  const int32_t* row = t.idx[i] + (r - t.start[i]) * taps;
  uint32_t bits = 0;
  for (int k = 0; k < taps; ++k) bits |= static_cast<uint32_t>(row[k] >= n) << k;
  keys[r] = static_cast<int64_t>(i) << t.shift | bits;
}

__global__ void tap_local_kernel(const __grid_constant__ TapTables t, int64_t* s_key,
                                 int32_t* perm) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= t.start[t.count]) return;
  const int64_t key = s_key[p];
  const int i = static_cast<int>(key >> t.shift);
  s_key[p] = key & ((int64_t{1} << t.shift) - 1);
  perm[p] -= static_cast<int32_t>(t.start[i]);
}

}  // namespace

// count tables (1..32) given by host arrays: idx pointers, rows, taps
// (1..32) and absent markers n_rows; keys, s_key (sum of rows,) int64 and
// perm (sum of rows,) int32 on the card, scratch of
// ms3d_key_sort_scratch(sum of rows, max taps + bit length of count - 1)
// bytes. s_key and perm then hold the tables' orders one after another.
extern "C" int ms3d_tap_orders(const int64_t* idx_ptrs, const int32_t* rows,
                               const int32_t* taps, const int32_t* n_rows, int count,
                               int64_t* keys, int64_t* s_key, int32_t* perm, void* scratch,
                               int64_t scratch_bytes, cudaStream_t stream) {
  if (count < 1 || count > kMaxTables) return static_cast<int>(cudaErrorInvalidValue);
  TapTables t{};
  t.count = count;
  int64_t total = 0;
  for (int i = 0; i < count; ++i) {
    if (taps[i] < 1 || taps[i] > 32 || rows[i] < 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    t.idx[i] = reinterpret_cast<const int32_t*>(idx_ptrs[i]);
    t.start[i] = total;
    t.taps[i] = taps[i];
    t.n_rows[i] = n_rows[i];
    t.shift = taps[i] > t.shift ? taps[i] : t.shift;
    total += rows[i];
  }
  t.start[count] = total;
  if (total == 0) return 0;
  int id_bits = 0;
  while ((1 << id_bits) < count) ++id_bits;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  tap_keys_kernel<<<blocks, kThreads, 0, stream>>>(t, keys);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sorted = ms3d_key_sort(keys, total, t.shift + id_bits, s_key, perm, scratch,
                                   scratch_bytes, stream);
  if (sorted != 0) return sorted;
  tap_local_kernel<<<blocks, kThreads, 0, stream>>>(t, s_key, perm);
  return static_cast<int>(cudaGetLastError());
}
