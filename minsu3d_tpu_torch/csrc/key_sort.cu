// K15 key_sort: a stable ascending sort of int64 keys, returning the sorted
// keys and the permutation (int32: sorted position -> input row).
//
// Replaces the key sorts of the JAX package's coordinate hashing:
// minsu3d_tpu/ops/hashing.py:53 lexsort_pairs (jnp.lexsort over (klo, khi),
// behind ops/sparse.py:94 build_base, i.e. every grid-plan level and
// model/general_model.py:164/178 make_units / make_units_grid) and the
// ball queries' cell-table sorts (ops/ballquery.py:57-66, :204-213,
// :300-309). The port packs a (khi, klo) pair into one int64
// (khi << 31 | klo), which keeps the pairs' lexicographic order, and
// segment.segment_csr sorts segment ids with the same kernel.
//
// What bounds it on an H100: bytes. A sort must read the keys once and
// write keys and permutation once (12-20 bytes a key: ~3 MB at 262144 keys,
// about 1 us at 3.35 TB/s). This LSD radix sort moves the data once per
// pass that is not skipped, so its floor is a few passes times that, and at
// the path's sizes (1536 to 262144 keys) the 3 launches of each pass
// dominate. Making it fast (fewer launches, onesweep-style decoupled
// look-back) is later work; this version is simple and right.
//
// Design: 8-bit digits, 8 passes over the 64 bits (the top digit's sign bit
// flipped, so negative keys sort first: any int64 sorts right, and the
// port's keys are non-negative). Each pass:
//   1. hist_kernel: one block per tile of kTile keys counts its digits in
//      shared memory (warp-aggregated with __match_any_sync) and writes
//      hist[digit * n_tiles + tile];
//   2. scan_kernel: one block; thread d sums digit d's tiles, then writes
//      the exclusive offsets in digit-major, tile-minor order. If one
//      digit holds every key the pass is the identity: the kernel records
//      that in sel[] on the device (no host read) and the scatter skips;
//   3. scatter_kernel: one block per tile walks its tile in input order,
//      kThreads keys a round; a key's slot is its digit's running base +
//      the counts of its digit in the earlier warps of the round (shared
//      memory) + its rank among the earlier lanes of its warp with the same
//      digit (__match_any_sync). Input order is kept within a digit, so
//      the pass, and the sort, is stable.
// sel[p] says which of the two key/permutation buffers holds the data
// before pass p; a last launch copies the result into the output buffers
// when it ended in the scratch ones. Integer-only: equal to
// torch.sort(stable=True) bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // = kDigits: thread d owns digit d in the scan and tally
constexpr int kDigits = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;
constexpr int kTile = kThreads * kRounds;  // 4096 keys a tile
constexpr int kPasses = 8;

__device__ __forceinline__ int digit_of(int64_t key, int pass) {
  int d = static_cast<int>((static_cast<uint64_t>(key) >> (8 * pass)) & 255u);
  return pass == kPasses - 1 ? d ^ 128 : d;  // signed order in the top digit
}

__global__ void init_kernel(const int64_t* __restrict__ in, int64_t n,
                            int64_t* __restrict__ key0, int32_t* __restrict__ perm0,
                            int32_t* __restrict__ sel) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) {
    key0[i] = in[i];
    perm0[i] = static_cast<int32_t>(i);
  }
  if (i == 0) sel[0] = 0;
}

__global__ void hist_kernel(const int64_t* __restrict__ key0, const int64_t* __restrict__ key1,
                            const int32_t* __restrict__ sel, int pass, int64_t n, int n_tiles,
                            int32_t* __restrict__ hist) {
  __shared__ int32_t h[kDigits];
  const int tid = threadIdx.x, lane = tid & 31;
  h[tid] = 0;
  __syncthreads();
  const int64_t* keys = sel[pass] ? key1 : key0;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = start + static_cast<int64_t>(r) * kThreads + tid;
    const int d = i < n ? digit_of(keys[i], pass) : kDigits;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (d < kDigits && lane == __ffs(peers) - 1) atomicAdd(&h[d], __popc(peers));
  }
  __syncthreads();
  hist[static_cast<int64_t>(tid) * n_tiles + blockIdx.x] = h[tid];
}

__global__ void scan_kernel(int32_t* __restrict__ hist, int n_tiles, int64_t n, int pass,
                            int32_t* __restrict__ sel) {
  __shared__ int32_t total[kDigits];
  __shared__ int skip;
  const int d = threadIdx.x;
  int32_t* row = hist + static_cast<int64_t>(d) * n_tiles;
  int32_t s = 0;
  for (int t = 0; t < n_tiles; ++t) s += row[t];
  total[d] = s;
  if (d == 0) skip = 0;
  __syncthreads();
  if (s == n) skip = 1;  // one digit holds every key: the pass is the identity
  int32_t base = 0;
  for (int e = 0; e < d; ++e) base += total[e];
  for (int t = 0; t < n_tiles; ++t) {
    const int32_t c = row[t];
    row[t] = base;
    base += c;
  }
  __syncthreads();
  if (d == 0) sel[pass + 1] = skip ? sel[pass] : 1 - sel[pass];
}

__global__ void scatter_kernel(int64_t* __restrict__ key0, int64_t* __restrict__ key1,
                               int32_t* __restrict__ perm0, int32_t* __restrict__ perm1,
                               const int32_t* __restrict__ sel, int pass, int64_t n,
                               int n_tiles, const int32_t* __restrict__ offsets) {
  const int src = sel[pass];
  if (sel[pass + 1] == src) return;  // skipped pass (uniform over the block)
  const int64_t* kin = src ? key1 : key0;
  int64_t* kout = src ? key0 : key1;
  const int32_t* pin = src ? perm1 : perm0;
  int32_t* pout = src ? perm0 : perm1;

  __shared__ int32_t base[kDigits];
  __shared__ int32_t wcount[kWarps][kDigits];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  base[tid] = offsets[static_cast<int64_t>(tid) * n_tiles + blockIdx.x];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) wcount[w][tid] = 0;
  __syncthreads();

  const int64_t start = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = start + static_cast<int64_t>(r) * kThreads + tid;
    const bool live = i < n;
    const int64_t key = live ? kin[i] : 0;
    const int32_t p = live ? pin[i] : 0;
    const int d = live ? digit_of(key, pass) : kDigits;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (live && lane == __ffs(peers) - 1) wcount[warp][d] = __popc(peers);
    __syncthreads();
    if (live) {
      int32_t pos = base[d] + rank;
      for (int w = 0; w < warp; ++w) pos += wcount[w][d];
      kout[pos] = key;
      pout[pos] = p;
    }
    __syncthreads();
    int32_t add = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      add += wcount[w][tid];
      wcount[w][tid] = 0;
    }
    base[tid] += add;
    __syncthreads();
  }
}

__global__ void final_kernel(const int64_t* __restrict__ key1, const int32_t* __restrict__ perm1,
                             int64_t* __restrict__ key0, int32_t* __restrict__ perm0,
                             const int32_t* __restrict__ sel, int64_t n) {
  if (sel[kPasses] == 0) return;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) {
    key0[i] = key1[i];
    perm0[i] = perm1[i];
  }
}

}  // namespace

// Scratch that ms3d_key_sort needs: key_tmp of n int64, i32_tmp of
// ms3d_key_sort_i32_scratch(n) int32.
extern "C" int64_t ms3d_key_sort_i32_scratch(int64_t n) {
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  return n + kDigits * n_tiles + kPasses + 1;
}

extern "C" int ms3d_key_sort(const int64_t* keys, int64_t n, int64_t* s_key, int32_t* perm,
                             int64_t* key_tmp, int32_t* i32_tmp, cudaStream_t stream) {
  if (n < 0 || n > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int n_tiles = static_cast<int>((n + kTile - 1) / kTile);
  int32_t* perm_tmp = i32_tmp;
  int32_t* hist = i32_tmp + n;
  int32_t* sel = hist + static_cast<int64_t>(kDigits) * n_tiles;
  const int copy_blocks = static_cast<int>((n + 255) / 256);

  init_kernel<<<copy_blocks, 256, 0, stream>>>(keys, n, s_key, perm, sel);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int pass = 0; pass < kPasses; ++pass) {
    hist_kernel<<<n_tiles, kThreads, 0, stream>>>(s_key, key_tmp, sel, pass, n, n_tiles, hist);
    scan_kernel<<<1, kThreads, 0, stream>>>(hist, n_tiles, n, pass, sel);
    scatter_kernel<<<n_tiles, kThreads, 0, stream>>>(s_key, key_tmp, perm, perm_tmp, sel, pass,
                                                     n, n_tiles, hist);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  final_kernel<<<copy_blocks, 256, 0, stream>>>(key_tmp, perm_tmp, s_key, perm, sel, n);
  return static_cast<int>(cudaGetLastError());
}
