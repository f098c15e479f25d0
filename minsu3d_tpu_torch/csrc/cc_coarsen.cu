// K18 cc_coarsen: the root-graph coarsening of connected components, its
// pair keys (cc_cross_pairs) and its pair-list hook (cc_pair_hook).
//
// Replaces minsu3d_tpu/ops/cluster.py:102-136 (connected_components with
// coarsen > 0): after `coarsen_sweeps` full sweeps most edges join nodes
// that already share a root; the distinct cross-root pairs are compacted
// into a `coarsen`-slot list and hooking iterates on that list.
//   * cc_cross_pairs: for each edge slot (u, j) that passes the edge mask
//     (active[u], nbr_valid, v = nbr[u, j] in [0, n), active[v], equal
//     groups; tested in that order, so an inactive unit's row costs one
//     byte), ru = label[u], rv = label[v]: where ru != rv, the key
//     min(ru, rv) << 31 | max(ru, rv) is appended to `keys` (a warp-
//     aggregated atomic counter, `count`). The slots that join no two roots,
//     most of them after the first sweeps, emit nothing, so the sort takes
//     only the cross-root keys. The int64 order of the keys is JAX's two-key
//     lexsort of the (a, b) pairs (a, b < n < 2^31), where its sentinels
//     (n, n) sort last. The append order depends on the atomics, the sorted
//     keys do not: K15 (key_sort.cu) sorts them and K17 (unique_compact.cu)
//     keeps the first `coarsen` distinct keys, in order: JAX's lax.sort +
//     uniq + slot < coarsen (:104-119), including which pairs survive an
//     overflowing list.
//   * cc_pair_hook: for each slot (a, b) with both ends < n, ra = prev[a],
//     rb = prev[b]: atomicMin(&label[max(ra, rb)], min(ra, rb)), JAX's
//     csweep scatters (:121-130; its other writes are no-ops, e[x] <= x).
//     The wrapper follows it with K3's synchronous jumps.
//
// What bounds it on an H100: cc_cross_pairs reads one byte a unit, the
// active units' rows of the (n, K) table (4 + 1 bytes a slot), their
// groups and labels, and writes 8 bytes a cross-root key: memory- or
// launch-bound. cc_pair_hook touches `coarsen` slots: launch-bound.
// Design: one thread per slot; one atomicAdd a warp.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kShift = 31;

__global__ void cc_cross_pairs_kernel(const int32_t* __restrict__ nbr,
                                      const uint8_t* __restrict__ nbr_valid,
                                      const uint8_t* __restrict__ active,
                                      const int32_t* __restrict__ group, int n, int k,
                                      const int32_t* __restrict__ label,
                                      int64_t* __restrict__ keys, int32_t* count) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t total = static_cast<int64_t>(n) * k;
  int64_t key = 0;
  bool emit = false;
  if (s < total) {
    const int u = static_cast<int>(s / k);
    if (active[u] && nbr_valid[s]) {
      const int32_t v = nbr[s];
      if (v >= 0 && v < n && active[v] && group[v] == group[u]) {
        const int32_t ru = label[u];
        const int32_t rv = label[v];
        emit = ru != rv;
        key = (static_cast<int64_t>(min(ru, rv)) << kShift) | max(ru, rv);
      }
    }
  }
  // every lane of the warp is here (blocks are whole warps)
  const unsigned mask = __ballot_sync(0xffffffffu, emit);
  if (mask == 0) return;
  const int lane = threadIdx.x & 31;
  int32_t base = 0;
  if (lane == __ffs(mask) - 1) base = atomicAdd(count, __popc(mask));
  base = __shfl_sync(0xffffffffu, base, __ffs(mask) - 1);
  if (emit) keys[base + __popc(mask & ((1u << lane) - 1))] = key;
}

__global__ void cc_pair_hook_kernel(const int32_t* __restrict__ ea,
                                    const int32_t* __restrict__ eb, int m, int n,
                                    const int32_t* __restrict__ prev, int32_t* label) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int32_t a = ea[i];
  const int32_t b = eb[i];
  if (a < 0 || a >= n || b < 0 || b >= n) return;
  const int32_t ra = prev[a];
  const int32_t rb = prev[b];
  if (ra != rb) atomicMin(&label[max(ra, rb)], min(ra, rb));
}

}  // namespace

// nbr (n, k) int32, nbr_valid (n, k) bool, active (n,) bool, group (n,)
// int32, label (n,) int32 -> keys (room for n * k) int64, the cross-root
// keys in keys[0, *count); *count (int32) zeroed by the caller.
extern "C" int ms3d_cc_cross_pairs(const int32_t* nbr, const uint8_t* nbr_valid,
                                   const uint8_t* active, const int32_t* group, int n, int k,
                                   const int32_t* label, int64_t* keys, int32_t* count,
                                   cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(n) * k;
  if (total > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  cc_cross_pairs_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      nbr, nbr_valid, active, group, n, k, label, keys, count);
  return static_cast<int>(cudaGetLastError());
}

// ea, eb (m,) int32 pair list (slots with an end >= n are empty); prev
// (n,) the labels before the hook, label (n,) updated in place.
extern "C" int ms3d_cc_pair_hook(const int32_t* ea, const int32_t* eb, int m, int n,
                                 const int32_t* prev, int32_t* label, cudaStream_t stream) {
  if (m == 0) return static_cast<int>(cudaSuccess);
  cc_pair_hook_kernel<<<(m + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      ea, eb, m, n, prev, label);
  return static_cast<int>(cudaGetLastError());
}
