// K3 connected components: cc_hook + cc_jumps, the JAX sweep.
//
// Replaces minsu3d_tpu/ops/cluster.py:21 connected_components: its sweep
// (:73-90, root hooking by scatter-min onto neighbour roots, then two
// synchronous pointer jumps, its default `jumps`, same-group edges only) and, driven from the
// wrapper (minsu3d_tpu_torch/ops/cluster.py), its loops with their exact
// sweep counts, so the labels equal JAX's at every budget, not only at the
// fixpoint. The root-graph coarsening's pair keys and pair-list hook are
// K18 (cc_coarsen.cu); its hook is followed by these jumps too.
//
// One sweep:
//   1. prev = label (a copy made by the wrapper);
//   2. cc_hook: for every valid edge (u, v) -- v = nbr[u, j] < n,
//      nbr_valid, both ends active, group[u] == group[v] -- with
//      ru = prev[u] != rv = prev[v]: atomicMin(&label[max(ru, rv)],
//      min(ru, rv)). That is JAX's pair of scatter-mins e.at[e].min(m) and
//      e.at[rv].min(e): their other writes are no-ops, since e[x] <= x.
//      Reading the copy makes the result independent of the atomics' order;
//   3. cc_jumps: two synchronous jumps out[u] = min(in[u], in[in[u]]),
//      label -> tmp -> label (an in-place jump would read labels that the
//      same jump already lowered, and give other labels at a truncated
//      budget); inactive nodes keep n. The second raises `changed` where
//      the sweep's result differs from prev (JAX's all(new == e)).
// Invariant label[u] <= u and label[u] in u's component.
//
// What bounds it on an H100: a sweep reads the (n, K) neighbour table once
// (4 + 1 bytes per slot) plus scattered label reads: HBM and atomic latency
// at n = 65536, K = 16; a handful of sweeps per call. Design, simple for
// now: one thread per node; the host reads the flag after each sweep.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void cc_hook_kernel(const int32_t* __restrict__ nbr,
                               const uint8_t* __restrict__ nbr_valid,
                               const uint8_t* __restrict__ active,
                               const int32_t* __restrict__ group, int n, int k,
                               const int32_t* __restrict__ prev, int32_t* label) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= n || !active[u]) return;
  const int32_t ru = prev[u];
  const int32_t gu = group[u];
  for (int j = 0; j < k; ++j) {
    const int64_t e = static_cast<int64_t>(u) * k + j;
    const int32_t v = nbr[e];
    if (!nbr_valid[e] || v < 0 || v >= n || !active[v] || group[v] != gu) continue;
    const int32_t rv = prev[v];
    if (ru == rv) continue;
    atomicMin(&label[max(ru, rv)], min(ru, rv));
  }
}

// out[u] = min(in[u], in[in[u]]) for active u, n otherwise; with `prev`,
// raise *changed where out differs from it.
__global__ void cc_jump_kernel(const uint8_t* __restrict__ active, int n,
                               const int32_t* __restrict__ in, int32_t* __restrict__ out,
                               const int32_t* __restrict__ prev, int32_t* changed) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= n) return;
  int32_t v = n;
  if (active[u]) {
    const int32_t l = in[u];
    v = (l >= 0 && l < n) ? min(l, in[l]) : l;
  }
  out[u] = v;
  if (prev != nullptr && v != prev[u]) *changed = 1;
}

}  // namespace

extern "C" int ms3d_cc_hook(const int32_t* nbr, const uint8_t* nbr_valid,
                            const uint8_t* active, const int32_t* group, int n, int k,
                            const int32_t* prev, int32_t* label, cudaStream_t stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  cc_hook_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      nbr, nbr_valid, active, group, n, k, prev, label);
  return static_cast<int>(cudaGetLastError());
}

// Two synchronous jumps on label (n,), tmp (n,) scratch; the result is
// left in label. *changed (zeroed by the caller) is raised where the
// result differs from prev (n,).
extern "C" int ms3d_cc_jumps(const uint8_t* active, int n, int32_t* label, int32_t* tmp,
                             const int32_t* prev, int32_t* changed, cudaStream_t stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (n + kThreads - 1) / kThreads;
  cc_jump_kernel<<<blocks, kThreads, 0, stream>>>(active, n, label, tmp, nullptr, changed);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cc_jump_kernel<<<blocks, kThreads, 0, stream>>>(active, n, tmp, label, prev, changed);
  return static_cast<int>(cudaGetLastError());
}
