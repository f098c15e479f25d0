// K3 connected components and K18 its root-graph coarsening: one
// persistent cooperative kernel a call, every loop decided on the card.
//
// Replaces minsu3d_tpu/ops/cluster.py:21 connected_components: its sweep
// (:73-90: root hooking by scatter-min onto neighbour roots, then two
// synchronous pointer jumps, its default `jumps`, same-group edges only),
// its loops (:92-101) and, with coarsen > 0, the root-graph coarsening
// (:102-146, K18): the pair list of the first `coarsen` distinct cross-root
// pairs, the pair-list loop and the confirm loop seeded with done = (sweep
// changed nothing), i = 1. The sweep counts are JAX's, so the labels equal
// JAX's at every budget, not only at the fixpoint.
//
// One launch runs the whole call; a grid-wide barrier (grid_sync, valid
// because the cooperative launch makes every block co-resident) separates
// the phases, and every block reads the same flag after a barrier, so all
// leave each loop at the same sweep. Nothing is read back by the host.
//   init    labels S[u] = H0[u] = H1[u] = u (n for an inactive node) and
//           the active ids (act), appended in any order (one atomic a
//           block): later phases touch active rows only. The first
//           sweep's hook reads the active rows of the (n, K) table and
//           keeps each slot's edge in `ev` (v, or -1 where the slot is no
//           edge: nbr_valid, v in [0, n), both ends active, equal groups),
//           which later phases read instead.
//   sweep   hook: for every edge (u, v) with ru = S[u] != rv = S[v],
//           atomicMin(&H[max(ru, rv)], min(ru, rv)) into the sweep's hook
//           array H (equal to S when the sweep starts) -- JAX's two
//           scatter-mins, whose other writes are no-ops (e[x] <= x);
//           reading S while writing H makes the result independent of
//           the atomics' order. Then both synchronous jumps in one phase,
//           from H alone: jump 1 gives T[x] = min(H[x], H[H[x]]), jump 2
//           v = min(T[u], T[T[u]]); with t = T[u], T[t] = min(H[t], H[H[t]])
//           is read as four dependent gathers from H, which no thread
//           writes in the phase. Where v != S[u] the sweep's flag slot is
//           raised; S[u] and the other hook array take v (H0 and H1
//           alternate, so the next hook starts from a copy of S). A
//           barrier after the hook and one after the jumps.
//   pairs   (K18) after the first `coarsen_sweeps` sweeps: every edge with
//           S[u] != S[v] gives the key min << 31 | max (JAX's two-key
//           lexsort order of the (a, b) pairs); the keys are deduplicated
//           in a hash table (cleared during the first sweep, sized from
//           the active slots) and each distinct key appended once. If more
//           than `coarsen` are distinct, an MSD radix select (8-bit digits,
//           a global histogram and one barrier a digit, every block
//           picking the same digit) finds the coarsen-th smallest key T:
//           the list is the distinct keys <= T, exactly JAX's sort + uniq +
//           slot < coarsen, including which pairs survive an overflowing
//           list. The list is kept as a set: the pair hook, like the
//           sweep's, reads S and atomicMins into H, so no result depends
//           on the slots' order.
//   csweep  the hook over the list (JAX's csweep, :121-130), then the
//           same two jumps over every active label: a jump also lowers
//           the nodes below a root just hooked, as JAX's whole-array
//           jumps do.
//   out     labels (int64, n for inactive nodes) and result = {unconverged,
//           sweeps, pair sweeps, distinct cross-root pairs}.
//
// What bounds it on an H100: the bytes are small (the (n, K) table once,
// the active rows' labels a phase: ~2 MB at n = 65536, K = 16); the time is
// the barriers (two a sweep, one a pair-list phase and radix digit) and
// the latency of each phase's gathers and atomics. Design: one block of
// kThreads per SM slot up to kBlocksPerSm, grid-stride loops over active
// ids, their slots and keys.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 2;
constexpr int kShift = 31;
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;
constexpr int kMaxRounds = 8;                  // 64-bit keys, 8 bits a round
constexpr unsigned long long kEmpty = ~0ull;   // no key is all ones
constexpr unsigned long long kHashMul = 0x9E3779B97F4A7C15ull;

// int32 control words at the end of the int32 scratch, zeroed by the
// launcher: the barrier, the append counters, the radix histograms and a
// flag a sweep
enum : int { kBarCount = 0, kBarGen, kNAct, kNUniq, kCtrlWords = 8 };
constexpr int kHistWords = kMaxRounds * kDigits;

struct Args {
  const int32_t* nbr;
  const uint8_t* nbr_valid;
  const uint8_t* active;
  const int32_t* group;  // null: one group
  int n, k, max_iters, coarsen, coarsen_sweeps;
  int32_t* ev;           // (n * k) the active rows' slots: v, or -1 for no edge
  int32_t* S;            // labels after the last sweep
  int32_t* H[2];         // hook arrays, in turns; a sweep's equals S at its start
  int32_t* act;          // active ids
  uint32_t* ctrl;        // kCtrlWords, then hist (kHistWords), then flags
  int64_t* uniq;         // distinct cross-root keys (room for n * k)
  unsigned long long* table;  // hash table (a power of two >= 2 n k slots)
  int64_t* labels;       // (n,) output
  int64_t* result;       // (4,) output
};

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Grid-wide barrier: an arrival counter and a generation word. Valid only
// under a cooperative launch (every block resident). The counter is back
// at 0 when the barrier opens.
__device__ void grid_sync(uint32_t* ctrl) {
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t* count = ctrl + kBarCount;
    uint32_t* gen = ctrl + kBarGen;
    const uint32_t g = ld_acquire(gen);
    __threadfence();
    if (atomicAdd(count, 1u) == gridDim.x - 1) {
      atomicExch(count, 0u);
      __threadfence();
      atomicAdd(gen, 1u);
    } else {
      while (ld_acquire(gen) == g) __nanosleep(20);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ uint32_t warp_inclusive_sum(uint32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t t = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

// Block-aggregated append of `count` items a thread: every thread of the
// block calls it; returns the thread's first slot (one atomic a block).
__device__ int block_append(uint32_t count, uint32_t* counter) {
  __shared__ uint32_t s_warp[kThreads / 32];
  __shared__ uint32_t s_base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t incl = warp_inclusive_sum(count);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const uint32_t c = lane < kThreads / 32 ? s_warp[lane] : 0;
    const uint32_t all = warp_inclusive_sum(c);
    if (lane < kThreads / 32) s_warp[lane] = all - c;
    if (lane == 31) s_base = all > 0 ? atomicAdd(counter, all) : 0;
  }
  __syncthreads();
  const int pos = static_cast<int>(s_base + s_warp[warp] + incl - count);
  __syncthreads();
  return pos;
}

__device__ __forceinline__ int64_t pair_key(int32_t a, int32_t b) {
  return (static_cast<int64_t>(min(a, b)) << kShift) | max(a, b);
}

// Labels and active ids; flags, counters and barrier were zeroed by the
// launcher.
__device__ void init_phase(const Args& a) {
  const int stride = gridDim.x * blockDim.x;
  for (int base = blockIdx.x * blockDim.x; base < a.n; base += stride) {
    const int u = base + threadIdx.x;
    const bool in = u < a.n;
    const bool on = in && a.active[u];
    if (in) a.S[u] = a.H[0][u] = a.H[1][u] = on ? u : a.n;
    const int pos = block_append(on ? 1 : 0, a.ctrl + kNAct);
    if (on) a.act[pos] = u;
  }
}

struct Loop {
  int n_act, n_slots, slot, sweeps, csweeps;  // n_slots = n_act * k
  int64_t n_uniq, thresh;  // the pair list: the distinct keys <= thresh
};

__device__ __forceinline__ void hook(const Args& a, const Loop& l, int32_t x, int32_t y) {
  const int32_t rx = __ldcg(a.S + x);
  const int32_t ry = __ldcg(a.S + y);
  if (rx != ry) atomicMin(a.H[l.slot & 1] + max(rx, ry), min(rx, ry));
}

// The two synchronous jumps over every active label and the sweep's flag;
// returns whether any label changed. Starts after the hook, ends after the
// barrier that closes the sweep.
__device__ bool jumps(const Args& a, Loop& l) {
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int32_t* h = a.H[l.slot & 1];
  int32_t* next = a.H[(l.slot & 1) ^ 1];
  uint32_t* flag = a.ctrl + kCtrlWords + kHistWords + l.slot;
  grid_sync(a.ctrl);
  bool changed = false;
  for (int i = gtid; i < l.n_act; i += stride) {
    const int u = __ldcg(a.act + i);
    const int32_t h1 = __ldcg(h + u);
    const int32_t t = min(h1, __ldcg(h + h1));      // T[u]
    const int32_t h3 = __ldcg(h + t);
    const int32_t v = min(t, min(h3, __ldcg(h + h3)));  // min(T[u], T[t])
    changed |= v != __ldcg(a.S + u);
    a.S[u] = v;
    next[u] = v;
  }
  if (changed) atomicExch(flag, 1u);
  grid_sync(a.ctrl);
  ++l.slot;
  return __ldcg(flag) != 0;
}

// The edge of the active rows' slot idx: (u, v), v < 0 for no edge.
__device__ __forceinline__ int32_t slot_edge(const Args& a, int idx, int& u) {
  u = __ldcg(a.act + idx / a.k);
  return __ldcg(a.ev + idx);
}

// One full-graph sweep. The first reads the table's active rows, keeps
// their edges in ev and clears the hash table the pair extraction fills.
__device__ bool sweep(const Args& a, Loop& l, bool first, int64_t clear) {
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  for (int i = gtid; i < l.n_slots; i += stride) {
    int u;
    int32_t v;
    if (first) {
      u = __ldcg(a.act + i / a.k);
      const int64_t s = static_cast<int64_t>(u) * a.k + i % a.k;
      v = a.nbr[s];
      const bool ok = a.nbr_valid[s] && v >= 0 && v < a.n && a.active[v] &&
                      (a.group == nullptr || a.group[v] == a.group[u]);
      if (!ok) v = -1;
      a.ev[i] = v;
    } else {
      v = slot_edge(a, i, u);
    }
    if (v >= 0) hook(a, l, u, v);
  }
  for (int64_t i = gtid; i < clear; i += stride) a.table[i] = kEmpty;
  ++l.sweeps;
  return jumps(a, l);
}

// One sweep over the pair list.
__device__ bool csweep(const Args& a, Loop& l) {
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int64_t lo_mask = (int64_t{1} << kShift) - 1;
  for (int64_t i = gtid; i < l.n_uniq; i += stride) {
    const int64_t key = __ldcg(a.uniq + i);
    if (key <= l.thresh) hook(a, l, static_cast<int32_t>(key >> kShift),
                              static_cast<int32_t>(key & lo_mask));
  }
  ++l.csweeps;
  return jumps(a, l);
}

// Inserts key; true when it was not there yet.
__device__ bool insert_key(const Args& a, int lg, unsigned long long key) {
  const unsigned long long mask = (1ull << lg) - 1;
  unsigned long long h = (key * kHashMul) >> (64 - lg);
  while (true) {
    unsigned long long cur = __ldcg(a.table + h);
    if (cur == key) return false;
    if (cur == kEmpty) {
      cur = atomicCAS(a.table + h, kEmpty, key);
      if (cur == kEmpty) return true;
      if (cur == key) return false;
    }
    h = (h + 1) & mask;
  }
}

// The distinct cross-root keys of the current labels into uniq; ends after
// a barrier.
__device__ void extract_pairs(const Args& a, Loop& l, int lg) {
  const int stride = gridDim.x * blockDim.x;
  for (int base = blockIdx.x * blockDim.x; base < l.n_slots; base += stride) {
    const int i = base + threadIdx.x;
    bool fresh = false;
    int64_t key = 0;
    int u = 0;
    const int32_t v = i < l.n_slots ? slot_edge(a, i, u) : -1;
    if (v >= 0) {
      const int32_t ru = __ldcg(a.S + u);
      const int32_t rv = __ldcg(a.S + v);
      if (ru != rv) {
        key = pair_key(ru, rv);
        fresh = insert_key(a, lg, static_cast<unsigned long long>(key));
      }
    }
    const int pos = block_append(fresh ? 1 : 0, a.ctrl + kNUniq);
    if (fresh) a.uniq[pos] = key;
  }
  grid_sync(a.ctrl);
  l.n_uniq = __ldcg(a.ctrl + kNUniq);
}

// The rank-th smallest (1-based) of the n_uniq distinct keys, all below
// 2^bits: MSD radix select, one global histogram and barrier a digit. Every
// block scans the same histogram with its first warp and takes the same
// digit.
__device__ int64_t radix_select(const Args& a, const Loop& l, int bits, int rank) {
  __shared__ uint32_t s_hist[kDigits];
  __shared__ int s_pick[2];
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  int64_t prefix = 0, mask = 0;
  int want = rank;
  const int top = (bits + kDigitBits - 1) / kDigitBits * kDigitBits;
  for (int shift = top - kDigitBits, round = 0; shift >= 0; shift -= kDigitBits, ++round) {
    for (int d = threadIdx.x; d < kDigits; d += blockDim.x) s_hist[d] = 0;
    __syncthreads();
    for (int64_t i = gtid; i < l.n_uniq; i += stride) {
      const int64_t key = __ldcg(a.uniq + i);
      if ((key & mask) == prefix) atomicAdd(s_hist + ((key >> shift) & (kDigits - 1)), 1u);
    }
    __syncthreads();
    uint32_t* hist = a.ctrl + kCtrlWords + round * kDigits;
    for (int d = threadIdx.x; d < kDigits; d += blockDim.x) {
      if (s_hist[d]) atomicAdd(hist + d, s_hist[d]);
    }
    grid_sync(a.ctrl);
    if (threadIdx.x < 32) {
      constexpr int kPer = kDigits / 32;
      const int lane = threadIdx.x;
      uint32_t c[kPer];
      uint32_t sum = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) sum += c[j] = __ldcg(hist + lane * kPer + j);
      const uint32_t incl = warp_inclusive_sum(sum);
      uint32_t below = incl - sum;
      if (below < static_cast<uint32_t>(want) && static_cast<uint32_t>(want) <= incl) {
        int j = 0;
        while (below + c[j] < static_cast<uint32_t>(want)) below += c[j++];
        s_pick[0] = lane * kPer + j;
        s_pick[1] = want - static_cast<int>(below);
      }
    }
    __syncthreads();
    prefix |= static_cast<int64_t>(s_pick[0]) << shift;
    mask |= static_cast<int64_t>(kDigits - 1) << shift;
    want = s_pick[1];
    __syncthreads();
  }
  return prefix;
}

__global__ void __launch_bounds__(kThreads) cc_kernel(Args a) {
  Loop l{0, 0, 0, 0, 0, 0, INT64_MAX};
  init_phase(a);
  grid_sync(a.ctrl);
  l.n_act = static_cast<int>(__ldcg(a.ctrl + kNAct));
  l.n_slots = l.n_act * a.k;
  // the pair extraction's table: a power of two >= 2x the active slots, >= 64
  int lg = 6;
  while ((int64_t{1} << lg) < 2 * static_cast<int64_t>(l.n_slots)) ++lg;
  const int64_t clear = a.coarsen > 0 ? (int64_t{1} << lg) : 0;

  bool done = false;
  int i = 0;
  sweep(a, l, true, clear);
  if (a.coarsen > 0) {
    for (int r = 1; r < a.coarsen_sweeps; ++r) sweep(a, l, false, 0);
    extract_pairs(a, l, lg);
    if (l.n_uniq > a.coarsen) {
      const int bits = kShift + (32 - __clz(a.n));
      l.thresh = radix_select(a, l, bits, a.coarsen);
    }
    csweep(a, l);
    while (!done && i < a.max_iters) {
      done = !csweep(a, l);
      ++i;
    }
    done = !sweep(a, l, false, 0);
    i = 1;
  } else {
    sweep(a, l, false, 0);
  }
  while (!done && i < a.max_iters) {
    done = !sweep(a, l, false, 0);
    ++i;
  }

  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  for (int u = gtid; u < a.n; u += gridDim.x * blockDim.x) a.labels[u] = __ldcg(a.S + u);
  if (gtid == 0) {
    a.result[0] = done ? 0 : 1;
    a.result[1] = l.sweeps;
    a.result[2] = l.csweeps;
    a.result[3] = a.coarsen > 0 ? l.n_uniq : 0;
  }
}

int64_t table_cap(int64_t slots) {
  int64_t cap = 64;
  while (cap < 2 * slots) cap <<= 1;
  return cap;
}

int flag_slots(int max_iters, int coarsen_sweeps) {
  return (coarsen_sweeps > 1 ? coarsen_sweeps : 1) + 2 * max_iters + 4;
}

// Scratch of one call, in words: which = 0 the int32 scratch (ev, S, H0,
// H1, act, then the control words the launcher zeroes), 1 the int64 scratch
// (the distinct keys and the hash table; none without coarsening).
int64_t scratch_words(int n, int k, int max_iters, int coarsen, int coarsen_sweeps,
                      int which) {
  const int64_t slots = static_cast<int64_t>(n) * k;
  if (which == 0) {
    return slots + 4 * static_cast<int64_t>(n) + kCtrlWords + kHistWords +
           flag_slots(max_iters, coarsen_sweeps);
  }
  return coarsen > 0 ? slots + table_cap(slots) : 0;
}

}  // namespace

// nbr (n, k) int32, nbr_valid (n, k) bool, active (n,) bool, group (n,)
// int32 or null; work32 / work64 of scratch_words' sizes (checked; the
// wrapper's cc_scratch_words mirrors it); labels (n,) int64 and result (4,) int64 written. One
// memset and one cooperative launch on `stream`; a grid that cannot be
// co-resident is an error (cudaErrorCooperativeLaunchTooLarge).
extern "C" int ms3d_connected_components(const int32_t* nbr, const uint8_t* nbr_valid,
                                         const uint8_t* active, const int32_t* group, int n,
                                         int k, int max_iters, int coarsen, int coarsen_sweeps,
                                         int32_t* work32, int64_t words32, int64_t* work64,
                                         int64_t words64, int64_t* labels, int64_t* result,
                                         cudaStream_t stream) {
  const int64_t slots = static_cast<int64_t>(n) * k;
  if (n < 0 || k < 0 || max_iters < 0 || coarsen < 0 || slots > INT32_MAX ||
      words32 < scratch_words(n, k, max_iters, coarsen, coarsen_sweeps, 0) ||
      words64 < scratch_words(n, k, max_iters, coarsen, coarsen_sweeps, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int grid[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (grid[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cc_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    grid[dev] = sms * (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm);
  }
  Args a;
  a.nbr = nbr;
  a.nbr_valid = nbr_valid;
  a.active = active;
  a.group = group;
  a.n = n;
  a.k = k;
  a.max_iters = max_iters;
  a.coarsen = coarsen;
  a.coarsen_sweeps = coarsen_sweeps;
  a.ev = work32;
  a.S = work32 + slots;
  a.H[0] = a.S + n;
  a.H[1] = a.H[0] + n;
  a.act = a.H[1] + n;
  a.ctrl = reinterpret_cast<uint32_t*>(a.act + n);
  a.uniq = work64;
  a.table = reinterpret_cast<unsigned long long*>(work64 + (coarsen > 0 ? slots : 0));
  a.labels = labels;
  a.result = result;
  const size_t ctrl_bytes =
      sizeof(uint32_t) * (kCtrlWords + kHistWords + flag_slots(max_iters, coarsen_sweeps));
  err = cudaMemsetAsync(a.ctrl, 0, ctrl_bytes, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(cc_kernel), dim3(grid[dev]),
                                    dim3(kThreads), params, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
