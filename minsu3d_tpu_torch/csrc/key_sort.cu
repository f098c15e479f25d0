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
// segment.segment_csr and the CC coarsening's pair list sort with the same
// kernel.
//
// What bounds it on an H100: bytes. A sort must read the keys once and
// write keys and permutation once (20 bytes a key: ~2 MB at 98304 keys,
// under 1 us at 3.35 TB/s). An LSD radix sort moves the data once per pass
// that is not the identity, all of it L2-resident at the path's sizes
// (1625 to 262144 keys), so what costs is launches, block-wide barriers and
// the dependent latency of carrying digit counts from tile to tile.
//
// Design: 8-bit digits of the key with its sign bit flipped (negative keys
// sort first, so any int64 sorts right), from the lowest. ``bits`` (CUB's
// end_bit) says that the keys are non-negative and below 2^bits, so
// onesweep launches ceil(bits / 8) passes; the default 64 sorts any key.
//
// * n <= kSmallMax (8192): one block of 256 to 1024 threads sorts in
//   shared memory and writes the result once: one launch. Every thread
//   keeps its keys in registers; warp w owns the contiguous rows [w *
//   chunk, (w + 1) * chunk). A pass ranks each warp's rows in row order
//   (eight ballots give a key's rank among the earlier lanes with its
//   digit, per-warp counters in shared memory the count of its digit in
//   the warp's earlier rows), one block scan of the (digit, warp) counts in
//   digit-major order gives every warp its base per digit, and the keys
//   move through one shared buffer. An OR and an AND of all keys give the
//   bits that vary; each pass takes the 8 bits from the lowest varying bit
//   not yet sorted, so constant bits cost no pass (the coarsening's cross
//   keys, two 16-bit labels 31 bits apart, take 4 passes, not 5).
// * larger n: onesweep. One kernel reads the keys once and counts all the
//   passes' digits (integer atomics into a global histogram); its last
//   block turns the counts into each digit's global start and the mask of
//   the passes that move keys (a pass whose histogram puts every key under
//   one digit is the identity); it also clears the passes' tile status
//   words. Then one launch a pass: a pass that is the identity returns at
//   once, and the mask gives every block the ping-pong parity with no host
//   read, so the last pass that runs writes straight into the outputs. A
//   block takes a tile id (2048 keys: 256 threads x 8) from an atomic
//   counter, so tiles run in order of id and every tile it waits on is
//   already resident; it ranks its
//   tile stably as above, publishes its per-digit counts, and thread d
//   finds digit d's count in the earlier tiles by decoupled look-back: it
//   reads the status words of the kLookback tiles before it at once, adds
//   the published counts back to the first tile whose word holds an
//   inclusive prefix, then publishes its own inclusive prefix. A status
//   word packs the flag and the count into 32 bits, so one relaxed
//   device-scope load sees both, and n must stay below 2^30. Each key
//   then goes to its digit's global base + its tile's prefix + its rank in
//   the tile.
// Tile t always owns keys [t * 2048, (t + 1) * 2048) and every prefix is an
// integer sum, so the result does not depend on block scheduling; input
// order is kept within a digit, so each pass, and the sort, is stable:
// equal to torch.sort(stable=True) bit for bit.

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kDigits = 256;
constexpr int kMaxPasses = 8;
constexpr uint64_t kSignBit = 1ull << 63;

constexpr int kSmallThreads = 1024;
constexpr int kSmallWarps = kSmallThreads / 32;
constexpr int kSmallItems = 8;
constexpr int kSmallMax = kSmallThreads * kSmallItems;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kLookback = 16;
constexpr uint32_t kFlagAgg = 1u << 30;  // the tile's own counts are published
constexpr uint32_t kFlagInc = 2u << 30;  // its inclusive prefix is published
constexpr uint32_t kFlags = 3u << 30;
constexpr uint32_t kCountMask = kFlagAgg - 1;
constexpr int64_t kMaxKeys = kCountMask;  // counts must fit the status word

constexpr int kHistItems = 4;  // keys a thread of the histogram kernel counts
constexpr int kHistKeys = kThreads * kHistItems;

// scratch of the onesweep path: the control words (each pass's digit
// counts, then each digit's global start, then the tile counters, the
// histogram blocks' done count and the mask of passes that move keys),
// the status words, then a key buffer and a permutation buffer of n each
constexpr int kHist = 0, kBase = kMaxPasses * kDigits, kCounters = 2 * kMaxPasses * kDigits;
constexpr int kDone = kCounters + kMaxPasses, kRun = kDone + 1;
constexpr int64_t kCtrlWords = kCounters + 64;

__device__ __forceinline__ int digit_of(uint64_t u, int pass) {
  return static_cast<int>((u >> (8 * pass)) & 255u);
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// A status word carries its flag and its count together and guards no
// other data (the keys a pass reads were written by the launch before), so
// relaxed device-scope accesses suffice: an acquire load would also
// invalidate the SM's L1 at every poll.
__device__ __forceinline__ void store_status(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t load_status(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The lanes of the warp whose live digit equals this lane's (d < kDigits
// is live), from one ballot a digit bit: __match_any_sync is far slower.
__device__ __forceinline__ unsigned match_digit(int d) {
  unsigned peers = __ballot_sync(0xffffffffu, d < kDigits);
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool bit = (d >> b) & 1;
    const unsigned m = __ballot_sync(0xffffffffu, bit);
    peers &= bit ? m : ~m;
  }
  return peers;
}

// Rank one warp's rows in row order: for each of its items (the row
// index rises with g, then with the lane), off[g] = the count of its digit
// in the warp's earlier rows. counts (kDigits) must be 0 on entry and holds
// the warp's digit counts on exit. A dead item carries digit kDigits.
template <int kN>
__device__ __forceinline__ void warp_rank(const int (&d)[kN], int groups, int32_t* counts,
                                          int32_t (&off)[kN]) {
  const unsigned lt = lanemask_lt();
#pragma unroll
  for (int g = 0; g < kN; ++g) {
    if (g < groups) {
      const unsigned peers = match_digit(d[g]);
      const bool live = d[g] < kDigits;
      const int32_t pre = live ? counts[d[g]] : 0;
      __syncwarp();
      if (live && (peers & lt) == 0) counts[d[g]] = pre + __popc(peers);
      __syncwarp();
      off[g] = pre + __popc(peers & lt);
    }
  }
}

// Exclusive prefix over the threads of a block in thread order; every
// thread of the block must call it. wsum holds one int a warp.
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t v, int32_t* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  int32_t incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int32_t w = lane < n_warps ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t t = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += t;
    }
    if (lane < n_warps) wsum[lane] = w - wsum[lane];  // exclusive over warps
  }
  __syncthreads();
  return wsum[warp] + incl - v;  // wsum is free again after the caller's next barrier
}

// ---- n <= kSmallMax: one block ----------------------------------------------

// kBlock threads (256, 512 or 1024; the register budget follows it)
template <int kBlock>
__global__ void __launch_bounds__(kBlock)
small_sort_kernel(const int64_t* __restrict__ keys, int n, int64_t* __restrict__ s_key,
                  int32_t* __restrict__ perm) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* cnt = reinterpret_cast<int32_t*>(smem);  // [warp][digit]
  uint64_t* buf_key = reinterpret_cast<uint64_t*>(cnt + kBlock / 32 * kDigits);
  int32_t* buf_perm = reinterpret_cast<int32_t*>(buf_key + n);
  __shared__ int32_t wsum[kBlock / 32];
  __shared__ unsigned long long s_or, s_and;

  constexpr int n_warps = kBlock / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int groups = (n + kBlock - 1) / kBlock;  // uniform, 1..8
  const int first = warp * groups * 32 + lane;   // row of item 0
  if (tid == 0) {
    s_or = 0;
    s_and = ~0ull;
  }
  uint64_t k[kSmallItems];
  int32_t p[kSmallItems];
  unsigned live = 0;
  uint64_t o = 0, a = ~0ull;
#pragma unroll
  for (int g = 0; g < kSmallItems; ++g) {
    const int i = first + g * 32;
    k[g] = 0;
    p[g] = i;
    if (g < groups && i < n) {
      k[g] = static_cast<uint64_t>(keys[i]) ^ kSignBit;
      live |= 1u << g;
      o |= k[g];
      a &= k[g];
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    o |= __shfl_xor_sync(0xffffffffu, o, s);
    a &= __shfl_xor_sync(0xffffffffu, a, s);
  }
  __syncthreads();
  if (lane == 0) {
    atomicOr(&s_or, static_cast<unsigned long long>(o));
    atomicAnd(&s_and, static_cast<unsigned long long>(a));
  }
  __syncthreads();
  const uint64_t varying = s_or ^ s_and;  // the bits that differ between keys

  // each pass sorts by the 8 bits from the lowest varying bit not yet
  // sorted: every varying bit is covered once, in rising order, and a
  // constant bit orders nothing, so this is the LSD sort of the whole key
  // in fewer passes where the varying bits are not byte-aligned
  int32_t* wc = cnt + warp * kDigits;
  for (int shift = varying ? __ffsll(static_cast<long long>(varying)) - 1 : 64; shift < 64;) {
    for (int j = lane; j < kDigits; j += 32) wc[j] = 0;
    __syncwarp();
    int d[kSmallItems];
    int32_t off[kSmallItems];
#pragma unroll
    for (int g = 0; g < kSmallItems; ++g) {
      d[g] = (live >> g & 1u) ? static_cast<int>((k[g] >> shift) & 255u) : kDigits;
    }
    warp_rank(d, groups, wc, off);
    __syncthreads();
    // (digit, warp) counts in digit-major order: with q = n_warps / 8
    // threads a digit, thread t owns digit t / q, warps (t % q) * 8 .. + 8,
    // so thread order is that order
    {
      constexpr int q = n_warps >> 3;
      int32_t* col = cnt + (tid % q) * 8 * kDigits + tid / q;
      int32_t c[8], s = 0;
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        c[w] = col[w * kDigits];
        s += c[w];
      }
      int32_t base = block_exclusive_scan(s, wsum);
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        col[w * kDigits] = base;
        base += c[w];
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < kSmallItems; ++g) {
      if (live >> g & 1u) {
        const int pos = wc[d[g]] + off[g];
        buf_key[pos] = k[g];
        buf_perm[pos] = p[g];
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < kSmallItems; ++g) {
      if (live >> g & 1u) {
        k[g] = buf_key[first + g * 32];
        p[g] = buf_perm[first + g * 32];
      }
    }
    __syncthreads();
    shift += 8;
    const uint64_t rest = shift < 64 ? varying >> shift : 0;
    shift = rest ? shift + __ffsll(static_cast<long long>(rest)) - 1 : 64;
  }
#pragma unroll
  for (int g = 0; g < kSmallItems; ++g) {
    if (live >> g & 1u) {
      s_key[first + g * 32] = static_cast<int64_t>(k[g] ^ kSignBit);
      perm[first + g * 32] = p[g];
    }
  }
}

// ---- onesweep ----------------------------------------------------------------

// Every pass's digit counts (integer atomics into ctrl[kHist]); the last
// block to finish turns them into each digit's global start (ctrl[kBase])
// and the mask of passes that move keys (ctrl[kRun]: a pass whose digit is
// the same for every key is the identity). Also clears the status words.
__global__ void __launch_bounds__(kThreads)
hist_kernel(const int64_t* __restrict__ keys, int n, int passes, int64_t n_status,
            uint32_t* __restrict__ ctrl, uint32_t* __restrict__ status) {
  __shared__ uint32_t h[kMaxPasses][kDigits];
  __shared__ int32_t wsum[kMaxPasses][kWarps];
  __shared__ uint32_t s_run;
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = tid; j < kMaxPasses * kDigits; j += kThreads) h[j / kDigits][j % kDigits] = 0;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + tid; j < n_status;
       j += static_cast<int64_t>(gridDim.x) * kThreads) {
    status[j] = 0;  // "not published"
  }
  __syncthreads();
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kHistKeys;
  uint64_t u[kHistItems];
#pragma unroll
  for (int r = 0; r < kHistItems; ++r) {
    const int64_t i = start + static_cast<int64_t>(r) * kThreads + tid;
    u[r] = i < n ? static_cast<uint64_t>(keys[i]) ^ kSignBit : 0;
  }
  for (int pass = 0; pass < passes; ++pass) {
#pragma unroll
    for (int r = 0; r < kHistItems; ++r) {
      const bool ok = start + static_cast<int64_t>(r) * kThreads + tid < n;
      const int d = ok ? digit_of(u[r], pass) : kDigits;
      const unsigned peers = match_digit(d);
      if (ok && lane == __ffs(peers) - 1) atomicAdd(&h[pass][d], __popc(peers));
    }
  }
  __syncthreads();
  for (int pass = 0; pass < passes; ++pass) {
    const uint32_t c = h[pass][tid];
    if (c) atomicAdd(&ctrl[kHist + pass * kDigits + tid], c);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(&ctrl[kDone], 1u) == gridDim.x - 1;
    s_run = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // thread tid = digit: exclusive scans of every pass's counts at once
  int32_t c[kMaxPasses], incl[kMaxPasses];
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) {
    c[p] = p < passes ? static_cast<int32_t>(__ldcg(&ctrl[kHist + p * kDigits + tid])) : 0;
    incl[p] = c[p];
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p) {
      const int32_t t = __shfl_up_sync(0xffffffffu, incl[p], o);
      if (lane >= o) incl[p] += t;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p) wsum[p][warp] = incl[p];
  }
  uint32_t identity = 0;
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) {
    if (p < passes && c[p] == n) identity |= 1u << p;
  }
  if (identity) atomicOr(&s_run, identity);
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) {
    if (p < passes) {
      int32_t before = 0;
      for (int w = 0; w < warp; ++w) before += wsum[p][w];
      ctrl[kBase + p * kDigits + tid] = static_cast<uint32_t>(before + incl[p] - c[p]);
    }
  }
  if (tid == 0) ctrl[kRun] = ((1u << passes) - 1u) & ~s_run;
}

__global__ void __launch_bounds__(kThreads)
onesweep_kernel(const int64_t* __restrict__ keys, int n, int pass, int n_tiles,
                int64_t* s_key, int32_t* perm, int64_t* key_tmp, int32_t* perm_tmp,
                uint32_t* ctrl, uint32_t* status) {
  __shared__ int s_tile;
  __shared__ int32_t s_base[kDigits];
  __shared__ int32_t wc[kWarps][kDigits];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) s_tile = static_cast<int>(atomicAdd(&ctrl[kCounters + pass], 1u));
  const uint32_t run = ctrl[kRun];  // the passes that move keys
  const int32_t base = static_cast<int32_t>(ctrl[kBase + pass * kDigits + tid]);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) wc[w][tid] = 0;
  if (run == 0) {  // every pass is the identity: the first launch copies
    if (pass == 0) {
      for (int r = 0; r < kItems; ++r) {
        const int64_t i = static_cast<int64_t>(blockIdx.x) * kTile + r * kThreads + tid;
        if (i < n) {
          s_key[i] = keys[i];
          perm[i] = static_cast<int32_t>(i);
        }
      }
    }
    return;
  }
  if (!(run >> pass & 1u)) return;
  const int n_run = __popc(run);
  const int j = __popc(run & ((1u << pass) - 1u));  // passes that ran before this one
  const bool to_out = ((n_run - 1 - j) & 1) == 0;    // the last one writes the outputs
  int64_t* kout = to_out ? s_key : key_tmp;
  int32_t* pout = to_out ? perm : perm_tmp;
  const int64_t* kin = j == 0 ? keys : (to_out ? key_tmp : s_key);
  const int32_t* pin = j == 0 ? nullptr : (to_out ? perm_tmp : perm);
  __syncthreads();
  const int tile = s_tile;

  // warp w owns the tile's rows [w * 256, (w + 1) * 256)
  const int64_t first = static_cast<int64_t>(tile) * kTile + warp * (kItems * 32) + lane;
  int64_t k[kItems];
  int32_t p[kItems];
  int d[kItems];
  int32_t off[kItems];
#pragma unroll
  for (int g = 0; g < kItems; ++g) {
    const int64_t i = first + g * 32;
    const bool ok = i < n;
    k[g] = ok ? kin[i] : 0;
    p[g] = ok ? (pin ? pin[i] : static_cast<int32_t>(i)) : 0;
    d[g] = ok ? digit_of(static_cast<uint64_t>(k[g]) ^ kSignBit, pass) : kDigits;
  }
  warp_rank(d, kItems, wc[warp], off);
  __syncthreads();

  // thread tid = digit: exclusive prefix over the warps, the tile's count
  int32_t agg = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int32_t c = wc[w][tid];
    wc[w][tid] = agg;
    agg += c;
  }
  uint32_t* st = status + static_cast<int64_t>(pass) * n_tiles * kDigits;
  store_status(st + static_cast<int64_t>(tile) * kDigits + tid,
                (tile == 0 ? kFlagInc : kFlagAgg) | static_cast<uint32_t>(agg));
  int32_t excl = 0;
  if (tile > 0) {
    bool done = false;
    for (int t = tile - 1; !done; t -= kLookback) {
      uint32_t v[kLookback];
#pragma unroll
      for (int w = 0; w < kLookback; ++w) {
        v[w] = t - w >= 0 ? load_status(st + static_cast<int64_t>(t - w) * kDigits + tid)
                          : kFlagInc;
      }
#pragma unroll
      for (int w = 0; w < kLookback; ++w) {
        if (!done) {
          uint32_t x = v[w];
          while ((x & kFlags) == 0) {
            x = load_status(st + static_cast<int64_t>(t - w) * kDigits + tid);
          }
          excl += static_cast<int32_t>(x & kCountMask);
          done = (x & kFlagInc) != 0;
        }
      }
    }
    store_status(st + static_cast<int64_t>(tile) * kDigits + tid,
                  kFlagInc | static_cast<uint32_t>(excl + agg));
  }
  s_base[tid] = base + excl;
  __syncthreads();

#pragma unroll
  for (int g = 0; g < kItems; ++g) {
    if (d[g] < kDigits) {
      const int32_t pos = s_base[d[g]] + wc[warp][d[g]] + off[g];
      kout[pos] = k[g];
      pout[pos] = p[g];
    }
  }
}

int64_t n_tiles_of(int64_t n) { return (n + kTile - 1) / kTile; }

}  // namespace

// Bytes of scratch that ms3d_key_sort needs for n keys of ``bits`` bits
// (0 for the one-block path); the wrapper computes the same number.
extern "C" int64_t ms3d_key_sort_scratch(int64_t n, int bits) {
  if (n <= kSmallMax) return 0;
  const int64_t passes = (bits + 7) / 8;
  return 4 * (kCtrlWords + passes * n_tiles_of(n) * kDigits) + 12 * n;
}

// keys (n,) int64 -> s_key (n,) int64 sorted, perm (n,) int32; keys below
// 2^bits and non-negative when bits < 64; scratch of
// ms3d_key_sort_scratch(n, bits) bytes (may be null when that is 0).
extern "C" int ms3d_key_sort(const int64_t* keys, int64_t n, int bits, int64_t* s_key,
                             int32_t* perm, void* scratch, int64_t scratch_bytes,
                             cudaStream_t stream) {
  if (n < 0 || n > kMaxKeys || bits < 1 || bits > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const int passes = (bits + 7) / 8;
  const int nn = static_cast<int>(n);
  if (n <= kSmallMax) {
    static bool attr_set = false;
    const int smem_max = kSmallWarps * kDigits * 4 + 12 * kSmallMax;
    if (!attr_set) {
      for (const void* fn : {reinterpret_cast<const void*>(small_sort_kernel<256>),
                             reinterpret_cast<const void*>(small_sort_kernel<512>),
                             reinterpret_cast<const void*>(small_sort_kernel<1024>)}) {
        const cudaError_t err =
            cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
        if (err != cudaSuccess) return static_cast<int>(err);
      }
      attr_set = true;
    }
    // 8, 16 or 32 warps, up to 8 keys a thread: on the card fewer warps
    // with more keys each beat more warps (cheaper barriers and scans).
    // Shared memory: the warps' digit counters, then the keys and the
    // permutation. The kernel finds the varying bits itself, so bits
    // changes nothing here.
    const int smem = 12 * nn;
    if (n <= 2048) {
      small_sort_kernel<256><<<1, 256, smem + 8 * kDigits * 4, stream>>>(keys, nn, s_key, perm);
    } else if (n <= 4096) {
      small_sort_kernel<512><<<1, 512, smem + 16 * kDigits * 4, stream>>>(keys, nn, s_key, perm);
    } else {
      small_sort_kernel<1024><<<1, 1024, smem + 32 * kDigits * 4, stream>>>(keys, nn, s_key,
                                                                            perm);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (scratch == nullptr || scratch_bytes < ms3d_key_sort_scratch(n, bits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = static_cast<int>(n_tiles_of(n));
  uint32_t* ctrl = static_cast<uint32_t*>(scratch);
  uint32_t* status = ctrl + kCtrlWords;
  int64_t* key_tmp = reinterpret_cast<int64_t*>(
      status + static_cast<int64_t>(passes) * n_tiles * kDigits);
  int32_t* perm_tmp = reinterpret_cast<int32_t*>(key_tmp + n);
  // the counts and counters start at 0 (the bases and the mask are written)
  cudaError_t err = cudaMemsetAsync(ctrl, 0, 4 * kCtrlWords, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_status = static_cast<int64_t>(passes) * n_tiles * kDigits;
  const int hist_blocks = static_cast<int>((n + kHistKeys - 1) / kHistKeys);
  hist_kernel<<<hist_blocks, kThreads, 0, stream>>>(keys, nn, passes, n_status, ctrl, status);
  for (int pass = 0; pass < passes; ++pass) {
    onesweep_kernel<<<n_tiles, kThreads, 0, stream>>>(keys, nn, pass, n_tiles, s_key, perm,
                                                      key_tmp, perm_tmp, ctrl, status);
  }
  return static_cast<int>(cudaGetLastError());
}
