// K13 gather_dx_bf16: the input gradient of a bf16 sparse conv, rounded where
// the JAX package's bf16 train step rounds it.
//
//   dout  (R, Cout) bf16, the conv's output cotangent;
//   idx_t (N, T) int32, the transposed index: row j of x is read at tap t by
//         output row idx_t[j, t]; a value outside [0, R) is absent;
//   perm  (N,) int32, idx_t's TapOrder: its rows sorted by their set of live
//         taps (K22, ops/sparse_conv.py conv_tables);
//   w     (T, Cout, Cin) bf16, the conv's weight with each tap transposed
//         (and the taps flipped for the submanifold conv);
//   out   (N, Cin) bf16.
//
// Replaces the dx half of jax.grad through minsu3d_tpu/ops/sparse_conv.py:50
// subm_conv, :66 down_conv and :80 up_conv with compute_dtype=bfloat16. There
// XLA computes, for every (source row i, tap) pair, one contribution: an f32
// dot over Cout of the widened cotangent with the bf16 weight, rounded to
// bf16. A bf16 scatter-add then adds the contributions into a zeros operand
// one at a time, in update order (source row major), rounding after every
// add. Both roundings, and the order, are part of the result: K1's "sum all
// taps in f32, round once" is another function. So, per target row j:
//   * the live sources i = idx_t[j, t] are taken in (i, t) order: the row
//     order of the scatter's updates (a source reaches a row through one
//     tap);
//   * each contribution is a serial __fmul_rn/__fadd_rn chain over Cout in
//     index order from +0.0 (no FMA contraction), rounded with
//     __float2bfloat16_rn;
//   * the accumulator starts at +0.0 and takes each contribution in that
//     order: widen, __fadd_rn, __float2bfloat16_rn.
// The plain version (ops/sparse_conv.py gather_dx_bf16_plain) repeats these
// steps with elementwise torch ops and equals the kernel bit for bit.
//
// What bounds it on an H100: not the bytes (dout's live rows, the weight,
// the index, out) nor the tensor cores, which may not compute a
// contribution (their accumulation is not IEEE-specified), but the CUDA
// cores' unfused multiplies and adds: 2 * live_pairs * Cin * Cout
// operations at 33.5 T/s (67 TFLOP/s counts an FMA as two). The design
// feeds that pipe:
//
// 1. Rows in tiles of the TapOrder. A block owns kTR consecutive rows of
//    the order and a block of CB input channels; it runs only the taps
//    that its rows use (the union of their live taps), and each warp skips
//    the taps that none of its rows uses.
// 2. Weights and cotangents staged once, reused by the tile. For each tap,
//    OC values of Cout a pass, the block stages the tap's weight slice
//    (OC x CB) and its rows' dout rows (OC x kTR, zeros where absent) in
//    shared memory as f32: the weight is read from L2 once a tile, not once
//    a row. The next pass's values are loaded into registers before the
//    current pass's products and stored into the other of two buffers
//    after them, so the loads' latency hides behind the products and a
//    pass costs one barrier.
// 3. Independent chains in every thread. A thread owns 4 rows x CB/8
//    channels, each the unchanged serial Cout chain, run side by side (one
//    vector of dout and one of weights per Cout step), so the FP32 pipe
//    always has independent adds to issue: tables of more than kFewRows
//    rows take 64-row blocks, 4 rows x 4 channels a thread (2 at Cin = 16,
//    where the warp's 8 channel groups still cover every lane).
// 4. The ordered accumulation on the fly. The taps are walked in ascending
//    order, so a row whose live sources ascend with the tap index (every
//    row of a plan's tables: rows sorted by coordinate key, taps by offset)
//    takes its contributions in (i, t) order as they come: its bf16
//    accumulator lives in registers and no contribution is stored. A row
//    whose sources do not ascend (any table the wrapper may be handed) is
//    recomputed at the end of the block in (i, t) order, one thread an
//    element, with the chains read straight from memory: exact, and slow
//    only where a table is not sorted.
// 5. The deep levels (at most kFewRows rows, a few thousand of them live):
//    there 64-row blocks would leave most SMs idle while each thread ran
//    27 serial chains of up to 224 steps. Their blocks are 16 rows of 16
//    channels (32 above 4096 rows where Cin is a multiple of 32), and the
//    block's 4 warps split its taps: each warp runs the whole tile for its
//    taps and keeps the bf16 contributions in shared memory; then each
//    element adds its row's contributions in (i, t) order, which each row
//    sorted its taps into (any table, exact).
// Every output element is written by one thread: no atomics, the same bits
// on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxTaps = 32;
// rows at or under which the warps of a block split its taps (point 5)
constexpr int kFewRows = 12288;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 8 bf16 at row[n..n+7] as raw words (zeros past len); vec: one 16-byte load
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* row, int n, int len, bool vec) {
  if (vec && n + 8 <= len) return *reinterpret_cast<const uint4*>(row + n);
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t lo = n + 2 * k < len ? __bfloat16_as_ushort(row[n + 2 * k]) : 0u;
    const uint32_t hi = n + 2 * k + 1 < len ? __bfloat16_as_ushort(row[n + 2 * k + 1]) : 0u;
    w[k] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the 8 values of a raw uint4 widened (exact: bf16 -> f32 is a shift)
__device__ __forceinline__ void widen8(uint4 u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// N consecutive f32 of shared memory (N = 2 or a multiple of 4, aligned to
// min(N, 4) floats)
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const float4 u = *reinterpret_cast<const float4*>(p + 4 * k);
      v[4 * k] = u.x, v[4 * k + 1] = u.y, v[4 * k + 2] = u.z, v[4 * k + 3] = u.w;
    }
  } else {
    const float2 u = *reinterpret_cast<const float2*>(p);
    v[0] = u.x, v[1] = u.y;
  }
}

// grid (ceil(N / kTR), ceil(Cin / CB)), NW warps; a thread owns 4 rows x
// CB / 8 channels, a warp 16 rows; OC Cout values a pass
template <int CB, int NW, int OC>
__global__ void __launch_bounds__(NW * 32)
gather_dx_bf16_kernel(const __nv_bfloat16* __restrict__ dout, int rows, int cout,
                      const int32_t* __restrict__ idx_t, int n, int taps,
                      const int32_t* __restrict__ perm, const __nv_bfloat16* __restrict__ w,
                      int cin, __nv_bfloat16* __restrict__ out, bool vec_d, bool vec_w) {
  constexpr int RM = 4, kWR = 4 * RM;   // rows a thread, a warp
  constexpr int kTR = kWR * NW;          // rows a block
  constexpr int kCM = CB / 8;            // channels a thread
  constexpr int kThreads = NW * 32;
  constexpr int kDV = kTR * (OC / 8) / kThreads;   // dout vectors a thread stages
  constexpr int kWVecs = OC * (CB / 8);             // weight vectors a pass
  constexpr int kWV = (kWVecs + kThreads - 1) / kThreads;
  static_assert(kDV * kThreads == kTR * (OC / 8), "");
  __shared__ int32_t s_row[kTR];
  __shared__ int32_t s_src[kTR][kMaxTaps];   // -1: absent
  __shared__ uint32_t s_live[kTR];
  __shared__ uint32_t s_union[NW + 1];        // each warp's rows, then the block's
  __shared__ int s_bad[kTR];                  // rows whose sources do not ascend,
  __shared__ int s_nbad;                      // done at the end
  __shared__ bool s_late[kTR];
  __shared__ __align__(16) float s_d[2][OC][kTR];
  __shared__ __align__(16) float s_w[2][OC][CB];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p0 = blockIdx.x * kTR, cb0 = blockIdx.y * CB;

  if (tid < kTR) s_row[tid] = p0 + tid < n ? perm[p0 + tid] : -1;
  if (tid <= NW) s_union[tid] = 0u;
  if (tid == 0) s_nbad = 0;
  __syncthreads();
  for (int e = tid; e < kTR * taps; e += kThreads) {
    const int r = e / taps, t = e % taps, row = s_row[r];
    int32_t s = -1;
    if (row >= 0) {
      s = idx_t[static_cast<int64_t>(row) * taps + t];
      if (s < 0 || s >= rows) s = -1;
    }
    s_src[r][t] = s;
  }
  __syncthreads();
  if (tid < kTR) {
    uint32_t live = 0u;
    int last = -1;
    bool ascending = true;
    for (int t = 0; t < taps; ++t) {
      const int s = s_src[tid][t];
      if (s < 0) continue;
      live |= 1u << t;
      ascending &= s >= last;
      last = s;
    }
    if (!ascending) live = 0u;   // a row left to the end takes nothing here
    s_live[tid] = live;
    s_late[tid] = !ascending;
    if (live != 0u) {
      atomicOr(&s_union[tid / kWR], live);
      atomicOr(&s_union[NW], live);
    }
    if (!ascending) s_bad[atomicAdd(&s_nbad, 1)] = tid;
  }
  __syncthreads();

  const uint32_t block_taps = s_union[NW], warp_taps = s_union[warp];
  const int r0 = warp * kWR + (lane >> 3) * RM;   // the thread's rows r0 .. r0 + RM - 1
  const int c0 = (lane & 7) * kCM;                // and channels cb0 + c0 ..
  uint32_t live[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) live[i] = s_live[r0 + i];
  float acc[RM][kCM];   // bf16 values held widened
  float dot[RM][kCM];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < kCM; ++j) acc[i][j] = dot[i][j] = 0.f;

  // one pass: tap t's Cout values o0 .. o0 + OC - 1. Its dout rows and
  // weights are loaded into registers a pass ahead, stored in the other
  // buffer after the current pass's products: one barrier a pass.
  uint4 dv[kDV], wv[kWV];
  auto load = [&](int t, int o0) {
    const int oc = min(OC, cout - o0);
#pragma unroll
    for (int k = 0; k < kDV; ++k) {
      const int e = tid + k * kThreads, r = e % kTR, o = (e / kTR) * 8, s = s_src[r][t];
      dv[k] = s >= 0 && o < oc ? load8(dout + static_cast<int64_t>(s) * cout + o0, o, oc, vec_d)
                               : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < kWV; ++k) {
      const int e = tid + k * kThreads, o = e / (CB / 8), c = (e % (CB / 8)) * 8;
      wv[k] = e < kWVecs && o < oc ? load8(w + (static_cast<int64_t>(t) * cout + o0 + o) * cin + cb0, c,
                             cin - cb0, vec_w)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store = [&](int b) {
#pragma unroll
    for (int k = 0; k < kDV; ++k) {
      const int e = tid + k * kThreads, r = e % kTR, o = (e / kTR) * 8;
      float v[8];
      widen8(dv[k], v);
#pragma unroll
      for (int j = 0; j < 8; ++j) s_d[b][o + j][r] = v[j];
    }
#pragma unroll
    for (int k = 0; k < kWV; ++k) {
      const int e = tid + k * kThreads, o = e / (CB / 8), c = (e % (CB / 8)) * 8;
      if (e >= kWVecs) break;
      float v[8];
      widen8(wv[k], v);
#pragma unroll
      for (int j = 0; j < 8; ++j) s_w[b][o][c + j] = v[j];
    }
  };

  int t = block_taps != 0u && cout > 0 ? __ffs(block_taps) - 1 : -1, o0 = 0, b = 0;
  if (t >= 0) {
    load(t, o0);
    store(0);
  }
  __syncthreads();
  while (t >= 0) {
    int nt = t, no0 = o0 + OC;
    if (no0 >= cout) {   // the tap's last pass: then the next tap
      const uint32_t rest = block_taps & ~((2u << t) - 1u);
      nt = rest != 0u ? __ffs(rest) - 1 : -1;
      no0 = 0;
    }
    if (nt >= 0) load(nt, no0);
    if ((warp_taps >> t) & 1u) {
      const int oc = min(OC, cout - o0);
#pragma unroll 4
      for (int o = 0; o < oc; ++o) {
        float d[RM], wc[kCM];
        lds<RM>(&s_d[b][o][r0], d);
        lds<kCM>(&s_w[b][o][c0], wc);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < kCM; ++j) dot[i][j] = __fadd_rn(dot[i][j], __fmul_rn(d[i], wc[j]));
      }
    }
    if (no0 == 0) {   // tap t's chains are whole: its contributions, in tap order
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < kCM; ++j) {
          if ((live[i] >> t) & 1u) acc[i][j] = bf16_round(__fadd_rn(acc[i][j], bf16_round(dot[i][j])));
          dot[i][j] = 0.f;
        }
      }
    }
    if (nt >= 0) store(b ^ 1);
    __syncthreads();
    b ^= 1, t = nt, o0 = no0;
  }

  // the rows done here (every row without a live tap too)
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = s_row[r0 + i];
    if (row < 0 || s_late[r0 + i]) continue;
#pragma unroll
    for (int j = 0; j < kCM; ++j) {
      const int c = cb0 + c0 + j;
      if (c < cin) out[static_cast<int64_t>(row) * cin + c] = __float2bfloat16_rn(acc[i][j]);
    }
  }

  // the rows whose sources do not ascend with the tap: every live (i, t) in
  // (i, t) order, found by selection, the chains read from memory
  const int nbad = s_nbad;
  for (int e = tid; e < nbad * CB; e += kThreads) {
    const int rr = s_bad[e / CB], c = cb0 + e % CB;
    if (c >= cin) continue;
    float a = 0.f;
    int prev_s = -1, prev_t = -1;
    for (;;) {
      int bs = 0, bt = -1;
      for (int k = 0; k < taps; ++k) {
        const int s = s_src[rr][k];
        if (s < 0 || s < prev_s || (s == prev_s && k <= prev_t)) continue;
        if (bt < 0 || s < bs) bs = s, bt = k;
      }
      if (bt < 0) break;
      const __nv_bfloat16* drow = dout + static_cast<int64_t>(bs) * cout;
      const __nv_bfloat16* wcol = w + static_cast<int64_t>(bt) * cout * cin + c;
      float d = 0.f;
      for (int o = 0; o < cout; ++o)
        d = __fadd_rn(d, __fmul_rn(__bfloat162float(drow[o]),
                                   __bfloat162float(wcol[static_cast<int64_t>(o) * cin])));
      a = bf16_round(__fadd_rn(a, bf16_round(d)));
      prev_s = bs, prev_t = bt;
    }
    out[static_cast<int64_t>(s_row[rr]) * cin + c] = __float2bfloat16_rn(a);
  }
}

// The deep levels: grid (ceil(N / 16), ceil(Cin / CB)), NW warps. A block
// owns 16 rows of the order and CB channels; its warps deal out the taps
// its rows use (the j-th tap of the union to warp j % NW) and each warp
// runs the whole 16 x CB tile for its taps (a thread 4 rows x CB / 8
// channels), staging the tap's dout rows and weights itself, OC values of
// Cout a pass ahead; each contribution, rounded to bf16, goes to shared
// memory. Then every element adds its row's contributions in (source, tap)
// order, the order each row sorted its live taps into at the start (any
// table: no row is left to the end).
template <int NW, int CB, int OC>
__global__ void __launch_bounds__(NW * 32)
gather_dx_bf16_taps_kernel(const __nv_bfloat16* __restrict__ dout, int rows, int cout,
                           const int32_t* __restrict__ idx_t, int n, int taps,
                           const int32_t* __restrict__ perm,
                           const __nv_bfloat16* __restrict__ w, int cin,
                           __nv_bfloat16* __restrict__ out, bool vec_d, bool vec_w) {
  constexpr int kTR = 16, kThreads = NW * 32, kCM = CB / 8;
  constexpr int kDV = kTR * OC / 8 / 32;   // dout vectors a lane stages a pass
  constexpr int kWV = OC * CB / 8 / 32;    // weight vectors a lane stages a pass
  static_assert(kDV * 256 == kTR * OC && kWV * 256 == OC * CB, "");
  __shared__ int32_t s_row[kTR];
  __shared__ int32_t s_src[kTR][kMaxTaps];   // -1: absent
  __shared__ uint8_t s_ord[kTR][kMaxTaps];   // a row's live taps in (source, tap) order
  __shared__ int s_nlive[kTR];
  __shared__ uint32_t s_union;
  __shared__ __nv_bfloat16 s_con[kMaxTaps][kTR][CB];   // contributions by tap
  __shared__ __align__(16) float s_d[NW][OC][kTR];     // each warp's staging
  __shared__ __align__(16) float s_w[NW][OC][CB];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p0 = blockIdx.x * kTR, cb0 = blockIdx.y * CB;

  if (tid < kTR) s_row[tid] = p0 + tid < n ? perm[p0 + tid] : -1;
  if (tid == 0) s_union = 0u;
  __syncthreads();
  for (int e = tid; e < kTR * taps; e += kThreads) {
    const int r = e / taps, t = e % taps, row = s_row[r];
    int32_t s = -1;
    if (row >= 0) {
      s = idx_t[static_cast<int64_t>(row) * taps + t];
      if (s < 0 || s >= rows) s = -1;
    }
    s_src[r][t] = s;
  }
  __syncthreads();
  if (tid < kTR) {   // insertion sort of the row's live (source, tap), stable in the tap
    int k = 0;
    uint32_t live = 0u;
    for (int t = 0; t < taps; ++t) {
      const int s = s_src[tid][t];
      if (s < 0) continue;
      live |= 1u << t;
      int j = k++;
      while (j > 0 && s_src[tid][s_ord[tid][j - 1]] > s) {
        s_ord[tid][j] = s_ord[tid][j - 1];
        --j;
      }
      s_ord[tid][j] = static_cast<uint8_t>(t);
    }
    s_nlive[tid] = k;
    if (live != 0u) atomicOr(&s_union, live);
  }
  __syncthreads();

  const int r0 = (lane >> 3) * 4, c0 = (lane & 7) * kCM;   // the thread's 4 rows, kCM channels
  // the warp's taps: every NW-th of the union, from the warp-th
  uint32_t mine = 0u;
  {
    int j = 0;
    for (uint32_t u = s_union; u != 0u; u &= u - 1u, ++j)
      if (j % NW == warp) mine |= u & (0u - u);
  }
  // a pass: tap t's Cout values o0 .. o0 + OC - 1, a pass ahead
  uint4 dv[kDV], wv[kWV];
  auto load = [&](int t, int o0) {
    const int oc = min(OC, cout - o0);
#pragma unroll
    for (int k = 0; k < kDV; ++k) {
      const int e = lane + 32 * k, r = e % kTR, o = (e / kTR) * 8, s = s_src[r][t];
      dv[k] = s >= 0 && o < oc ? load8(dout + static_cast<int64_t>(s) * cout + o0, o, oc, vec_d)
                               : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < kWV; ++k) {
      const int e = lane + 32 * k, o = e / (CB / 8), c = (e % (CB / 8)) * 8;
      wv[k] = o < oc ? load8(w + (static_cast<int64_t>(t) * cout + o0 + o) * cin + cb0, c,
                             cin - cb0, vec_w)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int k = 0; k < kDV; ++k) {
      const int e = lane + 32 * k, r = e % kTR, o = (e / kTR) * 8;
      float v[8];
      widen8(dv[k], v);
#pragma unroll
      for (int j = 0; j < 8; ++j) s_d[warp][o + j][r] = v[j];
    }
#pragma unroll
    for (int k = 0; k < kWV; ++k) {
      const int e = lane + 32 * k, o = e / (CB / 8), c = (e % (CB / 8)) * 8;
      float v[8];
      widen8(wv[k], v);
#pragma unroll
      for (int j = 0; j < 8; ++j) s_w[warp][o][c + j] = v[j];
    }
  };

  int t = mine != 0u && cout > 0 ? __ffs(mine) - 1 : -1, o0 = 0;
  if (t >= 0) {
    load(t, o0);
    store();
  }
  __syncwarp();
  float dot[4][kCM] = {};
  while (t >= 0) {
    int nt = t, no0 = o0 + OC;
    if (no0 >= cout) {
      const uint32_t rest = mine & ~((2u << t) - 1u);
      nt = rest != 0u ? __ffs(rest) - 1 : -1;
      no0 = 0;
    }
    if (nt >= 0) load(nt, no0);
    const int oc = min(OC, cout - o0);
#pragma unroll 4
    for (int o = 0; o < oc; ++o) {
      float d[4], wc[kCM];
      lds<4>(&s_d[warp][o][r0], d);
      lds<kCM>(&s_w[warp][o][c0], wc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCM; ++j) dot[i][j] = __fadd_rn(dot[i][j], __fmul_rn(d[i], wc[j]));
    }
    if (no0 == 0) {   // tap t's chains are whole: its contributions
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCM; ++j) {
          s_con[t][r0 + i][c0 + j] = __float2bfloat16_rn(dot[i][j]);
          dot[i][j] = 0.f;
        }
    }
    __syncwarp();   // the pass's reads are done
    if (nt >= 0) store();
    __syncwarp();
    t = nt, o0 = no0;
  }
  __syncthreads();

  for (int e = tid; e < kTR * CB; e += kThreads) {
    const int r = e / CB, cc = e % CB, c = cb0 + cc, row = s_row[r];
    if (row < 0 || c >= cin) continue;
    float a = 0.f;   // (with no Cout, every contribution is +0.0 and leaves it)
    for (int k = 0; cout > 0 && k < s_nlive[r]; ++k)
      a = bf16_round(__fadd_rn(a, __bfloat162float(s_con[s_ord[r][k]][r][cc])));
    out[static_cast<int64_t>(row) * cin + c] = __float2bfloat16_rn(a);
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int CB, int NW, int OC>
void launch_tiles(const __nv_bfloat16* dout, int rows, int cout, const int32_t* idx_t, int n,
                  int taps, const int32_t* perm, const __nv_bfloat16* w, int cin,
                  __nv_bfloat16* out, bool vec_d, bool vec_w, cudaStream_t stream) {
  constexpr int kTR = 16 * NW;
  const dim3 grid((n + kTR - 1) / kTR, (cin + CB - 1) / CB);
  gather_dx_bf16_kernel<CB, NW, OC><<<grid, NW * 32, 0, stream>>>(
      dout, rows, cout, idx_t, n, taps, perm, w, cin, out, vec_d, vec_w);
}

template <int NW, int CB, int OC>
void launch_taps(const __nv_bfloat16* dout, int rows, int cout, const int32_t* idx_t, int n,
                 int taps, const int32_t* perm, const __nv_bfloat16* w, int cin,
                 __nv_bfloat16* out, bool vec_d, bool vec_w, cudaStream_t stream) {
  const dim3 grid((n + 15) / 16, (cin + CB - 1) / CB);
  gather_dx_bf16_taps_kernel<NW, CB, OC><<<grid, NW * 32, 0, stream>>>(
      dout, rows, cout, idx_t, n, taps, perm, w, cin, out, vec_d, vec_w);
}

}  // namespace

extern "C" int ms3d_gather_dx_bf16(const __nv_bfloat16* dout, int rows, int cout,
                                   const int32_t* idx_t, int n, int taps, const int32_t* perm,
                                   const __nv_bfloat16* w, int cin, __nv_bfloat16* out,
                                   cudaStream_t stream) {
  if (taps > kMaxTaps || taps < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || cin <= 0) return static_cast<int>(cudaSuccess);
  const bool vec_d = cout % 8 == 0 && aligned(dout, 16);
  const bool vec_w = cin % 8 == 0 && aligned(w, 16);
  const auto args = [&](auto launch) {
    launch(dout, rows, cout, idx_t, n, taps, perm, w, cin, out, vec_d, vec_w, stream);
  };
  if (n > kFewRows) {   // 64-row blocks, the taps walked in order (points 1-4)
    if (cin <= 16)
      args(launch_tiles<16, 4, 32>);
    else
      args(launch_tiles<32, 4, 32>);
  } else if (n > 4096 && cin % 32 == 0) {   // the deep levels' taps split over warps (point 5)
    args(launch_taps<4, 32, 16>);
  } else {
    args(launch_taps<4, 16, 32>);
  }
  return static_cast<int>(cudaGetLastError());
}
