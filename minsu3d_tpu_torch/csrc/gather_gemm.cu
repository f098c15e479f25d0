// K1 gather_gemm: out[r] = sum_t x[idx[r, t]] . W[t]   (f32 sums)
//
// Replaces the gather + dot_general chains of the JAX package's sparse convs:
//   minsu3d_tpu/ops/sparse_conv.py:50 subm_conv  (T = 27, idx = nbr_idx)
//   minsu3d_tpu/ops/sparse_conv.py:66 down_conv  (T = 8, gather form: the
//        wrapper inverts (parent_idx, child_kid) into child_of[parent, kid])
//   minsu3d_tpu/ops/sparse_conv.py:80 up_conv    (T = 8, one live tap per row)
// and, over the transposed table, the f32 input gradient of all three
// (GatherConv.backward). idx is (R, T) int32, T <= 32; any value outside
// [0, n_rows) -- the plan writes n_rows, the level capacity -- is an absent
// neighbour and reads a zero row. Two element types: f32 x/W/out, and bf16
// x/W/out (the JAX package's compute_dtype=bfloat16: bf16 x bf16 products
// summed in f32, the sum rounded once to bf16, sparse_conv.py:30-43, :63,
// :77, :91).
//
// What bounds it on an H100. A call does 2 * live_pairs * Cin * Cout flops
// over a few MB (x's live rows, W, idx, out). At the main path's shapes
// (R <= 131072, 16-224 channels, 3.6-11.5 live taps of 27 a live row, a
// third to a half of the rows live) that is microseconds of tensor-core work
// and of HBM traffic alike: what a design loses is work on dead (row, tap)
// pairs and dead rows, idle SMs, and the latency of the dependent loads
// (order -> idx -> x) of a gather. The design, point by point:
//
// 1. Tensor cores. bf16: mma.sync m16n8k16 bf16 -> f32. f32: the JAX convs
//    run at Precision.HIGHEST, so one TF32 pass is not enough. Each operand
//    is split exactly into three TF32 terms (hi + mid + lo, truncations, as
//    K21 splits) and the six products down to 2^-22 of hi * hi go through
//    mma.sync m16n8k8 TF32 (the three left out are below 2^-33). A split in
//    two terms (three products) costs half as much, but each operand then
//    carries a 2^-22 error, some 10x f32's rounding, and a train step's
//    cancelling gradient sums (a batch-norm bias) took it past the
//    card-vs-CPU tolerance. A register-tiled CUDA-core product (a thread
//    owning 2 rows x 2*NT columns, 4*NT FMAs per k from registers) passed
//    too, but the six TF32 products were 1.1-2.3x faster at every timed
//    shape (PERF.md), so only they stay. The tensor cores' own accumulation
//    truncates, so each group of k steps sums into a fresh accumulator that
//    an f32 add moves into the running sum. A thread's A and B fragments are read
//    straight from global memory into registers: in mma.sync each gathered
//    element feeds exactly one thread, so staging through shared memory
//    (cp.async) would move the same bytes twice. The fragments' k index is
//    permuted (the sum over k does not care) so that a thread's share of a
//    gathered row is one contiguous 8-byte load, and their n index is
//    permuted so that its share of a weight row is one NT-wide vector load;
//    the output columns are un-permuted in the epilogue. Loads of a group of
//    k steps are issued together, and the next tap's sources are loaded
//    before the current tap's products.
// 2. Live work only. The wrapper passes the rows in an order sorted by
//    their set of live taps, rows with no live tap last (K22, tap_order.cu:
//    every table of a forward pass ordered in one call, once a pass, by
//    ops/sparse_conv.py conv_tables). A tile is 16 consecutive rows of
//    that order; it runs only the union of its rows' taps (at PointGroup
//    level 0, close to the 3.6 live taps of a row instead of all 27), and a
//    tile whose rows have no live tap -- past the level's count, read on the
//    card from the sorted keys, no host sync -- writes its zero rows and
//    returns. Up convs (one live tap a row) become dense per-tap groups.
//    Each output row is owned by one tile and written through the order.
// 3. Tiles sized to the widths. A tile is 16 rows x 8*NT columns with NT =
//    2 or 4 n8 tiles (16 or 32 columns, whichever pads Cout less), so a
//    16-wide layer runs in 16-wide tiles; k steps are 16 (bf16) or 8 (f32)
//    channels. Rows that are not 8-byte aligned (the input conv's Cin 6:
//    12 or 24 bytes) and a ragged last k step take guarded scalar loads.
// 4. Filling the card. A block is 4 or 8 warps. On the subm convs NWT = 4
//    warps share one 16-row tile: its taps are dealt out round robin, each
//    warp sums its taps in tap order in registers, and the block adds the
//    warps' partial sums in warp order in shared memory; on tables of at
//    most kFewRows rows (the deep levels, 30 to 2724 live rows), whose few
//    tiles would leave most SMs idle, NWT = 8. On the k2s2 tables (8 taps,
//    one or a few live a row) each warp runs a tile of its own (NWT = 1, 4
//    tiles a block) and stores its fragments directly. Registers are capped
//    so that 6 blocks of 4 warps fit an SM.
// 5. Determinism. No atomics; every output element is the same fixed
//    sequence of f32 adds on every run, so a train step repeats bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileRows = 16;
// rows at or under which 8 warps split a tile's taps: the deep levels, whose
// few tiles leave most SMs idle
constexpr int kFewRows = 12288;
// taps at or under which a warp runs a tile of its own (4 tiles a block):
// the k2s2 convs, whose rows use one tap (up) or a few (down), so that a
// tap split would leave most warps without work
constexpr int kFewTaps = 8;

enum class Product { kBf16, kTf32x6 };

// product -> element type, k step, k steps whose loads are issued together
template <Product P> struct Traits;
template <> struct Traits<Product::kBf16> {
  using T = __nv_bfloat16;
  static constexpr int kK = 16, kGroup = 2;
};
template <> struct Traits<Product::kTf32x6> {
  using T = float;
  static constexpr int kK = 8, kGroup = 2;
};

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

constexpr uint32_t kTf32Bits = 0xffffe000u;  // sign, exponent and 10 mantissa bits

// v = hi + mid + lo exactly: three TF32 truncations (K21's split) of a
// finite v whose terms stay normal
__device__ __forceinline__ void split3(float v, uint32_t (&t)[3]) {
  t[0] = __float_as_uint(v) & kTf32Bits;
  const float r = v - __uint_as_float(t[0]);
  t[1] = __float_as_uint(r) & kTf32Bits;
  t[2] = __float_as_uint(r - __uint_as_float(t[1])) & kTf32Bits;
}

// ---- loads (zeros outside the row, the channels or the columns) -----------

// 4 bf16 at row[k..k+3] as two bf16x2 words; vec: one 8-byte load
__device__ __forceinline__ uint2 load4(const __nv_bfloat16* row, int k, int len, bool vec) {
  if (row == nullptr || k >= len) return make_uint2(0u, 0u);
  if (vec) return *reinterpret_cast<const uint2*>(row + k);
  uint32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = k + j < len ? bf16_bits(row[k + j]) : 0u;
  return make_uint2(v[0] | (v[1] << 16), v[2] | (v[3] << 16));
}

// 2 f32 at row[k..k+1]; vec: one 8-byte load
__device__ __forceinline__ float2 load2(const float* row, int k, int len, bool vec) {
  if (row == nullptr || k >= len) return make_float2(0.f, 0.f);
  if (vec) return *reinterpret_cast<const float2*>(row + k);
  return make_float2(row[k], k + 1 < len ? row[k + 1] : 0.f);
}

// N f32 at row[n..n+N-1]; vec: one N-wide load (row + n aligned to N floats)
template <int N>
__device__ __forceinline__ void load_f32(const float* row, int n, int len, bool vec,
                                         float (&v)[N]) {
  if (row != nullptr && vec && n < len) {
    if constexpr (N == 4) {
      const float4 u = *reinterpret_cast<const float4*>(row + n);
      v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
    } else {
      const float2 u = *reinterpret_cast<const float2*>(row + n);
      v[0] = u.x, v[1] = u.y;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = row != nullptr && n + j < len ? row[n + j] : 0.f;
}

// N bf16 at row[n..n+N-1] as N/2 bf16x2 words; vec: one load
template <int N>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* row, int n, int len, bool vec,
                                          uint32_t (&v)[N / 2]) {
  if (row != nullptr && vec && n < len) {
    if constexpr (N == 4) {
      const uint2 u = *reinterpret_cast<const uint2*>(row + n);
      v[0] = u.x, v[1] = u.y;
    } else {
      v[0] = *reinterpret_cast<const uint32_t*>(row + n);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const uint32_t lo = row != nullptr && n + 2 * j < len ? bf16_bits(row[n + 2 * j]) : 0u;
    const uint32_t hi = row != nullptr && n + 2 * j + 1 < len ? bf16_bits(row[n + 2 * j + 1]) : 0u;
    v[j] = lo | (hi << 16);
  }
}

// What a thread of the warp owns: rows g and g + 8 of the tile (lane / 4) and
// quad q (lane % 4). Its accumulator acc[i][0..3] holds output rows (g, g,
// g + 8, g + 8) and columns (c0 + i, c1 + i, c0 + i, c1 + i) of the tile,
// c0 = 2q * NT, c1 = (2q + 1) * NT: mma's C fragment of n8 tile i, whose
// logical column j is the tile's column j * NT + i.
struct Lane {
  int g, q;
};

// One tap's contribution to the warp's 16 x 8NT tile, a k group at a time.
// xa, xb: the gathered rows of x (nullptr: absent), wt: the tap's (cin,
// cout) weight slice, n0: the tile's first output column.
template <Product P, int NT>
__device__ __forceinline__ void tap_product(float (&acc)[NT][4], Lane ln,
                                            const typename Traits<P>::T* xa,
                                            const typename Traits<P>::T* xb, int cin,
                                            bool vec_x, const typename Traits<P>::T* wt,
                                            int cout, int n0, bool vec_w) {
  constexpr int kK = Traits<P>::kK, kG = Traits<P>::kGroup;
  for (int k0 = 0; k0 < cin; k0 += kK * kG) {
    // the tensor cores sum a group's products into a fresh accumulator,
    // added to acc by an f32 add: their own accumulation truncates, and
    // over a row's hundreds of mma steps into one running sum that bias
    // reaches 1e-5 of the output's scale
    float grp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) grp[i][0] = grp[i][1] = grp[i][2] = grp[i][3] = 0.f;
    if constexpr (P == Product::kBf16) {
      // logical k (2q, 2q+1, 2q+8, 2q+9) of a k16 step is physical 4q..4q+3
      uint2 ra[kG], rb[kG];  // rows g and g+8
      uint32_t w[kG][4][NT / 2];
#pragma unroll
      for (int s = 0; s < kG; ++s) {
        const int k = k0 + s * kK + 4 * ln.q;
        ra[s] = load4(xa, k, cin, vec_x);
        rb[s] = load4(xb, k, cin, vec_x);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          load_bf16<NT>(k + j < cin ? wt + static_cast<int64_t>(k + j) * cout : nullptr,
                        n0 + ln.g * NT, cout, vec_w, w[s][j]);
      }
#pragma unroll
      for (int s = 0; s < kG; ++s) {
        if (k0 + s * kK >= cin) break;
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const uint32_t sel = (i & 1) ? 0x7632u : 0x5410u;
          const uint32_t b0 = __byte_perm(w[s][0][i / 2], w[s][1][i / 2], sel);
          const uint32_t b1 = __byte_perm(w[s][2][i / 2], w[s][3][i / 2], sel);
          mma_bf16(grp[i], ra[s].x, rb[s].x, ra[s].y, rb[s].y, b0, b1);
        }
      }
    } else {
      // logical k (q, q+4) of a k8 step is physical (2q, 2q+1)
      float2 ra[kG], rb[kG];  // rows g and g+8
      float w0[kG][NT], w1[kG][NT];
#pragma unroll
      for (int s = 0; s < kG; ++s) {
        const int k = k0 + s * kK + 2 * ln.q;
        ra[s] = load2(xa, k, cin, vec_x);
        rb[s] = load2(xb, k, cin, vec_x);
        load_f32<NT>(k < cin ? wt + static_cast<int64_t>(k) * cout : nullptr, n0 + ln.g * NT,
                     cout, vec_w, w0[s]);
        load_f32<NT>(k + 1 < cin ? wt + static_cast<int64_t>(k + 1) * cout : nullptr,
                     n0 + ln.g * NT, cout, vec_w, w1[s]);
      }
#pragma unroll
      for (int s = 0; s < kG; ++s) {
        if (k0 + s * kK >= cin) break;
        uint32_t a0[3], a1[3], a2[3], a3[3];
        split3(ra[s].x, a0);
        split3(rb[s].x, a1);
        split3(ra[s].y, a2);
        split3(rb[s].y, a3);
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          uint32_t b0[3], b1[3];
          split3(w0[s][i], b0);
          split3(w1[s][i], b1);
          // the six products down to 2^-22 of hi * hi, smallest first, in
          // a fresh accumulator added to the group's by an f32 add
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(d, a0[2], a1[2], a2[2], a3[2], b0[0], b1[0]);
          mma_tf32(d, a0[0], a1[0], a2[0], a3[0], b0[2], b1[2]);
          mma_tf32(d, a0[1], a1[1], a2[1], a3[1], b0[1], b1[1]);
          mma_tf32(d, a0[1], a1[1], a2[1], a3[1], b0[0], b1[0]);
          mma_tf32(d, a0[0], a1[0], a2[0], a3[0], b0[1], b1[1]);
          mma_tf32(d, a0[0], a1[0], a2[0], a3[0], b0[0], b1[0]);
#pragma unroll
          for (int c = 0; c < 4; ++c) grp[i][c] += d[c];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] += grp[i][c];
  }
}

// This warp's next tap of the tile's taps still in `left` (the j-th set bit
// of the tile's union goes to warp j % NW); -1: none.
template <int NW>
__device__ __forceinline__ int next_tap(uint32_t& left, int& j, int warp) {
  while (left != 0u) {
    const int t = __ffs(left) - 1;
    left &= left - 1u;
    if (j++ % NW == warp) return t;
  }
  return -1;
}

__device__ __forceinline__ int32_t source(const int32_t* idx, int row, int taps, int t,
                                          int n_rows) {
  if (row < 0 || t < 0) return -1;
  const int32_t s = idx[static_cast<int64_t>(row) * taps + t];
  return s >= 0 && s < n_rows ? s : -1;
}

// Stores `n` f32 sums as T at out[0..n) (columns past cout dropped); vec:
// one vector store (out aligned to n elements).
template <typename T, int N>
__device__ __forceinline__ void store_run(T* out, int col, int cout, bool vec, const float* v) {
  if (vec && col + N <= cout) {
    if constexpr (sizeof(T) == 4) {
      if constexpr (N == 4)
        *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
      else
        *reinterpret_cast<float2*>(out) = make_float2(v[0], v[1]);
    } else {
      uint32_t w[N / 2];
#pragma unroll
      for (int j = 0; j < N / 2; ++j)
        w[j] = bf16_bits(from_f32<T>(v[2 * j])) | (bf16_bits(from_f32<T>(v[2 * j + 1])) << 16);
      if constexpr (N == 4)
        *reinterpret_cast<uint2*>(out) = make_uint2(w[0], w[1]);
      else
        *reinterpret_cast<uint32_t*>(out) = w[0];
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (col + j < cout) out[j] = from_f32<T>(v[j]);
}

// grid (ceil(rows / (16 NWR)), ceil(cout / 8NT)), NWR * NWT warps: NWR
// 16-row tiles a block, each run by NWT warps that split its taps. perm:
// the rows in tap order; key: their sorted keys, bit t set where tap t is
// absent.
template <Product P, int NT, int NWR, int NWT>
__global__ void __launch_bounds__(NWR * NWT * 32, 768 / (NWR * NWT * 32))
gather_gemm_kernel(const typename Traits<P>::T* __restrict__ x, int n_rows, int cin,
                   const int32_t* __restrict__ idx, int rows, int taps,
                   const int32_t* __restrict__ perm, const int64_t* __restrict__ key,
                   const typename Traits<P>::T* __restrict__ w, int cout,
                   typename Traits<P>::T* __restrict__ out, bool vec_x, bool vec_w,
                   bool vec_out) {
  using T = typename Traits<P>::T;
  constexpr int kCols = 8 * NT;
  constexpr int kParts = NWT > 1 ? NWT : 1;
  __shared__ float part[kParts][kTileRows][kCols + 1];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wt = warp % NWT;                    // the warp's tap group
  const Lane ln{lane >> 2, lane & 3};
  const int p0 = (blockIdx.x * NWR + warp / NWT) * kTileRows;
  const int n0 = blockIdx.y * kCols;
  const uint32_t all = taps >= 32 ? 0xffffffffu : (1u << taps) - 1u;

  // the tile's taps: the union of its rows' live taps (every warp of the
  // tile reads it); the rows' ids are loaded beside the keys, not after them
  uint32_t live = 0u;
  if (lane < kTileRows && p0 + lane < rows) live = ~static_cast<uint32_t>(key[p0 + lane]) & all;
  const int ra = p0 + ln.g < rows ? perm[p0 + ln.g] : -1;
  const int rb = p0 + ln.g + 8 < rows ? perm[p0 + ln.g + 8] : -1;
  const uint32_t tile_taps = __reduce_or_sync(0xffffffffu, live);

  if (tile_taps == 0u) {  // past the live rows: zeros (uniform over the tile's warps)
    if (wt == 0) {
      for (int e = lane; e < kTileRows * kCols; e += 32) {
        const int p = p0 + e / kCols, n = n0 + e % kCols;
        if (p < rows && n < cout)
          out[static_cast<int64_t>(perm[p]) * cout + n] = from_f32<T>(0.f);
      }
    }
    return;
  }

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  uint32_t left = tile_taps;
  int j = 0;
  int t = next_tap<NWT>(left, j, wt);
  int32_t sa = source(idx, ra, taps, t, n_rows), sb = source(idx, rb, taps, t, n_rows);
  while (t >= 0) {
    const int tn = next_tap<NWT>(left, j, wt);
    const int32_t na = source(idx, ra, taps, tn, n_rows), nb = source(idx, rb, taps, tn, n_rows);
    tap_product<P, NT>(acc, ln, sa >= 0 ? x + static_cast<int64_t>(sa) * cin : nullptr,
                       sb >= 0 ? x + static_cast<int64_t>(sb) * cin : nullptr, cin, vec_x,
                       w + static_cast<int64_t>(t) * cin * cout, cout, n0, vec_w);
    t = tn, sa = na, sb = nb;
  }

  const int c0 = 2 * ln.q * NT, c1 = c0 + NT;
  if constexpr (NWT == 1) {
    // the warp owns its rows: store its C fragments as two runs of NT columns a row
    float v[4][NT];
#pragma unroll
    for (int i = 0; i < NT; ++i)
      v[0][i] = acc[i][0], v[1][i] = acc[i][1], v[2][i] = acc[i][2], v[3][i] = acc[i][3];
    if (ra >= 0) {
      T* o = out + static_cast<int64_t>(ra) * cout + n0;
      store_run<T, NT>(o + c0, n0 + c0, cout, vec_out, v[0]);
      store_run<T, NT>(o + c1, n0 + c1, cout, vec_out, v[1]);
    }
    if (rb >= 0) {
      T* o = out + static_cast<int64_t>(rb) * cout + n0;
      store_run<T, NT>(o + c0, n0 + c0, cout, vec_out, v[2]);
      store_run<T, NT>(o + c1, n0 + c1, cout, vec_out, v[3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      part[wt][ln.g][c0 + i] = acc[i][0];
      part[wt][ln.g][c1 + i] = acc[i][1];
      part[wt][ln.g + 8][c0 + i] = acc[i][2];
      part[wt][ln.g + 8][c1 + i] = acc[i][3];
    }
    __syncthreads();
    // warps past the tile's tap count hold zeros and are left out
    const int used = min(NWT, __popc(tile_taps));
    for (int e = threadIdx.x; e < kTileRows * kCols; e += NWT * 32) {
      const int r = e / kCols, c = e % kCols;
      const int p = p0 + r, n = n0 + c;
      if (p >= rows || n >= cout) continue;
      float sum = part[0][r][c];
      for (int k = 1; k < used; ++k) sum += part[k][r][c];
      out[static_cast<int64_t>(perm[p]) * cout + n] = from_f32<T>(sum);
    }
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <Product P, int NT>
int launch_nt(int groups, dim3 grid, const typename Traits<P>::T* x, int n_rows, int cin,
              const int32_t* idx, int rows, int taps, const int32_t* perm, const int64_t* key,
              const typename Traits<P>::T* w, int cout, typename Traits<P>::T* out, bool vec_x,
              bool vec_w, bool vec_out, cudaStream_t stream) {
  if (groups == 1) {
    grid.x = (grid.x + 3) / 4;
    gather_gemm_kernel<P, NT, 4, 1><<<grid, 128, 0, stream>>>(
        x, n_rows, cin, idx, rows, taps, perm, key, w, cout, out, vec_x, vec_w, vec_out);
  } else if (groups == 4) {
    gather_gemm_kernel<P, NT, 1, 4><<<grid, 128, 0, stream>>>(
        x, n_rows, cin, idx, rows, taps, perm, key, w, cout, out, vec_x, vec_w, vec_out);
  } else {
    gather_gemm_kernel<P, NT, 1, 8><<<grid, 256, 0, stream>>>(
        x, n_rows, cin, idx, rows, taps, perm, key, w, cout, out, vec_x, vec_w, vec_out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <Product P>
int launch(const typename Traits<P>::T* x, int n_rows, int cin, const int32_t* idx, int rows,
           int taps, const int32_t* perm, const int64_t* key, const typename Traits<P>::T* w,
           int cout, typename Traits<P>::T* out, cudaStream_t stream) {
  if (taps < 1 || taps > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || cout == 0) return static_cast<int>(cudaSuccess);
  using T = typename Traits<P>::T;
  // the warps that split a tile's taps (point 4 above)
  const int groups = taps <= kFewTaps ? 1 : (rows <= kFewRows ? 8 : 4);
  // 16-column tiles where they pad Cout less than 32-column ones
  const int nt = (cout <= 16 || (cout % 32 != 0 && cout % 32 <= 16)) ? 2 : 4;
  // x: a thread's 8-byte piece of a row, 4 bf16 or 2 f32
  const int xq = P == Product::kBf16 ? 4 : 2;
  const int esize = static_cast<int>(sizeof(T));
  const bool vec_x = cin % xq == 0 && aligned(x, xq * esize);
  const bool vec_w = cout % nt == 0 && aligned(w, nt * esize);
  const bool vec_out = cout % nt == 0 && aligned(out, nt * esize);
  const dim3 grid((rows + kTileRows - 1) / kTileRows, (cout + 8 * nt - 1) / (8 * nt));
  return nt == 2 ? launch_nt<P, 2>(groups, grid, x, n_rows, cin, idx, rows, taps, perm, key, w,
                                   cout, out, vec_x, vec_w, vec_out, stream)
                 : launch_nt<P, 4>(groups, grid, x, n_rows, cin, idx, rows, taps, perm, key, w,
                                   cout, out, vec_x, vec_w, vec_out, stream);
}

}  // namespace

// f32 (six TF32 products)
extern "C" int ms3d_gather_gemm(const float* x, int n_rows, int cin, const int32_t* idx,
                                int rows, int taps, const int32_t* perm, const int64_t* key,
                                const float* w, int cout, float* out, cudaStream_t stream) {
  return launch<Product::kTf32x6>(x, n_rows, cin, idx, rows, taps, perm, key, w, cout, out,
                                  stream);
}

// the same with bf16 x, w and out (f32 sums, one rounding per output)
extern "C" int ms3d_gather_gemm_bf16(const __nv_bfloat16* x, int n_rows, int cin,
                                     const int32_t* idx, int rows, int taps, const int32_t* perm,
                                     const int64_t* key, const __nv_bfloat16* w, int cout,
                                     __nv_bfloat16* out, cudaStream_t stream) {
  return launch<Product::kBf16>(x, n_rows, cin, idx, rows, taps, perm, key, w, cout, out,
                                stream);
}
