// K4 gather_wgrad: dW[t] = sum_r x~[idx[r, t]]^T . dout[r]   (f32 sum)
//
// Two element types: f32 x and dout (ms3d_gather_wgrad), or bf16 x and a
// bf16 cotangent (ms3d_gather_wgrad_bf16). The bf16 variant rounds the f32
// total once to bf16 and writes it widened to f32: the JAX package's bf16
// train step computes dW as an f32 dot of the bf16 gathered rows with the
// widened cotangent, rounds it to the bf16 weight's dtype (the transpose of
// _mm's b.astype(bf16), minsu3d_tpu/ops/sparse_conv.py:38) and widens it
// back for the f32 parameter, which Adam then reads.
//
// The weight gradient of the sparse convs (K1's forward out[r] = sum_t
// x~[idx[r, t]] . W[t], x~ = x with a zero row appended). Replaces the dW
// half of the JAX package's conv backward: the gathered-table contraction
// of minsu3d_tpu/ops/sparse_conv.py:306-376 (subm_conv_blocked_vjp) and the
// autodiff of subm_conv / down_conv / up_conv (:50, :66, :80). idx is (R,
// T) int32; any value outside [0, n_rows) is an absent pair and adds
// nothing.
//
// What bounds it on an H100: 2 * live_pairs * Cin * Cout flops, microseconds
// of tensor-core work at every level, over a few MB of gathered rows; what a
// design loses is work on dead pairs, idle SMs, the latency of the
// dependent loads (order -> idx -> x) and the traffic of its partial sums.
// The design, point by point:
//
// 1. A gathered GEMM a tap over its live pairs. dW[t] is (Cin x Cout) =
//    A^T B with K running over the rows where tap t is live: A = the
//    gathered x rows, B = the dout rows. Three short launches list those
//    pairs once a call, from the forward table's TapOrder (K22: the rows
//    sorted by their set of live taps): each 16-row tile of the order
//    counts its live rows a tap from the sorted keys alone, one block a tap
//    scans the counts, and each row writes its live (row, source) pairs to
//    the taps' lists, in the order's row order. The GEMM then reads K
//    slices of 16 live pairs as 8-byte entries, contiguous: no product on
//    a dead pair, and the table's index is read once a call, not once a
//    block.
// 2. Tensor cores. bf16: mma.sync m16n8k16 bf16 -> f32; the products are
//    exact, only the order of the f32 sum differs from the plain einsum.
//    f32: K1's exact three-term TF32 split, the six products down to 2^-22
//    of hi * hi on mma.sync m16n8k8 (gather_gemm.cu; two terms fail a train
//    step's card-vs-CPU bound). Every slice's products go into a fresh
//    accumulator that an f32 add moves into the running sum: the tensor
//    cores' own accumulation truncates.
// 3. Gathers in flight. A thread's share of a slice is 4 pairs (4q ..
//    4q+3: a bijection onto the fragments' k, whose order the sum does not
//    care about) times 2MT channels of x and NT columns of dout, each one
//    cp.async into the thread's own slot of a ring of kStages stages in
//    shared memory (zero-filled where absent), issued kStages - 1 slices
//    ahead of the products, so that the gathers' latency hides behind
//    them; the thread reads back only what it copied, so no barrier. The
//    fragments' m index is permuted so that a thread's channels are
//    contiguous (logical 16j + 8h + g <-> physical 2MT g + 2j + h) and
//    their n index as in K1 (logical 8i + c <-> NT c + i); the epilogue
//    writes the physical positions.
// 4. Filling the card. A block (4 warps) owns one tap, one (16MT x 8NT)
//    tile of dW and one of `chunks` equal parts of the tap's list (its
//    warps a quarter each), so that every block of a tap has the same work;
//    the warps add their sums in warp order in shared memory. The wrapper
//    (ops/sparse_conv.py wgrad_split) fixes the chunks from the shape
//    alone: as many as it takes to give the card about 8 blocks an SM,
//    fewer where the table is short or the partials would pass 8 MB. Each
//    block writes its sums to a per-chunk partial (one chunk writes dW
//    itself), and a last launch sums the partials in chunk order. No float
//    atomics: dW is the same bits from run to run.
// wgmma and TMA are not used: a level's K slices are 16 rows of gathered
// rows, which neither reads, and the per-tap GEMMs are at most 224 x 224.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileRows = 16;
constexpr int kWarps = 4;   // a block's warps, each with its own share of the chunk

enum class Product { kBf16, kTf32x6 };

template <Product P> struct Traits;
template <> struct Traits<Product::kBf16> { using T = __nv_bfloat16; };
template <> struct Traits<Product::kTf32x6> { using T = float; };

// ---- the mma and the split, as in gather_gemm.cu ------------------------

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

// v = hi + mid + lo exactly: three TF32 truncations
__device__ __forceinline__ void split3(float v, uint32_t (&t)[3]) {
  t[0] = __float_as_uint(v) & kTf32Bits;
  const float r = v - __uint_as_float(t[0]);
  t[1] = __float_as_uint(r) & kTf32Bits;
  t[2] = __float_as_uint(r - __uint_as_float(t[1])) & kTf32Bits;
}

// counts[t][i]: the rows of the order's 16-row tile i live at tap t (key
// bit t clear), a half-warp a tile; counts has tiles + 1 entries a tap
__global__ void pair_counts_kernel(const int64_t* __restrict__ key, int rows, int taps,
                                   int tiles, int32_t* __restrict__ counts) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const uint32_t all = taps >= 32 ? 0xffffffffu : (1u << taps) - 1u;
  const uint32_t live = p < rows ? ~static_cast<uint32_t>(key[p]) & all : 0u;
  const uint32_t half = lane < 16 ? 0x0000ffffu : 0xffff0000u;
  for (int t = 0; t < taps; ++t) {
    const uint32_t b = __ballot_sync(0xffffffffu, (live >> t) & 1u);
    if ((lane & 15) == 0 && p < rows)
      counts[static_cast<int64_t>(t) * (tiles + 1) + p / kTileRows] = __popc(b & half);
  }
}

// counts[t][.] -> exclusive prefix sums in place, the total at [t][tiles];
// a block of 1024 threads a tap, in tile order
__global__ void __launch_bounds__(1024) pair_offsets_kernel(int32_t* __restrict__ counts,
                                                            int tiles) {
  __shared__ int32_t warp_sums[32];
  __shared__ int32_t carry;
  int32_t* c = counts + static_cast<int64_t>(blockIdx.x) * (tiles + 1);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < tiles; base += 1024) {
    const int i = base + tid;
    const int32_t v = i < tiles ? c[i] : 0;
    int32_t x = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int32_t w = warp_sums[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    const int32_t excl = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
    if (i < tiles) c[i] = excl;
    __syncthreads();   // every thread has read carry and warp_sums
    if (tid == 1023) carry = excl + v;
    __syncthreads();
  }
  if (tid == 0) c[tiles] = carry;
}

// pairs[t][offsets[t][tile] + rank]: (row, source) of each order position
// live at tap t (source -1 where it lies outside [0, n_rows)), in order
__global__ void pair_scatter_kernel(const int64_t* __restrict__ key,
                                    const int32_t* __restrict__ perm,
                                    const int32_t* __restrict__ idx, int rows, int taps,
                                    int n_rows, int tiles, const int32_t* __restrict__ offsets,
                                    int2* __restrict__ pairs) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const uint32_t all = taps >= 32 ? 0xffffffffu : (1u << taps) - 1u;
  const uint32_t live = p < rows ? ~static_cast<uint32_t>(key[p]) & all : 0u;
  const int r = live != 0u ? perm[p] : -1;
  const uint32_t below = ((1u << lane) - 1u) & (lane < 16 ? 0x0000ffffu : 0xffff0000u);
  for (int t = 0; t < taps; ++t) {
    const bool on = (live >> t) & 1u;
    const uint32_t b = __ballot_sync(0xffffffffu, on);
    if (!on) continue;
    int32_t s = idx[static_cast<int64_t>(r) * taps + t];
    if (s < 0 || s >= n_rows) s = -1;
    const int64_t at = offsets[static_cast<int64_t>(t) * (tiles + 1) + p / kTileRows] +
                       __popc(b & below);
    pairs[static_cast<int64_t>(t) * rows + at] = make_int2(r, s);
  }
}

constexpr int kListCap = 512;   // pairs of a warp's list loaded at a time

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES (4, 8 or 16) from src to shared dst, or zeros when !ok
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
               "l"(src), "n"(BYTES), "r"(ok ? BYTES : 0));
}

__device__ __forceinline__ void commit_async() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <Product P, int MT, int NT>
struct Layout {
  using T = typename Traits<P>::T;
  static constexpr int kX = 2 * MT, kM = 16 * MT, kN = 8 * NT;
  static constexpr int kStages = P == Product::kBf16 ? 4 : 3;
  static constexpr int kThreads = kWarps * 32;
  // shared memory: each warp's pair list, then the stage ring (x then dout,
  // [stage][row j][thread][elements]), reused for the warps' sums at the end
  static constexpr int kListBytes = kWarps * kListCap * 8;
  static constexpr int kXBytes = kStages * 4 * kThreads * kX * static_cast<int>(sizeof(T));
  static constexpr int kDBytes = kStages * 4 * kThreads * NT * static_cast<int>(sizeof(T));
  static constexpr int kPartBytes = (kWarps - 1) * kM * (kN + 1) * 4;
  static constexpr int kRing = kXBytes + kDBytes > kPartBytes ? kXBytes + kDBytes : kPartBytes;
  static constexpr int kBytes = kListBytes + kRing;
};

// grid (chunks, taps, dW tiles), kWarps warps, Layout::kBytes of dynamic
// shared memory. Block (c, t, z) sums tap t's products over part c of the
// tap's pair list into dW tile z (16MT channels x 8NT columns) and writes
// them to partial[c][t] (rounded once to bf16 when `round_out`: one chunk,
// partial == dW).
template <Product P, int MT, int NT>
__global__ void __launch_bounds__(kWarps * 32)
wgrad_kernel(const typename Traits<P>::T* __restrict__ x, int cin,
             const int2* __restrict__ pairs, const int32_t* __restrict__ offsets, int rows,
             int taps, int tiles, const typename Traits<P>::T* __restrict__ dout, int cout,
             int chunks, float* __restrict__ partial, bool round_out, bool vec_x, bool vec_d) {
  using L = Layout<P, MT, NT>;
  using T = typename Traits<P>::T;
  constexpr int kX = L::kX, kM = L::kM, kN = L::kN, kS = L::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  int2* list = reinterpret_cast<int2*>(smem);
  T* st_x = reinterpret_cast<T*>(smem + L::kListBytes);
  T* st_d = reinterpret_cast<T*>(smem + L::kListBytes + L::kXBytes);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tid = threadIdx.x;
  const int g = lane >> 2, q = lane & 3;
  const int c = blockIdx.x, t = blockIdx.y;
  const int co_tiles = (cout + kN - 1) / kN;
  const int ci0 = (blockIdx.z / co_tiles) * kM, co0 = (blockIdx.z % co_tiles) * kN;
  const int xc = ci0 + kX * g, dc = co0 + NT * g;   // the thread's first channel, column
  int2* my_list = list + warp * kListCap;
  // the warp's quarter of the block's part of the tap's list
  const int64_t n_pairs = offsets[static_cast<int64_t>(t) * (tiles + 1) + tiles];
  const int64_t lo = n_pairs * c / chunks, hi = n_pairs * (c + 1) / chunks;
  const int64_t a = lo + (hi - lo) * warp / kWarps, b = lo + (hi - lo) * (warp + 1) / kWarps;
  const int2* tap_pairs = pairs + static_cast<int64_t>(t) * rows;

  float acc[MT][NT][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int i = 0; i < NT; ++i) acc[j][i][0] = acc[j][i][1] = acc[j][i][2] = acc[j][i][3] = 0.f;

  // slot (stage, pair j) of this thread in the ring
  auto x_slot = [&](int stage, int j) {
    return st_x + ((stage * 4 + j) * L::kThreads + tid) * kX;
  };
  auto d_slot = [&](int stage, int j) {
    return st_d + ((stage * 4 + j) * L::kThreads + tid) * NT;
  };
  // the copies of slice `slice` of the list into `stage`
  auto issue = [&](int slice, int stage) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int2 e = my_list[slice * kTileRows + 4 * q + j];   // (row, source)
      T* xs = x_slot(stage, j);
      T* ds = d_slot(stage, j);
      const bool xo = e.y >= 0 && xc < cin, dok = e.x >= 0 && dc < cout;
      if (vec_x) {
        copy_async<kX * sizeof(T)>(xs, xo ? x + static_cast<int64_t>(e.y) * cin + xc : x, xo);
      } else {
#pragma unroll
        for (int k = 0; k < kX; ++k)
          xs[k] = e.y >= 0 && xc + k < cin ? x[static_cast<int64_t>(e.y) * cin + xc + k] : T(0.f);
      }
      if (vec_d) {
        copy_async<NT * sizeof(T)>(ds, dok ? dout + static_cast<int64_t>(e.x) * cout + dc : dout,
                                   dok);
      } else {
#pragma unroll
        for (int k = 0; k < NT; ++k)
          ds[k] = e.x >= 0 && dc + k < cout ? dout[static_cast<int64_t>(e.x) * cout + dc + k]
                                            : T(0.f);
      }
    }
  };
  // the products of the slice in `stage`
  auto product = [&](int stage) {
    if constexpr (P == Product::kBf16) {
      uint32_t xv[4][MT], dv[4][NT / 2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t* xw = reinterpret_cast<const uint32_t*>(x_slot(stage, j));
        const uint32_t* dw = reinterpret_cast<const uint32_t*>(d_slot(stage, j));
#pragma unroll
        for (int k = 0; k < MT; ++k) xv[j][k] = xw[k];
#pragma unroll
        for (int k = 0; k < NT / 2; ++k) dv[j][k] = dw[k];
      }
      // pairs j = 0, 1, 2, 3 are the fragments' k = 2q, 2q + 1, 2q + 8, 2q + 9
#pragma unroll
      for (int jm = 0; jm < MT; ++jm) {
        const uint32_t a0 = __byte_perm(xv[0][jm], xv[1][jm], 0x5410);
        const uint32_t a1 = __byte_perm(xv[0][jm], xv[1][jm], 0x7632);
        const uint32_t a2 = __byte_perm(xv[2][jm], xv[3][jm], 0x5410);
        const uint32_t a3 = __byte_perm(xv[2][jm], xv[3][jm], 0x7632);
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const uint32_t sel = (i & 1) ? 0x7632u : 0x5410u;
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(d, a0, a1, a2, a3, __byte_perm(dv[0][i / 2], dv[1][i / 2], sel),
                   __byte_perm(dv[2][i / 2], dv[3][i / 2], sel));
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[jm][i][k] += d[k];
        }
      }
    } else {
      float xv[4][kX], dv[4][NT];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* xs = x_slot(stage, j);
        const float* ds = d_slot(stage, j);
#pragma unroll
        for (int k = 0; k < kX; ++k) xv[j][k] = xs[k];
#pragma unroll
        for (int k = 0; k < NT; ++k) dv[j][k] = ds[k];
      }
      // k8 step st takes pairs 2st (k = q) and 2st + 1 (k = q + 4)
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        uint32_t b0[NT][3], b1[NT][3];
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          split3(dv[2 * st][i], b0[i]);
          split3(dv[2 * st + 1][i], b1[i]);
        }
#pragma unroll
        for (int jm = 0; jm < MT; ++jm) {
          uint32_t a0[3], a1[3], a2[3], a3[3];
          split3(xv[2 * st][2 * jm], a0);
          split3(xv[2 * st][2 * jm + 1], a1);
          split3(xv[2 * st + 1][2 * jm], a2);
          split3(xv[2 * st + 1][2 * jm + 1], a3);
#pragma unroll
          for (int i = 0; i < NT; ++i) {
            // the six products down to 2^-22 of hi * hi, smallest first
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(d, a0[2], a1[2], a2[2], a3[2], b0[i][0], b1[i][0]);
            mma_tf32(d, a0[0], a1[0], a2[0], a3[0], b0[i][2], b1[i][2]);
            mma_tf32(d, a0[1], a1[1], a2[1], a3[1], b0[i][1], b1[i][1]);
            mma_tf32(d, a0[1], a1[1], a2[1], a3[1], b0[i][0], b1[i][0]);
            mma_tf32(d, a0[0], a1[0], a2[0], a3[0], b0[i][1], b1[i][1]);
            mma_tf32(d, a0[0], a1[0], a2[0], a3[0], b0[i][0], b1[i][0]);
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[jm][i][k] += d[k];
          }
        }
      }
    }
  };
  // the list's whole slices through the ring, kS - 1 slices in flight
  auto run = [&](int slices) {
#pragma unroll
    for (int k = 0; k < kS - 1; ++k) {
      if (k < slices) issue(k, k);
      commit_async();
    }
    for (int k = 0; k < slices; ++k) {
      if (k + kS - 1 < slices) issue(k + kS - 1, (k + kS - 1) % kS);
      commit_async();
      wait_async<kS - 1>();
      product(k % kS);
    }
  };

  // the warp's pairs, kListCap at a time; its last slice padded with absent pairs
  for (int64_t base = a; base < b; base += kListCap) {
    const int n = static_cast<int>(min(static_cast<int64_t>(kListCap), b - base));
    const int slices = (n + kTileRows - 1) / kTileRows;
#pragma unroll
    for (int u = 0; u < kListCap / 32; ++u) {
      const int e = lane + 32 * u;
      if (e < slices * kTileRows) my_list[e] = e < n ? tap_pairs[base + e] : make_int2(-1, -1);
    }
    __syncwarp();
    run(slices);
    __syncwarp();   // the list is read before it is overwritten
  }
  wait_async<0>();

  // the warps' sums added in warp order; fragment element k of (jm, i) is
  // logical dW row 16jm + g + 8(k >> 1), column 8i + 2q + (k & 1)
  __syncthreads();   // every warp is done with the ring, which now holds the sums
  float* part = reinterpret_cast<float*>(smem + L::kListBytes);
  auto at = [&](int w, int m, int n) { return part + ((w * kM) + m) * (kN + 1) + n; };
  if (warp > 0) {
#pragma unroll
    for (int jm = 0; jm < MT; ++jm)
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          *at(warp - 1, 16 * jm + g + 8 * (k >> 1), 8 * i + 2 * q + (k & 1)) = acc[jm][i][k];
  }
  __syncthreads();
  if (warp > 0) return;
  float* dst = partial + (static_cast<int64_t>(c) * taps + t) * cin * cout;
#pragma unroll
  for (int jm = 0; jm < MT; ++jm)
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int m = 16 * jm + g + 8 * (k >> 1), n = 8 * i + 2 * q + (k & 1);
        float v = acc[jm][i][k];
#pragma unroll
        for (int w = 0; w < kWarps - 1; ++w) v += *at(w, m, n);
        const int ci = ci0 + kX * g + 2 * jm + (k >> 1);   // physical channel
        const int co = co0 + NT * (2 * q + (k & 1)) + i;    // physical column
        if (ci < cin && co < cout)
          dst[static_cast<int64_t>(ci) * cout + co] =
              round_out ? __bfloat162float(__float2bfloat16_rn(v)) : v;
      }
}

// out[e] = sum over chunks, in chunk order, of partial[chunk][e] (rounded
// once to bf16 when `round_out`)
__global__ void sum_partials_kernel(const float* __restrict__ partial, int n_chunks,
                                    int64_t n_out, float* __restrict__ out, bool round_out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s = __fadd_rn(s, partial[c * n_out + e]);
  out[e] = round_out ? __bfloat162float(__float2bfloat16_rn(s)) : s;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <Product P, int MT, int NT>
int launch_tiles(dim3 grid, const typename Traits<P>::T* x, int cin, const int2* pairs,
                 const int32_t* offsets, int rows, int taps, int tiles,
                 const typename Traits<P>::T* dout, int cout, int chunks, float* partial,
                 bool round_out, cudaStream_t stream) {
  using L = Layout<P, MT, NT>;
  using T = typename Traits<P>::T;
  static bool sized = false;   // the attribute is the kernel's, set once a process
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgrad_kernel<P, MT, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const int esize = static_cast<int>(sizeof(T));
  const bool vec_x = cin % L::kX == 0 && aligned(x, L::kX * esize);
  const bool vec_d = cout % NT == 0 && aligned(dout, NT * esize);
  wgrad_kernel<P, MT, NT><<<grid, kWarps * 32, L::kBytes, stream>>>(
      x, cin, pairs, offsets, rows, taps, tiles, dout, cout, chunks, partial, round_out, vec_x,
      vec_d);
  return static_cast<int>(cudaGetLastError());
}

template <Product P>
int launch(const typename Traits<P>::T* x, int n_rows, int cin, const int32_t* idx, int rows,
           int taps, const int32_t* perm, const int64_t* key, const typename Traits<P>::T* dout,
           int cout, int mt, int nt, int chunks, int32_t* counts, int2* pairs, float* partial,
           float* out, cudaStream_t stream) {
  if (taps < 1 || taps > 32 || (mt != 1 && mt != 2) || (nt != 2 && nt != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_out = static_cast<int64_t>(taps) * cin * cout;
  if (n_out == 0) return static_cast<int>(cudaSuccess);
  const int tiles = (rows + kTileRows - 1) / kTileRows;
  if (tiles == 0) return static_cast<int>(cudaMemsetAsync(out, 0, n_out * sizeof(float), stream));
  if (chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool whole = chunks == 1;   // the blocks' sums are dW
  if (whole) partial = out;
  const bool round_out = P == Product::kBf16;

  const int row_blocks = (rows + 255) / 256;
  pair_counts_kernel<<<row_blocks, 256, 0, stream>>>(key, rows, taps, tiles, counts);
  pair_offsets_kernel<<<taps, 1024, 0, stream>>>(counts, tiles);
  pair_scatter_kernel<<<row_blocks, 256, 0, stream>>>(key, perm, idx, rows, taps, n_rows, tiles,
                                                       counts, pairs);
  const dim3 grid(chunks, taps,
                  ((cin + 16 * mt - 1) / (16 * mt)) * ((cout + 8 * nt - 1) / (8 * nt)));
  const bool r = whole && round_out;
  int err;
  if (mt == 1 && nt == 2)
    err = launch_tiles<P, 1, 2>(grid, x, cin, pairs, counts, rows, taps, tiles, dout, cout,
                                chunks, partial, r, stream);
  else if (mt == 1)
    err = launch_tiles<P, 1, 4>(grid, x, cin, pairs, counts, rows, taps, tiles, dout, cout,
                                chunks, partial, r, stream);
  else if (nt == 2)
    err = launch_tiles<P, 2, 2>(grid, x, cin, pairs, counts, rows, taps, tiles, dout, cout,
                                chunks, partial, r, stream);
  else
    err = launch_tiles<P, 2, 4>(grid, x, cin, pairs, counts, rows, taps, tiles, dout, cout,
                                chunks, partial, r, stream);
  if (err != 0 || whole) return err;
  const int threads = 256;
  const int64_t blocks = (n_out + threads - 1) / threads;
  sum_partials_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      partial, chunks, n_out, out, round_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// perm, key: idx's TapOrder (rows in order, their sorted absent-tap keys);
// mt, nt: the dW tile (16mt channels x 8nt columns, mt 1 or 2, nt 2 or 4)
// and chunks (>= 1): the K split, both from ops/sparse_conv.py
// wgrad_split; scratch: counts taps * (ceil(rows / 16) + 1) int32, pairs
// taps * rows int2, partial (chunks, taps, cin, cout) f32, unused (may be
// null) with one chunk.
extern "C" int ms3d_gather_wgrad(const float* x, int n_rows, int cin, const int32_t* idx,
                                 int rows, int taps, const int32_t* perm, const int64_t* key,
                                 const float* dout, int cout, int mt, int nt, int chunks,
                                 int32_t* counts, int2* pairs, float* partial, float* out,
                                 cudaStream_t stream) {
  return launch<Product::kTf32x6>(x, n_rows, cin, idx, rows, taps, perm, key, dout, cout, mt,
                                  nt, chunks, counts, pairs, partial, out, stream);
}

// bf16 x and dout; out (f32) holds the total rounded once to bf16
extern "C" int ms3d_gather_wgrad_bf16(const __nv_bfloat16* x, int n_rows, int cin,
                                      const int32_t* idx, int rows, int taps,
                                      const int32_t* perm, const int64_t* key,
                                      const __nv_bfloat16* dout, int cout, int mt, int nt,
                                      int chunks, int32_t* counts, int2* pairs, float* partial,
                                      float* out, cudaStream_t stream) {
  return launch<Product::kBf16>(x, n_rows, cin, idx, rows, taps, perm, key, dout, cout, mt, nt,
                                chunks, counts, pairs, partial, out, stream);
}
