// K6 segment_reduce: per-segment sum, max or min over the rows of a CSR.
//
//   perm    (R,) row ids sorted stably by segment; the first offsets[S]
//           are the live rows (rows of the padding segment S come last
//           and are never reduced);
//   seg     (R,) int64 segment of every row (S for the padding);
//   offsets (S+1,) segment s owns perm[offsets[s] : offsets[s+1]];
//   out[s, c] = x[r0, c] op x[r1, c] op ...   over s's rows in row order.
//
// sum (f32): (((+0.0 + x[r0]) + x[r1]) + ...) with __fadd_rn, the order of
// XLA:CPU's scatter-add and of torch's CPU index_add_, so the card's sums
// equal the CPU's bit for bit and repeat from run to run (no atomics). A
// bf16 sum rounds after every add, in row order: widen, add in f32 with
// __fadd_rn, round with __float2bfloat16_rn (XLA:CPU's bf16 scatter-add,
// the transpose of every bf16 row gather of the JAX package's bf16 train
// step). Such a chain cannot be split: (p1 + p2) is not ((p1 + x3) + x4).
// max/min (f32, int32, bf16) keep the first extreme in row order under a
// strict compare (-0.0 and +0.0 tie) and propagate NaN (the last NaN in
// row order); that operator is associative, so a segment may be cut into
// pieces combined in piece order. An int32 sum is associative too. An
// empty segment reads `fill` (a sum reads +0.0).
//
// Replaces the float scatter-adds and scatter-max/min of
// minsu3d_tpu/ops/cluster.py:230 (_unit_table), minsu3d_tpu/ops/segment.py:
// 40-72 (sec_mean/sec_min/sec_max/roipool), the per-cluster centers and
// class/batch max of minsu3d_tpu/model/hais.py:31, and the transpose of
// every row gather (gather_rows' backward).
//
// What bounds it on an H100: one read of each live row and of its perm
// entry, one write of (S, C): bytes, a few microseconds at most. What the
// design has to get round is latency: a perm-indirect gather per row and,
// for a sum, a chain of dependent adds as long as the segment. Segments
// are classified on the card from `offsets` (no count goes to the host),
// and every call is one launch (an f32/bf16 sum) or two, whatever the data:
//   short   (<= kShort rows, every op): one thread a (segment, channel),
//           lanes in groups of the least power of two >= C, a group a
//           segment, so a warp covers 32 / 4 = 8 units of the unit table
//           (C = 4) and a wide row one warp; each thread starts its rows'
//           loads 4 (8 for max and min) at a time, then adds (an empty
//           segment and one row, most of a gather's transpose, take short
//           paths).
//   ordered (longer f32/bf16 sums, in the same launch): the segments that
//           start in a span of kSpan sorted positions go to that span's
//           block (most spans hold none, and their blocks leave at once);
//           warps 1-7 stage the rows (perm-gathered, 16-byte cp.async where
//           the rows allow it) into shared memory, two buffers of 12 KB,
//           while warp 0, one lane a channel, runs the chain out of shared
//           memory, so the chain never waits on a device-memory gather.
//           Floor: the longest segment's length times one dependent add.
//           The launch keeps to 32 registers a thread and 24 KB a block, so
//           that its short blocks still fill every SM.
//   chunks  (longer, order-free ops): the sorted positions are cut into
//           chunks of kChunk, one warp a chunk; the warp reduces every long
//           segment's piece in its chunk (lanes over row blocks and
//           channels, each row block in row order, then a shuffle tree
//           that keeps the earlier operand on the left). A segment inside
//           one chunk is written out; the pieces of one that crosses a
//           chunk boundary go to a scratch slot (its head piece or its
//           tail piece), and the combine launch, at the chunk where the
//           segment ends, folds them in chunk order. No float atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kShort = 32;     // rows: the longest segment a (segment, channel) thread folds
constexpr int kChunk = 32;     // sorted positions of an order-free chunk (one warp)
constexpr int kSpan = kThreads;  // sorted positions whose long sums one block runs
constexpr int kStageBytes = 12288;  // one of a span block's two staging buffers

enum Op { kSum = 0, kMax = 1, kMin = 2 };

template <typename T, int OP>
__device__ __forceinline__ T combine(T acc, T v);

template <>
__device__ __forceinline__ float combine<float, kSum>(float acc, float v) {
  return __fadd_rn(acc, v);
}
// a NaN row makes the segment's max/min NaN, as torch.maximum/minimum and
// the JAX segment_max/min propagate it (a NaN acc stays unless v is NaN)
template <>
__device__ __forceinline__ float combine<float, kMax>(float acc, float v) {
  return (v > acc || v != v) ? v : acc;
}
template <>
__device__ __forceinline__ float combine<float, kMin>(float acc, float v) {
  return (v < acc || v != v) ? v : acc;
}
// bf16 compares in f32, which orders bf16 values exactly
template <>
__device__ __forceinline__ __nv_bfloat16 combine<__nv_bfloat16, kMax>(__nv_bfloat16 acc,
                                                                      __nv_bfloat16 v) {
  const float a = __bfloat162float(acc), b = __bfloat162float(v);
  return (b > a || b != b) ? v : acc;
}
template <>
__device__ __forceinline__ __nv_bfloat16 combine<__nv_bfloat16, kMin>(__nv_bfloat16 acc,
                                                                      __nv_bfloat16 v) {
  const float a = __bfloat162float(acc), b = __bfloat162float(v);
  return (b < a || b != b) ? v : acc;
}
// bf16 sum: one rounding per add, as XLA:CPU's bf16 scatter-add
template <>
__device__ __forceinline__ __nv_bfloat16 combine<__nv_bfloat16, kSum>(__nv_bfloat16 acc,
                                                                      __nv_bfloat16 v) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(acc), __bfloat162float(v)));
}
template <>
__device__ __forceinline__ int32_t combine<int32_t, kSum>(int32_t acc, int32_t v) {
  return acc + v;
}
template <>
__device__ __forceinline__ int32_t combine<int32_t, kMax>(int32_t acc, int32_t v) {
  return v > acc ? v : acc;
}
template <>
__device__ __forceinline__ int32_t combine<int32_t, kMin>(int32_t acc, int32_t v) {
  return v < acc ? v : acc;
}

template <typename T>
__device__ __forceinline__ T zero() {
  return T(0);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ float shfl_down(float v, int d) {
  return __shfl_down_sync(0xffffffffu, v, d);
}
__device__ __forceinline__ int32_t shfl_down(int32_t v, int d) {
  return __shfl_down_sync(0xffffffffu, v, d);
}
__device__ __forceinline__ __nv_bfloat16 shfl_down(__nv_bfloat16 v, int d) {
  const unsigned u = __shfl_down_sync(0xffffffffu, unsigned(__bfloat16_as_ushort(v)), d);
  return __ushort_as_bfloat16(static_cast<unsigned short>(u));
}
__device__ __forceinline__ float shfl0(float v) { return __shfl_sync(0xffffffffu, v, 0); }
__device__ __forceinline__ int32_t shfl0(int32_t v) { return __shfl_sync(0xffffffffu, v, 0); }
__device__ __forceinline__ __nv_bfloat16 shfl0(__nv_bfloat16 v) {
  const unsigned u = __shfl_sync(0xffffffffu, unsigned(__bfloat16_as_ushort(v)), 0);
  return __ushort_as_bfloat16(static_cast<unsigned short>(u));
}

// Order-preserving combine of (value, has-value) pairs held by lanes
// lane, lane + stride, lane + 2 stride, ... (n of them, in order): after
// it, the lanes of block index 0 (lane < stride) hold the fold of all n.
// Every lane of the warp must call it.
template <typename T, int OP>
__device__ __forceinline__ void ordered_tree(T& acc, bool& has, int stride, int n) {
  const int lane = threadIdx.x & 31;
  const int idx = lane / stride;
  for (int d = 1; d < n; d <<= 1) {
    const T o = shfl_down(acc, d * stride);
    const bool oh = __shfl_down_sync(0xffffffffu, has, d * stride);
    if (idx < n && idx % (2 * d) == 0 && idx + d < n && oh) {
      acc = has ? combine<T, OP>(acc, o) : o;
      has = true;
    }
  }
}

// -- short segments: one thread a (segment, channel) ------------------------
// Fold n <= N rows from beg into acc (has: acc holds a value): every load
// in flight, then the chain.
template <typename T, int OP, int N>
__device__ __forceinline__ void fold_rows(T& acc, bool& has, const T* __restrict__ x, int c_dim,
                                          int c, const int32_t* __restrict__ perm, int beg,
                                          int n) {
  int32_t p[N];
  T v[N];
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (k < n) p[k] = perm[beg + k];
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (k < n) v[k] = x[static_cast<int64_t>(p[k]) * c_dim + c];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k < n) {
      acc = has ? combine<T, OP>(acc, v[k]) : v[k];
      has = true;
    }
  }
}

// Lanes in groups of 2^gs_log (the least power of two >= C, at most 32), a
// group a segment, a lane a channel (and every 32nd past 32): a warp
// covers 32 >> gs_log narrow segments. Empty segments and single rows
// (most of a gather's transpose) take short paths; longer ones fold BATCH
// rows' loads at a time.
template <typename T, int OP, int BATCH>
__device__ void short_group(const T* __restrict__ x, int c_dim, int gs_log,
                            const int32_t* __restrict__ perm,
                            const int32_t* __restrict__ offsets, int n_seg, T fill,
                            T* __restrict__ out, int warp_id) {
  const int lane = threadIdx.x & 31;
  const int seg = (warp_id << (5 - gs_log)) + (lane >> gs_log);
  if (seg >= n_seg) return;
  const int beg = offsets[seg], len = offsets[seg + 1] - beg;
  if (len > kShort) return;
  const int step = 1 << gs_log;
  T* const o = out + static_cast<int64_t>(seg) * c_dim;
  int c = lane & (step - 1);
  if (len == 0) {   // a sum reads +0.0, as the scatter's zeros; a max/min fill
    const T v = OP == kSum ? zero<T>() : fill;
    for (; c < c_dim; c += step) o[c] = v;
    return;
  }
  if (len == 1) {
    const T* const row = x + static_cast<int64_t>(perm[beg]) * c_dim;
    for (; c < c_dim; c += step) o[c] = OP == kSum ? combine<T, kSum>(zero<T>(), row[c]) : row[c];
    return;
  }
  for (; c < c_dim; c += step) {
    T acc = OP == kSum ? zero<T>() : fill;
    bool has = OP == kSum;
    if (len == 2) {
      fold_rows<T, OP, 2>(acc, has, x, c_dim, c, perm, beg, 2);
    } else {
      for (int k = 0; k < len; k += BATCH)   // BATCH rows' loads in flight, then their adds
        fold_rows<T, OP, BATCH>(acc, has, x, c_dim, c, perm, beg + k, min(BATCH, len - k));
    }
    o[c] = acc;
  }
}

// -- order-free long segments: one warp a chunk of sorted positions --------
// part: (2, C, n_chunks) pieces, slot 0 the piece of a segment that began
// before the chunk, slot 1 that of one that begins in it and runs past it.
template <typename T, int OP>
__device__ void chunk_warp(const T* __restrict__ x, int c_dim, const int32_t* __restrict__ perm,
                           const int64_t* __restrict__ seg_of_row,
                           const int32_t* __restrict__ offsets, int n_seg,
                           T* __restrict__ out, T* __restrict__ part, int n_chunks, int chunk) {
  constexpr int kPer = kChunk / 32;
  const int lane = threadIdx.x & 31;
  const int n_live = offsets[n_seg];
  const int p0 = chunk * kChunk;
  if (p0 >= n_live) return;   // warp-uniform
  const int p1 = min(p0 + kChunk, n_live);
  // the segment at every position of the chunk; a position opens a piece
  // where its segment differs from the previous position's (the chunk's
  // first position always does)
  int row[kPer], s[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int q = p0 + 32 * i + lane;
    row[i] = q < p1 ? perm[q] : -1;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) s[i] = row[i] >= 0 ? static_cast<int>(seg_of_row[row[i]]) : -1;
  unsigned opens[kPer];
  int beg[kPer], end[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    int prev = __shfl_up_sync(0xffffffffu, s[i], 1);
    const int last = __shfl_sync(0xffffffffu, i > 0 ? s[i - 1] : -1, 31);
    if (lane == 0) prev = i > 0 ? last : -1;
    const bool open = s[i] >= 0 && s[i] != prev;
    beg[i] = open ? offsets[s[i]] : 0;
    end[i] = open ? offsets[s[i] + 1] : 0;
    opens[i] = __ballot_sync(0xffffffffu, open && end[i] - beg[i] > kShort);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    unsigned mask = opens[i];
    while (mask) {
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      const int sg = __shfl_sync(0xffffffffu, s[i], src);
      const int b = __shfl_sync(0xffffffffu, beg[i], src);
      const int e = __shfl_sync(0xffffffffu, end[i], src);
      const int a0 = max(b, p0), a1 = min(e, p1), n = a1 - a0;
      const bool inside = b >= p0 && e <= p1;
      const int slot = b < p0 ? 0 : 1;
      for (int c0 = 0; c0 < c_dim; c0 += 32) {
        const int cw = min(32, c_dim - c0);
        const int nb = 32 / cw;            // row blocks, each a contiguous run of rows
        const int bi = lane / cw, c = c0 + lane % cw;
        int r = 0, r1 = 0;
        if (bi < nb) {
          r = a0 + static_cast<int>(static_cast<int64_t>(n) * bi / nb);
          r1 = a0 + static_cast<int>(static_cast<int64_t>(n) * (bi + 1) / nb);
        }
        bool has = r < r1;
        T acc = zero<T>();
        if (has) acc = x[static_cast<int64_t>(perm[r++]) * c_dim + c];
        for (; r + 8 <= r1; r += 8) {
          int pr[8];
          T v[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) pr[k] = perm[r + k];
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k] = x[static_cast<int64_t>(pr[k]) * c_dim + c];
#pragma unroll
          for (int k = 0; k < 8; ++k) acc = combine<T, OP>(acc, v[k]);
        }
        for (; r < r1; ++r) acc = combine<T, OP>(acc, x[static_cast<int64_t>(perm[r]) * c_dim + c]);
        ordered_tree<T, OP>(acc, has, cw, nb);
        if (lane < cw) {
          if (inside) {
            out[static_cast<int64_t>(sg) * c_dim + c] = acc;
          } else {
            part[(static_cast<int64_t>(slot) * c_dim + c) * n_chunks + chunk] = acc;
          }
        }
      }
    }
  }
}

// Second launch: a warp a chunk finds whether a long segment that crossed
// a chunk boundary ends in it; then the block, a warp a channel, folds the
// pieces of each such segment of its kWarps chunks in chunk order (the
// first chunk's slot 1, then slot 0 of every later one).
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads) combine_kernel(
    const int32_t* __restrict__ perm, const int64_t* __restrict__ seg_of_row,
    const int32_t* __restrict__ offsets, int n_seg, int c_dim, const T* __restrict__ part,
    int n_chunks, T* __restrict__ out) {
  __shared__ int s_seg[kWarps], s_k0[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = blockIdx.x * kWarps + warp;
  const int n_live = offsets[n_seg];
  int found = -1, first = 0;
  if (k < n_chunks && k * kChunk < n_live) {
    const int p0 = k * kChunk;
    const int sg = static_cast<int>(seg_of_row[perm[p0]]);
    const int b = offsets[sg], e = offsets[sg + 1];
    if (b < p0 && e <= p0 + kChunk && e - b > kShort) {
      found = sg;
      first = b / kChunk;
    }
  }
  if (lane == 0) {
    s_seg[warp] = found;
    s_k0[warp] = first;
  }
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {
    const int sg = s_seg[w];
    if (sg < 0) continue;   // block-uniform
    const int k1 = blockIdx.x * kWarps + w, k0 = s_k0[w];
    for (int c = warp; c < c_dim; c += kWarps) {
      const T* tail = part + (static_cast<int64_t>(c_dim) + c) * n_chunks;   // slot 1
      const T* head = part + static_cast<int64_t>(c) * n_chunks;            // slot 0
      T acc = tail[k0];
      for (int j0 = k0 + 1; j0 <= k1; j0 += 32) {
        const int j = j0 + lane;
        bool has = j <= k1;
        T v = has ? head[j] : zero<T>();
        ordered_tree<T, OP>(v, has, 1, 32);
        acc = combine<T, OP>(acc, shfl0(v));
      }
      if (lane == 0) out[static_cast<int64_t>(sg) * c_dim + c] = acc;
    }
  }
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy units of BYTES (a row slice's cw elements of T are a whole number
// of them) of rows [r0, r0 + n) x channels [c0, c0 + cw) of the sorted rows
// into buf, row-major, cw wide; BYTES 0: plain loads of single elements.
template <typename T, int BYTES>
__device__ __forceinline__ void stage_units(T* buf, const T* __restrict__ x, int c_dim,
                                            const int32_t* __restrict__ perm, int r0, int n,
                                            int c0, int cw, int t, int nt) {
  if constexpr (BYTES == 0) {
    for (int e = t; e < n * cw; e += nt) {
      const int i = e / cw, j = e - i * cw;
      buf[e] = x[static_cast<int64_t>(perm[r0 + i]) * c_dim + c0 + j];
    }
  } else {
    const int uw = cw * static_cast<int>(sizeof(T)) / BYTES;   // units a row
    for (int e = t; e < n * uw; e += nt) {
      const int i = e / uw, j = e - i * uw;
      const char* src = reinterpret_cast<const char*>(x + static_cast<int64_t>(perm[r0 + i]) *
                                                              c_dim + c0);
      cp_async<BYTES>(reinterpret_cast<char*>(buf) + static_cast<int64_t>(e) * BYTES,
                      src + j * BYTES);
    }
  }
}

// Stage rows [r0, r0 + n) x channels [c0, c0 + cw) into buf: 16-byte
// cp.async where the rows allow it (unit 16), else 4-byte (unit 4: every
// f32 row, even bf16 rows), else plain loads (unit 0). Threads t0, t0 + 1,
// ... of the block (`nt` of them) start the copies.
template <typename T>
__device__ void stage(T* buf, const T* __restrict__ x, int c_dim,
                      const int32_t* __restrict__ perm, int r0, int n, int c0, int cw,
                      int unit, int t0, int nt) {
  const int t = threadIdx.x - t0;
  if (t >= 0) {
    if (unit == 16) {
      stage_units<T, 16>(buf, x, c_dim, perm, r0, n, c0, cw, t, nt);
    } else if (unit == 4) {
      stage_units<T, 4>(buf, x, c_dim, perm, r0, n, c0, cw, t, nt);
    } else {
      stage_units<T, 0>(buf, x, c_dim, perm, r0, n, c0, cw, t, nt);
    }
  }
  cp_async_commit();
}

// -- ordered long sums: a block a span of sorted positions ----------------
// The long segments that start in span `span` (kSpan sorted positions) go
// to its block: two staging buffers of kStageBytes in shared memory, so a
// tile holds kStageBytes / (C * sizeof(T)) rows (1024 f32 rows of 3
// channels). Where the chains take one warp (C <= 32), the other warps
// stage while it runs the chain of the tile before.
template <typename T>
__device__ void span_block(const T* __restrict__ x, int c_dim, const int32_t* __restrict__ perm,
                           const int64_t* __restrict__ seg_of_row,
                           const int32_t* __restrict__ offsets, int n_seg, T* __restrict__ out,
                           int span, int unit) {
  constexpr int kStage = kStageBytes / static_cast<int>(sizeof(T));   // elements a buffer
  __shared__ __align__(16) unsigned char raw[2 * kStageBytes];
  __shared__ unsigned s_mask[kWarps];
  T* const buf = reinterpret_cast<T*>(raw);   // buffer t & 1 at buf + (t & 1) * kStage
  const int n_live = offsets[n_seg];
  const int p0 = span * kSpan;
  if (p0 >= n_live) return;   // block-uniform
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = p0 + tid;
  int len = 0;
  if (q < n_live) {
    const int sq = static_cast<int>(seg_of_row[perm[q]]);
    const int prev = q > 0 ? static_cast<int>(seg_of_row[perm[q - 1]]) : -1;
    if (sq != prev) len = offsets[sq + 1] - q;   // sq begins at q
  }
  const unsigned m = __ballot_sync(0xffffffffu, len > kShort);
  if (lane == 0) s_mask[warp] = m;
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {
    unsigned mask = s_mask[w];
    while (mask) {
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      const int b = p0 + 32 * w + src;
      const int sg = static_cast<int>(seg_of_row[perm[b]]);
      const int e = offsets[sg + 1];
      for (int c0 = 0; c0 < c_dim; c0 += kThreads) {
        const int cw = min(kThreads, c_dim - c0);
        const int rows = kStage / cw;
        const int t0 = cw <= 32 ? 32 : 0;   // warp 0 chains, the others stage
        T acc = zero<T>();
        int t = 0;
        stage<T>(buf, x, c_dim, perm, b, min(rows, e - b), c0, cw, unit, t0, kThreads - t0);
        for (int r = b; r < e; r += rows, ++t) {
          const int n = min(rows, e - r);
          if (r + rows < e) {
            stage<T>(buf + ((t + 1) & 1) * kStage, x, c_dim, perm, r + rows,
                     min(rows, e - r - rows), c0, cw, unit, t0, kThreads - t0);
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          __syncthreads();
          if (tid < cw) {
            const T* src_buf = buf + (t & 1) * kStage + tid;
#pragma unroll 16
            for (int i = 0; i < n; ++i) acc = combine<T, kSum>(acc, src_buf[i * cw]);
          }
          __syncthreads();   // the buffer is staged again two tiles on
        }
        if (tid < cw) out[static_cast<int64_t>(sg) * c_dim + c0 + tid] = acc;
      }
    }
  }
}

// An ordered sum's one launch: blocks [0, n_span) the spans' long
// segments, the rest the short (segment, channel) groups; at most 32
// registers a thread and 24 KB of shared memory a block, so that every SM
// holds 2048 threads of the latency-bound short gathers (a gather's
// transpose has up to a million segments).
template <typename T>
__global__ void __launch_bounds__(kThreads, 8) sum_kernel(
    const T* __restrict__ x, int c_dim, int gs_log, const int32_t* __restrict__ perm,
    const int64_t* __restrict__ seg_of_row, const int32_t* __restrict__ offsets, int n_seg,
    T* __restrict__ out, int n_span, int unit) {
  if (static_cast<int>(blockIdx.x) < n_span) {
    span_block<T>(x, c_dim, perm, seg_of_row, offsets, n_seg, out, blockIdx.x, unit);
    return;
  }
  const int warp_id = (blockIdx.x - n_span) * kWarps + (threadIdx.x >> 5);
  short_group<T, kSum, 4>(x, c_dim, gs_log, perm, offsets, n_seg, zero<T>(), out, warp_id);
}

// An order-free op's first launch: blocks [0, n_chunk_blocks) run the
// chunk warps, the rest the short (segment, channel) groups.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads) chunk_short_kernel(
    const T* __restrict__ x, int c_dim, int gs_log, const int32_t* __restrict__ perm,
    const int64_t* __restrict__ seg_of_row, const int32_t* __restrict__ offsets, int n_seg,
    T fill, T* __restrict__ out, T* __restrict__ part, int n_chunks, int n_chunk_blocks) {
  if (static_cast<int>(blockIdx.x) < n_chunk_blocks) {
    const int chunk = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (chunk < n_chunks)
      chunk_warp<T, OP>(x, c_dim, perm, seg_of_row, offsets, n_seg, out, part, n_chunks, chunk);
    return;
  }
  const int warp_id = (blockIdx.x - n_chunk_blocks) * kWarps + (threadIdx.x >> 5);
  short_group<T, OP, 8>(x, c_dim, gs_log, perm, offsets, n_seg, fill, out, warp_id);
}

// The scratch bytes of a call: the chunks' two pieces of C values for an
// order-free op, none for an ordered sum. The wrapper's _scratch_bytes
// mirrors it.
int64_t scratch_bytes(int64_t rows, int c_dim, bool ordered, int elem) {
  return ordered ? 0 : 2 * ((rows + kChunk - 1) / kChunk) * c_dim * elem;
}

// Device operations enqueued (memsets and kernel launches), for the tests'
// count of a call's launches.
int64_t g_device_ops = 0;

template <typename T, int OP>
int launch_op(const T* x, int64_t rows, int c_dim, const int32_t* perm, const int64_t* seg,
              const int32_t* offsets, int n_seg, T fill, T* out, void* scratch,
              int64_t scratch_len, cudaStream_t stream) {
  constexpr bool ordered = OP == kSum && !std::is_same<T, int32_t>::value;
  if (scratch_len < scratch_bytes(rows, c_dim, ordered, sizeof(T))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int gs_log = 0;
  while (gs_log < 5 && (1 << gs_log) < c_dim) ++gs_log;
  const int64_t n_chunks = (rows + kChunk - 1) / kChunk;
  const int64_t seg_warps = ((static_cast<int64_t>(n_seg) << gs_log) + 31) / 32;
  const int64_t n_short = (seg_warps + kWarps - 1) / kWarps;
  const int64_t n_chunk_blocks = (n_chunks + kWarps - 1) / kWarps;
  // warp and segment numbers are int32 in the kernels
  if ((seg_warps + kWarps) * 32 > INT32_MAX || n_short + n_chunks > INT32_MAX / kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if constexpr (ordered) {
    // the largest copy unit that every row's bytes and the base's alignment allow
    const int64_t row_bytes = static_cast<int64_t>(c_dim) * sizeof(T);
    const uintptr_t base = reinterpret_cast<uintptr_t>(x);
    const int unit = row_bytes % 16 == 0 && base % 16 == 0 ? 16
                     : row_bytes % 4 == 0 && base % 4 == 0 ? 4 : 0;
    const int64_t n_span = (rows + kSpan - 1) / kSpan;
    sum_kernel<T><<<static_cast<int>(n_span + n_short), kThreads, 0, stream>>>(
        x, c_dim, gs_log, perm, seg, offsets, n_seg, out, static_cast<int>(n_span), unit);
    err = cudaGetLastError();
  } else {
    T* part = static_cast<T*>(scratch);
    chunk_short_kernel<T, OP><<<static_cast<int>(n_chunk_blocks + n_short), kThreads, 0,
                                stream>>>(x, c_dim, gs_log, perm, seg, offsets, n_seg, fill,
                                          out, part, static_cast<int>(n_chunks),
                                          static_cast<int>(n_chunk_blocks));
    err = cudaGetLastError();
    if (err != cudaSuccess || rows == 0) return static_cast<int>(err);
    ++g_device_ops;
    combine_kernel<T, OP><<<static_cast<int>(n_chunk_blocks), kThreads, 0, stream>>>(
        perm, seg, offsets, n_seg, c_dim, part, static_cast<int>(n_chunks), out);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) ++g_device_ops;
  return static_cast<int>(err);
}

template <typename T>
int launch(const T* x, int64_t rows, int c_dim, const int32_t* perm, const int64_t* seg,
           const int32_t* offsets, int n_seg, int op, T fill, T* out, void* scratch,
           int64_t scratch_len, cudaStream_t stream) {
  if (n_seg <= 0 || c_dim <= 0) return static_cast<int>(cudaSuccess);
  if (rows < 0 || rows > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  switch (op) {
    case kSum:
      return launch_op<T, kSum>(x, rows, c_dim, perm, seg, offsets, n_seg, fill, out, scratch,
                                scratch_len, stream);
    case kMax:
      return launch_op<T, kMax>(x, rows, c_dim, perm, seg, offsets, n_seg, fill, out, scratch,
                                scratch_len, stream);
    case kMin:
      return launch_op<T, kMin>(x, rows, c_dim, perm, seg, offsets, n_seg, fill, out, scratch,
                                scratch_len, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (rows, c_dim) row-major; perm (rows,), seg (rows,) int64 and offsets
// (n_seg + 1,) of the CSR; out (n_seg, c_dim); op 0 sum, 1 max, 2 min.
// scratch: scratch_len >= scratch_bytes(rows, c_dim, ...) bytes. On
// `stream`: an f32/bf16 sum is one launch; max, min and an int32 sum two
// (one when rows is 0), the short segments with the chunks, then the
// chunks' combine.
extern "C" int ms3d_segment_reduce_f32(const float* x, int64_t rows, int c_dim,
                                       const int32_t* perm, const int64_t* seg,
                                       const int32_t* offsets, int n_seg, int op, float fill,
                                       float* out, void* scratch, int64_t scratch_len,
                                       cudaStream_t stream) {
  return launch<float>(x, rows, c_dim, perm, seg, offsets, n_seg, op, fill, out, scratch,
                       scratch_len, stream);
}

extern "C" int ms3d_segment_reduce_i32(const int32_t* x, int64_t rows, int c_dim,
                                       const int32_t* perm, const int64_t* seg,
                                       const int32_t* offsets, int n_seg, int op, int32_t fill,
                                       int32_t* out, void* scratch, int64_t scratch_len,
                                       cudaStream_t stream) {
  return launch<int32_t>(x, rows, c_dim, perm, seg, offsets, n_seg, op, fill, out, scratch,
                         scratch_len, stream);
}

// bf16 rows: sum (op 0, rounded after every add), max (op 1), min (op 2)
extern "C" int ms3d_segment_reduce_bf16(const __nv_bfloat16* x, int64_t rows, int c_dim,
                                        const int32_t* perm, const int64_t* seg,
                                        const int32_t* offsets, int n_seg, int op, float fill,
                                        __nv_bfloat16* out, void* scratch,
                                        int64_t scratch_len, cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, rows, c_dim, perm, seg, offsets, n_seg, op,
                               __float2bfloat16_rn(fill), out, scratch, scratch_len, stream);
}

// Memsets and kernel launches that K6's entry points have enqueued so far.
extern "C" int64_t ms3d_segment_reduce_device_ops() { return g_device_ops; }
