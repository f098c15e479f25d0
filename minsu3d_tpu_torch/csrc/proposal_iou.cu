// K5 proposal_iou: the (P, I) IoU between proposals and ground-truth
// instances, from proposal membership rows.
//
//   psize[p]    = #{r : valid[r], keep[r], prop_id[r] = p}
//   inter[p, i] = #{r : valid[r], keep[r], prop_id[r] = p, inst[point_idx[r]] = i, 0 <= i < I}
//   iou[p, i]   = inter / (psize[p] + inst_num_point[i] - inter + 1e-5)
//
// keep is the optional row mask (row_keep; null counts every row): HAIS's and
// SoftGroup's mask-filtered IoU, whose rows count only where the row's mask
// sigmoid is above 0.5.
//
// Replaces the one-hot scatter-adds and the elementwise IoU of
// minsu3d_tpu/ops/instance_iou.py:35 (get_iou; row_weights, 0/1 in every
// caller, as row_keep) and :27 (proposal_sizes). The counts are integers,
// so they are exact in any order and split over blocks exactly: the result
// is deterministic and equal, bit for bit, to the plain version, which adds
// 1.0s in f32 (exact below 2^24) and then evaluates the same f32 expression
// in the same order. The f32 operations are written as
// __fadd_rn/__fsub_rn/__fdiv_rn so that nvcc cannot contract or approximate
// them.
//
// What bounds it on an H100: bytes, one read of the R rows (point_idx and
// prop_id as the heads hold them, int64; valid and keep; one gathered
// instance id per counted row) and a (P, I) write, at 3.35 TB/s: ~0.2-0.3
// microseconds at the training shapes. The time is latency and contention:
// a proposal covers ~1500 rows and a few instances, so one global atomic a
// row queues thousands of adds on a few addresses. So a call is one
// cooperative launch (a block an SM, every block resident; grid_sync of
// grid_sync.cuh on a __device__ word pair; no memset, no cast):
//   0  the grid zeroes the (P, I + 1) int32 global histogram (scratch from
//      the caller's allocator);
//   A  each block counts a contiguous chunk of rows into a (P, I + 1) int32
//      histogram in shared memory; column I holds the counted rows whose
//      instance lies outside [0, I), so psize is a row's sum. This phase is
//      two dependent round trips to memory (a row's fields, then its
//      point's instance): every row's fields are loaded before any is
//      tested, and the histogram is zeroed while they are in flight
//      (count_rows). Consecutive
//      rows mostly share (p, i) (the heads write a proposal's rows
//      together), so a warp's equal keys are summed by __match_any_sync
//      before one shared atomic; any order of the rows gives the same
//      counts. Where P x (I + 1) does not fit a block's shared memory, the
//      blocks split into proposal ranges, each range's blocks over all the
//      rows, so every (p, i) is still counted once;
//   B  after the first barrier each block adds its nonzero bins to the
//      global histogram (integer atomics);
//   C  after the second barrier a warp a proposal sums its row (psize) and
//      writes its I IoUs once (the instance sizes staged in shared memory
//      before the barrier).
// Rows are int64, as the heads write them; the instance ids and sizes are
// read in the caller's dtypes (int16, int32 or int64, ids.cuh).

#include <cuda_runtime.h>

#include <cstdint>

#include "grid_sync.cuh"
#include "ids.cuh"

namespace {

using ms3d::at;
using ms3d::grid_sync;
using ms3d::Ints;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // rows a thread loads before it counts them

__device__ uint32_t g_bar[2];  // the grid barrier: zero at load, zero after each use

struct Args {
  const long long* point_idx;  // (rows,)
  const long long* prop_id;    // (rows,)
  const unsigned char* valid;  // (rows,) bool
  const unsigned char* keep;   // (rows,) bool, or null: every row
  Ints inst;                   // (n_points,)
  Ints inst_num;               // (i_cap,)
  int64_t rows, n_points;
  int p_cap, i_cap;
  int p_range, n_ranges;       // proposals a block's histogram holds; ranges
  int32_t* hist;               // (p_cap, i_cap + 1) scratch
  float* iou;                  // (p_cap, i_cap)
};

// Rows [lo, hi) into the shared histogram of proposals [p_lo, p_lo + p_n)
// (cols bins a proposal). The time is two dependent round trips to memory
// (the row's fields, then its point's instance), so every row's fields are
// loaded before any of them is tested, and the histogram is zeroed while
// those loads are in flight.
__device__ __forceinline__ void count_rows(const Args& a, int64_t lo, int64_t hi, int p_lo,
                                           int p_n, int* s_hist) {
  const int lane = threadIdx.x & 31;
  const int cols = a.i_cap + 1;
  if (lo >= hi) {  // no row: the histogram stays zero
    for (int e = threadIdx.x; e < p_n * cols; e += kThreads) s_hist[e] = 0;
    return;
  }
  bool zeroed = false;
  for (int64_t base = lo; base < hi; base += kUnroll * kThreads) {
    bool ok[kUnroll];
    int64_t p[kUnroll], pt[kUnroll], in[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t r = base + j * kThreads + threadIdx.x;
      const int64_t rr = r < hi ? r : lo;  // an address to load; the row counts only below hi
      ok[j] = r < hi && __ldg(a.valid + rr) != 0 && (a.keep == nullptr || __ldg(a.keep + rr) != 0);
      p[j] = __ldg(a.prop_id + rr) - p_lo;
      pt[j] = __ldg(a.point_idx + rr);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      ok[j] = ok[j] && p[j] >= 0 && p[j] < p_n;
      in[j] = ok[j] && pt[j] >= 0 && pt[j] < a.n_points ? at(a.inst, pt[j]) : -1;
    }
    if (!zeroed) {
      for (int e = threadIdx.x; e < p_n * cols; e += kThreads) s_hist[e] = 0;
      __syncthreads();
      zeroed = true;
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t i = in[j] >= 0 && in[j] < a.i_cap ? in[j] : a.i_cap;
      const int bin = ok[j] ? static_cast<int>(p[j]) * cols + static_cast<int>(i) : -1;
      const unsigned same = __match_any_sync(0xffffffffu, bin);
      if (bin >= 0 && lane == __ffs(same) - 1) atomicAdd(s_hist + bin, __popc(same));
    }
  }
}

__global__ void __launch_bounds__(kThreads) proposal_iou_kernel(Args a) {
  extern __shared__ int s_hist[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cols = a.i_cap + 1;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;

  // 0: zero the global histogram; it is read only after the first barrier
  const int64_t n_bins = static_cast<int64_t>(a.p_cap) * cols;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; e < n_bins;
       e += stride) {
    a.hist[e] = 0;
  }

  // A: this block's chunk of rows into its proposal range's histogram
  const int range = static_cast<int>(blockIdx.x) % a.n_ranges;
  const int chunks = static_cast<int>(gridDim.x) / a.n_ranges;
  const int chunk = static_cast<int>(blockIdx.x) / a.n_ranges;  // >= chunks: idle
  const int p_lo = range * a.p_range;
  const int p_n = min(a.p_range, a.p_cap - p_lo);
  const int bins = p_n * cols;
  const bool counting = chunk < chunks && p_n > 0;
  if (counting) {
    const int64_t per = (a.rows + chunks - 1) / chunks;
    const int64_t lo = min(a.rows, chunk * per), hi = min(a.rows, lo + per);
    count_rows(a, lo, hi, p_lo, p_n, s_hist);
  }
  grid_sync(g_bar);

  // B: the nonzero bins into the global histogram; then the instance sizes
  // as f32 into shared memory (their loads wait out the barrier), in the
  // blocks that write IoUs
  if (counting) {
    int32_t* dst = a.hist + static_cast<int64_t>(p_lo) * cols;
    for (int e = threadIdx.x; e < bins; e += kThreads) {
      const int c = s_hist[e];
      if (c != 0) atomicAdd(dst + e, c);
    }
  }
  float* s_num = reinterpret_cast<float*>(s_hist);
  const bool writes = static_cast<int>(blockIdx.x) * kWarps < a.p_cap;
  if (writes) {
    __syncthreads();
    for (int i = threadIdx.x; i < a.i_cap; i += kThreads) {
      s_num[i] = static_cast<float>(at(a.inst_num, i));
    }
  }
  grid_sync(g_bar);

  // C: a warp a proposal: psize, then its I IoUs
  for (int p = blockIdx.x * kWarps + warp; p < a.p_cap; p += gridDim.x * kWarps) {
    const int32_t* h = a.hist + static_cast<int64_t>(p) * cols;
    int tot = 0;
    for (int i = lane; i < cols; i += 32) tot += __ldcg(h + i);
    const float psize = static_cast<float>(__reduce_add_sync(0xffffffffu, tot));
    float* out = a.iou + static_cast<int64_t>(p) * a.i_cap;
    for (int i = lane; i < a.i_cap; i += 32) {
      const float n = static_cast<float>(__ldcg(h + i));
      out[i] = __fdiv_rn(n, __fadd_rn(__fsub_rn(__fadd_rn(psize, s_num[i]), n), 1e-5f));
    }
  }
}

// Kernel launches enqueued so far, for the tests' count of a call's device ops.
int64_t g_device_ops = 0;

}  // namespace

extern "C" int64_t ms3d_proposal_iou_device_ops() { return g_device_ops; }

// point_idx and prop_id (rows,) int64; inst (n_points,) and inst_num
// (i_cap,) int16, int32 or int64, their element sizes in bytes packed in
// `widths` as inst | inst_num << 4; valid and row_keep (rows,) bool,
// row_keep null for every row. scratch: p_cap * (i_cap + 1) int32, any
// contents; iou (p_cap, i_cap) f32. One cooperative launch of a block an SM
// on `stream`, no memset; p_cap, i_cap >= 1.
extern "C" int ms3d_proposal_iou(const int64_t* point_idx, const int64_t* prop_id,
                                 const bool* valid, const bool* row_keep, int64_t rows,
                                 const void* inst, int64_t n_points, const void* inst_num,
                                 int widths, int p_cap, int i_cap, int32_t* scratch, float* iou,
                                 cudaStream_t stream) {
  const int inst_bytes = widths & 15, num_bytes = (widths >> 4) & 15;
  if (rows < 0 || n_points < 0 || p_cap < 1 || i_cap < 1 || !ms3d::ints_width(inst_bytes) ||
      !ms3d::ints_width(num_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int sms[64] = {0}, optin[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    // one block an SM at the opt-in shared memory: one at any less
    int opt = 0, n_sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&opt, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(proposal_iou_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 opt);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, proposal_iou_kernel, kThreads,
                                                          opt);
    }
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    optin[dev] = opt;
    sms[dev] = n_sms;
  }
  const int64_t hist_row = 4 * static_cast<int64_t>(i_cap + 1);  // a proposal's bins
  const int64_t fit = optin[dev] / hist_row;
  if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int p_range = static_cast<int>(fit < p_cap ? fit : p_cap);
  const int n_ranges = (p_cap + p_range - 1) / p_range;
  const int smem = static_cast<int>(p_range * hist_row);
  const int grid = sms[dev];
  if (n_ranges > grid) return static_cast<int>(cudaErrorInvalidValue);
  Args a{reinterpret_cast<const long long*>(point_idx),
         reinterpret_cast<const long long*>(prop_id),
         reinterpret_cast<const unsigned char*>(valid),
         reinterpret_cast<const unsigned char*>(row_keep),
         {inst, inst_bytes},
         {inst_num, num_bytes},
         rows, n_points, p_cap, i_cap, p_range, n_ranges, scratch, iou};
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(proposal_iou_kernel),
                                    dim3(grid), dim3(kThreads), params, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++g_device_ops;
  return static_cast<int>(err);
}
