// K12 mask_label: the per-proposal argmax instance and the per-row binary
// mask labels of HAIS's and SoftGroup's mask losses.
//
//   phase 1, per proposal p, over the I columns:
//     m[p, i]  = col[i] ? ious[p, i] : 0.0f
//     max[p]   = max_i m[p, i]
//     arg[p]   = the first i with m[p, i] == max[p]     (jnp.argmax's rule)
//     ok[p]    = max[p] >= thr
//   phase 2, per row r:
//     q         = min(prop_id[r], P - 1)
//     row_ok[r] = valid[r] && ok[q]
//     label[r]  = row_ok[r] && inst[point_idx[r]] == arg[q]
//
// Replaces minsu3d_tpu/ops/instance_iou.py:57 (get_mask_label: the masked
// max and argmax, then the row gathers) and, phase 1 alone, the masked max
// and argmax of SoftGroup's classification labels and IoU target
// (minsu3d_tpu/model/softgroup.py:360-364, :388). Masked columns read 0.0,
// not -inf, as in the JAX code: a proposal whose unmasked IoUs are all 0
// gets index 0 even where column 0 is masked. A NaN counts as the largest
// value (first NaN wins), as jnp.argmax and torch.max treat it; IoUs have a
// positive denominator, so none arises on the model's path. An invalid row
// reads proposal P-1's verdict and is masked by its valid flag.
//
// The kernel only compares and selects, so its outputs equal the plain
// version's bit for bit. What bounds it on an H100: bytes (a (P, I) f32
// read, the R rows and one gathered instance id a supervised row, two bool
// writes a row), so HBM at 3.35 TB/s; at P = 128, I = 64 and R = 196608
// rows that is ~2 MB, under a microsecond. The time is launches and
// latency. So get_mask_label is one launch (mask_label_kernel): the column
// mask is read from the instance classes (cls != ignored) in the kernel,
// and every block computes all P argmaxes itself into shared memory from
// the (P, I) IoUs, which stay in L2 (32 KB at 128 x 64; four threads a
// proposal, 16 independent loads each), then labels its rows. The
// redundant phase 1 costs each block a few microseconds' worth of L2
// reads and needs no grid barrier, which a cooperative launch would add
// to every call's host issue. proposal_argmax (phase 1 alone, over a given
// bool column mask) is one launch of argmax_kernel, a warp a proposal over
// the grid. Rows are int64, as the heads write them; the instance ids and
// classes are read in the caller's dtypes (int16, int32 or int64, ids.cuh).

#include <cuda_runtime.h>

#include <cstdint>

#include "ids.cuh"

namespace {

using ms3d::at;
using ms3d::Ints;

constexpr int kThreads = 512;
constexpr int kLanesPerProposal = 4;   // mask_label_kernel's phase 1
constexpr int kProposalsPerPass = kThreads / kLanesPerProposal;
constexpr int kArgmaxThreads = 256;    // argmax_kernel: a warp a proposal

// (a, ia) is better than (b, ib): larger, NaN above all, ties to the lower
// index.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

// Phase 1 for proposal p (p < p_cap where `live`), by the `lanes` aligned
// lanes that share p (a power of two up to 32); `col(i)` says whether
// column i counts. Every lane of the warp must call it (the shuffles take
// the whole warp). Each of the group's lanes scans its columns in
// increasing order, then the group combines them (`better` is a total
// order, so any order of combining gives the same pair); all of its lanes
// return the proposal's (max, arg).
template <int lanes, typename Col>
__device__ __forceinline__ void group_argmax(const float* __restrict__ ious, int p, bool live,
                                             int i_cap, Col col, float* best_out,
                                             int* arg_out) {
  const int sub = threadIdx.x % lanes;
  float best = 0.0f;
  int best_i = i_cap;  // no column seen yet: loses every comparison below
  if (live) {
    const float* row = ious + static_cast<int64_t>(p) * i_cap;
#pragma unroll 4
    for (int i = sub; i < i_cap; i += lanes) {
      const float v = col(i) ? __ldg(row + i) : 0.0f;
      if (best_i == i_cap || better(v, i, best, best_i)) {
        best = v;
        best_i = i;
      }
    }
  }
#pragma unroll
  for (int off = 1; off < lanes; off *= 2) {
    const float v = __shfl_xor_sync(0xffffffffu, best, off);
    const int vi = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (vi != i_cap && (best_i == i_cap || better(v, vi, best, best_i))) {
      best = v;
      best_i = vi;
    }
  }
  *best_out = best;
  *arg_out = best_i;
}

__global__ void __launch_bounds__(kArgmaxThreads) argmax_kernel(
    const float* __restrict__ ious, const bool* __restrict__ col_mask, int p_cap, int i_cap,
    float thr, float* __restrict__ max_out, int32_t* __restrict__ arg_out,
    bool* __restrict__ ok_out) {
  const int p = (blockIdx.x * kArgmaxThreads + threadIdx.x) / 32;
  const unsigned char* cm = reinterpret_cast<const unsigned char*>(col_mask);
  float best;
  int arg;
  group_argmax<32>(ious, p, p < p_cap, i_cap, [&](int i) { return __ldg(cm + i) != 0; }, &best,
                   &arg);
  if (p < p_cap && threadIdx.x % 32 == 0) {
    max_out[p] = best;
    arg_out[p] = arg;
    ok_out[p] = best >= thr;
  }
}

struct LabelArgs {
  const float* ious;          // (p_cap, i_cap)
  Ints cls;                   // (i_cap,): column i counts where cls[i] != ignored
  int64_t ignored;
  int p_cap, i_cap;
  float thr;
  const long long* point_idx; // (rows,)
  const long long* prop_id;   // (rows,)
  const unsigned char* valid;
  int64_t rows;
  Ints inst;                  // (n_points,)
  int64_t n_points;
  bool* label;                // (rows,)
  bool* row_ok;               // (rows,)
};

__global__ void __launch_bounds__(kThreads) mask_label_kernel(LabelArgs a) {
  extern __shared__ int32_t s_arg[];                        // (p_cap,), then
  unsigned char* s_ok = reinterpret_cast<unsigned char*>(s_arg + a.p_cap);  // (p_cap,),
  unsigned char* s_col = s_ok + a.p_cap;                                    // (i_cap,)
  for (int i = threadIdx.x; i < a.i_cap; i += kThreads) s_col[i] = at(a.cls, i) != a.ignored;
  __syncthreads();

  // phase 1, every proposal, in this block
  for (int base = 0; base < a.p_cap; base += kProposalsPerPass) {
    const int p = base + threadIdx.x / kLanesPerProposal;
    float best;
    int arg;
    group_argmax<kLanesPerProposal>(a.ious, p, p < a.p_cap, a.i_cap,
                                    [&](int i) { return s_col[i] != 0; }, &best, &arg);
    if (p < a.p_cap && threadIdx.x % kLanesPerProposal == 0) {
      s_arg[p] = arg;
      s_ok[p] = best >= a.thr;
    }
  }
  __syncthreads();

  // phase 2, this block's share of the rows
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; r < a.rows;
       r += stride) {
    const int64_t pid = __ldg(a.prop_id + r);
    const int64_t q = pid < a.p_cap - 1 ? pid : a.p_cap - 1;
    const bool ok = __ldg(a.valid + r) != 0 && q >= 0 && s_ok[q] != 0;
    bool lab = false;
    if (ok) {
      const int64_t pt = __ldg(a.point_idx + r);
      lab = pt >= 0 && pt < a.n_points && at(a.inst, pt) == s_arg[q];
    }
    a.row_ok[r] = ok;
    a.label[r] = lab;
  }
}

// Kernel launches enqueued so far, for the tests' count of a call's device ops.
int64_t g_device_ops = 0;

}  // namespace

extern "C" int64_t ms3d_mask_label_device_ops() { return g_device_ops; }

// proposal_argmax: phase 1 alone over a bool column mask. ious (p_cap,
// i_cap) f32; max_out (p_cap,) f32, arg_out (p_cap,) int32, ok_out (p_cap,)
// bool. One launch; nothing at p_cap 0.
extern "C" int ms3d_proposal_argmax(const float* ious, const bool* col_mask, int p_cap,
                                    int i_cap, float thr, float* max_out, int32_t* arg_out,
                                    bool* ok_out, cudaStream_t stream) {
  if (p_cap < 0 || (p_cap > 0 && i_cap <= 0)) return static_cast<int>(cudaErrorInvalidValue);
  if (p_cap == 0) return static_cast<int>(cudaSuccess);
  constexpr int per_block = kArgmaxThreads / 32;
  argmax_kernel<<<(p_cap + per_block - 1) / per_block, kArgmaxThreads, 0, stream>>>(
      ious, col_mask, p_cap, i_cap, thr, max_out, arg_out, ok_out);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++g_device_ops;
  return static_cast<int>(err);
}

// get_mask_label: both phases in one launch. ious (p_cap, i_cap) f32;
// point_idx and prop_id (rows,) int64; inst (n_points,) and cls (i_cap,)
// int16, int32 or int64, their element sizes in bytes packed in `widths` as
// inst | cls << 4; valid (rows,) bool; label and row_ok (rows,) bool.
// p_cap, i_cap >= 1.
extern "C" int ms3d_mask_label(const float* ious, const void* cls, int64_t ignored, int p_cap,
                               int i_cap, float thr, const int64_t* point_idx,
                               const int64_t* prop_id, const bool* valid, int64_t rows,
                               const void* inst, int64_t n_points, int widths, bool* label,
                               bool* row_ok, cudaStream_t stream) {
  const int inst_bytes = widths & 15, cls_bytes = (widths >> 4) & 15;
  if (p_cap < 1 || i_cap < 1 || rows < 0 || n_points < 0 || !ms3d::ints_width(inst_bytes) ||
      !ms3d::ints_width(cls_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int sms[64] = {0}, optin[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&optin[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(mask_label_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin[dev]);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t smem = 5 * static_cast<int64_t>(p_cap) + i_cap;
  if (smem > optin[dev]) return static_cast<int>(cudaErrorInvalidValue);
  // a block for every kThreads rows, at most two an SM: each block's phase 1
  // is the whole (P, I) read
  const int64_t want = (rows + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < 1 ? 1 : (want < 2 * sms[dev] ? want : 2 * sms[dev]));
  LabelArgs a{ious, {cls, cls_bytes}, ignored, p_cap, i_cap, thr,
              reinterpret_cast<const long long*>(point_idx),
              reinterpret_cast<const long long*>(prop_id),
              reinterpret_cast<const unsigned char*>(valid), rows, {inst, inst_bytes}, n_points,
              label, row_ok};
  mask_label_kernel<<<grid, kThreads, static_cast<size_t>(smem), stream>>>(a);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++g_device_ops;
  return static_cast<int>(err);
}
