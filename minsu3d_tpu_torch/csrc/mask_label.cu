// K12 mask_label: the per-proposal argmax instance and the per-row binary
// mask labels of HAIS's and SoftGroup's mask losses.
//
//   phase 1, one warp per proposal p, over the I columns:
//     m[p, i]  = col_mask[i] ? ious[p, i] : 0.0f
//     max[p]   = max_i m[p, i]
//     arg[p]   = the first i with m[p, i] == max[p]     (jnp.argmax's rule)
//     ok[p]    = max[p] >= thr
//   phase 2, one thread per row r:
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
// positive denominator, so none arises on the model's path.
//
// The kernel only compares and selects, so its outputs equal the plain
// version's bit for bit. What bounds it on an H100: bytes (a (P, I) f32
// read, then a read of the R rows and one gathered instance id per row, and
// two bool writes per row), so HBM at 3.35 TB/s; at P = 128, I = 64 and
// R = 196608 rows that is ~3 MB, about a microsecond. Phase 1 is tiny (P
// warps); the launch and the rows' pass dominate.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;

// (a, ia) is better than (b, ib): larger, NaN above all, ties to the lower
// index.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

__global__ void argmax_kernel(const float* __restrict__ ious,
                              const bool* __restrict__ col_mask, int p_cap, int i_cap,
                              float thr, float* __restrict__ max_out,
                              int32_t* __restrict__ arg_out, bool* __restrict__ ok_out) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (warp >= p_cap) return;  // whole warps leave together
  const float* row = ious + static_cast<int64_t>(warp) * i_cap;
  float best = 0.0f;
  int best_i = i_cap;  // no column seen yet: loses every comparison below
  for (int i = lane; i < i_cap; i += kWarp) {
    const float v = col_mask[i] ? row[i] : 0.0f;
    if (best_i == i_cap || better(v, i, best, best_i)) {
      best = v;
      best_i = i;
    }
  }
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const float v = __shfl_down_sync(0xffffffffu, best, off);
    const int vi = __shfl_down_sync(0xffffffffu, best_i, off);
    if (vi != i_cap && (best_i == i_cap || better(v, vi, best, best_i))) {
      best = v;
      best_i = vi;
    }
  }
  if (lane == 0) {
    max_out[warp] = best;
    arg_out[warp] = best_i;
    ok_out[warp] = best >= thr;
  }
}

__global__ void row_label_kernel(const int32_t* __restrict__ point_idx,
                                 const int32_t* __restrict__ prop_id,
                                 const bool* __restrict__ valid, int rows,
                                 const int32_t* __restrict__ inst, int n_points, int p_cap,
                                 const int32_t* __restrict__ arg,
                                 const bool* __restrict__ prop_ok, bool* __restrict__ label,
                                 bool* __restrict__ row_ok) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int q = min(prop_id[r], p_cap - 1);
  const bool ok = valid[r] && q >= 0 && prop_ok[q];
  const int pt = point_idx[r];
  row_ok[r] = ok;
  label[r] = ok && pt >= 0 && pt < n_points && inst[pt] == arg[q];
}

}  // namespace

// max_out (P,) f32, arg_out (P,) int32 and ok_out (P,) bool are phase 1's
// outputs; label and row_ok, (R,) bool each, are phase 2's. With rows == 0
// only phase 1 runs, and the row pointers may be null.
extern "C" int ms3d_mask_label(const float* ious, const bool* col_mask, int p_cap, int i_cap,
                               float thr, float* max_out, int32_t* arg_out, bool* ok_out,
                               const int32_t* point_idx, const int32_t* prop_id,
                               const bool* valid, int rows, const int32_t* inst, int n_points,
                               bool* label, bool* row_ok, cudaStream_t stream) {
  if (rows > 0 && p_cap <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (p_cap > 0) {
    if (i_cap <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const int threads = 256;  // 8 proposals a block
    argmax_kernel<<<(p_cap * kWarp + threads - 1) / threads, threads, 0, stream>>>(
        ious, col_mask, p_cap, i_cap, thr, max_out, arg_out, ok_out);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  row_label_kernel<<<(rows + threads - 1) / threads, threads, 0, stream>>>(
      point_idx, prop_id, valid, rows, inst, n_points, p_cap, arg_out, ok_out, label, row_ok);
  return static_cast<int>(cudaGetLastError());
}
