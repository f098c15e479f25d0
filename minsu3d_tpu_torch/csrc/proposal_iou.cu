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
// so int32 atomicAdd gives exact
// counts in any order: the result is deterministic and equal, bit for bit,
// to the plain version, which adds 1.0s in f32 (exact below 2^24) and then
// evaluates the same f32 expression in the same order. The f32 operations
// are written as __fadd_rn/__fsub_rn/__fdiv_rn so that nvcc cannot contract
// or approximate them.
//
// What bounds it on an H100: one read of the R rows (point_idx, prop_id,
// valid, and one gathered inst per valid row) and a (P, I) write; bytes, so
// HBM at 3.35 TB/s. Atomics contend on the few (p, i) cells a proposal
// covers; a shared-memory histogram per block is later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void count_kernel(const int32_t* __restrict__ point_idx,
                             const int32_t* __restrict__ prop_id,
                             const bool* __restrict__ valid,
                             const bool* __restrict__ row_keep, int rows,
                             const int32_t* __restrict__ inst, int n_points, int p_cap,
                             int i_cap, int32_t* __restrict__ psize,
                             int32_t* __restrict__ inter) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows || !valid[r] || (row_keep != nullptr && !row_keep[r])) return;
  const int p = prop_id[r];
  if (p < 0 || p >= p_cap) return;
  atomicAdd(psize + p, 1);
  const int pt = point_idx[r];
  if (pt < 0 || pt >= n_points) return;
  const int i = inst[pt];
  if (i >= 0 && i < i_cap) atomicAdd(inter + static_cast<int64_t>(p) * i_cap + i, 1);
}

__global__ void iou_kernel(const int32_t* __restrict__ psize,
                           const int32_t* __restrict__ inter,
                           const int32_t* __restrict__ inst_num_point, int p_cap, int i_cap,
                           float* __restrict__ iou) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p_cap * i_cap) return;
  const int p = e / i_cap, i = e % i_cap;
  const float n = static_cast<float>(inter[e]);
  const float denom = __fadd_rn(
      __fsub_rn(__fadd_rn(static_cast<float>(psize[p]), static_cast<float>(inst_num_point[i])),
                n),
      1e-5f);
  iou[e] = __fdiv_rn(n, denom);
}

}  // namespace

// psize (P,) and inter (P, I) are int32 scratch that the caller zeroed;
// row_keep may be null.
extern "C" int ms3d_proposal_iou(const int32_t* point_idx, const int32_t* prop_id,
                                 const bool* valid, const bool* row_keep, int rows,
                                 const int32_t* inst,
                                 int n_points, const int32_t* inst_num_point, int p_cap,
                                 int i_cap, int32_t* psize, int32_t* inter, float* iou,
                                 cudaStream_t stream) {
  const int threads = 256;
  if (rows > 0) {
    count_kernel<<<(rows + threads - 1) / threads, threads, 0, stream>>>(
        point_idx, prop_id, valid, row_keep, rows, inst, n_points, p_cap, i_cap, psize,
        inter);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_out = p_cap * i_cap;
  if (n_out == 0) return static_cast<int>(cudaSuccess);
  iou_kernel<<<(n_out + threads - 1) / threads, threads, 0, stream>>>(
      psize, inter, inst_num_point, p_cap, i_cap, iou);
  return static_cast<int>(cudaGetLastError());
}
