// K7 proposal_voxelize: proposal membership rows -> cells of dense
// (P, S, S, S) proposal volumes, first row wins, winners' features written.
//
// Replaces the per-row part of minsu3d_tpu/model/general_model.py:333
// (clusters_voxelization_dense): the placement of each valid row r of
// proposal p = pid[r] at point i = pidx[r],
//   c[d] = ((coords[i, d] - mean[p, d]) * scale[p]) + offset[p, d]
//   g[d] = clamp(floor(c[d]), 0, S - 1)
//   cell = ((p * S + g[0]) * S + g[1]) * S + g[2]      (P * S^3 if invalid)
// with every f32 operation explicitly rounded (__fsub_rn, __fmul_rn,
// __fadd_rn, floorf), so nvcc cannot contract them into an FMA and the cell
// equals the plain version's separate tensor operations bit for bit. The
// per-proposal mean, min and max come from K6; scale and offset (extent,
// jitter) are (P,)-sized and computed by the wrapper.
//
// The election: first_row[cell] = min row id of the valid rows placed in it,
// by int32 atomicMin -- order-free, so deterministic. Then every winner
// (valid, first_row[cell] == r) writes its feature row into the zeroed
// volume and sets the cell's occupancy; cell_w[r] = cell for winners and
// P * S^3 otherwise, which the backward gathers at. The features are f32,
// or bf16 (the proposal volume takes the point features' dtype,
// general_model.py:386): the winners' rows are copied, so either way the
// volume equals the plain version's bit for bit.
//
// What bounds it on an H100: bytes -- one read of the rows (ids, coords)
// and of the winners' feature rows, one write of those rows into the
// volume; the zeroing of the (P * S^3, C) volume is the wrapper's and is the
// largest traffic. Design, simple first: one thread per row for the
// placement, one thread per (row, channel) for the writes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void place_kernel(const float* __restrict__ coords, const int32_t* __restrict__ pidx,
                             const int32_t* __restrict__ pid, const bool* __restrict__ valid,
                             int rows, const float* __restrict__ mean,
                             const float* __restrict__ scale, const float* __restrict__ offset,
                             int s, int n_cells, int32_t* __restrict__ row_cell,
                             int32_t* __restrict__ first_row) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  if (!valid[r]) {
    row_cell[r] = n_cells;
    return;
  }
  const int p = pid[r];
  const int64_t i = pidx[r];
  const float sc = scale[p];
  int g[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float c = __fadd_rn(__fmul_rn(__fsub_rn(coords[3 * i + d], mean[3 * p + d]), sc),
                              offset[3 * p + d]);
    long long q = static_cast<long long>(floorf(c));
    q = q < 0 ? 0 : (q > s - 1 ? s - 1 : q);
    g[d] = static_cast<int>(q);
  }
  const int cell = ((p * s + g[0]) * s + g[1]) * s + g[2];
  row_cell[r] = cell;
  atomicMin(first_row + cell, r);
}

template <typename T>
__global__ void write_kernel(const T* __restrict__ f, int rows, int c_dim,
                             const int32_t* __restrict__ row_cell,
                             const int32_t* __restrict__ first_row, int n_cells,
                             T* __restrict__ volume, bool* __restrict__ occ,
                             int32_t* __restrict__ cell_w) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<int64_t>(rows) * c_dim) return;
  const int r = static_cast<int>(e / c_dim), ch = static_cast<int>(e % c_dim);
  const int cell = row_cell[r];
  const bool winner = cell < n_cells && first_row[cell] == r;
  if (ch == 0) {
    cell_w[r] = winner ? cell : n_cells;
    if (winner) occ[cell] = true;
  }
  if (winner) volume[static_cast<int64_t>(cell) * c_dim + ch] = f[e];
}

template <typename T>
int launch(const float* coords, const int32_t* pidx, const int32_t* pid, const bool* valid,
           int rows, const float* mean, const float* scale, const float* offset, int s,
           int n_cells, const T* f, int c_dim, int32_t* row_cell, int32_t* first_row,
           T* volume, bool* occ, int32_t* cell_w, cudaStream_t stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  place_kernel<<<(rows + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      coords, pidx, pid, valid, rows, mean, scale, offset, s, n_cells, row_cell, first_row);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t elems = static_cast<int64_t>(rows) * c_dim;
  write_kernel<T><<<static_cast<unsigned>((elems + kThreads - 1) / kThreads), kThreads, 0,
                    stream>>>(f, rows, c_dim, row_cell, first_row, n_cells, volume, occ,
                              cell_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// first_row (n_cells + 1,) int32 filled with INT32_MAX, volume (n_cells,
// c_dim) and occ (n_cells,) zeroed by the caller; c_dim >= 1.
extern "C" int ms3d_proposal_voxelize(const float* coords, const int32_t* pidx,
                                      const int32_t* pid, const bool* valid, int rows,
                                      const float* mean, const float* scale,
                                      const float* offset, int s, int n_cells, const float* f,
                                      int c_dim, int32_t* row_cell, int32_t* first_row,
                                      float* volume, bool* occ, int32_t* cell_w,
                                      cudaStream_t stream) {
  return launch<float>(coords, pidx, pid, valid, rows, mean, scale, offset, s, n_cells, f,
                       c_dim, row_cell, first_row, volume, occ, cell_w, stream);
}

// the same with bf16 feature rows and volume
extern "C" int ms3d_proposal_voxelize_bf16(const float* coords, const int32_t* pidx,
                                           const int32_t* pid, const bool* valid, int rows,
                                           const float* mean, const float* scale,
                                           const float* offset, int s, int n_cells,
                                           const __nv_bfloat16* f, int c_dim,
                                           int32_t* row_cell, int32_t* first_row,
                                           __nv_bfloat16* volume, bool* occ, int32_t* cell_w,
                                           cudaStream_t stream) {
  return launch<__nv_bfloat16>(coords, pidx, pid, valid, rows, mean, scale, offset, s,
                               n_cells, f, c_dim, row_cell, first_row, volume, occ, cell_w,
                               stream);
}
