// K7 proposal_voxelize: proposal membership rows -> cells of dense
// (P, S, S, S) proposal volumes, first row wins, winners' features written;
// one launch a call, the whole volume written once.
//
// Replaces the per-row part of minsu3d_tpu/model/general_model.py:333
// (clusters_voxelization_dense) and its row gather `f = feats[rows.point_idx]`
// (:351): the placement of each valid row r of proposal p at point
// i = pidx[r],
//   c[d] = ((coords[i, d] - mean[p, d]) * scale[p]) + offset[p, d]
//   g[d] = clamp(floor(c[d]), 0, S - 1)
//   cell = ((p * S + g[0]) * S + g[1]) * S + g[2]      (P * S^3 if invalid)
// with every f32 operation explicitly rounded (__fsub_rn, __fmul_rn,
// __fadd_rn, floorf), so nvcc cannot contract them into an FMA and the cell
// equals the plain version's separate tensor operations bit for bit. The
// per-proposal mean, min and max come from K6; scale and offset (extent,
// jitter) are (P,)-sized and computed by the caller.
//
// Design: a cluster of kCluster blocks a proposal (one proposal's 175 KB to
// 1 MB slice is too little work for one SM, and 128 proposals too few
// blocks for the card). The rows come from the forward's proposal CSR
// (perm, offsets: proposal p's rows are perm[offsets[p]:offsets[p + 1]],
// the rows of no proposal after offsets[P]); each block places a quarter
// of them and elects each cell's first row, an int32 atomicMin of row ids
// into block 0's S^3 table in shared memory through distributed shared
// memory: order-free, so deterministic. After a cluster barrier each block
// copies the table, writes its rows' winner cells, then writes a quarter of
// the proposal's cells exactly once: the winner's feature row feats[pidx]
// (read here, no gather before the call), else +0.0, in 16-byte stores
// where the rows allow, and the cells' occupancy. A proposal with no rows
// is written as zeros. Nothing is filled or zeroed before the launch. The
// features are f32, or bf16 (the proposal volume takes the point features'
// dtype, general_model.py:386); either way the rows are copied, so the
// volume equals the plain version's bit for bit.
//
// What bounds it on an H100: bytes -- one write of the (P * S^3, C) volume
// dominates (PointGroup f32 22.5 MB, 6.7 us; HAIS f32 131 MB, 39 us), then
// one read of the rows' ids, coords and the winners' feature rows.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kCluster = 4;
constexpr int32_t kNone = INT32_MAX;

struct Args {
  const float* coords;     // (n_points, 3)
  const int64_t* pidx;     // (rows,) point of each row
  const int32_t* perm;     // (rows,) rows by proposal, the rows of none last
  const int32_t* offsets;  // (p_cap + 1,)
  const float* mean;       // (p_cap, 3)
  const float* scale;      // (p_cap,)
  const float* offset;     // (p_cap, 3)
  int n_points, rows, p_cap, s, units;   // units: vector units of a cell's row
  bool* occ;               // (p_cap * S^3,)
  int64_t* row_cell;       // (rows,)
  int64_t* cell_w;         // (rows,)
};

template <typename Unit>
__global__ void __launch_bounds__(kThreads) voxelize_kernel(const Args a,
                                                            const Unit* __restrict__ feats,
                                                            Unit* __restrict__ volume) {
  extern __shared__ int32_t s_first[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int p = blockIdx.x / kCluster;
  const int s = a.s, s3 = s * s * s;
  const int64_t n_cells = static_cast<int64_t>(a.p_cap) * s3;
  const int64_t cell0 = static_cast<int64_t>(p) * s3;
  for (int c = tid; c < s3; c += kThreads) s_first[c] = kNone;
  cluster.sync();   // every table of the cluster initialised

  // this block's share of the proposal's rows: placement and election
  int32_t* first0 = cluster.map_shared_rank(s_first, 0);
  const int lo = a.offsets[p], hi = a.offsets[p + 1];
  const int per = (hi - lo + kCluster - 1) / kCluster;
  const int r_lo = min(hi, lo + rank * per), r_hi = min(hi, r_lo + per);
  const float sc = a.scale[p];
  float m[3], o[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    m[d] = a.mean[3 * p + d];
    o[d] = a.offset[3 * p + d];
  }
  for (int j = r_lo + tid; j < r_hi; j += kThreads) {
    const int r = a.perm[j];
    const int64_t i = a.pidx[r];
    int g[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float c = __fadd_rn(__fmul_rn(__fsub_rn(a.coords[3 * i + d], m[d]), sc), o[d]);
      long long q = static_cast<long long>(floorf(c));
      q = q < 0 ? 0 : (q > s - 1 ? s - 1 : q);
      g[d] = static_cast<int>(q);
    }
    const int local = (g[0] * s + g[1]) * s + g[2];
    a.row_cell[r] = cell0 + local;
    atomicMin(first0 + local, r);
  }
  cluster.sync();   // the election is over
  if (rank != 0) {
    for (int c = tid; c < s3; c += kThreads) s_first[c] = first0[c];
  }
  cluster.sync();   // block 0's table is no longer read by the others

  // this block's rows: won cells (each thread reads back its own row_cell)
  for (int j = r_lo + tid; j < r_hi; j += kThreads) {
    const int r = a.perm[j];
    const int64_t cell = a.row_cell[r];
    a.cell_w[r] = s_first[cell - cell0] == r ? cell : n_cells;
  }
  __syncthreads();

  // this block's cells: the winners' feature rows, then the slice and occupancy
  const int per_c = (s3 + kCluster - 1) / kCluster;
  const int c_lo = min(s3, rank * per_c), c_hi = min(s3, c_lo + per_c);
  for (int c = c_lo + tid; c < c_hi; c += kThreads) {
    const int32_t w = s_first[c];
    int32_t src = -1;
    if (w != kNone) {
      const int64_t i = a.pidx[w];
      src = i >= 0 && i < a.n_points ? static_cast<int32_t>(i) : -1;
    }
    s_first[c] = src;
    a.occ[cell0 + c] = w != kNone;
  }
  __syncthreads();
  const int units = a.units;
  Unit* out = volume + cell0 * units;
  for (int64_t u = static_cast<int64_t>(c_lo) * units + tid;
       u < static_cast<int64_t>(c_hi) * units; u += kThreads) {
    const int c = static_cast<int>(u / units);
    const int32_t src = s_first[c];
    const int64_t part = u - static_cast<int64_t>(c) * units;
    out[u] = src >= 0 ? feats[static_cast<int64_t>(src) * units + part] : Unit{};
  }

  // the rows of no proposal (the CSR's padding), shared by every block
  for (int64_t j = a.offsets[a.p_cap] + static_cast<int64_t>(blockIdx.x) * kThreads + tid;
       j < a.rows; j += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int r = a.perm[j];
    a.row_cell[r] = n_cells;
    a.cell_w[r] = n_cells;
  }
}

template <typename Unit>
int launch(const Args& a, const void* feats, void* volume, cudaStream_t stream) {
  const int smem = a.s * a.s * a.s * static_cast<int>(sizeof(int32_t));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        voxelize_kernel<Unit>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.p_cap) * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, voxelize_kernel<Unit>, a,
                                       static_cast<const Unit*>(feats),
                                       static_cast<Unit*>(volume));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Memsets and kernel launches enqueued so far, for the tests' count of a
// call's launches.
int64_t g_device_ops = 0;

int voxelize(const float* coords, int n_points, const int64_t* pidx, int rows,
             const int32_t* perm, const int32_t* offsets, int p_cap, const float* mean,
             const float* scale, const float* offset, int s, const void* feats, int c_dim,
             int elem_bytes, void* volume, bool* occ, int64_t* row_cell, int64_t* cell_w,
             cudaStream_t stream) {
  if (p_cap < 1 || s < 1 || c_dim < 1 || rows < 0 || n_points < 0 ||
      static_cast<int64_t>(s) * s * s * sizeof(int32_t) > 227 * 1024 ||
      static_cast<int64_t>(p_cap) * kCluster >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{coords, pidx, perm, offsets, mean, scale, offset, n_points, rows, p_cap, s, 0,
         occ, row_cell, cell_w};
  const int64_t row_bytes = static_cast<int64_t>(c_dim) * elem_bytes;
  const bool vec = row_bytes % 16 == 0 && (reinterpret_cast<uintptr_t>(feats) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(volume) & 15) == 0;
  int err;
  if (vec) {
    a.units = static_cast<int>(row_bytes / 16);
    err = launch<uint4>(a, feats, volume, stream);
  } else if (elem_bytes == 4) {
    a.units = c_dim;
    err = launch<uint32_t>(a, feats, volume, stream);
  } else {
    a.units = c_dim;
    err = launch<uint16_t>(a, feats, volume, stream);
  }
  if (err == 0) ++g_device_ops;
  return err;
}

}  // namespace

extern "C" int64_t ms3d_proposal_voxelize_device_ops() { return g_device_ops; }

// coords (n_points, 3) f32, pidx (rows,) int64, the proposal CSR's perm
// (rows,) and offsets (p_cap + 1,) int32, mean (p_cap, 3), scale (p_cap,),
// offset (p_cap, 3) f32, feats (n_points, c_dim) f32; writes volume
// (p_cap * S^3, c_dim), occ (p_cap * S^3,), row_cell and cell_w (rows,)
// int64, nothing filled before. One launch on `stream`.
extern "C" int ms3d_proposal_voxelize(const float* coords, int n_points, const int64_t* pidx,
                                      int rows, const int32_t* perm, const int32_t* offsets,
                                      int p_cap, const float* mean, const float* scale,
                                      const float* offset, int s, const float* feats,
                                      int c_dim, float* volume, bool* occ, int64_t* row_cell,
                                      int64_t* cell_w, cudaStream_t stream) {
  return voxelize(coords, n_points, pidx, rows, perm, offsets, p_cap, mean, scale, offset, s,
                  feats, c_dim, 4, volume, occ, row_cell, cell_w, stream);
}

// the same with bf16 feature rows and volume
extern "C" int ms3d_proposal_voxelize_bf16(const float* coords, int n_points,
                                           const int64_t* pidx, int rows, const int32_t* perm,
                                           const int32_t* offsets, int p_cap, const float* mean,
                                           const float* scale, const float* offset, int s,
                                           const uint16_t* feats, int c_dim, uint16_t* volume,
                                           bool* occ, int64_t* row_cell, int64_t* cell_w,
                                           cudaStream_t stream) {
  return voxelize(coords, n_points, pidx, rows, perm, offsets, p_cap, mean, scale, offset, s,
                  feats, c_dim, 2, volume, occ, row_cell, cell_w, stream);
}
