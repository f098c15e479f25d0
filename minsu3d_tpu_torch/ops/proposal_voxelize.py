"""The per-row part of the dense proposal re-voxelization
(minsu3d_tpu/model/general_model.py:333 ``clusters_voxelization_dense``,
with its row gather ``f = feats[rows.point_idx]`` at :351): kernel K7
``proposal_voxelize`` (csrc/proposal_voxelize.cu) for CUDA tensors, its
plain version for CPU ones.

The rows come with the forward's proposal CSR (``general_model.proposal_csr``:
the valid rows by proposal, the other rows its padding). Each row r of
proposal p (point i = pidx[r]) is placed at
``((coords[i] - mean[p]) * scale[p]) + offset[p]``, floored and clamped to
the S^3 grid of its proposal; duplicate cells keep their first row (an
integer min of row ids, deterministic); the winners' feature rows
``feats[pidx]`` (zeros for pidx = N) fill the (P * S^3, C) volume, every
other cell is +0.0, and the winners mark its occupancy. Both versions
evaluate the placement with the same f32 operations in the same order, so
``row_cell`` is bit-identical between them. The volume takes the features'
dtype, f32 or bf16 (general_model.py:386); the winners' rows are copied, so
it is bit-identical too. The gradient that reaches ``feats`` is that of the
winning rows alone, in the order of the row gather it replaces: the
volume's cotangent gathered at the winners' cells over all rows, then
summed into the points by ``segment.gather_rows``' ordered transpose (K6).
"""

from __future__ import annotations

import torch

from minsu3d_tpu_torch.csrc import build
from minsu3d_tpu_torch.ops import hashing, segment

_BIG = 2**31 - 1
# the feature types K7 takes, with the launch count of each (``build.LAUNCHES``),
# which is also its C entry's name after ``ms3d_``
_LAUNCH_NAME = {torch.float32: "proposal_voxelize", torch.bfloat16: "proposal_voxelize_bf16"}


def place_plain(feats, pidx, coords, csr, mean, scale, offset, p_cap: int, s: int):
    """K7's plain version: (volume (P*S^3, C), occ (P*S^3,), row_cell (R,),
    cell_w (R,)) int64; cell_w is the row's cell if it won it, else P*S^3.
    ``csr``: the rows' proposal CSR, whose ``seg`` is each row's proposal
    (P for the rows of none)."""
    dev = coords.device
    n_cells = p_cap * s * s * s
    pid = csr.seg
    valid = pid < p_cap
    pid_c = pid.clamp(max=p_cap - 1)
    c = coords[pidx] - mean[pid_c]
    c = c * scale[pid_c, None]
    c = c + offset[pid_c]
    grid = torch.floor(c).to(torch.int64).clamp(0, s - 1)
    cell = ((pid * s + grid[:, 0]) * s + grid[:, 1]) * s + grid[:, 2]
    cell = torch.where(valid, cell, torch.full_like(cell, n_cells))
    row_ids = torch.arange(cell.shape[0], device=dev)
    first_row = torch.full((n_cells + 1,), _BIG, dtype=torch.int64, device=dev)
    first_row.scatter_reduce_(0, cell, torch.where(valid, row_ids, torch.full_like(row_ids, _BIG)),
                              reduce="amin")
    winner = valid & (first_row[cell] == row_ids)
    cell_w = torch.where(winner, cell, torch.full_like(cell, n_cells))
    n = feats.shape[0]
    rows = torch.cat([feats, feats.new_zeros((1, feats.shape[1]))])[pidx[winner].clamp(0, n)]
    volume = torch.zeros((n_cells + 1, feats.shape[1]), dtype=feats.dtype, device=dev)
    volume[cell_w[winner]] = rows
    occ = torch.zeros(n_cells + 1, dtype=torch.bool, device=dev)
    occ[cell_w[winner]] = True
    return volume[:n_cells], occ[:n_cells], cell, cell_w


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t as a contiguous tensor of ``dtype``, with no op when it is one."""
    return t if t.dtype == dtype and t.is_contiguous() else t.to(dtype).contiguous()


def place_cuda(feats, pidx, coords, csr, mean, scale, offset, p_cap: int, s: int):
    """K7 on the card, one launch and nothing filled; same outputs as
    ``place_plain``."""
    dev = coords.device
    n_cells = p_cap * s * s * s
    n, c_dim = feats.shape
    rows = pidx.shape[0]
    if c_dim < 1 or p_cap < 1 or n_cells >= _BIG or rows >= _BIG or n >= _BIG:
        raise ValueError(f"proposal_voxelize: {rows} rows of {n} points x {c_dim} channels "
                         f"into {p_cap} x {s}^3 cells")
    if feats.dtype not in _LAUNCH_NAME:
        raise TypeError(f"proposal_voxelize: want f32 or bf16 features, got {feats.dtype}")
    if (csr.num_segments != p_cap or csr.perm.dtype != torch.int32
            or csr.offsets.dtype != torch.int32 or csr.perm.shape[0] != rows):
        raise ValueError("proposal_voxelize: want the rows' int32 proposal CSR over p_cap "
                         "proposals")
    f32 = torch.float32
    coords_, mean_, scale_, offset_ = (_as(t, f32) for t in (coords, mean, scale, offset))
    pidx_, feats_ = _as(pidx, torch.int64), _as(feats, feats.dtype)
    volume = torch.empty((n_cells, c_dim), dtype=feats.dtype, device=dev)
    occ = torch.empty(n_cells, dtype=torch.bool, device=dev)
    row_cell = torch.empty(rows, dtype=torch.int64, device=dev)
    cell_w = torch.empty(rows, dtype=torch.int64, device=dev)
    count = _LAUNCH_NAME[feats.dtype]
    build.check(getattr(build.kernel_lib(), "ms3d_" + count)(
        coords_.data_ptr(), n, pidx_.data_ptr(), rows, csr.perm.data_ptr(),
        csr.offsets.data_ptr(), p_cap, mean_.data_ptr(), scale_.data_ptr(), offset_.data_ptr(),
        s, feats_.data_ptr(), c_dim, volume.data_ptr(), occ.data_ptr(), row_cell.data_ptr(),
        cell_w.data_ptr(), hashing._stream(volume)), count)
    build.LAUNCHES[count] += 1
    return volume, occ, row_cell, cell_w


def place(feats, pidx, coords, csr, mean, scale, offset, p_cap: int, s: int):
    """K7 on CUDA tensors, the plain version on CPU ones (no autograd)."""
    if coords.device.type == "cpu":
        return place_plain(feats, pidx, coords, csr, mean, scale, offset, p_cap, s)
    if coords.device.type == "cuda":
        return place_cuda(feats, pidx, coords, csr, mean, scale, offset, p_cap, s)
    raise ValueError(f"proposal_voxelize: unsupported device {coords.device}")


class VoxelizeRows(torch.autograd.Function):
    """``place`` with a gradient to ``feats``: the volume's cotangent
    gathered at each row's won cell (0 for rows that lost or are invalid),
    then summed into each row's point in row order on K6, as the backward
    of ``segment.gather_rows(feats, pidx)`` sums it."""

    @staticmethod
    def forward(ctx, feats, pidx, coords, csr, mean, scale, offset, p_cap, s):
        volume, occ, row_cell, cell_w = place(feats, pidx, coords, csr, mean, scale, offset,
                                              p_cap, s)
        ctx.save_for_backward(cell_w)
        ctx.rows_csr = (segment.segment_csr(pidx, feats.shape[0])
                        if ctx.needs_input_grad[0] else None)
        ctx.mark_non_differentiable(occ, row_cell)
        return volume, occ, row_cell

    @staticmethod
    def backward(ctx, g_volume, g_occ, g_cell):
        (cell_w,) = ctx.saved_tensors
        g = torch.cat([g_volume, g_volume.new_zeros((1, g_volume.shape[1]))])
        g_rows = torch.index_select(g, 0, cell_w)
        return (segment.segment_reduce(g_rows, ctx.rows_csr, "sum"),) + (None,) * 8


def voxelize_rows(feats, pidx, coords, csr, mean, scale, offset, p_cap: int, s: int):
    """(volume (P*S^3, C), occ (P*S^3,), row_cell (R,) int64) of the rows
    ``pidx`` (R,) int64 into ``feats`` (N, C), by ``csr``, the rows' proposal
    CSR: see the module docstring."""
    return VoxelizeRows.apply(feats, pidx, coords, csr, mean, scale, offset, p_cap, s)
