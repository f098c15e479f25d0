"""The per-row part of the dense proposal re-voxelization
(minsu3d_tpu/model/general_model.py:333 ``clusters_voxelization_dense``):
kernel K7 ``proposal_voxelize`` (csrc/proposal_voxelize.cu) for CUDA
tensors, its plain version for CPU ones.

Each valid row r (proposal p = pid[r], point i = pidx[r]) is placed at
``((coords[i] - mean[p]) * scale[p]) + offset[p]``, floored and clamped to
the S^3 grid of its proposal; duplicate cells keep their first row (an
integer min of row ids, deterministic); the winners' feature rows are
written into the zeroed (P * S^3, C) volume and mark its occupancy. Both
versions evaluate the placement with the same f32 operations in the same
order, so ``row_cell`` is bit-identical between them. The volume takes the
features' dtype, f32 or bf16 (general_model.py:386); the winners' rows are
copied, so it is bit-identical too. The gradient that reaches ``f`` is that
of the winning rows alone: a gather of the volume's cotangent at the
winners' cells.
"""

from __future__ import annotations

import torch

from minsu3d_tpu_torch.csrc import build

_BIG = 2**31 - 1
# the feature types K7 takes, with the launch count of each (``build.LAUNCHES``),
# which is also its C entry's name after ``ms3d_``
_LAUNCH_NAME = {torch.float32: "proposal_voxelize", torch.bfloat16: "proposal_voxelize_bf16"}


def place_plain(f, coords, pidx, pid, valid, mean, scale, offset, p_cap: int, s: int):
    """K7's plain version: (volume (P*S^3, C), occ (P*S^3,), row_cell (R,),
    cell_w (R,)); cell_w is the row's cell if it won it, else P*S^3."""
    dev = coords.device
    n_cells = p_cap * s * s * s
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
    volume = torch.zeros((n_cells + 1, f.shape[1]), dtype=f.dtype, device=dev)
    volume[cell_w[winner]] = f[winner]
    occ = torch.zeros(n_cells + 1, dtype=torch.bool, device=dev)
    occ[cell_w[winner]] = True
    return volume[:n_cells], occ[:n_cells], cell, cell_w


def place_cuda(f, coords, pidx, pid, valid, mean, scale, offset, p_cap: int, s: int):
    """K7 on the card; same outputs as ``place_plain``."""
    dev = coords.device
    n_cells = p_cap * s * s * s
    rows, c_dim = f.shape
    if c_dim < 1 or n_cells >= _BIG or rows >= _BIG:
        raise ValueError(f"proposal_voxelize: {rows} rows x {c_dim} channels into "
                         f"{n_cells} cells")
    if f.dtype not in _LAUNCH_NAME:
        raise TypeError(f"proposal_voxelize: want f32 or bf16 features, got {f.dtype}")
    f32 = dict(dtype=torch.float32)
    args = [coords.to(**f32).contiguous(), pidx.to(torch.int32).contiguous(),
            pid.clamp(max=p_cap).to(torch.int32).contiguous(), valid.contiguous(),
            mean.to(**f32).contiguous(), scale.to(**f32).contiguous(),
            offset.to(**f32).contiguous(), f.contiguous()]
    coords_, pidx_, pid_, valid_, mean_, scale_, offset_, f_ = args
    row_cell = torch.empty(rows, dtype=torch.int32, device=dev)
    first_row = torch.full((n_cells + 1,), _BIG, dtype=torch.int32, device=dev)
    volume = torch.zeros((n_cells, c_dim), dtype=f.dtype, device=dev)
    occ = torch.zeros(n_cells, dtype=torch.bool, device=dev)
    cell_w = torch.empty(rows, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    count = _LAUNCH_NAME[f.dtype]
    build.check(getattr(build.kernel_lib(), "ms3d_" + count)(
        coords_.data_ptr(), pidx_.data_ptr(), pid_.data_ptr(), valid_.data_ptr(), rows,
        mean_.data_ptr(), scale_.data_ptr(), offset_.data_ptr(), s, n_cells, f_.data_ptr(),
        c_dim, row_cell.data_ptr(), first_row.data_ptr(), volume.data_ptr(), occ.data_ptr(),
        cell_w.data_ptr(), stream), count)
    build.LAUNCHES[count] += 1
    return volume, occ, row_cell.long(), cell_w.long()


def place(f, coords, pidx, pid, valid, mean, scale, offset, p_cap: int, s: int):
    """K7 on CUDA tensors, the plain version on CPU ones (no autograd)."""
    if coords.device.type == "cpu":
        return place_plain(f, coords, pidx, pid, valid, mean, scale, offset, p_cap, s)
    if coords.device.type == "cuda":
        return place_cuda(f, coords, pidx, pid, valid, mean, scale, offset, p_cap, s)
    raise ValueError(f"proposal_voxelize: unsupported device {coords.device}")


class VoxelizeRows(torch.autograd.Function):
    """``place`` with a gradient to ``f``: the volume's cotangent gathered
    at each row's won cell (0 for rows that lost or are invalid)."""

    @staticmethod
    def forward(ctx, f, coords, pidx, pid, valid, mean, scale, offset, p_cap, s):
        volume, occ, row_cell, cell_w = place(f, coords, pidx, pid, valid, mean, scale, offset,
                                              p_cap, s)
        ctx.save_for_backward(cell_w)
        ctx.mark_non_differentiable(occ, row_cell)
        return volume, occ, row_cell

    @staticmethod
    def backward(ctx, g_volume, g_occ, g_cell):
        (cell_w,) = ctx.saved_tensors
        g = torch.cat([g_volume, g_volume.new_zeros((1, g_volume.shape[1]))])
        return (torch.index_select(g, 0, cell_w),) + (None,) * 9


def voxelize_rows(f, coords, pidx, pid, valid, mean, scale, offset, p_cap: int, s: int):
    """(volume (P*S^3, C), occ (P*S^3,), row_cell (R,) int64): see the
    module docstring. ``pid`` carries p_cap for invalid rows."""
    return VoxelizeRows.apply(f, coords, pidx, pid, valid, mean, scale, offset, p_cap, s)
