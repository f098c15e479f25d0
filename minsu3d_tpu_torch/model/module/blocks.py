"""Sparse U-Net backbone as torch modules.

Counterparts of minsu3d_tpu/model/module/blocks.py: ``MaskedBatchNorm``
(:32), ``SubmConv`` (:95), ``Conv1x1`` (:135), ``DownConv`` (:152),
``UpConv`` (:175), ``ResidualBlock`` (:198), ``UBlock`` (:227),
``PointMLP`` (:316) and ``Backbone`` (:330), default dispatch only.
Submodule and parameter names follow the flax modules' names so that
``minsu3d_tpu_torch.convert`` maps a JAX variable tree onto the state_dict
one to one. Every forward takes ``train`` as the flax modules do: batch
norms use batch statistics and update their running statistics when it is
true, and read the running statistics otherwise. The sparse convs are
differentiable (``ops/sparse_conv.GatherConv``), and so is the
devoxelization (``ops/segment.gather_rows``).

Precision, as the flax modules with ``compute_dtype``: the ``Backbone``
casts its voxel features to ``compute_dtype`` once at entry (None keeps
f32), and every activation of the U-Net then stays in that dtype. The
sparse convs run in their input's dtype (``ops/sparse_conv``); the batch
norm computes in f32 and returns its input's dtype; ``Conv1x1`` multiplies
in f32 (JAX promotes bf16 @ f32) and rounds to the input's dtype; the
residual add and the devoxelization keep the dtype; ``PointMLP`` promotes
its input to f32, as ``nn.Dense`` does, so the semantic and offset heads
run in f32.
"""

from __future__ import annotations

import torch
from torch import nn

from minsu3d_tpu_torch.ops import segment, sparse_conv


class MaskedBatchNorm(nn.Module):
    """Batch norm over the rows where ``mask`` is set; masked-out rows come
    out 0 (blocks.py:32-73). Training: the output uses the masked batch mean
    and biased variance; the running statistics move by momentum 0.1 towards
    the mean and the unbiased variance (cnt / (cnt - 1), cnt = max(valid, 1)),
    in f32. Eval: the running statistics. Rows = every axis but the last.
    Statistics and the normalisation run in f32 on ``x.float()``; the
    output returns to x's dtype (blocks.py:57, :73)."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor, train: bool = False) -> torch.Tensor:
        mask_b = mask[..., None]
        x32 = x.float()
        if train:
            axes = tuple(range(x.dim() - 1))
            m = mask_b.to(torch.float32)
            cnt = m.sum().clamp(min=1.0)
            mean = (x32 * m).sum(axes) / cnt
            var = ((x32 - mean) ** 2 * m).sum(axes) / cnt
            with torch.no_grad():
                unbiased = var * cnt / (cnt - 1.0).clamp(min=1.0)
                self.mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        else:
            mean, var = self.mean, self.var
        y = (x32 - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias
        return torch.where(mask_b, y, torch.zeros_like(y)).to(x.dtype)


class SubmConv(nn.Module):
    """3^3 stride-1 sparse conv; kernel (27, Cin, Cout) in KERNEL_OFFSETS order."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(27, cin, cout))

    def forward(self, x: torch.Tensor, level, order=None) -> torch.Tensor:
        return sparse_conv.subm_conv(x, level, self.kernel, order)


class Conv1x1(nn.Module):
    """Per-voxel linear map without bias; kernel (Cin, Cout). The product is
    f32 (JAX promotes bf16 x to the f32 kernel), rounded to x's dtype."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(cin, cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x.float() @ self.kernel).to(x.dtype)


class DownConv(nn.Module):
    """k2s2 strided conv; kernel (8, Cin, Cout) indexed by child kid."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(8, cin, cout))

    def forward(self, x: torch.Tensor, lk: sparse_conv.Links) -> torch.Tensor:
        return sparse_conv.down_conv(x, lk, self.kernel)


class UpConv(nn.Module):
    """k2s2 transposed conv; kernel (8, Cparent, Cchild) indexed by child kid."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(8, cin, cout))

    def forward(self, x: torch.Tensor, lk: sparse_conv.Links) -> torch.Tensor:
        return sparse_conv.up_conv(x, lk, self.kernel)


class ResidualBlock(nn.Module):
    """Pre-activation residual block: BN-ReLU-conv-BN-ReLU-conv + identity."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        if cin != cout:
            self.downsample = Conv1x1(cin, cout)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(cin)
        self.SubmConv_0 = SubmConv(cin, cout)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(cout)
        self.SubmConv_1 = SubmConv(cout, cout)

    def forward(self, x: torch.Tensor, level, train: bool = False, order=None) -> torch.Tensor:
        identity = self.downsample(x) if hasattr(self, "downsample") else x
        y = torch.relu(self.MaskedBatchNorm_0(x, level.valid, train))
        y = self.SubmConv_0(y, level, order)
        y = torch.relu(self.MaskedBatchNorm_1(y, level.valid, train))
        y = self.SubmConv_1(y, level, order)
        return y + identity


class UBlock(nn.Module):
    """Recursive U-Net level: ``planes[0]`` is this level's width."""

    def __init__(self, planes: tuple, block_reps: int, depth: int = 0):
        super().__init__()
        self.depth = depth
        self.block_reps = block_reps
        p0 = planes[0]
        for i in range(block_reps):
            self.add_module(f"block{i}", ResidualBlock(p0, p0))
        self.deep = len(planes) > 1
        if self.deep:
            p1 = planes[1]
            self.conv_bn = MaskedBatchNorm(p0)
            self.conv = DownConv(p0, p1)
            self.u = UBlock(planes[1:], block_reps, depth + 1)
            self.deconv_bn = MaskedBatchNorm(p1)
            self.deconv = UpConv(p1, p0)
            for i in range(block_reps):
                self.add_module(f"block_tail{i}",
                                ResidualBlock(p0 * 2 if i == 0 else p0, p0))

    def forward(self, x: torch.Tensor, plan, train: bool = False, tables=None) -> torch.Tensor:
        """``tables``: the plan's ``sparse_conv.conv_tables`` (None: built here)."""
        if tables is None:
            tables = sparse_conv.conv_tables(plan)
        level, tab = plan.levels[self.depth], tables[self.depth]
        for i in range(self.block_reps):
            x = getattr(self, f"block{i}")(x, level, train, tab.nbr_order)
        if not self.deep:
            return x
        identity = x
        parent = plan.levels[self.depth + 1]
        y = torch.relu(self.conv_bn(x, level.valid, train))
        y = self.conv(y, tab.links)
        y = self.u(y, plan, train, tables)
        y = torch.relu(self.deconv_bn(y, parent.valid, train))
        y = self.deconv(y, tab.links)
        x = torch.cat([identity, y], dim=-1)
        for i in range(self.block_reps):
            x = getattr(self, f"block_tail{i}")(x, level, train, tab.nbr_order)
        return x


class PointMLP(nn.Module):
    """Linear -> masked BN -> ReLU -> Linear point head, in f32 whatever the
    input's dtype (``nn.Dense`` promotes bf16 input to its f32 kernel)."""

    def __init__(self, cin: int, hidden: int, out: int):
        super().__init__()
        self.Dense_0 = nn.Linear(cin, hidden)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(hidden)
        self.Dense_1 = nn.Linear(hidden, out)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = torch.relu(self.MaskedBatchNorm_0(self.Dense_0(x.float()), mask, train))
        return self.Dense_1(x)


class Backbone(nn.Module):
    """k3 input conv, 7-level UBlock, BN+ReLU, devoxelization, semantic and
    offset heads. ``compute_dtype`` (None or torch.bfloat16) is the dtype
    of the voxel features from entry to the point features."""

    def __init__(self, input_channel: int, m: int, blocks: tuple, block_reps: int,
                 sem_classes: int, compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.input_conv = SubmConv(input_channel, m)
        self.unet = UBlock(tuple(m * c for c in blocks), block_reps)
        self.out_bn = MaskedBatchNorm(m)
        self.semantic_branch = PointMLP(m, m, sem_classes)
        self.offset_branch = PointMLP(m, m, 3)

    def forward(self, voxel_feats: torch.Tensor, plan, v2p: torch.Tensor,
                point_mask: torch.Tensor, train: bool = False) -> dict:
        level0 = plan.levels[0]
        if self.compute_dtype is not None:
            voxel_feats = voxel_feats.to(self.compute_dtype)
        # every conv table's TapOrder, once per forward pass
        tables = sparse_conv.conv_tables(plan)
        x = self.input_conv(voxel_feats, level0, tables[0].nbr_order)
        x = self.unet(x, plan, train, tables)
        x = torch.relu(self.out_bn(x, level0.valid, train))
        # devoxelize: v2p == cap reads a zero row; the backward sums each
        # voxel's point rows in order (K6), padding points left out
        pf = segment.gather_rows(x, v2p)
        pf = torch.where(point_mask[:, None], pf, torch.zeros_like(pf))
        return {
            "point_features": pf,
            "semantic_scores": self.semantic_branch(pf, point_mask, train),
            "point_offsets": self.offset_branch(pf, point_mask, train),
        }
