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
differentiable (``ops/sparse_conv.GatherConv``).
"""

from __future__ import annotations

import torch
from torch import nn

from minsu3d_tpu_torch.ops import sparse_conv


class MaskedBatchNorm(nn.Module):
    """Batch norm over the rows where ``mask`` is set; masked-out rows come
    out 0 (blocks.py:32-73). Training: the output uses the masked batch mean
    and biased variance; the running statistics move by momentum 0.1 towards
    the mean and the unbiased variance (cnt / (cnt - 1), cnt = max(valid, 1)),
    in f32. Eval: the running statistics. Rows = every axis but the last."""

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
        if train:
            axes = tuple(range(x.dim() - 1))
            m = mask_b.to(torch.float32)
            cnt = m.sum().clamp(min=1.0)
            mean = (x * m).sum(axes) / cnt
            var = ((x - mean) ** 2 * m).sum(axes) / cnt
            with torch.no_grad():
                unbiased = var * cnt / (cnt - 1.0).clamp(min=1.0)
                self.mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias
        return torch.where(mask_b, y, torch.zeros_like(y))


class SubmConv(nn.Module):
    """3^3 stride-1 sparse conv; kernel (27, Cin, Cout) in KERNEL_OFFSETS order."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(27, cin, cout))

    def forward(self, x: torch.Tensor, level) -> torch.Tensor:
        return sparse_conv.subm_conv(x, level, self.kernel)


class Conv1x1(nn.Module):
    """Per-voxel linear map without bias; kernel (Cin, Cout)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(cin, cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel


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

    def forward(self, x: torch.Tensor, level, train: bool = False) -> torch.Tensor:
        identity = self.downsample(x) if hasattr(self, "downsample") else x
        y = torch.relu(self.MaskedBatchNorm_0(x, level.valid, train))
        y = self.SubmConv_0(y, level)
        y = torch.relu(self.MaskedBatchNorm_1(y, level.valid, train))
        y = self.SubmConv_1(y, level)
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

    def forward(self, x: torch.Tensor, plan, train: bool = False) -> torch.Tensor:
        level = plan.levels[self.depth]
        for i in range(self.block_reps):
            x = getattr(self, f"block{i}")(x, level, train)
        if not self.deep:
            return x
        identity = x
        parent = plan.levels[self.depth + 1]
        lk = sparse_conv.links(level, parent.cap)
        y = torch.relu(self.conv_bn(x, level.valid, train))
        y = self.conv(y, lk)
        y = self.u(y, plan, train)
        y = torch.relu(self.deconv_bn(y, parent.valid, train))
        y = self.deconv(y, lk)
        x = torch.cat([identity, y], dim=-1)
        for i in range(self.block_reps):
            x = getattr(self, f"block_tail{i}")(x, level, train)
        return x


class PointMLP(nn.Module):
    """Linear -> masked BN -> ReLU -> Linear point head."""

    def __init__(self, cin: int, hidden: int, out: int):
        super().__init__()
        self.Dense_0 = nn.Linear(cin, hidden)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(hidden)
        self.Dense_1 = nn.Linear(hidden, out)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = torch.relu(self.MaskedBatchNorm_0(self.Dense_0(x), mask, train))
        return self.Dense_1(x)


class Backbone(nn.Module):
    """k3 input conv, 7-level UBlock, BN+ReLU, devoxelization, semantic and
    offset heads."""

    def __init__(self, input_channel: int, m: int, blocks: tuple, block_reps: int,
                 sem_classes: int):
        super().__init__()
        self.input_conv = SubmConv(input_channel, m)
        self.unet = UBlock(tuple(m * c for c in blocks), block_reps)
        self.out_bn = MaskedBatchNorm(m)
        self.semantic_branch = PointMLP(m, m, sem_classes)
        self.offset_branch = PointMLP(m, m, 3)

    def forward(self, voxel_feats: torch.Tensor, plan, v2p: torch.Tensor,
                point_mask: torch.Tensor, train: bool = False) -> dict:
        level0 = plan.levels[0]
        x = self.input_conv(voxel_feats, level0)
        x = self.unet(x, plan, train)
        x = torch.relu(self.out_bn(x, level0.valid, train))
        # devoxelize: v2p == cap reads the zero row (index_select: see
        # general_model.devoxelize_dense, the padding points share that row)
        xe = torch.cat([x, x.new_zeros((1, x.shape[1]))])
        pf = torch.index_select(xe, 0, v2p)
        pf = torch.where(point_mask[:, None], pf, torch.zeros_like(pf))
        return {
            "point_features": pf,
            "semantic_scores": self.semantic_branch(pf, point_mask, train),
            "point_offsets": self.offset_branch(pf, point_mask, train),
        }
