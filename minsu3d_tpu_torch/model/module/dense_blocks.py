"""Dense 3D-conv ScoreNet on proposal volumes.

Counterpart of minsu3d_tpu/model/module/dense_blocks.py: ``DenseTinyUnet``
(:112) and its blocks, on (P, S, S, S, C) channels-last volumes. Every conv
output is masked by the occupancy volume, which makes the dense 3^3 conv
equal to a submanifold conv. The JAX package leaves these convs to stock
``lax.conv`` (:22-60), outside any kernel, and so does the port:
``torch.nn.functional.conv3d`` / ``conv_transpose3d`` on NCDHW views,
with cuDNN's TF32 turned off by the model entry point.

Weight layouts (``minsu3d_tpu_torch.convert`` does the mapping):
3^3 kernels are conv3d weights (Cout, Cin, 3, 3, 3); the k2s2 down conv a
conv3d weight (2c, c, 2, 2, 2); the k2s2 transposed conv a conv_transpose3d
weight (2c, c, 2, 2, 2) holding the JAX kernel flipped in all three spatial
axes (``lax.conv_transpose`` does not flip its kernel, torch's transposed
conv is the adjoint of a correlation and does).

Precision, as the JAX modules with ``compute_dtype`` (dense_blocks.py:22-60):
with bf16, every conv rounds its input and its f32 weight to bf16 (once per
call), convolves in bf16 (cuDNN sums in f32 and rounds once) and hands back
f32; a submanifold conv then returns its input's dtype, the k2s2 down and
up convs stay f32. So the first two blocks keep the bf16 volume's dtype,
and from the down conv on (the inner blocks, the skip concat, the tail) the
activations are f32 and only each conv's input is rounded: the TinyUnet's
output is f32. The batch norms compute in f32 (``MaskedBatchNorm``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from minsu3d_tpu_torch.model.module.blocks import MaskedBatchNorm


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


def _conv3d(x: torch.Tensor, w: torch.Tensor, stride: int, compute_dtype) -> torch.Tensor:
    """Channels-last conv (padding 1 for the 3^3 conv, none for the k2s2
    one) in ``compute_dtype`` (None: x's f32), returned in f32."""
    if compute_dtype is not None:
        x, w = x.to(compute_dtype), w.to(compute_dtype)
    y = F.conv3d(_ncdhw(x), w, stride=stride, padding=1 if stride == 1 else 0)
    return _ndhwc(y).float()


def _conv3d_transpose(x: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """k2s2 channels-last transposed conv in ``compute_dtype``, returned in f32."""
    if compute_dtype is not None:
        x, w = x.to(compute_dtype), w.to(compute_dtype)
    return _ndhwc(F.conv_transpose3d(_ncdhw(x), w, stride=2)).float()


class DenseBN(nn.Module):
    """Masked batch norm over the occupied cells of a dense volume."""

    def __init__(self, features: int):
        super().__init__()
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features)

    def forward(self, x: torch.Tensor, occ: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.MaskedBatchNorm_0(x, occ, train)


class DenseSubmConv(nn.Module):
    """3^3 dense conv masked to occupied sites (== submanifold conv), in x's
    dtype."""

    def __init__(self, cin: int, cout: int, compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(torch.zeros(cout, cin, 3, 3, 3))

    def forward(self, x: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
        y = _conv3d(x, self.kernel, 1, self.compute_dtype)
        return torch.where(occ[..., None], y, torch.zeros_like(y)).to(x.dtype)


class DenseResidualBlock(nn.Module):
    """Pre-activation residual block on dense volumes; the 1x1 downsample
    multiplies in f32 and rounds to x's dtype."""

    def __init__(self, cin: int, cout: int, compute_dtype=None):
        super().__init__()
        if cin != cout:
            self.downsample = nn.Parameter(torch.zeros(cin, cout))
        self.DenseBN_0 = DenseBN(cin)
        self.DenseSubmConv_0 = DenseSubmConv(cin, cout, compute_dtype)
        self.DenseBN_1 = DenseBN(cout)
        self.DenseSubmConv_1 = DenseSubmConv(cout, cout, compute_dtype)

    def forward(self, x: torch.Tensor, occ: torch.Tensor, train: bool = False) -> torch.Tensor:
        identity = ((x.float() @ self.downsample).to(x.dtype) if hasattr(self, "downsample")
                    else x)
        y = torch.relu(self.DenseBN_0(x, occ, train))
        y = self.DenseSubmConv_0(y, occ)
        y = torch.relu(self.DenseBN_1(y, occ, train))
        y = self.DenseSubmConv_1(y, occ)
        return y + identity


class DenseTinyUnet(nn.Module):
    """2-level UBlock + BN + ReLU on dense proposal volumes (planes [c, 2c],
    two residual blocks per stage); ``compute_dtype`` (None or
    torch.bfloat16) is the dtype of every conv."""

    def __init__(self, c: int, compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.block0 = DenseResidualBlock(c, c, compute_dtype)
        self.block1 = DenseResidualBlock(c, c, compute_dtype)
        self.conv_bn = DenseBN(c)
        self.conv_kernel = nn.Parameter(torch.zeros(2 * c, c, 2, 2, 2))
        self.u_block0 = DenseResidualBlock(2 * c, 2 * c, compute_dtype)
        self.u_block1 = DenseResidualBlock(2 * c, 2 * c, compute_dtype)
        self.deconv_bn = DenseBN(2 * c)
        self.deconv_kernel = nn.Parameter(torch.zeros(2 * c, c, 2, 2, 2))
        self.block_tail0 = DenseResidualBlock(2 * c, c, compute_dtype)
        self.block_tail1 = DenseResidualBlock(c, c, compute_dtype)
        self.out_bn = DenseBN(c)

    def forward(self, x: torch.Tensor, occ: torch.Tensor, train: bool = False) -> torch.Tensor:
        s = x.shape[1]
        if s % 2:  # pad to an even extent for the k2s2 down/up pair
            x = F.pad(x, (0, 0, 0, 1, 0, 1, 0, 1))
            occ = F.pad(occ, (0, 1, 0, 1, 0, 1))
        p, e = occ.shape[0], occ.shape[1] // 2
        occ2 = occ.reshape(p, e, 2, e, 2, e, 2).amax(dim=(2, 4, 6))

        x = self.block1(self.block0(x, occ, train), occ, train)
        identity = x
        y = torch.relu(self.conv_bn(x, occ, train))
        y = _conv3d(y, self.conv_kernel, 2, self.compute_dtype)
        y = torch.where(occ2[..., None], y, torch.zeros_like(y))
        y = self.u_block1(self.u_block0(y, occ2, train), occ2, train)
        y = torch.relu(self.deconv_bn(y, occ2, train))
        y = _conv3d_transpose(y, self.deconv_kernel, self.compute_dtype)
        y = torch.where(occ[..., None], y, torch.zeros_like(y))
        x = torch.cat([identity.to(y.dtype), y], dim=-1)
        x = self.block_tail1(self.block_tail0(x, occ, train), occ, train)
        x = torch.relu(self.out_bn(x, occ, train))
        if s % 2:
            x = x[:, :s, :s, :s, :]
        return x
