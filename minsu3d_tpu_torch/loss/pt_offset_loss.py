"""Point offset losses: the port of minsu3d_tpu/loss/pt_offset_loss.py:10-38
(reference minsu3d/loss/pt_offset_loss.py:6-38): the L1 distance and the
negative cosine of the predicted against the ground-truth offsets, over
instance-assigned points."""

from __future__ import annotations

import torch

F32_EPS = float(torch.finfo(torch.float32).eps)


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    # x / max(||x||, eps); the 1e-20 inside the sqrt keeps the gradient
    # finite at exactly-zero vectors (points at their instance centroid)
    norm = torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-20)
    return x / norm.clamp(min=eps)


def pt_offset_loss(pred_offsets: torch.Tensor, gt_offsets: torch.Tensor,
                   valid_mask: torch.Tensor):
    """Returns (offset_norm_loss, offset_dir_loss); 0 when no point is valid."""
    m = valid_mask.to(torch.float32)
    count = m.sum()
    safe = count.clamp(min=1.0)

    dist = (pred_offsets - gt_offsets).abs().sum(-1)
    norm_loss = (dist * m).sum() / safe

    # double where: masked rows must not reach sqrt(0), whose gradient is
    # inf, and inf * 0 mask = NaN in the backward pass
    ones = torch.ones_like(pred_offsets)
    gt_safe = torch.where(valid_mask[:, None], gt_offsets, ones)
    pr_safe = torch.where(valid_mask[:, None], pred_offsets, ones)
    cos = (_l2_normalize(gt_safe, F32_EPS) * _l2_normalize(pr_safe, F32_EPS)).sum(-1)
    dir_loss = (-cos * m).sum() / safe

    zero = torch.zeros_like(norm_loss)
    has = count > 0
    return torch.where(has, norm_loss, zero), torch.where(has, dir_loss, zero)
