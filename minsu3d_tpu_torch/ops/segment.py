"""Segment reductions over per-row segment ids (padded rows carry
``num_segments``): the port of minsu3d_tpu/ops/segment.py:40-72, plain torch
scatter reductions. An empty segment reads 0, as in the JAX code.

Gradients equal ``jax.grad`` of the JAX functions: a segment's min or max
splits its cotangent evenly among the rows that tie for it. The extreme
reductions seed the scatter with -inf/+inf and map empty (non-finite)
segments to 0 afterwards; a zero seed would count as one more tie in torch's
scatter_reduce backward whenever a segment's extreme is exactly 0, which is
common after a ReLU (roipool of the ScoreNet's output).
"""

from __future__ import annotations

import torch


def sec_mean(data: torch.Tensor, seg_id: torch.Tensor, valid: torch.Tensor,
             num_segments: int) -> torch.Tensor:
    data = torch.where(valid[:, None], data, torch.zeros_like(data))
    seg = seg_id.long()
    tot = torch.zeros((num_segments + 1, data.shape[1]), dtype=data.dtype,
                      device=data.device).index_add_(0, seg, data)[:num_segments]
    cnt = torch.zeros(num_segments + 1, dtype=torch.int64, device=data.device).index_add_(
        0, seg, valid.to(torch.int64))[:num_segments]
    return tot / cnt.clamp(min=1)[:, None].to(data.dtype)


def _sec_extreme(data, seg_id, valid, num_segments: int, reduce: str):
    seg = seg_id.long().clamp(max=num_segments)
    seg = torch.where(valid, seg, torch.full_like(seg, num_segments))
    seed = float("inf") if reduce == "amin" else float("-inf")
    out = torch.full((num_segments + 1, data.shape[1]), seed, dtype=data.dtype,
                     device=data.device)
    out = out.scatter_reduce(0, seg[:, None].expand_as(data), data, reduce=reduce,
                             include_self=False)[:num_segments]
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def sec_min(data, seg_id, valid, num_segments: int) -> torch.Tensor:
    return _sec_extreme(data, seg_id, valid, num_segments, "amin")


def sec_max(data, seg_id, valid, num_segments: int) -> torch.Tensor:
    return _sec_extreme(data, seg_id, valid, num_segments, "amax")


def roipool(feats, seg_id, valid, num_segments: int) -> torch.Tensor:
    """Per-segment channelwise max (reference roipool_fp); empty -> 0."""
    return _sec_extreme(feats, seg_id, valid, num_segments, "amax")
