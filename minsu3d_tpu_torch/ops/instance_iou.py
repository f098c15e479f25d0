"""Proposal <-> ground-truth-instance IoU of the score loss.

Counterparts of minsu3d_tpu/ops/instance_iou.py: ``proposal_sizes`` (:27)
and ``get_iou`` (:35, without ``row_weights``: the HAIS mask-IoU variant and
``get_mask_label`` come with HAIS). Proposals are the membership rows of
``pointgroup.merge_clusterings`` (a dict: point_idx, prop_id, valid).

``get_iou`` runs on K5 ``proposal_iou`` (csrc/proposal_iou.cu) for CUDA
tensors and on the plain version for CPU ones. Both count in integers and
evaluate ``inter / (psize + inst_num_point - inter + 1e-5)`` in f32 in the
JAX code's order, so they equal each other and the JAX function bit for bit.
"""

from __future__ import annotations

import torch

from minsu3d_tpu_torch.csrc import build


def proposal_sizes(rows: dict, p_cap: int) -> torch.Tensor:
    """Valid rows per proposal, (P,) f32."""
    pid = torch.where(rows["valid"], rows["prop_id"].long(),
                      torch.full_like(rows["prop_id"].long(), p_cap))
    return torch.zeros(p_cap + 1, dtype=torch.float32, device=pid.device).index_add_(
        0, pid, rows["valid"].to(torch.float32))[:p_cap]


def get_iou_plain(rows: dict, p_cap: int, instance_ids: torch.Tensor,
                  instance_num_point: torch.Tensor, i_cap: int) -> torch.Tensor:
    inst = instance_ids.long()[rows["point_idx"].long()]
    ok = rows["valid"] & (inst >= 0) & (inst < i_cap)
    pid = torch.where(ok, rows["prop_id"].long(), torch.full_like(inst, p_cap))
    iid = torch.where(ok, inst, torch.full_like(inst, i_cap))
    inter = torch.zeros((p_cap + 1) * (i_cap + 1), dtype=torch.float32, device=inst.device)
    inter.index_add_(0, pid * (i_cap + 1) + iid, ok.to(torch.float32))
    inter = inter.view(p_cap + 1, i_cap + 1)[:p_cap, :i_cap]
    p_tot = proposal_sizes(rows, p_cap)
    denom = p_tot[:, None] + instance_num_point[None, :].to(torch.float32) - inter + 1e-5
    return inter / denom


def get_iou(rows: dict, p_cap: int, instance_ids: torch.Tensor,
            instance_num_point: torch.Tensor, i_cap: int) -> torch.Tensor:
    """Dense (P, I) f32 IoU between proposals and ground-truth instances."""
    dev = instance_ids.device
    if dev.type == "cpu":
        return get_iou_plain(rows, p_cap, instance_ids, instance_num_point, i_cap)
    if dev.type != "cuda":
        raise ValueError(f"get_iou: unsupported device {dev}")
    if instance_num_point.shape != (i_cap,):
        raise ValueError(f"get_iou: instance_num_point {tuple(instance_num_point.shape)} "
                         f"is not ({i_cap},)")
    point_idx = rows["point_idx"].to(torch.int32).contiguous()
    prop_id = rows["prop_id"].to(torch.int32).contiguous()
    valid = rows["valid"].contiguous()
    inst = instance_ids.to(torch.int32).contiguous()
    inp = instance_num_point.to(torch.int32).contiguous()
    if not (point_idx.shape == prop_id.shape == valid.shape and valid.dtype == torch.bool):
        raise ValueError("get_iou: malformed proposal rows")
    psize = torch.zeros(p_cap, dtype=torch.int32, device=dev)
    inter = torch.zeros((p_cap, i_cap), dtype=torch.int32, device=dev)
    iou = torch.empty((p_cap, i_cap), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(build.kernel_lib().ms3d_proposal_iou(
        point_idx.data_ptr(), prop_id.data_ptr(), valid.data_ptr(), valid.shape[0],
        inst.data_ptr(), inst.shape[0], inp.data_ptr(), p_cap, i_cap, psize.data_ptr(),
        inter.data_ptr(), iou.data_ptr(), stream), "proposal_iou")
    build.LAUNCHES["proposal_iou"] += 1
    return iou
