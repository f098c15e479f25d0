"""Proposal <-> ground-truth-instance IoU and the mask labels of the losses.

Counterparts of minsu3d_tpu/ops/instance_iou.py: ``proposal_sizes`` (:27),
``get_iou`` (:35, ``row_weights`` as the bool ``row_keep``) and
``get_mask_label`` (:57-76), plus ``proposal_argmax``, the per-proposal
masked max and first-index argmax that ``get_mask_label`` starts with and
that SoftGroup's classification labels use alone (minsu3d_tpu/model/
softgroup.py:360-364, :388). Proposals are the membership rows of the heads (a
dict: point_idx, prop_id, valid).

``get_iou`` runs on K5 ``proposal_iou`` (csrc/proposal_iou.cu) for CUDA
tensors and on the plain version for CPU ones. Both count in integers and
evaluate ``inter / (psize + inst_num_point - inter + 1e-5)`` in f32 in the
JAX code's order, so they equal each other and the JAX function bit for bit
(the JAX weights are 0/1, so its f32 sums are integer counts too).
``proposal_argmax`` and ``get_mask_label`` run on K12 ``mask_label``
(csrc/mask_label.cu) for CUDA tensors; they compare and select only, so the
kernel equals the plain version bit for bit.
"""

from __future__ import annotations

import torch

from minsu3d_tpu_torch.csrc import build


def proposal_sizes(rows: dict, p_cap: int, row_keep: torch.Tensor | None = None) -> torch.Tensor:
    """Valid (and kept) rows per proposal, (P,) f32. The float scatter-add
    adds 1.0s: counts below 2^24 are exact in f32 in any order, so it is
    deterministic on the card too."""
    ok = rows["valid"] if row_keep is None else rows["valid"] & row_keep
    pid = torch.where(rows["valid"], rows["prop_id"].long(),
                      torch.full_like(rows["prop_id"].long(), p_cap))
    return torch.zeros(p_cap + 1, dtype=torch.float32, device=pid.device).index_add_(
        0, pid, ok.to(torch.float32))[:p_cap]


def get_iou_plain(rows: dict, p_cap: int, instance_ids: torch.Tensor,
                  instance_num_point: torch.Tensor, i_cap: int,
                  row_keep: torch.Tensor | None = None) -> torch.Tensor:
    inst = instance_ids.long()[rows["point_idx"].long()]
    ok = rows["valid"] & (inst >= 0) & (inst < i_cap)
    pid = torch.where(ok, rows["prop_id"].long(), torch.full_like(inst, p_cap))
    iid = torch.where(ok, inst, torch.full_like(inst, i_cap))
    counted = ok if row_keep is None else ok & row_keep
    inter = torch.zeros((p_cap + 1) * (i_cap + 1), dtype=torch.float32, device=inst.device)
    # 1.0 counts: exact in f32 in any order (this is the CPU path; K5 on the card)
    inter.index_add_(0, pid * (i_cap + 1) + iid, counted.to(torch.float32))
    inter = inter.view(p_cap + 1, i_cap + 1)[:p_cap, :i_cap]
    p_tot = proposal_sizes(rows, p_cap, row_keep)
    denom = p_tot[:, None] + instance_num_point[None, :].to(torch.float32) - inter + 1e-5
    return inter / denom


def _rows_i32(rows: dict, what: str) -> tuple:
    point_idx = rows["point_idx"].to(torch.int32).contiguous()
    prop_id = rows["prop_id"].to(torch.int32).contiguous()
    valid = rows["valid"].contiguous()
    if not (point_idx.shape == prop_id.shape == valid.shape and valid.dtype == torch.bool):
        raise ValueError(f"{what}: malformed proposal rows")
    return point_idx, prop_id, valid


def _cuda_device(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises on any other."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return True


def get_iou(rows: dict, p_cap: int, instance_ids: torch.Tensor,
            instance_num_point: torch.Tensor, i_cap: int,
            row_keep: torch.Tensor | None = None) -> torch.Tensor:
    """Dense (P, I) f32 IoU between proposals and ground-truth instances.
    ``row_keep`` ((R,) bool, or None for every row): a row counts in its
    proposal's size and in the intersection only where it is valid and
    kept (the JAX function's 0/1 ``row_weights``)."""
    if not _cuda_device(instance_ids, "get_iou"):
        return get_iou_plain(rows, p_cap, instance_ids, instance_num_point, i_cap, row_keep)
    dev = instance_ids.device
    if instance_num_point.shape != (i_cap,):
        raise ValueError(f"get_iou: instance_num_point {tuple(instance_num_point.shape)} "
                         f"is not ({i_cap},)")
    point_idx, prop_id, valid = _rows_i32(rows, "get_iou")
    keep_ptr = None
    if row_keep is not None:
        row_keep = row_keep.contiguous()
        if row_keep.shape != valid.shape or row_keep.dtype != torch.bool:
            raise ValueError("get_iou: row_keep must be a bool tensor of one entry per row")
        keep_ptr = row_keep.data_ptr()
    inst = instance_ids.to(torch.int32).contiguous()
    inp = instance_num_point.to(torch.int32).contiguous()
    psize = torch.zeros(p_cap, dtype=torch.int32, device=dev)
    inter = torch.zeros((p_cap, i_cap), dtype=torch.int32, device=dev)
    iou = torch.empty((p_cap, i_cap), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(build.kernel_lib().ms3d_proposal_iou(
        point_idx.data_ptr(), prop_id.data_ptr(), valid.data_ptr(), keep_ptr, valid.shape[0],
        inst.data_ptr(), inst.shape[0], inp.data_ptr(), p_cap, i_cap, psize.data_ptr(),
        inter.data_ptr(), iou.data_ptr(), stream), "proposal_iou")
    build.LAUNCHES["proposal_iou"] += 1
    return iou


def proposal_argmax_plain(ious: torch.Tensor, col_mask: torch.Tensor, thr: float) -> tuple:
    iou_m = torch.where(col_mask[None, :], ious, torch.zeros((), dtype=ious.dtype,
                                                              device=ious.device))
    # torch.max / argmax along a dim return the first index of the maximum
    mx, arg = iou_m.max(dim=1)
    return mx, arg.to(torch.int32), mx >= torch.tensor(thr, dtype=torch.float32)


def _argmax_args(ious: torch.Tensor, col_mask: torch.Tensor) -> tuple:
    ious, col_mask = ious.contiguous(), col_mask.contiguous()
    if ious.dim() != 2 or ious.dtype != torch.float32:
        raise ValueError(f"mask_label: ious must be a (P, I) f32 tensor, got "
                         f"{tuple(ious.shape)} {ious.dtype}")
    if col_mask.shape != (ious.shape[1],) or col_mask.dtype != torch.bool:
        raise ValueError("mask_label: col_mask must be a bool tensor of one entry per column")
    p = ious.shape[0]
    dev = ious.device
    outs = (torch.empty(p, dtype=torch.float32, device=dev),
            torch.empty(p, dtype=torch.int32, device=dev),
            torch.empty(p, dtype=torch.bool, device=dev))
    return ious, col_mask, outs


def proposal_argmax(ious: torch.Tensor, col_mask: torch.Tensor, thr: float) -> tuple:
    """Per proposal, over ``where(col_mask, ious, 0.0)``: (max (P,) f32,
    first-index argmax (P,) int32, max >= thr (P,) bool). A proposal whose
    unmasked IoUs are all 0 gets index 0, masked or not, as jnp.argmax
    gives it."""
    if not _cuda_device(ious, "proposal_argmax"):
        return proposal_argmax_plain(ious, col_mask, thr)
    ious, col_mask, (mx, arg, ok) = _argmax_args(ious, col_mask)
    stream = torch.cuda.current_stream(ious.device).cuda_stream
    # phase 1 alone: no rows
    build.check(build.kernel_lib().ms3d_mask_label(
        ious.data_ptr(), col_mask.data_ptr(), ious.shape[0], ious.shape[1], float(thr),
        mx.data_ptr(), arg.data_ptr(), ok.data_ptr(), None, None, None, 0, None, 0, None,
        None, stream), "mask_label")
    build.LAUNCHES["mask_label"] += 1
    return mx, arg, ok


def get_mask_label_plain(rows: dict, p_cap: int, instance_ids: torch.Tensor,
                         instance_cls: torch.Tensor, ious: torch.Tensor, iou_thr: float,
                         ignored_label: int = -1) -> tuple:
    _, arg, prop_ok = proposal_argmax_plain(ious, instance_cls != ignored_label, iou_thr)
    # invalid rows (prop_id p_cap) read proposal P-1 and are masked by valid
    pid = rows["prop_id"].long().clamp(max=p_cap - 1)
    row_ok = rows["valid"] & prop_ok[pid]
    label = row_ok & (instance_ids.long()[rows["point_idx"].long()] == arg.long()[pid])
    return label, row_ok


def get_mask_label(rows: dict, p_cap: int, instance_ids: torch.Tensor,
                   instance_cls: torch.Tensor, ious: torch.Tensor, iou_thr: float,
                   ignored_label: int = -1) -> tuple:
    """Per-row binary mask labels: each proposal's argmax-IoU instance among
    the classes other than ``ignored_label``; where that IoU >= iou_thr, a
    valid row of the proposal is supervised (``row_ok``) and labelled
    (``label``) by whether its point belongs to that instance. Returns
    (label (R,) bool, row_ok (R,) bool)."""
    if not _cuda_device(ious, "get_mask_label"):
        return get_mask_label_plain(rows, p_cap, instance_ids, instance_cls, ious, iou_thr,
                                    ignored_label)
    if ious.shape[0] != p_cap:
        raise ValueError(f"get_mask_label: ious has {ious.shape[0]} rows, p_cap is {p_cap}")
    col_mask = instance_cls != ignored_label
    ious, col_mask, (mx, arg, ok) = _argmax_args(ious, col_mask)
    point_idx, prop_id, valid = _rows_i32(rows, "get_mask_label")
    inst = instance_ids.to(torch.int32).contiguous()
    label = torch.empty_like(valid)
    row_ok = torch.empty_like(valid)
    stream = torch.cuda.current_stream(ious.device).cuda_stream
    build.check(build.kernel_lib().ms3d_mask_label(
        ious.data_ptr(), col_mask.data_ptr(), p_cap, ious.shape[1], float(iou_thr),
        mx.data_ptr(), arg.data_ptr(), ok.data_ptr(), point_idx.data_ptr(),
        prop_id.data_ptr(), valid.data_ptr(), valid.shape[0], inst.data_ptr(), inst.shape[0],
        label.data_ptr(), row_ok.data_ptr(), stream), "mask_label")
    build.LAUNCHES["mask_label"] += 1
    return label, row_ok
