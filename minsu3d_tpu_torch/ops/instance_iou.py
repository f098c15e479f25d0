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
kernel equals the plain version bit for bit. On the card each call is one
launch that reads the caller's arrays as they are (the heads' int64 rows,
int16, int32 or int64 instance ids, sizes and classes, bool flags): no
cast, no memset, no host sync.
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


_WIDTH = {torch.int16: 2, torch.int32: 4, torch.int64: 8}


def _widths(what: str, *ids: torch.Tensor) -> int:
    """The element sizes of the kernel's instance id, size or class arrays,
    4 bits each, first array lowest: the int16, int32 or int64 tensors as
    the caller holds them."""
    packed = 0
    for k, t in enumerate(ids):
        w = _WIDTH.get(t.dtype)
        if w is None:
            raise TypeError(f"{what}: ids must be int16, int32 or int64, got {t.dtype}")
        packed |= w << (4 * k)
    return packed


def _row_arrays(rows: dict, what: str) -> tuple:
    """The rows as the kernels read them: int64 point_idx and prop_id, as
    the heads write them, and the bool valid flags."""
    point_idx, prop_id = rows["point_idx"].contiguous(), rows["prop_id"].contiguous()
    valid = rows["valid"].contiguous()
    if point_idx.dtype != torch.int64 or prop_id.dtype != torch.int64:
        raise TypeError(f"{what}: point_idx and prop_id must be int64, got {point_idx.dtype} "
                        f"and {prop_id.dtype}")
    if not (point_idx.shape == prop_id.shape == valid.shape and valid.dim() == 1
            and valid.dtype == torch.bool):
        raise ValueError(f"{what}: malformed proposal rows")
    return point_idx, prop_id, valid


def _same_device(what: str, *ts: torch.Tensor) -> None:
    if len({t.get_device() for t in ts}) != 1:
        raise ValueError(f"{what}: tensors on several devices")


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
    kept (the JAX function's 0/1 ``row_weights``). On the card one K5
    launch reads the arrays in their own dtypes (int64 rows; int16, int32
    or int64 ids and sizes): no cast, no memset, no host sync."""
    if not _cuda_device(instance_ids, "get_iou"):
        return get_iou_plain(rows, p_cap, instance_ids, instance_num_point, i_cap, row_keep)
    if instance_num_point.shape != (i_cap,):
        raise ValueError(f"get_iou: instance_num_point {tuple(instance_num_point.shape)} "
                         f"is not ({i_cap},)")
    point_idx, prop_id, valid = _row_arrays(rows, "get_iou")
    inst, num = instance_ids.contiguous(), instance_num_point.contiguous()
    widths = _widths("get_iou", inst, num)
    keep_ptr, arrays = None, (point_idx, prop_id, valid, inst, num)
    if row_keep is not None:
        row_keep = row_keep.contiguous()
        if row_keep.shape != valid.shape or row_keep.dtype != torch.bool:
            raise ValueError("get_iou: row_keep must be a bool tensor of one entry per row")
        keep_ptr, arrays = row_keep.data_ptr(), (*arrays, row_keep)
    _same_device("get_iou", *arrays)
    if p_cap * i_cap == 0:
        return torch.empty((p_cap, i_cap), dtype=torch.float32, device=inst.device)
    # the (P, I) f32 IoUs, then the kernel's (P, I + 1) int32 histogram
    buf = torch.empty(p_cap * (2 * i_cap + 1), dtype=torch.float32, device=inst.device)
    build.check(build.kernel_lib().ms3d_proposal_iou(
        point_idx.data_ptr(), prop_id.data_ptr(), valid.data_ptr(), keep_ptr, valid.shape[0],
        inst.data_ptr(), inst.shape[0], num.data_ptr(), widths, p_cap, i_cap,
        buf.data_ptr() + 4 * p_cap * i_cap, buf.data_ptr(),
        torch.cuda.current_stream(inst.device).cuda_stream), "proposal_iou")
    build.LAUNCHES["proposal_iou"] += 1
    return buf[:p_cap * i_cap].view(p_cap, i_cap)


def proposal_argmax_plain(ious: torch.Tensor, col_mask: torch.Tensor, thr: float) -> tuple:
    iou_m = torch.where(col_mask[None, :], ious, torch.zeros((), dtype=ious.dtype,
                                                              device=ious.device))
    # torch.max / argmax along a dim return the first index of the maximum
    mx, arg = iou_m.max(dim=1)
    return mx, arg.to(torch.int32), mx >= torch.tensor(thr, dtype=torch.float32)


def proposal_argmax(ious: torch.Tensor, col_mask: torch.Tensor, thr: float) -> tuple:
    """Per proposal, over ``where(col_mask, ious, 0.0)``: (max (P,) f32,
    first-index argmax (P,) int32, max >= thr (P,) bool). A proposal whose
    unmasked IoUs are all 0 gets index 0, masked or not, as jnp.argmax
    gives it. On the card: one K12 launch (phase 1 alone)."""
    if not _cuda_device(ious, "proposal_argmax"):
        return proposal_argmax_plain(ious, col_mask, thr)
    ious, col_mask = ious.contiguous(), col_mask.contiguous()
    if ious.dim() != 2 or ious.dtype != torch.float32:
        raise ValueError(f"proposal_argmax: ious must be a (P, I) f32 tensor, got "
                         f"{tuple(ious.shape)} {ious.dtype}")
    p, i = ious.shape
    if col_mask.shape != (i,) or col_mask.dtype != torch.bool:
        raise ValueError("proposal_argmax: col_mask must be a bool tensor of one entry per "
                         "column")
    dev = ious.device
    mx = torch.empty(p, dtype=torch.float32, device=dev)
    arg = torch.empty(p, dtype=torch.int32, device=dev)
    ok = torch.empty(p, dtype=torch.bool, device=dev)
    if p > 0:
        build.check(build.kernel_lib().ms3d_proposal_argmax(
            ious.data_ptr(), col_mask.data_ptr(), p, i, float(thr), mx.data_ptr(),
            arg.data_ptr(), ok.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
            "mask_label")
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
    (label (R,) bool, row_ok (R,) bool). On the card one K12 launch reads
    the classes, rows and ids in their own dtypes (int64 rows; int16, int32
    or int64 ids and classes): no cast, no host sync."""
    if not _cuda_device(ious, "get_mask_label"):
        return get_mask_label_plain(rows, p_cap, instance_ids, instance_cls, ious, iou_thr,
                                    ignored_label)
    ious = ious.contiguous()
    if ious.dim() != 2 or ious.dtype != torch.float32 or ious.shape[0] != p_cap:
        raise ValueError(f"get_mask_label: ious must be a ({p_cap}, I) f32 tensor, got "
                         f"{tuple(ious.shape)} {ious.dtype}")
    i_cap = ious.shape[1]
    cls, inst = instance_cls.contiguous(), instance_ids.contiguous()
    if cls.shape != (i_cap,):
        raise ValueError("get_mask_label: instance_cls must hold one class per column")
    point_idx, prop_id, valid = _row_arrays(rows, "get_mask_label")
    widths = _widths("get_mask_label", inst, cls)
    _same_device("get_mask_label", ious, cls, inst, point_idx, prop_id, valid)
    n = valid.shape[0]
    out = torch.empty((2, n), dtype=torch.bool, device=ious.device)   # label, row_ok
    build.check(build.kernel_lib().ms3d_mask_label(
        ious.data_ptr(), cls.data_ptr(), int(ignored_label), p_cap, i_cap, float(iou_thr),
        point_idx.data_ptr(), prop_id.data_ptr(), valid.data_ptr(), n, inst.data_ptr(),
        inst.shape[0], widths, out.data_ptr(), out.data_ptr() + n,
        torch.cuda.current_stream(ious.device).cuda_stream), "mask_label")
    build.LAUNCHES["mask_label"] += 1
    label, row_ok = out.unbind(0)
    return label, row_ok
