"""SoftGroup: backbone, soft grouping over (point, class) pairs, proposal
volumes, TinyUnet refinement with the classification, mask-scoring and
IoU-score branches over K+1 classes; the losses; host-side per-class
extraction.

Counterpart of minsu3d_tpu/model/softgroup.py: ``soft_grouping`` (:27-83,
one clustering per foreground class, then the cross-class merge),
``soft_grouping_packed`` (:86-178, one clustering over the class-major
(point, class) pairs: K10 ``pack_pairs`` packs the pairs, K6 takes
each cluster's class, K11 ``proposal_rank`` ranks the clusters class-major
and gives every pair its proposal), ``compact_rows`` and
``soft_grouping_compacted`` (:181-204, on K10's ``compact_rows``), the forward of
``SoftGroupNet`` (:207-322, train and eval), ``losses`` (:342-393: the
classification CE on K12's per-proposal argmax, the mask BCE on K12's row
labels, the IoU-score MSE against K5's mask-filtered IoU),
``pred_instances`` (:396-433) and the empty ``forward_flags`` /
``loss_flags``. Both groupings run at unit or point granularity
(``cluster_granularity``); the packed one takes shifted-grid pair units
with ``shifted_units``, as the JAX package does. The forward is split into
``backbone_forward`` and ``heads`` (``general_model.BackboneHeadsNet``).
Module names follow the flax names (``backbone``, ``tiny_unet``,
``mask_scoring_0/1``, ``classification_branch``, ``iou_score``) so that
``minsu3d_tpu_torch.convert`` maps the weights.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from minsu3d_tpu_torch.config import SoftGroupEvalConfig, SoftGroupTrainConfig, StaticCaps
from minsu3d_tpu_torch.evaluation.instance_segmentation import rle_encode
from minsu3d_tpu_torch.model import general_model as gm
from minsu3d_tpu_torch.model.module.blocks import Backbone
from minsu3d_tpu_torch.model.module.dense_blocks import DenseTinyUnet
from minsu3d_tpu_torch.ops import segment, stable_partition
from minsu3d_tpu_torch.ops.instance_iou import get_iou, get_mask_label, proposal_argmax
from minsu3d_tpu_torch.ops.proposal_rank import proposal_rank


def _f32(x: float, dev) -> torch.Tensor:
    """A Python float as the f32 scalar that JAX's weak typing makes of it,
    filled on the device (no host copy, so no wait for the card)."""
    return torch.full((), x, dtype=torch.float32, device=dev)


def class_flags(sem_softmax: torch.Tensor, point_mask: torch.Tensor, cls_ids: torch.Tensor,
                score_thr: float, min_npoint: int) -> torch.Tensor:
    """(N, K) bool: point i is active for foreground class j when its
    softmax exceeds ``score_thr``; a class with fewer than ``min_npoint``
    active points is skipped (the reference's skip-class rule)."""
    probs = sem_softmax[:, cls_ids]
    active = point_mask[:, None] & (probs > _f32(score_thr, probs.device))
    return active & (active.sum(0) >= min_npoint)[None, :]


def soft_grouping(sem_softmax, shifted, batch_ids, point_mask, fg_class_ids: tuple,
                  score_thr: float, radius: float, npoint_thr: float,
                  point_num_avg: torch.Tensor, min_npoint: int, max_proposal_num: int,
                  caps: StaticCaps, p2v: torch.Tensor, big_thre: int = 1) -> tuple:
    """One clustering per foreground class (of (voxel) units, or of points
    at point granularity), merged into one proposal id space class by class
    (K*N rows, class-major). Returns (rows, diag)."""
    n = shifted.shape[0]
    dev = shifted.device
    cls_ids = gm.device_constant(fg_class_ids, torch.int64, dev)
    active_all = class_flags(sem_softmax, point_mask, cls_ids, score_thr, min_npoint)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    units_dropped, edges_dropped, clusters_dropped, unconverged = zero, zero, zero, zero
    no_group = torch.zeros_like(batch_ids)
    pc_all, ok_all = [], []
    for j, class_id in enumerate(fg_class_ids):
        active = active_all[:, j]
        units, dropped = None, zero
        if caps.unit_clustering:
            units, dropped = gm.make_units(p2v, torch.zeros_like(p2v), active,
                                           caps.cluster_units)
        clus = gm.cluster_step(shifted, batch_ids, active, no_group, radius, caps, units,
                               big_thre=big_thre)
        thr = _f32(npoint_thr, dev) * point_num_avg[class_id]
        ok_all.append(clus.valid & (clus.sizes.to(torch.float32) >= thr))
        pc_all.append(clus.point_cluster)
        units_dropped = units_dropped + dropped
        edges_dropped = edges_dropped + clus.edges_dropped
        clusters_dropped = clusters_dropped + clus.clusters_dropped
        unconverged = unconverged + clus.cc_unconverged
    pc_all, ok_all = torch.stack(pc_all), torch.stack(ok_all)             # (K, N), (K, C)

    p_cap = caps.proposals
    limit = min(max_proposal_num, p_cap)
    ok_i = ok_all.to(torch.int64)
    counts = ok_i.sum(1)
    bases = torch.cumsum(counts, 0) - counts
    prop = torch.where(ok_all, bases[:, None] + torch.cumsum(ok_i, 1) - 1,
                       torch.full_like(ok_i, limit))
    prop = torch.where(prop < limit, prop, torch.full_like(prop, p_cap))
    prop_ext = torch.cat([prop, prop.new_full((prop.shape[0], 1), p_cap)], 1)
    pid = torch.gather(prop_ext, 1, pc_all)
    k = len(fg_class_ids)
    rows = {"point_idx": torch.arange(n, device=dev).repeat(k),
            "prop_id": pid.clamp(max=p_cap).reshape(-1),
            "valid": (pid < p_cap).reshape(-1),
            "n_proposals": counts.sum().clamp(max=limit)}
    return rows, {"pairs_dropped": zero, "units_dropped": units_dropped,
                  "edges_dropped": edges_dropped, "clusters_dropped": clusters_dropped,
                  "cc_unconverged": unconverged}


def soft_grouping_packed(sem_softmax, shifted, batch_ids, point_mask, fg_class_ids: tuple,
                         score_thr: float, radius: float, npoint_thr: float,
                         point_num_avg: torch.Tensor, min_npoint: int, max_proposal_num: int,
                         caps: StaticCaps, p2v: torch.Tensor, pair_cap: int,
                         voxel_size: float = 0.02, big_thre: int = 1) -> tuple:
    """One clustering over the active (point, class) pairs, at most
    ``pair_cap`` of them, packed class-major by K10; the class folds into
    the units' key and the ball query's group. The pairs cluster as (voxel,
    class) units, as units of a grid of ``caps.shifted_grid_cell`` (0:
    ``voxel_size``) in the shifted coordinates with ``caps.shifted_units``,
    or as pairs at point granularity. Clusters are ranked class-major by
    K11. Returns (rows, diag); pairs beyond ``pair_cap`` are dropped and
    counted in ``pairs_dropped``."""
    dev = shifted.device
    cls_ids = gm.device_constant(fg_class_ids, torch.int64, dev)
    active = class_flags(sem_softmax, point_mask, cls_ids, score_thr, min_npoint)
    pair_point, pair_class, pair_valid, pairs_dropped = stable_partition.pack_pairs(
        active, pair_cap)

    pcoords, pbatch = shifted[pair_point], batch_ids[pair_point]
    units, units_dropped = None, torch.zeros((), dtype=torch.int64, device=dev)
    u_cap, s_cell = caps.cluster_units, 0.0
    if caps.unit_clustering and caps.shifted_units:
        u_cap = caps.cluster_units_shifted
        s_cell = caps.shifted_grid_cell or voxel_size
        units, units_dropped = gm.make_units_grid(pbatch, pcoords, pair_class, pair_valid,
                                                  u_cap, s_cell)
    elif caps.unit_clustering:
        # the voxel id goes in the unclipped key_hi slot (softgroup.py:142-144)
        units, units_dropped = gm.make_units(p2v[pair_point], pair_class, pair_valid,
                                             caps.cluster_units)
    clus = gm.cluster_step(pcoords, pbatch, pair_valid, pair_class, radius, caps, units,
                           u_cap=u_cap, grid_cell=s_cell, big_thre=big_thre)

    # per-cluster class: the int max of its pairs' classes (K6; -1 when
    # empty); pairs of no cluster form the padding segment
    c_cap = caps.clusters
    pc = clus.point_cluster
    csr = segment.segment_csr(torch.where(pair_valid, pc, torch.full_like(pc, c_cap)), c_cap)
    ccls = segment.segment_reduce(pair_class.to(torch.int32)[:, None].contiguous(), csr,
                                  "max", -1)[:, 0]
    p_cap = caps.proposals
    prop_id, valid, n_props = proposal_rank(
        ccls, clus.sizes, clus.valid, point_num_avg[cls_ids], npoint_thr,
        min(max_proposal_num, p_cap), p_cap, pc, pair_valid)
    rows = {"point_idx": pair_point, "prop_id": prop_id, "valid": valid, "n_proposals": n_props}
    return rows, {"pairs_dropped": pairs_dropped, "units_dropped": units_dropped,
                  "edges_dropped": clus.edges_dropped,
                  "clusters_dropped": clus.clusters_dropped,
                  "cc_unconverged": clus.cc_unconverged}


def compact_rows(rows: dict, r_cap: int) -> dict:
    """The valid rows first, in row order, into ``r_cap`` rows (K10 and
    its gather, one launch on the card)."""
    point_idx, prop_id, valid = stable_partition.compact_rows(
        rows["point_idx"], rows["prop_id"], rows["valid"], r_cap)
    return {"point_idx": point_idx, "prop_id": prop_id, "valid": valid,
            "n_proposals": rows["n_proposals"]}


def soft_grouping_compacted(*args, r_cap: int, **kwargs) -> tuple:
    """``soft_grouping`` compacted to ``r_cap`` rows; valid rows beyond it
    are dropped and counted in ``pairs_dropped``."""
    rows, diag = soft_grouping(*args, **kwargs)
    n_valid = rows["valid"].sum()
    diag["pairs_dropped"] = diag["pairs_dropped"] + (n_valid - r_cap).clamp(min=0)
    return compact_rows(rows, r_cap), diag


def pooled_mean(feats: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """(P, C) occupancy-weighted mean of each proposal's (S, S, S, C)
    volume (softgroup.py:303-306): the sum and the count in the features'
    dtype, the count at least 1. The TinyUnet hands back f32 in both
    precisions (its down conv returns f32, ``dense_blocks``), so the count
    is exact: the JAX bf16 forward's jaxpr reduces both in f32."""
    occ_f = occ[..., None].to(feats.dtype)
    return (feats * occ_f).sum((1, 2, 3)) / occ_f.sum((1, 2, 3)).clamp(min=1.0)


class SoftGroupNet(gm.BackboneHeadsNet):
    """SoftGroup over one collated batch of tensors; ``split`` picks the
    capacities (``StaticCaps.from_cfg``)."""

    def __init__(self, cfg: SoftGroupEvalConfig | SoftGroupTrainConfig, split: str = "val"):
        super().__init__()
        net = cfg.net
        self.cfg = cfg
        self.caps = StaticCaps.from_cfg(cfg, split)
        self.fg_class_ids = tuple(c for c in range(cfg.classes)
                                  if c + 1 not in cfg.ignore_classes)
        k1 = len(self.fg_class_ids) + 1
        self.backbone = Backbone(net.input_channel, net.m, net.blocks, net.block_reps,
                                 cfg.classes, gm.compute_dtype(cfg))
        self.tiny_unet = DenseTinyUnet(net.m, gm.compute_dtype(cfg))
        self.mask_scoring_0 = nn.Linear(net.m, net.m)
        self.mask_scoring_1 = nn.Linear(net.m, k1)
        self.classification_branch = nn.Linear(net.m, k1)
        self.iou_score = nn.Linear(net.m, k1)

    def heads(self, batch: dict, out: dict, train: bool = False,
              jitter=gm.EVAL_JITTER) -> dict:
        """Soft grouping, proposal volumes, mask / class / IoU scores from
        the backbone outputs."""
        cfg, net, c = self.cfg, self.cfg.net, self.caps
        g = net.grouping_cfg
        xyz = batch["point_xyz"]
        sem_softmax = torch.softmax(out["semantic_scores"], dim=-1).detach()
        shifted = xyz + out["point_offsets"].detach()
        pna = gm.device_constant(cfg.point_num_avg, torch.float32, xyz.device)
        # components below every class's size filter cannot become proposals,
        # so they do not count as dropped clusters (Python float arithmetic)
        big = max(int(g.npoint_thr * min(cfg.point_num_avg[i] for i in self.fg_class_ids)), 1)
        args = (sem_softmax, shifted, batch["vert_batch_ids"], batch["point_mask"],
                self.fg_class_ids, g.score_thr, g.radius, g.npoint_thr, pna,
                net.test_cfg.min_npoint, net.train_cfg.max_proposal_num, c, batch["p2v"])
        n = xyz.shape[0]
        if g.packed:
            rows, diag = soft_grouping_packed(*args, pair_cap=2 * n, voxel_size=cfg.voxel_size,
                                              big_thre=big)
        else:
            rows, diag = soft_grouping_compacted(
                *args, r_cap=min(n * len(self.fg_class_ids), 2 * n), big_thre=big)
        out = dict(out)
        out["proposal_rows"] = rows
        out["diag"] = diag

        v = net.instance_voxel_cfg
        volume, occ, row_cell = gm.clusters_voxelization_dense(
            rows, c.proposals, out["point_features"], xyz, v.scale, v.spatial_shape, jitter)
        feats = self.tiny_unet(volume, occ, train)
        mask_vox = self.mask_scoring_1(torch.relu(self.mask_scoring_0(feats)))
        out["mask_scores"] = gm.devoxelize_dense(mask_vox, row_cell)       # (R, K+1)
        pooled = pooled_mean(feats, occ)
        out["cls_scores"] = self.classification_branch(pooled)
        out["iou_scores"] = self.iou_score(pooled)
        return out


def losses(cfg: SoftGroupTrainConfig, caps: StaticCaps, batch: dict, out: dict,
           with_heads: bool) -> dict:
    """Semantic and offset losses, plus, when the heads ran, the
    classification CE over K+1 classes, the mask BCE at each row's
    proposal label and the IoU-score MSE against the IoU of the
    mask-filtered proposals (reference softgroup.py:127-183)."""
    result = gm.shared_losses(batch, out)
    if not with_heads:
        return result
    k = cfg.classes - len(cfg.ignore_classes)
    pos_iou_thr = cfg.net.train_cfg.pos_iou_thr
    rows, p_cap = out["proposal_rows"], caps.proposals
    dev = out["cls_scores"].device
    prop_valid = torch.arange(p_cap, device=dev) < rows["n_proposals"]
    ious = get_iou(rows, p_cap, batch["instance_ids"], batch["instance_num_point"],
                   caps.instances)

    inst_cls = batch["instance_semantic_cls"].long()
    fg = (inst_cls != -1) & batch["instance_mask"]
    _, arg, pos = proposal_argmax(ious, fg, pos_iou_thr)
    labels = torch.where(pos, inst_cls[arg.long()].clamp(0, k), torch.full_like(inst_cls[:1], k))
    logp = torch.log_softmax(out["cls_scores"], dim=-1)
    ce = -logp.gather(1, labels[:, None])[:, 0]
    pv = prop_valid.to(torch.float32)
    result["classification_loss"] = (ce * pv).sum() / pv.sum().clamp(min=1.0)

    # the mask score at each row's proposal label: a gather whose backward
    # writes one element per row (no two rows share one), so it is exact
    pid = rows["prop_id"].long().clamp(max=p_cap - 1)
    row_cls = labels[pid]
    mask_slice = torch.sigmoid(out["mask_scores"].gather(1, row_cls[:, None])[:, 0])
    mask_label, mask_valid = get_mask_label(rows, p_cap, batch["instance_ids"], inst_cls, ious,
                                            pos_iou_thr, -1)
    w = (mask_valid & rows["valid"]).to(torch.float32)
    result["mask_scoring_loss"] = (gm.clipped_bce(mask_slice, mask_label) * w).sum() / (w.sum() + 1)

    # the IoU score against the IoU of the rows whose mask sigmoid is above 0.5
    ious_on_pred = get_iou(rows, p_cap, batch["instance_ids"], batch["instance_num_point"],
                           caps.instances, row_keep=mask_slice.detach() > 0.5)
    gt_iou, _, _ = proposal_argmax(ious_on_pred, fg, pos_iou_thr)
    iou_slice = out["iou_scores"].gather(1, labels[:, None])[:, 0]
    wgt = ((labels < k) & prop_valid).to(torch.float32)
    result["iou_scoring_loss"] = (((iou_slice - gt_iou) ** 2) * wgt).sum() / (wgt.sum() + 1)
    return result


def forward_flags(cfg: SoftGroupEvalConfig, epoch: int, train: bool) -> dict:
    return {}


def loss_flags(cfg: SoftGroupEvalConfig, epoch: int) -> dict:
    return {}


def pred_instances(cfg: SoftGroupEvalConfig, scan_id: str, xyz: np.ndarray, out_np: dict,
                   num_ignored_classes: int) -> list:
    """Per-class extraction (reference softgroup.py:302-355): confidence =
    class softmax * clamp(IoU score, 0, 1), mask = rows whose mask score
    for the class exceeds ``mask_score_thr``, no NMS."""
    test_cfg = cfg.net.test_cfg
    instance_classes = cfg.classes - num_ignored_classes
    n = xyz.shape[0]
    rows = out_np["proposal_rows"]
    n_props = int(rows["n_proposals"])
    cls = out_np["cls_scores"][:n_props]
    e = np.exp(cls - cls.max(1, keepdims=True))
    cls_softmax = e / e.sum(1, keepdims=True)
    iou_scores = out_np["iou_scores"][:n_props]

    instances = []
    v = rows["valid"]
    r_prop, r_point = rows["prop_id"][v], rows["point_idx"][v]
    r_mask_scores = out_np["mask_scores"][v]
    for i in range(instance_classes):
        cur_cls = cls_softmax[:, i]
        score = cur_cls * np.clip(iou_scores[:, i], 0, 1)
        sel = r_mask_scores[:, i] > test_cfg.mask_score_thr
        masks = np.zeros((n_props, n), dtype=bool)
        masks[r_prop[sel], r_point[sel]] = True
        keep = (cur_cls > test_cfg.cls_score_thr) & (masks.sum(1) >= test_cfg.min_npoint)
        for p in np.flatnonzero(keep):
            mask = masks[p]
            pred_xyz = xyz[mask]
            instances.append({
                "scan_id": scan_id,
                "label_id": i + 1,
                "conf": float(score[p]),
                "pred_mask": rle_encode(mask),
                "pred_bbox": np.concatenate((pred_xyz.min(0), pred_xyz.max(0))),
            })
    return instances
