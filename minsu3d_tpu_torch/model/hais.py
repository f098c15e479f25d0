"""HAIS: backbone, one shifted-coordinate unit clustering, hierarchical set
aggregation, TinyUnet refinement with the mask and score branches; the
losses; host-side instance extraction without NMS.

Counterpart of minsu3d_tpu/model/hais.py: ``hierarchical_aggregation``
(:31-123; the per-cluster centers and class/batch maxima on K6, the absorb
step on K8 ``set_aggregation``), the forward of ``HAISNet`` (:126-220,
default conv dispatch, train and eval; the shifted clustering on (voxel,
class) or shifted-grid units, at unit or point granularity), ``losses``
(:249-278: the mask BCE on K12's labels, the score BCE on K5's IoU,
mask-filtered on K5 from ``cal_iou_based_on_mask_start_epoch``),
``pred_instances`` (:281-315), ``forward_flags`` (:318-327) and
``loss_flags`` (:330). The forward is split into ``backbone_forward`` and
``heads`` (``general_model.BackboneHeadsNet``). Module names follow the
flax names (``backbone``, ``tiny_unet``, ``mask_branch_0/1``,
``score_branch``) so that ``minsu3d_tpu_torch.convert`` maps the weights.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from minsu3d_tpu_torch.config import HaisEvalConfig, HaisTrainConfig, StaticCaps
from minsu3d_tpu_torch.evaluation.instance_segmentation import rle_encode
from minsu3d_tpu_torch.model import general_model as gm
from minsu3d_tpu_torch.model.module.blocks import Backbone
from minsu3d_tpu_torch.model.module.dense_blocks import DenseTinyUnet
from minsu3d_tpu_torch.model.pointgroup import foreground_mask, rows_to_masks
from minsu3d_tpu_torch.ops import segment
from minsu3d_tpu_torch.ops.cluster import Clusters
from minsu3d_tpu_torch.ops.instance_iou import get_iou, get_mask_label
from minsu3d_tpu_torch.ops.set_aggregation import MAX_PRIMARIES, set_aggregation


def hierarchical_aggregation(clus: Clusters, shifted: torch.Tensor, batch_ids: torch.Tensor,
                             sem_preds: torch.Tensor, active: torch.Tensor,
                             point_num_avg: torch.Tensor, radius_avg: torch.Tensor,
                             p_cap: int, use_set_aggr: bool):
    """Split clusters into fragment / kept / primary by class-relative size
    and absorb fragments into their nearest primary. Returns (rows dict:
    point_idx, prop_id, valid, n_proposals -- 2 rows per point, kept path
    then primary path; primaries_dropped: primaries beyond the 512-slot
    table, which lose absorption; kinds: the counts of primary, fragment,
    kept and absorbed clusters, which the JAX function does not return)."""
    c_cap = clus.sizes.shape[0]
    n = shifted.shape[0]
    dev = shifted.device
    pc = clus.point_cluster
    csr = segment.segment_csr(torch.where(active, pc, torch.full_like(pc, c_cap)), c_cap)

    # per-cluster class / batch (int max, -1 when empty) and centre (an
    # ordered f32 sum of the members' shifted coordinates)
    ints = torch.stack([sem_preds.to(torch.int32), batch_ids.to(torch.int32)], 1)
    mx = segment.segment_reduce(ints, csr, "max", -1)
    cls, cbatch = mx[:, 0].contiguous(), mx[:, 1].contiguous()
    csum = segment.segment_reduce(shifted.to(torch.float32).contiguous(), csr, "sum")
    centers = csum / clus.sizes.clamp(min=1)[:, None].to(torch.float32)

    cls_c = cls.long().clamp(0, point_num_avg.shape[0] - 1)
    mean_np = point_num_avg[cls_c]
    low = 0.05 * mean_np
    high = 0.3 * mean_np
    size_f = clus.sizes.to(torch.float32)
    primary = clus.valid & (size_f >= high)
    fragment = clus.valid & (size_f < high)
    kept = fragment & (size_f >= low)

    # proposal ids: kept first, then primaries (reference hais_ops.py:57-72)
    none = torch.full((c_cap,), p_cap, dtype=torch.int64, device=dev)
    kept_prop = torch.where(kept, torch.cumsum(kept.to(torch.int64), 0) - 1, none)
    n_kept = kept.sum()
    prim_rank = torch.cumsum(primary.to(torch.int64), 0) - 1
    prim_prop = torch.where(primary, n_kept + prim_rank, none)
    n_props = torch.clamp(n_kept + primary.sum(), max=p_cap)

    if use_set_aggr:
        # the primaries compacted to a static table of p2 slots in cluster
        # order, so the argmin's first-index rule is the dense form's
        p2 = min(c_cap, MAX_PRIMARIES)
        n_primary = primary.sum()
        primaries_dropped = torch.clamp(n_primary - p2, min=0)
        slot = torch.where(primary & (prim_rank < p2), prim_rank,
                           torch.full_like(prim_rank, p2))

        def compact(values, fill):
            table = torch.full((p2 + 1,) + values.shape[1:], fill, dtype=values.dtype,
                               device=dev)
            keep = slot < p2
            table[slot[keep]] = values[keep]
            return table[:p2]

        prim_path = set_aggregation(
            centers, cls, cbatch, fragment, primary, prim_prop, radius_avg[cls_c],
            compact(centers, 0.0), compact(cls, -2), compact(cbatch, -2), compact(size_f, 0.0),
            compact(prim_prop, p_cap), compact(primary, False), p_cap)
    else:
        prim_path = prim_prop
        primaries_dropped = torch.zeros((), dtype=torch.int64, device=dev)

    end = torch.full((1,), p_cap, dtype=torch.int64, device=dev)
    kept_ext = torch.cat([kept_prop, end])
    prim_ext = torch.cat([prim_path.long(), end])
    pid1 = torch.where(active, kept_ext[pc], torch.full_like(pc, p_cap))
    pid2 = torch.where(active, prim_ext[pc], torch.full_like(pc, p_cap))
    point_idx = torch.arange(n, device=dev)
    rows = {"point_idx": torch.cat([point_idx, point_idx]),
            "prop_id": torch.cat([pid1.clamp(max=p_cap), pid2.clamp(max=p_cap)]),
            "valid": torch.cat([pid1 < p_cap, pid2 < p_cap]),
            "n_proposals": n_props}
    kinds = {"primary": primary.sum(), "fragment": fragment.sum(), "kept": kept.sum(),
             "absorbed": (fragment & (prim_path < p_cap)).sum()}
    return rows, primaries_dropped, kinds


class HAISNet(gm.BackboneHeadsNet):
    """HAIS over one collated batch of tensors; ``split`` picks the
    capacities (``StaticCaps.from_cfg``)."""

    def __init__(self, cfg: HaisEvalConfig | HaisTrainConfig, split: str = "val"):
        super().__init__()
        net = cfg.net
        self.cfg = cfg
        self.caps = StaticCaps.from_cfg(cfg, split)
        self.backbone = Backbone(net.input_channel, net.m, net.blocks, net.block_reps,
                                 cfg.classes, gm.compute_dtype(cfg))
        self.tiny_unet = DenseTinyUnet(net.m, gm.compute_dtype(cfg))
        self.mask_branch_0 = nn.Linear(net.m, net.m)
        self.mask_branch_1 = nn.Linear(net.m, 1)
        self.score_branch = nn.Linear(net.m, 1)

    def heads(self, batch: dict, out: dict, train: bool = False, jitter=gm.EVAL_JITTER,
              use_set_aggr: bool = True, mask_filter_score_feature: bool = False,
              mask_filter_thre: float = 0.5) -> dict:
        """Clustering, set aggregation, proposal volumes, mask and proposal
        scores from the backbone outputs."""
        cfg, net, c = self.cfg, self.cfg.net, self.caps
        dev = batch["point_xyz"].device
        sem_preds = out["semantic_scores"].argmax(1)
        obj = foreground_mask(sem_preds, batch["point_mask"], cfg.ignore_classes)
        xyz = batch["point_xyz"]
        shifted = xyz + out["point_offsets"].detach()
        bids = batch["vert_batch_ids"]
        if c.shifted_units:
            s_cell = c.shifted_grid_cell or cfg.voxel_size
            units, units_dropped = gm.make_units_grid(bids, shifted, sem_preds, obj,
                                                      c.cluster_units_shifted, s_cell)
            clus = gm.cluster_step(shifted, bids, obj, sem_preds, net.point_aggr_radius, c,
                                   units, u_cap=c.cluster_units_shifted, grid_cell=s_cell)
        else:
            units, units_dropped = gm.make_units(batch["p2v"], sem_preds, obj,
                                                 c.cluster_units)
            clus = gm.cluster_step(shifted, bids, obj, sem_preds, net.point_aggr_radius, c,
                                   units)
        rows, primaries_dropped, kinds = hierarchical_aggregation(
            clus, shifted, bids, sem_preds, obj,
            torch.tensor(cfg.point_num_avg, dtype=torch.float32, device=dev),
            torch.tensor(cfg.radius_avg, dtype=torch.float32, device=dev),
            c.proposals, use_set_aggr)
        out = dict(out)
        out["proposal_rows"] = rows
        out["cluster_kinds"] = kinds
        out["diag"] = {"units_dropped": units_dropped,
                       "edges_dropped": clus.edges_dropped,
                       "clusters_dropped": clus.clusters_dropped,
                       "primaries_dropped": primaries_dropped,
                       "cc_unconverged": clus.cc_unconverged}
        csr = gm.proposal_csr(rows, c.proposals)   # one CSR for the pool and the placement
        volume, occ, row_cell = gm.clusters_voxelization_dense(
            rows, c.proposals, out["point_features"], xyz, net.score_scale,
            net.score_fullscale, jitter, csr)
        inst_feats = self.tiny_unet(volume, occ, train)

        # mask branch on the voxels, then devoxelize (reference hais.py:79-81)
        mask_vox = self.mask_branch_1(torch.relu(self.mask_branch_0(inst_feats)))
        mask_scores = gm.devoxelize_dense(mask_vox, row_cell)[:, 0]
        out["mask_scores"] = mask_scores

        score_feats = gm.devoxelize_dense(inst_feats, row_cell)
        if mask_filter_score_feature:
            keep = torch.sigmoid(mask_scores) >= mask_filter_thre
            score_feats = score_feats * keep[:, None].to(score_feats.dtype)
        prop_feats = segment.csr_max(score_feats, csr)   # roipool
        out["proposal_scores"] = self.score_branch(prop_feats)[:, 0]
        return out


def losses(cfg: HaisTrainConfig, caps: StaticCaps, batch: dict, out: dict, with_heads: bool,
           iou_on_mask: bool = False) -> dict:
    """Semantic and offset losses, plus, when the heads ran, the mask BCE
    (rows supervised by ``get_mask_label``, divided by the count of valid
    rows) and the score BCE against ``get_segmented_scores`` of each
    proposal's max IoU (reference hais.py:94-127). ``iou_on_mask`` counts
    only the rows whose mask sigmoid is above 0.5 in that IoU."""
    result = gm.shared_losses(batch, out)
    if not with_heads:
        return result
    rows = out["proposal_rows"]
    mask_sig = torch.sigmoid(out["mask_scores"])
    keep = (mask_sig.detach() > 0.5) if iou_on_mask else None
    ious = get_iou(rows, caps.proposals, batch["instance_ids"], batch["instance_num_point"],
                   caps.instances, row_keep=keep)
    mask_label, mask_valid = get_mask_label(rows, caps.proposals, batch["instance_ids"],
                                            batch["instance_semantic_cls"], ious, 0.5, -1)
    w = (mask_valid & rows["valid"]).to(torch.float32)
    n_valid = rows["valid"].sum().clamp(min=1)
    result["mask_loss"] = (gm.clipped_bce(mask_sig, mask_label) * w).sum() / n_valid

    gt_scores = gm.get_segmented_scores(ious.amax(1), cfg.net.fg_thresh, cfg.net.bg_thresh)
    logits = out["proposal_scores"]
    prop_valid = (torch.arange(caps.proposals, device=logits.device)
                  < rows["n_proposals"]).to(torch.float32)
    sbce = logits.clamp(min=0) - logits * gt_scores + torch.log1p(torch.exp(-logits.abs()))
    result["score_loss"] = (sbce * prop_valid).sum() / prop_valid.sum().clamp(min=1.0)
    return result


def forward_flags(cfg: HaisEvalConfig, epoch: int, train: bool) -> dict:
    """Epoch/phase-gated head behaviour (reference hais.py:52,83-86)."""
    net = cfg.net
    return {
        "use_set_aggr": bool(net.using_set_aggr_in_training if train
                             else net.using_set_aggr_in_testing),
        "mask_filter_score_feature": epoch > net.use_mask_filter_score_feature_start_epoch,
        "mask_filter_thre": float(net.mask_filter_score_feature_thre),
    }


def loss_flags(cfg: HaisTrainConfig, epoch: int) -> dict:
    """The IoU source switches from the clusters to the predicted masks
    (reference hais.py:104-116)."""
    return {"iou_on_mask": epoch > cfg.net.cal_iou_based_on_mask_start_epoch}


# config overrides that open the mask-IoU and mask-filter gates from the
# first heads-on epoch (short runs that must exercise them)
OPEN_GATES = {"net.cal_iou_based_on_mask_start_epoch": 0,
              "net.use_mask_filter_score_feature_start_epoch": 0}


def pred_instances(cfg: HaisEvalConfig, scan_id: str, xyz: np.ndarray, out_np: dict,
                   num_ignored_classes: int) -> list:
    """Host-side extraction (reference hais.py:210-247): mask-score outlier
    filter, score and npoint thresholds, no NMS."""
    test_cfg = cfg.net.test
    n = xyz.shape[0]
    sem_labels = out_np["semantic_scores"].argmax(1)
    rows = dict(out_np["proposal_rows"])
    n_props = int(rows["n_proposals"])
    scores = 1.0 / (1.0 + np.exp(-out_np["proposal_scores"][:n_props]))

    rows["valid"] = rows["valid"] & (out_np["mask_scores"] > test_cfg.test_mask_score_thre)
    masks = rows_to_masks(rows, n_props, n)

    keep = scores > test_cfg.TEST_SCORE_THRESH
    scores, masks = scores[keep], masks[keep]
    npoint = masks.sum(1)
    keep = npoint >= test_cfg.TEST_NPOINT_THRESH
    scores, masks = scores[keep], masks[keep]

    instances = []
    for i in range(len(scores)):
        mask = masks[i]
        pred_xyz = xyz[mask]
        instances.append({
            "scan_id": scan_id,
            "label_id": int(sem_labels[mask][0]) - num_ignored_classes + 1,
            "conf": float(scores[i]),
            "pred_mask": rle_encode(mask),
            "pred_bbox": np.concatenate((pred_xyz.min(0), pred_xyz.max(0))),
        })
    return instances
