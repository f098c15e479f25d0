"""PointGroup: backbone, dual unit clustering, proposal merge, dense
ScoreNet, roipool, score; the losses; host NMS.

Counterpart of minsu3d_tpu/model/pointgroup.py: ``merge_clusterings``
(:27), ``foreground_mask`` (:65), the forward of ``PointGroupNet`` (:74-173,
default conv dispatch, train and eval; the xyz clustering on (voxel, class)
or xyz-grid units, the shifted one on the same units or on shifted-grid
units, at unit or point granularity), ``losses`` (:201-213), ``nms_instances`` /
``rows_to_masks`` / ``pred_instances`` (:216-275, numpy) and
``forward_flags`` / ``loss_flags`` (:276-281). The forward is split in two,
``backbone_forward`` and ``heads`` (``general_model.BackboneHeadsNet``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from minsu3d_tpu_torch.config import EvalConfig, StaticCaps
from minsu3d_tpu_torch.evaluation.instance_segmentation import rle_encode
from minsu3d_tpu_torch.model import general_model as gm
from minsu3d_tpu_torch.model.module.blocks import Backbone
from minsu3d_tpu_torch.model.module.dense_blocks import DenseTinyUnet
from minsu3d_tpu_torch.ops import segment
from minsu3d_tpu_torch.ops.instance_iou import get_iou


def merge_clusterings(clusterings: list, thresholds: list, n_points: int, p_cap: int):
    """Concatenate clusterings into one proposal id space, dropping clusters
    below their size threshold; R = len(clusterings) * N membership rows.
    Returns (rows dict: point_idx, prop_id, valid, n_proposals; dropped)."""
    pts, pids, valids = [], [], []
    base = 0
    dev = clusterings[0].point_cluster.device
    for clus, thr in zip(clusterings, thresholds):
        ok = clus.valid & (clus.sizes >= thr)
        prop = torch.where(ok, base + torch.cumsum(ok.to(torch.int64), 0) - 1,
                           torch.full(ok.shape, p_cap, dtype=torch.int64, device=dev))
        prop = torch.where(prop < p_cap, prop, torch.full_like(prop, p_cap))
        prop_ext = torch.cat([prop, prop.new_full((1,), p_cap)])
        pid = prop_ext[clus.point_cluster]
        valid = pid < p_cap
        pts.append(torch.arange(n_points, device=dev))
        pids.append(torch.where(valid, pid, torch.full_like(pid, p_cap)))
        valids.append(valid)
        base = base + ok.sum()
    n_props = torch.clamp(torch.as_tensor(base), max=p_cap)
    rows = {"point_idx": torch.cat(pts), "prop_id": torch.cat(pids),
            "valid": torch.cat(valids), "n_proposals": n_props}
    return rows, base - n_props


def foreground_mask(semantic_preds: torch.Tensor, point_mask: torch.Tensor,
                    ignore_classes) -> torch.Tensor:
    """Exclude predicted ignore classes (reference pointgroup.py:30-35)."""
    m = point_mask
    for cl in ignore_classes:
        m = m & (semantic_preds != cl - 1)
    return m


class PointGroupNet(gm.BackboneHeadsNet):
    """PointGroup over one collated batch of tensors; ``split`` picks the
    capacities (``StaticCaps.from_cfg``), as the JAX ``make_net`` does."""

    def __init__(self, cfg: EvalConfig, split: str = "val"):
        super().__init__()
        net = cfg.net
        self.cfg = cfg
        self.caps = StaticCaps.from_cfg(cfg, split)
        self.backbone = Backbone(net.input_channel, net.m, net.blocks, net.block_reps,
                                 cfg.classes, gm.compute_dtype(cfg))
        self.score_net = DenseTinyUnet(net.m, gm.compute_dtype(cfg))
        self.score_branch = nn.Linear(net.m, 1)

    def heads(self, batch: dict, out: dict, train: bool = False,
              jitter=gm.EVAL_JITTER) -> dict:
        """Clustering, proposals and scores from the backbone outputs;
        ``jitter`` places the proposals in their volumes
        (``general_model.clusters_voxelization_dense``)."""
        net, c = self.cfg.net, self.caps
        sem_preds = out["semantic_scores"].argmax(1)
        obj = foreground_mask(sem_preds, batch["point_mask"], self.cfg.ignore_classes)
        xyz = batch["point_xyz"]
        shifted = xyz + out["point_offsets"].detach()
        bids = batch["vert_batch_ids"]
        if c.xyz_grid_cell > 0:
            units, units_dropped = gm.make_units_grid(bids, xyz, sem_preds, obj,
                                                      c.cluster_units, c.xyz_grid_cell)
        else:
            units, units_dropped = gm.make_units(batch["p2v"], sem_preds, obj,
                                                 c.cluster_units)
        clus = gm.cluster_step(xyz, bids, obj, sem_preds, net.cluster_radius, c, units,
                               edge_factor=c.edge_factor_xyz or None,
                               grid_cell=c.xyz_grid_cell, big_thre=net.cluster_npoint_thre)
        if c.shifted_units:
            s_cell = c.shifted_grid_cell or self.cfg.voxel_size
            units_s, us_dropped = gm.make_units_grid(bids, shifted, sem_preds, obj,
                                                     c.cluster_units_shifted, s_cell)
            units_dropped = units_dropped + us_dropped
            clus_shift = gm.cluster_step(shifted, bids, obj, sem_preds, net.cluster_radius,
                                         c, units_s, u_cap=c.cluster_units_shifted,
                                         grid_cell=s_cell, big_thre=net.cluster_npoint_thre)
        else:
            # the xyz units (a grid's too) with no grid_cell: the edge path
            clus_shift = gm.cluster_step(shifted, bids, obj, sem_preds, net.cluster_radius,
                                         c, units, big_thre=net.cluster_npoint_thre)
        rows, props_dropped = merge_clusterings(
            [clus, clus_shift], [net.cluster_npoint_thre] * 2, xyz.shape[0], c.proposals)
        out = dict(out)
        out["proposal_rows"] = rows
        out["diag"] = {
            "units_dropped": units_dropped,
            "proposals_dropped": props_dropped,
            "edges_dropped": clus.edges_dropped + clus_shift.edges_dropped,
            "clusters_dropped": clus.clusters_dropped + clus_shift.clusters_dropped,
            "cc_unconverged": clus.cc_unconverged + clus_shift.cc_unconverged,
        }
        volume, occ, row_cell = gm.clusters_voxelization_dense(
            rows, c.proposals, out["point_features"], xyz, net.score_scale,
            net.score_fullscale, jitter)
        sf = self.score_net(volume, occ, train)
        row_feats = gm.devoxelize_dense(sf, row_cell)
        prop_feats = segment.roipool(row_feats, rows["prop_id"], rows["valid"], c.proposals)
        out["proposal_scores"] = self.score_branch(prop_feats)[:, 0]
        return out


def losses(cfg: EvalConfig, caps: StaticCaps, batch: dict, out: dict,
           with_heads: bool) -> dict:
    """Semantic and offset losses, plus the ScoreNet's BCE against the
    segmented IoU targets over the valid proposals when the heads ran."""
    result = gm.shared_losses(batch, out)
    if with_heads:
        rows = out["proposal_rows"]
        ious = get_iou(rows, caps.proposals, batch["instance_ids"],
                       batch["instance_num_point"], caps.instances)
        gt_scores = gm.get_segmented_scores(ious.amax(1), cfg.net.fg_thresh,
                                            cfg.net.bg_thresh)
        logits = out["proposal_scores"]
        prop_valid = (torch.arange(caps.proposals, device=logits.device)
                      < rows["n_proposals"]).to(torch.float32)
        bce = logits.clamp(min=0) - logits * gt_scores + torch.log1p(torch.exp(-logits.abs()))
        result["score_loss"] = (bce * prop_valid).sum() / prop_valid.sum().clamp(min=1.0)
    return result


def forward_flags(cfg: EvalConfig, epoch: int, train: bool) -> dict:
    return {}


def loss_flags(cfg: EvalConfig, epoch: int) -> dict:
    return {}


def nms_instances(cross_ious: np.ndarray, scores: np.ndarray, threshold: float) -> np.ndarray:
    """Greedy mask-IoU NMS (reference pointgroup.py:197-218)."""
    ixs = np.argsort(-scores)
    pick = []
    while len(ixs) > 0:
        i = ixs[0]
        pick.append(i)
        ious = cross_ious[i, ixs[1:]]
        remove = np.where(ious > threshold)[0] + 1
        ixs = np.delete(ixs, remove)
        ixs = np.delete(ixs, 0)
    return np.array(pick, dtype=np.int32)


def rows_to_masks(rows_np: dict, num_proposals: int, n_points: int) -> np.ndarray:
    """Dense (P, N) bool masks from membership rows."""
    masks = np.zeros((num_proposals, n_points), dtype=bool)
    v = rows_np["valid"]
    masks[rows_np["prop_id"][v], rows_np["point_idx"][v]] = True
    return masks


def pred_instances(cfg: EvalConfig, scan_id: str, xyz: np.ndarray, out_np: dict,
                   num_ignored_classes: int) -> list:
    """Host-side instance extraction: sigmoid score and npoint thresholds,
    mask-IoU NMS, RLE encode."""
    test_cfg = cfg.net.test
    n = xyz.shape[0]
    sem_labels = out_np["semantic_scores"].argmax(1)
    n_props = int(out_np["proposal_rows"]["n_proposals"])
    scores = 1.0 / (1.0 + np.exp(-out_np["proposal_scores"][:n_props]))
    masks = rows_to_masks(out_np["proposal_rows"], n_props, n)

    npoint = masks.sum(1)
    keep = (scores > test_cfg.TEST_SCORE_THRESH) & (npoint > test_cfg.TEST_NPOINT_THRESH)
    scores, masks = scores[keep], masks[keep]

    if len(scores) == 0:
        pick = np.empty(0, np.int32)
    else:
        mf = masks.astype(np.float32)
        inter = mf @ mf.T
        np_h = mf.sum(1)[:, None]
        cross_ious = inter / (np_h + np_h.T - inter)
        pick = nms_instances(cross_ious, scores, test_cfg.TEST_NMS_THRESH)

    instances = []
    for i in pick:
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
