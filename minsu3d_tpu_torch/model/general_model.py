"""Shared model machinery: clustering units, the dense proposal
re-voxelization and the losses every model shares.

Counterparts of minsu3d_tpu/model/general_model.py: ``build_scene_plan``
(:29-112: the host plan, or without one the device plan, in
``BackboneHeadsNet.backbone_forward``), ``make_units`` (:164) and
``make_units_grid`` (:178) (``ops/sparse.py::build_base``: K15 and K17 on
the card), ``cluster_step`` (:200-249, every branch: unit or point
granularity, the direct grid query, the edge-buffer query and the fused
query), ``get_segmented_scores``
(:254), ``semantic_loss`` (:264), ``shared_losses`` (:274), ``clipped_bce``
(the mask BCE of minsu3d_tpu/model/hais.py:265-267 and softgroup.py:378-380),
``clusters_voxelization_dense`` (:333: per-proposal mean, min and max on
K6, the per-row placement and cell election on K7) and ``devoxelize_dense``
(:393). Row gathers go through ``segment.gather_rows``, whose backward is
K6's ordered sum: no float atomics, forward or backward. ``BackboneHeadsNet``
is the forward every model shares: the backbone, then its heads;
``compute_dtype`` reads a config's precision as the JAX ``make_net``s do.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from minsu3d_tpu_torch.loss.pt_offset_loss import pt_offset_loss
from minsu3d_tpu_torch.ops import segment
from minsu3d_tpu_torch.ops.cluster import Clusters, cluster_points, cluster_units
from minsu3d_tpu_torch.ops.proposal_voxelize import voxelize_rows
from minsu3d_tpu_torch.ops.hashing import COORD_MAX
from minsu3d_tpu_torch.ops.sparse import build_base, device_plan, plan_dropped, plan_from_batch

# Eval jitter of the proposal voxelization. The JAX model draws it with
# jax.random.PRNGKey(0) (model/pointgroup.py:164) split into two keys, each
# giving uniform(key, (3,)) (general_model.py:365-368). The port cannot call
# jax.random, so it keeps those six f32 values; tests/test_torch_imports.py
# recomputes them with JAX.
EVAL_JITTER = (
    (0.8423141241073608, 0.1823786497116089, 0.22717809677124023),
    (0.007293820381164551, 0.020891189575195312, 0.5814265012741089),
)


def compute_dtype(cfg) -> torch.dtype | None:
    """The models' compute dtype: torch.bfloat16 for ``precision``
    "bfloat16", None (f32) otherwise (model/hais.py:239, softgroup.py:331,
    pointgroup.py:191). Parameters stay f32 either way and are cast where
    they are used, as in the JAX package."""
    return torch.bfloat16 if cfg.precision == "bfloat16" else None


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A sequence of Python numbers as a tensor on ``device``, built once for
    each (values, dtype, device) and then shared, since
    ``torch.tensor(..., device=cuda)`` copies from the host and waits for
    the card: the heads read their configs' constants (class ids, mean
    instance sizes and radii) with no host sync. Callers do not write to
    it."""
    return _device_constant(tuple(values), dtype, torch.device(device))


@functools.lru_cache(maxsize=64)
def _device_constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def train_jitter(generator: torch.Generator) -> tuple:
    """The two uniform 3-vectors of a training-time proposal voxelization,
    drawn from ``generator`` where the JAX model draws them from
    ``make_rng("cluster")`` (general_model.py:363-367)."""
    return tuple(tuple(torch.rand(3, generator=generator).tolist()) for _ in range(2))


class BackboneHeadsNet(nn.Module):
    """A model's forward split in two, ``backbone_forward`` and the model's
    ``heads(batch, out, train, jitter, **flags)``, so that a test can feed
    the heads the same backbone outputs on both sides. Subclasses set
    ``self.cfg``, ``self.caps`` (``StaticCaps`` of the net's split) and
    ``self.backbone``."""

    def backbone_forward(self, batch: dict, train: bool = False):
        """The backbone on the batch's grid plan: the host-built one where
        the batch carries it (``plan0_nbr``), else one built on the batch's
        device at the split's level capacities (``host_plan=false``,
        build_scene_plan's device branch, general_model.py:70-72)."""
        n_levels = len(self.cfg.net.blocks)
        if "plan0_nbr" in batch:
            plan, v2p, vfeats = plan_from_batch(batch, n_levels)
        else:
            plan, v2p, vfeats = device_plan(batch, list(self.caps.voxel_caps), n_levels)
        out = self.backbone(vfeats, plan, v2p, batch["point_mask"], train)
        return out, plan

    def forward(self, batch: dict, train: bool = False, with_heads: bool = True,
                generator: torch.Generator | None = None, **flags) -> dict:
        """``flags``: the model's ``forward_flags``. Training draws the
        voxelization jitter from ``generator``; eval uses the JAX models'
        fixed PRNGKey(0) draws."""
        out, plan = self.backbone_forward(batch, train)
        if with_heads:
            if train and generator is None:
                raise ValueError(f"{type(self).__name__}: a training forward with heads needs "
                                 "a torch.Generator for the voxelization jitter")
            jitter = train_jitter(generator) if train else EVAL_JITTER
            out = self.heads(batch, out, train, jitter, **flags)
        else:
            out["diag"] = {}
        out["diag"]["voxels_dropped"] = plan_dropped(plan)
        return out


def make_units(key_hi: torch.Tensor, key_lo: torch.Tensor, active: torch.Tensor,
               u_cap: int):
    """(key_hi, key_lo) pairs of active points -> unit ids in sorted-key order
    ((N,) int64, u_cap = none) and the count of units beyond ``u_cap``."""
    z = torch.zeros_like(key_lo)
    coords = torch.stack([key_lo.clamp(0, 1023), z, z], 1)
    level, row2unit, _ = build_base(key_hi, coords, active, u_cap)
    return row2unit.long(), level.n_dropped.long()


def make_units_grid(batch_ids: torch.Tensor, coords: torch.Tensor, group: torch.Tensor,
                    active: torch.Tensor, u_cap: int, cell_size: float):
    """(cell, group) clustering units of a grid of ``cell_size`` metres in
    the coordinates being clustered: unit ids ((N,) int64, u_cap = none) and
    the count of units beyond ``u_cap``. The key is ``(batch << 8) |
    clip(group, 0, 255)`` -- not the ball query's ``batch << 16`` -- and the
    cells ``clip(floor(coords / cell_size) + 512)``, dividing by a device
    tensor (a Python-scalar divisor takes CUDA's multiply-by-reciprocal
    shortcut, which can move a point across a cell face), filled on the
    device with no host copy or sync."""
    div = torch.full((), cell_size, dtype=coords.dtype, device=coords.device)
    cell = (torch.floor(coords / div).to(torch.int64) + 512).clamp(0, COORD_MAX - 1)
    key_hi = (batch_ids.to(torch.int64) << 8) | group.to(torch.int64).clamp(0, 255)
    level, row2unit, _ = build_base(key_hi, cell, active, u_cap)
    return row2unit.long(), level.n_dropped.long()


def cluster_step(coords, batch_ids, active, group, radius: float, caps, unit_id=None,
                 u_cap: int | None = None, edge_factor: int | None = None,
                 grid_cell: float = 0.0, big_thre: int = 1) -> Clusters:
    """Point- or unit-granularity clustering per ``caps``, as the JAX
    dispatch. With units (``unit_id`` and ``caps.unit_clustering``): K and
    window halved and quartered; units of ``make_units_grid`` with cell
    ``grid_cell`` take the direct grid query when the radius spans at most
    ``caps.bq_grid_max_m`` cells, else the edge-buffer query with
    ``edge_factor * u_cap`` slots, or the fused query when the factor is 0.
    Points: the edge-buffer query with ``edge_factor * N`` slots (fused at
    0). ``edge_factor`` overrides ``caps.edge_factor``; ``big_thre`` is the
    consumer's size filter for ``clusters_dropped``."""
    ef = caps.edge_factor if edge_factor is None else edge_factor
    if unit_id is not None and caps.unit_clustering:
        if u_cap is None:
            u_cap = caps.cluster_units
        m_cells = math.ceil(radius / grid_cell - 1e-9) if grid_cell > 0 else 99
        grid_direct = grid_cell if m_cells <= caps.bq_grid_max_m else 0.0
        return cluster_units(coords, batch_ids, active, group, unit_id, u_cap, radius,
                             max(caps.neighbors // 2, 8), max(caps.window // 4, 8),
                             caps.clusters, caps.cc_iters, caps.half_space,
                             0 if grid_direct else ef * u_cap, big_thre=big_thre,
                             grid_cell=grid_direct, coarsen=caps.cc_coarsen,
                             coarsen_sweeps=caps.cc_coarsen_sweeps)
    return cluster_points(coords, batch_ids, active, group, radius, caps.neighbors,
                          caps.window, caps.clusters, caps.cc_iters, caps.half_space,
                          ef * coords.shape[0], big_thre=big_thre, coarsen=caps.cc_coarsen,
                          coarsen_sweeps=caps.cc_coarsen_sweeps)


def get_segmented_scores(scores: torch.Tensor, fg_thresh: float,
                         bg_thresh: float) -> torch.Tensor:
    """Piecewise-linear soft score targets (reference general_model.py:196-213)."""
    k = 1.0 / max(fg_thresh - bg_thresh, 1e-12)
    b = bg_thresh / (bg_thresh - fg_thresh) if fg_thresh != bg_thresh else 0.0
    mid = scores * k + b
    return torch.where(scores > fg_thresh, torch.ones_like(scores),
                       torch.where(scores < bg_thresh, torch.zeros_like(scores), mid))


def semantic_loss(semantic_scores: torch.Tensor, sem_labels: torch.Tensor) -> torch.Tensor:
    """Cross entropy with ignore index -1 (reference general_model.py:39-41)."""
    m = (sem_labels >= 0).to(torch.float32)
    logp = F.log_softmax(semantic_scores, dim=-1)
    nll = -logp.gather(1, sem_labels.long().clamp(min=0)[:, None])[:, 0]
    return (nll * m).sum() / m.sum().clamp(min=1.0)


def clipped_bce(p: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Per-element BCE of probabilities clipped to [1e-7, 1 - 1e-7], as the
    JAX losses write it (a clamp and two logs)."""
    pc = p.clamp(1e-7, 1 - 1e-7)
    lf = label.to(pc.dtype)
    return -(lf * torch.log(pc) + (1 - lf) * torch.log(1 - pc))


def shared_losses(batch: dict, output: dict) -> dict:
    """Semantic and offset losses (reference general_model.py:36-50)."""
    losses = {"semantic_loss": semantic_loss(output["semantic_scores"], batch["sem_labels"])}
    gt_offsets = batch["instance_center_xyz"] - batch["point_xyz"]
    valid = (batch["instance_ids"] != -1) & batch["point_mask"]
    losses["offset_norm_loss"], losses["offset_dir_loss"] = pt_offset_loss(
        output["point_offsets"], gt_offsets, valid)
    return losses


def proposal_csr(rows, p_cap: int) -> segment.CSR:
    """The CSR of the valid proposal rows by proposal: the one that the
    voxelization's mean, min and max and the roipool would each build
    (``segment.valid_csr``). The heads build it once a forward and pass it
    to each."""
    return segment.valid_csr(rows["prop_id"], rows["valid"], p_cap)


def voxelization_placement(rows, p_cap: int, coords: torch.Tensor, scale: float, s: int,
                           jitter=EVAL_JITTER, csr: segment.CSR | None = None) -> tuple:
    """Per-proposal placement of the rows in their S^3 volumes: (pidx, pid
    (p_cap for invalid rows), valid, mean (P, 3), cluster_scale (P,),
    offset (P, 3)). The mean, min and max are K6 reductions over ``csr``
    (``proposal_csr``, built here when None); ``jitter``: the two uniform
    3-vectors (``EVAL_JITTER``, or ``train_jitter`` in training)."""
    dev = coords.device
    pidx = rows["point_idx"].long()
    valid = rows["valid"]
    pid = torch.where(valid, rows["prop_id"].long(), torch.full_like(pidx, p_cap))
    if csr is None:
        csr = proposal_csr(rows, p_cap)
    c = coords[pidx]
    mean = segment.csr_mean(c, csr)
    c = c - mean[pid.clamp(max=p_cap - 1)]
    cmin = segment.csr_min(c, csr)
    cmax = segment.csr_max(c, csr)

    extent = ((cmax - cmin) / s).amax(dim=1)
    cluster_scale = torch.clamp(1.0 / extent.clamp(min=1e-12) - 0.01, max=scale)
    min_xyz = cmin * cluster_scale[:, None]
    max_xyz = cmax * cluster_scale[:, None]

    rnd1 = torch.tensor(jitter[0], dtype=torch.float32, device=dev)
    rnd2 = torch.tensor(jitter[1], dtype=torch.float32, device=dev)
    span = max_xyz - min_xyz
    offset = (-min_xyz
              + (s - span - 0.001).clamp(min=0) * rnd1[None, :]
              + (s - span + 0.001).clamp(max=0) * rnd2[None, :])
    return pidx, pid, valid, mean, cluster_scale, offset


def clusters_voxelization_dense(rows, p_cap: int, feats: torch.Tensor, coords: torch.Tensor,
                                scale: float, s: int, jitter=EVAL_JITTER,
                                csr: segment.CSR | None = None):
    """Proposal rows -> dense (P, S, S, S, C) volumes, occupancy (P, S, S, S)
    and each row's flat cell (P*S^3 for invalid rows). Duplicate cells keep
    their first row, and only the winners are written (K7, which reads the
    winners' rows of ``feats`` itself), so the gradient that reaches
    ``feats`` is that of the winning rows alone. ``csr``: the rows'
    ``proposal_csr``, built here when None."""
    if csr is None:
        csr = proposal_csr(rows, p_cap)
    pidx, _, _, mean, cluster_scale, offset = voxelization_placement(
        rows, p_cap, coords, scale, s, jitter, csr)
    volume, occ, cell = voxelize_rows(feats, pidx, coords, csr, mean, cluster_scale, offset,
                                      p_cap, s)
    return (volume.view(p_cap, s, s, s, feats.shape[1]), occ.view(p_cap, s, s, s), cell)


def devoxelize_dense(volume: torch.Tensor, row_cell: torch.Tensor) -> torch.Tensor:
    """Dense proposal-volume features back to membership rows (0 for invalid
    rows, whose cell is P*S^3). The ~200k invalid rows form the padding
    segment of the backward's ordered sum, which never reduces it."""
    return segment.gather_rows(volume.reshape(-1, volume.shape[-1]), row_cell)
