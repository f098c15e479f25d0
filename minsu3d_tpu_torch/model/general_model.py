"""Shared model machinery: clustering units, the dense proposal
re-voxelization and the losses every model shares.

Counterparts of minsu3d_tpu/model/general_model.py: ``make_units`` (:164),
``cluster_step`` (:200-252, the edge-buffer unit path that the golden config
takes: grid_cell = 0 for both clusterings), ``get_segmented_scores``
(:254), ``semantic_loss`` (:264), ``shared_losses`` (:274),
``clusters_voxelization_dense`` (:333) and ``devoxelize_dense`` (:393).
Plain torch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from minsu3d_tpu_torch.loss.pt_offset_loss import pt_offset_loss
from minsu3d_tpu_torch.ops import segment
from minsu3d_tpu_torch.ops.cluster import Clusters, cluster_units
from minsu3d_tpu_torch.ops.sparse import build_base

# Eval jitter of the proposal voxelization. The JAX model draws it with
# jax.random.PRNGKey(0) (model/pointgroup.py:164) split into two keys, each
# giving uniform(key, (3,)) (general_model.py:365-368). The port cannot call
# jax.random, so it keeps those six f32 values; tests/test_torch_imports.py
# recomputes them with JAX.
EVAL_JITTER = (
    (0.8423141241073608, 0.1823786497116089, 0.22717809677124023),
    (0.007293820381164551, 0.020891189575195312, 0.5814265012741089),
)


def train_jitter(generator: torch.Generator) -> tuple:
    """The two uniform 3-vectors of a training-time proposal voxelization,
    drawn from ``generator`` where the JAX model draws them from
    ``make_rng("cluster")`` (general_model.py:363-367)."""
    return tuple(tuple(torch.rand(3, generator=generator).tolist()) for _ in range(2))


def make_units(key_hi: torch.Tensor, key_lo: torch.Tensor, active: torch.Tensor,
               u_cap: int):
    """(key_hi, key_lo) pairs of active points -> unit ids in sorted-key order
    ((N,) int64, u_cap = none) and the count of units beyond ``u_cap``."""
    z = torch.zeros_like(key_lo)
    coords = torch.stack([key_lo.clamp(0, 1023), z, z], 1)
    return build_base(key_hi, coords, active, u_cap)


def cluster_step(coords, batch_ids, active, group, radius: float, caps, unit_id,
                 edge_factor: int | None = None, big_thre: int = 1) -> Clusters:
    """Unit-granularity clustering on the edge-buffer ball query (K and
    window scaled down for units as in the JAX dispatch)."""
    ef = caps.edge_factor if edge_factor is None else edge_factor
    u_cap = caps.cluster_units
    return cluster_units(coords, batch_ids, active, group, unit_id, u_cap, radius,
                         max(caps.neighbors // 2, 8), max(caps.window // 4, 8),
                         caps.clusters, caps.cc_iters, caps.half_space, ef * u_cap,
                         big_thre=big_thre)


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


def shared_losses(batch: dict, output: dict) -> dict:
    """Semantic and offset losses (reference general_model.py:36-50)."""
    losses = {"semantic_loss": semantic_loss(output["semantic_scores"], batch["sem_labels"])}
    gt_offsets = batch["instance_center_xyz"] - batch["point_xyz"]
    valid = (batch["instance_ids"] != -1) & batch["point_mask"]
    losses["offset_norm_loss"], losses["offset_dir_loss"] = pt_offset_loss(
        output["point_offsets"], gt_offsets, valid)
    return losses


def clusters_voxelization_dense(rows, p_cap: int, feats: torch.Tensor, coords: torch.Tensor,
                                scale: float, s: int, jitter=EVAL_JITTER):
    """Proposal rows -> dense (P, S, S, S, C) volumes, occupancy (P, S, S, S)
    and each row's flat cell (P*S^3 for invalid rows). Duplicate cells keep
    their first row, and only the winners are written, so the gradient that
    reaches ``feats`` is that of the winning rows alone. ``jitter``: the two
    uniform 3-vectors of the placement (``EVAL_JITTER``, or ``train_jitter``
    in training)."""
    dev = coords.device
    pidx = rows["point_idx"].long()
    valid = rows["valid"]
    pid = torch.where(valid, rows["prop_id"].long(), torch.full_like(pidx, p_cap))
    pid_c = pid.clamp(max=p_cap - 1)
    c = coords[pidx]
    f = torch.index_select(feats, 0, pidx)
    f = torch.where(valid[:, None], f, torch.zeros_like(f))

    mean = segment.sec_mean(c, pid, valid, p_cap)
    c = c - mean[pid_c]
    cmin = segment.sec_min(c, pid, valid, p_cap)
    cmax = segment.sec_max(c, pid, valid, p_cap)

    extent = ((cmax - cmin) / s).amax(dim=1)
    cluster_scale = torch.clamp(1.0 / extent.clamp(min=1e-12) - 0.01, max=scale)
    min_xyz = cmin * cluster_scale[:, None]
    max_xyz = cmax * cluster_scale[:, None]
    c = c * cluster_scale[pid_c, None]

    rnd1 = torch.tensor(jitter[0], dtype=torch.float32, device=dev)
    rnd2 = torch.tensor(jitter[1], dtype=torch.float32, device=dev)
    span = max_xyz - min_xyz
    offset = (-min_xyz
              + (s - span - 0.001).clamp(min=0) * rnd1[None, :]
              + (s - span + 0.001).clamp(max=0) * rnd2[None, :])
    c = c + offset[pid_c]
    grid = torch.floor(c).to(torch.int64).clamp(0, s - 1)

    n_cells = p_cap * s * s * s
    cell = ((pid * s + grid[:, 0]) * s + grid[:, 1]) * s + grid[:, 2]
    cell = torch.where(valid, cell, torch.full_like(cell, n_cells))

    big = 2**31 - 1
    row_ids = torch.arange(cell.shape[0], device=dev)
    first_row = torch.full((n_cells + 1,), big, dtype=torch.int64, device=dev)
    first_row.scatter_reduce_(0, cell, torch.where(valid, row_ids, torch.full_like(row_ids, big)),
                              reduce="amin")
    winner = valid & (first_row[cell.clamp(max=n_cells)] == row_ids)
    cell_w = torch.where(winner, cell, torch.full_like(cell, n_cells))

    n_feat = feats.shape[1]
    volume = torch.zeros((n_cells + 1, n_feat), dtype=feats.dtype, device=dev)
    volume[cell_w[winner]] = f[winner]
    occ = torch.zeros(n_cells + 1, dtype=torch.bool, device=dev)
    occ[cell_w[winner]] = True
    return (volume[:n_cells].view(p_cap, s, s, s, n_feat),
            occ[:n_cells].view(p_cap, s, s, s), cell)


def devoxelize_dense(volume: torch.Tensor, row_cell: torch.Tensor) -> torch.Tensor:
    """Dense proposal-volume features back to membership rows (0 for invalid)."""
    flat = volume.reshape(-1, volume.shape[-1])
    flat = torch.cat([flat, flat.new_zeros((1, flat.shape[1]))])
    # index_select: its backward is an index_add_; advanced indexing's sorts
    # the indices and walks each run of duplicates serially, and every
    # invalid row (most of them) reads the one sentinel cell
    return torch.index_select(flat, 0, row_cell)
