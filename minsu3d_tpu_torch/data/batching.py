"""Fixed-capacity batch assembly and the host-built UNet grid plan.

The port's copy of minsu3d_tpu/data/batching.py::collate (:39-112) and of
minsu3d_tpu/csrc/native.py::build_plan_host (:63). The plan is always built
on the host by the port's own ``host_ops.cpp``; there is no device plan
builder yet, so a missing host library raises.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from minsu3d_tpu_torch.csrc.build import host_lib, np_ptr


def collate(batch: list, caps: dict, plan: tuple | None = None) -> dict[str, Any]:
    """Pack per-scene dicts into one fixed-shape batch.

    ``caps`` = {"points", "voxels", "instances"}; ``plan=(level_caps,
    num_levels)`` adds the host-built grid plan (``plan{l}_*`` arrays)."""
    P, V, I = caps["points"], caps["voxels"], caps["instances"]
    n_feat = batch[0]["voxel_feats"].shape[1]

    out = {
        "scan_ids": [b["scan_id"] for b in batch],
        "point_xyz": np.zeros((P, 3), np.float32),
        "vert_batch_ids": np.full(P, -1, np.int32),
        "point_mask": np.zeros(P, bool),
        "sem_labels": np.full(P, -1, np.int32),
        "instance_ids": np.full(P, -1, np.int32),
        "instance_center_xyz": np.zeros((P, 3), np.float32),
        "instance_num_point": np.zeros(I, np.int32),
        "instance_semantic_cls": np.full(I, -1, np.int32),
        "instance_mask": np.zeros(I, bool),
        "num_instance": np.int32(0),
        "voxel_coords": np.zeros((V, 3), np.int32),
        "voxel_batch": np.zeros(V, np.int32),
        "voxel_feats": np.zeros((V, n_feat), np.float32),
        "voxel_mask": np.zeros(V, bool),
        "p2v": np.full(P, V, np.int32),
        "num_points": np.int32(0),
        "num_voxels": np.int32(0),
    }

    p0 = v0 = i0 = 0
    for i, b in enumerate(batch):
        n = b["point_xyz"].shape[0]
        v = b["voxel_coords"].shape[0]
        k = int(b["num_instance"])
        if p0 + n > P or v0 + v > V or i0 + k > I:
            raise ValueError(
                f"Batch overflows caps (points {p0 + n}/{P}, voxels {v0 + v}/{V}, "
                f"instances {i0 + k}/{I}); raise the caps")
        ps, vs, isl = slice(p0, p0 + n), slice(v0, v0 + v), slice(i0, i0 + k)
        out["point_xyz"][ps] = b["point_xyz"]
        out["vert_batch_ids"][ps] = i
        out["point_mask"][ps] = True
        out["sem_labels"][ps] = b["sem_labels"]
        inst = b["instance_ids"].copy()
        inst[inst != -1] += i0  # re-base instance ids across scenes
        out["instance_ids"][ps] = inst
        out["instance_center_xyz"][ps] = b["instance_center_xyz"]
        out["instance_num_point"][isl] = b["instance_num_point"]
        out["instance_semantic_cls"][isl] = b["instance_semantic_cls"]
        out["instance_mask"][isl] = True
        out["voxel_coords"][vs] = b["voxel_coords"]
        out["voxel_batch"][vs] = i
        out["voxel_feats"][vs] = b["voxel_feats"]
        out["voxel_mask"][vs] = True
        out["p2v"][ps] = b["p2v"] + v0
        p0 += n
        v0 += v
        i0 += k

    out["num_instance"] = np.int32(i0)
    out["num_points"] = np.int32(p0)
    out["num_voxels"] = np.int32(v0)
    if plan is not None:
        out.update(build_plan_host(out["voxel_batch"], out["voxel_coords"],
                                   out["voxel_mask"], plan[0], plan[1]))
    return out


def build_plan_host(vbatch: np.ndarray, vcoords: np.ndarray, vmask: np.ndarray,
                    caps: list, num_levels: int) -> dict:
    """Full UNet grid plan on the host: ``plan{l}_{khi,klo,coords,batch,valid,
    count,dropped,nbr}`` per level, ``plan{l}_{parent,kid}`` linking level l
    to l+1, ``plan_row2voxel`` (input voxel row -> level-0 index, cap =
    dropped) and ``plan0_featsrc`` (level-0 index -> representative input
    row, -1 = pad). Index ``cap`` means "absent" in every table."""
    lib = host_lib()
    vbatch = np.ascontiguousarray(vbatch, dtype=np.int32)
    vcoords = np.ascontiguousarray(vcoords, dtype=np.int32)
    vmask = np.ascontiguousarray(vmask, dtype=np.uint8)

    out: dict[str, np.ndarray] = {}
    cur_batch, cur_coords, cur_valid = vbatch, vcoords, vmask
    for lvl in range(num_levels):
        cap = int(caps[lvl])
        khi = np.empty(cap, np.int32)
        klo = np.empty(cap, np.int32)
        coords = np.empty((cap, 3), np.int32)
        batch = np.empty(cap, np.int32)
        valid = np.empty(cap, np.uint8)
        r2v = np.empty(len(cur_batch), np.int32)
        featsrc = np.empty(cap, np.int32)
        dropped = np.zeros(1, np.int32)
        count = lib.ms3d_plan_base(
            np_ptr(cur_batch), np_ptr(cur_coords), np_ptr(cur_valid), len(cur_batch), cap,
            np_ptr(khi), np_ptr(klo), np_ptr(coords), np_ptr(batch), np_ptr(valid),
            np_ptr(r2v), np_ptr(featsrc), np_ptr(dropped))
        nbr = np.empty((cap, 27), np.int32)
        lib.ms3d_plan_neighbors(np_ptr(khi), np_ptr(klo), np_ptr(coords), np_ptr(batch),
                                count, cap, np_ptr(nbr))
        out[f"plan{lvl}_khi"] = khi
        out[f"plan{lvl}_klo"] = klo
        out[f"plan{lvl}_coords"] = coords
        out[f"plan{lvl}_batch"] = batch
        out[f"plan{lvl}_valid"] = valid.astype(bool)
        out[f"plan{lvl}_count"] = np.int32(count)
        out[f"plan{lvl}_dropped"] = np.int32(dropped[0])
        out[f"plan{lvl}_nbr"] = nbr
        if lvl == 0:
            out["plan_row2voxel"] = r2v
            out["plan0_featsrc"] = featsrc
        else:
            pc = out[f"plan{lvl - 1}_coords"]
            kid = ((pc[:, 0] & 1) << 2) | ((pc[:, 1] & 1) << 1) | (pc[:, 2] & 1)
            out[f"plan{lvl - 1}_parent"] = r2v
            out[f"plan{lvl - 1}_kid"] = np.where(out[f"plan{lvl - 1}_valid"], kid,
                                                 0).astype(np.int32)
        cur_batch, cur_coords, cur_valid = batch, coords >> 1, valid
    return out


def eval_caps(cfg) -> dict:
    c = cfg.caps
    return {"points": c.eval_points, "voxels": c.eval_voxels, "instances": c.eval_instances}


def train_caps(cfg) -> dict:
    """``shard_caps(cfg, "train")``: a batch holds ``batch_size`` scenes."""
    c = cfg.caps
    return {"points": c.points, "voxels": c.voxels, "instances": c.instances}
