"""Scenes: normalize, augment, voxelize, instance info.

The port's copy of minsu3d_tpu/data/dataset.py (GeneralDataset.__getitem__:
``eval_item`` is the val/test path, ``train_item`` the train path with
augmentation, elastic distortion and crop, :100-150) and of
data/voxelize.py. Voxel dedup runs in
the port's host library (``ms3d_sparse_quantize``): voxel ids in
first-occurrence order, the order the JAX package gets from its native
library (which its ``test.py`` builds before evaluating).
"""

from __future__ import annotations

import numpy as np

from minsu3d_tpu_torch.config import EvalConfig, TrainConfig
from minsu3d_tpu_torch.csrc.build import host_lib, np_ptr
from minsu3d_tpu_torch.data import transform
from minsu3d_tpu_torch.data.synthetic import make_scene


def sparse_quantize(coords: np.ndarray, feats: np.ndarray, quantization_size: float):
    """Quantize float coords to unique voxels (data/voxelize.py).

    Returns (voxel_coords (V, 3) int32, voxel_feats (V, C), p2v (N,) int32);
    a voxel's features are its first point's, voxel ids follow first
    occurrence in point order."""
    grid = np.ascontiguousarray(np.floor(coords / quantization_size).astype(np.int64))
    n = grid.shape[0]
    p2v = np.empty(n, np.int32)
    first_idx = np.empty(n, np.int32)
    n_voxels = host_lib().ms3d_sparse_quantize(np_ptr(grid), n, np_ptr(p2v),
                                               np_ptr(first_idx))
    first_idx = first_idx[:n_voxels]
    return grid[first_idx].astype(np.int32), feats[first_idx], p2v


def normalize(scene: dict) -> dict:
    """Centre xyz, map rgb to [-1, 1] (GeneralDataset._normalize)."""
    scene = dict(scene)
    scene["xyz"] = scene["xyz"] - scene["xyz"].mean(axis=0)
    scene["rgb"] = scene["rgb"].astype(np.float32) / 127.5 - 1
    return scene


def instance_info(xyz: np.ndarray, instance_ids: np.ndarray, sem_labels: np.ndarray,
                  n_ignore: int):
    """Per-point instance centres, per-instance sizes and classes
    (GeneralDataset._instance_info)."""
    unique_ids = np.unique(instance_ids)
    unique_ids = unique_ids[unique_ids != -1]
    num_instance = len(unique_ids)
    center = np.zeros((xyz.shape[0], 3), np.float32)
    num_point = []
    cls = np.full(num_instance, -1, np.int32)
    for index, i in enumerate(unique_ids):
        idx = np.nonzero(instance_ids == i)[0]
        center[idx] = xyz[idx].mean(0)
        num_point.append(idx.size)
        sl = sem_labels[idx[0]]
        cls[index] = sl - n_ignore if sl != -1 else sl
    return num_instance, center, np.array(num_point, np.int32), cls


def eval_item(cfg: EvalConfig, scene: dict, scan_id: str) -> dict:
    """One normalized scene -> the per-scene dict that ``collate`` packs."""
    xyz = scene["xyz"].astype(np.float32)
    xyz_q = xyz * (1 / cfg.voxel_size)
    xyz_q = xyz_q - xyz_q.min(axis=0)
    return _item(cfg, scan_id, xyz, xyz_q, scene["rgb"].astype(np.float32),
                 scene["normal"].astype(np.float32), scene["instance_ids"].astype(np.int32),
                 scene["sem_labels"].astype(np.int32))


def augmentation_matrix(cfg: TrainConfig, rng: np.random.Generator) -> np.ndarray:
    aug = cfg.augmentation
    m = np.eye(3)
    if aug.jitter_xyz:
        m = m @ transform.jitter_mat(rng)
    if aug.flip:
        m *= transform.flip_mat(rng, 0, random=True)
    if aug.rotation:
        m = m @ transform.rotz_mat(rng.random() * 2 * np.pi)
    return m.astype(np.float32)


def compact_instance_ids(instance_ids: np.ndarray) -> np.ndarray:
    """Re-number instance ids to be consecutive after cropping
    (reference general_dataset.py:44-54)."""
    out = instance_ids.copy()
    j = 0
    while j < out.max(initial=-1):
        if np.count_nonzero(out == j) == 0:
            out[out == out.max()] = j
        j += 1
    return out


def train_item(cfg: TrainConfig, scene: dict, scan_id: str,
               rng: np.random.Generator) -> dict:
    """One normalized scene -> an augmented train item, every random draw
    from ``rng`` (the JAX package draws from an unseeded default_rng)."""
    xyz = scene["xyz"].astype(np.float32)
    colors = scene["rgb"].astype(np.float32)
    normals = scene["normal"].astype(np.float32)
    instance_ids = scene["instance_ids"].astype(np.int32)
    sem_labels = scene["sem_labels"].astype(np.int32)

    m = augmentation_matrix(cfg, rng)
    xyz = xyz @ m
    normals = normals @ np.linalg.inv(m).T.astype(np.float32)
    if cfg.augmentation.jitter_rgb:
        colors = colors + rng.standard_normal(3).astype(np.float32) * 0.1

    scale = 1 / cfg.voxel_size
    if cfg.augmentation.elastic:
        xyz_q = transform.elastic(xyz * scale, 6 * scale // 50, 40 * scale / 50, rng)
        xyz_q = transform.elastic(xyz_q, 20 * scale // 50, 160 * scale / 50, rng)
    else:
        xyz_q = xyz * scale
    xyz_q = xyz_q - xyz_q.min(axis=0)

    if xyz.shape[0] > cfg.max_num_point:
        for _ in range(20):
            xyz_tmp, valid = transform.crop(xyz_q, cfg.max_num_point, cfg.full_scale[1], rng)
            if (np.count_nonzero(valid) >= cfg.max_num_point // 2
                    and np.any(sem_labels[valid] != -1) and np.any(instance_ids[valid] != -1)):
                xyz_q = xyz_tmp
                break
        else:
            raise RuntimeError("Over-cropped scene (20 crop attempts failed)")
        xyz_q, xyz, normals, colors = xyz_q[valid], xyz[valid], normals[valid], colors[valid]
        sem_labels = sem_labels[valid]
        instance_ids = compact_instance_ids(instance_ids[valid])
    return _item(cfg, scan_id, xyz, xyz_q, colors, normals, instance_ids, sem_labels)


def _item(cfg: EvalConfig, scan_id: str, xyz, xyz_q, colors, normals, instance_ids,
          sem_labels) -> dict:
    """Instance info, point features and voxels of one (augmented) scene;
    ``xyz_q`` is in voxel units with its minimum at 0."""
    xyz_q = xyz_q * cfg.voxel_size
    num_instance, center, inst_npoint, inst_cls = instance_info(
        xyz, instance_ids, sem_labels, len(cfg.ignore_classes))

    feats = [np.zeros((len(xyz), 0), np.float32)]
    if cfg.net.use_color:
        feats.append(colors)
    if cfg.net.use_normal:
        feats.append(normals)
    feats.append(xyz)
    point_features = np.concatenate(feats, axis=1)
    voxel_coords, voxel_feats, p2v = sparse_quantize(xyz_q, point_features, cfg.voxel_size)
    return {
        "scan_id": scan_id,
        "point_xyz": xyz,
        "sem_labels": sem_labels,
        "instance_ids": instance_ids,
        "num_instance": num_instance,
        "instance_center_xyz": center,
        "instance_num_point": inst_npoint,
        "instance_semantic_cls": inst_cls,
        "voxel_coords": voxel_coords,
        "voxel_feats": voxel_feats,
        "p2v": p2v,
    }


def synthetic_train_scenes(cfg: EvalConfig) -> list:
    """(scan_id, normalized scene) of the synthetic train split
    (data/dataset.py::Synthetic with split="train")."""
    s = cfg.synthetic
    return [(f"synth_train{i:04d}",
             normalize(make_scene(seed=s.seed + i, num_objects=s.num_objects,
                                  points_per_object=s.points_per_object,
                                  floor_points=s.floor_points)))
            for i in range(s.train_scenes)]


def synthetic_val_scenes(cfg: EvalConfig) -> list:
    """(scan_id, normalized scene) of the synthetic val split
    (data/dataset.py::Synthetic with split="val")."""
    s = cfg.synthetic
    return [(f"synth_val{i:04d}",
             normalize(make_scene(seed=s.seed + 10_000 + i, num_objects=s.num_objects,
                                  points_per_object=s.points_per_object,
                                  floor_points=s.floor_points)))
            for i in range(s.val_scenes)]
