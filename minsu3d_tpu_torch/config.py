"""Plain-Python configuration of PointGroup inference and training.

``EvalConfig()`` is the golden-oracle eval config: the values of the JAX
package's ``config/data/base.yaml``, ``config/data/synthetic.yaml`` and
``config/model/{base,pointgroup}.yaml`` with the overrides of
``scripts/eval_synth_pointgroup.sh`` (f32, eval caps 131072 points /
98304 voxels, 16384 clusters, 128 proposals, cluster_npoint_thre 50).
``TrainConfig()`` is the golden training recipe,
``scripts/train_synth_pointgroup.sh`` with ``model.trainer.precision=float32``
(batch 2, train caps 131072 points / voxels, 64 instances, 512 clusters,
128 proposals, lr 0.004, cosine decay from epoch 30 of 60, prepare_epochs
20, augmentation on).

There is no YAML loader. ``with_overrides`` takes dotted keys
(``{"net.m": 8, "caps.clusters": 128}``) and raises on any key it does not
know, including the TPU-layout backends the port does not carry.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

CLASS_NAMES = (
    "floor", "wall", "cabinet", "bed", "chair", "sofa", "table", "door", "window",
    "bookshelf", "picture", "counter", "desk", "curtain", "refrigerator",
    "shower curtain", "toilet", "sink", "bathtub", "otherfurniture")

# config keys of the JAX package whose backends the port does not carry
# (model.network.* and data.caps.* of the TPU-layout conv / clustering variants)
UNSUPPORTED_KEYS = (
    "blocked_subm", "tap_compact", "zslice_subm", "channel_major", "dense_grid",
    "remat", "cluster_cell_xyz", "cluster_cell_shifted", "shifted_units",
    "cluster_units_shifted", "cluster_granularity", "cc_coarsen", "grid")


@dataclass(frozen=True)
class SyntheticCfg:
    """data.synthetic of the golden eval (train/val scene counts, scene shape)."""

    train_scenes: int = 12
    val_scenes: int = 3
    num_objects: int = 8
    points_per_object: int = 3000
    floor_points: int = 16000
    seed: int = 7


@dataclass(frozen=True)
class CapsCfg:
    """data.caps fields read by the port (train caps: points, voxels,
    instances; eval caps: eval_*)."""

    points: int = 131072
    voxels: int = 131072
    instances: int = 64
    eval_points: int = 131072
    eval_voxels: int = 98304
    eval_instances: int = 64
    level_divisors: tuple = (1, 2, 4, 8, 16, 32, 64)
    neighbors: int = 32
    cell_window: int = 32
    bq_half_space: bool = True
    bq_edge_factor: int = 56
    bq_edge_factor_xyz: int = 0
    cc_iters: int = 32
    cluster_units: int = 65536
    clusters: int = 16384
    proposals: int = 128


@dataclass(frozen=True)
class TestCfg:
    """model.network.test (reference pointgroup.yaml)."""

    TEST_NMS_THRESH: float = 0.3
    TEST_SCORE_THRESH: float = 0.09
    TEST_NPOINT_THRESH: int = 100


@dataclass(frozen=True)
class NetCfg:
    """model.network of PointGroup."""

    m: int = 16
    blocks: tuple = (1, 2, 3, 4, 5, 6, 7)
    block_reps: int = 2
    use_color: bool = True
    use_normal: bool = False
    score_scale: float = 50.0
    score_fullscale: int = 14
    cluster_radius: float = 0.03
    cluster_npoint_thre: int = 50
    fg_thresh: float = 0.75
    bg_thresh: float = 0.25
    prepare_epochs: int = 20
    test: TestCfg = field(default_factory=TestCfg)

    @property
    def input_channel(self) -> int:
        return 3 + 3 * self.use_color + 3 * self.use_normal


@dataclass(frozen=True)
class EvalConfig:
    voxel_size: float = 0.02
    classes: int = 20
    ignore_classes: tuple = (1, 2)
    class_names: tuple = CLASS_NAMES
    synthetic: SyntheticCfg = field(default_factory=SyntheticCfg)
    caps: CapsCfg = field(default_factory=CapsCfg)
    net: NetCfg = field(default_factory=NetCfg)
    test_seed: int = 321

    def with_overrides(self, overrides: dict) -> "EvalConfig":
        """Copy with dotted-key overrides, e.g. ``{"net.m": 8}``."""
        cfg = self
        for key, value in overrides.items():
            cfg = _replace_path(cfg, key.split("."), value, key)
        return cfg


@dataclass(frozen=True)
class AugmentationCfg:
    """data.augmentation (all on in the recipe)."""

    jitter_xyz: bool = True
    flip: bool = True
    rotation: bool = True
    elastic: bool = True
    jitter_rgb: bool = True


@dataclass(frozen=True)
class TrainConfig(EvalConfig):
    """The golden training recipe (see the module docstring). Fields beyond
    ``EvalConfig``'s: data.batch_size, max_num_point, full_scale and
    augmentation; model.optimizer.lr, lr_decay.decay_start_epoch and
    trainer.max_epochs; global_train_seed."""

    caps: CapsCfg = field(default_factory=lambda: CapsCfg(clusters=512))
    batch_size: int = 2
    max_num_point: int = 250000
    full_scale: tuple = (128, 512)
    augmentation: AugmentationCfg = field(default_factory=AugmentationCfg)
    lr: float = 0.004
    decay_start_epoch: int = 30
    max_epochs: int = 60
    global_train_seed: int = 123


def _replace_path(obj, parts: list, value, full_key: str):
    name = parts[0]
    if name in UNSUPPORTED_KEYS:
        raise ValueError(f"config key {full_key!r} selects a TPU-layout backend of the "
                         "JAX package that the port does not carry")
    names = {f.name for f in dataclasses.fields(obj)}
    if name not in names:
        raise KeyError(f"unknown config key {full_key!r} (have {sorted(names)})")
    if len(parts) == 1:
        if isinstance(value, list):
            value = tuple(value)
        return dataclasses.replace(obj, **{name: value})
    return dataclasses.replace(
        obj, **{name: _replace_path(getattr(obj, name), parts[1:], value, full_key)})


@dataclass(frozen=True)
class StaticCaps:
    """The fields of the JAX package's ``model/caps.py::StaticCaps`` that the
    port reads (``from_cfg`` at split "train" or "val")."""

    voxel_caps: tuple
    instances: int
    clusters: int
    proposals: int
    neighbors: int
    window: int
    cc_iters: int
    cluster_units: int
    half_space: bool
    edge_factor: int
    edge_factor_xyz: int

    @classmethod
    def from_cfg(cls, cfg: EvalConfig, split: str = "val") -> "StaticCaps":
        c = cfg.caps
        n_levels = len(cfg.net.blocks)
        train = split == "train"
        return cls(
            voxel_caps=tuple(backbone_caps(cfg, split)[:n_levels]),
            instances=c.instances if train else c.eval_instances,
            clusters=c.clusters,
            proposals=c.proposals,
            neighbors=c.neighbors,
            window=c.cell_window,
            cc_iters=c.cc_iters,
            cluster_units=min(c.cluster_units, c.points if train else c.eval_points),
            half_space=c.bq_half_space,
            edge_factor=c.bq_edge_factor,
            edge_factor_xyz=c.bq_edge_factor_xyz,
        )


def backbone_caps(cfg: EvalConfig, split: str = "val") -> list:
    """Voxel capacity of every UNet level (``general_model.backbone_caps``)."""
    v = cfg.caps.voxels if split == "train" else cfg.caps.eval_voxels
    return [max(v // d, 1024) for d in cfg.caps.level_divisors]
