"""Plain-Python configuration of PointGroup, HAIS and SoftGroup inference
and training.

``EvalConfig()`` is the golden-oracle eval config: the values of the JAX
package's ``config/data/base.yaml``, ``config/data/synthetic.yaml`` and
``config/model/{base,pointgroup}.yaml`` with the overrides of
``scripts/eval_synth_pointgroup.sh`` (f32, eval caps 131072 points /
98304 voxels, 16384 clusters, 128 proposals, cluster_npoint_thre 50).
``TrainConfig()`` is the golden training recipe,
``scripts/train_synth_pointgroup.sh`` with ``model.trainer.precision=float32``
(batch 2, train caps 131072 points / voxels, 64 instances, 512 clusters,
128 proposals, lr 0.004, cosine decay from epoch 30 of 60, prepare_epochs
20, augmentation on). ``HaisEvalConfig()`` is the golden HAIS eval,
``config/model/hais.yaml`` with the overrides of ``scripts/eval_synth_hais.sh``
(m=32, TinyUnet S=20, eval caps 57344 points / 65536 voxels / 49152
cluster units, 16384 clusters, 128 proposals, the mask-filter and
mask-IoU epochs at 40), run in f32. ``SoftGroupEvalConfig()`` is the golden
SoftGroup eval, ``config/model/softgroup.yaml`` with the overrides of
``scripts/eval_synth_softgroup.sh`` (m=32, the packed soft grouping, proposal
volumes S=20, the same eval caps as HAIS), run in f32.
``HaisTrainConfig()`` and ``SoftGroupTrainConfig()`` are the two models'
training recipes, ``scripts/train_synth_hais2.sh`` and
``scripts/train_synth_softgroup.sh`` in f32 (batch 2, train caps 98304
points / 90112 voxels / 49152 cluster units, 64 instances, 512 clusters,
128 proposals, lr 0.004, cosine decay from epoch 50 of 100, prepare_epochs
25; HAIS's mask-IoU and mask-filter epochs at 40).

Precision: every config has ``precision``, "float32" (the default) or
"bfloat16", the JAX package's ``model.trainer.precision``. "bfloat16" is the
JAX package's ``compute_dtype=jnp.bfloat16`` (``config/model/base.yaml``:
bf16 activations in the sparse backbone and the proposal volumes, bf16
products summed in f32, statistics and heads in f32). It is the JAX
package's own default: ``scripts/eval_synth_hais.sh``,
``scripts/eval_synth_softgroup.sh`` and every ``scripts/train_synth_*.sh``
set no precision and so run bf16 as written; only
``scripts/eval_synth_pointgroup.sh`` sets float32. The port keeps float32 as
its default, so the configs above are those scripts in f32; the override
``precision=bfloat16`` runs inference as the HAIS and SoftGroup scripts are
written, and training as every ``scripts/train_synth_*.sh`` is written (the
backward then rounds where the JAX package's bf16 train step rounds:
``ops/sparse_conv.py``, ``ops/segment.py``; parameters, batch statistics
and Adam stay f32).

There is no YAML loader. ``with_overrides`` takes dotted keys
(``{"net.m": 8, "caps.clusters": 128}``) and raises on any key it does not
know, including the TPU-layout backends the port does not carry;
``parse_overrides`` reads them from ``key=value`` command-line arguments.

Grid plan: ``host_plan`` is the JAX package's ``data.host_plan``
(``config/data/base.yaml:9``, default true): the collate builds the UNet
grid plan on the host; ``host_plan=false`` ships no plan and the backbone
builds it on the batch's device (kernels K15-K17 on the card), as
``general_model.build_scene_plan``'s device branch does.

Clustering variants: the ``caps`` keys ``cluster_granularity``,
``shifted_units``, ``cluster_units_shifted``, ``cluster_cell_xyz``,
``cluster_cell_shifted``, ``bq_grid_max_m`` and ``bq_edge_factor`` /
``bq_edge_factor_xyz`` select the clustering as they do in the JAX package
(``general_model.cluster_step``). The JAX benchmark's production clustering
(bench.py:63-121) is ``caps.shifted_units=true
caps.cluster_units_shifted=40960 caps.cluster_cell_xyz=0.03
caps.cluster_units=40960 caps.neighbors=16 caps.bq_edge_factor=28`` (56 for
SoftGroup) and, for PointGroup, ``caps.bq_edge_factor_xyz=8``.
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field
from typing import ClassVar

CLASS_NAMES = (
    "floor", "wall", "cabinet", "bed", "chair", "sofa", "table", "door", "window",
    "bookshelf", "picture", "counter", "desk", "curtain", "refrigerator",
    "shower curtain", "toilet", "sink", "bathtub", "otherfurniture")

# config keys of the JAX package whose backends the port does not carry
# (model.network.* of the TPU-layout conv variants and data.caps.grid of the
# dense-grid backbone)
UNSUPPORTED_KEYS = (
    "blocked_subm", "tap_compact", "zslice_subm", "channel_major", "dense_grid",
    "remat", "grid")

GRANULARITIES = ("unit", "point")


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
    # the root-graph coarsening of connected components (data/base.yaml:65,
    # :74): after cc_coarsen_sweeps sweeps, hook on a list of at most
    # cc_coarsen distinct cross-root pairs; 0 turns it off
    cc_coarsen: int = 4096
    cc_coarsen_sweeps: int = 2
    cluster_units: int = 65536
    clusters: int = 16384
    proposals: int = 128
    # the clustering variants (data/base.yaml's keys): "unit" clusters
    # (voxel, class) or grid units, "point" the points themselves;
    # shifted_units builds the shifted clustering's units on a grid of
    # cluster_cell_shifted metres (0: voxel_size) in the shifted coordinates,
    # at most cluster_units_shifted of them (0: cluster_units);
    # cluster_cell_xyz > 0 builds the original-coordinate units on such a
    # grid; a grid of cells at least radius / bq_grid_max_m wide takes the
    # direct grid ball query
    cluster_granularity: str = "unit"
    shifted_units: bool = False
    cluster_units_shifted: int = 0
    cluster_cell_xyz: float = 0.0
    cluster_cell_shifted: float = 0.0
    bq_grid_max_m: int = 1

    def __post_init__(self):
        if self.cluster_granularity not in GRANULARITIES:
            raise ValueError(f"cluster_granularity {self.cluster_granularity!r}: want one of "
                             f"{GRANULARITIES}")


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


PRECISIONS = ("float32", "bfloat16")


@dataclass(frozen=True)
class EvalConfig:
    MODEL: ClassVar[str] = "PointGroup"

    voxel_size: float = 0.02
    classes: int = 20
    ignore_classes: tuple = (1, 2)
    class_names: tuple = CLASS_NAMES
    synthetic: SyntheticCfg = field(default_factory=SyntheticCfg)
    caps: CapsCfg = field(default_factory=CapsCfg)
    net: NetCfg = field(default_factory=NetCfg)
    test_seed: int = 321
    precision: str = "float32"
    # data.host_plan (config/data/base.yaml:9): collate the grid plan on the
    # host (csrc/host_ops.cpp); false builds it on the batch's device
    host_plan: bool = True

    def __post_init__(self):
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision {self.precision!r}: want one of {PRECISIONS}")

    def with_overrides(self, overrides: dict) -> "EvalConfig":
        """Copy with dotted-key overrides, e.g. ``{"net.m": 8}``."""
        cfg = self
        for key, value in overrides.items():
            cfg = _replace_path(cfg, key.split("."), value, key)
        return cfg


@dataclass(frozen=True)
class HaisTestCfg:
    """model.network.test of HAIS (reference hais.yaml)."""

    TEST_SCORE_THRESH: float = 0.09
    TEST_NPOINT_THRESH: int = 100
    test_mask_score_thre: float = -0.5


@dataclass(frozen=True)
class HaisNetCfg:
    """model.network of HAIS (inference and its epoch gates), with the
    values of eval_synth_hais.sh."""

    m: int = 32
    blocks: tuple = (1, 2, 3, 4, 5, 6, 7)
    block_reps: int = 2
    use_color: bool = True
    use_normal: bool = False
    score_scale: float = 50.0
    score_fullscale: int = 20
    point_aggr_radius: float = 0.03
    # HAIS's score targets are the plain max IoU (hais.yaml:24-25), not
    # PointGroup's 0.75 / 0.25 ramp
    fg_thresh: float = 1.0
    bg_thresh: float = 0.0
    prepare_epochs: int = 100
    cal_iou_based_on_mask_start_epoch: int = 40
    use_mask_filter_score_feature_start_epoch: int = 40
    mask_filter_score_feature_thre: float = 0.5
    using_set_aggr_in_training: bool = False
    using_set_aggr_in_testing: bool = True
    test: HaisTestCfg = field(default_factory=HaisTestCfg)

    @property
    def input_channel(self) -> int:
        return 3 + 3 * self.use_color + 3 * self.use_normal


# data.point_num_avg / data.radius_avg of config/data/synthetic.yaml: the
# mean point count and radius of an instance of each class (-1: no instances)
SYNTH_POINT_NUM_AVG = (-1.0, -1.0) + (3000.0,) * 18
SYNTH_RADIUS_AVG = (-1.0, -1.0) + (0.7,) * 18


def golden_hais_softgroup_caps() -> CapsCfg:
    """data.caps of eval_synth_hais.sh and eval_synth_softgroup.sh."""
    return CapsCfg(points=98304, voxels=90112, eval_points=57344, eval_voxels=65536,
                   cluster_units=49152)


@dataclass(frozen=True)
class HaisEvalConfig(EvalConfig):
    """The golden HAIS eval (see the module docstring); fields beyond
    ``EvalConfig``'s: data.point_num_avg and data.radius_avg."""

    MODEL: ClassVar[str] = "HAIS"

    caps: CapsCfg = field(default_factory=golden_hais_softgroup_caps)
    net: HaisNetCfg = field(default_factory=HaisNetCfg)
    point_num_avg: tuple = SYNTH_POINT_NUM_AVG
    radius_avg: tuple = SYNTH_RADIUS_AVG


@dataclass(frozen=True)
class GroupingCfg:
    """model.network.grouping_cfg of SoftGroup; ``packed`` picks the one
    clustering over (point, class) pairs (True) or one per class."""

    score_thr: float = 0.2
    radius: float = 0.04
    npoint_thr: float = 0.05
    packed: bool = True


@dataclass(frozen=True)
class InstanceVoxelCfg:
    """model.network.instance_voxel_cfg: the proposal volumes' scale and
    side S."""

    scale: float = 50.0
    spatial_shape: int = 20


@dataclass(frozen=True)
class SoftGroupTrainCfg:
    """model.network.train_cfg: max_proposal_num caps eval proposals too;
    pos_iou_thr is the IoU from which a proposal is a positive."""

    max_proposal_num: int = 200
    pos_iou_thr: float = 0.5


@dataclass(frozen=True)
class SoftGroupTestCfg:
    """model.network.test_cfg of SoftGroup (min_npoint is also the
    grouping's skip-class rule)."""

    cls_score_thr: float = 0.001
    mask_score_thr: float = -0.5
    min_npoint: int = 100


@dataclass(frozen=True)
class SoftGroupNetCfg:
    """model.network of SoftGroup (inference), with the values of
    eval_synth_softgroup.sh."""

    m: int = 32
    blocks: tuple = (1, 2, 3, 4, 5, 6, 7)
    block_reps: int = 2
    use_color: bool = True
    use_normal: bool = False
    prepare_epochs: int = 100
    grouping_cfg: GroupingCfg = field(default_factory=GroupingCfg)
    instance_voxel_cfg: InstanceVoxelCfg = field(default_factory=InstanceVoxelCfg)
    train_cfg: SoftGroupTrainCfg = field(default_factory=SoftGroupTrainCfg)
    test_cfg: SoftGroupTestCfg = field(default_factory=SoftGroupTestCfg)

    @property
    def input_channel(self) -> int:
        return 3 + 3 * self.use_color + 3 * self.use_normal


@dataclass(frozen=True)
class SoftGroupEvalConfig(EvalConfig):
    """The golden SoftGroup eval (see the module docstring); fields beyond
    ``EvalConfig``'s: data.point_num_avg."""

    MODEL: ClassVar[str] = "SoftGroup"

    caps: CapsCfg = field(default_factory=golden_hais_softgroup_caps)
    net: SoftGroupNetCfg = field(default_factory=SoftGroupNetCfg)
    point_num_avg: tuple = SYNTH_POINT_NUM_AVG


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


def golden_hais_softgroup_train_caps() -> CapsCfg:
    """data.caps of train_synth_hais2.sh and train_synth_softgroup.sh."""
    return CapsCfg(points=98304, voxels=90112, eval_points=57344, eval_voxels=49152,
                   cluster_units=49152, clusters=512)


@dataclass(frozen=True)
class HaisTrainConfig(TrainConfig):
    """HAIS's training recipe (see the module docstring): ``TrainConfig``'s
    fields with HAIS's net, caps, schedule and class statistics."""

    MODEL: ClassVar[str] = "HAIS"

    caps: CapsCfg = field(default_factory=golden_hais_softgroup_train_caps)
    net: HaisNetCfg = field(default_factory=lambda: HaisNetCfg(prepare_epochs=25))
    decay_start_epoch: int = 50
    max_epochs: int = 100
    point_num_avg: tuple = SYNTH_POINT_NUM_AVG
    radius_avg: tuple = SYNTH_RADIUS_AVG


@dataclass(frozen=True)
class SoftGroupTrainConfig(TrainConfig):
    """SoftGroup's training recipe (see the module docstring)."""

    MODEL: ClassVar[str] = "SoftGroup"

    caps: CapsCfg = field(default_factory=golden_hais_softgroup_train_caps)
    net: SoftGroupNetCfg = field(default_factory=lambda: SoftGroupNetCfg(prepare_epochs=25))
    decay_start_epoch: int = 50
    max_epochs: int = 100
    point_num_avg: tuple = SYNTH_POINT_NUM_AVG


def parse_overrides(items: list) -> dict:
    """``key=value`` arguments -> an overrides dict for ``with_overrides``;
    values are Python literals where they parse as one, ``true`` / ``false``
    booleans (as in the JAX package's YAML overrides), else strings."""
    out = {}
    for item in items:
        key, sep, raw = item.partition("=")
        if not sep:
            raise ValueError(f"override {item!r} is not key=value")
        if raw.lower() in ("true", "false"):
            out[key] = raw.lower() == "true"
            continue
        try:
            out[key] = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            out[key] = raw
    return out


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
    port reads (``from_cfg`` at split "train" or "val"), derived as there
    (caps.py:86-101). ``edge_factor`` 0 selects the fused ball query (no
    edge buffer). The fields after ``edge_factor_xyz`` default to the
    golden configs' clustering ((voxel, class) units, no grids) but for
    ``cc_coarsen``, which defaults to 0 (no coarsening) as the JAX
    dataclass's does, while ``from_cfg`` reads the configs' 4096;
    ``cluster_units_shifted`` is read only with ``shifted_units``."""

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
    unit_clustering: bool = True
    shifted_units: bool = False
    cluster_units_shifted: int = 0
    xyz_grid_cell: float = 0.0
    shifted_grid_cell: float = 0.0
    bq_grid_max_m: int = 1
    cc_coarsen: int = 0
    cc_coarsen_sweeps: int = 2

    @classmethod
    def from_cfg(cls, cfg: EvalConfig, split: str = "val") -> "StaticCaps":
        c = cfg.caps
        n_levels = len(cfg.net.blocks)
        train = split == "train"
        cluster_units = min(c.cluster_units, c.points if train else c.eval_points)
        return cls(
            voxel_caps=tuple(backbone_caps(cfg, split)[:n_levels]),
            instances=c.instances if train else c.eval_instances,
            clusters=c.clusters,
            proposals=c.proposals,
            neighbors=c.neighbors,
            window=c.cell_window,
            cc_iters=c.cc_iters,
            cluster_units=cluster_units,
            half_space=c.bq_half_space,
            edge_factor=c.bq_edge_factor,
            edge_factor_xyz=c.bq_edge_factor_xyz,
            unit_clustering=c.cluster_granularity == "unit",
            shifted_units=bool(c.shifted_units),
            cluster_units_shifted=int(c.cluster_units_shifted) or cluster_units,
            xyz_grid_cell=float(c.cluster_cell_xyz),
            shifted_grid_cell=float(c.cluster_cell_shifted),
            bq_grid_max_m=int(c.bq_grid_max_m),
            cc_coarsen=int(c.cc_coarsen),
            cc_coarsen_sweeps=int(c.cc_coarsen_sweeps),
        )


def backbone_caps(cfg: EvalConfig, split: str = "val") -> list:
    """Voxel capacity of every UNet level (``general_model.backbone_caps``)."""
    v = cfg.caps.voxels if split == "train" else cfg.caps.eval_voxels
    return [max(v // d, 1024) for d in cfg.caps.level_divisors]
