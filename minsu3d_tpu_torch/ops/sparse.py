"""Sparse voxel grid plans as torch tensors.

``Level``/``GridPlan`` mirror minsu3d_tpu/ops/sparse.py:33-93 with the
fields the default conv dispatch reads and the table fields of the plan
build. A plan comes from one of two places, as in
minsu3d_tpu/model/general_model.py::build_scene_plan (:29-112):

* ``plan_from_batch`` rebuilds it from the host-built ``plan{l}_*`` arrays
  (``data/batching.py::build_plan_host``, the default ``host_plan=True``),
  including the representative-feature gather (``plan0_featsrc``) and the
  point -> level-0 voxel map ``v2p``;
* ``build_plan`` builds it on the batch's device (``host_plan=false``):
  ``build_base`` (:94), ``build_parent`` (:164), ``add_neighbors`` (:141)
  and ``build_plan`` (:178) on ops/hashing.py's key sort (K15), kernel-map
  lookup (K16's neighbour mode, every level's map in one launch) and
  unique/compaction (K17). On the card it makes no
  host-device sync; ``device_plan`` wraps it as the backbone reads it.

Both give the same arrays bit for bit. Index ``cap`` (the level capacity)
means "absent" in every int table. Tables stay int32; conversion to int64
for torch indexing happens where a table is used as an index.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from minsu3d_tpu_torch.ops import hashing as hs
from minsu3d_tpu_torch.ops.hashing import COORD_MAX, pack_key


class Level(NamedTuple):
    """One plan level: what the convs and the diag read, then the sorted
    table (None where the plan came from a batch without those arrays)."""

    valid: torch.Tensor       # (V,) bool
    n_dropped: torch.Tensor   # () int32 voxels lost to capacity overflow
    nbr_idx: Optional[torch.Tensor] = None     # (V, 27) int32, cap = absent
    parent_idx: Optional[torch.Tensor] = None  # (V,) int32 into level l+1
    child_kid: Optional[torch.Tensor] = None   # (V,) int32 k2s2 tap 0..7
    khi: Optional[torch.Tensor] = None         # (V,) int32 sorted keys (major)
    klo: Optional[torch.Tensor] = None         # (V,) int32 sorted keys (minor)
    coords: Optional[torch.Tensor] = None      # (V, 3) int32 at this level
    batch: Optional[torch.Tensor] = None       # (V,) int32 batch id
    count: Optional[torch.Tensor] = None       # () int32 valid voxels

    @property
    def cap(self) -> int:
        return self.valid.shape[0]


class GridPlan(NamedTuple):
    levels: tuple


# plan{l}_<key> array of build_plan_host -> Level field
PLAN_FIELDS = {"khi": "khi", "klo": "klo", "coords": "coords", "batch": "batch",
               "valid": "valid", "count": "count", "dropped": "n_dropped", "nbr": "nbr_idx",
               "parent": "parent_idx", "kid": "child_kid"}


def point_voxels(row2voxel: torch.Tensor, p2v: torch.Tensor, cap0: int) -> torch.Tensor:
    """v2p (N,) int64: the level-0 voxel of every point (cap0 = none), from
    the voxel row of each point and each voxel row's level-0 index."""
    row2voxel = row2voxel.long()
    r2v_ext = torch.cat([row2voxel, row2voxel.new_full((1,), cap0)])
    return r2v_ext[p2v.long().clamp(max=row2voxel.shape[0])]


def representative_feats(feats: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Each slot's features from its representative input row (src < 0:
    a zero row)."""
    src = src.long()
    out = feats[src.clamp(min=0)]
    return torch.where((src >= 0)[:, None], out, torch.zeros_like(out))


def plan_from_batch(batch: dict, num_levels: int):
    """(GridPlan, v2p (N,) int64 level-0 index per point (cap = none),
    level-0 voxel features) from a collated batch of tensors."""
    levels = []
    for lvl in range(num_levels):
        levels.append(Level(**{f: batch.get(f"plan{lvl}_{k}") for k, f in PLAN_FIELDS.items()}))
    voxel_feats = representative_feats(batch["voxel_feats"], batch["plan0_featsrc"])
    v2p = point_voxels(batch["plan_row2voxel"], batch["p2v"], levels[0].cap)
    return GridPlan(levels=tuple(levels)), v2p, voxel_feats


def plan_dropped(plan: GridPlan) -> torch.Tensor:
    """Voxels lost to level-capacity overflow across the plan."""
    return sum(lv.n_dropped.to(torch.int64) for lv in plan.levels)


def build_base(batch: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor, cap: int,
               feats: torch.Tensor | None = None):
    """Sorted unique fixed-capacity table of (batch, coords) rows: (Level
    without kernel map, row2voxel (N,) int32 with cap = invalid/dropped,
    representative features (cap, C) or None). Duplicates merge into the
    first row in key order (K15 is stable), whose features the slot takes;
    coords are clipped to [0, 1024). K15 then K17 on CUDA tensors."""
    c = coords.clamp(0, COORD_MAX - 1)
    khi, klo = hs.mask_invalid(*hs.pack(batch, c), valid)
    s_key, perm = hs.key_sort(pack_key(khi, klo))
    _, tab = hs.unique_compact(s_key, valid, perm, cap)
    feats_v = None if feats is None else representative_feats(feats, tab.src)
    level = Level(valid=tab.valid, n_dropped=tab.n_dropped, khi=tab.khi, klo=tab.klo,
                  coords=tab.coords, batch=tab.batch, count=tab.count)
    return level, tab.row2voxel, feats_v


def add_neighbors(level: Level) -> Level:
    """The level with its (V, 27) kernel map (K16's neighbour mode on one
    level; ``build_plan`` maps every level in one call)."""
    return level._replace(nbr_idx=hs.neighbor_maps([level])[0])


def build_parent(level: Level, cap_p: int) -> tuple:
    """(child with parent links, parent level): the parent table of
    coords >> 1, each child's parent row and its k2s2 tap (the coords' low
    bits, 0 on invalid rows)."""
    c = level.coords
    parent, child2parent, _ = build_base(level.batch, c >> 1, level.valid, cap_p)
    kid = ((c[:, 0] & 1) << 2) | ((c[:, 1] & 1) << 1) | (c[:, 2] & 1)
    kid = torch.where(level.valid, kid, torch.zeros_like(kid))
    return level._replace(parent_idx=child2parent, child_kid=kid), parent


def build_plan(batch: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor, caps: list,
               num_levels: int, feats: torch.Tensor | None = None):
    """The full UNet grid plan on the inputs' device: (GridPlan, row2voxel
    (N,) int32, level-0 features or None). ``caps[l]`` is level l's
    capacity."""
    level0, row2voxel, feats_v = build_base(batch, coords, valid, caps[0], feats)
    levels = [level0]
    for lvl in range(1, num_levels):
        child, parent = build_parent(levels[-1], caps[lvl])
        levels[-1] = child
        levels.append(parent)
    maps = hs.neighbor_maps(levels)                 # every level's kernel map, one launch
    return (GridPlan(levels=tuple(lv._replace(nbr_idx=m) for lv, m in zip(levels, maps))),
            row2voxel, feats_v)


def device_plan(batch: dict, caps: list, num_levels: int):
    """``plan_from_batch``'s outputs from a batch that carries no host plan:
    (GridPlan, v2p, level-0 features), built on the batch's device."""
    plan, row2voxel, feats = build_plan(batch["voxel_batch"], batch["voxel_coords"],
                                        batch["voxel_mask"], caps, num_levels,
                                        batch["voxel_feats"])
    return plan, point_voxels(row2voxel, batch["p2v"], caps[0]), feats


def plan_arrays(plan: GridPlan, row2voxel: torch.Tensor) -> dict:
    """The plan as ``build_plan_host``'s ``plan{l}_*`` arrays and
    ``plan_row2voxel`` (``plan0_featsrc`` aside)."""
    out = {"plan_row2voxel": row2voxel}
    for lvl, lv in enumerate(plan.levels):
        for key, field in PLAN_FIELDS.items():
            if getattr(lv, field) is not None:
                out[f"plan{lvl}_{key}"] = getattr(lv, field)
    return out
