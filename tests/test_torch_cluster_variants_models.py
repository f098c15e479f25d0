"""PointGroup's, HAIS's and SoftGroup's heads under the clustering variants,
the port against the JAX models at a small size (m=8, blocks [1, 2, 3], one
rep), both fed the same backbone outputs built from a scene's ground truth
(``minsu3d_tpu_torch.test.injected_backbone_outputs``) and the same seeded
weights:

* the JAX benchmark's production clustering (bench.py:63-121: shifted-grid
  units, 3 cm xyz-grid units for PointGroup, K 16, edge factors 28 / 56 and
  8 for PointGroup's xyz clustering), its unit capacities scaled to the
  small caps, for all three models;
* PointGroup at ``cluster_granularity=point``, and SoftGroup's packed and
  per-class groupings there (the grouping functions on the same inputs);
* PointGroup with ``bq_edge_factor=0``, the fused ball query: before the
  port carried it, the edge query got 0 slots, dropped every edge and
  made every unit a cluster of its own.

Proposal rows, n_proposals and every JAX diag counter bit for bit (the port
also reports ``cc_unconverged``, which must read 0); scores within 1e-5 of
their scale, as the models' own parity tests. The configs: the bench
overrides give the JAX StaticCaps, the keys the port still does not carry
raise, and ``python -m minsu3d_tpu_torch.test`` takes the overrides.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minsu3d_tpu.config import load_config
from minsu3d_tpu.model import get_model as jax_get_model
from minsu3d_tpu.model import softgroup as jsg
from minsu3d_tpu.model.caps import StaticCaps as JaxStaticCaps
from minsu3d_tpu.model.module.blocks import Backbone as JaxBackbone
from minsu3d_tpu_torch.config import (EvalConfig, HaisEvalConfig, SoftGroupEvalConfig,
                                      StaticCaps, backbone_caps, parse_overrides)
from minsu3d_tpu_torch.convert import jax_to_state_dict
from minsu3d_tpu_torch.data.batching import collate, eval_caps
from minsu3d_tpu_torch.data.dataset import eval_item, normalize
from minsu3d_tpu_torch.data.synthetic import make_scene
from minsu3d_tpu_torch.model import softgroup
from minsu3d_tpu_torch.model.registry import get_model
from minsu3d_tpu_torch.test import batch_to_torch, injected_backbone_outputs
from test_torch_data import port_build_in_tmp  # noqa: F401

RTOL = 1e-5
PNA = (-1.0, -1.0) + (500.0,) * 18
PNA_JAX = "data.point_num_avg=[" + ",".join(str(v) for v in PNA) + "]"
SMALL = {"net.m": 8, "net.blocks": [1, 2, 3], "net.block_reps": 1,
         "caps.eval_points": 8192, "caps.eval_voxels": 8192, "caps.clusters": 128,
         "caps.proposals": 64, "caps.neighbors": 16, "caps.cell_window": 16}
JAX_SMALL = ["data=synthetic", "model.trainer.precision=float32", "model.network.m=8",
             "model.network.blocks=[1,2,3]", "model.network.block_reps=1",
             "data.caps.eval_points=8192", "data.caps.eval_voxels=8192",
             "data.caps.eval_instances=64", "data.caps.clusters=128",
             "data.caps.proposals=64", "data.caps.neighbors=16", "data.caps.cell_window=16"]
# per model: the port's config, its small extras, the JAX config group
MODELS = {"PointGroup": (EvalConfig, {}, ["model=pointgroup"]),
          "HAIS": (HaisEvalConfig, {"point_num_avg": PNA},
                   ["model=hais", PNA_JAX, "model.network.cal_iou_based_on_mask_start_epoch=40",
                    "model.network.use_mask_filter_score_feature_start_epoch=40"]),
          "SoftGroup": (SoftGroupEvalConfig, {"point_num_avg": PNA},
                        ["model=softgroup", PNA_JAX])}


def bench(model: str, units: int) -> dict:
    """bench.py's production clustering overrides (``cluster_overrides`` and
    ``_cluster_prod_overrides``) with ``units`` unit capacity, the cluster
    and proposal capacities scaled by units / 40960 as the bench's
    ``unit_scale`` scales them (its ``proposal_rows``, which the JAX package
    reads nowhere, has no counterpart in the port)."""
    def up(x: float, mult: int) -> int:
        return -(-int(x) // mult) * mult
    scale = units / 40960
    over = {"caps.clusters": up(16384 * scale, 1024),
            "caps.proposals": max(256, up(256 * scale, 128)),
            "caps.shifted_units": True, "caps.cluster_units_shifted": units,
            "caps.cluster_cell_xyz": 0.03, "caps.cluster_units": units, "caps.neighbors": 16,
            "caps.bq_edge_factor": 56 if model == "SoftGroup" else 28}
    if model == "PointGroup":
        over["caps.bq_edge_factor_xyz"] = 8
    return over


def jax_overrides(over: dict) -> list:
    return [f"data.{k}={str(v).lower() if isinstance(v, bool) else v}"
            for k, v in over.items()]


# case -> (model, the variant's overrides)
CASES = {"pointgroup_bench": ("PointGroup", bench("PointGroup", 4096)),
         "hais_bench": ("HAIS", bench("HAIS", 4096)),
         "softgroup_bench": ("SoftGroup", bench("SoftGroup", 4096)),
         "pointgroup_point": ("PointGroup", {"caps.cluster_granularity": "point"}),
         "pointgroup_fused": ("PointGroup", {"caps.bq_edge_factor": 0})}


@pytest.fixture(scope="module")
def shared():
    """One small scene per model and each JAX net's variables, seeded numpy
    values in the shapes of the JAX init (no init compile)."""
    return {}


def _setup(shared: dict, model: str):
    if model in shared:
        return shared[model]
    config, extra, jgroup = MODELS[model]
    cfg = config().with_overrides({**SMALL, **extra})
    scene = normalize(make_scene(seed=23, num_objects=5, points_per_object=500,
                                 floor_points=800))
    batch = collate([eval_item(cfg, scene, "scene0")], eval_caps(cfg),
                    (backbone_caps(cfg), len(cfg.net.blocks)))
    arrays = {k: v for k, v in batch.items() if k != "scan_ids"}
    jnet = jax_get_model(model).make_net(load_config(jgroup + JAX_SMALL), "val")
    shapes = jax.eval_shape(lambda k, b: jnet.init({"params": k, "cluster": k}, b, False,
                                                   True), jax.random.PRNGKey(0), arrays)
    rng = np.random.default_rng(6)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "batch_stats" in name:
            return np.full(s.shape, 1.0 if "var" in name else 0.0, np.float32)
        return (rng.normal(0, 0.3, s.shape) if "kernel" in name or "scale" in name
                else rng.normal(0, 0.05, s.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, {
        "params": shapes["params"], "batch_stats": shapes["batch_stats"]})
    injected = {k: v.numpy() for k, v in injected_backbone_outputs(
        batch, cfg.classes, cfg.net.m, 1, "cpu").items()}
    shared[model] = (cfg, batch, arrays, variables, injected, jgroup)
    return shared[model]


def run_case(shared: dict, case: str) -> tuple:
    """(JAX out, port out) of the heads of ``case`` on injected outputs."""
    key = ("out", case)
    if key in shared:
        return shared[key]
    model, over = CASES[case]
    base, batch, arrays, variables, injected, jgroup = _setup(shared, model)
    cfg = base.with_overrides(over)
    jcfg = load_config(jgroup + JAX_SMALL + jax_overrides(over))
    jnet = jax_get_model(model).make_net(jcfg, "val")
    flags = get_model(model).forward_flags(cfg, 100, False)
    assert flags == jax_get_model(model).forward_flags(jcfg, 100, False)

    def intercept(next_fun, args, kwargs, context):
        if isinstance(context.module, JaxBackbone) and context.method_name == "__call__":
            return {k: jnp.asarray(v) for k, v in injected.items()}
        return next_fun(*args, **kwargs)

    def heads(v, b):
        with nn.intercept_methods(intercept):
            return jnet.apply(v, b, False, True, **flags)

    jout = jax.jit(heads)(variables, arrays)
    net = get_model(model).net(cfg, "val")
    net.load_state_dict(jax_to_state_dict(jax.tree.map(np.asarray, variables)), strict=True)
    net.eval()
    with torch.no_grad():
        tout = net.heads(batch_to_torch(batch, "cpu"),
                         {k: torch.from_numpy(v) for k, v in injected.items()}, **flags)
    shared[key] = (jout, tout)
    return jout, tout


@pytest.mark.parametrize("case", list(CASES))
def test_proposal_rows_and_diag_identical(shared, case):
    jout, tout = run_case(shared, case)
    jr, tr = jout["proposal_rows"], tout["proposal_rows"]
    assert int(tr["n_proposals"]) == int(jr.n_proposals) >= 3
    for f in ("point_idx", "prop_id", "valid"):
        np.testing.assert_array_equal(tr[f].numpy(), np.asarray(getattr(jr, f)), err_msg=f)
    jd, td = jout["diag"], tout["diag"]
    for k in jd:
        if k != "voxels_dropped":      # the heads' counters; the backbone did not run
            assert int(td[k]) == int(jd[k]), k
    assert int(td["cc_unconverged"]) == 0
    assert int(td["edges_dropped"]) == 0 and int(td["units_dropped"]) == 0


@pytest.mark.parametrize("case", list(CASES))
def test_scores_match(shared, case):
    jout, tout = run_case(shared, case)
    keys = [k for k in ("proposal_scores", "mask_scores", "cls_scores", "iou_scores")
            if k in jout]
    assert keys
    for k in keys:
        want = np.asarray(jout[k])
        np.testing.assert_allclose(tout[k].numpy(), want, rtol=0,
                                   atol=RTOL * max(np.abs(want).max(), 1.0), err_msg=k)


def test_fused_query_equals_an_edge_buffer_that_drops_nothing(shared):
    """bq_edge_factor=0 selects the fused query: its proposals are those of
    the default edge buffer (56 slots per unit), which drops nothing here."""
    _, fused = run_case(shared, "pointgroup_fused")
    base, batch, _, variables, injected, _ = _setup(shared, "PointGroup")
    net = get_model("PointGroup").net(base, "val")
    net.load_state_dict(jax_to_state_dict(jax.tree.map(np.asarray, variables)), strict=True)
    net.eval()
    with torch.no_grad():
        edge = net.heads(batch_to_torch(batch, "cpu"),
                         {k: torch.from_numpy(v) for k, v in injected.items()})
    assert base.caps.bq_edge_factor == 56 and int(edge["diag"]["edges_dropped"]) == 0
    for f in ("point_idx", "prop_id", "valid"):
        assert torch.equal(fused["proposal_rows"][f], edge["proposal_rows"][f]), f


@pytest.mark.parametrize("packed", [True, False])
def test_softgroup_grouping_at_point_granularity(shared, packed):
    """SoftGroup's packed and per-class groupings at point granularity (no
    units: ``cluster_points`` over the pairs, or over each class's points)
    on the scene's injected outputs: rows and counters bit for bit."""
    base, batch, _, _, injected, jgroup = _setup(shared, "SoftGroup")
    over = {"caps.cluster_granularity": "point"}
    cfg = base.with_overrides(over)
    jcaps = JaxStaticCaps.from_cfg(load_config(jgroup + JAX_SMALL + jax_overrides(over)), "val")
    tcaps = StaticCaps.from_cfg(cfg)
    assert not tcaps.unit_clustering and tcaps.unit_clustering == jcaps.unit_clustering
    soft = np.asarray(jax.nn.softmax(jnp.asarray(injected["semantic_scores"]), axis=-1))
    shifted = (batch["point_xyz"] + injected["point_offsets"]).astype(np.float32)
    g, fg = cfg.net.grouping_cfg, get_model("SoftGroup").net(cfg).fg_class_ids
    n = shifted.shape[0]
    static = (fg, g.score_thr, g.radius, g.npoint_thr)
    tail = (cfg.net.test_cfg.min_npoint, cfg.net.train_cfg.max_proposal_num)
    pna = np.asarray(PNA, np.float32)
    arrays = (soft, shifted, batch["vert_batch_ids"], batch["point_mask"])

    def jax_fn(sm, pts, bids, mask, pna_, p2v):
        args = (sm, pts, bids, mask, *static, pna_, *tail, jcaps)
        if packed:
            return jsg.soft_grouping_packed(*args, p2v, pair_cap=2 * n, big_thre=25)
        return jsg.soft_grouping_compacted(*args, p2v=p2v, r_cap=2 * n, big_thre=25)

    jrows, jdiag = jax.jit(jax_fn)(*map(jnp.asarray, (*arrays, pna, batch["p2v"])))
    targs = (*(torch.from_numpy(np.array(a)) for a in arrays), *static,
             torch.from_numpy(pna), *tail, tcaps, torch.from_numpy(batch["p2v"]))
    if packed:
        trows, tdiag = softgroup.soft_grouping_packed(*targs, pair_cap=2 * n, big_thre=25)
    else:
        trows, tdiag = softgroup.soft_grouping_compacted(*targs, r_cap=2 * n, big_thre=25)
    for f in ("point_idx", "prop_id", "valid"):
        np.testing.assert_array_equal(trows[f].numpy(), np.asarray(getattr(jrows, f)),
                                      err_msg=f)
    assert int(trows["n_proposals"]) == int(jrows.n_proposals) >= 3
    for k, v in jdiag.items():
        assert int(tdiag[k]) == int(v), k
    assert int(tdiag["cc_unconverged"]) == 0


@pytest.mark.parametrize("model", list(MODELS))
def test_bench_overrides_give_the_jax_static_caps(model):
    """Full-size golden configs with the bench's overrides: every StaticCaps
    field the port has equals the JAX one, derived fields included."""
    config, _, jgroup = MODELS[model]
    over = bench(model, 40960)
    scripts = {"PointGroup": "pointgroup", "HAIS": "hais", "SoftGroup": "softgroup"}
    for split in ("val", "train"):
        got = StaticCaps.from_cfg(config().with_overrides(over), split)
        want = JaxStaticCaps.from_cfg(load_config(
            [f"model={scripts[model]}", "data=synthetic", *jax_overrides(over)]), split)
        for f in ("clusters", "proposals", "neighbors", "edge_factor", "edge_factor_xyz",
                  "unit_clustering",
                  "shifted_units",
                  "cluster_units_shifted", "xyz_grid_cell", "shifted_grid_cell",
                  "bq_grid_max_m", "cc_coarsen", "cc_coarsen_sweeps"):
            assert getattr(got, f) == getattr(want, f), (split, f)
    assert got.shifted_units and got.xyz_grid_cell == 0.03 and got.unit_clustering
    point = StaticCaps.from_cfg(EvalConfig().with_overrides(
        {"caps.cluster_granularity": "point", "caps.cluster_units": 8192}))
    assert not point.unit_clustering and point.cluster_units_shifted == 8192


def test_coarsen_caps_reach_static_caps():
    """``caps.cc_coarsen`` and ``caps.cc_coarsen_sweeps`` are accepted and
    reach StaticCaps as the JAX ``StaticCaps.from_cfg`` reads them, on each
    golden config and with overrides."""
    scripts = {"PointGroup": "pointgroup", "HAIS": "hais", "SoftGroup": "softgroup"}
    for model, (config, _, _) in MODELS.items():
        for over in ({}, {"caps.cc_coarsen": 16, "caps.cc_coarsen_sweeps": 1},
                     {"caps.cc_coarsen": 0}):
            got = StaticCaps.from_cfg(config().with_overrides(over))
            want = JaxStaticCaps.from_cfg(load_config(
                [f"model={scripts[model]}", "data=synthetic", *jax_overrides(over)]), "val")
            assert (got.cc_coarsen, got.cc_coarsen_sweeps) == (
                want.cc_coarsen, want.cc_coarsen_sweeps), (model, over)
    assert StaticCaps.from_cfg(EvalConfig()).cc_coarsen == 4096


@pytest.mark.parametrize("key,value", [
    ("caps.grid", [64, 64, 32]), ("net.dense_grid", True),
    ("net.blocked_subm", [8]), ("net.tap_compact", [0.5]), ("net.zslice_subm", True),
    ("net.channel_major", True), ("net.remat", True)])
def test_keys_still_unported_raise(key, value):
    with pytest.raises(ValueError, match="does not carry"):
        EvalConfig().with_overrides({key: value})


def test_granularity_is_checked_and_overrides_read_booleans():
    with pytest.raises(ValueError, match="cluster_granularity"):
        EvalConfig().with_overrides({"caps.cluster_granularity": "voxel"})
    over = parse_overrides(["caps.shifted_units=false", "caps.bq_grid_max_m=2",
                            "caps.cluster_granularity=point"])
    assert over == {"caps.shifted_units": False, "caps.bq_grid_max_m": 2,
                    "caps.cluster_granularity": "point"}
    assert parse_overrides(["caps.shifted_units=true"])["caps.shifted_units"] is True


@pytest.mark.parametrize("model", list(MODELS))
def test_entry_point_takes_the_bench_overrides(model, monkeypatch, capsys):
    """``python -m minsu3d_tpu_torch.test --device cpu`` with the bench's
    overrides on the command line, at the small size."""
    from minsu3d_tpu_torch import test as entry

    config, extra, _ = MODELS[model]
    small = config().with_overrides({**SMALL, **extra, "synthetic.num_objects": 3,
                                     "synthetic.points_per_object": 400,
                                     "synthetic.floor_points": 1500})
    monkeypatch.setattr(entry, "get_model", lambda name: get_model(name)._replace(
        eval_config=lambda: small))
    args = [f"{k}={str(v).lower() if isinstance(v, bool) else v}"
            for k, v in bench(model, 4096).items()]
    entry.main(["--device", "cpu", "--scenes", "1", "--model", model.lower(), *args])
    out = capsys.readouterr().out
    for needle in ("average", "per-scene forward ms (cpu)", "edges_dropped",
                   "units_dropped"):
        assert needle in out, needle
