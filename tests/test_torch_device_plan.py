"""The device grid plan of the PyTorch port (``host_plan=false``:
minsu3d_tpu_torch/ops/sparse.py::build_plan on K15-K17's plain versions)
against the JAX package's ``sparse.build_plan`` and the port's host plan
(``data/batching.py::build_plan_host``), bit for bit, at caps that
overflow level 2; the ``host_plan`` key; and a small PointGroup forward
with ``host_plan=false`` on both sides: against the JAX model fed a batch
collated with no plan (its ``build_scene_plan`` device branch) within
tests/test_torch_pointgroup.py's tolerances, and against the port's own
host-plan forward bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minsu3d_tpu.config import load_config
from minsu3d_tpu.ops import sparse as jsparse
from minsu3d_tpu_torch.config import (EvalConfig, HaisTrainConfig, TrainConfig, backbone_caps,
                                      parse_overrides)
from minsu3d_tpu_torch.data import batching
from minsu3d_tpu_torch.data.dataset import eval_item, normalize
from minsu3d_tpu_torch.data.synthetic import make_scene
from minsu3d_tpu_torch.ops import sparse, sparse_conv
from minsu3d_tpu_torch.test import batch_to_torch
from test_torch_data import PORT_CFG, _items, port_build_in_tmp  # noqa: F401
from test_torch_pointgroup import JAX_SMALL, SMALL, _close, run_both

LEVEL_KEYS = list(sparse.PLAN_FIELDS)


@pytest.fixture(scope="module")
def plans():
    """The same collated 2-scene batch through the three plan builders."""
    b = batching.collate(_items(), batching.eval_caps(PORT_CFG))
    caps, n_levels = backbone_caps(PORT_CFG), len(PORT_CFG.net.blocks)
    host = batching.build_plan_host(b["voxel_batch"], b["voxel_coords"], b["voxel_mask"],
                                    caps, n_levels)
    jplan, jr2v, jfeats = jax.jit(jsparse.build_plan, static_argnums=(3, 4))(
        jnp.asarray(b["voxel_batch"]), jnp.asarray(b["voxel_coords"]),
        jnp.asarray(b["voxel_mask"]), tuple(caps), n_levels, jnp.asarray(b["voxel_feats"]))
    t = batch_to_torch(b, "cpu")
    plan, r2v, feats = sparse.build_plan(t["voxel_batch"], t["voxel_coords"], t["voxel_mask"],
                                         caps, n_levels, t["voxel_feats"])
    return dict(batch=b, host=host, jplan=jplan, jr2v=jr2v, jfeats=jfeats, plan=plan, r2v=r2v,
                feats=feats, arrays=sparse.plan_arrays(plan, r2v))


@pytest.mark.parametrize("key", LEVEL_KEYS)
def test_build_plan_level_fields_match_jax_and_host(plans, key):
    assert int(plans["host"]["plan2_dropped"]) > 0   # the small caps overflow level 2
    field = sparse.PLAN_FIELDS[key]
    for lvl, jlv in enumerate(plans["jplan"].levels):
        name = f"plan{lvl}_{key}"
        want = getattr(jlv, field)
        if want is None:      # parent links stop at the coarsest level
            assert name not in plans["arrays"] and name not in plans["host"]
            continue
        got = plans["arrays"][name].numpy()
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
        host = np.asarray(plans["host"][name])
        assert got.dtype == host.dtype, name
        np.testing.assert_array_equal(got, host, err_msg=name)


def test_build_plan_row2voxel_and_features_match(plans):
    r2v = plans["r2v"].numpy()
    np.testing.assert_array_equal(r2v, np.asarray(plans["jr2v"]))
    np.testing.assert_array_equal(r2v, plans["host"]["plan_row2voxel"])
    np.testing.assert_array_equal(plans["feats"].numpy(), np.asarray(plans["jfeats"]))
    src = plans["host"]["plan0_featsrc"]
    b = plans["batch"]
    want = np.where((src >= 0)[:, None], b["voxel_feats"][np.maximum(src, 0)], 0)
    np.testing.assert_array_equal(plans["feats"].numpy(), want)


def test_device_plan_equals_plan_from_batch(plans):
    """``device_plan`` (the backbone's host_plan=false branch) and
    ``plan_from_batch`` on the host arrays give the same plan and maps."""
    b = dict(plans["batch"], **plans["host"])
    t = batch_to_torch(b, "cpu")
    n_levels = len(PORT_CFG.net.blocks)
    want_plan, want_v2p, want_feats = sparse.plan_from_batch(t, n_levels)
    got_plan, got_v2p, got_feats = sparse.device_plan(t, backbone_caps(PORT_CFG), n_levels)
    assert torch.equal(got_v2p, want_v2p) and torch.equal(got_feats, want_feats)
    for lvl, (g, w) in enumerate(zip(got_plan.levels, want_plan.levels)):
        for field in sparse.PLAN_FIELDS.values():
            a, e = getattr(g, field), getattr(w, field)
            assert (a is None) == (e is None), (lvl, field)
            if a is not None:
                assert torch.equal(a, e), (lvl, field)


def test_both_plan_paths_give_the_same_conv_tables(plans):
    """``sparse_conv.conv_tables`` (K1's tap orders and k2s2 tables, built
    per forward pass from the plan) is the same over the host plan
    (``plan_from_batch``) and the device plan (``device_plan``)."""
    b = dict(plans["batch"], **plans["host"])
    t = batch_to_torch(b, "cpu")
    n_levels = len(PORT_CFG.net.blocks)
    host = sparse_conv.conv_tables(sparse.plan_from_batch(t, n_levels)[0])
    dev = sparse_conv.conv_tables(sparse.device_plan(t, backbone_caps(PORT_CFG), n_levels)[0])
    assert len(host) == len(dev) == n_levels
    for lvl, (h, d) in enumerate(zip(host, dev)):
        pairs = [(h.nbr_order, d.nbr_order)]
        if lvl + 1 < n_levels:
            assert torch.equal(h.links.down, d.links.down) and torch.equal(h.links.up, d.links.up)
            pairs += [(h.links.down_order, d.links.down_order),
                      (h.links.up_order, d.links.up_order)]
        else:
            assert h.links is None and d.links is None
        for ho, do in pairs:
            assert torch.equal(ho.perm, do.perm) and torch.equal(ho.key, do.key), lvl
            assert ho.n_rows == do.n_rows, lvl


def test_host_plan_key():
    for cls in (EvalConfig, TrainConfig, HaisTrainConfig):
        assert cls().host_plan is True
    off = EvalConfig().with_overrides(parse_overrides(["host_plan=false"]))
    assert off.host_plan is False
    assert batching.plan_spec(off) is None
    assert batching.plan_spec(TrainConfig().with_overrides({"host_plan": False}),
                              "train") is None
    assert batching.plan_spec(EvalConfig()) == (backbone_caps(EvalConfig()), 7)
    assert load_config(["model=pointgroup", "data=synthetic"]).data.host_plan is True


@pytest.fixture(scope="module")
def run_device_plan():
    """Both models on one scene collated with no plan: each backbone builds
    its plan on the device (JAX: ``build_scene_plan``'s device branch)."""
    cfg = EvalConfig().with_overrides({**SMALL, "host_plan": False})
    scene = normalize(make_scene(seed=21, num_objects=5, points_per_object=500,
                                 floor_points=1600))
    batch = batching.collate([eval_item(cfg, scene, "scene0")], batching.eval_caps(cfg),
                             batching.plan_spec(cfg))
    assert "plan0_nbr" not in batch
    return run_both(cfg, load_config(JAX_SMALL + ["data.host_plan=false"]), batch)


@pytest.mark.parametrize("key", ["point_features", "semantic_scores", "point_offsets"])
def test_pointgroup_device_plan_backbone_matches_jax(run_device_plan, key):
    _close(run_device_plan["tbackbone"][key], run_device_plan["jbackbone"][key], key)


def test_pointgroup_device_plan_heads_match_jax(run_device_plan):
    jout, tout = run_device_plan["jout"], run_device_plan["tout"]
    jr, tr = jout["proposal_rows"], tout["proposal_rows"]
    assert int(tr["n_proposals"]) == int(jr.n_proposals) >= 5
    for f in ("point_idx", "prop_id", "valid"):
        np.testing.assert_array_equal(tr[f].numpy(), np.asarray(getattr(jr, f)), err_msg=f)
    for k in ("units_dropped", "proposals_dropped", "edges_dropped", "clusters_dropped"):
        assert int(tout["diag"][k]) == int(jout["diag"][k]), k
    _close(tout["proposal_scores"], jout["proposal_scores"], "proposal_scores")


def test_device_plan_forward_equals_host_plan_forward(run_device_plan):
    """The port's forward with host_plan=false equals its host-plan forward
    bit for bit: outputs and every diag counter."""
    cfg, model = run_device_plan["cfg"], run_device_plan["model"]
    no_plan = batch_to_torch(run_device_plan["batch"], "cpu")
    b = run_device_plan["batch"]
    hp = batching.build_plan_host(b["voxel_batch"], b["voxel_coords"], b["voxel_mask"],
                                  backbone_caps(cfg), len(cfg.net.blocks))
    with_plan = batch_to_torch(dict(b, **hp), "cpu")
    with torch.no_grad():
        got, want = model(no_plan), model(with_plan)
    for k in ("semantic_scores", "point_offsets", "point_features", "proposal_scores"):
        assert torch.equal(got[k], want[k]), k
    for k in ("point_idx", "prop_id", "valid", "n_proposals"):
        assert torch.equal(got["proposal_rows"][k], want["proposal_rows"][k]), k
    assert got["diag"].keys() == want["diag"].keys()
    for k in want["diag"]:
        assert int(got["diag"][k]) == int(want["diag"][k]), k
