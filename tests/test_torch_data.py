"""Data path of the PyTorch port against the JAX package: synthetic scenes,
eval items, collate, the host-built grid plan and the config."""

import jax.numpy as jnp
import numpy as np
import pytest

from minsu3d_tpu.config import load_config
from minsu3d_tpu.csrc import native
from minsu3d_tpu.data import batching as jbatching
from minsu3d_tpu.data.dataset import GeneralDataset
from minsu3d_tpu.data.synthetic import make_scene as jax_make_scene
from minsu3d_tpu.model.caps import StaticCaps as JaxStaticCaps
from minsu3d_tpu.ops import sparse as jsparse
from minsu3d_tpu_torch.config import EvalConfig, StaticCaps, backbone_caps
from minsu3d_tpu_torch.csrc import build
from minsu3d_tpu_torch.data import batching
from minsu3d_tpu_torch.data.dataset import eval_item, normalize
from minsu3d_tpu_torch.data.synthetic import make_scene

SCENE = dict(num_objects=5, points_per_object=500, floor_points=1600)
PORT_CFG = EvalConfig().with_overrides({
    "net.m": 8, "net.blocks": [1, 2, 3], "net.block_reps": 1,
    "caps.eval_points": 16384, "caps.eval_voxels": 16384})
# the golden eval config: scripts/eval_synth_pointgroup.sh's overrides
GOLDEN_OVERRIDES = [
    "model=pointgroup", "data=synthetic", "model.network.prepare_epochs=20",
    "data.synthetic.train_scenes=12", "data.synthetic.val_scenes=3",
    "data.synthetic.num_objects=8", "data.synthetic.points_per_object=3000",
    "data.synthetic.floor_points=16000", "data.batch_size=2",
    "data.caps.points=131072", "data.caps.voxels=131072",
    "data.caps.eval_points=131072", "data.caps.eval_voxels=98304",
    "data.caps.instances=64", "data.caps.eval_instances=64",
    "data.caps.clusters=16384", "data.caps.proposals=128",
    "model.network.cluster.cluster_npoint_thre=50", "model.trainer.precision=float32"]


@pytest.fixture(autouse=True, scope="module")
def port_build_in_tmp(tmp_path_factory):
    """The port builds its host library at first use; in tests it goes to a
    pytest temp dir instead of minsu3d_tpu_torch/_build/. Other port test
    modules import this fixture."""
    mp = pytest.MonkeyPatch()
    mp.setattr(build, "BUILD_DIR", tmp_path_factory.mktemp("ms3d_build"))
    yield
    mp.undo()


def _items(seeds=(3, 4)):
    out = []
    for i, seed in enumerate(seeds):
        scene = normalize(make_scene(seed=seed, **SCENE))
        out.append(eval_item(PORT_CFG, scene, f"s{i}"))
    return out


@pytest.mark.parametrize("seed", [0, 17])
def test_synthetic_scene_matches(seed):
    a, b = make_scene(seed=seed, **SCENE), jax_make_scene(seed=seed, **SCENE)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_eval_item_matches_jax(monkeypatch):
    """Same arrays as the JAX val item; voxels compared per point, since the
    JAX package orders voxels by key without its native library."""
    jcfg = load_config(GOLDEN_OVERRIDES)
    scene = make_scene(seed=5, **SCENE)
    monkeypatch.setattr(native, "available", lambda: False)
    want = GeneralDataset(jcfg, "val", scenes=[scene])[0]
    got = eval_item(EvalConfig(), normalize(scene), "scene0000")
    for k in ("point_xyz", "sem_labels", "instance_ids", "num_instance",
              "instance_center_xyz", "instance_num_point", "instance_semantic_cls"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["voxel_coords"].shape == want["voxel_coords"].shape
    np.testing.assert_array_equal(got["voxel_coords"][got["p2v"]],
                                  want["voxel_coords"][want["p2v"]])
    np.testing.assert_array_equal(got["voxel_feats"][got["p2v"]],
                                  want["voxel_feats"][want["p2v"]])
    # port order: voxel ids in first-occurrence order of the points
    first = np.unique(got["p2v"], return_index=True)[1]
    assert np.all(np.diff(first) > 0)


def test_collate_matches_jax():
    items = _items()
    caps = batching.eval_caps(PORT_CFG)
    got = batching.collate(items, caps)
    want = jbatching.collate(items, caps)
    assert got.keys() == want.keys()
    for k in got:
        if k == "scan_ids":
            assert got[k] == want[k]
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_collate_overflow_raises():
    with pytest.raises(ValueError, match="overflows caps"):
        batching.collate(_items(), {"points": 1000, "voxels": 16384, "instances": 64})


def test_host_plan_matches_jax_plan_builder():
    """Every plan{l}_* array equals the JAX package's device plan builder."""
    b = batching.collate(_items(), batching.eval_caps(PORT_CFG))
    caps, n_levels = backbone_caps(PORT_CFG), len(PORT_CFG.net.blocks)
    host = batching.build_plan_host(b["voxel_batch"], b["voxel_coords"], b["voxel_mask"],
                                    caps, n_levels)
    plan, row2voxel, feats_v = jsparse.build_plan(
        jnp.asarray(b["voxel_batch"]), jnp.asarray(b["voxel_coords"]),
        jnp.asarray(b["voxel_mask"]), caps, n_levels, jnp.asarray(b["voxel_feats"]))
    assert int(host["plan2_dropped"]) > 0  # the small caps overflow level 2
    for lvl, lv in enumerate(plan.levels):
        for field, key in (("khi", "khi"), ("klo", "klo"), ("coords", "coords"),
                           ("batch", "batch"), ("valid", "valid"), ("count", "count"),
                           ("n_dropped", "dropped"), ("nbr_idx", "nbr"),
                           ("parent_idx", "parent"), ("child_kid", "kid")):
            if getattr(lv, field) is None:
                assert f"plan{lvl}_{key}" not in host
                continue
            np.testing.assert_array_equal(host[f"plan{lvl}_{key}"],
                                          np.asarray(getattr(lv, field)),
                                          err_msg=f"level {lvl} {field}")
    np.testing.assert_array_equal(host["plan_row2voxel"], np.asarray(row2voxel))
    src = host["plan0_featsrc"]
    feats = np.where((src >= 0)[:, None], b["voxel_feats"][np.maximum(src, 0)], 0)
    np.testing.assert_array_equal(feats, np.asarray(feats_v))


def test_static_caps_match_jax_golden_config():
    want = JaxStaticCaps.from_cfg(load_config(GOLDEN_OVERRIDES), "val")
    got = StaticCaps.from_cfg(EvalConfig())
    for field in ("voxel_caps", "clusters", "proposals", "neighbors", "window", "cc_iters",
                  "cluster_units", "half_space", "edge_factor", "edge_factor_xyz"):
        assert getattr(got, field) == getattr(want, field), field
    # the golden config takes the edge-buffer unit path this port carries
    assert want.unit_clustering and want.xyz_grid_cell == 0 and not want.shifted_units


@pytest.mark.parametrize("key,err", [("net.nope", KeyError), ("net.blocked_subm", ValueError),
                                     ("net.zslice_subm", ValueError)])
def test_config_rejects_unknown_and_unsupported_keys(key, err):
    with pytest.raises(err):
        EvalConfig().with_overrides({key: 1})


def test_eval_config_matches_jax_golden_config():
    j = load_config(GOLDEN_OVERRIDES)
    c = EvalConfig()
    net, jnet = c.net, j.model.network
    assert (net.m, tuple(net.blocks), net.block_reps) == (jnet.m, tuple(jnet.blocks),
                                                          jnet.block_reps)
    assert (net.use_color, net.use_normal) == (jnet.use_color, jnet.use_normal)
    assert (net.score_scale, net.score_fullscale) == (jnet.score_scale, jnet.score_fullscale)
    assert net.cluster_radius == jnet.cluster.cluster_radius
    assert net.cluster_npoint_thre == jnet.cluster.cluster_npoint_thre
    for k in ("TEST_NMS_THRESH", "TEST_SCORE_THRESH", "TEST_NPOINT_THRESH"):
        assert getattr(net.test, k) == jnet.test[k], k
    assert (c.voxel_size, c.classes) == (j.data.voxel_size, j.data.classes)
    assert tuple(c.ignore_classes) == tuple(j.data.ignore_classes)
    assert tuple(c.class_names) == tuple(j.data.class_names)
    for k in ("val_scenes", "num_objects", "points_per_object", "floor_points", "seed"):
        assert getattr(c.synthetic, k) == j.data.synthetic[k], k
    assert c.caps.level_divisors == tuple(j.data.caps.level_divisors)
    assert backbone_caps(c) == [max(98304 // d, 1024) for d in j.data.caps.level_divisors]
    assert c.test_seed == j.global_test_seed


def test_host_build_is_keyed_by_source_and_reused():
    path = build.build_host()
    assert path.parent == build.BUILD_DIR and path.exists()
    mtime = path.stat().st_mtime_ns
    assert build.build_host() == path and path.stat().st_mtime_ns == mtime
    assert build.host_target().name.startswith("libms3d_host-")


def test_failed_build_raises(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="build failed"):
        build._finish(build._compile(["g++", "-shared", "-fPIC", str(bad)],
                                     build.BUILD_DIR / "libbad-0.so"))
    assert not list(build.BUILD_DIR.glob("libbad*"))
