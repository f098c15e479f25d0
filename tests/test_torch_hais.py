"""HAIS inference of the PyTorch port against the JAX model, at a small size
(m=8, blocks [1, 2, 3], one rep, one ~3k-point synthetic scene), with the
JAX model's own initial variables carried over by ``convert.py``.

* backbone outputs: 1e-5 relative to each output's scale (f32 sums in
  another order);
* heads, with the mask filter on and off: both sides get the same backbone
  outputs, built from the scene's ground truth with some points thrown off
  their instance centre, so that the shifted clustering finds primaries,
  kept fragments and fragments to absorb. Proposal rows, primaries_dropped
  and every diag counter must be identical, mask and proposal scores within
  1e-5 of their scale, and AP, AP50 and mIoU equal. The instance sizes of
  the small scene are ~500 points, so both sides take point_num_avg 500
  (primaries above 150 points, kept fragments above 25);
* ``hierarchical_aggregation`` alone on crafted clusters, bit for bit:
  set aggregation on and off, an exact and a near tie of two primaries,
  random clusterings of several classes and batches, more than 512
  primaries (primaries_dropped > 0), and 1024 clusters in two batches with
  600 primaries, exact ties and fragments next to primaries that the
  512-slot table drops.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minsu3d_tpu.config import load_config
from minsu3d_tpu.evaluation.instance_segmentation import (
    GeneralDatasetEvaluator as JaxEvaluator)
from minsu3d_tpu.evaluation.instance_segmentation import get_gt_instances as jax_gt
from minsu3d_tpu.evaluation.semantic_segmentation import evaluate_semantic_miou as jax_miou
from minsu3d_tpu.model import get_model as jax_get_model
from minsu3d_tpu.model import hais as jhais
from minsu3d_tpu.model.module.blocks import Backbone as JaxBackbone
from minsu3d_tpu.ops.cluster import Clusters as JaxClusters
from minsu3d_tpu_torch.config import HaisEvalConfig, backbone_caps
from minsu3d_tpu_torch.convert import jax_to_state_dict
from minsu3d_tpu_torch.data.batching import collate, eval_caps
from minsu3d_tpu_torch.data.dataset import eval_item, normalize
from minsu3d_tpu_torch.data.synthetic import make_scene
from minsu3d_tpu_torch.evaluation.instance_segmentation import (
    GeneralDatasetEvaluator, get_gt_instances)
from minsu3d_tpu_torch.evaluation.semantic_segmentation import evaluate_semantic_miou
from minsu3d_tpu_torch.model import hais
from minsu3d_tpu_torch.model.registry import get_model
from minsu3d_tpu_torch.ops.cluster import Clusters
from minsu3d_tpu_torch.ops.sparse import plan_dropped
from minsu3d_tpu_torch.test import batch_to_torch, out_to_numpy
from test_torch_data import port_build_in_tmp  # noqa: F401

RTOL = 1e-5
PNA = (-1.0, -1.0) + (500.0,) * 18
SMALL = {"net.m": 8, "net.blocks": [1, 2, 3], "net.block_reps": 1,
         "caps.eval_points": 8192, "caps.eval_voxels": 8192, "caps.cluster_units": 4096,
         "caps.clusters": 128, "caps.proposals": 64, "caps.neighbors": 16,
         "caps.cell_window": 16, "point_num_avg": PNA}
JAX_SMALL = ["model=hais", "data=synthetic", "model.trainer.precision=float32",
             "model.network.m=8", "model.network.blocks=[1,2,3]",
             "model.network.block_reps=1", "model.network.prepare_epochs=25",
             "model.network.cal_iou_based_on_mask_start_epoch=40",
             "model.network.use_mask_filter_score_feature_start_epoch=40",
             "data.caps.eval_points=8192", "data.caps.eval_voxels=8192",
             "data.caps.cluster_units=4096", "data.caps.eval_instances=64",
             "data.caps.clusters=128", "data.caps.proposals=64",
             "data.caps.neighbors=16", "data.caps.cell_window=16",
             "data.point_num_avg=[" + ",".join(str(v) for v in PNA) + "]"]
EPOCHS = {"filter_on": 100, "filter_off": 10}


def _close(got, want, name):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * max(np.abs(want).max(), 1.0),
                               err_msg=name)


def gt_backbone_outputs(batch, classes: int, point_features) -> dict:
    """Noisy one-hot class scores and noisy instance-centre offsets; one
    point in 12 lands up to 0.3 m from its centre, so that small fragments
    form around the primaries, and a quarter of instance 0 lands 0.35 m
    away, a kept fragment."""
    rng = np.random.default_rng(1)
    n = batch["point_xyz"].shape[0]
    scores = np.zeros((n, classes), np.float32)
    scores[np.arange(n), np.maximum(batch["sem_labels"], 0)] = 4.0
    scores += rng.normal(0, 1.0, scores.shape).astype(np.float32)
    inst = (batch["instance_ids"] >= 0)[:, None]
    offs = (batch["instance_center_xyz"] - batch["point_xyz"]) * inst
    offs = offs + rng.normal(0, 0.005, offs.shape)
    far = rng.random(n) < 1 / 12
    offs[far] += rng.uniform(-0.3, 0.3, (int(far.sum()), 3))
    split = (batch["instance_ids"] == 0) & (rng.random(n) < 0.25)
    offs[split, 0] += 0.35      # a kept fragment of instance 0, 0.35 m off
    offs = (offs * batch["point_mask"][:, None]).astype(np.float32)
    return {"point_features": np.asarray(point_features), "semantic_scores": scores,
            "point_offsets": offs}


@pytest.fixture(scope="module")
def setup():
    cfg = HaisEvalConfig().with_overrides(SMALL)
    jcfg = load_config(JAX_SMALL)
    scene = normalize(make_scene(seed=23, num_objects=5, points_per_object=500,
                                 floor_points=600))
    batch = collate([eval_item(cfg, scene, "scene0")], eval_caps(cfg),
                    (backbone_caps(cfg), len(cfg.net.blocks)))
    arrays = {k: v for k, v in batch.items() if k != "scan_ids"}
    jnet = jax_get_model("HAIS").make_net(jcfg, "val")
    variables = jax.jit(lambda k, b: jnet.init({"params": k, "cluster": k}, b, False, True))(
        jax.random.PRNGKey(4), arrays)
    variables = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    jbackbone = jax.jit(lambda v, b: jnet.apply(v, b, False, False))(variables, arrays)
    injected = gt_backbone_outputs(batch, cfg.classes, jbackbone["point_features"])
    vnp = jax.tree.map(np.asarray, variables)
    model = hais.HAISNet(cfg)
    model.load_state_dict(jax_to_state_dict(vnp), strict=True)
    model.eval()
    tb = batch_to_torch(batch, "cpu")
    with torch.no_grad():
        tbackbone, plan = model.backbone_forward(tb)
    tbackbone["voxels_dropped"] = plan_dropped(plan)
    return dict(cfg=cfg, jcfg=jcfg, batch=batch, arrays=arrays, jnet=jnet, variables=variables,
                vnp=vnp, model=model, tb=tb, jbackbone=jbackbone, tbackbone=tbackbone,
                injected=injected, runs={})


def run_heads(setup, key: str) -> tuple:
    """(JAX out, port out) of the heads on the injected backbone outputs,
    with the forward flags at the epoch of ``key``; cached per key."""
    if key in setup["runs"]:
        return setup["runs"][key]
    cfg, jcfg, injected = setup["cfg"], setup["jcfg"], setup["injected"]
    jflags = jhais.forward_flags(jcfg, EPOCHS[key], False)
    tflags = hais.forward_flags(cfg, EPOCHS[key], False)
    assert jflags == tflags

    def intercept(next_fun, args, kwargs, context):
        if isinstance(context.module, JaxBackbone) and context.method_name == "__call__":
            return {k: jnp.asarray(v) for k, v in injected.items()}
        return next_fun(*args, **kwargs)

    def heads(v, b):
        with nn.intercept_methods(intercept):
            return setup["jnet"].apply(v, b, False, True, **jflags)

    jout = jax.jit(heads)(setup["variables"], setup["arrays"])
    with torch.no_grad():
        tout = setup["model"].heads(setup["tb"], {k: torch.from_numpy(np.array(v))
                                                  for k, v in injected.items()}, **tflags)
    setup["runs"][key] = (jout, tout)
    return jout, tout


def test_convert_maps_every_hais_variable(setup):
    sd = jax_to_state_dict(setup["vnp"])
    want = set(hais.HAISNet(setup["cfg"]).state_dict())
    assert set(sd) == want
    for name in ("mask_branch_0.weight", "mask_branch_1.weight", "score_branch.weight",
                 "tiny_unet.conv_kernel", "tiny_unet.deconv_kernel"):
        assert name in sd, name
    w = setup["vnp"]["params"]["mask_branch_0"]["kernel"]
    np.testing.assert_array_equal(sd["mask_branch_0.weight"].numpy(), w.T)


@pytest.mark.parametrize("key", ["point_features", "semantic_scores", "point_offsets"])
def test_backbone_matches_jax(setup, key):
    _close(setup["tbackbone"][key], setup["jbackbone"][key], key)


@pytest.mark.parametrize("key", sorted(EPOCHS))
def test_proposal_rows_and_diag_identical(setup, key):
    jout, tout = run_heads(setup, key)
    jr, tr = jout["proposal_rows"], tout["proposal_rows"]
    assert int(tr["n_proposals"]) == int(jr.n_proposals) >= 4
    for f in ("point_idx", "prop_id", "valid"):
        np.testing.assert_array_equal(tr[f].numpy(), np.asarray(getattr(jr, f)), err_msg=f)
    for k, v in jout["diag"].items():
        got = setup["tbackbone"] if k == "voxels_dropped" else tout["diag"]
        assert int(got[k]) == int(v), k
    assert int(tout["diag"]["primaries_dropped"]) == 0
    assert int(tout["diag"]["cc_unconverged"]) == 0


def test_injected_outputs_make_every_kind_of_cluster(setup):
    """The heads' input has kept fragments, primaries and fragments that set
    aggregation absorbs: without it, fewer primary-path rows are valid."""
    _, tout = run_heads(setup, "filter_on")
    flags = dict(hais.forward_flags(setup["cfg"], EPOCHS["filter_on"], False),
                 use_set_aggr=False)
    with torch.no_grad():
        plain = setup["model"].heads(setup["tb"], {k: torch.from_numpy(np.array(v))
                                                   for k, v in setup["injected"].items()},
                                     **flags)
    n = tout["proposal_rows"]["point_idx"].shape[0] // 2
    with_aggr, without = tout["proposal_rows"]["valid"], plain["proposal_rows"]["valid"]
    assert bool(with_aggr[:n].any()), "no kept fragment"
    assert bool(without[n:].any()), "no primary"
    assert int(with_aggr[n:].sum()) > int(without[n:].sum()), "nothing was absorbed"
    assert torch.equal(with_aggr[:n], without[:n])
    kinds = {k: int(v) for k, v in tout["cluster_kinds"].items()}
    assert min(kinds.values()) > 0, kinds
    assert int(plain["cluster_kinds"]["absorbed"]) == 0


@pytest.mark.parametrize("key", sorted(EPOCHS))
@pytest.mark.parametrize("name", ["mask_scores", "proposal_scores"])
def test_scores_match(setup, key, name):
    jout, tout = run_heads(setup, key)
    _close(tout[name], jout[name], name)


@pytest.mark.parametrize("key", sorted(EPOCHS))
def test_ap_and_miou_equal(setup, key):
    jout, tout = run_heads(setup, key)
    cfg, jcfg, batch = setup["cfg"], setup["jcfg"], setup["batch"]
    n = int(batch["num_points"])
    xyz, sem_gt, inst_gt = (batch["point_xyz"][:n], batch["sem_labels"][:n],
                            batch["instance_ids"][:n])
    ignore = list(cfg.ignore_classes)
    tnp = out_to_numpy(tout, n)
    jnp_out = {"semantic_scores": np.asarray(jout["semantic_scores"])[:n],
               "proposal_scores": np.asarray(jout["proposal_scores"]),
               "mask_scores": np.asarray(jout["mask_scores"]),
               "proposal_rows": {f: np.asarray(getattr(jout["proposal_rows"], f))
                                 for f in jout["proposal_rows"]._fields}}
    tpred = get_model("HAIS").pred_instances(cfg, "scene0", xyz, tnp, len(ignore))
    jpred = jhais.pred_instances(jcfg, "scene0", xyz, jnp_out, len(ignore))
    assert len(tpred) == len(jpred)
    for a, b in zip(tpred, jpred):
        assert a["label_id"] == b["label_id"] and a["pred_mask"] == b["pred_mask"]
    t_ap = GeneralDatasetEvaluator(cfg.class_names, -1, ignore).evaluate(
        [tpred], [get_gt_instances(sem_gt, inst_gt, ignore)])
    j_ap = JaxEvaluator(jcfg.data.class_names, -1, ignore).evaluate(
        [jpred], [jax_gt(sem_gt, inst_gt, ignore)])
    for k in ("all_ap", "all_ap_50%", "all_ap_25%"):
        assert t_ap[k] == j_ap[k] or (np.isnan(t_ap[k]) and np.isnan(j_ap[k])), k
    assert (evaluate_semantic_miou(tnp["semantic_scores"].argmax(1), sem_gt)
            == jax_miou(jnp_out["semantic_scores"].argmax(1), sem_gt))


def test_mask_filter_changes_the_scores(setup):
    """The two epochs really take the two branches of the mask filter."""
    _, on = run_heads(setup, "filter_on")
    _, off = run_heads(setup, "filter_off")
    assert not torch.equal(on["proposal_scores"], off["proposal_scores"])
    torch.testing.assert_close(on["mask_scores"], off["mask_scores"], rtol=0, atol=0)


# -- hierarchical_aggregation alone ----------------------------------------------

def _both(pc, sizes, valid, shifted, sem, bid, active, pna, ra, p_cap, use_set_aggr):
    """Rows of the JAX function and of the port on the same clustering."""
    c_cap = len(sizes)
    jclus = JaxClusters(point_cluster=jnp.asarray(pc, jnp.int32),
                        sizes=jnp.asarray(sizes, jnp.int32), valid=jnp.asarray(valid),
                        count=jnp.int32(int(np.sum(valid))))
    jrows, jdrop = jhais.hierarchical_aggregation(
        jclus, jnp.asarray(shifted), jnp.asarray(bid, jnp.int32), jnp.asarray(sem, jnp.int32),
        jnp.asarray(active), jnp.asarray(pna, jnp.float32), jnp.asarray(ra, jnp.float32),
        p_cap, use_set_aggr)
    z = torch.zeros((), dtype=torch.int64)
    tclus = Clusters(torch.as_tensor(np.asarray(pc), dtype=torch.int64),
                     torch.as_tensor(np.asarray(sizes), dtype=torch.int64),
                     torch.as_tensor(np.asarray(valid)), torch.tensor(int(np.sum(valid))), z, z,
                     z)
    trows, tdrop, kinds = hais.hierarchical_aggregation(
        tclus, torch.from_numpy(np.asarray(shifted, np.float32)),
        torch.from_numpy(np.asarray(bid, np.int32)), torch.from_numpy(np.asarray(sem, np.int64)),
        torch.from_numpy(np.asarray(active)), torch.tensor(pna, dtype=torch.float32),
        torch.tensor(ra, dtype=torch.float32), p_cap, use_set_aggr)
    for f in ("point_idx", "prop_id", "valid"):
        np.testing.assert_array_equal(trows[f].numpy(), np.asarray(getattr(jrows, f)), err_msg=f)
    assert int(trows["n_proposals"]) == int(jrows.n_proposals)
    assert int(tdrop) == int(jdrop)
    n_valid = int(np.sum(valid))
    assert int(kinds["primary"]) + int(kinds["fragment"]) == n_valid
    return trows, int(tdrop)


def _crafted():
    """test_models.py::test_hais_aggregation_semantics: one primary (100
    points), a kept fragment (20) near it and a far 2-point fragment."""
    n = 122
    pc = np.concatenate([np.zeros(100), np.ones(20), np.full(2, 2)]).astype(np.int32)
    shifted = np.zeros((n, 3), np.float32)
    shifted[100:120] += 0.05
    shifted[120:] += 10.0
    sizes = np.array([100, 20, 2, 0, 0, 0, 0, 0])
    valid = np.array([True, True, True] + [False] * 5)
    return pc, sizes, valid, shifted, np.full(n, 3), np.zeros(n), np.ones(n, bool)


@pytest.mark.parametrize("use_set_aggr", [True, False])
def test_aggregation_crafted_matches_jax(use_set_aggr):
    rows, drop = _both(*_crafted(), np.full(20, 100.0), np.full(20, 1.0), 16, use_set_aggr)
    assert drop == 0 and int(rows["n_proposals"]) == 2
    absorbed = bool(rows["valid"][122 + 100:122 + 120].all())
    assert absorbed == use_set_aggr


@pytest.mark.parametrize("gap", [0.0, 1e-4])
def test_aggregation_tie_of_two_primaries(gap):
    """A fragment half-way between two primaries of its class (exactly, or
    1e-4 nearer the second): the first index wins an exact tie."""
    pc = np.concatenate([np.zeros(50), np.ones(50), np.full(3, 2)]).astype(np.int32)
    shifted = np.zeros((103, 3), np.float32)
    shifted[:50, 0] = -0.25
    shifted[50:100, 0] = 0.25
    shifted[100:, 0] = gap
    sizes = np.array([50, 50, 3, 0])
    valid = np.array([True, True, True, False])
    rows, _ = _both(pc, sizes, valid, shifted, np.full(103, 4), np.zeros(103),
                    np.ones(103, bool), np.full(20, 100.0), np.full(20, 0.5), 8, True)
    frag = rows["prop_id"][103 + 100:]
    assert bool(rows["valid"][103 + 100:].all())
    assert set(frag.tolist()) == ({0} if gap == 0.0 else {1})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aggregation_random_clusterings(seed):
    """Many clusters of 3 classes in 2 batches, sizes from 1 to 120, with
    inactive points and invalid clusters."""
    rng = np.random.default_rng(seed)
    c_cap, n = 96, 2000
    sizes = rng.integers(1, 120, c_cap)
    valid = rng.random(c_cap) < 0.9
    pc = np.full(n, c_cap)
    members = np.repeat(np.arange(c_cap), sizes)[:n]
    pc[:members.shape[0]] = members
    pc = rng.permutation(pc)
    sizes = np.bincount(pc, minlength=c_cap + 1)[:c_cap]
    cls_of = rng.integers(2, 5, c_cap + 1)
    bid_of = rng.integers(0, 2, c_cap + 1)
    centre = rng.uniform(-1, 1, (c_cap + 1, 3))
    shifted = (centre[pc] + rng.normal(0, 0.02, (n, 3))).astype(np.float32)
    active = pc < c_cap
    _both(pc, sizes, valid, shifted, cls_of[pc], bid_of[pc], active, np.full(20, 150.0),
          np.full(20, 0.4), 64, True)


def test_aggregation_primaries_beyond_the_table():
    """520 one-point primaries and 40 fragments: 8 primaries drop out of the
    512-slot table and lose absorption, and the counter says so."""
    rng = np.random.default_rng(0)
    c_cap, n_primary = 600, 520
    sizes = np.ones(c_cap, np.int64)
    sizes[n_primary:n_primary + 40] = 0
    pc = np.arange(c_cap)
    shifted = rng.normal(0, 1, (c_cap, 3)).astype(np.float32)
    # each fragment point sits next to one of the last primaries
    frag = np.arange(n_primary, n_primary + 40)
    shifted[frag] = shifted[n_primary - 1 - (frag - n_primary) % 16] + 1e-3
    valid = np.arange(c_cap) < n_primary + 40
    active = valid
    rows, drop = _both(pc, sizes, valid, shifted, np.full(c_cap, 3), np.zeros(c_cap), active,
                       np.full(20, 1.0), np.full(20, 0.1), 1024, True)
    assert drop == n_primary - 512


def test_aggregation_beyond_the_table_with_ties_in_two_batches():
    """1024 clusters: 600 primaries of 20 points (3 classes, 2 batches) on a
    1/16 m grid, so every centre is exact; 300 fragments of 1-11 points,
    some exactly half-way between two table primaries of their class and
    batch (the first slot wins), some next to a primary beyond the 512-slot
    table; inactive points and invalid clusters. Rows, n_proposals and
    primaries_dropped bit for bit against JAX."""
    rng = np.random.default_rng(11)
    c_cap, n_prim, n_frag = 1024, 600, 300
    sizes = np.zeros(c_cap, np.int64)
    sizes[:n_prim] = 20
    frag = np.arange(n_prim, n_prim + n_frag)
    sizes[frag] = rng.integers(1, 12, n_frag)
    valid = sizes > 0
    cls_of = rng.integers(2, 5, c_cap)
    bid_of = rng.integers(0, 2, c_cap)
    centre = rng.integers(-64, 65, (c_cap, 3)) / 16.0
    prims = np.arange(n_prim)
    for i, c in enumerate(frag):
        if i % 3 == 0:      # half-way between two table primaries of one key
            a = rng.integers(0, 256)
            twin = next(j for j in range(a + 1, 512)
                        if cls_of[j] == cls_of[a] and bid_of[j] == bid_of[a])
            cls_of[twin] = cls_of[a]
            centre[twin] = centre[a] + np.array([0.5, 0.0, 0.0])
            cls_of[c], bid_of[c] = cls_of[a], bid_of[a]
            centre[c] = centre[a] + np.array([0.25, 0.0, 0.0])
        else:               # next to any primary, in the table or beyond it
            a = rng.choice(prims[-100:] if i % 3 == 1 else prims)
            cls_of[c], bid_of[c] = cls_of[a], bid_of[a]
            centre[c] = centre[a] + rng.integers(-6, 7, 3) / 16.0
    pc = np.concatenate([np.repeat(np.arange(c_cap), sizes), np.full(500, c_cap)])
    shifted = np.concatenate([centre, np.zeros((1, 3))])[pc].astype(np.float32)
    active = pc < c_cap
    rows, drop = _both(pc, sizes, valid, shifted, np.append(cls_of, 0)[pc],
                       np.append(bid_of, 0)[pc], active, np.full(20, 40.0), np.full(20, 0.5),
                       1024, True)
    assert drop == n_prim - 512
    # the data holds the cases: exact ties at the nearest table primary, and
    # fragments whose nearest primary of their key lies beyond the table
    # (distances exact on the 1/16 grid)
    ties = beyond = 0
    for c in frag:
        key = prims[(cls_of[prims] == cls_of[c]) & (bid_of[prims] == bid_of[c])]
        d = ((centre[key] - centre[c]) ** 2).sum(1)
        in_table = d[key < 512]
        ties += int(in_table.size > 1 and in_table.min() < 0.25
                    and np.sum(in_table == in_table.min()) > 1)
        beyond += int(d.min() < 0.25 and key[np.argmin(d)] >= 512)
    assert ties > 20 and beyond > 20
    assert len(set(bid_of[frag].tolist())) == 2
    n = pc.shape[0]
    assert int(rows["valid"][n:].sum()) > int(sizes[:512].sum())   # fragments absorbed


# -- configuration, registry, entry point --------------------------------------------

EVAL_SCRIPT = ["model=hais", "data=synthetic", "model.network.prepare_epochs=25",
               "model.network.cal_iou_based_on_mask_start_epoch=40",
               "model.network.use_mask_filter_score_feature_start_epoch=40",
               "data.synthetic.train_scenes=12", "data.synthetic.val_scenes=3",
               "data.synthetic.num_objects=8", "data.synthetic.points_per_object=3000",
               "data.synthetic.floor_points=16000", "data.batch_size=2",
               "data.caps.points=98304", "data.caps.voxels=90112",
               "data.caps.eval_points=57344", "data.caps.eval_voxels=65536",
               "data.caps.cluster_units=49152", "data.caps.instances=64",
               "data.caps.eval_instances=64", "data.caps.clusters=16384",
               "data.caps.proposals=128"]


def test_hais_config_matches_eval_script():
    """HaisEvalConfig() is scripts/eval_synth_hais.sh's config (in f32)."""
    from minsu3d_tpu.model.caps import StaticCaps as JaxStaticCaps
    from minsu3d_tpu_torch.config import StaticCaps

    j, c = load_config(EVAL_SCRIPT), HaisEvalConfig()
    jn = j.model.network
    for k in ("m", "block_reps", "score_scale", "score_fullscale", "point_aggr_radius",
              "cal_iou_based_on_mask_start_epoch",
              "use_mask_filter_score_feature_start_epoch", "mask_filter_score_feature_thre",
              "using_set_aggr_in_training", "using_set_aggr_in_testing", "use_color",
              "use_normal"):
        assert getattr(c.net, k) == jn[k], k
    assert c.net.blocks == tuple(jn.blocks)
    for k in ("TEST_SCORE_THRESH", "TEST_NPOINT_THRESH", "test_mask_score_thre"):
        assert getattr(c.net.test, k) == jn.test[k], k
    assert c.point_num_avg == tuple(j.data.point_num_avg)
    assert c.radius_avg == tuple(j.data.radius_avg)
    for k in ("points", "voxels", "eval_points", "eval_voxels", "cluster_units", "instances",
              "eval_instances", "clusters", "proposals", "neighbors", "cell_window",
              "bq_edge_factor", "cc_iters"):
        assert getattr(c.caps, k) == j.data.caps[k], k
    assert (c.synthetic.val_scenes, c.synthetic.num_objects, c.synthetic.points_per_object,
            c.synthetic.floor_points, c.synthetic.seed) == (
        j.data.synthetic.val_scenes, j.data.synthetic.num_objects,
        j.data.synthetic.points_per_object, j.data.synthetic.floor_points,
        j.data.synthetic.seed)
    want, got = JaxStaticCaps.from_cfg(j, "val"), StaticCaps.from_cfg(c, "val")
    for f in ("voxel_caps", "instances", "clusters", "proposals", "cluster_units"):
        assert getattr(got, f) == getattr(want, f), f
    with pytest.raises(KeyError):
        c.with_overrides({"net.cluster_npoint_thre": 50})


def test_registry_switches_models():
    assert get_model("HAIS").net is hais.HAISNet
    assert get_model("hais").eval_config is HaisEvalConfig
    assert get_model("PointGroup").net.__name__ == "PointGroupNet"
    assert get_model("SoftGroup").net.__name__ == "SoftGroupNet"
    with pytest.raises(KeyError):
        get_model("Mask3D")


def test_entry_point_runs_hais_on_cpu(monkeypatch, capsys):
    """``python -m minsu3d_tpu_torch.test --model hais`` end to end on the
    CPU at the small size: the AP table, the metrics and HAIS's counters."""
    from minsu3d_tpu_torch import test as entry

    small = HaisEvalConfig().with_overrides({**SMALL, "synthetic.num_objects": 3,
                                             "synthetic.points_per_object": 400,
                                             "synthetic.floor_points": 1500})
    monkeypatch.setattr(entry, "get_model", lambda name: get_model(name)._replace(
        eval_config=lambda: small))
    entry.main(["--device", "cpu", "--scenes", "1", "--model", "hais", "--epoch", "100"])
    out = capsys.readouterr().out
    for needle in ("average", "Semantic Accuracy:", "per-scene forward ms (cpu)",
                   "primaries_dropped"):
        assert needle in out, needle
