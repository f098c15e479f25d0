"""PointGroup inference of the PyTorch port against the JAX model, at a small
size (m=8, blocks [1, 2, 3], one rep, one ~5k-point synthetic scene), with
the JAX model's own initial variables carried over by ``convert.py``.

* backbone outputs: 1e-5 relative to each output's scale (f32 sums in
  another order);
* heads: both sides get the same backbone outputs -- the JAX model through
  ``flax.linen.intercept_methods`` on its Backbone -- built from the scene's
  ground truth so that clustering has real instances to find. Proposal rows
  and every overflow counter must be identical, proposal scores within 1e-5
  relative, and the AP table and semantic metrics equal.
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
from minsu3d_tpu.model import get_model
from minsu3d_tpu.model import pointgroup as jpg
from minsu3d_tpu.model.module.blocks import Backbone as JaxBackbone
from minsu3d_tpu.model.module.dense_blocks import DenseTinyUnet as JaxDenseTinyUnet
from minsu3d_tpu.ops import segment as jseg
from minsu3d_tpu_torch.config import EvalConfig, backbone_caps
from minsu3d_tpu_torch.convert import jax_to_state_dict
from minsu3d_tpu_torch.data.batching import collate, eval_caps
from minsu3d_tpu_torch.data.dataset import eval_item, normalize
from minsu3d_tpu_torch.data.synthetic import make_scene
from minsu3d_tpu_torch.evaluation.instance_segmentation import (
    GeneralDatasetEvaluator, get_gt_instances)
from minsu3d_tpu_torch.evaluation.semantic_segmentation import evaluate_semantic_miou
from minsu3d_tpu_torch.model import general_model as gm
from minsu3d_tpu_torch.model.module.dense_blocks import DenseTinyUnet
from minsu3d_tpu_torch.model.pointgroup import PointGroupNet, pred_instances
from minsu3d_tpu_torch.ops import proposal_voxelize, segment
from minsu3d_tpu_torch.test import batch_to_torch, out_to_numpy
from test_torch_data import port_build_in_tmp  # noqa: F401

RTOL = 1e-5
SMALL = {"net.m": 8, "net.blocks": [1, 2, 3], "net.block_reps": 1,
         "caps.eval_points": 16384, "caps.eval_voxels": 16384, "caps.clusters": 128,
         "caps.proposals": 64, "caps.neighbors": 16, "caps.cell_window": 16}
JAX_SMALL = ["model=pointgroup", "data=synthetic", "model.trainer.precision=float32",
             "model.network.m=8", "model.network.blocks=[1,2,3]",
             "model.network.block_reps=1", "data.caps.eval_points=16384",
             "data.caps.eval_voxels=16384", "data.caps.eval_instances=64",
             "data.caps.clusters=128", "data.caps.proposals=64",
             "data.caps.neighbors=16", "data.caps.cell_window=16"]


def _close(got, want, name):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * max(np.abs(want).max(), 1.0),
                               err_msg=name)


def gt_backbone_outputs(batch, classes: int, point_features) -> dict:
    """Backbone outputs built from the ground truth: noisy one-hot class
    scores and noisy instance-centre offsets."""
    rng = np.random.default_rng(0)
    n = batch["point_xyz"].shape[0]
    scores = np.zeros((n, classes), np.float32)
    scores[np.arange(n), np.maximum(batch["sem_labels"], 0)] = 4.0
    scores += rng.normal(0, 1.0, scores.shape).astype(np.float32)
    inst = (batch["instance_ids"] >= 0)[:, None]
    offs = (batch["instance_center_xyz"] - batch["point_xyz"]) * inst
    offs = ((offs + rng.normal(0, 0.01, offs.shape)) * batch["point_mask"][:, None]
            ).astype(np.float32)
    return {"point_features": np.asarray(point_features), "semantic_scores": scores,
            "point_offsets": offs}


def run_both(cfg, jcfg, batch, variables=None, inject="gt") -> dict:
    """Both models on one collated batch: backbones on their own, then the
    heads on the same injected backbone outputs (``inject="gt"``: built from
    the ground truth; ``"jax"``: the JAX backbone's own outputs). Without
    ``variables`` the JAX model's initial variables (PRNGKey(3)) are used."""
    arrays = {k: v for k, v in batch.items() if k != "scan_ids"}
    jnet = get_model("PointGroup").make_net(jcfg, "val")
    if variables is None:
        variables = jax.jit(lambda k, b: jnet.init({"params": k, "cluster": k}, b, False,
                                                   True))(jax.random.PRNGKey(3), arrays)
    variables = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    jbackbone = jax.jit(lambda v, b: jnet.apply(v, b, False, False))(variables, arrays)
    if inject == "gt":
        injected = gt_backbone_outputs(batch, cfg.classes, jbackbone["point_features"])
    else:
        injected = {k: np.asarray(jbackbone[k])
                    for k in ("point_features", "semantic_scores", "point_offsets")}

    def intercept(next_fun, args, kwargs, context):
        if isinstance(context.module, JaxBackbone) and context.method_name == "__call__":
            return {k: jnp.asarray(v) for k, v in injected.items()}
        return next_fun(*args, **kwargs)

    def heads(v, b):
        with nn.intercept_methods(intercept):
            return jnet.apply(v, b, False, True)

    jout = jax.jit(heads)(variables, arrays)

    vnp = jax.tree.map(np.asarray, variables)
    model = PointGroupNet(cfg)
    model.load_state_dict(jax_to_state_dict(vnp), strict=True)
    model.eval()
    tb = batch_to_torch(batch, "cpu")
    with torch.no_grad():
        tbackbone, _ = model.backbone_forward(tb)
        tout = model.heads(tb, {k: torch.from_numpy(np.array(v)) for k, v in injected.items()})
    return dict(cfg=cfg, jcfg=jcfg, batch=batch, jbackbone=jbackbone, tbackbone=tbackbone,
                jout=jout, tout=tout, variables=vnp, model=model)


def ap_pair(cfg, jcfg, batch, tout, jout) -> tuple:
    """(port AP dict, JAX AP dict, port preds, JAX preds) of one scene."""
    n = int(batch["num_points"])
    xyz, sem_gt, inst_gt = (batch["point_xyz"][:n], batch["sem_labels"][:n],
                            batch["instance_ids"][:n])
    ignore = list(cfg.ignore_classes)
    tnp = out_to_numpy(tout, n)
    jnp_out = {"semantic_scores": np.asarray(jout["semantic_scores"])[:n],
               "proposal_scores": np.asarray(jout["proposal_scores"]),
               "proposal_rows": {f: np.asarray(getattr(jout["proposal_rows"], f))
                                 for f in jout["proposal_rows"]._fields}}
    tpred = pred_instances(cfg, "scene0", xyz, tnp, len(ignore))
    jpred = jpg.pred_instances(jcfg, "scene0", xyz, jnp_out, len(ignore))
    t_ap = GeneralDatasetEvaluator(cfg.class_names, -1, ignore).evaluate(
        [tpred], [get_gt_instances(sem_gt, inst_gt, ignore)])
    j_ap = JaxEvaluator(jcfg.data.class_names, -1, ignore).evaluate(
        [jpred], [jax_gt(sem_gt, inst_gt, ignore)])
    t_miou = evaluate_semantic_miou(tnp["semantic_scores"].argmax(1), sem_gt)
    j_miou = jax_miou(jnp_out["semantic_scores"].argmax(1), sem_gt)
    return t_ap, j_ap, tpred, jpred, t_miou, j_miou


@pytest.fixture(scope="module")
def run():
    cfg = EvalConfig().with_overrides(SMALL)
    scene = normalize(make_scene(seed=21, num_objects=5, points_per_object=500,
                                 floor_points=1600))
    batch = collate([eval_item(cfg, scene, "scene0")], eval_caps(cfg),
                    (backbone_caps(cfg), len(cfg.net.blocks)))
    return run_both(cfg, load_config(JAX_SMALL), batch)


@pytest.mark.parametrize("key", ["point_features", "semantic_scores", "point_offsets"])
def test_backbone_matches_jax(run, key):
    _close(run["tbackbone"][key], run["jbackbone"][key], key)


def test_proposal_rows_identical(run):
    jr, tr = run["jout"]["proposal_rows"], run["tout"]["proposal_rows"]
    assert int(tr["n_proposals"]) == int(jr.n_proposals) >= 5
    for f in ("point_idx", "prop_id", "valid"):
        np.testing.assert_array_equal(tr[f].numpy(), np.asarray(getattr(jr, f)), err_msg=f)


def test_diag_counters_identical(run):
    jd, td = run["jout"]["diag"], run["tout"]["diag"]
    for k in ("units_dropped", "proposals_dropped", "edges_dropped", "clusters_dropped"):
        assert int(td[k]) == int(jd[k]), k
    assert int(td["cc_unconverged"]) == 0


def test_proposal_scores_match(run):
    _close(run["tout"]["proposal_scores"], run["jout"]["proposal_scores"], "proposal_scores")


def test_ap_and_miou_equal(run):
    t_ap, j_ap, tpred, jpred, t_miou, j_miou = ap_pair(run["cfg"], run["jcfg"], run["batch"],
                                                        run["tout"], run["jout"])
    assert len(tpred) == len(jpred) > 0
    for a, b in zip(tpred, jpred):
        assert a["label_id"] == b["label_id"] and a["pred_mask"] == b["pred_mask"]
    for k in ("all_ap", "all_ap_50%", "all_ap_25%"):
        assert t_ap[k] == j_ap[k], k
    assert t_ap["all_ap_50%"] > 0.5
    assert t_miou == j_miou


def test_clusters_voxelization_dense_matches_jax(run):
    """Volumes, occupancy and row cells of the proposal re-voxelization; the
    grid cells come from coordinates only and match exactly on the CPU."""
    from minsu3d_tpu.model import general_model as jgm
    from minsu3d_tpu.ops.instance_iou import ProposalRows

    jr, tr = run["jout"]["proposal_rows"], run["tout"]["proposal_rows"]
    feats = np.array(run["jbackbone"]["point_features"])
    xyz = run["batch"]["point_xyz"]
    want = jgm.clusters_voxelization_dense(
        ProposalRows(*(jnp.asarray(x) for x in jr)), 64, jnp.asarray(feats),
        jnp.asarray(xyz), 50.0, 14, jax.random.PRNGKey(0))
    got = gm.clusters_voxelization_dense(tr, 64, torch.from_numpy(feats),
                                         torch.from_numpy(xyz), 50.0, 14)
    for name, g, w in zip(("volume", "occ", "row_cell"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[1].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_voxelize_rows_gives_feats_the_row_gather_chains_gradient(dtype):
    """K7 reads ``feats[pidx]`` itself: the volume and the gradient that
    reaches ``feats`` through ``voxelize_rows(feats, pidx, ...)`` equal, bit
    for bit, those of the chain it replaced: ``segment.gather_rows(feats,
    pidx)``, ``torch.where`` on the valid rows, then a voxelization whose
    backward gathers the volume's cotangent at each row's won cell. Points
    recur across proposals, so the ordered sums add several rows."""
    rng = np.random.default_rng(11)
    n, n_rows, p_cap, s, c = 300, 2000, 8, 6, 5
    tr = {"point_idx": torch.from_numpy(rng.integers(0, n, n_rows)),
          "prop_id": torch.from_numpy(rng.integers(0, p_cap, n_rows).astype(np.int32)),
          "valid": torch.from_numpy(rng.random(n_rows) < 0.8)}
    coords = torch.from_numpy(rng.random((n, 3), dtype=np.float32))
    feats = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)).to(dtype)
    g_vol = torch.from_numpy(rng.normal(size=(p_cap * s ** 3, c)).astype(np.float32)).to(dtype)
    csr = gm.proposal_csr(tr, p_cap)
    pidx, _, valid, mean, scale, offset = gm.voxelization_placement(tr, p_cap, coords, 50.0, s,
                                                                    csr=csr)
    new = feats.clone().requires_grad_(True)
    volume, _, row_cell = proposal_voxelize.voxelize_rows(new, pidx, coords, csr, mean, scale,
                                                          offset, p_cap, s)
    volume.backward(g_vol)

    old = feats.clone().requires_grad_(True)
    f = segment.gather_rows(old, pidx)
    f = torch.where(valid[:, None], f, torch.zeros_like(f))
    *_, cell_w = proposal_voxelize.place_plain(feats, pidx, coords, csr, mean, scale, offset,
                                               p_cap, s)
    win = cell_w < p_cap * s ** 3
    want = torch.zeros_like(volume)
    want[cell_w[win]] = f.detach()[win]
    f.backward(torch.cat([g_vol, g_vol.new_zeros((1, c))])[cell_w])

    assert torch.equal(volume.detach().view(torch.uint8), want.view(torch.uint8))
    assert torch.equal(new.grad.view(torch.uint8), old.grad.view(torch.uint8))
    assert int(torch.bincount(pidx[win], minlength=n).max()) > 1   # sums of several rows
    assert torch.equal(row_cell[~valid], torch.full_like(row_cell[~valid], p_cap * s ** 3))


def test_segment_reductions_match_jax():
    rng = np.random.default_rng(5)
    data = rng.normal(size=(500, 4)).astype(np.float32)
    seg = rng.integers(0, 9, 500).astype(np.int32)   # segments 7, 8 stay empty below
    valid = rng.random(500) < 0.8
    seg = np.where(seg >= 7, 10, seg).astype(np.int32)
    seg_j = np.where(valid, seg, 10)
    args_t = (torch.from_numpy(data), torch.from_numpy(seg_j), torch.from_numpy(valid), 10)
    args_j = (jnp.asarray(data), jnp.asarray(seg_j), jnp.asarray(valid), 10)
    for name in ("sec_mean", "sec_min", "sec_max", "roipool"):
        got = getattr(segment, name)(*args_t)
        want = getattr(jseg, name)(*args_j)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    assert (segment.roipool(*args_t)[7:] == 0).all()


@pytest.mark.parametrize("s", [14, 13])
def test_dense_tiny_unet_matches_jax(run, s):
    """ScoreNet alone on a random occupied volume (weights from the fixture);
    an odd extent takes the pad-and-crop path."""
    params = run["variables"]["params"]["score_net"]
    stats = run["variables"]["batch_stats"]["score_net"]
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, s, s, s, 8)).astype(np.float32)
    occ = rng.random((3, s, s, s)) < 0.3
    x = x * occ[..., None]
    want = JaxDenseTinyUnet(8).apply({"params": params, "batch_stats": stats},
                                     jnp.asarray(x), jnp.asarray(occ), False)
    net = DenseTinyUnet(8)
    sd = jax_to_state_dict({"params": params, "batch_stats": stats})
    net.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(occ))
    _close(got, want, "score_net")


def test_entry_point_runs_on_cpu(monkeypatch, capsys):
    """``python -m minsu3d_tpu_torch.test`` end to end on the CPU, at the small
    size: prints the AP table, the semantic metrics and the counters."""
    from minsu3d_tpu_torch import test as entry
    from minsu3d_tpu_torch.model import registry

    small = EvalConfig().with_overrides({**SMALL, "synthetic.num_objects": 3,
                                         "synthetic.points_per_object": 400,
                                         "synthetic.floor_points": 1500})
    monkeypatch.setattr(entry, "get_model", lambda name: registry.get_model(name)._replace(
        eval_config=lambda: small))
    entry.main(["--device", "cpu", "--scenes", "1"])
    out = capsys.readouterr().out
    for needle in ("average", "Semantic Accuracy:", "Semantic mean IoU:",
                   "per-scene forward ms (cpu)", "cc_unconverged"):
        assert needle in out, needle
