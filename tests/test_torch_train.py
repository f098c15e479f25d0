"""PointGroup training of the PyTorch port against the JAX package, at a
small size on the CPU (m=8, blocks [1, 2, 3], one rep, two ~5k-point
synthetic scenes per batch), both sides starting from the JAX model's
initial variables (``convert.py``), TF32 off.

Tolerances:
* augmentation and the train item: exact (the same numpy draws from
  generators made from one seed);
* losses within 1e-5 relative; every parameter gradient and the batch-norm
  statistics within 1e-5 of the tensor's max abs (f32 sums in another
  order through the whole network; measured: at most 2e-6), a gradient's
  scale taken as at least 0.01 (a gradient that is 0 in exact arithmetic,
  such as a Dense bias right before a batch norm, reads rounding noise of
  about 3e-8 on both sides);
* the Adam step: the port's update equals optax's update of the port's own
  gradients within 1e-6 of the parameter's scale; against the JAX package's
  parameters after its own step, within 1e-5 of the scale wherever the
  gradient exceeds 1e-3 of that gradient scale (Adam's first step moves a
  parameter by lr * g / (|g| + eps), which for a gradient at rounding level
  is a coin flip between +lr and -lr; those elements are held to lr);
* the heads-active step: score_loss within 1e-5 relative, the score
  branch's gradients within 1e-5 of their scale; the ScoreNet's and the
  point features' gradients within 1e-2 of their scale against the JAX
  package in f32, because XLA:CPU's f32 gradient of the ScoreNet's dense
  convs strays from an f64 evaluation by up to 7e-3 of the scale on such
  proposal volumes (measured; the port's f32 stays within 2e-6 of it), and
  within 1e-5 against the JAX ScoreNet with f64 convolutions
  (``test_score_net_train_grad_matches_jax_f64_convs``).
"""

import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from minsu3d_tpu.config import load_config
from minsu3d_tpu.csrc import native
from minsu3d_tpu.data import transform as jtransform
from minsu3d_tpu.data.dataset import GeneralDataset
from minsu3d_tpu.model import general_model as jgm
from minsu3d_tpu.model import get_model
from minsu3d_tpu.model import pointgroup as jpg
from minsu3d_tpu.model.caps import StaticCaps as JaxStaticCaps
from minsu3d_tpu.model.module.blocks import Backbone as JaxBackbone
from minsu3d_tpu.model.module.dense_blocks import DenseTinyUnet as JaxDenseTinyUnet
from minsu3d_tpu.util.lr_decay import cosine_lr as jax_cosine_lr
from minsu3d_tpu_torch import train as train_entry
from minsu3d_tpu_torch.config import StaticCaps, TrainConfig, backbone_caps
from minsu3d_tpu_torch.convert import jax_to_state_dict
from minsu3d_tpu_torch.data import transform
from minsu3d_tpu_torch.data.batching import collate, train_caps
from minsu3d_tpu_torch.data.datamodule import TrainData
from minsu3d_tpu_torch.data.dataset import normalize, train_item
from minsu3d_tpu_torch.data.synthetic import make_scene
from minsu3d_tpu_torch.model import pointgroup
from minsu3d_tpu_torch.model.module.dense_blocks import DenseTinyUnet
from minsu3d_tpu_torch.model.pointgroup import PointGroupNet
from minsu3d_tpu_torch.test import batch_to_torch, set_f32_numerics
from minsu3d_tpu_torch.trainer.trainer import Trainer, max_param_change, param_snapshot
from minsu3d_tpu_torch.util.lr_decay import cosine_lr
from test_torch_data import port_build_in_tmp  # noqa: F401
from test_torch_pointgroup import gt_backbone_outputs

RTOL = 1e-5
SCENE = dict(num_objects=5, points_per_object=500, floor_points=1600)
SMALL = {"net.m": 8, "net.blocks": [1, 2, 3], "net.block_reps": 1,
         "caps.points": 16384, "caps.voxels": 16384, "caps.clusters": 128,
         "caps.proposals": 64, "caps.neighbors": 16, "caps.cell_window": 16}
JAX_SMALL = ["model=pointgroup", "data=synthetic", "model.trainer.precision=float32",
             "model.network.m=8", "model.network.blocks=[1,2,3]",
             "model.network.block_reps=1", "data.caps.points=16384",
             "data.caps.voxels=16384", "data.caps.instances=64", "data.caps.clusters=128",
             "data.caps.proposals=64", "data.caps.neighbors=16", "data.caps.cell_window=16",
             "data.batch_size=2", "model.optimizer.lr=0.004"]
# scripts/train_synth_pointgroup.sh with model.trainer.precision=float32
RECIPE = ["model=pointgroup", "data=synthetic", "model.trainer.max_epochs=60",
          "model.network.prepare_epochs=20", "data.synthetic.train_scenes=12",
          "data.synthetic.val_scenes=3", "data.synthetic.num_objects=8",
          "data.synthetic.points_per_object=3000", "data.synthetic.floor_points=16000",
          "data.batch_size=2", "data.caps.points=131072", "data.caps.voxels=131072",
          "data.caps.eval_points=131072", "data.caps.eval_voxels=98304",
          "data.caps.instances=64", "data.caps.eval_instances=64", "data.caps.clusters=512",
          "data.caps.proposals=128", "model.network.cluster.cluster_npoint_thre=50",
          "model.optimizer.lr=0.004", "model.lr_decay.decay_start_epoch=30",
          "model.trainer.precision=float32"]


GRAD_FLOOR = 0.01
XLA_CPU_CONV_TOL = 1e-2


def _close(got, want, name, rtol=RTOL, floor=1e-30):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), floor),
                               err_msg=name)


# -- configuration and schedule ----------------------------------------------------

def test_train_config_matches_recipe():
    j, c = load_config(RECIPE), TrainConfig()
    jc = j.data.caps
    assert (c.caps.points, c.caps.voxels, c.caps.instances) == (jc.points, jc.voxels,
                                                                jc.instances)
    assert (c.caps.clusters, c.caps.proposals) == (jc.clusters, jc.proposals)
    assert (c.batch_size, c.max_num_point, tuple(c.full_scale)) == (
        j.data.batch_size, j.data.max_num_point, tuple(j.data.full_scale))
    for k in ("jitter_xyz", "flip", "rotation", "elastic", "jitter_rgb"):
        assert getattr(c.augmentation, k) == j.data.augmentation[k], k
    assert (c.lr, c.decay_start_epoch, c.max_epochs) == (
        j.model.optimizer.lr, j.model.lr_decay.decay_start_epoch, j.model.trainer.max_epochs)
    jn = j.model.network
    assert (c.net.prepare_epochs, c.net.fg_thresh, c.net.bg_thresh) == (
        jn.prepare_epochs, jn.fg_thresh, jn.bg_thresh)
    assert c.global_train_seed == j.global_train_seed
    assert c.synthetic.train_scenes == j.data.synthetic.train_scenes
    want = JaxStaticCaps.from_cfg(j, "train")
    got = StaticCaps.from_cfg(c, "train")
    for f in ("voxel_caps", "instances", "clusters", "proposals", "cluster_units"):
        assert getattr(got, f) == getattr(want, f), f
    assert backbone_caps(c, "train") == list(jgm.backbone_caps(j, "train"))


@pytest.mark.parametrize("epoch", [0, 29, 30, 31, 45, 59, 60])
def test_cosine_lr_matches_jax(epoch):
    assert cosine_lr(0.004, epoch, 30, 60) == jax_cosine_lr(0.004, epoch, 30, 60)


# -- augmentation and the train item -------------------------------------------------

def _pts(seed=0):
    return np.random.default_rng(seed).uniform(0, 300, (2000, 3)).astype(np.float32)


@pytest.mark.parametrize("name", ["jitter_mat", "flip_mat", "rotz_mat", "elastic", "crop"])
def test_transform_matches_jax(name):
    calls = {"jitter_mat": lambda t, g: t.jitter_mat(g),
             "flip_mat": lambda t, g: t.flip_mat(g, 0, random=True),
             "rotz_mat": lambda t, g: t.rotz_mat(g.random() * 2 * np.pi),
             "elastic": lambda t, g: t.elastic(_pts() - 150, 6.0, 40.0, g),
             "crop": lambda t, g: t.crop(_pts(), 800, 512, g)}[name]
    got = calls(transform, np.random.default_rng(42))
    want = calls(jtransform, np.random.default_rng(42))
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(a, b)


def test_train_item_matches_jax(monkeypatch):
    """Augmentation, elastic distortion and a crop (max_num_point below the
    scene's size) from one generator seed; voxels compared per point, since
    the JAX package orders them by key without its native library."""
    jcfg = load_config(RECIPE + ["data.max_num_point=3000"])
    cfg = TrainConfig().with_overrides({"max_num_point": 3000})
    scene = make_scene(seed=5, **SCENE)
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(np.random, "default_rng",
                        lambda *a: np.random.Generator(np.random.PCG64(77)))
    want = GeneralDataset(jcfg, "train", scenes=[scene])[0]
    monkeypatch.undo()
    got = train_item(cfg, normalize(scene), "scene0000",
                     np.random.Generator(np.random.PCG64(77)))
    assert 1500 <= got["point_xyz"].shape[0] <= 3000
    for k in ("point_xyz", "sem_labels", "instance_ids", "num_instance",
              "instance_center_xyz", "instance_num_point", "instance_semantic_cls"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["voxel_coords"][got["p2v"]],
                                  want["voxel_coords"][want["p2v"]])
    np.testing.assert_array_equal(got["voxel_feats"][got["p2v"]],
                                  want["voxel_feats"][want["p2v"]])


def test_train_data_order_and_reproducible_items():
    cfg = TrainConfig().with_overrides({**SMALL, "synthetic.train_scenes": 4, **{
        f"synthetic.{k}": v for k, v in SCENE.items()}})
    data = TrainData(cfg)
    np.testing.assert_array_equal(data.order(3), np.random.default_rng(126).permutation(4))
    a, b = data.batch(3, [2, 0]), data.batch(3, [2, 0])
    assert a["scan_ids"] == ["synth_train0002", "synth_train0000"]
    for k in a:
        if k != "scan_ids":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert not np.array_equal(a["point_xyz"], data.batch(4, [2, 0])["point_xyz"])


# -- one train step against the JAX package ---------------------------------------------

@pytest.fixture(scope="module")
def setup():
    set_f32_numerics()
    cfg = TrainConfig().with_overrides(SMALL)
    jcfg = load_config(JAX_SMALL)
    items = [train_item(cfg, normalize(make_scene(seed=s, **SCENE)), f"s{s}",
                        np.random.default_rng(s)) for s in (21, 22)]
    batch = collate(items, train_caps(cfg), (backbone_caps(cfg, "train"),
                                             len(cfg.net.blocks)))
    arrays = {k: jnp.asarray(v) for k, v in batch.items() if k != "scan_ids"}
    jnet = get_model("PointGroup").make_net(jcfg, "train")
    variables = jax.jit(lambda k, b: jnet.init({"params": k, "cluster": k}, b, True, True))(
        jax.random.PRNGKey(3), arrays)
    variables = jax.tree.map(np.asarray, {"params": variables["params"],
                                          "batch_stats": variables["batch_stats"]})
    return dict(cfg=cfg, jcfg=jcfg, batch=batch, arrays=arrays, jnet=jnet,
                variables=variables, jcaps=JaxStaticCaps.from_cfg(jcfg, "train"))


def _port_model(setup):
    model = PointGroupNet(setup["cfg"], "train")
    model.load_state_dict(jax_to_state_dict(setup["variables"]), strict=True)
    return model


@pytest.fixture(scope="module")
def inactive_step(setup):
    """One heads-inactive step on both sides: losses, gradients, batch
    statistics, and the parameters after one Adam step."""
    jnet, jcfg, jcaps, v = setup["jnet"], setup["jcfg"], setup["jcaps"], setup["variables"]
    lr = setup["cfg"].lr

    def loss_fn(params, batch):
        out, mut = jnet.apply({"params": params, "batch_stats": v["batch_stats"]}, batch,
                              True, False, mutable=["batch_stats"])
        losses = jpg.losses(jcfg, jcaps, batch, out, False)
        return sum(losses.values()), (losses, mut["batch_stats"])

    tx = optax.adam(lr)

    @jax.jit
    def step(params, batch):
        (_, (losses, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, batch)
        updates, _ = tx.update(grads, tx.init(params), params)
        return losses, grads, stats, optax.apply_updates(params, updates)

    jlosses, jgrads, jstats, jparams = jax.tree.map(np.asarray, step(v["params"],
                                                                     setup["arrays"]))
    model = _port_model(setup)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    tb = batch_to_torch(setup["batch"], "cpu")
    out = model(tb, train=True, with_heads=False)
    losses = pointgroup.losses(setup["cfg"], model.caps, tb, out, False)
    sum(losses.values()).backward()
    grads = {k: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
             for k, p in model.named_parameters()}
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    opt.step()
    return dict(jlosses=jlosses, jgrads=jax_to_state_dict({"params": jgrads}),
                jstate=jax_to_state_dict({"params": jparams, "batch_stats": jstats}),
                losses=losses, grads=grads, before=before, model=model)


def test_inactive_step_losses_match(inactive_step):
    s = inactive_step
    assert set(s["losses"]) == set(s["jlosses"]) == {"semantic_loss", "offset_norm_loss",
                                                     "offset_dir_loss"}
    for k, v in s["losses"].items():
        np.testing.assert_allclose(float(v.detach()), float(s["jlosses"][k]), rtol=RTOL,
                                   err_msg=k)


def test_inactive_step_gradients_match(inactive_step):
    s = inactive_step
    assert set(s["grads"]) == set(s["jgrads"])
    for k, g in s["grads"].items():
        _close(g, s["jgrads"][k], k, floor=GRAD_FLOOR)
    assert float(s["grads"]["backbone.input_conv.kernel"].abs().max()) > 0


def test_inactive_step_batch_stats_match(inactive_step):
    s = inactive_step
    buffers = dict(s["model"].named_buffers())
    assert len(buffers) > 20
    for k, b in buffers.items():
        _close(b, s["jstate"][k], k)
    # the heads did not run: their statistics stay where they started
    assert torch.equal(buffers["score_net.out_bn.MaskedBatchNorm_0.var"],
                       torch.ones_like(buffers["score_net.out_bn.MaskedBatchNorm_0.var"]))


def test_inactive_step_adam_update(inactive_step):
    s = inactive_step
    params = {k: p.detach().numpy() for k, p in s["model"].named_parameters()}
    before = {k: p.numpy() for k, p in s["before"].items()}
    grads = {k: g.numpy() for k, g in s["grads"].items()}
    tx = optax.adam(TrainConfig().lr)
    updates, _ = tx.update(grads, tx.init(before), before)
    want = optax.apply_updates(before, updates)
    for k in params:
        scale = max(np.abs(before[k]).max(), 1.0)
        np.testing.assert_allclose(params[k], np.asarray(want[k]), rtol=0, atol=1e-6 * scale,
                                   err_msg=k)
        jg = np.abs(s["jgrads"][k].numpy())
        firm = jg > 1e-3 * max(jg.max(), GRAD_FLOOR)
        diff = np.abs(params[k] - s["jstate"][k].numpy())
        assert (diff[firm] <= RTOL * scale).all(), k
        assert (diff <= 2 * TrainConfig().lr + RTOL * scale).all(), k
    moved = max(float(np.abs(params[k] - before[k]).max()) for k in params)
    assert moved > 0.5 * TrainConfig().lr


# -- heads-active step with ground-truth backbone outputs ----------------------------------

@pytest.fixture(scope="module")
def heads_step(setup):
    """The heads on both sides from the same injected backbone outputs
    (ground-truth classes and offsets, random point features), in training
    mode, with the JAX voxelization key fixed and its draws handed to the
    port: score_loss and its gradients."""
    jnet, jcfg, jcaps, v = setup["jnet"], setup["jcfg"], setup["jcaps"], setup["variables"]
    batch = setup["batch"]
    rng = np.random.default_rng(12)
    feats = np.abs(rng.normal(size=(batch["point_xyz"].shape[0], setup["cfg"].net.m)))
    feats = (feats * batch["point_mask"][:, None]).astype(np.float32)
    injected = gt_backbone_outputs(batch, setup["cfg"].classes, feats)
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(key)
    jitter = tuple(tuple(np.asarray(jax.random.uniform(k, (3,))).tolist()) for k in (k1, k2))
    orig = jgm.clusters_voxelization_dense

    def fixed_key(*args):
        return orig(*args[:-1], key)

    def loss_fn(params, pf, batch):
        def intercept(next_fun, args, kwargs, context):
            if isinstance(context.module, JaxBackbone) and context.method_name == "__call__":
                return {"point_features": pf,
                        "semantic_scores": jnp.asarray(injected["semantic_scores"]),
                        "point_offsets": jnp.asarray(injected["point_offsets"])}
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(intercept):
            out, mut = jnet.apply(
                {"params": params, "batch_stats": v["batch_stats"]}, batch, True, True,
                mutable=["batch_stats"], rngs={"cluster": jax.random.PRNGKey(9)})
        losses = jpg.losses(jcfg, jcaps, batch, out, True)
        return losses["score_loss"], (out["proposal_rows"], mut["batch_stats"])

    mp = pytest.MonkeyPatch()
    mp.setattr(jgm, "clusters_voxelization_dense", fixed_key)
    try:
        (jscore, (jrows, jstats)), (jgp, jgf) = jax.jit(jax.value_and_grad(
            loss_fn, (0, 1), has_aux=True))(v["params"], jnp.asarray(feats), setup["arrays"])
    finally:
        mp.undo()

    model = _port_model(setup)
    volumes = []
    model.score_net.register_forward_hook(
        lambda mod, args, out: volumes.append((args[0].detach().clone(), args[1].clone())))
    tb = batch_to_torch(batch, "cpu")
    pf = torch.from_numpy(feats).requires_grad_()
    tin = {"point_features": pf,
           "semantic_scores": torch.from_numpy(injected["semantic_scores"]),
           "point_offsets": torch.from_numpy(injected["point_offsets"])}
    out = model.heads(tb, tin, train=True, jitter=jitter)
    score = pointgroup.losses(setup["cfg"], model.caps, tb, out, True)["score_loss"]
    score.backward()
    return dict(jscore=float(jscore), jrows=jrows, jstats=jstats,
                jgp=jax_to_state_dict({"params": jax.tree.map(np.asarray, jgp)}),
                jgf=np.asarray(jgf), score=score, rows=out["proposal_rows"], pf=pf,
                model=model, volume=volumes[0])


def test_heads_step_proposals_and_score_loss_match(heads_step):
    s = heads_step
    assert int(s["rows"]["n_proposals"]) == int(s["jrows"].n_proposals) >= 5
    for f in ("point_idx", "prop_id", "valid"):
        np.testing.assert_array_equal(s["rows"][f].numpy(), np.asarray(getattr(s["jrows"], f)))
    np.testing.assert_allclose(float(s["score"].detach()), s["jscore"], rtol=RTOL)
    assert s["jscore"] > 0


@pytest.mark.parametrize("part", ["score_net", "score_branch", "point_features"])
def test_heads_step_gradients_match(heads_step, part):
    s = heads_step
    tol = RTOL if part == "score_branch" else XLA_CPU_CONV_TOL
    if part == "point_features":
        _close(s["pf"].grad, s["jgf"], part, tol, GRAD_FLOOR)
        assert float(s["pf"].grad.abs().max()) > 0
        return
    names = [k for k, _ in s["model"].named_parameters() if k.startswith(part + ".")]
    assert names
    for k in names:
        p = dict(s["model"].named_parameters())[k]
        _close(p.grad, s["jgp"][k], k, tol, GRAD_FLOOR)
    buffers = {k: b for k, b in s["model"].named_buffers() if k.startswith(part + ".")}
    want = jax_to_state_dict({"batch_stats": jax.tree.map(np.asarray, s["jstats"])})
    for k, b in buffers.items():
        _close(b, want[k], k)


def test_score_net_train_grad_matches_jax_f64_convs(heads_step, setup):
    """The ScoreNet alone in training mode on the heads step's proposal
    volumes, random cotangent: the port's f32 parameter gradients against
    the JAX ScoreNet with f64 convolutions (batch norms stay f32 there)."""
    x, occ = (t.numpy() for t in heads_step["volume"])
    cot = np.random.default_rng(0).normal(size=x.shape).astype(np.float32)
    p = setup["variables"]["params"]["score_net"]
    stats = setup["variables"]["batch_stats"]["score_net"]
    net = DenseTinyUnet(setup["cfg"].net.m)
    net.load_state_dict(jax_to_state_dict({"params": p, "batch_stats": stats}), strict=True)
    (net(torch.from_numpy(x), torch.from_numpy(occ), True) * torch.from_numpy(cot)).sum().backward()
    jax.config.update("jax_enable_x64", True)
    try:
        f64 = jax.tree.map(lambda a: np.asarray(a, np.float64), {"params": p, "batch_stats": stats})
        jnet = JaxDenseTinyUnet(setup["cfg"].net.m, compute_dtype=jnp.float64)

        def f(params):
            y, _ = jnet.apply({"params": params, "batch_stats": f64["batch_stats"]},
                              jnp.asarray(x, jnp.float64), jnp.asarray(occ), True,
                              mutable=["batch_stats"])
            return jnp.sum(y * cot.astype(np.float64))

        want = jax_to_state_dict({"params": jax.tree.map(np.asarray, jax.grad(f)(f64["params"]))})
    finally:
        jax.config.update("jax_enable_x64", False)
    for k, param in net.named_parameters():
        _close(param.grad, want[k].numpy(), k, RTOL, GRAD_FLOOR)


# -- trainer, checkpoint, entry point ------------------------------------------------------

TINY = {**SMALL, "synthetic.train_scenes": 4, "net.prepare_epochs": 0,
        "net.cluster_npoint_thre": 20, **{f"synthetic.{k}": v for k, v in SCENE.items()}}


def test_trainer_checkpoint_round_trip(tmp_path):
    """Save after one step; the next step of the saved trainer and of a
    trainer loaded from the checkpoint give identical losses (CPU), and
    both phases of the recipe run: heads off in epoch 0, on in epoch 1;
    ``step``'s ``mark`` hook names each part of the step as it ends."""
    cfg = TrainConfig().with_overrides(TINY)
    data = TrainData(cfg)
    a = Trainer(cfg, data, "cpu", out_dir=str(tmp_path))
    snap = param_snapshot(a.model)
    first = a.step()
    assert "score_loss" not in first["losses"] and not a.heads_active
    path = a.save_checkpoint(str(tmp_path / "ck.pt"))
    second = a.step()
    assert a.epoch == 1 and a.heads_active
    third = a.step()
    assert "score_loss" in third["losses"]
    assert max_param_change(snap, a.model) > 0
    assert all(np.isfinite(v) for r in (first, second, third) for v in r["losses"].values())

    b = Trainer(cfg, data, "cpu", seed=999)
    b.load_checkpoint(path)
    assert (b.epoch, b.pos, b.global_step) == (0, 1, 1)
    parts = []   # the step's parts, named as they end, for a caller that times them
    assert b.step(mark=parts.append)["losses"] == second["losses"]
    assert parts == ["host_input", "forward", "backward", "adam"]
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["epoch"] for r in records] == [0]
    assert "diag/voxels_dropped" in records[0]


def test_train_entry_point_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_entry.main(["--steps", "1"])


def test_train_entry_point_runs_on_cpu(tmp_path, capsys):
    args = ["--device", "cpu", "--steps", "3", "--out", str(tmp_path)]
    args += [f"{k}={v}" for k, v in TINY.items()]
    trainer = train_entry.main([a.replace(" ", "") for a in args])
    out = capsys.readouterr().out
    assert "step 1 epoch 0 heads=0" in out and "step 3 epoch 1 heads=1" in out
    assert "score_loss=" in out and (tmp_path / "last.pt").exists()
    assert trainer.global_step == 3
