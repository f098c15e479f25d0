"""HAIS and SoftGroup training of the PyTorch port against the JAX package,
at a small size on the CPU (m=8, blocks [1, 2, 3], one rep, a batch of two
~4k-point synthetic train scenes), both sides starting from the JAX model's
initial variables (``convert.py``), TF32 off.

* ``get_iou`` with ``row_keep``, ``proposal_argmax`` and ``get_mask_label``
  (their plain versions, which the CPU runs) against the JAX functions and
  lines, bit for bit: random rows and row masks, an all-zero proposal whose
  column 0 is masked, tied IoUs, an IoU of exactly 0.5 and one just below
  it, invalid rows that read proposal P-1's verdict; and at the training
  caps' 512 x 64 on rows as the heads write them (grouped by proposal, and
  shuffled), int64 rows and int16 / int32 / int64 instance ids with ids at
  -1 and at I or above, with every row, a random row mask and one that
  keeps nothing;
* the heads in training mode on both sides from the same injected backbone
  outputs (ground-truth classes and offsets plus seeded noise, random point
  features; ``test.injected_backbone_outputs``) and the same voxelization
  jitter, with HAIS's loss flags at both ``iou_on_mask`` settings and with
  the mask filter on, and SoftGroup's packed grouping: proposal rows bit for
  bit; the mask sigmoid's 0.5 cut the same on both sides (the port's and
  JAX's sigmoid of the same logits give the same mask, and the smallest
  |logit| of a valid row at this seed is asserted far above the two sides'
  f32 disagreement); losses within 1e-5 relative; the head branches'
  gradients within 1e-5 of their scale; the TinyUnet's and the point
  features' gradients within 1e-2 of their scale, because XLA:CPU's f32
  gradient of the dense convs strays from an f64 evaluation by up to 7e-3
  of the scale (tests/test_torch_train.py), and the TinyUnet alone on
  these proposal volumes within 1e-5 of the JAX TinyUnet with f64 convs;
* the registry's training bundles and the two recipes' configs;
* one recipe batch's grid plan at the recipes' caps.voxels=90112: the JAX
  package's plan drops the same level-1 voxels as the port's;
* ``train.main`` for both models on the CPU: 3 steps over both head phases
  with the mask gates at 0, a checkpoint, and a resumed run whose step 4
  equals the first trainer's own step 4.

The instances of the small scenes hold ~500 points, so both sides take
point_num_avg 500.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minsu3d_tpu.config import load_config
from minsu3d_tpu.data import batching as jbatching
from minsu3d_tpu.model import general_model as jgm
from minsu3d_tpu.model import get_model as jax_get_model
from minsu3d_tpu.model import hais as jhais
from minsu3d_tpu.model import softgroup as jsg
from minsu3d_tpu.model.caps import StaticCaps as JaxStaticCaps
from minsu3d_tpu.model.module.blocks import Backbone as JaxBackbone
from minsu3d_tpu.model.module.dense_blocks import DenseTinyUnet as JaxDenseTinyUnet
from minsu3d_tpu.ops import instance_iou as jiou
from minsu3d_tpu.ops import sparse as jsparse
from minsu3d_tpu_torch import train as train_entry
from minsu3d_tpu_torch.config import HaisTrainConfig, StaticCaps, backbone_caps
from minsu3d_tpu_torch.convert import jax_to_state_dict
from minsu3d_tpu_torch.data.batching import collate, train_caps
from minsu3d_tpu_torch.data.datamodule import TrainData
from minsu3d_tpu_torch.data.dataset import normalize, train_item
from minsu3d_tpu_torch.data.synthetic import make_scene
from minsu3d_tpu_torch.model import hais, softgroup
from minsu3d_tpu_torch.model.module.dense_blocks import DenseTinyUnet
from minsu3d_tpu_torch.model.registry import get_model
from minsu3d_tpu_torch.ops import instance_iou
from minsu3d_tpu_torch.test import batch_to_torch, injected_backbone_outputs, set_f32_numerics
from test_torch_data import port_build_in_tmp  # noqa: F401

RTOL = 1e-5
GRAD_FLOOR = 0.01
XLA_CPU_CONV_TOL = 1e-2
PNA = (-1.0, -1.0) + (500.0,) * 18
SCENE = dict(num_objects=5, points_per_object=500, floor_points=1600)
SMALL = {"net.m": 8, "net.blocks": [1, 2, 3], "net.block_reps": 1,
         "caps.points": 16384, "caps.voxels": 16384, "caps.cluster_units": 16384,
         "caps.clusters": 128, "caps.proposals": 16, "caps.neighbors": 16,
         "caps.cell_window": 16, "point_num_avg": PNA}


def jax_small(model: str) -> list:
    return [f"model={model}", "data=synthetic", "model.trainer.precision=float32",
            "model.network.m=8", "model.network.blocks=[1,2,3]", "model.network.block_reps=1",
            "data.caps.points=16384", "data.caps.voxels=16384",
            "data.caps.cluster_units=16384", "data.caps.instances=64",
            "data.caps.clusters=128", "data.caps.proposals=16", "data.caps.neighbors=16",
            "data.caps.cell_window=16", "data.batch_size=2", "model.optimizer.lr=0.004",
            "data.point_num_avg=[" + ",".join(str(v) for v in PNA) + "]",
            *(["model.network.cal_iou_based_on_mask_start_epoch=40",
               "model.network.use_mask_filter_score_feature_start_epoch=40"]
              if model == "hais" else [])]


# scripts/train_synth_hais2.sh and train_synth_softgroup.sh with
# model.trainer.precision=float32
def recipe(model: str) -> list:
    out = [f"model={model}", "data=synthetic", "model.trainer.max_epochs=100",
           "model.network.prepare_epochs=25", "data.synthetic.train_scenes=12",
           "data.synthetic.val_scenes=3", "data.synthetic.num_objects=8",
           "data.synthetic.points_per_object=3000", "data.synthetic.floor_points=16000",
           "data.batch_size=2", "data.caps.points=98304", "data.caps.voxels=90112",
           "data.caps.eval_points=57344", "data.caps.eval_voxels=49152",
           "data.caps.cluster_units=49152", "data.caps.instances=64",
           "data.caps.eval_instances=64", "data.caps.clusters=512", "data.caps.proposals=128",
           "model.optimizer.lr=0.004", "model.lr_decay.decay_start_epoch=50",
           "model.trainer.precision=float32"]
    if model == "hais":
        out += ["model.network.cal_iou_based_on_mask_start_epoch=40",
                "model.network.use_mask_filter_score_feature_start_epoch=40"]
    return out


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two torch threads in this module: the suite runs several workers on
    one machine, and with every core each, torch's CPU conv3d slows down
    by an order of magnitude under the contention."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _close(got, want, name, rtol=RTOL, floor=1e-30):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), floor),
                               err_msg=name)


# -- the ops, bit for bit against the JAX functions -------------------------------------

def _rows(seed: int, n: int, p: int, reps: int = 2) -> dict:
    """``reps`` rows per point, random proposals, about a quarter invalid
    (prop_id p)."""
    rng = np.random.default_rng(seed)
    prop = rng.integers(0, p + p // 3 + 1, reps * n)
    valid = prop < p
    return {"point_idx": np.tile(np.arange(n, dtype=np.int32), reps),
            "prop_id": np.where(valid, prop, p).astype(np.int32), "valid": valid,
            "n_proposals": np.int32(p)}


def _jrows(rows: dict):
    return jiou.ProposalRows(*(jnp.asarray(rows[k]) for k in ("point_idx", "prop_id", "valid",
                                                                 "n_proposals")))


def _trows(rows: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in rows.items()}


def _instances(seed: int, n: int, i_cap: int) -> tuple:
    rng = np.random.default_rng(seed)
    inst = rng.integers(-1, i_cap - 2, n).astype(np.int32)   # the last 2 slots unused
    num = np.bincount(inst[inst >= 0], minlength=i_cap).astype(np.int32)
    cls = np.where(np.arange(i_cap) < i_cap - 2, rng.integers(-1, 18, i_cap), -1)
    return inst, num, cls.astype(np.int32)


@pytest.mark.parametrize("keep", ["none", "random", "all", "nothing"])
def test_get_iou_row_keep_matches_jax(keep):
    n, p, i_cap = 3000, 24, 12
    rows = _rows(0, n, p)
    inst, num, _ = _instances(1, n, i_cap)
    r = rows["valid"].shape[0]
    mask = {"none": None, "random": np.random.default_rng(2).random(r) < 0.6,
            "all": np.ones(r, bool), "nothing": np.zeros(r, bool)}[keep]
    want = jiou.get_iou(_jrows(rows), p, jnp.asarray(inst), jnp.asarray(num), i_cap,
                        None if mask is None else jnp.asarray(mask.astype(np.float32)))
    got = instance_iou.get_iou(_trows(rows), p, torch.from_numpy(inst), torch.from_numpy(num),
                               i_cap, None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    assert (keep == "nothing") == (float(got.max()) == 0.0)
    if keep == "random":
        full = instance_iou.get_iou(_trows(rows), p, torch.from_numpy(inst),
                                    torch.from_numpy(num), i_cap)
        assert not torch.equal(got, full)


def crafted_ious() -> tuple:
    """(ious (8, 5) f32, column mask): proposal 0's unmasked IoUs are all 0
    and its column 0 is masked; 1 ties at columns 1 and 3; 2 is exactly 0.5;
    3's largest IoU lies in a masked column; 4 is the f32 just below 0.5;
    5 ties at 0.5 in columns 2 and 3; 6 is all zero; 7 is random."""
    half_minus = np.nextafter(np.float32(0.5), np.float32(0))
    ious = np.array([[0.8, 0.0, 0.0, 0.0, 0.3],
                     [0.1, 0.7, 0.2, 0.7, 0.0],
                     [0.0, 0.1, 0.5, 0.2, 0.0],
                     [0.0, 0.3, 0.1, 0.2, 0.9],
                     [0.0, 0.1, half_minus, 0.2, 0.0],
                     [0.0, 0.1, 0.5, 0.5, 0.0],
                     [0.0, 0.0, 0.0, 0.0, 0.0],
                     np.random.default_rng(3).random(5)], np.float32)
    return ious, np.array([False, True, True, True, False])


def quantised_ious(seed: int, p: int, i_cap: int) -> np.ndarray:
    """IoUs on a grid of quarters: many ties and many exact 0.5s."""
    return (np.random.default_rng(seed).integers(0, 5, (p, i_cap)) / 4).astype(np.float32)


def jax_argmax(ious, col_mask, thr):
    """The JAX lines: minsu3d_tpu/model/softgroup.py:361-364 (and
    ops/instance_iou.py:66-69)."""
    iou_m = jnp.where(jnp.asarray(col_mask)[None, :], jnp.asarray(ious), 0.0)
    mx = jnp.max(iou_m, axis=1)
    return mx, jnp.argmax(iou_m, axis=1).astype(jnp.int32), mx >= thr


@pytest.mark.parametrize("case", ["crafted", "quantised", "random"])
def test_proposal_argmax_matches_jax(case):
    if case == "crafted":
        ious, mask = crafted_ious()
    else:
        rng = np.random.default_rng(4)
        ious = (quantised_ious(5, 128, 64) if case == "quantised"
                else rng.random((128, 64)).astype(np.float32))
        mask = rng.random(64) < 0.7
    got = instance_iou.proposal_argmax(torch.from_numpy(ious), torch.from_numpy(mask), 0.5)
    want = jax_argmax(ious, mask, 0.5)
    for g, w, name in zip(got, want, ("max", "arg", "ok")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[1].dtype == torch.int32
    if case == "crafted":
        assert got[1].tolist() == [0, 1, 2, 1, 2, 2, 0, int(np.argmax(ious[7] * mask))]
        assert got[2].tolist()[:7] == [False, True, True, False, False, True, False]


@pytest.mark.parametrize("case", ["crafted", "quantised"])
def test_get_mask_label_matches_jax(case):
    """Rows of every proposal, invalid rows (prop_id P) that read proposal
    P-1, whose own rows are supervised; ignored (-1) instance classes."""
    if case == "crafted":
        ious, col_mask = crafted_ious()
        p, i_cap = ious.shape
        n = 400
        inst = np.random.default_rng(6).integers(-1, i_cap, n).astype(np.int32)
        cls = np.where(col_mask, 3, -1).astype(np.int32)
    else:
        p, i_cap, n = 128, 64, 5000
        ious = quantised_ious(7, p, i_cap)
        inst, _, cls = _instances(8, n, i_cap)
    ious[p - 1] = 0.0
    ious[p - 1, 1] = 0.75            # proposal P-1 passes the threshold
    cls[1] = 4
    rows = _rows(9, n, p)
    assert (~rows["valid"]).sum() > 100 and (rows["prop_id"] == p - 1).sum() > 0
    want = jiou.get_mask_label(_jrows(rows), p, jnp.asarray(inst), jnp.asarray(cls),
                               jnp.asarray(ious), 0.5, -1)
    got = instance_iou.get_mask_label(_trows(rows), p, torch.from_numpy(inst),
                                      torch.from_numpy(cls), torch.from_numpy(ious), 0.5, -1)
    for g, w, name in zip(got, want, ("label", "row_ok")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    label, row_ok = (g.numpy() for g in got)
    assert not row_ok[~rows["valid"]].any()
    assert row_ok.any() and label.any() and (row_ok & ~label).any()


def heads_rows(seed: int, p: int, i_cap: int, n: int = 12000, shuffled: bool = False,
               id_dtype=np.int32) -> tuple:
    """Rows as the heads write them, at the training caps' 512 proposals x
    64 instances: int64 point_idx and prop_id, each proposal's rows
    together (a run of points sorted by instance, so a proposal covers one
    or two instances and part of the background), then invalid rows at
    prop_id P; ``shuffled`` permutes the same rows. Instance ids (of dtype
    ``id_dtype``) include -1 and ids at I and above. Returns (rows, inst,
    num, cls)."""
    rng = np.random.default_rng(seed)
    inst = rng.integers(-1, i_cap + 4, n).astype(id_dtype)
    order = np.argsort(inst, kind="stable")
    starts = rng.integers(0, n - 300, p)
    lens = rng.integers(1, 300, p)
    point_idx = np.concatenate([order[s:s + k] for s, k in zip(starts, lens)])
    prop_id = np.repeat(np.arange(p), lens)
    pad = point_idx.shape[0] // 4
    point_idx = np.concatenate([point_idx, rng.integers(0, n, pad)]).astype(np.int64)
    prop_id = np.concatenate([prop_id, np.full(pad, p)]).astype(np.int64)
    if shuffled:
        perm = rng.permutation(point_idx.shape[0])
        point_idx, prop_id = point_idx[perm], prop_id[perm]
    rows = {"point_idx": point_idx, "prop_id": prop_id, "valid": prop_id < p,
            "n_proposals": np.int64(p)}
    num = np.bincount(inst[(inst >= 0) & (inst < i_cap)], minlength=i_cap).astype(id_dtype)
    cls = np.where(np.arange(i_cap) % 7 == 3, -1, rng.integers(0, 18, i_cap)).astype(id_dtype)
    return rows, inst, num, cls


HEADS_ROW_CASES = [(dt, order) for dt in (np.int16, np.int32, np.int64)
                   for order in ("grouped", "shuffled")]


@pytest.mark.parametrize("dtype,order", HEADS_ROW_CASES,
                         ids=[f"{np.dtype(d).name}-{o}" for d, o in HEADS_ROW_CASES])
def test_get_iou_and_mask_label_on_heads_rows_match_jax(dtype, order):
    """The plain versions against the JAX functions, bit for bit, at 512 x
    64 on rows as the heads write them (grouped by proposal, and shuffled),
    with int64 rows and int16 / int32 / int64 instance ids, classes and
    sizes; with every row, with a random row mask and with one that keeps
    nothing."""
    p, i_cap = 512, 64
    rows, inst, num, cls = heads_rows(11, p, i_cap, shuffled=order == "shuffled", id_dtype=dtype)
    r = rows["valid"].shape[0]
    masks = {"every row": None, "random": np.random.default_rng(12).random(r) < 0.6,
             "nothing": np.zeros(r, bool)}
    jrows, trows = _jrows(rows), _trows(rows)
    got_full = None
    for name, mask in masks.items():
        want = jiou.get_iou(jrows, p, jnp.asarray(inst), jnp.asarray(num), i_cap,
                            None if mask is None else jnp.asarray(mask.astype(np.float32)))
        got = instance_iou.get_iou(trows, p, torch.from_numpy(inst), torch.from_numpy(num),
                                   i_cap, None if mask is None else torch.from_numpy(mask))
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32), err_msg=name)
        assert (name == "nothing") == (float(got.max()) == 0.0)
        got_full = got if mask is None else got_full
    assert float(got_full.max()) >= 0.5
    want = jiou.get_mask_label(jrows, p, jnp.asarray(inst), jnp.asarray(cls),
                               jnp.asarray(got_full.numpy()), 0.5, -1)
    got = instance_iou.get_mask_label(trows, p, torch.from_numpy(inst), torch.from_numpy(cls),
                                      got_full, 0.5, -1)
    for g, w, name in zip(got, want, ("label", "row_ok")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[1].any() and got[0].any() and (got[1] & ~got[0]).any()


# -- the heads and losses in training mode against JAX -----------------------------------

@pytest.fixture(scope="module")
def batch():
    set_f32_numerics()
    cfg = HaisTrainConfig().with_overrides(SMALL)
    items = [train_item(cfg, normalize(make_scene(seed=s, **SCENE)), f"s{s}",
                        np.random.default_rng(s)) for s in (21, 22)]
    return collate(items, train_caps(cfg), (backbone_caps(cfg, "train"), len(cfg.net.blocks)))


KEY = jax.random.PRNGKey(5)


def _jitter() -> tuple:
    k1, k2 = jax.random.split(KEY)
    return tuple(tuple(np.asarray(jax.random.uniform(k, (3,))).tolist()) for k in (k1, k2))


def heads_on_both(model: str, batch, cases: dict) -> dict:
    """For each case (name: (epoch of the forward flags, loss flags)), the
    heads of the JAX and the port model in training mode on the same
    injected outputs and jitter: losses, rows, mask scores, gradients of the
    summed losses by parameter and by point features, and the TinyUnet's
    input volumes of the port."""
    bundle, jbundle = get_model(model), jax_get_model({"hais": "HAIS",
                                                      "softgroup": "SoftGroup"}[model])
    cfg = bundle.train_config().with_overrides(SMALL)
    jcfg = load_config(jax_small(model))
    jnet = jbundle.make_net(jcfg, "train")
    arrays = {k: jnp.asarray(v) for k, v in batch.items() if k != "scan_ids"}
    variables = jax.jit(lambda k, b: jnet.init({"params": k, "cluster": k}, b, True, True))(
        jax.random.PRNGKey(3), arrays)
    variables = jax.tree.map(np.array, {"params": variables["params"],
                                        "batch_stats": variables["batch_stats"]})
    if model == "hais":
        # at the JAX init every valid row's mask logit is <= 0: a bias puts
        # about half of them above the 0.5 sigmoid cut, so that the mask IoU
        # and the mask filter keep some rows and drop others
        variables["params"]["mask_branch_1"]["bias"][:] = 0.3
    jcaps = JaxStaticCaps.from_cfg(jcfg, "train")
    inj = {k: v.numpy() for k, v in injected_backbone_outputs(
        batch, cfg.classes, cfg.net.m, 12, "cpu").items()}
    orig = jgm.clusters_voxelization_dense

    def run_jax(flags, lflags):
        # every array is an argument: closed-over arrays become constants
        # that XLA folds for tens of seconds
        def loss_fn(params, pf, sem, offs, stats, b):
            def intercept(next_fun, args, kwargs, context):
                if isinstance(context.module, JaxBackbone) and context.method_name == "__call__":
                    return {"point_features": pf, "semantic_scores": sem, "point_offsets": offs}
                return next_fun(*args, **kwargs)

            with nn.intercept_methods(intercept):
                out, _ = jnet.apply({"params": params, "batch_stats": stats},
                                    b, True, True, **flags, mutable=["batch_stats"],
                                    rngs={"cluster": jax.random.PRNGKey(9)})
            losses = jbundle.losses(jcfg, jcaps, b, out, True, **lflags)
            return sum(losses.values()), (losses, out["proposal_rows"], out["mask_scores"])

        return jax.jit(jax.value_and_grad(loss_fn, (0, 1), has_aux=True))(
            variables["params"], *(jnp.asarray(inj[k]) for k in (
                "point_features", "semantic_scores", "point_offsets")),
            variables["batch_stats"], arrays)

    res = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(jgm, "clusters_voxelization_dense", lambda *a: orig(*a[:-1], KEY))
    try:
        for name, (epoch, lflags) in cases.items():
            jflags = jbundle.forward_flags(jcfg, epoch, True)
            (_, (jl, jrows, jmask)), (jgp, jgf) = run_jax(jflags, lflags)
            res[name] = {"jlosses": {k: float(v) for k, v in jl.items()}, "jrows": jrows,
                         "jmask": np.asarray(jmask), "jgf": np.asarray(jgf),
                         "jgp": jax_to_state_dict({"params": jax.tree.map(np.asarray, jgp)})}
    finally:
        mp.undo()

    tb = batch_to_torch(batch, "cpu")
    for name, (epoch, lflags) in cases.items():
        net = bundle.net(cfg, "train")
        net.load_state_dict(jax_to_state_dict(variables), strict=True)
        volumes = []
        net.tiny_unet.register_forward_hook(
            lambda mod, args, out: volumes.append((args[0].detach().clone(), args[1].clone())))
        pf = torch.from_numpy(inj["point_features"]).requires_grad_()
        tin = {"point_features": pf,
               "semantic_scores": torch.from_numpy(inj["semantic_scores"]),
               "point_offsets": torch.from_numpy(inj["point_offsets"])}
        flags = bundle.forward_flags(cfg, epoch, True)
        assert flags == jbundle.forward_flags(jcfg, epoch, True)
        out = net.heads(tb, tin, train=True, jitter=_jitter(), **flags)
        losses = bundle.losses(cfg, net.caps, tb, out, True, **lflags)
        sum(losses.values()).backward()
        res[name].update(losses={k: float(v.detach()) for k, v in losses.items()},
                         rows=out["proposal_rows"], mask=out["mask_scores"].detach(),
                         grads={k: p.grad for k, p in net.named_parameters()
                                if p.grad is not None},
                         pf=pf.grad, volume=volumes[0], net=net, variables=variables)
    return res


# the IoU on the clusters with the mask filter off (HAIS's epochs 26-40),
# the mask IoU with the filter on (from epoch 41)
HAIS_CASES = {"cluster_iou": (10, {"iou_on_mask": False}),
              "mask_iou_filter_on": (41, {"iou_on_mask": True})}


@pytest.fixture(scope="module")
def hais_runs(batch):
    return heads_on_both("hais", batch, HAIS_CASES)


@pytest.fixture(scope="module")
def softgroup_runs(batch):
    return heads_on_both("softgroup", batch, {"packed": (30, {})})


@pytest.fixture(params=[("hais", c) for c in HAIS_CASES] + [("softgroup", "packed")],
                ids=lambda p: "-".join(p))
def run(request):
    model, case = request.param
    runs = request.getfixturevalue(f"{model}_runs")
    return model, runs[case]


def test_heads_rows_identical_and_masks_agree(run):
    model, r = run
    jr, tr = r["jrows"], r["rows"]
    assert int(tr["n_proposals"]) == int(jr.n_proposals) >= 4
    for f in ("point_idx", "prop_id", "valid"):
        np.testing.assert_array_equal(tr[f].numpy(), np.asarray(getattr(jr, f)), err_msg=f)
    valid = tr["valid"].numpy()
    jlogits, tlogits = r["jmask"][valid], r["mask"].numpy()[valid]
    _close(r["mask"], r["jmask"], "mask_scores")
    # the same logits: torch's and JAX's sigmoid make the same cuts (> 0.5,
    # the mask IoU's; >= 0.5, the mask filter's)
    cut_t = torch.sigmoid(torch.from_numpy(jlogits)).numpy()
    cut_j = np.asarray(jax.nn.sigmoid(jnp.asarray(jlogits)))
    np.testing.assert_array_equal(cut_t > 0.5, cut_j > 0.5)
    np.testing.assert_array_equal(cut_t >= 0.5, cut_j >= 0.5)
    # each side's own logits make the same cuts
    for cut in (np.greater, np.greater_equal):
        np.testing.assert_array_equal(cut(torch.sigmoid(torch.from_numpy(tlogits)).numpy(), 0.5),
                                      cut(cut_j, 0.5))
    nonzero = np.abs(jlogits[jlogits != 0])
    print(f"{model}: smallest nonzero |mask logit| of a valid row {nonzero.min():.3e}, "
          f"{int((jlogits == 0).sum())} exact zeros")
    assert 0 < (cut_j > 0.5).sum() < cut_j.size


def test_losses_match(run):
    model, r = run
    assert set(r["losses"]) == set(r["jlosses"])
    heads = {"hais": ("mask_loss", "score_loss"),
             "softgroup": ("classification_loss", "mask_scoring_loss", "iou_scoring_loss")}
    for k, v in r["losses"].items():
        np.testing.assert_allclose(v, r["jlosses"][k], rtol=RTOL, err_msg=k)
    assert all(r["jlosses"][k] > 0 for k in heads[model]), r["jlosses"]


BRANCHES = {"hais": ("mask_branch_0.", "mask_branch_1.", "score_branch."),
            "softgroup": ("mask_scoring_0.", "mask_scoring_1.", "classification_branch.",
                          "iou_score.")}


@pytest.mark.parametrize("part", ["branches", "tiny_unet", "point_features"])
def test_gradients_match(run, part):
    model, r = run
    if part == "point_features":
        _close(r["pf"], r["jgf"], part, XLA_CPU_CONV_TOL, GRAD_FLOOR)
        assert float(r["pf"].abs().max()) > 0
        return
    prefixes = BRANCHES[model] if part == "branches" else ("tiny_unet.",)
    tol = RTOL if part == "branches" else XLA_CPU_CONV_TOL
    names = [k for k in r["grads"] if k.startswith(prefixes)]
    assert len(names) >= len(prefixes)
    for k in names:
        _close(r["grads"][k], r["jgp"][k], k, tol, GRAD_FLOOR)
    # the backbone got no gradient: its outputs were injected
    assert not any(k.startswith("backbone.") for k in r["grads"])


@pytest.mark.parametrize("model", ["hais", "softgroup"])
def test_tiny_unet_train_grad_matches_jax_f64_convs(request, model):
    """The TinyUnet alone in training mode on the heads' proposal volumes,
    random cotangent: the port's f32 parameter gradients against the JAX
    TinyUnet with f64 convolutions (batch norms stay f32 there; measured on
    these 16 x 20^3-cell volumes, that reference is within 4e-7 of the port
    run in f64, and the port's f32 within 1.1e-6)."""
    case = "mask_iou_filter_on" if model == "hais" else "packed"
    r = request.getfixturevalue(f"{model}_runs")[case]
    x, occ = (t.numpy() for t in r["volume"])
    assert occ.sum() > 1000
    cot = np.random.default_rng(0).normal(size=x.shape).astype(np.float32)
    p = r["variables"]["params"]["tiny_unet"]
    stats = r["variables"]["batch_stats"]["tiny_unet"]
    net = DenseTinyUnet(8)
    net.load_state_dict(jax_to_state_dict({"params": p, "batch_stats": stats}), strict=True)
    (net(torch.from_numpy(x), torch.from_numpy(occ), True) * torch.from_numpy(cot)).sum().backward()
    jax.config.update("jax_enable_x64", True)
    try:
        f64 = jax.tree.map(lambda a: np.asarray(a, np.float64), {"params": p, "batch_stats": stats})
        jnet = JaxDenseTinyUnet(8, compute_dtype=jnp.float64)

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


def test_hais_mask_filter_and_mask_iou_change_the_losses(hais_runs):
    a, b = (hais_runs[k]["losses"] for k in HAIS_CASES)
    assert a["mask_loss"] != b["mask_loss"] and a["score_loss"] != b["score_loss"]


# -- configs, registry, entry point -------------------------------------------------------

@pytest.mark.parametrize("model", ["hais", "softgroup"])
def test_train_config_matches_recipe(model):
    j = load_config(recipe(model))
    c = get_model(model).train_config()
    jc, jn = j.data.caps, j.model.network
    for k in ("points", "voxels", "eval_points", "eval_voxels", "cluster_units", "instances",
              "eval_instances", "clusters", "proposals", "neighbors", "cell_window"):
        assert getattr(c.caps, k) == jc[k], k
    assert (c.batch_size, c.max_num_point, tuple(c.full_scale)) == (
        j.data.batch_size, j.data.max_num_point, tuple(j.data.full_scale))
    assert (c.lr, c.decay_start_epoch, c.max_epochs, c.global_train_seed) == (
        j.model.optimizer.lr, j.model.lr_decay.decay_start_epoch, j.model.trainer.max_epochs,
        j.global_train_seed)
    assert c.net.prepare_epochs == jn.prepare_epochs == 25
    assert (c.net.m, c.net.blocks, c.net.block_reps) == (jn.m, tuple(jn.blocks), jn.block_reps)
    assert c.point_num_avg == tuple(j.data.point_num_avg)
    assert c.synthetic.train_scenes == j.data.synthetic.train_scenes
    if model == "hais":
        for k in ("fg_thresh", "bg_thresh", "cal_iou_based_on_mask_start_epoch",
                  "use_mask_filter_score_feature_start_epoch", "using_set_aggr_in_training",
                  "mask_filter_score_feature_thre"):
            assert getattr(c.net, k) == jn[k], k
        assert (c.net.fg_thresh, c.net.bg_thresh) == (1.0, 0.0)
        assert c.radius_avg == tuple(j.data.radius_avg)
        assert jhais.loss_flags(j, 41) == hais.loss_flags(c, 41) == {"iou_on_mask": True}
        assert hais.loss_flags(c, 40) == {"iou_on_mask": False}
    else:
        for k in ("pos_iou_thr", "max_proposal_num"):
            assert getattr(c.net.train_cfg, k) == jn.train_cfg[k], k
        assert jsg.loss_flags(j, 41) == softgroup.loss_flags(c, 41) == {}
    want, got = JaxStaticCaps.from_cfg(j, "train"), StaticCaps.from_cfg(c, "train")
    for f in ("voxel_caps", "instances", "clusters", "proposals", "cluster_units"):
        assert getattr(got, f) == getattr(want, f), f


def test_registry_bundles_train_the_three_models():
    for name, losses in (("pointgroup", "pointgroup"), ("hais", "hais"),
                         ("softgroup", "softgroup")):
        b = get_model(name)
        assert b.losses.__module__ == f"minsu3d_tpu_torch.model.{losses}"
        assert b.train_config.MODEL == b.eval_config.MODEL
        assert callable(b.loss_flags)
        # the overrides name epoch gates of the recipe's net config
        cfg = b.train_config().with_overrides(b.open_gates)
        assert all(getattr(cfg.net, k.split(".")[1]) == 0 for k in b.open_gates)
    assert set(get_model("hais").open_gates) == {
        "net.cal_iou_based_on_mask_start_epoch", "net.use_mask_filter_score_feature_start_epoch"}
    assert get_model("pointgroup").open_gates == get_model("softgroup").open_gates == {}


@pytest.mark.parametrize("epoch", [0, 1])
def test_recipe_batch_drops_the_same_level1_voxels_as_jax(epoch):
    """The recipes' caps.voxels=90112 leave 45056 voxels to level 1 of the
    grid plan, and a batch of two augmented recipe scenes holds more there.
    The JAX package, collating the port's train items with its own plan (the
    native host plan its recipe runs build, or its device builder where that
    library is missing), drops the same voxels at every level as the port's
    ``TrainData`` batch: the drop is the recipe's, not the port's."""
    cfg = get_model("hais").train_config().with_overrides({"synthetic.train_scenes": 2})
    assert get_model("softgroup").train_config().caps == cfg.caps
    jcfg = load_config(recipe("hais"))
    data = TrainData(cfg)
    got = data.batch(epoch, [0, 1])
    items = [train_item(cfg, scene, scan_id,
                        np.random.default_rng([cfg.global_train_seed, epoch, i]))
             for i, (scan_id, scene) in enumerate(data.scenes)]
    spec = jbatching.plan_spec(jcfg, "train")
    want = jbatching.collate(items, jbatching.shard_caps(jcfg, "train"), spec)
    for k in ("voxel_batch", "voxel_coords", "voxel_mask"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    levels = len(jcfg.model.network.blocks)
    if spec is None or "plan0_dropped" not in want:
        plan, _, _ = jsparse.build_plan(
            jnp.asarray(want["voxel_batch"]), jnp.asarray(want["voxel_coords"]),
            jnp.asarray(want["voxel_mask"]), jgm.backbone_caps(jcfg, "train"), levels,
            jnp.asarray(want["voxel_feats"]))
        want = {f"plan{lvl}_dropped": lv.n_dropped for lvl, lv in enumerate(plan.levels)}
    dropped = [int(got[f"plan{lvl}_dropped"]) for lvl in range(levels)]
    assert dropped == [int(want[f"plan{lvl}_dropped"]) for lvl in range(levels)]
    assert dropped[1] > 0


TINY = {**SMALL, "caps.voxels": 32768, "synthetic.train_scenes": 4, "net.prepare_epochs": 0,
        **{f"synthetic.{k}": v for k, v in SCENE.items()}}


@pytest.mark.parametrize("model", ["hais", "softgroup"])
def test_train_entry_point_runs_on_cpu(tmp_path, capsys, model):
    """Steps 1-3 (heads off in epoch 0, on in epoch 1, HAIS's mask gates
    open) and a checkpoint; step 4 of a run resumed from it equals the
    first trainer's own step 4; another model refuses the checkpoint."""
    over = [f"{k}={v}".replace(" ", "") for k, v in {**TINY, **get_model(model).open_gates}.items()]
    args = ["--device", "cpu", "--model", model, "--out", str(tmp_path), *over]
    first = train_entry.main(["--steps", "3", *args])
    out = capsys.readouterr().out
    assert "step 1 epoch 0 heads=0" in out and "step 3 epoch 1 heads=1" in out
    head_loss = {"hais": "mask_loss", "softgroup": "mask_scoring_loss"}[model]
    assert f"{head_loss}=" in out and (tmp_path / "last.pt").exists()
    assert first.cfg.MODEL == get_model(model).train_config.MODEL
    want = first.step()["losses"]

    resumed = train_entry.main(["--steps", "1", "--resume", str(tmp_path / "last.pt"), *args])
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step 4 ")][0]
    assert line.startswith("step 4 epoch 1 heads=1") and resumed.global_step == 4
    printed = dict(w.split("=") for w in line.split() if w.split("=")[0] in want)
    assert printed == {k: f"{v:.5f}" for k, v in want.items()}

    other = "softgroup" if model == "hais" else "hais"
    with pytest.raises(ValueError, match="holds a"):
        train_entry.main(["--device", "cpu", "--model", other, "--steps", "1", "--out",
                          str(tmp_path / "other"), "--resume", str(tmp_path / "last.pt"),
                          *[f"{k}={v}".replace(" ", "") for k, v in TINY.items()]])
