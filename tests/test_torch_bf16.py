"""bf16 inference of the PyTorch port (``precision=bfloat16``) against the
JAX package with ``compute_dtype=jnp.bfloat16``, on the CPU, at a small
size (m=8, blocks [1, 2, 3], one rep; the caps of test_torch_hais.py), the
same seeded numpy inputs and the same f32 parameters.

* Per op (``subm_conv``, ``down_conv``, ``up_conv``, ``MaskedBatchNorm`` in
  both modes, ``Conv1x1``, one ``ResidualBlock``, the dense
  ``DenseTinyUnet`` at S=8): every element within one bf16 ulp of the
  larger of the two magnitudes, and fewer than 1% of the elements differ.
  Both sides round at the same points; they differ only where their f32
  sums, taken in other orders, round to neighbouring bf16 values (and
  where torch's CPU bf16 conv3d rounds another way than XLA's). One
  exception is allowed, cancellation: where a sum is far smaller than its
  terms, two f32 sums of them in other orders differ by up to F32_RTOL of
  the output's scale (the tolerance the f32 tests hold these sums to), and
  can round two bf16 ulps apart; an element beyond one ulp must lie within
  that f32 tolerance (Conv1x1 has one such element: 2 ulps at 5e-4, terms
  summing to 2.8 in magnitude).
* Rounding traps, bit for bit: SoftGroup's pooled mean on volumes with 257
  and 300 occupied cells (an f32 count: a bf16 count would read 256 and
  300 -> 300 but 257 -> 256); ``roipool`` and the segment min on bf16 rows
  with ties and empty segments; K7's placement of bf16 rows.
* The rounding map itself, read from the jaxpr of each JAX model's bf16
  forward: the proposal volume is bf16, the rows that ``roipool`` and the
  SoftGroup pool reduce are f32 (the TinyUnet hands back f32).
* Whole forward of PointGroup, HAIS and SoftGroup (seeded weights): the
  backbone's semantic scores and offsets within BACKBONE_RTOL of their scale
  (measured: 4.9e-3 to 7.3e-3; one-ulp differences of the bf16 activations
  travel through the U-Net), the point features within one bf16 ulp on
  all but BACKBONE_ULP_SHARE of the elements (measured 0.8-1.5%), and the
  share of points whose semantic argmax differs printed and under
  ARGMAX_SHARE (measured 0.26%). On injected backbone outputs (bf16 point
  features, the same on both sides): proposal rows, n_proposals and every
  diag counter bit for bit, the rows' cells, occupancy and bf16 volumes bit
  for bit, the scores within HEADS_RTOL of their scale (measured up to
  1.5e-2: one bf16 ulp is 2^-8 to 2^-7 of a value), the same instances in
  the same order, and AP equal where no row's mask test differs.
* Configs and errors: the default precision is float32, a bad value
  raises, a training config in bf16 raises, the entry points take the
  override, K1 raises on mixed dtypes, K6 on a bf16 sum, the sparse conv
  backward on bf16.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_hais as th
import test_torch_pointgroup as tp
import test_torch_softgroup as ts
from minsu3d_tpu.config import load_config
from minsu3d_tpu.evaluation.instance_segmentation import (
    GeneralDatasetEvaluator as JaxEvaluator)
from minsu3d_tpu.evaluation.instance_segmentation import get_gt_instances as jax_gt
from minsu3d_tpu.model import general_model as jgm
from minsu3d_tpu.model import get_model as jax_get_model
from minsu3d_tpu.model.module import blocks as jblocks
from minsu3d_tpu.model.module.dense_blocks import DenseTinyUnet as JaxDenseTinyUnet
from minsu3d_tpu.ops import instance_iou as jiou
from minsu3d_tpu.ops import segment as jsegment
from minsu3d_tpu.ops import sparse_conv as jconv
from minsu3d_tpu_torch import profile_main
from minsu3d_tpu_torch import test as test_entry
from minsu3d_tpu_torch.config import (EvalConfig, HaisEvalConfig, HaisTrainConfig,
                                      SoftGroupEvalConfig, SoftGroupTrainConfig, TrainConfig,
                                      backbone_caps)
from minsu3d_tpu_torch.convert import jax_to_state_dict
from minsu3d_tpu_torch.data.batching import collate, eval_caps
from minsu3d_tpu_torch.data.dataset import eval_item, normalize
from minsu3d_tpu_torch.data.synthetic import make_scene
from minsu3d_tpu_torch.evaluation.instance_segmentation import (
    GeneralDatasetEvaluator, get_gt_instances)
from minsu3d_tpu_torch.model import general_model as gm
from minsu3d_tpu_torch.model import softgroup
from minsu3d_tpu_torch.model.module import blocks
from minsu3d_tpu_torch.model.module.dense_blocks import DenseTinyUnet
from minsu3d_tpu_torch.model.registry import get_model
from minsu3d_tpu_torch.ops import segment, sparse_conv
from minsu3d_tpu_torch.ops.sparse import plan_dropped, plan_from_batch
from minsu3d_tpu_torch.test import SCORE_KEYS, batch_to_torch, injected_backbone_outputs
from test_torch_data import port_build_in_tmp  # noqa: F401

BF16 = torch.bfloat16
F32_RTOL = 1e-5
BACKBONE_RTOL = 1e-2
BACKBONE_ULP_SHARE = 0.02
ARGMAX_SHARE = 0.01
HEADS_RTOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two torch threads: the suite runs several workers on one machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_ulp(mag: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each magnitude (8 significant bits); 0 at 0."""
    _, e = np.frexp(mag)
    return np.where(mag > 0, np.ldexp(1.0, e - 8), 0.0)


def _ulp_report(got, want, name: str) -> tuple:
    """(share of elements that differ, share beyond one bf16 ulp of the
    larger magnitude, largest gap beyond one ulp over the output's scale);
    printed."""
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape, name
    assert np.isfinite(g).all(), name
    diff = np.abs(g - w)
    ulp = _bf16_ulp(np.maximum(np.abs(g), np.abs(w)))
    differ = float((diff > 0).mean())
    beyond = diff > ulp
    scale = max(float(np.abs(w).max()), 1.0)
    over = float(diff[beyond].max()) / scale if beyond.any() else 0.0
    worst = float(np.max(np.where(diff > 0, diff / np.maximum(ulp, 1e-45), 0.0)))
    print(f"{name}: {differ:.4%} of {g.size} elements differ, {beyond.mean():.4%} by more "
          f"than one bf16 ulp (worst {worst:.2f} ulp, {over:.2e} of the scale)")
    return differ, float(beyond.mean()), over


def _within_one_ulp(got, want, name: str) -> None:
    """One bf16 ulp, or the f32 tolerance under cancellation (see the module
    docstring); under 1% of the elements differ."""
    differ, _, over = _ulp_report(got, want, name)
    assert over <= F32_RTOL, name
    assert differ < 0.01, name


def _bits_equal(got: torch.Tensor, want) -> None:
    """Equal bit for bit: bf16 compared as int16, f32 as int32 (so -0.0 !=
    +0.0)."""
    want = np.array(want)
    as_int = {jnp.bfloat16: (torch.int16, np.int16), np.float32: (torch.int32, np.int32)}
    t_int, n_int = as_int[want.dtype.type]
    assert got.shape == want.shape and got.element_size() == want.itemsize
    assert torch.equal(got.view(t_int), torch.from_numpy(want.view(n_int)))


def _close(got, want, name: str, rtol: float) -> float:
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape, name
    err = float(np.abs(g - w).max()) if g.size else 0.0
    scale = max(float(np.abs(w).max()) if w.size else 0.0, 1.0)
    print(f"{name}: max abs err {err:.3e}, scale {scale:.3e}, err/scale {err / scale:.3e}")
    assert err <= rtol * scale, name
    return err / scale


def _bf16_numpy(rng, *shape, scale=1.0) -> np.ndarray:
    """f32 values that bf16 holds exactly (the same inputs for both sides)."""
    x = (rng.uniform(-1, 1, shape) * scale).astype(np.float32)
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _to_bf16(x: np.ndarray) -> tuple:
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(BF16)


# -- per op --------------------------------------------------------------------------------

SCENE = dict(seed=23, num_objects=5, points_per_object=500, floor_points=600)
OP_CFG = EvalConfig().with_overrides({"net.m": 8, "net.blocks": [1, 2, 3],
                                      "net.block_reps": 1, "caps.eval_points": 8192,
                                      "caps.eval_voxels": 8192})


@pytest.fixture(scope="module")
def plans():
    scene = normalize(make_scene(**SCENE))
    batch = collate([eval_item(OP_CFG, scene, "s")], eval_caps(OP_CFG),
                    (backbone_caps(OP_CFG), len(OP_CFG.net.blocks)))
    arrays = {k: v for k, v in batch.items() if k != "scan_ids"}
    jplan, _, _ = jgm.build_scene_plan({k: jnp.asarray(v) for k, v in arrays.items()},
                                       backbone_caps(OP_CFG), len(OP_CFG.net.blocks))
    tplan, _, _ = plan_from_batch({k: torch.as_tensor(v) for k, v in arrays.items()},
                                  len(OP_CFG.net.blocks))
    return jplan, tplan


@pytest.mark.parametrize("level,cin,cout", [(0, 6, 8), (0, 16, 8), (1, 16, 16)])
def test_subm_conv_bf16_matches_jax(plans, level, cin, cout):
    jplan, tplan = plans
    rng = np.random.default_rng(level * 100 + cin)
    x = _bf16_numpy(rng, tplan.levels[level].cap, cin)
    w = (rng.uniform(-1, 1, (27, cin, cout)) * (6 / (27 * cin)) ** 0.5).astype(np.float32)
    jx, tx = _to_bf16(x)
    want = jconv.subm_conv(jx, jplan.levels[level], jnp.asarray(w), jnp.bfloat16)
    got = sparse_conv.subm_conv(tx, tplan.levels[level], torch.from_numpy(w))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _within_one_ulp(got, want, f"subm_conv L{level} {cin}->{cout}")


@pytest.mark.parametrize("kind", ["down", "up"])
def test_k2s2_convs_bf16_match_jax(plans, kind):
    jplan, tplan = plans
    rng = np.random.default_rng(7 if kind == "down" else 11)
    child, parent = tplan.levels[0], tplan.levels[1]
    lk = sparse_conv.links(child, parent.cap)
    if kind == "down":
        x, w = _bf16_numpy(rng, child.cap, 8), rng.uniform(-0.3, 0.3, (8, 8, 16))
        jx, tx = _to_bf16(x)
        want = jconv.down_conv(jx, jplan.levels[0], parent.cap, jnp.asarray(w, jnp.float32),
                               jnp.bfloat16)
        got = sparse_conv.down_conv(tx, lk, torch.from_numpy(w.astype(np.float32)))
    else:
        x, w = _bf16_numpy(rng, parent.cap, 16), rng.uniform(-0.3, 0.3, (8, 16, 8))
        jx, tx = _to_bf16(x)
        want = jconv.up_conv(jx, jplan.levels[0], jnp.asarray(w, jnp.float32), jnp.bfloat16)
        got = sparse_conv.up_conv(tx, lk, torch.from_numpy(w.astype(np.float32)))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _within_one_ulp(got, want, f"{kind}_conv")


def _jax_module(module, seed: int, *args, train: bool = False):
    """(output, variables after the call) of a flax module initialised from
    ``seed``, with random batch statistics so that eval mode normalises."""
    variables = module.init(jax.random.PRNGKey(seed), *args, train)
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(lambda a: np.asarray(rng.uniform(0.5, 1.5, a.shape), np.float32),
                         variables.get("batch_stats", {}))
    params = jax.tree.map(lambda a: np.asarray(a) + np.asarray(
        rng.normal(0, 0.1, a.shape), np.float32), variables["params"])
    variables = {"params": params, "batch_stats": stats}
    out, new = module.apply(variables, *args, train, mutable=["batch_stats"])
    return out, variables, new


@pytest.mark.parametrize("train", [False, True])
def test_masked_batch_norm_bf16_matches_jax(plans, train):
    _, tplan = plans
    valid = tplan.levels[0].valid.numpy()
    x = _bf16_numpy(np.random.default_rng(3), valid.shape[0], 16, scale=4.0)
    jx, tx = _to_bf16(x)
    want, variables, new = _jax_module(jblocks.MaskedBatchNorm(16), 5, jx, jnp.asarray(valid),
                                       train=train)
    bn = blocks.MaskedBatchNorm(16)
    bn.load_state_dict(jax_to_state_dict(jax.tree.map(np.asarray, variables)))
    got = bn(tx, torch.from_numpy(valid), train)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _within_one_ulp(got, want, f"MaskedBatchNorm train={train}")
    if train:  # the running statistics move in f32, from the f32 statistics
        for k in ("mean", "var"):
            _close(getattr(bn, k), new["batch_stats"][k], f"running {k}", 1e-6)


def test_conv1x1_bf16_matches_jax():
    x = _bf16_numpy(np.random.default_rng(4), 3000, 16)
    jx, tx = _to_bf16(x)
    module = jblocks.Conv1x1(16, 8)
    variables = module.init(jax.random.PRNGKey(6), jx)
    want = module.apply(variables, jx)
    conv = blocks.Conv1x1(16, 8)
    conv.load_state_dict(jax_to_state_dict(jax.tree.map(np.asarray, variables)))
    got = conv(tx)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _within_one_ulp(got, want, "Conv1x1")


@pytest.mark.parametrize("train", [False, True])
def test_residual_block_bf16_matches_jax(plans, train):
    """A tail block (2c -> c: the 1x1 downsample, two BN-ReLU-conv, the bf16
    residual add) at level 0."""
    jplan, tplan = plans
    x = _bf16_numpy(np.random.default_rng(8), tplan.levels[0].cap, 16)
    jx, tx = _to_bf16(x)
    want, variables, _ = _jax_module(jblocks.ResidualBlock(16, 8, jnp.bfloat16), 9, jx,
                                     jplan.levels[0], train=train)
    block = blocks.ResidualBlock(16, 8)
    block.load_state_dict(jax_to_state_dict(jax.tree.map(np.asarray, variables)))
    got = block(tx, tplan.levels[0], train)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _within_one_ulp(got, want, f"ResidualBlock train={train}")


def test_dense_tiny_unet_bf16_matches_jax():
    """The TinyUnet on 6 bf16 volumes of 8^3 cells: the first blocks keep
    bf16, the rest is f32 with bf16 conv inputs, the output f32."""
    rng = np.random.default_rng(12)
    occ = rng.random((6, 8, 8, 8)) < 0.35
    x = _bf16_numpy(rng, 6, 8, 8, 8, 8) * occ[..., None]
    jx, tx = _to_bf16(x)
    want, variables, _ = _jax_module(JaxDenseTinyUnet(8, jnp.bfloat16), 13, jx,
                                     jnp.asarray(occ), train=False)
    net = DenseTinyUnet(8, BF16)
    net.load_state_dict(jax_to_state_dict(jax.tree.map(np.asarray, variables)))
    got = net(tx, torch.from_numpy(occ), False)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _within_one_ulp(got, want, "DenseTinyUnet S=8")


# -- rounding traps ------------------------------------------------------------------------

@pytest.mark.parametrize("n_occ", [257, 300])
def test_softgroup_pooled_mean_counts_exactly(n_occ):
    """Features that sum exactly in any order (multiples of 1/8), so the
    mean is one f32 division: by the f32 count, as the JAX forward's jaxpr
    reduces it (``test_jax_rounding_map``). A bf16 count reads 256 for 257."""
    rng = np.random.default_rng(n_occ)
    occ = np.zeros((3, 10, 10, 10), bool)
    occ[0].reshape(-1)[rng.choice(1000, n_occ, replace=False)] = True
    occ[1].reshape(-1)[:5] = True                       # a small proposal; 2 is empty
    feats = (rng.integers(0, 64, (3, 10, 10, 10, 8)) / 8.0).astype(np.float32)
    occ_f = jnp.asarray(occ)[..., None].astype(jnp.float32)
    want = (jnp.sum(jnp.asarray(feats) * occ_f, axis=(1, 2, 3))
            / jnp.maximum(jnp.sum(occ_f, axis=(1, 2, 3)), 1.0))
    got = softgroup.pooled_mean(torch.from_numpy(feats), torch.from_numpy(occ))
    _bits_equal(got, want)
    by_bf16_count = (jnp.sum(jnp.asarray(feats) * occ_f, axis=(1, 2, 3))
                     / jnp.sum(occ_f, axis=(1, 2, 3)).astype(jnp.bfloat16).astype(jnp.float32))
    assert (np.asarray(by_bf16_count[0]) != np.asarray(want[0])).any() == (n_occ == 257)


def _bf16_rows_with_ties(seed: int, rows: int, n_seg: int, c: int) -> tuple:
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, n_seg, rows).astype(np.int32)
    seg[seg == 3] = 4                                  # segment 3 is empty
    valid = rng.random(rows) < 0.85
    x = (rng.integers(-6, 6, (rows, c)) / 4.0).astype(np.float32)   # many ties
    x[seg == 5] = -2.5                                 # an all-tied negative segment
    return x, seg, valid


def test_roipool_on_bf16_rows_matches_jax():
    x, seg, valid = _bf16_rows_with_ties(1, 5000, 40, 8)
    jx, tx = _to_bf16(x)
    want = jsegment.roipool(jx, jnp.asarray(seg), jnp.asarray(valid), 40)
    got = segment.roipool(tx, torch.from_numpy(seg), torch.from_numpy(valid), 40)
    assert want.dtype == jnp.bfloat16
    _bits_equal(got, want)
    assert (got[3] == 0).all() and (got[5] == -2.5).all()


@pytest.mark.parametrize("op", ["min", "max"])
def test_segment_min_max_on_bf16_rows_match_jax(op):
    """JAX's sec_min / sec_max widen bf16 rows to f32 (their sentinel is an
    f32 1e30); the port keeps bf16, and the values are the same."""
    x, seg, valid = _bf16_rows_with_ties(2, 5000, 40, 8)
    jx, tx = _to_bf16(x)
    jfn, tfn = (jsegment.sec_min, segment.sec_min) if op == "min" else (jsegment.sec_max,
                                                                        segment.sec_max)
    want = jfn(jx, jnp.asarray(seg), jnp.asarray(valid), 40)
    got = tfn(tx, torch.from_numpy(seg), torch.from_numpy(valid), 40)
    assert got.dtype == BF16
    np.testing.assert_array_equal(_f32(got), _f32(want))


def test_proposal_voxelization_places_bf16_rows_as_jax():
    """The dense proposal volumes of bf16 point features: volume (bf16),
    occupancy and row cells bit for bit (K7's plain placement)."""
    rng = np.random.default_rng(21)
    n, p_cap, s = 3000, 12, 14
    coords = rng.normal(0, 0.4, (n, 3)).astype(np.float32)
    feats = _bf16_numpy(rng, n, 8)
    rows = {
        "point_idx": np.tile(np.arange(n, dtype=np.int32), 2),
        "prop_id": rng.integers(0, p_cap + 3, 2 * n).astype(np.int32)}
    rows["valid"] = rows["prop_id"] < p_cap
    rows["prop_id"] = np.where(rows["valid"], rows["prop_id"], p_cap).astype(np.int32)
    rows["n_proposals"] = np.int32(p_cap)
    jf, tf = _to_bf16(feats)
    jrows = jiou.ProposalRows(*(jnp.asarray(rows[k]) for k in ("point_idx", "prop_id", "valid",
                                                                  "n_proposals")))
    jvol, jocc, jcell = jgm.clusters_voxelization_dense(
        jrows, p_cap, jf, jnp.asarray(coords), 50.0, s, jax.random.PRNGKey(0))
    tvol, tocc, tcell = gm.clusters_voxelization_dense(
        {k: torch.from_numpy(np.asarray(v)) for k, v in rows.items()}, p_cap, tf,
        torch.from_numpy(coords), 50.0, s)
    assert jvol.dtype == jnp.bfloat16
    _bits_equal(tvol, jvol)
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(tcell.numpy(), np.asarray(jcell))
    assert int(tocc.sum()) > 1000


# -- whole forward, per model ----------------------------------------------------------------

MODELS = {"pointgroup": ("PointGroup", EvalConfig, tp), "hais": ("HAIS", HaisEvalConfig, th),
          "softgroup": ("SoftGroup", SoftGroupEvalConfig, ts)}
EPOCH = 100   # the frozen checkpoints' epoch: HAIS's mask filter on


def _seeded_variables(shapes, seed: int) -> dict:
    """f32 variables of the JAX net's shapes: conv and Dense kernels
    uniform in +-sqrt(6 / fan_in), small biases, batch-norm scales near 1,
    running means near 0 and variances near 1 (eval mode reads them)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "kernel" or name in ("conv_kernel", "deconv_kernel", "downsample"):
            fan = int(np.prod(a.shape[:-1]))
            return rng.uniform(-1, 1, a.shape).astype(np.float32) * np.float32((6 / fan) ** 0.5)
        if name == "scale":
            return rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return rng.normal(0, 0.05, a.shape).astype(np.float32)   # bias, mean

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module", params=sorted(MODELS))
def model_run(request):
    """One model in bf16 on both sides: the backbone outputs, the heads on
    injected outputs, and the jaxpr of the JAX heads."""
    name, eval_cls, mod = MODELS[request.param]
    cfg = eval_cls().with_overrides({**mod.SMALL, "precision": "bfloat16"})
    jcfg = load_config([a.replace("precision=float32", "precision=bfloat16")
                        for a in mod.JAX_SMALL])
    scene = normalize(make_scene(**SCENE))
    batch = collate([eval_item(cfg, scene, "scene0")], eval_caps(cfg),
                    (backbone_caps(cfg), len(cfg.net.blocks)))
    arrays = {k: v for k, v in batch.items() if k != "scan_ids"}
    jnet = jax_get_model(name).make_net(jcfg, "val")
    assert jnet.compute_dtype == jnp.bfloat16
    shapes = jax.eval_shape(lambda b: jnet.init({"params": jax.random.PRNGKey(0),
                                                 "cluster": jax.random.PRNGKey(0)}, b, False,
                                                True), arrays)
    variables = _seeded_variables({"params": shapes["params"],
                                   "batch_stats": shapes["batch_stats"]}, 31)
    model = get_model(name).net(cfg)
    model.load_state_dict(jax_to_state_dict(variables), strict=True)
    model.eval()
    tb = batch_to_torch(batch, "cpu")
    jbackbone = jax.jit(lambda v, b: jnet.apply(v, b, False, False))(variables, arrays)
    with torch.no_grad():
        tbackbone, plan = model.backbone_forward(tb)

    inj = injected_backbone_outputs(batch, cfg.classes, cfg.net.m, 5, "cpu", BF16)
    jinj = {k: jnp.asarray(_f32(v)) for k, v in inj.items()}
    jinj["point_features"] = jinj["point_features"].astype(jnp.bfloat16)
    jflags = jax_get_model(name).forward_flags(jcfg, EPOCH, False) if name == "HAIS" else {}
    tflags = get_model(name).forward_flags(cfg, EPOCH, False)

    def intercept(next_fun, args, kwargs, context):
        if isinstance(context.module, jblocks.Backbone) and context.method_name == "__call__":
            return dict(jinj)
        return next_fun(*args, **kwargs)

    def heads(v, b):
        with nn.intercept_methods(intercept):
            return jnet.apply(v, b, False, True, **jflags)

    jheads = jax.jit(heads)(variables, arrays)
    jaxpr = str(jax.make_jaxpr(heads)(variables, arrays))
    with torch.no_grad():
        theads = model.heads(tb, dict(inj), **tflags)
        vox = gm.clusters_voxelization_dense(theads["proposal_rows"], model.caps.proposals,
                                             inj["point_features"], tb["point_xyz"],
                                             *_voxel_params(cfg))
    tbackbone["voxels_dropped"] = plan_dropped(plan)
    return dict(name=name, cfg=cfg, jcfg=jcfg, batch=batch, jbackbone=jbackbone,
                tbackbone=tbackbone, jheads=jheads, theads=theads, jaxpr=jaxpr, jinj=jinj,
                vox=vox, arrays=arrays)


def _voxel_params(cfg) -> tuple:
    if cfg.MODEL == "SoftGroup":
        return cfg.net.instance_voxel_cfg.scale, cfg.net.instance_voxel_cfg.spatial_shape
    return cfg.net.score_scale, cfg.net.score_fullscale


def test_backbone_bf16_matches_jax(model_run):
    r = model_run
    tb, jb = r["tbackbone"], r["jbackbone"]
    assert tb["point_features"].dtype == BF16 and jb["point_features"].dtype == jnp.bfloat16
    for key in ("semantic_scores", "point_offsets"):
        assert tb[key].dtype == torch.float32 and jb[key].dtype == jnp.float32
        _close(tb[key], jb[key], f"{r['name']} {key}", BACKBONE_RTOL)
    _, beyond, _ = _ulp_report(tb["point_features"], jb["point_features"],
                               f"{r['name']} point_features")
    assert beyond < BACKBONE_ULP_SHARE
    n = int(r["batch"]["num_points"])
    t_arg = tb["semantic_scores"][:n].argmax(1).numpy()
    j_arg = np.asarray(jb["semantic_scores"])[:n].argmax(1)
    share = float((t_arg != j_arg).mean())
    print(f"{r['name']}: semantic argmax differs on {share:.4%} of {n} points")
    assert share < ARGMAX_SHARE


def test_heads_bf16_rows_cells_and_occupancy_identical(model_run):
    r = model_run
    jr, tr = r["jheads"]["proposal_rows"], r["theads"]["proposal_rows"]
    assert int(tr["n_proposals"]) == int(jr.n_proposals) >= 3
    for f in ("point_idx", "prop_id", "valid"):
        np.testing.assert_array_equal(tr[f].numpy(), np.asarray(getattr(jr, f)), err_msg=f)
    for k, v in r["jheads"]["diag"].items():
        got = r["tbackbone"] if k == "voxels_dropped" else r["theads"]["diag"]
        assert int(got[k]) == int(v), k
    jvol, jocc, jcell = jgm.clusters_voxelization_dense(
        jr, r["cfg"].caps.proposals, r["jinj"]["point_features"],
        jnp.asarray(r["arrays"]["point_xyz"]), *_voxel_params(r["cfg"]), jax.random.PRNGKey(0))
    tvol, tocc, tcell = r["vox"]
    _bits_equal(tvol, jvol)
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(tcell.numpy(), np.asarray(jcell))


def test_heads_bf16_scores_match_jax(model_run):
    r = model_run
    keys = [k for k in SCORE_KEYS if k in r["jheads"]]
    assert keys
    for k in keys:
        assert r["theads"][k].dtype == torch.float32
        _close(r["theads"][k], r["jheads"][k], f"{r['name']} {k}", HEADS_RTOL)


def _jax_pred(name):
    from minsu3d_tpu.model import hais as jhais, pointgroup as jpg, softgroup as jsg
    return {"PointGroup": jpg, "HAIS": jhais, "SoftGroup": jsg}[name].pred_instances


def _mask_threshold(cfg) -> tuple:
    """(score key, threshold) of the rows' mask test in ``pred_instances``,
    or None for PointGroup (its masks are the rows)."""
    if cfg.MODEL == "HAIS":
        return "mask_scores", cfg.net.test.test_mask_score_thre
    if cfg.MODEL == "SoftGroup":
        return "mask_scores", cfg.net.test_cfg.mask_score_thr
    return None


def test_heads_bf16_ap_equal_where_the_order_is(model_run):
    """The same instances, labels and confidence order on both sides; the
    rows' mask tests (HAIS, SoftGroup) differ only where JAX's mask score
    lies within HEADS_RTOL of the threshold; AP, AP50 and AP25 equal where
    no row's mask test differs."""
    r = model_run
    cfg, jcfg, batch, name = r["cfg"], r["jcfg"], r["batch"], r["name"]
    n = int(batch["num_points"])
    ignore = list(cfg.ignore_classes)
    xyz, sem_gt, inst_gt = (batch["point_xyz"][:n], batch["sem_labels"][:n],
                            batch["instance_ids"][:n])
    tout = {"semantic_scores": r["theads"]["semantic_scores"][:n].numpy(),
            "proposal_rows": {k: v.numpy() for k, v in r["theads"]["proposal_rows"].items()}}
    jout = {"semantic_scores": np.asarray(r["jheads"]["semantic_scores"])[:n],
            "proposal_rows": {f: np.asarray(getattr(r["jheads"]["proposal_rows"], f))
                              for f in r["jheads"]["proposal_rows"]._fields}}
    for k in SCORE_KEYS:
        if k in r["jheads"]:
            tout[k] = r["theads"][k].numpy()
            jout[k] = np.asarray(r["jheads"][k])
    tpred = get_model(name).pred_instances(cfg, "scene0", xyz, tout, len(ignore))
    jpred = _jax_pred(name)(jcfg, "scene0", xyz, jout, len(ignore))
    assert len(tpred) == len(jpred) > 0
    assert [p["label_id"] for p in tpred] == [p["label_id"] for p in jpred]
    assert np.array_equal(np.argsort([-p["conf"] for p in tpred], kind="stable"),
                          np.argsort([-p["conf"] for p in jpred], kind="stable"))
    flips = 0
    test = _mask_threshold(cfg)
    if test is not None:
        key, thr = test
        valid = jout["proposal_rows"]["valid"]
        t_keep, j_keep = tout[key] > thr, jout[key] > thr
        flip = (t_keep != j_keep) & (valid if t_keep.ndim == 1 else valid[:, None])
        flips = int(flip.sum())
        scale = max(float(np.abs(jout[key]).max()), 1.0)
        assert (np.abs(jout[key][flip] - thr) <= HEADS_RTOL * scale).all()
    same_masks = all(a["pred_mask"] == b["pred_mask"] for a, b in zip(tpred, jpred))
    t_ap = GeneralDatasetEvaluator(cfg.class_names, -1, ignore).evaluate(
        [tpred], [get_gt_instances(sem_gt, inst_gt, ignore)])
    j_ap = JaxEvaluator(jcfg.data.class_names, -1, ignore).evaluate(
        [jpred], [jax_gt(sem_gt, inst_gt, ignore)])
    keys = ("all_ap", "all_ap_50%", "all_ap_25%")
    print(f"{name}: {len(tpred)} instances in the same order; {flips} row mask tests "
          f"differ near the threshold; masks equal: {same_masks}; AP port "
          f"{[t_ap[k] for k in keys]} JAX {[j_ap[k] for k in keys]}")
    if flips == 0:
        assert same_masks
        for k in keys:
            assert t_ap[k] == j_ap[k] or (np.isnan(t_ap[k]) and np.isnan(j_ap[k])), k


def test_jax_rounding_map(model_run):
    """What the port follows, read from the JAX bf16 heads' jaxpr: the
    proposal volume is scattered in bf16; every segment max over the rows
    (``roipool``) and SoftGroup's pooled sums reduce f32 values."""
    r = model_run
    lines = r["jaxpr"].splitlines()
    assert any("= scatter[" in ln and "bf16[" in ln.split("=")[0] for ln in lines), \
        "no bf16 volume scatter"
    seg_max = [ln.split("=")[0] for ln in lines if "= scatter-max[" in ln]
    assert seg_max and not any("bf16" in s for s in seg_max), seg_max
    if r["name"] == "SoftGroup":
        sums = [ln.split("=")[0] for ln in lines if "reduce_sum[axes=(1, 2, 3)" in ln]
        assert len(sums) == 2 and all("f32[" in s for s in sums), sums


# -- configs and errors --------------------------------------------------------------------

@pytest.mark.parametrize("cls", [EvalConfig, HaisEvalConfig, SoftGroupEvalConfig, TrainConfig,
                                 HaisTrainConfig, SoftGroupTrainConfig])
def test_precision_defaults_to_float32(cls):
    cfg = cls()
    assert cfg.precision == "float32" and gm.compute_dtype(cfg) is None
    with pytest.raises(ValueError, match="precision"):
        cfg.with_overrides({"precision": "float16"})


@pytest.mark.parametrize("cls", [EvalConfig, HaisEvalConfig, SoftGroupEvalConfig])
def test_eval_configs_take_bf16(cls):
    cfg = cls().with_overrides({"precision": "bfloat16"})
    assert gm.compute_dtype(cfg) == BF16
    model = get_model(cfg.MODEL).net(cfg)
    assert model.backbone.compute_dtype == BF16


@pytest.mark.parametrize("cls", [TrainConfig, HaisTrainConfig, SoftGroupTrainConfig])
def test_training_configs_reject_bf16(cls):
    with pytest.raises(NotImplementedError, match="next slice"):
        cls().with_overrides({"precision": "bfloat16"})


def test_test_entry_point_runs_bf16_on_the_cpu(capsys):
    over = [f"{k}={v}" for k, v in {**th.SMALL, "synthetic.num_objects": 5,
                                     "synthetic.points_per_object": 500,
                                     "synthetic.floor_points": 600}.items()]
    over = [o.replace(" ", "") for o in over]
    test_entry.main(["--device", "cpu", "--scenes", "1", "--model", "hais",
                     "precision=bfloat16", *over])
    out = capsys.readouterr().out
    assert "HAIS in bfloat16 on cpu" in out and "per-scene forward ms" in out


def test_profile_main_takes_the_precision_override():
    """The override is read before the card is asked for: bf16 inference is
    accepted (then the missing card stops it), a bad value or bf16 training
    is refused."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusals that come before the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_main.main(["--model", "softgroup", "precision=bfloat16"])
    with pytest.raises(ValueError, match="precision"):
        profile_main.main(["--model", "hais", "precision=float16"])
    with pytest.raises(NotImplementedError, match="next slice"):
        profile_main.main(["--train", "--model", "hais", "precision=bfloat16"])


@pytest.mark.parametrize("xd,wd", [(torch.bfloat16, torch.float32),
                                   (torch.float32, torch.bfloat16)])
def test_gather_gemm_rejects_mixed_dtypes(xd, wd):
    x = torch.zeros(4, 3, dtype=xd)
    idx = torch.zeros(2, 2, dtype=torch.int32)
    w = torch.zeros(2, 3, 5, dtype=wd)
    with pytest.raises(TypeError, match="both"):
        sparse_conv.gather_gemm(x, idx, w)


def test_segment_reduce_rejects_a_bf16_sum():
    csr = segment.segment_csr(torch.tensor([0, 1, 1]), 2)
    x = torch.ones(3, 2, dtype=BF16)
    with pytest.raises(NotImplementedError, match="bf16 sum"):
        segment.segment_reduce(x, csr, "sum")
    assert torch.equal(segment.segment_reduce(x, csr, "max"), torch.ones(2, 2, dtype=BF16))


def test_sparse_conv_backward_refuses_bf16(plans):
    _, tplan = plans
    x = torch.zeros(tplan.levels[0].cap, 8, dtype=BF16, requires_grad=True)
    w = torch.zeros(27, 8, 8, requires_grad=True)
    out = sparse_conv.subm_conv(x, tplan.levels[0], w)
    with pytest.raises(NotImplementedError, match="bf16 training"):
        out.float().sum().backward()
