"""bf16 training of the PyTorch port (``precision=bfloat16``, the precision
every ``scripts/train_synth_*.sh`` runs as written) against the JAX
package's bf16 train step, on the CPU, at a small size (m=8, blocks
[1, 2, 3], one rep), the same seeded numpy inputs and the same f32
parameters on both sides.

* (a) The rounding map, read from the jaxpr of the JAX package's bf16 train
  step (PointGroup, heads on): the input gradient of every submanifold and
  up conv and of every bf16 row gather (the devoxelization, the point
  features into the proposal rows) is a bf16 scatter-add, which rounds
  after every add; each contribution is an f32 dot rounded to bf16 before
  it; every sparse conv's weight gradient is an f32 dot rounded once to
  bf16 and widened back; the TinyUnet's convs transpose to bf16 convs; the
  f32 -> bf16 casts of the batch norms, ``Conv1x1`` and the heads' ``Dense``
  layers round their f32 cotangents once.
* (b) K6's bf16 sum (its plain version, which the CPU runs) against JAX's
  ``.at[idx].add`` on bf16 rows, bit for bit: the order trap ([1, 2^-9 x 8]
  reads 1.0, the same values small-first 1.015625), a segment of 300 rows,
  a lone -0 contribution (+0 out), random segments; and ``gather_rows``'
  backward against ``jax.vjp`` of the JAX row gather.
* (c) ``subm_conv``, ``down_conv`` and ``up_conv``: dx and dW against
  ``jax.grad`` of the JAX functions in bf16. dx equals the JAX result bit
  for bit wherever every contribution's f32 dot rounds to the same bf16
  value (XLA may add the Cout products in another order); where one does
  not, the element stays within one bf16 ulp (DX_ULP_SHARE bounds the share;
  measured: bit for bit at every shape here; one element in 65536 of an
  up conv's dx at another seed). dW within one bf16 ulp (measured: bit for
  bit but 0.2% of the down conv's); a sum that cancels may round two ulps
  apart, and then within 1e-5 of the scale, as in test_torch_bf16.py.
* (d) One ``ResidualBlock`` (the tail block 2c -> c with the 1x1
  downsample) in training mode: its input gradient within one bf16 ulp on
  all but BLOCK_ULP_SHARE of the elements (measured: 0.007% differ, none
  by more than one ulp), every parameter gradient within BLOCK_RTOL of its
  scale (measured 2e-7). The TinyUnet's bf16 backward, at S=8: each of its
  dense convs (3^3 at c -> c, 2c -> c and 2c -> 2c, the k2s2 down conv and
  transposed conv), dx and dW within one bf16 ulp on all but DX_ULP_SHARE
  of the elements (measured: bit for bit but one dW element in 3456); each
  of its residual blocks in training mode under the (d) block rules
  (measured: at most 0.002% of dx one ulp apart, parameters within 4e-7 of
  their scale); the whole TinyUnet in training mode, dx and every
  parameter gradient within UNET_RTOL in relative L2 (measured 7.4e-3: one
  bf16 ulp of a forward activation, where two f32 sums round apart, moves
  the batch statistics of every later norm). The backbone's gradients: in
  (e), the heads-off step.
* (e) Train steps: PointGroup with the heads off, then PointGroup, HAIS and
  SoftGroup with the heads on (their heads read ground-truth classes and
  offsets beside the backbone's own point features, as
  ``Trainer.forward_gt``, the voxelization jitter fixed on both sides).
  Losses within LOSS_RTOL relative (of at least 0.1; measured: 1e-3);
  the batch statistics within STATS_RTOL of their scale (measured 7e-4).
  Gradients: a bf16 step's gradient is only defined up to bf16 noise. The
  forwards already differ (one-ulp differences of the bf16 activations
  where two f32 sums in other orders round apart, under 2% of the
  elements, test_torch_bf16.py; more in a training-mode TinyUnet, whose
  batch statistics sum in other orders), and the TinyUnet's 18 convs and
  the U-Net's levels carry that through the backward: at this size the
  JAX package's bf16 gradients stray from the f32 ones by up to 0.74 in
  relative L2 (printed per step). So each gradient tensor's relative L2
  gap to the JAX bf16 step must stay within NOISE_FACTOR times that
  tensor's noise, the JAX bf16 step's relative L2 gap to the port's f32
  step from the same variables (equal to the JAX f32 step within 2e-6,
  test_torch_train.py), plus GRAD_RTOL (measured: at most 3.14 times the
  noise, in the TinyUnet), and never beyond GAP_CAP (measured: at most
  0.72, PointGroup heads on); its norm within NORM_RATIO of JAX's
  (measured: 0.80 to 1.25). A zeroed gradient reads a gap of 1 and a norm
  of 0, a flipped one a gap of 2, a halved one a norm of 0.5: all fail
  whatever the noise. A tensor that is 0 in exact arithmetic stays below
  ZERO_GRAD. Where the noise passes NOISY (PointGroup heads on: 47 of 94
  tensors; the others: 2 to 5), this check alone cannot tell a small error
  from noise, so such a tensor must lie in the backbone or the TinyUnet,
  whose operations (b)-(d) hold one by one: the sparse convs' dx and dW,
  K6's sum, the residual blocks (their batch norms and 1x1 downsample),
  and the TinyUnet's convs, blocks and whole. Adam: the port's step equals
  optax's update of the port's own gradients within 1e-6 of the
  parameter's scale (f32 parameters and gradients on both sides); the
  parameters after it equal the JAX package's within 1e-5 of the scale
  wherever the two gradients agree in sign and exceed 1e-3 (Adam's first
  step is lr * g / (|g| + eps), about lr * sign(g)), within one step
  (2 lr) where the noise flips a sign (measured: 3-8% of the entries); the
  entries held exactly make up at least ADAM_AGREE of those where JAX's
  gradient exceeds 1e-3 (measured: 91-97%).

Where torch and JAX add three or more bf16 gradients of one tensor (the
point features feed the semantic and offset branches and the heads), the
rounded sum depends on the grouping. Both add the later consumers'
gradients first (torch's engine runs the nodes created last first, JAX's
transpose walks the jaxpr backwards); a test with values that make the
grouping visible holds that bit for bit.
"""

import collections
import contextlib
import re

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_train as tt
import test_torch_train_instance as tti
from test_torch_bf16 import _bf16_numpy, _f32, _to_bf16, _ulp_report, plans  # noqa: F401
from minsu3d_tpu.config import load_config
from minsu3d_tpu.model import general_model as jgm
from minsu3d_tpu.model import get_model as jax_get_model
from minsu3d_tpu.model.caps import StaticCaps as JaxStaticCaps
from minsu3d_tpu.model.module import blocks as jblocks
from minsu3d_tpu.model.module import dense_blocks as jdense
from minsu3d_tpu.ops import sparse_conv as jconv
from minsu3d_tpu_torch.config import EvalConfig, HaisTrainConfig, TrainConfig, backbone_caps
from minsu3d_tpu_torch.convert import convert_leaf, jax_to_state_dict
from minsu3d_tpu_torch.data.batching import collate, train_caps
from minsu3d_tpu_torch.data.dataset import normalize, train_item
from minsu3d_tpu_torch.data.synthetic import make_scene
from minsu3d_tpu_torch.model.module import blocks, dense_blocks
from minsu3d_tpu_torch.model.registry import get_model
from minsu3d_tpu_torch.ops import segment, sparse_conv
from minsu3d_tpu_torch.test import batch_to_torch, injected_backbone_outputs, set_f32_numerics
from test_torch_data import port_build_in_tmp  # noqa: F401

BF16 = torch.bfloat16
F32_RTOL = 1e-5
DX_ULP_SHARE = 1e-3
BLOCK_ULP_SHARE = 0.02
BLOCK_RTOL = 1e-2
LOSS_RTOL = 5e-3
NOISE_FACTOR = 4.0
GRAD_RTOL = 1e-2
ZERO_GRAD = 1e-5
STATS_RTOL = 5e-3
GRAD_FLOOR = 0.01
UNET_RTOL = 0.02
GAP_CAP = 0.9
NORM_RATIO = 1.5
ADAM_AGREE = 0.8
# where a step's gradient noise passes NOISY, the tensor's operations are held one by one
# in (c)-(d): the sparse backbone's convs and blocks, and the TinyUnet's convs and blocks
NOISY = 0.25
NOISY_COVERED = ("backbone.", "score_net.", "tiny_unet.")


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two torch threads: the suite runs several workers on one machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _bits_equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


def _close(got, want, name: str, rtol: float, floor: float = 1.0) -> float:
    """Max abs error within ``rtol`` of the scale (at least ``floor``);
    returns err / scale."""
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape, name
    assert np.isfinite(g).all(), name
    err = float(np.abs(g - w).max()) if g.size else 0.0
    scale = max(float(np.abs(w).max()) if w.size else 0.0, floor)
    assert err <= rtol * scale, f"{name}: max abs err {err:.3e}, scale {scale:.3e}"
    return err / scale


# -- (b) K6's bf16 sum: XLA's bf16 scatter-add, bit for bit ----------------------------------

def _sum_case(case: str) -> tuple:
    """(rows (R, C) f32 holding bf16 values, segment ids (R,), S)."""
    rng = np.random.default_rng(7)
    if case in ("big_first", "small_first"):
        vals = np.array([1.0] + [2.0 ** -9] * 8, np.float32)
        vals = vals if case == "big_first" else vals[::-1].copy()
        return vals[:, None], np.zeros(9, np.int64), 1
    if case == "long_segment":
        x = _bf16_numpy(rng, 300, 3) * np.float32(2.0) ** rng.integers(-12, 4, (300, 1))
        return x.astype(np.float32), np.zeros(300, np.int64), 1
    if case == "negative_zero":
        x = np.array([[-0.0, 1.0], [3.0, -0.0], [-0.0, -0.0]], np.float32)
        return x, np.array([0, 1, 2]), 4   # segment 3 is empty
    x = _bf16_numpy(rng, 4000, 5) * np.exp2(rng.integers(-8, 8, (4000, 1))).astype(np.float32)
    return x, rng.integers(0, 41, 4000), 40   # id 40: padding rows


@pytest.mark.parametrize("case", ["big_first", "small_first", "long_segment", "negative_zero",
                                  "random"])
def test_bf16_segment_sum_matches_jax_scatter_add(case):
    x, seg, s = _sum_case(case)
    jx, tx = _to_bf16(x)
    want = jnp.zeros((s + 1, x.shape[1]), jnp.bfloat16).at[jnp.asarray(seg)].add(jx)[:s]
    got = segment.segment_reduce(tx, segment.segment_csr(torch.from_numpy(seg), s), "sum")
    _bits_equal(got, want)
    if case == "big_first":
        assert float(got[0, 0]) == 1.0
    if case == "small_first":
        assert float(got[0, 0]) == 1.015625
    if case == "negative_zero":   # a lone -0 lands on a +0.0 accumulator: +0
        assert not torch.signbit(got).any() and float(got[2].abs().sum()) == 0


def test_gather_rows_bf16_backward_matches_jax():
    """The devoxelization's transpose: idx == n reads a zero row and its
    cotangent goes nowhere; every other row sums its cotangents in row
    order, rounding after every add."""
    rng = np.random.default_rng(8)
    n, r, c = 700, 5000, 8
    idx = rng.integers(0, n + 1, r)
    x = _bf16_numpy(rng, n, c)
    ct = _bf16_numpy(rng, r, c) * np.exp2(rng.integers(-6, 6, (r, 1))).astype(np.float32)
    jx, tx = _to_bf16(x)
    jct, tct = _to_bf16(ct)
    want = jax.vjp(lambda v: jconv.ext_zero(v)[jnp.asarray(idx)], jx)[1](jct)[0]
    tx.requires_grad_()
    segment.gather_rows(tx, torch.from_numpy(idx)).backward(tct)
    _bits_equal(tx.grad, want)


# -- (c) the convs' dx and dW ---------------------------------------------------------------

def _conv_grads(jfn, tfn, x: np.ndarray, w: np.ndarray, ct: np.ndarray) -> tuple:
    """(port dx, port dW, JAX dx, JAX dW) of one conv from the same bf16
    input and cotangent and f32 weight."""
    jx, tx = _to_bf16(x)
    jct, tct = _to_bf16(ct)
    jdx, jdw = jax.vjp(jfn, jx, jnp.asarray(w))[1](jct)
    tx.requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = tfn(tx, tw)
    assert out.dtype == BF16
    out.backward(tct)
    assert tx.grad.dtype == BF16 and tw.grad.dtype == torch.float32
    return tx.grad, tw.grad, jdx, jdw


def _check_conv_grads(name: str, grads: tuple) -> None:
    tdx, tdw, jdx, jdw = grads
    differ, beyond, over = _ulp_report(tdx, jdx, f"{name} dx")
    assert beyond == 0.0 and differ <= DX_ULP_SHARE, name
    # dW: the bf16 rounding of an f32 sum taken in another order
    _, _, over = _ulp_report(tdw, jdw, f"{name} dW")
    assert over <= F32_RTOL, name
    assert float(tdw.abs().max()) > 0 and float(tdx.float().abs().max()) > 0


@pytest.mark.parametrize("level,cin,cout", [(0, 6, 8), (0, 16, 8), (1, 16, 16)])
def test_subm_conv_bf16_grads_match_jax(plans, level, cin, cout):
    jplan, tplan = plans
    rng = np.random.default_rng(level * 100 + cin)
    cap = tplan.levels[level].cap
    w = (rng.uniform(-1, 1, (27, cin, cout)) * (6 / (27 * cin)) ** 0.5).astype(np.float32)
    grads = _conv_grads(
        lambda x, w: jconv.subm_conv(x, jplan.levels[level], w, jnp.bfloat16),
        lambda x, w: sparse_conv.subm_conv(x, tplan.levels[level], w),
        _bf16_numpy(rng, cap, cin), w, _bf16_numpy(rng, cap, cout))
    _check_conv_grads(f"subm_conv L{level} {cin}->{cout}", grads)


@pytest.mark.parametrize("kind", ["down", "up"])
def test_k2s2_convs_bf16_grads_match_jax(plans, kind):
    jplan, tplan = plans
    rng = np.random.default_rng(17 if kind == "down" else 19)
    child, parent = tplan.levels[0], tplan.levels[1]
    lk = sparse_conv.links(child, parent.cap)
    if kind == "down":
        cin, cout, n_in, n_out = 8, 16, child.cap, parent.cap
        jfn = lambda x, w: jconv.down_conv(x, jplan.levels[0], parent.cap, w,  # noqa: E731
                                           jnp.bfloat16)
        tfn = lambda x, w: sparse_conv.down_conv(x, lk, w)  # noqa: E731
    else:
        cin, cout, n_in, n_out = 16, 8, parent.cap, child.cap
        jfn = lambda x, w: jconv.up_conv(x, jplan.levels[0], w, jnp.bfloat16)  # noqa: E731
        tfn = lambda x, w: sparse_conv.up_conv(x, lk, w)  # noqa: E731
    w = rng.uniform(-0.3, 0.3, (8, cin, cout)).astype(np.float32)
    grads = _conv_grads(jfn, tfn, _bf16_numpy(rng, n_in, cin), w, _bf16_numpy(rng, n_out, cout))
    _check_conv_grads(f"{kind}_conv", grads)


def test_gather_dx_bf16_plain_rounds_each_contribution_then_each_add():
    """K13's plain version on a crafted row: three sources whose
    contributions are 1.0, 2^-9 and 2^-9 reach row 0 through taps listed in
    reverse source order; sorted by source (1.0 first) every add rounds the
    2^-9 away, while one rounding of the f32 sum would keep 2^-8. Row 1
    has one source whose contribution is -0: it reads +0."""
    w = torch.zeros((3, 1, 1), dtype=BF16)
    w[:, 0, 0] = 1.0
    dout = torch.tensor([[1.0], [2.0 ** -9], [2.0 ** -9], [-0.0]], dtype=BF16)
    idx_t = torch.tensor([[2, 1, 0], [4, 3, 4]], dtype=torch.int32)   # 4 = absent
    got = sparse_conv.gather_dx_bf16(dout, idx_t, w)
    assert got.dtype == BF16 and float(got[0, 0]) == 1.0
    assert float(got[1, 0]) == 0.0 and not torch.signbit(got[1, 0])
    once = sparse_conv.gather_gemm(dout.float(), idx_t, w.float())
    assert float(once[0, 0]) == 1.0 + 2.0 ** -8


# -- (d) a residual block --------------------------------------------------------------------

def test_residual_block_bf16_grads_match_jax(plans):
    """The tail block (2c -> c: the 1x1 downsample, two BN-ReLU-conv, the
    bf16 residual add) at level 0, training mode, random cotangent."""
    jplan, tplan = plans
    rng = np.random.default_rng(21)
    x = _bf16_numpy(rng, tplan.levels[0].cap, 16)
    ct = _bf16_numpy(rng, tplan.levels[0].cap, 8)
    jx, tx = _to_bf16(x)
    jct, tct = _to_bf16(ct)
    module = jblocks.ResidualBlock(16, 8, jnp.bfloat16)
    variables = jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(9), jx,
                                                     jplan.levels[0], True))
    variables["params"] = jax.tree.map(
        lambda a: a + rng.normal(0, 0.1, a.shape).astype(np.float32), variables["params"])

    def f(params, x):
        y, _ = module.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                            jplan.levels[0], True, mutable=["batch_stats"])
        return y

    y, vjp = jax.vjp(f, variables["params"], jx)
    jgp, jdx = vjp(jct)
    block = blocks.ResidualBlock(16, 8)
    block.load_state_dict(jax_to_state_dict(variables))
    tx.requires_grad_()
    out = block(tx, tplan.levels[0], True)
    _, beyond, _ = _ulp_report(out, y, "ResidualBlock forward")
    assert beyond < BLOCK_ULP_SHARE
    out.backward(tct)
    _, beyond, _ = _ulp_report(tx.grad, jdx, "ResidualBlock dx")
    assert beyond < BLOCK_ULP_SHARE
    want = jax_to_state_dict({"params": jax.tree.map(np.asarray, jgp)})
    worst = max(_close(p.grad, want[k], k, BLOCK_RTOL, GRAD_FLOOR)
                for k, p in block.named_parameters())
    print(f"ResidualBlock parameter gradients: worst {worst:.2e} of scale")


# -- (d) the TinyUnet's dense convs and blocks ----------------------------------------------

def _volume(rng, s: int, c: int) -> tuple:
    """(occupancy (6, s, s, s), bf16-exact features on it (6, s, s, s, c))."""
    occ = rng.random((6, s, s, s)) < 0.35
    return occ, _bf16_numpy(rng, 6, s, s, s, c) * occ[..., None]


# (Cin, Cout, input extent, input dtype): the TinyUnet's subm convs at c -> c, 2c -> c (the
# first tail block) and 2c -> 2c (the inner blocks at half the extent), its k2s2 down conv (a
# bf16 input) and its k2s2 transposed conv (an f32 input, rounded to bf16 inside)
DENSE_CONVS = {
    "subm_c_c": (8, 8, 8, BF16), "subm_2c_c": (16, 8, 8, BF16),
    "subm_2c_2c": (16, 16, 4, BF16), "down": (8, 16, 8, BF16), "up": (16, 8, 4, torch.float32),
}


def _dense_conv_pair(kind: str, cin: int, cout: int, occ: np.ndarray, occ_out: np.ndarray):
    """(JAX fn of (x, w), port fn of (x, w), the weight's flax path) of one
    dense conv, its output masked to ``occ_out`` as in the TinyUnet."""
    if kind.startswith("subm"):
        jmod = jdense.DenseSubmConv(cin, cout, jnp.bfloat16)
        tmod = dense_blocks.DenseSubmConv(cin, cout, BF16)
        return (lambda x, w: jmod.apply({"params": {"kernel": w}}, x, jnp.asarray(occ)),
                lambda x, w: torch.func.functional_call(tmod, {"kernel": w},
                                                        (x, torch.from_numpy(occ))),
                ("DenseSubmConv_0", "kernel"))
    jocc, tocc = jnp.asarray(occ_out)[..., None], torch.from_numpy(occ_out)[..., None]
    if kind == "down":
        jconv3d = lambda x, w: jdense._conv3d(x, w, 2, jnp.bfloat16)  # noqa: E731
        tconv3d = lambda x, w: dense_blocks._conv3d(x, w, 2, BF16)  # noqa: E731
    else:
        jconv3d = lambda x, w: jdense._conv3d_transpose(x, w, jnp.bfloat16)  # noqa: E731
        tconv3d = lambda x, w: dense_blocks._conv3d_transpose(x, w, BF16)  # noqa: E731
    return (lambda x, w: jnp.where(jocc, jconv3d(x, w), 0),
            lambda x, w: torch.where(tocc, tconv3d(x, w), 0.0),
            ("conv_kernel",) if kind == "down" else ("deconv_kernel",))


@pytest.mark.parametrize("kind", sorted(DENSE_CONVS))
def test_dense_convs_bf16_grads_match_jax(kind):
    """Each dense conv of the TinyUnet under ``jax.vjp`` against autograd,
    on the same bf16-exact input, f32 weight and random cotangent: dx and
    dW within one bf16 ulp (a bf16 conv's transposes are bf16 convs that sum
    in f32 and round once; torch's CPU conv3d and XLA's may sum in other
    orders) on all but DX_ULP_SHARE of the elements; measured: bit for bit
    but one element of the 2c -> c conv's dW (0.03%)."""
    cin, cout, s, xdtype = DENSE_CONVS[kind]
    rng = np.random.default_rng(len(kind) * 10 + cin)
    occ, x = _volume(rng, s, cin)
    if kind == "down":
        occ_out = occ.reshape(6, s // 2, 2, s // 2, 2, s // 2, 2).max(axis=(2, 4, 6))
    else:
        occ_out = rng.random((6, 2 * s, 2 * s, 2 * s)) < 0.35 if kind == "up" else occ
    ct = _bf16_numpy(rng, *occ_out.shape, cout) * occ_out[..., None]
    jfn, tfn, path = _dense_conv_pair(kind, cin, cout, occ, occ_out)
    k = 3 if kind.startswith("subm") else 2
    w = (rng.uniform(-1, 1, (k, k, k, cin, cout)) * (3 / (27 * cin)) ** 0.5).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if xdtype == BF16 else jnp.float32)
    tx = torch.from_numpy(x).to(xdtype).requires_grad_()
    y, vjp = jax.vjp(jfn, jx, jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(ct).astype(y.dtype))
    tw = convert_leaf(path, w)[1].requires_grad_()
    out = tfn(tx, tw)
    assert out.dtype == (BF16 if kind.startswith("subm") else torch.float32)
    _ulp_report(out, y, f"dense {kind} forward")
    out.backward(torch.from_numpy(ct).to(out.dtype))
    assert tx.grad.dtype == xdtype and tw.grad.dtype == torch.float32
    for label, got, want in (("dx", tx.grad, jdx),
                             ("dW", tw.grad, convert_leaf(path, np.asarray(jdw))[1])):
        differ, beyond, _ = _ulp_report(got, want, f"dense {kind} {label}")
        assert beyond == 0.0 and differ <= DX_ULP_SHARE, (kind, label)
        assert float(got.float().abs().max()) > 0, (kind, label)


def _dense_module_grads(jmod, tmod, seed: int, occ: np.ndarray, x: np.ndarray, cout: int):
    """(port dx, port parameter gradients, JAX dx, JAX parameter gradients
    as a state dict) of a dense module in training mode from the same
    bf16-exact input, the JAX module's initial parameters (plus noise) and a
    random bf16-exact cotangent on the occupied cells."""
    rng = np.random.default_rng(seed)
    jx, tx = _to_bf16(x)
    jocc = jnp.asarray(occ)
    variables = jmod.init(jax.random.PRNGKey(seed), jx, jocc, True)
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(0, 0.1, a.shape).astype(
        np.float32), variables["params"])

    def f(params, x):
        y, _ = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, jocc,
                          True, mutable=["batch_stats"])
        return y

    y, vjp = jax.vjp(f, params, jx)
    ct = _bf16_numpy(rng, *occ.shape, cout) * occ[..., None]
    jgp, jdx = vjp(jnp.asarray(ct).astype(y.dtype))
    tmod.load_state_dict(jax_to_state_dict({"params": params, "batch_stats": jax.tree.map(
        np.asarray, variables["batch_stats"])}))
    tx.requires_grad_()
    out = tmod(tx, torch.from_numpy(occ), True)
    assert str(out.dtype) == f"torch.{y.dtype}"
    _ulp_report(out, y, f"{type(tmod).__name__} forward")
    out.backward(torch.from_numpy(ct).to(out.dtype))
    grads = {k: p.grad for k, p in tmod.named_parameters()}
    return tx.grad, grads, jdx, jax_to_state_dict({"params": jax.tree.map(np.asarray, jgp)})


# (Cin, Cout, extent): the TinyUnet's residual blocks at c -> c, 2c -> 2c (half the extent)
# and 2c -> c (the first tail block, with the 1x1 downsample)
DENSE_BLOCKS = {"c_c": (8, 8, 8), "2c_2c": (16, 16, 4), "2c_c": (16, 8, 8)}


@pytest.mark.parametrize("kind", sorted(DENSE_BLOCKS))
def test_dense_residual_block_bf16_grads_match_jax(kind):
    """One dense residual block of the TinyUnet in training mode (its batch
    statistics from the batch): dx within one bf16 ulp on all but
    BLOCK_ULP_SHARE of the elements (measured: at most 0.02% differ), every
    parameter gradient within BLOCK_RTOL of its scale (measured 5e-4)."""
    cin, cout, s = DENSE_BLOCKS[kind]
    occ, x = _volume(np.random.default_rng(40 + cin + s), s, cin)
    tdx, tgrads, jdx, jgrads = _dense_module_grads(
        jdense.DenseResidualBlock(cin, cout, jnp.bfloat16),
        dense_blocks.DenseResidualBlock(cin, cout, BF16), 41, occ, x, cout)
    assert tdx.dtype == BF16
    _, beyond, _ = _ulp_report(tdx, jdx, f"DenseResidualBlock {kind} dx")
    assert beyond < BLOCK_ULP_SHARE
    assert set(tgrads) == set(jgrads)
    worst = max(_close(g, jgrads[k], k, BLOCK_RTOL, GRAD_FLOOR) for k, g in tgrads.items())
    print(f"DenseResidualBlock {kind} parameter gradients: worst {worst:.2e} of scale")


@pytest.mark.parametrize("seed", [12, 31])
def test_dense_tiny_unet_bf16_grads_match_jax(seed):
    """The whole TinyUnet at S=8 in training mode, dx and every parameter
    gradient. Its forward already differs where two f32 sums (the convs',
    the batch statistics') round to neighbouring bf16 values, and ten batch
    norms carry that on, so the comparison is in relative L2, each tensor
    within UNET_RTOL (measured: at most 7.4e-3 at both seeds, with 9-10%
    of dx one bf16 ulp or more apart); a gradient that is zeroed, flipped,
    halved or sent down a wrong tap reads 0.5 or more."""
    occ, x = _volume(np.random.default_rng(seed), 8, 8)
    tdx, tgrads, jdx, jgrads = _dense_module_grads(
        jdense.DenseTinyUnet(8, jnp.bfloat16), dense_blocks.DenseTinyUnet(8, BF16), seed, occ,
        x, 8)
    assert tdx.dtype == BF16 and set(tgrads) == set(jgrads)
    _ulp_report(tdx, jdx, "DenseTinyUnet dx")
    worst = (0.0, "")
    for k, got, want in [("dx", tdx, jdx)] + [(k, g, jgrads[k]) for k, g in tgrads.items()]:
        g, w = _f32(got).ravel(), _f32(want).ravel()
        assert np.isfinite(g).all() and np.linalg.norm(w) > 0, k
        gap = float(np.linalg.norm(g - w) / np.linalg.norm(w))
        assert gap <= UNET_RTOL, f"{k}: relative L2 gap {gap:.3e}"
        worst = max(worst, (gap, k))
    print(f"DenseTinyUnet seed {seed}: worst relative L2 gap {worst[0]:.2e} ({worst[1]})")


# -- (e) train steps -----------------------------------------------------------------------

def _bf16_jax_args(args: list) -> list:
    return [a.replace("precision=float32", "precision=bfloat16") for a in args]


KEY = jax.random.PRNGKey(5)
# (port model name, JAX overrides, port overrides, heads, epoch, loss flags)
STEPS = {
    "pointgroup_heads_off": ("PointGroup", tt.JAX_SMALL, tt.SMALL, False, 0, {}),
    "pointgroup_heads_on": ("PointGroup", tt.JAX_SMALL, tt.SMALL, True, 30, {}),
    "hais_heads_on": ("HAIS", tti.jax_small("hais"), tti.SMALL, True, 10,
                      {"iou_on_mask": False}),
    "softgroup_heads_on": ("SoftGroup", tti.jax_small("softgroup"), tti.SMALL, True, 30, {}),
}


def _train_batch(cfg) -> dict:
    items = [train_item(cfg, normalize(make_scene(seed=s, **tt.SCENE)), f"s{s}",
                        np.random.default_rng(s)) for s in (21, 22)]
    return collate(items, train_caps(cfg), (backbone_caps(cfg, "train"), len(cfg.net.blocks)))


def _jitter() -> tuple:
    k1, k2 = jax.random.split(KEY)
    return tuple(tuple(np.asarray(jax.random.uniform(k, (3,))).tolist()) for k in (k1, k2))


def _step_both(case: str) -> dict:
    """One bf16 train step of a model on both sides from the JAX model's
    initial variables: losses, gradients, batch statistics, parameters
    after one Adam step, the port's f32 gradients of the same step (the
    bf16 noise), and (PointGroup heads on) the JAX step's jaxpr."""
    name, jax_args, small, heads, epoch, lflags = STEPS[case]
    bundle, jbundle = get_model(name), jax_get_model(name)
    cfg = bundle.train_config().with_overrides({**small, "precision": "bfloat16"})
    jcfg = load_config(_bf16_jax_args(jax_args))
    batch = _train_batch(cfg)
    arrays = {k: jnp.asarray(v) for k, v in batch.items() if k != "scan_ids"}
    jnet = jbundle.make_net(jcfg, "train")
    assert jnet.compute_dtype == jnp.bfloat16
    variables = jax.jit(lambda k, b: jnet.init({"params": k, "cluster": k}, b, True, True))(
        jax.random.PRNGKey(3), arrays)
    variables = jax.tree.map(np.array, {"params": variables["params"],
                                        "batch_stats": variables["batch_stats"]})
    if name == "HAIS":   # half the rows above the mask cut (test_torch_train_instance.py)
        variables["params"]["mask_branch_1"]["bias"][:] = 0.3
    jcaps = JaxStaticCaps.from_cfg(jcfg, "train")
    gt = injected_backbone_outputs(batch, cfg.classes, cfg.net.m, 12, "cpu")
    jflags = jbundle.forward_flags(jcfg, epoch, True)
    lr = cfg.lr

    def loss_fn(params, stats, sem, offs, b):
        def intercept(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, jblocks.Backbone) and context.method_name == "__call__":
                out = dict(out, semantic_scores=sem, point_offsets=offs)
            return out

        with nn.intercept_methods(intercept) if heads else contextlib.nullcontext():
            out, mut = jnet.apply({"params": params, "batch_stats": stats}, b, True, heads,
                                  **jflags, mutable=["batch_stats"],
                                  rngs={"cluster": jax.random.PRNGKey(9)})
        losses = jbundle.losses(jcfg, jcaps, b, out, heads, **lflags)
        return sum(losses.values()), (losses, mut["batch_stats"])

    tx = optax.adam(lr)

    def step(params, stats, sem, offs, b):
        (_, (losses, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, stats, sem, offs, b)
        updates, _ = tx.update(grads, tx.init(params), params)
        return losses, grads, new_stats, optax.apply_updates(params, updates)

    args = (variables["params"], variables["batch_stats"],
            jnp.asarray(gt["semantic_scores"].numpy()), jnp.asarray(gt["point_offsets"].numpy()),
            arrays)
    orig = jgm.clusters_voxelization_dense
    mp = pytest.MonkeyPatch()
    mp.setattr(jgm, "clusters_voxelization_dense", lambda *a: orig(*a[:-1], KEY))
    try:
        jlosses, jgrads, jstats, jparams = jax.tree.map(np.asarray, jax.jit(step)(*args))
        jaxpr = str(jax.make_jaxpr(jax.grad(lambda *a: loss_fn(*a)[0]))(*args)) \
            if case == "pointgroup_heads_on" else None
    finally:
        mp.undo()

    set_f32_numerics()
    tb = batch_to_torch(batch, "cpu")
    port = {}
    for precision in ("float32", "bfloat16"):
        pcfg = cfg.with_overrides({"precision": precision})
        net = bundle.net(pcfg, "train")
        net.load_state_dict(jax_to_state_dict(variables), strict=True)
        out, _ = net.backbone_forward(tb, train=True)
        if heads:
            out = dict(out, semantic_scores=gt["semantic_scores"],
                       point_offsets=gt["point_offsets"])
            out = net.heads(tb, out, True, _jitter(), **bundle.forward_flags(pcfg, epoch, True))
        losses = bundle.losses(pcfg, net.caps, tb, out, heads, **lflags)
        before = {k: p.detach().clone() for k, p in net.named_parameters()}
        sum(losses.values()).backward()
        grads = {k: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                 for k, p in net.named_parameters()}
        port[precision] = dict(out=out, losses=losses, grads=grads, before=before, net=net)
    out, losses, grads, before, net = (port["bfloat16"][k] for k in (
        "out", "losses", "grads", "before", "net"))
    assert out["point_features"].dtype == BF16
    assert all(g.dtype == torch.float32 for g in grads.values())
    opt = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    opt.step()
    return dict(name=name, heads=heads, lr=lr, jlosses=jlosses,
                jgrads=jax_to_state_dict({"params": jgrads}),
                jstate=jax_to_state_dict({"params": jparams, "batch_stats": jstats}),
                losses={k: float(v.detach()) for k, v in losses.items()}, grads=grads,
                grads_f32=port["float32"]["grads"], before=before, net=net, jaxpr=jaxpr,
                n_props=int(out["proposal_rows"]["n_proposals"]) if heads else None)


_RUNS: dict = {}


def _step(case: str) -> dict:
    """``_step_both(case)``, once per test process."""
    if case not in _RUNS:
        _RUNS[case] = _step_both(case)
    return _RUNS[case]


@pytest.fixture(scope="module", params=sorted(STEPS))
def train_step(request):
    return _step(request.param)


def test_bf16_train_step_losses_match(train_step):
    s = train_step
    assert set(s["losses"]) == set(s["jlosses"])
    for k, v in s["losses"].items():
        want = float(s["jlosses"][k])
        print(f"{s['name']} {k}: port {v:.6f} JAX {want:.6f}")
        assert np.isfinite(v) and abs(v - want) <= LOSS_RTOL * max(abs(want), 0.1), k
    if s["heads"]:
        assert s["n_props"] > 0


def test_bf16_train_step_gradients_match(train_step):
    """Every parameter gradient, the backbone's included, against the bf16
    noise of the same tensor, below GAP_CAP and with its norm within
    NORM_RATIO of JAX's (see the module docstring); a tensor whose noise
    passes NOISY lies in a module whose operations (c)-(d) hold one by one."""
    s = train_step
    assert set(s["grads"]) == set(s["jgrads"])
    worst, loudest, widest = (0.0, ""), (0.0, ""), (0.0, "")
    for k, g in s["grads"].items():
        got, want, f32 = (t.numpy().ravel() for t in (g, s["jgrads"][k], s["grads_f32"][k]))
        norm = float(np.linalg.norm(want))
        if norm < ZERO_GRAD:   # 0 in exact arithmetic (a Dense bias before a batch norm)
            assert float(np.linalg.norm(got)) < ZERO_GRAD, k
            continue
        gap = float(np.linalg.norm(got - want)) / norm
        noise = float(np.linalg.norm(want - f32)) / norm
        ratio = float(np.linalg.norm(got)) / norm
        limit = min(NOISE_FACTOR * noise + GRAD_RTOL, GAP_CAP)
        assert gap <= limit, f"{k}: gap {gap:.3e}, noise {noise:.3e}"
        assert 1 / NORM_RATIO <= ratio <= NORM_RATIO, f"{k}: norm {ratio:.3f} of JAX's"
        assert noise <= NOISY or k.startswith(NOISY_COVERED), f"{k}: noise {noise:.3e}"
        worst = max(worst, (gap / (noise + GRAD_RTOL / NOISE_FACTOR), k))
        loudest = max(loudest, (noise, k))
        widest = max(widest, (abs(np.log(ratio)), k))
    print(f"{s['name']} heads={s['heads']}: worst gap over noise {worst[0]:.2f} ({worst[1]}); "
          f"largest noise {loudest[0]:.3e} ({loudest[1]}); norm ratio furthest from 1 "
          f"{np.exp(widest[0]):.3f}x ({widest[1]})")
    assert float(s["grads"]["backbone.input_conv.kernel"].abs().max()) > 0


def test_bf16_train_step_batch_stats_match(train_step):
    s = train_step
    buffers = dict(s["net"].named_buffers())
    assert len(buffers) > 20
    worst = max(_close(b, s["jstate"][k], k, STATS_RTOL) for k, b in buffers.items())
    print(f"{s['name']} heads={s['heads']}: batch statistics worst err/scale {worst:.2e}")


def test_bf16_train_step_adam_update(train_step):
    """Adam on f32 parameters: optax's update of the port's own gradients;
    against the JAX package's parameters after its own step, equal where
    the two gradients agree in sign and stand clear of Adam's eps, within
    one step (2 lr) where bf16 noise flips a gradient's sign; the entries
    held exactly make up at least ADAM_AGREE of those where JAX's gradient
    exceeds 1e-3 (a zeroed or flipped gradient holds none)."""
    s = train_step
    params = {k: p.detach().numpy() for k, p in s["net"].named_parameters()}
    before = {k: p.numpy() for k, p in s["before"].items()}
    grads = {k: g.numpy() for k, g in s["grads"].items()}
    assert all(p.dtype == np.float32 for p in params.values())
    tx = optax.adam(s["lr"])
    updates, _ = tx.update(grads, tx.init(before), before)
    want = optax.apply_updates(before, updates)
    flips = total = agreed = clear = 0
    for k in params:
        scale = max(np.abs(before[k]).max(), 1.0)
        np.testing.assert_allclose(params[k], np.asarray(want[k]), rtol=0, atol=1e-6 * scale,
                                   err_msg=k)
        jg, g = s["jgrads"][k].numpy(), grads[k]
        agree = (np.sign(jg) == np.sign(g)) & (np.minimum(np.abs(jg), np.abs(g)) > 1e-3)
        diff = np.abs(params[k] - s["jstate"][k].numpy())
        assert (diff[agree] <= 1e-5 * scale).all(), k
        assert (diff <= 2 * s["lr"] + 1e-5 * scale).all(), k
        flips += int((np.sign(jg) != np.sign(g)).sum())
        total += g.size
        agreed += int(agree.sum())
        clear += int((np.abs(jg) > 1e-3).sum())
    print(f"{s['name']} heads={s['heads']}: gradient signs differ on {flips} of {total} entries; "
          f"the update is held exactly on {agreed} of the {clear} where JAX's exceeds 1e-3")
    assert agreed >= ADAM_AGREE * clear


def test_three_bf16_gradients_of_one_tensor_add_in_jax_order():
    """A bf16 tensor read by three f32 consumers (as the point features by
    the semantic and offset branches and the heads) gets three bf16
    cotangents; torch and JAX group their sum alike, so the rounded result
    is the same. The values make the grouping visible: 1 + 2^-8 rounds to 1
    (a tie to even), 2^-8 + 2^-8 + 1 does not."""
    for scales in ((1.0, 2.0 ** -8, 2.0 ** -8), (2.0 ** -8, 2.0 ** -8, 1.0),
                   (2.0 ** -8, 1.0, 2.0 ** -8)):
        def f(x):
            return sum(jnp.sum(x.astype(jnp.float32) * c) for c in scales)

        want = jax.grad(f)(jnp.ones((1,), jnp.bfloat16))
        x = torch.ones(1, dtype=BF16, requires_grad=True)
        sum((x.float() * c).sum() for c in scales).backward()
        _bits_equal(x.grad, want)


# -- (a) the rounding map ------------------------------------------------------------------

def _scatter_adds(jaxpr: str) -> list:
    """(output dtype, output shape, combiner dtype, combiner op) of every
    scatter-add of a printed jaxpr; a combiner is inline or a shared
    ``let jaxprN = { lambda ; a:T[] b:T[]. let c:T[] = op a b ...``."""
    named = {m.group(1): (m.group(2), m.group(3)) for m in re.finditer(
        r"let (\w+) = \{ lambda ; \w+:(\w+)\[\] \w+:\w+\[\]\. let\s+\w+:\w+\[\] = (\w+) ",
        jaxpr)}
    lines = jaxpr.splitlines()
    out = []
    for i, line in enumerate(lines):
        m = re.search(r"\w+:(\w+)\[([\d,]*)\] = scatter-add\[", line)
        if not m:
            continue
        block = "\n".join(lines[i:i + 14])
        u = re.search(r"update_jaxpr=(\w+|\{ lambda ; \w+:(\w+)\[\] \w+:\w+\[\]\. let\s+"
                      r"\w+:\w+\[\] = (\w+))", block)
        comb = named[u.group(1)] if u.group(1) in named else (u.group(2), u.group(3))
        out.append((m.group(1), tuple(int(d) for d in m.group(2).split(",")), *comb))
    return out


def test_jax_train_rounding_map():
    """Where the JAX package's bf16 train step rounds, read from the jaxpr
    of PointGroup's step with the heads on (m=8, levels of 8/16/24
    channels, caps 16384/8192/4096, 64 proposals of 14^3 cells):
    * every input gradient of a bf16 row gather is a bf16 scatter-add into
      a zeros operand whose combiner is a bf16 add, so it rounds after
      every add: the 10 subm convs' (the input conv's input needs none),
      the 2 up convs', the devoxelization's and the point-feature gather
      into the proposal rows'; the one more is the forward's placement of
      the bf16 rows into the proposal volume; the down convs' forward sums
      (and the losses' counts) scatter in f32 or int32;
    * every dot is f32 (bf16 x bf16 or f32 x bf16 products, f32 sums), and
      every sparse conv weight appears twice in bf16: the forward's cast of
      the f32 weight and its gradient's f32 dot rounded to bf16;
    * the TinyUnet's 14 convs and their 28 transposes are bf16 convs."""
    jaxpr = _step("pointgroup_heads_on")["jaxpr"]
    cfg = TrainConfig().with_overrides(tt.SMALL)
    caps = backbone_caps(cfg, "train")[:len(cfg.net.blocks)]
    widths = [cfg.net.m * b for b in cfg.net.blocks]
    reps, last = cfg.net.block_reps, len(widths) - 1
    want = []
    for lv, (cap, w) in enumerate(zip(caps, widths)):
        want += [(cap + 1, w)] * 2 * reps                     # the level's blocks
        if lv < last:                                         # its tail blocks
            want += [(cap + 1, 2 * w), (cap + 1, w)] + [(cap + 1, w)] * 2 * (reps - 1)
        if lv > 0:                                            # the up conv into it
            want.append((cap + 1, w))
    m, points = cfg.net.m, cfg.caps.points
    s = cfg.net.score_fullscale
    want += [(caps[0] + 1, m), (points, m), (cfg.caps.proposals * s ** 3 + 1, m)]
    scatters = _scatter_adds(jaxpr)
    bf16 = sorted(shape for dt, shape, cdt, op in scatters if dt == "bf16")
    assert bf16 == sorted(want), (bf16, sorted(want))
    assert all(cdt == dt and op == "add" for dt, _, cdt, op in scatters), scatters
    assert {dt for dt, *_ in scatters} == {"bf16", "f32", "i32"}

    dots = re.findall(r":(\w+)\[[\d,]*\] = dot_general", jaxpr)
    assert dots and set(dots) == {"f32"}
    casts = collections.Counter(re.findall(
        r":bf16\[([\d,]*)\] = convert_element_type\[new_dtype=bfloat16", jaxpr))
    for lv, w in enumerate(widths):
        cin = [w] * 2 * reps + ([2 * w, w] + [w] * 2 * (reps - 1) if lv < last else [])
        for c in set(cin):
            assert casts[f"{27 * c},{w}"] >= 2 * cin.count(c), (lv, c)
    assert casts[f"{27 * cfg.net.input_channel},{m}"] == 2   # the input conv: weight, gradient
    convs = re.findall(r":(\w+)\[[\d,]*\] = conv_general_dilated", jaxpr)
    assert len(convs) == 42 and set(convs) == {"bf16"}


# -- a port checkpoint, evaluated ----------------------------------------------------------

def test_test_entry_point_evaluates_a_port_checkpoint(tmp_path, capsys):
    """``train.py`` saves ``last.pt`` after a bf16 step; ``test.py --ckpt``
    builds the eval net from it (weights and batch statistics, eval caps),
    and its forward equals the trained net's own eval forward bit for bit;
    the entry point evaluates it end to end; another model's net refuses
    the checkpoint."""
    from minsu3d_tpu_torch import test as entry
    from minsu3d_tpu_torch.data.datamodule import TrainData
    from minsu3d_tpu_torch.test import collated_scenes
    from minsu3d_tpu_torch.trainer.trainer import Trainer

    cfg = TrainConfig().with_overrides({**tt.TINY, "precision": "bfloat16"})
    trainer = Trainer(cfg, TrainData(cfg), "cpu")
    trainer.step()
    path = trainer.save_checkpoint(str(tmp_path / "last.pt"))
    small = {k: v for k, v in tt.TINY.items() if k.startswith(("net.", "synthetic."))}
    ecfg = EvalConfig().with_overrides({
        **small, "caps.eval_points": 16384, "caps.eval_voxels": 16384, "caps.clusters": 128,
        "caps.proposals": 64, "caps.neighbors": 16, "caps.cell_window": 16,
        "synthetic.val_scenes": 1, "precision": "bfloat16"})
    model, epoch = entry.checkpoint_model(ecfg, path, "cpu")
    assert epoch == trainer.epoch and not model.training
    _, batch = next(collated_scenes(ecfg))
    tb = batch_to_torch(batch, "cpu")
    flags = get_model("PointGroup").forward_flags(ecfg, epoch, False)
    trained = get_model("PointGroup").net(ecfg, "val")
    trained.load_state_dict(trainer.model.state_dict())
    with torch.no_grad():
        got, want = model.eval()(tb, **flags), trained.eval()(tb, **flags)
    for k in ("semantic_scores", "point_offsets", "point_features"):
        assert torch.equal(got[k], want[k]), k
    assert got["point_features"].dtype == BF16

    mp = pytest.MonkeyPatch()
    mp.setattr(entry, "get_model", lambda name: get_model(name)._replace(
        eval_config=lambda: ecfg))
    try:
        entry.main(["--device", "cpu", "--ckpt", path])
    finally:
        mp.undo()
    out = capsys.readouterr().out
    assert f"weights of {path} (epoch {epoch})" in out and "Semantic mean IoU:" in out
    with pytest.raises(ValueError, match="holds a PointGroup model"):
        entry.checkpoint_model(HaisTrainConfig(), path, "cpu")
