"""Gradients of the PyTorch port against ``jax.grad`` of the JAX package, at
a small size on the CPU (the plain versions of the kernels), same numpy
inputs on both sides.

Tolerances: ``get_iou`` and the plan symmetry are exact (the same f32
operations on the same values, or integer tables); segment-reduction
gradients within 1e-6 of their max abs (a tie of n rows gets cot / n in
torch and cot * (1 / n) in JAX, one rounding apart); conv gradients and the
batch norm within 1e-5 of each gradient's max abs (f32 sums in another
order); losses within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minsu3d_tpu.loss import pt_offset_loss as jax_pt_offset_loss
from minsu3d_tpu.model import general_model as jgm
from minsu3d_tpu.model.module.blocks import MaskedBatchNorm as JaxMaskedBatchNorm
from minsu3d_tpu.ops import instance_iou as jiou
from minsu3d_tpu.ops import segment as jseg
from minsu3d_tpu.ops import sparse_conv as jconv
from minsu3d_tpu.ops.sparse import KERNEL_OFFSETS
from minsu3d_tpu_torch.config import EvalConfig, backbone_caps
from minsu3d_tpu_torch.data.batching import collate, eval_caps
from minsu3d_tpu_torch.data.dataset import eval_item, normalize
from minsu3d_tpu_torch.data.synthetic import make_scene
from minsu3d_tpu_torch.loss.pt_offset_loss import pt_offset_loss
from minsu3d_tpu_torch.model import general_model as gm
from minsu3d_tpu_torch.model.module.blocks import MaskedBatchNorm
from minsu3d_tpu_torch.ops import instance_iou, segment, sparse_conv
from minsu3d_tpu_torch.ops.sparse import plan_from_batch
from test_torch_data import port_build_in_tmp  # noqa: F401

RTOL = 1e-5
CFG = EvalConfig().with_overrides({
    "net.m": 8, "net.blocks": [1, 2, 3], "net.block_reps": 1,
    "caps.eval_points": 16384, "caps.eval_voxels": 16384})


def _close(got, want, name, rtol=RTOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1.0),
                               err_msg=name)


@pytest.fixture(scope="module")
def plans():
    """Two small scenes in one batch; level 2 overflows its capacity, so
    the symmetry and the gradients are checked where voxels were dropped."""
    items = [eval_item(CFG, normalize(make_scene(seed=s, num_objects=5, points_per_object=500,
                                                 floor_points=1600)), f"s{s}")
             for s in (2, 9)]
    batch = collate(items, eval_caps(CFG), (backbone_caps(CFG), len(CFG.net.blocks)))
    assert int(batch["plan2_dropped"]) > 0
    arrays = {k: v for k, v in batch.items() if k != "scan_ids"}
    jplan, _, _ = jgm.build_scene_plan({k: jnp.asarray(v) for k, v in arrays.items()},
                                       backbone_caps(CFG), len(CFG.net.blocks))
    tplan, _, _ = plan_from_batch({k: torch.as_tensor(v) for k, v in arrays.items()},
                                  len(CFG.net.blocks))
    return jplan, tplan


# -- segment reductions --------------------------------------------------------

def _segment_inputs():
    """Ties at 0 (a segment whose max and min are 0 on several rows), ties
    away from 0, a one-row segment, invalid rows and two empty segments."""
    rng = np.random.default_rng(3)
    data = rng.normal(size=(60, 3)).astype(np.float32)
    seg = rng.integers(0, 6, 60).astype(np.int32)
    data[seg == 0] = 0.0                                 # max = min = 0, many ties
    data[seg == 1] = -np.abs(data[seg == 1])
    data[np.flatnonzero(seg == 1)[:3]] = 0.0             # max 0 with three ties
    data[np.flatnonzero(seg == 2)[:2], 1] = 5.0          # a tie away from 0
    seg[seg == 5] = 4
    seg[0] = 5                                           # a one-row segment
    valid = rng.random(60) < 0.85
    valid[0] = True
    seg = np.where(valid, seg, 8).astype(np.int32)       # segments 6, 7 stay empty
    cot = rng.normal(size=(8, 3)).astype(np.float32)
    return data, seg, valid, cot


@pytest.mark.parametrize("name", ["sec_mean", "sec_min", "sec_max", "roipool"])
def test_segment_grad_matches_jax(name):
    data, seg, valid, cot = _segment_inputs()
    want = jax.grad(lambda d: jnp.sum(getattr(jseg, name)(
        d, jnp.asarray(seg), jnp.asarray(valid), 8) * cot))(jnp.asarray(data))
    x = torch.from_numpy(data).requires_grad_()
    out = getattr(segment, name)(x, torch.from_numpy(seg), torch.from_numpy(valid), 8)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(x.grad, want, name, 1e-6)
    assert (out[6:] == 0).all()


def test_roipool_splits_ties_at_zero_evenly():
    """One segment [0, 0] and one [-1]: the cotangent splits 1/2, 1/2."""
    x = torch.tensor([[0.0], [0.0], [-1.0]], requires_grad=True)
    segment.roipool(x, torch.tensor([0, 0, 1]), torch.ones(3, dtype=torch.bool), 2).sum().backward()
    assert x.grad.flatten().tolist() == [0.5, 0.5, 1.0]


# -- sparse convs ----------------------------------------------------------------

@pytest.mark.parametrize("level", [0, 1, 2])
def test_nbr_idx_is_symmetric(plans, level):
    """nbr_idx[i, k] = j  <=>  nbr_idx[j, 26 - k] = i on the port's plans,
    the property that lets dx run as a conv with flipped taps; tap 26 - k is
    the negated offset of tap k in KERNEL_OFFSETS order."""
    assert all(np.array_equal(-np.array(KERNEL_OFFSETS[k]), KERNEL_OFFSETS[26 - k])
               for k in range(27))
    lv = plans[1].levels[level]
    nbr = lv.nbr_idx.numpy()
    cap = nbr.shape[0]
    i, k = np.nonzero(nbr < cap)
    j = nbr[i, k]
    np.testing.assert_array_equal(nbr[j, 26 - k], i)
    assert len(i) > int(lv.valid.sum())  # more than the centre taps


CONV_CASES = [("subm", 0, 6, 8), ("subm", 1, 16, 16), ("subm", 2, 24, 16), ("down", 0, 8, 16),
              ("down", 1, 16, 24), ("up", 0, 16, 8), ("up", 1, 24, 16)]


@pytest.mark.parametrize("kind,level,cin,cout", CONV_CASES)
def test_conv_grads_match_jax(plans, kind, level, cin, cout):
    """dx and dW of the port's autograd (plain path) against jax.grad of
    subm_conv / down_conv / up_conv for a random cotangent."""
    jplan, tplan = plans
    rng = np.random.default_rng(level * 10 + cin)
    jl, tl = jplan.levels[level], tplan.levels[level]
    other = tl.cap if kind == "subm" else tplan.levels[level + 1].cap
    n_in = other if kind == "up" else tl.cap
    n_out = other if kind == "down" else tl.cap
    taps = 27 if kind == "subm" else 8
    x = rng.uniform(-1, 1, (n_in, cin)).astype(np.float32)
    w = rng.uniform(-0.3, 0.3, (taps, cin, cout)).astype(np.float32)
    cot = rng.normal(size=(n_out, cout)).astype(np.float32)
    parent_cap = n_out if kind == "down" else n_in

    def jf(xx, ww):
        if kind == "subm":
            out = jconv.subm_conv(xx, jl, ww)
        elif kind == "down":
            out = jconv.down_conv(xx, jl, parent_cap, ww)
        else:
            out = jconv.up_conv(xx, jl, ww)
        return jnp.sum(out * cot)

    jdx, jdw = jax.grad(jf, (0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    if kind == "subm":
        out = sparse_conv.subm_conv(xt, tl, wt)
    elif kind == "down":
        out = sparse_conv.down_conv(xt, sparse_conv.links(tl, parent_cap), wt)
    else:
        out = sparse_conv.up_conv(xt, sparse_conv.links(tl, parent_cap), wt)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(xt.grad, jdx, f"{kind} dx")
    _close(wt.grad, jdw, f"{kind} dW")


def test_gather_wgrad_plain_counts_absent_as_zero():
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    idx = torch.tensor([[0, 3], [2, -1]], dtype=torch.int32)   # 3 and -1 are absent
    dout = torch.tensor([[1.0], [10.0]])
    dw = sparse_conv.gather_wgrad(x, idx, dout)
    assert dw.shape == (2, 2, 1)
    assert dw[:, :, 0].tolist() == [[40.0, 51.0], [0.0, 0.0]]


# -- proposal IoU ------------------------------------------------------------------

def test_get_iou_bit_identical():
    rng = np.random.default_rng(11)
    n, p_cap, i_cap = 3000, 16, 12
    prop = rng.integers(0, 10, 2 * n).astype(np.int32)
    valid = rng.random(2 * n) < 0.6
    prop = np.where(valid, prop, p_cap).astype(np.int32)
    inst = rng.integers(-1, i_cap + 2, n).astype(np.int32)   # -1 and >= I are not instances
    inp = np.bincount(np.clip(inst, 0, None), minlength=i_cap + 2)[:i_cap].astype(np.int32)
    point_idx = np.concatenate([np.arange(n), np.arange(n)]).astype(np.int32)
    want = jiou.get_iou(jiou.ProposalRows(jnp.asarray(point_idx), jnp.asarray(prop),
                                          jnp.asarray(valid), jnp.int32(10)),
                        p_cap, jnp.asarray(inst), jnp.asarray(inp), i_cap)
    rows = {"point_idx": torch.from_numpy(point_idx).long(),
            "prop_id": torch.from_numpy(prop).long(), "valid": torch.from_numpy(valid)}
    got = instance_iou.get_iou(rows, p_cap, torch.from_numpy(inst), torch.from_numpy(inp),
                               i_cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got > 0).any()


# -- losses --------------------------------------------------------------------------

def test_pt_offset_loss_and_grad_match_jax():
    """Including zero ground-truth and zero predicted offset vectors, where
    the gradient must stay finite."""
    rng = np.random.default_rng(4)
    pred = rng.normal(size=(40, 3)).astype(np.float32)
    gt = rng.normal(size=(40, 3)).astype(np.float32)
    gt[:5] = 0.0
    pred[5:9] = 0.0
    valid = rng.random(40) < 0.8
    valid[:9] = True

    def jf(p):
        a, b = jax_pt_offset_loss(p, jnp.asarray(gt), jnp.asarray(valid))
        return a + 2.0 * b, (a, b)

    (_, (ja, jb)), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(pred))
    pt = torch.from_numpy(pred).requires_grad_()
    a, b = pt_offset_loss(pt, torch.from_numpy(gt), torch.from_numpy(valid))
    (a + 2.0 * b).backward()
    _close(a, ja, "norm", 1e-6)
    _close(b, jb, "dir", 1e-6)
    _close(pt.grad, jg, "grad", 1e-6)


def test_pt_offset_loss_no_valid_points_is_zero():
    z = torch.zeros(4, 3, requires_grad=True)
    a, b = pt_offset_loss(z, torch.zeros(4, 3), torch.zeros(4, dtype=torch.bool))
    (a + b).backward()
    assert float(a.detach()) == 0.0 and float(b.detach()) == 0.0
    assert torch.isfinite(z.grad).all()


def test_semantic_loss_and_grad_match_jax():
    rng = np.random.default_rng(6)
    scores = rng.normal(size=(50, 20)).astype(np.float32)
    labels = rng.integers(-1, 20, 50).astype(np.int32)
    jv, jg = jax.value_and_grad(lambda s: jgm.semantic_loss(s, jnp.asarray(labels)))(
        jnp.asarray(scores))
    st = torch.from_numpy(scores).requires_grad_()
    v = gm.semantic_loss(st, torch.from_numpy(labels))
    v.backward()
    _close(v, jv, "semantic_loss", 1e-6)
    _close(st.grad, jg, "semantic grad", 1e-6)


@pytest.mark.parametrize("fg,bg", [(0.75, 0.25), (0.5, 0.5)])
def test_get_segmented_scores_match_jax(fg, bg):
    s = np.linspace(0, 1, 101, dtype=np.float32)
    want = jgm.get_segmented_scores(jnp.asarray(s), fg, bg)
    _close(gm.get_segmented_scores(torch.from_numpy(s), fg, bg), want, "segmented", 1e-6)


# -- batch norm ----------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(300, 6), (3, 5, 5, 5, 4)])
def test_masked_batch_norm_train_matches_jax(shape):
    """Output, gradients and running statistics of a training forward, on
    sparse rows and on a dense volume (rows = every axis but the last)."""
    rng = np.random.default_rng(len(shape))
    c = shape[-1]
    x = rng.normal(1.0, 2.0, shape).astype(np.float32)
    mask = rng.random(shape[:-1]) < 0.4
    cot = rng.normal(size=shape).astype(np.float32)
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                            "bias": rng.normal(size=c).astype(np.float32)},
                 "batch_stats": {"mean": rng.normal(size=c).astype(np.float32),
                                 "var": rng.uniform(0.5, 2, c).astype(np.float32)}}
    bn = JaxMaskedBatchNorm(c)

    def jf(params, xx):
        y, mut = bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx,
                          jnp.asarray(mask), True, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, mut["batch_stats"])

    (_, (jy, jstats)), (jgp, jgx) = jax.value_and_grad(jf, (0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    tbn = MaskedBatchNorm(c)
    with torch.no_grad():
        for coll in variables.values():
            for k, v in coll.items():
                getattr(tbn, k).copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).requires_grad_()
    y = tbn(xt, torch.from_numpy(mask), train=True)
    (y * torch.from_numpy(cot)).sum().backward()
    _close(y, jy, "y")
    assert (y[torch.from_numpy(~mask)] == 0).all()
    _close(xt.grad, jgx, "dx")
    _close(tbn.scale.grad, jgp["scale"], "dscale")
    _close(tbn.bias.grad, jgp["bias"], "dbias")
    _close(tbn.mean, jstats["mean"], "running mean")
    _close(tbn.var, jstats["var"], "running var")
