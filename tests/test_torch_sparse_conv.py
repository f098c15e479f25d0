"""Sparse convolutions of the PyTorch port (gather_gemm's plain version on
the CPU) against minsu3d_tpu/ops/sparse_conv.py on the same host-built plan.
Tolerance: 1e-5 relative to the output scale, because the two sum the
27 * Cin products in different orders (f32 either way)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minsu3d_tpu.model import general_model as jgm
from minsu3d_tpu.ops import sparse_conv as jconv
from minsu3d_tpu_torch.config import EvalConfig, backbone_caps
from minsu3d_tpu_torch.data.batching import collate, eval_caps
from minsu3d_tpu_torch.data.dataset import eval_item, normalize
from minsu3d_tpu_torch.data.synthetic import make_scene
from minsu3d_tpu_torch.ops import sparse_conv
from minsu3d_tpu_torch.ops.sparse import plan_from_batch
from test_torch_data import port_build_in_tmp  # noqa: F401

RTOL = 1e-5
CFG = EvalConfig().with_overrides({
    "net.m": 8, "net.blocks": [1, 2, 3], "net.block_reps": 1,
    "caps.eval_points": 16384, "caps.eval_voxels": 16384})


@pytest.fixture(scope="module")
def plans():
    scene = normalize(make_scene(seed=2, num_objects=5, points_per_object=500,
                                 floor_points=1600))
    batch = collate([eval_item(CFG, scene, "s")], eval_caps(CFG),
                    (backbone_caps(CFG), len(CFG.net.blocks)))
    arrays = {k: v for k, v in batch.items() if k != "scan_ids"}
    jplan, jv2p, jfeats = jgm.build_scene_plan({k: jnp.asarray(v) for k, v in arrays.items()},
                                               backbone_caps(CFG), len(CFG.net.blocks))
    tplan, tv2p, tfeats = plan_from_batch({k: torch.as_tensor(v) for k, v in arrays.items()},
                                          len(CFG.net.blocks))
    return jplan, tplan, (jv2p, jfeats, tv2p, tfeats)


def _rand(rng, *shape, scale=1.0):
    return (rng.uniform(-1, 1, shape) * scale).astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    tol = RTOL * max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_plan_v2p_and_feats_match(plans):
    _, _, (jv2p, jfeats, tv2p, tfeats) = plans
    np.testing.assert_array_equal(tv2p.numpy(), np.asarray(jv2p))
    np.testing.assert_array_equal(tfeats.numpy(), np.asarray(jfeats))


@pytest.mark.parametrize("level,cin,cout", [(0, 6, 8), (0, 8, 8), (1, 16, 16), (2, 24, 24)])
def test_subm_conv_matches_jax(plans, level, cin, cout):
    jplan, tplan, _ = plans
    rng = np.random.default_rng(level * 100 + cin)
    cap = tplan.levels[level].cap
    x, w = _rand(rng, cap, cin), _rand(rng, 27, cin, cout, scale=0.3)
    want = jconv.subm_conv(jnp.asarray(x), jplan.levels[level], jnp.asarray(w))
    got = sparse_conv.subm_conv(torch.from_numpy(x), tplan.levels[level], torch.from_numpy(w))
    _close(got, want)


@pytest.mark.parametrize("level", [0, 1])
def test_down_conv_matches_jax(plans, level):
    jplan, tplan, _ = plans
    rng = np.random.default_rng(7 + level)
    child, parent = tplan.levels[level], tplan.levels[level + 1]
    x, w = _rand(rng, child.cap, 8), _rand(rng, 8, 8, 16)
    want = jconv.down_conv(jnp.asarray(x), jplan.levels[level], parent.cap, jnp.asarray(w))
    got = sparse_conv.down_conv(torch.from_numpy(x), sparse_conv.links(child, parent.cap),
                                torch.from_numpy(w))
    _close(got, want)
    assert (got[~parent.valid] == 0).all()


@pytest.mark.parametrize("level", [0, 1])
def test_up_conv_matches_jax(plans, level):
    jplan, tplan, _ = plans
    rng = np.random.default_rng(11 + level)
    child, parent = tplan.levels[level], tplan.levels[level + 1]
    x, w = _rand(rng, parent.cap, 16), _rand(rng, 8, 16, 8)
    want = jconv.up_conv(jnp.asarray(x), jplan.levels[level], jnp.asarray(w))
    got = sparse_conv.up_conv(torch.from_numpy(x), sparse_conv.links(child, parent.cap),
                              torch.from_numpy(w))
    _close(got, want)
    assert (got[~child.valid] == 0).all()


def test_down_index_inverts_parent_links(plans):
    _, tplan, _ = plans
    child, parent = tplan.levels[0], tplan.levels[1]
    child_of = sparse_conv.down_index(child, parent.cap)
    rows = torch.nonzero(child.valid).flatten()
    assert torch.equal(child_of[child.parent_idx[rows].long(), child.child_kid[rows].long()],
                       rows.to(torch.int32))
    assert int((child_of < child.cap).sum()) == int(child.valid.sum())


def test_gather_gemm_absent_rows_read_zero():
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    idx = torch.tensor([[0, 4], [4, 4], [3, 1]], dtype=torch.int32)
    w = torch.ones(2, 3, 2)
    out = sparse_conv.gather_gemm(x, idx, w)
    want = torch.tensor([[3.0, 3.0], [0.0, 0.0], [30.0 + 12.0, 30.0 + 12.0]])
    assert torch.equal(out, want)


@pytest.mark.parametrize("bad", ["dtype", "idx_dtype", "shape", "device"])
def test_gather_gemm_rejects_bad_inputs(bad):
    x = torch.zeros(4, 3)
    idx = torch.zeros(2, 2, dtype=torch.int32)
    w = torch.zeros(2, 3, 5)
    if bad == "dtype":
        x = x.double()
    elif bad == "idx_dtype":
        idx = idx.long()
    elif bad == "shape":
        w = torch.zeros(3, 3, 5)
    else:
        x = x.to("meta")
    with pytest.raises((TypeError, ValueError)):
        sparse_conv.gather_gemm(x, idx, w)
