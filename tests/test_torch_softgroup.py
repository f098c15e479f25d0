"""SoftGroup inference of the PyTorch port against the JAX model, at a small
size (m=8, blocks [1, 2, 3], one rep, one ~3k-point synthetic scene), with
the JAX model's own initial variables carried over by ``convert.py``.

* backbone outputs: 1e-5 relative to each output's scale (f32 sums in
  another order);
* softmax: the port's against ``jax.nn.softmax`` within 1e-6 absolute, and
  no (point, class) flag ``prob > score_thr`` flips between the two at the
  test seed (the count is asserted 0);
* grouping (packed and per class): both sides get the same softmax and
  shifted coordinates; proposal rows, n_proposals and every diag counter
  bit for bit, on the scene and on the crafted cases of
  ``tests/test_models.py`` (voxel ids >= 1024, dropped pairs, the per-class
  path's compaction), ported here as parametrised cases. The JAX case of
  the compaction clusters points; the port clusters units only, so both
  sides run it on units of one point each (p2v = arange);
* heads on injected ground-truth backbone outputs: rows and diag bit for
  bit, mask / class / IoU scores within 1e-5 of their scale, AP, AP50,
  AP25 and mIoU equal. The instances of the small scene hold ~500 points,
  so both sides take point_num_avg 500 (clusters above 25 points survive);
* the plain versions of K10 (the pair packing against the JAX lines
  softgroup.py:121-127: no point, no active pair, all active, over and
  under the cap, N not a multiple of 32, K = 1 and 18, cap 0;
  ``compact_rows`` against the JAX function, no row among its cases) and
  K11 (against the JAX lines: tied keys,
  also at 40960 clusters).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from minsu3d_tpu.config import load_config
from minsu3d_tpu.evaluation.instance_segmentation import (
    GeneralDatasetEvaluator as JaxEvaluator)
from minsu3d_tpu.evaluation.instance_segmentation import get_gt_instances as jax_gt
from minsu3d_tpu.evaluation.semantic_segmentation import evaluate_semantic_miou as jax_miou
from minsu3d_tpu.model import get_model as jax_get_model
from minsu3d_tpu.model import softgroup as jsg
from minsu3d_tpu.model.caps import StaticCaps as JaxStaticCaps
from minsu3d_tpu.model.module.blocks import Backbone as JaxBackbone
from minsu3d_tpu_torch.config import SoftGroupEvalConfig, StaticCaps, backbone_caps
from minsu3d_tpu_torch.convert import jax_to_state_dict
from minsu3d_tpu_torch.data.batching import collate, eval_caps
from minsu3d_tpu_torch.data.dataset import eval_item, normalize
from minsu3d_tpu_torch.data.synthetic import make_scene
from minsu3d_tpu_torch.evaluation.instance_segmentation import (
    GeneralDatasetEvaluator, get_gt_instances)
from minsu3d_tpu_torch.evaluation.semantic_segmentation import evaluate_semantic_miou
from minsu3d_tpu_torch.model import softgroup
from minsu3d_tpu_torch.model.registry import get_model
from minsu3d_tpu_torch.ops import stable_partition
from minsu3d_tpu_torch.ops.proposal_rank import proposal_rank_plain
from minsu3d_tpu_torch.ops.sparse import plan_dropped
from minsu3d_tpu_torch.test import batch_to_torch, injected_backbone_outputs, out_to_numpy
from test_torch_data import port_build_in_tmp  # noqa: F401

RTOL = 1e-5
SOFTMAX_ATOL = 1e-6
PNA = (-1.0, -1.0) + (500.0,) * 18
SMALL = {"net.m": 8, "net.blocks": [1, 2, 3], "net.block_reps": 1,
         "caps.eval_points": 8192, "caps.eval_voxels": 8192, "caps.cluster_units": 4096,
         "caps.clusters": 128, "caps.proposals": 64, "caps.neighbors": 16,
         "caps.cell_window": 16, "point_num_avg": PNA}
JAX_SMALL = ["model=softgroup", "data=synthetic", "model.trainer.precision=float32",
             "model.network.m=8", "model.network.blocks=[1,2,3]",
             "model.network.block_reps=1", "model.network.prepare_epochs=25",
             "data.caps.eval_points=8192", "data.caps.eval_voxels=8192",
             "data.caps.cluster_units=4096", "data.caps.eval_instances=64",
             "data.caps.clusters=128", "data.caps.proposals=64",
             "data.caps.neighbors=16", "data.caps.cell_window=16",
             "data.point_num_avg=[" + ",".join(str(v) for v in PNA) + "]"]
FG = tuple(range(2, 20))
ROW_FIELDS = ("point_idx", "prop_id", "valid")


def _close(got, want, name):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * max(np.abs(want).max(), 1.0),
                               err_msg=name)


def _same_rows(trows, tdiag, jrows, jdiag):
    """Rows, n_proposals and the JAX diag counters bit for bit."""
    for f in ROW_FIELDS:
        np.testing.assert_array_equal(trows[f].numpy(), np.asarray(getattr(jrows, f)),
                                      err_msg=f)
    assert int(trows["n_proposals"]) == int(jrows.n_proposals)
    for k, v in jdiag.items():
        assert int(tdiag[k]) == int(v), k
    assert int(tdiag["cc_unconverged"]) == 0


def port_caps(jcaps) -> StaticCaps:
    """The port's caps with the fields of a JAX StaticCaps."""
    return StaticCaps(jcaps.voxel_caps, jcaps.instances, jcaps.clusters, jcaps.proposals,
                      jcaps.neighbors, jcaps.window, jcaps.cc_iters, jcaps.cluster_units,
                      jcaps.half_space, jcaps.edge_factor, jcaps.edge_factor_xyz,
                      jcaps.unit_clustering, jcaps.shifted_units, jcaps.cluster_units_shifted,
                      jcaps.xyz_grid_cell, jcaps.shifted_grid_cell, jcaps.bq_grid_max_m,
                      jcaps.cc_coarsen, jcaps.cc_coarsen_sweeps)


@pytest.fixture(scope="module")
def setup():
    cfg = SoftGroupEvalConfig().with_overrides(SMALL)
    jcfg = load_config(JAX_SMALL)
    scene = normalize(make_scene(seed=23, num_objects=5, points_per_object=500,
                                 floor_points=600))
    batch = collate([eval_item(cfg, scene, "scene0")], eval_caps(cfg),
                    (backbone_caps(cfg), len(cfg.net.blocks)))
    arrays = {k: v for k, v in batch.items() if k != "scan_ids"}
    jnet = jax_get_model("SoftGroup").make_net(jcfg, "val")
    variables = jax.jit(lambda k, b: jnet.init({"params": k, "cluster": k}, b, False, True))(
        jax.random.PRNGKey(4), arrays)
    variables = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    jbackbone = jax.jit(lambda v, b: jnet.apply(v, b, False, False))(variables, arrays)
    injected = {k: v.numpy() for k, v in injected_backbone_outputs(
        batch, cfg.classes, cfg.net.m, 1, "cpu").items()}
    vnp = jax.tree.map(np.asarray, variables)
    model = softgroup.SoftGroupNet(cfg)
    model.load_state_dict(jax_to_state_dict(vnp), strict=True)
    model.eval()
    tb = batch_to_torch(batch, "cpu")
    with torch.no_grad():
        tbackbone, plan = model.backbone_forward(tb)
    tbackbone["voxels_dropped"] = plan_dropped(plan)
    jsoft = np.asarray(jax.nn.softmax(jnp.asarray(injected["semantic_scores"]), axis=-1))
    shifted = (batch["point_xyz"] + injected["point_offsets"]).astype(np.float32)
    return dict(cfg=cfg, jcfg=jcfg, batch=batch, arrays=arrays, jnet=jnet, variables=variables,
                vnp=vnp, model=model, tb=tb, jbackbone=jbackbone, tbackbone=tbackbone,
                injected=injected, jsoft=jsoft, shifted=shifted, runs={})


def run_heads(setup) -> tuple:
    """(JAX out, port out) of the heads on the injected backbone outputs."""
    if "heads" in setup["runs"]:
        return setup["runs"]["heads"]
    injected = setup["injected"]

    def intercept(next_fun, args, kwargs, context):
        if isinstance(context.module, JaxBackbone) and context.method_name == "__call__":
            return {k: jnp.asarray(v) for k, v in injected.items()}
        return next_fun(*args, **kwargs)

    def heads(v, b):
        with nn.intercept_methods(intercept):
            return setup["jnet"].apply(v, b, False, True)

    jout = jax.jit(heads)(setup["variables"], setup["arrays"])
    with torch.no_grad():
        tout = setup["model"].heads(setup["tb"], {k: torch.from_numpy(v)
                                                  for k, v in injected.items()})
    setup["runs"]["heads"] = (jout, tout)
    return jout, tout


def test_convert_maps_every_softgroup_variable(setup):
    sd = jax_to_state_dict(setup["vnp"])
    assert set(sd) == set(softgroup.SoftGroupNet(setup["cfg"]).state_dict())
    for name in ("mask_scoring_0", "mask_scoring_1", "classification_branch", "iou_score"):
        w = setup["vnp"]["params"][name]["kernel"]
        np.testing.assert_array_equal(sd[f"{name}.weight"].numpy(), w.T)
    assert sd["iou_score.weight"].shape == (len(FG) + 1, 8)


@pytest.mark.parametrize("key", ["point_features", "semantic_scores", "point_offsets"])
def test_backbone_matches_jax(setup, key):
    _close(setup["tbackbone"][key], setup["jbackbone"][key], key)


@pytest.mark.parametrize("source", ["injected", "seeded_backbone"])
def test_softmax_matches_jax_and_no_flag_flips(setup, source):
    """The port's softmax within 1e-6 of jax.nn.softmax; at this seed not one
    (point, class) flag prob > score_thr differs between them."""
    scores = (setup["injected"]["semantic_scores"] if source == "injected"
              else np.asarray(setup["jbackbone"]["semantic_scores"]))
    want = np.asarray(jax.nn.softmax(jnp.asarray(scores), axis=-1))
    got = torch.softmax(torch.from_numpy(np.array(scores)), dim=-1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=SOFTMAX_ATOL)
    thr = np.float32(setup["cfg"].net.grouping_cfg.score_thr)
    flips = int(((got[:, FG] > thr) != (want[:, FG] > thr)).sum())
    assert flips == 0, flips


# -- the grouping functions on the same inputs ------------------------------------

def _scene_case(setup):
    b, cfg = setup["batch"], setup["cfg"]
    g = cfg.net.grouping_cfg
    inputs = (setup["jsoft"], setup["shifted"], b["vert_batch_ids"], b["point_mask"])
    return inputs, b["p2v"], setup["jnet"].caps, setup["model"].caps, (
        g.score_thr, g.radius, g.npoint_thr, np.asarray(PNA, np.float32),
        cfg.net.test_cfg.min_npoint, cfg.net.train_cfg.max_proposal_num), 25


def _tiny_case(name):
    """The crafted inputs of tests/test_models.py:182, :215 and :236."""
    rng = np.random.default_rng({"large_voxel_ids": 5, "dropped_pairs": 0, "chain": 0}[name])
    jcaps = JaxStaticCaps.from_cfg(tiny_cfg("softgroup"), "train")._replace(unit_clustering=True)
    if name == "large_voxel_ids":
        n = 400
        pts = np.concatenate([rng.normal(0, 0.01, (200, 3)), rng.normal(5, 0.01, (200, 3))])
        soft = np.zeros((n, 20), np.float32)
        soft[:, 4] = 0.9
        p2v = 2000 + np.arange(n)
    else:
        n = 256
        if name == "dropped_pairs":
            pts = rng.normal(0, 0.5, (n, 3))
        else:
            pts = np.zeros((n, 3))
            pts[:, 0] = np.arange(n) * 0.01
        soft = np.zeros((n, 20), np.float32)
        soft[:, 2], soft[:, 3], soft[:, 4] = 0.4, 0.3, 0.25
        p2v = np.arange(n)
    inputs = (soft, pts.astype(np.float32), np.zeros(n, np.int32), np.ones(n, bool))
    return inputs, p2v.astype(np.int32), jcaps, port_caps(jcaps), (
        0.2, 0.04, 0.05, np.full(20, 100.0, np.float32), 20, 200), 1


def _grouping_case(setup, name):
    return _scene_case(setup) if name == "scene" else _tiny_case(name)


def _run_grouping(setup, name, packed: bool):
    """(JAX rows, diag, port rows, diag) of one case, packed or per class."""
    inputs, p2v, jcaps, tcaps, params, big = _grouping_case(setup, name)
    thr, radius, npoint_thr, pna, min_npoint, max_props = params
    n = inputs[0].shape[0]
    r_cap = min(n * len(FG), 2 * n)
    static = (FG, thr, radius, npoint_thr)

    def jax_fn(soft, pts, bids, mask, pna_, p2v_):
        args = (soft, pts, bids, mask, *static, pna_, min_npoint, max_props, jcaps)
        if packed:
            return jsg.soft_grouping_packed(*args, p2v_, pair_cap=2 * n, big_thre=big)
        return jsg.soft_grouping_compacted(*args, p2v=p2v_, r_cap=r_cap, big_thre=big)

    jrows, jdiag = jax.jit(jax_fn)(*map(jnp.asarray, (*inputs, pna, p2v)))
    targs = (*(torch.from_numpy(np.array(a)) for a in inputs), *static, torch.from_numpy(pna),
             min_npoint, max_props, tcaps, torch.from_numpy(p2v))
    if packed:
        trows, tdiag = softgroup.soft_grouping_packed(*targs, pair_cap=2 * n, big_thre=big)
    else:
        trows, tdiag = softgroup.soft_grouping_compacted(*targs, r_cap=r_cap, big_thre=big)
    return jrows, jdiag, trows, tdiag


@pytest.mark.parametrize("name", ["scene", "large_voxel_ids", "dropped_pairs"])
def test_grouping_packed_matches_jax(setup, name):
    jrows, jdiag, trows, tdiag = _run_grouping(setup, name, packed=True)
    _same_rows(trows, tdiag, jrows, jdiag)
    n_props = int(trows["n_proposals"])
    if name == "scene":
        assert n_props >= 4 and int(tdiag["pairs_dropped"]) == 0
    elif name == "large_voxel_ids":   # two same-class blobs 5 m apart: two proposals
        assert int(tdiag["units_dropped"]) == 0 and n_props == 2
        pid, pt = trows["prop_id"][trows["valid"]], trows["point_idx"][trows["valid"]]
        a, b = set(pid[pt < 200].tolist()), set(pid[pt >= 200].tolist())
        assert len(a) == 1 and len(b) == 1 and a != b
    else:                             # 3 active classes a point: 3N pairs, 2N kept
        assert int(tdiag["pairs_dropped"]) == 256
        # the kept pairs: the first two classes' points, class-major
        assert torch.equal(trows["point_idx"], torch.arange(256).repeat(2))


@pytest.mark.parametrize("name", ["scene", "chain"])
def test_grouping_per_class_matches_jax(setup, name):
    jrows, jdiag, trows, tdiag = _run_grouping(setup, name, packed=False)
    _same_rows(trows, tdiag, jrows, jdiag)
    if name == "chain":               # 3N valid rows compacted to 2N, counted
        assert int(tdiag["pairs_dropped"]) == 256
        assert trows["point_idx"].shape[0] == 512 and bool(trows["valid"].all())
        for k in ("edges_dropped", "clusters_dropped", "units_dropped"):
            assert int(tdiag[k]) == 0, k
    else:
        assert int(trows["n_proposals"]) >= 4


def test_packed_equals_per_class_on_the_port():
    """tests/test_models.py:134 on the port: overlapping blobs whose points
    are active for two classes; both paths give the same proposals."""
    rng = np.random.default_rng(2)
    n = 600
    pts = np.concatenate([rng.normal(0.0, 0.02, (200, 3)), rng.normal(0.08, 0.02, (200, 3)),
                          rng.normal(3.0, 0.02, (200, 3))]).astype(np.float32)
    soft = np.full((n, 20), 0.01, np.float32)
    soft[:200, 2], soft[:200, 3] = 0.6, 0.3
    soft[200:400, 3], soft[200:400, 2] = 0.6, 0.3
    soft[400:, 4] = 0.9
    caps = port_caps(JaxStaticCaps.from_cfg(tiny_cfg("softgroup"), "train"))
    args = (torch.from_numpy(soft), torch.from_numpy(pts),
            torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)),
            torch.from_numpy(rng.random(n) > 0.05), FG, 0.2, 0.04, 0.05,
            torch.full((20,), 100.0), 20, 200, caps, torch.arange(n, dtype=torch.int32))

    def partition(rows):
        groups = {}
        for p, i in zip(rows["prop_id"][rows["valid"]].tolist(),
                        rows["point_idx"][rows["valid"]].tolist()):
            groups.setdefault(p, set()).add(i)
        return {frozenset(v) for v in groups.values()}

    packed, _ = softgroup.soft_grouping_packed(*args, pair_cap=2 * n)
    scan, _ = softgroup.soft_grouping(*args)
    assert int(packed["n_proposals"]) == int(scan["n_proposals"]) >= 3
    assert partition(packed) == partition(scan)


# -- the plain versions of K10 and K11 ------------------------------------------------

def jax_pack(active, pair_cap: int) -> tuple:
    """minsu3d_tpu/model/softgroup.py:121-127 on given class flags."""
    n = active.shape[0]
    act_kn = active.T.reshape(-1)
    n_active = jnp.sum(act_kn.astype(jnp.int32))
    pairs_dropped = jnp.maximum(n_active - pair_cap, 0)
    order = jnp.argsort(~act_kn, stable=True)[:pair_cap].astype(jnp.int32)
    pair_valid = act_kn[order]
    pair_class = jnp.where(pair_valid, order // n, 0).astype(jnp.int32)
    pair_point = (order % n).astype(jnp.int32)
    return pair_point, pair_class, pair_valid, pairs_dropped


# (points N, classes K, share of active pairs, pair cap)
PACK_CASES = {"no point": (0, 18, 0.5, 8),
              "no active pair": (3000, 18, 0.0, 6000),
              "all pairs active": (3000, 18, 1.0, 6000),
              "over the cap": (3000, 18, 0.3, 6000),
              "under the cap": (3000, 18, 0.05, 6000),
              "N not a multiple of 32": (3001, 18, 0.2, 6002),
              "K = 1": (5000, 1, 0.4, 10000),
              "K = 18, cap beyond the pairs": (700, 18, 0.5, 20000),
              "cap 0": (300, 3, 0.5, 0)}


@pytest.mark.parametrize("case", list(PACK_CASES))
def test_pack_pairs_plain_matches_jax(case):
    """K10's pair packing, plain version: every output equal to the JAX
    lines on (N, K) flags whose classes are active at different rates."""
    n, k, share, cap = PACK_CASES[case]
    rng = np.random.default_rng(len(case))
    active = rng.random((n, k)) < share * rng.random(k) * 2
    if share in (0.0, 1.0):
        active[:] = bool(share)
    got = stable_partition.pack_pairs(torch.from_numpy(active), cap)
    want = jax_pack(jnp.asarray(active), cap)
    assert [t.dtype for t in got] == [torch.int64, torch.int64, torch.bool, torch.int64]
    assert got[0].shape == (min(cap, n * k),)
    for name, g, w in zip(("pair_point", "pair_class", "pair_valid", "pairs_dropped"),
                          got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    n_true = int(active.sum())
    assert int(got[3]) == max(n_true - cap, 0)
    if case == "under the cap":       # the false tail, class-major from the first
        tail = got[0][n_true:].numpy(), got[1][n_true:].numpy()
        assert not got[2][n_true:].any() and (tail[1] == 0).all() and tail[0][0] == (
            np.flatnonzero(~active.T.reshape(-1))[0] % n)


# (rows R, share of valid rows, r_cap)
COMPACT_CASES = {"no row": (0, 0.5, 16),
                 "fewer valid rows than the cap": (6000, 0.2, 3000),
                 "more valid rows than the cap": (6000, 0.7, 3000),
                 "no valid row": (4000, 0.0, 1000),
                 "cap beyond the rows": (500, 0.5, 900)}


@pytest.mark.parametrize("case", list(COMPACT_CASES))
def test_compact_rows_plain_matches_jax(case):
    """K10's compact_rows, plain version, against minsu3d_tpu's
    compact_rows (softgroup.py:181-189), field for field."""
    r, share, r_cap = COMPACT_CASES[case]
    rng = np.random.default_rng(r + r_cap)
    valid = rng.random(r) < share
    point_idx = rng.integers(0, 3000, r)
    prop_id = np.where(valid, rng.integers(0, 64, r), 64)
    jrows = jsg.ProposalRows(point_idx=jnp.asarray(point_idx.astype(np.int32)),
                             prop_id=jnp.asarray(prop_id.astype(np.int32)),
                             valid=jnp.asarray(valid), n_proposals=jnp.int32(7))
    want = jsg.compact_rows(jrows, r_cap)
    got = stable_partition.compact_rows(*(torch.from_numpy(a) for a in
                                          (point_idx, prop_id, valid)), r_cap)
    for name, g in zip(("point_idx", "prop_id", "valid"), got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, name)), err_msg=name)
    rows = {"point_idx": torch.from_numpy(point_idx), "prop_id": torch.from_numpy(prop_id),
            "valid": torch.from_numpy(valid), "n_proposals": torch.tensor(7)}
    model = softgroup.compact_rows(rows, r_cap)
    for name, g in zip(("point_idx", "prop_id", "valid"), got):
        assert torch.equal(model[name], g), name


def jax_rank(ccls, sizes, valid, pna_fg, npoint_thr, limit, p_cap, pc, pair_valid):
    """minsu3d_tpu/model/softgroup.py:156-175, on a given cluster class."""
    k, c_cap = pna_fg.shape[0], ccls.shape[0]
    thr = npoint_thr * pna_fg[jnp.clip(ccls, 0, k - 1)]
    ok = valid & (sizes.astype(jnp.float32) >= thr)
    rank_src = jnp.argsort(jnp.where(ok, ccls, k), stable=True)
    rank = jnp.zeros((c_cap,), jnp.int32).at[rank_src].set(jnp.arange(c_cap, dtype=jnp.int32))
    prop = jnp.where(ok & (rank < limit), rank, p_cap)
    prop_ext = jnp.concatenate([prop, jnp.full((1,), p_cap, jnp.int32)])
    pid = jnp.where(pair_valid, prop_ext[pc], p_cap)
    return jnp.minimum(pid, p_cap), pid < p_cap, jnp.minimum(jnp.sum(ok.astype(jnp.int32)), limit)


RANK_CASES = ["tied_keys", "sizes_at_threshold", "few_survivors", "limit_cuts",
              "tied_keys_above_the_old_cluster_cap"]


@pytest.mark.parametrize("case", RANK_CASES)
def test_proposal_rank_plain_matches_jax(case):
    """Also at 40960 clusters, above the 32768 that K11's one-block rank
    could take before it spread over the card, with 3 classes' tied keys
    and a proposal cap that leaves every rank below 30000 visible."""
    rng = np.random.default_rng(RANK_CASES.index(case))
    big = case == "tied_keys_above_the_old_cluster_cap"
    c_cap, k, n_pairs, p_cap = (40960, 18, 120000, 65536) if big else (512, 18, 6000, 128)
    limit = {"limit_cuts": 40, "tied_keys_above_the_old_cluster_cap": 30000}.get(case, 100)
    ccls = rng.integers(0, 3 if case.startswith("tied_keys") else k, c_cap).astype(np.int32)
    valid = np.arange(c_cap) < (30 if case == "few_survivors" else c_cap * 450 // 512)
    ccls[~valid] = -1
    pna = rng.choice([100.0, 333.0, 3000.0], k).astype(np.float32)
    sizes = rng.integers(1, 400, c_cap).astype(np.int32)
    if case == "sizes_at_threshold":  # sizes on, just below and just above 0.05 * pna
        thr = np.float32(0.05) * pna[np.clip(ccls, 0, k - 1)]
        sizes = (np.ceil(thr) + rng.integers(-1, 2, c_cap)).astype(np.int32)
    pc = rng.integers(0, c_cap + 1, n_pairs).astype(np.int32)
    pair_valid = rng.random(n_pairs) < 0.9
    got = proposal_rank_plain(torch.from_numpy(ccls), torch.from_numpy(sizes),
                              torch.from_numpy(valid), torch.from_numpy(pna), 0.05, limit,
                              p_cap, torch.from_numpy(pc), torch.from_numpy(pair_valid))
    want = jax_rank(*map(jnp.asarray, (ccls, sizes, valid, pna)), 0.05, limit, p_cap,
                    jnp.asarray(pc), jnp.asarray(pair_valid))
    for g, w, name in zip(got, want, ("prop_id", "valid", "n_proposals")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert int(got[2]) > 0
    if big:   # clusters past 32768 hold proposals, and the cap cuts
        assert bool(got[1][torch.from_numpy(pc) >= 32768].any()) and int(got[2]) == limit


# -- the full heads -----------------------------------------------------------------

def test_heads_rows_and_diag_identical(setup):
    jout, tout = run_heads(setup)
    _same_rows(tout["proposal_rows"], tout["diag"], jout["proposal_rows"],
               {k: v for k, v in jout["diag"].items() if k != "voxels_dropped"})
    assert int(setup["tbackbone"]["voxels_dropped"]) == int(jout["diag"]["voxels_dropped"])
    assert int(tout["proposal_rows"]["n_proposals"]) >= 4
    assert all(int(v) == 0 for v in tout["diag"].values())


@pytest.mark.parametrize("name", ["mask_scores", "cls_scores", "iou_scores"])
def test_scores_match(setup, name):
    jout, tout = run_heads(setup)
    _close(tout[name], jout[name], name)


def test_ap_and_miou_equal(setup):
    jout, tout = run_heads(setup)
    cfg, jcfg, batch = setup["cfg"], setup["jcfg"], setup["batch"]
    n = int(batch["num_points"])
    xyz, sem_gt, inst_gt = (batch["point_xyz"][:n], batch["sem_labels"][:n],
                            batch["instance_ids"][:n])
    ignore = list(cfg.ignore_classes)
    tnp = out_to_numpy(tout, n)
    jnp_out = {k: np.asarray(jout[k]) for k in ("mask_scores", "cls_scores", "iou_scores")}
    jnp_out["semantic_scores"] = np.asarray(jout["semantic_scores"])[:n]
    jnp_out["proposal_rows"] = {f: np.asarray(getattr(jout["proposal_rows"], f))
                                for f in jout["proposal_rows"]._fields}
    tpred = get_model("SoftGroup").pred_instances(cfg, "scene0", xyz, tnp, len(ignore))
    jpred = jsg.pred_instances(jcfg, "scene0", xyz, jnp_out, len(ignore))
    assert len(tpred) == len(jpred) > 0
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


# -- configuration, registry, entry point --------------------------------------------

EVAL_SCRIPT = ["model=softgroup", "data=synthetic", "model.network.prepare_epochs=25",
               "data.synthetic.train_scenes=12", "data.synthetic.val_scenes=3",
               "data.synthetic.num_objects=8", "data.synthetic.points_per_object=3000",
               "data.synthetic.floor_points=16000", "data.batch_size=2",
               "data.caps.points=98304", "data.caps.voxels=90112",
               "data.caps.eval_points=57344", "data.caps.eval_voxels=65536",
               "data.caps.cluster_units=49152", "data.caps.instances=64",
               "data.caps.eval_instances=64", "data.caps.clusters=16384",
               "data.caps.proposals=128"]


def test_softgroup_config_matches_eval_script():
    """SoftGroupEvalConfig() is scripts/eval_synth_softgroup.sh's config (in f32)."""
    j, c = load_config(EVAL_SCRIPT), SoftGroupEvalConfig()
    jn = j.model.network
    for k in ("m", "block_reps", "use_color", "use_normal"):
        assert getattr(c.net, k) == jn[k], k
    assert c.net.blocks == tuple(jn.blocks)
    for sub, keys in (("grouping_cfg", ("score_thr", "radius", "npoint_thr", "packed")),
                      ("instance_voxel_cfg", ("scale", "spatial_shape")),
                      ("train_cfg", ("max_proposal_num",)),
                      ("test_cfg", ("cls_score_thr", "mask_score_thr", "min_npoint"))):
        for k in keys:
            assert getattr(getattr(c.net, sub), k) == jn[sub][k], (sub, k)
    assert c.point_num_avg == tuple(j.data.point_num_avg)
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
    assert port_caps(want) == got
    net = jax_get_model("SoftGroup").make_net(j, "val")
    assert softgroup.SoftGroupNet(c).fg_class_ids == net.fg_class_ids
    assert not c.with_overrides({"net.grouping_cfg.packed": False}).net.grouping_cfg.packed
    for key in ("caps.grid",):
        with pytest.raises(ValueError, match="TPU-layout backend"):
            c.with_overrides({key: True})


def test_registry_resolves_softgroup():
    bundle = get_model("softgroup")
    assert bundle.net is softgroup.SoftGroupNet
    assert bundle.eval_config is SoftGroupEvalConfig
    assert bundle.forward_flags(SoftGroupEvalConfig(), 100, False) == {}


def test_entry_point_runs_softgroup_on_cpu(monkeypatch, capsys):
    """``python -m minsu3d_tpu_torch.test --device cpu --model softgroup``
    end to end on the CPU at the small size: the AP table, the metrics and
    SoftGroup's four overflow counters."""
    from minsu3d_tpu_torch import test as entry

    small = SoftGroupEvalConfig().with_overrides({**SMALL, "synthetic.num_objects": 3,
                                                  "synthetic.points_per_object": 400,
                                                  "synthetic.floor_points": 1500})
    monkeypatch.setattr(entry, "get_model", lambda name: get_model(name)._replace(
        eval_config=lambda: small))
    entry.main(["--device", "cpu", "--scenes", "1", "--model", "softgroup"])
    out = capsys.readouterr().out
    for needle in ("average", "Semantic Accuracy:", "Semantic mean IoU:",
                   "per-scene forward ms (cpu)", "pairs_dropped", "units_dropped",
                   "edges_dropped", "clusters_dropped"):
        assert needle in out, needle
