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
from minsu3d_tpu_torch.model.module import blocks
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


def _tables(tplan):
    """(name, idx, n_rows) of every K1 table of the plan: each level's
    kernel map and the two k2s2 tables of each level boundary."""
    out = []
    for lvl, lv in enumerate(tplan.levels):
        out.append((f"nbr{lvl}", lv.nbr_idx, lv.cap))
        if lvl + 1 < len(tplan.levels):
            lk = sparse_conv.links(lv, tplan.levels[lvl + 1].cap)
            out += [(f"down{lvl}", lk.down, lv.cap),
                    (f"up{lvl}", lk.up, tplan.levels[lvl + 1].cap)]
    return out


def test_tap_order_is_a_stable_sort_by_live_taps(plans):
    """Every table's TapOrder is a permutation of its rows, sorted by the set
    of live taps (equal sets together, in row order), rows with no live tap
    last; ``conv_tables`` gives each level's map and k2s2 tables theirs."""
    _, tplan, _ = plans
    for name, idx, n in _tables(tplan):
        order = sparse_conv.tap_order(idx, n)
        r, taps = idx.shape
        assert order.n_rows == n and order.perm.dtype == torch.int32
        assert torch.equal(torch.sort(order.perm.long()).values, torch.arange(r)), name
        perm = order.perm.long()
        live = idx[perm] < n
        key = ((~live).long() << torch.arange(taps)).sum(1)
        assert torch.equal(order.key, key), name                   # key = absent-tap bits
        assert bool((order.key[1:] >= order.key[:-1]).all()), name
        same = order.key[1:] == order.key[:-1]
        assert bool((perm[1:][same] > perm[:-1][same]).all()), name  # stable
        n_live = int(live.any(1).sum())
        assert bool(live[:n_live].any(1).all()) and not bool(live[n_live:].any()), name
    tables = sparse_conv.conv_tables(tplan)
    assert len(tables) == len(tplan.levels) and tables[-1].links is None
    for lv, tab in zip(tplan.levels, tables):
        want = sparse_conv.tap_order(lv.nbr_idx, lv.cap)
        assert tab.nbr_order.table is lv.nbr_idx and tab.nbr_order.n_rows == lv.cap
        assert torch.equal(tab.nbr_order.perm, want.perm)
    lk = tables[0].links
    assert torch.equal(lk.down, sparse_conv.down_index(tplan.levels[0], tplan.levels[1].cap))
    assert torch.equal(lk.down_order.key, sparse_conv.tap_order(lk.down, tplan.levels[0].cap).key)
    assert torch.equal(lk.up_order.key, sparse_conv.tap_order(lk.up, tplan.levels[1].cap).key)
    assert lk.down_order.table is lk.down and lk.up_order.table is lk.up


def test_tap_orders_of_several_tables_equal_each_table_alone(plans):
    """``tap_orders`` over every table of the plan at once (K22's plain
    version here) gives each table the order it gets alone."""
    _, tplan, _ = plans
    tables = [(idx, n) for _, idx, n in _tables(tplan)]
    for (idx, n), order in zip(tables, sparse_conv.tap_orders(tables)):
        alone = sparse_conv.tap_order(idx, n)
        assert torch.equal(order.perm, alone.perm) and torch.equal(order.key, alone.key)
        assert order.table is idx and order.n_rows == n


@pytest.mark.parametrize("bad", ["int64", "rank", "taps", "devices"])
def test_tap_orders_rejects_bad_tables(bad):
    idx = torch.zeros(4, 27, dtype=torch.int32)
    tables = {"int64": [(idx.long(), 4)], "rank": [(idx[0], 4)],
              "taps": [(torch.zeros(4, 33, dtype=torch.int32), 4)],
              "devices": [(idx, 4), (idx.to("meta"), 4)]}[bad]
    with pytest.raises((TypeError, ValueError)):
        sparse_conv.tap_orders(tables)


@pytest.mark.parametrize("case", ["copy", "same_shape", "shorter", "source_rows", "edited"])
def test_gather_gemm_rejects_a_tap_order_built_for_another_table(plans, case):
    """K1 picks a tile's taps from its order alone, so the wrapper refuses,
    on every device, an order of another table: an equal copy, a
    same-shaped table with other rows, a shorter one, the table with
    another source row count, or the table itself edited in place since."""
    _, tplan, _ = plans
    lv = tplan.levels[0]
    idx = lv.nbr_idx.clone()
    x, w = torch.zeros(lv.cap, 4), torch.zeros(27, 4, 2)
    assert torch.equal(sparse_conv.gather_gemm(x, idx, w, sparse_conv.tap_order(idx, lv.cap)),
                       sparse_conv.gather_gemm(x, idx, w))
    other = {"copy": idx.clone(), "same_shape": idx.flip(0).contiguous(),
             "shorter": idx[:-16].contiguous()}.get(case, idx)
    order = sparse_conv.tap_order(other, lv.cap + (case == "source_rows"))
    if case == "edited":
        idx[0, 0] = lv.cap
    with pytest.raises(ValueError, match="tap order|changed in place"):
        sparse_conv.gather_gemm(x, idx, w, order)


def test_backbone_builds_each_tap_order_once_a_forward(plans, monkeypatch):
    """One forward pass orders all its tables in one ``tap_orders`` call
    (each level's kernel map and both k2s2 tables of each level boundary)
    and hands every conv its own table's order: nothing is built per conv
    call."""
    _, tplan, (_, _, tv2p, tfeats) = plans
    calls, convs = [], []
    tap_orders, gather_gemm = sparse_conv.tap_orders, sparse_conv.gather_gemm

    def counted(tables):
        calls.append([idx for idx, _ in tables])
        return tap_orders(tables)

    def seen(x, idx, w, order=None):
        convs.append((idx, order))
        return gather_gemm(x, idx, w, order)

    monkeypatch.setattr(sparse_conv, "tap_orders", counted)
    monkeypatch.setattr(sparse_conv, "gather_gemm", seen)
    net = blocks.Backbone(tfeats.shape[1], CFG.net.m, tuple(CFG.net.blocks),
                          CFG.net.block_reps, 20)
    with torch.no_grad():
        net(tfeats, tplan, tv2p, tv2p < tplan.levels[0].cap)
    n_levels = len(tplan.levels)
    assert len(calls) == 1 and len(calls[0]) == n_levels + 2 * (n_levels - 1)
    assert len({id(t) for t in calls[0]}) == len(calls[0])
    # the input conv, two a residual block (the tails' too), a down and an up
    reps = CFG.net.block_reps
    assert len(convs) == 1 + 2 * reps * (2 * n_levels - 1) + 2 * (n_levels - 1)
    assert all(order is not None and order.table is idx for idx, order in convs)


def _tiled(x, idx, w, order, tile=16, warps=4):
    """K1's tile algorithm on the CPU: tiles of ``tile`` consecutive rows of
    the order, each running the union of its rows' live taps, dealt to
    ``warps`` partial sums added in warp order, written through the order;
    returns (out, slots computed)."""
    r, taps = idx.shape
    xe = torch.cat([x, x.new_zeros((1, x.shape[1]))]).double()
    src = torch.where(idx < x.shape[0], idx.long(), torch.full_like(idx.long(), x.shape[0]))
    out = torch.full((r, w.shape[2]), float("nan"), dtype=torch.float64)
    slots = 0
    for p0 in range(0, r, tile):
        rows = order.perm[p0:p0 + tile].long()
        union = 0
        for k in order.key[p0:p0 + tile].tolist():
            union |= ~k & ((1 << taps) - 1)
        used = [t for t in range(taps) if union >> t & 1]
        slots += len(used) * rows.numel()
        part = torch.zeros((warps, rows.numel(), w.shape[2]), dtype=torch.float64)
        for j, t in enumerate(used):
            part[j % warps] += xe[src[rows, t]] @ w[t].double()
        out[rows] = part.sum(0)
    return out.float(), slots


@pytest.mark.parametrize("table", ["nbr0", "nbr2", "down0", "up0", "up1"])
def test_tiles_over_the_tap_order_compute_the_conv(plans, table):
    """The tiles over a TapOrder skip only dead (row, tap) pairs: the tile
    algorithm gives the plain conv on every row, each row written once, and
    computes exactly ``tile_slots`` pair slots, at least the live pairs."""
    _, tplan, _ = plans
    name, idx, n = next(t for t in _tables(tplan) if t[0] == table)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_rand(rng, n, 8))
    w = torch.from_numpy(_rand(rng, idx.shape[1], 8, 16, scale=0.3))
    order = sparse_conv.tap_order(idx, n)
    got, slots = _tiled(x, idx, w, order)
    want = sparse_conv.gather_gemm_plain(x, idx, w)
    assert not bool(got.isnan().any())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=RTOL * max(float(want.abs().max()), 1.0))
    assert slots == int(sparse_conv.tile_slots(order, idx.shape[1]))
    assert slots >= int((idx < n).sum())
    assert torch.equal(sparse_conv.gather_gemm(x, idx, w, order), want)   # CPU ignores it
