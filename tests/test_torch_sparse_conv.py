"""Sparse convolutions of the PyTorch port (gather_gemm's plain version on
the CPU) against minsu3d_tpu/ops/sparse_conv.py on the same host-built plan.
Tolerance: 1e-5 relative to the output scale, because the two sum the
27 * Cin products in different orders (f32 either way)."""

import functools

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


def _backward_table(tplan, name):
    """(idx, n_rows) of a plan table by ``_tables`` name, or a crafted one:
    "full27", a symmetric subm table of 1003 rows (no multiple of 16) with
    40 rows past the count (all absent), a row with all 27 taps, and rows
    whose sources do not ascend with the tap (the first row is the full
    one's centre, moved ahead of the others); "unsorted", random sources,
    about a third of the taps live, most rows not ascending."""
    if name == "full27":
        from test_torch_kernels_cuda import _subm_table
        return _subm_table(963, 14, 5, 1003), 1003
    if name == "unsorted":
        g = torch.Generator().manual_seed(7)
        src = torch.randint(0, 900, (700, 27), generator=g, dtype=torch.int32)
        return torch.where(torch.rand(700, 27, generator=g) < 0.35, src,
                           torch.full_like(src, 900)), 900
    if name == "nbr0_swapped":   # level 0's map, 40 rows with their taps reversed
        _, idx, n = next(t for t in _tables(tplan) if t[0] == "nbr0")
        idx = idx.clone()
        rows = torch.nonzero((idx < n).sum(1) >= 3).flatten()[::97][:40]
        idx[rows] = idx[rows].flip(1)
        return idx, n
    _, idx, n = next(t for t in _tables(tplan) if t[0] == name)
    return idx, n


def _bf16(rng, *shape, scale=1.0):
    v = rng.standard_normal(shape) * scale * 2.0 ** rng.integers(-3, 3, shape[:1] + (1,) *
                                                                  (len(shape) - 1))
    return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)


def _dx_tile_walk(dout, idx_t, w, order, oc=32):
    """K13's walk on the CPU. Above 12288 rows: blocks of 64 rows of the
    order, each running the union of its rows' live taps in ascending
    order, its 16-row warps only the taps their rows use, each tap's
    chains over Cout staged ``oc`` values a pass; a row whose live sources
    ascend with the tap takes each contribution as its tap comes, every
    other row is redone in (source, tap) order at the end of its block. At
    most 12288 rows: blocks of 16 rows whose 4 warps deal out the union's
    taps, each contribution kept, and every row adding its contributions in
    the (source, tap) order it sorted them into. Returns (out, the rows
    whose sources do not ascend)."""
    r, cout = dout.shape
    n, taps = idx_t.shape
    deep = n <= 12288
    tr, wr = (16, 16) if deep else (64, 16)
    src = idx_t.long()
    live = (src >= 0) & (src < r)
    srcv = torch.where(live, src, torch.full_like(src, -1))
    ascending = ~(live & (srcv < torch.cummax(srcv, 1).values)).any(1)
    perm = order.perm.long()
    on = live if deep else live & ascending[:, None]   # the pairs the walk computes
    pos = on[perm]
    pad = -n % tr
    blk = torch.cat([pos, pos.new_zeros((pad, taps))]).view(-1, tr, taps)
    block = blk.any(1).repeat_interleave(tr, 0)[:n]
    warp = blk.view(-1, wr, taps).any(1).repeat_interleave(wr, 0)[:n]
    assert bool((pos <= warp).all()) and bool((warp <= block).all())
    if deep:   # each union tap dealt to exactly one of the 4 warps
        for u in blk.any(1):
            dealt = [t for t in range(taps) if u[t]]
            assert sorted(sum(([t for j, t in enumerate(dealt) if j % 4 == k]
                                for k in range(4)), [])) == dealt
    runs = torch.zeros((n, taps), dtype=torch.bool)
    runs[perm] = warp                          # (row, tap) computed
    g = torch.cat([dout, dout.new_zeros((1, cout))]).float()
    wf = w.float()
    con = torch.zeros((n, taps, w.shape[2]), dtype=torch.bfloat16)
    acc = torch.zeros((n, w.shape[2]), dtype=torch.float32)
    for t in range(taps):
        d = g[torch.where(runs[:, t] & live[:, t], src[:, t], r)]
        dot = torch.zeros_like(acc)
        for o0 in range(0, cout, oc):
            for o in range(o0, min(o0 + oc, cout)):
                dot = dot + d[:, o, None] * wf[t, o][None, :]
        con[:, t] = dot.to(torch.bfloat16)
        if not deep:
            step = (acc + con[:, t].float()).to(torch.bfloat16).float()
            acc = torch.where(on[:, t, None], step, acc)
    late = torch.arange(n) if deep else torch.nonzero(~ascending).flatten()
    for j in late.tolist():
        a = torch.zeros(w.shape[2], dtype=torch.float32)
        for _, t in sorted((int(src[j, t]), t) for t in range(taps) if live[j, t]):
            if not deep:   # redone from memory
                dot = torch.zeros(w.shape[2], dtype=torch.float32)
                for o in range(cout):
                    dot = dot + g[src[j, t], o] * wf[t, o]
                a = (a + dot.to(torch.bfloat16).float()).to(torch.bfloat16).float()
            else:
                a = (a + con[j, t].float()).to(torch.bfloat16).float()
        acc[j] = a
    return acc.to(torch.bfloat16), int((~ascending).sum())


BACKWARD_TABLES = ["nbr0", "nbr1", "down0", "up0", "up1", "full27", "unsorted",
                   "nbr0_swapped"]


@pytest.mark.parametrize("table", BACKWARD_TABLES)
def test_k13_tile_walk_equals_the_plain_dx_bit_for_bit(plans, table):
    """K13's two decompositions (tiles of the transposed table's order; on
    large tables the taps in ascending order with the bf16 accumulation on
    the fly and the rows whose sources do not ascend redone at the end, on
    small ones the taps split over warps and each row's contributions added
    in its sorted order) give ``gather_dx_bf16_plain`` bit for bit. Every
    row of a plan table ascends; the crafted tables hold rows that do not
    (on a large table: "nbr0_swapped")."""
    _, tplan, _ = plans
    idx_t, r = _backward_table(tplan, table)
    rng = np.random.default_rng(11)
    cin, cout = (16, 24) if idx_t.shape[1] == 27 else (24, 16)
    dout = _bf16(rng, r, cout)
    w = _bf16(rng, idx_t.shape[1], cout, cin, scale=0.2)
    order = sparse_conv.tap_order(idx_t, r)
    got, unsorted = _dx_tile_walk(dout, idx_t, w, order)
    want = sparse_conv.gather_dx_bf16_plain(dout, idx_t, w)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert (unsorted == 0) == (table not in ("full27", "unsorted", "nbr0_swapped")), unsorted
    assert torch.equal(sparse_conv.gather_dx_bf16(dout, idx_t, w, order).view(torch.int16),
                       want.view(torch.int16))


def _wgrad_pair_lists(x, idx, dout, order, split):
    """K4's decomposition on the CPU: each tap's list of live (row, source)
    pairs in the order's row order (live as the order's keys say: an index
    below n_rows), cut into ``split.chunks`` equal parts and each part into
    4 warp quarters; a quarter's slices of 16 pairs (the last one padded)
    each summed apart and added in f32, the quarters added in order, then
    the parts. Returns dW in f32 (bf16: rounded once) and the slices."""
    r, taps = idx.shape
    n, cin = x.shape
    perm = order.perm.long()
    bit = torch.arange(taps, dtype=torch.int64)
    live = ((order.key[:, None] >> bit) & 1) == 0                     # (R, T) by position
    xe = torch.cat([x.float(), x.new_zeros((1, cin)).float()])
    src = idx.long()[perm]
    src = torch.where((src >= 0) & (src < n), src, n)
    assert torch.equal(live, idx.long()[perm] < n)
    de = dout.float()[perm]
    dw = torch.zeros((taps, cin, dout.shape[1]), dtype=torch.float32)
    slices = 0
    for t in range(taps):
        pos = torch.nonzero(live[:, t]).flatten()                      # the tap's list
        total = pos.numel()
        for c in range(split.chunks):
            lo, hi = total * c // split.chunks, total * (c + 1) // split.chunks
            block = torch.zeros_like(dw[t])
            for wp in range(4):
                a, b = lo + (hi - lo) * wp // 4, lo + (hi - lo) * (wp + 1) // 4
                acc = torch.zeros_like(dw[t])
                for s0 in range(a, b, 16):
                    sl = pos[s0:min(s0 + 16, b)]
                    acc = acc + xe[src[sl, t]].T @ de[sl]
                    slices += 1
                block = block + acc
            dw[t] = dw[t] + block
    return (dw.to(torch.bfloat16).float() if x.dtype == torch.bfloat16 else dw), slices


@pytest.mark.parametrize("table", BACKWARD_TABLES)
def test_k4_pair_lists_and_chunks_equal_the_plain_wgrad(plans, table):
    """K4's decomposition (each tap's live pairs listed in the forward
    table's order, ``wgrad_split``'s parts and warp quarters, slices of 16
    pairs, sums in fixed order) gives ``gather_wgrad_plain`` within its
    tolerances: f32 within 1e-5 of the scale, bf16 within one bf16 ulp (or
    1e-5 of the scale where a sum cancels); the slices cover the live pairs
    with at most one padded slice a (tap, part, quarter)."""
    _, tplan, _ = plans
    idx, n = _backward_table(tplan, table)
    rng = np.random.default_rng(12)
    cin, cout = (8, 16) if idx.shape[1] == 27 else (24, 40)
    order = sparse_conv.tap_order(idx, n)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(_rand(rng, n, cin)).to(dtype)
        dout = torch.from_numpy(_rand(rng, idx.shape[0], cout)).to(dtype)
        split = sparse_conv.wgrad_split(idx.shape[0], idx.shape[1], cin, cout)
        got, slices = _wgrad_pair_lists(x, idx, dout, order, split)
        want = sparse_conv.gather_wgrad_plain(x, idx, dout)
        diff = (got - want).abs()
        scale = max(float(want.abs().max()), 1.0)
        if dtype == torch.float32:
            assert float(diff.max()) <= RTOL * scale
        else:
            mag = torch.maximum(got.abs(), want.abs())
            ulp = torch.where(mag > 0, torch.ldexp(torch.ones_like(mag),
                                                   torch.frexp(mag).exponent - 8), mag)
            assert bool(((diff <= ulp) | (diff <= RTOL * scale)).all())
        live = int((idx < n).sum())
        assert live <= 16 * slices < live + 16 * 4 * split.chunks * idx.shape[1]
        assert torch.equal(sparse_conv.gather_wgrad(x, idx, dout, order), want)


@pytest.mark.parametrize("rows,taps,cin,cout,want", [
    (131072, 27, 16, 16, (1, 2, 40)),      # PointGroup level 0
    (11264, 27, 128, 128, (2, 4, 3)),      # HAIS level 3
    (22528, 27, 192, 96, (2, 4, 3)),       # HAIS level 2's tail: the partials' cap
    (1408, 27, 224, 224, (2, 4, 1)),       # HAIS level 6: one part, dW itself
    (65536, 8, 16, 32, (1, 4, 32)),        # PointGroup's level-0 down conv
    (1000, 27, 6, 16, (1, 2, 1)),          # the input conv of a short table
    (0, 27, 16, 16, (1, 2, 1)),            # an empty table
])
def test_wgrad_split_fills_the_card_from_the_shape(rows, taps, cin, cout, want):
    """K4's split: dW tiles of 16 or 32 channels by 16 or 32 columns,
    whichever pads less, and parts of each tap's list up to about 1056
    blocks (8 an SM), one a 2048 table rows at most and at most 8 MB of
    partial sums, from the shape alone."""
    split = sparse_conv.wgrad_split(rows, taps, cin, cout)
    assert tuple(split) == want
    assert split.chunks == 1 or (
        split.chunks <= rows // sparse_conv.WGRAD_MIN_ROWS
        and 4 * split.chunks * taps * cin * cout <= sparse_conv.WGRAD_PARTIAL_BYTES)


@pytest.mark.parametrize("kernel", ["gather_wgrad", "gather_dx_bf16"])
@pytest.mark.parametrize("case", ["copy", "same_shape", "shorter", "source_rows", "edited"])
def test_backward_kernels_reject_a_tap_order_built_for_another_table(plans, kernel, case):
    """K4 and K13 walk the table's order as K1 does, so their wrappers
    refuse, on every device, the order of another table (an equal copy, a
    same-shaped table with other rows, a shorter one, the table with another
    source row count) or of the table edited in place since."""
    _, tplan, _ = plans
    lv = tplan.levels[0]
    idx = lv.nbr_idx.clone()
    if kernel == "gather_wgrad":
        a, b = torch.zeros(lv.cap, 4), torch.zeros(lv.cap, 2)
        run = functools.partial(sparse_conv.gather_wgrad, a, idx, b)
    else:
        a, b = torch.zeros(lv.cap, 2, dtype=torch.bfloat16), torch.zeros(27, 2, 4,
                                                                          dtype=torch.bfloat16)
        run = functools.partial(sparse_conv.gather_dx_bf16, a, idx, b)
    assert torch.equal(run(sparse_conv.tap_order(idx, lv.cap)), run())
    other = {"copy": idx.clone(), "same_shape": idx.flip(0).contiguous(),
             "shorter": idx[:-16].contiguous()}.get(case, idx)
    order = sparse_conv.tap_order(other, lv.cap + (case == "source_rows"))
    if case == "edited":
        idx[0, 0] = lv.cap
    with pytest.raises(ValueError, match=f"{kernel}: (tap order|the table was changed)"):
        run(order)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_conv_backward_hands_each_kernel_its_order(plans, monkeypatch, dtype):
    """The backward walks the orders the forward was given: dW (K4) the
    forward table's, dx (K13 in bf16, K1 in f32) the transposed table's."""
    _, tplan, _ = plans
    lk = sparse_conv.links(tplan.levels[0], tplan.levels[1].cap)
    seen = {}
    for name in ("gather_wgrad", "gather_dx_bf16", "gather_gemm"):
        fn = getattr(sparse_conv, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            seen.setdefault(_name, []).append(args[3] if len(args) > 3 else kw.get("order"))
            return _fn(*args, **kw)
        monkeypatch.setattr(sparse_conv, name, spy)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_rand(rng, tplan.levels[0].cap, 4)).to(dtype).requires_grad_()
    wt = torch.from_numpy(_rand(rng, 8, 4, 8)).requires_grad_()
    sparse_conv.down_conv(x, lk, wt).float().sum().backward()
    dx = "gather_dx_bf16" if dtype == torch.bfloat16 else "gather_gemm"
    assert len(seen["gather_wgrad"]) == 1 and seen["gather_wgrad"][0] is lk.down_order
    assert seen[dx][-1] is lk.up_order
    assert x.grad is not None and wt.grad is not None
