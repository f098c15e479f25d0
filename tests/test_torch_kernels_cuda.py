"""Kernels K3 and K18 (connected components, also at truncated budgets, with
the root-graph coarsening and with a pair list that overflows; one launch
and no host sync a call), K5 and K12 (one launch and no host sync a call:
K5 at 128, 512 and 1024 proposals, on rows grouped by proposal as the
heads write them and shuffled, int64 rows and int16 / int32 / int64 ids,
with and without a row mask; K12 on the same rows, crafted ties, NaNs and
invalid rows), K6-K13 (K9 also on
non-root labels; K8 on the per-cluster arrays, building its 512-slot table
itself, at up to 16384 clusters with primaries beyond the table, exact
ties and unaligned flags, and the whole ``hierarchical_aggregation``; K11
above the old 32768-cluster cap, on int32 and int64 inputs, at 1 and 126
classes and with nothing to rank, and SoftGroup's packed grouping from the
pair packing to the ranked rows; each call one launch and no host sync),
K14, K2 (one launch a call on its table: the recipe's
cap, an overflowing one and none, 14 and 27 offsets, with and without
groups, K above a warp, n = 1, no valid point; the whole ball query call
with no K16 launch and no host sync), K10 (the pair packing at SoftGroup's
main-path shape on both sides of the cap, over several tiles a block, at K
= 1, from flags that start unaligned, at cap 0 and N = 0; compact_rows'
gather; one launch a call and no host sync), K15-K17 (the key sort on both
of its paths and with ``bits``, sorted lookup in all three modes, the
neighbour mode over every level of a plan in one launch with no host sync:
keys that wrap at z = 1023 and y = 1023, two batches, a level with no valid
row, a full level, eight levels, and the golden PointGroup scene's seven
levels against the host plan's maps; K17 reading the
valid flags through the permutation, one launch a call, with and without a
table, into an overflowing cap, at n = 0 and 1; ``make_units_grid`` with no
host sync; and a small device grid plan) and
the gather probe's K19-K21 against their plain versions on the card, at
small shapes, bit for bit (integers and the ordered f32 sums alike); the bf16 variants of
K1 and K4 (within one bf16 ulp, or the f32 tolerance where a sum cancels),
K6 (max, min and the per-add-rounded sum), K7 and K13 (bit for bit); K1 in
f32 (within 1e-5 of scale) and in bf16, at every tile layout, and as the
f32 dx of a subm conv, at the widths of the models (Cin 6, 16, 224), with
rows past the count, all-absent rows and a row with all 27 taps, each
result equal bit for bit from call to call; K13 (bit for bit) and K4 (f32
within 1e-5 of scale, bf16 within one bf16 ulp) over the tables' TapOrders
at Cin 6, 16 and 224 and Cout 192, on both of K13's table sizes and the
k2s2 tables, each called twice for the same bits and refusing another
table's order with no launch; K6 on adversarial segments (signed zeros,
NaN payloads, a 100k-row segment, empty segments, long segments over two
channel groups) and K9 on crafted label sets and a val scene's units,
each call's launches counted and no host sync. They need a GPU and
``nvcc`` and skip without CUDA. This file imports no JAX, so it runs on a
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``chip_smoke.py`` holds the same kernels against their plain versions at
the main path's shapes.)
"""

import pytest
import torch

from minsu3d_tpu_torch.csrc import build
from minsu3d_tpu_torch.ops import (ballquery, cluster, instance_iou, proposal_rank,
                                   proposal_voxelize, segment, set_aggregation, sparse_conv,
                                   stable_partition)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only on the card")
    build.kernel_lib()
    return torch.device("cuda", 0)


def _csr_pair(seg, n_seg, dev):
    return segment.segment_csr(seg, n_seg), segment.segment_csr(seg.to(dev), n_seg)


@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_segment_reduce_kernel_matches_plain(dev, op, dtype):
    g = torch.Generator().manual_seed(0)
    rows, n_seg, c = 20000, 300, 37
    seg = torch.randint(0, n_seg + 1, (rows,), generator=g)
    seg[:3000] = 5                                       # one long segment
    seg[seg == 7] = n_seg                                # an empty one
    if dtype == torch.float32:
        mag = 10 ** (torch.rand((rows, 1), generator=g) * 6 - 3)
        x = torch.randn((rows, c), generator=g) * mag
    else:
        x = torch.randint(-1000, 1000, (rows, c), generator=g, dtype=torch.int32)
    cpu, card = _csr_pair(seg, n_seg, dev)
    want = segment.segment_reduce(x, cpu, op, -3)
    before = build.LAUNCHES["segment_reduce"]
    got = segment.segment_reduce(x.to(dev), card, op, -3)
    assert build.LAUNCHES["segment_reduce"] == before + 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(segment.segment_reduce_plain(x.to(dev), card, op, -3).cpu(), want)


@pytest.mark.parametrize("op", ["max", "min"])
def test_segment_reduce_kernel_propagates_nan(dev, op):
    g = torch.Generator().manual_seed(5)
    rows, n_seg, c = 4000, 50, 5
    seg = torch.randint(0, n_seg, (rows,), generator=g)
    x = torch.randn((rows, c), generator=g)
    x[torch.randint(0, rows, (40,), generator=g), torch.randint(0, c, (40,), generator=g)] = \
        float("nan")
    x[0, 0] = float("nan")                              # a NaN that opens its segment
    cpu, card = _csr_pair(seg, n_seg, dev)
    want = segment.segment_reduce(x, cpu, op)
    got = segment.segment_reduce(x.to(dev), card, op).cpu()
    assert bool(want.isnan().any())
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


def test_gather_rows_backward_on_the_card_matches_cpu(dev):
    g = torch.Generator().manual_seed(1)
    x = torch.randn((500, 16), generator=g)
    idx = torch.randint(0, 501, (8000,), generator=g)
    cot = torch.randn((8000, 16), generator=g)
    grads = []
    for d in ("cpu", dev):
        xt = x.to(d, copy=True).requires_grad_()
        segment.gather_rows(xt, idx.to(d)).backward(cot.to(d))
        grads.append(xt.grad.cpu())
    assert torch.equal(grads[0], grads[1])


def test_unit_compact_kernel_matches_plain(dev):
    g = torch.Generator().manual_seed(2)
    u, n_points = 6000, 20000
    comp = torch.randint(0, 900, (u,), generator=g)
    active = torch.rand(u, generator=g) < 0.7
    first = torch.full((900,), u, dtype=torch.int64)
    first.scatter_reduce_(0, comp[active], torch.arange(u)[active], reduce="amin")
    label = torch.where(active, first[comp], torch.full_like(comp, u))
    counts = torch.where(active, torch.randint(1, 4, (u,), generator=g), 0)
    uid = torch.randint(0, u + 1, (n_points,), generator=g)
    for c_cap in (4096, 50):
        want = cluster.unit_points_compact_plain(label, uid, u, c_cap, counts)
        got = cluster.unit_points_compact_cuda(label.to(dev), uid.to(dev), u, c_cap,
                                               counts.to(dev))
        for name, w, k in zip(("point_cluster", "sizes", "count", "seg_sizes", "n_big"), want,
                               got):
            assert torch.equal(k.cpu(), w), name


def _k7_inputs(g, n: int, rows: int, p_cap: int, s: int, c: int, dtype):
    """Seeded K7 inputs: rows of random points and proposals, a fifth
    invalid, placement parameters that crowd and clamp the cells."""
    coords = torch.randn((n, 3), generator=g)
    pidx = torch.randint(0, n, (rows,), generator=g)
    valid = torch.rand(rows, generator=g) < 0.8
    prop = torch.randint(0, p_cap, (rows,), generator=g, dtype=torch.int32)
    mean = torch.randn((p_cap, 3), generator=g) * 0.1
    scale = torch.rand(p_cap, generator=g) * 5 + 1
    offset = torch.rand((p_cap, 3), generator=g) * s / 2
    feats = torch.randn((n, c), generator=g).to(dtype)
    return feats, pidx, coords, prop, valid, mean, scale, offset


def _k7_run(dev, feats, pidx, coords, prop, valid, mean, scale, offset, p_cap, s):
    """K7 on the card against ``place_plain`` on the CPU, bit for bit, over
    the rows' proposal CSR built on each side; returns the plain outputs
    and the call's launches (the kernel library's count)."""
    csr = segment.valid_csr(prop, valid, p_cap)
    want = proposal_voxelize.place_plain(feats, pidx, coords, csr, mean, scale, offset, p_cap, s)
    csr_d = segment.valid_csr(prop.to(dev), valid.to(dev), p_cap)
    args = [t.to(dev) for t in (feats, pidx, coords)] + [csr_d] + [
        t.to(dev) for t in (mean, scale, offset)] + [p_cap, s]
    count = proposal_voxelize._LAUNCH_NAME[feats.dtype]
    before = build.LAUNCHES[count]
    got, ops = _device_ops(lambda: proposal_voxelize.place_cuda(*args),
                           "ms3d_proposal_voxelize_device_ops")
    assert build.LAUNCHES[count] == before + 1
    assert got[0].dtype == feats.dtype
    for name, w, k in zip(("volume", "occ", "row_cell", "cell_w"), want, got):
        assert torch.equal(k.cpu().view(torch.uint8), w.view(torch.uint8)), name
    return want, ops, args


def test_proposal_voxelize_kernel_matches_plain(dev):
    g = torch.Generator().manual_seed(3)
    p_cap, s = 16, 14
    want, ops, _ = _k7_run(dev, *_k7_inputs(g, 3000, 6000, p_cap, s, 8, torch.float32),
                           p_cap, s)
    assert bool(want[1].any()) and ops == 1


def test_proposal_voxelize_bf16_kernel_matches_plain(dev):
    g = torch.Generator().manual_seed(13)
    p_cap, s = 16, 20
    want, ops, _ = _k7_run(dev, *_k7_inputs(g, 3000, 6000, p_cap, s, 32, torch.bfloat16),
                           p_cap, s)
    assert bool(want[1].any()) and ops == 1


# the models' K7 shapes: (points, rows, proposals, S, channels, dtype)
K7_SHAPES = {"PointGroup f32": (131072, 262144, 128, 14, 16, torch.float32),
             "HAIS f32": (57344, 114688, 128, 20, 32, torch.float32),
             "HAIS/SoftGroup bf16": (57344, 114688, 128, 20, 32, torch.bfloat16)}

# aten ops that allocate, view or read metadata and launch nothing on the card
NO_KERNEL_OPS = {"aten::empty", "aten::empty_strided", "aten::view", "aten::slice",
                 "aten::select", "aten::as_strided", "aten::narrow", "aten::reshape",
                 "aten::_reshape_alias", "aten::to", "aten::contiguous", "aten::alias",
                 "aten::detach", "aten::unbind", "aten::_unsafe_view", "aten::lift_fresh",
                 "aten::split", "aten::split_with_sizes"}


def _torch_ops(fn) -> set:
    """The aten ops that ``fn()`` runs, by torch.profiler's host events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    torch.cuda.synchronize()
    return {e.key for e in prof.key_averages() if e.key.startswith("aten::")}


@pytest.mark.parametrize("case", ["random", "empty proposals", "contested", "all invalid"])
@pytest.mark.parametrize("shape", list(K7_SHAPES))
def test_proposal_voxelize_is_one_launch_at_the_model_shapes(dev, shape, case):
    """K7 at PointGroup's, HAIS's and SoftGroup's shapes, bit for bit: one
    launch, no fill or zeroing op in its wrapper; proposals with no rows
    come out zero, a cell contested by the first and last rows of a
    proposal (far apart in the CSR, placed by different blocks of the
    cluster) goes to the first, and with every row invalid the volume is
    zero and every row's cell P * S^3."""
    n, rows, p_cap, s, c, dtype = K7_SHAPES[shape]
    g = torch.Generator().manual_seed(17)
    feats, pidx, coords, prop, valid, mean, scale, offset = _k7_inputs(g, n, rows, p_cap, s, c,
                                                                       dtype)
    if case == "empty proposals":
        prop = torch.where((prop == 3) | (prop == p_cap - 1), torch.full_like(prop, 4), prop)
    if case == "all invalid":
        valid = torch.zeros_like(valid)
    mine = torch.nonzero(valid & (prop == 5))[:, 0]
    if case == "contested":
        pidx[mine[-1]] = pidx[mine[0]]
    want, ops, args = _k7_run(dev, feats, pidx, coords, prop, valid, mean, scale, offset, p_cap,
                              s)
    volume, occ, row_cell, cell_w = want
    n_cells = p_cap * s ** 3
    assert ops == 1
    ops_run = _torch_ops(lambda: proposal_voxelize.place_cuda(*args))
    assert ops_run <= NO_KERNEL_OPS, ops_run - NO_KERNEL_OPS
    if case == "empty proposals":
        for p in (3, p_cap - 1):
            assert not bool(occ.view(p_cap, -1)[p].any())
            assert not bool(volume.view(p_cap, -1)[p].any())
    if case == "contested":
        a, b = int(mine[0]), int(mine[-1])
        assert row_cell[a] == row_cell[b] and cell_w[a] == row_cell[a] and cell_w[b] == n_cells
    if case == "all invalid":
        assert not bool(occ.any()) and not bool(volume.any())
        assert bool((row_cell == n_cells).all()) and bool((cell_w == n_cells).all())
    else:
        assert bool(occ.any())


# name: (clusters, primaries, batches, classes, share of fragments, unaligned flags)
K8_CASES = {
    "5000 clusters, 250 primaries, 4 classes": (5000, 250, 2, 4, 0.9, False),
    "16384 clusters, 700 primaries: the table drops 188": (16384, 700, 2, 18, 0.9, False),
    "16384 clusters, 512 primaries, 95% fragments, one batch": (16384, 512, 1, 18, 0.95, False),
    "300 clusters: a table of 300 slots": (300, 40, 2, 3, 0.9, False),
    "no primary": (4000, 0, 2, 4, 0.9, False),
    "every cluster a primary": (1000, 1000, 2, 4, 0.0, False),
    "unaligned primary flags": (5000, 600, 2, 4, 0.9, True),
    "n = 1": (1, 0, 1, 1, 1.0, False),
}


def _k8_inputs(case):
    """The per-cluster arrays as ``hierarchical_aggregation`` holds them:
    centres in a 10 x 10 x 3 m room on a 1/64 m grid, random primaries and
    fragments, a class radius a cluster; the first two table slots share
    centre, class and batch (an exact tie), and a third of the fragments sit
    next to a random primary, in the table or beyond it. Returns (args,
    p_cap, the tie's fragments, the tie's first primary)."""
    n, n_prim, batches, classes, share, unaligned = K8_CASES[case]
    g = torch.Generator().manual_seed(4 + n + n_prim)
    p_cap = 128
    centers = torch.round(torch.rand((n, 3), generator=g) * torch.tensor([10.0, 10.0, 3.0]) * 64)
    centers = centers / 64
    cls = torch.randint(2, 2 + classes, (n,), generator=g, dtype=torch.int32)
    cbatch = torch.randint(0, batches, (n,), generator=g, dtype=torch.int32)
    primary = torch.zeros(n, dtype=torch.bool)
    primary[torch.randperm(n, generator=g)[:n_prim]] = True
    fragment = ~primary & (torch.rand(n, generator=g) < share)
    prims, frags = torch.nonzero(primary)[:, 0], torch.nonzero(fragment)[:, 0]
    near = frags[torch.rand(frags.shape[0], generator=g) < 1 / 3]
    if n_prim:
        src = prims[torch.randint(0, n_prim, (near.shape[0],), generator=g)]
        cls[near], cbatch[near] = cls[src], cbatch[src]
        centers[near] = centers[src] + torch.randint(-16, 17, (near.shape[0], 3),
                                                     generator=g) / 64
    tie, first = near[:0], -1
    if n_prim >= 2 and near.shape[0] >= 8:
        a, b = int(prims[0]), int(prims[1])
        centers[b], cls[b], cbatch[b] = centers[a].clone(), int(cls[a]), int(cbatch[a])
        tie = near[:8]
        cls[tie], cbatch[tie] = int(cls[a]), int(cbatch[a])
        centers[tie] = centers[a] + torch.tensor([1.0, 0.0, -1.0]) / 64
        first = a
    prim_prop = torch.where(primary, torch.cumsum(primary.long(), 0) + 9,
                            torch.full((n,), p_cap))
    size_f = torch.randint(1, 3000, (n,), generator=g).float()
    r_cls = torch.rand(n, generator=g) * 0.4 + 0.1
    if unaligned:
        primary = torch.cat([torch.zeros(1, dtype=torch.bool), primary])[1:]
    args = (centers, cls, cbatch, primary, fragment, prim_prop, size_f, r_cls)
    return args, p_cap, tie, first


@pytest.mark.parametrize("case", list(K8_CASES))
def test_set_aggregation_kernel_matches_plain(dev, case):
    """K8 on the per-cluster arrays against its plain version (the JAX
    lines' table by scatter, the (C, P2) matrix), bit for bit: one launch a
    call that builds the 512-slot table itself, no host sync; the exact tie
    goes to the first slot."""
    args, p_cap, tie, first = _k8_inputs(case)
    want = set_aggregation.set_aggregation_plain(*args, p_cap)
    dargs = [a.to(dev) for a in args]
    if case == "unaligned primary flags":
        dargs[3] = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), dargs[3]])[1:]
        assert dargs[3].data_ptr() % 16 == 1
    before = build.LAUNCHES["set_aggregation"]
    got, ops = _device_ops(lambda: set_aggregation.set_aggregation(*dargs, p_cap),
                           "ms3d_set_aggregation_device_ops")
    assert ops == 1 and build.LAUNCHES["set_aggregation"] == before + 1
    assert got.dtype == torch.int64
    assert torch.equal(got.cpu(), want)
    fragment, prim_prop = args[4], args[5]
    absorbed = fragment & (want < p_cap)
    assert bool(absorbed.any()) == (K8_CASES[case][1] > 0 and bool(fragment.any()))
    if first >= 0:
        assert bool((want[tie] == prim_prop[first]).all())


def _k8_clusters(g, c_cap: int = 2048, n: int = 40000):
    """A clustering as the HAIS heads hand it over: blobs of 2 batches and 4
    classes, 600 of them primaries (more than the table holds)."""
    sizes = torch.randint(1, 12, (c_cap,), generator=g)
    sizes[:600] = 40
    valid = torch.arange(c_cap) < c_cap - 100
    sizes = torch.where(valid, sizes, torch.zeros_like(sizes))
    pc = torch.repeat_interleave(torch.arange(c_cap), sizes)
    pc = torch.cat([pc, torch.full((n - pc.shape[0],), c_cap)])
    centre = torch.round(torch.rand((c_cap + 1, 3), generator=g) * 6 * 64) / 64
    cls_of = torch.randint(2, 6, (c_cap + 1,), generator=g)
    bid_of = torch.randint(0, 2, (c_cap + 1,), generator=g, dtype=torch.int32)
    shifted = centre[pc] + torch.randn((n, 3), generator=g) * 0.01
    z = torch.zeros((), dtype=torch.int64)
    clus = cluster.Clusters(pc, sizes, valid, valid.sum(), z, z, z)
    return clus, shifted, bid_of[pc], cls_of[pc], pc < c_cap


def test_hierarchical_aggregation_on_the_card_makes_no_host_sync(dev):
    """The whole ``hierarchical_aggregation``, set aggregation on, with 600
    primaries and 2048 clusters: rows, primaries_dropped and the kinds equal
    the CPU's bit for bit; one K8 launch and no host sync."""
    from minsu3d_tpu_torch.model import hais

    clus, shifted, bids, sem, active = _k8_clusters(torch.Generator().manual_seed(30))
    pna, ra = torch.full((20,), 100.0), torch.full((20,), 0.3)
    want = hais.hierarchical_aggregation(clus, shifted, bids, sem, active, pna, ra, 1024, True)
    dclus = cluster.Clusters(*(t.to(dev) for t in clus))
    args = [t.to(dev) for t in (shifted, bids, sem, active, pna, ra)]
    before = build.LAUNCHES["set_aggregation"]
    got, _ = _device_ops(lambda: hais.hierarchical_aggregation(dclus, *args, 1024, True),
                         "ms3d_set_aggregation_device_ops")
    assert build.LAUNCHES["set_aggregation"] == before + 1
    for k in ("point_idx", "prop_id", "valid", "n_proposals"):
        assert torch.equal(got[0][k].cpu(), want[0][k]), k
    assert int(got[1]) == int(want[1]) == 88
    for k, v in want[2].items():
        assert int(got[2][k]) == int(v), k
    assert int(want[2]["absorbed"]) > 0


# (points N, classes K, share of active pairs, pair cap); SoftGroup's main
# path: 57344 points x 18 classes, a few % active, cap 2N
PACK_CASES = {"empty": (0, 18, 0.5, 8), "all_false": (50000, 3, 0.0, 20000),
              "all_true": (50000, 3, 1.0, 20000),
              "main path shape, fewer than the cap": (57344, 18, 0.025, 114688),
              "main path shape, more than the cap": (57344, 18, 0.3, 114688),
              "cap_beyond_length": (5000, 1, 0.5, 9000),
              "N not a multiple of 32, several tiles a block": (600001, 18, 0.1, 1200002),
              "K = 1": (100000, 1, 0.4, 200000),
              "K = 1, several tiles a block": (9000001, 1, 0.3, 4000000),
              "cap 0": (3000, 5, 0.5, 0)}


@pytest.mark.parametrize("case", list(PACK_CASES))
def test_pack_pairs_kernel_matches_plain(dev, case):
    """K10's pair packing bit for bit against its plain version; one launch
    a call and no host sync."""
    g = torch.Generator().manual_seed(6)
    n, k, share, cap = PACK_CASES[case]
    active = torch.rand((n, k), generator=g) < share * torch.rand(k, generator=g) * 2
    if share in (0.0, 1.0):
        active[:] = bool(share)
    want = stable_partition.pack_pairs(active, cap)
    card = active.to(dev)
    before = build.LAUNCHES["stable_partition"]
    got, ops = _device_ops(lambda: stable_partition.pack_pairs(card, cap),
                           "ms3d_stable_partition_device_ops")
    assert ops == 1 and build.LAUNCHES["stable_partition"] == before + 1
    for name, x, w in zip(("point", "class", "valid", "dropped"), got, want):
        assert x.dtype == w.dtype and torch.equal(x.cpu(), w), name


def test_pack_pairs_kernel_reads_unaligned_flags(dev):
    """Flags whose first row does not start on a 16-byte boundary (a row
    slice of a larger matrix): the byte-load path, bit for bit."""
    g = torch.Generator().manual_seed(9)
    big = torch.rand((4001, 18), generator=g) < 0.2
    want = stable_partition.pack_pairs(big[1:], 6000)
    card = big.to(dev)[1:]
    assert card.data_ptr() % 16 != 0 and card.is_contiguous()
    got = stable_partition.pack_pairs(card, 6000)
    for x, w in zip(got, want):
        assert torch.equal(x.cpu(), w)


@pytest.mark.parametrize("share,r_cap", [(0.2, 200000), (0.6, 100000), (0.0, 5000),
                                         (0.5, 300000)])
def test_compact_rows_kernel_matches_plain(dev, share, r_cap):
    """K10 with compact_rows' gather epilogue (point_idx, prop_id and valid of
    the kept rows) bit for bit; one launch a call and no host sync."""
    g = torch.Generator().manual_seed(int(share * 10) + r_cap)
    r = 18 * 8192 + 5
    valid = torch.rand(r, generator=g) < share
    point_idx = torch.randint(0, 8192, (r,), generator=g)
    prop_id = torch.where(valid, torch.randint(0, 64, (r,), generator=g), torch.tensor(64))
    want = stable_partition.compact_rows(point_idx, prop_id, valid, r_cap)
    args = [t.to(dev) for t in (point_idx, prop_id, valid)]
    got, ops = _device_ops(lambda: stable_partition.compact_rows(*args, r_cap),
                           "ms3d_stable_partition_device_ops")
    assert ops == 1
    for x, w in zip(got, want):
        assert x.dtype == w.dtype and torch.equal(x.cpu(), w)


@pytest.mark.parametrize("n_classes", [1, 3, 18])
def test_proposal_rank_kernel_matches_plain_on_tied_keys(dev, n_classes):
    """K11 bit for bit on 16384 clusters and 114688 pairs (the SoftGroup
    main path's sizes) with sizes on the threshold; one launch a call and no
    host sync."""
    g = torch.Generator().manual_seed(7 + n_classes)
    c_cap, k, n_pairs, p_cap = 16384, 18, 114688, 128
    valid = torch.arange(c_cap) < 9000
    ccls = torch.where(valid, torch.randint(0, n_classes, (c_cap,), generator=g),
                       torch.full((c_cap,), -1)).int()
    pna = torch.tensor([100.0, 333.0, 3000.0])[torch.randint(0, 3, (k,), generator=g)]
    thr = torch.tensor(0.05) * pna[ccls.clamp(0, k - 1)]
    sizes = (torch.ceil(thr) + torch.randint(-1, 2, (c_cap,), generator=g)).long()
    pc = torch.randint(0, c_cap + 1, (n_pairs,), generator=g)
    pair_valid = torch.rand(n_pairs, generator=g) < 0.9
    for limit in (200, 128, 7):
        args = (ccls, sizes, valid, pna, 0.05, min(limit, p_cap), p_cap, pc, pair_valid)
        assert int(_check_proposal_rank(dev, args)[2]) > 0


def _check_proposal_rank(dev, args) -> tuple:
    want = proposal_rank.proposal_rank_plain(*args)
    dargs = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]
    before = build.LAUNCHES["proposal_rank"]
    got, ops = _device_ops(lambda: proposal_rank.proposal_rank(*dargs),
                           "ms3d_proposal_rank_device_ops")
    assert ops == 1 and build.LAUNCHES["proposal_rank"] == before + 1
    for name, w, k_ in zip(("prop_id", "valid", "n_proposals"), want, got):
        assert k_.dtype == w.dtype and k_.shape == w.shape, name
        assert torch.equal(k_.cpu(), w), name
    return want


# name: (clusters, classes k, key classes, pairs, p_cap, limit, share valid)
K11_CASES = {
    "40960 clusters, above the old one-block cap": (40960, 18, 3, 120000, 65536, 20000, 0.9),
    "all 18 classes, 60% valid": (16384, 18, 18, 114688, 128, 128, 0.6),
    "100 clusters, fewer than the grid's blocks": (100, 18, 5, 3000, 128, 128, 0.9),
    "k = 1": (5000, 1, 1, 20000, 4096, 4096, 0.9),
    "k = 126, the most classes": (20000, 126, 126, 50000, 65536, 60000, 0.9),
    "no valid cluster": (5000, 18, 18, 20000, 128, 128, 0.0),
    "no pair": (5000, 18, 18, 0, 128, 128, 0.9),
    "no cluster": (0, 18, 18, 1000, 128, 128, 0.9),
}


@pytest.mark.parametrize("case", list(K11_CASES))
def test_proposal_rank_kernel_cases(dev, case):
    """K11 against its plain version, bit for bit, with a proposal cap that
    shows every rank below the limit: above the old 32768-cluster cap, at
    grids with empty blocks, one class and the most classes, and with
    nothing to rank; one launch, no host sync."""
    c_cap, k, key_classes, n_pairs, p_cap, limit, share = K11_CASES[case]
    g = torch.Generator().manual_seed(40 + c_cap + k)
    valid = torch.rand(c_cap, generator=g) < share
    ccls = torch.where(valid, torch.randint(0, key_classes, (c_cap,), generator=g),
                       torch.full((c_cap,), -1)).int()
    pna = torch.tensor([100.0, 333.0, 3000.0])[torch.randint(0, 3, (k,), generator=g)]
    thr = torch.tensor(0.05) * pna[ccls.clamp(0, k - 1)]
    sizes = (torch.ceil(thr) + torch.randint(-1, 2, (c_cap,), generator=g)).long()
    pc = torch.randint(0, c_cap + 1, (n_pairs,), generator=g)
    pair_valid = torch.rand(n_pairs, generator=g) < 0.9
    want = _check_proposal_rank(dev, (ccls, sizes, valid, pna, 0.05, limit, p_cap, pc,
                                      pair_valid))
    if case.startswith("40960"):   # ranks past the old cap, and the limit cuts
        assert bool(want[1][pc >= 32768].any()) and int(want[2]) == limit


def test_softgroup_ranking_step_makes_no_host_sync(dev):
    """SoftGroup's packed grouping on the card, from the pair packing to the
    ranked rows (K10, the clustering, K6's cluster class, K11), with the
    class ids and mean sizes read from the device constants: rows and diag
    equal the CPU's, and the call makes no host sync once the constants
    exist."""
    from minsu3d_tpu_torch.config import SoftGroupEvalConfig, StaticCaps
    from minsu3d_tpu_torch.model import general_model as gm
    from minsu3d_tpu_torch.model import softgroup

    cfg = SoftGroupEvalConfig()
    caps = StaticCaps.from_cfg(cfg)
    fg = tuple(range(2, 20))
    coords, batch, valid, group = _blob_points(torch.Generator().manual_seed(31), 6000)
    g = torch.Generator().manual_seed(32)
    soft = torch.softmax(torch.randn((6000, 20), generator=g) * 3, dim=1)
    soft[torch.arange(6000), 2 + group.long()] += 1.0
    soft = soft / soft.sum(1, keepdim=True)
    p2v = torch.arange(6000, dtype=torch.int32)
    pna = torch.full((20,), 60.0)

    def call(d, tensors):
        soft_, coords_, batch_, valid_, p2v_ = tensors
        return softgroup.soft_grouping_packed(
            soft_, coords_, batch_, valid_, fg, 0.2, 0.04, 0.05,
            gm.device_constant(pna.tolist(), torch.float32, d), 50, 200, caps, p2v_,
            pair_cap=12000)

    inputs = (soft, coords, batch, valid, p2v)
    want = call(torch.device("cpu"), inputs)
    on_card = [t.to(dev) for t in inputs]
    call(dev, on_card)                           # builds the device constants
    before = build.LAUNCHES["proposal_rank"]
    got, _ = _device_ops(lambda: call(dev, on_card), "ms3d_proposal_rank_device_ops")
    assert build.LAUNCHES["proposal_rank"] == before + 1
    for k in ("point_idx", "prop_id", "valid", "n_proposals"):
        assert torch.equal(got[0][k].cpu(), want[0][k]), k
    for k, v in want[1].items():
        assert int(got[1][k]) == int(v), k
    assert int(want[0]["n_proposals"]) > 0


def _rows(g, n, p_cap):
    prop = torch.randint(0, p_cap + p_cap // 3 + 1, (2 * n,), generator=g)
    valid = prop < p_cap
    return {"point_idx": torch.arange(n).repeat(2), "prop_id": prop.clamp(max=p_cap),
            "valid": valid, "n_proposals": torch.tensor(p_cap)}


def _check_iou(dev, rows, p_cap, inst, num, i_cap, mask) -> torch.Tensor:
    """K5 against its plain version, bit for bit: one launch, no memset and
    no host sync a call. Returns the plain IoUs."""
    want = instance_iou.get_iou(rows, p_cap, inst, num, i_cap, mask)
    drows = {k: v.to(dev) for k, v in rows.items()}
    args = (drows, p_cap, inst.to(dev), num.to(dev), i_cap, None if mask is None else mask.to(dev))
    before = build.LAUNCHES["proposal_iou"]
    got, ops = _device_ops(lambda: instance_iou.get_iou(*args), "ms3d_proposal_iou_device_ops")
    assert ops == 1 and build.LAUNCHES["proposal_iou"] == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    return want


@pytest.mark.parametrize("keep", ["none", "random", "nothing"])
def test_proposal_iou_kernel_with_row_keep_matches_plain(dev, keep):
    g = torch.Generator().manual_seed(8)
    n, p_cap, i_cap = 20000, 128, 64
    rows = _rows(g, n, p_cap)
    inst = torch.randint(-1, i_cap - 4, (n,), generator=g)
    num = torch.bincount(inst[inst >= 0], minlength=i_cap).to(torch.int32)
    r = rows["valid"].shape[0]
    mask = {"none": None, "random": torch.rand(r, generator=g) < 0.6,
            "nothing": torch.zeros(r, dtype=torch.bool)}[keep]
    _check_iou(dev, rows, p_cap, inst, num, i_cap, mask)


def _heads_rows(seed: int, p: int, i_cap: int, n: int = 40000, shuffled: bool = False,
                dtype=torch.int32) -> tuple:
    """Rows as the heads write them: int64 point_idx and prop_id, each
    proposal's rows together (a run of points sorted by instance), then
    invalid rows at prop_id P; ``shuffled`` permutes the same rows.
    Instance ids, sizes and classes of ``dtype``, the ids with -1 and ids
    at I and above. Returns (rows, inst, num, cls)."""
    g = torch.Generator().manual_seed(seed)
    inst = torch.randint(-1, i_cap + 4, (n,), generator=g)
    order = torch.argsort(inst, stable=True)
    starts = torch.randint(0, n - 600, (p,), generator=g).tolist()
    lens = torch.randint(1, 600, (p,), generator=g)
    point_idx = torch.cat([order[s:s + k] for s, k in zip(starts, lens.tolist())])
    prop_id = torch.repeat_interleave(torch.arange(p), lens)
    pad = point_idx.shape[0] // 4
    point_idx = torch.cat([point_idx, torch.randint(0, n, (pad,), generator=g)])
    prop_id = torch.cat([prop_id, torch.full((pad,), p)])
    if shuffled:
        perm = torch.randperm(point_idx.shape[0], generator=g)
        point_idx, prop_id = point_idx[perm], prop_id[perm]
    rows = {"point_idx": point_idx, "prop_id": prop_id, "valid": prop_id < p,
            "n_proposals": torch.tensor(p)}
    num = torch.bincount(inst[(inst >= 0) & (inst < i_cap)], minlength=i_cap).to(dtype)
    cls = torch.where(torch.arange(i_cap) % 7 == 3, -1, torch.randint(0, 18, (i_cap,),
                                                                      generator=g))
    return rows, inst.to(dtype), num, cls.to(dtype)


K5_ROW_CASES = [(p, order, dt) for p in (128, 512, 1024) for order in ("grouped", "shuffled")
                for dt in (torch.int16, torch.int32, torch.int64)]


@pytest.mark.parametrize("p_cap,order,dtype", K5_ROW_CASES,
                         ids=[f"P{p}-{o}-{str(d).split('.')[-1]}" for p, o, d in K5_ROW_CASES])
def test_proposal_iou_kernel_on_heads_rows(dev, p_cap, order, dtype):
    """K5 on rows as the heads write them and on the same rows shuffled, at
    P 128, 512 (one block's shared histogram) and 1024 (two proposal
    ranges), with int64 rows and int16 / int32 / int64 ids and sizes: with
    every row, a random row mask and one that keeps nothing."""
    i_cap = 64
    rows, inst, num, _ = _heads_rows(20 + p_cap, p_cap, i_cap, shuffled=order == "shuffled",
                                     dtype=dtype)
    r = rows["valid"].shape[0]
    g = torch.Generator().manual_seed(21)
    full = _check_iou(dev, rows, p_cap, inst, num, i_cap, None)
    assert float(full.max()) >= 0.5
    _check_iou(dev, rows, p_cap, inst, num, i_cap, torch.rand(r, generator=g) < 0.6)
    nothing = _check_iou(dev, rows, p_cap, inst, num, i_cap, torch.zeros(r, dtype=torch.bool))
    assert float(nothing.max()) == 0.0


def _check_mask_label(dev, rows, p_cap, inst, cls, ious, thr) -> tuple:
    """K12's get_mask_label against its plain version, bit for bit: one
    launch and no host sync a call. Returns the plain (label, row_ok)."""
    want = instance_iou.get_mask_label(rows, p_cap, inst, cls, ious, thr)
    args = ({k: v.to(dev) for k, v in rows.items()}, p_cap, inst.to(dev), cls.to(dev),
            ious.to(dev), thr)
    before = build.LAUNCHES["mask_label"]
    got, ops = _device_ops(lambda: instance_iou.get_mask_label(*args),
                           "ms3d_mask_label_device_ops")
    assert ops == 1 and build.LAUNCHES["mask_label"] == before + 1
    for name, w, k in zip(("label", "row_ok"), want, got):
        assert k.dtype == w.dtype and torch.equal(k.cpu(), w), name
    return want


def _check_argmax(dev, ious, mask, thr) -> tuple:
    """K12's phase 1 alone against its plain version: one launch, no sync."""
    want = instance_iou.proposal_argmax(ious, mask, thr)
    d_ious, d_mask = ious.to(dev), mask.to(dev)
    before = build.LAUNCHES["mask_label"]
    got, ops = _device_ops(lambda: instance_iou.proposal_argmax(d_ious, d_mask, thr),
                           "ms3d_mask_label_device_ops")
    assert ops == 1 and build.LAUNCHES["mask_label"] == before + 1
    for name, w, k in zip(("max", "arg", "ok"), want, got):
        k = k.cpu()
        assert k.dtype == w.dtype, name
        if w.dtype == torch.float32:   # bit for bit: NaN equals its own bits
            k, w = k.view(torch.int32), w.view(torch.int32)
        assert torch.equal(k, w), name
    return want


K12_ROW_CASES = [(order, dt) for order in ("grouped", "shuffled")
                 for dt in (torch.int16, torch.int32, torch.int64)]


@pytest.mark.parametrize("order,dtype", K12_ROW_CASES,
                         ids=[f"{o}-{str(d).split('.')[-1]}" for o, d in K12_ROW_CASES])
def test_mask_label_kernel_on_heads_rows(dev, order, dtype):
    """K12 on the IoUs of rows as the heads write them (P 128 and 512, I 64),
    grouped and shuffled, int64 rows and int16 / int32 / int64 ids and
    classes, invalid rows at prop_id P; phase 1 alone over the classes'
    column mask."""
    for p_cap in (128, 512):
        rows, inst, num, cls = _heads_rows(30 + p_cap, p_cap, 64, shuffled=order == "shuffled",
                                           dtype=dtype)
        ious = instance_iou.get_iou(rows, p_cap, inst, num, 64)
        label, row_ok = _check_mask_label(dev, rows, p_cap, inst, cls, ious, 0.5)
        assert bool(label.any()) and bool((row_ok & ~label).any())
        assert not bool(row_ok[~rows["valid"]].any())
        ok = _check_argmax(dev, ious, cls != -1, 0.5)[2]
        assert bool(ok.any()) and not bool(ok.all())


def _crafted_ious():
    """Proposal 0: unmasked IoUs all 0, column 0 masked; 1: a tie; 2: exactly
    0.5; 3: the largest IoU in a masked column; 4: the f32 below 0.5; 5: a
    tie at 0.5; 6: all zero; then IoUs on a grid of quarters (ties)."""
    below = torch.nextafter(torch.tensor(0.5), torch.tensor(0.0)).item()
    head = torch.tensor([[0.8, 0.0, 0.0, 0.0, 0.3], [0.1, 0.7, 0.2, 0.7, 0.0],
                         [0.0, 0.1, 0.5, 0.2, 0.0], [0.0, 0.3, 0.1, 0.2, 0.9],
                         [0.0, 0.1, below, 0.2, 0.0], [0.0, 0.1, 0.5, 0.5, 0.0],
                         [0.0] * 5])
    g = torch.Generator().manual_seed(9)
    ious = torch.randint(0, 5, (128, 64), generator=g).float() / 4
    ious[:7] = 0.0
    ious[:7, :5] = head
    mask = torch.rand(64, generator=g) < 0.7
    mask[:5] = torch.tensor([False, True, True, True, False])
    return ious, mask


def test_mask_label_argmax_kernel_matches_plain(dev):
    ious, mask = _crafted_ious()
    got = _check_argmax(dev, ious, mask, 0.5)
    assert got[1][:7].tolist() == [0, 1, 2, 1, 2, 2, 0]


def test_mask_label_kernel_matches_plain(dev):
    """Invalid rows read proposal P-1's verdict and stay unsupervised."""
    ious, mask = _crafted_ious()
    p_cap, i_cap = ious.shape
    ious[p_cap - 1] = 0.0
    ious[p_cap - 1, 1] = 0.75
    g = torch.Generator().manual_seed(10)
    n = 30000
    rows = _rows(g, n, p_cap)
    inst = torch.randint(-1, i_cap, (n,), generator=g)
    cls = torch.where(mask, torch.randint(0, 18, (i_cap,), generator=g), torch.full((i_cap,), -1))
    want = _check_mask_label(dev, rows, p_cap, inst, cls, ious, 0.5)
    assert not bool(want[1][~rows["valid"]].any())
    assert bool(want[0].any()) and bool((want[1] & ~want[0]).any())


def test_mask_label_kernel_on_nans_and_empty_calls(dev):
    """NaN IoUs (the largest value, the first NaN wins), a proposal of
    masked columns only, a call with no rows, and a one-column call."""
    ious, mask = _crafted_ious()
    ious[7, 3] = float("nan")
    ious[8, 10] = float("nan")
    ious[8, 2] = float("nan")
    ious[9] = float("nan")
    got = _check_argmax(dev, ious, mask, 0.5)
    assert torch.isnan(got[0][7]) and torch.isnan(got[0][8])
    _check_argmax(dev, ious, torch.zeros_like(mask), 0.5)
    _check_argmax(dev, ious[:, :1].contiguous(), mask[:1], 0.0)
    empty = {"point_idx": torch.zeros(0, dtype=torch.int64),
             "prop_id": torch.zeros(0, dtype=torch.int64),
             "valid": torch.zeros(0, dtype=torch.bool), "n_proposals": torch.tensor(0)}
    cls = torch.where(mask, 3, -1)
    _check_mask_label(dev, empty, ious.shape[0], torch.zeros(5, dtype=torch.int32), cls, ious,
                      0.5)


def test_instance_kernels_take_int64_rows(dev):
    """K5 and K12 read the rows as the heads write them, int64: rows of
    another dtype raise before any launch."""
    g = torch.Generator().manual_seed(12)
    rows = {k: v.to(dev) for k, v in _rows(g, 1000, 128).items()}
    narrow = dict(rows, point_idx=rows["point_idx"].to(torch.int32),
                  prop_id=rows["prop_id"].to(torch.int32))
    inst = torch.randint(-1, 64, (1000,), generator=g).to(dev)
    num = torch.bincount(inst[inst >= 0].cpu(), minlength=64).to(dev)
    cls = torch.full((64,), 3, device=dev)
    ious = instance_iou.get_iou(rows, 128, inst, num, 64)
    before = (build.LAUNCHES["proposal_iou"], build.LAUNCHES["mask_label"])
    with pytest.raises(TypeError, match="int64"):
        instance_iou.get_iou(narrow, 128, inst, num, 64)
    with pytest.raises(TypeError, match="int64"):
        instance_iou.get_mask_label(narrow, 128, inst, cls, ious, 0.5)
    assert (build.LAUNCHES["proposal_iou"], build.LAUNCHES["mask_label"]) == before


def test_gather_gemm_bf16_kernel_matches_plain(dev):
    g = torch.Generator().manual_seed(11)
    n, rows, taps, cin, cout = 5000, 4000, 27, 40, 24
    x = torch.randn((n, cin), generator=g).to(torch.bfloat16)
    idx = torch.randint(0, n + 1, (rows, taps), generator=g, dtype=torch.int32)
    idx[torch.rand((rows, taps), generator=g) < 0.7] = n            # 70% absent taps
    w = (torch.randn((taps, cin, cout), generator=g) * 0.05).to(torch.bfloat16)
    want = sparse_conv.gather_gemm(x, idx, w)
    before = build.LAUNCHES["gather_gemm_bf16"]
    got = sparse_conv.gather_gemm(x.to(dev), idx.to(dev), w.to(dev))
    assert build.LAUNCHES["gather_gemm_bf16"] == before + 1
    assert got.dtype == torch.bfloat16
    g32, w32 = got.cpu().float(), want.float()
    diff = (g32 - w32).abs()
    mag = torch.maximum(g32.abs(), w32.abs())
    ulp = torch.where(mag > 0, torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8),
                      torch.zeros_like(mag))
    scale = max(float(w32.abs().max()), 1.0)
    assert bool(((diff <= ulp) | (diff <= 1e-5 * scale)).all())
    assert float((diff > 0).float().mean()) < 0.01


def _subm_table(n_vox: int, side: int, seed: int, cap: int) -> torch.Tensor:
    """A symmetric (cap, 27) subm table of n_vox random voxels in a side^3
    grid (taps in KERNEL_OFFSETS order: tap k's offset is minus tap 26 - k's),
    cap = absent; rows n_vox..cap-1 are past the count (all absent), and
    voxel 0 sits in a full 3x3x3 block, so it has all 27 taps."""
    g = torch.Generator().manual_seed(seed)
    occ = torch.zeros((side,) * 3, dtype=torch.bool)
    occ[1:4, 1:4, 1:4] = True
    flat = torch.randperm(side ** 3, generator=g)
    occ.view(-1)[flat[:n_vox]] = True
    coords = occ.nonzero()
    center = torch.tensor([2, 2, 2])
    first = int(((coords == center).all(1)).nonzero()[0, 0])
    coords = torch.cat([coords[first:first + 1], coords[:first], coords[first + 1:]])
    n = coords.shape[0]
    assert n <= cap
    grid = torch.full((side + 2,) * 3, cap, dtype=torch.int32)
    grid[coords[:, 0] + 1, coords[:, 1] + 1, coords[:, 2] + 1] = torch.arange(n, dtype=torch.int32)
    offs = torch.tensor([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)])
    nb = coords[:, None, :] + 1 + offs[None]
    idx = torch.full((cap, 27), cap, dtype=torch.int32)
    idx[:n] = grid[nb[..., 0], nb[..., 1], nb[..., 2]]
    return idx


# K1 cases: (source rows, table, cin, cout). The subm tables hold row counts
# that are no multiple of a 16-row tile, rows past the count and a row with
# all 27 taps; "absent" is a table with every tap absent. The kernel picks
# its tile layout from the shape, and the cases reach each one: 8 warps
# sharing a tile's taps on subm tables of at most 12288 rows, 4 on larger
# ones ("large"), a warp a tile on the 8-tap k2s2 tables ("down", "up").
K1_CASES = {
    "input 27x6->16": (1003, "subm", 6, 16),
    "subm 27x16->16": (1003, "subm", 16, 16),
    "subm 27x224->224": (301, "subm", 224, 224),
    "tail 27x96->48": (517, "subm", 96, 48),
    "ragged 27x40->24": (700, "subm", 40, 24),
    "large 27x32->32": (12800, "subm", 32, 32),
    "down 8x32->64": (900, "down", 32, 64),
    "up 8x64->32": (300, "up", 64, 32),
    "absent 27x16->32": (257, "absent", 16, 32),
}


def _k1_case(name: str, dtype, seed: int = 5):
    n, kind, cin, cout = K1_CASES[name]
    g = torch.Generator().manual_seed(seed)
    idx = _case_table(n, kind, g, seed)
    x = torch.randn((n, cin), generator=g).to(dtype)
    w = (torch.randn((idx.shape[1], cin, cout), generator=g) * (1.0 / (27 * cin)) ** 0.5)
    return x, idx, w.to(dtype)


def _case_table(n: int, kind: str, g, seed: int) -> torch.Tensor:
    """A table over n source rows (n = absent) of the kind of a K1 case."""
    if kind == "subm":
        side = max(14, round((1.6 * n) ** (1 / 3)) + 1)
        idx = _subm_table(n - 40, side, seed, n)
    elif kind == "down":
        rows = n // 3
        idx = torch.full((rows, 8), n, dtype=torch.int32)
        kid = torch.randint(0, 8, (n,), generator=g)
        parent = torch.randint(0, rows - 10, (n,), generator=g)
        idx[parent, kid] = torch.arange(n, dtype=torch.int32)
    elif kind == "up":   # one live tap a child row, the last 50 rows past the count
        idx = torch.full((3 * n, 8), n, dtype=torch.int32)
        kid = torch.randint(0, 8, (3 * n - 50,), generator=g)
        idx[torch.arange(3 * n - 50), kid] = torch.randint(0, n, (3 * n - 50,), generator=g,
                                                           dtype=torch.int32)
    else:
        idx = torch.full((n, 27), n, dtype=torch.int32)
    return idx


def _within_k1_tolerance(got: torch.Tensor, want: torch.Tensor) -> None:
    """f32: within 1e-5 of the output scale; bf16: every element within one
    bf16 ulp of the larger magnitude or within 1e-5 of the scale (a
    cancelling sum), under 1% of the elements differing."""
    g32, w32 = got.cpu().float(), want.float()
    diff = (g32 - w32).abs()
    scale = max(float(w32.abs().max()), 1.0)
    if got.dtype == torch.float32:
        assert float(diff.max()) <= 1e-5 * scale, float(diff.max())
        return
    mag = torch.maximum(g32.abs(), w32.abs())
    ulp = torch.where(mag > 0, torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8),
                      torch.zeros_like(mag))
    assert bool(((diff <= ulp) | (diff <= 1e-5 * scale)).all())
    assert float((diff > 0).float().mean()) < 0.01


@pytest.mark.parametrize("case", list(K1_CASES))
def test_gather_gemm_f32_kernel_matches_plain(dev, case):
    x, idx, w = _k1_case(case, torch.float32)
    want = sparse_conv.gather_gemm(x, idx, w)
    xd, idd, wd = x.to(dev), idx.to(dev), w.to(dev)
    order = sparse_conv.tap_order(idd, x.shape[0])
    got = sparse_conv.gather_gemm(xd, idd, wd, order)
    again = sparse_conv.gather_gemm(xd, idd, wd, order)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _within_k1_tolerance(got, want)
    assert torch.equal(got, again)                      # bit for bit, call to call
    if case.startswith("absent"):
        assert not bool(got.any())


@pytest.mark.parametrize("case", list(K1_CASES))
def test_gather_gemm_bf16_kernel_matches_plain_at_main_path_shapes(dev, case):
    x, idx, w = _k1_case(case, torch.bfloat16)
    want = sparse_conv.gather_gemm(x, idx, w)
    before = build.LAUNCHES["gather_gemm_bf16"]
    got = sparse_conv.gather_gemm(x.to(dev), idx.to(dev), w.to(dev))
    again = sparse_conv.gather_gemm(x.to(dev), idx.to(dev), w.to(dev))
    assert build.LAUNCHES["gather_gemm_bf16"] == before + 2
    assert got.dtype == torch.bfloat16
    _within_k1_tolerance(got, want)
    assert torch.equal(got, again)


def test_gather_conv_f32_dx_on_a_symmetric_table_matches_cpu(dev):
    """The f32 input gradient of a subm conv: K1 over the table itself (its
    own TapOrder) with the taps flipped, against the CPU's plain backward."""
    x, idx, w = _k1_case("subm 27x16->16", torch.float32)
    w = w[:, :, :8].contiguous()
    g = torch.Generator().manual_seed(9)
    dout = torch.randn((idx.shape[0], 8), generator=g)

    def run(device):
        xd = x.detach().clone().to(device).requires_grad_()
        wd = w.detach().clone().to(device).requires_grad_()
        idd = idx.to(device)
        order = sparse_conv.tap_order(idd, x.shape[0])
        out = sparse_conv.GatherConv.apply(xd, wd, idd, idd, True, order, order)
        out.backward(dout.to(device))
        return xd.grad, wd.grad

    dx, dw = run("cpu")
    before = build.LAUNCHES["gather_gemm"]
    dx_d, dw_d = run(dev)
    assert build.LAUNCHES["gather_gemm"] == before + 2   # forward and dx
    _within_k1_tolerance(dx_d, dx)
    _within_k1_tolerance(dw_d, dw)
    assert torch.equal(dx_d, run(dev)[0])


def _tap_tables(sizes, seed: int = 3) -> list:
    """(idx, n_rows) tables of the given (rows, taps, live share) sizes:
    random live sources below n_rows, absent entries n_rows."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for rows, taps, live in sizes:
        n = max(rows, 1)
        src = torch.randint(0, n, (rows, taps), generator=g, dtype=torch.int32)
        keep = torch.rand((rows, taps), generator=g) < live
        out.append((torch.where(keep, src, torch.full_like(src, n)), n))
    return out


# K22 cases: the PointGroup plan's kinds of table (27-tap kernel maps with
# 3-11 live taps a row, 8-tap k2s2 tables with one or a few), an empty
# table, an all-absent one; totals on both sides of K15's one-block limit
TAP_CASES = {
    "plan-like": [(20000, 27, 0.15), (9000, 27, 0.4), (9000, 8, 0.3), (20000, 8, 0.12),
                  (0, 27, 0.5), (700, 27, 0.0), (3000, 27, 1.0)],
    "one table": [(98304, 27, 0.05)],
    "small": [(1000, 27, 0.2), (513, 8, 0.12), (17, 27, 0.9)],
    "32 tables": [(300 + 37 * i, 27 if i % 3 else 8, 0.05 * (i % 7)) for i in range(32)],
}


@pytest.mark.parametrize("case", list(TAP_CASES))
def test_tap_orders_kernel_matches_plain(dev, case):
    """K22 against one stable sort a table, bit for bit, in one launch."""
    tables = _tap_tables(TAP_CASES[case])
    want = sparse_conv.tap_orders_plain(tables)
    before = build.LAUNCHES["tap_orders"]
    on_dev = [(idx.to(dev), n) for idx, n in tables]
    got = sparse_conv.tap_orders(on_dev)
    assert build.LAUNCHES["tap_orders"] == before + 1
    for (idx, n), g, w in zip(on_dev, got, want):
        assert g.table is idx and g.n_rows == n
        assert torch.equal(g.perm.cpu(), w.perm) and torch.equal(g.key.cpu(), w.key)
    again = sparse_conv.tap_orders(on_dev)
    assert all(torch.equal(a.perm, b.perm) for a, b in zip(got, again))


def test_tap_orders_rejects_what_the_kernel_cannot_take(dev):
    idx = torch.zeros(64, 27, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        sparse_conv.tap_orders([(idx[:, ::2], 64)])             # not contiguous
    with pytest.raises(ValueError):
        sparse_conv.tap_orders([(idx, 64)] * 33)                 # more than 32 tables


def _plan_like(caps, case: str, seed: int = 9):
    """A grid plan at ``caps`` made from a seed: per level two fifths of
    the rows valid, kernel maps with a third of the taps live (row 0 all 27,
    the invalid rows none) and each valid child at a distinct (parent, kid)
    of the next level's valid rows; the invalid rows' links are noise.
    "edge": one level with no valid row, one whose kernel map is all
    absent, and children whose parent lies past the parent cap."""
    from minsu3d_tpu_torch.ops.sparse import GridPlan, Level

    g = torch.Generator().manual_seed(seed)
    counts = [0 if case == "edge" and l == 2 else cap * 2 // 5 for l, cap in enumerate(caps)]
    levels = []
    for l, (cap, count) in enumerate(zip(caps, counts)):
        valid = torch.arange(cap) < count
        src = torch.randint(0, max(count, 1), (cap, 27), generator=g, dtype=torch.int32)
        live = (torch.rand((cap, 27), generator=g) < 0.33) & valid[:, None]
        live[0] = count > 0
        if case == "edge" and l == 1:
            live[:] = False
        nbr = torch.where(live, src, torch.full_like(src, cap))
        parent = kid = None
        if l + 1 < len(caps):
            noise = torch.randint(0, 2 * caps[l + 1], (cap,), generator=g, dtype=torch.int32)
            slots = torch.randperm(max(counts[l + 1], 1) * 8, generator=g)[:cap].to(torch.int32)
            slots = torch.cat([slots, slots.new_zeros(cap - slots.shape[0])])
            parent = torch.where(valid, slots // 8, noise)
            kid = torch.where(valid, slots % 8, noise % 8)
            if counts[l + 1] == 0 or (case == "edge" and l == 0):
                over = valid & (torch.rand(cap, generator=g) < (1.0 if counts[l + 1] == 0
                                                               else 0.2))
                parent = torch.where(over, caps[l + 1] + noise % 7, parent)
        levels.append(Level(valid=valid, n_dropped=torch.zeros((), dtype=torch.int32),
                            nbr_idx=nbr.contiguous(), parent_idx=parent, child_kid=kid))
    return GridPlan(tuple(levels))


def _plan_to(plan, dev):
    return type(plan)(tuple(lv._replace(**{k: getattr(lv, k).to(dev) for k in (
        "valid", "n_dropped", "nbr_idx", "parent_idx", "child_kid")
        if getattr(lv, k) is not None}) for lv in plan.levels))


# level capacities of the PointGroup (m=16) and HAIS eval backbones, and a
# small plan with the edge cases
CONV_TABLE_PLANS = {"PointGroup": [98304, 49152, 24576, 12288, 6144, 3072, 1536],
                    "HAIS": [65536, 32768, 16384, 8192, 4096, 2048, 1024],
                    "edge": [5000, 2600, 1200, 700, 300]}


@pytest.mark.parametrize("plan_name", list(CONV_TABLE_PLANS))
def test_conv_tables_are_one_launch_equal_to_the_plain_tables(dev, plan_name):
    """``conv_tables`` on the card: one K22 launch and the memset of its
    histograms (no other op on the card, no host sync) build every k2s2
    table equal to ``down_index`` / ``up_index`` and order all 3L - 2 tables
    equal to ``tap_orders_plain``, bit for bit, on the eval backbones' plan
    shapes and on a plan with a level of no valid row, an all-absent kernel
    map and parents past the cap; each order holds its table."""
    plan = _plan_like(CONV_TABLE_PLANS[plan_name], plan_name)
    want = sparse_conv.conv_tables(plan)
    plan_d = _plan_to(plan, dev)
    before = build.LAUNCHES["tap_orders"]
    got, ops = _device_ops(lambda: sparse_conv.conv_tables(plan_d),
                           "ms3d_tap_tables_device_ops")
    assert ops == 2 and build.LAUNCHES["tap_orders"] == before + 1   # a memset and a launch
    ops_run = _torch_ops(lambda: sparse_conv.conv_tables(plan_d))
    assert ops_run <= NO_KERNEL_OPS, ops_run - NO_KERNEL_OPS
    n = len(plan.levels)
    assert len(got) == n and got[-1].links is None
    for lvl, (g, w, lv) in enumerate(zip(got, want, plan_d.levels)):
        orders = [(g.nbr_order, w.nbr_order)]
        assert g.nbr_order.table is lv.nbr_idx and g.nbr_order.n_rows == lv.cap
        if lvl + 1 < n:
            gl, wl = g.links, w.links
            assert torch.equal(gl.down.cpu(), wl.down) and torch.equal(gl.up.cpu(), wl.up)
            assert gl.down_order.table is gl.down and gl.up_order.table is gl.up
            orders += [(gl.down_order, wl.down_order), (gl.up_order, wl.up_order)]
        for go, wo in orders:
            assert go.n_rows == wo.n_rows
            assert torch.equal(go.perm.cpu(), wo.perm) and torch.equal(go.key.cpu(), wo.key)
    if plan_name == "edge":
        dropped = plan.levels[0].valid & (plan.levels[0].parent_idx >= plan.levels[1].cap)
        assert bool(dropped.any()) and not bool(plan.levels[2].valid.any())
    again = sparse_conv.conv_tables(plan_d)
    assert all(torch.equal(a.nbr_order.perm, b.nbr_order.perm) for a, b in zip(got, again))


@pytest.mark.parametrize("case", ["copy", "same_shape", "shorter", "edited"])
def test_gather_gemm_rejects_a_tap_order_of_another_table(dev, case):
    """An order of an equal copy, of a same-shaped other table, of a shorter
    one, or of the table itself before an in-place edit is refused before
    any launch."""
    x, idx, w = _k1_case("subm 27x16->16", torch.float32)
    idd = idx.to(dev)
    other = {"copy": idd.clone(), "same_shape": idd.flip(0).contiguous(),
             "shorter": idd[:-16].contiguous(), "edited": idd}[case]
    order = sparse_conv.tap_order(other, x.shape[0])
    if case == "edited":
        idd[0, 0] = x.shape[0]
    before = build.LAUNCHES["gather_gemm"]
    with pytest.raises(ValueError, match="tap order|changed in place"):
        sparse_conv.gather_gemm(x.to(dev), idd, w.to(dev), order)
    assert build.LAUNCHES["gather_gemm"] == before


@pytest.mark.parametrize("op", ["max", "min", "sum"])
def test_segment_reduce_bf16_kernel_matches_plain(dev, op):
    """bf16 max and min (ties), and the bf16 sum rounded after every add in
    row order (magnitudes over 12 binades, so the order shows)."""
    g = torch.Generator().manual_seed(12)
    rows, n_seg, c = 20000, 300, 19
    seg = torch.randint(0, n_seg + 1, (rows,), generator=g)
    seg[:3000] = 5
    seg[seg == 7] = n_seg
    x = (torch.randint(-50, 50, (rows, c), generator=g) / 8.0)   # ties
    if op == "sum":
        x = torch.randn((rows, c), generator=g) * 2.0 ** torch.randint(-6, 6, (rows, 1),
                                                                        generator=g)
    x = x.to(torch.bfloat16)
    cpu, card = _csr_pair(seg, n_seg, dev)
    want = segment.segment_reduce(x, cpu, op, 0.0)
    count = "segment_reduce_bf16_sum" if op == "sum" else "segment_reduce_bf16"
    before = build.LAUNCHES[count]
    got = segment.segment_reduce(x.to(dev), card, op, 0.0)
    assert build.LAUNCHES[count] == before + 1
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))
    if op == "sum":   # the card's plain version repeats the chain too
        plain = segment.segment_reduce_plain(x.to(dev), card, op)
        assert torch.equal(plain.cpu().view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("kind", ["subm", "down", "up"])
def test_gather_dx_bf16_kernel_matches_plain(dev, kind):
    """K13 bit for bit against its plain version, on the card and on the
    CPU: 27 taps with about a third live, or 8 taps with one live per row
    (down conv's dx) or up to 8 (up conv's dx); absent taps read R."""
    g = torch.Generator().manual_seed(14)
    n, r, cin, cout = 3000, 2500, 24, 40
    taps = 27 if kind == "subm" else 8
    idx = torch.randint(0, r, (n, taps), generator=g, dtype=torch.int32)
    keep = torch.rand((n, taps), generator=g) < {"subm": 0.35, "down": 0.0, "up": 0.6}[kind]
    if kind == "down":
        keep[torch.arange(n), torch.randint(0, taps, (n,), generator=g)] = True
    idx = torch.where(keep, idx, torch.full_like(idx, r))
    dout = (torch.randn((r, cout), generator=g) * 2.0 ** torch.randint(-4, 4, (r, 1),
                                                                          generator=g))
    w = torch.randn((taps, cout, cin), generator=g) * 0.2
    dout, w = dout.to(torch.bfloat16), w.to(torch.bfloat16)
    want = sparse_conv.gather_dx_bf16(dout, idx, w)
    before = build.LAUNCHES["gather_dx_bf16"]
    got = sparse_conv.gather_dx_bf16(dout.to(dev), idx.to(dev), w.to(dev))
    assert build.LAUNCHES["gather_dx_bf16"] == before + 1
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))
    plain = sparse_conv.gather_dx_bf16_plain(dout.to(dev), idx.to(dev), w.to(dev))
    assert torch.equal(plain.cpu().view(torch.int16), want.view(torch.int16))


def test_gather_wgrad_bf16_kernel_within_one_ulp_of_plain(dev):
    """K4's bf16 variant: the f32 sum rounded once to bf16 and widened;
    against the plain einsum's, within one bf16 ulp (two f32 sums in other
    orders round to neighbouring bf16 values, or apart by two where they
    cancel, within 1e-5 of the scale)."""
    g = torch.Generator().manual_seed(15)
    n, rows, taps, cin, cout = 5000, 6000, 27, 24, 40
    idx = torch.randint(0, n + 1, (rows, taps), generator=g, dtype=torch.int32)
    x = torch.randn((n, cin), generator=g).to(torch.bfloat16)
    dout = torch.randn((rows, cout), generator=g).to(torch.bfloat16)
    want = sparse_conv.gather_wgrad(x, idx, dout)
    before = build.LAUNCHES["gather_wgrad_bf16"]
    got = sparse_conv.gather_wgrad(x.to(dev), idx.to(dev), dout.to(dev)).cpu()
    assert build.LAUNCHES["gather_wgrad_bf16"] == before + 1
    assert got.dtype == torch.float32 and torch.equal(got, got.to(torch.bfloat16).float())
    diff = (got - want).abs()
    mag = torch.maximum(got.abs(), want.abs())
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
    beyond = diff > ulp
    assert not beyond.any() or float(diff[beyond].max()) <= 1e-5 * float(want.abs().max())


# K13 and K4 cases: (source rows, table, Cin, Cout), Cin the conv input's
# channels (K13's output, K4's x), Cout its output's (K13's chain, K4's
# dout); the tables as K1's cases (rows past the count, all-absent rows, a
# row with all 27 taps and, on the subm tables, rows whose sources do not
# ascend with the tap); Cin 6, 16 and 224, Cout 192; tables of at most
# 12288 rows and larger ones ("large"), which take K13's other tiles.
BWD_CASES = {
    "subm 27x6->192": (1003, "subm", 6, 192),
    "subm 27x16->16": (1003, "subm", 16, 16),
    "subm 27x16->192": (1003, "subm", 16, 192),
    "subm 27x224->192": (301, "subm", 224, 192),
    "ragged 27x40->24": (700, "subm", 40, 24),
    "large 27x16->48": (12800, "subm", 16, 48),
    "large 27x96->32": (12800, "subm", 96, 32),
    "down 8x32->64": (900, "down", 32, 64),
    "up 8x64->32": (300, "up", 64, 32),
    "absent 27x16->32": (257, "absent", 16, 32),
}


def _bwd_case(name: str, dtype, seed: int = 6):
    """(table, source rows, x (n, Cin), dout over the table's rows (R, Cout),
    dout over the source rows (n, Cout), w (T, Cout, Cin)) of a case."""
    n, kind, cin, cout = BWD_CASES[name]
    g = torch.Generator().manual_seed(seed)
    idx = _case_table(n, kind, g, seed)
    scale = 2.0 ** torch.randint(-3, 3, (1,), generator=g)
    x = torch.randn((n, cin), generator=g).to(dtype)
    dout = (torch.randn((idx.shape[0], cout), generator=g) * scale).to(dtype)
    dout_src = (torch.randn((n, cout), generator=g) * scale).to(dtype)
    w = (torch.randn((idx.shape[1], cout, cin), generator=g) * (1.0 / (27 * cout)) ** 0.5)
    return idx, n, x, dout, dout_src, w.to(dtype)


def _refused_launches_nothing(count: str, run, idx, n: int) -> None:
    """An order of an equal copy of the table is refused before a launch."""
    before = build.LAUNCHES[count]
    with pytest.raises(ValueError, match="tap order"):
        run(sparse_conv.tap_order(idx.clone(), n))
    assert build.LAUNCHES[count] == before


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_gather_dx_bf16_kernel_over_the_tap_order_matches_plain(dev, case):
    """K13 over the table's TapOrder, bit for bit against its plain version
    and from call to call, one launch a call; the order of another table is
    refused with no launch."""
    idx, n, _, _, dout, w = _bwd_case(case, torch.bfloat16)
    want = sparse_conv.gather_dx_bf16_plain(dout, idx, w)
    dd, idd, wd = dout.to(dev), idx.to(dev), w.to(dev)
    order = sparse_conv.tap_order(idd, n)
    before = build.LAUNCHES["gather_dx_bf16"]
    got = sparse_conv.gather_dx_bf16(dd, idd, wd, order)
    again = sparse_conv.gather_dx_bf16(dd, idd, wd, order)
    assert build.LAUNCHES["gather_dx_bf16"] == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    _refused_launches_nothing("gather_dx_bf16",
                              lambda o: sparse_conv.gather_dx_bf16(dd, idd, wd, o), idd, n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_gather_wgrad_kernel_over_the_tap_order_matches_plain(dev, case, dtype):
    """K4 over the forward table's TapOrder (tensor cores, K split from the
    shape): f32 within 1e-5 of the scale, bf16 within one bf16 ulp (1e-5
    of the scale where a sum cancels) and bf16 values, the same bits from
    call to call, one launch a call; another table's order is refused with
    no launch."""
    idx, n, x, dout, _, _ = _bwd_case(case, dtype)
    want = sparse_conv.gather_wgrad_plain(x, idx, dout)
    xd, idd, dd = x.to(dev), idx.to(dev), dout.to(dev)
    order = sparse_conv.tap_order(idd, n)
    count = "gather_wgrad" if dtype == torch.float32 else "gather_wgrad_bf16"
    before = build.LAUNCHES[count]
    got = sparse_conv.gather_wgrad(xd, idd, dd, order)
    again = sparse_conv.gather_wgrad(xd, idd, dd, order)
    assert build.LAUNCHES[count] == before + 2
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, again)
    if dtype == torch.bfloat16:
        assert torch.equal(got, got.to(torch.bfloat16).float())
    diff = (got.cpu() - want).abs()
    scale = max(float(want.abs().max()), 1.0)
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-5 * scale, float(diff.max())
    else:
        mag = torch.maximum(got.cpu().abs(), want.abs())
        ulp = torch.where(mag > 0, torch.ldexp(torch.ones_like(mag),
                                               torch.frexp(mag).exponent - 8), mag)
        assert bool(((diff <= ulp) | (diff <= 1e-5 * scale)).all())
    _refused_launches_nothing(count, lambda o: sparse_conv.gather_wgrad(xd, idd, dd, o), idd, n)


def _grid_units(g, n: int = 4000):
    """Unit-like points: most cells hold one, some two (same batch and
    group), in two scenes and three groups, with an inactive tail."""
    coords = torch.rand((n, 3), generator=g) * 0.6
    batch = torch.randint(0, 2, (n,), generator=g, dtype=torch.int32)
    group = torch.randint(0, 3, (n,), generator=g, dtype=torch.int32)
    valid = torch.ones(n, dtype=torch.bool)
    valid[-n // 10:] = False
    return coords, batch, valid, group


@pytest.mark.parametrize("radius,cell,half_space", [(0.03, 0.03, True), (0.03, 0.03, False),
                                                    (0.04, 0.02, True), (0.03, 0.02, False)])
def test_ball_query_grid_kernel_matches_plain(dev, radius, cell, half_space):
    coords, batch, valid, group = _grid_units(torch.Generator().manual_seed(1))
    want = ballquery.ball_query_grid(coords, batch, valid, radius, 8, cell, half_space, group)
    before = build.LAUNCHES["ball_query_grid"]
    got = ballquery.ball_query_grid(coords.to(dev), batch.to(dev), valid.to(dev), radius, 8,
                                    cell, half_space, group.to(dev))
    assert build.LAUNCHES["ball_query_grid"] == before + 1
    assert torch.equal(got[0].cpu(), want[0]) and bool(want[1].any())


def test_ball_query_fused_kernel_matches_plain(dev):
    coords, batch, valid, group = _grid_units(torch.Generator().manual_seed(2))
    want = ballquery.ball_query(coords, batch, valid, 0.04, 8, 4, True, group)
    before = build.LAUNCHES["ball_query_edge"]
    got = ballquery.ball_query(coords.to(dev), batch.to(dev), valid.to(dev), 0.04, 8, 4, True,
                               group.to(dev))
    assert build.LAUNCHES["ball_query_edge"] == before + 1
    assert torch.equal(got[0].cpu(), want[0]) and bool(want[1].any())


def test_compact_labels_on_k9_matches_plain(dev):
    g = torch.Generator().manual_seed(3)
    n = 30000
    comp = torch.randint(0, 4000, (n,), generator=g)
    active = torch.rand(n, generator=g) < 0.8
    first = torch.full((4000,), n, dtype=torch.int64)
    first.scatter_reduce_(0, comp[active], torch.arange(n)[active], reduce="amin")
    label = torch.where(active, first[comp], torch.full_like(comp, n))
    for c_cap, big in ((5000, 1), (64, 1), (64, 10)):
        want = cluster.compact_labels(label, active, c_cap, big)
        got = cluster.compact_labels(label.to(dev), active.to(dev), c_cap, big)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("edge_cap", [0, 40000])
def test_cluster_points_on_the_card_matches_cpu(dev, edge_cap):
    """Point granularity end to end (K2, K3 with an int64 group as the heads
    pass it, K9 through compact_labels), card against CPU."""
    coords, batch, valid, group = _grid_units(torch.Generator().manual_seed(4))
    group = group.long()
    want = cluster.cluster_points(coords, batch, valid, group, 0.03, 16, 8, 256, 32, True,
                                  edge_cap, big_thre=3)
    got = cluster.cluster_points(coords.to(dev), batch.to(dev), valid.to(dev), group.to(dev),
                                 0.03, 16, 8, 256, 32, True, edge_cap, big_thre=3)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def _plan_keys(g, n: int = 30000):
    """Packed (batch, coords) keys of two batches with SENTINEL rows, as a
    grid-plan level sorts them (62 bits, every pass moves keys)."""
    from minsu3d_tpu_torch.ops import hashing

    batch = torch.randint(0, 2, (n,), generator=g, dtype=torch.int32)
    coords = torch.randint(0, 300, (n, 3), generator=g, dtype=torch.int32)
    valid = torch.rand(n, generator=g) < 0.6
    return hashing.pack_key(*hashing.mask_invalid(*hashing.pack(batch, coords), valid))


# name: (keys from a generator, bits); K15 runs one block up to 8192 keys
# and onesweep (2048-key tiles) above
KEY_CASES = {
    "random": (lambda g: torch.randint(0, 1 << 40, (20000,), generator=g), 64),
    "duplicate runs": (lambda g: torch.randint(0, 50, (9000,), generator=g) << 31, 64),
    "all equal": (lambda g: torch.full((5000,), 3, dtype=torch.int64), 64),
    "reversed": (lambda g: torch.arange(7000).flip(0), 64),
    "one key": (lambda g: torch.tensor([9]), 64),
    "negative keys": (lambda g: torch.randint(-2**62, 2**62, (4100,), generator=g), 64),
    "n = 8192, the one-block threshold": (
        lambda g: torch.randint(-2**40, 2**40, (8192,), generator=g), 64),
    "n = 8193, one past it": (lambda g: torch.randint(0, 3000, (8193,), generator=g), 64),
    "262144 segment ids, bits 17": (
        lambda g: torch.randint(0, 65537, (262144,), generator=g), 17),
    "plan keys with SENTINEL rows, 62 bits": (_plan_keys, 62),
    "every pass the identity, onesweep": (
        lambda g: torch.full((20000,), -5, dtype=torch.int64), 64),
    "every pass the identity, bits 20": (
        lambda g: torch.full((9000,), 1000, dtype=torch.int64), 20),
    "n = 7 tiles + 5": (lambda g: torch.randint(0, 1 << 20, (7 * 2048 + 5,), generator=g), 24),
    "cross-root pair keys, bits 48": (
        lambda g: torch.randint(0, 65536, (1625,), generator=g) << 31
        | torch.randint(0, 65536, (1625,), generator=g), 48),
}


@pytest.mark.parametrize("case", list(KEY_CASES))
def test_key_sort_kernel_matches_plain(dev, case):
    from minsu3d_tpu_torch.ops import hashing

    make, bits = KEY_CASES[case]
    key = make(torch.Generator().manual_seed(2))
    want = hashing.key_sort_plain(key)
    before = build.LAUNCHES["key_sort"]
    got = hashing.key_sort(key.to(dev), bits)
    assert build.LAUNCHES["key_sort"] == before + 1
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    n = key.shape[0]
    assert build.kernel_lib().ms3d_key_sort_scratch(n, bits) == (
        hashing.key_sort_scratch_bytes(n, bits))


def _bounds_case(name: str, g):
    """(table, queries) of each bounds case."""
    rand = torch.sort(torch.randint(0, 500, (3000,), generator=g))[0]
    if name == "random":
        return rand, torch.randint(-5, 505, (4000,), generator=g).reshape(40, 100)
    if name == "3000 rows of one key":   # the gallop's long run
        return torch.full((3000,), 7, dtype=torch.int64), torch.tensor([-1, 6, 7, 8, 2**62])
    if name == "queries below and above every row":
        return rand, torch.cat([torch.tensor([-2**63, -1, 500, 2**63 - 1]),
                                torch.randint(-10**6, -1, (300,), generator=g),
                                torch.randint(500, 10**6, (300,), generator=g)])
    if name == "1 row":
        return torch.tensor([5]), torch.tensor([-1, 4, 5, 6, 2**62])
    if name == "empty table":
        return torch.zeros(0, dtype=torch.int64), torch.tensor([-1, 0, 3])
    # larger than the 2048 staged samples: buckets of several rows, runs
    # across bucket boundaries
    big = torch.sort(torch.randint(0, 40000, (200000,), generator=g))[0]
    return big, torch.randint(-10, 40010, (50000,), generator=g)


@pytest.mark.parametrize("case", ["random", "3000 rows of one key",
                                  "queries below and above every row", "1 row", "empty table",
                                  "200000 rows in buckets"])
def test_sorted_lookup_kernel_matches_plain(dev, case):
    from minsu3d_tpu_torch.ops import hashing

    table, q = _bounds_case(case, torch.Generator().manual_seed(3))
    want = hashing.sorted_bounds_plain(table, q)
    got = hashing.sorted_bounds(table.to(dev), q.to(dev))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    before = build.LAUNCHES["sorted_lookup"]
    lower = hashing.lower_bound(table.to(dev), q.to(dev))
    assert build.LAUNCHES["sorted_lookup"] == before + 1
    assert torch.equal(lower.cpu(), want[0])


RUN_OFFSET_CASES = {
    # ids with a third of the segments empty and padding rows
    "random ids, empty segments and padding": (70000, lambda g, s: torch.where(
        torch.rand(70000, generator=g) < 0.2, s,
        torch.randint(0, s // 3, (70000,), generator=g) * 3)),
    "all padding": (4000, lambda g, s: torch.full((9000,), s, dtype=torch.int64)),
    "one segment": (5000, lambda g, s: torch.full((3000,), 1234, dtype=torch.int64)),
    "no rows": (300, lambda g, s: torch.zeros(0, dtype=torch.int64)),
    "unit table: 131072 ids, 20000 units of 65536": (65536, lambda g, s: torch.where(
        torch.rand(131072, generator=g) < 0.6, s,
        torch.randint(0, 20000, (131072,), generator=g))),
}


@pytest.mark.parametrize("case", list(RUN_OFFSET_CASES))
def test_run_offsets_kernel_matches_plain(dev, case):
    """K16's run offsets against searchsorted of arange(S+1), bit for bit;
    segment_csr on the card against the CPU's."""
    from minsu3d_tpu_torch.ops import hashing

    n_seg, make = RUN_OFFSET_CASES[case]
    ids = make(torch.Generator().manual_seed(8), n_seg)
    s = torch.sort(ids)[0]
    want = hashing.run_offsets_plain(s, n_seg)
    before = build.LAUNCHES["sorted_lookup"]
    got = hashing.run_offsets(s.to(dev), n_seg)
    assert build.LAUNCHES["sorted_lookup"] == before + 1
    assert torch.equal(got.cpu(), want)
    cpu, card = _csr_pair(ids, n_seg, dev)
    assert torch.equal(card.perm.cpu(), cpu.perm) and torch.equal(card.offsets.cpu(),
                                                                   cpu.offsets)


def test_neighbor_map_and_unique_compact_kernels_match_plain(dev):
    """A small device plan: K15-K17 on the card against the plain versions
    of the same build, every table field bit for bit."""
    from minsu3d_tpu_torch.ops import sparse

    g = torch.Generator().manual_seed(4)
    n = 6000
    batch = torch.randint(0, 2, (n,), generator=g, dtype=torch.int32)
    coords = torch.randint(0, 40, (n, 3), generator=g, dtype=torch.int32)
    valid = torch.rand(n, generator=g) < 0.9
    feats = torch.randn((n, 5), generator=g)
    caps = [4096, 2048, 1024, 1024]
    want, want_r2v, want_f = sparse.build_plan(batch, coords, valid, caps, 4, feats)
    before = build.LAUNCHES["neighbor_map"]
    got, got_r2v, got_f = sparse.build_plan(batch.to(dev), coords.to(dev), valid.to(dev), caps,
                                            4, feats.to(dev))
    assert build.LAUNCHES["neighbor_map"] == before + 1     # every level's map, one launch
    assert int(want.levels[0].n_dropped) > 0      # level 0 overflows
    assert torch.equal(got_r2v.cpu(), want_r2v) and torch.equal(got_f.cpu(), want_f)
    a, b = sparse.plan_arrays(got, got_r2v), sparse.plan_arrays(want, want_r2v)
    assert a.keys() == b.keys()
    for k in b:
        assert torch.equal(a[k].cpu(), b[k]), k


def _wrap_voxels(g, n: int = 20000) -> tuple:
    """(batch, coords, valid) of two batches whose keys wrap: voxels at z =
    1023 beside (y + 1, z = 0) and at y = 1023 beside (x + 1, y = 0),
    adjacent in key order, and seeded voxels around them."""
    crafted = []
    for b in (0, 1):
        for x, y in ((5, 7), (9, 1022), (3, 1022)):
            crafted += [(b, x, y, 1023), (b, x, y, 1022), (b, x, y + 1, 0), (b, x, y + 1, 1)]
        crafted += [(b, 20, 1023, 4), (b, 21, 0, 4), (b, 20, 1023, 5), (b, 21, 0, 3),
                    (b, 22, 0, 1023), (b, 22, 1, 0), (b, 1023, 1023, 1023), (b, 0, 0, 0)]
    crafted = torch.tensor(crafted, dtype=torch.int32)
    pick = crafted[torch.randint(0, len(crafted), (n,), generator=g)]
    pick[:, 1:] = (pick[:, 1:] + torch.randint(-3, 4, (n, 3), generator=g,
                                               dtype=torch.int32)).clamp(0, 1023)
    pts = torch.cat([crafted, pick])
    valid = torch.rand(len(pts), generator=g) < 0.95
    valid[:len(crafted)] = True
    return pts[:, 0].contiguous(), pts[:, 1:].contiguous(), valid


@pytest.mark.parametrize("case", ["wrapping keys, two batches", "no valid row",
                                  "full level", "eight levels"])
def test_neighbor_maps_kernel_matches_plain(dev, case):
    """K16's neighbour mode over every level of a plan built on the CPU, bit
    for bit against the plain maps: keys that wrap at z = 1023 and y = 1023,
    two batches, a level with no valid row, a level with no padding, eight
    levels; one launch a call, no host sync; nine levels refused."""
    from minsu3d_tpu_torch.ops import hashing, sparse

    g = torch.Generator().manual_seed(12)
    batch, coords, valid = _wrap_voxels(g)
    caps, n_levels = [16384, 8192, 4096, 2048], 4
    if case == "no valid row":
        valid = torch.zeros_like(valid)
    plan, _, _ = sparse.build_plan(batch, coords, valid, caps, n_levels)
    levels = list(plan.levels)
    if case == "full level":
        lv = levels[0]
        count = int(lv.count)
        levels = [lv._replace(**{f: getattr(lv, f)[:count] for f in
                                 ("khi", "klo", "coords", "batch", "valid")})]
        assert bool(levels[0].valid.all())
    if case == "eight levels":      # the most one launch takes
        levels = (levels * 2)[:8]
    want = hashing.neighbor_maps_plain(levels)
    card = [lv._replace(**{f: getattr(lv, f).to(dev) for f in
                           ("khi", "klo", "coords", "batch", "valid")}) for lv in levels]
    before = build.LAUNCHES["neighbor_map"]
    got, ops = _device_ops(lambda: hashing.neighbor_maps(card), "ms3d_neighbor_maps_device_ops")
    assert ops == 1 and build.LAUNCHES["neighbor_map"] == before + 1
    for lvl, (x, w) in enumerate(zip(got, want)):
        assert x.dtype == torch.int32 and torch.equal(x.cpu(), w), f"L{lvl}"
    if case == "eight levels":
        with pytest.raises(ValueError):
            hashing.neighbor_maps(card + card[:1])
    if case == "wrapping keys, two batches":     # level 0 holds the z = 1023 rows
        lv, w = levels[0], want[0]
        edge = lv.valid & (lv.coords[:, 2] == 1023)
        assert bool(edge.any()) and bool((w[edge, 14] == lv.cap).all())


def test_neighbor_maps_equal_the_host_plan_on_a_scene(dev):
    """The seven-level map of the golden PointGroup eval's first val scene
    (the device plan's levels) equals the host plan's ms3d_plan_neighbors map
    level for level, in one launch with no host sync."""
    from minsu3d_tpu_torch.config import EvalConfig, backbone_caps
    from minsu3d_tpu_torch.data.batching import build_plan_host, collate, eval_caps
    from minsu3d_tpu_torch.data.dataset import eval_item, synthetic_val_scenes
    from minsu3d_tpu_torch.ops import hashing, sparse
    from minsu3d_tpu_torch.test import batch_to_torch

    cfg = EvalConfig()
    scan_id, scene = synthetic_val_scenes(cfg)[0]
    b = collate([eval_item(cfg, scene, scan_id)], eval_caps(cfg))
    caps, n_levels = backbone_caps(cfg), len(cfg.net.blocks)
    hp = build_plan_host(b["voxel_batch"], b["voxel_coords"], b["voxel_mask"], caps, n_levels)
    tb = batch_to_torch(b, dev)
    plan, _, _ = sparse.build_plan(tb["voxel_batch"], tb["voxel_coords"], tb["voxel_mask"],
                                   caps, n_levels)
    got, ops = _device_ops(lambda: hashing.neighbor_maps(plan.levels),
                           "ms3d_neighbor_maps_device_ops")
    assert ops == 1 and len(got) == n_levels == 7
    for lvl, (x, lv) in enumerate(zip(got, plan.levels)):
        want = torch.as_tensor(hp[f"plan{lvl}_nbr"])
        assert torch.equal(x.cpu(), want) and torch.equal(lv.nbr_idx.cpu(), want), f"L{lvl}"


def _chain_graph(g, n: int = 5000, k: int = 6):
    """Random chains through a permutation of the nodes (links in random
    slots, some cut), an inactive tail and two groups: many sweeps deep."""
    perm = torch.randperm(n, generator=g)
    nbr = torch.full((n, k), n, dtype=torch.int32)
    slot = torch.randint(0, k, (n - 1,), generator=g)
    keep = torch.rand(n - 1, generator=g) > 0.01
    nbr[perm[:-1][keep], slot[keep]] = perm[1:][keep].to(torch.int32)
    nbr_valid = nbr < n
    active = torch.rand(n, generator=g) > 0.02
    group = (torch.argsort(perm) // 700 % 2).to(torch.int32)
    return nbr, nbr_valid, active, group


@pytest.mark.parametrize("max_iters,coarsen,coarsen_sweeps",
                         [(1, 0, 2), (3, 0, 2), (64, 0, 2), (1, 4096, 2), (2, 8, 1),
                          (64, 4096, 2), (64, 4096, 1), (0, 0, 2), (0, 4096, 2)])
def test_connected_components_kernels_match_plain(dev, max_iters, coarsen, coarsen_sweeps):
    """K3 (and K18 with coarsening) against the plain sweeps: labels,
    unconverged, the sweep counts and the distinct cross-root pairs, also
    at truncated budgets; one launch a call and no host sync in it."""
    graph = _chain_graph(torch.Generator().manual_seed(5))
    want = cluster.connected_components_plain(*graph, max_iters, coarsen, coarsen_sweeps)
    before = dict(build.LAUNCHES)
    args = [t.to(dev) for t in graph]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = cluster.connected_components_cuda(*args, max_iters, coarsen, coarsen_sweeps)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got.labels.cpu(), want.labels)
    assert all(g.device == dev and g.dim() == 0 for g in got[1:])
    assert [int(v) for v in got[1:]] == [int(v) for v in want[1:]]
    assert build.LAUNCHES["connected_components"] - before["connected_components"] == 1
    assert build.LAUNCHES["cc_coarsen"] - before["cc_coarsen"] == (1 if coarsen else 0)
    if max_iters == 1:
        assert int(got.unconverged)


@pytest.mark.parametrize("max_iters,coarsen", [(32, 4096), (1, 4096), (2, 4)])
def test_connected_components_kernels_on_an_overflowing_pair_list(dev, max_iters, coarsen):
    """The (64, 64, 64) lattice: ~455k cross-root edge slots and ~15k
    distinct pairs after two sweeps, more than ``coarsen``, so the kernel's
    hash table is large and its radix select picks the list."""
    from minsu3d_tpu_torch.tools import cc_graph

    graph = [torch.from_numpy(a) for a in cc_graph.lattice((64, 64, 64), 16, 7)]
    want = cluster.connected_components_plain(*graph, max_iters, coarsen, 2)
    got = cluster.connected_components_cuda(*(t.to(dev) for t in graph), max_iters, coarsen,
                                            2)
    assert int(want.pairs) > coarsen
    assert torch.equal(got.labels.cpu(), want.labels)
    assert [int(v) for v in got[1:]] == [int(v) for v in want[1:]]


def test_unit_compact_kernel_on_non_root_labels(dev):
    """K9 groups units by label value: labels that are not roots (a
    truncated CC loop's) give the plain version's result."""
    g = torch.Generator().manual_seed(6)
    u = 5000
    active = torch.rand(u, generator=g) < 0.8
    label = torch.where(active, torch.randint(0, u, (u,), generator=g),
                        torch.full((u,), u, dtype=torch.int64))
    counts = torch.where(active, torch.randint(1, 4, (u,), generator=g), 0)
    uid = torch.randint(0, u + 1, (12000,), generator=g)
    for c_cap in (4096, 40):
        want = cluster.unit_points_compact_plain(label, uid, u, c_cap, counts)
        got = cluster.unit_points_compact_cuda(label.to(dev), uid.to(dev), u, c_cap,
                                               counts.to(dev))
        for name, w, k in zip(("point_cluster", "sizes", "count", "seg_sizes", "n_big"), want,
                               got):
            assert torch.equal(k.cpu(), w), name


@pytest.mark.parametrize("v,c,tile", [(4608 * 2, 128, 4608), (512, 8, 64), (768, 12, 256),
                                      (1000, 4, 40)])
def test_probe_kernels_match_plain(dev, v, c, tile):
    """K19-K21 against their plain versions bit for bit (K21 only where
    the tile is a multiple of 16), with a -0.0, subnormals, a normal x
    whose lowest TF32 term is subnormal and the largest finite f32 planted
    where the first rows read."""
    from minsu3d_tpu_torch.tools import probe_cuda

    g = torch.Generator().manual_seed(7)
    x = torch.randn((v, c), generator=g)
    idx = torch.randint(0, tile, (v,), generator=g, dtype=torch.int32)
    special = torch.tensor([-0.0, 1e-40, -3e-45, 1.2345678 * 2.0 ** -110,
                            -1.7654321 * 2.0 ** -101, 1.5 * 2.0 ** -100, 3.4028235e38])
    for i, val in enumerate(special.tolist()):
        x[i, i % c] = val
    idx[:len(special)] = torch.arange(len(special), dtype=torch.int32)
    xd, idd = x.to(dev), idx.to(dev)
    pairs = [(probe_cuda.double_cuda(xd), probe_cuda.double_plain(x)),
             (probe_cuda.window_gather_cuda(xd, idd, tile),
              probe_cuda.window_gather_plain(x, idx, tile))]
    if tile % 16 == 0:
        pairs.append((probe_cuda.onehot_gather_cuda(xd, idd, tile),
                      probe_cuda.onehot_gather_plain(x, idx, tile)))
    for got, want in pairs:
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def _device_ops(fn, counter: str):
    """(fn()'s result, the memsets and kernel launches it enqueued, by the
    kernel library's own count ``counter``); fn runs under
    set_sync_debug_mode("error"), so a host sync inside it raises."""
    count = getattr(build.kernel_lib(), counter)
    before = count()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, count() - before


def _k6_adversarial(case):
    """(x f32, segment ids, segments, fill) of K6's adversarial cases (the
    first four are also the CPU model test's, tests/test_torch_segment.py;
    the last one's long segments fill one span and two channel groups)."""
    g = torch.Generator().manual_seed(11)
    if case == "signed zeros":
        seg = torch.randint(0, 6, (3000,), generator=g)
        x = torch.where(torch.rand((3000, 5), generator=g) < 0.5, -0.0, 0.0)
        x[torch.rand((3000, 5), generator=g) < 0.02] = -1.0
        return x, seg, 6, 0.0
    if case == "NaN in a middle chunk":
        seg = torch.zeros(2000, dtype=torch.int64)
        seg[1500:] = torch.randint(1, 4, (500,), generator=g)
        x = torch.randn((2000, 3), generator=g)
        nan = torch.tensor([0x7FC00001, 0x7FC00002], dtype=torch.int32).view(torch.float32)
        x[700, 1], x[710, 1], x[900, 2] = nan[0], nan[1], nan[0]
        return x, seg, 4, 0.0
    if case == "one segment of 100k rows":
        seg = torch.zeros(100000, dtype=torch.int64)
        seg[torch.rand(100000, generator=g) < 0.01] = 3
        return torch.randn((100000, 2), generator=g), seg, 5, 0.0
    if case == "empty segments, int32 fill -1, 37 ch":
        seg = torch.randint(0, 40, (4000,), generator=g)
        seg[seg % 3 == 0] = 40
        seg[:900] = 7
        return torch.randn((4000, 37), generator=g), seg, 40, -1.0
    if case == "segments of 1-600 rows, 300 ch":     # many long ones in one span, two
        lens = torch.randint(1, 600, (60,), generator=g)   # channel groups of a block
        seg = torch.repeat_interleave(torch.arange(60), lens)[torch.randperm(int(lens.sum()),
                                                                           generator=g)]
        return torch.randn((seg.shape[0], 300), generator=g), seg, 62, 0.0
    raise KeyError(case)


K6_ADVERSARIAL = ["signed zeros", "NaN in a middle chunk", "one segment of 100k rows",
                  "empty segments, int32 fill -1, 37 ch", "segments of 1-600 rows, 300 ch"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("case", K6_ADVERSARIAL)
def test_segment_reduce_kernel_on_adversarial_segments(dev, case, op, dtype):
    """K6 bit for bit against its plain version on the CPU: ties of -0.0
    and +0.0, NaN payloads in a middle chunk, a 100k-row segment, empty
    segments with an int32 fill of -1, long segments in one span and over
    two channel groups; whatever the data, one launch for an f32/bf16 sum
    (short segments and staged chains) and two otherwise (short segments
    and chunks, then the chunks' combine); no host sync."""
    x, seg, n_seg, fill = _k6_adversarial(case)
    if dtype == torch.int32:
        x, fill = (x.nan_to_num(0.0) * 100).to(torch.int32), int(fill)
    else:
        x = x.to(dtype)
    cpu, card = _csr_pair(seg, n_seg, dev)
    want = segment.segment_reduce(x, cpu, op, fill)
    xd = x.to(dev)
    got, ops = _device_ops(lambda: segment.segment_reduce(xd, card, op, fill),
                           "ms3d_segment_reduce_device_ops")
    width = torch.int16 if dtype == torch.bfloat16 else torch.int32
    got = got.cpu()
    if op == "sum" and dtype != torch.int32:
        # a NaN's bits after an add are the adder's (the card's is 0x7fffffff)
        assert torch.equal(got.isnan(), want.isnan())
        got, want = got.nan_to_num(0.0), want.nan_to_num(0.0)
    assert torch.equal(got.view(width), want.view(width))
    assert ops == (1 if op == "sum" and dtype != torch.int32 else 2)


def _k9_labels(case, u=3000):
    """(labels, counts) of K9's label sets (also the CPU model test's,
    tests/test_torch_cluster.py), labels as K3 leaves them: the smallest
    unit id of a component, u for an inactive unit."""
    g = torch.Generator().manual_seed(12)
    ids = torch.arange(u)
    if case == "n = 0":
        return torch.full((u,), u, dtype=torch.int64), torch.zeros(u, dtype=torch.int64)
    if case == "one giant component":
        active = torch.rand(u, generator=g) < 0.9
        return (torch.where(active, int(ids[active][0]), u), torch.where(active, 1, 0))
    if case == "every size equal":
        comp = torch.randperm(u, generator=g) // 3
        first = torch.full((u,), u, dtype=torch.int64).scatter_reduce_(0, comp, ids, "amin")
        return first[comp], torch.ones(u, dtype=torch.int64)
    comp = torch.randint(0, 700, (u,), generator=g)
    active = torch.rand(u, generator=g) < 0.8
    first = torch.full((700,), u, dtype=torch.int64)
    first.scatter_reduce_(0, comp[active], ids[active], reduce="amin")
    label = torch.where(active, first[comp], torch.full_like(comp, u))
    if case == "sizes over 2^16":
        return label, torch.where(active, torch.randint(1000, 30000, (u,), generator=g), 0)
    return label, torch.where(active, torch.randint(1, 4, (u,), generator=g), 0)


K9_CASES = {"every size equal": 2000, "one giant component": 64, "n > c_cap": 10,
            "n = 0": 64, "sizes over 2^16": 64}


def _check_unit_compact(dev, label, uid, u, c_cap, counts, big_thre):
    """K9 against its plain version: every output, one kernel (and one
    memset) a call, no host sync."""
    want = cluster.unit_points_compact_plain(label.cpu(), uid.cpu(), u, c_cap, counts.cpu(),
                                             big_thre)
    args = (label.to(dev), uid.to(dev), u, c_cap, counts.to(dev), big_thre)
    got, ops = _device_ops(lambda: cluster.unit_points_compact_cuda(*args),
                           "ms3d_unit_compact_device_ops")
    for name, w, k in zip(("point_cluster", "sizes", "count", "seg_sizes", "n_big"), want, got):
        assert torch.equal(k.cpu(), w), name
    assert ops == 2     # the memset and the cooperative launch


@pytest.mark.parametrize("case", list(K9_CASES))
def test_unit_compact_kernel_on_the_model_label_sets(dev, case):
    u = 3000
    label, counts = _k9_labels(case, u)
    uid = torch.randint(0, u + 1, (6000,), generator=torch.Generator().manual_seed(13))
    _check_unit_compact(dev, label, uid, u, K9_CASES[case], counts, 3)


def test_unit_compact_kernel_on_the_val_scene_units(dev):
    """K9 on the unit labels of PointGroup's two clusterings of the first val
    scene (heads on ground-truth outputs), at the eval caps."""
    from minsu3d_tpu_torch.config import EvalConfig
    from minsu3d_tpu_torch.model.registry import get_model
    from minsu3d_tpu_torch.test import (batch_to_torch, collated_scenes,
                                        injected_backbone_outputs, seeded_model)

    cfg = EvalConfig()
    _, batch = next(collated_scenes(cfg))
    model = seeded_model(cfg, 4, dev)
    inj = injected_backbone_outputs(batch, cfg.classes, cfg.net.m, 4, dev)
    calls, orig = [], cluster.unit_points_compact

    def spy(*args):
        calls.append(args)
        return orig(*args)

    cluster.unit_points_compact = spy
    try:
        with torch.no_grad():
            model.heads(batch_to_torch(batch, dev), inj,
                        **get_model(cfg.MODEL).forward_flags(cfg, 100, False))
    finally:
        cluster.unit_points_compact = orig
    assert len(calls) == 2
    for label, uid, u_cap, c_cap, counts, big_thre in calls:
        assert int((label < u_cap).sum()) > 1000
        _check_unit_compact(dev, label, uid, u_cap, c_cap, counts, big_thre)


def _blob_points(g, n: int = 4000, blobs: int = 12):
    """Dense blobs (many points a 3 cm cell), two scenes, four groups and an
    inactive tail: window clipping, the K cap and the keys all matter."""
    centers = torch.rand((blobs, 3), generator=g) - 0.5
    which = torch.randint(0, blobs, (n,), generator=g)
    coords = centers[which] + torch.randn((n, 3), generator=g) * 0.03
    batch = (which % 2).to(torch.int32)
    group = torch.randint(0, 4, (n,), generator=g, dtype=torch.int32)
    valid = torch.ones(n, dtype=torch.bool)
    valid[n - n // 10:] = False
    return coords, batch, valid, group


# name: (half_space, groups, K, window, edge cap, points)
K2_CASES = {
    "half space, groups, the recipe's cap": (True, True, 16, 8, "recipe", 4000),
    "half space, groups, half the candidates": (True, True, 16, 8, "half", 4000),
    "27 offsets, groups, half the candidates": (False, True, 16, 8, "half", 4000),
    "half space, no groups, no cap": (True, False, 16, 8, "none", 4000),
    "27 offsets, K 32, window 32, no cap": (False, True, 32, 32, "none", 4000),
    "K 40: two lane rounds a row": (True, True, 40, 8, "recipe", 3000),
    "n = 1": (True, True, 8, 8, "recipe", 1),
    "no valid point": (True, True, 8, 8, "recipe", 0),   # 500 points, all invalid
}


@pytest.mark.parametrize("case", list(K2_CASES))
def test_ball_query_edge_kernel_is_one_launch_equal_to_plain(dev, case):
    """K2 on the table the wrapper hands it against ``edge_scan_plain``: the
    neighbour table, its validity, the candidate total and edges_dropped,
    bit for bit; one launch a call (no memset, no K16 search) and no host
    sync."""
    half, groups, k, window, cap, n = K2_CASES[case]
    coords, batch, valid, group = _blob_points(torch.Generator().manual_seed(21), n or 500)
    if n == 0:    # 500 points, none of them valid
        valid[:] = False
    group = group if groups else None
    table = ballquery.edge_table(coords, batch, valid, 0.03, group)
    r2 = float(torch.tensor(0.03 * 0.03, dtype=torch.float32))
    total = int(ballquery.run_bounds(table[0], table[1], valid, table[2], window, half)[3])
    edge_cap = {"recipe": 56 * coords.shape[0], "half": total // 2,
                "none": ballquery.NO_EDGE_CAP}[cap]
    want = ballquery.edge_scan_plain(coords, valid, *table, k, window, edge_cap, half, r2)
    args = [t.to(dev) for t in (coords, valid, *table)]
    k16 = build.LAUNCHES["sorted_lookup"]
    got, ops = _device_ops(
        lambda: ballquery.edge_scan_cuda(*args, k, window, edge_cap, half, r2),
        "ms3d_ball_query_edge_device_ops")
    assert ops == 1 and build.LAUNCHES["sorted_lookup"] == k16
    for name, w, g in zip(("nbr", "nbr_valid", "total, edges_dropped"), want, got):
        assert torch.equal(g.cpu(), w), name
    assert (int(want[2][1]) > 0) == (cap == "half")
    assert bool(want[1].any()) == (n > 0)


@pytest.mark.parametrize("fused", [False, True])
def test_ball_query_call_launches_k2_once_and_no_k16(dev, fused):
    """The whole call on the card: the cell keys, K15's sort, then one K2
    launch and no K16 launch, with no host sync (the cell size is filled on
    the card, not copied from the host); equal to the CPU call bit for
    bit."""
    coords, batch, valid, group = _blob_points(torch.Generator().manual_seed(22))

    def call(c, b, v, g):
        if fused:
            return ballquery.ball_query(c, b, v, 0.03, 16, 8, True, g)
        return ballquery.ball_query_edge(c, b, v, 0.03, 16, 8, 10000, True, g)

    want = call(coords, batch, valid, group)
    args = [t.to(dev) for t in (coords, batch, valid, group)]
    before = dict(build.LAUNCHES)
    got, _ = _device_ops(lambda: call(*args), "ms3d_ball_query_edge_device_ops")
    launched = {k: v - before[k] for k, v in build.LAUNCHES.items() if v != before[k]}
    assert launched.get("ball_query_edge") == 1 and "sorted_lookup" not in launched
    for w, g in zip(want, got):
        assert torch.equal(g.cpu(), w)
    if not fused:
        assert int(want[2]) > 0     # the cap of 10000 slots overflows


def test_make_units_grid_makes_no_host_sync(dev):
    """``make_units_grid``'s cell divisor is filled on the card: the unit ids
    and the dropped count equal the CPU's, with no host sync."""
    from minsu3d_tpu_torch.model import general_model as gm

    coords, batch, valid, group = _blob_points(torch.Generator().manual_seed(24))
    want = gm.make_units_grid(batch, coords, group, valid, 500, 0.02)
    args = [t.to(dev) for t in (batch, coords, group, valid)]
    got, _ = _device_ops(lambda: gm.make_units_grid(*args, 500, 0.02),
                         "ms3d_unique_compact_device_ops")
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    assert int(want[1]) > 0


# name: (rows, coordinate span, share of valid rows, cap or None, with perm)
K17_CASES = {
    "30000 rows with duplicates into 32768": (30000, 40, 0.8, 32768, True),
    "cap overflows": (30000, 40, 0.8, 2000, True),
    "98304 rows, the plan's level 0": (98304, 120, 0.45, 98304, True),
    "no table": (30000, 40, 0.8, None, True),
    "sorted flags, no perm (unique_sorted)": (30000, 40, 0.8, None, False),
    "all rows invalid": (6000, 40, 0.0, 1000, True),
    "cap 0": (500, 40, 0.8, 0, True),
    "n = 0": (0, 40, 0.8, 16, True),
    "n = 1": (1, 40, 1.0, 4, True),
}


@pytest.mark.parametrize("case", list(K17_CASES))
def test_unique_compact_kernel_is_one_launch_equal_to_plain(dev, case):
    """K17 reading the valid flags through the permutation against its plain
    version: first, seg, n_unique and every table field bit for bit; one
    launch a call (no memset) and no host sync."""
    from minsu3d_tpu_torch.ops import hashing

    n, span, share, cap, with_perm = K17_CASES[case]
    g = torch.Generator().manual_seed(23)
    batch = torch.randint(0, 2, (n,), generator=g, dtype=torch.int32)
    coords = torch.randint(0, span, (n, 3), generator=g, dtype=torch.int32)
    valid = torch.rand(n, generator=g) < share
    key = hashing.pack_key(*hashing.mask_invalid(*hashing.pack(batch, coords), valid))
    s_key, perm = hashing.key_sort_plain(key)
    if not with_perm:
        valid, perm = valid[perm.long()], None
    want = hashing.unique_compact_plain(s_key, valid, perm, cap)
    args = [None if t is None else t.to(dev) for t in (s_key, valid, perm)]
    got, ops = _device_ops(lambda: hashing.unique_compact(*args, cap),
                           "ms3d_unique_compact_device_ops")
    assert ops == 1
    for name, w, k in zip(hashing.Unique._fields, want[0], got[0]):
        assert torch.equal(k.cpu(), w), name
    if cap is None:
        assert got[1] is None
    else:
        for name, w, k in zip(hashing.Table._fields, want[1], got[1]):
            assert k.dtype == w.dtype and torch.equal(k.cpu(), w), name
