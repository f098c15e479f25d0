"""Kernels K3 and K18 (connected components, also at truncated budgets, with
the root-graph coarsening and with a pair list that overflows; one launch
and no host sync a call), K5 (with a row mask), K6-K13 (K9 also on
non-root labels), K14, K2 without an edge cap, K15-K17 (the key sort on
both of its paths and with ``bits``, sorted lookup in all three modes,
unique/compaction, and a small device grid plan) and
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


def test_proposal_voxelize_kernel_matches_plain(dev):
    g = torch.Generator().manual_seed(3)
    n, rows, p_cap, s, c = 3000, 6000, 16, 14, 8
    coords = torch.randn((n, 3), generator=g)
    pidx = torch.randint(0, n, (rows,), generator=g)
    valid = torch.rand(rows, generator=g) < 0.8
    pid = torch.where(valid, torch.randint(0, p_cap, (rows,), generator=g),
                      torch.full((rows,), p_cap))
    mean = torch.randn((p_cap, 3), generator=g) * 0.1
    scale = torch.rand(p_cap, generator=g) * 5 + 1
    offset = torch.rand((p_cap, 3), generator=g) * s / 2
    f = torch.randn((rows, c), generator=g)
    args = (pidx, pid, valid, mean, scale, offset)
    want = proposal_voxelize.place_plain(f, coords, *args, p_cap, s)
    got = proposal_voxelize.place_cuda(f.to(dev), coords.to(dev), *(a.to(dev) for a in args),
                                       p_cap, s)
    for name, w, k in zip(("volume", "occ", "row_cell", "cell_w"), want, got):
        assert torch.equal(k.cpu(), w), name
    assert bool(want[1].any())


def test_set_aggregation_kernel_matches_plain(dev):
    g = torch.Generator().manual_seed(4)
    n_c, n_p, p_cap = 5000, 512, 128
    centers = torch.rand((n_c, 3), generator=g) * 4
    cls = torch.randint(2, 6, (n_c,), generator=g, dtype=torch.int32)
    cbatch = torch.randint(0, 2, (n_c,), generator=g, dtype=torch.int32)
    primary = torch.rand(n_c, generator=g) < 0.05
    fragment = ~primary & (torch.rand(n_c, generator=g) < 0.9)
    prim_prop = torch.where(primary, torch.randint(0, p_cap, (n_c,), generator=g),
                            torch.full((n_c,), p_cap))
    r_cls = torch.full((n_c,), 0.3)
    centers_p = torch.rand((n_p, 3), generator=g) * 4
    centers_p[1] = centers_p[0]                          # an exact tie
    cls_p = torch.randint(2, 6, (n_p,), generator=g, dtype=torch.int32)
    cls_p[1] = cls_p[0]
    cbatch_p = torch.randint(0, 2, (n_p,), generator=g, dtype=torch.int32)
    cbatch_p[1] = cbatch_p[0]
    size_p = torch.randint(1, 3000, (n_p,), generator=g).float()
    prop_p = torch.randint(0, p_cap, (n_p,), generator=g)
    live_p = torch.rand(n_p, generator=g) < 0.9
    live_p[:2] = True
    args = (centers, cls, cbatch, fragment, primary, prim_prop, r_cls, centers_p, cls_p,
            cbatch_p, size_p, prop_p, live_p)
    want = set_aggregation.set_aggregation_plain(*args, p_cap)
    got = set_aggregation.set_aggregation_cuda(*(a.to(dev) for a in args), p_cap)
    assert torch.equal(got.cpu(), want)
    assert int((fragment & (want < p_cap)).sum()) > 0


@pytest.mark.parametrize("case", ["empty", "all_false", "all_true", "fewer_than_cap",
                                  "more_than_cap", "cap_beyond_length", "ragged_tiles"])
def test_stable_partition_kernel_matches_plain(dev, case):
    g = torch.Generator().manual_seed(6)
    n, cap = {"empty": (0, 8), "cap_beyond_length": (5000, 9000),
              "ragged_tiles": (3 * 4096 + 77, 5000)}.get(case, (50000, 20000))
    p = {"all_false": 0.0, "all_true": 1.0, "fewer_than_cap": 0.2, "more_than_cap": 0.6}
    flags = torch.rand(n, generator=g) < p.get(case, 0.5)
    want = stable_partition.stable_partition_plain(flags, cap)
    before = build.LAUNCHES["stable_partition"]
    got = stable_partition.stable_partition(flags.to(dev), cap)
    assert build.LAUNCHES["stable_partition"] == before + 1
    assert torch.equal(got[0].cpu(), want[0])
    assert int(got[1]) == int(want[1])


@pytest.mark.parametrize("n_classes", [1, 3, 18])
def test_proposal_rank_kernel_matches_plain_on_tied_keys(dev, n_classes):
    g = torch.Generator().manual_seed(7 + n_classes)
    c_cap, k, n_pairs, p_cap = 16384, 18, 114688, 128
    valid = torch.arange(c_cap) < 9000
    ccls = torch.where(valid, torch.randint(0, n_classes, (c_cap,), generator=g),
                       torch.full((c_cap,), -1))
    pna = torch.tensor([100.0, 333.0, 3000.0])[torch.randint(0, 3, (k,), generator=g)]
    thr = torch.tensor(0.05) * pna[ccls.clamp(0, k - 1)]
    sizes = (torch.ceil(thr) + torch.randint(-1, 2, (c_cap,), generator=g)).long()
    pc = torch.randint(0, c_cap + 1, (n_pairs,), generator=g)
    pair_valid = torch.rand(n_pairs, generator=g) < 0.9
    for limit in (200, 128, 7):
        args = (ccls, sizes, valid, pna, 0.05, min(limit, p_cap), p_cap, pc, pair_valid)
        want = proposal_rank.proposal_rank_plain(*args)
        got = proposal_rank.proposal_rank(*(a.to(dev) if isinstance(a, torch.Tensor) else a
                                            for a in args))
        for name, w, k_ in zip(("prop_id", "valid", "n_proposals"), want, got):
            assert torch.equal(k_.cpu(), w), (name, limit)
        assert int(want[2]) > 0


def _rows(g, n, p_cap):
    prop = torch.randint(0, p_cap + p_cap // 3 + 1, (2 * n,), generator=g)
    valid = prop < p_cap
    return {"point_idx": torch.arange(n).repeat(2), "prop_id": prop.clamp(max=p_cap),
            "valid": valid, "n_proposals": torch.tensor(p_cap)}


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
    want = instance_iou.get_iou(rows, p_cap, inst, num, i_cap, mask)
    before = build.LAUNCHES["proposal_iou"]
    got = instance_iou.get_iou({k: v.to(dev) for k, v in rows.items()}, p_cap, inst.to(dev),
                               num.to(dev), i_cap, None if mask is None else mask.to(dev))
    assert build.LAUNCHES["proposal_iou"] == before + 1
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


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
    want = instance_iou.proposal_argmax(ious, mask, 0.5)
    before = build.LAUNCHES["mask_label"]
    got = instance_iou.proposal_argmax(ious.to(dev), mask.to(dev), 0.5)
    assert build.LAUNCHES["mask_label"] == before + 1
    for name, w, k in zip(("max", "arg", "ok"), want, got):
        assert torch.equal(k.cpu(), w), name
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
    want = instance_iou.get_mask_label(rows, p_cap, inst, cls, ious, 0.5)
    got = instance_iou.get_mask_label({k: v.to(dev) for k, v in rows.items()}, p_cap,
                                      inst.to(dev), cls.to(dev), ious.to(dev), 0.5)
    for name, w, k in zip(("label", "row_ok"), want, got):
        assert torch.equal(k.cpu(), w), name
    assert not bool(want[1][~rows["valid"]].any())
    assert bool(want[0].any()) and bool((want[1] & ~want[0]).any())


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


def test_proposal_voxelize_bf16_kernel_matches_plain(dev):
    g = torch.Generator().manual_seed(13)
    n, rows, p_cap, s, c = 3000, 6000, 16, 20, 32
    coords = torch.randn((n, 3), generator=g)
    pidx = torch.randint(0, n, (rows,), generator=g)
    valid = torch.rand(rows, generator=g) < 0.8
    pid = torch.where(valid, torch.randint(0, p_cap, (rows,), generator=g),
                      torch.full((rows,), p_cap))
    mean = torch.randn((p_cap, 3), generator=g) * 0.1
    scale = torch.rand(p_cap, generator=g) * 5 + 1
    offset = torch.rand((p_cap, 3), generator=g) * s / 2
    f = torch.randn((rows, c), generator=g).to(torch.bfloat16)
    args = (pidx, pid, valid, mean, scale, offset)
    want = proposal_voxelize.place_plain(f, coords, *args, p_cap, s)
    before = build.LAUNCHES["proposal_voxelize_bf16"]
    got = proposal_voxelize.place_cuda(f.to(dev), coords.to(dev), *(a.to(dev) for a in args),
                                       p_cap, s)
    assert build.LAUNCHES["proposal_voxelize_bf16"] == before + 1
    assert got[0].dtype == torch.bfloat16
    assert torch.equal(got[0].cpu().view(torch.int16), want[0].view(torch.int16))
    for name, w, k in zip(("occ", "row_cell", "cell_w"), want[1:], got[1:]):
        assert torch.equal(k.cpu(), w), name


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
    got, got_r2v, got_f = sparse.build_plan(batch.to(dev), coords.to(dev), valid.to(dev), caps,
                                            4, feats.to(dev))
    assert int(want.levels[0].n_dropped) > 0      # level 0 overflows
    assert torch.equal(got_r2v.cpu(), want_r2v) and torch.equal(got_f.cpu(), want_f)
    a, b = sparse.plan_arrays(got, got_r2v), sparse.plan_arrays(want, want_r2v)
    assert a.keys() == b.keys()
    for k in b:
        assert torch.equal(a[k].cpu(), b[k]), k


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
