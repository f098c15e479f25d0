"""Kernels K5 (with a row mask) and K6-K13 against their plain versions on
the card, at small shapes,
bit for bit (integers and the ordered f32 sums alike); the bf16 variants of
K1 and K4 (within one bf16 ulp, or the f32 tolerance where a sum cancels),
K6 (max, min and the per-add-rounded sum), K7 and K13 (bit for bit). They need a GPU and
``nvcc`` and skip without CUDA. This file imports no JAX, so it runs on a
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``chip_smoke.py`` holds the same kernels against their plain versions at
the main path's shapes.)
"""

import pytest
import torch

from minsu3d_tpu_torch.csrc import build
from minsu3d_tpu_torch.ops import (cluster, instance_iou, proposal_rank, proposal_voxelize,
                                   segment, set_aggregation, sparse_conv, stable_partition)

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
        for name, w, k in zip(("point_cluster", "sizes", "count", "seg_sizes"), want, got):
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
