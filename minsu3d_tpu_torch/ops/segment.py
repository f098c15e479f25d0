"""Segment reductions over per-row segment ids (padded rows carry
``num_segments``): the port of minsu3d_tpu/ops/segment.py:40-76, on kernel
K6 ``segment_reduce`` (csrc/segment_reduce.cu) for CUDA tensors and on its
plain version for CPU ones. An empty segment reads 0, as in the JAX code.

Every reduction goes through a CSR of the segment ids (``segment_csr``): the
row ids sorted stably by segment, and the segment offsets. Rows of the
padding segment are never reduced. A sum adds a segment's rows in row order
from +0.0, the order of XLA:CPU's scatter-add and of torch's CPU
``index_add_``, so the card's sums equal the CPU's and the JAX package's bit
for bit and repeat from run to run: no float atomics anywhere. A bf16 sum
rounds to bf16 after every add, as XLA:CPU's bf16 scatter-add does (the
transpose of every bf16 row gather in the JAX package's bf16 train step):
rows in another order, or one rounding at the end, give other bits.

Gradients equal ``jax.grad`` of the JAX functions: a segment sum's is a
gather; a segment's min or max splits its cotangent evenly among the rows
that tie for it (empty segments take no gradient; a zero seed would count as
one more tie whenever a segment's extreme is exactly 0, which is common
after a ReLU, e.g. roipool of the ScoreNet's output).

``gather_rows`` is the row gather ``x[idx]`` of the heads and the backbone's
devoxelization, whose backward is K6's ordered sum of the cotangent rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from minsu3d_tpu_torch.csrc import build
from minsu3d_tpu_torch.ops import hashing

OPS = {"sum": 0, "max": 1, "min": 2}


class CSR(NamedTuple):
    seg: torch.Tensor       # (R,) int64 segment of every row, num_segments = padding
    perm: torch.Tensor      # (R,) int32 row ids sorted stably by segment, padding last
    offsets: torch.Tensor   # (S+1,) int32: segment s owns perm[offsets[s]:offsets[s+1]]
    num_segments: int


def segment_csr(seg_id: torch.Tensor, num_segments: int) -> CSR:
    """CSR of the rows by segment; ids outside [0, num_segments) are padding.
    Index preparation, not a reduction: a stable sort of the ids, which lie
    in [0, num_segments] and so take num_segments.bit_length() bits (K15 on
    the card), and the lower bound of every id from one pass over the
    sorted ids (K16's run offsets)."""
    seg = seg_id.long()
    seg = torch.where((seg >= 0) & (seg < num_segments), seg,
                      torch.full_like(seg, num_segments))
    sorted_seg, order = hashing.key_sort(seg, max(num_segments.bit_length(), 1))
    offsets = hashing.run_offsets(sorted_seg, num_segments)
    return CSR(seg, order, offsets, num_segments)


def extreme_step(acc: torch.Tensor, v: torch.Tensor, op: str) -> torch.Tensor:
    """One step of K6's max/min fold: v replaces acc where it is strictly
    greater (max) or smaller (min), or NaN. So a fold keeps the first
    extreme in row order (-0.0 and +0.0 tie) and the last NaN, with its
    bits; torch.maximum's pick among tied zeros and its NaN bits vary with
    the vector width. The operator is associative: pieces of a segment may
    be folded apart and then in piece order."""
    take = (v > acc) if op == "max" else (v < acc)
    return torch.where(take | (v != v), v, acc)


def segment_reduce_plain(x: torch.Tensor, csr: CSR, op: str, fill=0) -> torch.Tensor:
    """K6's plain version: the same per-segment fold in row order, one
    position of every segment at a time (segments ordered by length, so the
    k-th step touches only the segments longer than k), with K6's
    operators."""
    n_seg, c = csr.num_segments, x.shape[1]
    out = torch.full((n_seg, c), fill if op != "sum" else 0, dtype=x.dtype, device=x.device)
    beg = csr.offsets[:-1].long()
    lens = csr.offsets[1:].long() - beg
    ids = torch.nonzero(lens > 0)[:, 0]
    if ids.numel() == 0:
        return out
    lens = lens[ids]
    by_len = torch.sort(-lens, stable=True).indices
    ids, lens = ids[by_len], lens[by_len]
    starts = beg[ids]
    perm = csr.perm.long()
    len_list = lens.tolist()
    if op == "sum":
        acc = torch.zeros((ids.numel(), c), dtype=x.dtype, device=x.device)
        k0 = 0
    else:
        acc = x[perm[starts]]
        k0 = 1
    live = ids.numel()
    for k in range(k0, len_list[0]):
        while len_list[live - 1] <= k:
            live -= 1
        v = x[perm[starts[:live] + k]]
        if op == "sum":
            acc[:live] = acc[:live] + v   # bf16: widened, added, rounded, as K6
        else:
            acc[:live] = extreme_step(acc[:live], v, op)
    out[ids] = acc
    return out


# the C entry and the launch count of each row type K6 takes (bf16 sums
# count apart from bf16 max and min)
_ENTRY = {torch.float32: ("ms3d_segment_reduce_f32", "segment_reduce"),
          torch.int32: ("ms3d_segment_reduce_i32", "segment_reduce"),
          torch.bfloat16: ("ms3d_segment_reduce_bf16", "segment_reduce_bf16")}


def _scratch_bytes(rows: int, c: int, ordered: bool, elem: int) -> int:
    """K6's scratch (``scratch_bytes`` in csrc/segment_reduce.cu, which
    checks it): none for an ordered sum, else two pieces of C values a
    chunk of 32 sorted rows."""
    return 0 if ordered else 2 * -(-rows // 32) * c * elem


def segment_reduce(x: torch.Tensor, csr: CSR, op: str, fill=0) -> torch.Tensor:
    """(S, C) per-segment ``op`` ("sum", "max", "min") of the rows of x
    (R, C), f32, int32 or bf16 (a bf16 sum rounds after every add, in row
    order); an empty segment reads ``fill`` (0 for a sum). K6 on CUDA
    tensors (one launch for an f32/bf16 sum, two otherwise; no host sync),
    the plain version on CPU ones."""
    if x.dim() != 2 or x.shape[0] != csr.seg.shape[0]:
        raise ValueError(f"segment_reduce: x {tuple(x.shape)} for {csr.seg.shape[0]} rows")
    if op not in OPS:
        raise ValueError(f"segment_reduce: unknown op {op!r}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"segment_reduce: want f32, int32 or bf16 rows, got {x.dtype}")
    if x.device != csr.perm.device:
        raise ValueError(f"segment_reduce: x on {x.device}, CSR on {csr.perm.device}")
    if x.device.type == "cpu":
        return segment_reduce_plain(x, csr, op, fill)
    if x.device.type != "cuda":
        raise ValueError(f"segment_reduce: unsupported device {x.device}")
    x = x.contiguous()
    rows, c = x.shape
    out = torch.empty((csr.num_segments, c), dtype=x.dtype, device=x.device)
    n_scratch = _scratch_bytes(rows, c, op == "sum" and x.dtype != torch.int32,
                               x.element_size())
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=x.device) if n_scratch else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    entry, count = _ENTRY[x.dtype]
    if x.dtype == torch.bfloat16 and op == "sum":
        count = "segment_reduce_bf16_sum"
    build.check(getattr(build.kernel_lib(), entry)(
        x.data_ptr(), rows, c, csr.perm.data_ptr(), csr.seg.data_ptr(), csr.offsets.data_ptr(),
        csr.num_segments, OPS[op], int(fill) if x.dtype == torch.int32 else float(fill),
        out.data_ptr(), scratch.data_ptr() if n_scratch else None, n_scratch, stream), count)
    build.LAUNCHES[count] += 1
    return out


def _pad_row(t: torch.Tensor) -> torch.Tensor:
    return torch.cat([t, t.new_zeros((1,) + t.shape[1:])])


class SegmentSum(torch.autograd.Function):
    """(S, C) ordered segment sum; backward: each row reads its segment's
    cotangent (padding rows 0)."""

    @staticmethod
    def forward(ctx, x, csr):
        ctx.csr = csr
        return segment_reduce(x, csr, "sum")

    @staticmethod
    def backward(ctx, g):
        return torch.index_select(_pad_row(g), 0, ctx.csr.seg), None


class SegmentExtreme(torch.autograd.Function):
    """(S, C) segment max or min, 0 for an empty segment; backward: the
    cotangent split evenly among the rows that tie for the extreme."""

    @staticmethod
    def forward(ctx, x, csr, op):
        out = segment_reduce(x, csr, op, 0.0)
        ctx.csr = csr
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        csr = ctx.csr
        inside = (csr.seg < csr.num_segments)[:, None]
        tie = (x == torch.index_select(_pad_row(out), 0, csr.seg)) & inside
        # tie counts are small integers: summed as int32 (K6's order-free
        # path), they equal the f32 sums of ones, in f32 for bf16 rows too
        cnt = segment_reduce(tie.to(torch.int32), csr, "sum").float()
        share = g / cnt.clamp(min=1.0)
        grad = torch.index_select(_pad_row(share), 0, csr.seg)
        return torch.where(tie, grad, torch.zeros_like(grad)), None, None


class GatherRows(torch.autograd.Function):
    """``x[idx]`` with idx == x.shape[0] reading a zero row. The forward is
    an index_select; the backward sums the cotangent rows of each row of x
    in row order on K6, in x's dtype (bf16 rows round after every add; the
    CSR of idx is built in the forward, and only when x needs a gradient)."""

    @staticmethod
    def forward(ctx, x, idx):
        n = x.shape[0]
        ok = idx < n
        out = torch.index_select(x, 0, idx.clamp(max=max(n - 1, 0)))
        out = out.masked_fill(~ok[:, None], 0.0)
        ctx.csr = segment_csr(idx, n) if ctx.needs_input_grad[0] else None
        return out

    @staticmethod
    def backward(ctx, g):
        return segment_reduce(g.contiguous(), ctx.csr, "sum"), None


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(R, C) rows ``x[idx]``; idx (R,) int64 in [0, x.shape[0]], the last
    value reading zeros. Its gradient is an ordered segment sum (K6)."""
    if x.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"gather_rows: x {tuple(x.shape)}, idx {tuple(idx.shape)}")
    return GatherRows.apply(x, idx.long())


def valid_csr(seg_id, valid, num_segments: int) -> CSR:
    """The CSR of the rows whose ``valid`` is set, by ``seg_id`` (the other
    rows are padding): what ``sec_mean``/``sec_min``/``sec_max``/``roipool``
    reduce over. A caller that reduces the same rows several times builds
    it once and calls the ``csr_*`` functions."""
    seg = torch.where(valid, seg_id.long(), torch.full_like(seg_id.long(), num_segments))
    return segment_csr(seg, num_segments)


def csr_mean(data: torch.Tensor, csr: CSR) -> torch.Tensor:
    """Per-segment mean over a CSR: an ordered sum on K6 over the count."""
    tot = SegmentSum.apply(data.contiguous(), csr)
    cnt = (csr.offsets[1:] - csr.offsets[:-1]).clamp(min=1)
    return tot / cnt[:, None].to(data.dtype)


def csr_min(data: torch.Tensor, csr: CSR) -> torch.Tensor:
    return SegmentExtreme.apply(data.contiguous(), csr, "min")


def csr_max(data: torch.Tensor, csr: CSR) -> torch.Tensor:
    return SegmentExtreme.apply(data.contiguous(), csr, "max")


def sec_mean(data: torch.Tensor, seg_id: torch.Tensor, valid: torch.Tensor,
             num_segments: int) -> torch.Tensor:
    return csr_mean(data, valid_csr(seg_id, valid, num_segments))


def sec_min(data, seg_id, valid, num_segments: int) -> torch.Tensor:
    return csr_min(data, valid_csr(seg_id, valid, num_segments))


def sec_max(data, seg_id, valid, num_segments: int) -> torch.Tensor:
    return csr_max(data, valid_csr(seg_id, valid, num_segments))


def roipool(feats, seg_id, valid, num_segments: int) -> torch.Tensor:
    """Per-segment channelwise max (reference roipool_fp); empty -> 0."""
    return sec_max(feats, seg_id, valid, num_segments)


def global_avg_pool(feats, seg_id, valid, num_segments: int) -> torch.Tensor:
    """Per-segment mean-pool with the exact mean backward (reference
    global_avg_pool, segment.py:73): ``sec_mean``, an ordered sum on K6
    divided by the count; each valid row's gradient is its segment's
    cotangent over the count."""
    return sec_mean(feats, seg_id, valid, num_segments)
