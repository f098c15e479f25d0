"""The stable partition of a flag matrix, true first, with SoftGroup's pair
packing or ``compact_rows``' gather around it: kernel K10
``stable_partition`` (csrc/stable_partition.cu) for CUDA tensors, the plain
versions for CPU ones.

Counterparts of minsu3d_tpu/model/softgroup.py:121-127 (``pack_pairs``:
the (point, class) pairs of the (N, K) class flags, packed class-major by
``argsort(~act_kn, stable=True)[:pair_cap]``) and :181-189
(``compact_rows``: the valid rows first, in row order, into ``r_cap``
rows). The false tail of the partition matters: an invalid pair's point is
``order % N``, an invalid kept row the row at its index. The plain versions
spell out the JAX lines in torch; the kernel computes each call in one
launch on the caller's arrays (no transposed copy, no cast, no memset, no
host sync).
"""

from __future__ import annotations

import torch

from minsu3d_tpu_torch.csrc import build
from minsu3d_tpu_torch.ops.hashing import _stream

MAX_CLASSES = 64          # the kernel's columns (csrc/stable_partition.cu kMaxK)
_SCRATCH = 64 * 256       # its (class, block) counts, kMaxK x kMaxGrid int32


def pack_pairs_plain(active: torch.Tensor, pair_cap: int) -> tuple:
    n = active.shape[0]
    act_kn = active.t().reshape(-1)                              # (K*N,) class-major
    order = torch.argsort(~act_kn, stable=True)[:pair_cap]
    pair_valid = act_kn[order]
    pair_class = torch.where(pair_valid, order // max(n, 1), torch.zeros_like(order))
    pairs_dropped = (act_kn.sum() - pair_cap).clamp(min=0)
    return order % max(n, 1), pair_class, pair_valid, pairs_dropped


def _launch(flags: torch.Tensor, n: int, k: int, cap: int, src_a=None, src_b=None) -> tuple:
    """One K10 launch over the (n, k) flags, min(cap, n * k) slots: (out_a,
    out_b int64, valid bool), and for the pair packing (no sources) its
    dropped () int64."""
    m = min(cap, n * k)
    packing = src_a is None
    dev = flags.device
    out = torch.empty(2 * m + packing, dtype=torch.int64, device=dev)   # out_a, out_b, dropped
    valid = torch.empty(m, dtype=torch.bool, device=dev)
    scratch = torch.empty(_SCRATCH, dtype=torch.int32, device=dev)
    build.check(build.kernel_lib().ms3d_stable_partition(
        flags.data_ptr(), n, k, cap, 0 if packing else src_a.data_ptr(),
        0 if packing else src_b.data_ptr(), out.data_ptr(), out.data_ptr() + 8 * m,
        valid.data_ptr(), out.data_ptr() + 16 * m if packing else 0, scratch.data_ptr(),
        _stream(flags)), "stable_partition")
    build.LAUNCHES["stable_partition"] += 1
    if packing:
        return out[:m], out[m:2 * m], valid, out[2 * m]
    return out[:m], out[m:], valid


def pack_pairs_cuda(active: torch.Tensor, pair_cap: int) -> tuple:
    if active.dtype != torch.bool or active.dim() != 2:
        raise TypeError(f"pack_pairs: want an (N, K) bool tensor, got {active.dtype} "
                        f"{tuple(active.shape)}")
    n, k = active.shape
    if not 1 <= k <= MAX_CLASSES:
        raise ValueError(f"pack_pairs: {k} classes, the kernel takes 1 to {MAX_CLASSES}")
    return _launch(active.contiguous(), n, k, pair_cap)


def pack_pairs(active: torch.Tensor, pair_cap: int) -> tuple:
    """The active (point, class) pairs of the (N, K) bool class flags,
    packed class-major (pair i = c * N + p), at most ``pair_cap`` of them,
    the inactive pairs after them in the same order: (pair_point (P,)
    int64, pair_class (P,) int64 (0 where inactive), pair_valid (P,) bool,
    pairs_dropped () int64 = max(active pairs - pair_cap, 0)), P =
    min(pair_cap, N * K). K10 on a CUDA tensor."""
    if pair_cap < 0:
        raise ValueError(f"pack_pairs: pair_cap {pair_cap} < 0")
    if active.device.type == "cpu":
        return pack_pairs_plain(active, pair_cap)
    if active.device.type == "cuda":
        return pack_pairs_cuda(active, pair_cap)
    raise ValueError(f"pack_pairs: unsupported device {active.device}")


def compact_rows_plain(point_idx, prop_id, valid, r_cap: int) -> tuple:
    order = torch.argsort(~valid, stable=True)[:r_cap]
    return point_idx[order], prop_id[order], valid[order]


def compact_rows_cuda(point_idx, prop_id, valid, r_cap: int) -> tuple:
    if (point_idx.dtype, prop_id.dtype, valid.dtype) != (torch.int64, torch.int64, torch.bool):
        raise TypeError("compact_rows: takes point_idx and prop_id int64, valid bool")
    n = valid.shape[0]
    if valid.dim() != 1 or point_idx.shape != (n,) or prop_id.shape != (n,):
        raise ValueError("compact_rows: want three (R,) row arrays")
    if len({t.get_device() for t in (point_idx, prop_id, valid)}) != 1:
        raise ValueError("compact_rows: tensors on several devices")
    return _launch(valid.contiguous(), n, 1, r_cap, point_idx.contiguous(),
                   prop_id.contiguous())


def compact_rows(point_idx: torch.Tensor, prop_id: torch.Tensor, valid: torch.Tensor,
                 r_cap: int) -> tuple:
    """The rows (R,) whose ``valid`` is set first, in row order, then the
    others, into min(r_cap, R) rows: (point_idx, prop_id, valid). K10 with
    a gather epilogue on CUDA tensors."""
    if r_cap < 0:
        raise ValueError(f"compact_rows: r_cap {r_cap} < 0")
    if valid.device.type == "cpu":
        return compact_rows_plain(point_idx, prop_id, valid, r_cap)
    if valid.device.type == "cuda":
        return compact_rows_cuda(point_idx, prop_id, valid, r_cap)
    raise ValueError(f"compact_rows: unsupported device {valid.device}")
