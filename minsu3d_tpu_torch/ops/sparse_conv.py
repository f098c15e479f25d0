"""Sparse convolutions over grid plans, all through one kernel, gather_gemm.

Counterparts of minsu3d_tpu/ops/sparse_conv.py:
  * ``subm_conv`` (:50)  3^3 submanifold conv, T = 27 taps, idx = nbr_idx;
  * ``down_conv`` (:66)  k2s2 strided conv, in GATHER form: the (child ->
    parent, kid) links are inverted into child_of[parent, kid] by an index
    scatter (the pairs are unique), so every parent row sums its own <= 8
    children and no float atomics are needed;
  * ``up_conv``   (:80)  k2s2 transposed conv: row c holds parent_idx[c]
    in column child_kid[c], every other column is absent.
Rows that are not valid come out 0, as in the JAX code. Sums are f32; the
plain version and the kernel add in different orders, so they agree to f32
rounding (about 1e-6 relative at these depths), not bit for bit.

Gradients (``GatherConv``), in the gather form of the JAX package's
hand-written conv backward ``subm_conv_blocked_vjp`` (:306-376), applied to
the default convs above:
  * dx runs on K1 itself, over a transposed index: a 3^3 submanifold conv's
    transpose is a submanifold conv with negated offsets (tap k <-> 26 - k in
    KERNEL_OFFSETS order) and the kernel transposed, which needs nbr_idx to
    be symmetric (nbr_idx[i, k] = j  <=>  nbr_idx[j, 26 - k] = i); the down
    conv's transpose gathers over ``up_index`` and the up conv's over
    ``down_index``, with the kernel transposed;
  * dW runs on K4 ``gather_wgrad`` (csrc/gather_wgrad.cu):
    dW[t] = sum_r x~[idx[r, t]]^T dout[r].
The autograd node saves only (x, w) and the two index tables, so a conv
keeps its input alive and nothing 27x wider: the memory of the JAX
package's conv-granularity remat without its recompute.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from minsu3d_tpu_torch.csrc import build


def gather_gemm_plain(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[r] = sum_t x[idx[r, t]] @ w[t]; idx == x.shape[0] reads a zero row."""
    n, cin = x.shape
    taps, _, cout = w.shape
    xe = torch.cat([x, x.new_zeros((1, cin))])
    g = xe[idx.long()]                                   # (R, T, Cin)
    return g.reshape(idx.shape[0], taps * cin) @ w.reshape(taps * cin, cout)


def gather_gemm(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K1 (csrc/gather_gemm.cu) on CUDA tensors, the plain version on CPU ones.

    x (n_rows, Cin) f32, idx (R, T) int32 with n_rows = absent, w (T, Cin,
    Cout) f32; returns (R, Cout) f32. The int32 table goes to the kernel
    as it is; the plain version widens it to int64 for indexing."""
    if x.dim() != 2 or idx.dim() != 2 or w.dim() != 3:
        raise ValueError(f"gather_gemm: bad ranks x{tuple(x.shape)} idx{tuple(idx.shape)} "
                         f"w{tuple(w.shape)}")
    if w.shape[0] != idx.shape[1] or w.shape[1] != x.shape[1]:
        raise ValueError(f"gather_gemm: shapes disagree: x{tuple(x.shape)} "
                         f"idx{tuple(idx.shape)} w{tuple(w.shape)}")
    if x.dtype != torch.float32 or w.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"gather_gemm: want f32 x/w and int32 idx, got {x.dtype}, "
                        f"{w.dtype}, {idx.dtype}")
    devices = {x.device, idx.device, w.device}
    if len(devices) != 1:
        raise ValueError(f"gather_gemm: tensors on several devices {devices}")
    if x.device.type == "cpu":
        return gather_gemm_plain(x, idx, w)
    if x.device.type != "cuda":
        raise ValueError(f"gather_gemm: unsupported device {x.device}")
    if not (x.is_contiguous() and idx.is_contiguous() and w.is_contiguous()):
        raise ValueError("gather_gemm: CUDA inputs must be contiguous")
    out = torch.empty((idx.shape[0], w.shape[2]), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(build.kernel_lib().ms3d_gather_gemm(
        x.data_ptr(), x.shape[0], x.shape[1], idx.data_ptr(), idx.shape[0], idx.shape[1],
        w.data_ptr(), w.shape[2], out.data_ptr(), stream), "gather_gemm")
    build.LAUNCHES["gather_gemm"] += 1
    return out


def gather_wgrad_plain(x: torch.Tensor, idx: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """dW[t] = sum_r x~[idx[r, t]]^T dout[r] (x~: x with a zero row appended)."""
    n = x.shape[0]
    xe = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    idx = idx.long()
    idx = torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))  # absent: zero row
    return torch.einsum("rtc,ro->tco", xe[idx], dout)


def gather_wgrad(x: torch.Tensor, idx: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """K4 (csrc/gather_wgrad.cu) on CUDA tensors, the plain version on CPU ones.

    x (n_rows, Cin) f32, idx (R, T) int32 (outside [0, n_rows) = absent),
    dout (R, Cout) f32; returns (T, Cin, Cout) f32, deterministic on the card
    (per-chunk partials summed in chunk order, no float atomics)."""
    if x.dim() != 2 or idx.dim() != 2 or dout.dim() != 2 or dout.shape[0] != idx.shape[0]:
        raise ValueError(f"gather_wgrad: bad shapes x{tuple(x.shape)} idx{tuple(idx.shape)} "
                         f"dout{tuple(dout.shape)}")
    if x.dtype != torch.float32 or dout.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"gather_wgrad: want f32 x/dout and int32 idx, got {x.dtype}, "
                        f"{dout.dtype}, {idx.dtype}")
    devices = {x.device, idx.device, dout.device}
    if len(devices) != 1:
        raise ValueError(f"gather_wgrad: tensors on several devices {devices}")
    if x.device.type == "cpu":
        return gather_wgrad_plain(x, idx, dout)
    if x.device.type != "cuda":
        raise ValueError(f"gather_wgrad: unsupported device {x.device}")
    if not (x.is_contiguous() and idx.is_contiguous() and dout.is_contiguous()):
        raise ValueError("gather_wgrad: CUDA inputs must be contiguous")
    rows, taps = idx.shape
    cin, cout = x.shape[1], dout.shape[1]
    lib = build.kernel_lib()
    out = torch.empty((taps, cin, cout), dtype=torch.float32, device=x.device)
    n_chunks = lib.ms3d_gather_wgrad_chunks(rows)
    partial = (out if n_chunks <= 1 else
               torch.empty((n_chunks, taps, cin, cout), dtype=torch.float32, device=x.device))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(lib.ms3d_gather_wgrad(
        x.data_ptr(), x.shape[0], cin, idx.data_ptr(), rows, taps, dout.data_ptr(), cout,
        partial.data_ptr(), out.data_ptr(), stream), "gather_wgrad")
    build.LAUNCHES["gather_wgrad"] += 1
    return out


class GatherConv(torch.autograd.Function):
    """out = gather_gemm(x, idx, w) with the gather-form backward:
    dx = gather_gemm(dout, idx_t, w'^T) where w' flips the taps when
    ``flip`` (subm conv) and is w otherwise (k2s2 convs); dW = gather_wgrad(
    x, idx, dout). ``idx_t`` is the transposed index: row j of x lists, per
    tap, the output row that reads j there (dout.shape[0] = absent)."""

    @staticmethod
    def forward(ctx, x, w, idx, idx_t, flip: bool):
        ctx.save_for_backward(x, w, idx, idx_t)
        ctx.flip = flip
        return gather_gemm(x, idx, w)

    @staticmethod
    def backward(ctx, dout):
        x, w, idx, idx_t = ctx.saved_tensors
        dout = dout.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            wt = (w.flip(0) if ctx.flip else w).transpose(1, 2).contiguous()
            dx = gather_gemm(dout, idx_t, wt)
        if ctx.needs_input_grad[1]:
            dw = gather_wgrad(x, idx, dout)
        return dx, dw, None, None, None


def subm_conv(feats: torch.Tensor, level, weight: torch.Tensor) -> torch.Tensor:
    """3^3 submanifold conv: feats (V, Cin), weight (27, Cin, Cout)."""
    return GatherConv.apply(feats, weight, level.nbr_idx, level.nbr_idx, True)


def down_index(child, parent_cap: int) -> torch.Tensor:
    """child_of (parent_cap, 8) int32: the child row of each (parent, kid),
    child.cap where the parent has no such child."""
    n = child.cap
    ok = child.valid & (child.parent_idx < parent_cap)
    flat = child.parent_idx.long() * 8 + child.child_kid.long()
    child_of = torch.full((parent_cap * 8,), n, dtype=torch.int32, device=flat.device)
    rows = torch.arange(n, dtype=torch.int32, device=flat.device)
    child_of[flat[ok]] = rows[ok]
    return child_of.view(parent_cap, 8)


def up_index(child, parent_cap: int) -> torch.Tensor:
    """(V, 8) int32: parent_idx[c] in column child_kid[c] of valid rows,
    parent_cap (absent) everywhere else."""
    idx = torch.full((child.cap, 8), parent_cap, dtype=torch.int32,
                     device=child.parent_idx.device)
    par = torch.where(child.valid, child.parent_idx,
                      torch.full_like(child.parent_idx, parent_cap))
    idx.scatter_(1, child.child_kid.long()[:, None], par[:, None])
    return idx


class Links(NamedTuple):
    """Both k2s2 index tables of one child level: the down conv gathers over
    ``down`` and its dx over ``up``; the up conv the other way round. Built
    once per level and forward pass, shared by the level's two convs."""

    down: torch.Tensor  # (parent_cap, 8) child row per (parent, kid)
    up: torch.Tensor    # (child_cap, 8) parent row in column child_kid


def links(child, parent_cap: int) -> Links:
    return Links(down_index(child, parent_cap), up_index(child, parent_cap))


def down_conv(feats: torch.Tensor, lk: Links, weight: torch.Tensor) -> torch.Tensor:
    """k2s2 strided conv child -> parent over the child level's ``links``:
    weight (8, Cin, Cout)."""
    return GatherConv.apply(feats, weight, lk.down, lk.up, False)


def up_conv(parent_feats: torch.Tensor, lk: Links, weight: torch.Tensor) -> torch.Tensor:
    """k2s2 transposed conv parent -> child over the child level's ``links``:
    weight (8, Cp, Cc)."""
    return GatherConv.apply(parent_feats, weight, lk.up, lk.down, False)
