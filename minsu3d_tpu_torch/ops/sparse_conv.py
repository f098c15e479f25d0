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

Precision: a conv runs in its input's dtype. f32 features take the f32
weight as it is; bf16 features (the backbone of a ``precision=bfloat16``
config, which casts its input once) round the f32 weight to bf16 once per
call, multiply bf16 by bf16, sum in f32 and round the sum once to bf16: the
rounding points of the JAX package's ``_mm`` with compute_dtype=bfloat16
(:30-43) and of its convs' final ``astype`` (:63, :77, :91). There the
down conv rounds after its f32 scatter over the children; K1's gather form
sums the children in the same f32 accumulator, so it rounds at the same
point. Kernel and plain version then differ by at most one bf16 ulp where
their f32 sums round to neighbouring values.

Gradients (``GatherConv``), in the gather form of the JAX package's
hand-written conv backward ``subm_conv_blocked_vjp`` (:306-376), applied to
the default convs above. dx gathers over a transposed index: a 3^3
submanifold conv's transpose is a submanifold conv with negated offsets
(tap k <-> 26 - k in KERNEL_OFFSETS order) and the kernel transposed, which
needs nbr_idx to be symmetric (nbr_idx[i, k] = j  <=>  nbr_idx[j, 26 - k] =
i); the down conv's transpose gathers over ``up_index`` and the up conv's
over ``down_index``, with the kernel transposed. dW is
dW[t] = sum_r x~[idx[r, t]]^T dout[r].
  * f32: dx on K1 itself, dW on K4 ``gather_wgrad`` (csrc/gather_wgrad.cu).
  * bf16, with the rounding points of ``jax.grad`` through the JAX convs
    (the golden configs run them under autodiff, not under the hand-written
    VJP, and the two round differently): dx on K13 ``gather_dx_bf16``
    (csrc/gather_dx.cu): each (source row, tap) contribution is an f32 dot
    over Cout rounded to bf16, and a row's contributions are added in
    source-row order with a rounding after every add, as XLA's bf16
    scatter-add does; dW on K4's bf16 variant: the f32 sum of bf16 x times
    the bf16 cotangent, rounded once to bf16 (the weight's cast) and handed
    to the f32 parameter widened.
The autograd node saves only (x, w) and the two index tables, so a conv
keeps its input alive and nothing 27x wider: the memory of the JAX
package's conv-granularity remat without its recompute.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from minsu3d_tpu_torch.csrc import build


def gather_gemm_plain(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[r] = sum_t x[idx[r, t]] @ w[t]; idx == x.shape[0] reads a zero row.
    bf16 x and w: the products and their sum in f32, rounded once to bf16."""
    n, cin = x.shape
    taps, _, cout = w.shape
    xe = torch.cat([x, x.new_zeros((1, cin))])
    g = xe[idx.long()].float()                           # (R, T, Cin)
    out = g.reshape(idx.shape[0], taps * cin) @ w.float().reshape(taps * cin, cout)
    return out.to(x.dtype)


# the element types K1 takes (x and w alike) with the launch count of each
# (``build.LAUNCHES``), which is also its C entry's name after ``ms3d_``
_LAUNCH_NAME = {torch.float32: "gather_gemm", torch.bfloat16: "gather_gemm_bf16"}


def gather_gemm(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K1 (csrc/gather_gemm.cu) on CUDA tensors, the plain version on CPU ones.

    x (n_rows, Cin), idx (R, T) int32 with n_rows = absent, w (T, Cin,
    Cout), x and w both f32 or both bf16; returns (R, Cout) in their dtype
    (f32 sums, rounded once in bf16). The int32 table goes to the kernel
    as it is; the plain version widens it to int64 for indexing."""
    if x.dim() != 2 or idx.dim() != 2 or w.dim() != 3:
        raise ValueError(f"gather_gemm: bad ranks x{tuple(x.shape)} idx{tuple(idx.shape)} "
                         f"w{tuple(w.shape)}")
    if w.shape[0] != idx.shape[1] or w.shape[1] != x.shape[1]:
        raise ValueError(f"gather_gemm: shapes disagree: x{tuple(x.shape)} "
                         f"idx{tuple(idx.shape)} w{tuple(w.shape)}")
    if x.dtype not in _LAUNCH_NAME or w.dtype != x.dtype or idx.dtype != torch.int32:
        raise TypeError(f"gather_gemm: want x and w both f32 or both bf16 and int32 idx, got "
                        f"{x.dtype}, {w.dtype}, {idx.dtype}")
    devices = {x.device, idx.device, w.device}
    if len(devices) != 1:
        raise ValueError(f"gather_gemm: tensors on several devices {devices}")
    if x.device.type == "cpu":
        return gather_gemm_plain(x, idx, w)
    if x.device.type != "cuda":
        raise ValueError(f"gather_gemm: unsupported device {x.device}")
    if not (x.is_contiguous() and idx.is_contiguous() and w.is_contiguous()):
        raise ValueError("gather_gemm: CUDA inputs must be contiguous")
    out = torch.empty((idx.shape[0], w.shape[2]), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    count = _LAUNCH_NAME[x.dtype]
    build.check(getattr(build.kernel_lib(), "ms3d_" + count)(
        x.data_ptr(), x.shape[0], x.shape[1], idx.data_ptr(), idx.shape[0], idx.shape[1],
        w.data_ptr(), w.shape[2], out.data_ptr(), stream), count)
    build.LAUNCHES[count] += 1
    return out


def _absent_to(idx: torch.Tensor, n: int) -> torch.Tensor:
    """idx as int64 with every value outside [0, n) replaced by n."""
    idx = idx.long()
    return torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))


def gather_wgrad_plain(x: torch.Tensor, idx: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """dW[t] = sum_r x~[idx[r, t]]^T dout[r] (x~: x with a zero row appended),
    summed in f32; bf16 x and dout: widened, and the sum rounded once to
    bf16 and returned widened to f32."""
    xe = torch.cat([x, x.new_zeros((1, x.shape[1]))]).float()
    dw = torch.einsum("rtc,ro->tco", xe[_absent_to(idx, x.shape[0])], dout.float())
    return dw.to(torch.bfloat16).float() if x.dtype == torch.bfloat16 else dw


# the element types K4 takes (x and dout alike) with their C entries and
# launch counts
_WGRAD = {torch.float32: "gather_wgrad", torch.bfloat16: "gather_wgrad_bf16"}


def gather_wgrad(x: torch.Tensor, idx: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """K4 (csrc/gather_wgrad.cu) on CUDA tensors, the plain version on CPU ones.

    x (n_rows, Cin) and dout (R, Cout) both f32 or both bf16, idx (R, T)
    int32 (outside [0, n_rows) = absent); returns (T, Cin, Cout) f32 (in
    bf16, the f32 sum rounded once to bf16), deterministic on the card
    (per-chunk partials summed in chunk order, no float atomics)."""
    if x.dim() != 2 or idx.dim() != 2 or dout.dim() != 2 or dout.shape[0] != idx.shape[0]:
        raise ValueError(f"gather_wgrad: bad shapes x{tuple(x.shape)} idx{tuple(idx.shape)} "
                         f"dout{tuple(dout.shape)}")
    if x.dtype not in _WGRAD or dout.dtype != x.dtype or idx.dtype != torch.int32:
        raise TypeError(f"gather_wgrad: want x and dout both f32 or both bf16 and int32 idx, "
                        f"got {x.dtype}, {dout.dtype}, {idx.dtype}")
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
    count = _WGRAD[x.dtype]
    build.check(getattr(lib, "ms3d_" + count)(
        x.data_ptr(), x.shape[0], cin, idx.data_ptr(), rows, taps, dout.data_ptr(), cout,
        partial.data_ptr(), out.data_ptr(), stream), count)
    build.LAUNCHES[count] += 1
    return out


def gather_dx_bf16_plain(dout: torch.Tensor, idx_t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K13's plain version, step for step: per (row j, tap t) the
    contribution of source i = idx_t[j, t] is an f32 chain over Cout of
    products, each rounded (no fused multiply-add), summed in index order
    from +0.0 and rounded to bf16; a row's contributions, sorted by (i, t),
    are added to a +0.0 bf16 accumulator with a rounding after every add.
    Absent taps read a zero row (a +0.0 contribution, which leaves the
    accumulator as it is)."""
    r, cout = dout.shape
    n, taps = idx_t.shape
    cin = w.shape[2]
    src = _absent_to(idx_t, r)
    g = torch.cat([dout, dout.new_zeros((1, cout))]).float()[src]      # (N, T, Cout)
    wf = w.float()
    dot = torch.zeros((n, taps, cin), dtype=torch.float32, device=dout.device)
    for o in range(cout):
        dot = dot + g[:, :, o, None] * wf[None, :, o, :]
    order = torch.sort(src, dim=1, stable=True).indices
    contrib = dot.to(torch.bfloat16).gather(1, order[:, :, None].expand(-1, -1, cin))
    acc = torch.zeros((n, cin), dtype=torch.float32, device=dout.device)
    for t in range(taps):
        acc = (acc + contrib[:, t].float()).to(torch.bfloat16).float()
    return acc.to(torch.bfloat16)


def gather_dx_bf16(dout: torch.Tensor, idx_t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K13 (csrc/gather_dx.cu) on CUDA tensors, the plain version on CPU ones.

    dout (R, Cout) bf16, idx_t (N, T) int32 with R (or any value outside
    [0, R)) = absent, T <= 32, w (T, Cout, Cin) bf16; returns (N, Cin) bf16:
    the input gradient of a bf16 sparse conv with the JAX bf16 train step's
    rounding points (see the module docstring)."""
    if dout.dim() != 2 or idx_t.dim() != 2 or w.dim() != 3:
        raise ValueError(f"gather_dx_bf16: bad ranks dout{tuple(dout.shape)} "
                         f"idx_t{tuple(idx_t.shape)} w{tuple(w.shape)}")
    if w.shape[0] != idx_t.shape[1] or w.shape[1] != dout.shape[1] or idx_t.shape[1] > 32:
        raise ValueError(f"gather_dx_bf16: shapes disagree: dout{tuple(dout.shape)} "
                         f"idx_t{tuple(idx_t.shape)} w{tuple(w.shape)}")
    if dout.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or idx_t.dtype != torch.int32:
        raise TypeError(f"gather_dx_bf16: want bf16 dout and w and int32 idx_t, got "
                        f"{dout.dtype}, {w.dtype}, {idx_t.dtype}")
    devices = {dout.device, idx_t.device, w.device}
    if len(devices) != 1:
        raise ValueError(f"gather_dx_bf16: tensors on several devices {devices}")
    if dout.device.type == "cpu":
        return gather_dx_bf16_plain(dout, idx_t, w)
    if dout.device.type != "cuda":
        raise ValueError(f"gather_dx_bf16: unsupported device {dout.device}")
    if not (dout.is_contiguous() and idx_t.is_contiguous() and w.is_contiguous()):
        raise ValueError("gather_dx_bf16: CUDA inputs must be contiguous")
    out = torch.empty((idx_t.shape[0], w.shape[2]), dtype=torch.bfloat16, device=dout.device)
    stream = torch.cuda.current_stream(dout.device).cuda_stream
    build.check(build.kernel_lib().ms3d_gather_dx_bf16(
        dout.data_ptr(), dout.shape[0], dout.shape[1], idx_t.data_ptr(), idx_t.shape[0],
        idx_t.shape[1], w.data_ptr(), w.shape[2], out.data_ptr(), stream), "gather_dx_bf16")
    build.LAUNCHES["gather_dx_bf16"] += 1
    return out


class GatherConv(torch.autograd.Function):
    """out = gather_gemm(x, idx, w), w the f32 ``weight`` in x's dtype (bf16
    features round it once per call, as ``_mm`` casts it, sparse_conv.py:38),
    with the gather-form backward over the transposed weight w' (the taps
    flipped when ``flip``, the subm conv; as they are for the k2s2 convs):
    f32 dx = gather_gemm(dout, idx_t, w'^T), bf16 dx = gather_dx_bf16(dout,
    idx_t, w'^T); dW = gather_wgrad(x, idx, dout), f32 for the f32 weight.
    ``idx_t`` is the transposed index: row j of x lists, per tap, the output
    row that reads j there (dout.shape[0] = absent)."""

    @staticmethod
    def forward(ctx, x, weight, idx, idx_t, flip: bool):
        w = weight.to(x.dtype)
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
            dx = (gather_dx_bf16 if x.dtype == torch.bfloat16 else gather_gemm)(dout, idx_t, wt)
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
