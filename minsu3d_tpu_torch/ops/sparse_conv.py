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

K1 reads each table through its ``TapOrder``: the rows sorted by their set
of live taps, so that a kernel tile of 16 consecutive rows runs only the
taps its rows use. ``conv_tables`` builds every level's kernel-map order
and k2s2 ``links`` with theirs once per forward pass (on the card one K22
launch, which also builds the k2s2 tables, after a memset of its
histograms); the subm table is symmetric, so its order serves the dx too.
The backward kernels walk the same orders: K4 the forward table's, K13
(and K1 as the f32 dx) the transposed table's. An order holds the table it was built from, and each
kernel refuses it for any other table.

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

import array
from typing import NamedTuple, Optional

import torch

from minsu3d_tpu_torch.csrc import build
from minsu3d_tpu_torch.ops import hashing


def gather_gemm_plain(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[r] = sum_t x[idx[r, t]] @ w[t]; idx == x.shape[0] reads a zero row.
    bf16 x and w: the products and their sum in f32, rounded once to bf16."""
    n, cin = x.shape
    taps, _, cout = w.shape
    xe = torch.cat([x, x.new_zeros((1, cin))])
    g = xe[idx.long()].float()                           # (R, T, Cin)
    out = g.reshape(idx.shape[0], taps * cin) @ w.float().reshape(taps * cin, cout)
    return out.to(x.dtype)


class TapOrder(NamedTuple):
    """The rows of an index table ordered by their set of live taps, for K1:
    its tiles of 16 consecutive rows then run only the taps their rows use,
    and the rows with no live tap (sorted last) only write zeros."""

    perm: torch.Tensor      # (R,) int32: position -> row, stable
    key: torch.Tensor       # (R,) int64 sorted keys: bit t set where tap t is absent
    n_rows: int             # the table's absent marker (the source row count)
    table: torch.Tensor     # the (R, T) table it orders
    version: Optional[int]  # the table's version counter then (None: inference tensor)


def tap_key(idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """(R,) int64: bit t set where idx[r, t] >= n_rows (absent). A row with
    no live tap has every bit set, so it sorts after every live row; equal
    keys are equal sets of live taps."""
    bit = 1 << torch.arange(idx.shape[1], dtype=torch.int32, device=idx.device)
    return torch.where(idx >= n_rows, bit, 0).sum(1, dtype=torch.int64)


def tap_orders_plain(tables: list) -> list:
    """K22's plain version: one stable sort of ``tap_key`` a table."""
    out = []
    for idx, n_rows in tables:
        s_key, perm = hashing.key_sort_plain(tap_key(idx, n_rows))
        out.append(TapOrder(perm, s_key, n_rows, idx, _version(idx)))
    return out


# K22's tile of rows and its most digit buckets (csrc/tap_order.cu kTile,
# kBuckets), which size its work buffer; the kinds of table it takes
TAP_TILE = 2048
TAP_BUCKETS = 512
_GIVEN, _DOWN, _UP = 0, 1, 2


def _tap_launch(specs: list, dev: torch.device) -> list:
    """One K22 call (csrc/tap_order.cu: a memset and a launch) over
    ``specs``, each (kind, idx, rows, taps, absent marker, child level): a
    given table idx (kind ``_GIVEN``, child None), or a level boundary's
    down or up table built in the launch from the child level's
    ``parent_idx``, ``child_kid`` and ``valid`` (idx None). Returns each
    table's TapOrder, its table being the given one or the built (rows, 8)
    one. Everything the launch writes is a view of one buffer: the sorted
    keys, the permutations, the built tables and the sort's work, the views
    from three ``split`` calls (the host work of a call is what a
    host-bound forward feels)."""
    rows = [sp[2] for sp in specs]
    total = sum(rows)
    tiles = sum(-(-r // TAP_TILE) for r in rows)
    built_rows = [r for sp, r in zip(specs, rows) if sp[0] != _GIVEN]
    o_perm = 8 * total
    o_built = o_perm + 4 * total + (-(o_perm + 4 * total) % 16)
    o_work = o_built + 32 * sum(built_rows)
    passes = max(-(-sp[3] // min(sp[3], 9)) for sp in specs)   # digits of <= 9 bits
    work = 4 * (passes * tiles * TAP_BUCKETS + 4 * total)
    buf = torch.empty(o_work + work, dtype=torch.uint8, device=dev)
    base = buf.data_ptr()
    built = iter(buf[o_built:o_work].view(torch.int32).view(-1, 8).split(built_rows))
    # a built table is fresh: version 0, or an inference tensor
    fresh = None if torch.is_inference_mode_enabled() else 0
    desc, tabs, at = array.array("q"), [], base + o_built
    for kind, idx, r, taps, absent, child in specs:
        if kind == _GIVEN:
            desc.extend((kind, idx.data_ptr(), r, taps, absent, 0, 0, 0, 0))
            tabs.append((idx, _version(idx)))
        else:
            desc.extend((kind, at, r, taps, absent, child.parent_idx.data_ptr(),
                         child.child_kid.data_ptr(), child.valid.data_ptr(),
                         child.valid.shape[0]))
            tabs.append((next(built), fresh))
            at += 32 * r
    keys = buf[:o_perm].view(torch.int64)
    perm = buf[o_perm:o_perm + 4 * total].view(torch.int32)
    build.check(build.kernel_lib().ms3d_tap_tables(
        desc.buffer_info()[0], len(specs), base, base + o_perm, base + o_work, work,
        hashing._stream(buf)), "tap_orders")
    if total:
        build.LAUNCHES["tap_orders"] += 1
    return [TapOrder(p, k, sp[4], idx, version) for p, k, sp, (idx, version)
            in zip(perm.split(rows), keys.split(rows), specs, tabs)]


def tap_orders(tables: list) -> list:
    """[TapOrder] of each (idx (R, T) int32, n_rows) of ``tables`` (1 <= T
    <= 32, all on one device). K22 (csrc/tap_order.cu) on CUDA tables, at
    most 32 a call: one launch (after a memset of its histograms) sorts
    every table's rows stably by ``tap_key``, each table by its own digit
    histograms; the orders are views of one buffer. No host-device sync.
    The plain version on CPU tables."""
    if not tables:
        return []
    for idx, _ in tables:
        if idx.dtype != torch.int32 or idx.dim() != 2 or not 1 <= idx.shape[1] <= 32:
            raise TypeError(f"tap_orders: want (R, T <= 32) int32 tables, got {idx.dtype} "
                            f"{tuple(idx.shape)}")
    if len({idx.device for idx, _ in tables}) != 1:
        raise ValueError("tap_orders: tables on several devices")
    dev = tables[0][0].device
    if dev.type == "cpu":
        return tap_orders_plain(tables)
    if dev.type != "cuda":
        raise ValueError(f"tap_orders: unsupported device {dev}")
    if len(tables) > 32 or not all(idx.is_contiguous() for idx, _ in tables):
        raise ValueError("tap_orders: want at most 32 contiguous CUDA tables a call")
    return _tap_launch([(_GIVEN, idx, idx.shape[0], idx.shape[1], n, None)
                        for idx, n in tables], dev)


def tap_order(idx: torch.Tensor, n_rows: int) -> TapOrder:
    """The table's TapOrder (``tap_orders`` of this table alone)."""
    return tap_orders([(idx, n_rows)])[0]


def _version(t: torch.Tensor) -> Optional[int]:
    return None if t.is_inference() else t._version


def check_order(order: TapOrder, idx: torch.Tensor, n_rows: int,
                what: str = "gather_gemm") -> None:
    """Raise unless ``order`` is ``idx``'s TapOrder for ``n_rows`` source
    rows, unchanged since it was built: K1 and K4 pick a tile's taps from
    the order's keys alone, so the order of another table, even of the same
    shape, or of one edited in place would skip live taps (K13 would run
    its rows in a useless order). No sync: it compares storage, shape and
    version counter."""
    t = order.table
    if (t.data_ptr() != idx.data_ptr() or t.shape != idx.shape or t.device != idx.device
            or order.n_rows != n_rows):
        raise ValueError(f"{what}: tap order of another table (idx{tuple(t.shape)} at "
                         f"{t.data_ptr():#x}, {order.n_rows} source rows), given "
                         f"idx{tuple(idx.shape)} at {idx.data_ptr():#x}, {n_rows} source rows")
    if order.version != _version(idx):
        raise ValueError(f"{what}: the table was changed in place after its tap order "
                         "was built")


def tile_slots(order: TapOrder, taps: int, tile: int = 16) -> torch.Tensor:
    """() int64: the (row, tap) slots K1's tiles compute over ``order``:
    per tile of ``tile`` consecutive rows, its row count times the number
    of taps any of them uses. Set beside the live (row, tap) pairs it shows
    the work spent on dead taps."""
    r = order.key.shape[0]
    pad = -r % tile
    bit = torch.arange(taps, dtype=torch.int64, device=order.key.device)
    keys = torch.cat([order.key, order.key.new_full((pad,), (1 << taps) - 1)])
    live = ((keys[:, None] >> bit) & 1) == 0                        # (R + pad, T)
    used = live.view(-1, tile, taps).any(1).sum(1)                   # (tiles,)
    rows = (torch.arange(r + pad, device=keys.device) < r).view(-1, tile).sum(1)
    return (used * rows).sum()


# the element types K1 takes (x and w alike) with the launch count of each
# (``build.LAUNCHES``), which is also its C entry's name after ``ms3d_``
_LAUNCH_NAME = {torch.float32: "gather_gemm", torch.bfloat16: "gather_gemm_bf16"}


def gather_gemm(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                order: Optional[TapOrder] = None) -> torch.Tensor:
    """K1 (csrc/gather_gemm.cu) on CUDA tensors, the plain version on CPU ones.

    x (n_rows, Cin), idx (R, T) int32 with n_rows = absent, T <= 32, w (T,
    Cin, Cout), x and w both f32 or both bf16; returns (R, Cout) in their
    dtype (f32 sums, rounded once in bf16). ``order`` is idx's ``tap_order``
    for n_rows (built here when not given; checked on every device, and
    then ignored by the plain version). The int32 table goes to the kernel
    as it is; the plain version widens it to int64 for indexing."""
    if x.dim() != 2 or idx.dim() != 2 or w.dim() != 3:
        raise ValueError(f"gather_gemm: bad ranks x{tuple(x.shape)} idx{tuple(idx.shape)} "
                         f"w{tuple(w.shape)}")
    if w.shape[0] != idx.shape[1] or w.shape[1] != x.shape[1] or idx.shape[1] > 32:
        raise ValueError(f"gather_gemm: shapes disagree: x{tuple(x.shape)} "
                         f"idx{tuple(idx.shape)} w{tuple(w.shape)}")
    if x.dtype not in _LAUNCH_NAME or w.dtype != x.dtype or idx.dtype != torch.int32:
        raise TypeError(f"gather_gemm: want x and w both f32 or both bf16 and int32 idx, got "
                        f"{x.dtype}, {w.dtype}, {idx.dtype}")
    devices = {x.device, idx.device, w.device}
    if len(devices) != 1:
        raise ValueError(f"gather_gemm: tensors on several devices {devices}")
    if order is not None:
        check_order(order, idx, x.shape[0])
    if x.device.type == "cpu":
        return gather_gemm_plain(x, idx, w)
    if x.device.type != "cuda":
        raise ValueError(f"gather_gemm: unsupported device {x.device}")
    if not (x.is_contiguous() and idx.is_contiguous() and w.is_contiguous()):
        raise ValueError("gather_gemm: CUDA inputs must be contiguous")
    if order is None:
        order = tap_order(idx, x.shape[0])
    out = torch.empty((idx.shape[0], w.shape[2]), dtype=x.dtype, device=x.device)
    count = _LAUNCH_NAME[x.dtype]
    build.check(getattr(build.kernel_lib(), "ms3d_" + count)(
        x.data_ptr(), x.shape[0], x.shape[1], idx.data_ptr(), idx.shape[0], idx.shape[1],
        order.perm.data_ptr(), order.key.data_ptr(), w.data_ptr(), w.shape[2], out.data_ptr(),
        hashing._stream(x)), count)
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


class WgradSplit(NamedTuple):
    """K4's decomposition of one call (``wgrad_split``)."""

    mt: int      # a block's dW tile: 16 mt channels of x ...
    nt: int      # ... by 8 nt columns of dout
    chunks: int  # equal parts of each tap's pair list, each a partial sum,
    #              the partials added in chunk order


# K4's K split: about 8 blocks of 4 warps an SM of the H100's 132, each part
# of a list from at least 2048 rows of the table, the partials at most 8 MB
WGRAD_BLOCKS = 132 * 8
WGRAD_MIN_ROWS = 2048
WGRAD_PARTIAL_BYTES = 8 << 20


def wgrad_split(rows: int, taps: int, cin: int, cout: int) -> WgradSplit:
    """How K4 cuts a call, from the shape alone (so that dW's bits depend on
    nothing else): a dW tile of 16 or 32 channels by 16 or 32 columns,
    whichever pads less, and as many parts of each tap's list of live pairs
    as it takes to give the card ``WGRAD_BLOCKS`` blocks (taps x dW tiles x
    parts), no more than one for each ``WGRAD_MIN_ROWS`` rows of the table
    and than ``WGRAD_PARTIAL_BYTES`` of partial sums hold."""
    mt = 1 if cin <= 16 or 0 < cin % 32 <= 16 else 2
    nt = 2 if cout <= 16 or 0 < cout % 32 <= 16 else 4
    per_chunk = taps * -(-cin // (16 * mt)) * -(-cout // (8 * nt))
    chunks = min(-(-WGRAD_BLOCKS // max(per_chunk, 1)), rows // WGRAD_MIN_ROWS,
                 WGRAD_PARTIAL_BYTES // max(4 * taps * cin * cout, 1))
    return WgradSplit(mt, nt, max(chunks, 1))


# the element types K4 takes (x and dout alike) with their C entries and
# launch counts
_WGRAD = {torch.float32: "gather_wgrad", torch.bfloat16: "gather_wgrad_bf16"}


def gather_wgrad(x: torch.Tensor, idx: torch.Tensor, dout: torch.Tensor,
                 order: Optional[TapOrder] = None) -> torch.Tensor:
    """K4 (csrc/gather_wgrad.cu) on CUDA tensors, the plain version on CPU ones.

    x (n_rows, Cin) and dout (R, Cout) both f32 or both bf16, idx (R, T)
    int32 (outside [0, n_rows) = absent), T <= 32; returns (T, Cin, Cout)
    f32 (in bf16, the f32 sum rounded once to bf16), deterministic on the
    card (per-chunk partials summed in chunk order, no float atomics).
    ``order`` is idx's ``tap_order`` for n_rows (built here when not given;
    checked on every device, and then ignored by the plain version)."""
    if x.dim() != 2 or idx.dim() != 2 or dout.dim() != 2 or dout.shape[0] != idx.shape[0]:
        raise ValueError(f"gather_wgrad: bad shapes x{tuple(x.shape)} idx{tuple(idx.shape)} "
                         f"dout{tuple(dout.shape)}")
    if x.dtype not in _WGRAD or dout.dtype != x.dtype or idx.dtype != torch.int32:
        raise TypeError(f"gather_wgrad: want x and dout both f32 or both bf16 and int32 idx, "
                        f"got {x.dtype}, {dout.dtype}, {idx.dtype}")
    devices = {x.device, idx.device, dout.device}
    if len(devices) != 1:
        raise ValueError(f"gather_wgrad: tensors on several devices {devices}")
    if order is not None:
        check_order(order, idx, x.shape[0], "gather_wgrad")
    if x.device.type == "cpu":
        return gather_wgrad_plain(x, idx, dout)
    if x.device.type != "cuda":
        raise ValueError(f"gather_wgrad: unsupported device {x.device}")
    if not (x.is_contiguous() and idx.is_contiguous() and dout.is_contiguous()):
        raise ValueError("gather_wgrad: CUDA inputs must be contiguous")
    rows, taps = idx.shape
    if taps > 32:
        raise ValueError(f"gather_wgrad: at most 32 taps, got {taps}")
    if order is None:
        order = tap_order(idx, x.shape[0])
    cin, cout = x.shape[1], dout.shape[1]
    split = wgrad_split(rows, taps, cin, cout)
    out = torch.empty((taps, cin, cout), dtype=torch.float32, device=x.device)
    counts = torch.empty(taps * (-(-rows // 16) + 1), dtype=torch.int32, device=x.device)
    pairs = torch.empty(taps * rows * 2, dtype=torch.int32, device=x.device)
    partial = (torch.empty((split.chunks, taps, cin, cout), dtype=torch.float32,
                           device=x.device) if split.chunks > 1 else None)
    count = _WGRAD[x.dtype]
    build.check(getattr(build.kernel_lib(), "ms3d_" + count)(
        x.data_ptr(), x.shape[0], cin, idx.data_ptr(), rows, taps, order.perm.data_ptr(),
        order.key.data_ptr(), dout.data_ptr(), cout, split.mt, split.nt, split.chunks,
        counts.data_ptr(), pairs.data_ptr(), 0 if partial is None else partial.data_ptr(),
        out.data_ptr(), hashing._stream(x)), count)
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


def gather_dx_bf16(dout: torch.Tensor, idx_t: torch.Tensor, w: torch.Tensor,
                   order: Optional[TapOrder] = None) -> torch.Tensor:
    """K13 (csrc/gather_dx.cu) on CUDA tensors, the plain version on CPU ones.

    dout (R, Cout) bf16, idx_t (N, T) int32 with R (or any value outside
    [0, R)) = absent, T <= 32, w (T, Cout, Cin) bf16; returns (N, Cin) bf16:
    the input gradient of a bf16 sparse conv with the JAX bf16 train step's
    rounding points (see the module docstring). ``order`` is idx_t's
    ``tap_order`` for R (built here when not given; checked on every
    device, and then ignored by the plain version)."""
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
    if order is not None:
        check_order(order, idx_t, dout.shape[0], "gather_dx_bf16")
    if dout.device.type == "cpu":
        return gather_dx_bf16_plain(dout, idx_t, w)
    if dout.device.type != "cuda":
        raise ValueError(f"gather_dx_bf16: unsupported device {dout.device}")
    if not (dout.is_contiguous() and idx_t.is_contiguous() and w.is_contiguous()):
        raise ValueError("gather_dx_bf16: CUDA inputs must be contiguous")
    if order is None:
        order = tap_order(idx_t, dout.shape[0])
    out = torch.empty((idx_t.shape[0], w.shape[2]), dtype=torch.bfloat16, device=dout.device)
    build.check(build.kernel_lib().ms3d_gather_dx_bf16(
        dout.data_ptr(), dout.shape[0], dout.shape[1], idx_t.data_ptr(), idx_t.shape[0],
        idx_t.shape[1], order.perm.data_ptr(), w.data_ptr(), w.shape[2], out.data_ptr(),
        hashing._stream(dout)), "gather_dx_bf16")
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
    row that reads j there (dout.shape[0] = absent). ``order`` and
    ``order_t`` are the two tables' TapOrders, which the kernels of both
    passes walk: K1 and K4 ``order``, the dx (K1 or K13) ``order_t`` (None:
    each kernel builds its own)."""

    @staticmethod
    def forward(ctx, x, weight, idx, idx_t, flip: bool, order=None, order_t=None):
        w = weight.to(x.dtype)
        ctx.save_for_backward(x, w, idx, idx_t)
        ctx.flip = flip
        ctx.order, ctx.order_t = order, order_t
        return gather_gemm(x, idx, w, order)

    @staticmethod
    def backward(ctx, dout):
        x, w, idx, idx_t = ctx.saved_tensors
        dout = dout.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            wt = (w.flip(0) if ctx.flip else w).transpose(1, 2).contiguous()
            if x.dtype == torch.bfloat16:
                dx = gather_dx_bf16(dout, idx_t, wt, ctx.order_t)
            else:
                dx = gather_gemm(dout, idx_t, wt, ctx.order_t)
        if ctx.needs_input_grad[1]:
            dw = gather_wgrad(x, idx, dout, ctx.order)
        return dx, dw, None, None, None, None, None


def subm_conv(feats: torch.Tensor, level, weight: torch.Tensor,
              order: Optional[TapOrder] = None) -> torch.Tensor:
    """3^3 submanifold conv: feats (V, Cin), weight (27, Cin, Cout);
    ``order``: the level's ``conv_tables`` order (None: K1 builds one). The
    table is symmetric, so the order serves the f32 dx too."""
    return GatherConv.apply(feats, weight, level.nbr_idx, level.nbr_idx, True, order, order)


def down_index(child, parent_cap: int) -> torch.Tensor:
    """child_of (parent_cap, 8) int32: the child row of each (parent, kid),
    child.cap where the parent has no such child."""
    n = child.cap
    ok = child.valid & (child.parent_idx < parent_cap)
    # rows without a parent write to one spare slot past the table, dropped
    # after: no boolean mask, so no host-device sync
    flat = torch.where(ok, child.parent_idx.long() * 8 + child.child_kid.long(), parent_cap * 8)
    child_of = torch.full((parent_cap * 8 + 1,), n, dtype=torch.int32, device=flat.device)
    child_of[flat] = torch.arange(n, dtype=torch.int32, device=flat.device)
    return child_of[:-1].view(parent_cap, 8)


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
    """Both k2s2 index tables of one child level and their TapOrders: the
    down conv gathers over ``down`` and its dx over ``up``; the up conv the
    other way round. Built once per level and forward pass, shared by the
    level's two convs and their backward."""

    down: torch.Tensor  # (parent_cap, 8) child row per (parent, kid)
    up: torch.Tensor    # (child_cap, 8) parent row in column child_kid
    down_order: Optional[TapOrder] = None
    up_order: Optional[TapOrder] = None


def links(child, parent_cap: int) -> Links:
    down, up = down_index(child, parent_cap), up_index(child, parent_cap)
    return Links(down, up, *tap_orders([(down, child.cap), (up, parent_cap)]))


class LevelTables(NamedTuple):
    """One plan level's conv tables with their TapOrders, as ``conv_tables``
    builds them: the kernel map's order, for every subm conv at the level
    and its f32 dx, and the k2s2 ``links`` to the next level."""

    nbr_order: TapOrder
    links: Optional[Links]  # None at the deepest level


def conv_table_list(plan) -> list:
    """[(idx, n_rows)] of every table a forward pass over ``plan`` convolves
    over: each level's kernel map, then each level boundary's down and up
    tables (``down_index``, ``up_index``)."""
    lv = plan.levels
    return [(v.nbr_idx, v.cap) for v in lv] + [
        t for v, p in zip(lv, lv[1:])
        for t in ((down_index(v, p.cap), v.cap), (up_index(v, p.cap), p.cap))]


def conv_tables(plan) -> tuple:
    """(LevelTables per level of ``plan``): every table of ``conv_table_list``
    with its TapOrder (the 7-level backbone's 7 kernel maps and 12 k2s2
    tables), no host sync. On the card one K22 call (a memset and a
    launch) builds the k2s2 tables and orders all of them (``_tap_launch``);
    on the CPU
    ``down_index``, ``up_index`` and one ``tap_orders`` call. The plan
    itself carries no order, so both plan paths share this."""
    lv = plan.levels
    n = len(lv)
    if lv[0].nbr_idx.device.type == "cuda":
        for v in lv:
            links = (v.parent_idx, v.child_kid) if v is not lv[-1] else ()
            if (v.nbr_idx.dtype != torch.int32 or v.nbr_idx.dim() != 2
                    or any(t.dtype != torch.int32 for t in links) or v.valid.dtype != torch.bool
                    or not all(t.is_contiguous() for t in (v.nbr_idx, v.valid, *links))):
                raise TypeError("conv_tables: want contiguous int32 nbr_idx, parent_idx and "
                                "child_kid and bool valid at every level")
        orders = _tap_launch(
            [(_GIVEN, v.nbr_idx, v.cap, v.nbr_idx.shape[1], v.cap, None) for v in lv]
            + [sp for v, p in zip(lv, lv[1:])
               for sp in ((_DOWN, None, p.cap, 8, v.cap, v), (_UP, None, v.cap, 8, p.cap, v))],
            lv[0].nbr_idx.device)
    else:
        orders = tap_orders(conv_table_list(plan))
    return tuple(LevelTables(orders[i], Links(orders[n + 2 * i].table, orders[n + 2 * i + 1].table,
                                              orders[n + 2 * i], orders[n + 2 * i + 1])
                             if i + 1 < n else None) for i in range(n))


def down_conv(feats: torch.Tensor, lk: Links, weight: torch.Tensor) -> torch.Tensor:
    """k2s2 strided conv child -> parent over the child level's ``links``:
    weight (8, Cin, Cout)."""
    return GatherConv.apply(feats, weight, lk.down, lk.up, False, lk.down_order, lk.up_order)


def up_conv(parent_feats: torch.Tensor, lk: Links, weight: torch.Tensor) -> torch.Tensor:
    """k2s2 transposed conv parent -> child over the child level's ``links``:
    weight (8, Cp, Cc)."""
    return GatherConv.apply(parent_feats, weight, lk.up, lk.down, False, lk.up_order,
                            lk.down_order)
