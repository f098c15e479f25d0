"""Ball queries: the edge-buffer and fused queries (kernel K2) and the
direct grid query (kernel K14), with their torch set-up.

Counterparts of minsu3d_tpu/ops/ballquery.py:
* ``ball_query_edge`` (:268): up to ``k`` neighbours within ``radius`` that
  share the query's batch and group, in window-position-major candidate
  order, with the point-major edge buffer of ``edge_cap`` slots and its
  drop count;
* ``ball_query`` (:42, the fused schedule): the same candidates with no
  edge buffer. Its candidates are each point's runs clipped to ``window``
  (``pos < ends``, :117-119), in the same window-position-major order, so
  it is K2 given a cap that no candidate total reaches. The JAX
  ``fused=False`` loop schedule gives the same tables
  (tests/test_cluster.py::test_fused_matches_loop); the port carries this
  one function for both;
* ``ball_query_grid`` (:176): single-occupancy unit grids, one exact-match
  lookup per pruned cell offset within ``m = ceil(radius / cell_size)``
  cells, nothing dropped beyond the K cap.
Result arrays equal the JAX functions' bit for bit (same cell keys, same
stable sort, same f32 distance arithmetic).

The wrappers hash cells (dividing by a device tensor), pack the
``(batch << 16 | group, cell)`` keys and sort them stably (the table
builds of :57-66, :204-213, :300-309: K15 ``hashing.key_sort``), then hand
the table (``edge_table``: cells, key_hi, sorted keys, permutation) to one
kernel: K2 (csrc/ball_query.cu) finds every (point, offset) run by binary
search, scans the candidate counts and scans the candidates in one
launch; K14 (csrc/ball_query_grid.cu) binary-searches the sorted keys
itself. On CPU tensors the sort is its plain version and the kernels'
plain versions run (``edge_scan_plain``: ``run_bounds`` and
``scan_plain``; ``grid_scan_plain``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from minsu3d_tpu_torch.csrc import build
from minsu3d_tpu_torch.ops import hashing
from minsu3d_tpu_torch.ops.hashing import COORD_MAX, SENTINEL, pack_key

_CELL_OFFSET = 512  # recentre cells so negative coords stay in [0, 1024)
_GROUP_SHIFT = 16   # khi = batch << 16 | group

_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
# K2's edge cap for the fused query: above any candidate total (points x
# offsets x window), so no candidate is ever dropped
NO_EDGE_CAP = 1 << 62


def cell_offsets(half_space: bool) -> list:
    """The 27 neighbour-cell offsets in (dx, dy, dz) order; with
    ``half_space`` only the centre and the 13 lexicographically forward ones."""
    return [o for o in _OFFSETS if o >= (0, 0, 0)] if half_space else list(_OFFSETS)


def grid_offsets(radius: float, cell_size: float, half_space: bool) -> list:
    """``ball_query_grid``'s cell offsets, in Python floats as the JAX
    function computes them (:202, :215-224): every (dx, dy, dz) within
    ``m = ceil(radius / cell_size - 1e-9)`` cells, in (dx, dy, dz) order,
    pruned to those whose nearest corners lie within ``radius``; with
    ``half_space`` only those >= (0, 0, 0)."""
    m = math.ceil(radius / cell_size - 1e-9)
    r2f = radius * radius
    rng = range(-m, m + 1)
    offsets = [(dx, dy, dz) for dx in rng for dy in rng for dz in rng
               if sum((max(abs(d) - 1, 0) * cell_size) ** 2 for d in (dx, dy, dz)) <= r2f]
    return [o for o in offsets if o >= (0, 0, 0)] if half_space else offsets


def table_keys(coords: torch.Tensor, batch: torch.Tensor, valid: torch.Tensor,
               cell_size: float, group: torch.Tensor | None):
    """Cells and unsorted keys of a ball query's table: (cell (N, 3) int64 in
    [0, COORD_MAX), key_hi (N,) int64 = batch << 16 | group, key (N,) int64
    with invalid rows as SENTINEL pairs)."""
    # divide by a device tensor: a Python-scalar divisor takes CUDA's
    # multiply-by-reciprocal shortcut, which can move a point across a cell;
    # the tensor is filled on the device (torch.tensor would copy it from
    # the host and wait for the card)
    cell = torch.floor(coords / torch.full((), cell_size, dtype=coords.dtype,
                                           device=coords.device))
    cell = cell.to(torch.int64) + _CELL_OFFSET
    cell = cell.clamp(0, COORD_MAX - 1)
    key_hi = batch.to(torch.int64)
    if group is not None:
        key_hi = (key_hi << _GROUP_SHIFT) | group.to(torch.int64).clamp(
            0, (1 << _GROUP_SHIFT) - 1)
    sent = torch.full_like(key_hi, SENTINEL)
    klo = (cell[:, 0] << 20) | (cell[:, 1] << 10) | cell[:, 2]
    return cell, key_hi, pack_key(torch.where(valid, key_hi, sent), torch.where(valid, klo, sent))


def cell_keys(coords: torch.Tensor, batch: torch.Tensor, valid: torch.Tensor,
              cell_size: float, group: torch.Tensor | None):
    """``table_keys``' cells and key_hi, then the keys sorted stably (K15):
    (cell, key_hi, s_key (N,) int64, perm (N,) int32 sorted row -> point)."""
    cell, key_hi, key = table_keys(coords, batch, valid, cell_size, group)
    s_key, perm = hashing.key_sort(key)
    return cell, key_hi, s_key, perm


def query_keys(cell, key_hi, valid, offs):
    """Keys of every (point, offset) neighbour cell: (q_key (N, n_off)
    int64, in_rng (N, n_off) bool: the cell lies in the grid and the query
    is valid)."""
    q_cell = cell[:, None, :] + offs[None, :, :]                    # (N, n_off, 3)
    in_rng = ((q_cell >= 0) & (q_cell < COORD_MAX)).all(-1) & valid[:, None]
    q = q_cell.clamp(0, COORD_MAX - 1)
    q_lo = (q[..., 0] << 20) | (q[..., 1] << 10) | q[..., 2]
    return pack_key(key_hi[:, None].expand_as(q_lo), q_lo), in_rng


def run_bounds(cell, key_hi, valid, s_key, window: int, half_space: bool):
    """Plain run bounds of every (point, offset): (starts (N, n_off) int32,
    run_len (N, n_off) int32 clipped to ``window`` and 0 for out-of-range
    cells, point_base (N,) int64 exclusive cumsum of the per-point
    candidate counts, total () int64)."""
    offs = torch.tensor(cell_offsets(half_space), dtype=torch.int64, device=cell.device)
    q_key, in_rng = query_keys(cell.long(), key_hi, valid, offs)
    starts, ends = hashing.sorted_bounds_plain(s_key, q_key)
    run_len = torch.where(in_rng, (ends - starts).clamp(0, window), torch.zeros_like(ends))
    per_point = run_len.sum(1, dtype=torch.int64)
    point_base = torch.cumsum(per_point, 0) - per_point
    return starts, run_len, point_base, per_point.sum()


def runs(coords: torch.Tensor, batch: torch.Tensor, valid: torch.Tensor, radius: float,
         window: int, half_space: bool, group: torch.Tensor | None):
    """Cell hashing and plain run bounds: (perm (N,) int32 sorted row ->
    point, then ``run_bounds``' starts, run_len, point_base and total)."""
    cell, key_hi, s_key, perm = cell_keys(coords, batch, valid, radius, group)
    return (perm, *run_bounds(cell, key_hi, valid, s_key, window, half_space))


def scan_plain(coords, perm, starts, run_len, point_base, k: int, window: int,
               edge_cap: int, r2: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel's candidate scan: (N, k) int32, n = empty."""
    n, n_off = starts.shape
    run_len = run_len.long()
    pre = point_base[:, None] + torch.cumsum(run_len, 1) - run_len    # (N, n_off)
    w = torch.arange(window, device=coords.device)[None, :, None]     # (1, W, 1)
    exists = (w < run_len[:, None, :]) & (pre[:, None, :] + w < edge_cap)
    pos = torch.where(exists, starts.long()[:, None, :] + w, torch.zeros_like(w))
    cand = perm.long()[pos]                                           # (N, W, n_off)
    d = coords[cand] - coords[:, None, None, :]
    dx, dy, dz = d.unbind(-1)
    ok = exists & (dx * dx + dy * dy + dz * dz <= r2)
    ok = ok.reshape(n, window * n_off)                                # (w, o) order
    cand = cand.reshape(n, window * n_off)
    col = torch.cumsum(ok.to(torch.int64), 1) - 1
    store = ok & (col < k)
    nbr = torch.full((n, k + 1), n, dtype=torch.int32, device=coords.device)
    rows = torch.arange(n, device=coords.device)[:, None].expand_as(col)
    nbr[rows[store], col[store]] = cand[store].to(torch.int32)
    return nbr[:, :k]


def edge_table(coords: torch.Tensor, batch: torch.Tensor, valid: torch.Tensor,
               radius: float, group: torch.Tensor | None):
    """K2's table, as K14 takes it: (cell (N, 3) int32, key_hi (N,) int64,
    s_key (N,) int64, perm (N,) int32) of cells of ``radius`` metres."""
    cell, key_hi, s_key, perm = cell_keys(coords, batch, valid, radius, group)
    return cell.to(torch.int32).contiguous(), key_hi.contiguous(), s_key, perm


def edge_scan_plain(coords, valid, cell, key_hi, s_key, perm, k: int, window: int,
                    edge_cap: int, half_space: bool, r2: float):
    """Plain version of K2 with its signature: ``run_bounds`` (torch
    searches), then ``scan_plain``. Returns (nbr (N, k) int32 with N =
    empty, nbr_valid (N, k) bool, (2,) int64: the candidate total and
    edges_dropped = max(total - edge_cap, 0))."""
    starts, run_len, point_base, total = run_bounds(cell, key_hi, valid, s_key, window,
                                                    half_space)
    nbr = scan_plain(coords, perm, starts, run_len, point_base, k, window, edge_cap,
                     torch.tensor(r2, dtype=torch.float32))
    return nbr, nbr < coords.shape[0], torch.stack([total, (total - edge_cap).clamp(min=0)])


def edge_scan_cuda(coords, valid, cell, key_hi, s_key, perm, k: int, window: int,
                   edge_cap: int, half_space: bool, r2: float):
    """Launch K2 (csrc/ball_query.cu) on CUDA tensors: one cooperative
    launch, nothing read back. Returns what ``edge_scan_plain`` returns."""
    tensors = (coords, valid, cell, key_hi, s_key, perm)
    if hashing._device("ball_query_edge", *tensors) != "cuda":
        raise ValueError("ball_query_edge: the kernel takes CUDA tensors")
    want = (torch.float32, torch.bool, torch.int32, torch.int64, torch.int64, torch.int32)
    if tuple(t.dtype for t in tensors) != want:
        raise TypeError(f"ball_query_edge: dtypes {[t.dtype for t in tensors]}, want {want}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ball_query_edge: inputs must be contiguous")
    n = coords.shape[0]
    if cell.shape != (n, 3) or any(t.shape != (n,) for t in (valid, key_hi, s_key, perm)):
        raise ValueError(f"ball_query_edge: shapes {[tuple(t.shape) for t in tensors]} for "
                         f"{n} points")
    dev = coords.device
    lib = build.kernel_lib()
    work = torch.empty(lib.ms3d_ball_query_edge_scratch(n, 14 if half_space else 27),
                       dtype=torch.uint8, device=dev)
    result, nbr = torch.empty(4 + n * k, dtype=torch.int32, device=dev).split_with_sizes([4, n * k])
    result, nbr = result.view(torch.int64), nbr.view(n, k)
    nbr_valid = torch.empty((n, k), dtype=torch.bool, device=dev)
    build.check(lib.ms3d_ball_query_edge(
        coords.data_ptr(), valid.data_ptr(), cell.data_ptr(), key_hi.data_ptr(),
        s_key.data_ptr(), perm.data_ptr(), n, int(half_space), window, k, edge_cap, r2,
        work.data_ptr(), work.numel(), nbr.data_ptr(), nbr_valid.data_ptr(), result.data_ptr(),
        hashing._stream(coords)), "ball_query_edge")
    build.LAUNCHES["ball_query_edge"] += 1
    return nbr, nbr_valid, result


def _check_coords(name: str, coords: torch.Tensor) -> None:
    if coords.dtype != torch.float32 or coords.dim() != 2 or coords.shape[1] != 3:
        raise ValueError(f"{name}: want (N, 3) f32 coords, got "
                         f"{tuple(coords.shape)} {coords.dtype}")


def _r2(radius: float) -> float:
    """radius^2 rounded to f32, as the JAX functions compare in f32."""
    return float(np.float32(radius * radius))


def _edge_scan(coords, batch, valid, radius: float, k: int, window: int, edge_cap: int,
               half_space: bool, group):
    """K2's table, then K2 on CUDA tensors or ``edge_scan_plain`` on CPU
    tensors."""
    args = (coords, valid.contiguous(), *edge_table(coords, batch, valid, radius, group), k,
            window, edge_cap, half_space, _r2(radius))
    if coords.device.type == "cpu":
        return edge_scan_plain(*args)
    if coords.device.type == "cuda":
        return edge_scan_cuda(*args)
    raise ValueError(f"ball query: unsupported device {coords.device}")


def ball_query_edge(coords: torch.Tensor, batch: torch.Tensor, valid: torch.Tensor,
                    radius: float, k: int, window: int, edge_cap: int,
                    half_space: bool = False, group: torch.Tensor | None = None):
    """Returns (nbr_idx (N, k) int32 with N = empty, nbr_valid (N, k) bool,
    edges_dropped () int64)."""
    _check_coords("ball_query_edge", coords)
    nbr, nbr_valid, result = _edge_scan(coords, batch, valid, radius, k, window, edge_cap,
                                        half_space, group)
    return nbr, nbr_valid, result[1]


def ball_query(coords: torch.Tensor, batch: torch.Tensor, valid: torch.Tensor,
               radius: float, k: int, window: int = 32, half_space: bool = False,
               group: torch.Tensor | None = None):
    """The fused ball query: ``ball_query_edge``'s candidates with no edge
    buffer (K2 with a cap no total reaches). Returns (nbr_idx (N, k) int32
    with N = empty, nbr_valid (N, k) bool)."""
    _check_coords("ball_query", coords)
    nbr, nbr_valid, _ = _edge_scan(coords, batch, valid, radius, k, window, NO_EDGE_CAP,
                                   half_space, group)
    return nbr, nbr_valid


def grid_table(coords: torch.Tensor, batch: torch.Tensor, valid: torch.Tensor,
               radius: float, cell_size: float, half_space: bool,
               group: torch.Tensor | None):
    """K14's inputs: ``edge_table`` of cells of ``cell_size`` metres, then
    offs (n_off, 3) int32 from ``grid_offsets``."""
    offs = torch.tensor(grid_offsets(radius, cell_size, half_space), dtype=torch.int32,
                        device=coords.device).reshape(-1, 3)
    return (*edge_table(coords, batch, valid, cell_size, group), offs)


def grid_scan_plain(coords, valid, cell, key_hi, s_key, perm, offs, k: int,
                    r2: torch.Tensor) -> torch.Tensor:
    """Plain version of K14: per (unit, offset) the LAST sorted row whose
    key equals the neighbour cell's (``searchsorted(right=True) - 1``, the
    JAX lookup's ``cnt - 1``), the distance test, then the first ``k`` in
    offset order. (N, k) int32, N = empty."""
    n = coords.shape[0]
    dev = coords.device
    q_key, in_rng = query_keys(cell.long(), key_hi, valid, offs.long())   # (N, n_off)
    idx = torch.searchsorted(s_key, q_key, right=True) - 1
    idx_c = idx.clamp(min=0)
    found = in_rng & (idx >= 0) & (s_key[idx_c] == q_key)
    cand = perm.long()[idx_c]
    d = coords[cand] - coords[:, None, :]
    dx, dy, dz = d.unbind(-1)
    ok = found & (dx * dx + dy * dy + dz * dz <= r2)
    col = torch.cumsum(ok.to(torch.int64), 1) - 1
    store = ok & (col < k)
    nbr = torch.full((n, k + 1), n, dtype=torch.int32, device=dev)
    rows = torch.arange(n, device=dev)[:, None].expand_as(col)
    nbr[rows[store], col[store]] = cand[store].to(torch.int32)
    return nbr[:, :k]


def ball_query_grid(coords: torch.Tensor, batch: torch.Tensor, valid: torch.Tensor,
                    radius: float, k: int, cell_size: float, half_space: bool = False,
                    group: torch.Tensor | None = None):
    """Ball query over a single-occupancy grid (the unit centroids of
    ``general_model.make_units_grid``): a neighbour cell holds one unit or
    none, found by one exact-match search per cell offset. Returns (nbr_idx
    (N, k) int32 with N = empty, nbr_valid (N, k) bool). K14 on CUDA
    tensors, ``grid_scan_plain`` on CPU tensors."""
    _check_coords("ball_query_grid", coords)
    if cell_size <= 0:
        raise ValueError(f"ball_query_grid: cell_size {cell_size} must be > 0")
    cell, key_hi, s_key, perm, offs = grid_table(coords, batch, valid, radius, cell_size,
                                                 half_space, group)
    r2 = torch.tensor(radius * radius, dtype=torch.float32)
    if coords.device.type == "cpu":
        nbr = grid_scan_plain(coords, valid, cell, key_hi, s_key, perm, offs, k, r2)
    elif coords.device.type == "cuda":
        nbr = ball_query_grid_scan(coords, valid, cell, key_hi, s_key, perm, offs, k,
                                   float(r2))
    else:
        raise ValueError(f"ball_query_grid: unsupported device {coords.device}")
    return nbr, nbr < coords.shape[0]


def ball_query_grid_scan(coords, valid, cell, key_hi, s_key, perm, offs, k: int,
                         r2: float) -> torch.Tensor:
    """Launch K14 (csrc/ball_query_grid.cu) on CUDA tensors."""
    tensors = (coords, valid, cell, key_hi, s_key, perm, offs)
    if any(t.device != coords.device for t in tensors):
        raise ValueError("ball_query_grid_scan: tensors on several devices")
    want = (torch.float32, torch.bool, torch.int32, torch.int64, torch.int64, torch.int32,
            torch.int32)
    if tuple(t.dtype for t in tensors) != want:
        raise TypeError(f"ball_query_grid_scan: dtypes {[t.dtype for t in tensors]}, "
                        f"want {want}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ball_query_grid_scan: inputs must be contiguous")
    n = coords.shape[0]
    nbr = torch.empty((n, k), dtype=torch.int32, device=coords.device)
    stream = torch.cuda.current_stream(coords.device).cuda_stream
    build.check(build.kernel_lib().ms3d_ball_query_grid(
        coords.data_ptr(), valid.data_ptr(), cell.data_ptr(), key_hi.data_ptr(),
        s_key.data_ptr(), perm.data_ptr(), offs.data_ptr(), n, offs.shape[0], k, r2,
        nbr.data_ptr(), stream), "ball_query_grid")
    build.LAUNCHES["ball_query_grid"] += 1
    return nbr
