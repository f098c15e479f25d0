"""Coordinate keys: packing, the stable key sort (kernel K15), sorted-table
lookups (K16) and the unique/compaction pass (K17).

Counterpart of minsu3d_tpu/ops/hashing.py. ``pack``, ``unpack`` and
``mask_invalid`` (:29-50) are plain torch. Where the JAX package keeps a
key as an int32 pair (khi, klo), the port packs it into one int64,
``khi << 31 | klo`` (``pack_key``): both halves are non-negative (ids,
10-bit packed coords, SENTINEL), so the int64 order is the pairs'
lexicographic order and one sort key does the work of a lexsort.

* ``key_sort`` (K15, csrc/key_sort.cu): a stable ascending sort of int64
  keys, optionally of their low ``bits`` only; ``lexsort_pairs`` (:53) is
  its permutation on packed pairs.
* ``sorted_bounds`` / ``lookup`` (K16 bounds mode, csrc/sorted_lookup.cu):
  lower and upper bounds of query keys in a sorted table; ``lookup`` has
  the meaning of ``lookup_sorted_union`` (:103): idx = the LAST equal table
  row (upper - 1) or ``missing``, found, the upper bound; and the lower
  bound (``lower_bound``, :62; ``lookup``'s idx where a key is unique).
  A query whose khi is SENTINEL is never found. ``run_offsets`` is the
  lower bound of every id 0..S (a segment CSR's offsets) without a search;
  ``neighbor_maps`` is K16's neighbour mode, the (V, 27) kernel maps of
  ops/sparse.py:141 of every level of a plan in one launch.
* ``unique_sorted`` (:158) and ``unique_compact`` (K17,
  csrc/unique_compact.cu): first flags, segment ids (n_unique for invalid
  rows), n_unique, and the compacted table of ops/sparse.py:94
  ``build_base``, whose valid flags K17 reads through the sort's
  permutation itself.

Each wrapper launches its kernel on CUDA tensors and takes its plain
version (``torch.sort``, ``torch.searchsorted``, cumsum and scatters) only
on CPU tensors. No wrapper reads a value back to the host: counts stay
device tensors, so a plan build makes no host-device sync.
"""

from __future__ import annotations

import array
from typing import NamedTuple

import torch

from minsu3d_tpu_torch.csrc import build

COORD_BITS = 10
COORD_MAX = 1 << COORD_BITS  # 1024 voxels per axis
SENTINEL = 2**31 - 1
KHI_SHIFT = 31               # key = khi << 31 | klo


def pack(batch: torch.Tensor, coords: torch.Tensor) -> tuple:
    """(batch, xyz int coords in [0, 1024)) -> (khi, klo) int32."""
    c = coords.to(torch.int32)
    klo = (c[..., 0] << (2 * COORD_BITS)) | (c[..., 1] << COORD_BITS) | c[..., 2]
    return batch.to(torch.int32), klo


def unpack(khi: torch.Tensor, klo: torch.Tensor) -> tuple:
    mask = COORD_MAX - 1
    x = (klo >> (2 * COORD_BITS)) & mask
    y = (klo >> COORD_BITS) & mask
    return khi, torch.stack([x, y, klo & mask], dim=-1)


def mask_invalid(khi: torch.Tensor, klo: torch.Tensor, valid: torch.Tensor) -> tuple:
    """Invalid entries become the sentinel pair, so they sort to the end."""
    return (torch.where(valid, khi, torch.full_like(khi, SENTINEL)),
            torch.where(valid, klo, torch.full_like(klo, SENTINEL)))


def pack_key(khi: torch.Tensor, klo: torch.Tensor) -> torch.Tensor:
    """(khi, klo) non-negative int32 pairs -> one int64 key with the pairs'
    lexicographic order."""
    return (khi.to(torch.int64) << KHI_SHIFT) | klo.to(torch.int64)


def _device(name: str, *tensors) -> str:
    """The device kind of all the tensors, cuda or cpu (on the card it reads
    only is_cuda and the card index: cheap host work for short kernels)."""
    first = tensors[0]
    if first.is_cuda:
        card = first.get_device()
        if any(not t.is_cuda or t.get_device() != card for t in tensors[1:]):
            raise ValueError(f"{name}: tensors on several devices")
        return "cuda"
    if any(t.device != first.device for t in tensors):
        raise ValueError(f"{name}: tensors on several devices")
    if first.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {first.device}")
    return "cpu"


def _want(name: str, t: torch.Tensor, dtype: torch.dtype, dim: int = 1) -> torch.Tensor:
    if t.dtype != dtype or t.dim() != dim:
        raise TypeError(f"{name}: want a {dim}-D {dtype} tensor, got {t.dtype} "
                        f"{tuple(t.shape)}")
    return t.contiguous()


# the current stream's handle as an int without building a Stream object,
# which costs a short kernel's wrapper several times more host time
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(t: torch.Tensor) -> int:
    if _raw_stream is not None:
        return _raw_stream(t.get_device())
    return torch.cuda.current_stream(t.device).cuda_stream


# ---- K15 -------------------------------------------------------------------

SORT_SMALL_MAX = 8192    # keys sorted by one block in shared memory
SORT_TILE = 2048         # keys a tile of the onesweep path
_SORT_CTRL_WORDS = 2 * 8 * 256 + 64


def key_sort_scratch_bytes(n: int, bits: int = 64) -> int:
    """Bytes of scratch K15 needs for n keys of ``bits`` bits (the C side's
    ``ms3d_key_sort_scratch``): none for the one-block path; else the digit
    histograms, digit starts and counters, a status word per (pass, tile,
    digit), and a key and a permutation buffer."""
    if n <= SORT_SMALL_MAX:
        return 0
    passes, tiles = -(-bits // 8), -(-n // SORT_TILE)
    return 4 * (_SORT_CTRL_WORDS + passes * tiles * 256) + 12 * n


def key_sort_plain(key: torch.Tensor, bits: int = 64) -> tuple:
    s_key, perm = torch.sort(key, stable=True)
    return s_key, perm.to(torch.int32)


def key_sort_cuda(key: torch.Tensor, bits: int = 64) -> tuple:
    # a short kernel's time on the card is mostly its wrapper's host work:
    # the outputs come from empty_like (no shape or device read back into
    # Python) and the scratch, if any, from one more allocation
    key = _want("key_sort", key, torch.int64)
    if not 1 <= bits <= 64:
        raise ValueError(f"key_sort: bits {bits} outside [1, 64]")
    n = key.shape[0]
    s_key = torch.empty_like(key)
    perm = torch.empty_like(key, dtype=torch.int32)
    size = key_sort_scratch_bytes(n, bits)
    scratch = torch.empty(size, dtype=torch.uint8, device=key.device) if size else None
    build.check(build.kernel_lib().ms3d_key_sort(
        key.data_ptr(), n, bits, s_key.data_ptr(), perm.data_ptr(),
        scratch.data_ptr() if size else 0, size, _stream(key)), "key_sort")
    build.LAUNCHES["key_sort"] += 1
    return s_key, perm


def key_sort(key: torch.Tensor, bits: int = 64) -> tuple:
    """(sorted keys (N,) int64, permutation (N,) int32: sorted position ->
    input row) of int64 keys, stable. ``bits`` < 64 promises keys in [0,
    2^bits) (CUB's end_bit): the kernel then sorts only those bits, and the
    plain version ignores it. K15 on CUDA tensors."""
    if _device("key_sort", key) == "cpu":
        return key_sort_plain(key, bits)
    return key_sort_cuda(key, bits)


def lexsort_pairs(khi: torch.Tensor, klo: torch.Tensor) -> torch.Tensor:
    """Permutation sorting (khi, klo) pairs ascending, khi major. Stable."""
    return key_sort(pack_key(khi, klo))[1]


# ---- K16 -------------------------------------------------------------------

def sorted_bounds_plain(s_key: torch.Tensor, q_key: torch.Tensor, upper: bool = True) -> tuple:
    return (torch.searchsorted(s_key, q_key, right=False, out_int32=True),
            torch.searchsorted(s_key, q_key, right=True, out_int32=True) if upper else None)


def sorted_bounds_cuda(s_key: torch.Tensor, q_key: torch.Tensor, upper: bool = True) -> tuple:
    s_key = _want("sorted_bounds", s_key, torch.int64)
    if q_key.dtype != torch.int64:
        raise TypeError(f"sorted_bounds: want int64 queries, got {q_key.dtype}")
    q = q_key.contiguous()
    lower = torch.empty_like(q, dtype=torch.int32)
    up = torch.empty_like(lower) if upper else None
    build.check(build.kernel_lib().ms3d_sorted_bounds(
        s_key.data_ptr(), s_key.shape[0], q.data_ptr(), q.numel(), lower.data_ptr(),
        up.data_ptr() if upper else 0, _stream(q)), "sorted_lookup")
    build.LAUNCHES["sorted_lookup"] += 1
    return lower, up


def sorted_bounds(s_key: torch.Tensor, q_key: torch.Tensor, upper: bool = True) -> tuple:
    """(lower, upper) int32 of each query of ``q_key`` (any shape, int64) in
    the ascending table ``s_key`` (N,): the first row >= and > the query;
    ``upper=False`` searches only the lower bound and returns (lower, None).
    K16 on CUDA tensors."""
    if _device("sorted_bounds", s_key, q_key) == "cpu":
        return sorted_bounds_plain(s_key, q_key, upper)
    return sorted_bounds_cuda(s_key, q_key, upper)


def lower_bound(s_key: torch.Tensor, q_key: torch.Tensor) -> torch.Tensor:
    """int32 first row of the ascending table ``s_key`` >= each query."""
    return sorted_bounds(s_key, q_key, upper=False)[0]


def run_offsets_plain(s_key: torch.Tensor, num_segments: int) -> torch.Tensor:
    ids = torch.arange(num_segments + 1, dtype=torch.int64, device=s_key.device)
    return torch.searchsorted(s_key, ids, out_int32=True)


def run_offsets_cuda(s_key: torch.Tensor, num_segments: int) -> torch.Tensor:
    s_key = _want("run_offsets", s_key, torch.int64)
    offsets = torch.empty(num_segments + 1, dtype=torch.int32, device=s_key.device)
    build.check(build.kernel_lib().ms3d_run_offsets(
        s_key.data_ptr(), s_key.shape[0], num_segments, offsets.data_ptr(), _stream(s_key)),
        "sorted_lookup")
    build.LAUNCHES["sorted_lookup"] += 1
    return offsets


def run_offsets(s_key: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(S+1,) int32 ``lower_bound(s_key, arange(S+1))`` for S =
    ``num_segments``: the first row of the ascending table >= each id, the
    offsets of a segment CSR. K16's sorted-query route on CUDA tensors (one
    pass over the rows, no search)."""
    if num_segments < 0:
        raise ValueError(f"run_offsets: num_segments {num_segments} < 0")
    if _device("run_offsets", s_key) == "cpu":
        return run_offsets_plain(s_key, num_segments)
    return run_offsets_cuda(s_key, num_segments)


class Lookup(NamedTuple):
    idx: torch.Tensor     # int32 last equal table row, or ``missing``
    found: torch.Tensor   # bool exact match (never for a SENTINEL khi)
    upper: torch.Tensor   # int32 first table row > query
    lower: torch.Tensor   # int32 first table row >= query


def lookup(s_key: torch.Tensor, q_key: torch.Tensor, missing: int | None = None) -> Lookup:
    """Exact-match lookup of packed query keys in a sorted packed table,
    with ``lookup_sorted_union``'s meaning (``missing`` defaults to the
    table length)."""
    if missing is None:
        missing = s_key.shape[0]
    lower, upper = sorted_bounds(s_key, q_key)
    found = (upper > lower) & ((q_key >> KHI_SHIFT) != SENTINEL)
    idx = torch.where(found, upper - 1, torch.full_like(upper, missing))
    return Lookup(idx, found, upper, lower)


KERNEL_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
CENTER_TAP = KERNEL_OFFSETS.index((0, 0, 0))


def neighbor_map_plain(khi, klo, coords, batch, valid) -> torch.Tensor:
    cap = valid.shape[0]
    dev = valid.device
    offs = torch.tensor(KERNEL_OFFSETS, dtype=torch.int32, device=dev)       # (27, 3)
    q = coords[:, None, :] + offs[None, :, :]                                # (V, 27, 3)
    in_range = ((q >= 0) & (q < COORD_MAX)).all(-1) & valid[:, None]
    q_hi, q_lo = pack(batch[:, None].expand(-1, 27), q.clamp(0, COORD_MAX - 1))
    lower, upper = sorted_bounds_plain(pack_key(khi, klo), pack_key(q_hi, q_lo))
    found = in_range & (upper > lower) & (q_hi != SENTINEL)
    nbr = torch.where(found, lower, torch.full_like(lower, cap))
    center = torch.where(valid, torch.arange(cap, dtype=torch.int32, device=dev),
                         torch.full((cap,), cap, dtype=torch.int32, device=dev))
    nbr[:, CENTER_TAP] = center
    return nbr


NEIGHBOR_LEVELS_MAX = 8   # levels a launch of K16's neighbour mode takes (kMaxLevels)


def neighbor_maps_plain(levels) -> list:
    return [neighbor_map_plain(lv.khi, lv.klo, lv.coords, lv.batch, lv.valid) for lv in levels]


_LEVEL_DTYPES = (torch.int32,) * 4 + (torch.bool,)   # khi, klo, coords, batch, valid


def neighbor_maps_cuda(levels) -> list:
    # a short kernel's event time is mostly its wrapper's host work: one
    # pass over the 5 fields a level checks and reads each tensor once
    card = levels[0].valid.get_device()
    caps, ptrs = [], []
    for lv in levels:
        cap = lv.valid.shape[0]
        fields = (lv.khi, lv.klo, lv.coords, lv.batch, lv.valid)
        for t, dt in zip(fields, _LEVEL_DTYPES):
            if (t.dtype != dt or t.shape[0] != cap or not t.is_contiguous()
                    or t.get_device() != card):
                raise TypeError("neighbor_maps: a level wants contiguous khi, klo, batch "
                                "int32, coords (V, 3) int32 and valid bool of V rows, all on "
                                "one card")
            ptrs.append(t.data_ptr())
        if lv.coords.shape[1:] != (3,):
            raise TypeError("neighbor_maps: coords must be (V, 3)")
        caps.append(cap)
        ptrs.append(0)                      # the level's map, below
    # every map in one buffer, each on a 16-byte boundary (the kernel writes
    # by 16-byte stores: a level's rows padded to a multiple of 4)
    rows = [cap + -cap % 4 for cap in caps]
    maps = list(torch.empty((sum(rows), 27), dtype=torch.int32,
                            device=levels[0].valid.device).split(rows))
    for i, m in enumerate(maps):
        if rows[i] != caps[i]:
            maps[i] = m[:caps[i]]
        ptrs[6 * i + 5] = m.data_ptr()
    # the pointers and caps as host arrays (array.array builds them several
    # times faster than ctypes arrays)
    ptr_arr, cap_arr = array.array("q", ptrs), array.array("i", caps)
    build.check(build.kernel_lib().ms3d_neighbor_maps(
        len(caps), ptr_arr.buffer_info()[0], cap_arr.buffer_info()[0],
        _stream(levels[0].valid)), "neighbor_map")
    if any(caps):
        build.LAUNCHES["neighbor_map"] += 1
    return maps


def neighbor_maps(levels) -> list:
    """The (V_l, 27) int32 same-level kernel map of every level of a plan,
    each level a sorted table of unique keys with khi, klo int32, coords
    (V, 3) int32, batch int32 and valid bool fields (``sparse.Level``, or
    ``Table``): per row, the row of each neighbour cell in
    ``KERNEL_OFFSETS`` order, the centre the row itself, V where absent or
    where the row is invalid. K16's neighbour mode on CUDA tensors: one
    launch for all of them (1 to 8 levels)."""
    levels = list(levels)
    if not 1 <= len(levels) <= NEIGHBOR_LEVELS_MAX:
        raise ValueError(f"neighbor_maps: {len(levels)} levels, one launch takes 1 to "
                         f"{NEIGHBOR_LEVELS_MAX}")
    if _device("neighbor_maps", *(lv.valid for lv in levels)) == "cpu":
        return neighbor_maps_plain(levels)
    return neighbor_maps_cuda(levels)


# ---- K17 -------------------------------------------------------------------

class Unique(NamedTuple):
    first: torch.Tensor      # (N,) bool first row of a valid key
    seg: torch.Tensor        # (N,) int32 index of the row's key (n_unique if invalid)
    n_unique: torch.Tensor   # () int32


class Table(NamedTuple):
    """The compacted table of ``unique_compact``; index ``cap`` = absent."""

    khi: torch.Tensor        # (cap,) int32, SENTINEL padding
    klo: torch.Tensor        # (cap,) int32, SENTINEL padding
    coords: torch.Tensor     # (cap, 3) int32 unpacked klo (0 on padding)
    batch: torch.Tensor      # (cap,) int32 khi (0 on padding)
    valid: torch.Tensor      # (cap,) bool
    count: torch.Tensor      # () int32 min(n_unique, cap)
    n_dropped: torch.Tensor  # () int32 max(n_unique - cap, 0)
    row2voxel: torch.Tensor  # (N,) int32 input row -> slot (cap = invalid/dropped)
    src: torch.Tensor        # (cap,) int32 representative input row (-1 = pad)


def unique_compact_plain(s_key, valid, perm, cap: int | None):
    n = s_key.shape[0]
    dev = s_key.device
    s_valid = valid if perm is None else valid[perm.long()]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = s_key[1:] != s_key[:-1]
    first &= s_valid
    seg = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    n_uni = first.sum(dtype=torch.int32)
    seg = torch.where(s_valid, seg, n_uni)
    uniq = Unique(first, seg, n_uni)
    if cap is None:
        return uniq, None
    target = torch.where(first & (seg < cap), seg, torch.full_like(seg, cap)).long()
    khi = torch.full((cap + 1,), SENTINEL, dtype=torch.int32, device=dev)
    klo = khi.clone()
    src = torch.full((cap + 1,), -1, dtype=torch.int32, device=dev)
    khi[target] = (s_key >> KHI_SHIFT).to(torch.int32)
    klo[target] = (s_key & SENTINEL).to(torch.int32)
    src[target] = perm
    khi, klo, src = khi[:cap], klo[:cap], src[:cap]
    count = torch.clamp(n_uni, max=cap)
    valid = torch.arange(cap, device=dev) < count
    _, coords = unpack(khi, klo)
    coords = torch.where(valid[:, None], coords, torch.zeros_like(coords))
    batch = torch.where(valid, khi, torch.zeros_like(khi))
    seg_c = torch.where(s_valid & (seg < cap), seg, torch.full_like(seg, cap))
    row2voxel = torch.empty_like(seg_c)
    row2voxel[perm.long()] = seg_c
    return uniq, Table(khi, klo, coords, batch, valid, count, (n_uni - cap).clamp(min=0),
                       row2voxel, src)


UNIQUE_GRID_MAX = 1024   # K17's tile counts (csrc/unique_compact.cu kMaxGrid)


def _carve(sizes: list, dtype: torch.dtype, device) -> list:
    """Consecutive 1-D views of one new buffer of the given lengths, each
    starting on a 16-byte boundary (one allocation and one split: a short
    kernel's wrapper pays for every tensor op)."""
    per = 16 // dtype.itemsize
    parts = []
    for size in sizes:
        parts += [size, -size % per]
    return torch.empty(sum(parts), dtype=dtype, device=device).split_with_sizes(parts)[::2]


def unique_compact_cuda(s_key, valid, perm, cap: int | None):
    s_key = _want("unique_compact", s_key, torch.int64)
    valid = _want("unique_compact", valid, torch.bool)
    n = s_key.shape[0]
    if valid.shape[0] != n:
        raise ValueError(f"unique_compact: {valid.shape[0]} valid flags for {n} keys")
    perm_ptr = 0
    if perm is not None:
        perm = _want("unique_compact", perm, torch.int32)
        if perm.shape[0] != n:
            raise ValueError(f"unique_compact: a permutation of {perm.shape[0]} rows for {n} keys")
        perm_ptr = perm.data_ptr()
    dev = s_key.device
    # int32: tile counts, seg, the three scalars, then the table's khi, klo,
    # batch, src, coords and row2voxel; bool: first, then the table's valid
    sizes = [UNIQUE_GRID_MAX, n, 3]
    if cap is not None:
        sizes += [cap, cap, cap, cap, 3 * cap, n]
    ints = _carve(sizes, torch.int32, dev)
    bools = _carve([n] if cap is None else [n, cap], torch.bool, dev)
    tiles, seg, scalars = ints[:3]
    first = bools[0]
    table, table_ptrs = None, [0] * 7
    if cap is not None:
        khi, klo, batch, src, coords, row2voxel = ints[3:]
        table = Table(khi, klo, coords.view(cap, 3), batch, bools[1], scalars[1], scalars[2],
                      row2voxel, src)
        table_ptrs = [t.data_ptr() for t in (row2voxel, khi, klo, coords, batch, src, bools[1])]
    build.check(build.kernel_lib().ms3d_unique_compact(
        s_key.data_ptr(), valid.data_ptr(), perm_ptr, n, -1 if cap is None else cap,
        tiles.data_ptr(), first.data_ptr(), seg.data_ptr(), scalars.data_ptr(), *table_ptrs,
        _stream(s_key)), "unique_compact")
    build.LAUNCHES["unique_compact"] += 1
    return Unique(first, seg, scalars[0]), table


def unique_compact(s_key: torch.Tensor, valid: torch.Tensor, perm: torch.Tensor | None,
                   cap: int | None) -> tuple:
    """Over sorted int64 keys (N,), their valid flags and the permutation of
    the sort (int32, sorted position -> input row, or None): (``Unique``,
    ``Table`` of capacity ``cap``, or None when ``cap`` is None). With
    ``perm`` the flags are in input-row order (sorted row i reads
    ``valid[perm[i]]``), without it in sorted order; a table needs
    ``perm``. K17 on CUDA tensors: one launch, the gather through ``perm``
    included."""
    if cap is not None and (cap < 0 or perm is None):
        raise ValueError(f"unique_compact: a table (cap {cap}) needs cap >= 0 and perm")
    tensors = (s_key, valid) if perm is None else (s_key, valid, perm)
    if _device("unique_compact", *tensors) == "cpu":
        return unique_compact_plain(s_key, valid, perm, cap)
    return unique_compact_cuda(s_key, valid, perm, cap)


def unique_sorted(s_key: torch.Tensor, valid_sorted: torch.Tensor) -> Unique:
    """(first (N,) bool, seg (N,) int32 with n_unique for invalid rows,
    n_unique () int32) over sorted keys."""
    return unique_compact(s_key, valid_sorted, None, None)[0]
