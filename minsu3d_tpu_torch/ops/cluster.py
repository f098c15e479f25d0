"""Clustering: unit table, connected components (kernels K3 and K18),
compaction.

Counterparts of minsu3d_tpu/ops/cluster.py: ``connected_components`` (:21,
kernel K3 on CUDA tensors, with the root-graph coarsening of :102-144 as
K18, all in one launch with no host sync; the same sweeps and loop counts
as the JAX function, so the labels are equal at every budget),
``compact_labels`` (:160, on kernel K9), ``cluster_points`` (:208),
``_unit_table`` (:230, on kernel K6 ``segment_reduce``),
``_unit_points_compact`` (:261, kernel K9 ``unit_compact`` on CUDA tensors)
and ``cluster_units`` (:308) on its three ball queries: the direct grid
query (K14), the edge-buffer query and the fused query (both K2). Every
output equals the JAX function's bit for bit, on the CPU and on the card:
unit centroids are f32 sums in point order (K6 adds each unit's points in
row order, as XLA's CPU scatter does), and every integer output (labels,
cluster ids, sizes, drop counts) is exact; sorts are ``stable=True``
because ``jnp.argsort`` is stable."""

from __future__ import annotations

from typing import NamedTuple

import torch

from minsu3d_tpu_torch.csrc import build
from minsu3d_tpu_torch.ops import hashing, segment
from minsu3d_tpu_torch.ops.ballquery import ball_query, ball_query_edge, ball_query_grid


class Clusters(NamedTuple):
    point_cluster: torch.Tensor   # (N,) int64 in [0, C) or C for none
    sizes: torch.Tensor           # (C,) int64
    valid: torch.Tensor           # (C,) bool
    count: torch.Tensor           # () int64
    edges_dropped: torch.Tensor   # () int64 ball-query edge-buffer overflow
    clusters_dropped: torch.Tensor  # () int64 components >= big_thre beyond C
    cc_unconverged: torch.Tensor  # () int64 1 if CC stopped at max_iters


def edge_mask(nbr_idx, nbr_valid, active, group):
    """(N, K) bool: edges CC may follow (valid, both ends active, same group)."""
    n = nbr_idx.shape[0]
    v = nbr_idx.long().clamp(max=n)
    act_e = torch.cat([active, active.new_zeros(1)])
    ok = nbr_valid & active[:, None] & act_e[v]
    if group is not None:
        g_e = torch.cat([group, group.new_full((1,), -2)])
        ok = ok & (g_e[v] == group[:, None])
    return ok


class _PlainSweeps:
    """K3's and K18's plain versions: the JAX sweeps in its (N+1,) int64
    label space (slot N is the inactive label and stays N)."""

    def __init__(self, nbr_idx, nbr_valid, active, group):
        n = nbr_idx.shape[0]
        dev = nbr_idx.device
        self.n = n
        self.ok = edge_mask(nbr_idx, nbr_valid, active, group)
        self.nbr = nbr_idx.long().clamp(0, n)
        self.src = torch.arange(n, device=dev)[:, None].expand_as(self.ok)[self.ok]
        self.dst = self.nbr[self.ok]
        self.active_e = torch.cat([active, active.new_zeros(1)])
        self.fill = torch.full((n + 1,), n, device=dev)
        self.sweeps = self.csweeps = 0
        self.key_sort, self.unique_compact = hashing.key_sort_plain, hashing.unique_compact_plain

    def label0(self):
        return torch.where(self.active_e, torch.arange(self.n + 1, device=self.fill.device),
                           self.fill)

    def _hook(self, e, ru, rv):
        """label[max(ru, rv)] min= min(ru, rv) per pair, reading ``e``; the
        JAX sweep's two scatter-mins, whose other writes are no-ops
        (e[x] <= x). Then two synchronous jumps (JAX's default ``jumps``)
        and the active mask. Returns (new labels, whether any label
        changed)."""
        e2 = e.scatter_reduce(0, torch.maximum(ru, rv), torch.minimum(ru, rv), reduce="amin")
        for _ in range(2):
            e2 = torch.minimum(e2, e2[e2])
        e2 = torch.where(self.active_e, e2, self.fill)
        return e2, not torch.equal(e2, e)

    def sweep(self, e):
        self.sweeps += 1
        return self._hook(e, e[self.src], e[self.dst])

    def pairs(self, e):
        """(M,) int64 pair keys of the M edge slots that join two roots,
        in slot order (row-major)."""
        ru = e[:self.n, None].expand_as(self.nbr)
        rv = e[self.nbr]
        cross = self.ok & (ru != rv)
        return hashing.pack_key(torch.minimum(ru, rv)[cross], torch.maximum(ru, rv)[cross])

    def csweep(self, e, ea, eb):
        self.csweeps += 1
        ok = (ea < self.n) & (eb < self.n)
        return self._hook(e, e[ea.long()[ok]], e[eb.long()[ok]])

    def labels(self, e):
        return e[:self.n]


def cross_pair_list(ops, keys: torch.Tensor, coarsen: int) -> tuple:
    """The first ``coarsen`` distinct cross-root pairs (a < b) in ascending
    order, from the keys ``a << 31 | b`` of the edge slots that join two
    roots, in any order: K15's and K17's plain versions sort them and keep
    the first ``coarsen`` distinct keys, in order, which is JAX's
    ``lax.sort`` + ``uniq`` + ``slot < coarsen`` (ops/cluster.py:104-119;
    its sentinel slots sort last, so dropping them first changes nothing).
    Both labels of a key are at most N, so the keys take 31 +
    N.bit_length() bits. Returns (ea, eb) (coarsen,) int32, SENTINEL in
    unused slots, and the number of distinct keys."""
    if keys.numel() == 0:
        empty = torch.full((coarsen,), hashing.SENTINEL, dtype=torch.int32, device=keys.device)
        return empty, empty.clone(), 0
    s_key, perm = ops.key_sort(keys, hashing.KHI_SHIFT + ops.n.bit_length())
    valid = torch.ones_like(s_key, dtype=torch.bool)
    uniq, table = ops.unique_compact(s_key, valid, perm, coarsen)
    return table.khi, table.klo, int(uniq.n_unique)


class CCResult(NamedTuple):
    """0-dim int64 tensors on the labels' device, but ``labels``."""

    labels: torch.Tensor       # (N,) int64 min-index labels, N for inactive nodes
    unconverged: torch.Tensor  # 1 if the loop ended before a sweep changed nothing
    sweeps: torch.Tensor       # full-graph sweeps run
    csweeps: torch.Tensor      # pair-list sweeps run (coarsening)
    pairs: torch.Tensor        # distinct cross-root pairs found (0 without coarsening)


def _run(ops, max_iters: int, coarsen: int, coarsen_sweeps: int) -> CCResult:
    """JAX's loops (ops/cluster.py:92-101, :102-146) over ``ops``' sweeps."""
    e, _ = ops.sweep(ops.label0())
    n_pairs = 0
    if coarsen > 0:
        for _ in range(max(coarsen_sweeps - 1, 0)):
            e, _ = ops.sweep(e)
        ea, eb, n_pairs = cross_pair_list(ops, ops.pairs(e), coarsen)
        e, _ = ops.csweep(e, ea, eb)
        done, i = False, 0
        while not done and i < max_iters:
            e, changed = ops.csweep(e, ea, eb)
            done, i = not changed, i + 1
        e, changed = ops.sweep(e)
        done, i = not changed, 1
    else:
        e, _ = ops.sweep(e)
        done, i = False, 0
    while not done and i < max_iters:
        e, changed = ops.sweep(e)
        done, i = not changed, i + 1
    counts = torch.tensor([int(not done), ops.sweeps, ops.csweeps, n_pairs], device=e.device)
    return CCResult(ops.labels(e), *counts.unbind())


def connected_components_plain(nbr_idx, nbr_valid, active, group=None, max_iters: int = 64,
                               coarsen: int = 0, coarsen_sweeps: int = 2) -> CCResult:
    """K3's and K18's plain versions (and K15's and K17's for the pair
    list), on tensors of any device."""
    return _run(_PlainSweeps(nbr_idx, nbr_valid, active, group), max_iters, coarsen,
                coarsen_sweeps)


# the kernel's control words: the barrier and counters, then the radix
# select's histograms (8 rounds of 256 digits)
_CC_CTRL_WORDS = 8 + 8 * 256


def cc_scratch_words(n: int, k: int, max_iters: int, coarsen: int,
                     coarsen_sweeps: int) -> tuple:
    """(int32, int64) words of a K3 call's scratch, as the C side's
    ``scratch_words`` counts them (the launcher refuses less): the active
    rows' edges (a word a slot), the labels, both hook arrays and the active
    ids, the control words and a flag a sweep; with coarsening the distinct
    keys (a word a slot) and the hash table (a power of two >= 2 a slot)."""
    slots = n * k
    w32 = slots + 4 * n + _CC_CTRL_WORDS + max(coarsen_sweeps, 1) + 2 * max_iters + 4
    w64 = slots + max(64, 1 << (2 * slots - 1).bit_length()) if coarsen > 0 else 0
    return w32, w64


def connected_components_cuda(nbr_idx, nbr_valid, active, group=None, max_iters: int = 64,
                              coarsen: int = 0, coarsen_sweeps: int = 2) -> CCResult:
    """K3 and, with ``coarsen`` > 0, K18: the whole call in one cooperative
    launch (csrc/connected_components.cu) that reads nothing back; CUDA
    tensors (nbr_idx int32, nbr_valid and active bool, group int32 or
    None)."""
    n, k = nbr_idx.shape
    dev = nbr_idx.device
    tensors = (nbr_idx, nbr_valid, active) + (() if group is None else (group,))
    if any(t.device != dev for t in tensors):
        raise ValueError("connected_components: tensors on several devices")
    want = (torch.int32, torch.bool, torch.bool, torch.int32)[:len(tensors)]
    if tuple(t.dtype for t in tensors) != want:
        raise TypeError(f"connected_components: dtypes {[t.dtype for t in tensors]}, "
                        f"want {want}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("connected_components: inputs must be contiguous")
    if min(max_iters, coarsen) < 0:
        raise ValueError(f"connected_components: max_iters {max_iters}, coarsen {coarsen}")
    w32, w64 = cc_scratch_words(n, k, max_iters, coarsen, coarsen_sweeps)
    work = torch.empty(w64 + (w32 + 1) // 2, dtype=torch.int64, device=dev)
    out = torch.empty(n + 4, dtype=torch.int64, device=dev)
    build.check(build.kernel_lib().ms3d_connected_components(
        *(t.data_ptr() for t in tensors[:3]), 0 if group is None else group.data_ptr(), n, k,
        max_iters, coarsen, coarsen_sweeps, work.data_ptr() + 8 * w64, w32, work.data_ptr(),
        w64, out.data_ptr(), out.data_ptr() + 8 * n, hashing._stream(out)),
        "connected_components")
    build.LAUNCHES["connected_components"] += 1
    if coarsen > 0:
        build.LAUNCHES["cc_coarsen"] += 1
    return CCResult(out[:n], *out[n:].unbind())


def connected_components(nbr_idx, nbr_valid, active, group=None, max_iters: int = 64,
                         coarsen: int = 0, coarsen_sweeps: int = 2):
    """Min-index component labels ((N,) int64; inactive nodes get N) and
    whether the loop ended before a sweep left the labels unchanged (a
    0-dim int64 tensor on the input's device: 1 if not).

    Sweep for sweep the JAX function's, so the labels are equal at every
    budget, also where ``max_iters`` runs out before the fixpoint: a sweep
    hooks every edge's larger root onto the smaller (reading the labels as
    they were), then runs two synchronous pointer jumps ``e = min(e, e[e])``
    (the JAX function's default ``jumps``). Without coarsening: two sweeps, then up to
    ``max_iters`` more until one changes nothing. With ``coarsen`` > 0:
    ``coarsen_sweeps`` sweeps (at least one), the pair list
    (``cross_pair_list``), one hook over it, then up to ``max_iters`` more
    until one changes nothing; then a sweep, and up to ``max_iters`` - 1
    more until one changes nothing. K3 (and K18 for the coarsening) on CUDA
    tensors, in one launch with no host sync."""
    kind = nbr_idx.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"connected_components: unsupported device {nbr_idx.device}")
    fn = connected_components_plain if kind == "cpu" else connected_components_cuda
    res = fn(nbr_idx, nbr_valid, active, group, max_iters, coarsen, coarsen_sweeps)
    return res.labels, res.unconverged


def unit_table(coords, batch, active, group, unit_id, u_cap: int):
    """Aggregate points into units (``_unit_table``): (u_coords (U, 3),
    u_batch (U,), u_active (U,), u_group (U,), uid (N,) with u_cap =
    inactive, u_counts (U,) int64). The x/y/z/count sums and the batch/group
    maxima are K6 reductions over the CSR of ``uid`` (inactive points form
    the padding segment and are never reduced)."""
    uid = torch.where(active & (unit_id < u_cap), unit_id,
                      torch.full_like(unit_id, u_cap)).long()
    csr = segment.segment_csr(uid, u_cap)
    vals = torch.cat([coords.to(torch.float32), coords.new_ones((coords.shape[0], 1))], 1)
    acc = segment.segment_reduce(vals, csr, "sum")
    cnt = acc[:, 3]
    u_coords = acc[:, :3] / cnt.clamp(min=1.0)[:, None]
    ints = torch.stack([batch.to(torch.int32), group.to(torch.int32)], 1)
    mx = segment.segment_reduce(ints, csr, "max", -1)
    return (u_coords, mx[:, 0].contiguous(), cnt > 0, mx[:, 1].contiguous(), uid,
            cnt.to(torch.int64))


def unit_points_compact_plain(u_label, uid, u_cap: int, c_cap: int, u_counts, big_thre: int = 1):
    """K9's plain version, in K9's algorithm: every label value that an
    active unit holds is flagged, a run's index is the exclusive prefix
    count of the flags at its value (the ascending order of JAX's argsort
    of the labels, for any labels, roots or not), its size an integer sum
    into its value, then the stable size ranking. Returns (point_cluster
    (N,), sizes (C,), count (), seg_sizes (U,), n_big ()), all int64:
    n_big counts the runs of at least ``big_thre`` points (the count when
    ``big_thre`` <= 1)."""
    u = u_label.shape[0]
    dev = u_label.device
    active = u_label < u
    ids = torch.arange(u, device=dev)
    value = torch.where(active, u_label, torch.full_like(u_label, u)).long()
    flag = torch.zeros(u + 1, dtype=torch.bool, device=dev).index_fill_(0, value, True)[:u]
    seg_of_value = torch.cumsum(flag.to(torch.int64), 0) - 1
    count = flag.sum()
    value_size = torch.zeros(u + 1, dtype=torch.int64, device=dev).index_add_(
        0, value, u_counts.long())[:u]
    seg_sizes = torch.zeros(u, dtype=torch.int64, device=dev)
    seg_sizes[seg_of_value[flag]] = value_size[flag]
    rank_src = torch.sort(-seg_sizes, stable=True).indices
    rank = torch.empty(u, dtype=torch.int64, device=dev)
    rank[rank_src] = ids
    r = rank[seg_of_value[value.clamp(max=u - 1)]]
    unit_cid = torch.where(active & (r < c_cap), r, torch.full_like(r, c_cap))
    cid_ext = torch.cat([unit_cid, unit_cid.new_full((1,), c_cap)])
    point_cluster = torch.where(uid < u_cap, cid_ext[uid.clamp(max=u_cap)],
                                torch.full_like(uid, c_cap))
    sizes = torch.zeros(c_cap + 1, dtype=torch.int64, device=dev).index_add_(
        0, unit_cid, u_counts.long())[:c_cap]
    n_big = (seg_sizes >= big_thre).sum() if big_thre > 1 else count
    return point_cluster, sizes, count, seg_sizes, n_big


def unit_compact_words(u: int) -> int:
    """int32 words of K9's workspace for u units (``workspace_words`` in
    csrc/unit_compact.cu, which checks it): 8 control words, a count for
    each of at most 512 blocks, a (256 digit, 512 block) histogram, 256
    digit totals and eight arrays of u."""
    return 8 + 512 + 256 * 512 + 256 + 8 * u


def unit_points_compact_cuda(u_label, uid, u_cap: int, c_cap: int, u_counts,
                             big_thre: int = 1):
    """K9 (csrc/unit_compact.cu): the plain version's outputs, bit for bit,
    from one memset and one cooperative launch that reads the int64 labels,
    counts and unit ids and writes every output in int64 into one buffer;
    no host sync."""
    u = u_label.shape[0]
    dev = u_label.device
    if u != u_cap:
        raise ValueError(f"unit_compact: {u} labels for u_cap {u_cap}")
    label = u_label.long().contiguous()
    counts = u_counts.long().contiguous()
    uid64 = uid.long().contiguous()
    n = uid64.shape[0]
    words = unit_compact_words(u)
    work = torch.empty(words, dtype=torch.int32, device=dev)
    out = torch.empty(n + c_cap + u + 2, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(build.kernel_lib().ms3d_unit_compact(
        label.data_ptr(), counts.data_ptr(), u, uid64.data_ptr(), n, c_cap, big_thre,
        work.data_ptr(), words, out.data_ptr(), stream), "unit_compact")
    build.LAUNCHES["unit_compact"] += 1
    return (out[:n], out[n:n + c_cap], out[n + c_cap + u], out[n + c_cap:n + c_cap + u],
            out[n + c_cap + u + 1])


def unit_points_compact(u_label, uid, u_cap: int, c_cap: int, u_counts, big_thre: int):
    """Unit labels (U for an inactive unit) -> size-ranked per-point cluster
    ids (``_unit_points_compact`` with ``u_counts``): (point_cluster, sizes,
    valid, count, clusters_dropped). K9 on CUDA tensors."""
    if u_label.device.type == "cpu":
        fn = unit_points_compact_plain
    elif u_label.device.type == "cuda":
        fn = unit_points_compact_cuda
    else:
        raise ValueError(f"unit_points_compact: unsupported device {u_label.device}")
    point_cluster, sizes, count, _, n_big = fn(u_label, uid, u_cap, c_cap, u_counts, big_thre)
    count = count.clamp(max=c_cap)
    valid = torch.arange(c_cap, device=u_label.device) < count
    return point_cluster, sizes, valid, count, (n_big - c_cap).clamp(min=0)


def compact_labels(label, active, c_cap: int, big_thre: int = 1) -> Clusters:
    """CC labels -> dense cluster ids [0, C), largest components first, ties
    by label (``compact_labels``). Active labels lie in [0, N); they need
    not be roots (a truncated CC loop leaves some that are not): points are
    grouped by label value, as JAX's argsort groups them. That is K9's
    algorithm with unit counts of one and the identity unit map, so it runs
    on K9 (``unit_points_compact``), with no host sync. ``edges_dropped``
    and ``cc_unconverged`` read 0 (``cluster_points`` fills them)."""
    n = label.shape[0]
    dev = label.device
    u_label = torch.where(active, label.long(), torch.full_like(label, n, dtype=torch.int64))
    ids = torch.arange(n, device=dev)
    uid = torch.where(active, ids, torch.full_like(ids, n))
    point_cluster, sizes, valid, count, dropped = unit_points_compact(
        u_label, uid, n, c_cap, active.to(torch.int64), big_thre)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return Clusters(point_cluster, sizes, valid, count, zero, dropped, zero)


def cluster_points(coords, batch, active, group, radius: float, k: int, window: int,
                   c_cap: int, max_iters: int, half_space: bool, edge_cap: int,
                   big_thre: int = 1, coarsen: int = 0, coarsen_sweeps: int = 2) -> Clusters:
    """Connected components at point granularity (``cluster_points``): the
    edge-buffer ball query when ``edge_cap`` > 0, else the fused query, then
    ``connected_components`` (K3, K18 with ``coarsen``) and
    ``compact_labels``."""
    if edge_cap:
        nbr_idx, nbr_valid, dropped = ball_query_edge(
            coords, batch, active, radius, k, window, edge_cap, half_space=half_space,
            group=group)
    else:
        nbr_idx, nbr_valid = ball_query(coords, batch, active, radius, k, window,
                                        half_space=half_space, group=group)
        dropped = torch.zeros((), dtype=torch.int64, device=coords.device)
    if group is not None:   # K3 reads int32 groups (a unit table's are already)
        group = group.to(torch.int32).contiguous()
    label, unconverged = connected_components(nbr_idx, nbr_valid, active, group, max_iters,
                                              coarsen=coarsen, coarsen_sweeps=coarsen_sweeps)
    return compact_labels(label, active, c_cap, big_thre)._replace(
        edges_dropped=dropped, cc_unconverged=unconverged)


def cluster_units(coords, batch, active, group, unit_id, u_cap: int, radius: float,
                  k: int, window: int, c_cap: int, max_iters: int, half_space: bool,
                  edge_cap: int, big_thre: int = 1, grid_cell: float = 0.0,
                  coarsen: int = 0, coarsen_sweeps: int = 2) -> Clusters:
    """Connected components at unit granularity; returns per-POINT Clusters
    with sizes counted in points. The ball query over the units: the direct
    grid query (K14) when ``grid_cell`` > 0 (units of ``make_units_grid``
    with that cell), else the edge-buffer query when ``edge_cap`` > 0, else
    the fused query; only the edge buffer drops edges."""
    u_coords, u_batch, u_active, u_group, uid, u_counts = unit_table(
        coords, batch, active, group, unit_id, u_cap)
    dropped = torch.zeros((), dtype=torch.int64, device=coords.device)
    if grid_cell > 0:
        nbr_idx, nbr_valid = ball_query_grid(u_coords, u_batch, u_active, radius, k,
                                             grid_cell, half_space=half_space, group=u_group)
    elif edge_cap:
        nbr_idx, nbr_valid, dropped = ball_query_edge(
            u_coords, u_batch, u_active, radius, k, window, edge_cap,
            half_space=half_space, group=u_group)
    else:
        nbr_idx, nbr_valid = ball_query(u_coords, u_batch, u_active, radius, k, window,
                                        half_space=half_space, group=u_group)
    u_label, unconverged = connected_components(nbr_idx, nbr_valid, u_active, u_group,
                                                max_iters, coarsen=coarsen,
                                                coarsen_sweeps=coarsen_sweeps)
    point_cluster, sizes, valid, count, clusters_dropped = unit_points_compact(
        u_label, uid, u_cap, c_cap, u_counts, big_thre)
    return Clusters(point_cluster, sizes, valid, count, dropped, clusters_dropped, unconverged)
