"""Clustering: unit table, connected components (kernel K3), compaction.

Counterparts of minsu3d_tpu/ops/cluster.py: ``connected_components``
(:21, kernel K3 on CUDA tensors; no root-graph coarsening, a speed knob
whose labels are identical), ``compact_labels`` (:160, on kernel K9),
``cluster_points`` (:208), ``_unit_table`` (:230, on kernel K6
``segment_reduce``), ``_unit_points_compact`` (:261, kernel K9
``unit_compact`` on CUDA tensors) and ``cluster_units`` (:308) on its three
ball queries: the direct grid query (K14), the edge-buffer query and the
fused query (both K2). Every output equals the JAX function's bit for bit,
on the CPU and on the card: unit centroids are f32 sums in point order (K6
adds each unit's points in row order, as XLA's CPU scatter does), and every
integer output (labels, cluster ids, sizes, drop counts) is exact; sorts
are ``stable=True`` because ``jnp.argsort`` is stable.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from minsu3d_tpu_torch.csrc import build
from minsu3d_tpu_torch.ops import segment
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


def cc_sweep_plain(label: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> bool:
    """One hook + full-jump sweep on ``label`` ((N+1,) int64, in place).
    Returns whether any edge still joined two labels (the kernel's flag)."""
    ru, rv = label[src], label[dst]
    diff = ru != rv
    if not bool(diff.any()):
        return False
    hi = torch.maximum(ru, rv)[diff]
    lo = torch.minimum(ru, rv)[diff]
    label.scatter_reduce_(0, hi, lo, reduce="amin")
    while True:
        nxt = label[label]
        if torch.equal(nxt, label):
            return True
        label.copy_(nxt)


def connected_components_plain(nbr_idx, nbr_valid, active, group, max_iters: int):
    """Plain version of K3: same sweeps, torch scatter_reduce for the hooks."""
    n = nbr_idx.shape[0]
    ok = edge_mask(nbr_idx, nbr_valid, active, group)
    src = torch.arange(n, device=nbr_idx.device)[:, None].expand_as(ok)[ok]
    dst = nbr_idx.long()[ok]
    label = torch.where(torch.cat([active, active.new_zeros(1)]),
                        torch.arange(n + 1, device=nbr_idx.device),
                        torch.full((n + 1,), n, device=nbr_idx.device))
    for _ in range(max_iters):
        if not cc_sweep_plain(label, src, dst):
            return label[:n], False
    return label[:n], True


def connected_components_cuda(nbr_idx, nbr_valid, active, group, max_iters: int):
    """K3 (csrc/connected_components.cu): cc_hook + cc_jump per sweep until
    the hook changes nothing, at most ``max_iters`` sweeps."""
    n, k = nbr_idx.shape
    dev = nbr_idx.device
    if group is None:
        group = torch.zeros(n, dtype=torch.int32, device=dev)
    tensors = (nbr_idx, nbr_valid, active, group)
    if any(t.device != dev for t in tensors):
        raise ValueError("connected_components: tensors on several devices")
    want = (torch.int32, torch.bool, torch.bool, torch.int32)
    if tuple(t.dtype for t in tensors) != want:
        raise TypeError(f"connected_components: dtypes {[t.dtype for t in tensors]}, "
                        f"want {want}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("connected_components: inputs must be contiguous")
    lib = build.kernel_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    label = torch.where(active, torch.arange(n, dtype=torch.int32, device=dev),
                        torch.full((n,), n, dtype=torch.int32, device=dev))
    prev = torch.empty_like(label)
    changed = torch.zeros(1, dtype=torch.int32, device=dev)
    for _ in range(max_iters):
        prev.copy_(label)
        changed.zero_()
        build.check(lib.ms3d_cc_hook(nbr_idx.data_ptr(), nbr_valid.data_ptr(),
                                     active.data_ptr(), group.data_ptr(), n, k,
                                     prev.data_ptr(), label.data_ptr(), changed.data_ptr(),
                                     stream), "cc_hook")
        build.LAUNCHES["connected_components"] += 1
        build.check(lib.ms3d_cc_jump(active.data_ptr(), n, label.data_ptr(), stream),
                    "cc_jump")
        build.LAUNCHES["connected_components"] += 1
        if not bool(changed.item()):
            return label.long(), False
    return label.long(), True


def connected_components(nbr_idx, nbr_valid, active, group=None, max_iters: int = 64):
    """Min-index component labels ((N,) int64; inactive nodes get N) and
    whether ``max_iters`` sweeps ended before the fixpoint."""
    if nbr_idx.device.type == "cpu":
        return connected_components_plain(nbr_idx, nbr_valid, active, group, max_iters)
    if nbr_idx.device.type == "cuda":
        return connected_components_cuda(nbr_idx, nbr_valid, active, group, max_iters)
    raise ValueError(f"connected_components: unsupported device {nbr_idx.device}")


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


def unit_points_compact_plain(u_label, uid, u_cap: int, c_cap: int, u_counts):
    """K9's plain version, in K9's algorithm: a component's run index is the
    exclusive prefix count of root flags (the labels are min-index roots),
    its size an integer sum into its root, then the stable size ranking.
    Returns (point_cluster (N,), sizes (C,), count (), seg_sizes (U,))."""
    u = u_label.shape[0]
    dev = u_label.device
    active = u_label < u
    ids = torch.arange(u, device=dev)
    is_root = active & (u_label == ids)
    seg_of_root = torch.cumsum(is_root.to(torch.int64), 0) - 1
    count = is_root.sum()
    root = torch.where(active, u_label, torch.full_like(u_label, u))
    root_size = torch.zeros(u + 1, dtype=torch.int64, device=dev).index_add_(
        0, root, u_counts.long())[:u]
    seg_sizes = torch.zeros(u, dtype=torch.int64, device=dev)
    seg_sizes[seg_of_root[is_root]] = root_size[is_root]
    rank_src = torch.sort(-seg_sizes, stable=True).indices
    rank = torch.empty(u, dtype=torch.int64, device=dev)
    rank[rank_src] = ids
    r = rank[seg_of_root[root.clamp(max=u - 1)]]
    unit_cid = torch.where(active & (r < c_cap), r, torch.full_like(r, c_cap))
    cid_ext = torch.cat([unit_cid, unit_cid.new_full((1,), c_cap)])
    point_cluster = torch.where(uid < u_cap, cid_ext[uid.clamp(max=u_cap)],
                                torch.full_like(uid, c_cap))
    sizes = torch.zeros(c_cap + 1, dtype=torch.int64, device=dev).index_add_(
        0, unit_cid, u_counts.long())[:c_cap]
    return point_cluster, sizes, count, seg_sizes


def unit_points_compact_cuda(u_label, uid, u_cap: int, c_cap: int, u_counts):
    """K9 (csrc/unit_compact.cu); same outputs as the plain version."""
    u = u_label.shape[0]
    dev = u_label.device
    if u != u_cap:
        raise ValueError(f"unit_compact: {u} labels for u_cap {u_cap}")
    label = u_label.to(torch.int32).contiguous()
    counts = u_counts.to(torch.int32).contiguous()
    uid32 = uid.to(torch.int32).contiguous()
    i32 = dict(dtype=torch.int32, device=dev)
    root_size, seg_sizes = torch.zeros(u, **i32), torch.zeros(u, **i32)
    sizes = torch.zeros(c_cap, **i32)
    count = torch.zeros(1, **i32)
    scratch = [torch.empty(u, **i32) for _ in range(8)]
    flag, seg_of_root, keys_a, vals_a, keys_b, vals_b, rank, unit_cid = scratch
    point_cluster = torch.empty(uid32.shape[0], **i32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(build.kernel_lib().ms3d_unit_compact(
        label.data_ptr(), counts.data_ptr(), u, uid32.data_ptr(), uid32.shape[0], c_cap,
        root_size.data_ptr(), flag.data_ptr(), seg_of_root.data_ptr(), seg_sizes.data_ptr(),
        count.data_ptr(), keys_a.data_ptr(), vals_a.data_ptr(), keys_b.data_ptr(),
        vals_b.data_ptr(), rank.data_ptr(), sizes.data_ptr(), unit_cid.data_ptr(),
        point_cluster.data_ptr(), stream), "unit_compact")
    build.LAUNCHES["unit_compact"] += 1
    return point_cluster.long(), sizes.long(), count[0].long(), seg_sizes.long()


def unit_points_compact(u_label, uid, u_cap: int, c_cap: int, u_counts, big_thre: int):
    """Unit labels (K3's min-index roots) -> size-ranked per-point cluster
    ids (``_unit_points_compact`` with ``u_counts``): (point_cluster, sizes,
    valid, count, clusters_dropped). K9 on CUDA tensors."""
    if u_label.device.type == "cpu":
        fn = unit_points_compact_plain
    elif u_label.device.type == "cuda":
        fn = unit_points_compact_cuda
    else:
        raise ValueError(f"unit_points_compact: unsupported device {u_label.device}")
    point_cluster, sizes, count, seg_sizes = fn(u_label, uid, u_cap, c_cap, u_counts)
    valid = torch.arange(c_cap, device=u_label.device) < count.clamp(max=c_cap)
    n_big = (seg_sizes >= big_thre).sum() if big_thre > 1 else count
    return point_cluster, sizes, valid, count.clamp(max=c_cap), (n_big - c_cap).clamp(min=0)


def compact_labels(label, active, c_cap: int, big_thre: int = 1) -> Clusters:
    """CC labels -> dense cluster ids [0, C), largest components first, ties
    by label (``compact_labels``). Every JAX caller hands it connected-
    component labels, which are min-index roots; on those it equals K9's
    algorithm with unit counts of one and the identity unit map, so it runs
    on K9 (``unit_points_compact``). Raises when an active label is not a
    root (``label[label] != label``). ``edges_dropped`` and
    ``cc_unconverged`` read 0 (``cluster_points`` fills them)."""
    n = label.shape[0]
    dev = label.device
    u_label = torch.where(active, label.long(), torch.full_like(label, n, dtype=torch.int64))
    lab = u_label[active]
    root = (lab < n) & (u_label[lab.clamp(max=n - 1)] == lab)
    if not bool(root.all()):
        raise ValueError("compact_labels: active labels must be component roots "
                         "(label[label] == label), as connected_components gives them")
    ids = torch.arange(n, device=dev)
    uid = torch.where(active, ids, torch.full_like(ids, n))
    point_cluster, sizes, valid, count, dropped = unit_points_compact(
        u_label, uid, n, c_cap, active.to(torch.int64), big_thre)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return Clusters(point_cluster, sizes, valid, count, zero, dropped, zero)


def cluster_points(coords, batch, active, group, radius: float, k: int, window: int,
                   c_cap: int, max_iters: int, half_space: bool, edge_cap: int,
                   big_thre: int = 1) -> Clusters:
    """Connected components at point granularity (``cluster_points``): the
    edge-buffer ball query when ``edge_cap`` > 0, else the fused query, then
    K3 and ``compact_labels``."""
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
    label, unconverged = connected_components(nbr_idx, nbr_valid, active, group, max_iters)
    return compact_labels(label, active, c_cap, big_thre)._replace(
        edges_dropped=dropped,
        cc_unconverged=torch.tensor(int(unconverged), device=coords.device))


def cluster_units(coords, batch, active, group, unit_id, u_cap: int, radius: float,
                  k: int, window: int, c_cap: int, max_iters: int, half_space: bool,
                  edge_cap: int, big_thre: int = 1, grid_cell: float = 0.0) -> Clusters:
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
                                                max_iters)
    point_cluster, sizes, valid, count, clusters_dropped = unit_points_compact(
        u_label, uid, u_cap, c_cap, u_counts, big_thre)
    return Clusters(point_cluster, sizes, valid, count, dropped, clusters_dropped,
                    torch.tensor(int(unconverged), device=coords.device))
