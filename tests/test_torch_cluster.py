"""Unit clustering of the PyTorch port against minsu3d_tpu/ops/cluster.py:
connected-component labels, the unit table, the (voxel, class) units, the
size-ranked compaction and the whole cluster_units call, all bit for bit;
and a torch model of K9's multi-block radix ranking against the plain
version and the JAX compaction on the card test's label sets."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minsu3d_tpu.model import general_model as jgm
from minsu3d_tpu.ops import cluster as jcluster
from minsu3d_tpu.ops.ballquery import ball_query_edge as jax_bq
from minsu3d_tpu_torch.config import EvalConfig
from minsu3d_tpu_torch.data.batching import collate, eval_caps
from minsu3d_tpu_torch.data.dataset import eval_item, normalize
from minsu3d_tpu_torch.data.synthetic import make_scene
from minsu3d_tpu_torch.model import general_model as gm
from minsu3d_tpu_torch.ops import cluster
from test_torch_data import port_build_in_tmp  # noqa: F401
from test_torch_kernels_cuda import K9_CASES, _k9_labels

CFG = EvalConfig().with_overrides({"caps.eval_points": 16384, "caps.eval_voxels": 16384})
U_CAP = 8192


@pytest.fixture(scope="module")
def scene():
    """A collated small scene with ground-truth classes as the groups."""
    sc = normalize(make_scene(seed=9, num_objects=5, points_per_object=500,
                              floor_points=1600))
    b = collate([eval_item(CFG, sc, "s")], eval_caps(CFG))
    sem = np.maximum(b["sem_labels"], 0).astype(np.int32)
    active = b["point_mask"] & (b["sem_labels"] >= 2)
    return b, sem, active


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=msg)


def test_make_units_matches_jax(scene):
    b, sem, active = scene
    want = jgm.make_units(jnp.asarray(b["p2v"]), jnp.asarray(sem), jnp.asarray(active), U_CAP)
    got = gm.make_units(*_t(b["p2v"], sem, active), U_CAP)
    _eq(got[0], want[0])
    assert int(got[1]) == int(want[1]) == 0
    small = gm.make_units(*_t(b["p2v"], sem, active), 500)
    small_j = jgm.make_units(jnp.asarray(b["p2v"]), jnp.asarray(sem), jnp.asarray(active), 500)
    _eq(small[0], small_j[0])
    assert int(small[1]) == int(small_j[1]) > 0


def _units(scene):
    b, sem, active = scene
    units = jgm.make_units(jnp.asarray(b["p2v"]), jnp.asarray(sem), jnp.asarray(active),
                           U_CAP)[0]
    return b["point_xyz"], b["vert_batch_ids"], active, sem, np.asarray(units)


def test_unit_table_matches_jax(scene):
    args = _units(scene)
    want = jcluster._unit_table(*map(jnp.asarray, args), U_CAP)
    got = cluster.unit_table(*_t(*args), U_CAP)
    for name, g, w in zip(("coords", "batch", "active", "group", "uid", "counts"), got, want):
        _eq(g, w, name)


def _graph(scene, edge_cap=56 * U_CAP):
    args = _units(scene)
    u = jcluster._unit_table(*map(jnp.asarray, args), U_CAP)
    nbr, ok, _ = jax_bq(u[0], u[1], u[2], 0.03, 8, 8, edge_cap, half_space=True, group=u[3])
    return nbr, ok, u


@pytest.mark.parametrize("coarsen", [0, 4096])
def test_connected_components_matches_jax(scene, coarsen):
    nbr, ok, u = _graph(scene)
    want = jcluster.connected_components(nbr, ok, u[2], u[3], 32, coarsen=coarsen)
    got, unconverged = cluster.connected_components(*_t(nbr, ok, u[2], u[3]), max_iters=32,
                                                    coarsen=coarsen)
    _eq(got, want)
    assert not unconverged
    n_comp = int(((got == torch.arange(U_CAP)) & torch.from_numpy(np.array(u[2]))).sum())
    assert 1 < n_comp < int(np.asarray(u[2]).sum())


def test_connected_components_without_groups(scene):
    nbr, ok, u = _graph(scene)
    want = jcluster.connected_components(nbr, ok, u[2], None, 32)
    got, _ = cluster.connected_components(*_t(nbr, ok, u[2]), None, max_iters=32)
    _eq(got, want)


def test_connected_components_reports_unconverged(scene):
    nbr, ok, u = _graph(scene)
    _, unconverged = cluster.connected_components(*_t(nbr, ok, u[2], u[3]), max_iters=1)
    assert unconverged


@pytest.mark.parametrize("c_cap,big_thre", [(4096, 50), (8, 50), (8, 1), (3, 20)])
def test_unit_compaction_matches_jax(scene, c_cap, big_thre):
    nbr, ok, u = _graph(scene)
    label = jcluster.connected_components(nbr, ok, u[2], u[3], 32)
    want = jcluster._unit_points_compact(label, u[4], U_CAP, len(u[4]), c_cap,
                                         u_counts=u[5], big_thre=big_thre)
    got = cluster.unit_points_compact(*_t(label, u[4]), U_CAP, c_cap,
                                      torch.from_numpy(np.array(u[5])).long(), big_thre)
    for name, g, w in zip(("point_cluster", "sizes", "valid", "count", "clusters_dropped"),
                          got, (want.point_cluster, want.sizes, want.valid, want.count,
                                want.clusters_dropped)):
        _eq(g, w, name)


@pytest.mark.parametrize("edge_cap,c_cap", [(56 * U_CAP, 4096), (300, 16)])
def test_cluster_units_matches_jax(scene, edge_cap, c_cap):
    args = _units(scene)
    kw = dict(radius=0.03, k=8, window=8, c_cap=c_cap, max_iters=32, half_space=True,
              edge_cap=edge_cap, big_thre=50)
    want = jcluster.cluster_units(*map(jnp.asarray, args), U_CAP, coarsen=4096, **kw)
    got = cluster.cluster_units(*_t(*args), U_CAP, coarsen=4096, **kw)
    for name in ("point_cluster", "sizes", "valid", "count", "edges_dropped",
                 "clusters_dropped"):
        _eq(getattr(got, name), getattr(want, name), name)
    assert int(got.count) > 0
    if edge_cap == 300:
        assert int(got.edges_dropped) > 0


def k9_radix_model(u_label, uid, u_cap, c_cap, u_counts, big_thre, blocks):
    """K9 (csrc/unit_compact.cu) on ``blocks`` blocks: the flags by value
    and their numbering by tile counts; then the stable ranking by size as
    K9's multi-block LSD radix (8-bit digits, buckets from the highest digit
    down; a pass's histograms, a row a digit over the blocks, scanned in
    (digit, block) order; each block's tile scattered stably), pass 0 over
    each block's own run of segs and later passes over equal tiles; then
    ranks, sizes and the points. Returns the plain version's tuple."""
    u = u_label.shape[0]
    active = u_label < u
    value = torch.where(active, u_label, torch.full_like(u_label, u)).long()
    flag = torch.zeros(u + 1, dtype=torch.int64).index_fill_(0, value, 1)[:u]
    value_size = torch.zeros(u + 1, dtype=torch.int64).index_add_(0, value, u_counts.long())[:u]
    per = -(-u // blocks)
    tile_count = torch.stack([flag[b * per:(b + 1) * per].sum() for b in range(blocks)])
    seg0 = torch.cumsum(tile_count, 0) - tile_count
    n = int(tile_count.sum())
    seg_of_value = torch.full((u,), -1, dtype=torch.int64)
    for b in range(blocks):
        vals = torch.arange(b * per, min(u, (b + 1) * per))
        f = flag[vals].bool()
        seg_of_value[vals[f]] = seg0[b] + torch.arange(int(f.sum()))
    key = torch.zeros(n, dtype=torch.int64)
    key[seg_of_value[flag.bool()]] = value_size[flag.bool()]
    val = torch.arange(n)
    max_size = int(key.max()) if n else 0
    passes = 1
    while passes < 4 and max_size >> (8 * passes):
        passes += 1
    tiles = [(int(seg0[b]), int(seg0[b] + tile_count[b])) for b in range(blocks)]
    for p in range(passes):
        if p > 0:
            per_n = -(-n // blocks)
            tiles = [(min(n, b * per_n), min(n, b * per_n + per_n)) for b in range(blocks)]
        bucket = 255 - ((key >> (8 * p)) & 255)
        hist = torch.stack([torch.bincount(bucket[lo:hi], minlength=256) for lo, hi in tiles], 1)
        before_blocks = torch.cumsum(hist, 1) - hist              # (digit, block) scan
        total = hist.sum(1)
        digit_base = torch.cumsum(total, 0) - total
        pos = torch.empty(n, dtype=torch.int64)
        for b, (lo, hi) in enumerate(tiles):
            bk = bucket[lo:hi]
            order = torch.sort(bk, stable=True).indices
            first = torch.cumsum(torch.bincount(bk, minlength=256), 0) - torch.bincount(
                bk, minlength=256)
            within = torch.empty(hi - lo, dtype=torch.int64)
            within[order] = torch.arange(hi - lo) - first[bk[order]]
            pos[lo:hi] = digit_base[bk] + before_blocks[bk, b] + within
        key_out, val_out = torch.empty_like(key), torch.empty_like(val)
        key_out[pos], val_out[pos] = key, val
        key, val = key_out, val_out
    rank = torch.empty(n, dtype=torch.int64)
    rank[val] = torch.arange(n)
    seg_sizes = torch.zeros(u, dtype=torch.int64)
    seg_sizes[val] = key
    sizes = torch.zeros(c_cap, dtype=torch.int64)
    sizes[:min(n, c_cap)] = key[:c_cap]
    unit_cid = torch.full((u + 1,), c_cap, dtype=torch.int64)
    if n:
        r = rank[seg_of_value[value[active]]]
        unit_cid[:u][active] = torch.where(r < c_cap, r, torch.full_like(r, c_cap))
    point_cluster = unit_cid[uid.clamp(max=u_cap)]
    n_big = (seg_sizes >= big_thre).sum() if big_thre > 1 else torch.tensor(n)
    return point_cluster, sizes, torch.tensor(n), seg_sizes, n_big


@pytest.mark.parametrize("blocks", [1, 7])
@pytest.mark.parametrize("case", list(K9_CASES))
def test_k9_radix_ranking_matches_plain_and_jax(case, blocks):
    """K9's multi-block ranking equals the plain version (and so the JAX
    package's argsort-based compaction) bit for bit."""
    u, c_cap, big_thre = 3000, K9_CASES[case], 3
    label, counts = _k9_labels(case, u)
    uid = torch.randint(0, u + 1, (6000,), generator=torch.Generator().manual_seed(13))
    want = cluster.unit_points_compact_plain(label, uid, u, c_cap, counts, big_thre)
    got = k9_radix_model(label, uid, u, c_cap, counts, big_thre, blocks)
    for name, g, w in zip(("point_cluster", "sizes", "count", "seg_sizes", "n_big"), got, want):
        assert torch.equal(g, w), name
    n = int(want[2])
    assert n == {"n = 0": 0, "one giant component": 1}.get(case, n)
    if case == "sizes over 2^16":
        assert int(want[3].max()) >= 2 ** 16
    if case == "n > c_cap":
        assert n > c_cap
    jwant = jcluster._unit_points_compact(jnp.asarray(label, jnp.int32),
                                          jnp.asarray(uid, jnp.int32), u, uid.shape[0], c_cap,
                                          u_counts=jnp.asarray(counts, jnp.int32),
                                          big_thre=big_thre)
    tgot = cluster.unit_points_compact(label, uid, u, c_cap, counts, big_thre)
    for name, g, w in zip(("point_cluster", "sizes", "valid", "count", "clusters_dropped"),
                          tgot, (jwant.point_cluster, jwant.sizes, jwant.valid, jwant.count,
                                 jwant.clusters_dropped)):
        _eq(g, w, name)
