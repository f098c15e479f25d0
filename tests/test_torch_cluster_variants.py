"""The clustering variants of the PyTorch port against minsu3d_tpu's, bit for
bit on the CPU (plain versions of K2, K3, K9 and K14): the fused ball query
(no edge buffer), the direct grid ball query (``m`` 1 and 2, a cell that
holds two units), ``make_units_grid``, ``compact_labels`` (an overflowing
cluster cap, a size filter, non-root labels), ``cluster_points``,
``cluster_units`` on its grid and fused paths and every branch of
``cluster_step``. Inputs are seeded numpy blobs: two scenes, four groups, a
tail of inactive rows."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minsu3d_tpu.model import general_model as jgm
from minsu3d_tpu.model.caps import StaticCaps as JaxStaticCaps
from minsu3d_tpu.ops import ballquery as jbq
from minsu3d_tpu.ops import cluster as jcluster
from minsu3d_tpu_torch.config import StaticCaps
from minsu3d_tpu_torch.model import general_model as gm
from minsu3d_tpu_torch.ops import ballquery, cluster
from test_torch_data import port_build_in_tmp  # noqa: F401

CLUSTER_FIELDS = ("point_cluster", "sizes", "valid", "count", "edges_dropped",
                  "clusters_dropped")


def _blobs(seed: int, n: int = 3000, spread: float = 0.03):
    """Dense blobs in two scenes with four groups and an inactive tail."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.5, 0.5, (16, 3))
    which = rng.integers(0, len(centers), n)
    coords = (centers[which] + rng.normal(0, spread, (n, 3))).astype(np.float32)
    batch = (which % 2).astype(np.int32)
    group = (which // 4 % 4).astype(np.int32)
    group[rng.random(n) < 0.05] = 3
    active = np.ones(n, bool)
    active[-n // 10:] = False
    return coords, batch, active, group


def _jit(fn, *arrays, **static):
    """``fn`` jitted with its non-array arguments bound (one XLA compile
    instead of one per op), on numpy ``arrays``."""
    return jax.jit(functools.partial(fn, **static))(*_j(*arrays))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _eq(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=msg)


def _same_clusters(got, want):
    for f in CLUSTER_FIELDS:
        _eq(got._asdict()[f], getattr(want, f), f)


def _grid_units(seed: int, cell: float, u_cap: int = 4096):
    """Grid units of the blobs (JAX ``make_units_grid``) and their table
    (JAX ``_unit_table``): (u_coords, u_batch, u_active, u_group) as numpy."""
    coords, batch, active, group = _blobs(seed)
    table = _jit(lambda b, c, g, a: jcluster._unit_table(
        c, b, a, g, jgm.make_units_grid(b, c, g, a, u_cap, cell)[0], u_cap),
        batch, coords, group, active)
    return [np.array(a) for a in table[:4]]


@pytest.mark.parametrize("half_space", [True, False])
@pytest.mark.parametrize("window,k", [(8, 16), (4, 4)])
def test_fused_ball_query_matches_jax(half_space, window, k):
    """Fused schedule on points: (4, 4) saturates the K cap on most rows."""
    coords, batch, active, group = _blobs(1)
    want = _jit(jbq.ball_query, coords, batch, active, group=jnp.asarray(group),
                radius=0.03, k=k, window=window, half_space=half_space)
    got = ballquery.ball_query(*_t(coords, batch, active), 0.03, k, window,
                               half_space=half_space, group=torch.from_numpy(group))
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    full = got[1].all(1).float().mean()
    assert (full > 0.3) if k == 4 else got[1][:100].any(1).all()
    assert not got[1][torch.from_numpy(~active)].any()


def test_fused_ball_query_without_groups_equals_unbounded_edge_buffer():
    coords, batch, active, _ = _blobs(2, 2000)
    want = _jit(jbq.ball_query, coords, batch, active, radius=0.05, k=8, window=8,
                half_space=True)
    got = ballquery.ball_query(*_t(coords, batch, active), 0.05, 8, 8, half_space=True)
    _eq(got[0], want[0])
    edge = ballquery.ball_query_edge(*_t(coords, batch, active), 0.05, 8, 8,
                                     56 * len(coords), half_space=True)
    assert int(edge[2]) == 0 and torch.equal(edge[0], got[0])


@pytest.mark.parametrize("half_space", [True, False])
@pytest.mark.parametrize("radius,cell", [(0.03, 0.03), (0.03, 0.02), (0.04, 0.02)])
def test_grid_ball_query_matches_jax(radius, cell, half_space):
    """m = 1 (cell = radius) and m = 2 on grid-unit centroids; K 8 caps."""
    u_coords, u_batch, u_active, u_group = _grid_units(3, cell)
    want = _jit(jbq.ball_query_grid, u_coords, u_batch, u_active, group=jnp.asarray(u_group),
                radius=radius, k=8, cell_size=cell, half_space=half_space)
    got = ballquery.ball_query_grid(*_t(u_coords, u_batch, u_active), radius, 8, cell,
                                    half_space=half_space, group=torch.from_numpy(u_group))
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    assert got[1].sum() > 2 * u_active.sum()
    m = int(np.ceil(radius / cell - 1e-9))
    n_off = len(ballquery.grid_offsets(radius, cell, half_space))
    assert n_off == {(1, False): 27, (1, True): 14}.get((m, half_space), n_off)
    assert (m == 2) == (n_off > 27)


@pytest.mark.parametrize("second_far", [False, True])
def test_grid_ball_query_takes_the_last_unit_of_a_shared_cell(second_far):
    """Two units in one cell (same batch and group): the lookup takes the
    last row of the cell's sorted run, i.e. the later unit; a query one cell
    over finds it when it is near and nothing when only the earlier is."""
    near, far = [0.02, 0.01, 0.01], [0.001, 0.01, 0.01]
    first, second = (near, far) if second_far else (far, near)
    coords = np.array([first, second, [0.045, 0.01, 0.01], [0.3, 0.3, 0.3]], np.float32)
    batch = np.zeros(4, np.int32)
    group = np.array([1, 1, 1, 2], np.int32)
    active = np.ones(4, bool)
    want = _jit(jbq.ball_query_grid, coords, batch, active, group=jnp.asarray(group),
                radius=0.03, k=4, cell_size=0.03)
    got = ballquery.ball_query_grid(*_t(coords, batch, active), 0.03, 4, 0.03,
                                    group=torch.from_numpy(group))
    _eq(got[0], want[0])
    assert got[0][2].tolist() == ([2, 4, 4, 4] if second_far else [1, 2, 4, 4])


@pytest.mark.parametrize("u_cap", [4096, 300])
@pytest.mark.parametrize("cell", [0.03, 0.02])
def test_make_units_grid_matches_jax(cell, u_cap):
    coords, batch, active, group = _blobs(4)
    group[:50] = 300          # clipped to 255 in the key
    want = _jit(jgm.make_units_grid, batch, coords, group, active, u_cap=u_cap,
                cell_size=cell)
    got = gm.make_units_grid(*_t(batch, coords, group, active), u_cap, cell)
    _eq(got[0], want[0])
    assert int(got[1]) == int(want[1])
    assert (int(got[1]) > 0) == (u_cap == 300)


def _point_graph(seed: int):
    coords, batch, active, group = _blobs(seed, 2500, 0.05)

    def labels(c, b, a, g):
        nbr, ok, _ = jbq.ball_query_edge(c, b, a, 0.03, 8, 8, 56 * 2500, half_space=True,
                                         group=g)
        return jcluster.connected_components(nbr, ok, a, g, 64)

    return np.array(_jit(labels, coords, batch, active, group)), active


@pytest.mark.parametrize("c_cap,big_thre", [(4096, 1), (16, 1), (16, 20)])
def test_compact_labels_matches_jax(c_cap, big_thre):
    label, active = _point_graph(5)
    want = _jit(jcluster.compact_labels, label, active, c_cap=c_cap, big_thre=big_thre)
    got = cluster.compact_labels(*_t(label, active), c_cap, big_thre)
    for f in ("point_cluster", "sizes", "valid", "count", "clusters_dropped"):
        _eq(got._asdict()[f], getattr(want, f), f)
    assert (int(got.clusters_dropped) > 0) == (c_cap == 16)
    assert int(got.edges_dropped) == 0 and int(got.cc_unconverged) == 0


def test_compact_labels_refuses_non_root_labels():
    """Non-root labels, as a truncated CC loop leaves them, are no longer
    refused: points are grouped by label value, as JAX's argsort groups
    them, with no host sync."""
    cases = [([0, 0, 1, 3, 4], [True] * 5),        # point 2 points at 1, whose label is 0
             ([1, 1, 2], [True, False, True]),     # an active point on an inactive root
             ([0, 0, 2, 3, 3], [True] * 5)]
    for label, active in cases:
        label, active = np.array(label, np.int32), np.array(active)
        want = _jit(jcluster.compact_labels, label, active, c_cap=8)
        got = cluster.compact_labels(*_t(label, active), 8)
        for f in ("point_cluster", "sizes", "valid", "count", "clusters_dropped"):
            _eq(got._asdict()[f], getattr(want, f), f)
    ok = cluster.compact_labels(torch.tensor([0, 0, 2, 3, 3]), torch.ones(5, dtype=torch.bool), 8)
    assert ok.point_cluster.tolist() == [0, 0, 2, 1, 1] and ok.sizes[:3].tolist() == [2, 2, 1]


@pytest.mark.parametrize("edge_cap", [0, 56 * 2500, 2000])
def test_cluster_points_matches_jax(edge_cap):
    coords, batch, active, group = _blobs(6, 2500, 0.05)
    args = (coords, batch, active, group)
    kw = dict(half_space=True, edge_cap=edge_cap, big_thre=10)
    want = _jit(jcluster.cluster_points, *args, radius=0.03, k=16, window=16, c_cap=64,
                max_iters=32, **kw)
    got = cluster.cluster_points(*_t(*args), 0.03, 16, 16, 64, 32, **kw)
    _same_clusters(got, want)
    assert (int(got.edges_dropped) > 0) == (edge_cap == 2000)
    assert int(got.count) > 10 and int(got.cc_unconverged) == 0


@pytest.mark.parametrize("path", ["grid_m1", "grid_m2", "fused"])
def test_cluster_units_matches_jax(path):
    coords, batch, active, group = _blobs(7)
    cell = 0.03 if path == "grid_m1" else 0.02
    units = gm.make_units_grid(*_t(batch, coords, group, active), 4096, cell)[0]
    args = (coords, batch, active, group)
    grid_cell = 0.0 if path == "fused" else cell
    want = _jit(jcluster.cluster_units, *args, units.numpy(), u_cap=4096, radius=0.03, k=8,
                window=8, c_cap=256, max_iters=32, half_space=True, edge_cap=0,
                grid_cell=grid_cell)
    got = cluster.cluster_units(*_t(*args), units, 4096, 0.03, 8, 8, 256, 32, True, 0,
                                grid_cell=grid_cell)
    _same_clusters(got, want)
    assert int(got.count) > 10 and int(got.edges_dropped) == 0


def _caps(unit: bool, ef: int, max_m: int = 1):
    common = dict(clusters=256, proposals=64, neighbors=16, window=16, cc_iters=32,
                  cluster_units=4096, half_space=True, edge_factor=ef, edge_factor_xyz=0)
    jcaps = JaxStaticCaps(voxel_caps=(), instances=64, proposal_voxel_caps=(),
                          unit_clustering=unit, bq_grid_max_m=max_m, **common)
    tcaps = StaticCaps(voxel_caps=(), instances=64, unit_clustering=unit,
                       bq_grid_max_m=max_m, **common)
    return jcaps, tcaps


# branch -> (unit granularity, units: grid cell or "voxel", edge factor,
# bq_grid_max_m, the ball query the branch must take)
BRANCHES = {
    "grid_m1_exactly_one_cell": (True, 0.03, 28, 1, "grid"),
    "grid_m2_over_max_m_edge": (True, 0.02, 28, 1, "edge"),
    "grid_m2_within_max_m": (True, 0.02, 28, 2, "grid"),
    "grid_m2_fused": (True, 0.02, 0, 1, "fused"),
    "voxel_units_edge": (True, "voxel", 56, 1, "edge"),
    "voxel_units_fused": (True, "voxel", 0, 1, "fused"),
    "points_edge": (False, 0.02, 8, 1, "edge"),
    "points_fused": (False, 0.02, 0, 1, "fused"),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_cluster_step_matches_jax(branch, monkeypatch):
    unit, cell, ef, max_m, query = BRANCHES[branch]
    coords, batch, active, group = _blobs(8)
    if cell == "voxel":
        key = (np.floor(coords / 0.02).astype(np.int64) % 1024 * [1 << 20, 1 << 10, 1]).sum(1)
        units = gm.make_units(*_t(key.astype(np.int32), group, active), 4096)[0]
        grid_cell = 0.0
    else:
        units = gm.make_units_grid(*_t(batch, coords, group, active), 4096, cell)[0]
        grid_cell = cell
    jcaps, tcaps = _caps(unit, ef, max_m)
    args = (coords, batch, active, group)
    want = _jit(jgm.cluster_step, *args, radius=0.03, caps=jcaps,
                unit_id=jnp.asarray(units.numpy()), grid_cell=grid_cell, big_thre=5)
    taken = []
    for name in ("ball_query", "ball_query_edge", "ball_query_grid"):
        fn = getattr(cluster, name)
        monkeypatch.setattr(cluster, name, lambda *a, _f=fn, _n=name, **kw: (
            taken.append(_n), _f(*a, **kw))[1])
    got = gm.cluster_step(*_t(*args), 0.03, tcaps, units, grid_cell=grid_cell, big_thre=5)
    _same_clusters(got, want)
    assert taken == [{"grid": "ball_query_grid", "edge": "ball_query_edge",
                      "fused": "ball_query"}[query]]
    assert int(got.count) > 10 and int(got.cc_unconverged) == 0
