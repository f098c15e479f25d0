"""Unit clustering of the PyTorch port against minsu3d_tpu/ops/cluster.py:
connected-component labels, the unit table, the (voxel, class) units, the
size-ranked compaction and the whole cluster_units call, all bit for bit."""

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
