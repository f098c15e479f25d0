"""Connected components sweep for sweep, and the gather probe's kernels,
against the JAX package on the CPU, bit for bit.

* ``connected_components`` (K3's and K18's plain versions) against
  ``minsu3d_tpu/ops/cluster.py::connected_components`` at truncated
  budgets (``max_iters`` 1-4, where the labels are not yet the fixpoint and
  need not be roots) and at 32, without and with the root-graph coarsening
  (``coarsen`` 4, a list that overflows, and 4096; ``coarsen_sweeps`` 1 and
  2): on a 256-node random chain with 5 inactive nodes and on the unit graph
  of ``test_torch_cluster.py`` with its groups.
* ``connected_components`` on ``minsu3d_tpu_torch/tools/cc_graph.py``'s
  (256, 256, 1) lattice at K 8, whose two sweeps before the coarsening
  leave ~50k cross-root edge slots and 4534 distinct pairs: more than
  ``coarsen`` 4096, so the pair list overflows and the kernel's radix
  select (the branch that runs when the distinct pairs exceed ``coarsen``)
  picks the pairs that JAX's sort keeps; at budgets (32, 4096, 2), (1,
  4096, 2) and (2, 4, 2).
* ``connected_components``, ``cluster_points`` and ``cluster_units`` return
  ``unconverged`` / ``cc_unconverged`` as a 0-dim tensor on the input's
  device (the card's wrapper never reads it back).
* ``compact_labels`` (K9's plain version) on labels of a truncated budget,
  which hold non-roots, and ``cluster_units`` at truncated budgets on a
  long path of units.
* The probe's P1-P3 (``tools/probe_pallas.py``'s ``k_double``, ``k_gather``
  and ``k_onehot`` through ``pl.pallas_call(..., interpret=True)``) at V =
  256, C = 8, tile = 64 against ``minsu3d_tpu_torch/tools/probe_cuda.py``.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from minsu3d_tpu.ops import cluster as jcluster
from minsu3d_tpu_torch.ops import cluster
from minsu3d_tpu_torch.tools import cc_graph, probe_cuda
from test_torch_cluster import _graph, scene  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@functools.cache
def _jax_cc(max_iters: int, coarsen: int, coarsen_sweeps: int):
    return jax.jit(functools.partial(jcluster.connected_components, max_iters=max_iters,
                                     coarsen=coarsen, coarsen_sweeps=coarsen_sweeps))


def _chain(n: int = 256, inactive: int = 5, seed: int = 3):
    """A random chain through a permutation of the nodes (each link in a
    random one of 4 slots of its first node, a few links cut), 5 inactive
    nodes, two groups along the chain in runs."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    nbr = np.full((n, 4), n, np.int32)
    ok = np.zeros((n, 4), bool)
    for a, b in zip(perm[:-1], perm[1:]):
        if rng.random() < 0.02:
            continue
        j = rng.integers(0, 4)
        nbr[a, j], ok[a, j] = b, True
    active = np.ones(n, bool)
    active[rng.choice(n, inactive, replace=False)] = False
    group = (np.arange(n)[np.argsort(perm)] // 64 % 2).astype(np.int32)
    return nbr, ok, active, group


def _both(graph, max_iters: int, coarsen: int, coarsen_sweeps: int):
    nbr, ok, active, group = graph
    want = np.asarray(_jax_cc(max_iters, coarsen, coarsen_sweeps)(
        jnp.asarray(nbr), jnp.asarray(ok), jnp.asarray(active), jnp.asarray(group)))
    got, unconverged = cluster.connected_components(
        *[torch.from_numpy(np.array(a)) for a in graph], max_iters=max_iters,
        coarsen=coarsen, coarsen_sweeps=coarsen_sweeps)
    return got.numpy(), want, unconverged


def _non_roots(label, active) -> int:
    n = label.shape[0]
    lab = np.where(active, label, n)
    ext = np.append(lab, n)
    return int((active & (ext[lab] != lab)).sum())


CHAIN_BUDGETS = [(1, 0, 2), (2, 0, 2), (3, 0, 2), (4, 0, 2), (32, 0, 2), (1, 4096, 2),
                 (1, 4096, 1), (2, 4, 2), (3, 4, 1), (32, 4, 2), (32, 4096, 2)]


@pytest.mark.parametrize("max_iters,coarsen,coarsen_sweeps", CHAIN_BUDGETS)
def test_chain_labels_match_jax(max_iters, coarsen, coarsen_sweeps):
    graph = _chain()
    got, want, unconverged = _both(graph, max_iters, coarsen, coarsen_sweeps)
    np.testing.assert_array_equal(got, want)
    fixpoint, _, _ = _both(graph, 32, 0, 2)
    if max_iters == 32:
        assert not unconverged
    if (max_iters, coarsen) == (1, 0):   # truncated: not the fixpoint yet
        assert unconverged and (got != fixpoint).any() and _non_roots(got, graph[2]) > 0


@pytest.mark.parametrize("max_iters,coarsen,coarsen_sweeps",
                         [(1, 0, 2), (2, 4096, 2), (1, 4, 1), (32, 4096, 2)])
def test_unit_graph_labels_match_jax(scene, max_iters, coarsen, coarsen_sweeps):
    nbr, ok, u = _graph(scene)
    graph = (np.asarray(nbr), np.asarray(ok), np.asarray(u[2]), np.asarray(u[3]))
    got, want, unconverged = _both(graph, max_iters, coarsen, coarsen_sweeps)
    np.testing.assert_array_equal(got, want)
    if (max_iters, coarsen) in ((1, 0), (32, 4096)):
        assert unconverged == (max_iters == 1)


@pytest.mark.parametrize("max_iters,coarsen,coarsen_sweeps",
                         [(32, 4096, 2), (1, 4096, 2), (2, 4, 2)])
def test_overflowing_pair_list_matches_jax(max_iters, coarsen, coarsen_sweeps):
    graph = cc_graph.lattice((256, 256, 1), 8, 7)
    got, want, unconverged = _both(graph, max_iters, coarsen, coarsen_sweeps)
    np.testing.assert_array_equal(got, want)
    res = cluster.connected_components_plain(*map(torch.from_numpy, graph), max_iters,
                                             coarsen, coarsen_sweeps)
    assert int(res.pairs) > coarsen            # the list overflows
    assert int(unconverged) == (max_iters != 32)


@pytest.mark.parametrize("fn", ["connected_components", "cluster_points", "cluster_units"])
def test_unconverged_is_a_tensor_on_the_input_device(fn):
    if fn == "connected_components":
        graph = [torch.from_numpy(a) for a in _chain()]
        dev = graph[0].device
        flag = cluster.connected_components(*graph, max_iters=1)[1]
    else:
        coords, batch, active, group, unit_id = map(torch.from_numpy, _path_units())
        dev = coords.device
        kw = dict(radius=0.03, k=8, window=8, c_cap=64, max_iters=1, half_space=True,
                  edge_cap=56 * 1024, coarsen=4096)
        flag = (cluster.cluster_points(coords, batch, active, group, **kw)
                if fn == "cluster_points" else
                cluster.cluster_units(coords, batch, active, group, unit_id, 1024,
                                      **kw)).cc_unconverged
    assert isinstance(flag, torch.Tensor) and flag.dim() == 0 and flag.device == dev
    assert flag.dtype == torch.int64 and int(flag) == 1


def test_compact_labels_on_truncated_labels_match_jax():
    nbr, ok, active, group = _chain()
    label = np.asarray(_jax_cc(1, 0, 2)(*map(jnp.asarray, (nbr, ok, active, group))))
    assert _non_roots(label, active) > 0
    for c_cap, big_thre in ((64, 1), (8, 3)):
        want = jcluster.compact_labels(jnp.asarray(label), jnp.asarray(active), c_cap,
                                       big_thre)
        got = cluster.compact_labels(torch.from_numpy(label), torch.from_numpy(active), c_cap,
                                     big_thre)
        for f in ("point_cluster", "sizes", "valid", "count", "clusters_dropped"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                          f)


def _path_units(n: int = 600, u_cap: int = 1024, seed: int = 4):
    """Points along a smooth random walk, 2 cm apart (a 3 cm ball query
    joins neighbours only), one unit each with scrambled unit ids: a long
    path graph, so short CC budgets stop before the fixpoint."""
    rng = np.random.default_rng(seed)
    step = rng.normal(0, 1, (n, 3))
    d = np.cumsum(step / np.linalg.norm(step, axis=1, keepdims=True) * 0.3, 0)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    coords = np.cumsum(d * 0.02, 0).astype(np.float32)
    active = np.ones(n, bool)
    active[rng.choice(n, 5, replace=False)] = False
    unit_id = rng.permutation(u_cap)[:n].astype(np.int32)
    return coords, np.zeros(n, np.int32), active, np.zeros(n, np.int32), unit_id


@pytest.mark.parametrize("max_iters,coarsen", [(1, 0), (0, 4), (0, 4096)])
def test_cluster_units_at_a_truncated_budget_matches_jax(max_iters, coarsen):
    args = _path_units()
    kw = dict(radius=0.03, k=8, window=8, c_cap=64, half_space=True, edge_cap=56 * 1024,
              big_thre=1, coarsen=coarsen)
    want = jax.jit(functools.partial(jcluster.cluster_units, u_cap=1024, max_iters=max_iters,
                                     **kw))(*map(jnp.asarray, args))
    got = cluster.cluster_units(*[torch.from_numpy(a) for a in args], 1024,
                                max_iters=max_iters, **kw)
    for f in ("point_cluster", "sizes", "valid", "count", "edges_dropped", "clusters_dropped"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    fixpoint = cluster.cluster_units(*[torch.from_numpy(a) for a in args], 1024, max_iters=32,
                                     **kw)
    assert int(got.cc_unconverged) == 1 and int(fixpoint.cc_unconverged) == 0
    assert int(got.count) > int(fixpoint.count)   # components not yet merged


@pytest.fixture(scope="module")
def probe_pallas():
    """tools/probe_pallas.py, imported once (it times its own kernels on
    import, at its full size)."""
    spec = importlib.util.spec_from_file_location("probe_pallas",
                                                  ROOT / "tools" / "probe_pallas.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pallas(probe, kernel: str, x, idx, tile: int):
    v, c = x.shape
    if kernel == "double":
        return pl.pallas_call(probe.k_double, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
                              interpret=True)(x)
    body = probe.k_gather if kernel == "window_gather" else probe.k_onehot
    return pl.pallas_call(
        body, grid=(v // tile,),
        in_specs=[pl.BlockSpec((tile,), lambda i: (i,)),
                  pl.BlockSpec((tile, c), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((tile, c), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((v, c), jnp.float32), interpret=True)(idx, x)


@pytest.mark.parametrize("kernel", ["double", "window_gather", "onehot_gather"])
def test_probe_kernels_match_pallas(probe_pallas, monkeypatch, kernel):
    v, c, tile = 256, 8, 64
    monkeypatch.setattr(probe_pallas, "TILE", tile)   # k_onehot's iota reads it
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (v, c)).astype(np.float32)
    idx = rng.integers(0, tile, (v,)).astype(np.int32)
    want = np.asarray(_pallas(probe_pallas, kernel, jnp.asarray(x), jnp.asarray(idx), tile))
    xt, it = torch.from_numpy(x), torch.from_numpy(idx)
    got = (probe_cuda.double(xt) if kernel == "double"
           else getattr(probe_cuda, kernel)(xt, it, tile)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if kernel != "double":
        with pytest.raises(ValueError, match="multiple"):
            getattr(probe_cuda, kernel)(xt[:200], it[:200], tile)
