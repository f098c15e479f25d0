"""Edge-buffer ball query of the PyTorch port against
minsu3d_tpu/ops/ballquery.py::ball_query_edge: neighbour tables, validity and
edges_dropped must be identical, bit for bit, including inputs whose edge
buffer overflows; the fused ``ball_query`` against the JAX fused schedule;
and K2's plain version (``edge_scan_plain``, the signature the kernel
takes) against the chain it replaced (``runs`` with K16's bounds, then
``scan_plain``), bit for bit, at the recipe's cap, an overflowing one and
no cap, with and without groups, at half_space true and false."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minsu3d_tpu.ops.ballquery import ball_query as jax_fused
from minsu3d_tpu.ops.ballquery import ball_query_edge as jax_bq
from minsu3d_tpu_torch.ops import ballquery


def _points(seed: int, n: int = 3000):
    """Dense blobs (many points per 3 cm cell), two scenes, four groups and a
    tail of inactive rows: window clipping, the K cap and the group/batch
    keys all matter."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.5, 0.5, (12, 3))
    which = rng.integers(0, len(centers), n)
    coords = (centers[which] + rng.normal(0, 0.03, (n, 3))).astype(np.float32)
    batch = (which % 2).astype(np.int32)
    group = rng.integers(0, 4, n).astype(np.int32)
    valid = np.ones(n, bool)
    valid[-n // 10:] = False
    return coords, batch, valid, group


def _compare(coords, batch, valid, group, radius, k, window, edge_cap, half_space):
    want = jax_bq(jnp.asarray(coords), jnp.asarray(batch), jnp.asarray(valid), radius, k,
                  window, edge_cap, half_space=half_space,
                  group=None if group is None else jnp.asarray(group))
    got = ballquery.ball_query_edge(
        torch.from_numpy(coords), torch.from_numpy(batch), torch.from_numpy(valid), radius,
        k, window, edge_cap, half_space=half_space,
        group=None if group is None else torch.from_numpy(group))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2])
    return got


@pytest.mark.parametrize("half_space", [True, False])
@pytest.mark.parametrize("window,k", [(8, 16), (2, 4)])
def test_matches_jax(half_space, window, k):
    coords, batch, valid, group = _points(1)
    nbr, ok, dropped = _compare(coords, batch, valid, group, 0.03, k, window,
                                56 * len(coords), half_space)
    assert int(dropped) == 0 and ok.any(1)[:100].all()
    assert (~ok[~torch.from_numpy(valid)]).all()


def _overflow(frac, half_space, groups):
    coords, batch, valid, group = _points(2)
    group = group if groups else None
    total = int(ballquery.runs(torch.from_numpy(coords), torch.from_numpy(batch),
                               torch.from_numpy(valid), 0.03, 8, half_space,
                               None if group is None else torch.from_numpy(group))[4])
    edge_cap = int(total * frac)
    _, ok, dropped = _compare(coords, batch, valid, group, 0.03, 16, 8, edge_cap, half_space)
    assert int(dropped) == total - edge_cap > 0
    # points whose candidates lie past the buffer end find no neighbour at all
    assert not ok[valid.nonzero()[0][-1]].any()


@pytest.mark.parametrize("frac", [0.5, 0.05])
def test_matches_jax_when_edge_buffer_overflows(frac):
    _overflow(frac, True, True)


@pytest.mark.parametrize("half_space,groups", [(False, True), (True, False)])
def test_matches_jax_when_edge_buffer_overflows_with_27_offsets_or_no_groups(half_space,
                                                                             groups):
    _overflow(0.3, half_space, groups)


def test_matches_jax_without_groups():
    coords, batch, valid, _ = _points(3, 2000)
    _compare(coords, batch, valid, None, 0.05, 8, 8, 56 * len(coords), True)


@pytest.mark.parametrize("half_space,groups", [(True, True), (False, True), (True, False),
                                               (False, False)])
def test_fused_ball_query_matches_jax(half_space, groups):
    """The fused query (K2 with ``NO_EDGE_CAP``) against the JAX fused
    schedule."""
    coords, batch, valid, group = _points(5, 2000)
    group = group if groups else None
    want = jax_fused(jnp.asarray(coords), jnp.asarray(batch), jnp.asarray(valid), 0.03, 8, 4,
                     half_space=half_space, group=None if group is None else jnp.asarray(group))
    got = ballquery.ball_query(torch.from_numpy(coords), torch.from_numpy(batch),
                               torch.from_numpy(valid), 0.03, 8, 4, half_space=half_space,
                               group=None if group is None else torch.from_numpy(group))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert bool(got[1].any())


@pytest.mark.parametrize("cap,half_space,groups", [
    ("recipe", True, True), ("recipe", False, True), ("recipe", True, False),
    ("half the candidates", True, True), ("half the candidates", False, False),
    ("none", True, True), ("none", False, True)])
def test_edge_scan_plain_equals_the_chain_it_replaced(cap, half_space, groups):
    """K2's plain version, on the table the kernel takes, against ``runs``
    (cell keys, K16's bounds, the run lengths and their scan) and
    ``scan_plain``: the neighbour table, its validity, the candidate total
    and edges_dropped, bit for bit."""
    coords, batch, valid, group = map(torch.from_numpy, _points(6, 2500))
    group = group if groups else None
    radius, k, window = 0.03, 16, 8
    perm, starts, run_len, point_base, total = ballquery.runs(coords, batch, valid, radius,
                                                              window, half_space, group)
    edge_cap = {"recipe": 56 * coords.shape[0], "half the candidates": int(total) // 2,
                "none": ballquery.NO_EDGE_CAP}[cap]
    r2 = float(torch.tensor(radius * radius, dtype=torch.float32))
    want = ballquery.scan_plain(coords, perm, starts, run_len, point_base, k, window,
                                edge_cap, torch.tensor(r2, dtype=torch.float32))
    table = ballquery.edge_table(coords, batch, valid, radius, group)
    assert table[0].dtype == torch.int32 and torch.equal(table[3], perm)
    nbr, nbr_valid, result = ballquery.edge_scan_plain(coords, valid, *table, k, window,
                                                       edge_cap, half_space, r2)
    assert torch.equal(nbr, want) and torch.equal(nbr_valid, want < coords.shape[0])
    assert result.tolist() == [int(total), max(int(total) - edge_cap, 0)]
    assert (int(result[1]) > 0) == (cap == "half the candidates")


def test_neighbours_are_within_radius_and_share_keys():
    coords, batch, valid, group = _points(4, 1500)
    nbr, ok, _ = ballquery.ball_query_edge(
        torch.from_numpy(coords), torch.from_numpy(batch), torch.from_numpy(valid), 0.03,
        16, 8, 56 * len(coords), half_space=True, group=torch.from_numpy(group))
    p, j = ok.nonzero(as_tuple=True)
    q = nbr[p, j].long()
    d2 = ((torch.from_numpy(coords)[q] - torch.from_numpy(coords)[p]) ** 2).sum(1)
    assert (d2 <= 0.03 ** 2 * (1 + 1e-5)).all()
    assert torch.equal(torch.from_numpy(batch)[q], torch.from_numpy(batch)[p])
    assert torch.equal(torch.from_numpy(group)[q], torch.from_numpy(group)[p])
