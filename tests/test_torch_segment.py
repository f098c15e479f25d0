"""Ordered segment reductions (K6's plain version), ``gather_rows`` and the
size-ranked unit compaction (K9's plain version) against the JAX package on
the CPU, all bit for bit:

* ``segment_reduce`` sum/max/min against ``.at[seg].add/max/min`` into a
  buffer with a padding row, f32 and int32, with empty segments, a padding
  segment and segments of one to many rows;
* ``gather_rows`` forward and backward against ``x[idx]`` and ``jax.grad``
  of it, with repeated indices and the zero row;
* ``unit_points_compact`` against ``_unit_points_compact`` on random
  min-index labels with many equal component sizes, with and without
  overflow of the cluster capacity;
* ``unit_table`` against ``_unit_table`` on random points;
* ``global_avg_pool`` forward and gradient against the JAX function and
  ``jax.grad`` of it (the mean of an ordered sum: bit for bit forward, the
  gradient within 1 ulp of f32);
* a torch model of K6's order-free path (32-row chunks, row blocks,
  shuffle trees, pieces folded in chunk order) against the plain fold, bit
  for bit, on the card test's adversarial cases;
* the heads' shared proposal CSR against the ones each reduction builds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minsu3d_tpu.ops import cluster as jcluster
from minsu3d_tpu.ops import segment as jsegment
from minsu3d_tpu_torch.ops import cluster, segment
from test_torch_kernels_cuda import K6_ADVERSARIAL, _k6_adversarial


def _segments(rng, rows, n_seg):
    """Segment ids with two empty segments and about 10% padding rows."""
    seg = rng.integers(0, n_seg, rows)
    seg[np.isin(seg, [1, n_seg - 2])] = n_seg
    seg[rng.random(rows) < 0.1] = n_seg
    return seg


@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_segment_reduce_plain_matches_jax_scatter(op, dtype):
    rng = np.random.default_rng(0)
    rows, n_seg, c = 3000, 40, 5
    seg = _segments(rng, rows, n_seg)
    seg[:400] = 3                                        # one long segment
    if dtype == "float32":
        x = (rng.normal(size=(rows, c)) * 10 ** rng.uniform(-3, 3, (rows, 1))).astype(np.float32)
        x[::7] = -0.0
    else:
        x = rng.integers(-1000, 1000, (rows, c)).astype(np.int32)
    fill = {"sum": 0, "max": -7, "min": 9}[op]
    jseg, jx = jnp.asarray(seg), jnp.asarray(x)
    if op == "sum":
        want = np.asarray(jnp.zeros((n_seg + 1, c), x.dtype).at[jseg].add(jx))[:n_seg]
    else:
        info = np.finfo if dtype == "float32" else np.iinfo
        seed = info(x.dtype).min if op == "max" else info(x.dtype).max
        buf = jnp.full((n_seg + 1, c), seed, x.dtype)
        want = np.asarray(getattr(buf.at[jseg], op)(jx))[:n_seg]
        empty = np.bincount(seg, minlength=n_seg + 1)[:n_seg] == 0
        want = np.where(empty[:, None], np.array(fill, x.dtype), want)
    csr = segment.segment_csr(torch.from_numpy(seg), n_seg)
    got = segment.segment_reduce(torch.from_numpy(x), csr, op, fill).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_segment_csr_orders_rows_and_leaves_padding_out():
    seg = torch.tensor([2, 0, 5, 2, 9, 0, 2, -1])
    csr = segment.segment_csr(seg, 5)
    assert csr.offsets.tolist() == [0, 2, 2, 5, 5, 5]
    assert csr.perm[:5].tolist() == [1, 5, 0, 3, 6]
    assert csr.seg.tolist() == [2, 0, 5, 2, 5, 0, 2, 5]


def test_segment_sum_is_sequential_in_row_order():
    """1 + 2^-24 + 2^-24 ... in row order stays 1; a pairwise tree would not."""
    x = torch.full((33, 1), 2.0 ** -24)
    x[0] = 1.0
    csr = segment.segment_csr(torch.zeros(33, dtype=torch.int64), 1)
    assert float(segment.segment_reduce(x, csr, "sum")[0, 0]) == 1.0
    x = x.flip(0)
    assert float(segment.segment_reduce(x, csr, "sum")[0, 0]) == 1.0 + 32 * 2.0 ** -24


def test_gather_rows_matches_jax_forward_and_grad():
    rng = np.random.default_rng(1)
    n, rows, c = 50, 400, 6
    x = rng.normal(size=(n, c)).astype(np.float32)
    idx = rng.integers(0, n + 1, rows)                   # n reads the zero row
    idx[:60] = 7                                         # a row gathered 60+ times
    cot = (rng.normal(size=(rows, c)) * 10 ** rng.uniform(-4, 4, (rows, 1))).astype(np.float32)

    def f(xx):
        return jnp.concatenate([xx, jnp.zeros((1, c), xx.dtype)])[jnp.asarray(idx)]

    want = np.asarray(f(jnp.asarray(x)))
    want_grad = np.asarray(jax.grad(lambda xx: jnp.sum(f(xx) * jnp.asarray(cot)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    got = segment.gather_rows(xt, torch.from_numpy(idx))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(xt.grad.numpy(), want_grad)
    # the vjp alone, against jax.vjp's cotangent-in, gradient-out map
    _, vjp = jax.vjp(f, jnp.asarray(x))
    xt.grad = None
    segment.gather_rows(xt, torch.from_numpy(idx)).backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]))


def test_gather_rows_builds_no_csr_without_a_gradient():
    x = torch.ones(4, 2)
    with torch.no_grad():
        out = segment.gather_rows(x, torch.tensor([0, 4, 3]))
    assert out.tolist() == [[1.0, 1.0], [0.0, 0.0], [1.0, 1.0]]


def _min_index_labels(rng, u, n_comp, active_frac):
    """Random components as K3 labels them: every active unit carries the
    smallest unit id of its component, inactive units carry u."""
    comp = rng.integers(0, n_comp, u)
    active = rng.random(u) < active_frac
    label = np.full(u, u, np.int64)
    first = {}
    for i in range(u):
        if active[i]:
            label[i] = first.setdefault(comp[i], i)
    return label


@pytest.mark.parametrize("c_cap,big_thre", [(4096, 1), (40, 1), (40, 6), (5, 3)])
def test_unit_compaction_plain_matches_jax(c_cap, big_thre):
    """Many components of equal size (counts 1-3), so the stable tie order
    decides most ranks; c_cap 40 and 5 overflow."""
    rng = np.random.default_rng(c_cap + big_thre)
    u, n_points = 2048, 5000
    label = _min_index_labels(rng, u, 300, 0.7)
    counts = np.where(label < u, rng.integers(1, 4, u), 0)
    uid = rng.integers(0, u + 1, n_points)
    want = jcluster._unit_points_compact(jnp.asarray(label, jnp.int32), jnp.asarray(uid, jnp.int32),
                                         u, n_points, c_cap,
                                         u_counts=jnp.asarray(counts, jnp.int32),
                                         big_thre=big_thre)
    got = cluster.unit_points_compact(torch.from_numpy(label), torch.from_numpy(uid), u, c_cap,
                                      torch.from_numpy(counts), big_thre)
    for name, g, w in zip(("point_cluster", "sizes", "valid", "count", "clusters_dropped"), got,
                          (want.point_cluster, want.sizes, want.valid, want.count,
                           want.clusters_dropped)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if c_cap < 100:
        assert int(got[4]) > 0


def test_unit_table_matches_jax_on_random_points():
    rng = np.random.default_rng(4)
    n, u_cap = 6000, 1500
    coords = rng.normal(size=(n, 3)).astype(np.float32) * 3
    coords[::5] = -0.0
    batch = rng.integers(0, 2, n).astype(np.int32)
    group = rng.integers(0, 20, n).astype(np.int32)
    active = rng.random(n) < 0.8
    unit_id = rng.integers(0, u_cap + 200, n)               # some ids beyond the cap
    want = jcluster._unit_table(jnp.asarray(coords), jnp.asarray(batch), jnp.asarray(active),
                                jnp.asarray(group), jnp.asarray(unit_id, jnp.int32), u_cap)
    got = cluster.unit_table(torch.from_numpy(coords), torch.from_numpy(batch),
                             torch.from_numpy(active), torch.from_numpy(group),
                             torch.from_numpy(unit_id), u_cap)
    for name, g, w in zip(("coords", "batch", "active", "group", "uid", "counts"), got, want):
        g = g.numpy()
        w = np.asarray(w)
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_global_avg_pool_matches_jax_forward_and_grad():
    rng = np.random.default_rng(4)
    rows, n_seg, c = 2000, 30, 6
    seg = _segments(rng, rows, n_seg).astype(np.int32)
    valid = seg < n_seg
    seg = np.where(rng.random(rows) < 0.05, 0, seg).astype(np.int32)   # invalid rows in 0
    valid &= seg != 0
    x = rng.normal(size=(rows, c)).astype(np.float32)
    cot = rng.normal(size=(n_seg, c)).astype(np.float32)
    args = (jnp.asarray(seg), jnp.asarray(valid), n_seg)
    want = np.asarray(jsegment.global_avg_pool(jnp.asarray(x), *args))
    want_g = np.asarray(jax.grad(
        lambda v: jnp.sum(jsegment.global_avg_pool(v, *args) * cot))(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = segment.global_avg_pool(tx, torch.from_numpy(seg), torch.from_numpy(valid), n_seg)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_allclose(tx.grad.numpy(), want_g, rtol=2 ** -23, atol=0)
    assert (tx.grad.numpy()[~valid] == 0).all()
    assert (got.detach().numpy()[[1, n_seg - 2]] == 0).all()      # empty segments


# K6's order-free path (csrc/segment_reduce.cu), modelled piece by piece
K6_SHORT, K6_CHUNK = 32, 32


def _k6_combine(a, b, op):
    return a + b if op == "sum" else segment.extreme_step(a, b, op)


def _k6_tree(vals, op):
    """The warp's shuffle tree over row blocks or pieces in order (None for
    an empty one): at step d, index i (a multiple of 2d) takes i + d's
    value on its right."""
    vals = list(vals)
    d = 1
    while d < len(vals):
        for i in range(0, len(vals) - d, 2 * d):
            a, b = vals[i], vals[i + d]
            if b is not None:
                vals[i] = b if a is None else _k6_combine(a, b, op)
        d *= 2
    return vals[0]


def k6_chunk_model(x, csr, op, fill):
    """K6 on max, min and int32 sums: segments of at most K6_SHORT rows
    folded whole; longer ones cut at every K6_CHUNK-th sorted position,
    each piece cut into 32 // cw row blocks a group of cw <= 32 channels,
    the blocks folded in row order (the plain fold of each block) and then
    by the tree, a segment inside one chunk written out, else its pieces
    folded by groups of 32 pieces and the tree, in chunk order, after its
    first chunk's piece."""
    offsets = csr.offsets.tolist()
    xs = x[csr.perm[:offsets[-1]].long()]          # rows in sorted position order
    lens = [e - b for b, e in zip(offsets[:-1], offsets[1:])]
    long_seg = torch.tensor(lens + [0]) > K6_SHORT
    short = segment.segment_csr(torch.where(long_seg[csr.seg], csr.num_segments, csr.seg),
                                csr.num_segments)
    out = segment.segment_reduce_plain(x, short, op, fill)
    for c0 in range(0, x.shape[1], 32):
        cw = min(32, x.shape[1] - c0)
        nb = 32 // cw
        block = torch.full((xs.shape[0],), -1, dtype=torch.int64)
        plan, n_blocks = [], 0                      # (segment, [[block ids] a piece])
        for s, n in enumerate(lens):
            if n <= K6_SHORT:
                continue
            b, e = offsets[s], offsets[s + 1]
            pieces = []
            for k in range(b // K6_CHUNK, (e - 1) // K6_CHUNK + 1):
                a0, a1 = max(b, k * K6_CHUNK), min(e, (k + 1) * K6_CHUNK)
                ids = []
                for i in range(nb):
                    r0, r1 = a0 + (a1 - a0) * i // nb, a0 + (a1 - a0) * (i + 1) // nb
                    ids.append(n_blocks if r1 > r0 else None)
                    if r1 > r0:
                        block[r0:r1] = n_blocks
                        n_blocks += 1
                pieces.append(ids)
            plan.append((s, pieces))
        bcsr = segment.segment_csr(torch.where(block >= 0, block, n_blocks), n_blocks)
        folds = segment.segment_reduce_plain(xs[:, c0:c0 + cw].contiguous(), bcsr, op, fill)
        for s, pieces in plan:
            vals = [_k6_tree([None if i is None else folds[i] for i in ids], op)
                    for ids in pieces]
            acc = vals[0]
            for j in range(1, len(vals), 32):
                acc = _k6_combine(acc, _k6_tree(vals[j:j + 32], op), op)
            out[s, c0:c0 + cw] = acc
    return out


# the four cases of the card test's adversarial set that the model covers
K6_CASES = K6_ADVERSARIAL[:4]


@pytest.mark.parametrize("op", ["max", "min", "sum"])
@pytest.mark.parametrize("case", K6_CASES)
def test_k6_chunked_order_free_path_matches_the_plain_fold(case, op):
    """K6's pieces, trees and chunk-order combine equal the plain version's
    row-order fold bit for bit (the operators are associative); an int32
    sum takes the same path."""
    x, seg, n_seg, fill = _k6_adversarial(case)
    if op == "sum" or "int32" in case:
        x, fill = (x.nan_to_num(0.0) * 100).to(torch.int32), int(fill)
    csr = segment.segment_csr(seg, n_seg)
    lens = (csr.offsets[1:] - csr.offsets[:-1])
    assert int(lens.max()) > K6_SHORT               # a segment takes the chunked path
    want = segment.segment_reduce_plain(x, csr, op, fill)
    got = k6_chunk_model(x, csr, op, fill)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if case == "NaN in a middle chunk" and op != "sum":
        assert int(want[0, 1].view(torch.int32)) == 0x7FC00002


def test_heads_proposal_csr_is_the_one_each_reduction_builds():
    """The heads build the proposal rows' CSR once a forward
    (``general_model.proposal_csr``); it equals the CSR that sec_mean,
    sec_min and sec_max build from the voxelization's (pid, valid) and that
    roipool builds from (prop_id, valid), and the placement over it equals
    the placement that builds its own."""
    from minsu3d_tpu_torch.model import general_model as gm

    rng = np.random.default_rng(14)
    n, p_cap = 3000, 24
    rows = {"point_idx": torch.from_numpy(rng.integers(0, 1500, 2 * n)),
            "prop_id": torch.from_numpy(rng.integers(0, p_cap + 1, 2 * n)),
            "valid": torch.from_numpy(rng.random(2 * n) < 0.6)}
    rows["prop_id"][rows["prop_id"] == 5] = 7                    # an empty proposal
    shared = gm.proposal_csr(rows, p_cap)
    pid = torch.where(rows["valid"], rows["prop_id"], torch.full_like(rows["prop_id"], p_cap))
    for own in (segment.valid_csr(pid, rows["valid"], p_cap),
                segment.valid_csr(rows["prop_id"], rows["valid"], p_cap)):
        for a, b in zip(shared, own):
            assert a == b if isinstance(a, int) else torch.equal(a, b)
    coords = torch.from_numpy(rng.normal(size=(1500, 3)).astype(np.float32))
    got = gm.voxelization_placement(rows, p_cap, coords, 50.0, 14, csr=shared)
    want = gm.voxelization_placement(rows, p_cap, coords, 50.0, 14)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
