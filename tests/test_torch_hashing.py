"""The port's coordinate hashing (minsu3d_tpu_torch/ops/hashing.py: K15's,
K16's and K17's plain versions on the CPU) against the JAX package's
minsu3d_tpu/ops/hashing.py, bit for bit, on seeded numpy keys: a few
thousand (batch, xyz) pairs over several batch ids with runs of
duplicates and rows masked to the sentinel.

* ``lexsort_pairs``: the stable permutation;
* ``lookup``: idx, found and upper bound equal ``lookup_sorted_union``'s
  (idx the last equal row) on a table with duplicates, present, absent and
  sentinel queries; the lower bound equals ``lower_bound``; on a unique
  table idx equals ``lookup``'s; ``lower_bound`` (the lower bound alone);
* ``neighbor_map_plain``: a brute-force kernel map, through
  ``torch.searchsorted`` and never through a dispatching wrapper;
* ``neighbor_maps`` (K16's neighbour mode over every level of a plan) on
  CPU tensors, its plain version: JAX's ``add_neighbors`` on every level of
  a JAX ``build_plan`` of two batches whose keys wrap (rows at z = 1023
  next to (y + 1, z = 0), at y = 1023 next to (x + 1, y = 0)), on a level
  with no valid row and on a full level; and a numpy model of the kernel's search (one lower bound a
  (dx, dy) column, a three-row walk, the centre column by adjacency, the
  range checks) against the plain maps;
* ``unique_sorted``: first flags, segment ids and n_unique;
* ``unique_compact`` reading the valid flags through the sort's
  permutation (K17's interface): the table, row2voxel and representative
  rows against ``build_base``, with and without a table, into a cap that
  overflows, with every row invalid and at n = 0 and 1; its first flags,
  segment ids and n_unique against the sorted-flag route (the flags
  gathered by ``valid[perm]`` first, as ``build_base`` did before);
* ``key_sort(bits=...)`` on CPU tensors (its plain version, which ignores
  ``bits``) against ``lexsort_pairs`` of the keys' halves;
* ``run_offsets`` (the lower bound of every id 0..S) and ``segment_csr``,
  which builds its offsets with it, against ``lower_bound`` of the ids,
  ``torch.searchsorted`` of ``arange(S+1)`` and ``segment_count``: random
  ids with empty segments and padding, ids that are all padding, one
  segment.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minsu3d_tpu.ops import hashing as jhs
from minsu3d_tpu.ops import segment as jsegment
from minsu3d_tpu.ops import sparse as jsparse
from minsu3d_tpu_torch.ops import hashing as hs
from minsu3d_tpu_torch.ops import segment

N = 3000


def _pairs(seed: int, n: int = N):
    """(khi, klo, valid) int32 / bool: batch ids 0-3, coords drawn from a
    small cube so that many rows repeat, 10% of the rows invalid."""
    rng = np.random.default_rng(seed)
    batch = rng.integers(0, 4, n).astype(np.int32)
    coords = rng.integers(0, 12, (n, 3)).astype(np.int32)
    coords[: n // 10] = coords[n // 10: n // 5]          # guaranteed duplicate runs
    batch[: n // 10] = batch[n // 10: n // 5]
    valid = rng.random(n) >= 0.1
    return batch, coords, valid


def _masked(seed: int, n: int = N):
    batch, coords, valid = _pairs(seed, n)
    khi, klo = jhs.mask_invalid(*jhs.pack(jnp.asarray(batch), jnp.asarray(coords)),
                                jnp.asarray(valid))
    return np.array(khi), np.array(klo), valid


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_unpack_mask_match_jax(seed):
    batch, coords, valid = _pairs(seed)
    want = jhs.mask_invalid(*jhs.pack(jnp.asarray(batch), jnp.asarray(coords)),
                            jnp.asarray(valid))
    got = hs.mask_invalid(*hs.pack(torch.from_numpy(batch), torch.from_numpy(coords)),
                          torch.from_numpy(valid))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    jb, jc = jhs.unpack(*want)
    tb, tc = hs.unpack(*got)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lexsort_pairs_matches_jax(seed):
    khi, klo, _ = _masked(seed)
    want = np.asarray(jhs.lexsort_pairs(jnp.asarray(khi), jnp.asarray(klo)))
    got = hs.lexsort_pairs(torch.from_numpy(khi), torch.from_numpy(klo))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    s_key, perm = hs.key_sort(hs.pack_key(torch.from_numpy(khi), torch.from_numpy(klo)))
    np.testing.assert_array_equal(perm.numpy(), want)
    assert bool((s_key[1:] >= s_key[:-1]).all())


def _table_and_queries(seed: int):
    """A sorted table with duplicate runs and sentinel padding, and queries:
    every table key, absent keys, and sentinel queries."""
    khi, klo, _ = _masked(seed)
    perm = np.lexsort((klo, khi))
    s_hi, s_lo = khi[perm], klo[perm]
    rng = np.random.default_rng(seed + 100)
    qb, qc, qv = _pairs(seed + 7, 1500)
    qc = qc + rng.integers(0, 2, qc.shape).astype(np.int32)   # some absent cells
    q_hi, q_lo = (np.asarray(a) for a in jhs.mask_invalid(
        *jhs.pack(jnp.asarray(qb), jnp.asarray(qc)), jnp.asarray(qv)))
    q_hi = np.concatenate([q_hi, s_hi[::7]])
    q_lo = np.concatenate([q_lo, s_lo[::7]])
    return s_hi, s_lo, q_hi, q_lo


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("seed", [0, 3])
def test_lookup_matches_lookup_sorted_union(seed):
    s_hi, s_lo, q_hi, q_lo = _table_and_queries(seed)
    assert (q_hi == jhs.SENTINEL).any() and (s_hi == jhs.SENTINEL).any()
    missing = len(s_hi) + 5
    idx, found, ub = jax.jit(jhs.lookup_sorted_union, static_argnums=4)(
        *map(jnp.asarray, (s_hi, s_lo, q_hi, q_lo)), missing)
    th, tl, qh, ql = _t(s_hi, s_lo, q_hi, q_lo)
    got = hs.lookup(hs.pack_key(th, tl), hs.pack_key(qh, ql), missing)
    assert bool(got.found.any()) and not bool(got.found.all())
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(found))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(got.upper.numpy(), np.asarray(ub))
    lb = jax.jit(jhs.lower_bound)(*map(jnp.asarray, (s_hi, s_lo, q_hi, q_lo)))
    np.testing.assert_array_equal(got.lower.numpy(), np.asarray(lb))
    lower = hs.lower_bound(hs.pack_key(th, tl), hs.pack_key(qh, ql))
    np.testing.assert_array_equal(lower.numpy(), np.asarray(lb))
    assert hs.sorted_bounds(hs.pack_key(th, tl), hs.pack_key(qh, ql), upper=False)[1] is None


def test_lookup_matches_jax_lookup_on_a_unique_table():
    s_hi, s_lo, q_hi, q_lo = _table_and_queries(5)
    keep = np.ones(len(s_hi), bool)
    keep[1:] = (s_hi[1:] != s_hi[:-1]) | (s_lo[1:] != s_lo[:-1])
    s_hi, s_lo = s_hi[keep], s_lo[keep]
    idx, found = jax.jit(jhs.lookup)(*map(jnp.asarray, (s_hi, s_lo, q_hi, q_lo)))
    th, tl, qh, ql = _t(s_hi, s_lo, q_hi, q_lo)
    got = hs.lookup(hs.pack_key(th, tl), hs.pack_key(qh, ql))
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(found))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(idx))


@pytest.mark.parametrize("seed", [0, 4])
def test_unique_sorted_matches_jax(seed):
    khi, klo, valid = _masked(seed)
    perm = np.lexsort((klo, khi))
    s_hi, s_lo, s_valid = khi[perm], klo[perm], valid[perm]
    first, seg, n_uni = jax.jit(jhs.unique_sorted)(*map(jnp.asarray, (s_hi, s_lo, s_valid)))
    th, tl, tv = _t(s_hi, s_lo, s_valid)
    got = hs.unique_sorted(hs.pack_key(th, tl), tv)
    assert got.seg.dtype == torch.int32 and got.n_unique.dtype == torch.int32
    np.testing.assert_array_equal(got.first.numpy(), np.asarray(first))
    np.testing.assert_array_equal(got.seg.numpy(), np.asarray(seg))
    assert int(got.n_unique) == int(n_uni) < int(s_valid.sum())


def test_neighbor_map_plain_matches_brute_force_without_a_wrapper(monkeypatch):
    """The neighbour mode's plain version is its own reference: it searches
    with torch.searchsorted and never reaches ``sorted_bounds`` or
    ``lookup`` (which launch K16 on a CUDA tensor)."""
    def no_wrapper(*args, **kwargs):
        raise AssertionError("neighbor_map_plain reached a dispatching wrapper")

    monkeypatch.setattr(hs, "sorted_bounds", no_wrapper)
    monkeypatch.setattr(hs, "lookup", no_wrapper)
    khi, klo, valid = _masked(6, 800)
    perm = np.lexsort((klo, khi))
    s_hi, s_lo = khi[perm], klo[perm]
    keep = np.ones(len(s_hi), bool)
    keep[1:] = (s_hi[1:] != s_hi[:-1]) | (s_lo[1:] != s_lo[:-1])
    s_hi, s_lo = s_hi[keep], s_lo[keep]
    cap = len(s_hi) + 3                                   # sentinel padding rows
    s_hi = np.concatenate([s_hi, np.full(cap - len(s_hi), jhs.SENTINEL, np.int32)])
    s_lo = np.concatenate([s_lo, np.full(cap - len(s_lo), jhs.SENTINEL, np.int32)])
    ok = s_hi != jhs.SENTINEL
    coords = np.where(ok[:, None], np.stack([(s_lo >> 20) & 1023, (s_lo >> 10) & 1023,
                                              s_lo & 1023], -1), 0).astype(np.int32)
    batch = np.where(ok, s_hi, 0).astype(np.int32)
    slot = {(int(b), *map(int, c)): i for i, (b, c) in enumerate(zip(batch, coords)) if ok[i]}
    want = np.full((cap, 27), cap, np.int32)
    for v in np.flatnonzero(ok):
        for k, off in enumerate(hs.KERNEL_OFFSETS):
            want[v, k] = slot.get((int(batch[v]), *(int(c) + o for c, o in zip(coords[v], off))),
                                  cap)
    got = hs.neighbor_map_plain(*_t(s_hi, s_lo, coords, batch, ok))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[ok][:, hs.CENTER_TAP] == np.flatnonzero(ok)).all()


@pytest.mark.parametrize("bits", [17, 40, 62])
def test_key_sort_with_bits_matches_jax_lexsort(bits):
    """Keys in [0, 2^bits) with runs of duplicates: the stable permutation
    equals JAX's lexsort of their (key >> 31, key & (2^31 - 1)) halves."""
    rng = np.random.default_rng(bits)
    key = rng.integers(0, 1 << bits, 4000, dtype=np.int64)
    key[:800] = key[800:1600]
    key[-1] = (1 << bits) - 1
    want = np.asarray(jhs.lexsort_pairs(jnp.asarray((key >> 31).astype(np.int32)),
                                        jnp.asarray((key & jhs.SENTINEL).astype(np.int32))))
    s_key, perm = hs.key_sort(torch.from_numpy(key), bits)
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), want)
    np.testing.assert_array_equal(s_key.numpy(), key[want])


N_SEG = 700
SEGMENT_CASES = {
    # ids with a third of the segments empty and ~20% padding rows
    "empty segments and padding": lambda rng: np.where(
        np.isin(ids := rng.integers(0, N_SEG, 5000), rng.choice(N_SEG, N_SEG // 3, False))
        | (rng.random(5000) < 0.2), N_SEG, ids),
    "all padding": lambda rng: np.full(3000, N_SEG),
    "one segment": lambda rng: np.full(2500, 417),
}


def _jax_lower_bound(sorted_ids: np.ndarray, num_segments: int) -> np.ndarray:
    """JAX's lower_bound of every id 0..S, the ids as (0, id) pairs. The
    table ends in a (SENTINEL, SENTINEL) row, as the JAX package's padded
    tables do: its search can step one past a table whose rows are all
    below the query, while the row past the ids is their lower bound."""
    s_hi = np.append(np.zeros(len(sorted_ids), np.int32), jhs.SENTINEL)
    s_lo = np.append(sorted_ids.astype(np.int32), jhs.SENTINEL)
    q = np.arange(num_segments + 1, dtype=np.int32)
    return np.asarray(jhs.lower_bound(jnp.asarray(s_hi), jnp.asarray(s_lo),
                                      jnp.zeros_like(q), jnp.asarray(q)))


@pytest.mark.parametrize("case", list(SEGMENT_CASES))
def test_run_offsets_plain_matches_jax_lower_bound(case):
    rng = np.random.default_rng(11)
    s = np.sort(SEGMENT_CASES[case](rng))
    want = _jax_lower_bound(s, N_SEG)
    got = hs.run_offsets(torch.from_numpy(s), N_SEG)
    assert got.dtype == torch.int32 and got.shape == (N_SEG + 1,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), hs.run_offsets_plain(torch.from_numpy(s),
                                                                    N_SEG).numpy())
    ids = torch.arange(N_SEG + 1)
    np.testing.assert_array_equal(
        got.numpy(), torch.searchsorted(torch.from_numpy(s), ids, out_int32=True).numpy())


@pytest.mark.parametrize("case", list(SEGMENT_CASES))
def test_segment_csr_offsets_and_order_match_jax(case):
    """segment_csr's sort (bits = S.bit_length()) and run offsets: the
    stable order of the rows by id, the offsets JAX's lower_bound of the
    sorted ids, their differences JAX's segment_count."""
    rng = np.random.default_rng(12)
    ids = SEGMENT_CASES[case](rng)
    ids[:7] = [-3, N_SEG + 5, 0, N_SEG - 1, 0, N_SEG, -1]   # out-of-range ids are padding
    csr = segment.segment_csr(torch.from_numpy(ids), N_SEG)
    clipped = np.where((ids >= 0) & (ids < N_SEG), ids, N_SEG)
    order = np.argsort(clipped, kind="stable")
    np.testing.assert_array_equal(csr.perm.numpy(), order)
    np.testing.assert_array_equal(csr.offsets.numpy(), _jax_lower_bound(clipped[order], N_SEG))
    count = jsegment.segment_count(jnp.asarray(clipped), jnp.ones(len(ids), bool), N_SEG)
    np.testing.assert_array_equal(np.diff(csr.offsets.numpy()), np.asarray(count))


# (seed, rows, share of valid rows, cap)
UNIQUE_CASES = {"3000 rows, cap 2560": (0, N, 0.9, 2560), "cap overflows": (1, N, 0.9, 300),
                "all rows invalid": (2, 500, 0.0, 64), "n = 1": (3, 1, 1.0, 4),
                "n = 0": (4, 0, 1.0, 8)}


@pytest.mark.parametrize("case", list(UNIQUE_CASES))
def test_unique_compact_reads_valid_through_perm_as_jax_build_base(case):
    seed, n, share, cap = UNIQUE_CASES[case]
    batch, coords, _ = _pairs(seed, n)
    valid = np.random.default_rng(seed + 10).random(n) < share
    feats = np.arange(n, dtype=np.float32)[:, None]
    want, want_r2v, want_f = jsparse.build_base(jnp.asarray(batch), jnp.asarray(coords),
                                                jnp.asarray(valid), cap, jnp.asarray(feats))
    tb, tc, tv = _t(batch, coords, valid)
    s_key, perm = hs.key_sort(hs.pack_key(*hs.mask_invalid(*hs.pack(tb, tc), tv)))
    uniq, tab = hs.unique_compact(s_key, tv, perm, cap)
    for field in ("khi", "klo", "coords", "batch", "valid", "count", "n_dropped"):
        np.testing.assert_array_equal(getattr(tab, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    np.testing.assert_array_equal(tab.row2voxel.numpy(), np.asarray(want_r2v))
    src = np.where(np.asarray(want.valid), np.asarray(want_f)[:, 0].astype(np.int32), -1)
    np.testing.assert_array_equal(tab.src.numpy(), src)
    assert int(tab.n_dropped) == max(int(uniq.n_unique) - cap, 0)
    assert (int(tab.n_dropped) > 0) == (case == "cap overflows")
    # the sorted-flag route and the call without a table give the same ids
    sorted_route = hs.unique_sorted(s_key, tv[perm.long()])
    no_table, none = hs.unique_compact(s_key, tv, perm, None)
    assert none is None
    for a, b, c in zip(uniq, sorted_route, no_table):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_unique_compact_refuses_a_table_without_perm():
    s_key = torch.arange(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        hs.unique_compact(s_key, torch.ones(4, dtype=torch.bool), None, 4)


def _wrap_scene(seed: int) -> tuple:
    """(batch, coords, valid) voxels of two batches whose keys wrap: rows at
    z = 1023 beside (y + 1, z = 0) and at y = 1023 beside (x + 1, y = 0),
    adjacent in key order, next to seeded random voxels near them."""
    rng = np.random.default_rng(seed)
    crafted = []
    for b in (0, 1):
        for x, y in ((5, 7), (9, 1022), (3, 1023)):
            crafted += [(b, x, y, 1023), (b, x, y, 1022), (b, x, y + 1, 0), (b, x, y + 1, 1)]
        crafted += [(b, 20, 1023, 4), (b, 21, 0, 4), (b, 20, 1023, 5), (b, 21, 0, 3),
                    (b, 21, 1, 4), (b, 22, 0, 1023), (b, 22, 1, 0), (b, 1023, 1023, 1023),
                    (b, 0, 0, 0), (b, 0, 0, 1), (b, 0, 1, 0)]
    crafted = np.array([c for c in crafted if c[2] < 1024], np.int32)
    n = 1500
    base = rng.integers(0, len(crafted), n)
    pts = crafted[base].copy()
    pts[:, 1:] += rng.integers(-2, 3, (n, 3)).astype(np.int32)
    pts[:, 1:] = np.clip(pts[:, 1:], 0, 1023)
    pts = np.concatenate([crafted, pts])
    valid = np.ones(len(pts), bool)
    valid[len(crafted) + 3::11] = False
    return pts[:, 0].copy(), pts[:, 1:].copy(), valid


LEVEL_FIELDS = ("khi", "klo", "coords", "batch", "valid")


def _levels(jlevels) -> list:
    """The JAX levels' tables as torch tensors, with the fields a level has."""
    return [SimpleNamespace(**dict(zip(LEVEL_FIELDS, _t(*(np.asarray(getattr(lv, f))
                                                          for f in LEVEL_FIELDS)))))
            for lv in jlevels]


NEIGHBOR_CASES = {
    # the whole plan of the wrapping voxels, level 0 with padding
    "plan of wrapping keys, two batches": (0, None),
    # one level: every row invalid, and every row valid (cap = count)
    "a level with no valid row": (1, "none"),
    "a full level": (2, "full"),
}


@pytest.mark.parametrize("case", list(NEIGHBOR_CASES))
def test_neighbor_maps_plain_matches_jax_add_neighbors(case):
    """neighbor_maps_plain on every level of a JAX plan (or one JAX level)
    equals JAX's add_neighbors bit for bit, the wrapped keys included."""
    seed, kind = NEIGHBOR_CASES[case]
    batch, coords, valid = _wrap_scene(seed)
    if kind is None:
        plan, _, _ = jsparse.build_plan(jnp.asarray(batch), jnp.asarray(coords),
                                        jnp.asarray(valid), [2048, 1536, 1024, 768], 4)
        jlevels = list(plan.levels)
        assert int(jlevels[0].count) < 2048 and any(int(lv.count) > 1 for lv in jlevels[1:])
    else:
        n_uni = len({tuple(r) for r, v in zip(np.c_[batch, coords], valid) if v})
        ok = valid if kind == "full" else np.zeros_like(valid)
        level, _, _ = jsparse.build_base(jnp.asarray(batch), jnp.asarray(coords),
                                         jnp.asarray(ok), n_uni if kind == "full" else 512)
        jlevels = [jsparse.add_neighbors(level)]
        assert bool(np.asarray(level.valid).all()) == (kind == "full")
        assert not (kind == "none" and bool(np.asarray(level.valid).any()))
    got = hs.neighbor_maps(_levels(jlevels))
    assert len(got) == len(jlevels)
    for lvl, (g, lv) in enumerate(zip(got, jlevels)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(lv.nbr_idx), err_msg=f"L{lvl}")
    lv0 = _levels(jlevels)[0]
    assert torch.equal(hs.neighbor_map_plain(*(getattr(lv0, f) for f in LEVEL_FIELDS)),
                       got[0])
    if kind is None:                 # the trap: the z = 1023 row's +z tap is absent
        lv0 = jlevels[0]
        c0, b0, v0 = (np.asarray(lv0.coords), np.asarray(lv0.batch), np.asarray(lv0.valid))
        rows = np.flatnonzero(v0 & (c0[:, 2] == 1023))
        assert len(rows) > 0
        nxt = rows[rows + 1 < len(v0)] + 1
        assert (v0[nxt] & (c0[nxt, 2] == 0)).any()   # (y + 1, z = 0) follows in key order
        assert (got[0][rows, 14].numpy() == len(v0)).all()


def _walk_model(lv) -> np.ndarray:
    """K16's neighbour-mode walk, modelled in numpy: for each valid row and
    column (dx, dy), the lower bound of q0 - 1 and a walk of three rows that
    matches q0 - 1, q0, q0 + 1 in turn (column (0, 0): rows v - 1, v + 1),
    each tap kept only inside [0, 1024)^3."""
    khi, klo, coords, batch, valid = (getattr(lv, f).numpy().astype(np.int64)
                                      for f in LEVEL_FIELDS)
    valid = valid.astype(bool)
    cap = len(valid)
    table = (khi << 31) | klo
    key = (batch << 31) + (coords[:, 0] << 20) + (coords[:, 1] << 10) + coords[:, 2]
    out = np.full((cap, 27), cap, np.int64)
    rows = np.flatnonzero(valid)
    out[rows, 13] = rows
    for ci in range(9):
        dx, dy = ci // 3 - 1, ci % 3 - 1
        qx, qy = coords[rows, 0] + dx, coords[rows, 1] + dy
        live = rows[(qx >= 0) & (qx < 1024) & (qy >= 0) & (qy < 1024)]
        q0 = key[live] + (dx << 20) + (dy << 10)
        if ci == 4:
            for d, nb in ((0, live - 1), (2, live + 1)):
                ok = (nb >= 0) & (nb < cap)
                hit = np.zeros(len(live), bool)
                hit[ok] = table[nb[ok]] == q0[ok] + d - 1
                z = coords[live, 2] + d - 1
                hit &= (z >= 0) & (z < 1024)
                out[live[hit], 3 * ci + d] = nb[hit]
            continue
        r = np.searchsorted(table, q0 - 1, side="left")
        for d in range(3):
            inside = r < cap
            hit = np.zeros(len(live), bool)
            hit[inside] = table[r[inside]] == q0[inside] + d - 1
            z = coords[live, 2] + d - 1
            keep = hit & (z >= 0) & (z < 1024)
            out[live[keep], 3 * ci + d] = r[keep]
            r = r + hit
    return out


def test_neighbor_walk_model_matches_plain_on_wrapping_keys():
    """The kernel's search (one lower bound a column, a three-row walk, the
    centre column by adjacency, the range checks) gives the plain map on
    every level of a plan of wrapping keys."""
    batch, coords, valid = _wrap_scene(3)
    plan, _, _ = jsparse.build_plan(jnp.asarray(batch), jnp.asarray(coords),
                                    jnp.asarray(valid), [2048, 1536, 1024, 768], 4)
    for lv in _levels(plan.levels):
        want = hs.neighbor_map_plain(*(getattr(lv, f) for f in LEVEL_FIELDS))
        np.testing.assert_array_equal(_walk_model(lv), want.numpy())
