"""A seeded lattice graph for connected components with many cross-root
pairs left after the first sweeps: the cells of a ``dims`` grid joined to
their face neighbours (6 in 3-D, 4 in a 1-thick slab) under a random
permutation of the node ids, each link in a random one of ``k`` slots, 5%
of the nodes inactive, two groups split along the first axis.

Random ids keep the roots' hooking local, so after the two sweeps before
the coarsening's extraction the (64, 64, 64) lattice at K 16 still has
~455k cross-root edge slots and ~15k distinct cross-root pairs (more than
``cc_coarsen`` 4096: the pair list overflows), and the (256, 256, 1) slab
at K 8 ~50k slots and ~4.5k distinct pairs.
"""

from __future__ import annotations

import numpy as np


def lattice(dims: tuple, k: int, seed: int) -> tuple:
    """(nbr (N, k) int32 with N for an empty slot, nbr_valid (N, k) bool,
    active (N,) bool, group (N,) int32) as numpy arrays."""
    rng = np.random.default_rng(seed)
    shape = np.array(dims)
    n = int(shape.prod())
    node = rng.permutation(n).astype(np.int32)   # lattice cell -> node id
    cell = np.stack(np.unravel_index(np.arange(n), dims), 1)
    offsets = [o for o in np.concatenate([np.eye(3, dtype=int), -np.eye(3, dtype=int)])
               if shape[np.abs(o).argmax()] > 1]
    slot = np.argsort(rng.random((n, k)), 1)[:, :len(offsets)]
    nbr = np.full((n, k), n, np.int32)
    for j, off in enumerate(offsets):
        to = cell + off
        inside = np.all((to >= 0) & (to < shape), 1)
        target = np.ravel_multi_index(to[inside].T, dims)
        nbr[node[inside], slot[inside, j]] = node[target]
    active = rng.random(n) >= 0.05
    group = np.empty(n, np.int32)
    group[node] = cell[:, 0] * 2 // dims[0]
    return nbr, nbr < n, active, group
