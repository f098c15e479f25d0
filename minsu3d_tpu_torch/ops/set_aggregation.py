"""HAIS's set aggregation, the ``use_set_aggr`` branch of
minsu3d_tpu/model/hais.py:82-108 (``hierarchical_aggregation``): kernel K8
``set_aggregation`` (csrc/set_aggregation.cu) for CUDA tensors, the plain
version for CPU ones.

The first ``min(C, 512)`` primaries in cluster order form a compact table
(centre, class, batch, size, proposal). Every fragment cluster looks for
the nearest live slot of its class and batch (first slot on ties, as
``jnp.argmin``); it is absorbed when the squared distance is below
max(0.01 * sqrt(slot size), class radius)^2 and below 1e9. The result is
each cluster's primary-path proposal: its own for a primary, the slot's for
an absorbed fragment, p_cap otherwise. Both versions compute d2 = ((dx*dx +
dy*dy) + dz*dz) with the same f32 operations, so they agree bit for bit.
The plain version builds the table by scatter by slot, as the JAX lines
do, and the (C, P2) distance matrix; the kernel builds the table in its
launch and never materializes the matrix.
"""

from __future__ import annotations

import torch

from minsu3d_tpu_torch.csrc import build

MAX_PRIMARIES = 512  # the compact primary table of the JAX code (p2 = min(C, 512))


def set_aggregation_plain(centers, cls, cbatch, primary, fragment, prim_prop, size_f, r_cls,
                          p_cap: int):
    n = centers.shape[0]
    p2 = min(n, MAX_PRIMARIES)
    rank = torch.cumsum(primary.to(torch.int64), 0) - 1
    slot = torch.where(primary & (rank < p2), rank, torch.full_like(rank, p2))

    def table(values, fill):
        t = torch.full((p2 + 1,) + values.shape[1:], fill, dtype=values.dtype,
                       device=values.device)
        t[slot] = values    # slot p2 collects the rest and is cut off
        return t[:p2]

    centers_p, cls_p, cbatch_p = table(centers, 0.0), table(cls, -2), table(cbatch, -2)
    size_p, prop_p, live_p = table(size_f, 0.0), table(prim_prop, p_cap), table(primary, False)
    d = centers[:, None, :] - centers_p[None, :, :]
    dist2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    bad = ((~fragment[:, None]) | (~live_p[None, :]) | (cls[:, None] != cls_p[None, :])
           | (cbatch[:, None] != cbatch_p[None, :]))
    dist2 = torch.where(bad, torch.full_like(dist2, 1e10), dist2)
    near_d2, nearest = torch.min(dist2, dim=1)
    r_size = 0.01 * torch.sqrt(size_p[nearest])
    r_set = torch.maximum(r_size, r_cls)
    absorbed = fragment & (near_d2 < r_set * r_set) & (near_d2 < 1e9)
    none = torch.full_like(prim_prop, p_cap)
    return torch.where(primary, prim_prop, torch.where(absorbed, prop_p[nearest], none))


_DTYPES = (torch.float32, torch.int32, torch.int32, torch.bool, torch.bool, torch.int64,
           torch.float32, torch.float32)


def set_aggregation_cuda(centers, cls, cbatch, primary, fragment, prim_prop, size_f, r_cls,
                         p_cap: int):
    """One K8 launch on the arrays as ``hierarchical_aggregation`` holds
    them; no cast, no memset, no host sync."""
    n = centers.shape[0]
    tensors = (centers, cls, cbatch, primary, fragment, prim_prop, size_f, r_cls)
    if len({t.get_device() for t in tensors}) != 1:
        raise ValueError("set_aggregation: tensors on several devices")
    if tuple(t.dtype for t in tensors) != _DTYPES:
        raise TypeError("set_aggregation: takes centers, size_f, r_cls f32; cls, cbatch "
                        "int32; primary, fragment bool; prim_prop int64")
    if centers.shape != (n, 3) or any(t.shape != (n,) for t in tensors[1:]):
        raise ValueError("set_aggregation: shapes of the cluster arrays disagree")
    args = [t.contiguous() for t in tensors]
    dev = centers.device
    out = torch.empty(n, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(build.kernel_lib().ms3d_set_aggregation(
        n, *(t.data_ptr() for t in args), p_cap, out.data_ptr(), stream), "set_aggregation")
    if n:
        build.LAUNCHES["set_aggregation"] += 1
    return out


def set_aggregation(centers, cls, cbatch, primary, fragment, prim_prop, size_f, r_cls,
                    p_cap: int):
    """(C,) int64 primary-path proposal of every cluster. Per cluster:
    centers (C, 3) f32, cls and cbatch (C,) int32, primary and fragment
    (C,) bool, prim_prop (C,) int64 (its proposal if primary, else p_cap),
    size_f (C,) f32 (its size), r_cls (C,) f32 (its class radius)."""
    args = (centers, cls, cbatch, primary, fragment, prim_prop, size_f, r_cls, p_cap)
    if centers.device.type == "cpu":
        return set_aggregation_plain(*args)
    if centers.device.type == "cuda":
        return set_aggregation_cuda(*args)
    raise ValueError(f"set_aggregation: unsupported device {centers.device}")
