"""SoftGroup's class-major proposal ids: kernel K11 ``proposal_rank``
(csrc/proposal_rank.cu) for CUDA tensors, the plain version for CPU ones.

Counterpart of minsu3d_tpu/model/softgroup.py:156-175: a cluster survives
when it is valid and holds at least ``npoint_thr * point_num_avg`` of its
class points (an f32 product, rounded as the JAX line rounds it); the
survivors are ranked class-major, by (class, cluster id), through the stable
argsort of ``where(ok, ccls, k)``; the first ``limit`` become proposals, and
every (point, class) pair reads its cluster's proposal id (``p_cap`` for
none). The plain version holds the JAX ops one for one.
"""

from __future__ import annotations

import ctypes

import torch

from minsu3d_tpu_torch.csrc import build


def proposal_rank_plain(ccls, sizes, valid, pna_fg, npoint_thr: float, limit: int, p_cap: int,
                        point_cluster, pair_valid) -> tuple:
    c_cap, k = ccls.shape[0], pna_fg.shape[0]
    dev = ccls.device
    ccls = ccls.long()
    thr = torch.tensor(npoint_thr, dtype=torch.float32, device=dev) * pna_fg[ccls.clamp(0, k - 1)]
    ok = valid & (sizes.to(torch.float32) >= thr)
    rank_src = torch.argsort(torch.where(ok, ccls, torch.full_like(ccls, k)), stable=True)
    rank = torch.empty(c_cap, dtype=torch.int64, device=dev)
    rank[rank_src] = torch.arange(c_cap, device=dev)
    prop = torch.where(ok & (rank < limit), rank, torch.full_like(rank, p_cap))
    prop_ext = torch.cat([prop, prop.new_full((1,), p_cap)])
    pc = point_cluster.long().clamp(0, c_cap)
    pid = torch.where(pair_valid, prop_ext[pc], torch.full_like(pc, p_cap))
    return pid.clamp(max=p_cap), pid < p_cap, ok.sum().clamp(max=limit)


# the histograms' part of the kernel's scratch: kMaxKeys x kMaxGrid int32
# (csrc/proposal_rank.cu); the clusters' proposals follow
_HIST_SCRATCH = 128 * 256


def proposal_rank_cuda(ccls, sizes, valid, pna_fg, npoint_thr: float, limit: int, p_cap: int,
                       point_cluster, pair_valid) -> tuple:
    """One K11 launch that reads the arrays as the caller holds them: ccls
    int32 (K6's cluster class), sizes and point_cluster int64 (the
    clustering's), the flags bool, pna_fg f32; it writes prop_id and
    n_proposals in int64. No cast, no memset, no host sync. (The checks
    read device indices and dtypes once: a forward waits on this host
    work.)"""
    c_cap, k, n = ccls.shape[0], pna_fg.shape[0], point_cluster.shape[0]
    tensors = (ccls, sizes, valid, pna_fg, point_cluster, pair_valid)
    if len({t.get_device() for t in tensors}) != 1:
        raise ValueError("proposal_rank: tensors on several devices")
    dt = tuple(t.dtype for t in tensors)
    if dt != (torch.int32, torch.int64, torch.bool, torch.float32, torch.int64, torch.bool):
        raise TypeError("proposal_rank: takes ccls int32, sizes and point_cluster int64, "
                        "valid and pair_valid bool, pna_fg float32")
    if sizes.shape[0] != c_cap or valid.shape[0] != c_cap or pair_valid.shape[0] != n:
        raise ValueError("proposal_rank: shapes of the cluster or pair arrays disagree")
    ccls, sizes, valid, pna_fg, point_cluster, pair_valid = (t.contiguous() for t in tensors)
    dev = ccls.device
    scratch = torch.empty(_HIST_SCRATCH + c_cap, dtype=torch.int32, device=dev)
    out = torch.empty(n + 1, dtype=torch.int64, device=dev)     # prop_id, then n_proposals
    row_valid = torch.empty(n, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(build.kernel_lib().ms3d_proposal_rank(
        ccls.data_ptr(), sizes.data_ptr(), valid.data_ptr(), pna_fg.data_ptr(), k,
        ctypes.c_float(npoint_thr), c_cap, limit, p_cap, point_cluster.data_ptr(),
        pair_valid.data_ptr(), n, scratch.data_ptr(), out.data_ptr(), row_valid.data_ptr(),
        out.data_ptr() + 8 * n, stream), "proposal_rank")
    build.LAUNCHES["proposal_rank"] += 1
    return out[:n], row_valid, out[n]


def proposal_rank(ccls, sizes, valid, pna_fg, npoint_thr: float, limit: int, p_cap: int,
                  point_cluster, pair_valid) -> tuple:
    """Per cluster: ccls (C,) int32, the class of its pairs (-1 when empty;
    in [-1, k) where valid), sizes (C,) int64, valid (C,) bool; pna_fg (k,)
    f32, the mean instance size of each foreground class; per pair:
    point_cluster (R,) int64 in [0, C] and pair_valid (R,) bool. Returns
    (prop_id (R,) int64 with p_cap for none, valid (R,) bool, n_proposals
    () int64)."""
    args = (ccls, sizes, valid, pna_fg, npoint_thr, limit, p_cap, point_cluster, pair_valid)
    if ccls.device.type == "cpu":
        return proposal_rank_plain(*args)
    if ccls.device.type == "cuda":
        return proposal_rank_cuda(*args)
    raise ValueError(f"proposal_rank: unsupported device {ccls.device}")
