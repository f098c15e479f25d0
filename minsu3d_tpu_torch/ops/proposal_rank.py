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


def proposal_rank_cuda(ccls, sizes, valid, pna_fg, npoint_thr: float, limit: int, p_cap: int,
                       point_cluster, pair_valid) -> tuple:
    c_cap, k, n = ccls.shape[0], pna_fg.shape[0], point_cluster.shape[0]
    dev = ccls.device
    tensors = (ccls, sizes, valid, pna_fg, point_cluster, pair_valid)
    if any(t.device != dev for t in tensors):
        raise ValueError("proposal_rank: tensors on several devices")
    if valid.dtype != torch.bool or pair_valid.dtype != torch.bool:
        raise TypeError("proposal_rank: valid and pair_valid must be bool")
    if sizes.shape[0] != c_cap or valid.shape[0] != c_cap or pair_valid.shape[0] != n:
        raise ValueError("proposal_rank: shapes of the cluster or pair arrays disagree")
    ccls32, sizes32, pc32 = (t.to(torch.int32).contiguous()
                             for t in (ccls, sizes, point_cluster))
    pna32 = pna_fg.to(torch.float32).contiguous()
    valid, pair_valid = valid.contiguous(), pair_valid.contiguous()
    i32 = dict(dtype=torch.int32, device=dev)
    prop, n_props = torch.empty(c_cap, **i32), torch.empty(1, **i32)
    prop_id = torch.empty(n, **i32)
    row_valid = torch.empty(n, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(build.kernel_lib().ms3d_proposal_rank(
        ccls32.data_ptr(), sizes32.data_ptr(), valid.data_ptr(), pna32.data_ptr(), k,
        ctypes.c_float(npoint_thr), c_cap, limit, p_cap, pc32.data_ptr(), pair_valid.data_ptr(),
        n, prop.data_ptr(), n_props.data_ptr(), prop_id.data_ptr(), row_valid.data_ptr(),
        stream), "proposal_rank")
    build.LAUNCHES["proposal_rank"] += 1
    return prop_id.long(), row_valid, n_props[0].long()


def proposal_rank(ccls, sizes, valid, pna_fg, npoint_thr: float, limit: int, p_cap: int,
                  point_cluster, pair_valid) -> tuple:
    """Per cluster: ccls (C,) int, the class of its pairs (-1 when empty;
    in [-1, k) where valid), sizes (C,) int, valid (C,) bool; pna_fg (k,)
    f32, the mean instance size of each foreground class; per pair:
    point_cluster (R,) int in [0, C] and pair_valid (R,) bool. Returns
    (prop_id (R,) int64 with p_cap for none, valid (R,) bool, n_proposals
    () int64)."""
    args = (ccls, sizes, valid, pna_fg, npoint_thr, limit, p_cap, point_cluster, pair_valid)
    if ccls.device.type == "cpu":
        return proposal_rank_plain(*args)
    if ccls.device.type == "cuda":
        return proposal_rank_cuda(*args)
    raise ValueError(f"proposal_rank: unsupported device {ccls.device}")
