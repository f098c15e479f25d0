"""The stable partition of a flag vector, true indices first: kernel K10
``stable_partition`` (csrc/stable_partition.cu) for CUDA tensors, the plain
version for CPU ones.

Counterpart of the two stable argsorts of SoftGroup's grouping,
minsu3d_tpu/model/softgroup.py:124 (``jnp.argsort(~act_kn, stable=True)
[:pair_cap]``, the (point, class) pair packing) and :183 (``compact_rows``):
the first ``cap`` entries of the true indices in ascending order followed by
the false ones in ascending order. The false tail matters: the packed
grouping reads an invalid pair's point as ``order % N``.
"""

from __future__ import annotations

import torch

from minsu3d_tpu_torch.csrc import build


def stable_partition_plain(flags: torch.Tensor, cap: int) -> tuple:
    order = torch.argsort(~flags, stable=True)[:cap]
    return order.to(torch.int32), flags.sum().to(torch.int32)


def stable_partition_cuda(flags: torch.Tensor, cap: int) -> tuple:
    if flags.dtype != torch.bool or flags.dim() != 1 or not flags.is_contiguous():
        raise TypeError(f"stable_partition: want a contiguous 1-D bool tensor, got "
                        f"{flags.dtype} {tuple(flags.shape)}")
    n = flags.shape[0]
    dev = flags.device
    lib = build.kernel_lib()
    tiles = torch.empty(max(lib.ms3d_stable_partition_tiles(n), 1), dtype=torch.int32,
                        device=dev)
    order = torch.empty(min(cap, n), dtype=torch.int32, device=dev)
    n_true = torch.empty(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.ms3d_stable_partition(flags.data_ptr(), n, cap, tiles.data_ptr(),
                                          order.data_ptr(), n_true.data_ptr(), stream),
                "stable_partition")
    build.LAUNCHES["stable_partition"] += 1
    return order, n_true[0]


def stable_partition(flags: torch.Tensor, cap: int) -> tuple:
    """(order (min(cap, L),) int32, n_true () int32) of the flags (L,) bool:
    ``argsort(~flags, stable=True)[:cap]`` and the count of true flags."""
    if cap < 0:
        raise ValueError(f"stable_partition: cap {cap} < 0")
    if flags.device.type == "cpu":
        return stable_partition_plain(flags, cap)
    if flags.device.type == "cuda":
        return stable_partition_cuda(flags, cap)
    raise ValueError(f"stable_partition: unsupported device {flags.device}")
