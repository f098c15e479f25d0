"""Build and load the port's two native libraries.

* ``libms3d_host``: ``host_ops.cpp`` (voxel dedup, the host-built UNet grid
  plan), built with ``g++``; every entry point needs it.
* ``libms3d_kernels``: every ``*.cu`` file of this directory (and the
  ``*.cuh`` headers they share), each ``*.cu`` compiled
  by its own ``nvcc -gencode arch=compute_90a,code=sm_90a -c`` (all started
  together, beside the g++ build), then linked into one shared library with
  a plain C interface (no torch headers, no pybind11) and loaded with
  ``ctypes``; only CUDA tensors need it.

Both go into ``minsu3d_tpu_torch/_build/`` (gitignored), made at first use.
A library's file name carries a hash of its sources and flags, so a second
run in the same checkout loads what the first one built. A failed build or
load raises: there is no fallback.

``python -m minsu3d_tpu_torch.csrc.build`` builds both (the kernels only
where ``nvcc`` exists) and prints the paths.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parent / "_build"

HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]


def kernel_sources() -> list:
    return sorted(HERE.glob("*.cu"))


def kernel_headers() -> list:
    return sorted(HERE.glob("*.cuh"))


def _target(name: str, sources: list, flags: list) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin: "
                           "the CUDA kernels cannot be built")
    return found


def _compile(cmd_head: list, out: Path):
    """Start one compiler run writing to a temp file beside ``out``; returns
    (process, temp path, target) for ``_finish``, or None when ``out`` is
    already built."""
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=out.stem + ".", suffix=".tmp", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(cmd_head + ["-o", tmp], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"build failed ({' '.join(proc.args)}):\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders race benignly


def host_target() -> Path:
    return _target("ms3d_host", [HERE / "host_ops.cpp"], HOST_FLAGS)


def kernels_target() -> Path:
    return _target("ms3d_kernels", kernel_sources() + kernel_headers(), NVCC_FLAGS)


def _host_cmd() -> list:
    return ["g++", *HOST_FLAGS, str(HERE / "host_ops.cpp")]


def _object_jobs(lib: Path) -> tuple:
    """Start one ``nvcc -c`` per kernel source (objects named after the
    library's hash); returns (jobs, object paths)."""
    if lib.exists():
        return [], []
    nvcc = nvcc_path()
    objs = [BUILD_DIR / f"{lib.stem}.{src.stem}.o" for src in kernel_sources()]
    jobs = [_compile([nvcc, *NVCC_FLAGS, "-c", str(src)], obj)
            for src, obj in zip(kernel_sources(), objs)]
    return jobs, objs


def _link(lib: Path, objs: list) -> None:
    if objs:
        _finish(_compile([nvcc_path(), "-shared", *NVCC_FLAGS[:2], *map(str, objs)], lib))


def build_host() -> Path:
    out = host_target()
    _finish(_compile(_host_cmd(), out))
    return out


def build_kernels() -> Path:
    out = kernels_target()
    jobs, objs = _object_jobs(out)
    for job in jobs:
        _finish(job)
    _link(out, objs)
    return out


def build_all() -> tuple:
    """Start the g++ build and every nvcc together, wait for all, link."""
    host, kern = host_target(), kernels_target()
    host_job = _compile(_host_cmd(), host)
    jobs, objs = _object_jobs(kern)
    for job in [host_job, *jobs]:
        _finish(job)
    _link(kern, objs)
    return host, kern


_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64


def np_ptr(a) -> ctypes.c_void_p:
    """Address of a contiguous numpy array for a ``c_void_p`` argument."""
    return a.ctypes.data_as(ctypes.c_void_p)


@functools.cache
def host_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_host()))
    lib.ms3d_sparse_quantize.argtypes = [_P, _I64, _P, _P]
    lib.ms3d_sparse_quantize.restype = _I64
    lib.ms3d_plan_base.argtypes = [_P, _P, _P, _I64, ctypes.c_int32,
                                   _P, _P, _P, _P, _P, _P, _P, _P]
    lib.ms3d_plan_base.restype = ctypes.c_int32
    lib.ms3d_plan_neighbors.argtypes = [_P, _P, _P, _P, ctypes.c_int32, ctypes.c_int32, _P]
    lib.ms3d_plan_neighbors.restype = None
    return lib


@functools.cache
def kernel_lib() -> ctypes.CDLL:
    # cached: every wrapper calls this at each launch, and finding the
    # library hashes all kernel sources
    lib = ctypes.CDLL(str(build_kernels()))
    lib.ms3d_gather_gemm.argtypes = [_P, _I, _I, _P, _I, _I, _P, _P, _P, _I, _P, _P]
    lib.ms3d_gather_gemm_bf16.argtypes = lib.ms3d_gather_gemm.argtypes
    lib.ms3d_gather_wgrad.argtypes = [_P, _I, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I,
                                      _P, _P, _P, _P, _P]
    lib.ms3d_gather_wgrad_bf16.argtypes = lib.ms3d_gather_wgrad.argtypes
    lib.ms3d_gather_dx_bf16.argtypes = [_P, _I, _I, _P, _I, _I, _P, _P, _I, _P, _P]
    lib.ms3d_proposal_iou.argtypes = [_P, _P, _P, _P, _I64, _P, _I64, _P, _I, _I, _I, _P, _P, _P]
    lib.ms3d_ball_query_edge.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I64,
                                         ctypes.c_float, _P, _I64, _P, _P, _P, _P]
    lib.ms3d_ball_query_edge_scratch.argtypes = [_I64, _I]
    lib.ms3d_ball_query_edge_scratch.restype = _I64
    lib.ms3d_ball_query_grid.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                         ctypes.c_float, _P, _P]
    lib.ms3d_connected_components.argtypes = [_P, _P, _P, _P, *[_I] * 5, _P, _I64, _P, _I64,
                                              _P, _P, _P]
    lib.ms3d_probe_double.argtypes = [_P, _I64, _P, _P]
    lib.ms3d_window_gather_slice.argtypes = [_I, _I]
    lib.ms3d_window_gather.argtypes = [_P, _P, _I, _I, _I, _P, _P]
    lib.ms3d_onehot_gather.argtypes = [_P, _P, _I, _I, _I, _P, _P]
    lib.ms3d_segment_reduce_f32.argtypes = [_P, _I64, _I, _P, _P, _P, _I, _I, ctypes.c_float,
                                            _P, _P, _I64, _P]
    lib.ms3d_segment_reduce_i32.argtypes = [_P, _I64, _I, _P, _P, _P, _I, _I, ctypes.c_int32,
                                            _P, _P, _I64, _P]
    lib.ms3d_segment_reduce_bf16.argtypes = lib.ms3d_segment_reduce_f32.argtypes
    lib.ms3d_proposal_voxelize.argtypes = [_P, _I, _P, _I, _P, _P, _I, _P, _P, _P, _I, _P, _I,
                                           _P, _P, _P, _P, _P]
    lib.ms3d_proposal_voxelize_bf16.argtypes = lib.ms3d_proposal_voxelize.argtypes
    lib.ms3d_set_aggregation.argtypes = [_I64, *[_P] * 8, _I64, _P, _P]
    lib.ms3d_unit_compact.argtypes = [_P, _P, _I, _P, _I, _I, _I, _P, _I64, _P, _P]
    for fn in (lib.ms3d_segment_reduce_device_ops, lib.ms3d_unit_compact_device_ops,
               lib.ms3d_tap_tables_device_ops, lib.ms3d_proposal_voxelize_device_ops,
               lib.ms3d_unique_compact_device_ops, lib.ms3d_ball_query_edge_device_ops,
               lib.ms3d_proposal_rank_device_ops, lib.ms3d_set_aggregation_device_ops,
               lib.ms3d_proposal_iou_device_ops, lib.ms3d_mask_label_device_ops,
               lib.ms3d_neighbor_maps_device_ops, lib.ms3d_stable_partition_device_ops):
        fn.argtypes = []
        fn.restype = _I64
    lib.ms3d_stable_partition.argtypes = [_P, _I64, _I, _I64, *[_P] * 8]
    lib.ms3d_proposal_rank.argtypes = [_P, _P, _P, _P, _I, ctypes.c_float, _I64, _I64, _I64,
                                       _P, _P, _I64, _P, _P, _P, _P, _P]
    lib.ms3d_mask_label.argtypes = [_P, _P, _I64, _I, _I, ctypes.c_float, _P, _P, _P, _I64, _P,
                                    _I64, _I, _P, _P, _P]
    lib.ms3d_proposal_argmax.argtypes = [_P, _P, _I, _I, ctypes.c_float, _P, _P, _P, _P]
    lib.ms3d_key_sort_scratch.argtypes = [_I64, _I]
    lib.ms3d_key_sort_scratch.restype = _I64
    lib.ms3d_key_sort.argtypes = [_P, _I64, _I, _P, _P, _P, _I64, _P]
    lib.ms3d_sorted_bounds.argtypes = [_P, _I64, _P, _I64, _P, _P, _P]
    lib.ms3d_run_offsets.argtypes = [_P, _I64, _I64, _P, _P]
    lib.ms3d_neighbor_maps.argtypes = [_I, _P, _P, _P]
    lib.ms3d_tap_tables.argtypes = [_P, _I, _P, _P, _P, _I64, _P]
    lib.ms3d_unique_compact.argtypes = [_P, _P, _P, _I64, ctypes.c_int32, *[_P] * 11, _P]
    for fn in (lib.ms3d_gather_gemm, lib.ms3d_gather_gemm_bf16, lib.ms3d_gather_wgrad,
               lib.ms3d_gather_wgrad_bf16, lib.ms3d_gather_dx_bf16, lib.ms3d_proposal_iou,
               lib.ms3d_ball_query_edge, lib.ms3d_ball_query_grid,
               lib.ms3d_connected_components, lib.ms3d_probe_double, lib.ms3d_window_gather_slice,
               lib.ms3d_window_gather, lib.ms3d_onehot_gather, lib.ms3d_segment_reduce_f32,
               lib.ms3d_segment_reduce_i32, lib.ms3d_segment_reduce_bf16,
               lib.ms3d_proposal_voxelize, lib.ms3d_proposal_voxelize_bf16,
               lib.ms3d_set_aggregation, lib.ms3d_unit_compact,
               lib.ms3d_stable_partition,
               lib.ms3d_proposal_rank, lib.ms3d_mask_label, lib.ms3d_proposal_argmax,
               lib.ms3d_key_sort,
               lib.ms3d_sorted_bounds, lib.ms3d_run_offsets, lib.ms3d_neighbor_maps,
               lib.ms3d_unique_compact, lib.ms3d_tap_tables):
        fn.restype = _I
    return lib


# Launch count of every kernel wrapper: each wrapper adds one where it
# launches its kernel on the card (never on the CPU path), so a run can show
# that its main path went through the kernels. Reset with reset_launches().
# The bf16 variants of K1, K4, K6 and K7 count apart from their f32 versions,
# and K6's bf16 sum apart from its bf16 max and min; K16's bounds mode and
# run offsets share one count, its neighbour mode (one launch for every
# level of a plan) counts apart as "neighbor_map"; K10 counts the pair
# packing and compact_rows. K3 counts its launches (one
# a CC call), K18 those of them that run the coarsening. K22 counts its
# launches (one a call, the k2s2 tables of ``conv_tables`` included).
LAUNCHES = {"gather_gemm": 0, "ball_query_edge": 0, "connected_components": 0,
            "gather_wgrad": 0, "proposal_iou": 0, "segment_reduce": 0,
            "proposal_voxelize": 0, "set_aggregation": 0, "unit_compact": 0,
            "stable_partition": 0, "proposal_rank": 0, "mask_label": 0,
            "gather_gemm_bf16": 0, "segment_reduce_bf16": 0, "proposal_voxelize_bf16": 0,
            "gather_dx_bf16": 0, "gather_wgrad_bf16": 0, "segment_reduce_bf16_sum": 0,
            "ball_query_grid": 0, "key_sort": 0, "sorted_lookup": 0, "neighbor_map": 0,
            "unique_compact": 0,
            "cc_coarsen": 0, "probe_double": 0, "window_gather": 0, "onehot_gather": 0,
            "tap_orders": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check(err: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


if __name__ == "__main__":
    print("host:", build_host())
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        print("kernels:", build_kernels())
    else:
        print("kernels: nvcc not found, not built", file=sys.stderr)
