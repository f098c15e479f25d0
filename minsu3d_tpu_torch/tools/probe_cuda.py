"""The gather probe on the card: the port's counterpart of
``tools/probe_pallas.py``, whose three ``pl.pallas_call`` kernels it ports.

    python -m minsu3d_tpu_torch.tools.probe_cuda [--reps 20]

Is a row gather whose sources lie in a window (``out[i] = x[(i // tile) *
tile + idx[i]]``, idx in [0, tile)) faster when the window is staged in
shared memory than as a plain gather from device memory (whose window the
L2 serves), and what does the one-hot matrix-product route cost?

* ``double`` (K19, P1 ``k_double``): ``x * 2``.
* ``window_gather`` (K20, P2 ``tiled_gather``): the windowed gather, each
  tile's window staged in shared memory one channel slice at a time.
* ``onehot_gather`` (K21, P3 ``onehot_gather``): the same gather as the
  (tile x tile) one-hot matrix times the window, on TF32 tensor cores in
  three exact terms, equal to the gather bit for bit.

Each wrapper launches its kernel (``csrc/probe_gather.cu``) on CUDA tensors
and takes its plain version only on CPU tensors. The functions require
``V % tile == 0``: the Pallas grid of ``V // tile`` steps writes only the
first ``V // tile * tile`` rows of its output, so the probe runs V =
119808 (26 tiles of 4608), C = 128. ``main`` needs a card: it times each
kernel (CUDA events, median of ``--reps`` after a warm-up), as a wrapper
call and as a bare launch, beside its plain version, one PyTorch call of
the same function (``x * 2``, ``x[rows]``) and its bound, checks each
kernel against its plain version bit for bit, and prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from minsu3d_tpu_torch.csrc import build

V_PALLAS = 122880     # the Pallas probe's V
C = 128
TILE = 4608
V = V_PALLAS // TILE * TILE   # the rows its grid writes: 119808
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_FLOPS = 67e12             # H100 SXM f32 outside the tensor cores
TF32_FLOPS = 495e12           # H100 SXM TF32, dense tensor cores


def probe_inputs(device="cpu") -> tuple:
    """The Pallas probe's x (V, C) f32 and idx (V,) int32 (the same numpy
    draws, ``tools/probe_pallas.py:37-38``), cut to the rows its grid
    writes."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (V_PALLAS + TILE, C)).astype(np.float32)[:V]
    idx = rng.integers(0, TILE, (V_PALLAS,)).astype(np.int32)[:V]
    return torch.from_numpy(x).to(device), torch.from_numpy(idx).to(device)


def _device(name: str, *tensors) -> str:
    kind = tensors[0].device.type
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{name}: tensors on several devices")
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {tensors[0].device}")
    return kind


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---- K19 -------------------------------------------------------------------

def double_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2


def double_cuda(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32:
        raise TypeError(f"double: want float32, got {x.dtype}")
    x = x.contiguous()
    y = torch.empty_like(x)
    build.check(build.kernel_lib().ms3d_probe_double(x.data_ptr(), x.numel(), y.data_ptr(),
                                                     _stream(x)), "probe_double")
    build.LAUNCHES["probe_double"] += 1
    return y


def double(x: torch.Tensor) -> torch.Tensor:
    """``x * 2`` of a float32 tensor; K19 on CUDA tensors."""
    if _device("double", x) == "cpu":
        return double_plain(x)
    return double_cuda(x)


# ---- K20, K21 --------------------------------------------------------------

def _check_gather(name: str, x: torch.Tensor, idx: torch.Tensor, tile: int) -> None:
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"{name}: want x (V, C) float32, got {x.dtype} {tuple(x.shape)}")
    if idx.dtype != torch.int32 or idx.shape != x.shape[:1]:
        raise TypeError(f"{name}: want idx (V,) int32, got {idx.dtype} {tuple(idx.shape)}")
    if tile <= 0 or x.shape[0] % tile:
        raise ValueError(f"{name}: V = {x.shape[0]} is not a multiple of tile {tile}")


def window_rows(idx: torch.Tensor, tile: int) -> torch.Tensor:
    """The source row of every output row: ``(i // tile) * tile + idx``."""
    i = torch.arange(idx.shape[0], device=idx.device)
    return (i // tile) * tile + idx.long()


def window_gather_plain(x: torch.Tensor, idx: torch.Tensor, tile: int) -> torch.Tensor:
    return x[window_rows(idx, tile)]


def window_gather_cuda(x: torch.Tensor, idx: torch.Tensor, tile: int) -> torch.Tensor:
    v, c = x.shape
    lib = build.kernel_lib()
    if lib.ms3d_window_gather_slice(c, tile) == 0:
        raise ValueError(f"window_gather: no channel slice of C = {c} (a multiple of 4) "
                         f"fits shared memory at tile {tile}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("window_gather: x and out must be 16-byte aligned")
    build.check(lib.ms3d_window_gather(x.data_ptr(), idx.contiguous().data_ptr(), v, c, tile,
                                       out.data_ptr(), _stream(x)), "window_gather")
    build.LAUNCHES["window_gather"] += 1
    return out


def window_gather(x: torch.Tensor, idx: torch.Tensor, tile: int) -> torch.Tensor:
    """``out[i] = x[(i // tile) * tile + idx[i]]`` for x (V, C) float32 and
    idx (V,) int32 in [0, tile), V a multiple of ``tile``; K20 on CUDA
    tensors (C a multiple of 4)."""
    _check_gather("window_gather", x, idx, tile)
    if _device("window_gather", x, idx) == "cpu":
        return window_gather_plain(x, idx, tile)
    return window_gather_cuda(x, idx, tile)


def onehot_gather_plain(x: torch.Tensor, idx: torch.Tensor, tile: int) -> torch.Tensor:
    return window_gather_plain(x, idx, tile)


def onehot_gather_cuda(x: torch.Tensor, idx: torch.Tensor, tile: int) -> torch.Tensor:
    v, c = x.shape
    if tile % 16 or v // tile > 65535:
        raise ValueError(f"onehot_gather: tile {tile} must be a multiple of 16, with at "
                         f"most 65535 tiles")
    x = x.contiguous()
    out = torch.empty_like(x)
    build.check(build.kernel_lib().ms3d_onehot_gather(
        x.data_ptr(), idx.contiguous().data_ptr(), v, c, tile, out.data_ptr(), _stream(x)),
        "onehot_gather")
    build.LAUNCHES["onehot_gather"] += 1
    return out


def onehot_gather(x: torch.Tensor, idx: torch.Tensor, tile: int) -> torch.Tensor:
    """The gather of ``window_gather`` as a one-hot matrix product per tile,
    equal to it bit for bit for finite x; K21 on CUDA tensors (tile a
    multiple of 16)."""
    _check_gather("onehot_gather", x, idx, tile)
    if _device("onehot_gather", x, idx) == "cpu":
        return onehot_gather_plain(x, idx, tile)
    return onehot_gather_cuda(x, idx, tile)


# ---- timing ----------------------------------------------------------------

def cuda_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(n_bytes: float, flops: float, peak_flops: float) -> tuple:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bare_launch(name: str, x: torch.Tensor, idx: torch.Tensor, tile: int):
    """A call of kernel ``name``'s bare launch, with the library handle,
    the output and the stream taken once outside it: its time holds none of
    the wrapper's host work (checks, the allocation, the handle lookup),
    which lies inside the event window of a call this short."""
    lib, out, stream = build.kernel_lib(), torch.empty_like(x), _stream(x)
    v, c = x.shape
    xp, ip, op = x.data_ptr(), idx.data_ptr(), out.data_ptr()
    if name == "probe_double":
        return lambda: lib.ms3d_probe_double(xp, x.numel(), op, stream)
    fn = lib.ms3d_window_gather if name == "window_gather" else lib.ms3d_onehot_gather
    return lambda: fn(xp, ip, v, c, tile, op, stream)


def run(device, reps: int = 20, tile: int = TILE) -> dict:
    """Each kernel at the probe's shapes on ``device`` (a card): its
    records {name: {shape, max_abs_err, ms, launch_ms, plain_ms, library_ms,
    bound_ms, bound_by}}, ``ms`` a wrapper call, ``launch_ms`` the bare
    launch. Raises where a kernel differs from its plain version."""
    if torch.device(device).type != "cuda":
        raise RuntimeError("probe_cuda: the probe measures the card; pass a CUDA device")
    x, idx = probe_inputs(device)
    v, c = x.shape
    rows = window_rows(idx, tile)
    xy_bytes = 2 * x.numel() * 4
    shape = f"V {v}, C {c}, tile {tile}"
    cases = {
        "probe_double": (lambda: double(x), lambda: double_plain(x), lambda: x * 2,
                         bound_ms(xy_bytes, x.numel(), F32_FLOPS)),
        "window_gather": (lambda: window_gather(x, idx, tile),
                          lambda: window_gather_plain(x, idx, tile), lambda: x[rows],
                          bound_ms(xy_bytes + 4 * v, 0.0, TF32_FLOPS)),
        "onehot_gather": (lambda: onehot_gather(x, idx, tile),
                          lambda: onehot_gather_plain(x, idx, tile), lambda: x[rows],
                          bound_ms(xy_bytes + 4 * v, 0.0, TF32_FLOPS)),
    }
    recs = {}
    for name, (kernel, plain, library, (b_ms, b_by)) in cases.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"{name}: {int((got != want).sum())} elements differ from "
                                 f"the plain version")
        launch = bare_launch(name, x, idx, tile)
        build.check(launch(), name)
        recs[name] = {"shape": shape, "max_abs_err": float((got - want).abs().max()),
                      "ms": cuda_ms(kernel, reps),
                      "launch_ms": cuda_ms(launch, reps),
                      "plain_ms": cuda_ms(plain, reps),
                      "library_ms": cuda_ms(library, reps), "bound_ms": b_ms,
                      "bound_by": b_by}
    # the one-hot route's tensor-core work: three TF32 products a tile
    recs["onehot_gather"]["tf32_flops"] = 3 * 2 * tile * tile * c * (v // tile)
    return recs


def main(argv: list | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20, help="timed calls a function")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_cuda: CUDA is not available; the probe runs only on a card")
    recs = run(torch.device("cuda", 0), args.reps)
    for name, r in recs.items():
        print(f"# {name:14s} {r['ms']:.4f} ms  bare launch {r['launch_ms']:.4f}  plain "
              f"{r['plain_ms']:.4f}  library "
              f"{r['library_ms']:.4f}  bound {r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "probe": recs}), flush=True)
    return recs


if __name__ == "__main__":
    main()
