"""K6 ``segment_reduce`` and K9 ``unit_compact`` at every shape the models
launch them with, on one GPU.

    python -m minsu3d_tpu_torch.tools.segment_bench [--out FILE] [--reps 20]

The shapes are the main path's own inputs: the heads of PointGroup, HAIS
and SoftGroup (golden eval configs, full width) on the first val scene fed
``injected_backbone_outputs`` (ground-truth classes and offsets, so the
clusterings and proposals are real), each call of ``segment.segment_reduce``
recorded with the function that made it (the unit table, HAIS's centres and
class/batch max, the voxelization's mean, min and max, the roipool,
SoftGroup's cluster class); the backward of every ``gather_rows`` of those
heads (an ordered sum of seeded cotangent rows, f32 and bf16); at the HAIS
roipool's shape its sum as ``global_avg_pool`` and its bf16 max and min;
and every ``cluster.unit_points_compact`` call of those heads and of
PointGroup at point granularity (``compact_labels``), plus K9 on random
labels. The first of two identical calls of a model (PointGroup's two
clusterings) is kept.

Per call it records CUDA-event ms (median of ``--reps`` wrapper calls after
a warm-up), device ms (``torch.profiler``, kernels summed, a mean over
``--reps`` calls; also split by kernel), the library call's event and
device ms (``index_add_``
for a sum, ``scatter_reduce`` for max and min, into a padding row), the
bound (each live row and its perm entry read once, the output written once,
over 3.35 TB/s), for an f32/bf16 sum the chain floor (the longest segment
times one dependent f32 add, 4 cycles at the H100 SXM's 1980 MHz), and a
hash of the output's bits, so that two trees can be held to the same
results. The tool calls only wrappers that every commit since K6 and K9
were ported has (``segment_reduce(x, csr, op, fill)``,
``unit_points_compact_cuda(label, uid, u, c_cap, counts)``): copied into an
earlier checkout's ``tools/``, it times that tree, so parent and change can
run in turns in one call. The last line is a JSON object with every record
and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch

from minsu3d_tpu_torch.config import EvalConfig, HaisEvalConfig, SoftGroupEvalConfig
from minsu3d_tpu_torch.model.registry import get_model
from minsu3d_tpu_torch.ops import cluster, segment
from minsu3d_tpu_torch.test import (batch_to_torch, collated_scenes, injected_backbone_outputs,
                                    seeded_model, set_f32_numerics)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FADD_MS = 4 / 1.98e9 * 1e3  # one dependent f32 add: 4 cycles at 1980 MHz


def event_ms(fn, reps: int) -> float:
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


def device_parts(fn, reps: int) -> dict:
    """Device ms of one fn() by kernel (and memset), from torch.profiler
    over ``reps`` calls after a warm-up; a kernel named without its return
    type, namespace, template and parameters."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = e.key.removeprefix("void ").replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1].strip()
            parts[name] = parts.get(name, 0.0) + e.device_time_total / reps / 1e3
    return parts


def device_ms(fn, reps: int) -> float | None:
    total = sum(device_parts(fn, reps).values())
    return total if total > 0 else None


def bits_hash(t: torch.Tensor) -> int:
    """A sum of the output's bits (f32 as int32, bf16 as int16)."""
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(t.dtype)
    t = t.view(view) if view is not None else t
    return int((t.long() * torch.arange(1, t.numel() + 1, device=t.device).view(t.shape)).sum())


def _caller() -> str:
    """The first function outside the segment ops and autograd."""
    f = sys._getframe(2)
    while f is not None and f.f_code.co_filename.endswith(("ops/segment.py", "function.py")):
        f = f.f_back
    return f.f_code.co_name if f is not None else "?"


def model_calls(dev) -> tuple:
    """The K6 calls (model, caller, x, csr, op, fill), the gather_rows calls
    (model, x, idx) and the K9 calls (model, args) of each model's heads on
    the first val scene with ground-truth outputs."""
    k6, rows, k9 = [], [], []
    orig = (segment.segment_reduce, segment.gather_rows, cluster.unit_points_compact)
    configs = [(c.MODEL, c) for c in (EvalConfig(), HaisEvalConfig(), SoftGroupEvalConfig())]
    configs.append(("PointGroup point granularity",
                    EvalConfig().with_overrides({"caps.cluster_granularity": "point"})))
    for name, cfg in configs:
        def spy_k6(x, csr, op, fill=0, _n=name):
            k6.append((_n, _caller(), x, csr, op, fill))
            return orig[0](x, csr, op, fill)

        def spy_rows(x, idx, _n=name):
            rows.append((_n, x, idx))
            return orig[1](x, idx)

        def spy_k9(*args, _n=name):
            k9.append((_n, args))
            return orig[2](*args)

        _, batch = next(collated_scenes(cfg))
        model = seeded_model(cfg, 4, dev)
        inj = injected_backbone_outputs(batch, cfg.classes, cfg.net.m, 4, dev)
        flags = get_model(cfg.MODEL).forward_flags(cfg, 100, False)
        segment.segment_reduce, segment.gather_rows = spy_k6, spy_rows
        cluster.unit_points_compact = spy_k9
        try:
            with torch.no_grad():
                model.heads(batch_to_torch(batch, dev), inj, **flags)
        finally:
            segment.segment_reduce, segment.gather_rows, cluster.unit_points_compact = orig
    return k6, rows, k9


def k6_shapes(dev) -> tuple:
    """(name, x, csr, op, fill) at every K6 shape of the models, and the K9
    calls (name, (label, uid, u, c_cap, counts))."""
    k6, rows, k9 = model_calls(dev)
    shapes, seen = [], set()
    for model, caller, x, csr, op, fill in k6:
        if "point granularity" in model:
            continue
        key = (model, caller, op, x.dtype, tuple(x.shape), csr.num_segments)
        if key not in seen:
            seen.add(key)
            shapes.append((f"{model} {caller} {op}", x, csr, op, fill))
    g = torch.Generator().manual_seed(7)
    for model, x, idx in rows:
        if "point granularity" in model:
            continue
        key = (model, "gather_rows", tuple(x.shape), idx.shape[0])
        if key in seen:
            continue
        seen.add(key)
        csr = segment.segment_csr(idx.long(), x.shape[0])
        cot = torch.randn((idx.shape[0], x.shape[1]), generator=g).to(dev)
        shapes.append((f"{model} gather_rows backward", cot, csr, "sum", 0))
        shapes.append((f"{model} gather_rows backward bf16", cot.to(torch.bfloat16), csr, "sum",
                       0))
    pool = next(s for s in shapes if s[0] == "HAIS heads max")
    x = torch.randn(pool[1].shape, generator=g).to(dev)
    shapes.append(("HAIS roipool shape as global_avg_pool sum", x, pool[2], "sum", 0))
    xb = (torch.randint(-64, 64, pool[1].shape, generator=g) / 16.0).to(dev, torch.bfloat16)
    for op in ("max", "min"):
        shapes.append((f"HAIS roipool shape bf16 {op}", xb, pool[2], op, 0.0))
    calls = [(f"{model} {c_cap} clusters", (label, uid, u, c_cap, counts))
             for model, (label, uid, u, c_cap, counts, *_) in k9]
    u = calls[0][1][2]
    comp = torch.randint(0, 20000, (u,), generator=g)
    active = torch.rand(u, generator=g) < 0.8
    first = torch.full((20000,), u, dtype=torch.int64)
    first.scatter_reduce_(0, comp[active], torch.arange(u)[active], reduce="amin")
    label = torch.where(active, first[comp], torch.full_like(comp, u))
    counts = torch.where(active, torch.randint(1, 4, (u,), generator=g), 0)
    uid = torch.randint(0, u + 1, (131072,), generator=g)
    calls.append((f"random labels ({u} units, ~20000 components)",
                  (label.to(dev), uid.to(dev), u, calls[0][1][3], counts.to(dev))))
    return shapes, calls


def k6_record(name, x, csr, op, fill, reps: int) -> dict:
    live = int(csr.offsets[-1])
    n_seg, c = csr.num_segments, x.shape[1]
    lens = csr.offsets[1:] - csr.offsets[:-1]
    longest = int(lens.max())
    nb = x.element_size() * (live * c + n_seg * c) + 4 * (live + n_seg + 1)
    seg = csr.seg

    def run():
        return segment.segment_reduce(x, csr, op, fill)

    def library():
        if op == "sum":
            return torch.zeros((n_seg + 1, c), dtype=x.dtype, device=x.device).index_add_(0, seg, x)
        return torch.full((n_seg + 1, c), fill, dtype=x.dtype, device=x.device).scatter_reduce_(
            0, seg[:, None].expand_as(x), x, reduce="a" + op, include_self=True)

    rec = {"shape": name, "op": op, "dtype": str(x.dtype).replace("torch.", ""),
           "rows": x.shape[0], "live_rows": live, "channels": c, "segments": n_seg,
           "long_segments": int((lens > 32).sum()), "longest_segment": longest,
           "ms": event_ms(run, reps), "device_ms": device_ms(run, reps),
           "device_parts": device_parts(run, reps),
           "library_ms": event_ms(library, reps), "library_device_ms": device_ms(library, reps),
           "bound_ms": nb / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "out_hash": bits_hash(run())}
    if op == "sum" and x.dtype != torch.int32:
        rec["chain_floor_ms"] = longest * FADD_MS
    return rec


def k9_record(name, args, reps: int) -> dict:
    label, uid, u, c_cap, counts = args

    def run():
        return cluster.unit_points_compact_cuda(label, uid, u, c_cap, counts)

    out = run()
    return {"shape": name, "units": u, "points": uid.shape[0], "c_cap": c_cap,
            "components": int(out[2]), "ms": event_ms(run, reps),
            "device_ms": device_ms(run, reps),
            "bound_ms": 4 * (2 * u + 2 * uid.shape[0] + c_cap) / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "out_hash": [bits_hash(t) for t in out[:4]]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the records here as JSON")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("segment_bench: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    set_f32_numerics()
    dev = torch.device("cuda", 0)
    shapes, calls = k6_shapes(dev)
    k6 = []
    for shape in shapes:
        k6.append(k6_record(*shape, reps=args.reps))
        print(json.dumps(k6[-1]), flush=True)
    k9 = []
    for name, call in calls:
        k9.append(k9_record(name, call, args.reps))
        print(json.dumps(k9[-1]), flush=True)
    result = {"device": smi, "torch": torch.__version__, "k6": k6, "k9": k9}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
