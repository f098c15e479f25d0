"""The whole ball query call (K2's path) and ``sparse.build_base`` (K17's)
at the models' captured shapes, on one GPU.

    python -m minsu3d_tpu_torch.tools.query_bench [--out FILE] [--reps 20]
        [--part all|neighbor_maps]

Ball queries: every ``ball_query_edge`` and ``ball_query`` call that the
heads of PointGroup, HAIS and SoftGroup (golden eval configs, f32) make on
the first val scene fed ``injected_backbone_outputs`` (ground-truth classes
and offsets, so the unit graphs are real), and those of PointGroup at
point granularity, under the JAX bench's clustering and with
``caps.bq_edge_factor=0`` (the fused query), captured as they are made.
``build_base``: the same heads' unit tables (``make_units``,
``make_units_grid``) and the 7 levels of the device grid plan
(``sparse.build_plan``, ``host_plan=false``) of the PointGroup scene. The
kernel maps of that plan: the whole ``build_plan``, whose kernels by name
give the neighbour kernel's device ms and launches over all seven levels,
and the map of level 0 alone (``sparse.add_neighbors``).

Per call, from the query's inputs to its outputs (the cell hashing, K15's
sort and the kernels, all of it): the host ms of a call without a sync
(what a host-bound forward feels), CUDA-event ms (median of ``--reps``
calls after a warm-up), device ms and device ops a call by
``torch.profiler`` (kernels and memsets summed, a mean over ``--reps``
calls) and the device ms and launches of each kernel by name. Every record carries a
hash of its outputs' bits, so that two trees can be held to the same
results. The tool calls only the public functions (``ball_query_edge``,
``ball_query``, ``build_base``, ``build_plan``, ``add_neighbors``) whose
signatures the parent shares: copied
into a parent checkout's ``tools/`` it times that tree, so parent and
change can run in turns in one call. The last line is a JSON object with
every record and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys

import torch

from minsu3d_tpu_torch.config import EvalConfig, HaisEvalConfig, SoftGroupEvalConfig, backbone_caps
from minsu3d_tpu_torch.model import general_model as gm
from minsu3d_tpu_torch.model.registry import get_model
from minsu3d_tpu_torch.ops import cluster, sparse
from minsu3d_tpu_torch.test import (batch_to_torch, collated_scenes, injected_backbone_outputs,
                                    seeded_model, set_f32_numerics)
from minsu3d_tpu_torch.tools.conv_voxel_bench import host_ms
from minsu3d_tpu_torch.tools.segment_bench import bits_hash, event_ms

# the JAX bench's clustering (bench.py:63-121) on PointGroup's eval config,
# one scene a batch
BENCH_CLUSTERING = {"caps.clusters": 16384, "caps.proposals": 256, "caps.shifted_units": True,
                    "caps.cluster_units_shifted": 40960, "caps.cluster_cell_xyz": 0.03,
                    "caps.cluster_units": 40960, "caps.neighbors": 16,
                    "caps.bq_edge_factor": 28, "caps.bq_edge_factor_xyz": 8}


def configs() -> list:
    return [("PointGroup", EvalConfig()), ("HAIS", HaisEvalConfig()),
            ("SoftGroup", SoftGroupEvalConfig()),
            ("PointGroup point granularity",
             EvalConfig().with_overrides({"caps.cluster_granularity": "point"})),
            ("PointGroup bench clustering", EvalConfig().with_overrides(BENCH_CLUSTERING)),
            ("PointGroup bq_edge_factor=0", EvalConfig().with_overrides(
                {"caps.bq_edge_factor": 0}))]


def captured_calls(dev) -> tuple:
    """(ball query calls, build_base calls), each (name, function, args,
    kwargs), the tensors cloned as the call received them."""
    queries, bases = [], []
    orig = (cluster.ball_query_edge, cluster.ball_query, gm.build_base)

    def keep(store, name, fn, args, kw):
        args = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
        kw = {k: v.clone() if torch.is_tensor(v) else v for k, v in kw.items()}
        store.append((name, fn, args, kw))

    for name, cfg in configs():
        def spy_edge(*a, _n=name, **kw):
            keep(queries, f"{_n}: ball_query_edge", orig[0], a, kw)
            return orig[0](*a, **kw)

        def spy_fused(*a, _n=name, **kw):
            keep(queries, f"{_n}: ball_query (fused)", orig[1], a, kw)
            return orig[1](*a, **kw)

        def spy_base(*a, _n=name, **kw):
            if "point granularity" not in _n:
                keep(bases, f"{_n}: units", orig[2], a, kw)
            return orig[2](*a, **kw)

        _, batch = next(collated_scenes(cfg))
        model = seeded_model(cfg, 4, dev)
        inj = injected_backbone_outputs(batch, cfg.classes, cfg.net.m, 4, dev)
        flags = get_model(cfg.MODEL).forward_flags(cfg, 100, False)
        cluster.ball_query_edge, cluster.ball_query, gm.build_base = spy_edge, spy_fused, spy_base
        try:
            with torch.no_grad():
                model.heads(batch_to_torch(batch, dev), inj, **flags)
        finally:
            cluster.ball_query_edge, cluster.ball_query, gm.build_base = orig
    cfg = EvalConfig()
    _, batch = next(collated_scenes(cfg))
    tb = batch_to_torch(batch, dev)
    orig_base = sparse.build_base
    level = [0]

    def spy_plan(*a, **kw):
        keep(bases, f"PointGroup plan L{level[0]}", orig_base, a, kw)
        level[0] += 1
        return orig_base(*a, **kw)

    sparse.build_base = spy_plan
    try:
        sparse.build_plan(tb["voxel_batch"], tb["voxel_coords"], tb["voxel_mask"],
                          backbone_caps(cfg), len(cfg.net.blocks))
    finally:
        sparse.build_base = orig_base
    return queries, bases


def out_hash(out) -> int:
    """A hash of a call's tensors (bool as int64; NamedTuples and None
    walked)."""
    if out is None:
        return 0
    if torch.is_tensor(out):
        t = out.long() if out.dtype == torch.bool else out
        return bits_hash(t.contiguous()) if t.numel() else 0
    return sum(out_hash(o) for o in out)


def shape_of(fn, args: tuple, kw: dict) -> str:
    bound = inspect.signature(fn).bind(*args, **kw)
    bound.apply_defaults()
    a = bound.arguments
    if "radius" in a:
        return (f"{a['coords'].shape[0]} points ({int(a['valid'].sum())} valid), r "
                f"{a['radius']}, K {a['k']}, window {a['window']}, edge_cap "
                f"{a.get('edge_cap', 'none')}, half_space {a['half_space']}")
    return f"{a['batch'].shape[0]} rows ({int(a['valid'].sum())} valid), cap {a['cap']}"


def profiled(fn, reps: int) -> tuple:
    """(device ms by kernel name, device ops, device ops by kernel name) of
    one fn() from torch.profiler over ``reps`` calls after a warm-up:
    kernels and memsets."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts, counts = {}, {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = e.key.removeprefix("void ").replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1].strip()
            parts[name] = parts.get(name, 0.0) + e.device_time_total / reps / 1e3
            counts[name] = counts.get(name, 0.0) + e.count / reps
    return parts, sum(counts.values()), counts


def record(name: str, fn, args: tuple, kw: dict, reps: int) -> dict:
    return record_call(name, shape_of(fn, args, kw), lambda: fn(*args, **kw), reps)


def record_call(name: str, shape: str, call, reps: int) -> dict:
    with torch.no_grad():
        parts, ops, counts = profiled(call, reps)
        rec = {"call": name, "shape": shape,
               "host_ms": host_ms(call, reps), "ms": event_ms(call, reps),
               "device_ms": sum(parts.values()), "device_ops": ops, "parts": parts,
               "part_ops": counts,
               "hash": out_hash(call())}
    print(json.dumps(rec), flush=True)
    return rec


def neighbor_records(dev, reps: int) -> list:
    """The kernel maps of the PointGroup scene's device plan: the whole
    ``build_plan`` (its parts by kernel name hold the neighbour kernel's
    device ms and launches over the seven levels) and the map of level 0
    alone (``sparse.add_neighbors``). Both hash the maps they make."""
    cfg = EvalConfig()
    _, batch = next(collated_scenes(cfg))
    tb = batch_to_torch(batch, dev)
    args = (tb["voxel_batch"], tb["voxel_coords"], tb["voxel_mask"], backbone_caps(cfg),
            len(cfg.net.blocks))
    levels = sparse.build_plan(*args)[0].levels
    level0 = levels[0]._replace(nbr_idx=None)
    shape = (f"{[lv.cap for lv in levels]} rows x 27 taps, "
             f"{[int(lv.valid.sum()) for lv in levels]} valid")
    return [record_call("PointGroup device plan (build_plan): kernel maps of every level",
                        shape, lambda: [lv.nbr_idx for lv in sparse.build_plan(*args)[0].levels],
                        reps),
            record_call("PointGroup plan: kernel map of level 0", shape.split(",")[0],
                        lambda: sparse.add_neighbors(level0).nbr_idx, reps)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the records here as JSON")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--part", choices=("all", "neighbor_maps"), default="all",
                    help="neighbor_maps: only the device plan and its kernel maps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("query_bench: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    set_f32_numerics()
    dev = torch.device("cuda", 0)
    result = {"device": smi, "torch": torch.__version__}
    if args.part == "all":
        queries, bases = captured_calls(dev)
        result["ball_query"] = [record(*c, args.reps) for c in queries]
        result["build_base"] = [record(*c, args.reps) for c in bases]
    result["neighbor_maps"] = neighbor_records(dev, args.reps)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
