"""K22 ``conv_tables`` and K7 ``proposal_voxelize`` at the main path's shapes,
on one GPU.

    python -m minsu3d_tpu_torch.tools.conv_voxel_bench [--out FILE] [--reps 20]

``conv_tables``: the grid plans of the first val scene of the golden
PointGroup (m=16) and HAIS (m=32) eval configs (the host plan the batch
ships; 7 kernel maps and 12 k2s2 tables each). Per plan: the host ms of a
call without a sync (what a host-bound forward feels), CUDA-event ms
(median of ``--reps`` calls after a warm-up), device ms by
``torch.profiler`` (kernels and memsets summed, a mean over ``--reps``
calls), the device ops a call the profiler counts, and beside them one
``torch.sort(stable=True)`` of the prebuilt key column (every table's tap
keys with the table's index above them: the sort alone, without the keys,
the tables or the orders' split).

K7: the calls of ``general_model.clusters_voxelization_dense`` that
PointGroup's and HAIS's heads (f32) and HAIS's and SoftGroup's (bf16) make
on the first val scene fed ``injected_backbone_outputs`` (ground-truth
classes and offsets, so the proposals are real), captured as they are
made. Per call: the K7 wrapper alone (``place_cuda``) and the forward chain
the heads run (``voxelize_rows``, with the row gather and mask before it
in a tree whose K7 takes gathered rows), each by event and device ms and
device ops a call, and K7's bytes bound (``voxelize_bytes``).

Every record carries a hash of its outputs' bits, so that two trees can be
held to the same results. The tool adapts to K7's signature and otherwise
calls only functions that trees with ``segment.valid_csr`` and
``tools/segment_bench.py`` have: copied into such a checkout's ``tools/``
it times that tree, so parent and change can run in turns in one call. The
last line is a JSON object with every record and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
import time

import torch

from minsu3d_tpu_torch.config import EvalConfig, HaisEvalConfig, SoftGroupEvalConfig
from minsu3d_tpu_torch.model import general_model as gm
from minsu3d_tpu_torch.model.registry import get_model
from minsu3d_tpu_torch.ops import proposal_voxelize as pv
from minsu3d_tpu_torch.ops import segment, sparse_conv
from minsu3d_tpu_torch.ops.sparse import plan_from_batch
from minsu3d_tpu_torch.test import (batch_to_torch, collated_scenes, injected_backbone_outputs,
                                    seeded_model, set_f32_numerics)
from minsu3d_tpu_torch.tools.segment_bench import bits_hash, event_ms

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet


def host_ms(fn, reps: int) -> float:
    """Median host ms of one fn() without a sync inside it, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def device_ops(fn, reps: int) -> tuple:
    """(device ms of one fn(), device ops a call) from torch.profiler over
    ``reps`` calls after a warm-up: kernels and memsets summed."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = [e for e in prof.key_averages() if e.device_time_total > 0]
    return (sum(e.device_time_total for e in busy) / reps / 1e3,
            sum(e.count for e in busy) / reps)


def timed(fn, reps: int) -> dict:
    ms, ops = device_ops(fn, reps)
    return {"ms": event_ms(fn, reps), "device_ms": ms, "device_ops": ops}


def tables_hash(tabs) -> int:
    """A sum of the bits of every order's permutation and keys and of the
    k2s2 tables."""
    parts = []
    for lt in tabs:
        parts += [lt.nbr_order.perm, lt.nbr_order.key]
        if lt.links is not None:
            lk = lt.links
            parts += [lk.down, lk.up, lk.down_order.perm, lk.down_order.key, lk.up_order.perm,
                      lk.up_order.key]
    return sum(bits_hash(t.contiguous()) for t in parts)


def conv_tables_records(dev, reps: int) -> list:
    recs = []
    for cfg in (EvalConfig(), HaisEvalConfig()):
        _, batch = next(collated_scenes(cfg))
        plan, _, _ = plan_from_batch(batch_to_torch(batch, dev), len(cfg.net.blocks))
        tables = sparse_conv.conv_table_list(plan)
        column = torch.cat([sparse_conv.tap_key(idx, n) + (i << 32)
                            for i, (idx, n) in enumerate(tables)])
        rec = {"plan": cfg.MODEL, "tables": len(tables),
               "rows": sum(idx.shape[0] for idx, _ in tables),
               "host_ms": host_ms(lambda: sparse_conv.conv_tables(plan), reps),
               **timed(lambda: sparse_conv.conv_tables(plan), reps),
               "sort_alone": timed(lambda: torch.sort(column, stable=True), reps),
               "hash": tables_hash(sparse_conv.conv_tables(plan))}
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


def voxelize_bytes(rows: int, n_valid: int, n_win: int, c: int, esize: int, p_cap: int,
                   n_cells: int) -> int:
    """What K7 must move: every row's CSR entry read and its cell and won
    cell written (4 + 16 bytes), each valid row's point id and coords read
    (8 + 12), the winners' feature rows read, the proposal CSR's offsets and
    the per-proposal mean, scale and offset read, the volume and occupancy
    written once."""
    return (20 * rows + 20 * n_valid + n_win * c * esize + 4 * (p_cap + 1) + 28 * p_cap
            + n_cells * (c * esize + 1))


def k7_calls(dev) -> list:
    """(name, args, kwargs) of each ``clusters_voxelization_dense`` call of
    the four heads on the first val scene with ground-truth outputs."""
    calls, orig = [], gm.clusters_voxelization_dense
    bf16 = {"precision": "bfloat16"}
    for name, cfg in (("PointGroup f32", EvalConfig()), ("HAIS f32", HaisEvalConfig()),
                      ("HAIS bf16", HaisEvalConfig().with_overrides(bf16)),
                      ("SoftGroup bf16", SoftGroupEvalConfig().with_overrides(bf16))):
        def spy(*a, _n=name, **kw):
            calls.append((_n, a, kw))
            return orig(*a, **kw)

        _, batch = next(collated_scenes(cfg))
        model = seeded_model(cfg, 4, dev)
        inj = injected_backbone_outputs(batch, cfg.classes, cfg.net.m, 4, dev,
                                        gm.compute_dtype(cfg))
        flags = get_model(cfg.MODEL).forward_flags(cfg, 100, False)
        gm.clusters_voxelization_dense = spy
        try:
            with torch.no_grad():
                model.heads(batch_to_torch(batch, dev), inj, **flags)
        finally:
            gm.clusters_voxelization_dense = orig
    return calls


def k7_record(name: str, args: tuple, kw: dict, reps: int) -> dict:
    rows, p_cap, feats, coords, scale, s = args[:6]
    jitter = args[6] if len(args) > 6 else kw.get("jitter", gm.EVAL_JITTER)
    csr = args[7] if len(args) > 7 else kw.get("csr")
    if csr is None:
        csr = gm.proposal_csr(rows, p_cap)
    pidx, pid, valid, mean, c_scale, offset = gm.voxelization_placement(
        rows, p_cap, coords, scale, s, jitter, csr)
    if list(inspect.signature(pv.place_cuda).parameters)[0] == "feats":
        def call():
            return pv.place_cuda(feats, pidx, coords, csr, mean, c_scale, offset, p_cap, s)

        def chain():
            return pv.voxelize_rows(feats, pidx, coords, csr, mean, c_scale, offset, p_cap, s)
    else:   # K7 over rows gathered before the call
        def gathered():
            f = segment.gather_rows(feats, pidx)
            return torch.where(valid[:, None], f, torch.zeros_like(f))

        f = gathered()

        def call():
            return pv.place_cuda(f, coords, pidx, pid, valid, mean, c_scale, offset, p_cap, s)

        def chain():
            return pv.voxelize_rows(gathered(), coords, pidx, pid, valid, mean, c_scale, offset,
                                    p_cap, s)
    with torch.no_grad():
        volume, occ, row_cell, cell_w = call()
        n_cells, c, esize = occ.numel(), volume.shape[1], volume.element_size()
        n_valid, n_win = int(valid.sum()), int((cell_w < n_cells).sum())
        nb = voxelize_bytes(pidx.shape[0], n_valid, n_win, c, esize, p_cap, n_cells)
        rec = {"shape": name, "rows": pidx.shape[0], "valid_rows": n_valid, "winners": n_win,
               "cells": n_cells, "channels": c, "dtype": str(volume.dtype).replace("torch.", ""),
               "bound_ms": nb / HBM_BYTES_PER_S * 1e3, "call": timed(call, reps),
               "chain": timed(chain, reps),
               "hash": sum(bits_hash(t.long() if t.dtype == torch.bool else t)
                           for t in (volume, occ, row_cell, cell_w))}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the records here as JSON")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("conv_voxel_bench: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    set_f32_numerics()
    dev = torch.device("cuda", 0)
    result = {"device": smi, "torch": torch.__version__,
              "conv_tables": conv_tables_records(dev, args.reps),
              "k7": [k7_record(n, a, kw, args.reps) for n, a, kw in k7_calls(dev)]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
