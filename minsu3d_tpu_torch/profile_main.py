"""Where the time of PointGroup, HAIS or SoftGroup inference and training
goes, on one GPU.

    python -m minsu3d_tpu_torch.profile_main [--scenes 3] [--out FILE]
    python -m minsu3d_tpu_torch.profile_main --model hais [--epoch 100] [--out FILE]
    python -m minsu3d_tpu_torch.profile_main --model softgroup [--out FILE]
    python -m minsu3d_tpu_torch.profile_main --train [--model hais|softgroup] [--steps 5]
        [--out FILE]
    python -m minsu3d_tpu_torch.profile_main --model hais precision=bfloat16
    python -m minsu3d_tpu_torch.profile_main --train --model hais precision=bfloat16

Trailing ``key=value`` arguments override the eval config (or, with
``--train``, the training config), as ``train.py``'s do;
``precision=bfloat16`` profiles inference as the HAIS and SoftGroup eval
scripts are written, and training as every ``train_synth_*.sh`` is.

Inference: the model's golden eval config at full width
(``scripts/eval_synth_{pointgroup,hais,softgroup}.sh``, f32 by default),
seeded weights, the synthetic val scenes, the model's forward gates at
``--epoch``. Per scene it times, on the host clock: the host input path
(item, collate and the host-built grid plan, each apart; the plan counts
in the host input only with ``host_plan``, the default), the backbone and
the heads (each ending in ``torch.cuda.synchronize``), and the host tail
(``pred_instances``); and, with CUDA events, the device plan build
(``ops/sparse.py::device_plan``, what ``host_plan=false`` runs inside the
backbone), reported on a line of its own. Then a
``torch.profiler`` window over one forward per scene gives device time by
kernel name and the device's busy share of that window. Seeded weights
give the heads little to cluster (HAIS finds no proposal), so the heads and
the host tail are timed again, with a window of their own, on backbone
outputs made from the scene's ground truth (``injected_backbone_outputs``,
seed 20 + scene), where the clusters are the scene's objects. Each scene's
row carries the heads' overflow counters of both runs (``diag``,
``diag_gt``).

Training (``--train``): the model's training recipe at full width
(``scripts/train_synth_pointgroup.sh``, ``train_synth_hais2.sh`` or
``train_synth_softgroup.sh``: batch of 2 augmented scenes, f32 unless
``precision=bfloat16``), seeded
weights, ``--steps`` steps with the heads off (epoch 0), as many with them
on (epoch 1; HAIS's mask-IoU and mask-filter gates at 0, so that they are
on too), and as many heads-on steps whose heads read ground-truth classes
and offsets beside the backbone's point features (epoch 2,
``Trainer.forward_gt``): seeded HAIS and SoftGroup heads find no proposal on
their own outputs, so only that phase gives their heads and losses real
proposals.
Each step is split, on the host clock with the card synchronised after
each part, into host input (train items + collate + grid plan + copy to
the card), forward with the losses, backward, and the Adam update. The
last step of each phase runs inside a ``torch.profiler`` window (host input
outside it; in the third phase the injected outputs are made after the host
input is timed). The medians leave out each phase's first step (cuDNN and
allocator warm-up) and its profiled last step (the profiler's own host
cost); every step is reported.

Prints one JSON object and writes it to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from minsu3d_tpu_torch.config import backbone_caps, parse_overrides
from minsu3d_tpu_torch.data.batching import build_plan_host, collate, eval_caps
from minsu3d_tpu_torch.data.datamodule import TrainData
from minsu3d_tpu_torch.data.dataset import eval_item, synthetic_val_scenes
from minsu3d_tpu_torch.model.general_model import compute_dtype
from minsu3d_tpu_torch.model.registry import CLI_NAMES, get_model
from minsu3d_tpu_torch.ops.sparse import device_plan
from minsu3d_tpu_torch.test import (batch_to_torch, injected_backbone_outputs, out_to_numpy,
                                    seeded_model, set_f32_numerics)
from minsu3d_tpu_torch.trainer.trainer import Trainer


def _sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def event_ms(fn) -> float:
    """Device ms of ``fn()`` between two CUDA events, after one warm-up call."""
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


# the sparse convs' kernels, by a part of their kernel names: K1 the forward
# and the f32 dx, K13 the bf16 dx, K4 the weight gradient (its pair lists and
# partial sums included)
CONV_KERNELS = {"K1 gather_gemm": ("gather_gemm_kernel",),
                "K13 gather_dx_bf16": ("gather_dx_bf16",),
                "K4 gather_wgrad": ("wgrad_kernel", "pair_counts", "pair_offsets",
                                    "pair_scatter", "sum_partials")}


def device_window(fn) -> dict:
    """Run ``fn`` inside a torch.profiler window: window ms on the host
    clock, device busy ms (sum of kernel times), idle share, top kernels,
    and the sparse convs' kernels' device ms (``CONV_KERNELS``)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for ev in prof.key_averages():
        # kernel events only: an aten op's own device time repeats its kernels'
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = ev.self_device_time_total
        if dev_us > 0:
            kernels.append({"name": ev.key[:90], "calls": ev.count, "device_ms": dev_us / 1e3})
    kernels.sort(key=lambda k: -k["device_ms"])
    busy_ms = sum(k["device_ms"] for k in kernels)
    conv = {fam: sum(k["device_ms"] for k in kernels if any(p in k["name"] for p in parts))
            for fam, parts in CONV_KERNELS.items()}
    return {"profile_window_ms": window_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / window_ms),
            "conv_kernels_ms": conv, "top_kernels": kernels[:25]}


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()


# the overrides of a profiled training run: one epoch per head phase (the
# model's epoch gates open from the first heads-on epoch)
TRAIN_PROFILE = {"net.prepare_epochs": 0}


def train_main(steps: int, model: str = "pointgroup", overrides: dict | None = None) -> dict:
    """Step breakdown of the model's training recipe; see the module
    docstring."""
    dev = torch.device("cuda", 0)
    bundle = get_model(model)
    over = {**TRAIN_PROFILE, **bundle.open_gates, "synthetic.train_scenes": 2 * steps,
            **(overrides or {})}
    cfg = bundle.train_config().with_overrides(over)
    trainer = Trainer(cfg, TrainData(cfg), dev)
    phases = {}
    for phase in ("heads_off", "heads_on", "heads_on_gt"):
        rows, window = [], None
        for i in range(steps):
            t0 = time.perf_counter()
            batch = trainer.next_batch()
            tb = batch_to_torch(batch, dev)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            if phase == "heads_on_gt":
                inj = injected_backbone_outputs(batch, cfg.classes, cfg.net.m, 20 + i, dev)
                fwd = lambda: trainer.forward_gt(tb, inj)  # noqa: E731
            else:
                fwd = lambda: trainer.forward(tb)  # noqa: E731
            parts = {}

            def run():
                (out, losses, total), parts["forward_ms"] = _sync_ms(fwd)
                _, parts["backward_ms"] = _sync_ms(lambda: trainer.backward(total))
                _, parts["optimizer_ms"] = _sync_ms(trainer.update)
                parts["record"] = trainer.record(out, losses, total)
                parts["proposals"] = int(out["proposal_rows"]["n_proposals"]) \
                    if "proposal_rows" in out else 0

            if i == steps - 1:
                window = device_window(run)
            else:
                run()
            rec, n_props = parts.pop("record"), parts.pop("proposals")
            rows.append({"host_input_ms": host_ms, **parts,
                         "step_ms": host_ms + sum(parts.values()), "losses": rec["losses"],
                         "diag": rec["diag"], "proposals": n_props})
        timed = rows[1:-1]
        keys = ("host_input_ms", "forward_ms", "backward_ms", "optimizer_ms", "step_ms")
        phases[phase] = {"steps": rows, "median": {k: statistics.median(r[k] for r in timed)
                                                   for k in keys}, **window}
    script = {"PointGroup": "train_synth_pointgroup.sh", "HAIS": "train_synth_hais2.sh",
              "SoftGroup": "train_synth_softgroup.sh"}[cfg.MODEL]
    return {"device": card_name(), "model": cfg.MODEL,
            "config": f"scripts/{script}, {cfg.precision}",
            "overrides": over, "steps_per_phase": steps, **phases}


def main(argv: list | None = None) -> dict:
    ap = argparse.ArgumentParser(description="time breakdown of PointGroup, HAIS or "
                                 "SoftGroup inference or training")
    ap.add_argument("--scenes", type=int, default=3)
    ap.add_argument("--model", choices=CLI_NAMES, default="pointgroup",
                    help="the model to profile")
    ap.add_argument("--epoch", type=int, default=100, help="epoch of the forward gates")
    ap.add_argument("--train", action="store_true", help="profile training steps instead")
    ap.add_argument("--steps", type=int, default=5, help="train steps per head phase")
    ap.add_argument("--out", default=None)
    ap.add_argument("overrides", nargs="*",
                    help="config key=value overrides, e.g. precision=bfloat16")
    args = ap.parse_intermixed_args(argv)
    overrides = parse_overrides(args.overrides)
    bundle = get_model(args.model)
    # the config first, so that a bad override fails before the card is asked for
    cfg = (bundle.train_config() if args.train else bundle.eval_config()).with_overrides(
        overrides)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_main measures the GPU; CUDA is not available")
    set_f32_numerics()
    if args.train:
        if args.steps < 3:
            raise ValueError("--train needs --steps >= 3 (first step warm-up, last profiled)")
        return _emit(train_main(args.steps, args.model, overrides), args.out)
    dev = torch.device("cuda", 0)
    cfg = cfg.with_overrides({"synthetic.val_scenes": args.scenes})
    model = seeded_model(cfg, 0, dev)
    flags = bundle.forward_flags(cfg, args.epoch, False)
    caps, n_levels = backbone_caps(cfg), len(cfg.net.blocks)

    parts_ms = {"item": [], "collate": [], "host_plan": [], "device_plan": []}
    host_ms, batches = [], []
    for scan_id, scene in synthetic_val_scenes(cfg):
        t0 = time.perf_counter()
        item = eval_item(cfg, scene, scan_id)
        t1 = time.perf_counter()
        b = collate([item], eval_caps(cfg))
        t2 = time.perf_counter()
        hp = build_plan_host(b["voxel_batch"], b["voxel_coords"], b["voxel_mask"], caps,
                             n_levels)
        t3 = time.perf_counter()
        for key, ms in zip(("item", "collate", "host_plan"), (t1 - t0, t2 - t1, t3 - t2)):
            parts_ms[key].append(ms * 1e3)
        host_ms.append((t3 - t0 if cfg.host_plan else t2 - t0) * 1e3)
        if cfg.host_plan:
            b.update(hp)
        tb = batch_to_torch(b, dev)
        parts_ms["device_plan"].append(event_ms(lambda: device_plan(tb, caps, n_levels)))
        batches.append((scan_id, b, tb))
    print(f"# device plan build ms per scene (CUDA events, {n_levels} levels, caps {caps}): "
          f"{parts_ms['device_plan']}; host plan ms {parts_ms['host_plan']}", flush=True)

    rows = []
    with torch.no_grad():
        model(batches[0][2], **flags)  # warm-up: cuDNN and allocator
        for i, (scan_id, b, tb) in enumerate(batches):
            (out, _), bb_ms = _sync_ms(lambda: model.backbone_forward(tb))
            out, hd_ms = _sync_ms(lambda: model.heads(tb, out, **flags))
            n = int(b["num_points"])
            t0 = time.perf_counter()
            preds = bundle.pred_instances(cfg, scan_id, b["point_xyz"][:n],
                                          out_to_numpy(out, n), len(cfg.ignore_classes))
            tail_ms = (time.perf_counter() - t0) * 1e3
            gt = injected_backbone_outputs(b, cfg.classes, cfg.net.m, 20 + i, dev,
                                           compute_dtype(cfg))
            out_gt, hd_gt_ms = _sync_ms(lambda: model.heads(tb, gt, **flags))
            t0 = time.perf_counter()
            preds_gt = bundle.pred_instances(cfg, scan_id, b["point_xyz"][:n],
                                             out_to_numpy(out_gt, n), len(cfg.ignore_classes))
            tail_gt_ms = (time.perf_counter() - t0) * 1e3
            rows.append({"backbone_ms": bb_ms, "heads_ms": hd_ms, "host_tail_ms": tail_ms,
                         "proposals": int(out["proposal_rows"]["n_proposals"]),
                         "instances": len(preds), "heads_gt_ms": hd_gt_ms,
                         "host_tail_gt_ms": tail_gt_ms,
                         "proposals_gt": int(out_gt["proposal_rows"]["n_proposals"]),
                         "instances_gt": len(preds_gt),
                         "diag": {k: int(v) for k, v in out["diag"].items()},
                         "diag_gt": {k: int(v) for k, v in out_gt["diag"].items()}})
            batches[i] += (gt,)

        window = device_window(lambda: [model(tb, **flags) for _, _, tb, _ in batches])
        window_gt = device_window(lambda: [model.heads(tb, gt, **flags)
                                           for _, _, tb, gt in batches])

    result = {
        "device": card_name(), "model": cfg.MODEL, "precision": cfg.precision,
        "overrides": overrides, "scenes": args.scenes,
        "host_input_ms": host_ms, **{f"{k}_ms": v for k, v in parts_ms.items()},
        "per_scene": rows,
        "median": {k: statistics.median(r[k] for r in rows) for k, v in rows[0].items()
                   if not isinstance(v, dict)},
        **window, "heads_on_ground_truth_outputs": window_gt,
    }
    return _emit(result, args.out)


def _emit(result: dict, out: str | None) -> dict:
    print(json.dumps(result))
    if out:
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
