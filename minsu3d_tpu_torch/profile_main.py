"""Where the time of PointGroup inference and training goes, on one GPU.

    python -m minsu3d_tpu_torch.profile_main [--scenes 3] [--out FILE]
    python -m minsu3d_tpu_torch.profile_main --train [--steps 5] [--out FILE]

Inference: golden eval config at full width, seeded weights, the synthetic
val scenes. Per scene it times, on the host clock: the host input path
(item + collate + grid plan), the backbone and the heads (each ending in
``torch.cuda.synchronize``), and the host tail (``pred_instances``). Then a
``torch.profiler`` window over one forward per scene gives device time by
kernel name and the device's busy share of that window.

Training (``--train``): the training recipe at full width (batch of 2
augmented scenes, 131072-voxel caps, f32), seeded weights, ``--steps``
steps with the heads off (epoch 0) and as many with them on (epoch 1).
Each step is split, on the host clock with the card synchronised after
each part, into host input (train items + collate + grid plan + copy to
the card), forward with the losses, backward, and the Adam update. The
last step of each phase runs inside a ``torch.profiler`` window (host input
outside it). The medians leave out each phase's first step (cuDNN and
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

from minsu3d_tpu_torch.config import EvalConfig, TrainConfig, backbone_caps
from minsu3d_tpu_torch.data.batching import collate, eval_caps
from minsu3d_tpu_torch.data.datamodule import TrainData
from minsu3d_tpu_torch.data.dataset import eval_item, synthetic_val_scenes
from minsu3d_tpu_torch.model.pointgroup import pred_instances
from minsu3d_tpu_torch.test import (batch_to_torch, out_to_numpy, seeded_model,
                                    set_f32_numerics)
from minsu3d_tpu_torch.trainer.trainer import Trainer


def _sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def device_window(fn) -> dict:
    """Run ``fn`` inside a torch.profiler window: window ms on the host
    clock, device busy ms (sum of kernel times), idle share, top kernels."""
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
    return {"profile_window_ms": window_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / window_ms),
            "top_kernels": kernels[:25]}


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()


def train_main(steps: int) -> dict:
    """Step breakdown of the training recipe; see the module docstring."""
    dev = torch.device("cuda", 0)
    cfg = TrainConfig().with_overrides({"synthetic.train_scenes": 2 * steps,
                                        "net.prepare_epochs": 0})
    trainer = Trainer(cfg, TrainData(cfg), dev)
    phases = {}
    for phase in ("heads_off", "heads_on"):
        rows, window = [], None
        for i in range(steps):
            t0 = time.perf_counter()
            tb = batch_to_torch(trainer.next_batch(), dev)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            parts = {}

            def run():
                (out, losses, total), parts["forward_ms"] = _sync_ms(lambda: trainer.forward(tb))
                _, parts["backward_ms"] = _sync_ms(lambda: trainer.backward(total))
                _, parts["optimizer_ms"] = _sync_ms(trainer.update)
                parts["record"] = trainer.record(out, losses, total)

            if i == steps - 1:
                window = device_window(run)
            else:
                run()
            rec = parts.pop("record")
            rows.append({"host_input_ms": host_ms, **parts,
                         "step_ms": host_ms + sum(parts.values()), "losses": rec["losses"],
                         "diag": rec["diag"]})
        timed = rows[1:-1]
        keys = ("host_input_ms", "forward_ms", "backward_ms", "optimizer_ms", "step_ms")
        phases[phase] = {"steps": rows, "median": {k: statistics.median(r[k] for r in timed)
                                                   for k in keys}, **window}
    return {"device": card_name(), "config": "scripts/train_synth_pointgroup.sh, f32",
            "steps_per_phase": steps, **phases}


def main(argv: list | None = None) -> dict:
    ap = argparse.ArgumentParser(description="time breakdown of PointGroup inference "
                                 "or training")
    ap.add_argument("--scenes", type=int, default=3)
    ap.add_argument("--train", action="store_true", help="profile training steps instead")
    ap.add_argument("--steps", type=int, default=5, help="train steps per head phase")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_main measures the GPU; CUDA is not available")
    set_f32_numerics()
    if args.train:
        if args.steps < 3:
            raise ValueError("--train needs --steps >= 3 (first step warm-up, last profiled)")
        return _emit(train_main(args.steps), args.out)
    dev = torch.device("cuda", 0)
    cfg = EvalConfig().with_overrides({"synthetic.val_scenes": args.scenes})
    model = seeded_model(cfg, 0, dev)
    plan = (backbone_caps(cfg), len(cfg.net.blocks))

    host_ms, batches = [], []
    for scan_id, scene in synthetic_val_scenes(cfg):
        t0 = time.perf_counter()
        b = collate([eval_item(cfg, scene, scan_id)], eval_caps(cfg), plan)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        batches.append((scan_id, b, batch_to_torch(b, dev)))

    rows = []
    with torch.no_grad():
        model(batches[0][2])  # warm-up: cuDNN and allocator
        for scan_id, b, tb in batches:
            (out, _), bb_ms = _sync_ms(lambda: model.backbone_forward(tb))
            out, hd_ms = _sync_ms(lambda: model.heads(tb, out))
            n = int(b["num_points"])
            t0 = time.perf_counter()
            pred_instances(cfg, scan_id, b["point_xyz"][:n], out_to_numpy(out, n),
                           len(cfg.ignore_classes))
            tail_ms = (time.perf_counter() - t0) * 1e3
            rows.append({"backbone_ms": bb_ms, "heads_ms": hd_ms, "host_tail_ms": tail_ms})

        window = device_window(lambda: [model(tb) for _, _, tb in batches])

    result = {
        "device": card_name(), "scenes": args.scenes,
        "host_input_ms": host_ms, "per_scene": rows,
        "median": {k: statistics.median(r[k] for r in rows) for k in rows[0]},
        **window,
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
