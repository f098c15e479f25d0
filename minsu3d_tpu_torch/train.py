"""PointGroup, HAIS or SoftGroup training on one GPU: the port's
counterpart of ``train.py`` under ``scripts/train_synth_pointgroup.sh``
(``--model pointgroup``, the default), ``scripts/train_synth_hais2.sh``
(``--model hais``) or ``scripts/train_synth_softgroup.sh`` (``--model
softgroup``), in f32, or in bf16 with ``precision=bfloat16``, the precision
those scripts run as written (the JAX package's default).

    python -m minsu3d_tpu_torch.train                      # the whole recipe
    python -m minsu3d_tpu_torch.train precision=bfloat16   # ... as the script runs it
    python -m minsu3d_tpu_torch.train --steps 4 net.prepare_epochs=0 \\
        synthetic.train_scenes=4                           # a few steps
    python -m minsu3d_tpu_torch.train --model hais --steps 4 net.prepare_epochs=0 \\
        net.cal_iou_based_on_mask_start_epoch=0 \\
        net.use_mask_filter_score_feature_start_epoch=0 synthetic.train_scenes=4
    python -m minsu3d_tpu_torch.train --device cpu --steps 1 net.m=8 ...

Trailing ``key=value`` arguments override the model's training config
(``TrainConfig``, ``HaisTrainConfig``, ``SoftGroupTrainConfig``; dotted
keys, values parsed as Python literals). ``precision=bfloat16`` trains
with bf16 activations and the JAX bf16 train step's rounding points, f32
parameters, batch statistics and Adam. Prints per-step losses and step
times (card synchronised), writes metrics.jsonl and a checkpoint under
``--out`` (``last.pt``, which ``python -m minsu3d_tpu_torch.test --ckpt``
evaluates). ``--resume`` continues from a checkpoint. Weights start from
the seed ``global_train_seed``.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from minsu3d_tpu_torch.config import parse_overrides
from minsu3d_tpu_torch.data.datamodule import TrainData
from minsu3d_tpu_torch.model.registry import CLI_NAMES, get_model
from minsu3d_tpu_torch.trainer.trainer import Trainer


def main(argv: list | None = None) -> Trainer:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", choices=CLI_NAMES, default="pointgroup")
    ap.add_argument("--steps", type=int, default=None, help="stop after this many steps")
    ap.add_argument("--epochs", type=int, default=None, help="max epochs (default the recipe's)")
    ap.add_argument("--out", default="output/torch_train", help="metrics and checkpoint dir")
    ap.add_argument("--resume", default=None, help="checkpoint to continue from")
    ap.add_argument("overrides", nargs="*", help="training config key=value overrides")
    args = ap.parse_intermixed_args(argv)

    cfg = get_model(args.model).train_config().with_overrides(
        parse_overrides(args.overrides))
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    trainer = Trainer(cfg, TrainData(cfg), device, out_dir=args.out)
    if args.resume:
        trainer.load_checkpoint(args.resume)
    max_epochs = cfg.max_epochs if args.epochs is None else args.epochs
    taken = 0
    while trainer.epoch < max_epochs and (args.steps is None or taken < args.steps):
        t0 = time.perf_counter()
        batch = trainer.next_batch()
        t1 = time.perf_counter()
        epoch, heads = trainer.epoch, trainer.heads_active
        rec = trainer.step(batch)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        losses = " ".join(f"{k}={v:.5f}" for k, v in rec["losses"].items())
        print(f"step {trainer.global_step} epoch {epoch} heads={int(heads)} {losses} "
              f"host_ms={(t1 - t0) * 1e3:.1f} step_ms={(t2 - t1) * 1e3:.1f} "
              f"diag={rec['diag']}", flush=True)
        taken += 1
    path = trainer.save_checkpoint(os.path.join(args.out, "last.pt"))
    print(f"checkpoint {path} (epoch {trainer.epoch}, step {trainer.global_step})")
    return trainer


if __name__ == "__main__":
    main()
