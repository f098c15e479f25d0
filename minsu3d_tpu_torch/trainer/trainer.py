"""PointGroup, HAIS and SoftGroup training on one device: the port of
minsu3d_tpu/trainer/trainer.py:71-250 (``Trainer``) and of the single-shard
step of minsu3d_tpu/parallel/mesh.py:63-85.

* The model comes from the registry by ``cfg.MODEL``: its net, its
  ``forward_flags`` (train=True) and ``losses`` with its ``loss_flags``, all
  at the current epoch (minsu3d_tpu/trainer/trainer.py:87,130-145).
* Parameters from a seed (``test.seeded_model``), every head's parameters
  created up front, as the JAX trainer's ``init`` with ``with_heads=True``.
* ``torch.optim.Adam`` with optax's defaults (betas 0.9/0.999, eps 1e-8
  outside the square root, bias correction); the learning rate is set per
  epoch from ``cosine_lr``.
* The heads run once ``epoch > prepare_epochs`` (``heads_active``); the loss
  is the plain sum of the loss dict.
* ``forward_gt``: a heads-on forward whose heads read injected ground-truth
  classes and offsets beside the backbone's own point features, for runs
  whose seeded heads would find no proposal.
* Diag counters keep the worst value of the epoch; any overflow prints a
  warning. One JSONL record per epoch goes to ``<out_dir>/metrics.jsonl``.
* ``save_checkpoint``/``load_checkpoint``: ``torch.save`` of the model's
  name and state, the optimizer, the epoch, the position in the epoch and
  the jitter generator's state, so a resumed run takes the same next step;
  loading another model's checkpoint raises. (The JAX
  package's orbax checkpoints cannot be read without JAX.)
* The config's precision: f32 by default, with TF32 off for matmuls and
  cuDNN convs (the JAX package's ``model.trainer.precision=float32``);
  with "bfloat16" the model runs bf16 activations and rounds its backward
  where the JAX package's bf16 train step does, while the parameters, the
  batch statistics, the gradients handed to Adam and Adam's state stay
  f32, as the JAX trainer's f32 parameters under optax
  (minsu3d_tpu/trainer/trainer.py:90).

Data parallelism and periodic validation are not ported yet.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from minsu3d_tpu_torch.config import TrainConfig
from minsu3d_tpu_torch.data.datamodule import TrainData
from minsu3d_tpu_torch.model import general_model as gm
from minsu3d_tpu_torch.model.registry import get_model
from minsu3d_tpu_torch.ops.sparse import plan_dropped
from minsu3d_tpu_torch.test import batch_to_torch, seeded_model, set_f32_numerics
from minsu3d_tpu_torch.util.lr_decay import cosine_lr


class Trainer:
    def __init__(self, cfg: TrainConfig, data: TrainData, device, seed: int | None = None,
                 out_dir: str | None = None):
        set_f32_numerics()
        self.cfg = cfg
        self.data = data
        self.device = torch.device(device)
        self.bundle = get_model(cfg.MODEL)
        seed = cfg.global_train_seed if seed is None else seed
        self.model = seeded_model(cfg, seed, self.device, "train")
        self.caps = self.model.caps
        self.opt = torch.optim.Adam(self.model.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                                    eps=1e-8)
        self.generator = torch.Generator().manual_seed(seed)
        self.epoch = 0
        self.pos = 0          # steps taken in the current epoch
        self.global_step = 0
        self.out_dir = out_dir
        self._reset_epoch_stats()

    @property
    def heads_active(self) -> bool:
        return self.epoch > self.cfg.net.prepare_epochs

    def lr(self) -> float:
        return cosine_lr(self.cfg.lr, self.epoch, self.cfg.decay_start_epoch,
                         self.cfg.max_epochs)

    # -- one step -----------------------------------------------------------
    def next_batch(self) -> dict:
        """Collated numpy batch of the next step (host input)."""
        bs = self.cfg.batch_size
        order = self.data.order(self.epoch)
        return self.data.batch(self.epoch, order[self.pos * bs:(self.pos + 1) * bs])

    def forward(self, tb: dict) -> tuple:
        """Training forward and losses: (out, losses dict, total)."""
        heads, b = self.heads_active, self.bundle
        flags = b.forward_flags(self.cfg, self.epoch, True)
        out = self.model(tb, train=True, with_heads=heads, generator=self.generator, **flags)
        losses = b.losses(self.cfg, self.caps, tb, out, heads,
                          **b.loss_flags(self.cfg, self.epoch))
        return out, losses, sum(losses.values())

    def forward_gt(self, tb: dict, injected: dict) -> tuple:
        """A heads-on training forward whose heads read the ground-truth
        classes and offsets of ``injected`` (``test.injected_backbone_outputs``)
        beside the backbone's own point features, and the model's losses:
        (out, losses, total). Seeded HAIS and SoftGroup heads find no
        proposal on their own backbone outputs; here the objects are the
        clusters, and the losses' gradients reach the backbone through the
        point features."""
        b = self.bundle
        out, plan = self.model.backbone_forward(tb, train=True)
        out = dict(out, semantic_scores=injected["semantic_scores"],
                   point_offsets=injected["point_offsets"])
        out = self.model.heads(tb, out, True, gm.train_jitter(self.generator),
                               **b.forward_flags(self.cfg, self.epoch, True))
        out["diag"]["voxels_dropped"] = plan_dropped(plan)
        losses = b.losses(self.cfg, self.caps, tb, out, True,
                          **b.loss_flags(self.cfg, self.epoch))
        return out, losses, sum(losses.values())

    def backward(self, total: torch.Tensor) -> None:
        self.opt.zero_grad(set_to_none=True)
        total.backward()

    def update(self) -> None:
        for group in self.opt.param_groups:
            group["lr"] = self.lr()
        self.opt.step()

    def step(self, batch: dict | None = None, mark=None) -> dict:
        """One Adam step on ``batch`` (default: the next batch of the
        epoch). Returns the losses and diag counters as Python numbers.
        ``mark``, if given, is called with the name of each part of the step
        as it ends ("host_input": the batch on the device, "forward" with
        the losses, "backward", "adam"), so that a caller can time them."""
        mark = mark or (lambda part: None)
        if batch is None:
            batch = self.next_batch()
        tb = batch_to_torch(batch, self.device)
        mark("host_input")
        out, losses, total = self.forward(tb)
        mark("forward")
        self.backward(total)
        mark("backward")
        self.update()
        mark("adam")
        return self.record(out, losses, total)

    def record(self, out: dict, losses: dict, total: torch.Tensor) -> dict:
        """Close a step: losses and diag counters as Python numbers (this
        waits for the device), epoch statistics, position in the epoch."""
        rec = {k: float(v.detach()) for k, v in losses.items()}
        rec["total_loss"] = float(total.detach())
        diag = {k: int(v) for k, v in out["diag"].items()}
        self._account(rec, diag)
        return {"losses": rec, "diag": diag}

    # -- epochs -------------------------------------------------------------
    def _reset_epoch_stats(self) -> None:
        self._agg: dict = {}
        self._diag: dict = {}
        self._nsteps = 0
        self._t0 = time.time()

    def _account(self, rec: dict, diag: dict) -> None:
        for k, v in rec.items():
            self._agg[k] = self._agg.get(k, 0.0) + v
        for k, v in diag.items():
            self._diag[k] = max(self._diag.get(k, 0), v)  # worst step of the epoch
        self._nsteps += 1
        self.pos += 1
        self.global_step += 1
        if self.pos >= self.data.steps_per_epoch():
            self._end_epoch()

    def _end_epoch(self) -> None:
        n = max(self._nsteps, 1)
        dt = time.time() - self._t0
        record = {f"train/{k}": v / n for k, v in self._agg.items()}
        record.update({f"diag/{k}": v for k, v in self._diag.items()})
        record.update(epoch=self.epoch, lr=self.lr(), epoch_time=dt,
                      scenes_per_sec=self._nsteps * self.cfg.batch_size / max(dt, 1e-9))
        overflows = {k: v for k, v in self._diag.items() if v > 0}
        if overflows:
            print(f"[epoch {self.epoch}] WARNING capacity overflow (raise caps.*): "
                  f"{overflows}", flush=True)
        if self.out_dir:
            os.makedirs(self.out_dir, exist_ok=True)
            with open(os.path.join(self.out_dir, "metrics.jsonl"), "a") as f:
                f.write(json.dumps(record) + "\n")
        print(f"[epoch {self.epoch}] " + " ".join(
            f"{k.split('/')[-1]}={v:.4f}" for k, v in record.items() if k.startswith("train/"))
            + f" lr={record['lr']:.2e}", flush=True)
        self.epoch += 1
        self.pos = 0
        self._reset_epoch_stats()

    # -- checkpoints ----------------------------------------------------------
    def save_checkpoint(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        torch.save({"model_name": self.cfg.MODEL, "model": self.model.state_dict(),
                    "optimizer": self.opt.state_dict(),
                    "epoch": self.epoch, "pos": self.pos, "global_step": self.global_step,
                    "generator": self.generator.get_state()}, path)
        return path

    def load_checkpoint(self, path: str) -> None:
        ck = torch.load(path, map_location=self.device, weights_only=True)
        name = ck.get("model_name", "PointGroup")   # written since HAIS/SoftGroup training
        if name != self.cfg.MODEL:
            raise ValueError(f"checkpoint {path} holds a {name} model, this trainer trains "
                             f"{self.cfg.MODEL}")
        self.model.load_state_dict(ck["model"])
        self.opt.load_state_dict(ck["optimizer"])
        self.epoch, self.pos, self.global_step = ck["epoch"], ck["pos"], ck["global_step"]
        self.generator.set_state(ck["generator"].cpu())
        self._reset_epoch_stats()


def param_snapshot(model: torch.nn.Module) -> dict:
    """Host copies of the trainable parameters (for change checks). The
    batch-norm buffers are left out: every training forward moves them,
    so they would show a change even where no optimizer step was taken."""
    return {k: v.detach().cpu().numpy().copy() for k, v in model.named_parameters()}


def max_param_change(before: dict, model: torch.nn.Module) -> float:
    after = param_snapshot(model)
    return max(float(np.abs(after[k] - before[k]).max()) for k in before)
