"""Cosine learning-rate decay: the port of minsu3d_tpu/util/lr_decay.py
(reference minsu3d/util/lr_decay.py:7-12): flat until ``start_epoch``, then
a half cosine from ``base_lr`` down to ``clip``."""

from __future__ import annotations

from math import cos, pi


def cosine_lr(base_lr: float, current_epoch: int, start_epoch: int,
              total_epochs: int, clip: float = 1e-6) -> float:
    if current_epoch < start_epoch:
        return base_lr
    span = max(total_epochs - start_epoch, 1)
    return clip + 0.5 * (base_lr - clip) * (1 + cos(pi * (current_epoch - start_epoch) / span))
