"""Train batches: the seeded scene order of
minsu3d_tpu/data/datamodule.py::train_batches (:46-81) for one device,
collated at the train caps with the host-built grid plan.

Every augmentation draw of an item comes from a generator seeded with
(global_train_seed, epoch, scene index), so a run is reproducible; the JAX
package draws from an unseeded ``np.random.default_rng()``. Items are built
on the calling thread, one batch at a time (no prefetch yet).
"""

from __future__ import annotations

import numpy as np

from minsu3d_tpu_torch.config import TrainConfig, backbone_caps
from minsu3d_tpu_torch.data.batching import collate, train_caps
from minsu3d_tpu_torch.data.dataset import synthetic_train_scenes, train_item


class TrainData:
    """The train split (``scenes``: (scan_id, normalized scene) pairs,
    default the synthetic train scenes of ``cfg``)."""

    def __init__(self, cfg: TrainConfig, scenes: list | None = None):
        self.cfg = cfg
        self.scenes = synthetic_train_scenes(cfg) if scenes is None else scenes
        self.plan = (backbone_caps(cfg, "train"), len(cfg.net.blocks))

    def steps_per_epoch(self) -> int:
        return max(len(self.scenes) // self.cfg.batch_size, 1)

    def order(self, epoch: int) -> np.ndarray:
        """Scene indices of the epoch, ``batch_size`` per step."""
        bs, n = self.cfg.batch_size, len(self.scenes)
        rng = np.random.default_rng(self.cfg.global_train_seed + epoch)
        order = rng.permutation(n)
        if n < bs:  # tiny datasets: sample with replacement
            order = rng.choice(n, bs * self.steps_per_epoch())
        return order

    def batch(self, epoch: int, indices) -> dict:
        """Collated numpy batch of the scenes ``indices``."""
        items = []
        for i in indices:
            scan_id, scene = self.scenes[int(i)]
            rng = np.random.default_rng([self.cfg.global_train_seed, epoch, int(i)])
            items.append(train_item(self.cfg, scene, scan_id, rng))
        return collate(items, train_caps(self.cfg), self.plan)
