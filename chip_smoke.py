#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each followed by a ``# phase <name> <seconds>`` line:
  device   require CUDA; print the card's name and power limit (nvidia-smi)
  build    g++ host library and the nvcc kernel library, started together
  kernels  every kernel of the inference paths against its plain PyTorch
           version on the card, at main-path shapes, seeded inputs:
           gather_gemm (K1) at every distinct conv shape of the PointGroup
           (m=16) and HAIS (m=32) eval backbones, one timed shape per level;
           ball_query_edge (K2) and connected_components (K3) bit for bit,
           including an input made to overflow the edge buffer;
           segment_reduce (K6) on the unit table of a val scene and on a
           heads forward's 2N rows, proposal_voxelize (K7) on the PointGroup
           and HAIS heads' rows, set_aggregation (K8) on 16384 clusters x
           512 primaries, unit_compact (K9) on a val scene's unit labels and
           on random labels with many equal sizes: all bit for bit; times by
           CUDA events; stable_partition (K10) bit for bit on the class-major
           (point, class) flags of a SoftGroup val scene fed injected
           ground-truth backbone outputs (fewer trues than the cap: the false
           tail) and on flags with more trues than the cap (pairs dropped),
           proposal_rank (K11) bit for bit on that scene's clusters and on
           random classes and sizes with many equal keys; both timed beside
           torch.argsort(stable=True)
  train_kernels
           the training slice's kernels at the training recipe's shapes
           (131072-voxel caps, batch of 2 augmented train scenes):
           gather_wgrad (the conv weight gradient; subm level 0 and 3, one
           down, one up conv) within 1e-5 of the output scale, and
           proposal_iou bit for bit, on the proposal rows of a heads forward
  instance_kernels
           the mask-filtered proposal_iou (K5 with a row mask) and mask_label
           (K12, both phases and phase 1 alone) bit for bit against their
           plain versions, on the inputs that HAIS's and SoftGroup's losses
           give them in a full-width heads-on train step on injected
           ground-truth backbone outputs (196608 rows, 128 x 64 IoUs), on an
           empty row mask, and on crafted IoUs (ties, exact 0.5s, a masked
           maximum, an all-zero proposal whose column 0 is masked, invalid
           rows that read proposal P-1); times beside the masked max/argmax
           and row gathers that K12 replaces
  small    the full model at a small size on the card against the same
           model on the CPU (plain versions), same seeded weights
  small_train
           one small train step on the card against the CPU: losses, every
           parameter gradient and the Adam update with the heads off; with
           them on (injected ground-truth backbone outputs, same jitter):
           proposals, score_loss and the heads' and point features' gradients
  small_instance_train
           HAIS's (mask IoU and mask filter on) and SoftGroup's heads-on train
           step at a small size, card against CPU, same weights, injected
           outputs and jitter: proposal rows bit for bit, losses and the
           gradients of the heads and the point features within 1e-4 of scale
  heads_parity
           PointGroup's, HAIS's and SoftGroup's heads at full size on one val
           scene, on the card and on the CPU, same weights, same injected
           backbone outputs (ground truth plus seeded numpy noise that makes
           HAIS fragments, kept fragments and absorbed fragments): proposal
           rows (invalid rows included), n_proposals, every diag counter, the
           rows' cells, occupancy and volumes bit for bit; proposal, mask,
           class and IoU scores within 1e-5 of their scale
  train_repeat
           one heads-on train step at full width, twice from the same state
           and generator: every gradient and the Adam update bit for bit;
           then the heads-on backward with cuDNN's deterministic algorithms
           off and on (in turns), and a probe that names any op torch still
           flags as non-deterministic
  gt_train_repeat
           HAIS's and SoftGroup's full-width heads-on train step whose heads
           read injected ground-truth classes and offsets beside the
           backbone's own point features (seeded weights find no proposal),
           twice from the same state: proposals found, finite losses, every
           gradient (backbone included) and the Adam update bit for bit, and
           torch's deterministic-algorithms probe flags no op
  main     PointGroupNet at full width (m=16, 7 levels, 2 reps) on seeded
           weights through ``minsu3d_tpu_torch.test.evaluate`` on the 3
           synthetic val scenes of the golden eval config; the inference
           kernels' launch counts must move
  hais     HAISNet at full width (m=32, TinyUnet S=20) on seeded weights
           through ``evaluate`` on the 3 val scenes of the golden HAIS eval
           config (scripts/eval_synth_hais.sh, f32, epoch 100); K1-K3 and
           K6-K9 must each launch; outputs of their shapes and finite. The
           seeded backbone's random classes overflow the cluster cap and
           leave no proposal, so the heads also run, timed and with their
           launches counted apart (``launches_hais_gt_heads``), on the 3
           scenes fed ground-truth backbone outputs: there K2-K3 and K6-K9
           must launch on real rows (proposals found, fragments absorbed)
           and no overflow counter may move
  softgroup
           SoftGroupNet at full width (m=32, packed soft grouping, S=20) on
           seeded weights through ``evaluate`` on the 3 val scenes of the
           golden SoftGroup eval config (scripts/eval_synth_softgroup.sh,
           f32), then its heads on the 3 scenes fed ground-truth backbone
           outputs, launches counted apart (``launches_softgroup_gt_heads``):
           there K2-K3, K6-K7 and K9-K11 must launch on real rows (proposals
           found), no overflow counter may move, and every output is finite
           and of the JAX model's shape
  kernels_bf16
           K1's bf16 variant at every distinct conv shape of both eval
           backbones against its plain version (within one bf16 ulp of the
           larger magnitude, a cancelling sum within 1e-5 of the scale,
           under 1% of the elements differing), each shape timed beside its
           plain version and its bound (bf16 bytes over 3.35 TB/s or the
           live pairs' flops over 989 TFLOP/s); K7's bf16 placement on the
           bf16 HAIS and SoftGroup heads' rows and K6's bf16 max and min at
           the HAIS roipool's shape, bit for bit, timed; and
           ``global_avg_pool`` (K6's sum and a division; no model calls it)
           at that shape, card against CPU bit for bit, timed
  heads_parity_bf16
           heads_parity in bf16 (precision=bfloat16, injected bf16 point
           features): rows, diag, cells, occupancy and the bf16 volumes bit
           for bit card vs CPU; the scores and the TinyUnet's output on those
           volumes within 2e-2 of their scale (cuDNN's and the CPU's bf16
           conv3d round some outputs one ulp apart); HAIS's proposal scores
           on the proposals whose rows pass its mask filter alike (rows that
           flip must sit within 2e-2 of the filter's threshold)
  bf16_inference
           the main path of the bf16 slice: HAIS, SoftGroup and PointGroup
           through ``evaluate`` at full width with precision=bfloat16, the 3
           val scenes, launch counts reset just before each run and read
           just after: K1's and K7's bf16 variants must launch and their f32
           versions not; per-scene ms beside the f32 run of this call; every
           diag counter equal to the f32 run's but those that follow the
           seeded backbone's random classes; then the heads on the 3 scenes
           fed ground-truth outputs, bf16 against f32 with the same weights:
           proposals and diag equal, no overflow, AP printed
  train    the training recipe at full width (scripts/train_synth_pointgroup.sh,
           f32): 2 steps with the heads off (epoch 0) and 2 with them on
           (epoch 1, prepare_epochs=0), a checkpoint saved after step 1 and
           loaded into a second trainer, whose step 2 must equal the first
           trainer's; every kernel of the training path must launch
  train_hais, train_softgroup
           the same for HAIS (scripts/train_synth_hais2.sh, the mask IoU and
           mask filter on from epoch 1) and SoftGroup
           (scripts/train_synth_softgroup.sh); K12 must launch on both, K10
           and K11 on SoftGroup's; each step is timed in parts (host input,
           forward with the losses, backward, Adam), the card synchronised
  bf16_train_kernel_checks
           the bf16 backward's kernels at the training recipes' shapes (a
           batch of 2 augmented full-width train scenes, PointGroup m=16 and
           HAIS m=32): gather_dx_bf16 (K13) at every conv shape of both
           training backbones' backward (subm, tail, down, up) bit for bit;
           gather_wgrad's bf16 variant (K4) at four shapes of each within one
           bf16 ulp, the differing share printed; segment_reduce's bf16 sum
           (K6) at the devoxelization and the point-feature gather into the
           proposal rows, bit for bit; each timed beside its plain version,
           its bound and (K6) index_add_
  small_bf16_train_check
           one small bf16 heads-on train step of PointGroup and of HAIS
           (ground-truth classes and offsets beside the backbone's point
           features, ``Trainer.forward_gt``) on the card against the CPU:
           proposals equal, losses, every gradient and the Adam update within
           tests/test_torch_bf16_train.py's rules (a gradient against its
           bf16 noise, measured by the CPU's f32 step of the same state)
  bf16_train_repeat
           gt_train_repeat in bf16 for PointGroup and HAIS at full width:
           every gradient and parameter after Adam bit-identical in the
           repeated step, no op flagged by torch's determinism probe
  bf16_train_main
           the three training recipes at full width in bf16 (precision=
           bfloat16, as every train_synth_*.sh runs), as ``train``: steps 1-2
           heads off, 3-4 heads on, finite losses, a checkpoint round trip;
           K1, K4 and K7 run only their bf16 variants, K13 and K6's bf16 sum
           must launch; the median ms of each part beside the f32 steps of
           this call
Then a ``{"kernels": [...]}`` line (K1-K13 and the bf16 variants of K1, K4,
K6 and K7; K6's bf16 max and min run on no model path and ride in the bf16
sum's entry) and, only on success, the last line ``{"ok": true, "device":
{...}}``. Any failure raises (exit code != 0).
Imports only the standard library, numpy, torch and minsu3d_tpu_torch.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from minsu3d_tpu_torch.config import (EvalConfig, HaisEvalConfig, HaisTrainConfig,
                                      SoftGroupEvalConfig, SoftGroupTrainConfig, StaticCaps,
                                      TrainConfig, backbone_caps)
from minsu3d_tpu_torch.csrc import build
from minsu3d_tpu_torch.data.batching import collate, eval_caps
from minsu3d_tpu_torch.data.datamodule import TrainData
from minsu3d_tpu_torch.data.dataset import eval_item, synthetic_val_scenes
from minsu3d_tpu_torch.evaluation.instance_segmentation import (GeneralDatasetEvaluator,
                                                                get_gt_instances)
from minsu3d_tpu_torch.model import general_model as gm
from minsu3d_tpu_torch.model import hais, pointgroup, softgroup
from minsu3d_tpu_torch.model.registry import get_model
from minsu3d_tpu_torch.ops import (ballquery, cluster, instance_iou, proposal_rank,
                                   proposal_voxelize, segment, set_aggregation, sparse_conv,
                                   stable_partition)
from minsu3d_tpu_torch.ops.sparse import plan_from_batch
from minsu3d_tpu_torch.test import (SCORE_KEYS, batch_to_torch, collated_scenes, evaluate,
                                    injected_backbone_outputs, out_to_numpy, seeded_model,
                                    set_f32_numerics)
from minsu3d_tpu_torch.trainer.trainer import Trainer, max_param_change, param_snapshot

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM bf16, dense tensor cores
K1_RTOL = 1e-5              # f32 sums in another order than the plain matmul
# bf16 heads, card against CPU, on the same bf16 proposal volumes: cuDNN's
# bf16 conv3d and the CPU's round some outputs one bf16 ulp (2^-8 to 2^-7
# of a value) apart, and those ulps travel through the TinyUnet's 18 convs
# into the heads; on the CPU the port's bf16 heads stay within 1.5e-2 of
# the JAX package's scale (tests/test_torch_bf16.py)
BF16_HEADS_RTOL = 2e-2
K4_RTOL = 1e-5              # f32 sums in another order than the plain einsum
# one train step, card against CPU: the card's kernels sum in other orders
# (K1, K4, cuDNN-free torch reductions); measured on the CPU against JAX the
# port's gradients agree to 2e-6 of their scale, so 1e-4 leaves room for
# the deeper sums of the card without hiding a wrong tap or index
TRAIN_RTOL = 1e-4
GRAD_FLOOR = 0.01           # a gradient that is 0 in exact arithmetic reads noise
RESUME_RTOL = 1e-5          # step after a checkpoint round trip
SMALL_TRAIN = {"net.m": 8, "net.blocks": [1, 2, 3], "net.block_reps": 1,
               "caps.points": 16384, "caps.voxels": 32768, "caps.clusters": 128,
               "caps.proposals": 64, "caps.neighbors": 16, "caps.cell_window": 16,
               "synthetic.train_scenes": 2, "synthetic.num_objects": 5,
               "synthetic.points_per_object": 600, "synthetic.floor_points": 3000}
# the training phase: the recipe at full width, 4 train scenes (2 steps per
# epoch), heads on from epoch 1 (HAIS's mask IoU and mask filter too)
MAIN_TRAIN = {"synthetic.train_scenes": 4, "net.prepare_epochs": 0}
TRAIN_CONFIGS = {"PointGroup": TrainConfig, "HAIS": HaisTrainConfig,
                 "SoftGroup": SoftGroupTrainConfig}
# the kernels that a training path in each precision does not run: HAIS's
# set aggregation (using_set_aggr_in_training is False), K6's bf16 max and
# min (no model reduces bf16 rows with them), and the other precision's
# variants of K1, K4 and K7 and the bf16 backward's K13 and K6 bf16 sum
BF16_TRAIN_KERNELS = ("gather_gemm_bf16", "gather_dx_bf16", "gather_wgrad_bf16",
                      "segment_reduce_bf16_sum", "proposal_voxelize_bf16")
NOT_IN_ANY_TRAIN = ("set_aggregation", "segment_reduce_bf16")
NOT_IN_TRAIN_OF = {"float32": NOT_IN_ANY_TRAIN + BF16_TRAIN_KERNELS,
                  "bfloat16": NOT_IN_ANY_TRAIN + ("gather_gemm", "gather_wgrad",
                                                  "proposal_voxelize")}
# a bf16 train step, card against CPU (tests/test_torch_bf16_train.py's
# rules): losses within BF16_LOSS_RTOL of at least 0.1; each gradient
# tensor's relative L2 gap within NOISE_FACTOR times its bf16 noise (the
# CPU's bf16 gradient against the CPU's f32 one) plus BF16_GRAD_RTOL and
# below GAP_CAP, its norm within NORM_RATIO of the CPU's (a zeroed, flipped
# or halved gradient fails whatever the noise); a tensor that is 0 in
# exact arithmetic below ZERO_GRAD; the Adam update held exactly on at
# least ADAM_AGREE of the entries whose CPU gradient exceeds 1e-3
BF16_LOSS_RTOL = 5e-3
NOISE_FACTOR = 4.0
BF16_GRAD_RTOL = 1e-2
GAP_CAP = 0.9
NORM_RATIO = 1.5
ADAM_AGREE = 0.8
ZERO_GRAD = 1e-5
# and the kernels each training path does not run besides
NOT_IN_TRAIN = {"PointGroup": ("stable_partition", "proposal_rank", "mask_label"),
                "HAIS": ("stable_partition", "proposal_rank"), "SoftGroup": ()}
# the small HAIS / SoftGroup heads-on check: the small train scenes' objects
# hold ~600 points, so a class's mean instance size is taken as 500
SMALL_PNA = {"point_num_avg": (-1.0, -1.0) + (500.0,) * 18}


def phase(name: str, t0: float) -> float:
    now = time.perf_counter()
    print(f"# phase {name} {now - t0:.3f}", flush=True)
    return now


def cuda_ms(fn, reps: int = 10) -> float:
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


def bound_ms(n_bytes: float, flops: float, peak_flops: float = F32_FLOPS) -> tuple:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def live_rows(idx, n: int) -> tuple:
    """What a gather over ``idx`` must touch: the live (row, tap) pairs, the
    distinct rows of x that some live pair reads, and the rows of idx with
    at least one live tap. The bounds count only these rows (a capped
    level's padding rows are never read)."""
    live = (idx >= 0) & (idx < n)
    x_rows = int(torch.unique(idx[live]).numel())
    return int(live.sum()), x_rows, int(live.any(1).sum())


def bf16_ulp(mag: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each magnitude (8 significant bits); 0 at 0."""
    return torch.where(mag > 0, torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8),
                       torch.zeros_like(mag))


def bf16_gap(got: torch.Tensor, want: torch.Tensor) -> dict:
    """How two bf16 results of the same f32 sums differ: the share of
    elements that differ, the share beyond one bf16 ulp of the larger
    magnitude, and the largest such gap over the output's scale."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    beyond = diff > bf16_ulp(torch.maximum(g.abs(), w.abs()))
    scale = max(float(w.abs().max()), 1.0)
    return {"differ_share": float((diff > 0).float().mean()),
            "beyond_ulp_share": float(beyond.float().mean()),
            "beyond_ulp_err": float(diff[beyond].max()) / scale if bool(beyond.any()) else 0.0}


def check_gather_gemm(name: str, x, idx, w, timed: bool = True) -> dict:
    """K1 against its plain version; returns the record of this shape
    (times and bound only when ``timed``). f32: within K1_RTOL of the output
    scale. bf16: every element within one bf16 ulp of the larger magnitude,
    except where a sum cancels (far smaller than its terms): there the two
    f32 sums, added in other orders, may round two ulps apart, and the gap
    must stay within K1_RTOL of the scale; fewer than 1% of the elements
    differ. The bound counts bf16 bytes and the bf16 tensor-core rate."""
    got = sparse_conv.gather_gemm(x, idx, w)
    want = sparse_conv.gather_gemm_plain(x, idx, w)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    rec = {"shape": name, "dtype": str(x.dtype).replace("torch.", ""), "max_abs_err": err,
           "scale": scale}
    if x.dtype == torch.bfloat16:
        rec.update(bf16_gap(got, want))
        ok = rec["beyond_ulp_err"] <= K1_RTOL and rec["differ_share"] < 0.01
    else:
        ok = err <= K1_RTOL * max(scale, 1.0)
    if not (math.isfinite(err) and ok):
        raise AssertionError(f"gather_gemm {name}: {rec}")
    if timed:
        live, x_rows, _ = live_rows(idx, x.shape[0])
        nb = x.element_size() * (x_rows * x.shape[1] + w.numel() + idx.shape[0] * w.shape[2])
        peak = BF16_FLOPS if x.dtype == torch.bfloat16 else F32_FLOPS
        b_ms, b_by = bound_ms(nb + 4 * idx.numel(), 2.0 * live * w.shape[1] * w.shape[2], peak)
        rec.update(ms=cuda_ms(lambda: sparse_conv.gather_gemm(x, idx, w)),
                   plain_ms=cuda_ms(lambda: sparse_conv.gather_gemm_plain(x, idx, w)),
                   bound_ms=b_ms, bound_by=b_by, live_pairs=live, x_rows_read=x_rows,
                   x_rows=x.shape[0])
    print(f"# gather_gemm {json.dumps(rec)}", flush=True)
    return rec


def k1_every_width(dev, dtype=torch.float32) -> list:
    """K1 at every distinct conv shape (kind, level, Cin, Cout) of the
    PointGroup (m=16) and HAIS (m=32) eval backbones, on each recipe's own
    plan of its first val scene: the input conv, each level's subm conv and
    its tail's first subm conv over the skip concat (2w -> w), and the down
    and up convs between levels, in ``dtype`` (inputs and weights rounded
    to it). In f32 the subm conv of each level is timed, in bf16 every
    shape."""
    g = torch.Generator(device="cpu").manual_seed(3)
    recs = []
    every = dtype != torch.float32
    for cfg in (EvalConfig(), HaisEvalConfig()):
        _, batch = next(collated_scenes(cfg))
        plan, _, _ = plan_from_batch(batch_to_torch(batch, dev), len(cfg.net.blocks))
        m, blocks = cfg.net.m, cfg.net.blocks
        widths = [m * b for b in blocks]

        def rnd(*shape, fan):
            return ((torch.rand(shape, generator=g) * 2 - 1) * (6 / fan) ** 0.5).to(dev, dtype)

        for lvl, w in enumerate(widths):
            lv = plan.levels[lvl]
            tag = f"{cfg.MODEL} L{lvl} ({lv.cap} rows)"
            x_w = rnd(lv.cap, w, fan=1)
            if lvl == 0:
                cin = cfg.net.input_channel
                recs.append(check_gather_gemm(f"{tag} input 27x{cin} -> {m}",
                                              rnd(lv.cap, cin, fan=1), lv.nbr_idx,
                                              rnd(27, cin, m, fan=27 * cin), every))
            recs.append(check_gather_gemm(f"{tag} subm 27x{w} -> {w}", x_w, lv.nbr_idx,
                                          rnd(27, w, w, fan=27 * w), True))
            if lvl + 1 == len(widths):
                continue
            parent, w2 = plan.levels[lvl + 1], widths[lvl + 1]
            lk = sparse_conv.links(lv, parent.cap)
            recs.append(check_gather_gemm(f"{tag} tail 27x{2 * w} -> {w}",
                                          rnd(lv.cap, 2 * w, fan=1), lv.nbr_idx,
                                          rnd(27, 2 * w, w, fan=54 * w), every))
            recs.append(check_gather_gemm(f"{tag} down 8x{w} -> {w2}", x_w, lk.down,
                                          rnd(8, w, w2, fan=8 * w), every))
            recs.append(check_gather_gemm(f"{tag} up 8x{w2} -> {w}", rnd(parent.cap, w2, fan=1),
                                          lk.up, rnd(8, w2, w, fan=8 * w2), every))
    if every:
        print(f"# gather_gemm {dtype}: {len(recs)} shapes of both eval backbones within one "
              f"bf16 ulp (cancelling sums within {K1_RTOL} of their scale); differing share "
              f"at most {max(r['differ_share'] for r in recs):.3e}, beyond one ulp at most "
              f"{max(r['beyond_ulp_share'] for r in recs):.3e}", flush=True)
    else:
        print(f"# gather_gemm: {len(recs)} shapes of both eval backbones within "
              f"{K1_RTOL} of their scale", flush=True)
    return recs


def kernel_checks(cfg: EvalConfig, dev) -> list:
    g = torch.Generator(device="cpu").manual_seed(0)
    scan_id, scene = synthetic_val_scenes(cfg)[0]
    batch = collate([eval_item(cfg, scene, scan_id)], eval_caps(cfg),
                    (backbone_caps(cfg), len(cfg.net.blocks)))
    tb = batch_to_torch(batch, dev)
    plan, _, _ = plan_from_batch(tb, len(cfg.net.blocks))
    m = cfg.net.m

    def rnd(*shape, scale=1.0):
        return ((torch.rand(shape, generator=g) * 2 - 1) * scale).to(dev)

    lv0, lv1, lv3 = plan.levels[0], plan.levels[1], plan.levels[3]
    k1 = [
        check_gather_gemm("subm L0 (98304, 27x16 -> 16)", rnd(lv0.cap, m),
                          lv0.nbr_idx, rnd(27, m, m, scale=(6 / (27 * m)) ** 0.5)),
        check_gather_gemm("subm L3 (12288, 27x64 -> 64)", rnd(lv3.cap, 4 * m),
                          lv3.nbr_idx, rnd(27, 4 * m, 4 * m, scale=(6 / (108 * m)) ** 0.5)),
        check_gather_gemm("down L0->L1 (8x16 -> 32)", rnd(lv0.cap, m),
                          sparse_conv.down_index(lv0, lv1.cap), rnd(8, m, 2 * m)),
        check_gather_gemm("up L1->L0 (8x32 -> 16)", rnd(lv1.cap, 2 * m),
                          sparse_conv.up_index(lv0, lv1.cap), rnd(8, 2 * m, m)),
    ]

    # K2/K3 on the main path's unit graph: (voxel, class) units of the scene
    # with ground-truth classes standing in for predictions
    caps = StaticCaps.from_cfg(cfg)
    sem = tb["sem_labels"].long()
    obj = tb["point_mask"] & (sem >= len(cfg.ignore_classes))
    units, _ = gm.make_units(tb["p2v"], sem.clamp(min=0), obj, caps.cluster_units)
    u_coords, u_batch, u_active, u_group, uid, u_counts = cluster.unit_table(
        tb["point_xyz"], tb["vert_batch_ids"], obj, sem.clamp(min=0), units,
        caps.cluster_units)
    k, window = max(caps.neighbors // 2, 8), max(caps.window // 4, 8)
    radius = cfg.net.cluster_radius
    perm, starts, run_len, point_base, total = ballquery.runs(
        u_coords, u_batch, u_active, radius, window, caps.half_space, u_group)
    r2 = float(torch.tensor(radius * radius, dtype=torch.float32))
    r2_t = torch.tensor(r2, dtype=torch.float32)
    args = (u_coords, perm, starts, run_len, point_base)
    total = int(total)
    for edge_cap in (caps.edge_factor * caps.cluster_units, total // 2):
        got = ballquery.ball_query_scan(*args, k, window, edge_cap, r2)
        want = ballquery.scan_plain(*args, k, window, edge_cap, r2_t)
        if not torch.equal(got, want):
            raise AssertionError(f"ball_query_edge differs (edge_cap {edge_cap}): "
                                 f"{int((got != want).sum())} slots")
        print(f"# ball_query_edge edge_cap={edge_cap} candidates={total} "
              f"edges_dropped={max(total - edge_cap, 0)} equal", flush=True)
    if total // 2 >= total:
        raise AssertionError("overflow input did not overflow the edge buffer")
    edge_cap = caps.edge_factor * caps.cluster_units
    n_u, n_off = starts.shape
    nb = (n_u * 12 + n_u * 4 + 2 * n_u * n_off * 4 + n_u * 8 + n_u * k * 4)
    b_ms, b_by = bound_ms(nb, 9.0 * min(total, edge_cap))
    nbr = ballquery.ball_query_scan(*args, k, window, edge_cap, r2)
    k2 = {"max_abs_err": 0.0,
          "ms": cuda_ms(lambda: ballquery.ball_query_scan(*args, k, window, edge_cap, r2)),
          "plain_ms": cuda_ms(lambda: ballquery.scan_plain(*args, k, window, edge_cap, r2_t)),
          "bound_ms": b_ms, "bound_by": b_by,
          "shape": f"{n_u} units x {n_off} cells x window {window}, K {k}"}

    nbr_valid = nbr < n_u
    lab_k, unconv_k = cluster.connected_components_cuda(nbr, nbr_valid, u_active, u_group,
                                                        caps.cc_iters)
    lab_p, unconv_p = cluster.connected_components_plain(nbr, nbr_valid, u_active, u_group,
                                                         caps.cc_iters)
    if not torch.equal(lab_k, lab_p) or unconv_k != unconv_p:
        raise AssertionError(f"connected_components differs: {int((lab_k != lab_p).sum())}")
    n_comp = int(((lab_k == torch.arange(n_u, device=dev)) & u_active).sum())
    print(f"# connected_components units={int(u_active.sum())} components={n_comp} "
          f"equal", flush=True)
    nb = n_u * k * 5 + n_u * (1 + 4 + 4)
    b_ms, b_by = bound_ms(nb, 0.0)
    k3 = {"max_abs_err": 0.0,
          "ms": cuda_ms(lambda: cluster.connected_components_cuda(
              nbr, nbr_valid, u_active, u_group, caps.cc_iters)),
          "plain_ms": cuda_ms(lambda: cluster.connected_components_plain(
              nbr, nbr_valid, u_active, u_group, caps.cc_iters)),
          "bound_ms": b_ms, "bound_by": b_by, "shape": f"{n_u} units x K {k}"}
    return k1, k2, k3, (lab_k, uid, u_counts)


def _bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (f32 compared as int32 and bf16 as int16, so
    -0.0 != +0.0)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    if a.dtype == torch.bfloat16:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a, b)


def check_segment_reduce(name: str, x, csr, op: str, fill=0) -> dict:
    """K6 against its plain version, bit for bit; library call: index_add_
    (sum) or scatter_reduce (max/min) of the same rows, in another order.
    The CSR's build (a stable sort and a search, index preparation) is timed
    apart from the reduction."""
    got = segment.segment_reduce(x, csr, op, fill)
    want = segment.segment_reduce_plain(x, csr, op, fill)
    if not _bit_equal(got, want):
        raise AssertionError(f"segment_reduce {name}: differs from its plain version in "
                             f"{int((got != want).sum())} of {got.numel()} entries")
    n_seg, c = csr.num_segments, x.shape[1]
    rows = int(csr.offsets[-1])
    nb = x.element_size() * (rows * c + n_seg * c) + 4 * (rows + n_seg + 1)
    b_ms, b_by = bound_ms(nb, float(rows * c))
    seg = csr.seg

    def library():
        if op == "sum":
            return torch.zeros((n_seg + 1, c), dtype=x.dtype, device=x.device).index_add_(0, seg, x)
        return torch.full((n_seg + 1, c), fill, dtype=x.dtype, device=x.device).scatter_reduce_(
            0, seg[:, None].expand_as(x), x, reduce="a" + op, include_self=True)

    rec = {"shape": name, "dtype": str(x.dtype).replace("torch.", ""), "max_abs_err": 0.0,
           "rows": rows, "segments": n_seg,
           "ms": cuda_ms(lambda: segment.segment_reduce(x, csr, op, fill)),
           "csr_ms": cuda_ms(lambda: segment.segment_csr(seg, n_seg)),
           "plain_ms": cuda_ms(lambda: segment.segment_reduce_plain(x, csr, op, fill), 3),
           "library_ms": cuda_ms(library), "bound_ms": b_ms, "bound_by": b_by,
           "longest_segment": int((csr.offsets[1:] - csr.offsets[:-1]).max())}
    print(f"# segment_reduce {json.dumps(rec)}", flush=True)
    return rec


def check_voxelize(name: str, model, tb: dict, out: dict, flags: dict) -> dict:
    """K7 against its plain version on the rows of a heads forward, bit for
    bit: volume, occupancy, row cells and winners' cells."""
    cfg, caps = model.cfg, model.caps
    (v_scale, s), rows, p_cap = voxel_params(cfg), out["proposal_rows"], caps.proposals
    xyz = tb["point_xyz"]
    pidx, pid, valid, mean, scale, offset = gm.voxelization_placement(rows, p_cap, xyz, v_scale,
                                                                      s)
    f = segment.gather_rows(out["point_features"], pidx)
    f = torch.where(valid[:, None], f, torch.zeros_like(f))
    args = (f, xyz, pidx, pid, valid, mean, scale, offset, p_cap, s)
    got = proposal_voxelize.place_cuda(*args)
    want = proposal_voxelize.place_plain(*args)
    for part, k, w in zip(("volume", "occ", "row_cell", "cell_w"), got, want):
        if not _bit_equal(k, w):
            raise AssertionError(f"proposal_voxelize {name}: {part} differs from the plain "
                                 "version")
    n_rows, n_valid, n_win = f.shape[0], int(valid.sum()), int((got[3] < got[1].numel()).sum())
    if n_win == 0:
        raise AssertionError(f"proposal_voxelize {name}: no row won a cell")
    c, esize = f.shape[1], f.element_size()
    # every row's valid flag, each valid row's two ids and its point's
    # coords, and the winners' feature rows read once; the per-proposal
    # mean, scale and offset; the volume, occupancy and the two per-row
    # cell arrays written once
    nb = (n_rows + n_valid * (8 + 12) + n_win * esize * c + 4 * p_cap * 7
          + got[0].numel() * esize + got[1].numel() + 8 * n_rows)
    b_ms, b_by = bound_ms(nb, 9.0 * n_valid)
    rec = {"shape": name, "dtype": str(f.dtype).replace("torch.", ""), "max_abs_err": 0.0,
           "rows": f.shape[0], "valid_rows": n_valid,
           "winners": n_win, "cells": got[1].numel(), "channels": c,
           "ms": cuda_ms(lambda: proposal_voxelize.place_cuda(*args)),
           "plain_ms": cuda_ms(lambda: proposal_voxelize.place_plain(*args)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    print(f"# proposal_voxelize {json.dumps(rec)}", flush=True)
    return rec


def check_set_aggregation(dev) -> dict:
    """K8 against its plain version, bit for bit, on 16384 clusters (most of
    them fragments) and a full 512-slot primary table in a 10 x 10 x 3 m
    room, 18 classes, one batch, exact ties included."""
    g = torch.Generator().manual_seed(6)
    n_c, n_p, p_cap = 16384, 512, 128
    room = torch.tensor([10.0, 10.0, 3.0])
    centers = torch.rand((n_c, 3), generator=g) * room
    cls = torch.randint(2, 20, (n_c,), generator=g, dtype=torch.int32)
    cbatch = torch.zeros(n_c, dtype=torch.int32)
    primary = torch.zeros(n_c, dtype=torch.bool)
    primary[torch.randperm(n_c, generator=g)[:n_p]] = True
    fragment = ~primary & (torch.rand(n_c, generator=g) < 0.95)
    prim_prop = torch.where(primary, torch.randint(0, p_cap, (n_c,), generator=g),
                            torch.full((n_c,), p_cap))
    r_cls = torch.full((n_c,), 0.7)
    centers_p, cls_p = centers[primary], cls[primary]
    centers_p[1], cls_p[1] = centers_p[0], cls_p[0]       # an exact tie
    args = [centers, cls, cbatch, fragment, primary, prim_prop, r_cls, centers_p, cls_p,
            torch.zeros(n_p, dtype=torch.int32),
            torch.randint(900, 6000, (n_p,), generator=g).float(),
            torch.randint(0, p_cap, (n_p,), generator=g), torch.ones(n_p, dtype=torch.bool)]
    args = [a.to(dev) for a in args] + [p_cap]
    got = set_aggregation.set_aggregation_cuda(*args)
    want = set_aggregation.set_aggregation_plain(*args)
    if not torch.equal(got, want):
        raise AssertionError(f"set_aggregation differs from its plain version in "
                             f"{int((got != want).sum())} of {n_c} clusters")
    n_frag, n_prim = int(fragment.sum()), int(primary.sum())
    absorbed = int((args[3] & (got < p_cap)).sum())
    if absorbed == 0:
        raise AssertionError("set_aggregation: no fragment was absorbed")
    # a distance (3 sub, 3 mul, 2 add, a compare) only for the live primaries
    # of a fragment's class and batch, one compare for each other pair
    same = torch.zeros((2 ** 16,), dtype=torch.int64)
    key_p = args[8].cpu().long() * 256 + args[9].cpu().long()
    same.index_add_(0, key_p, args[12].cpu().long())
    key_f = (cls.long() * 256 + cbatch.long())[fragment]
    matched = int(same[key_f].sum())
    flops = 9.0 * matched + (n_frag * n_p - matched)
    # every cluster's two flags; a fragment's centre, class, batch and
    # radius; a primary's proposal; the primary table once; the output
    nb = (n_c * 2 + n_frag * (12 + 4 + 4 + 4) + n_prim * 8
          + n_p * (12 + 4 + 4 + 4 + 8 + 1) + 4 * n_c)
    b_ms, b_by = bound_ms(nb, flops)
    rec = {"shape": f"{n_c} clusters x {n_p} primaries", "max_abs_err": 0.0,
           "fragments": n_frag, "matched_pairs": matched, "absorbed": absorbed,
           "ms": cuda_ms(lambda: set_aggregation.set_aggregation_cuda(*args)),
           "plain_ms": cuda_ms(lambda: set_aggregation.set_aggregation_plain(*args)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    print(f"# set_aggregation {json.dumps(rec)}", flush=True)
    return rec


def check_unit_compact(name: str, label, uid, counts, c_cap: int) -> dict:
    """K9 against its plain version, bit for bit."""
    u = label.shape[0]
    got = cluster.unit_points_compact_cuda(label, uid, u, c_cap, counts)
    want = cluster.unit_points_compact_plain(label, uid, u, c_cap, counts)
    for part, k, w in zip(("point_cluster", "sizes", "count", "seg_sizes"), got, want):
        if not torch.equal(k, w):
            raise AssertionError(f"unit_compact {name}: {part} differs from the plain version")
    count = int(got[2])
    sizes = want[3][:count]
    ties = count - int(torch.unique(sizes).numel())
    nb = 4 * (2 * u + 2 * uid.shape[0] + c_cap)
    b_ms, b_by = bound_ms(nb, 0.0)
    rec = {"shape": name, "max_abs_err": 0.0, "units": u, "components": count,
           "tied_sizes": ties, "points": uid.shape[0],
           "ms": cuda_ms(lambda: cluster.unit_points_compact_cuda(label, uid, u, c_cap, counts)),
           "plain_ms": cuda_ms(lambda: cluster.unit_points_compact_plain(label, uid, u, c_cap,
                                                                        counts)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    print(f"# unit_compact {json.dumps(rec)}", flush=True)
    return rec


@contextlib.contextmanager
def capture(module, name: str):
    """Within the block, record the arguments of every call of
    ``module.name`` (a kernel wrapper as the model calls it) and call it
    through: the main path's own inputs for a kernel check."""
    calls, orig = [], getattr(module, name)

    def spy(*args, **kwargs):
        calls.append((*args, *kwargs.values()))
        return orig(*args, **kwargs)

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def voxel_params(cfg) -> tuple:
    """(scale, side S) of the model's proposal volumes."""
    if cfg.MODEL == "SoftGroup":
        return cfg.net.instance_voxel_cfg.scale, cfg.net.instance_voxel_cfg.spatial_shape
    return cfg.net.score_scale, cfg.net.score_fullscale


def output_shapes(cfg, n: int, p: int) -> dict:
    """The JAX model's output shapes at n points and p proposals."""
    shapes = {"point_features": (n, cfg.net.m), "semantic_scores": (n, cfg.classes),
              "point_offsets": (n, 3)}
    if cfg.MODEL == "SoftGroup":
        k1 = cfg.classes - len(cfg.ignore_classes) + 1
        shapes.update(mask_scores=(2 * n, k1), cls_scores=(p, k1), iou_scores=(p, k1))
    else:
        shapes["proposal_scores"] = (p,)
        if cfg.MODEL == "HAIS":
            shapes["mask_scores"] = (2 * n,)
    return shapes


def check_stable_partition(name: str, flags, cap: int) -> dict:
    """K10 against its plain version, bit for bit; library call: the stable
    descending argsort of the flags (the same permutation, uncut)."""
    got = stable_partition.stable_partition_cuda(flags, cap)
    want = stable_partition.stable_partition_plain(flags, cap)
    if not (torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])):
        raise AssertionError(f"stable_partition {name}: differs from its plain version")
    n, n_true = flags.shape[0], int(want[1])
    # every flag byte read once; the order and the count written once
    b_ms, b_by = bound_ms(n + 4 * min(cap, n) + 4, 0.0)
    rec = {"shape": f"{name}: {n} flags, cap {cap}", "max_abs_err": 0.0, "n_true": n_true,
           "pairs_dropped": max(n_true - cap, 0),
           "ms": cuda_ms(lambda: stable_partition.stable_partition_cuda(flags, cap)),
           "plain_ms": cuda_ms(lambda: stable_partition.stable_partition_plain(flags, cap)),
           "library_ms": cuda_ms(lambda: torch.argsort(flags, descending=True, stable=True)),
           "bound_ms": b_ms, "bound_by": b_by}
    print(f"# stable_partition {json.dumps(rec)}", flush=True)
    return rec


def check_proposal_rank(name: str, ccls, sizes, valid, pna_fg, npoint_thr: float, limit: int,
                        p_cap: int, pc, pair_valid) -> dict:
    """K11 against its plain version, bit for bit; library call: the stable
    argsort of the clusters' keys where(ok, ccls, k)."""
    args = (ccls, sizes, valid, pna_fg, npoint_thr, limit, p_cap, pc, pair_valid)
    got = proposal_rank.proposal_rank_cuda(*args)
    want = proposal_rank.proposal_rank_plain(*args)
    for part, k_, w in zip(("prop_id", "valid", "n_proposals"), got, want):
        if not torch.equal(k_, w):
            raise AssertionError(f"proposal_rank {name}: {part} differs from its plain version")
    c_cap, k, n_pairs = ccls.shape[0], pna_fg.shape[0], pc.shape[0]
    thr = torch.tensor(npoint_thr, dtype=torch.float32, device=ccls.device) * pna_fg[
        ccls.long().clamp(0, k - 1)]
    ok = valid & (sizes.to(torch.float32) >= thr)
    key = torch.where(ok, ccls.long(), torch.full_like(ccls.long(), k))
    n_ok = int(ok.sum())
    # int32 class, size and a valid byte per cluster, the class table, int32
    # cluster id and a flag per pair read once; an int32 id and a flag per
    # pair and the count written once. Operations: a threshold product and
    # k + 1 key compares per cluster, one lookup per pair
    nb = 9 * c_cap + 4 * k + 10 * n_pairs + 4
    b_ms, b_by = bound_ms(nb, float(c_cap * (k + 2) + n_pairs))
    rec = {"shape": f"{name}: {c_cap} clusters, {n_pairs} pairs", "max_abs_err": 0.0,
           "ok_clusters": n_ok, "tied_keys": n_ok - int(torch.unique(key[ok]).numel()),
           "n_proposals": int(want[2]), "valid_rows": int(want[1].sum()),
           "ms": cuda_ms(lambda: proposal_rank.proposal_rank_cuda(*args)),
           "plain_ms": cuda_ms(lambda: proposal_rank.proposal_rank_plain(*args)),
           "library_ms": cuda_ms(lambda: torch.argsort(key, stable=True)),
           "bound_ms": b_ms, "bound_by": b_by}
    print(f"# proposal_rank {json.dumps(rec)}", flush=True)
    return rec


def softgroup_kernel_checks(dev) -> dict:
    """K10 and K11 on the inputs the SoftGroup heads give them on a val scene
    fed injected ground-truth backbone outputs, and on made-up inputs that
    drop pairs (K10) and tie many keys (K11)."""
    cfg = SoftGroupEvalConfig()
    with capture(softgroup, "stable_partition") as k10_calls, \
            capture(softgroup, "proposal_rank") as k11_calls:
        _, _, out, _ = heads_on_scene(cfg, 4, dev)
    if int(out["proposal_rows"]["n_proposals"]) == 0 or len(k10_calls) != 1:
        raise AssertionError("softgroup kernels: the injected scene made no proposal")
    flags, cap = k10_calls[0]
    k10 = [check_stable_partition("main path class-major flags", flags, cap)]
    g = torch.Generator().manual_seed(8)
    many = (torch.rand(flags.shape[0], generator=g) < 0.3).to(dev)
    k10.append(check_stable_partition("random flags, 30% true", many, cap))
    if not k10[0]["n_true"] < cap < k10[1]["n_true"]:
        raise AssertionError("stable_partition: the two inputs should fall on both sides of "
                             f"the cap: {k10[0]['n_true']}, {k10[1]['n_true']}, cap {cap}")
    k11 = [check_proposal_rank("main path", *k11_calls[0])]
    c_cap, k, n_pairs, p_cap = 16384, 18, cap, 128
    valid = torch.arange(c_cap) < 9000
    ccls = torch.where(valid, torch.randint(0, 3, (c_cap,), generator=g),
                       torch.full((c_cap,), -1)).to(torch.int32)
    pna = torch.tensor([100.0, 333.0, 3000.0])[torch.randint(0, 3, (k,), generator=g)]
    thr = torch.tensor(0.05) * pna[ccls.long().clamp(0, k - 1)]
    sizes = (torch.ceil(thr) + torch.randint(-1, 2, (c_cap,), generator=g)).long()
    pc = torch.randint(0, c_cap + 1, (n_pairs,), generator=g)
    pair_valid = torch.rand(n_pairs, generator=g) < 0.9
    k11.append(check_proposal_rank("random, 3 classes", ccls.to(dev), sizes.to(dev),
                                   valid.to(dev), pna.to(dev), 0.05, p_cap, p_cap, pc.to(dev),
                                   pair_valid.to(dev)))
    return {"stable_partition": k10, "proposal_rank": k11}


def heads_on_scene(cfg, seed: int, device, epoch: int = 100) -> tuple:
    """(model, torch batch, heads output, flags) of a seeded model's heads
    on the first val scene with ``injected_backbone_outputs`` (point
    features in the config's compute dtype), in eval mode."""
    _, batch = next(collated_scenes(cfg))
    model = seeded_model(cfg, seed, device)
    tb = batch_to_torch(batch, device)
    inj = injected_backbone_outputs(batch, cfg.classes, cfg.net.m, seed, device,
                                    gm.compute_dtype(cfg))
    flags = get_model(cfg.MODEL).forward_flags(cfg, epoch, False)
    with torch.no_grad():
        out = model.heads(tb, inj, **flags)
    out["point_features"] = inj["point_features"]
    return model, tb, out, flags


def new_kernel_checks(dev, k3_graph: tuple) -> dict:
    """K6-K9 at the main paths' shapes; returns their records."""
    cfg = EvalConfig()
    caps = StaticCaps.from_cfg(cfg)
    model, tb, out, flags = heads_on_scene(cfg, 4, dev)
    # K6 on the unit table of the val scene (65536 units)
    sem = tb["sem_labels"].long()
    obj = tb["point_mask"] & (sem >= len(cfg.ignore_classes))
    units, _ = gm.make_units(tb["p2v"], sem.clamp(min=0), obj, caps.cluster_units)
    u_cap = caps.cluster_units
    uid = torch.where(obj & (units < u_cap), units, torch.full_like(units, u_cap))
    csr = segment.segment_csr(uid, u_cap)
    xyz = tb["point_xyz"]
    k6 = [check_segment_reduce(f"unit table ({xyz.shape[0]} points -> {u_cap} units, 4 ch)",
                               torch.cat([xyz, torch.ones_like(xyz[:, :1])], 1), csr, "sum"),
          check_segment_reduce("unit table batch/group max (int32, 2 ch)",
                               torch.stack([tb["vert_batch_ids"], sem.to(torch.int32)], 1),
                               csr, "max", -1)]
    # K6 on a heads forward's 2N rows: gather_rows' backward (rows -> points)
    # and roipool (rows -> proposals)
    rows = out["proposal_rows"]
    g = torch.Generator().manual_seed(7)
    cot = torch.randn((rows["point_idx"].shape[0], cfg.net.m), generator=g).to(dev)
    k6.append(check_segment_reduce(
        f"heads 2N rows -> N points ({rows['point_idx'].shape[0]} x {cfg.net.m})", cot,
        segment.segment_csr(rows["point_idx"], xyz.shape[0]), "sum"))
    pid = torch.where(rows["valid"], rows["prop_id"], torch.full_like(rows["prop_id"],
                                                                       caps.proposals))
    k6.append(check_segment_reduce(
        f"heads roipool 2N rows -> {caps.proposals} proposals ({cfg.net.m} ch)", cot,
        segment.segment_csr(pid, caps.proposals), "max", 0.0))
    # K7 on the PointGroup and HAIS heads' rows
    hcfg = HaisEvalConfig()
    hmodel, htb, hout, _ = heads_on_scene(hcfg, 4, dev)
    k7 = [check_voxelize(f"PointGroup {rows['point_idx'].shape[0]} rows -> {caps.proposals}"
                         f"x{cfg.net.score_fullscale}^3", model, tb, out, flags),
          check_voxelize(f"HAIS {hout['proposal_rows']['point_idx'].shape[0]} rows -> "
                         f"{hmodel.caps.proposals}x{hcfg.net.score_fullscale}^3", hmodel, htb,
                         hout, {})]
    k8 = check_set_aggregation(dev)
    # K9 on the val scene's unit labels (K3 on the unit graph of the kernel
    # phase) and on random min-index labels with many equal sizes
    label, uid_g, counts = k3_graph
    k9 = [check_unit_compact(f"val scene units ({label.shape[0]}), c_cap {caps.clusters}",
                             label, uid_g, counts, caps.clusters)]
    u = label.shape[0]
    comp = torch.randint(0, 20000, (u,), generator=g)
    active = torch.rand(u, generator=g) < 0.8
    first = torch.full((20000,), u, dtype=torch.int64)
    first.scatter_reduce_(0, comp[active], torch.arange(u)[active], reduce="amin")
    rlabel = torch.where(active, first[comp], torch.full_like(comp, u))
    rcounts = torch.where(active, torch.randint(1, 4, (u,), generator=g), 0)
    ruid = torch.randint(0, u + 1, (131072,), generator=g)
    k9.append(check_unit_compact(f"random labels ({u} units, ~20000 components), c_cap "
                                 f"{caps.clusters}", rlabel.to(dev), ruid.to(dev),
                                 rcounts.to(dev), caps.clusters))
    return {"segment_reduce": k6, "proposal_voxelize": k7, "set_aggregation": [k8],
            "unit_compact": k9}


def heads_parity(dev, precision: str = "float32") -> dict:
    """PointGroup's, HAIS's and SoftGroup's heads on the card against the
    CPU; see the module docstring. In bf16 the scores are held to
    BF16_HEADS_RTOL, and so is the TinyUnet alone on the (bit-identical)
    volumes; returns each model's largest err/scale."""
    rtol = 1e-5 if precision == "float32" else BF16_HEADS_RTOL
    worst = {}
    for base in (EvalConfig(), HaisEvalConfig(), SoftGroupEvalConfig()):
        cfg = base.with_overrides({"precision": precision})
        res = {d: heads_on_scene(cfg, 5, d) for d in ("cpu", dev)}
        (m_c, tb_c, oc, _), (m_k, tb_k, ok, _) = res["cpu"], res[dev]
        name = cfg.MODEL if precision == "float32" else f"{cfg.MODEL} {precision}"
        rc, rk = oc["proposal_rows"], ok["proposal_rows"]
        if int(rc["n_proposals"]) != int(rk["n_proposals"]) or int(rc["n_proposals"]) == 0:
            raise AssertionError(f"heads_parity {name}: proposals CPU {int(rc['n_proposals'])} "
                                 f"card {int(rk['n_proposals'])}")
        for f in ("point_idx", "prop_id", "valid"):
            if not torch.equal(rc[f], rk[f].cpu()):
                raise AssertionError(f"heads_parity {name}: proposal rows differ in {f} "
                                     f"({int((rc[f] != rk[f].cpu()).sum())} rows)")
        diag = {k: (int(v), int(ok["diag"][k])) for k, v in oc["diag"].items()}
        if any(a != b for a, b in diag.values()) or oc["diag"].keys() != ok["diag"].keys():
            raise AssertionError(f"heads_parity {name}: diag CPU vs card {diag}")
        vox = []
        for tb, o in ((tb_c, oc), (tb_k, ok)):
            with torch.no_grad():
                vox.append(gm.clusters_voxelization_dense(
                    o["proposal_rows"], cfg.caps.proposals, o["point_features"],
                    tb["point_xyz"], *voxel_params(cfg)))
        for part, a, b in zip(("volume", "occupancy", "row_cell"), *vox):
            if not _bit_equal(a, b.cpu()):
                raise AssertionError(f"heads_parity {name}: {part} differs")
        if vox[0][0].dtype != gm.compute_dtype(cfg) and precision != "float32":
            raise AssertionError(f"heads_parity {name}: volume in {vox[0][0].dtype}")
        pairs = [(key, oc[key], ok[key].cpu()) for key in SCORE_KEYS if key in oc]
        flipped = 0
        if precision != "float32" and cfg.MODEL == "HAIS":
            # HAIS's mask filter keeps a row's score feature where its mask
            # sigmoid is >= 0.5: a row whose mask logit sits at 0 can pass on
            # one device and not on the other, which moves its proposal's
            # roipool. Such rows must lie within rtol of the threshold; their
            # proposals leave the proposal-score comparison.
            flip = ((torch.sigmoid(oc["mask_scores"]) >= 0.5)
                    != (torch.sigmoid(ok["mask_scores"].cpu()) >= 0.5)) & rc["valid"]
            m_scale = max(float(oc["mask_scores"].abs().max()), 1.0)
            if not bool((oc["mask_scores"][flip].abs() <= rtol * m_scale).all()):
                raise AssertionError(f"heads_parity {name}: the mask filter differs on rows "
                                     f"away from its threshold")
            keep = torch.ones(cfg.caps.proposals, dtype=torch.bool)
            keep[rc["prop_id"][flip].long()] = False
            flipped = int(flip.sum())
            pairs = [(k, a[keep], b[keep]) if k == "proposal_scores" else (k, a, b)
                     for k, a, b in pairs]
        if precision != "float32":
            nets = [getattr(m, "score_net", None) or m.tiny_unet for m in (m_c, m_k)]
            with torch.no_grad():
                pairs.append(("tiny_unet", nets[0](vox[0][0], vox[0][1]),
                              nets[1](vox[1][0], vox[1][1]).cpu()))
        errs = {key: float((got - want).abs().max()) / max(float(want.abs().max()), 1.0)
                for key, want, got in pairs}
        if not max(errs.values()) <= rtol:
            raise AssertionError(f"heads_parity {name}: err/scale {errs} (limit {rtol}), "
                                 f"{flipped} rows' mask filter differs")
        worst[cfg.MODEL] = max(errs.values())
        kinds = {}
        if "cluster_kinds" in oc:
            kinds = {k: int(v) for k, v in ok["cluster_kinds"].items()}
            if kinds != {k: int(v) for k, v in oc["cluster_kinds"].items()}:
                raise AssertionError(f"heads_parity {name}: cluster kinds differ")
            if min(kinds[k] for k in ("fragment", "kept", "absorbed")) == 0:
                raise AssertionError(f"heads_parity {name}: the injected outputs made no "
                                     f"fragment, kept or absorbed cluster: {kinds}")
        print(f"# heads_parity {name}: {int(rc['n_proposals'])} proposals, "
              f"{int(rc['valid'].sum())} valid rows, {int(vox[0][1].sum())} occupied cells, "
              f"rows/cells/occupancy/volume bit-identical card vs CPU; diag "
              f"{ {k: v[0] for k, v in diag.items()} }; cluster kinds {kinds}; "
              f"scores err/scale {errs}"
              + (f"; {flipped} rows' mask filter differs at its threshold" if flipped else ""),
              flush=True)
    return worst


def train_repeat(dev) -> None:
    """One heads-on full-width train step, twice from the same state and
    generator: gradients and the Adam update bit for bit. Then the cost of
    cuDNN's deterministic algorithms on the heads-on backward, and a probe
    of torch's deterministic-algorithms mode."""
    cfg = TrainConfig().with_overrides(MAIN_TRAIN)
    data = TrainData(cfg)
    batch = data.batch(1, [0, 1])
    runs = []
    for _ in range(2):
        tr = Trainer(cfg, data, dev, seed=11)
        tr.epoch = 1
        tb = batch_to_torch(batch, dev)
        out, losses, total = tr.forward(tb)
        tr.backward(total)
        grads = {k: p.grad.detach().clone() for k, p in tr.model.named_parameters()
                 if p.grad is not None}
        tr.update()
        params = {k: p.detach().clone() for k, p in tr.model.named_parameters()}
        runs.append((grads, params, {k: float(v.detach()) for k, v in losses.items()},
                     int(out["proposal_rows"]["n_proposals"])))
    (g1, p1, l1, n1), (g2, p2, l2, n2) = runs
    if "score_loss" not in l1 or n1 == 0:
        raise AssertionError(f"train_repeat: the heads did not run ({n1} proposals)")
    if g1.keys() != g2.keys() or not any(k.startswith("score_net.") for k in g1):
        raise AssertionError("train_repeat: the two steps differ in which tensors got gradients")
    bad = [k for k in g1 if not _bit_equal(g1[k], g2[k])]
    bad += [f"param {k}" for k in p1 if not _bit_equal(p1[k], p2[k])]
    if bad or l1 != l2:
        raise AssertionError(f"train_repeat: the repeated step differs: {bad[:8]} losses "
                             f"{l1} vs {l2}")
    print(f"# train_repeat: {n1} proposals, losses {l1}; {len(g1)} gradients and "
          f"{len(p1)} parameters after Adam bit-identical in the repeated step", flush=True)

    times = {False: [], True: []}
    for det in (False, True, True, False, False, True):
        torch.backends.cudnn.deterministic = det
        out, losses, total = tr.forward(tb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.backward(total)
        torch.cuda.synchronize()
        times[det].append((time.perf_counter() - t0) * 1e3)
    torch.backends.cudnn.deterministic = True
    print(f"# train_repeat heads-on backward ms, cudnn.deterministic off {times[False]} "
          f"on {times[True]}", flush=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            out, losses, total = tr.forward(tb)
            tr.backward(total)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    flagged = sorted({str(w.message).split(".")[0][:160] for w in caught})
    print(f"# train_repeat deterministic-algorithms probe: {len(flagged)} ops flagged: "
          f"{flagged}", flush=True)


def inference_phase(cfg, dev, path: tuple) -> tuple:
    """The model of ``cfg`` at full width over the 3 val scenes through
    ``evaluate``, then its heads on the 3 scenes fed ground-truth backbone
    outputs; every kernel of ``path`` must launch in the first run, every one
    but K1 in the second. Returns (launches, launches on ground-truth
    outputs, the cluster kinds of each of those scenes, the metrics of
    ``evaluate``)."""
    name = cfg.MODEL.lower()
    model = seeded_model(cfg, 0, dev)
    flags = get_model(cfg.MODEL).forward_flags(cfg, 100, False)
    build.reset_launches()
    with capture(softgroup, "stable_partition") as packings:
        metrics = evaluate(cfg, model, dev, epoch=100)
    launches = dict(build.LAUNCHES)
    print(f"# {name}: seeded random weights, AP and mIoU carry no meaning", flush=True)
    if packings:
        print(f"# {name} active (point, class) pairs per scene "
              f"{[int(f.sum()) for f, _ in packings]} of cap {2 * cfg.caps.eval_points}",
              flush=True)
    print(f"# {name} per-scene ms {metrics['scene_ms']}", flush=True)
    print(f"# {name} proposals {metrics['proposals']} instances {metrics['n_instances']} "
          f"diag {metrics['diag']}", flush=True)
    print(f"# {name} AP {metrics['AP']} AP50 {metrics['AP_50']} AP25 {metrics['AP_25']} "
          f"semantic acc {metrics['semantic_accuracy']} mIoU "
          f"{metrics['semantic_mean_iou']}", flush=True)
    print(f"# {name} launches {launches}", flush=True)
    if len(metrics["scene_ms"]) != cfg.synthetic.val_scenes:
        raise AssertionError(f"{name}: not every val scene ran")
    for key in ("semantic_accuracy", "semantic_mean_iou"):
        if not math.isfinite(metrics[key]):
            raise AssertionError(f"{name}: {key} is not finite")
    missing = [k for k in path if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name} path never launched: {missing}")
    # The seeded backbone predicts a random class per point. HAIS's shifted
    # clustering then finds tens of thousands of one-unit components and no
    # proposal; the JAX HAIS counts every component beyond the cluster cap
    # (big_thre 1), and so does the port: clusters_dropped moves on seeded
    # weights (heads_parity holds the counter equal card vs CPU, the CPU
    # tests hold it equal to JAX). Seeded SoftGroup's softmax leaves few
    # pairs active. The heads' real work, and the overflow rule, are
    # therefore read on the 3 val scenes fed ground-truth backbone outputs:
    # objects as clusters, proposals, HAIS's absorbed fragments.
    check_outputs(cfg, model, dev, flags, overflow=False)
    build.reset_launches()
    kinds, heads_ms = [], []
    n, p = cfg.caps.eval_points, cfg.caps.proposals
    shapes = {k: v for k, v in output_shapes(cfg, n, p).items() if k in SCORE_KEYS}
    for i, (_, batch) in enumerate(collated_scenes(cfg)):
        tb = batch_to_torch(batch, dev)
        inj = injected_backbone_outputs(batch, cfg.classes, cfg.net.m, 20 + i, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            out = model.heads(tb, inj, **flags)
        torch.cuda.synchronize()
        heads_ms.append((time.perf_counter() - t1) * 1e3)
        n_props = int(out["proposal_rows"]["n_proposals"])
        kinds.append({k: int(v) for k, v in out.get("cluster_kinds", {}).items()})
        overflow = {k: int(v) for k, v in out["diag"].items() if int(v) != 0}
        bad = [k for k, shape in shapes.items()
               if tuple(out[k].shape) != shape or not bool(torch.isfinite(out[k]).all())]
        if overflow or n_props == 0 or bad:
            raise AssertionError(f"{name} scene {i} on ground-truth outputs: {n_props} "
                                 f"proposals, overflow {overflow}, malformed {bad}")
        print(f"# {name} scene {i} heads on ground-truth outputs: {n_props} proposals, "
              f"{int(out['proposal_rows']['valid'].sum())} valid rows, cluster kinds "
              f"{kinds[-1]}, no overflow counter moved, outputs of the JAX shapes and "
              f"finite", flush=True)
    gt_launches = dict(build.LAUNCHES)
    print(f"# {name} heads on ground-truth outputs: ms {heads_ms}, launches {gt_launches}",
          flush=True)
    missing = [k for k in path if gt_launches[k] == 0 and k != "gather_gemm"]
    if missing:
        raise AssertionError(f"{name} heads on ground-truth outputs: never launched {missing}")
    return launches, gt_launches, kinds, metrics


def check_gather_wgrad(name: str, x, idx, dout) -> dict:
    """K4 against its plain version; returns the record of this shape."""
    got = sparse_conv.gather_wgrad(x, idx, dout)
    want = sparse_conv.gather_wgrad_plain(x, idx, dout)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not (math.isfinite(err) and err <= K4_RTOL * max(scale, 1.0)):
        raise AssertionError(f"gather_wgrad {name}: max abs err {err} vs scale {scale}")
    if not torch.equal(got, sparse_conv.gather_wgrad(x, idx, dout)):
        raise AssertionError(f"gather_wgrad {name}: two launches differ (not deterministic)")
    live, x_rows, dout_rows = live_rows(idx, x.shape[0])
    nb = 4 * (x_rows * x.shape[1] + idx.numel() + dout_rows * dout.shape[1] + got.numel())
    b_ms, b_by = bound_ms(nb, 2.0 * live * x.shape[1] * dout.shape[1])
    rec = {"shape": name, "max_abs_err": err, "scale": scale,
           "ms": cuda_ms(lambda: sparse_conv.gather_wgrad(x, idx, dout)),
           "plain_ms": cuda_ms(lambda: sparse_conv.gather_wgrad_plain(x, idx, dout)),
           "bound_ms": b_ms, "bound_by": b_by, "live_pairs": live,
           "x_rows_read": x_rows, "x_rows": x.shape[0], "dout_rows_read": dout_rows,
           "dout_rows": dout.shape[0]}
    print(f"# gather_wgrad {json.dumps(rec)}", flush=True)
    return rec


def train_kernel_checks(dev) -> tuple:
    """K4 at the training recipe's conv shapes and K5 on the rows of a
    heads forward, on one batch of 2 augmented full-width train scenes."""
    cfg = TrainConfig()
    g = torch.Generator(device="cpu").manual_seed(1)
    data = TrainData(cfg.with_overrides({"synthetic.train_scenes": 2}))
    batch = data.batch(0, [0, 1])
    tb = batch_to_torch(batch, dev)
    plan, _, _ = plan_from_batch(tb, len(cfg.net.blocks))
    m = cfg.net.m

    def rnd(*shape):
        return (torch.rand(shape, generator=g) * 2 - 1).to(dev)

    lv0, lv1, lv3 = plan.levels[0], plan.levels[1], plan.levels[3]
    lk = sparse_conv.links(lv0, lv1.cap)
    c0, c3 = lv0.cap, lv3.cap
    k4 = [
        check_gather_wgrad(f"subm L0 ({c0}, 27x{m} -> {m})", rnd(c0, m), lv0.nbr_idx,
                           rnd(c0, m)),
        check_gather_wgrad(f"subm L3 ({c3}, 27x{4 * m} -> {4 * m})", rnd(c3, 4 * m),
                           lv3.nbr_idx, rnd(c3, 4 * m)),
        check_gather_wgrad(f"down L0->L1 (8x{m} -> {2 * m})", rnd(c0, m), lk.down,
                           rnd(lv1.cap, 2 * m)),
        check_gather_wgrad(f"up L1->L0 (8x{2 * m} -> {m})", rnd(lv1.cap, 2 * m), lk.up,
                           rnd(c0, m)),
    ]

    model = seeded_model(cfg, 0, dev, "train")
    with torch.no_grad():
        out = model.heads(tb, injected_backbone_outputs(batch, cfg.classes, m, 1, dev))
    rows, caps = out["proposal_rows"], model.caps
    args = (rows, caps.proposals, tb["instance_ids"], tb["instance_num_point"], caps.instances)
    got = instance_iou.get_iou(*args)
    want = instance_iou.get_iou_plain(*args)
    if not torch.equal(got, want):
        raise AssertionError(f"proposal_iou differs from its plain version in "
                             f"{int((got != want).sum())} of {got.numel()} cells")
    n_props, n_rows = int(rows["n_proposals"]), rows["valid"].shape[0]
    if n_props == 0 or not (got > 0).any():
        raise AssertionError("proposal_iou: the heads forward found no overlapping proposal")
    print(f"# proposal_iou rows={n_rows} valid={int(rows['valid'].sum())} proposals={n_props} "
          f"max_iou={float(got.max()):.4f} equal", flush=True)
    # bytes the function needs: every row's valid flag; point_idx and
    # prop_id of the valid rows; the instance id of each point they name;
    # the instance sizes; the output
    valid = rows["valid"]
    n_valid = int(valid.sum())
    n_points = int(torch.unique(rows["point_idx"][valid]).numel())
    nb = n_rows + 8 * n_valid + 4 * n_points + 4 * caps.instances + 4 * got.numel()
    b_ms, b_by = bound_ms(nb, 0.0)
    k5 = {"max_abs_err": 0.0, "ms": cuda_ms(lambda: instance_iou.get_iou(*args)),
          "plain_ms": cuda_ms(lambda: instance_iou.get_iou_plain(*args)),
          "bound_ms": b_ms, "bound_by": b_by,
          "shape": f"{n_rows} rows -> ({caps.proposals}, {caps.instances})"}
    return k4, k5


def small_check(dev) -> None:
    """Small model: the card's outputs against the CPU's (plain versions)."""
    cfg = EvalConfig().with_overrides({
        "net.m": 8, "net.blocks": [1, 2, 3], "net.block_reps": 1,
        "caps.eval_points": 16384, "caps.eval_voxels": 16384, "caps.clusters": 128,
        "caps.proposals": 64, "caps.neighbors": 16, "caps.cell_window": 16,
        "synthetic.val_scenes": 1, "synthetic.num_objects": 5,
        "synthetic.points_per_object": 600, "synthetic.floor_points": 3000})
    _, batch = next(collated_scenes(cfg))
    outs = {}
    for d in ("cpu", dev):
        model = seeded_model(cfg, 1, d)
        with torch.no_grad():
            out, _ = model.backbone_forward(batch_to_torch(batch, d))
        outs[str(d)] = {k: v.cpu() for k, v in out.items()}
    for key, cpu in outs["cpu"].items():
        gpu = outs[str(dev)][key]
        if gpu.shape != cpu.shape or not torch.isfinite(gpu).all():
            raise AssertionError(f"small {key}: shape {tuple(gpu.shape)} or non-finite")
        err = float((gpu - cpu).abs().max())
        if err > 1e-4 * max(float(cpu.abs().max()), 1.0):
            raise AssertionError(f"small {key}: card vs CPU max abs err {err}")
        print(f"# small {key} {tuple(gpu.shape)} card-vs-cpu max abs err {err:.3e}")


def _close_grads(tag: str, want: dict, got: dict) -> float:
    """Card gradients against CPU ones, each within TRAIN_RTOL of its
    tensor's scale (at least GRAD_FLOOR); returns the worst err/scale."""
    if want.keys() != got.keys() or not want:
        raise AssertionError(f"{tag}: card and CPU differ in which tensors got gradients")
    worst = 0.0
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        scale = max(float(w.abs().max()), GRAD_FLOOR)
        if not err <= TRAIN_RTOL * scale:
            raise AssertionError(f"{tag} grad {k}: card vs CPU max abs err {err}, scale {scale}")
        worst = max(worst, err / scale)
    return worst


def _close_losses(tag: str, want: dict, got: dict) -> None:
    for k, v in want.items():
        if not (math.isfinite(got[k]) and abs(got[k] - v) <= TRAIN_RTOL * max(abs(v), 1e-6)):
            raise AssertionError(f"{tag} {k}: card {got[k]} vs CPU {v}")


def small_train_check(dev) -> None:
    """One small train step with the heads off on the card against the CPU,
    same seeded weights and batch: losses, every parameter gradient, and the
    parameters after the Adam update. Then the heads on both devices in
    training mode from the same injected ground-truth backbone outputs and
    the same voxelization jitter: proposals, score_loss, and the gradients
    of the ScoreNet, the score branch and the point features."""
    cfg = TrainConfig().with_overrides(SMALL_TRAIN)
    data = TrainData(cfg)
    batch = data.batch(0, [0, 1])
    g = torch.Generator(device="cpu").manual_seed(2)
    injected = injected_backbone_outputs(batch, cfg.classes, cfg.net.m, 2, "cpu")
    jitter = gm.train_jitter(g)
    res = {}
    for d in ("cpu", dev):
        tr = Trainer(cfg, data, d, seed=5)
        before = {k: p.detach().cpu().clone() for k, p in tr.model.named_parameters()}
        tb = batch_to_torch(batch, d)
        _, losses, total = tr.forward(tb)
        tr.backward(total)
        grads = {k: p.grad.cpu() for k, p in tr.model.named_parameters() if p.grad is not None}
        tr.update()
        after = {k: p.detach().cpu().clone() for k, p in tr.model.named_parameters()}
        # the heads, training mode, on the injected backbone outputs
        tr.opt.zero_grad(set_to_none=True)
        tin = {k: v.to(d, copy=True) for k, v in injected.items()}
        tin["point_features"].requires_grad_()
        out = tr.model.heads(tb, tin, train=True, jitter=jitter)
        score = pointgroup.losses(cfg, tr.caps, tb, out, True)["score_loss"]
        score.backward()
        hgrads = {k: p.grad.cpu() for k, p in tr.model.named_parameters()
                  if k.startswith(("score_net.", "score_branch.")) and p.grad is not None}
        hgrads["point_features"] = tin["point_features"].grad.cpu()
        rows = {k: out["proposal_rows"][k].cpu() for k in ("point_idx", "prop_id", "valid")}
        res[str(d)] = dict(losses={k: float(v.detach()) for k, v in losses.items()},
                           grads=grads, before=before, after=after, hgrads=hgrads, rows=rows,
                           score=float(score.detach()),
                           n_props=int(out["proposal_rows"]["n_proposals"]))
    c, k = res["cpu"], res[str(dev)]
    _close_losses("small_train", c["losses"], k["losses"])
    worst = _close_grads("small_train", c["grads"], k["grads"])
    # Adam's first step moves a parameter by about lr * sign(grad); where the
    # gradient stands clear of the card-vs-CPU noise both devices must take
    # the same step, and nowhere may they differ by more than a sign flip
    lr = tr.lr()
    n_firm = 0
    for name, want in c["after"].items():
        b, got = c["before"][name], k["after"][name]
        if name not in c["grads"]:   # the heads' parameters: no gradient, no step
            if not (torch.equal(want, b) and torch.equal(got, b)):
                raise AssertionError(f"small_train update {name} moved without a gradient")
            continue
        gc = c["grads"][name].abs()
        tol = TRAIN_RTOL * (lr + b.abs())
        diff = (got - want).abs()
        firm = gc > 1e-3 * max(float(gc.max()), GRAD_FLOOR)
        if not bool((diff[firm] <= tol[firm]).all()):
            raise AssertionError(f"small_train update {name}: card vs CPU max diff "
                                 f"{float(diff[firm].max())} where the gradient is firm")
        if not bool(((want - b).abs()[firm] >= 0.5 * lr).all()):
            raise AssertionError(f"small_train update {name}: the CPU step did not move it")
        if not bool((diff <= 2 * lr + tol).all()):
            raise AssertionError(f"small_train update {name}: card vs CPU max diff "
                                 f"{float(diff.max())}")
        n_firm += int(firm.sum())
    print(f"# small_train heads off: losses card {k['losses']} cpu {c['losses']}; "
          f"{len(c['grads'])} gradients, worst card-vs-cpu err {worst:.3e} of scale; "
          f"Adam update equal on {n_firm} firm entries (lr {lr})", flush=True)
    if k["n_props"] != c["n_props"] or c["n_props"] == 0:
        raise AssertionError(f"small_train heads: proposals card {k['n_props']} "
                             f"CPU {c['n_props']}")
    for f in ("point_idx", "prop_id", "valid"):
        if not torch.equal(k["rows"][f], c["rows"][f]):
            raise AssertionError(f"small_train heads: proposal rows differ in {f}")
    _close_losses("small_train heads", {"score_loss": c["score"]}, {"score_loss": k["score"]})
    worst = _close_grads("small_train heads", c["hgrads"], k["hgrads"])
    if not float(c["hgrads"]["point_features"].abs().max()) > 0:
        raise AssertionError("small_train heads: no gradient reached the point features")
    print(f"# small_train heads on: {c['n_props']} proposals on both, score_loss card "
          f"{k['score']} cpu {c['score']}; {len(c['hgrads'])} gradients (score_net, "
          f"score_branch, point_features), worst card-vs-cpu err {worst:.3e} of scale",
          flush=True)


def train_config(model: str, **over):
    """``model``'s training recipe with MAIN_TRAIN's overrides and its epoch
    gates open from the first heads-on epoch (HAIS's mask IoU and mask
    filter)."""
    return TRAIN_CONFIGS[model]().with_overrides(
        {**MAIN_TRAIN, **get_model(model).open_gates, **over})


# the loss that shows a model's heads ran in a step
HEAD_LOSS = {"PointGroup": "score_loss", "HAIS": "mask_loss", "SoftGroup": "mask_scoring_loss"}


def train_main(dev, model: str = "PointGroup", precision: str = "float32") -> dict:
    """``model``'s training recipe at full width in ``precision``: steps 1-2
    heads off, 3-4 heads on, checkpoint after step 1; each step is
    ``Trainer.step``, the step that ``fit`` runs, timed in parts through its
    ``mark`` hook with the card synchronised after each (host input: next
    batch and copy to the card; forward with the losses; backward; Adam).
    Returns launches and step records."""
    cfg = train_config(model, precision=precision)
    data = TrainData(cfg)
    tag = f"train {model} {precision}"
    with tempfile.TemporaryDirectory() as tmp:
        build.reset_launches()
        a = Trainer(cfg, data, dev, out_dir=tmp)
        snap = param_snapshot(a.model)
        recs, ck = [], None
        for step in range(1, 5):
            heads = a.heads_active
            ends = {}

            def mark(part: str) -> None:
                torch.cuda.synchronize()
                ends[part] = time.perf_counter()

            t0 = time.perf_counter()
            rec = a.step(mark=mark)
            rec.update(step=step, heads=heads, ms=(ends["adam"] - t0) * 1e3)
            for part, start in (("host_input", t0), ("forward", ends["host_input"]),
                                ("backward", ends["forward"]), ("adam", ends["backward"])):
                rec[f"{part}_ms"] = (ends[part] - start) * 1e3
            recs.append(rec)
            print(f"# {tag} step {step} heads={int(heads)} ms {rec['ms']:.1f} (host input "
                  f"{rec['host_input_ms']:.1f}, forward {rec['forward_ms']:.1f}, backward "
                  f"{rec['backward_ms']:.1f}, Adam {rec['adam_ms']:.1f}) losses {rec['losses']} "
                  f"diag {rec['diag']}", flush=True)
            if step == 1:
                ck = a.save_checkpoint(os.path.join(tmp, "step1.pt"))
        launches = dict(build.LAUNCHES)
        moved = max_param_change(snap, a.model)
        b = Trainer(cfg, data, dev, seed=cfg.global_train_seed + 1)
        b.load_checkpoint(ck)
        resumed = b.step()["losses"]
        metrics = open(os.path.join(tmp, "metrics.jsonl")).read().splitlines()
    print(f"# {tag} launches {launches}", flush=True)
    head_loss = HEAD_LOSS[model]
    for rec in recs:
        if not all(math.isfinite(v) for v in rec["losses"].values()):
            raise AssertionError(f"{tag} step {rec['step']}: non-finite losses {rec['losses']}")
        if (head_loss in rec["losses"]) != rec["heads"]:
            raise AssertionError(f"{tag} step {rec['step']}: {head_loss} present "
                                 f"{head_loss in rec['losses']} with heads {rec['heads']}")
    if [r["heads"] for r in recs] != [False, False, True, True]:
        raise AssertionError(f"{tag}: head phases {[r['heads'] for r in recs]}")
    if not moved > 0:
        raise AssertionError(f"{tag}: the parameters did not change")
    want = recs[1]["losses"]
    for k, v in want.items():
        if not abs(resumed[k] - v) <= RESUME_RTOL * max(abs(v), 1e-6):
            raise AssertionError(f"{tag} resume: step 2 {k} {resumed[k]} after the round trip, "
                                 f"{v} without")
    print(f"# {tag} resume: step 2 after save/load {resumed} == {want}", flush=True)
    print(f"# {tag} max parameter change {moved:.4e}; metrics records {len(metrics)}",
          flush=True)
    skip = NOT_IN_TRAIN_OF[precision] + NOT_IN_TRAIN[model]
    missing = [k for k, v in launches.items() if v == 0 and k not in skip]
    if missing:
        raise AssertionError(f"{tag}: training path never launched: {missing}")
    other = [k for k in NOT_IN_TRAIN_OF[precision] if launches[k]]
    if other:
        raise AssertionError(f"{tag}: kernels of another precision or path launched: "
                             f"{ {k: launches[k] for k in other} }")
    return {"launches": launches, "steps": recs}


def step_parts_ms(recs: list) -> dict:
    """The median of each timed part over a train_main run's heads-off
    (steps 1-2) and heads-on (steps 3-4) steps."""
    keys = ("host_input_ms", "forward_ms", "backward_ms", "adam_ms", "ms")
    return {phase: {k: statistics.median(r[k] for r in recs if r["heads"] == on) for k in keys}
            for phase, on in (("heads_off", False), ("heads_on", True))}


def check_mask_iou(name: str, rows, p_cap: int, inst, num, i_cap: int, keep) -> dict:
    """K5 with a row mask against its plain version, bit for bit."""
    args = (rows, p_cap, inst, num, i_cap, keep)
    got = instance_iou.get_iou(*args)
    want = instance_iou.get_iou_plain(*args)
    if not _bit_equal(got, want):
        raise AssertionError(f"proposal_iou row_keep {name}: differs from its plain version in "
                             f"{int((got != want).sum())} of {got.numel()} cells")
    valid = rows["valid"]
    counted = valid & keep
    n_rows, n_valid, n_counted = valid.shape[0], int(valid.sum()), int(counted.sum())
    n_points = int(torch.unique(rows["point_idx"][counted]).numel())
    # every row's valid flag; the keep flag of the valid rows; point_idx and
    # prop_id of the counted rows; the instance id of each point they name;
    # the instance sizes; the output
    nb = n_rows + n_valid + 8 * n_counted + 4 * n_points + 4 * i_cap + 4 * got.numel()
    b_ms, b_by = bound_ms(nb, 0.0)
    rec = {"shape": f"{name}: {n_rows} rows ({n_valid} valid, {n_counted} kept) -> "
                    f"({p_cap}, {i_cap})",
           "max_abs_err": 0.0, "max_iou": float(got.max()),
           "ms": cuda_ms(lambda: instance_iou.get_iou(*args)),
           "plain_ms": cuda_ms(lambda: instance_iou.get_iou_plain(*args)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    print(f"# proposal_iou row_keep {json.dumps(rec)}", flush=True)
    return rec


def check_mask_label(name: str, rows, p_cap: int, inst_ids, inst_cls, ious, thr: float,
                     col_mask=None) -> dict:
    """K12 against its plain version, bit for bit: phases 1 and 2
    (``get_mask_label``), and phase 1 alone (``proposal_argmax``) over
    ``col_mask`` (default: the classes other than -1). Library call: the
    masked max/argmax and the two row gathers that the kernel replaces."""
    got = instance_iou.get_mask_label(rows, p_cap, inst_ids, inst_cls, ious, thr)
    want = instance_iou.get_mask_label_plain(rows, p_cap, inst_ids, inst_cls, ious, thr)
    for part, k, w in zip(("label", "row_ok"), got, want):
        if not torch.equal(k, w):
            raise AssertionError(f"mask_label {name}: {part} differs from its plain version in "
                                 f"{int((k != w).sum())} rows")
    col_mask = inst_cls != -1 if col_mask is None else col_mask
    a1 = instance_iou.proposal_argmax(ious, col_mask, thr)
    w1 = instance_iou.proposal_argmax_plain(ious, col_mask, thr)
    for part, k, w in zip(("max", "arg", "ok"), a1, w1):
        if not _bit_equal(k, w):
            raise AssertionError(f"mask_label phase 1 {name}: {part} differs from its plain "
                                 "version")
    valid, row_ok = rows["valid"], want[1]
    n_rows, n_valid, n_ok = valid.shape[0], int(valid.sum()), int(row_ok.sum())
    n_points = int(torch.unique(rows["point_idx"][row_ok]).numel())
    p, i = ious.shape
    # the IoUs and the column mask; every row's valid flag; prop_id of the
    # valid rows; point_idx of the supervised rows and the instance id of
    # each point they name; two bool outputs per row
    nb = 4 * p * i + i + n_rows + 4 * n_valid + 4 * n_ok + 4 * n_points + 2 * n_rows
    b_ms, b_by = bound_ms(nb, float(p * i))
    pid = rows["prop_id"].long().clamp(max=p_cap - 1)
    zero = torch.zeros((), device=ious.device)

    def library():
        mx, arg = torch.where(col_mask[None, :], ious, zero).max(dim=1)
        return (mx >= thr)[pid], arg[pid]

    args = (rows, p_cap, inst_ids, inst_cls, ious, thr)
    rec = {"shape": f"{name}: ({p}, {i}) IoUs, {n_rows} rows ({n_valid} valid, {n_ok} "
                    f"supervised, {int(want[0].sum())} labelled)",
           "max_abs_err": 0.0, "proposals_ok": int(w1[2].sum()),
           "ms": cuda_ms(lambda: instance_iou.get_mask_label(*args)),
           "phase1_ms": cuda_ms(lambda: instance_iou.proposal_argmax(ious, col_mask, thr)),
           "plain_ms": cuda_ms(lambda: instance_iou.get_mask_label_plain(*args)),
           "library_ms": cuda_ms(library), "bound_ms": b_ms, "bound_by": b_by}
    print(f"# mask_label {json.dumps(rec)}", flush=True)
    return rec


def crafted_ious(dev) -> tuple:
    """(ious (128, 64), column mask): proposal 0's unmasked IoUs are all 0
    and its column 0 is masked; 1 ties at columns 1 and 3; 2 is exactly 0.5;
    3's largest IoU lies in a masked column; 4 is the f32 below 0.5; 5 ties
    at 0.5; 6 is all zero; 7-127 lie on a grid of quarters (ties, 0.5s);
    proposal 127 passes the threshold in column 1 only."""
    below = torch.nextafter(torch.tensor(0.5), torch.tensor(0.0)).item()
    head = torch.tensor([[0.8, 0.0, 0.0, 0.0, 0.3], [0.1, 0.7, 0.2, 0.7, 0.0],
                         [0.0, 0.1, 0.5, 0.2, 0.0], [0.0, 0.3, 0.1, 0.2, 0.9],
                         [0.0, 0.1, below, 0.2, 0.0], [0.0, 0.1, 0.5, 0.5, 0.0],
                         [0.0] * 5])
    g = torch.Generator().manual_seed(9)
    ious = torch.randint(0, 5, (128, 64), generator=g).float() / 4
    ious[:7] = 0.0
    ious[:7, :5] = head
    ious[127] = 0.0
    ious[127, 1] = 0.75
    mask = torch.rand(64, generator=g) < 0.7
    mask[:5] = torch.tensor([False, True, True, True, False])
    return ious.to(dev), mask.to(dev)


def instance_kernel_checks(dev) -> dict:
    """K5 with a row mask and K12 on the inputs HAIS's and SoftGroup's losses
    give them in a full-width heads-on train step whose heads read injected
    ground-truth outputs (``Trainer.forward_gt``; HAIS with its mask IoU on),
    and on crafted IoUs (ties, exact 0.5s, masked maxima, invalid rows at
    proposal P-1)."""
    recs = {"mask_iou": [], "mask_label": []}
    for model, mod in (("HAIS", hais), ("SoftGroup", softgroup)):
        cfg = train_config(model, **{"synthetic.train_scenes": 2})
        tr = Trainer(cfg, TrainData(cfg), dev, seed=0)
        tr.epoch = 1
        batch = tr.data.batch(1, [0, 1])
        tb = batch_to_torch(batch, dev)
        inj = injected_backbone_outputs(batch, cfg.classes, cfg.net.m, 1, dev)
        with torch.no_grad(), capture(mod, "get_iou") as iou_calls, \
                capture(mod, "get_mask_label") as ml_calls:
            out, losses, _ = tr.forward_gt(tb, inj)
        n_props = int(out["proposal_rows"]["n_proposals"])
        masked = [c for c in iou_calls if len(c) > 5 and c[5] is not None]
        if n_props == 0 or len(masked) != 1 or len(ml_calls) != 1:
            raise AssertionError(f"instance kernels {model}: {n_props} proposals, "
                                 f"{len(masked)} masked IoUs, {len(ml_calls)} mask labels")
        print(f"# instance kernels {model}: {n_props} proposals, losses "
              f"{ {k: float(v) for k, v in losses.items()} }", flush=True)
        recs["mask_iou"].append(check_mask_iou(f"{model} main path", *masked[0]))
        rows, p_cap, inst_ids, inst_cls, ious, thr, _ = ml_calls[0]
        col = None
        if model == "SoftGroup":   # the classification labels' columns
            col = (inst_cls != -1) & tb["instance_mask"]
        recs["mask_label"].append(check_mask_label(f"{model} main path", rows, p_cap, inst_ids,
                                                   inst_cls, ious, thr, col))
        if model == "HAIS":
            keep = torch.zeros_like(rows["valid"])
            recs["mask_iou"].append(check_mask_iou("HAIS rows, nothing kept", rows, p_cap,
                                                   inst_ids, masked[0][3], masked[0][4], keep))
            cious, cmask = crafted_ious(dev)
            ccls = torch.where(cmask, torch.full_like(cmask, 3, dtype=torch.int32),
                               torch.full_like(cmask, -1, dtype=torch.int32))
            g = torch.Generator().manual_seed(10)
            prop = torch.randint(0, 171, (rows["valid"].shape[0],), generator=g)
            crows = {"point_idx": rows["point_idx"], "prop_id": prop.clamp(max=128).to(dev),
                     "valid": (prop < 128).to(dev), "n_proposals": torch.tensor(128)}
            cinst = torch.randint(-1, 64, (inst_ids.shape[0],), generator=g).to(dev)
            recs["mask_label"].append(check_mask_label("crafted IoUs, random rows", crows, 128,
                                                       cinst, ccls, cious, 0.5))
            arg = instance_iou.proposal_argmax(cious, cmask, 0.5)[1]
            if arg[:7].tolist() != [0, 1, 2, 1, 2, 2, 0]:
                raise AssertionError(f"mask_label crafted: argmax {arg[:7].tolist()}")
    return recs


def small_instance_train_check(dev) -> None:
    """HAIS's and SoftGroup's heads-on train step at a small size on the
    card against the CPU: the same seeded weights, batch, injected
    ground-truth backbone outputs (point features with a gradient) and
    jitter; HAIS with its mask IoU and mask filter on. Proposal rows bit for
    bit; losses and the gradients of every head parameter and of the point
    features within TRAIN_RTOL of their scale."""
    for model in ("HAIS", "SoftGroup"):
        cfg = TRAIN_CONFIGS[model]().with_overrides(
            {**SMALL_TRAIN, **SMALL_PNA, "net.prepare_epochs": 0,
             **get_model(model).open_gates})
        data = TrainData(cfg)
        batch = data.batch(0, [0, 1])
        injected = injected_backbone_outputs(batch, cfg.classes, cfg.net.m, 2, "cpu")
        jitter = gm.train_jitter(torch.Generator().manual_seed(2))
        res = {}
        for d in ("cpu", dev):
            tr = Trainer(cfg, data, d, seed=5)
            b = tr.bundle
            tb = batch_to_torch(batch, d)
            tin = {k: v.to(d, copy=True) for k, v in injected.items()}
            tin["point_features"].requires_grad_()
            out = tr.model.heads(tb, tin, train=True, jitter=jitter,
                                 **b.forward_flags(cfg, 1, True))
            losses = b.losses(cfg, tr.caps, tb, out, True, **b.loss_flags(cfg, 1))
            sum(losses.values()).backward()
            grads = {k: p.grad.cpu() for k, p in tr.model.named_parameters()
                     if p.grad is not None}
            grads["point_features"] = tin["point_features"].grad.cpu()
            res[str(d)] = dict(losses={k: float(v.detach()) for k, v in losses.items()},
                               grads=grads, n_props=int(out["proposal_rows"]["n_proposals"]),
                               rows={k: out["proposal_rows"][k].cpu()
                                     for k in ("point_idx", "prop_id", "valid")})
        c, k = res["cpu"], res[str(dev)]
        tag = f"small_instance_train {model}"
        if k["n_props"] != c["n_props"] or c["n_props"] == 0:
            raise AssertionError(f"{tag}: proposals card {k['n_props']} CPU {c['n_props']}")
        for f in ("point_idx", "prop_id", "valid"):
            if not torch.equal(k["rows"][f], c["rows"][f]):
                raise AssertionError(f"{tag}: proposal rows differ in {f}")
        _close_losses(tag, c["losses"], k["losses"])
        worst = _close_grads(tag, c["grads"], k["grads"])
        if not float(c["grads"]["point_features"].abs().max()) > 0:
            raise AssertionError(f"{tag}: no gradient reached the point features")
        print(f"# {tag}: {c['n_props']} proposals on both, losses card {k['losses']} cpu "
              f"{c['losses']}; {len(c['grads'])} gradients, worst card-vs-cpu err "
              f"{worst:.3e} of scale", flush=True)


def gt_train_repeat(model: str, dev, precision: str = "float32") -> dict:
    """One full-width heads-on train step in ``precision`` whose heads read
    injected ground-truth outputs (``Trainer.forward_gt``), twice from the
    same state and generator: proposals found, finite losses, every
    gradient and the parameters after Adam bit for bit; then the same step
    under torch's deterministic-algorithms probe, which must flag no op.
    Returns the launches of one step."""
    cfg = train_config(model, precision=precision)
    data = TrainData(cfg)
    batch = data.batch(1, [0, 1])
    inj = injected_backbone_outputs(batch, cfg.classes, cfg.net.m, 3, dev)
    tag = f"gt_train_repeat {model} {precision}"
    runs, launches = [], None
    for _ in range(2):
        tr = Trainer(cfg, data, dev, seed=11)
        tr.epoch = 1
        tb = batch_to_torch(batch, dev)
        build.reset_launches()
        t0 = time.perf_counter()
        out, losses, total = tr.forward_gt(tb, inj)
        tr.backward(total)
        grads = {k: p.grad.detach().clone() for k, p in tr.model.named_parameters()
                 if p.grad is not None}
        tr.update()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = launches or dict(build.LAUNCHES)
        params = {k: p.detach().clone() for k, p in tr.model.named_parameters()}
        runs.append((grads, params, {k: float(v.detach()) for k, v in losses.items()},
                     int(out["proposal_rows"]["n_proposals"]), ms,
                     {k: int(v) for k, v in out["diag"].items()}))
    (g1, p1, l1, n1, ms1, diag), (g2, p2, l2, n2, ms2, _) = runs
    if n1 == 0 or not all(math.isfinite(v) for v in l1.values()) or HEAD_LOSS[model] not in l1:
        raise AssertionError(f"{tag}: {n1} proposals, losses {l1}")
    if g1.keys() != g2.keys() or not any(k.startswith("backbone.") for k in g1):
        raise AssertionError(f"{tag}: the gradients do not reach the backbone, or the two "
                             "steps differ in which tensors got gradients")
    bad = [k for k in g1 if not _bit_equal(g1[k], g2[k])]
    bad += [f"param {k}" for k in p1 if not _bit_equal(p1[k], p2[k])]
    if bad or l1 != l2 or n1 != n2:
        raise AssertionError(f"{tag}: the repeated step differs: {bad[:8]} losses {l1} vs {l2}")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            out, losses, total = tr.forward_gt(tb, inj)
            tr.backward(total)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    flagged = sorted({str(w.message).split(".")[0][:160] for w in caught})
    if flagged:
        raise AssertionError(f"{tag}: torch's deterministic-algorithms probe flags {flagged}")
    print(f"# {tag}: {n1} proposals, {int(out['proposal_rows']['valid'].sum())} valid rows, "
          f"losses {l1}; diag {diag}; {len(g1)} gradients and {len(p1)} parameters after Adam "
          f"bit-identical in the repeated step; step ms {ms1:.1f}, {ms2:.1f}; "
          f"deterministic-algorithms probe: no op flagged; launches {launches}", flush=True)
    return launches


def bf16_kernel_checks(dev) -> dict:
    """The bf16 variants of K6 and K7 against their plain versions, bit for
    bit, timed: K7 places the bf16 point features of the HAIS and SoftGroup
    heads on a val scene fed injected ground-truth outputs (the main path's
    inputs). No model reduces bf16 rows with K6 (the JAX bf16 forward's
    roipool and SoftGroup pool read the TinyUnet's f32 output), so K6's bf16
    max and min run at the shape roipool has there: the HAIS heads' 2N rows
    x m channels into the proposals, on bf16 values with many ties."""
    k7, k6 = [], []
    for base in (HaisEvalConfig(), SoftGroupEvalConfig()):
        cfg = base.with_overrides({"precision": "bfloat16"})
        model, tb, out, flags = heads_on_scene(cfg, 4, dev)
        rows, (_, s) = out["proposal_rows"], voxel_params(cfg)
        k7.append(check_voxelize(f"{cfg.MODEL} bf16 {rows['point_idx'].shape[0]} rows -> "
                                 f"{model.caps.proposals}x{s}^3", model, tb, out, flags))
        if cfg.MODEL == "HAIS":
            p_cap, m = model.caps.proposals, cfg.net.m
            pid = torch.where(rows["valid"], rows["prop_id"],
                              torch.full_like(rows["prop_id"], p_cap))
            csr = segment.segment_csr(pid, p_cap)
            g = torch.Generator().manual_seed(9)
            x = (torch.randint(-64, 64, (pid.shape[0], m), generator=g) / 16.0).to(
                dev, torch.bfloat16)
            for op in ("max", "min"):
                k6.append(check_segment_reduce(
                    f"HAIS roipool shape, bf16 {op}: {pid.shape[0]} rows -> {p_cap} x {m}",
                    x, csr, op, 0.0))
    return {"segment_reduce_bf16": k6, "proposal_voxelize_bf16": k7}


def check_gather_dx(name: str, dout, idx_t, wt) -> dict:
    """K13 against its plain version, bit for bit; timed. Bound: the bf16
    bytes of the dout rows read, the weight and the output, the int32
    index, or the live pairs' flops at the bf16 tensor-core rate."""
    got = sparse_conv.gather_dx_bf16(dout, idx_t, wt)
    want = sparse_conv.gather_dx_bf16_plain(dout, idx_t, wt)
    torch.cuda.synchronize()
    if not _bit_equal(got, want):
        raise AssertionError(f"gather_dx_bf16 {name}: differs from its plain version in "
                             f"{int((got != want).sum())} of {got.numel()} elements")
    live, d_rows, _ = live_rows(idx_t, dout.shape[0])
    nb = 2 * (d_rows * dout.shape[1] + wt.numel() + got.numel()) + 4 * idx_t.numel()
    b_ms, b_by = bound_ms(nb, 2.0 * live * wt.shape[1] * wt.shape[2], BF16_FLOPS)
    rec = {"shape": name, "max_abs_err": 0.0,
           "ms": cuda_ms(lambda: sparse_conv.gather_dx_bf16(dout, idx_t, wt)),
           "plain_ms": cuda_ms(lambda: sparse_conv.gather_dx_bf16_plain(dout, idx_t, wt), 3),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "live_pairs": live,
           "dout_rows_read": d_rows}
    print(f"# gather_dx_bf16 {json.dumps(rec)}", flush=True)
    return rec


def check_gather_wgrad_bf16(name: str, x, idx, dout) -> dict:
    """K4's bf16 variant against its plain version: the f32 sums, taken in
    other orders, rounded once to bf16, within one bf16 ulp (a cancelling
    sum within K4_RTOL of the scale); the share that differs printed.
    Deterministic (two launches equal); timed, bound in bf16 bytes and the
    bf16 tensor-core rate."""
    got = sparse_conv.gather_wgrad(x, idx, dout)
    want = sparse_conv.gather_wgrad_plain(x, idx, dout)
    torch.cuda.synchronize()
    gap = bf16_gap(got, want)
    err = float((got - want).abs().max())
    if not (math.isfinite(err) and gap["beyond_ulp_err"] <= K4_RTOL):
        raise AssertionError(f"gather_wgrad_bf16 {name}: {gap}, max abs err {err}")
    if not (_bit_equal(got, sparse_conv.gather_wgrad(x, idx, dout))
            and _bit_equal(got, got.to(torch.bfloat16).float())):
        raise AssertionError(f"gather_wgrad_bf16 {name}: not deterministic, or not bf16 values")
    live, x_rows, dout_rows = live_rows(idx, x.shape[0])
    nb = 2 * (x_rows * x.shape[1] + dout_rows * dout.shape[1]) + 4 * (idx.numel() + got.numel())
    b_ms, b_by = bound_ms(nb, 2.0 * live * x.shape[1] * dout.shape[1], BF16_FLOPS)
    rec = {"shape": name, "max_abs_err": err, "scale": float(want.abs().max()), **gap,
           "ms": cuda_ms(lambda: sparse_conv.gather_wgrad(x, idx, dout)),
           "plain_ms": cuda_ms(lambda: sparse_conv.gather_wgrad_plain(x, idx, dout)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "live_pairs": live}
    print(f"# gather_wgrad_bf16 {json.dumps(rec)}", flush=True)
    return rec


def bf16_train_kernel_checks(dev) -> dict:
    """The bf16 backward's kernels at the training recipes' shapes, on one
    batch of 2 augmented full-width train scenes of PointGroup's (m=16) and
    of HAIS's (m=32; SoftGroup trains the same backbone at the same caps)
    recipe: K13 at every conv shape of the backbone's backward (each level's
    subm conv and its tail's first conv over the skip concat, the down and
    up convs between levels; the input conv's input takes no gradient), bit
    for bit; K4's bf16 variant at the subm L0 and L3, down and up shapes of
    each, within one bf16 ulp; K6's bf16 sum at the devoxelization (the
    points' cotangents into the level-0 voxels) and at the point-feature
    gather into a heads forward's proposal rows, bit for bit."""
    g = torch.Generator(device="cpu").manual_seed(21)
    out = {"gather_dx_bf16": [], "gather_wgrad_bf16": [], "segment_reduce_bf16_sum": []}
    for cfg in (TrainConfig(), HaisTrainConfig()):
        data = TrainData(cfg.with_overrides({"synthetic.train_scenes": 2}))
        batch = data.batch(0, [0, 1])
        tb = batch_to_torch(batch, dev)
        plan, v2p, _ = plan_from_batch(tb, len(cfg.net.blocks))
        m = cfg.net.m
        widths = [m * b for b in cfg.net.blocks]

        def rnd(*shape, scale=1.0):
            x = (torch.randn(shape, generator=g) * scale).to(dev)
            return (x * 2.0 ** torch.randint(-3, 3, shape[:1] + (1,) * (len(shape) - 1),
                                             generator=g).to(dev)).to(torch.bfloat16)

        for lvl, w in enumerate(widths):
            lv = plan.levels[lvl]
            tag = f"{cfg.MODEL} train L{lvl} ({lv.cap} rows)"
            out["gather_dx_bf16"].append(check_gather_dx(
                f"{tag} subm 27x{w} -> {w}", rnd(lv.cap, w), lv.nbr_idx,
                rnd(27, w, w, scale=(6 / (27 * w)) ** 0.5)))
            if lvl + 1 == len(widths):
                continue
            parent, w2 = plan.levels[lvl + 1], widths[lvl + 1]
            lk = sparse_conv.links(lv, parent.cap)
            out["gather_dx_bf16"] += [
                check_gather_dx(f"{tag} tail 27x{2 * w} -> {w}", rnd(lv.cap, w), lv.nbr_idx,
                                rnd(27, w, 2 * w, scale=(6 / (54 * w)) ** 0.5)),
                check_gather_dx(f"{tag} down 8x{w} -> {w2}", rnd(parent.cap, w2), lk.up,
                                rnd(8, w2, w, scale=(6 / (8 * w)) ** 0.5)),
                check_gather_dx(f"{tag} up 8x{w2} -> {w}", rnd(lv.cap, w), lk.down,
                                rnd(8, w, w2, scale=(6 / (8 * w2)) ** 0.5))]
        l3 = min(3, len(widths) - 1)
        lv0, lv1, lv3 = plan.levels[0], plan.levels[1], plan.levels[l3]
        lk = sparse_conv.links(lv0, lv1.cap)
        c0, c1, c3, w3 = lv0.cap, lv1.cap, lv3.cap, widths[l3]
        out["gather_wgrad_bf16"] += [
            check_gather_wgrad_bf16(f"{cfg.MODEL} subm L0 ({c0}, 27x{m} -> {m})", rnd(c0, m),
                                    lv0.nbr_idx, rnd(c0, m)),
            check_gather_wgrad_bf16(f"{cfg.MODEL} subm L{l3} ({c3}, 27x{w3} -> {w3})",
                                    rnd(c3, w3), lv3.nbr_idx, rnd(c3, w3)),
            check_gather_wgrad_bf16(f"{cfg.MODEL} down L0->L1 (8x{m} -> {2 * m})", rnd(c0, m),
                                    lk.down, rnd(c1, 2 * m)),
            check_gather_wgrad_bf16(f"{cfg.MODEL} up L1->L0 (8x{2 * m} -> {m})",
                                    rnd(c1, 2 * m), lk.up, rnd(c0, m))]
        # the devoxelization's transpose: each point's cotangent into its
        # voxel (padding points, v2p == cap, are left out)
        n_pts = v2p.shape[0]
        csr = segment.segment_csr(v2p, c0)
        ct = rnd(n_pts, m) * tb["point_mask"][:, None].to(torch.bfloat16)
        out["segment_reduce_bf16_sum"].append(check_segment_reduce(
            f"{cfg.MODEL} devoxelization: {n_pts} points -> {c0} voxels x {m}", ct, csr, "sum"))
        # the point-feature gather into the proposal rows of a heads forward
        model = seeded_model(cfg, 0, dev, "train")
        with torch.no_grad():
            heads = model.heads(tb, injected_backbone_outputs(batch, cfg.classes, m, 1, dev),
                                **get_model(cfg.MODEL).forward_flags(cfg, 100, False))
        rows = heads["proposal_rows"]
        csr = segment.segment_csr(rows["point_idx"].long(), n_pts)
        ct = rnd(rows["point_idx"].shape[0], m) * rows["valid"][:, None].to(torch.bfloat16)
        out["segment_reduce_bf16_sum"].append(check_segment_reduce(
            f"{cfg.MODEL} proposal rows: {rows['point_idx'].shape[0]} rows "
            f"({int(rows['valid'].sum())} valid) -> {n_pts} points x {m}", ct, csr, "sum"))
    print(f"# gather_dx_bf16: {len(out['gather_dx_bf16'])} conv shapes of both training "
          f"backbones bit for bit; gather_wgrad_bf16: {len(out['gather_wgrad_bf16'])} shapes "
          f"within one bf16 ulp, differing share at most "
          f"{max(r['differ_share'] for r in out['gather_wgrad_bf16']):.3e}", flush=True)
    return out


def _bf16_grads_close(tag: str, card: dict, cpu: dict, cpu_f32: dict) -> tuple:
    """Card bf16 gradients against the CPU's, each tensor against its bf16
    noise (the CPU's bf16 against its f32 gradient), below GAP_CAP, its norm
    within NORM_RATIO of the CPU's; returns the worst gap / noise and its
    tensor, the largest gap and the norm ratio furthest from 1."""
    if card.keys() != cpu.keys() or not cpu:
        raise AssertionError(f"{tag}: card and CPU differ in which tensors got gradients")
    worst, largest, ratio_far = (0.0, ""), 0.0, 1.0
    for k, want in cpu.items():
        norm = float(want.norm())
        if norm < ZERO_GRAD:
            if float(card[k].norm()) >= ZERO_GRAD:
                raise AssertionError(f"{tag} grad {k}: 0 on the CPU, {float(card[k].norm())} "
                                     f"on the card")
            continue
        gap = float((card[k] - want).norm()) / norm
        noise = float((want - cpu_f32[k]).norm()) / norm
        ratio = float(card[k].norm()) / norm
        if not gap <= min(NOISE_FACTOR * noise + BF16_GRAD_RTOL, GAP_CAP):
            raise AssertionError(f"{tag} grad {k}: card vs CPU gap {gap:.3e}, bf16 noise "
                                 f"{noise:.3e}")
        if not 1 / NORM_RATIO <= ratio <= NORM_RATIO:
            raise AssertionError(f"{tag} grad {k}: card norm {ratio:.3f} of the CPU's")
        worst = max(worst, (gap / (noise + BF16_GRAD_RTOL / NOISE_FACTOR), k))
        largest = max(largest, gap)
        ratio_far = max(ratio_far, ratio, 1 / ratio)
    return worst, largest, ratio_far


def small_bf16_train_check(dev) -> None:
    """One small bf16 heads-on train step (PointGroup; HAIS with its mask
    gates closed) whose heads read injected ground-truth outputs beside the
    backbone's point features (``Trainer.forward_gt``), on the card against
    the same step on the CPU, same seeded weights, batch and generator,
    under tests/test_torch_bf16_train.py's rules: proposals equal, losses
    within BF16_LOSS_RTOL, every gradient within its bf16 noise (the CPU's
    f32 step of the same state gives it) and below GAP_CAP, its norm within
    NORM_RATIO, and the Adam update equal where the two gradients agree in
    sign and exceed 1e-3 (at least ADAM_AGREE of the entries), within 2 lr
    elsewhere."""
    for model in ("PointGroup", "HAIS"):
        pna = SMALL_PNA if model == "HAIS" else {}
        cfg = TRAIN_CONFIGS[model]().with_overrides(
            {**SMALL_TRAIN, **pna, "net.prepare_epochs": 0, "precision": "bfloat16"})
        data = TrainData(cfg)
        batch = data.batch(0, [0, 1])
        injected = injected_backbone_outputs(batch, cfg.classes, cfg.net.m, 2, "cpu")
        res = {}
        for name, d, precision in (("cpu", "cpu", "bfloat16"), ("cpu_f32", "cpu", "float32"),
                                   ("card", dev, "bfloat16")):
            tr = Trainer(cfg.with_overrides({"precision": precision}), data, d, seed=5)
            tr.epoch = 1
            before = {k: p.detach().cpu().clone() for k, p in tr.model.named_parameters()}
            out, losses, total = tr.forward_gt(batch_to_torch(batch, d),
                                               {k: v.to(d) for k, v in injected.items()})
            tr.backward(total)
            grads = {k: p.grad.cpu() for k, p in tr.model.named_parameters()
                     if p.grad is not None}
            tr.update()
            res[name] = dict(losses={k: float(v.detach()) for k, v in losses.items()},
                             grads=grads, before=before, lr=tr.lr(),
                             after={k: p.detach().cpu() for k, p in tr.model.named_parameters()},
                             n_props=int(out["proposal_rows"]["n_proposals"]))
        c, k, c32 = res["cpu"], res["card"], res["cpu_f32"]
        tag = f"small_bf16_train {model}"
        if k["n_props"] != c["n_props"] or c["n_props"] == 0 or HEAD_LOSS[model] not in c["losses"]:
            raise AssertionError(f"{tag}: proposals card {k['n_props']} CPU {c['n_props']}, "
                                 f"losses {c['losses']}")
        for name, v in c["losses"].items():
            if not (math.isfinite(k["losses"][name])
                    and abs(k["losses"][name] - v) <= BF16_LOSS_RTOL * max(abs(v), 0.1)):
                raise AssertionError(f"{tag} {name}: card {k['losses'][name]} vs CPU {v}")
        worst, largest, ratio_far = _bf16_grads_close(tag, k["grads"], c["grads"], c32["grads"])
        lr, flips, agreed, clear = c["lr"], 0, 0, 0
        for name, b in c["before"].items():
            if name not in c["grads"]:
                continue
            gc, gk = c["grads"][name], k["grads"][name]
            agree = (gc.sign() == gk.sign()) & (torch.minimum(gc.abs(), gk.abs()) > 1e-3)
            diff = (k["after"][name] - c["after"][name]).abs()
            tol = 1e-5 * max(float(b.abs().max()), 1.0)
            if not (bool((diff[agree] <= tol).all()) and bool((diff <= 2 * lr + tol).all())):
                raise AssertionError(f"{tag} update {name}: card vs CPU max diff "
                                     f"{float(diff.max())}")
            flips += int((gc.sign() != gk.sign()).sum())
            agreed += int(agree.sum())
            clear += int((gc.abs() > 1e-3).sum())
        if not agreed >= ADAM_AGREE * clear:
            raise AssertionError(f"{tag}: the update is held exactly on {agreed} of {clear} "
                                 f"entries")
        print(f"# {tag}: {c['n_props']} proposals on both; losses card {k['losses']} cpu "
              f"{c['losses']}; {len(c['grads'])} gradients within {NOISE_FACTOR} x their bf16 "
              f"noise + {BF16_GRAD_RTOL} (worst {worst[0]:.2f}, {worst[1]}), below {GAP_CAP} "
              f"(largest gap {largest:.3f}), norms within {ratio_far:.3f}x; Adam update "
              f"equal where the gradients agree ({agreed} of {clear} entries), {flips} sign "
              f"flips", flush=True)


def check_global_avg_pool(dev) -> dict:
    """``segment.global_avg_pool`` (K6's ordered sum over a CSR, divided by
    the count; no model calls it) on the card against the CPU, bit for bit,
    at the shape roipool has in the HAIS heads (2N rows x m channels into
    the proposals), timed beside its plain version (the plain fold, then the
    division) and index_add_ divided by the count."""
    cfg = HaisEvalConfig()
    _, tb, out, _ = heads_on_scene(cfg, 4, dev)
    rows, p_cap, m = out["proposal_rows"], cfg.caps.proposals, cfg.net.m
    g = torch.Generator().manual_seed(10)
    x = torch.randn((rows["valid"].shape[0], m), generator=g).to(dev)
    args = (rows["prop_id"], rows["valid"], p_cap)
    got = segment.global_avg_pool(x, *args)
    want = segment.global_avg_pool(x.cpu(), *(a.cpu() if torch.is_tensor(a) else a for a in args))
    if not _bit_equal(got.cpu(), want):
        raise AssertionError("global_avg_pool: card and CPU differ")
    csr = segment.segment_csr(torch.where(rows["valid"], rows["prop_id"],
                                          torch.full_like(rows["prop_id"], p_cap)), p_cap)
    cnt = (csr.offsets[1:] - csr.offsets[:-1]).clamp(min=1)[:, None].to(x.dtype)
    n_valid = int(csr.offsets[-1])
    b_ms, b_by = bound_ms(4 * (n_valid * m + n_valid + p_cap + 1 + p_cap * m), float(n_valid * m))
    rec = {"shape": f"HAIS roipool shape: {x.shape[0]} rows ({n_valid} valid) -> {p_cap} x {m}",
           "max_abs_err": 0.0,
           "ms": cuda_ms(lambda: segment.global_avg_pool(x, *args)),
           "plain_ms": cuda_ms(lambda: segment.segment_reduce_plain(x, csr, "sum") / cnt, 3),
           "library_ms": cuda_ms(lambda: torch.zeros((p_cap + 1, m), device=dev).index_add_(
               0, csr.seg, x)[:p_cap] / cnt), "bound_ms": b_ms, "bound_by": b_by}
    print(f"# global_avg_pool {json.dumps(rec)}", flush=True)
    return rec


def gt_heads_ap(cfg, model, dev, flags: dict) -> dict:
    """The heads on the 3 val scenes fed ground-truth backbone outputs
    (point features in the config's compute dtype, the same noise in both
    precisions), scored: proposals, diag, heads ms and AP/AP50/AP25."""
    ignore = list(cfg.ignore_classes)
    bundle = get_model(cfg.MODEL)
    preds, gts, props, diag, ms = [], [], [], {}, []
    for i, (scan_id, batch) in enumerate(collated_scenes(cfg)):
        tb = batch_to_torch(batch, dev)
        inj = injected_backbone_outputs(batch, cfg.classes, cfg.net.m, 20 + i, dev,
                                        gm.compute_dtype(cfg))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = model.heads(tb, inj, **flags)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        n = int(batch["num_points"])
        props.append(int(out["proposal_rows"]["n_proposals"]))
        for k, v in out["diag"].items():
            diag[k] = max(diag.get(k, 0), int(v))
        preds.append(bundle.pred_instances(cfg, scan_id, batch["point_xyz"][:n],
                                           out_to_numpy(out, n), len(ignore)))
        gts.append(get_gt_instances(batch["sem_labels"][:n], batch["instance_ids"][:n], ignore))
    res = GeneralDatasetEvaluator(cfg.class_names, -1, ignore).evaluate(preds, gts)
    return {"AP": float(res["all_ap"]), "AP_50": float(res["all_ap_50%"]),
            "AP_25": float(res["all_ap_25%"]), "proposals": props, "diag": diag,
            "heads_ms": ms, "instances": [len(p) for p in preds]}


# diag counters that follow the seeded backbone's random class per point,
# which the precision moves; the others must equal the f32 run's
CLASS_DEPENDENT = ("units_dropped", "edges_dropped", "clusters_dropped", "proposals_dropped",
                   "pairs_dropped", "primaries_dropped")


def bf16_inference(dev, f32_metrics: dict) -> dict:
    """This slice's main path: ``evaluate`` at each model's eval config with
    precision=bfloat16, full width, the 3 val scenes, seeded weights; the
    launch counts are reset just before each run and read just after. K1's
    and K7's bf16 variants must launch, and their f32 versions not at all.
    The per-scene ms stand beside the f32 run of the same call. Every diag
    counter equals the f32 run's but those that follow the seeded
    backbone's random classes (CLASS_DEPENDENT). Then the heads on the 3
    scenes fed ground-truth outputs, bf16 against f32 with the same weights:
    proposals and diag equal (the clustering reads the same f32 classes and
    offsets), AP printed. Returns each model's launch counts."""
    result = {}
    for base in (HaisEvalConfig(), SoftGroupEvalConfig(), EvalConfig()):
        name = base.MODEL
        cfg = base.with_overrides({"precision": "bfloat16"})
        model = seeded_model(cfg, 0, dev)
        flags = get_model(name).forward_flags(cfg, 100, False)
        build.reset_launches()
        metrics = evaluate(cfg, model, dev, epoch=100)
        launches = dict(build.LAUNCHES)
        f32 = f32_metrics[name]
        print(f"# bf16_inference {name}: seeded random weights, AP and mIoU carry no meaning",
              flush=True)
        print(f"# bf16_inference {name} per-scene ms bf16 {metrics['scene_ms']} f32 "
              f"{f32['scene_ms']}", flush=True)
        print(f"# bf16_inference {name} proposals bf16 {metrics['proposals']} f32 "
              f"{f32['proposals']}; diag bf16 {metrics['diag']} f32 {f32['diag']}", flush=True)
        print(f"# bf16_inference {name} AP {metrics['AP']} AP50 {metrics['AP_50']} semantic acc "
              f"{metrics['semantic_accuracy']} mIoU {metrics['semantic_mean_iou']}", flush=True)
        print(f"# bf16_inference {name} launches {launches}", flush=True)
        if len(metrics["scene_ms"]) != cfg.synthetic.val_scenes:
            raise AssertionError(f"bf16_inference {name}: not every val scene ran")
        for key in ("semantic_accuracy", "semantic_mean_iou"):
            if not math.isfinite(metrics[key]):
                raise AssertionError(f"bf16_inference {name}: {key} is not finite")
        if (launches["gather_gemm_bf16"] == 0 or launches["proposal_voxelize_bf16"] == 0
                or launches["gather_gemm"] or launches["proposal_voxelize"]):
            raise AssertionError(f"bf16_inference {name}: the bf16 kernels did not carry the "
                                 f"path: {launches}")
        fixed = {k: (v, f32["diag"].get(k)) for k, v in metrics["diag"].items()
                 if k not in CLASS_DEPENDENT}
        if metrics["diag"].keys() != f32["diag"].keys() or any(a != b for a, b in fixed.values()):
            raise AssertionError(f"bf16_inference {name}: diag bf16 vs f32 {fixed}")
        check_outputs(cfg, model, dev, flags, overflow=False)
        gt = {"bf16": gt_heads_ap(cfg, model, dev, flags),
              "f32": gt_heads_ap(base, seeded_model(base, 0, dev), dev, flags)}
        print(f"# bf16_inference {name} heads on ground-truth outputs: {json.dumps(gt)}",
              flush=True)
        if gt["bf16"]["proposals"] != gt["f32"]["proposals"] or \
                gt["bf16"]["diag"] != gt["f32"]["diag"] or min(gt["bf16"]["proposals"]) == 0:
            raise AssertionError(f"bf16_inference {name}: ground-truth heads bf16 vs f32 {gt}")
        if any(gt["bf16"]["diag"].values()):
            raise AssertionError(f"bf16_inference {name}: ground-truth heads overflow {gt}")
        result[name] = launches
    return result


def check_outputs(cfg: EvalConfig, model, dev, flags: dict | None = None,
                  overflow: bool = True) -> None:
    """One more forward of the first val scene: every output has its shape,
    is finite, and (``overflow``) no overflow counter moved (the repo's
    validity rule)."""
    _, batch = next(collated_scenes(cfg))
    with torch.no_grad():
        out = model(batch_to_torch(batch, dev), **(flags or {}))
    n, p = cfg.caps.eval_points, cfg.caps.proposals
    for key, shape in output_shapes(cfg, n, p).items():
        if tuple(out[key].shape) != shape or not torch.isfinite(out[key]).all():
            raise AssertionError(f"{cfg.MODEL} {key}: shape {tuple(out[key].shape)} != "
                                 f"{shape} or non-finite values")
    rows = out["proposal_rows"]
    if rows["point_idx"].shape != (2 * n,) or not 0 <= int(rows["n_proposals"]) <= p:
        raise AssertionError(f"{cfg.MODEL}: malformed proposal rows")
    moved = {k: int(v) for k, v in out["diag"].items() if int(v) != 0}
    if overflow and moved:
        raise AssertionError(f"{cfg.MODEL}: overflow counters moved: {moved}")
    print(f"# {cfg.MODEL} outputs checked: shapes, finite, diag "
          f"{ {k: int(v) for k, v in out['diag'].items()} }", flush=True)


def main() -> None:
    t_all = t0 = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} device {name}", flush=True)
    set_f32_numerics()
    t0 = phase("device", t0)

    host_so, kern_so = build.build_all()
    build.host_lib()
    build.kernel_lib()
    print(f"# built {host_so.name} {kern_so.name}", flush=True)
    t0 = phase("build", t0)

    cfg = EvalConfig()
    k1, k2, k3, k3_graph = kernel_checks(cfg, dev)
    k1_every_width(dev)
    new_kernels = new_kernel_checks(dev, k3_graph)
    new_kernels.update(softgroup_kernel_checks(dev))
    t0 = phase("kernels", t0)

    k4, k5 = train_kernel_checks(dev)
    t0 = phase("train_kernels", t0)

    instance_kernels = instance_kernel_checks(dev)
    t0 = phase("instance_kernels", t0)

    small_check(dev)
    t0 = phase("small", t0)

    small_train_check(dev)
    t0 = phase("small_train", t0)

    small_instance_train_check(dev)
    t0 = phase("small_instance_train", t0)

    heads_parity(dev)
    t0 = phase("heads_parity", t0)

    train_repeat(dev)
    t0 = phase("train_repeat", t0)

    gt_train = {m: gt_train_repeat(m, dev) for m in ("HAIS", "SoftGroup")}
    t0 = phase("gt_train_repeat", t0)

    model = seeded_model(cfg, 0, dev)
    build.reset_launches()
    metrics = evaluate(cfg, model, dev)
    eval_launches = dict(build.LAUNCHES)
    print("# main: seeded random weights, AP and mIoU carry no meaning", flush=True)
    print(f"# main per-scene ms {metrics['scene_ms']}", flush=True)
    print(f"# main proposals {metrics['proposals']} instances "
          f"{metrics['n_instances']} diag {metrics['diag']}", flush=True)
    print(f"# main AP {metrics['AP']} AP50 {metrics['AP_50']} AP25 {metrics['AP_25']} "
          f"semantic acc {metrics['semantic_accuracy']} mIoU "
          f"{metrics['semantic_mean_iou']}", flush=True)
    print(f"# main launches {eval_launches}", flush=True)
    if len(metrics["scene_ms"]) != cfg.synthetic.val_scenes:
        raise AssertionError("main: not every val scene ran")
    for key in ("semantic_accuracy", "semantic_mean_iou"):
        if not math.isfinite(metrics[key]):
            raise AssertionError(f"main: {key} is not finite")
    missing = [k for k in ("gather_gemm", "ball_query_edge", "connected_components",
                           "segment_reduce", "proposal_voxelize", "unit_compact")
               if eval_launches[k] == 0]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")
    check_outputs(cfg, model, dev)
    t0 = phase("main", t0)

    hais_launches, hais_gt_launches, kinds, hais_metrics = inference_phase(
        HaisEvalConfig(), dev, ("gather_gemm", "ball_query_edge", "connected_components",
                                "segment_reduce", "proposal_voxelize", "set_aggregation",
                                "unit_compact"))
    if sum(k["absorbed"] for k in kinds) == 0:
        raise AssertionError("hais heads on ground-truth outputs: no fragment was absorbed")
    t0 = phase("hais", t0)

    sg_launches, sg_gt_launches, _, sg_metrics = inference_phase(
        SoftGroupEvalConfig(), dev, ("gather_gemm", "ball_query_edge", "connected_components",
                                     "segment_reduce", "proposal_voxelize", "unit_compact",
                                     "stable_partition", "proposal_rank"))
    t0 = phase("softgroup", t0)

    k1_bf16 = k1_every_width(dev, torch.bfloat16)
    bf16_kernels = bf16_kernel_checks(dev)
    check_global_avg_pool(dev)
    t0 = phase("kernels_bf16", t0)

    heads_parity(dev, "bfloat16")
    t0 = phase("heads_parity_bf16", t0)

    bf16 = bf16_inference(dev, {"PointGroup": metrics, "HAIS": hais_metrics,
                                "SoftGroup": sg_metrics})
    k6_bf16 = {m: r["segment_reduce_bf16"] for m, r in bf16.items()}
    print(f"# segment_reduce_bf16 launches on the bf16 inference paths {k6_bf16}: no model "
          f"reduces bf16 rows (roipool and the SoftGroup pool read the TinyUnet's f32 output); "
          f"its records: {json.dumps(bf16_kernels['segment_reduce_bf16'])}", flush=True)
    t0 = phase("bf16_inference", t0)

    train = train_main(dev)
    t0 = phase("train", t0)

    train_hais = train_main(dev, "HAIS")
    t0 = phase("train_hais", t0)

    train_sg = train_main(dev, "SoftGroup")
    t0 = phase("train_softgroup", t0)

    bf16_train_kernels = bf16_train_kernel_checks(dev)
    t0 = phase("bf16_train_kernel_checks", t0)

    small_bf16_train_check(dev)
    t0 = phase("small_bf16_train_check", t0)

    bf16_repeat = {m: gt_train_repeat(m, dev, "bfloat16") for m in ("PointGroup", "HAIS")}
    t0 = phase("bf16_train_repeat", t0)

    f32_train = {"PointGroup": train, "HAIS": train_hais, "SoftGroup": train_sg}
    bf16_train = {}
    for m in ("PointGroup", "HAIS", "SoftGroup"):
        bf16_train[m] = train_main(dev, m, "bfloat16")
        print(f"# bf16_train_main {m} median ms per part, bf16 "
              f"{json.dumps(step_parts_ms(bf16_train[m]['steps']))} f32 (this call) "
              f"{json.dumps(step_parts_ms(f32_train[m]['steps']))}", flush=True)
    t0 = phase("bf16_train_main", t0)

    repl = {"gather_gemm": "minsu3d_tpu/ops/sparse_conv.py:50",
            "ball_query_edge": "minsu3d_tpu/ops/ballquery.py:268",
            "connected_components": "minsu3d_tpu/ops/cluster.py:21",
            "gather_wgrad": "minsu3d_tpu/ops/sparse_conv.py:306",
            "proposal_iou": "minsu3d_tpu/ops/instance_iou.py:35",
            "segment_reduce": "minsu3d_tpu/ops/segment.py:40",
            "proposal_voxelize": "minsu3d_tpu/model/general_model.py:333",
            "set_aggregation": "minsu3d_tpu/model/hais.py:31",
            "unit_compact": "minsu3d_tpu/ops/cluster.py:261",
            "stable_partition": "minsu3d_tpu/model/softgroup.py:124",
            "proposal_rank": "minsu3d_tpu/model/softgroup.py:161",
            "mask_label": "minsu3d_tpu/ops/instance_iou.py:57"}
    src = {k: f"minsu3d_tpu_torch/csrc/{k}.cu" for k in repl}
    src["ball_query_edge"] = "minsu3d_tpu_torch/csrc/ball_query.cu"
    records = {"gather_gemm": k1[0], "ball_query_edge": k2, "connected_components": k3,
               "gather_wgrad": k4[0], "proposal_iou": k5,
               **{k: v[0] for k, v in new_kernels.items()},
               "mask_label": instance_kernels["mask_label"][0]}
    # launches: K1-K5 keep the PointGroup training path's count, as since the
    # training slice; K6-K9 the HAIS inference path's; K10-K11 the SoftGroup
    # inference path's; K12 the HAIS training path's; every path's count
    # stands beside it
    own = {"gather_gemm": train["launches"], "ball_query_edge": train["launches"],
           "connected_components": train["launches"], "gather_wgrad": train["launches"],
           "proposal_iou": train["launches"], "stable_partition": sg_launches,
           "proposal_rank": sg_launches, "mask_label": train_hais["launches"]}
    # the bf16 variants: the bf16 HAIS inference path's launches (this
    # slice's main path), the record at its level-0 subm conv / its rows
    repl.update(gather_gemm_bf16="minsu3d_tpu/ops/sparse_conv.py:50",
                proposal_voxelize_bf16="minsu3d_tpu/model/general_model.py:333")
    src.update(gather_gemm_bf16=src["gather_gemm"],
               proposal_voxelize_bf16=src["proposal_voxelize"])
    records["gather_gemm_bf16"] = next(r for r in k1_bf16 if r["shape"].startswith("HAIS L0")
                                       and " subm " in r["shape"])
    records["proposal_voxelize_bf16"] = bf16_kernels["proposal_voxelize_bf16"][0]
    own.update(gather_gemm_bf16=bf16["HAIS"], proposal_voxelize_bf16=bf16["HAIS"])
    # the bf16 backward's kernels (K13, K4's and K6's bf16 variants): the bf16
    # PointGroup training path's launches (this slice's main path), the record
    # at PointGroup's level-0 training shapes; K6's bf16 max and min, which no
    # model path runs, ride along in the bf16 sum's entry
    repl.update(gather_dx_bf16="minsu3d_tpu/ops/sparse_conv.py:50",
                gather_wgrad_bf16="minsu3d_tpu/ops/sparse_conv.py:30",
                segment_reduce_bf16_sum="minsu3d_tpu/model/module/blocks.py:383")
    src.update(gather_dx_bf16="minsu3d_tpu_torch/csrc/gather_dx.cu",
               gather_wgrad_bf16=src["gather_wgrad"],
               segment_reduce_bf16_sum="minsu3d_tpu_torch/csrc/segment_reduce.cu")
    for kname in ("gather_dx_bf16", "gather_wgrad_bf16", "segment_reduce_bf16_sum"):
        records[kname] = bf16_train_kernels[kname][0]
        own[kname] = bf16_train["PointGroup"]["launches"]
    kernels = []
    for kname, rec in records.items():
        kernels.append({
            "name": kname, "route": "cuda", "source": src[kname], "replaces": repl[kname],
            "launches": own.get(kname, hais_launches)[kname],
            "launches_eval": eval_launches[kname], "launches_train": train["launches"][kname],
            "launches_hais": hais_launches[kname],
            "launches_hais_gt_heads": hais_gt_launches[kname],
            "launches_softgroup": sg_launches[kname],
            "launches_softgroup_gt_heads": sg_gt_launches[kname],
            "launches_train_hais": train_hais["launches"][kname],
            "launches_train_softgroup": train_sg["launches"][kname],
            "launches_hais_gt_train_step": gt_train["HAIS"][kname],
            "launches_softgroup_gt_train_step": gt_train["SoftGroup"][kname],
            **{f"launches_{m.lower()}_bf16": r[kname] for m, r in bf16.items()},
            **{f"launches_train_{m.lower()}_bf16": r["launches"][kname]
               for m, r in bf16_train.items()},
            **{f"launches_{m.lower()}_gt_train_step_bf16": r[kname]
               for m, r in bf16_repeat.items()},
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms"), "shape": rec["shape"]})
        if kname == "segment_reduce_bf16_sum":   # bf16 max and min, on no model path
            kernels[-1]["max_min"] = bf16_kernels["segment_reduce_bf16"]
        if kname == "proposal_iou":   # the mask-filtered variant of the same kernel
            kernels[-1]["row_keep"] = {k: instance_kernels["mask_iou"][0][k] for k in (
                "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
    print(f"# total {time.perf_counter() - t_all:.3f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
