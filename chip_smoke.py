#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each followed by a ``# phase <name> <seconds>`` line:
  device   require CUDA; print the card's name and power limit (nvidia-smi)
  build    g++ host library and the nvcc kernel library, started together
  kernels  every kernel of the inference paths against its plain PyTorch
           version on the card, at main-path shapes, seeded inputs:
           gather_gemm (K1) at every distinct conv shape of the PointGroup
           (m=16) and HAIS (m=32) eval backbones over the plan's tap orders,
           one timed shape per level (event and device ms, the pair slots
           its tiles compute against the live pairs); tap_orders (K22), the
           orders of all 19 tables of each plan in one call, bit for bit,
           and conv_tables' cost a forward (host launch, event, device ms);
           ball_query_edge (K2) bit for bit, including an input made to
           overflow the edge buffer, and connected_components (K3) on its
           graph;
           segment_reduce (K6) at every shape the models launch it with
           (``tools/segment_bench.py``'s: each call of PointGroup's, HAIS's
           and SoftGroup's heads on a val scene fed ground-truth outputs,
           captured with its caller: the unit table's sum and int max,
           HAIS's centres and class/batch max, the voxelization's mean, min
           and max, the f32 roipool, SoftGroup's cluster class; every
           gather_rows backward of those heads in f32 and bf16; the HAIS
           roipool shape as global_avg_pool and in bf16 max and min), each
           call under set_sync_debug_mode("error"), with event and device
           ms, the bound by live rows, the sums' chain floor and the
           library call (index_add_ or scatter_reduce, event and device
           ms); proposal_voxelize (K7) on the PointGroup and HAIS heads'
           rows, set_aggregation (K8) on 16384 clusters x 512 primaries,
           unit_compact (K9) on a val scene's unit labels and on random
           labels with many equal sizes, each call under
           set_sync_debug_mode("error"): all bit for bit; times by CUDA
           events; stable_partition (K10) bit for bit on the class-major
           (point, class) flags of a SoftGroup val scene fed injected
           ground-truth backbone outputs (fewer trues than the cap: the false
           tail) and on flags with more trues than the cap (pairs dropped),
           proposal_rank (K11) bit for bit on that scene's clusters and on
           random classes and sizes with many equal keys; both timed beside
           torch.argsort(stable=True)
  plan_kernel_checks
           K15 key_sort, K16 sorted_lookup (bounds and neighbour modes) and
           K17 unique_compact against their plain versions bit for bit, on
           the first val scene of the golden PointGroup eval: the device
           plan's level-0 and coarsest keys, make_units' 131072 keys, the
           ball query's unit cells and run bounds (65536 units x 14 cells),
           segment_csr ids and offsets, the plan's kernel map at every level,
           the level-0 table (and an overflowing one), and adversarial inputs
           (all keys equal, already sorted, reversed, n = 1, n not a multiple
           of the tile, all rows invalid, negative keys); each kernel timed
           at its first shape (CUDA-event median of 10, wrapper included)
           beside its bound, its plain version and one library call
           (torch.sort, torch.searchsorted, torch.unique_consecutive with the
           inverse scattered back)
  cc_checks
           connected components on every unit graph that PointGroup's,
           HAIS's and SoftGroup's heads (golden eval configs, full size) make
           on the first val scene fed ground-truth outputs, captured as they
           call it, and on a seeded (64, 64, 64) lattice whose pair list
           overflows (~455k cross-root edge slots, ~15k distinct pairs): K3
           and K18 (one cooperative launch a call) bit for bit against the
           plain sweeps, labels, unconverged, both sweep counts and the
           distinct cross-root pairs, at the captured budget (cc_iters 32,
           cc_coarsen 4096, 2 sweeps), without coarsening, at a truncated
           budget (max_iters 1, with and without coarsening) and with an
           overflowing list of 4 pairs; every call under
           set_sync_debug_mode("error") (no host sync) and at most 4
           launches; then PointGroup's first graph and the lattice timed at
           cc_coarsen 0 and 4096 (event and device ms, launches), beside the
           parent design's figures
  probe_kernels
           the gather probe's path, ``python -m
           minsu3d_tpu_torch.tools.probe_cuda`` (its ``main``), launch counts
           reset just before and read just after: K19 probe_double, K20
           window_gather and K21 onehot_gather at the probe's shapes (V
           119808, C 128, tile 4608) bit for bit against their plain
           versions, each timed beside its plain version, its bound and
           ``x * 2`` / ``x[rows]``
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
  cluster_variant_kernels
           the clustering variants' kernels at the JAX bench's production
           clustering (bench.py:63-121: shifted-grid units, 3 cm xyz-grid
           units, K 16, edge factors 28 / 56 and 8 for PointGroup's xyz
           clustering) on the first val scene, ground-truth classes and
           offsets injected: ball_query_grid (K14) bit for bit against its
           plain version on the xyz-grid units (m 1 and 2, half space both
           ways) and the shifted-grid units (m 2), and on a crafted cell
           holding two units; K2 with no edge cap (the fused query) on the
           shifted-grid units; K9 as compact_labels on PointGroup's
           point-granularity CC result (131072 points, K 32), card against
           CPU; each timed (CUDA-event median of 10) beside its plain version
           and its bound
  cluster_variant_parity
           PointGroup's, HAIS's and SoftGroup's heads at full size under the
           bench clustering, and PointGroup's at cluster_granularity=point and
           with bq_edge_factor=0 (the fused query), on one val scene fed
           ground-truth outputs: card against CPU, proposal rows, n_proposals
           and every diag counter bit for bit, scores within 1e-5 of scale;
           K2 launches in every run, K14 in PointGroup's bench run
  cluster_variant_main
           the three models at full width in f32 under the bench clustering
           through ``evaluate`` on the 3 val scenes (per-scene ms, counters
           as they fall on seeded weights), then their heads on the scenes fed
           ground-truth outputs (no overflow counter may move), launches
           counted per run; then a heads-on PointGroup train step on
           ground-truth outputs under the bench clustering (unit capacities
           for the batch of 2 scenes), repeated bit for bit
Then a ``{"kernels": [...]}`` line (K1-K21 and the bf16 variants of K1, K4,
K6 and K7; K3's and K18's records are one call on PointGroup's heads graph
without and with coarsening; K18 on the golden PointGroup inference path,
where the default ``cc_coarsen`` 4096 runs it, K19-K21 on the probe's path;
K6's bf16 max and min run on no model path and ride in the bf16 sum's entry; K2's entry
carries its no-edge-cap record, K9's its compact_labels record, K15-K17's
their other shapes, K16's its neighbour mode) and, only on success, the
last line ``{"ok": true, "device": {...}}``. Any failure raises (exit code != 0).
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
from minsu3d_tpu_torch.data.batching import build_plan_host, collate, eval_caps
from minsu3d_tpu_torch.data.datamodule import TrainData
from minsu3d_tpu_torch.data.dataset import eval_item, synthetic_val_scenes
from minsu3d_tpu_torch.evaluation.instance_segmentation import (GeneralDatasetEvaluator,
                                                                get_gt_instances)
from minsu3d_tpu_torch.model import general_model as gm
from minsu3d_tpu_torch.model import hais, pointgroup, softgroup
from minsu3d_tpu_torch.model.registry import get_model
from minsu3d_tpu_torch.ops import (ballquery, cluster, hashing, instance_iou, proposal_rank,
                                   proposal_voxelize, segment, set_aggregation, sparse,
                                   sparse_conv, stable_partition)
from minsu3d_tpu_torch.ops.sparse import plan_from_batch
from minsu3d_tpu_torch.tools import backward_bench, cc_graph, probe_cuda, segment_bench
from minsu3d_tpu_torch.test import (SCORE_KEYS, batch_to_torch, collated_scenes, evaluate,
                                    injected_backbone_outputs, out_to_numpy, seeded_model,
                                    set_f32_numerics)
from minsu3d_tpu_torch.trainer.trainer import Trainer, max_param_change, param_snapshot

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM bf16, dense tensor cores
UNFUSED_OPS = F32_FLOPS / 2  # f32 multiplies or adds outside the tensor cores, one op each
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
# the gather probe's kernels (python -m minsu3d_tpu_torch.tools.probe_cuda),
# on no model path
PROBE_KERNELS = ("probe_double", "window_gather", "onehot_gather")
# K22's records, one for each eval backbone's plan (k1_every_width in f32)
TAP_RECORDS = []
# the kernels that a training path in each precision does not run: HAIS's
# set aggregation (using_set_aggr_in_training is False), K6's bf16 max and
# min (no model reduces bf16 rows with them), K14 (the recipes cluster
# (voxel, class) units, not grid units), the probe's, and the other
# precision's variants of K1, K4 and K7 and the bf16 backward's K13 and K6
# bf16 sum
BF16_TRAIN_KERNELS = ("gather_gemm_bf16", "gather_dx_bf16", "gather_wgrad_bf16",
                      "segment_reduce_bf16_sum", "proposal_voxelize_bf16")
NOT_IN_ANY_TRAIN = ("set_aggregation", "segment_reduce_bf16", "ball_query_grid",
                    *PROBE_KERNELS)
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
# the key sort, sorted lookup and unique/compaction of the grid plan, the
# clustering units, the ball queries' tables and every segment CSR
PLAN_KERNELS = ("key_sort", "sorted_lookup", "unique_compact")
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


def batch_ms(fn, reps: int = 10) -> float:
    """CUDA-event time of ``reps`` back-to-back calls of ``fn()`` over
    ``reps``, after a warm-up, with no sync between them: a kernel's device
    time where it outlasts its wrapper's host work (the host then runs
    ahead), without the profiler."""
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def host_ms(fn, reps: int = 10) -> float:
    """Median host ms of one ``fn()`` without a sync inside it (the host's
    launch time, which a host-bound forward feels), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def device_ms(fn, reps: int = 10) -> float | None:
    """Mean device time of one ``fn()`` (kernels, copies and memsets summed
    by torch.profiler over ``reps`` calls after a warm-up), without the
    host's share that the CUDA-event time of a short call carries; None when
    the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages())
    return total / reps / 1e3 if total > 0 else None


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


def scan_bytes(starts, run_len, k: int) -> int:
    """What K2's candidate scan must move: per live unit (one with a
    candidate; every valid unit finds itself) its coordinates, runs and
    point_base; perm once at each sorted position some run covers; the whole
    (U, K) table. Empty units' rows are never needed."""
    n_u, n_off = starts.shape
    n_live = int((run_len.sum(1) > 0).sum())
    st, ln = starts.long().flatten(), run_len.long().flatten()
    cover = torch.zeros(n_u + 1, dtype=torch.int64, device=starts.device)
    cover.index_add_(0, st[ln > 0], torch.ones_like(st[ln > 0]))
    cover.index_add_(0, (st + ln)[ln > 0], -torch.ones_like(st[ln > 0]))
    perm_rows = int((cover.cumsum(0)[:n_u] > 0).sum())
    return n_live * (12 + 2 * n_off * 4 + 8) + 4 * perm_rows + 4 * n_u * k


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


def check_gather_gemm(name: str, x, idx, w, timed: bool = True, order=None) -> dict:
    """K1 against its plain version, over ``order`` (idx's TapOrder from the
    plan; built here when None); returns the record of this shape (times
    and bound only when ``timed``). f32: within K1_RTOL of the output
    scale. bf16: every element within one bf16 ulp of the larger magnitude,
    except where a sum cancels (far smaller than its terms): there the two
    f32 sums, added in other orders, may round two ulps apart, and the gap
    must stay within K1_RTOL of the scale; fewer than 1% of the elements
    differ. The bound counts bf16 bytes and the bf16 tensor-core rate. A
    timed record also holds the device time (``device_ms``) and the (row,
    tap) slots K1's tiles compute against the live pairs."""
    if order is None:
        order = sparse_conv.tap_order(idx, x.shape[0])
    got = sparse_conv.gather_gemm(x, idx, w, order)
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
        slots = int(sparse_conv.tile_slots(order, idx.shape[1]))
        rec.update(ms=cuda_ms(lambda: sparse_conv.gather_gemm(x, idx, w, order)),
                   device_ms=device_ms(lambda: sparse_conv.gather_gemm(x, idx, w, order)),
                   plain_ms=cuda_ms(lambda: sparse_conv.gather_gemm_plain(x, idx, w)),
                   bound_ms=b_ms, bound_by=b_by, live_pairs=live, slots=slots,
                   slots_per_live_pair=slots / max(live, 1), x_rows_read=x_rows,
                   x_rows=x.shape[0])
    print(f"# gather_gemm {json.dumps(rec)}", flush=True)
    return rec


def conv_tables_cost(name: str, plan) -> dict:
    """What a forward pass pays for its TapOrders: ``sparse_conv.conv_tables``
    on ``plan`` timed on the host clock without a sync (the host's launch
    time, which a host-bound forward feels), by CUDA events and by
    ``torch.profiler`` device time; medians of 10 after a warm-up."""
    rec = {"plan": name, "tables": 3 * len(plan.levels) - 2,
           "host_ms": host_ms(lambda: sparse_conv.conv_tables(plan)),
           "ms": cuda_ms(lambda: sparse_conv.conv_tables(plan)),
           "device_ms": device_ms(lambda: sparse_conv.conv_tables(plan))}
    print(f"# conv_tables {json.dumps(rec)}", flush=True)
    return rec


def check_tap_orders(name: str, plan) -> dict:
    """K22 against its plain version (one stable sort a table) bit for bit
    on every table a forward pass over ``plan`` orders, in one call; timed
    beside its plain version and its bound (each table read once, each
    row's sorted key and permutation entry written once)."""
    tables = sparse_conv.conv_table_list(plan)
    got = sparse_conv.tap_orders(tables)
    want = sparse_conv.tap_orders_plain(tables)
    bad = [i for i, (g, w) in enumerate(zip(got, want))
           if not (torch.equal(g.perm, w.perm) and torch.equal(g.key, w.key))]
    if bad:
        raise AssertionError(f"tap_orders {name}: tables {bad} differ from one sort a table")
    rows = sum(idx.shape[0] for idx, _ in tables)
    b_ms, b_by = bound_ms(sum(4 * idx.numel() for idx, _ in tables) + 12 * rows, 0.0)
    rec = {"shape": f"{name}: {len(tables)} tables, {rows} rows", "max_abs_err": 0.0,
           "ms": cuda_ms(lambda: sparse_conv.tap_orders(tables)),
           "device_ms": device_ms(lambda: sparse_conv.tap_orders(tables)),
           "plain_ms": cuda_ms(lambda: sparse_conv.tap_orders_plain(tables)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    print(f"# tap_orders {json.dumps(rec)}", flush=True)
    return rec


def k1_every_width(dev, dtype=torch.float32) -> list:
    """K1 at every distinct conv shape (kind, level, Cin, Cout) of the
    PointGroup (m=16) and HAIS (m=32) eval backbones, on each recipe's own
    plan of its first val scene and the plan's ``conv_tables``: the input
    conv, each level's subm conv and its tail's first subm conv over the
    skip concat (2w -> w), and the down and up convs between levels, in
    ``dtype`` (inputs and weights rounded to it). In f32 the subm conv of
    each level is timed, with K22 on the plan's tables and the conv tables'
    cost (PointGroup's K22 record is the first of ``TAP_RECORDS``); in bf16
    every shape."""
    g = torch.Generator(device="cpu").manual_seed(3)
    recs = []
    every = dtype != torch.float32
    for cfg in (EvalConfig(), HaisEvalConfig()):
        _, batch = next(collated_scenes(cfg))
        plan, _, _ = plan_from_batch(batch_to_torch(batch, dev), len(cfg.net.blocks))
        tables = sparse_conv.conv_tables(plan)
        if not every:
            TAP_RECORDS.append(check_tap_orders(cfg.MODEL, plan))
            conv_tables_cost(cfg.MODEL, plan)
        m, blocks = cfg.net.m, cfg.net.blocks
        widths = [m * b for b in blocks]

        def rnd(*shape, fan):
            return ((torch.rand(shape, generator=g) * 2 - 1) * (6 / fan) ** 0.5).to(dev, dtype)

        for lvl, w in enumerate(widths):
            lv, order = plan.levels[lvl], tables[lvl].nbr_order
            tag = f"{cfg.MODEL} L{lvl} ({lv.cap} rows)"
            x_w = rnd(lv.cap, w, fan=1)
            if lvl == 0:
                cin = cfg.net.input_channel
                recs.append(check_gather_gemm(f"{tag} input 27x{cin} -> {m}",
                                              rnd(lv.cap, cin, fan=1), lv.nbr_idx,
                                              rnd(27, cin, m, fan=27 * cin), every, order))
            recs.append(check_gather_gemm(f"{tag} subm 27x{w} -> {w}", x_w, lv.nbr_idx,
                                          rnd(27, w, w, fan=27 * w), True, order))
            if lvl + 1 == len(widths):
                continue
            parent, w2 = plan.levels[lvl + 1], widths[lvl + 1]
            lk = tables[lvl].links
            recs.append(check_gather_gemm(f"{tag} tail 27x{2 * w} -> {w}",
                                          rnd(lv.cap, 2 * w, fan=1), lv.nbr_idx,
                                          rnd(27, 2 * w, w, fan=54 * w), every, order))
            recs.append(check_gather_gemm(f"{tag} down 8x{w} -> {w2}", x_w, lk.down,
                                          rnd(8, w, w2, fan=8 * w), every, lk.down_order))
            recs.append(check_gather_gemm(f"{tag} up 8x{w2} -> {w}", rnd(parent.cap, w2, fan=1),
                                          lk.up, rnd(8, w2, w, fan=8 * w2), every, lk.up_order))
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
    tables = sparse_conv.conv_tables(plan)
    lk = tables[0].links
    k1 = [
        check_gather_gemm("subm L0 (98304, 27x16 -> 16)", rnd(lv0.cap, m),
                          lv0.nbr_idx, rnd(27, m, m, scale=(6 / (27 * m)) ** 0.5),
                          order=tables[0].nbr_order),
        check_gather_gemm("subm L3 (12288, 27x64 -> 64)", rnd(lv3.cap, 4 * m),
                          lv3.nbr_idx, rnd(27, 4 * m, 4 * m, scale=(6 / (108 * m)) ** 0.5),
                          order=tables[3].nbr_order),
        check_gather_gemm("down L0->L1 (8x16 -> 32)", rnd(lv0.cap, m), lk.down,
                          rnd(8, m, 2 * m), order=lk.down_order),
        check_gather_gemm("up L1->L0 (8x32 -> 16)", rnd(lv1.cap, 2 * m), lk.up,
                          rnd(8, 2 * m, m), order=lk.up_order),
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
    b_ms, b_by = bound_ms(scan_bytes(starts, run_len, k), 9.0 * min(total, edge_cap))
    nbr = ballquery.ball_query_scan(*args, k, window, edge_cap, r2)
    k2 = {"max_abs_err": 0.0,
          "ms": cuda_ms(lambda: ballquery.ball_query_scan(*args, k, window, edge_cap, r2)),
          "plain_ms": cuda_ms(lambda: ballquery.scan_plain(*args, k, window, edge_cap, r2_t)),
          "bound_ms": b_ms, "bound_by": b_by,
          "shape": f"{n_u} units x {n_off} cells x window {window}, K {k}"}

    nbr_valid = nbr < n_u
    got, _ = check_cc("kernel_checks' unit graph", (nbr, nbr_valid, u_active, u_group),
                      caps.cc_iters, 0, 2)
    lab_k = got.labels
    n_comp = int(((lab_k == torch.arange(n_u, device=dev)) & u_active).sum())
    print(f"# connected_components units={int(u_active.sum())} components={n_comp} sweeps "
          f"{int(got.sweeps)} equal (timed in cc_checks)", flush=True)
    return k1, k2, (lab_k, uid, u_counts)


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


def no_sync(fn):
    """fn() under set_sync_debug_mode("error"): a host sync inside raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def check_segment_reduce(name: str, x, csr, op: str, fill=0) -> dict:
    """K6 against its plain version, bit for bit, the call under
    set_sync_debug_mode("error"); library call: index_add_ (sum) or
    scatter_reduce (max/min) of the same rows, in another order. The CSR's
    build (a stable sort and a search, index preparation) is timed apart
    from the reduction. An f32/bf16 sum's chain floor: the longest segment
    times one dependent f32 add (4 cycles at 1980 MHz)."""
    got = no_sync(lambda: segment.segment_reduce(x, csr, op, fill))
    want = segment.segment_reduce_plain(x, csr, op, fill)
    if not _bit_equal(got, want):
        raise AssertionError(f"segment_reduce {name}: differs from its plain version in "
                             f"{int((got != want).sum())} of {got.numel()} entries")
    n_seg, c = csr.num_segments, x.shape[1]
    rows = int(csr.offsets[-1])
    lens = csr.offsets[1:] - csr.offsets[:-1]
    nb = x.element_size() * (rows * c + n_seg * c) + 4 * (rows + n_seg + 1)
    b_ms, b_by = bound_ms(nb, float(rows * c))
    seg = csr.seg

    def run():
        return segment.segment_reduce(x, csr, op, fill)

    def library():
        if op == "sum":
            return torch.zeros((n_seg + 1, c), dtype=x.dtype, device=x.device).index_add_(0, seg, x)
        return torch.full((n_seg + 1, c), fill, dtype=x.dtype, device=x.device).scatter_reduce_(
            0, seg[:, None].expand_as(x), x, reduce="a" + op, include_self=True)

    longest = int(lens.max())
    rec = {"shape": name, "op": op, "dtype": str(x.dtype).replace("torch.", ""),
           "max_abs_err": 0.0, "rows": rows, "channels": c, "segments": n_seg,
           "ms": cuda_ms(run), "device_ms": device_ms(run),
           "csr_ms": cuda_ms(lambda: segment.segment_csr(seg, n_seg)),
           "plain_ms": cuda_ms(lambda: segment.segment_reduce_plain(x, csr, op, fill), 3),
           "library_ms": cuda_ms(library), "library_device_ms": device_ms(library),
           "bound_ms": b_ms, "bound_by": b_by, "longest_segment": longest,
           "long_segments": int((lens > 32).sum())}
    if op == "sum" and x.dtype != torch.int32:
        rec["chain_floor_ms"] = longest * segment_bench.FADD_MS
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
    """K9 against its plain version, bit for bit, the call under
    set_sync_debug_mode("error")."""
    u = label.shape[0]
    got = no_sync(lambda: cluster.unit_points_compact_cuda(label, uid, u, c_cap, counts))
    want = cluster.unit_points_compact_plain(label, uid, u, c_cap, counts)
    for part, k, w in zip(("point_cluster", "sizes", "count", "seg_sizes", "n_big"), got,
                          want):
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
           "device_ms": device_ms(lambda: cluster.unit_points_compact_cuda(label, uid, u, c_cap,
                                                                          counts)),
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
    """K11 against its plain version, bit for bit. No one PyTorch call
    computes the same function: the stable argsort of the clusters' keys
    where(ok, ccls, k) (``argsort_ms``, a part of it) leaves out the
    threshold, the inverse permutation, the cap and the pairs' lookup."""
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
           "library_ms": None, "argsort_ms": cuda_ms(lambda: torch.argsort(key, stable=True)),
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
    rows = out["proposal_rows"]
    g = torch.Generator().manual_seed(7)
    # K6 at every shape the three models' heads launch it with (the first
    # is PointGroup's unit table sum: 131072 points -> 65536 units x 4)
    k6 = [check_segment_reduce(*shape) for shape in segment_bench.k6_shapes(dev)[0]]
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


def inference_phase(cfg, dev, path: tuple, name: str | None = None) -> tuple:
    """The model of ``cfg`` at full width over the 3 val scenes through
    ``evaluate``, then its heads on the 3 scenes fed ground-truth backbone
    outputs; every kernel of ``path`` must launch in the first run, every one
    but K1 in the second. Returns (launches, launches on ground-truth
    outputs, the cluster kinds of each of those scenes, the metrics of
    ``evaluate``). ``name`` tags the printed lines (default: the model)."""
    name = name or cfg.MODEL.lower()
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
    # the backbone's kernels (K1 and its tile orders, K22) do not run here
    missing = [k for k in path if gt_launches[k] == 0 and k not in ("gather_gemm", "tap_orders")]
    if missing:
        raise AssertionError(f"{name} heads on ground-truth outputs: never launched {missing}")
    return launches, gt_launches, kinds, metrics


def check_gather_wgrad(name: str, x, idx, dout, order=None) -> dict:
    """K4 against its plain version, over ``order`` (idx's TapOrder; built
    by the wrapper when None), within K4_RTOL of the scale and the same
    bits from call to call; returns the record of this shape (event and
    device ms, plain ms, bound)."""
    got = sparse_conv.gather_wgrad(x, idx, dout, order)
    want = sparse_conv.gather_wgrad_plain(x, idx, dout)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not (math.isfinite(err) and err <= K4_RTOL * max(scale, 1.0)):
        raise AssertionError(f"gather_wgrad {name}: max abs err {err} vs scale {scale}")
    if not torch.equal(got, sparse_conv.gather_wgrad(x, idx, dout, order)):
        raise AssertionError(f"gather_wgrad {name}: two launches differ (not deterministic)")
    live, x_rows, dout_rows = live_rows(idx, x.shape[0])
    nb = 4 * (x_rows * x.shape[1] + idx.numel() + dout_rows * dout.shape[1] + got.numel())
    b_ms, b_by = bound_ms(nb, 2.0 * live * x.shape[1] * dout.shape[1])
    rec = {"shape": name, "max_abs_err": err, "scale": scale,
           "ms": cuda_ms(lambda: sparse_conv.gather_wgrad(x, idx, dout, order)),
           "device_ms": device_ms(lambda: sparse_conv.gather_wgrad(x, idx, dout, order)),
           "batch_ms": batch_ms(lambda: sparse_conv.gather_wgrad(x, idx, dout, order)),
           "plain_ms": cuda_ms(lambda: sparse_conv.gather_wgrad_plain(x, idx, dout)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "live_pairs": live,
           "x_rows_read": x_rows, "x_rows": x.shape[0], "dout_rows_read": dout_rows,
           "dout_rows": dout.shape[0]}
    print(f"# gather_wgrad {json.dumps(rec)}", flush=True)
    return rec


def backward_every_width(dev, dtype) -> dict:
    """K13 and K4 at every conv shape of both training backbones: the
    PointGroup recipe (m=16) and HAIS's (m=32; SoftGroup trains the same
    backbone at the same caps), each on its plan of a batch of 2 augmented
    full-width train scenes and the plan's ``conv_tables``, the shapes of
    ``tools/backward_bench.py`` (each level's subm conv and its tail's first
    conv over the skip concat, the down and up convs between levels, and
    for K4 the input conv). f32: K4 within K4_RTOL of the scale. bf16: K13
    bit for bit (each conv's dx; the input conv's input takes none) and
    K4's bf16 variant within one bf16 ulp. Every call walks the table's
    TapOrder from ``conv_tables``, as the training step does; every shape
    is timed (event and device ms) beside its plain version and its bound,
    K13 also beside its exact-order floor."""
    bf16 = dtype == torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(21 if bf16 else 1)
    out = {"gather_dx_bf16": [], "gather_wgrad_bf16": []} if bf16 else {"gather_wgrad": []}

    def rnd(*shape, scale=1.0):
        if not bf16:
            return ((torch.rand(shape, generator=g) * 2 - 1) * scale).to(dev)
        x = (torch.randn(shape, generator=g) * scale).to(dev)
        return (x * 2.0 ** torch.randint(-3, 3, shape[:1] + (1,) * (len(shape) - 1),
                                         generator=g).to(dev)).to(torch.bfloat16)

    for cfg in (TrainConfig(), HaisTrainConfig()):
        data = TrainData(cfg.with_overrides({"synthetic.train_scenes": 2}))
        tb = batch_to_torch(data.batch(0, [0, 1]), dev)
        plan, _, _ = plan_from_batch(tb, len(cfg.net.blocks))
        for sh in backward_bench.level_shapes(cfg, plan, sparse_conv.conv_tables(plan)):
            idx, cin, cout = sh["idx"], sh["cin"], sh["cout"]
            if bf16 and sh["idx_t"] is not None:
                taps = sh["idx_t"].shape[1]
                out["gather_dx_bf16"].append(check_gather_dx(
                    sh["tag"], rnd(idx.shape[0], cout), sh["idx_t"],
                    rnd(taps, cout, cin, scale=(6 / (taps * cin)) ** 0.5), sh["order_t"]))
            check = check_gather_wgrad_bf16 if bf16 else check_gather_wgrad
            out["gather_wgrad_bf16" if bf16 else "gather_wgrad"].append(check(
                sh["tag"], rnd(sh["n_src"], cin), idx, rnd(idx.shape[0], cout), sh["order"]))
    if bf16:
        print(f"# gather_dx_bf16: {len(out['gather_dx_bf16'])} conv shapes of both training "
              f"backbones bit for bit; gather_wgrad_bf16: {len(out['gather_wgrad_bf16'])} shapes "
              f"within one bf16 ulp, differing share at most "
              f"{max(r['differ_share'] for r in out['gather_wgrad_bf16']):.3e}", flush=True)
    else:
        print(f"# gather_wgrad: {len(out['gather_wgrad'])} conv shapes of both training "
              f"backbones within {K4_RTOL} of their scale", flush=True)
    return out


def train_kernel_checks(dev) -> tuple:
    """K4 (f32) at every conv shape of both training recipes
    (``backward_every_width``, 16-224 channels) and K5 on the rows of a
    heads forward, on one batch of 2 augmented full-width train scenes."""
    cfg = TrainConfig()
    data = TrainData(cfg.with_overrides({"synthetic.train_scenes": 2}))
    batch = data.batch(0, [0, 1])
    tb = batch_to_torch(batch, dev)
    m = cfg.net.m
    k4 = backward_every_width(dev, torch.float32)["gather_wgrad"]

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
    ``col_mask`` (default: the classes other than -1). No one PyTorch call
    computes the same function: ``chain_ms`` times the five ops of the
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

    def chain():   # five ops, not one call of the same function
        mx, arg = torch.where(col_mask[None, :], ious, zero).max(dim=1)
        return (mx >= thr)[pid], arg[pid]

    args = (rows, p_cap, inst_ids, inst_cls, ious, thr)
    rec = {"shape": f"{name}: ({p}, {i}) IoUs, {n_rows} rows ({n_valid} valid, {n_ok} "
                    f"supervised, {int(want[0].sum())} labelled)",
           "max_abs_err": 0.0, "proposals_ok": int(w1[2].sum()),
           "ms": cuda_ms(lambda: instance_iou.get_mask_label(*args)),
           "phase1_ms": cuda_ms(lambda: instance_iou.proposal_argmax(ious, col_mask, thr)),
           "plain_ms": cuda_ms(lambda: instance_iou.get_mask_label_plain(*args)),
           "library_ms": None, "chain_ms": cuda_ms(chain), "bound_ms": b_ms,
           "bound_by": b_by}
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


def gt_train_repeat(model: str, dev, precision: str = "float32",
                    overrides: dict | None = None, tag: str | None = None) -> dict:
    """One full-width heads-on train step in ``precision`` whose heads read
    injected ground-truth outputs (``Trainer.forward_gt``), twice from the
    same state and generator: proposals found, finite losses, every
    gradient and the parameters after Adam bit for bit; then the same step
    under torch's deterministic-algorithms probe, which must flag no op.
    ``overrides`` go on top of the training recipe. Returns the launches of
    one step."""
    cfg = train_config(model, precision=precision).with_overrides(overrides or {})
    data = TrainData(cfg)
    batch = data.batch(1, [0, 1])
    inj = injected_backbone_outputs(batch, cfg.classes, cfg.net.m, 3, dev)
    tag = tag or f"gt_train_repeat {model} {precision}"
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


def check_gather_dx(name: str, dout, idx_t, wt, order=None) -> dict:
    """K13 over ``order`` (idx_t's TapOrder; built by the wrapper when None)
    against its plain version, bit for bit; timed (event and device ms).
    Bound: the bf16 bytes of the dout rows read, the weight and the output,
    the int32 index, or the live pairs' flops at the bf16 tensor-core rate.
    Exact-order floor: the live pairs' 2 Cin Cout unfused f32 multiplies and
    adds at UNFUSED_OPS, what the kernel's exact chains need on CUDA cores."""
    got = sparse_conv.gather_dx_bf16(dout, idx_t, wt, order)
    want = sparse_conv.gather_dx_bf16_plain(dout, idx_t, wt)
    torch.cuda.synchronize()
    if not _bit_equal(got, want):
        raise AssertionError(f"gather_dx_bf16 {name}: differs from its plain version in "
                             f"{int((got != want).sum())} of {got.numel()} elements")
    if not _bit_equal(got, sparse_conv.gather_dx_bf16(dout, idx_t, wt, order)):
        raise AssertionError(f"gather_dx_bf16 {name}: two launches differ")
    live, d_rows, _ = live_rows(idx_t, dout.shape[0])
    nb = 2 * (d_rows * dout.shape[1] + wt.numel() + got.numel()) + 4 * idx_t.numel()
    ops = 2.0 * live * wt.shape[1] * wt.shape[2]
    b_ms, b_by = bound_ms(nb, ops, BF16_FLOPS)
    rec = {"shape": name, "max_abs_err": 0.0,
           "ms": cuda_ms(lambda: sparse_conv.gather_dx_bf16(dout, idx_t, wt, order)),
           "device_ms": device_ms(lambda: sparse_conv.gather_dx_bf16(dout, idx_t, wt, order)),
           "batch_ms": batch_ms(lambda: sparse_conv.gather_dx_bf16(dout, idx_t, wt, order)),
           "plain_ms": cuda_ms(lambda: sparse_conv.gather_dx_bf16_plain(dout, idx_t, wt), 3),
           "bound_ms": b_ms, "bound_by": b_by, "exact_floor_ms": ops / UNFUSED_OPS * 1e3,
           "library_ms": None, "live_pairs": live, "dout_rows_read": d_rows}
    print(f"# gather_dx_bf16 {json.dumps(rec)}", flush=True)
    return rec


def check_gather_wgrad_bf16(name: str, x, idx, dout, order=None) -> dict:
    """K4's bf16 variant over ``order`` against its plain version: the f32
    sums, taken in other orders, rounded once to bf16, within one bf16 ulp
    (a cancelling sum within K4_RTOL of the scale); the share that differs
    printed. Deterministic (two launches equal); timed (event and device
    ms), bound in bf16 bytes and the bf16 tensor-core rate."""
    got = sparse_conv.gather_wgrad(x, idx, dout, order)
    want = sparse_conv.gather_wgrad_plain(x, idx, dout)
    torch.cuda.synchronize()
    gap = bf16_gap(got, want)
    err = float((got - want).abs().max())
    if not (math.isfinite(err) and gap["beyond_ulp_err"] <= K4_RTOL):
        raise AssertionError(f"gather_wgrad_bf16 {name}: {gap}, max abs err {err}")
    if not (_bit_equal(got, sparse_conv.gather_wgrad(x, idx, dout, order))
            and _bit_equal(got, got.to(torch.bfloat16).float())):
        raise AssertionError(f"gather_wgrad_bf16 {name}: not deterministic, or not bf16 values")
    live, x_rows, dout_rows = live_rows(idx, x.shape[0])
    nb = 2 * (x_rows * x.shape[1] + dout_rows * dout.shape[1]) + 4 * (idx.numel() + got.numel())
    b_ms, b_by = bound_ms(nb, 2.0 * live * x.shape[1] * dout.shape[1], BF16_FLOPS)
    rec = {"shape": name, "max_abs_err": err, "scale": float(want.abs().max()), **gap,
           "ms": cuda_ms(lambda: sparse_conv.gather_wgrad(x, idx, dout, order)),
           "device_ms": device_ms(lambda: sparse_conv.gather_wgrad(x, idx, dout, order)),
           "batch_ms": batch_ms(lambda: sparse_conv.gather_wgrad(x, idx, dout, order)),
           "plain_ms": cuda_ms(lambda: sparse_conv.gather_wgrad_plain(x, idx, dout)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "live_pairs": live}
    print(f"# gather_wgrad_bf16 {json.dumps(rec)}", flush=True)
    return rec


def bf16_train_kernel_checks(dev) -> dict:
    """The bf16 backward's kernels at the training recipes' shapes: K13 and
    K4's bf16 variant at every conv shape of both training backbones
    (``backward_every_width``); K6's bf16 sum, on one batch of 2 augmented
    full-width train scenes of PointGroup's (m=16) and of HAIS's (m=32)
    recipe, at the devoxelization (the points' cotangents into the level-0
    voxels) and at the point-feature gather into a heads forward's proposal
    rows, bit for bit."""
    out = backward_every_width(dev, torch.bfloat16)
    out["segment_reduce_bf16_sum"] = []
    g = torch.Generator(device="cpu").manual_seed(22)

    def rnd(*shape):
        x = torch.randn(shape, generator=g).to(dev)
        return (x * 2.0 ** torch.randint(-3, 3, shape[:1] + (1,) * (len(shape) - 1),
                                         generator=g).to(dev)).to(torch.bfloat16)

    for cfg in (TrainConfig(), HaisTrainConfig()):
        data = TrainData(cfg.with_overrides({"synthetic.train_scenes": 2}))
        batch = data.batch(0, [0, 1])
        tb = batch_to_torch(batch, dev)
        plan, v2p, _ = plan_from_batch(tb, len(cfg.net.blocks))
        m, c0 = cfg.net.m, plan.levels[0].cap
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
    return out


def pg_subm_l0(recs: list) -> dict:
    """The record at the PointGroup training backbone's level-0 subm conv."""
    return next(r for r in recs if r["shape"].startswith("PointGroup train L0")
                and " subm " in r["shape"])


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
    got = no_sync(lambda: segment.global_avg_pool(x, *args))
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
           "device_ms": device_ms(lambda: segment.global_avg_pool(x, *args)),
           "plain_ms": cuda_ms(lambda: segment.segment_reduce_plain(x, csr, "sum") / cnt, 3),
           "library_ms": cuda_ms(lambda: torch.zeros((p_cap + 1, m), device=dev).index_add_(
               0, csr.seg, x)[:p_cap] / cnt),
           "library_device_ms": device_ms(lambda: torch.zeros((p_cap + 1, m), device=dev)
                                          .index_add_(0, csr.seg, x)[:p_cap] / cnt),
           "bound_ms": b_ms, "bound_by": b_by}
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


# The JAX benchmark's production clustering (bench.py:63-121): the cluster
# and proposal capacities, shifted-grid units, 3 cm xyz-grid units, K 16 and
# the per-model edge factors; the capacities scale with the scenes that share
# a batch, as the bench's do. Its caps.proposal_rows has no counterpart: the
# JAX package reads it nowhere (both give each clustering one proposal row
# per point)
EVAL_CONFIGS = {"PointGroup": EvalConfig, "HAIS": HaisEvalConfig,
                "SoftGroup": SoftGroupEvalConfig}


def bench_overrides(model: str, scenes: int = 1) -> dict:
    def up(x: int, mult: int) -> int:
        return -(-x // mult) * mult
    units = up(40960 * scenes, 8192)
    over = {"caps.clusters": up(16384 * scenes, 1024),
            "caps.proposals": max(256, up(256 * scenes, 128)),
            "caps.shifted_units": True, "caps.cluster_units_shifted": units,
            "caps.cluster_cell_xyz": 0.03, "caps.cluster_units": units, "caps.neighbors": 16,
            "caps.bq_edge_factor": 56 if model == "SoftGroup" else 28}
    if model == "PointGroup":
        over["caps.bq_edge_factor_xyz"] = 8
    return over


def bench_config(model: str):
    return EVAL_CONFIGS[model]().with_overrides(bench_overrides(model))


def check_grid_query(name: str, coords, batch, valid, group, radius: float, cell: float,
                     half_space: bool, k: int) -> dict:
    """K14 against its plain version on the card, bit for bit; the record
    of this shape with its times and bound."""
    args = ballquery.grid_table(coords, batch, valid, radius, cell, half_space, group)
    args = (coords, valid, *args)
    r2 = float(torch.tensor(radius * radius, dtype=torch.float32))
    r2_t = torch.tensor(r2, dtype=torch.float32)
    got = ballquery.ball_query_grid_scan(*args, k, r2)
    want = ballquery.grid_scan_plain(*args, k, r2_t)
    if not torch.equal(got, want):
        raise AssertionError(f"ball_query_grid {name}: {int((got != want).sum())} slots differ "
                             f"from the plain version")
    _, _, cell_t, key_hi, s_key, _, offs = args
    q_key, in_rng = ballquery.query_keys(cell_t.long(), key_hi, valid, offs.long())
    idx = torch.searchsorted(s_key, q_key, right=True) - 1
    hit = in_rng & (idx >= 0) & (s_key[idx.clamp(min=0)] == q_key)
    found = int(hit.sum())
    u, n_off, n_valid = coords.shape[0], offs.shape[0], int(valid.sum())
    # what the function must move: every valid flag; a valid unit's coords,
    # cell and key_hi; the valid prefix of s_key (the SENTINEL tail is never
    # matched); perm once per distinct found row; the offsets; the whole
    # table. 9 f32 operations per distance test of a found neighbour cell
    perm_rows = int(torch.unique(idx[hit]).numel())
    nb = (u + n_valid * (12 + 12 + 8) + 8 * n_valid + 4 * perm_rows + 12 * n_off
          + 4 * u * k)
    b_ms, b_by = bound_ms(nb, 9.0 * found)
    rec = {"shape": f"{name}: {int(valid.sum())} of {u} units x {n_off} offsets, K {k}",
           "max_abs_err": 0.0, "found": found, "neighbours": int((got < u).sum()),
           "ms": cuda_ms(lambda: ballquery.ball_query_grid_scan(*args, k, r2)),
           "plain_ms": cuda_ms(lambda: ballquery.grid_scan_plain(*args, k, r2_t)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    print(f"# ball_query_grid {json.dumps(rec)}", flush=True)
    return rec


def gt_units(cfg, dev, seed: int = 4) -> tuple:
    """The first val scene on the card with ground-truth classes standing in
    for predictions and shifted coordinates from injected ground-truth
    offsets: (tb, sem, obj, shifted)."""
    _, batch = next(collated_scenes(cfg))
    tb = batch_to_torch(batch, dev)
    inj = injected_backbone_outputs(batch, cfg.classes, cfg.net.m, seed, dev)
    sem = inj["semantic_scores"].argmax(1)
    obj = pointgroup.foreground_mask(sem, tb["point_mask"], cfg.ignore_classes)
    return tb, sem, obj, tb["point_xyz"] + inj["point_offsets"]


def cluster_variant_kernels(dev) -> dict:
    """K14, K2 with no edge cap and K9 as ``compact_labels`` at the bench
    clustering's shapes, against their plain versions on the card."""
    cfg = bench_config("PointGroup")
    caps = StaticCaps.from_cfg(cfg)
    tb, sem, obj, shifted = gt_units(cfg, dev)
    bids, xyz = tb["vert_batch_ids"], tb["point_xyz"]
    k, window = max(caps.neighbors // 2, 8), max(caps.window // 4, 8)
    radius = cfg.net.cluster_radius
    # PointGroup's xyz clustering: 3 cm grid units, m = 1 (the main path's
    # shape, half space as the config), then m = 2 at radius 0.06
    units, dropped = gm.make_units_grid(bids, xyz, sem, obj, caps.cluster_units,
                                        caps.xyz_grid_cell)
    xu = cluster.unit_table(xyz, bids, obj, sem, units, caps.cluster_units)
    k14 = [check_grid_query("xyz grid 3 cm, r 0.03 (m 1)", xu[0], xu[1], xu[2], xu[3],
                            radius, caps.xyz_grid_cell, caps.half_space, k)]
    k14.append(check_grid_query("xyz grid 3 cm, r 0.03 (m 1), full space", xu[0], xu[1],
                                xu[2], xu[3], radius, caps.xyz_grid_cell, False, k))
    for hs in (True, False):
        k14.append(check_grid_query(f"xyz grid 3 cm, r 0.06 (m 2){'' if hs else ', full space'}",
                                    xu[0], xu[1], xu[2], xu[3], 0.06, caps.xyz_grid_cell, hs, k))
    # a crafted cell holding two units: the later one is the candidate
    for second_far in (False, True):
        near, far = [0.02, 0.01, 0.01], [0.001, 0.01, 0.01]
        first, second = (near, far) if second_far else (far, near)
        c = torch.tensor([first, second, [0.045, 0.01, 0.01], [0.3, 0.3, 0.3]], device=dev)
        z = torch.zeros(4, dtype=torch.int32, device=dev)
        g = torch.tensor([1, 1, 1, 2], dtype=torch.int32, device=dev)
        ok = torch.ones(4, dtype=torch.bool, device=dev)
        nbr = ballquery.ball_query_grid(c, z, ok, 0.03, 4, 0.03, False, g)[0]
        plain = ballquery.grid_scan_plain(c, ok, *ballquery.grid_table(
            c, z, ok, 0.03, 0.03, False, g), 4, torch.tensor(0.03 * 0.03, dtype=torch.float32))
        want = [2, 4, 4, 4] if second_far else [1, 2, 4, 4]
        if nbr[2].tolist() != want or not torch.equal(nbr, plain):
            raise AssertionError(f"ball_query_grid two units in a cell: {nbr[2].tolist()} "
                                 f"(want {want})")
    print("# ball_query_grid: a cell holding two units gives the later one, bit for bit "
          "with the plain version", flush=True)
    # the shifted clustering's 2 cm grid units: K2 with no edge cap (the
    # fused query), and K14 at m = 2 as bq_grid_max_m = 2 would take it
    s_units, s_dropped = gm.make_units_grid(bids, shifted, sem, obj, caps.cluster_units_shifted,
                                            cfg.voxel_size)
    su = cluster.unit_table(shifted, bids, obj, sem, s_units, caps.cluster_units_shifted)
    k14.append(check_grid_query("shifted grid 2 cm, r 0.03 (m 2)", su[0], su[1], su[2], su[3],
                                radius, cfg.voxel_size, caps.half_space, k))
    perm, starts, run_len, point_base, total = ballquery.runs(
        su[0], su[1], su[2], radius, window, caps.half_space, su[3])
    r2 = float(torch.tensor(radius * radius, dtype=torch.float32))
    r2_t = torch.tensor(r2, dtype=torch.float32)
    args = (su[0], perm, starts, run_len, point_base)
    cap = ballquery.NO_EDGE_CAP
    got = ballquery.ball_query_scan(*args, k, window, cap, r2)
    want = ballquery.scan_plain(*args, k, window, cap, r2_t)
    if not torch.equal(got, want):
        raise AssertionError(f"ball_query (no edge cap) differs: {int((got != want).sum())}")
    n_u, n_off = starts.shape
    b_ms, b_by = bound_ms(scan_bytes(starts, run_len, k), 9.0 * int(total))
    k2_fused = {"shape": f"shifted grid 2 cm: {int(su[2].sum())} of {n_u} units x {n_off} "
                         f"cells x window {window}, K {k}, no edge cap",
                "max_abs_err": 0.0, "candidates": int(total),
                "ms": cuda_ms(lambda: ballquery.ball_query_scan(*args, k, window, cap, r2)),
                "plain_ms": cuda_ms(lambda: ballquery.scan_plain(*args, k, window, cap, r2_t)),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    print(f"# ball_query_edge no edge cap {json.dumps(k2_fused)}", flush=True)
    # K9 as compact_labels: PointGroup's shifted clustering at point
    # granularity (K 32, the golden window and cc_iters), CC on the card
    pcaps = StaticCaps.from_cfg(EvalConfig().with_overrides({"caps.cluster_granularity": "point"}))
    n = shifted.shape[0]
    nbr, nbr_ok, e_drop = ballquery.ball_query_edge(
        shifted, bids, obj, radius, pcaps.neighbors, pcaps.window, pcaps.edge_factor * n,
        pcaps.half_space, sem)
    label, unconverged = cluster.connected_components(
        nbr, nbr_ok, obj, sem.to(torch.int32), pcaps.cc_iters, coarsen=pcaps.cc_coarsen,
        coarsen_sweeps=pcaps.cc_coarsen_sweeps)
    if int(unconverged) or int(e_drop):
        raise AssertionError(f"point granularity: cc_unconverged {int(unconverged)}, "
                             f"edges_dropped {int(e_drop)}")
    ids = torch.arange(n, device=dev)
    u_label = torch.where(obj, label, torch.full_like(label, n))
    uid = torch.where(obj, ids, torch.full_like(ids, n))
    k9 = [check_unit_compact(f"compact_labels: {int(obj.sum())} of {n} points, K "
                             f"{pcaps.neighbors}, c_cap {pcaps.clusters}",
                             u_label, uid, obj.to(torch.int64), pcaps.clusters)]
    for c_cap, big in ((pcaps.clusters, 1), (16, 50)):
        got_c = cluster.compact_labels(label, obj, c_cap, big)
        want_c = cluster.compact_labels(label.cpu(), obj.cpu(), c_cap, big)
        if not all(torch.equal(a.cpu(), b) for a, b in zip(got_c, want_c)):
            raise AssertionError(f"compact_labels (c_cap {c_cap}, big_thre {big}) differs")
    k9[0]["compact_labels_ms"] = cuda_ms(lambda: cluster.compact_labels(label, obj,
                                                                       pcaps.clusters))
    print(f"# compact_labels on K9: card equals CPU (c_cap {pcaps.clusters} and 16 with "
          f"big_thre 50); point-granularity CC converged; units dropped xyz {int(dropped)} "
          f"shifted {int(s_dropped)}", flush=True)
    return {"ball_query_grid": k14, "ball_query_no_edge_cap": k2_fused, "compact_labels": k9}


# the variants of cluster_variant_parity: the bench clustering of each model,
# PointGroup's golden config at point granularity and with the fused query
PARITY_VARIANTS = (("PointGroup bench", lambda: bench_config("PointGroup")),
                   ("HAIS bench", lambda: bench_config("HAIS")),
                   ("SoftGroup bench", lambda: bench_config("SoftGroup")),
                   ("PointGroup point", lambda: EvalConfig().with_overrides(
                       {"caps.cluster_granularity": "point"})),
                   ("PointGroup fused", lambda: EvalConfig().with_overrides(
                       {"caps.bq_edge_factor": 0})))


def cluster_variant_parity(dev) -> dict:
    """Each variant's heads at full size on one val scene fed injected
    ground-truth outputs, card against CPU: proposal rows, n_proposals and
    every diag counter bit for bit, scores within 1e-5 of their scale; K2
    launches in every run and K14 in PointGroup's bench run. Returns each
    variant's launches."""
    out = {}
    for name, make in PARITY_VARIANTS:
        cfg = make()
        _, _, oc, _ = heads_on_scene(cfg, 5, "cpu")
        build.reset_launches()
        _, _, ok, _ = heads_on_scene(cfg, 5, dev)
        launches = dict(build.LAUNCHES)
        rc, rk = oc["proposal_rows"], ok["proposal_rows"]
        if int(rc["n_proposals"]) != int(rk["n_proposals"]) or int(rc["n_proposals"]) == 0:
            raise AssertionError(f"cluster_variant_parity {name}: proposals CPU "
                                 f"{int(rc['n_proposals'])} card {int(rk['n_proposals'])}")
        for f in ("point_idx", "prop_id", "valid"):
            if not torch.equal(rc[f], rk[f].cpu()):
                raise AssertionError(f"cluster_variant_parity {name}: rows differ in {f}")
        diag = {k: (int(v), int(ok["diag"][k])) for k, v in oc["diag"].items()}
        if any(a != b for a, b in diag.values()) or oc["diag"].keys() != ok["diag"].keys():
            raise AssertionError(f"cluster_variant_parity {name}: diag CPU vs card {diag}")
        if diag["cc_unconverged"][0]:
            raise AssertionError(f"cluster_variant_parity {name}: CC did not converge")
        errs = {key: float((ok[key].cpu() - oc[key]).abs().max())
                / max(float(oc[key].abs().max()), 1.0) for key in SCORE_KEYS if key in oc}
        if not max(errs.values()) <= 1e-5:
            raise AssertionError(f"cluster_variant_parity {name}: scores err/scale {errs}")
        need = ["ball_query_edge", "connected_components"]
        if name == "PointGroup bench":
            need.append("ball_query_grid")
        if any(launches[k] == 0 for k in need):
            raise AssertionError(f"cluster_variant_parity {name}: launches {launches}")
        out[name] = launches
        print(f"# cluster_variant_parity {name}: {int(rc['n_proposals'])} proposals, "
              f"{int(rc['valid'].sum())} valid rows bit-identical card vs CPU; diag "
              f"{ {k: v[0] for k, v in diag.items()} }; scores err/scale {errs}; launches "
              f"K14 {launches['ball_query_grid']} K2 {launches['ball_query_edge']} K3 "
              f"{launches['connected_components']} K9 {launches['unit_compact']}", flush=True)
    return out


CLUSTER_PATHS = {
    "PointGroup": ("gather_gemm", "ball_query_grid", "ball_query_edge", "connected_components",
                   "cc_coarsen", "segment_reduce", "proposal_voxelize", "unit_compact"),
    "HAIS": ("gather_gemm", "ball_query_edge", "connected_components", "cc_coarsen",
             "segment_reduce", "proposal_voxelize", "set_aggregation", "unit_compact"),
    "SoftGroup": ("gather_gemm", "ball_query_edge", "connected_components", "cc_coarsen",
                  "segment_reduce", "proposal_voxelize", "unit_compact", "stable_partition",
                  "proposal_rank")}


def cluster_variant_main(dev) -> dict:
    """The three models at full width in f32 under the bench clustering,
    through ``evaluate`` on the 3 val scenes (counters as they fall on the
    seeded weights), then their heads on the scenes fed ground-truth outputs
    (no overflow counter may move); then one heads-on PointGroup train step
    on ground-truth outputs under the same clustering, repeated bit for bit.
    Returns {model: (launches, launches on ground-truth outputs, metrics)}
    and the train step's launches under "PointGroup train"."""
    res = {}
    for model, path in CLUSTER_PATHS.items():
        launches, gt_launches, _, metrics = inference_phase(
            bench_config(model), dev, path, f"cluster_variant_main {model}")
        res[model] = (launches, gt_launches, metrics)
    res["PointGroup train"] = gt_train_repeat(
        "PointGroup", dev, overrides=bench_overrides("PointGroup", 2),
        tag="cluster_variant_main PointGroup train step, bench clustering")
    if res["PointGroup train"]["ball_query_grid"] == 0:
        raise AssertionError("cluster_variant_main: the train step never launched K14")
    return res


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

def _level_keys(batch, coords, valid) -> torch.Tensor:
    """The packed keys that ``sparse.build_base`` sorts for these rows."""
    c = coords.clamp(0, hashing.COORD_MAX - 1)
    return hashing.pack_key(*hashing.mask_invalid(*hashing.pack(batch, c), valid))


def check_key_sort(name: str, key, timed: bool = False, bits: int = 64) -> dict:
    """K15 (sorting the low ``bits`` bits) against torch.sort(stable=True)
    (its plain version), keys and permutation bit for bit; timed: the
    library call is the same sort, and both also by their device time."""
    got = hashing.key_sort(key, bits)
    want = hashing.key_sort_plain(key)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"key_sort {name}: {int((got[1] != want[1]).sum())} of "
                             f"{key.shape[0]} permutation entries differ")
    n = key.shape[0]
    rec = {"shape": f"{name}: {n} keys{'' if bits == 64 else f', bits {bits}'}",
           "max_abs_err": 0.0}
    if timed:
        rec["ms"] = cuda_ms(lambda: hashing.key_sort(key, bits))
        rec["plain_ms"] = cuda_ms(lambda: hashing.key_sort_plain(key))
        rec["library_ms"] = cuda_ms(lambda: torch.sort(key, stable=True))
        rec["device_ms"] = device_ms(lambda: hashing.key_sort(key, bits))
        rec["library_device_ms"] = device_ms(lambda: torch.sort(key, stable=True))
        rec["bound_ms"], rec["bound_by"] = bound_ms(20.0 * n, 0.0)
    print(f"# key_sort {json.dumps(rec)}", flush=True)
    return rec


def check_sorted_bounds(name: str, s_key, q_key, timed: bool = False,
                        upper: bool = True) -> dict:
    """K16's bounds mode against torch.searchsorted, bit for bit
    (``upper=False``: the lower bound alone, as segment_csr asks)."""
    got = hashing.sorted_bounds(s_key, q_key, upper)
    want = hashing.sorted_bounds_plain(s_key, q_key, upper)
    bad = sum(int((g != w).sum()) for g, w in zip(got, want) if w is not None)
    if bad or (got[1] is None) != (want[1] is None):
        raise AssertionError(f"sorted_lookup {name}: bounds differ at {bad}")
    nq = q_key.numel()
    rec = {"shape": f"{name}: {nq} queries in {s_key.shape[0]} rows"
                    f"{'' if upper else ', lower bound only'}", "max_abs_err": 0.0}
    if timed:
        rec["ms"] = cuda_ms(lambda: hashing.sorted_bounds(s_key, q_key, upper))
        rec["plain_ms"] = cuda_ms(lambda: hashing.sorted_bounds_plain(s_key, q_key, upper))
        rec["library_ms"] = cuda_ms(lambda: (torch.searchsorted(s_key, q_key),
                                             torch.searchsorted(s_key, q_key, right=True)))
        rec["device_ms"] = device_ms(lambda: hashing.sorted_bounds(s_key, q_key, upper))
        rec["library_device_ms"] = device_ms(lambda: (
            torch.searchsorted(s_key, q_key), torch.searchsorted(s_key, q_key, right=True)))
        rec["bound_ms"], rec["bound_by"] = bound_ms(8.0 * s_key.shape[0] + 16.0 * nq, 0.0)
    print(f"# sorted_lookup {json.dumps(rec)}", flush=True)
    return rec


def check_run_offsets(name: str, s_key, num_segments: int, timed: bool = False) -> dict:
    """K16's run offsets against their plain version (searchsorted of
    arange(S+1)), bit for bit; library: that searchsorted, the ids made
    beforehand."""
    got = hashing.run_offsets(s_key, num_segments)
    want = hashing.run_offsets_plain(s_key, num_segments)
    if not torch.equal(got, want):
        raise AssertionError(f"run_offsets {name}: {int((got != want).sum())} offsets differ")
    n = s_key.shape[0]
    rec = {"shape": f"{name}: {n} sorted ids, {num_segments} segments", "max_abs_err": 0.0}
    if timed:
        ids = torch.arange(num_segments + 1, device=s_key.device)
        rec["ms"] = cuda_ms(lambda: hashing.run_offsets(s_key, num_segments))
        rec["plain_ms"] = cuda_ms(lambda: hashing.run_offsets_plain(s_key, num_segments))
        rec["library_ms"] = cuda_ms(lambda: torch.searchsorted(s_key, ids, out_int32=True))
        rec["device_ms"] = device_ms(lambda: hashing.run_offsets(s_key, num_segments))
        rec["library_device_ms"] = device_ms(
            lambda: torch.searchsorted(s_key, ids, out_int32=True))
        rec["bound_ms"], rec["bound_by"] = bound_ms(8.0 * n + 4.0 * (num_segments + 1), 0.0)
    print(f"# run_offsets {json.dumps(rec)}", flush=True)
    return rec


def check_neighbor_map(name: str, lv, timed: bool = False) -> dict:
    """K16's neighbour mode against its plain version (26 packed queries a
    row through searchsorted), bit for bit; library: searchsorted of the
    materialised (V, 27) query keys."""
    args = (lv.khi, lv.klo, lv.coords, lv.batch, lv.valid)
    got = hashing.neighbor_map(*args)
    want = hashing.neighbor_map_plain(*args)
    if not torch.equal(got, want):
        raise AssertionError(f"neighbor_map {name}: {int((got != want).sum())} slots differ")
    if lv.nbr_idx is not None and not torch.equal(got, lv.nbr_idx):
        raise AssertionError(f"neighbor_map {name}: differs from the plan's kernel map")
    cap = lv.cap
    rec = {"shape": f"{name}: {cap} rows x 27 taps, {int(lv.count)} valid", "max_abs_err": 0.0}
    if timed:
        offs = torch.tensor(hashing.KERNEL_OFFSETS, dtype=torch.int32, device=lv.valid.device)
        table = hashing.pack_key(lv.khi, lv.klo)
        q = hashing.pack_key(*hashing.pack(lv.batch[:, None].expand(-1, 27),
                                           (lv.coords[:, None, :] + offs).clamp(0, 1023)))
        rec["ms"] = cuda_ms(lambda: hashing.neighbor_map(*args))
        rec["plain_ms"] = cuda_ms(lambda: hashing.neighbor_map_plain(*args))
        rec["library_ms"] = cuda_ms(lambda: torch.searchsorted(table, q))
        # live rows only: an invalid row's thread reads its valid flag and
        # writes cap, never its key, coords or batch
        n_live = int(lv.valid.sum())
        rec["bound_ms"], rec["bound_by"] = bound_ms(24.0 * n_live + (1.0 + 108.0) * cap, 0.0)
    print(f"# neighbor_map {json.dumps(rec)}", flush=True)
    return rec


def check_unique_compact(name: str, s_key, s_valid, perm, cap, timed: bool = False) -> dict:
    """K17 against its plain version: first flags, segment ids, n_unique
    and (with a ``cap``) every table field, bit for bit; library:
    torch.unique_consecutive(return_inverse=True) and the inverse scattered
    back to input order."""
    got = hashing.unique_compact(s_key, s_valid, perm, cap)
    want = hashing.unique_compact_plain(s_key, s_valid, perm, cap)
    bad = [f for f in hashing.Unique._fields
           if not torch.equal(getattr(got[0], f), getattr(want[0], f))]
    if cap is not None:
        bad += [f for f in hashing.Table._fields
                if not torch.equal(getattr(got[1], f), getattr(want[1], f))]
    if bad:
        raise AssertionError(f"unique_compact {name}: {bad} differ")
    n = s_key.shape[0]
    rec = {"shape": f"{name}: {n} rows, cap {cap}, {int(got[0].n_unique)} unique",
           "max_abs_err": 0.0}
    if timed:
        def library():
            _, inv = torch.unique_consecutive(s_key, return_inverse=True)
            r2v = torch.empty_like(inv)
            r2v[perm.long()] = inv
            return r2v

        rec["ms"] = cuda_ms(lambda: hashing.unique_compact(s_key, s_valid, perm, cap))
        rec["plain_ms"] = cuda_ms(lambda: hashing.unique_compact_plain(s_key, s_valid, perm, cap))
        rec["library_ms"] = cuda_ms(library)
        # a row's key is read only where it or the next row is valid
        # (is_first); valid, perm, first, seg and row2voxel move for every
        # row, the table's 29 bytes for every slot, and 3 scalars
        key_rows = int((s_valid | torch.cat([s_valid[1:], torch.zeros_like(s_valid[:1])])).sum())
        row_b = 14.0 if cap is not None else 6.0
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            8.0 * key_rows + row_b * n + 29.0 * (cap or 0) + 12.0, 0.0)
    print(f"# unique_compact {json.dumps(rec)}", flush=True)
    return rec


def plan_kernel_checks(dev) -> dict:
    """K15-K17 against their plain versions bit for bit at the main path's
    shapes on the first val scene of the golden PointGroup eval (the device
    plan's levels, make_units' keys, the ball query's unit table and run
    bounds, a segment CSR) and on adversarial inputs; each kernel timed at
    its first shape, K15 also at the ball query's unit cells and the unit
    CSR's ids (with segment_csr's bits), K16's run offsets at that CSR.
    Returns {kernel: [records], "neighbor_map": [...], "run_offsets":
    [...]}."""
    cfg = EvalConfig()
    scan_id, scene = synthetic_val_scenes(cfg)[0]
    b = collate([eval_item(cfg, scene, scan_id)], eval_caps(cfg))
    tb = batch_to_torch(b, dev)
    caps, n_levels = backbone_caps(cfg), len(cfg.net.blocks)
    plan, _, _ = sparse.build_plan(tb["voxel_batch"], tb["voxel_coords"], tb["voxel_mask"],
                                   caps, n_levels)
    g = torch.Generator(device="cpu").manual_seed(12)
    res = {"key_sort": [], "sorted_lookup": [], "unique_compact": [], "neighbor_map": [],
           "run_offsets": []}

    key_l0 = _level_keys(tb["voxel_batch"], tb["voxel_coords"], tb["voxel_mask"])
    top = plan.levels[n_levels - 2]
    key_top = _level_keys(top.batch, top.coords >> 1, top.valid)
    sem = tb["sem_labels"].long().clamp(min=0)
    obj = tb["point_mask"] & (tb["sem_labels"].long() >= len(cfg.ignore_classes))
    z = torch.zeros_like(sem)
    key_units = _level_keys(tb["p2v"], torch.stack([sem.clamp(max=1023), z, z], 1), obj)
    caps_s = StaticCaps.from_cfg(cfg)
    units, _ = gm.make_units(tb["p2v"], sem, obj, caps_s.cluster_units)
    u_coords, u_batch, u_active, u_group, uid, _ = cluster.unit_table(
        tb["point_xyz"], tb["vert_batch_ids"], obj, sem, units, caps_s.cluster_units)
    cell, key_hi, key_bq = ballquery.table_keys(u_coords, u_batch, u_active,
                                                cfg.net.cluster_radius, u_group)
    seg = torch.where(uid < caps_s.cluster_units, uid, torch.full_like(uid, caps_s.cluster_units))
    seg_rand = torch.randint(0, 131073, (262144,), generator=g).to(dev)
    rand_neg = torch.randint(-2**62, 2**62, (70000,), generator=g).to(dev)
    adversarial = {
        "all keys equal": torch.full((10000,), 7, dtype=torch.int64, device=dev),
        "already sorted": torch.arange(5000, device=dev) * 3,
        "reversed": torch.arange(5000, device=dev).flip(0) * 3,
        "n = 1": torch.tensor([5], device=dev),
        "n = 4097 (not a multiple of the tile)": torch.randint(0, 100, (4097,),
                                                               generator=g).to(dev),
        "all rows invalid": torch.full((6000,), (hashing.SENTINEL << 31) | hashing.SENTINEL,
                                       dtype=torch.int64, device=dev),
        "random int64 with negatives": rand_neg,
    }
    u_bits = caps_s.cluster_units.bit_length()     # segment_csr's bits for the unit ids
    res["key_sort"].append(check_key_sort(f"plan L0 keys ({caps[0]} voxel rows)", key_l0, True))
    res["key_sort"].append(check_key_sort("ball-query unit cells", key_bq, True))
    res["key_sort"].append(check_key_sort("segment_csr unit ids", seg, True, u_bits))
    for name, key, bits in (("plan L6 input keys (level 5 rows)", key_top, 64),
                            ("make_units keys", key_units, 64),
                            ("segment_csr unit ids, all 64 bits", seg, 64),
                            ("segment_csr random ids", seg_rand, 18),
                            ("segment_csr random ids, all 64 bits", seg_rand, 64),
                            *((name, key, 64) for name, key in adversarial.items())):
        res["key_sort"].append(check_key_sort(name, key, bits=bits))

    s_bq, _ = hashing.key_sort(key_bq)
    offs = torch.tensor(ballquery.cell_offsets(caps_s.half_space), dtype=torch.int64,
                        device=dev)
    q_bq, _ = ballquery.query_keys(cell, key_hi, u_active, offs)
    res["sorted_lookup"].append(check_sorted_bounds(
        f"K2 run bounds ({q_bq.shape[0]} units x {q_bq.shape[1]} cells)", s_bq, q_bq, True))
    s_seg, _ = hashing.key_sort(seg)
    res["sorted_lookup"].append(check_sorted_bounds(
        "segment_csr offsets", s_seg, torch.arange(caps_s.cluster_units + 1, device=dev),
        upper=False))
    res["run_offsets"].append(check_run_offsets("segment_csr unit ids", s_seg,
                                                caps_s.cluster_units, True))
    s_rand, _ = hashing.key_sort(seg_rand)
    for name, ids, n_seg in (("random ids, empty segments and padding", s_rand, 131072),
                             ("all padding", torch.full((6000,), 4000, device=dev), 4000),
                             ("one segment", torch.full((5000,), 17, device=dev), 4000),
                             ("no rows", torch.zeros(0, dtype=torch.int64, device=dev), 100)):
        res["run_offsets"].append(check_run_offsets(name, ids, n_seg))
    eq = adversarial["all keys equal"]
    probes = torch.tensor([-1, 6, 7, 8, 2**62], device=dev)
    for name, table, q in (("table of 1 row", adversarial["n = 1"], probes),
                           ("all table keys equal", eq, probes),
                           ("random int64 queries", torch.sort(rand_neg)[0], rand_neg[::3])):
        res["sorted_lookup"].append(check_sorted_bounds(name, table, q))
    for lvl, lv in enumerate(plan.levels):
        res["neighbor_map"].append(check_neighbor_map(f"plan L{lvl}", lv, lvl == 0))

    s_l0, p_l0 = hashing.key_sort(key_l0)
    res["unique_compact"].append(check_unique_compact(
        "plan L0", s_l0, tb["voxel_mask"][p_l0.long()], p_l0, caps[0], True))
    s_u, p_u = hashing.key_sort(key_units)
    res["unique_compact"].append(check_unique_compact(
        "make_units", s_u, obj[p_u.long()], p_u, caps_s.cluster_units))
    res["unique_compact"].append(check_unique_compact(
        "plan L0 into cap 4096 (overflow)", s_l0, tb["voxel_mask"][p_l0.long()], p_l0, 4096))
    res["unique_compact"].append(check_unique_compact(
        "unique_sorted (no table)", s_l0, tb["voxel_mask"][p_l0.long()], None, None))
    for name in ("all keys equal", "n = 1", "n = 4097 (not a multiple of the tile)",
                 "all rows invalid"):
        s, p = hashing.key_sort(adversarial[name])
        valid = torch.rand(s.shape[0], generator=g).to(dev) < 0.8
        if name == "all rows invalid":
            valid = torch.zeros_like(valid)
        res["unique_compact"].append(check_unique_compact(name, s, valid, p, 2048))
    return res


def _outputs_differ(a, b, prefix: str = "") -> list:
    """The keys of two model outputs (nested dicts of tensors) that are not
    bit-identical."""
    bad = []
    for k, v in a.items():
        if isinstance(v, dict):
            bad += _outputs_differ(v, b[k], f"{prefix}{k}.")
        elif torch.is_tensor(v) and not _bit_equal(v, b[k]):
            bad.append(prefix + k)
    return bad


def build_plan_checked(tb: dict, caps: list, n_levels: int) -> tuple:
    """The device plan of a batch, built with torch's sync debug mode at
    "error", and then the conv tables a forward pass builds from it (K1's
    tap orders on K22): any host-device sync in either raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = sparse.build_plan(tb["voxel_batch"], tb["voxel_coords"], tb["voxel_mask"], caps,
                                n_levels, tb["voxel_feats"])
        sparse_conv.conv_tables(out[0])
        return out
    finally:
        torch.cuda.set_sync_debug_mode("default")


def device_plan_main(dev) -> dict:
    """The three models' golden eval configs (f32, full width, 3 val
    scenes) with ``host_plan=false``: per scene the card's plan (no sync)
    equals the host plan bit for bit; the forward with the device plan
    equals the host-plan forward bit for bit, on seeded weights and in the
    heads on ground-truth outputs; host input with and without the host
    plan, the plan build's device ms and both forwards' ms. Then one
    full-width PointGroup f32 train step with host_plan=false against the
    host-plan step. Returns {model: launches of the host_plan=false
    forwards} and {"PointGroup train": launches of that step}."""
    res = {}
    for model_name, cls in EVAL_CONFIGS.items():
        cfg = cls().with_overrides({"host_plan": False})
        caps, n_levels = backbone_caps(cfg), len(cfg.net.blocks)
        model = seeded_model(cfg, 0, dev)
        flags = get_model(cfg.MODEL).forward_flags(cfg, 100, False)
        scenes, rep = [], {"host_input_ms": [], "host_input_no_plan_ms": [], "host_plan_ms": [],
                           "device_plan_ms": [], "device_plan_device_ms": [],
                           "device_plan_bound_ms": [],
                           "forward_device_plan_ms": [],
                           "forward_host_plan_ms": []}
        for scan_id, scene in synthetic_val_scenes(cfg):
            t0 = time.perf_counter()
            b = collate([eval_item(cfg, scene, scan_id)], eval_caps(cfg))
            t1 = time.perf_counter()
            hp = build_plan_host(b["voxel_batch"], b["voxel_coords"], b["voxel_mask"], caps,
                                 n_levels)
            t2 = time.perf_counter()
            rep["host_input_no_plan_ms"].append((t1 - t0) * 1e3)
            rep["host_plan_ms"].append((t2 - t1) * 1e3)
            rep["host_input_ms"].append((t2 - t0) * 1e3)
            tb = batch_to_torch(b, dev)
            plan, r2v, feats = build_plan_checked(tb, caps, n_levels)
            got = {k: v.cpu() for k, v in sparse.plan_arrays(plan, r2v).items()}
            want = {k: torch.as_tensor(np.asarray(v)) for k, v in hp.items()
                    if k != "plan0_featsrc"}
            src = hp["plan0_featsrc"]
            want_feats = np.where((src >= 0)[:, None], b["voxel_feats"][np.maximum(src, 0)], 0)
            bad = sorted(set(got) ^ set(want)) + [k for k in want if k in got
                                                  and not _bit_equal(got[k], want[k])]
            if bad or not _bit_equal(feats.cpu(), torch.from_numpy(want_feats)):
                raise AssertionError(f"device_plan_main {model_name} {scan_id}: the card's plan "
                                     f"differs from the host plan: {bad[:8]} (features equal "
                                     f"{_bit_equal(feats.cpu(), torch.from_numpy(want_feats))})")
            rep["device_plan_ms"].append(cuda_ms(lambda: sparse.device_plan(tb, caps, n_levels),
                                                 reps=5))
            # the card's own share of it (the rest is the host's op issue)
            rep["device_plan_device_ms"].append(
                device_ms(lambda: sparse.device_plan(tb, caps, n_levels), reps=5))
            # the least the plan build must move: its inputs read once, the
            # plan's arrays and the level-0 features written once
            nb = sum(tb[k].numel() * tb[k].element_size() for k in
                     ("voxel_batch", "voxel_coords", "voxel_mask", "voxel_feats", "p2v"))
            nb += sum(v.numel() * v.element_size()
                      for v in sparse.plan_arrays(plan, r2v).values())
            rep["device_plan_bound_ms"].append(
                bound_ms(nb + feats.numel() * feats.element_size(), 0.0)[0])
            scenes.append((b, hp, tb))
        print(f"# device_plan_main {model_name}: the card's plan (no host-device sync under "
              f"set_sync_debug_mode('error'), nor in its conv tables' tap orders) equals the "
              f"host plan bit for bit on "
              f"{len(scenes)} scenes: {len(want)} plan arrays and the level-0 features",
              flush=True)

        outs = []
        build.reset_launches()
        with torch.no_grad():
            for b, _, tb in scenes:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs.append(model(tb, **flags))
                torch.cuda.synchronize()
                rep["forward_device_plan_ms"].append((time.perf_counter() - t0) * 1e3)
        res[model_name] = dict(build.LAUNCHES)
        missing = [k for k in ("key_sort", "sorted_lookup", "unique_compact", "gather_gemm")
                   if res[model_name][k] == 0]
        if missing:
            raise AssertionError(f"device_plan_main {model_name}: never launched {missing}")
        with torch.no_grad():
            for i, ((b, hp, tb), out) in enumerate(zip(scenes, outs)):
                tb_hp = batch_to_torch(dict(b, **hp), dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = model(tb_hp, **flags)
                torch.cuda.synchronize()
                rep["forward_host_plan_ms"].append((time.perf_counter() - t0) * 1e3)
                bad = _outputs_differ(out, want)
                inj = injected_backbone_outputs(b, cfg.classes, cfg.net.m, 20 + i, dev)
                gt_dp, gt_hp = model.heads(tb, inj, **flags), model.heads(tb_hp, inj, **flags)
                bad += [f"gt {k}" for k in _outputs_differ(gt_dp, gt_hp)]
                if bad or int(gt_dp["proposal_rows"]["n_proposals"]) == 0:
                    raise AssertionError(f"device_plan_main {model_name} scene {i}: host_plan="
                                         f"false differs from host_plan=true in {bad[:8]} (or no "
                                         f"proposal on ground-truth outputs)")
        print(f"# device_plan_main {model_name}: host_plan=false forward equals host_plan=true "
              f"bit for bit (outputs, diag {dict((k, int(v)) for k, v in outs[0]['diag'].items())}"
              f"; heads on ground-truth outputs too); {json.dumps(rep)}; launches "
              f"{res[model_name]}", flush=True)

    cfg = TrainConfig().with_overrides(MAIN_TRAIN)
    cfg_dp = cfg.with_overrides({"host_plan": False})
    data = TrainData(cfg)
    data_dp = TrainData(cfg_dp, data.scenes)
    steps = []
    for c, d in ((cfg, data), (cfg_dp, data_dp)):
        batch = d.batch(1, [0, 1])
        tr = Trainer(c, d, dev, seed=11)
        tr.epoch = 1
        build.reset_launches()
        out, losses, total = tr.forward(batch_to_torch(batch, dev))
        tr.backward(total)
        torch.cuda.synchronize()
        grads = {k: p.grad.detach().clone() for k, p in tr.model.named_parameters()
                 if p.grad is not None}
        steps.append(({k: v.detach() for k, v in losses.items()}, grads,
                      int(out["proposal_rows"]["n_proposals"]), dict(build.LAUNCHES),
                      "plan0_nbr" in batch))
    (l1, g1, n1, _, has1), (l2, g2, n2, launches, has2) = steps
    bad = [k for k in l1 if not _bit_equal(l1[k], l2[k])]
    bad += [k for k in g1 if k not in g2 or not _bit_equal(g1[k], g2[k])]
    if bad or g1.keys() != g2.keys() or n1 != n2 or n1 == 0 or not has1 or has2:
        raise AssertionError(f"device_plan_main train step: host_plan=false differs from "
                             f"host_plan=true: {bad[:8]}, proposals {n1} / {n2}")
    print(f"# device_plan_main PointGroup train step (heads on, {n1} proposals): losses "
          f"{ {k: float(v) for k, v in l1.items()} } and {len(g1)} gradients bit-identical "
          f"with the device plan; launches {launches}", flush=True)
    res["PointGroup train"] = launches
    return res


def cc_graphs(dev) -> list:
    """Every connected-components input of PointGroup's, HAIS's and
    SoftGroup's heads (golden eval configs, full size) on the first val
    scene fed ground-truth outputs, captured as the heads make it:
    [(tag, (nbr, nbr_valid, active, group, max_iters, coarsen,
    coarsen_sweeps))]."""
    graphs = []
    for cfg in (EvalConfig(), HaisEvalConfig(), SoftGroupEvalConfig()):
        with capture(cluster, "connected_components") as calls:
            heads_on_scene(cfg, 4, dev)
        if not calls:
            raise AssertionError(f"cc_checks: {cfg.MODEL}'s heads ran no connected components")
        graphs += [(f"{cfg.MODEL} #{i}", c) for i, c in enumerate(calls)]
    return graphs


def cc_counts(res) -> tuple:
    """(unconverged, sweeps, pair sweeps, distinct cross-root pairs) of a
    CCResult as ints."""
    return tuple(int(v) for v in res[1:])


def cc_call(graph: tuple, max_iters: int, coarsen: int, sweeps: int):
    """One K3 call (K18 when coarsening) under set_sync_debug_mode("error"):
    any host-device sync in it raises. Returns (CCResult, its launches)."""
    before = build.LAUNCHES["connected_components"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = cluster.connected_components_cuda(*graph, max_iters, coarsen, sweeps)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return res, build.LAUNCHES["connected_components"] - before


def check_cc(tag: str, graph: tuple, max_iters: int, coarsen: int, sweeps: int) -> tuple:
    """K3 (with K18 when coarsening) against the plain sweeps on the card:
    labels, unconverged, both sweep counts and the distinct cross-root
    pairs; the call makes no host sync and at most CC_MAX_LAUNCHES launches.
    Returns (result, its launches)."""
    got, launches = cc_call(graph, max_iters, coarsen, sweeps)
    want = cluster.connected_components_plain(*graph, max_iters, coarsen, sweeps)
    if (not torch.equal(got.labels, want.labels) or cc_counts(got) != cc_counts(want)
            or any(t.device != got.labels.device for t in got[1:])):
        raise AssertionError(f"cc_checks {tag} (max_iters {max_iters}, coarsen {coarsen}, "
                             f"sweeps {sweeps}): {int((got.labels != want.labels).sum())} "
                             f"labels differ; {cc_counts(got)} against {cc_counts(want)}")
    if launches > CC_MAX_LAUNCHES:
        raise AssertionError(f"cc_checks {tag}: {launches} launches a call")
    return got, launches


# the parent design's CC call on PointGroup's graph #0 (a launch a phase,
# the flag read after each sweep; the chip runs of chip_smoke.py at commit
# b154c21 on an H100 80GB HBM3, 700 W): event ms of a call and its phases
CC_PARENT_MS = {"call_coarsen_4096": [1.01, 1.25], "call_coarsen_0": [0.62, 0.75],
                "extraction": [0.080, 0.099], "key_sort": [0.044, 0.067],
                "unique_compact": [0.107, 0.150], "pair_sweep": [0.086, 0.121],
                "host_syncs_coarsen_4096": 8, "host_syncs_coarsen_0": 6}
CC_MAX_LAUNCHES = 4
CC_LATTICE = ((64, 64, 64), 16, 7)   # cc_graph.lattice's dims, K, seed


def cc_checks(dev) -> tuple:
    """K3 and K18 on the unit graphs of the three golden models' heads and
    on a seeded lattice whose pair list overflows (cc_graph.lattice
    (64, 64, 64), K 16: ~455k cross-root edge slots, ~15k distinct pairs):
    bit for bit against the plain sweeps at the captured budget (cc_iters
    32, cc_coarsen 4096, 2 sweeps), without coarsening, at a truncated
    budget (max_iters 1, with and without coarsening) and with an
    overflowing list of 4 pairs; each call under set_sync_debug_mode
    ("error") with its launches counted (at most CC_MAX_LAUNCHES). Then one
    CC call on PointGroup's first graph and on the lattice timed at
    cc_coarsen 0 and 4096: event ms, torch.profiler device ms, launches,
    beside the parent design's figures. Returns the K3 record (PointGroup's
    graph, no coarsening) and the K18 record (the same graph, coarsened)."""
    graphs = cc_graphs(dev)
    lattice = [torch.from_numpy(a).to(dev) for a in cc_graph.lattice(*CC_LATTICE)]
    graphs.append((f"lattice {CC_LATTICE[0]} K {CC_LATTICE[1]}",
                   (*lattice, 32, 4096, 2)))
    for tag, (nbr, ok, active, group, max_iters, coarsen, sweeps) in graphs:
        graph = (nbr, ok, active, group)
        main, launches = check_cc(tag, graph, max_iters, coarsen, sweeps)
        if coarsen <= 0 or int(main.unconverged):
            raise AssertionError(f"cc_checks {tag}: coarsen {coarsen}, unconverged "
                                 f"{int(main.unconverged)} on the main path")
        runs = {"main": cc_counts(main)}
        calls = [launches]
        for name, mi, co in (("no_coarsen", max_iters, 0), ("truncated", 1, 0),
                             ("truncated_coarse", 1, coarsen), ("overflow", 1, 4)):
            res, launches = check_cc(tag, graph, mi, co, sweeps)
            calls.append(launches)
            if name != "no_coarsen" and not torch.equal(res.labels, main.labels):
                runs[name + "_differs"] = int((res.labels != main.labels).sum())
            runs[name] = cc_counts(res)
        if tag.startswith("lattice") and runs["main"][3] <= coarsen:
            raise AssertionError(f"cc_checks {tag}: the pair list does not overflow {runs}")
        print(f"# cc_checks {tag}: {int(active.sum())} of {nbr.shape[0]} units, K "
              f"{nbr.shape[1]}; (unconverged, sweeps, pair sweeps, distinct pairs) card "
              f"equals plain, no host sync, launches a call {calls}: {runs}", flush=True)

    recs = {}
    for tag, (nbr, ok, active, group, max_iters, coarsen, sweeps) in (graphs[0], graphs[-1]):
        graph = (nbr, ok, active, group)
        n, k = nbr.shape
        n_act = int(active.sum())
        # the labels' function reads active (1 byte a unit), the active
        # units' rows of the table (4 + 1 bytes a slot) and groups, and
        # writes every label once (int64)
        b_ms, b_by = bound_ms(n + n_act * (k * 5 + 4) + 8 * n, 0.0)
        for co in (0, coarsen):
            res, launches = cc_call(graph, max_iters, co, sweeps)
            rec = {"shape": f"{tag}: {n} units x K {k}, {n_act} active, cc_coarsen {co}",
                   "max_abs_err": 0.0, "launches_a_call": launches, "host_syncs_a_call": 0,
                   "counts": cc_counts(res), "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": None,
                   "ms": cuda_ms(lambda co=co: cluster.connected_components_cuda(
                       *graph, max_iters, co, sweeps)),
                   "device_ms": device_ms(lambda co=co: cluster.connected_components_cuda(
                       *graph, max_iters, co, sweeps)),
                   "plain_ms": cuda_ms(lambda co=co: cluster.connected_components_plain(
                       *graph, max_iters, co, sweeps))}
            if co == 0:   # the same call cut to 2 sweeps: device ms a sweep
                rec["device_ms_2_sweeps"] = device_ms(
                    lambda: cluster.connected_components_cuda(*graph, 0, 0, sweeps))
            rec["host_ms"] = host_ms(lambda co=co: cluster.connected_components_cuda(
                *graph, max_iters, co, sweeps))
            if tag == graphs[0][0]:
                rec["parent_ms"] = CC_PARENT_MS[f"call_coarsen_{co}"]
                rec["parent_host_syncs"] = CC_PARENT_MS[f"host_syncs_coarsen_{co}"]
            recs[(tag, co)] = rec
            print(f"# cc_checks timing {json.dumps(rec)}", flush=True)
    print(f"# cc_checks parent design (chip runs at b154c21) {json.dumps(CC_PARENT_MS)}",
          flush=True)
    pg = graphs[0]
    return recs[(pg[0], 0)], recs[(pg[0], pg[1][5])]


def probe_kernels() -> tuple:
    """The gather probe's path: its entry point ``probe_cuda.main`` at the
    probe's shapes (V 119808, C 128, tile 4608), which holds K19-K21 against
    their plain versions bit for bit and times each beside its plain
    version, ``x * 2`` / ``x[rows]`` and its bound; launch counts reset just
    before and read just after. Returns (records, launches)."""
    build.reset_launches()
    recs = probe_cuda.main(["--reps", "10"])
    launches = dict(build.LAUNCHES)
    missing = [k for k in PROBE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"probe path never launched: {missing}")
    print(f"# probe_kernels launches { {k: launches[k] for k in PROBE_KERNELS} }", flush=True)
    return recs, launches


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
    k1, k2, k3_graph = kernel_checks(cfg, dev)
    k1_every_width(dev)
    new_kernels = new_kernel_checks(dev, k3_graph)
    new_kernels.update(softgroup_kernel_checks(dev))
    t0 = phase("kernels", t0)

    plan_kernels = plan_kernel_checks(dev)
    t0 = phase("plan_kernel_checks", t0)

    k3, k18 = cc_checks(dev)
    t0 = phase("cc_checks", t0)

    probe_recs, probe_launches = probe_kernels()
    t0 = phase("probe_kernels", t0)

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
                           "cc_coarsen", "segment_reduce", "proposal_voxelize", "unit_compact",
                           "tap_orders", *PLAN_KERNELS)
               if eval_launches[k] == 0]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")
    check_outputs(cfg, model, dev)
    t0 = phase("main", t0)

    hais_launches, hais_gt_launches, kinds, hais_metrics = inference_phase(
        HaisEvalConfig(), dev, ("gather_gemm", "ball_query_edge", "connected_components",
                                "cc_coarsen", "segment_reduce", "proposal_voxelize",
                                "set_aggregation", "unit_compact", "tap_orders",
                                *PLAN_KERNELS))
    if sum(k["absorbed"] for k in kinds) == 0:
        raise AssertionError("hais heads on ground-truth outputs: no fragment was absorbed")
    t0 = phase("hais", t0)

    sg_launches, sg_gt_launches, _, sg_metrics = inference_phase(
        SoftGroupEvalConfig(), dev, ("gather_gemm", "ball_query_edge", "connected_components",
                                     "cc_coarsen", "segment_reduce", "proposal_voxelize",
                                     "unit_compact", "stable_partition", "proposal_rank",
                                     "tap_orders", *PLAN_KERNELS))
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

    cv_kernels = cluster_variant_kernels(dev)
    t0 = phase("cluster_variant_kernels", t0)

    cv_parity = cluster_variant_parity(dev)
    t0 = phase("cluster_variant_parity", t0)

    cv_main = cluster_variant_main(dev)
    t0 = phase("cluster_variant_main", t0)

    dp_main = device_plan_main(dev)
    t0 = phase("device_plan_main", t0)

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
               "gather_wgrad": pg_subm_l0(k4), "proposal_iou": k5,
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
        records[kname] = (bf16_train_kernels[kname][0] if kname == "segment_reduce_bf16_sum"
                          else pg_subm_l0(bf16_train_kernels[kname]))
        own[kname] = bf16_train["PointGroup"]["launches"]
    # K14: PointGroup's inference path under the bench clustering (this
    # slice's main path), the record at its xyz clustering's shape
    repl["ball_query_grid"] = "minsu3d_tpu/ops/ballquery.py:176"
    src["ball_query_grid"] = "minsu3d_tpu_torch/csrc/ball_query_grid.cu"
    records["ball_query_grid"] = cv_kernels["ball_query_grid"][0]
    own["ball_query_grid"] = cv_main["PointGroup"][0]
    # K15-K17: the device plan's inference path (host_plan=false, PointGroup,
    # this slice's main path); the record at the plan's level-0 shapes
    repl.update(key_sort="minsu3d_tpu/ops/hashing.py:53",
                sorted_lookup="minsu3d_tpu/ops/hashing.py:103",
                unique_compact="minsu3d_tpu/ops/hashing.py:158")
    src.update(key_sort="minsu3d_tpu_torch/csrc/key_sort.cu",
               sorted_lookup="minsu3d_tpu_torch/csrc/sorted_lookup.cu",
               unique_compact="minsu3d_tpu_torch/csrc/unique_compact.cu")
    for kname in PLAN_KERNELS:
        records[kname] = plan_kernels[kname][0]
        own[kname] = dp_main["PointGroup"]
    # K18: the golden PointGroup inference path (coarsening on by default),
    # the record at its xyz clustering's unit graph; K19-K21: the gather
    # probe's path (probe_cuda.main), the records at the probe's shapes
    repl.update(cc_coarsen="minsu3d_tpu/ops/cluster.py:102",
                probe_double="tools/probe_pallas.py:59",
                window_gather="tools/probe_pallas.py:73",
                onehot_gather="tools/probe_pallas.py:111")
    src["cc_coarsen"] = src["connected_components"]
    records["cc_coarsen"] = k18
    own["cc_coarsen"] = eval_launches
    # K22: K1's tile orders on the golden PointGroup inference path, the
    # record at its plan's 19 tables
    repl["tap_orders"] = repl["gather_gemm"]
    src["tap_orders"] = "minsu3d_tpu_torch/csrc/tap_order.cu"
    records["tap_orders"] = TAP_RECORDS[0]
    own["tap_orders"] = eval_launches
    for kname in PROBE_KERNELS:
        src[kname] = "minsu3d_tpu_torch/csrc/probe_gather.cu"
        records[kname] = probe_recs[kname]
        own[kname] = probe_launches
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
            **{f"launches_cluster_variant_{m.lower()}": r[0][kname]
               for m, r in cv_main.items() if m in CLUSTER_PATHS},
            **{f"launches_cluster_variant_{m.lower()}_gt_heads": r[1][kname]
               for m, r in cv_main.items() if m in CLUSTER_PATHS},
            "launches_cluster_variant_pointgroup_train_step":
                cv_main["PointGroup train"][kname],
            **{f"launches_parity_{v.lower().replace(' ', '_')}": r[kname]
               for v, r in cv_parity.items()},
            **{f"launches_device_plan_{m.lower().replace(' ', '_')}": r[kname]
               for m, r in dp_main.items()},
            "launches_probe": probe_launches[kname],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms"), "shape": rec["shape"],
            **{k: rec[k] for k in ("device_ms", "batch_ms", "exact_floor_ms") if k in rec}})
        if kname == "ball_query_grid":   # the other shapes it was held at
            kernels[-1]["other_shapes"] = cv_kernels["ball_query_grid"][1:]
        if kname == "ball_query_edge":   # the fused query: K2 with no edge cap
            kernels[-1]["no_edge_cap"] = cv_kernels["ball_query_no_edge_cap"]
        if kname == "unit_compact":      # compact_labels at point granularity
            kernels[-1]["compact_labels"] = cv_kernels["compact_labels"][0]
            kernels[-1]["other_shapes"] = new_kernels["unit_compact"][1:]
        if kname == "segment_reduce":   # every other shape the models launch it with
            kernels[-1]["other_shapes"] = new_kernels["segment_reduce"][1:]
        if kname == "segment_reduce_bf16_sum":   # bf16 max and min, on no model path
            kernels[-1]["max_min"] = bf16_kernels["segment_reduce_bf16"]
        if kname in PLAN_KERNELS:      # the other shapes it was held at
            kernels[-1]["other_shapes"] = plan_kernels[kname][1:]
        if kname == "sorted_lookup":   # neighbour mode, the plan's kernel maps
            kernels[-1]["neighbor_mode"] = plan_kernels["neighbor_map"]
            kernels[-1]["run_offsets"] = plan_kernels["run_offsets"]
        if kname in ("gather_dx_bf16", "gather_wgrad", "gather_wgrad_bf16"):
            # every other conv shape of both training backbones
            shapes = {"gather_wgrad": k4}.get(kname, bf16_train_kernels.get(kname))
            kernels[-1]["other_shapes"] = [
                {k: r.get(k) for k in ("shape", "ms", "device_ms", "batch_ms", "plain_ms",
                                        "bound_ms", "exact_floor_ms", "max_abs_err")}
                for r in shapes if r is not rec]
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
