#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each followed by a ``# phase <name> <seconds>`` line:
  device   require CUDA; print the card's name and power limit (nvidia-smi)
  build    g++ host library and the nvcc kernel library, started together
  kernels  every kernel of the PointGroup inference path against its plain
           PyTorch version on the card, at main-path shapes, seeded inputs:
           gather_gemm (subm conv level 0 and 3, one down, one up conv),
           ball_query_edge and connected_components (bit for bit, including
           an input made to overflow the edge buffer); times by CUDA events
  train_kernels
           the training slice's kernels at the training recipe's shapes
           (131072-voxel caps, batch of 2 augmented train scenes):
           gather_wgrad (the conv weight gradient; subm level 0 and 3, one
           down, one up conv) within 1e-5 of the output scale, and
           proposal_iou bit for bit, on the proposal rows of a heads forward
  small    the full model at a small size on the card against the same
           model on the CPU (plain versions), same seeded weights
  small_train
           one small train step on the card against the CPU: losses, every
           parameter gradient and the Adam update with the heads off; with
           them on (injected ground-truth backbone outputs, same jitter):
           proposals, score_loss and the heads' and point features' gradients
  main     PointGroupNet at full width (m=16, 7 levels, 2 reps) on seeded
           weights through ``minsu3d_tpu_torch.test.evaluate`` on the 3
           synthetic val scenes of the golden eval config; the inference
           kernels' launch counts must move
  train    the training recipe at full width (scripts/train_synth_pointgroup.sh,
           f32): 2 steps with the heads off (epoch 0) and 2 with them on
           (epoch 1, prepare_epochs=0), a checkpoint saved after step 1 and
           loaded into a second trainer, whose step 2 must equal the first
           trainer's; every kernel's launch count must move
Then a ``{"kernels": [...]}`` line and, only on success, the last line
``{"ok": true, "device": {...}}``. Any failure raises (exit code != 0).
Imports only the standard library, numpy, torch and minsu3d_tpu_torch.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from minsu3d_tpu_torch.config import EvalConfig, StaticCaps, TrainConfig, backbone_caps
from minsu3d_tpu_torch.csrc import build
from minsu3d_tpu_torch.data.batching import collate, eval_caps
from minsu3d_tpu_torch.data.datamodule import TrainData
from minsu3d_tpu_torch.data.dataset import eval_item, synthetic_val_scenes
from minsu3d_tpu_torch.model import general_model as gm
from minsu3d_tpu_torch.model import pointgroup
from minsu3d_tpu_torch.ops import ballquery, cluster, instance_iou, sparse_conv
from minsu3d_tpu_torch.ops.sparse import plan_from_batch
from minsu3d_tpu_torch.test import (batch_to_torch, collated_scenes, evaluate,
                                    seeded_model, set_f32_numerics)
from minsu3d_tpu_torch.trainer.trainer import Trainer, max_param_change, param_snapshot

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
K1_RTOL = 1e-5              # f32 sums in another order than the plain matmul
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
# epoch), heads on from epoch 1
MAIN_TRAIN = {"synthetic.train_scenes": 4, "net.prepare_epochs": 0}


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


def bound_ms(n_bytes: float, flops: float) -> tuple:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def live_rows(idx, n: int) -> tuple:
    """What a gather over ``idx`` must touch: the live (row, tap) pairs, the
    distinct rows of x that some live pair reads, and the rows of idx with
    at least one live tap. The bounds count only these rows (a capped
    level's padding rows are never read)."""
    live = (idx >= 0) & (idx < n)
    x_rows = int(torch.unique(idx[live]).numel())
    return int(live.sum()), x_rows, int(live.any(1).sum())


def check_gather_gemm(name: str, x, idx, w) -> dict:
    """K1 against its plain version; returns the record of this shape."""
    got = sparse_conv.gather_gemm(x, idx, w)
    want = sparse_conv.gather_gemm_plain(x, idx, w)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not (math.isfinite(err) and err <= K1_RTOL * max(scale, 1.0)):
        raise AssertionError(f"gather_gemm {name}: max abs err {err} vs scale {scale}")
    live, x_rows, _ = live_rows(idx, x.shape[0])
    nb = 4 * (x_rows * x.shape[1] + idx.numel() + w.numel() + idx.shape[0] * w.shape[2])
    b_ms, b_by = bound_ms(nb, 2.0 * live * w.shape[1] * w.shape[2])
    rec = {"shape": name, "max_abs_err": err, "scale": scale,
           "ms": cuda_ms(lambda: sparse_conv.gather_gemm(x, idx, w)),
           "plain_ms": cuda_ms(lambda: sparse_conv.gather_gemm_plain(x, idx, w)),
           "bound_ms": b_ms, "bound_by": b_by, "live_pairs": live,
           "x_rows_read": x_rows, "x_rows": x.shape[0]}
    print(f"# gather_gemm {json.dumps(rec)}", flush=True)
    return rec


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
    u_coords, u_batch, u_active, u_group, _, _ = cluster.unit_table(
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
    return k1, k2, k3


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


def gt_backbone_outputs(tb: dict, classes: int, m: int, g: torch.Generator) -> dict:
    """Backbone outputs made from the ground truth (noisy one-hot classes,
    noisy instance-centre offsets, random features), so that clustering
    finds the scenes' objects although the weights are seeded."""
    n, dev = tb["point_xyz"].shape[0], tb["point_xyz"].device
    mask = tb["point_mask"][:, None]
    scores = torch.randn((n, classes), generator=g).to(dev)
    scores[torch.arange(n, device=dev), tb["sem_labels"].long().clamp(min=0)] += 4.0
    inst = (tb["instance_ids"] >= 0)[:, None]
    offs = (tb["instance_center_xyz"] - tb["point_xyz"]) * inst
    offs = (offs + 0.01 * torch.randn(offs.shape, generator=g).to(dev)) * mask
    feats = torch.randn((n, m), generator=g).abs().to(dev) * mask
    return {"point_features": feats, "semantic_scores": scores, "point_offsets": offs}


def train_kernel_checks(dev) -> tuple:
    """K4 at the training recipe's conv shapes and K5 on the rows of a
    heads forward, on one batch of 2 augmented full-width train scenes."""
    cfg = TrainConfig()
    g = torch.Generator(device="cpu").manual_seed(1)
    data = TrainData(cfg.with_overrides({"synthetic.train_scenes": 2}))
    tb = batch_to_torch(data.batch(0, [0, 1]), dev)
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
        out = model.heads(tb, gt_backbone_outputs(tb, cfg.classes, m, g))
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
    injected = gt_backbone_outputs(batch_to_torch(batch, "cpu"), cfg.classes, cfg.net.m, g)
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


def train_main(dev) -> dict:
    """The training recipe at full width: steps 1-2 heads off, 3-4 heads on,
    checkpoint after step 1; returns launches and step records."""
    cfg = TrainConfig().with_overrides(MAIN_TRAIN)
    data = TrainData(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        build.reset_launches()
        a = Trainer(cfg, data, dev, out_dir=tmp)
        snap = param_snapshot(a.model)
        recs, ck = [], None
        for step in range(1, 5):
            heads = a.heads_active
            t0 = time.perf_counter()
            rec = a.step()
            torch.cuda.synchronize()
            rec.update(step=step, heads=heads, ms=(time.perf_counter() - t0) * 1e3)
            recs.append(rec)
            print(f"# train step {step} heads={int(heads)} ms {rec['ms']:.1f} losses "
                  f"{rec['losses']} diag {rec['diag']}", flush=True)
            if step == 1:
                ck = a.save_checkpoint(os.path.join(tmp, "step1.pt"))
        launches = dict(build.LAUNCHES)
        moved = max_param_change(snap, a.model)
        b = Trainer(cfg, data, dev, seed=cfg.global_train_seed + 1)
        b.load_checkpoint(ck)
        resumed = b.step()["losses"]
        metrics = open(os.path.join(tmp, "metrics.jsonl")).read().splitlines()
    print(f"# train launches {launches}", flush=True)
    for rec in recs:
        if not all(math.isfinite(v) for v in rec["losses"].values()):
            raise AssertionError(f"train step {rec['step']}: non-finite losses {rec['losses']}")
        if ("score_loss" in rec["losses"]) != rec["heads"]:
            raise AssertionError(f"train step {rec['step']}: score_loss present "
                                 f"{'score_loss' in rec['losses']} with heads {rec['heads']}")
    if [r["heads"] for r in recs] != [False, False, True, True]:
        raise AssertionError(f"train: head phases {[r['heads'] for r in recs]}")
    if not moved > 0:
        raise AssertionError("train: the parameters did not change")
    want = recs[1]["losses"]
    for k, v in want.items():
        if not abs(resumed[k] - v) <= RESUME_RTOL * max(abs(v), 1e-6):
            raise AssertionError(f"train resume: step 2 {k} {resumed[k]} after the round trip, "
                                 f"{v} without")
    print(f"# train resume: step 2 after save/load {resumed} == {want}", flush=True)
    print(f"# train max parameter change {moved:.4e}; metrics records {len(metrics)}",
          flush=True)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"training path never launched: {missing}")
    return {"launches": launches, "steps": recs}


def check_outputs(cfg: EvalConfig, model, dev) -> None:
    """One more forward of the first val scene: every output has its shape,
    is finite, and no overflow counter moved (the repo's validity rule)."""
    _, batch = next(collated_scenes(cfg))
    with torch.no_grad():
        out = model(batch_to_torch(batch, dev))
    n, p = cfg.caps.eval_points, cfg.caps.proposals
    shapes = {"point_features": (n, cfg.net.m), "semantic_scores": (n, cfg.classes),
              "point_offsets": (n, 3), "proposal_scores": (p,)}
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape or not torch.isfinite(out[key]).all():
            raise AssertionError(f"main {key}: shape {tuple(out[key].shape)} != {shape} "
                                 "or non-finite values")
    rows = out["proposal_rows"]
    if rows["point_idx"].shape != (2 * n,) or not 0 <= int(rows["n_proposals"]) <= p:
        raise AssertionError("main: malformed proposal rows")
    overflow = {k: int(v) for k, v in out["diag"].items() if int(v) != 0}
    if overflow:
        raise AssertionError(f"main: overflow counters moved: {overflow}")
    print(f"# main outputs checked: shapes, finite, diag {dict.fromkeys(out['diag'], 0)}",
          flush=True)


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
    k1, k2, k3 = kernel_checks(cfg, dev)
    t0 = phase("kernels", t0)

    k4, k5 = train_kernel_checks(dev)
    t0 = phase("train_kernels", t0)

    small_check(dev)
    t0 = phase("small", t0)

    small_train_check(dev)
    t0 = phase("small_train", t0)

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
    missing = [k for k in ("gather_gemm", "ball_query_edge", "connected_components")
               if eval_launches[k] == 0]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")
    check_outputs(cfg, model, dev)
    t0 = phase("main", t0)

    train = train_main(dev)
    t0 = phase("train", t0)

    repl = {"gather_gemm": "minsu3d_tpu/ops/sparse_conv.py:50",
            "ball_query_edge": "minsu3d_tpu/ops/ballquery.py:268",
            "connected_components": "minsu3d_tpu/ops/cluster.py:21",
            "gather_wgrad": "minsu3d_tpu/ops/sparse_conv.py:306",
            "proposal_iou": "minsu3d_tpu/ops/instance_iou.py:35"}
    src = {k: f"minsu3d_tpu_torch/csrc/{k}.cu" for k in repl}
    src["ball_query_edge"] = "minsu3d_tpu_torch/csrc/ball_query.cu"
    records = {"gather_gemm": k1[0], "ball_query_edge": k2, "connected_components": k3,
               "gather_wgrad": k4[0], "proposal_iou": k5}
    kernels = []
    for kname, rec in records.items():
        kernels.append({
            "name": kname, "route": "cuda", "source": src[kname], "replaces": repl[kname],
            "launches": train["launches"][kname], "launches_eval": eval_launches.get(kname, 0),
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": None,
            "shape": rec["shape"]})
    print(f"# total {time.perf_counter() - t_all:.3f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
