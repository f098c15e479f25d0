"""PointGroup inference + evaluation on the synthetic val split: the port's
counterpart of ``test.py`` under ``scripts/eval_synth_pointgroup.sh``.

    python -m minsu3d_tpu_torch.test                          # CUDA
    python -m minsu3d_tpu_torch.test --device cpu --scenes 1  # plain versions

Prints the AP table, semantic accuracy and mIoU, per-scene times and the
overflow counters. The weights are seeded (``seeded_model``): the numbers
exercise the path and mean nothing as accuracy.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from minsu3d_tpu_torch.config import EvalConfig, backbone_caps
from minsu3d_tpu_torch.data.batching import collate, eval_caps
from minsu3d_tpu_torch.data.dataset import eval_item, synthetic_val_scenes
from minsu3d_tpu_torch.evaluation.instance_segmentation import (
    GeneralDatasetEvaluator, get_gt_instances)
from minsu3d_tpu_torch.evaluation.semantic_segmentation import (
    evaluate_semantic_accuracy, evaluate_semantic_miou)
from minsu3d_tpu_torch.model.pointgroup import PointGroupNet, pred_instances


def set_f32_numerics() -> None:
    """Full f32 products and convolutions: the JAX package runs them at
    Precision.HIGHEST (ops/sparse_conv.py:38), cuDNN would use TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def seeded_model(cfg: EvalConfig, seed: int, device, split: str = "val") -> PointGroupNet:
    """PointGroupNet with weights drawn from ``torch.Generator(seed)`` by the
    JAX package's initializers (conv: uniform +-sqrt(6 / (taps * Cin));
    Dense: lecun-normal, zero bias; batch norm: identity statistics). Every
    head's parameters exist from the start."""
    model = PointGroupNet(cfg, split)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if "MaskedBatchNorm" in name:
                p.fill_(1.0 if leaf == "scale" else 0.0)
            elif leaf == "bias":
                p.zero_()
            elif leaf == "weight":  # nn.Linear (out, in)
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=g)
            else:
                if p.dim() == 5:        # conv3d (Cout, Cin, D, H, W)
                    fan = p.shape[1] * p.shape[2] * p.shape[3] * p.shape[4]
                    if leaf == "deconv_kernel":
                        fan = p.shape[0] * 8
                elif p.dim() == 3:      # sparse (taps, Cin, Cout)
                    fan = p.shape[0] * p.shape[1]
                else:                   # 1x1 (Cin, Cout)
                    fan = p.shape[0]
                bound = math.sqrt(6.0 / fan)
                p.uniform_(-bound, bound, generator=g)
    return model.to(device).eval()


def batch_to_torch(batch: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items() if k != "scan_ids"}


def out_to_numpy(out: dict, n_points: int) -> dict:
    """What ``pred_instances`` reads, on the host, point axis truncated."""
    return {
        "semantic_scores": out["semantic_scores"][:n_points].cpu().numpy(),
        "proposal_scores": out["proposal_scores"].cpu().numpy(),
        "proposal_rows": {k: v.cpu().numpy() for k, v in out["proposal_rows"].items()},
    }


def collated_scenes(cfg: EvalConfig):
    """(scan_id, collated numpy batch) for every val scene, host plan built."""
    plan = (backbone_caps(cfg), len(cfg.net.blocks))
    for scan_id, scene in synthetic_val_scenes(cfg):
        yield scan_id, collate([eval_item(cfg, scene, scan_id)], eval_caps(cfg), plan)


@torch.no_grad()
def evaluate(cfg: EvalConfig, model: PointGroupNet, device,
             print_result: bool = False) -> dict:
    """Run the model over the val scenes and score them. Returns AP/AP_50/
    AP_25, semantic accuracy/mIoU, per-scene forward ms (device synchronised),
    the worst value of every diag counter and the proposal counts."""
    set_f32_numerics()
    ignore = list(cfg.ignore_classes)
    all_preds, all_gts, accs, mious, scene_ms, n_props = [], [], [], [], [], []
    diag: dict = {}
    for scan_id, batch in collated_scenes(cfg):
        tb = batch_to_torch(batch, device)
        if tb["point_xyz"].is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(tb)
        if tb["point_xyz"].is_cuda:
            torch.cuda.synchronize()
        scene_ms.append((time.perf_counter() - t0) * 1e3)
        for k, v in out["diag"].items():
            diag[k] = max(diag.get(k, 0), int(v))
        n = int(batch["num_points"])
        out_np = out_to_numpy(out, n)
        n_props.append(int(out_np["proposal_rows"]["n_proposals"]))
        sem_pred = out_np["semantic_scores"].argmax(1)
        sem_gt = batch["sem_labels"][:n]
        accs.append(evaluate_semantic_accuracy(sem_pred, sem_gt, -1))
        mious.append(evaluate_semantic_miou(sem_pred, sem_gt, -1))
        xyz = batch["point_xyz"][:n]
        all_preds.append(pred_instances(cfg, scan_id, xyz, out_np, len(ignore)))
        all_gts.append(get_gt_instances(sem_gt, batch["instance_ids"][:n], ignore))
    evaluator = GeneralDatasetEvaluator(cfg.class_names, -1, ignore)
    res = evaluator.evaluate(all_preds, all_gts, print_result=print_result)
    return {
        "AP": float(res["all_ap"]), "AP_50": float(res["all_ap_50%"]),
        "AP_25": float(res["all_ap_25%"]),
        "semantic_accuracy": float(np.mean(accs)),
        "semantic_mean_iou": float(np.mean(mious)),
        "scene_ms": scene_ms, "proposals": n_props, "diag": diag,
        "n_instances": [len(p) for p in all_preds],
    }


def main(argv: list | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scenes", type=int, default=None, help="val scenes (default 3)")
    args = ap.parse_args(argv)

    cfg = EvalConfig()
    if args.scenes is not None:
        cfg = cfg.with_overrides({"synthetic.val_scenes": args.scenes})
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    model = seeded_model(cfg, 0, device)
    print("# seeded random weights: AP and mIoU below carry no meaning")
    m = evaluate(cfg, model, device, print_result=True)
    print(f"Semantic Accuracy: {m['semantic_accuracy']}")
    print(f"Semantic mean IoU: {m['semantic_mean_iou']}")
    print(f"per-scene forward ms ({device}): {[round(t, 3) for t in m['scene_ms']]}")
    print(f"proposals per scene: {m['proposals']}  diag: {m['diag']}")


if __name__ == "__main__":
    main()
