"""PointGroup, HAIS or SoftGroup inference + evaluation on the synthetic val
split: the port's counterpart of ``test.py`` under
``scripts/eval_synth_pointgroup.sh`` (``--model pointgroup``, the default),
``scripts/eval_synth_hais.sh`` (``--model hais``) or
``scripts/eval_synth_softgroup.sh`` (``--model softgroup``), in f32 unless
told otherwise.

    python -m minsu3d_tpu_torch.test                          # CUDA
    python -m minsu3d_tpu_torch.test --device cpu --scenes 1  # plain versions
    python -m minsu3d_tpu_torch.test --model hais [--epoch 100]
    python -m minsu3d_tpu_torch.test --model softgroup
    python -m minsu3d_tpu_torch.test --model hais precision=bfloat16
    python -m minsu3d_tpu_torch.test --ckpt output/torch_train/last.pt

Trailing ``key=value`` arguments override the model's eval config (dotted
keys, as ``train.py``). ``precision=bfloat16`` runs the HAIS and SoftGroup
eval scripts as they are written (they set no precision, and the JAX
package's default is bf16); the PointGroup script sets float32.

Prints the AP table, semantic accuracy and mIoU, per-scene times and the
overflow counters. Without ``--ckpt`` the weights are seeded
(``seeded_model``): the numbers exercise the path and mean nothing as
accuracy. ``--ckpt`` evaluates the weights and batch statistics of a
checkpoint that ``train.py`` wrote (``last.pt``), as the JAX ``test.py``
evaluates ``model.ckpt_path``; the checkpoint must hold the ``--model``'s
net, trained in either precision, and the eval runs in the eval config's.
``--epoch`` feeds the model's epoch gates (``forward_flags``; HAIS's mask
filter is on after epoch 40): by default the checkpoint's epoch, or 100,
the frozen checkpoints' epoch, for seeded weights.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from minsu3d_tpu_torch.config import EvalConfig, backbone_caps, parse_overrides
from minsu3d_tpu_torch.data.batching import collate, eval_caps
from minsu3d_tpu_torch.data.dataset import eval_item, synthetic_val_scenes
from minsu3d_tpu_torch.evaluation.instance_segmentation import (
    GeneralDatasetEvaluator, get_gt_instances)
from minsu3d_tpu_torch.evaluation.semantic_segmentation import (
    evaluate_semantic_accuracy, evaluate_semantic_miou)
from minsu3d_tpu_torch.model.registry import CLI_NAMES, get_model


def set_f32_numerics() -> None:
    """Full f32 products and convolutions: the JAX package runs them at
    Precision.HIGHEST (ops/sparse_conv.py:38), cuDNN would use TF32 (in a
    bf16 config the f32 heads and batch norms still need this). cuDNN
    also picks only deterministic algorithms (no autotuning), so the
    ScoreNet's conv3d backward repeats bit for bit from run to run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def seeded_model(cfg: EvalConfig, seed: int, device, split: str = "val"):
    """The net of ``cfg.MODEL`` (PointGroupNet, HAISNet, SoftGroupNet) with weights
    drawn from ``torch.Generator(seed)`` by the
    JAX package's initializers (conv: uniform +-sqrt(6 / (taps * Cin));
    Dense: lecun-normal, zero bias; batch norm: identity statistics). Every
    head's parameters exist from the start."""
    model = get_model(cfg.MODEL).net(cfg, split)
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


# per-proposal and per-row scores of the models' heads, as pred_instances reads them
SCORE_KEYS = ("proposal_scores", "mask_scores", "cls_scores", "iou_scores")


def out_to_numpy(out: dict, n_points: int) -> dict:
    """What ``pred_instances`` reads, on the host, point axis truncated:
    the semantic scores, the proposal rows and the model's scores."""
    out_np = {
        "semantic_scores": out["semantic_scores"][:n_points].cpu().numpy(),
        "proposal_rows": {k: v.cpu().numpy() for k, v in out["proposal_rows"].items()},
    }
    out_np.update({k: out[k].cpu().numpy() for k in SCORE_KEYS if k in out})
    return out_np


def injected_backbone_outputs(batch: dict, classes: int, m: int, seed: int, device,
                              feature_dtype: torch.dtype | None = None) -> dict:
    """Backbone outputs of a collated batch, on ``device``, from the ground
    truth plus seeded numpy noise (the same values on every device), so that
    the heads of a seeded model cluster the scene's objects: noisy one-hot classes, noisy instance-centre
    offsets with one point in 12 thrown up to 0.3 m off (small fragments)
    and a quarter of instance 0 thrown 0.35 m off (a kept fragment next to
    its primary), random features, cast to ``feature_dtype`` (the
    backbone's compute dtype; None keeps f32)."""
    rng = np.random.default_rng(seed)
    n = batch["point_xyz"].shape[0]
    mask = batch["point_mask"][:, None]
    scores = rng.normal(0, 1.0, (n, classes)).astype(np.float32)
    scores[np.arange(n), np.maximum(batch["sem_labels"], 0)] += 4.0
    inst = (batch["instance_ids"] >= 0)[:, None]
    offs = (batch["instance_center_xyz"] - batch["point_xyz"]) * inst
    offs = offs + rng.normal(0, 0.005, offs.shape)
    far = rng.random(n) < 1 / 12
    offs[far] += rng.uniform(-0.3, 0.3, (int(far.sum()), 3))
    split = (batch["instance_ids"] == 0) & (rng.random(n) < 0.25)
    offs[split, 0] += 0.35
    feats = np.abs(rng.normal(0, 1.0, (n, m)))
    out = {"point_features": feats * mask, "semantic_scores": scores,
           "point_offsets": offs * mask}
    out = {k: torch.from_numpy(v.astype(np.float32)).to(device) for k, v in out.items()}
    if feature_dtype is not None:
        out["point_features"] = out["point_features"].to(feature_dtype)
    return out


def collated_scenes(cfg: EvalConfig):
    """(scan_id, collated numpy batch) for every val scene, host plan built."""
    plan = (backbone_caps(cfg), len(cfg.net.blocks))
    for scan_id, scene in synthetic_val_scenes(cfg):
        yield scan_id, collate([eval_item(cfg, scene, scan_id)], eval_caps(cfg), plan)


def checkpoint_model(cfg: EvalConfig, path: str, device) -> tuple:
    """(the eval net of ``cfg`` with the weights and batch statistics of a
    ``Trainer.save_checkpoint`` file, the checkpoint's epoch). Raises when
    the checkpoint holds another model."""
    ck = torch.load(path, map_location=device, weights_only=True)
    name = ck.get("model_name", "PointGroup")
    if name != cfg.MODEL:
        raise ValueError(f"checkpoint {path} holds a {name} model, not {cfg.MODEL}")
    model = get_model(cfg.MODEL).net(cfg, "val").to(device)
    model.load_state_dict(ck["model"], strict=True)
    return model.eval(), int(ck["epoch"])


@torch.no_grad()
def evaluate(cfg: EvalConfig, model, device, print_result: bool = False,
             epoch: int = 100) -> dict:
    """Run the model over the val scenes and score them, with the model's
    ``forward_flags`` at ``epoch``. Returns AP/AP_50/AP_25, semantic
    accuracy/mIoU, per-scene forward ms (device synchronised), the worst
    value of every diag counter and the proposal counts."""
    set_f32_numerics()
    bundle = get_model(cfg.MODEL)
    flags = bundle.forward_flags(cfg, epoch, False)
    ignore = list(cfg.ignore_classes)
    all_preds, all_gts, accs, mious, scene_ms, n_props = [], [], [], [], [], []
    diag: dict = {}
    for scan_id, batch in collated_scenes(cfg):
        tb = batch_to_torch(batch, device)
        if tb["point_xyz"].is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(tb, **flags)
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
        all_preds.append(bundle.pred_instances(cfg, scan_id, xyz, out_np, len(ignore)))
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
    ap.add_argument("--model", choices=CLI_NAMES, default="pointgroup")
    ap.add_argument("--epoch", type=int, default=None,
                    help="epoch of the model's forward gates (default: the checkpoint's, "
                    "else 100)")
    ap.add_argument("--ckpt", default=None, help="a checkpoint that train.py wrote")
    ap.add_argument("overrides", nargs="*",
                    help="eval config key=value overrides, e.g. precision=bfloat16")
    args = ap.parse_intermixed_args(argv)

    cfg = get_model(args.model).eval_config().with_overrides(parse_overrides(args.overrides))
    if args.scenes is not None:
        cfg = cfg.with_overrides({"synthetic.val_scenes": args.scenes})
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    if args.ckpt:
        model, ck_epoch = checkpoint_model(cfg, args.ckpt, device)
        epoch = ck_epoch if args.epoch is None else args.epoch
        print(f"# {cfg.MODEL} in {cfg.precision} on {device}, weights of {args.ckpt} "
              f"(epoch {ck_epoch}), forward gates at epoch {epoch}")
    else:
        model, epoch = seeded_model(cfg, 0, device), 100 if args.epoch is None else args.epoch
        print(f"# {cfg.MODEL} in {cfg.precision} on {device}")
        print("# seeded random weights: AP and mIoU below carry no meaning")
    m = evaluate(cfg, model, device, print_result=True, epoch=epoch)
    print(f"Semantic Accuracy: {m['semantic_accuracy']}")
    print(f"Semantic mean IoU: {m['semantic_mean_iou']}")
    print(f"per-scene forward ms ({device}): {[round(t, 3) for t in m['scene_ms']]}")
    print(f"proposals per scene: {m['proposals']}  diag: {m['diag']}")


if __name__ == "__main__":
    main()
