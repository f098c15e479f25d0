"""The heads' kernel calls and the losses' targets at their captured inputs,
on one GPU.

    python -m minsu3d_tpu_torch.tools.heads_bench [--out FILE] [--reps 20]
        [--part all|packing]

The SoftGroup and HAIS heads (golden eval configs, f32) run on the first
val scene fed ``injected_backbone_outputs`` (ground-truth classes and
offsets, so the clusterings are real), and the calls are captured as they
are made:

* K10's callers: the SoftGroup heads' packed grouping
  (``soft_grouping_packed``, whose pair packing is K10; its kernels by name
  and its device ops hold the packing's share), and ``compact_rows`` on
  the rows of the per-class grouping (``grouping_cfg.packed`` false);
* ``proposal_rank`` (K11 and whatever its wrapper does around it), the
  SoftGroup heads' call;
* ``hierarchical_aggregation`` of the HAIS heads, with ``use_set_aggr`` on
  and off: the difference is the set aggregation branch (K8, its table and
  its wrapper);
* the whole heads of each model, for the record;
* the losses' targets of a full-width heads-on train step of PointGroup,
  HAIS and SoftGroup (two augmented train scenes, the heads on injected
  ground-truth outputs through ``Trainer.forward_gt``, HAIS with its mask
  IoU on): every ``get_iou`` (K5, with or without a row mask),
  ``get_mask_label`` and ``proposal_argmax`` (K12) call as the losses made
  it; SoftGroup's five calls replayed in their order (the loss-target
  chain, from the first ``get_iou`` to the last ``proposal_argmax``); and
  each model's whole ``losses``, for the record.

Per call: the host ms of a call without a sync (what a host-bound forward
feels), CUDA-event ms (median of ``--reps`` calls after a warm-up), device
ms and device ops a call by ``torch.profiler`` (kernels, memsets and copies,
a mean over ``--reps`` calls) with the device ms and launches of each
kernel by name,
and the host syncs a call makes (``set_sync_debug_mode("warn")``'s
warnings). Every record carries a hash of its outputs' bits, so that two
trees can be held to the same results. The tool calls only functions whose
signatures the parent shares: copied into a parent checkout's ``tools/`` it
times that tree, so parent and change can run in turns in one call. The
last line is a JSON object with every record and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import warnings

import torch

from minsu3d_tpu_torch.config import (HaisEvalConfig, HaisTrainConfig, SoftGroupEvalConfig,
                                      SoftGroupTrainConfig, TrainConfig)
from minsu3d_tpu_torch.data.datamodule import TrainData
from minsu3d_tpu_torch.model import hais, pointgroup, softgroup
from minsu3d_tpu_torch.model.registry import get_model
from minsu3d_tpu_torch.test import (batch_to_torch, collated_scenes, injected_backbone_outputs,
                                    seeded_model, set_f32_numerics)
from minsu3d_tpu_torch.tools.conv_voxel_bench import host_ms
from minsu3d_tpu_torch.tools.query_bench import out_hash, profiled
from minsu3d_tpu_torch.tools.segment_bench import event_ms
from minsu3d_tpu_torch.trainer.trainer import Trainer

# the losses' target calls of each model's heads-on train step
LOSS_TARGETS = {"PointGroup": (TrainConfig, pointgroup, ("get_iou",)),
                "HAIS": (HaisTrainConfig, hais, ("get_iou", "get_mask_label")),
                "SoftGroup": (SoftGroupTrainConfig, softgroup,
                              ("get_iou", "get_mask_label", "proposal_argmax"))}


def heads_inputs(cfg, dev) -> tuple:
    """(model, torch batch, injected outputs, flags) of the first val scene."""
    _, batch = next(collated_scenes(cfg))
    model = seeded_model(cfg, 4, dev)
    inj = injected_backbone_outputs(batch, cfg.classes, cfg.net.m, 4, dev)
    flags = get_model(cfg.MODEL).forward_flags(cfg, 100, False)
    return model, batch_to_torch(batch, dev), inj, flags


def captured_calls(module, names: tuple, run) -> list:
    """(name, arguments) of every call of ``module.<name>`` for each of
    ``names`` that run() makes, in call order, tensors cloned as the call
    received them."""
    calls, origs = [], {n: getattr(module, n) for n in names}

    def spy_of(name):
        def spy(*a, **kw):
            calls.append((name, tuple(t.clone() if torch.is_tensor(t) else t
                                      for t in (*a, *kw.values()))))
            return origs[name](*a, **kw)
        return spy

    for n in names:
        setattr(module, n, spy_of(n))
    try:
        with torch.no_grad():
            run()
    finally:
        for n, f in origs.items():
            setattr(module, n, f)
    return calls


def captured(module, name: str, run) -> list:
    """The arguments of every call of ``module.name`` that run() makes."""
    return [args for _, args in captured_calls(module, (name,), run)]


def host_syncs(fn) -> int:
    """The host syncs one fn() makes, by set_sync_debug_mode("warn")."""
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in seen)


def rows_hash(rows: dict) -> int:
    return out_hash([rows[k] for k in ("point_idx", "prop_id", "valid", "n_proposals")])


def aggregation_hash(out) -> int:
    """A hash of hierarchical_aggregation's rows, primaries_dropped and kinds."""
    rows, dropped, kinds = out
    return rows_hash(rows) + out_hash([dropped, *kinds.values()])


def record(name: str, fn, reps: int, digest=out_hash) -> dict:
    with torch.no_grad():
        parts, ops, counts = profiled(fn, reps)
        rec = {"call": name, "host_ms": host_ms(fn, reps), "ms": event_ms(fn, reps),
               "device_ms": sum(parts.values()), "device_ops": ops, "parts": parts,
               "part_ops": counts,
               "host_syncs": host_syncs(fn), "hash": digest(fn())}
    print(json.dumps(rec), flush=True)
    return rec


def call_shape(name: str, args: tuple) -> str:
    if name == "proposal_argmax":
        return f"{tuple(args[0].shape)} IoUs"
    valid = args[0]["valid"]
    shape = f"{valid.shape[0]} rows ({int(valid.sum())} valid"
    if name == "get_iou":
        keep = args[5] if len(args) > 5 else None
        kept = "" if keep is None else f", {int((keep & valid).sum())} kept"
        return f"{shape}{kept}) -> ({args[1]}, {args[4]})"
    return f"{shape}), {tuple(args[4].shape)} IoUs"


def packing_records(model, tb, inj, flags, dev, reps: int) -> list:
    """K10's callers on the SoftGroup heads' val scene: the packed grouping
    as the heads call it (its pair packing is K10), and ``compact_rows`` on
    the rows of the per-class grouping (``grouping_cfg.packed`` false)."""
    (sg,) = captured(softgroup, "soft_grouping_packed", lambda: model.heads(tb, inj, **flags))
    active = softgroup.class_flags(sg[0], sg[3], torch.tensor(sg[4], device=dev), sg[5], sg[9])
    recs = [record(f"SoftGroup soft_grouping_packed: {tuple(active.shape)} class flags "
                   f"({int(active.sum())} active), pair_cap {sg[13]}",
                   lambda: softgroup.soft_grouping_packed(*sg)[0], reps, rows_hash)]
    cfg = model.cfg.with_overrides({"net.grouping_cfg.packed": False})
    per_class, tb2, inj2, flags2 = heads_inputs(cfg, dev)
    (cr,) = captured(softgroup, "compact_rows", lambda: per_class.heads(tb2, inj2, **flags2))
    rows, r_cap = cr
    recs.append(record(f"SoftGroup compact_rows (packed=false): {rows['valid'].shape[0]} rows "
                       f"({int(rows['valid'].sum())} valid), r_cap {r_cap}",
                       lambda: softgroup.compact_rows(rows, r_cap), reps, rows_hash))
    return recs


def loss_target_records(dev, reps: int) -> list:
    """The losses' target calls of each model's heads-on train step (see the
    module docstring), each call alone, SoftGroup's chain, and the whole
    losses."""
    recs = []
    for name, (config, module, names) in LOSS_TARGETS.items():
        bundle = get_model(name)
        cfg = config().with_overrides({"synthetic.train_scenes": 2, "net.prepare_epochs": 0,
                                       **bundle.open_gates})
        tr = Trainer(cfg, TrainData(cfg), dev, seed=0)
        tr.epoch = 1
        batch = tr.data.batch(1, [0, 1])
        tb = batch_to_torch(batch, dev)
        inj = injected_backbone_outputs(batch, cfg.classes, cfg.net.m, 1, dev)
        got = {}
        calls = captured_calls(module, names,
                               lambda: got.setdefault("out", tr.forward_gt(tb, inj)[0]))
        for k, (fn_name, args) in enumerate(calls):
            fn = getattr(module, fn_name)
            recs.append(record(f"{name} losses call {k}: {fn_name}, {call_shape(fn_name, args)}",
                               lambda fn=fn, args=args: fn(*args), reps))
        if name == "SoftGroup":
            def chain(calls=calls):
                return [getattr(module, n)(*a) for n, a in calls]
            recs.append(record(f"SoftGroup loss-target chain: {len(calls)} calls "
                               f"({', '.join(n for n, _ in calls)})", chain, reps))
        out = got["out"]
        flags = bundle.loss_flags(cfg, tr.epoch)
        recs.append(record(f"{name} losses (heads on ground truth)",
                           lambda: list(bundle.losses(cfg, tr.caps, tb, out, True,
                                                      **flags).values()), reps))
        del tr
    return recs


def other_records(model, tb, inj, flags, dev, reps: int) -> list:
    """K11's call and the SoftGroup heads, HAIS's aggregation branch and
    heads, and the losses' target calls (the module docstring)."""
    recs = []
    (k11,) = captured(softgroup, "proposal_rank", lambda: model.heads(tb, inj, **flags))
    recs.append(record(f"SoftGroup proposal_rank: {k11[0].shape[0]} clusters, "
                       f"{k11[7].shape[0]} pairs", lambda: softgroup.proposal_rank(*k11),
                       reps))
    recs.append(record("SoftGroup heads", lambda: model.heads(tb, inj, **flags)["proposal_rows"],
                       reps, rows_hash))

    model, tb, inj, flags = heads_inputs(HaisEvalConfig(), dev)
    (agg,) = captured(hais, "hierarchical_aggregation", lambda: model.heads(tb, inj, **flags))
    for on in (True, False):
        call = (lambda on=on: hais.hierarchical_aggregation(*agg[:-1], on))
        recs.append(record(f"HAIS hierarchical_aggregation, use_set_aggr={on}: "
                           f"{agg[0].sizes.shape[0]} clusters", call, reps,
                           aggregation_hash))
    on, off = recs[-2], recs[-1]
    branch = {"call": "HAIS set aggregation branch (use_set_aggr on minus off)",
              **{k: on[k] - off[k] for k in ("host_ms", "ms", "device_ms", "device_ops",
                                             "host_syncs")}}
    print(json.dumps(branch), flush=True)
    recs.append(branch)
    recs.append(record("HAIS heads", lambda: model.heads(tb, inj, **flags)["proposal_rows"],
                       reps, rows_hash))
    recs.extend(loss_target_records(dev, reps))
    return recs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the records here as JSON")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--part", choices=("all", "packing"), default="all",
                    help="packing: only K10's callers (the packed grouping, compact_rows)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("heads_bench: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    set_f32_numerics()
    dev = torch.device("cuda", 0)
    recs = []

    model, tb, inj, flags = heads_inputs(SoftGroupEvalConfig(), dev)
    recs.extend(packing_records(model, tb, inj, flags, dev, args.reps))
    if args.part == "all":
        recs.extend(other_records(model, tb, inj, flags, dev, args.reps))
    result = {"device": smi, "torch": torch.__version__, "records": recs}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
