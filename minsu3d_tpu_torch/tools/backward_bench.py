"""K13 ``gather_dx_bf16`` and K4 ``gather_wgrad`` (f32 and bf16) at every
conv shape of both training backbones, on one GPU.

    python -m minsu3d_tpu_torch.tools.backward_bench [--out FILE] [--reps 10]

The shapes: each training recipe's (``TrainConfig``, PointGroup, m=16;
``HaisTrainConfig``, HAIS and SoftGroup, m=32) plan of its first batch of 2
augmented full-width scenes, with the plan's ``conv_tables``; per level the
subm conv (27 x w -> w), its tail's first conv over the skip concat (27 x
2w -> w), and the down and up convs to the next level, and K4 also at the
input conv (27 x 6 -> m, whose input takes no gradient). Inputs are seeded
random bf16 or f32 values. Each kernel call gets the tables' TapOrders
where its wrapper takes them (the wrappers of commits before the backward
kernels walked the orders take none: the tool runs unchanged in such a
checkout, so that two trees are timed in one call).

Per shape and kernel it prints one JSON line: CUDA-event ms (median of
``--reps`` wrapper calls after a warm-up), device ms (``torch.profiler``,
kernels summed, a mean over ``--reps`` calls), batch ms (CUDA events around
``--reps`` back-to-back calls, over ``--reps``: the device time where a
kernel outlasts its wrapper's host work), the bound (bytes over 3.35
TB/s or flops over 67 / 989 TFLOP/s, the larger, for what these inputs
need) and for K13 the exact-order floor (2 live_pairs Cin Cout unfused f32
multiplies and adds over 33.5 T/s), and whether the result matches the
plain version (K13 bit for bit, K4 within 1e-5 of the scale in f32 and one
bf16 ulp in bf16). The last line is a JSON object with every record and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess

import torch

from minsu3d_tpu_torch.config import HaisTrainConfig, TrainConfig
from minsu3d_tpu_torch.data.datamodule import TrainData
from minsu3d_tpu_torch.ops import sparse_conv
from minsu3d_tpu_torch.ops.sparse import plan_from_batch
from minsu3d_tpu_torch.test import batch_to_torch, set_f32_numerics

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS = 67e12           # f32 outside the tensor cores (an FMA counts two)
BF16_FLOPS = 989e12         # bf16 tensor cores, dense
UNFUSED_OPS = F32_FLOPS / 2  # f32 multiplies or adds, each one operation


def takes_order(fn) -> bool:
    return "order" in inspect.signature(fn).parameters


def event_ms(fn, reps: int) -> float:
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


def batch_ms(fn, reps: int) -> float:
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps: int):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages())
    return total / reps / 1e3 if total > 0 else None


def bound(n_bytes: float, flops: float, peak: float) -> tuple:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def used(idx: torch.Tensor, n: int) -> tuple:
    """(live pairs, distinct source rows read, table rows with a live tap)."""
    live = (idx >= 0) & (idx < n)
    return int(live.sum()), int(torch.unique(idx[live]).numel()), int(live.any(1).sum())


def level_shapes(cfg, plan, tables) -> list:
    """The training backbone's conv shapes over ``plan``: dicts with the tag,
    the forward table ``idx`` over ``n_src`` source rows and its order, the
    transposed table ``idx_t`` and its order (None for the input conv, whose
    dx is not taken), and the conv's Cin and Cout."""
    widths = [cfg.net.m * b for b in cfg.net.blocks]
    out = []
    for lvl, w in enumerate(widths):
        lv, order = plan.levels[lvl], tables[lvl].nbr_order
        tag = f"{cfg.MODEL} train L{lvl} ({lv.cap} rows)"
        subm = dict(idx=lv.nbr_idx, n_src=lv.cap, order=order, idx_t=lv.nbr_idx, order_t=order)
        if lvl == 0:
            cin = cfg.net.input_channel
            out.append(dict(subm, tag=f"{tag} input 27x{cin} -> {w}", cin=cin, cout=w,
                            idx_t=None, order_t=None))
        out.append(dict(subm, tag=f"{tag} subm 27x{w} -> {w}", cin=w, cout=w))
        if lvl + 1 == len(widths):
            continue
        parent, w2, lk = plan.levels[lvl + 1], widths[lvl + 1], tables[lvl].links
        out.append(dict(subm, tag=f"{tag} tail 27x{2 * w} -> {w}", cin=2 * w, cout=w))
        out.append(dict(tag=f"{tag} down 8x{w} -> {w2}", idx=lk.down, n_src=lv.cap,
                        order=lk.down_order, idx_t=lk.up, order_t=lk.up_order, cin=w, cout=w2))
        out.append(dict(tag=f"{tag} up 8x{w2} -> {w}", idx=lk.up, n_src=parent.cap,
                        order=lk.up_order, idx_t=lk.down, order_t=lk.down_order, cin=w2,
                        cout=w))
    return out


def bf16_close(got: torch.Tensor, want: torch.Tensor) -> bool:
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    mag = torch.maximum(g.abs(), w.abs())
    ulp = torch.where(mag > 0, torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8),
                      mag)
    return bool(((diff <= ulp) | (diff <= 1e-5 * max(float(w.abs().max()), 1.0))).all())


def time_shape(s: dict, gen: torch.Generator, dev, reps: int) -> list:
    """K13 (where the conv takes a dx) and K4 in f32 and bf16 at one shape."""
    recs = []
    idx, n, cin, cout = s["idx"], s["n_src"], s["cin"], s["cout"]
    rows = idx.shape[0]

    def rnd(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    if s["idx_t"] is not None:
        idx_t, order_t = s["idx_t"], s["order_t"]
        dout = rnd(rows, cout, dtype=torch.bfloat16)
        wt = rnd(idx_t.shape[1], cout, cin, dtype=torch.bfloat16, scale=(1 / (27 * cout)) ** 0.5)
        kw = {"order": order_t} if takes_order(sparse_conv.gather_dx_bf16) else {}

        def k13():
            return sparse_conv.gather_dx_bf16(dout, idx_t, wt, **kw)

        got, want = k13(), sparse_conv.gather_dx_bf16_plain(dout, idx_t, wt)
        live, d_rows, _ = used(idx_t, rows)
        nb = 2 * (d_rows * cout + wt.numel() + got.numel()) + 4 * idx_t.numel()
        b_ms, b_by = bound(nb, 2.0 * live * cin * cout, BF16_FLOPS)
        recs.append({"kernel": "gather_dx_bf16", "shape": s["tag"],
                     "equal": bool(torch.equal(got.view(torch.int16), want.view(torch.int16))),
                     "ms": event_ms(k13, reps), "device_ms": device_ms(k13, reps),
                     "batch_ms": batch_ms(k13, reps),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "exact_floor_ms": 2.0 * live * cin * cout / UNFUSED_OPS * 1e3,
                     "live_pairs": live})
    for dtype in (torch.float32, torch.bfloat16):
        x, dout = rnd(n, cin, dtype=dtype), rnd(rows, cout, dtype=dtype)
        kw = {"order": s["order"]} if takes_order(sparse_conv.gather_wgrad) else {}

        def k4():
            return sparse_conv.gather_wgrad(x, idx, dout, **kw)

        got, want = k4(), sparse_conv.gather_wgrad_plain(x, idx, dout)
        if dtype == torch.float32:
            ok = float((got - want).abs().max()) <= 1e-5 * max(float(want.abs().max()), 1.0)
        else:
            ok = bf16_close(got, want)
        live, x_rows, d_rows = used(idx, n)
        es = x.element_size()
        nb = es * (x_rows * cin + d_rows * cout) + 4 * (idx.numel() + got.numel())
        peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        b_ms, b_by = bound(nb, 2.0 * live * cin * cout, peak)
        recs.append({"kernel": "gather_wgrad" + ("_bf16" if dtype == torch.bfloat16 else ""),
                     "shape": s["tag"], "equal": ok, "ms": event_ms(k4, reps),
                     "device_ms": device_ms(k4, reps), "batch_ms": batch_ms(k4, reps),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "live_pairs": live})
    return recs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("backward_bench: needs a CUDA device")
    set_f32_numerics()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    gen = torch.Generator().manual_seed(31)
    recs = []
    for cfg in (TrainConfig(), HaisTrainConfig()):
        batch = TrainData(cfg.with_overrides({"synthetic.train_scenes": 2})).batch(0, [0, 1])
        plan, _, _ = plan_from_batch(batch_to_torch(batch, dev), len(cfg.net.blocks))
        tables = sparse_conv.conv_tables(plan)
        for s in level_shapes(cfg, plan, tables):
            for rec in time_shape(s, gen, dev, args.reps):
                print(json.dumps(rec), flush=True)
                recs.append(rec)
    result = {"device": smi, "records": recs}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
