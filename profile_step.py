"""Device-time breakdown of the port's train step (dense or packed), or of
its serving forward (dense or static int8), on one NVIDIA GPU.

    python3 profile_step.py [--dropout | --int8 | --forward | --packed |
                             --packed-tome] [--int8-train] [--batch N]
                            [--tome-r R [--tome-schedule decreasing]]
                            [--remat-policy POLICY] [--heads H]

bench.py's step (ViT-B/16 @384, bf16, full remat, batch 36, random weights
from seed 0); ``--dropout`` adds attention dropout 0.1, hidden dropout 0.1
and mixup α 0.2. ``--int8`` profiles the serving forward instead: the
fused int8 route at batch 32 on a static tree calibrated on 8 images (the
weights of seed 0, standard-normal images); ``--forward`` the dense bf16
serving forward, at batch 8; ``--batch`` sets either batch. ``--packed``
profiles the
packed train step on smoke_batches.py's probe batch (32 sequences of 1152
tokens, two 384 x 384 images each), ``--packed-tome`` the same with
within-segment token merging (r = 16, decreasing). ``--tome-r`` merges
tokens on the dense step (with or without ``--dropout``) or on the int8
forward, under ``--tome-schedule``. ``--remat-policy`` runs the dense
step (with or without ``--dropout`` or ``--tome-r``) under another remat
policy (``full``, the default, ``mlp``, ``attn``, ``attn_mlp``,
``flash_out``, ``dots``; ``none`` trains without remat). ``--int8-train``
runs the dense step (with any of those) on the int8 straight-through
forward, its scales calibrated on the step's batch. ``--heads`` splits the
hidden 768 into that many heads (3: heads of 256, on the wide attention
kernels; default 12). After 3 warm-up steps
``torch.profiler`` traces 2 steps (forwards); the kernels of the trace are
summed by category, and the busy share is the union of their intervals
over the traced wall; ``syncs_per_step`` counts the host's waits on the
card in the trace (CUDA runtime calls that synchronize), ``copies_per_step``
its memory copies between host and card. Outside the
profiler, ``event_ms`` is a step's time by CUDA events over 5 steps, and
``enqueue_ms`` the host's time to issue one (the call returns before the
card is done). Prints one JSON line (the trace is written beside the
kernel build, read and removed).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from smoke_batches import bench_batch

BATCH, INT8_BATCH, SERVE_BATCH, WARMUP_STEPS, STEPS = 36, 32, 8, 3, 2

# kernel-name fragments by category, first match wins
CATEGORIES = (
    ("int8_matmul", ("int8_gemm",)),
    ("attention_fwd", ("attn_fwd",)),
    ("attention_bwd", ("attn_bwd",)),
    ("layer_norm_fwd", ("ln_fwd",)),
    ("layer_norm_bwd", ("ln_bwd",)),
    ("hidden_dropout", ("hidden_dropout",)),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")),
    ("random", ("philox", "distribution", "uniform", "bernoulli")),
    ("sort_scatter", ("sort", "scatter", "gather", "radix", "scan")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "unrolled", "vectorized", "where",
                     "copy", "fill")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in ms (µs input)."""
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if s > end:
            total, end = total + (e - s), e
        elif e > end:
            total, end = total + (e - end), e
    return total / 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--dropout", action="store_true")
    mode.add_argument("--int8", action="store_true")
    mode.add_argument("--forward", action="store_true")
    mode.add_argument("--packed", action="store_true")
    mode.add_argument("--packed-tome", action="store_true")
    ap.add_argument("--int8-train", action="store_true")
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--tome-r", type=int, default=0)
    ap.add_argument("--tome-schedule", choices=("constant", "decreasing"),
                    default="constant")
    ap.add_argument("--remat-policy", default="full",
                    choices=("full", "mlp", "attn", "attn_mlp", "flash_out",
                             "dots", "none"))
    args = ap.parse_args()
    if args.int8_train and (args.int8 or args.forward or args.packed
                            or args.packed_tome):
        ap.error("--int8-train profiles the dense train step")
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    import chestxray_vit_tpu_torch as cxr
    from chestxray_vit_tpu_torch import kernels
    from chestxray_vit_tpu_torch.models.vit import init_params
    from chestxray_vit_tpu_torch.train import steps

    torch.backends.cuda.matmul.allow_tf32 = False
    rate = 0.1 if args.dropout else 0.0
    policy = args.remat_policy
    cfg = cxr.Config(model=cxr.ModelConfig(num_heads=args.heads,
                                           remat=policy != "none",
                                           remat_policy=(
                                               "full" if policy == "none"
                                               else policy),
                                           attention_dropout=rate,
                                           hidden_dropout=rate,
                                           tome_r=args.tome_r,
                                           tome_schedule=args.tome_schedule),
                     data=cxr.DataConfig(
                         mixup_alpha=0.2 if args.dropout else 0.0))
    dev = torch.device("cuda")
    batch = bench_batch(BATCH, 0, dev)
    params = init_params(torch.Generator().manual_seed(0), cfg.model, dev)
    if args.int8 or args.forward:
        batch_size = args.batch or (INT8_BATCH if args.int8 else SERVE_BATCH)
        run = serving_forward(params, cfg.model, dev, batch_size, args.int8)
        config = "int8" if args.int8 else "forward"
    elif args.packed or args.packed_tome:
        run, batch_size = packed_step(params, args.packed_tome, dev)
        config = "packed_tome" if args.packed_tome else "packed"
    else:
        scales = None
        if args.int8_train:
            from chestxray_vit_tpu_torch.models.quantized import (
                calibrate_vit_scales)
            scales = calibrate_vit_scales(params, batch["pixel_values"],
                                          cfg.model)
        state = steps.TrainState.create(params, seed=42)
        step = steps.make_train_step(cfg, total_steps=10_000,
                                     int8_scales=scales)

        def run():
            nonlocal state
            state, m = step(state, batch)
            return m["loss"]

        batch_size = BATCH
        config = ("int8_" if args.int8_train else "") + (
            "dropout" if args.dropout else "dense")
    if args.tome_r and not (args.packed or args.packed_tome):
        config += f"_tome{args.tome_r}_{args.tome_schedule}"
    if policy != "full" and ("dense" in config or "dropout" in config):
        config += f"_remat_{policy}"
    if args.heads != 12:
        config += f"_heads{args.heads}"
    for _ in range(WARMUP_STEPS):
        out = run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    enqueue_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        run()
    end.record()
    end.synchronize()
    event_ms = start.elapsed_time(end) / 5
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            out = run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = str(kernels.BUILD_DIR / "profile_step_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    launched = [e for e in events if e.get("cat") == "kernel"]
    runtime = [e.get("name", "") for e in events
               if e.get("cat") == "cuda_runtime"]
    syncs = [n for n in runtime if "Synchronize" in n]
    copies = [n for n in runtime if "Memcpy" in n]
    by_cat: dict = {}
    for e in launched:
        c = category(e["name"])
        by_cat[c] = by_cat.get(c, 0.0) + e["dur"] / 1e3 / STEPS
    span = [(e["ts"], e["ts"] + e["dur"]) for e in launched]
    busy = busy_ms(span)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({
        "config": config, "batch": batch_size, "steps": STEPS,
        "nvidia_smi": smi,
        "wall_ms_per_step": wall_ms / STEPS,
        "event_ms": event_ms, "enqueue_ms": enqueue_ms,
        "syncs_per_step": len(syncs) / STEPS,
        "copies_per_step": len(copies) / STEPS,
        "device_ms_per_step": busy / STEPS,
        "busy_share": busy / wall_ms,
        "kernels_per_step": len(launched) / STEPS,
        "ms_per_step_by_category": {k: round(v, 4) for k, v in
                                    sorted(by_cat.items(),
                                           key=lambda kv: -kv[1])},
        **({"logits_absmax": out.abs().max().item()}
           if args.int8 or args.forward else {"loss": out.item()})}))
    return 0


def packed_step(params, tome: bool, dev):
    """(the packed train step on smoke_batches.py's probe batch as a callable
    returning the loss, the images per step)."""
    import chestxray_vit_tpu_torch as cxr
    from chestxray_vit_tpu_torch.train import steps
    from smoke_batches import (TOME_R, TOME_SCHEDULE, packed_probe_batch,
                               tensors)

    model = cxr.ModelConfig(remat=True, tome_r=TOME_R if tome else 0,
                            tome_schedule=TOME_SCHEDULE)
    batch = packed_probe_batch(dev)
    data = tensors(batch)
    state = steps.TrainState.create(params, seed=42)
    step = steps.make_packed_train_step(cxr.Config(model=model),
                                        total_steps=10_000)

    def run():
        nonlocal state
        state, m = step(state, data)
        return m["loss"]

    return run, batch["n_images"]


def serving_forward(params, cfg, dev, batch: int, int8: bool):
    """The serving forward at ``batch``, as the ``Predictor`` runs it
    (under ``inference_mode``): dense bf16 on weights cast once, or static
    int8 on the fused route (a tree calibrated on 8 images); merging with
    ``cfg.tome_r``."""
    from chestxray_vit_tpu_torch.models import quantized, tome_forward, vit

    rng = np.random.default_rng(1)

    def images(n):
        return torch.from_numpy(rng.standard_normal(
            (n, 384, 384, 3)).astype(np.float32)).to(dev, torch.bfloat16)

    if int8:
        tree = quantized.quantize_vit_params(
            params, quantized.calibrate_vit_scales(params, images(8), cfg))
    else:
        tree = vit.inference_params(params, dev)
    x = images(batch)
    backend = "pallas" if int8 else "xla"

    def run():
        with torch.inference_mode():
            if cfg.tome_r:
                return tome_forward.apply_tome(
                    tree, x, cfg, cfg.tome_r, quantized=int8,
                    schedule=cfg.tome_schedule, backend=backend)
            if int8:
                return quantized.apply_quantized(tree, x, cfg, backend)
            return vit.apply(tree, x, cfg)

    return run


if __name__ == "__main__":
    raise SystemExit(main())
