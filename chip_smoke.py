"""Smoke run of the PyTorch port on one NVIDIA GPU: the serving path and
the dense fine-tune and eval steps.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. device: a CUDA card is required (exit 2 without one, before any
   result); its name and power limit as nvidia-smi prints them.
2. build: the kernels in chestxray_vit_tpu_torch/csrc/ built with nvcc
   (one process per source, all at once).
3. kernel_check: each kernel against its plain PyTorch version on the card,
   at its path's shapes (ViT-B/16 @384: batch 8 for serving, batch 36 for
   training), with the tolerance stated, and the median time of each.
4. serving: a Predictor at full ViT-B/16 @384 width in bf16 (random
   weights from seed 0) behind the MicroBatcher answers concurrent
   requests from several threads; every request must be answered with 15
   finite probabilities, and the kernels' launch counts must be exactly 12
   (attention) and 25 (LayerNorm) per forwarded batch.
5. cross_check: the card's bf16 logits and an f32 forward on the card
   against the port's f32 forward on the CPU (plain versions), same
   weights and images.
6. train: bench.py's step, ViT-B/16 @384 bf16 with full remat at batch 36
   on its synthetic batch: 3 warm-up and 10 timed steps, finite losses
   that go down, exact launch counts of the four training kernels per
   step, step time, images/s and peak memory; then one step without remat
   against the remat step.
7. train_cross_check: one train step at full width, depth 2, batch 2 on
   the card against the same step on the CPU (plain versions), in f32 and
   with the card in bf16.
8. eval: the eval step over 4 batches of 36 and the on-device AUROC / F1,
   against the row losses and metrics recomputed on the CPU.

The second-to-last line is the kernels summary, the last one the result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

BATCH = 8
REQUESTS = 32
CLIENT_THREADS = 4
SEED = 0
TRAIN_BATCH = 36            # bench.py's batch per chip; remat on above 32
WARMUP_STEPS, TIMED_STEPS = 3, 10
EVAL_BATCHES = 4

# Tolerances, each with its reason:
# - attention, bf16: the bf16 tolerance of tests/test_flash_attention.py
#   (the kernel rounds P to bf16 before its running normalization, the plain
#   version after); f32: summation order only.
ATTN_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-5}
# - LayerNorm, bf16: one bf16 ulp of the output (f32 statistics in another
#   summation order may round the last bit either way) plus 1e-5 for the f32
#   rounding of the affine step, which shows where x̂·scale and bias cancel
#   to a small output; f32: 1e-5.
LN_F32_TOL = 1e-5
# - card bf16 logits vs CPU f32 logits: bf16 activations through 12 layers
#   against f32; logits of the random-weight model are O(1).
BF16_LOGIT_TOL = 5e-2
# - card f32 vs CPU f32: the same math in another summation order.
F32_LOGIT_TOL = 1e-3
# - training attention: o and lse (natural log, O(10)) against ATTN_TOL,
#   absolute; dq, dk, dv relative to each one's largest magnitude, where
#   bf16 rounds P and dS before their products at other points of the sum
#   than the plain version and f32 differs in summation order only.
ATTN_GRAD_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# - LayerNorm backward: dx as the forward's output (1 bf16 ulp + 1e-5 in
#   bf16); dscale and dbias sum 20,772 rows in another order: relative 1e-5
#   of the largest in f32, plus one ulp of each element when cast to bf16.
LN_BWD_REL_TOL = 1e-5
# - train: one bf16 step with and without remat runs the same kernels on
#   the same inputs (the card's products may pick other algorithms for the
#   recompute's shapes): loss 1e-3, gradients 1e-2 of the largest.
REMAT_LOSS_TOL, REMAT_GRAD_TOL = 1e-3, 1e-2
# - train_cross_check, f32 card vs f32 CPU: the same math in another
#   summation order. bf16 card vs f32 CPU: bf16 activations; AdamW's first
#   step moves each weight by about lr, so the updated weights can differ
#   by at most ~2 lr where the two gradients disagree in sign.
#   Gradients relative to the largest gradient of the model.
XCHECK_F32 = {"loss": 1e-5, "grad_norm_rel": 1e-4, "grads_rel": 1e-4,
              "params": 1e-5}
XCHECK_BF16 = {"loss": 5e-2, "grads_rel": 5e-2, "params": 2.1e-4}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, reps: int = 7, inner: int = 10) -> float:
    """Median per-call milliseconds over ``reps`` runs of ``inner`` calls,
    timed with CUDA events after a warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def time_pair(kernel, plain) -> tuple:
    """(kernel ms, plain ms), measured in turns: plain, kernel, kernel,
    plain."""
    p1, k1, k2, p2 = (time_ms(f) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
                      - 7)


def _wrappers() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from chestxray_vit_tpu_torch.ops import flash_attention as fa
    from chestxray_vit_tpu_torch.ops import layer_norm as ln
    return {"flash_attention_inference": fa.flash_attention_inference,
            "layer_norm": ln.layer_norm_cuda,
            "flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "layer_norm_bwd": ln.layer_norm_bwd_cuda}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def bench_batch(n: int, seed: int, device) -> dict:
    """bench.py's synthetic batch: standard-normal f32 NHWC pixels and
    Bernoulli(0.2) labels over 15 classes, from numpy's generator."""
    rng = np.random.default_rng(seed)
    pixels = rng.standard_normal((n, 384, 384, 3)).astype(np.float32)
    labels = (rng.random((n, 15)) < 0.2).astype(np.float32)
    return {"pixel_values": torch.from_numpy(pixels).to(device),
            "labels": torch.from_numpy(labels).to(device)}


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build() -> None:
    from chestxray_vit_tpu_torch import kernels
    t0 = time.perf_counter()
    path = kernels.build()
    kernels.library()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "library": path.name})


def phase_kernel_check() -> dict:
    from chestxray_vit_tpu_torch.ops import flash_attention as fa
    from chestxray_vit_tpu_torch.ops import layer_norm as ln

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    summary = {}

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # attention: the serving shape, one S that 64 divides, one short odd S
    for s in (577, 512, 37):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (randn((BATCH, 12, s, 64), dtype) for _ in range(3))
            out = fa.flash_attention_inference(q, k, v)
            ref = fa.attention_reference(q, k, v)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ms, plain_ms = time_pair(
                lambda: fa.flash_attention_inference(q, k, v),
                lambda: fa.attention_reference(q, k, v))
            rec = {"phase": "kernel_check", "kernel": "attention",
                   "shape": [BATCH, 12, s, 64], "dtype": str(dtype),
                   "max_abs_err": err, "tol": ATTN_TOL[dtype],
                   "finite": bool(torch.isfinite(out).all()),
                   "ms": ms, "plain_ms": plain_ms}
            emit(rec)
            require(rec["finite"] and err <= ATTN_TOL[dtype],
                    f"attention S={s} {dtype}: err {err}")
            if s == 577 and dtype == torch.bfloat16:
                summary["attention"] = rec

    rows, d = BATCH * 577, 768
    for x_dtype, w_dtype in ((torch.bfloat16, torch.bfloat16),
                             (torch.bfloat16, torch.float32),
                             (torch.float32, torch.float32)):
        x = randn((rows, d), x_dtype) * 3 + 1
        s_, b_ = randn((d,), w_dtype), randn((d,), w_dtype)
        y = ln.layer_norm_cuda(x, s_, b_, 1e-12)
        ref = ln.layer_norm_reference(x, s_, b_, 1e-12).float()
        torch.cuda.synchronize()
        diff = (y.float() - ref).abs()
        err = diff.max().item()
        if x_dtype == torch.bfloat16:
            ok = bool((diff <= bf16_ulp(ref) + LN_F32_TOL).all())
            tol = "1 bf16 ulp + 1e-5"
        else:
            ok, tol = err <= LN_F32_TOL, LN_F32_TOL
        ms, plain_ms = time_pair(
            lambda: ln.layer_norm_cuda(x, s_, b_, 1e-12),
            lambda: ln.layer_norm_reference(x, s_, b_, 1e-12))
        rec = {"phase": "kernel_check", "kernel": "layer_norm",
               "shape": [rows, d], "dtype": str(x_dtype),
               "scale_dtype": str(w_dtype), "max_abs_err": err, "tol": tol,
               "ms": ms, "plain_ms": plain_ms}
        emit(rec)
        require(ok, f"layer_norm {x_dtype}/{w_dtype}: err {err}")
        if x_dtype == w_dtype == torch.bfloat16:
            summary["layer_norm"] = rec
    check_training_attention(randn, summary)
    check_layer_norm_bwd(randn, summary)
    return summary


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got − ref| over max |ref|."""
    ref = ref.float()
    return ((got.float() - ref).abs().max()
            / ref.abs().max().clamp_min(1e-30)).item()


def check_training_attention(randn, summary: dict) -> None:
    """The forward-with-lse and backward kernels against their plain
    versions, at the training batch."""
    from chestxray_vit_tpu_torch.ops import flash_attention as fa

    for s in (577, 512, 37):
        for dtype in (torch.bfloat16, torch.float32):
            shape = (TRAIN_BATCH, 12, s, 64)
            # q, k, v as the projections leave them: [B, H, S, d] views
            x = randn((TRAIN_BATCH, s, 3, 12, 64), dtype)
            q, k, v = (t.transpose(1, 2) for t in x.unbind(2))
            do = randn(shape, dtype)
            tol = ATTN_TOL[dtype]

            o, lse = fa.flash_attention_fwd(q, k, v)
            ro, rlse = fa.attention_fwd_reference(q, k, v)
            torch.cuda.synchronize()
            err_o = (o.float() - ro.float()).abs().max().item()
            err_lse = (lse - rlse).abs().max().item()
            ms, plain_ms = time_pair(
                lambda: fa.flash_attention_fwd(q, k, v),
                lambda: fa.attention_fwd_reference(q, k, v))
            rec = {"phase": "kernel_check", "kernel": "attention_fwd",
                   "shape": list(shape), "dtype": str(dtype),
                   "max_abs_err": err_o, "lse_max_abs_err": err_lse,
                   "tol": tol, "ms": ms, "plain_ms": plain_ms}
            emit(rec)
            require(bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
                    and err_o <= tol and err_lse <= tol,
                    f"attention fwd S={s} {dtype}: o {err_o}, lse {err_lse}")

            grads = fa.flash_attention_bwd(q, k, v, o, lse, do)
            refs = fa.attention_bwd_reference(q, k, v, o, lse, do)
            torch.cuda.synchronize()
            errs = [rel_err(g, r) for g, r in zip(grads, refs)]
            ms_b, plain_ms_b = time_pair(
                lambda: fa.flash_attention_bwd(q, k, v, o, lse, do),
                lambda: fa.attention_bwd_reference(q, k, v, o, lse, do))
            rec_b = {"phase": "kernel_check", "kernel": "attention_bwd",
                     "shape": list(shape), "dtype": str(dtype),
                     "dq_dk_dv_rel_err": errs,
                     "max_abs_err": max((g.float() - r.float()).abs().max()
                                        .item() for g, r in zip(grads, refs)),
                     "rel_tol": ATTN_GRAD_TOL[dtype], "ms": ms_b,
                     "plain_ms": plain_ms_b}
            emit(rec_b)
            require(all(bool(torch.isfinite(g).all()) for g in grads)
                    and max(errs) <= ATTN_GRAD_TOL[dtype],
                    f"attention bwd S={s} {dtype}: {errs}")
            if s == 577 and dtype == torch.bfloat16:
                summary["flash_attention_fwd"] = rec
                summary["flash_attention_bwd"] = rec_b


def check_layer_norm_bwd(randn, summary: dict) -> None:
    """The LayerNorm backward kernel against its plain version at the
    training rows (36 × 577), with the block LNs' bf16 scale, the final
    LN's f32 scale and in f32; and that it gives the same bits twice."""
    from chestxray_vit_tpu_torch.ops import layer_norm as ln

    rows, d = TRAIN_BATCH * 577, 768
    for x_dtype, w_dtype in ((torch.bfloat16, torch.bfloat16),
                             (torch.bfloat16, torch.float32),
                             (torch.float32, torch.float32)):
        x = randn((rows, d), x_dtype) * 3 + 1
        scale, dy = randn((d,), w_dtype), randn((rows, d), x_dtype)
        got = ln.layer_norm_bwd_cuda(x, scale, dy, 1e-12)
        again = ln.layer_norm_bwd_cuda(x, scale, dy, 1e-12)
        refs = ln.layer_norm_bwd_reference(x, scale, dy, 1e-12)
        torch.cuda.synchronize()
        ok = all(torch.equal(a, b) for a, b in zip(got, again))
        dx, ref_dx = got[0].float(), refs[0].float()
        if x_dtype == torch.bfloat16:
            ok &= bool(((dx - ref_dx).abs()
                        <= bf16_ulp(ref_dx) + LN_F32_TOL).all())
        else:
            ok &= (dx - ref_dx).abs().max().item() <= LN_F32_TOL
        for g, r in zip(got[1:], refs[1:]):
            g, r = g.float(), r.float()
            bound = LN_BWD_REL_TOL * r.abs().max()
            if w_dtype == torch.bfloat16:
                bound = bound + bf16_ulp(r)
            ok &= bool(((g - r).abs() <= bound).all())
        ms, plain_ms = time_pair(
            lambda: ln.layer_norm_bwd_cuda(x, scale, dy, 1e-12),
            lambda: ln.layer_norm_bwd_reference(x, scale, dy, 1e-12))
        rec = {"phase": "kernel_check", "kernel": "layer_norm_bwd",
               "shape": [rows, d], "dtype": str(x_dtype),
               "scale_dtype": str(w_dtype),
               "max_abs_err": max((g.float() - r.float()).abs().max().item()
                                  for g, r in zip(got, refs)),
               "dscale_dbias_rel_err": [rel_err(g, r) for g, r in
                                        zip(got[1:], refs[1:])],
               "deterministic": all(torch.equal(a, b)
                                    for a, b in zip(got, again)),
               "tol": "dx as layer_norm; dscale/dbias 1e-5 rel (+1 ulp "
                      "in bf16)", "ms": ms, "plain_ms": plain_ms}
        emit(rec)
        require(ok, f"layer_norm_bwd {x_dtype}/{w_dtype}: {rec}")
        if x_dtype == w_dtype == torch.bfloat16:
            summary["layer_norm_bwd"] = rec


def make_requests() -> list:
    """Seeded u8 grayscale images of varied size up to 1024²."""
    rng = np.random.default_rng(SEED)
    out = []
    for i in range(REQUESTS):
        h, w = (1024, 1024) if i == 0 else rng.integers(256, 1025, 2)
        img = rng.integers(0, 256, (h, w), np.uint8)
        # a bright disc, so the images are not pure noise
        yy, xx = np.ogrid[:h, :w]
        img[(yy - h // 2) ** 2 + (xx - w // 3) ** 2 < (min(h, w) // 4) ** 2] \
            = 230
        out.append(img)
    return out


def phase_serving(params, cfg, images: list):
    import chestxray_vit_tpu_torch as cxr

    t0 = time.perf_counter()
    pred = cxr.Predictor(params, cfg, batch_size=BATCH, placement="device",
                         device="cuda")
    pred.warmup()
    warm_s = time.perf_counter() - t0
    batcher = cxr.MicroBatcher(pred)
    submitted = [0.0] * len(images)
    done = [0.0] * len(images)
    futures = [None] * len(images)

    def client(idx):
        for i in idx:
            submitted[i] = time.perf_counter()
            fut = batcher.submit(images[i])
            fut.add_done_callback(
                lambda _f, i=i: done.__setitem__(i, time.perf_counter()))
            futures[i] = fut

    # the counts cover exactly the main path's run
    reset_launch_counts()
    pred.forwards = 0
    try:
        threads = [threading.Thread(target=client,
                                    args=(range(t, len(images),
                                                CLIENT_THREADS),))
                   for t in range(CLIENT_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            require(not t.is_alive(), "client thread finished")
        results = [f.result(timeout=300) for f in futures]
    finally:
        batcher.close()
    launches = launch_counts()
    attn_launches = launches["flash_attention_inference"]
    ln_launches = launches["layer_norm"]
    forwards = pred.forwards

    probs = np.stack([r.probs for r in results])
    logits = np.stack([r.logits for r in results])
    lat = sorted(d - s for s, d in zip(submitted, done))
    wall = max(done) - min(submitted)
    rec = {"phase": "serving", "requests": len(images),
           "answered": len(results), "client_threads": CLIENT_THREADS,
           "batch_size": BATCH, "forwards": forwards,
           "attention_launches": attn_launches,
           "layer_norm_launches": ln_launches,
           "probs_shape": list(probs.shape),
           "probs_finite_in_0_1": bool(np.isfinite(probs).all()
                                       and (probs >= 0).all()
                                       and (probs <= 1).all()),
           "images_per_s": len(images) / wall,
           "p50_latency_ms": 1e3 * statistics.median(lat),
           "max_latency_ms": 1e3 * lat[-1],
           "warmup_s": warm_s}
    emit(rec)
    require(rec["answered"] == len(images), "every request answered")
    require(probs.shape == (len(images), cfg.num_classes),
            "15 probabilities per request")
    require(rec["probs_finite_in_0_1"], "probabilities finite in [0, 1]")
    require(forwards > 0 and attn_launches == cfg.num_layers * forwards,
            f"{attn_launches} attention launches for {forwards} forwards")
    require(ln_launches == (2 * cfg.num_layers + 1) * forwards,
            f"{ln_launches} LayerNorm launches for {forwards} forwards")
    require(sum(launches.values()) == attn_launches + ln_launches,
            f"serving launched no training kernel: {launches}")
    return logits, launches


def phase_cross_check(params, cfg, images: list, card_logits) -> None:
    import dataclasses

    import chestxray_vit_tpu_torch as cxr

    pick = [0, 1]
    f32 = dataclasses.replace(cfg, dtype="float32")
    cpu = cxr.Predictor(params, f32, batch_size=2, placement="device",
                        device="cpu").predict_arrays(
        [images[i] for i in pick]).logits
    card_f32 = cxr.Predictor(params, f32, batch_size=2, placement="device",
                             device="cuda").predict_arrays(
        [images[i] for i in pick]).logits
    d_bf16 = float(np.abs(card_logits[pick] - cpu).max())
    d_f32 = float(np.abs(card_f32 - cpu).max())
    emit({"phase": "cross_check", "images": pick,
          "cpu_f32_logits_absmax": float(np.abs(cpu).max()),
          "card_bf16_vs_cpu_f32_max_abs": d_bf16, "tol_bf16": BF16_LOGIT_TOL,
          "card_f32_vs_cpu_f32_max_abs": d_f32, "tol_f32": F32_LOGIT_TOL})
    require(np.isfinite(cpu).all() and np.isfinite(card_f32).all(),
            "finite logits")
    require(d_bf16 <= BF16_LOGIT_TOL, f"bf16 card vs f32 CPU: {d_bf16}")
    require(d_f32 <= F32_LOGIT_TOL, f"f32 card vs f32 CPU: {d_f32}")


def train_config(**model):
    import chestxray_vit_tpu_torch as cxr
    return cxr.Config(model=cxr.ModelConfig(num_classes=15, **model),
                      train=cxr.TrainConfig())


def phase_train():
    """bench.py's train step on the card: ViT-B/16 @384, bf16, full remat,
    batch 36, TrainConfig defaults, over 10,000 scheduled steps."""
    from chestxray_vit_tpu_torch.models.vit import init_params
    from chestxray_vit_tpu_torch.train import steps

    dev = torch.device("cuda")
    cfg = train_config(remat=True)
    n_layers = cfg.model.num_layers
    per_step = {"flash_attention_fwd": 2 * n_layers,   # forward + recompute
                "flash_attention_bwd": n_layers,
                "layer_norm": 2 * (2 * n_layers + 1) - 1,  # final LN once
                "layer_norm_bwd": 2 * n_layers + 1,
                "flash_attention_inference": 0}
    batch = bench_batch(TRAIN_BATCH, SEED, dev)
    params = init_params(torch.Generator().manual_seed(SEED), cfg.model, dev)
    state = steps.TrainState.create(params, seed=42)
    train_step = steps.make_train_step(cfg, total_steps=10_000)

    losses, norms, step_counts = [], [], []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        if i == WARMUP_STEPS:               # the timed steps: the main path
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
        before = launch_counts()
        state, m = train_step(state, batch)
        after = launch_counts()
        step_counts.append({k: after[k] - before[k] for k in after})
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
        if i == 0:                          # for the no-remat comparison
            first = (m["loss"].clone(),
                     {n: p.grad.clone() for n, p in params.named_parameters()})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).tolist()
    norms = torch.stack(norms).tolist()
    rec = {"phase": "train", "batch": TRAIN_BATCH, "remat": "full",
           "dtype": cfg.model.dtype, "warmup_steps": WARMUP_STEPS,
           "timed_steps": TIMED_STEPS,
           "step_ms": 1e3 * wall / TIMED_STEPS,
           "images_per_s": TRAIN_BATCH * TIMED_STEPS / wall,
           "max_memory_allocated_gb": peak / 1e9,
           "losses": losses, "grad_norms": norms,
           "launches_per_step": step_counts[-1], "launches": launches}
    emit(rec)
    require(all(np.isfinite(losses)) and all(np.isfinite(norms)),
            "finite loss and grad_norm at every step")
    require(losses[-1] < losses[0],
            f"loss went down over the steps: {losses[0]} → {losses[-1]}")
    require(all(c == per_step for c in step_counts),
            f"launches per step {step_counts} != {per_step}")

    # one step without remat from the same weights, against the first
    del state, m
    params_nr = init_params(torch.Generator().manual_seed(SEED), cfg.model,
                            dev)
    step_nr = steps.make_train_step(train_config(remat=False),
                                    total_steps=10_000)
    state_nr, m_nr = step_nr(steps.TrainState.create(params_nr, seed=42),
                             batch)
    loss_diff = abs(m_nr["loss"].item() - first[0].item())
    scale = max(g.abs().max().item() for g in first[1].values())
    grad_diff = max((p.grad - first[1][n]).abs().max().item()
                    for n, p in params_nr.named_parameters()) / scale
    del first
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    state_nr, m_nr = step_nr(state_nr, batch)
    torch.cuda.synchronize()
    rec_nr = {"phase": "train_no_remat", "batch": TRAIN_BATCH,
              "loss_diff_vs_remat": loss_diff,
              "grad_rel_diff_vs_remat": grad_diff,
              "tol": [REMAT_LOSS_TOL, REMAT_GRAD_TOL],
              "one_step_ms": 1e3 * (time.perf_counter() - t1),
              "max_memory_allocated_gb":
                  torch.cuda.max_memory_allocated() / 1e9}
    emit(rec_nr)
    require(loss_diff <= REMAT_LOSS_TOL and grad_diff <= REMAT_GRAD_TOL,
            f"remat vs no remat: loss {loss_diff}, grads {grad_diff}")
    del state_nr, params_nr
    torch.cuda.empty_cache()
    return params, cfg, launches


def phase_train_cross_check() -> None:
    """One train step at full width, depth 2, batch 2: the card in f32 and
    in bf16 against the CPU in f32 (plain versions), same weights."""
    import dataclasses

    from chestxray_vit_tpu_torch.models import bridge
    from chestxray_vit_tpu_torch.models.vit import init_params
    from chestxray_vit_tpu_torch.train import steps

    cfg32 = train_config(num_layers=2, dtype="float32")
    cfg16 = dataclasses.replace(cfg32, model=dataclasses.replace(
        cfg32.model, dtype="bfloat16"))
    cpu_params = init_params(torch.Generator().manual_seed(SEED), cfg32.model)
    tree = bridge.params_to_numpy(cpu_params)
    batch = bench_batch(2, SEED + 1, "cpu")

    def run(cfg, params, device):
        dev_batch = {k: v.to(device) for k, v in batch.items()}
        state, m = steps.make_train_step(cfg, total_steps=10_000)(
            steps.TrainState.create(params, seed=0), dev_batch)
        return ({k: v.item() for k, v in m.items()},
                _leaves(bridge.grads_to_numpy(state.params)),
                _leaves(bridge.params_to_numpy(state.params)))

    cpu_m, cpu_g, cpu_p = run(cfg32, cpu_params, "cpu")
    g_scale = max(float(np.abs(g).max()) for g in cpu_g)
    rec = {"phase": "train_cross_check", "depth": 2, "batch": 2,
           "cpu_f32_loss": cpu_m["loss"], "tol_f32": XCHECK_F32,
           "tol_bf16": XCHECK_BF16}
    for name, cfg in (("f32", cfg32), ("bf16", cfg16)):
        card = bridge.params_from_jax(tree, cfg.model).to("cuda")
        m, g, p = run(cfg, card, "cuda")
        rec[f"card_{name}_loss_diff"] = abs(m["loss"] - cpu_m["loss"])
        rec[f"card_{name}_grad_norm_rel_diff"] = (
            abs(m["grad_norm"] - cpu_m["grad_norm"]) / cpu_m["grad_norm"])
        rec[f"card_{name}_grads_rel_diff"] = max(
            float(np.abs(a - b).max()) for a, b in zip(g, cpu_g)) / g_scale
        rec[f"card_{name}_params_max_abs_diff"] = max(
            float(np.abs(a - b).max()) for a, b in zip(p, cpu_p))
    emit(rec)
    for key, tol in (("loss_diff", XCHECK_F32["loss"]),
                     ("grad_norm_rel_diff", XCHECK_F32["grad_norm_rel"]),
                     ("grads_rel_diff", XCHECK_F32["grads_rel"]),
                     ("params_max_abs_diff", XCHECK_F32["params"])):
        require(rec[f"card_f32_{key}"] <= tol, f"f32 {key}: {rec}")
    for key, tol in (("loss_diff", XCHECK_BF16["loss"]),
                     ("grads_rel_diff", XCHECK_BF16["grads_rel"]),
                     ("params_max_abs_diff", XCHECK_BF16["params"])):
        require(rec[f"card_bf16_{key}"] <= tol, f"bf16 {key}: {rec}")


def _leaves(tree: dict) -> list:
    out = []
    for key in sorted(tree):
        val = tree[key]
        out.extend(_leaves(val) if isinstance(val, dict) else [val])
    return out


def phase_eval(params, cfg) -> dict:
    """The eval step over 4 batches of 36 on the trained weights, then
    AUROC and F1 on the card, each against the CPU."""
    from chestxray_vit_tpu_torch.eval import metrics
    from chestxray_vit_tpu_torch.train import steps

    eval_step = steps.make_eval_step(cfg)
    dev = torch.device("cuda")
    batches = [bench_batch(TRAIN_BATCH, SEED + 10 + i, dev)
               for i in range(EVAL_BATCHES)]
    reset_launch_counts()
    outs = [eval_step(params, b) for b in batches]
    torch.cuda.synchronize()
    launches = launch_counts()
    logits = torch.cat([o[0] for o in outs])
    rows = torch.cat([o[1] for o in outs])
    labels = torch.cat([b["labels"] for b in batches])
    card = metrics.compute_metrics(logits, labels)
    cpu = metrics.compute_metrics(logits.cpu(), labels.cpu())

    x = logits.double().cpu().numpy()
    z = labels.double().cpu().numpy()
    host_rows = (np.maximum(x, 0) - x * z
                 + np.log1p(np.exp(-np.abs(x)))).sum(axis=1)
    row_err = float(np.abs(rows.cpu().numpy() - host_rows).max())
    n = EVAL_BATCHES
    rec = {"phase": "eval", "batches": n, "batch": TRAIN_BATCH,
           "logits_shape": list(logits.shape),
           "finite": bool(torch.isfinite(logits).all()),
           "row_loss_max_abs_err": row_err, "metrics_card": card,
           "metrics_cpu": cpu, "launches": launches}
    emit(rec)
    require(rec["finite"] and logits.shape == (n * TRAIN_BATCH, 15),
            "finite logits of the expected shape")
    # f32 sums of 15 elements of O(1) against the f64 host sum
    require(row_err <= 1e-4, f"row losses vs host: {row_err}")
    require(all(abs(card[k] - cpu[k]) <= 1e-6 for k in card),
            f"metrics card vs CPU: {card} {cpu}")
    require(launches["flash_attention_inference"] == cfg.model.num_layers * n
            and launches["layer_norm"] == (2 * cfg.model.num_layers + 1) * n
            and launches["flash_attention_fwd"] == 0
            and launches["layer_norm_bwd"] == 0,
            f"eval launches {launches}")
    return launches


KERNELS = (  # name, source, the TPU kernel it replaces, kernel_check key
    ("flash_attention_inference", "csrc/flash_attention_inf.cu",
     "chestxray_vit_tpu/ops/flash_attention.py:319", "attention"),
    ("layer_norm", "csrc/layer_norm.cu",
     "chestxray_vit_tpu/ops/layer_norm.py:93", "layer_norm"),
    ("flash_attention_fwd", "csrc/flash_attention.cu",
     "chestxray_vit_tpu/ops/flash_attention.py:267", "flash_attention_fwd"),
    ("flash_attention_bwd", "csrc/flash_attention_bwd.cu",
     "chestxray_vit_tpu/ops/flash_attention.py:755", "flash_attention_bwd"),
    ("layer_norm_bwd", "csrc/layer_norm.cu",
     "chestxray_vit_tpu/ops/layer_norm.py:103", "layer_norm_bwd"),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    # the port itself; outside a checkout of the repo this import fails
    from chestxray_vit_tpu_torch import ModelConfig
    from chestxray_vit_tpu_torch.models.vit import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device()
    phase_build()
    checked = phase_kernel_check()

    cfg = ModelConfig()                 # ViT-B/16 @384, 15 classes, bf16
    params = init_params(torch.Generator().manual_seed(SEED), cfg)
    images = make_requests()
    card_logits, serve_launches = phase_serving(params, cfg, images)
    phase_cross_check(params, cfg, images, card_logits)
    del params
    train_params, train_cfg, train_launches = phase_train()
    phase_train_cross_check()
    eval_launches = phase_eval(train_params, train_cfg)
    require("jax" not in sys.modules, "no JAX imported")

    # launches: the sum over the main paths' runs (serving, the timed
    # train steps, eval), each counted from 0 just before it
    paths = (serve_launches, train_launches, eval_launches)
    summary = []
    for name, source, replaces, key in KERNELS:
        launches = sum(p[name] for p in paths)
        require(launches > 0, f"{name} launched on the main paths")
        summary.append({
            "name": name, "route": "cuda",
            "source": f"chestxray_vit_tpu_torch/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": checked[key]["max_abs_err"],
            "ms": checked[key]["ms"], "plain_ms": checked[key]["plain_ms"]})
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
