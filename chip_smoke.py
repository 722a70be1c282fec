"""Smoke run of the PyTorch port on one NVIDIA GPU: the serving path, the
fine-tune step (dense, and with attention dropout, hidden dropout and
mixup), the eval step and packed variable-resolution training (with and
without within-segment token merging).

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. device: a CUDA card is required (exit 2 without one, before any
   result); its name and power limit as nvidia-smi prints them.
2. build: the kernels in chestxray_vit_tpu_torch/csrc/ built with nvcc
   (one process per source, all at once).
3. kernel_check: after a second of products that brings the card to its
   working clocks, each kernel against its plain PyTorch version on the
   card, at its path's shapes (ViT-B/16 @384: batch 8 for serving, batch 32
   for int8 serving, batch 36 for training), with the tolerance stated; the
   median time of each, of its plain version and of the one PyTorch call
   that computes the same function (timed only, never used by the port),
   and its bound. The int8 kernel and the LayerNorm forward and backward
   also give the profiler's device time beside the CUDA-event time
   (``device_ms``: the card alone, where events around a fast call also
   time the host), their library call's too, and their time before their
   redesign (``earlier_ms``, EARLIER_INT8_MS, EARLIER_LN_MS,
   EARLIER_LN_BWD_MS). The
   dropout kernels at [36, 12, 577, 64], rate 0.1: the debug kernel's mask
   against the plain counter hash (0 mismatches), o, lse and dq/dk/dv. The
   dense, inference and dropout attention kernels are also checked, not
   timed, at the edges of their 64-row tiles (EDGE_LENGTHS); the dense
   forwards and backwards carry ``earlier_ms``, their time before the
   redesign (EARLIER_FWD_MS, EARLIER_BWD_MS).
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
9. train_dropout: the step of 6 with attention dropout 0.1, hidden
   dropout 0.1 and mixup α 0.2: 2 warm-up and 5 timed steps, finite
   losses, exact launch counts per step (24 dropout forwards, 12 dropout
   backwards, no dense training attention), then one step with and one
   without remat on the same weights, batch and draws.
10. train_dropout_cross_check: 7 with attention dropout 0.1 and mixup on
   the same injected draws (the attention mask is a counter hash, equal on
   the card and the CPU; hidden dropout draws from a generator of the
   tensor's device, so 9 and the CPU tests cover it).
11. serving_int8: a static-int8 Predictor (calibrated on 8 of the request
   images, batch 32, the fused int8 kernel) behind the MicroBatcher answers
   128 concurrent requests: 15 finite probabilities each, exactly 73 int8
   kernel launches (1 + 6 per layer), 12 attention and 25 LayerNorm per
   forwarded batch; beside it a dense bf16 Predictor at batch 32 on the same
   requests, and the b32 forward time of the fused route, the plain "xla"
   route, dynamic int8 and dense bf16 on the same images.
12. int8_cross_check: on that tree and 32 of the images, the card's fused
   route against the port's CPU plain route (2 images) and the card's
   "xla" route, in f32 and bf16 (logits within 0.15, correlation above
   0.995; see INT8_ROUTE_TOL), and the bf16 fused route against the card's
   dense f32 forward (probabilities within 0.1, logit correlation above
   0.995).
13. eval_int8: the int8 eval step on a static tree of the trained weights
   over the eval batches of 8, against the host's row losses, with exact
   launch counts.

14. train_packed: the packed (NaViT-style) train step on the packed
   probe's batch, 32 sequences of 1152 tokens holding two 384 x 384 images
   each (64 images), bf16, full remat: 3 warm-up and 8 timed steps, the
   loss falls on the fixed batch, exactly 24 segment-forward and 12
   segment-backward launches per step and no dense attention kernel; the
   dense b36 step's images/s of phase 6 beside it.
15. train_packed_mixed: 32 sequences packed from 256 / 384 / 512 px images
   (256, 576 and 1024 tokens) with attention dropout 0.1 and hidden
   dropout 0.1: the two dropout segment kernels, exact launch counts, the
   pad share of the batch, then remat against no remat on the same draws
   (8 of the sequences).
16. train_packed_tome: the batch of 14 with tome_r = 16 under the
   decreasing schedule: 24 / 12 launches at twelve different lengths.
17. train_packed_cross_check: depth 2, full width, one f32 step on the
   card against the CPU (plain versions), packed and packed with merging,
   with attention dropout on injected seeds.

kernel_check also holds the four segment kernels to their plain versions at
[32, 12, 1152, 64] bf16 (f32 at batch 4) in three layouts: two segments of
576; mixed with padding (1024 + 128 pad, 576 + 256 + 256 + 64 pad,
4 x 256 + 128 pad); and ragged with interleaved ids (S = 1136, the order a
token merge leaves). It also holds the int8 kernel to its plain version at the batch-32
serving shapes in its five call forms (INT8_FORMS: patch embed, Q/K/V, the
residual forms of wo and mlp_out, mlp_in with GELU and requantize), equal
bits twice.

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

from smoke_batches import (PACKED_SEQS, TOME_R, TOME_SCHEDULE, bench_batch,
                           packed_batch, packed_layouts, packed_mixed_batch,
                           packed_probe_batch, skipped_tile_share, tensors)

BATCH = 8
REQUESTS = 32
INT8_BATCH, INT8_REQUESTS = 32, 128
CLIENT_THREADS = 4
SEED = 0
TRAIN_BATCH = 36            # bench.py's batch per chip; remat on above 32
WARMUP_STEPS, TIMED_STEPS = 3, 10
DROPOUT_WARMUP_STEPS, DROPOUT_TIMED_STEPS = 2, 5
EVAL_BATCHES = 4
PACKED_WARMUP_STEPS, PACKED_TIMED_STEPS = 3, 8
PACKED_F32_BATCH = 4                        # kernel_check's f32 batch
DROP_RATE, DROP_SEED = 0.1, -123456789   # a negative int32 seed, as JAX's
MIXUP_ALPHA = 0.2

# The least time the card could take for a kernel's work: the larger of its
# bytes (each input read once, each output written once) over the memory
# rate and its operations over the peak rate of their type, from NVIDIA's
# data sheet for the H100 SXM (dense): products on the tensor cores in bf16,
# on the CUDA cores (plain FMA) in f32; LayerNorm's arithmetic on the CUDA
# cores, beside the tensor cores in bf16. The dropout hash is integer work:
# the data sheet gives no INT32 rate, so it is counted at the SM's 64 INT32
# lanes per clock (half its 128 FP32 lanes), 132 SMs at the 1,980 MHz boost
# clock, beside both.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS, CUDA_CORE_FLOPS = 989e12, 67e12
INT8_TENSOR_OPS = 1979e12
INT32_OPS = 132 * 64 * 1.98e9
# integer operations of the hash per score element: add the column, XOR
# the seed, murmur3's finalizer (3 shift-XORs, 2 multiplies), compare, select
HASH_OPS = 12
# LayerNorm per element: forward mean, variance, normalize, scale, shift;
# backward the two row sums, dx, and the dscale/dbias sums
LN_FWD_OPS, LN_BWD_OPS = 8, 12
# the int8 kernel's epilogue per output element, f32 on the CUDA cores:
# dequantize and bias 2, residual 1, GELU (erf polynomial, exp2, sign) 21,
# requantize 4
INT8_EPI_OPS = {"base": 2, "resid": 1, "gelu": 21, "requant": 4}

# Tolerances, each with its reason:
# - attention, bf16: the bf16 tolerance of tests/test_flash_attention.py
#   (the kernel rounds P to bf16 before its running normalization, the plain
#   version after); f32: summation order only.
ATTN_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-5}
# - segment attention, bf16, tighter than the dense rows, so that a few
#   dropped or wrongly masked keys per row, or a wrong guard of the running
#   max on a few rows, cannot pass: o within two bf16 ulps at |o| in [1, 2)
#   (1.6e-2; read 0.0078 on an H100, one ulp), the f32 lse within 5e-3
#   (read 0.0009: P is rounded to bf16 before the kernel's running sum, a
#   relative error of the sum of at most 2^-9 and far less on average; one
#   key lost of a segment of 576 moves lse by about 1/576 at equal scores
#   and by more where it matters). f32: summation order only.
PACKED_TOL = {torch.bfloat16: {"o": 1.6e-2, "lse": 5e-3},
              torch.float32: {"o": 1e-5, "lse": 1e-5}}
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
# - int8 kernel vs its plain version: every output equal, int8 included
#   (the same exact integer sums, the epilogue rounded at the same points,
#   its exp2f libdevice's as PyTorch's exp2 on the card).
# - int8 routes, the fused route against the plain one (the port's CPU
#   route, the card's "xla" route) on the same tree and images, in f32 and
#   bf16. The static int8 forward is not continuous: an activation within
#   a rounding error of an int8 step boundary quantizes one step apart, and
#   over 12 layers of width 768 such flips re-draw the quantization noise.
#   LayerNorm and attention sum in other orders on the card and the CPU,
#   and the routes round GELU → requantize differently, so their logits
#   differ by about int8's own error against the dense f32 forward (on an
#   H100 80GB HBM3: 0.033–0.087 against 0.060–0.071), and so does the fused
#   route on its f32 input moved by noise of f32-rounding size
#   (``noise_sensitivity``, N(0, 1e-6) on pixels of O(1), measured in every
#   run). Bound: 0.15 in logits of O(1) with a logit correlation above
#   0.995 (tests/test_quant.py's correlation bound for int8 against f32); a
#   wrong scale, bias or residual moves logits by O(1). The int8 kernel
#   itself equals its plain version (kernel_check). int8 against the dense
#   f32 forward: tests/test_quant.py's bounds.
INT8_ROUTE_TOL, INT8_ROUTE_MIN_CORR = 0.15, 0.995
NOISE_STD = 1e-6
INT8_PROB_TOL, INT8_MIN_CORR = 0.1, 0.995


# Sequence lengths at which the dense attention kernels are held against
# their plain versions beside the serving and training lengths: the edges
# of their 64-row tiles, a tail of one row, and more tiles than the copy
# ring has stages (checked, not timed).
EDGE_LENGTHS = (64, 128, 129, 576, 1025)
# The dense attention kernels before their redesign (mma.sync from scalar
# shared-memory loads, synchronous tile loads, transposed copies) on an
# NVIDIA H100 80GB HBM3 at 700.00 W: the backwards at [36, 12, 577, 64]
# bf16, the training forward there and the inference forward at
# [8, 12, 577, 64].
EARLIER_BWD_MS = {"flash_attention_bwd": 1.7810,
                  "flash_attention_dropout_bwd": 1.9064}
EARLIER_FWD_MS = {"flash_attention_fwd": 0.4434,
                  "flash_attention_inference": 0.1046}
# The int8 kernel before its redesign (mma.sync, two cp.async stages,
# 2-element stores) and the LayerNorm forward before its own (registers
# for D = 2048, one row a warp): (CUDA-event ms, profiler device ms), the
# mean of two runs of attn_probe.py --parent on an NVIDIA H100 80GB HBM3 at
# 700.00 W, at check_int8_matmul's five forms and at check_layer_norm's
# bf16 rows by the scale's dtype.
EARLIER_INT8_MS = {"patch_embed": (0.07247200012207031, 0.06717615000000002),
                   "q": (0.07384960055351257, 0.06727784999999997),
                   "wo_resid": (0.09932319819927216, 0.09270415000000011),
                   "mlp_in_gelu_requant": (0.341815996170044,
                                           0.32579794999999995),
                   "mlp_out_resid": (0.2323807954788208, 0.2212899)}
EARLIER_LN_MS = {(4616, "torch.bfloat16"): (0.02654239982366562,
                                            0.009964300000000027),
                 (18464, "torch.bfloat16"): (0.044433599710464476,
                                             0.04048999999999998),
                 (18464, "torch.float32"): (0.05555679798126221,
                                            0.05183605000000009),
                 (20772, "torch.bfloat16"): (0.04831520020961762,
                                             0.04487954999999995)}
# The LayerNorm backward before its redesign (one row a warp with no
# prefetch, a serial block combine, a column pass on six SMs): (CUDA-event
# ms, profiler device ms) by (rows, scale dtype) at check_layer_norm_bwd's
# bf16 rows, the mean of two runs of attn_probe.py --only ln --parent on an
# NVIDIA H100 80GB HBM3 at 700.00 W.
EARLIER_LN_BWD_MS = {(20772, "torch.bfloat16"): (0.1004207968711853,
                                                 0.09289450000000007),
                     (20772, "torch.float32"): (0.10245119929313659,
                                                0.09349860000000002),
                     (36864, "torch.bfloat16"): (0.1443567991256714,
                                                 0.13422415000000001),
                     (36864, "torch.float32"): (0.14273279905319214,
                                                0.13473835)}
# Seconds of back-to-back products that bring the card to its working
# clocks before the first kernel is timed.
WARM_UP_S = 1.0


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


def time_pair(kernel, plain, plain_reps: int = 7,
              plain_inner: int = 10) -> tuple:
    """(kernel ms, plain ms), measured in turns: plain, kernel, kernel,
    plain. A plain version that takes tens of ms is given fewer calls."""
    p1 = time_ms(plain, plain_reps, plain_inner)
    k1, k2 = time_ms(kernel), time_ms(kernel)
    p2 = time_ms(plain, plain_reps, plain_inner)
    return (k1 + k2) / 2, (p1 + p2) / 2


def device_ms(fn, calls: int = 10, parts: tuple = ()) -> dict:
    """``device_ms``: mean device milliseconds per call of every kernel
    ``fn`` launches, from a ``torch.profiler`` trace of ``calls`` calls (the
    card's time alone, where CUDA events around the calls also time a host
    that cannot keep up); ``<part>_ms`` for each name fragment in
    ``parts``: the kernels whose name holds it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {"device_ms": 0.0, **{f"{part}_ms": 0.0 for part in parts}}
    for ev in prof.key_averages():
        ms = ev.device_time_total / 1e3 / calls
        out["device_ms"] += ms
        for part in parts:
            if part in ev.key:
                out[f"{part}_ms"] += ms
    return out


def backward_pass_ms(fn, calls: int = 10) -> dict:
    """``dkdv_ms`` and ``dq_ms``: mean device milliseconds per call of an
    attention backward's dK/dV kernel and dQ kernel (``delta_ms``: its
    pre-pass)."""
    got = device_ms(fn, calls, ("attn_bwd_delta", "attn_bwd_dkdv",
                                "attn_bwd_dq"))
    return {f"{part}_ms": got[f"attn_bwd_{part}_ms"]
            for part in ("delta", "dkdv", "dq")}


def bound(nbytes: float, flops: float, dtype, core_ops: float = 0.0,
          int_ops: float = 0.0) -> dict:
    """``bound_ms`` and ``bound_by`` of a kernel's work (see
    HBM_BYTES_PER_S): ``flops`` are its products, on the tensor cores in
    bf16 and int8, ``core_ops`` the float work on the CUDA cores beside
    them, ``int_ops`` the integer work."""
    if dtype == torch.int8:
        t_ops = max(flops / INT8_TENSOR_OPS, core_ops / CUDA_CORE_FLOPS)
    elif dtype == torch.bfloat16:
        t_ops = max(flops / BF16_TENSOR_FLOPS, core_ops / CUDA_CORE_FLOPS)
    else:
        t_ops = (flops + core_ops) / CUDA_CORE_FLOPS
    t_ops = max(t_ops, int_ops / INT32_OPS)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "bytes": nbytes, "flops": flops, "core_ops": core_ops,
            "int_ops": int_ops}


def attention_bound(shape, dtype, *, backward=False, lse=False,
                    hash_passes=0, mask_out=False) -> dict:
    """The attention forward reads q, k, v and writes o (and lse): 4·S²·d
    flops per head (QKᵀ and PV). The backward reads q, k, v, o, dO and lse
    and writes dq, dk, dv: 10·S²·d (S again, dV, dP, dQ, dK). The dropout
    kernels hash each score element once, forward and backward alike: dq,
    dk and dv need each keep bit once, so a second hash in a backward that
    is split into a dK/dV and a dQ kernel is that design's cost, not the
    function's work. The debug forward also writes the byte mask."""
    b, h, s, d = shape
    e = torch.empty((), dtype=dtype).element_size()
    tensors = 8 if backward else 4
    nbytes = (tensors * b * h * s * d * e
              + (4 * b * h * s if backward or lse else 0)
              + (b * h * s * s if mask_out else 0))
    flops = (10 if backward else 4) * b * h * s * s * d
    return bound(nbytes, flops, dtype,
                 int_ops=HASH_OPS * hash_passes * b * h * s * s)


def packed_attention_bound(seg: torch.Tensor, heads: int, dtype, *,
                           backward=False, hash_passes=0) -> dict:
    """The segment kernels' bound counts each input and output once (the
    ids too, once for all heads) and only same-segment products: the sum
    over sequences and segments of len², not S²."""
    b, s = seg.shape
    d = 64
    e = torch.empty((), dtype=dtype).element_size()
    ids = seg.cpu().numpy()
    pairs = heads * sum(int((np.unique(row, return_counts=True)[1] ** 2)
                            .sum()) for row in ids)
    tensors = 8 if backward else 4
    nbytes = tensors * b * heads * s * d * e + 4 * b * heads * s + 4 * b * s
    return {**bound(nbytes, (10 if backward else 4) * pairs * d, dtype,
                    int_ops=HASH_OPS * hash_passes * pairs),
            "same_segment_pairs": pairs,
            "share_of_all_pairs": pairs / (b * heads * s * s)}


def layer_norm_bound(rows, d, x_dtype, w_dtype, backward=False) -> dict:
    """Forward: x, scale, bias in, y out. Backward: x, dy, scale in, dx,
    dscale, dbias out (the statistics are recomputed from x)."""
    ex = torch.empty((), dtype=x_dtype).element_size()
    ew = torch.empty((), dtype=w_dtype).element_size()
    if backward:
        return bound(3 * rows * d * ex + 3 * d * ew, 0, x_dtype,
                     LN_BWD_OPS * rows * d)
    return bound(2 * rows * d * ex + 2 * d * ew, 0, x_dtype,
                 LN_FWD_OPS * rows * d)


def library_attention(q, k, v, do=None, rate=0.0) -> tuple:
    """(forward ms, backward ms or None) of PyTorch's flash SDPA, forward
    with the logsumexp and, given dO, backward, on contiguous [B, H, S, d]
    copies of the operands (it lays them out otherwise than the kernels
    read them), with ``dropout_p = rate``: a yardstick, never called by the
    port."""
    flash = torch.ops.aten._scaled_dot_product_flash_attention
    flash_bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
    q, k, v = (t.contiguous() for t in (q, k, v))
    fwd_ms = time_ms(lambda: flash(q, k, v, rate))
    if do is None:
        return fwd_ms, None
    do = do.contiguous()
    o, lse, cq, ck, mq, mk, seed, offset, _ = flash(q, k, v, rate)
    return fwd_ms, time_ms(lambda: flash_bwd(do, q, k, v, o, lse, cq, ck, mq,
                                             mk, rate, False, seed, offset))


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
                      - 7)


def _wrappers() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from chestxray_vit_tpu_torch.ops import flash_attention as fa
    from chestxray_vit_tpu_torch.ops import int8_matmul as i8
    from chestxray_vit_tpu_torch.ops import layer_norm as ln
    return {"int8_matmul_fused": i8.int8_matmul_fused,
            "flash_attention_inference": fa.flash_attention_inference,
            "layer_norm": ln.layer_norm_cuda,
            "flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "layer_norm_bwd": ln.layer_norm_bwd_cuda,
            "flash_attention_dropout_fwd": fa.flash_attention_dropout_fwd,
            "flash_attention_dropout_debug": fa.flash_attention_dropout_debug,
            "flash_attention_dropout_bwd": fa.flash_attention_dropout_bwd,
            "flash_attention_packed_fwd": fa.flash_attention_packed_fwd,
            "flash_attention_packed_bwd": fa.flash_attention_packed_bwd,
            "flash_attention_packed_dropout_fwd":
                fa.flash_attention_packed_dropout_fwd,
            "flash_attention_packed_dropout_bwd":
                fa.flash_attention_packed_dropout_bwd}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


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


def warm_up() -> float:
    """Busy the card with bf16 products for WARM_UP_S seconds, so that the
    first kernel timed does not meet it at idle clocks; returns the
    seconds spent."""
    a = torch.ones((4096, 4096), device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < WARM_UP_S:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_kernel_check() -> dict:
    from chestxray_vit_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    summary = {}
    emit({"phase": "kernel_check", "warm_up_s": warm_up()})

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # attention: the serving shape, one S that 64 divides, one short odd S;
    # the tile edges checked, not timed
    for s in (577, 512, 37) + EDGE_LENGTHS:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (randn((BATCH, 12, s, 64), dtype) for _ in range(3))
            out = fa.flash_attention_inference(q, k, v)
            ref = fa.attention_reference(q, k, v)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            rec = {"phase": "kernel_check", "kernel": "attention",
                   "shape": [BATCH, 12, s, 64], "dtype": str(dtype),
                   "max_abs_err": err, "tol": ATTN_TOL[dtype],
                   "finite": bool(torch.isfinite(out).all()),
                   **attention_bound(q.shape, dtype)}
            if s not in EDGE_LENGTHS:
                rec["ms"], rec["plain_ms"] = time_pair(
                    lambda: fa.flash_attention_inference(q, k, v),
                    lambda: fa.attention_reference(q, k, v))
            if s == 577 and dtype == torch.bfloat16:
                rec["library_ms"] = library_attention(q, k, v)[0]
                rec["earlier_ms"] = EARLIER_FWD_MS["flash_attention_inference"]
                summary["flash_attention_inference"] = rec
            emit(rec)
            require(rec["finite"] and err <= ATTN_TOL[dtype],
                    f"attention S={s} {dtype}: err {err}")

    check_layer_norm(randn, summary)
    check_int8_matmul(gen, summary)
    check_training_attention(randn, summary)
    check_layer_norm_bwd(randn, summary)
    check_dropout_attention(randn, summary)
    check_packed_attention(randn, summary)
    return summary


def check_layer_norm(randn, summary: dict) -> None:
    """The LayerNorm forward kernel against its plain version at the
    serving rows (8 × 577) in three dtype pairs, and in bf16 at the int8
    serving rows (32 × 577: the summary row) and the training rows (36 ×
    577); times by CUDA events and by the profiler's device time, beside
    ``F.layer_norm``'s."""
    from chestxray_vit_tpu_torch.ops import layer_norm as ln

    d = 768
    cases = [(BATCH * 577, torch.bfloat16, torch.bfloat16),
             (BATCH * 577, torch.bfloat16, torch.float32),
             (BATCH * 577, torch.float32, torch.float32),
             (INT8_BATCH * 577, torch.bfloat16, torch.bfloat16),
             (INT8_BATCH * 577, torch.bfloat16, torch.float32),
             (TRAIN_BATCH * 577, torch.bfloat16, torch.bfloat16)]
    for rows, x_dtype, w_dtype in cases:
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

        def kernel():
            return ln.layer_norm_cuda(x, s_, b_, 1e-12)

        ms, plain_ms = time_pair(
            kernel, lambda: ln.layer_norm_reference(x, s_, b_, 1e-12))
        rec = {"phase": "kernel_check", "kernel": "layer_norm",
               "shape": [rows, d], "dtype": str(x_dtype),
               "scale_dtype": str(w_dtype), "max_abs_err": err, "tol": tol,
               "ms": ms, "plain_ms": plain_ms, **device_ms(kernel),
               **layer_norm_bound(rows, d, x_dtype, w_dtype)}
        if x_dtype == torch.bfloat16:
            def library():
                return torch.nn.functional.layer_norm(x, (d,), s_.to(x_dtype),
                                                      b_.to(x_dtype), 1e-12)
            rec["library_ms"] = time_ms(library)
            rec["library_device_ms"] = device_ms(library)["device_ms"]
            earlier = EARLIER_LN_MS.get((rows, str(w_dtype)))
            if earlier is not None:
                rec["earlier_ms"], rec["earlier_device_ms"] = earlier
        if rows == INT8_BATCH * 577 and w_dtype == torch.bfloat16:
            summary["layer_norm"] = rec
        emit(rec)
        require(ok, f"layer_norm {x_dtype}/{w_dtype}: err {err}")


# The int8 kernel's call forms in the batch-32 static int8 forward: name,
# M, K, N, residual, GELU + requantize.
INT8_FORMS = (
    ("patch_embed", INT8_BATCH * 576, 768, 768, False, False),
    ("q", INT8_BATCH * 577, 768, 768, False, False),
    ("wo_resid", INT8_BATCH * 577, 768, 768, True, False),
    ("mlp_in_gelu_requant", INT8_BATCH * 577, 768, 3072, False, True),
    ("mlp_out_resid", INT8_BATCH * 577, 3072, 768, True, False))


def int8_operands(gen, m, k, n, with_resid, gelu) -> tuple:
    """(xq, wq, scale, bias, keyword arguments) of one call form, drawn
    from ``gen`` on the card."""
    dev = torch.device("cuda")

    def rint8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    xq, wq = rint8(m, k), rint8(n, k)
    # scales that put y = acc·scale + bias at O(1), as calibration does
    scale = (torch.rand(n, generator=gen, device=dev) + 0.5) \
        / (127.0 * 127.0 * k ** 0.5)
    bias = torch.randn(n, generator=gen, device=dev) * 0.1
    kw = {}
    if with_resid:
        kw["resid"] = torch.randn(m, n, generator=gen, device=dev).to(
            torch.bfloat16)
    if gelu:
        kw.update(gelu=True, out_quant_scale=torch.tensor(0.02, device=dev))
    return xq, wq, scale, bias, kw


def check_int8_matmul(gen, summary: dict) -> None:
    """The int8 kernel against its plain version at the batch-32 serving
    shapes, in the call forms of the fused route (INT8_FORMS): outputs
    equal, int8 included; times by CUDA events and by the profiler's device
    time beside ``torch._int_mm``'s (the int32 product alone, on the same
    operands). The mlp_in form is the summary row."""
    from chestxray_vit_tpu_torch.ops import int8_matmul as i8

    for name, m, k, n, with_resid, gelu in INT8_FORMS:
        xq, wq, scale, bias, kw = int8_operands(gen, m, k, n, with_resid,
                                                gelu)
        out = i8.int8_matmul_fused(xq, wq, scale, bias, **kw)
        again = i8.int8_matmul_fused(xq, wq, scale, bias, **kw)
        ref = i8.int8_matmul_fused_reference(xq, wq, scale, bias, **kw)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        flips = int((diff > 0).sum())
        equal_twice = torch.equal(out, again)
        del again
        ms, plain_ms = time_pair(
            lambda: i8.int8_matmul_fused(xq, wq, scale, bias, **kw),
            lambda: i8.int8_matmul_fused_reference(xq, wq, scale, bias,
                                                   **kw))
        wt = wq.t()
        out_bytes = m * n * (1 if gelu else 2)
        ops = (INT8_EPI_OPS["base"] + INT8_EPI_OPS["resid"] * with_resid
               + (INT8_EPI_OPS["gelu"] + INT8_EPI_OPS["requant"]) * gelu)
        rec = {"phase": "kernel_check", "kernel": "int8_matmul_fused",
               "form": name, "m_k_n": [m, k, n],
               "out_dtype": str(out.dtype), "max_abs_err": diff.max().item(),
               "mismatched": flips, "equal_twice": equal_twice,
               "tol": "equal", "ms": ms, "plain_ms": plain_ms,
               **device_ms(lambda: i8.int8_matmul_fused(xq, wq, scale, bias,
                                                         **kw)),
               "earlier_ms": EARLIER_INT8_MS[name][0],
               "earlier_device_ms": EARLIER_INT8_MS[name][1],
               "library_ms": time_ms(lambda: torch._int_mm(xq, wt)),
               "library_device_ms": device_ms(
                   lambda: torch._int_mm(xq, wt))["device_ms"],
               "tops": 2 * m * k * n / ms / 1e9,
               **bound(m * k + n * k + 8 * n + 2 * m * n * with_resid
                       + out_bytes, 2 * m * k * n, torch.int8,
                       core_ops=ops * m * n)}
        emit(rec)
        if gelu:
            summary["int8_matmul_fused"] = rec
        require(bool(torch.isfinite(out.float()).all()) and flips == 0
                and equal_twice,
                f"int8_matmul_fused {name}: {flips} mismatched, max "
                f"{diff.max().item()}, equal twice {equal_twice}")


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got − ref| over max |ref|."""
    ref = ref.float()
    return ((got.float() - ref).abs().max()
            / ref.abs().max().clamp_min(1e-30)).item()


def check_training_attention(randn, summary: dict) -> None:
    """The forward-with-lse and backward kernels against their plain
    versions, at the training batch."""
    from chestxray_vit_tpu_torch.ops import flash_attention as fa

    for s in (577, 512, 37) + EDGE_LENGTHS:
        timed = s not in EDGE_LENGTHS      # the edge lengths are checked only
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
            del ro, rlse
            rec = {"phase": "kernel_check", "kernel": "attention_fwd",
                   "shape": list(shape), "dtype": str(dtype),
                   "max_abs_err": err_o, "lse_max_abs_err": err_lse,
                   "tol": tol, **attention_bound(shape, dtype, lse=True)}
            if timed:
                rec["ms"], rec["plain_ms"] = time_pair(
                    lambda: fa.flash_attention_fwd(q, k, v),
                    lambda: fa.attention_fwd_reference(q, k, v))
            summary_row = s == 577 and dtype == torch.bfloat16
            if summary_row:
                rec["library_ms"], lib_bwd_ms = library_attention(q, k, v, do)
                rec["earlier_ms"] = EARLIER_FWD_MS["flash_attention_fwd"]
            emit(rec)
            require(bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
                    and err_o <= tol and err_lse <= tol,
                    f"attention fwd S={s} {dtype}: o {err_o}, lse {err_lse}")

            grads = fa.flash_attention_bwd(q, k, v, o, lse, do)
            refs = fa.attention_bwd_reference(q, k, v, o, lse, do)
            torch.cuda.synchronize()
            errs = [rel_err(g, r) for g, r in zip(grads, refs)]
            rec_b = {"phase": "kernel_check", "kernel": "attention_bwd",
                     "shape": list(shape), "dtype": str(dtype),
                     "dq_dk_dv_rel_err": errs,
                     "max_abs_err": max((g.float() - r.float()).abs().max()
                                        .item() for g, r in zip(grads, refs)),
                     "rel_tol": ATTN_GRAD_TOL[dtype],
                     **attention_bound(shape, dtype, backward=True)}
            finite = all(bool(torch.isfinite(g).all()) for g in grads)
            del refs
            if timed:
                rec_b["ms"], rec_b["plain_ms"] = time_pair(
                    lambda: fa.flash_attention_bwd(q, k, v, o, lse, do),
                    lambda: fa.attention_bwd_reference(q, k, v, o, lse, do))
            if summary_row:
                again = fa.flash_attention_bwd(q, k, v, o, lse, do)
                rec_b["equal_twice"] = all(torch.equal(a, b)
                                           for a, b in zip(grads, again))
                rec_b.update(backward_pass_ms(
                    lambda: fa.flash_attention_bwd(q, k, v, o, lse, do)))
                rec_b["earlier_ms"] = EARLIER_BWD_MS["flash_attention_bwd"]
                rec_b["library_ms"] = lib_bwd_ms
                summary["flash_attention_fwd"] = rec
                summary["flash_attention_bwd"] = rec_b
            emit(rec_b)
            require(finite and max(errs) <= ATTN_GRAD_TOL[dtype],
                    f"attention bwd S={s} {dtype}: {errs}")
            require(rec_b.get("equal_twice", True),
                    "attention bwd: two calls give the same bits")


def check_layer_norm_bwd(randn, summary: dict) -> None:
    """The LayerNorm backward kernel against its plain version at the
    training rows (36 × 577: the summary row), with the block LNs' bf16
    scale, the final LN's f32 scale and in f32, at the packed rows (32 ×
    1152) and at a count of rows that is no multiple of a block's warps
    (8 × 577 − 1); that it gives the same bits twice; times by CUDA events
    and by the profiler's device time (the main kernel and the column pass
    of one call), beside ``aten.native_layer_norm_backward``'s where x and
    the scale share a dtype, and the kernel's time before its redesign
    (EARLIER_LN_BWD_MS)."""
    from chestxray_vit_tpu_torch.ops import layer_norm as ln

    d = 768
    cases = [(TRAIN_BATCH * 577, torch.bfloat16, torch.bfloat16),
             (TRAIN_BATCH * 577, torch.bfloat16, torch.float32),
             (TRAIN_BATCH * 577, torch.float32, torch.float32),
             (PACKED_SEQS * 1152, torch.bfloat16, torch.bfloat16),
             (PACKED_SEQS * 1152, torch.bfloat16, torch.float32),
             (BATCH * 577 - 1, torch.bfloat16, torch.bfloat16)]
    for rows, x_dtype, w_dtype in cases:
        x = randn((rows, d), x_dtype) * 3 + 1
        scale, dy = randn((d,), w_dtype), randn((rows, d), x_dtype)

        def kernel():
            return ln.layer_norm_bwd_cuda(x, scale, dy, 1e-12)

        got, again = kernel(), kernel()
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
            kernel, lambda: ln.layer_norm_bwd_reference(x, scale, dy, 1e-12))
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
                      "in bf16)", "ms": ms, "plain_ms": plain_ms,
               **device_ms(kernel, parts=("ln_bwd_cols",)),
               **layer_norm_bound(rows, d, x_dtype, w_dtype, backward=True)}
        if x_dtype == w_dtype:
            # the library's backward takes the forward's statistics
            _, mean, rstd = torch.ops.aten.native_layer_norm(
                x, [d], scale, torch.zeros_like(scale), 1e-12)

            def library():
                return torch.ops.aten.native_layer_norm_backward(
                    dy, x, [d], mean, rstd, scale, scale, [True] * 3)
            rec["library_ms"] = time_ms(library)
            rec["library_device_ms"] = device_ms(library)["device_ms"]
        earlier = EARLIER_LN_BWD_MS.get((rows, str(w_dtype)))
        if x_dtype == torch.bfloat16 and earlier is not None:
            rec["earlier_ms"], rec["earlier_device_ms"] = earlier
        if (rows == TRAIN_BATCH * 577
                and x_dtype == w_dtype == torch.bfloat16):
            summary["layer_norm_bwd"] = rec
        emit(rec)
        require(ok, f"layer_norm_bwd {rows} {x_dtype}/{w_dtype}: {rec}")


def check_dropout_attention(randn, summary: dict) -> None:
    """The dropout kernels at the training shape, rate 0.1, the automatic
    Q block: the debug kernel's mask against the plain counter hash (0
    mismatches), its o and the forward's o and lse and the backward's dq,
    dk, dv against their plain versions; times beside PyTorch's flash SDPA with
    ``dropout_p = 0.1`` (the same work on another mask stream)."""
    from chestxray_vit_tpu_torch.ops import flash_attention as fa

    for s in EDGE_LENGTHS:                 # checked, not timed
        kw = {"block_q": fa.auto_block_q(s)}
        for dtype in (torch.bfloat16, torch.float32):
            shape = (TRAIN_BATCH, 12, s, 64)
            x = randn((TRAIN_BATCH, s, 3, 12, 64), dtype)
            q, k, v = (t.transpose(1, 2) for t in x.unbind(2))
            do = randn(shape, dtype)
            o, lse = fa.flash_attention_dropout_fwd(q, k, v, DROP_SEED,
                                                    DROP_RATE, **kw)
            ro, rlse = fa.attention_dropout_fwd_reference(
                q, k, v, DROP_SEED, DROP_RATE, **kw)
            err_o = (o.float() - ro.float()).abs().max().item()
            err_lse = (lse - rlse).abs().max().item()
            del ro, rlse
            grads = fa.flash_attention_dropout_bwd(q, k, v, o, lse, do,
                                                   DROP_SEED, DROP_RATE, **kw)
            refs = fa.attention_dropout_bwd_reference(
                q, k, v, o, lse, do, DROP_SEED, DROP_RATE, **kw)
            torch.cuda.synchronize()
            errs = [rel_err(g, r) for g, r in zip(grads, refs)]
            finite = all(bool(torch.isfinite(t).all())
                         for t in (o, lse, *grads))
            del grads, refs
            emit({"phase": "kernel_check", "kernel": "attention_dropout_bwd",
                  "shape": list(shape), "dtype": str(dtype),
                  "rate": DROP_RATE, "fwd_max_abs_err": err_o,
                  "lse_max_abs_err": err_lse, "tol": ATTN_TOL[dtype],
                  "dq_dk_dv_rel_err": errs,
                  "rel_tol": ATTN_GRAD_TOL[dtype]})
            require(finite and err_o <= ATTN_TOL[dtype]
                    and err_lse <= ATTN_TOL[dtype]
                    and max(errs) <= ATTN_GRAD_TOL[dtype],
                    f"dropout fwd/bwd S={s} {dtype}: o {err_o}, lse "
                    f"{err_lse}, grads {errs}")

    s = 577
    block_q = fa.auto_block_q(s)
    q_pad, s_pad = fa.mask_strides(s, block_q)
    args = (DROP_SEED, DROP_RATE)
    kw = {"block_q": block_q}
    for dtype in (torch.bfloat16, torch.float32):
        shape = (TRAIN_BATCH, 12, s, 64)
        x = randn((TRAIN_BATCH, s, 3, 12, 64), dtype)
        q, k, v = (t.transpose(1, 2) for t in x.unbind(2))
        do = randn(shape, dtype)
        tol = ATTN_TOL[dtype]

        o_dbg, keep = fa.flash_attention_dropout_debug(q, k, v, *args, **kw)
        ref_keep = fa.keep_mask(TRAIN_BATCH * 12, q_pad, s_pad, *args,
                                device=q.device)[:, :s, :s].reshape(keep.shape)
        mismatches = int((keep != ref_keep).sum())
        keep_share = keep.float().mean().item()
        del ref_keep
        o, lse = fa.flash_attention_dropout_fwd(q, k, v, *args, **kw)
        ro, rlse = fa.attention_dropout_fwd_reference(q, k, v, *args, **kw)
        torch.cuda.synchronize()
        err_o = (o.float() - ro.float()).abs().max().item()
        err_lse = (lse - rlse).abs().max().item()
        err_dbg = (o_dbg.float() - ro.float()).abs().max().item()
        del ro, rlse, o_dbg, keep
        ms_d, plain_ms_d = time_pair(
            lambda: fa.flash_attention_dropout_debug(q, k, v, *args, **kw),
            lambda: (fa.attention_dropout_fwd_reference(q, k, v, *args, **kw),
                     fa.keep_mask(TRAIN_BATCH * 12, q_pad, s_pad, *args,
                                  device=q.device)))
        ms, plain_ms = time_pair(
            lambda: fa.flash_attention_dropout_fwd(q, k, v, *args, **kw),
            lambda: fa.attention_dropout_fwd_reference(q, k, v, *args, **kw))
        rec_d = {"phase": "kernel_check", "kernel": "attention_dropout_debug",
                 "shape": list(shape), "dtype": str(dtype), "rate": DROP_RATE,
                 "seed": DROP_SEED, "q_pad_s_pad": [q_pad, s_pad],
                 "mask_mismatches": mismatches, "keep_share": keep_share,
                 "max_abs_err": err_dbg, "tol": tol,
                 "ms": ms_d, "plain_ms": plain_ms_d,
                 **attention_bound(shape, dtype, lse=True, hash_passes=1,
                                   mask_out=True)}
        rec = {"phase": "kernel_check", "kernel": "attention_dropout_fwd",
               "shape": list(shape), "dtype": str(dtype), "rate": DROP_RATE,
               "max_abs_err": err_o, "lse_max_abs_err": err_lse, "tol": tol,
               "ms": ms, "plain_ms": plain_ms,
               **attention_bound(shape, dtype, lse=True, hash_passes=1)}

        grads = fa.flash_attention_dropout_bwd(q, k, v, o, lse, do, *args,
                                               **kw)
        refs = fa.attention_dropout_bwd_reference(q, k, v, o, lse, do, *args,
                                                  **kw)
        torch.cuda.synchronize()
        errs = [rel_err(g, r) for g, r in zip(grads, refs)]
        err_g = max((g.float() - r.float()).abs().max().item()
                    for g, r in zip(grads, refs))
        finite = all(bool(torch.isfinite(t).all())
                     for t in (o, lse, *grads))
        again = fa.flash_attention_dropout_bwd(q, k, v, o, lse, do, *args,
                                               **kw)
        equal_twice = all(torch.equal(a, b) for a, b in zip(grads, again))
        del grads, refs, again
        ms_b, plain_ms_b = time_pair(
            lambda: fa.flash_attention_dropout_bwd(q, k, v, o, lse, do, *args,
                                                   **kw),
            lambda: fa.attention_dropout_bwd_reference(q, k, v, o, lse, do,
                                                       *args, **kw))
        rec_b = {"phase": "kernel_check", "kernel": "attention_dropout_bwd",
                 "shape": list(shape), "dtype": str(dtype), "rate": DROP_RATE,
                 "dq_dk_dv_rel_err": errs, "max_abs_err": err_g,
                 "rel_tol": ATTN_GRAD_TOL[dtype], "ms": ms_b,
                 "plain_ms": plain_ms_b,
                 **attention_bound(shape, dtype, backward=True,
                                   hash_passes=1)}
        if dtype == torch.bfloat16:
            # the library's flash kernels take bf16, not f32
            lib_fwd, lib_bwd = library_attention(q, k, v, do, DROP_RATE)
            rec_d["library_ms"] = rec["library_ms"] = lib_fwd
            rec_b["library_ms"] = lib_bwd
            rec_b["equal_twice"] = equal_twice
            rec_b.update(backward_pass_ms(
                lambda: fa.flash_attention_dropout_bwd(q, k, v, o, lse, do,
                                                       *args, **kw)))
            rec_b["earlier_ms"] = EARLIER_BWD_MS["flash_attention_dropout_bwd"]
            summary["flash_attention_dropout_debug"] = rec_d
            summary["flash_attention_dropout_fwd"] = rec
            summary["flash_attention_dropout_bwd"] = rec_b
        for r in (rec_d, rec, rec_b):
            emit(r)
        require(mismatches == 0, f"dropout mask {dtype}: {mismatches} "
                                 f"mismatches")
        require(err_dbg <= tol, f"dropout debug o {dtype}: {err_dbg}")
        require(abs(keep_share - (1 - DROP_RATE)) < 1e-3,
                f"keep share {keep_share}")
        require(finite and err_o <= tol and err_lse <= tol,
                f"dropout fwd {dtype}: o {err_o}, lse {err_lse}")
        require(max(errs) <= ATTN_GRAD_TOL[dtype],
                f"dropout bwd {dtype}: {errs}")
        require(equal_twice, f"dropout bwd {dtype}: two calls give the same "
                             f"bits")


def library_packed_attention(q, k, v, seg, do, rate=0.0) -> tuple:
    """(forward ms, backward ms) of ``scaled_dot_product_attention`` with
    the boolean same-segment mask [B, 1, S, S] (and ``dropout_p``) on
    contiguous copies: a yardstick, never called by the port."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = (seg[:, None, :, None] == seg[:, None, None, :])
    q, k, v = (t.contiguous().requires_grad_() for t in (q, k, v))
    do = do.contiguous()
    with torch.no_grad():
        fwd_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=mask,
                                      dropout_p=rate))
    o = sdpa(q, k, v, attn_mask=mask, dropout_p=rate)
    return fwd_ms, time_ms(lambda: torch.autograd.grad(
        o, (q, k, v), do, retain_graph=True))


def check_packed_attention(randn, summary: dict) -> None:
    """The four segment kernels against their plain versions in three
    layouts, bf16 at the packed step's batch and f32 at batch 4: o and lse
    (PACKED_TOL), dq/dk/dv (ATTN_GRAD_TOL, relative), finite everywhere. The
    two-segment bf16 rows go to the summary."""
    from chestxray_vit_tpu_torch.ops import flash_attention as fa

    plain_calls = {"plain_reps": 2, "plain_inner": 2}
    for dtype, batch in ((torch.bfloat16, PACKED_SEQS),
                         (torch.float32, PACKED_F32_BATCH)):
        for layout, seg in packed_layouts(batch).items():
            s = seg.shape[1]
            shape = (batch, 12, s, 64)
            x = randn((batch, s, 3, 12, 64), dtype)
            q, k, v = (t.transpose(1, 2) for t in x.unbind(2))
            do = randn(shape, dtype)
            tiles = skipped_tile_share(seg)
            for rate in (0.0, DROP_RATE):
                if rate:
                    extra = (DROP_SEED, rate, None, fa.packed_block_q(s))
                    fwd, bwd = (fa.flash_attention_packed_dropout_fwd,
                                fa.flash_attention_packed_dropout_bwd)
                    rfwd, rbwd = (fa.attention_packed_dropout_fwd_reference,
                                  fa.attention_packed_dropout_bwd_reference)
                else:
                    extra = ()
                    fwd, bwd = (fa.flash_attention_packed_fwd,
                                fa.flash_attention_packed_bwd)
                    rfwd, rbwd = (fa.attention_packed_fwd_reference,
                                  fa.attention_packed_bwd_reference)
                o, lse = fwd(q, k, v, seg, *extra)
                ro, rlse = rfwd(q, k, v, seg, *extra)
                torch.cuda.synchronize()
                err_o = (o.float() - ro.float()).abs().max().item()
                err_lse = (lse - rlse).abs().max().item()
                del ro, rlse
                grads = bwd(q, k, v, seg, o, lse, do, *extra)
                refs = rbwd(q, k, v, seg, o, lse, do, *extra)
                torch.cuda.synchronize()
                errs = [rel_err(g, r) for g, r in zip(grads, refs)]
                err_g = max((g.float() - r.float()).abs().max().item()
                            for g, r in zip(grads, refs))
                finite = all(bool(torch.isfinite(t).all())
                             for t in (o, lse, *grads))
                del grads, refs
                torch.cuda.empty_cache()
                hashes = 1 if rate else 0
                rec = {"phase": "kernel_check", "kernel": fwd.__name__,
                       "layout": layout, "shape": list(shape),
                       "dtype": str(dtype), "rate": rate,
                       "max_abs_err": err_o, "lse_max_abs_err": err_lse,
                       "tol": PACKED_TOL[dtype], **tiles,
                       **packed_attention_bound(seg, 12, dtype,
                                                hash_passes=hashes)}
                rec_b = {"phase": "kernel_check", "kernel": bwd.__name__,
                         "layout": layout, "shape": list(shape),
                         "dtype": str(dtype), "rate": rate,
                         "dq_dk_dv_rel_err": errs, "max_abs_err": err_g,
                         "rel_tol": ATTN_GRAD_TOL[dtype], **tiles,
                         **packed_attention_bound(seg, 12, dtype,
                                                  backward=True,
                                                  hash_passes=hashes)}
                if dtype == torch.bfloat16:
                    timed = layout == "two_segments"
                    if timed:       # the plain versions take tens of ms
                        rec["ms"], rec["plain_ms"] = time_pair(
                            lambda: fwd(q, k, v, seg, *extra),
                            lambda: rfwd(q, k, v, seg, *extra),
                            **plain_calls)
                        rec_b["ms"], rec_b["plain_ms"] = time_pair(
                            lambda: bwd(q, k, v, seg, o, lse, do, *extra),
                            lambda: rbwd(q, k, v, seg, o, lse, do, *extra),
                            **plain_calls)
                        torch.cuda.empty_cache()
                        summary[fwd.__name__] = rec
                        summary[bwd.__name__] = rec_b
                    else:
                        rec["ms"] = time_ms(lambda: fwd(q, k, v, seg, *extra))
                        rec_b["ms"] = time_ms(
                            lambda: bwd(q, k, v, seg, o, lse, do, *extra))
                    rec["library_ms"], rec_b["library_ms"] = \
                        library_packed_attention(q, k, v, seg, do, rate)
                    torch.cuda.empty_cache()
                emit(rec)
                emit(rec_b)
                tol = PACKED_TOL[dtype]
                require(finite and err_o <= tol["o"]
                        and err_lse <= tol["lse"],
                        f"{fwd.__name__} {layout} {dtype}: o {err_o}, lse "
                        f"{err_lse}, finite {finite}")
                require(max(errs) <= ATTN_GRAD_TOL[dtype],
                        f"{bwd.__name__} {layout} {dtype}: {errs}")


def make_requests(n: int = REQUESTS) -> list:
    """Seeded u8 grayscale images of varied size up to 1024²."""
    rng = np.random.default_rng(SEED)
    out = []
    for i in range(n):
        h, w = (1024, 1024) if i == 0 else rng.integers(256, 1025, 2)
        img = rng.integers(0, 256, (h, w), np.uint8)
        # a bright disc, so the images are not pure noise
        yy, xx = np.ogrid[:h, :w]
        img[(yy - h // 2) ** 2 + (xx - w // 3) ** 2 < (min(h, w) // 4) ** 2] \
            = 230
        out.append(img)
    return out


def serve_burst(pred, images: list) -> tuple:
    """Every image submitted to a MicroBatcher over ``pred`` from
    CLIENT_THREADS threads at once, with the launch counts and the
    Predictor's forward count set to 0 just before: (results, submit
    times, done times, launches)."""
    import chestxray_vit_tpu_torch as cxr

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
    return results, submitted, done, launch_counts()


def burst_record(phase: str, pred, images: list, results, submitted, done,
                 cfg) -> dict:
    """The serving record of a burst, after checking that every request
    got 15 finite probabilities in [0, 1]."""
    probs = np.stack([r.probs for r in results])
    lat = sorted(d - s for s, d in zip(submitted, done))
    wall = max(done) - min(submitted)
    rec = {"phase": phase, "requests": len(images),
           "answered": len(results), "client_threads": CLIENT_THREADS,
           "batch_size": pred.batch_size, "forwards": pred.forwards,
           "probs_shape": list(probs.shape),
           "probs_finite_in_0_1": bool(np.isfinite(probs).all()
                                       and (probs >= 0).all()
                                       and (probs <= 1).all()),
           "images_per_s": len(images) / wall,
           "p50_latency_ms": 1e3 * statistics.median(lat),
           "max_latency_ms": 1e3 * lat[-1]}
    require(rec["answered"] == len(images), f"{phase}: every request "
                                            f"answered")
    require(probs.shape == (len(images), cfg.num_classes),
            f"{phase}: 15 probabilities per request")
    require(rec["probs_finite_in_0_1"], f"{phase}: probabilities finite in "
                                        f"[0, 1]")
    return rec


def require_forward_launches(phase: str, launches: dict, forwards: int,
                             cfg, int8: bool) -> None:
    """Exactly 12 attention and 25 LayerNorm launches per forward, 73 of
    the int8 kernel on the fused int8 route, and no other kernel."""
    want = {**dict.fromkeys(launches, 0),
            "flash_attention_inference": cfg.num_layers * forwards,
            "layer_norm": (2 * cfg.num_layers + 1) * forwards}
    if int8:
        want["int8_matmul_fused"] = (1 + 6 * cfg.num_layers) * forwards
    require(forwards > 0 and launches == want,
            f"{phase}: launches {launches} for {forwards} forwards, "
            f"expected {want}")


def phase_serving(params, cfg, images: list):
    import chestxray_vit_tpu_torch as cxr

    t0 = time.perf_counter()
    pred = cxr.Predictor(params, cfg, batch_size=BATCH, placement="device",
                         device="cuda")
    pred.warmup()
    warm_s = time.perf_counter() - t0
    # the counts cover exactly the main path's run
    results, submitted, done, launches = serve_burst(pred, images)
    rec = {**burst_record("serving", pred, images, results, submitted, done,
                          cfg),
           "attention_launches": launches["flash_attention_inference"],
           "layer_norm_launches": launches["layer_norm"], "warmup_s": warm_s}
    emit(rec)
    require_forward_launches("serving", launches, pred.forwards, cfg,
                             int8=False)
    return np.stack([r.logits for r in results]), launches


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


def phase_serving_int8(params, cfg, images: list):
    """The static-int8 Predictor at batch 32 on the fused kernel, and beside
    it the dense bf16 Predictor at batch 32 on the same requests; then the
    b32 forward times of the fused route, the "xla" route, dynamic int8
    and dense bf16 on the same 32 images. Returns the static tree, the
    32 images (preprocessed on the card), the fused route's logits on them
    and the int8 run's launches."""
    import chestxray_vit_tpu_torch as cxr
    from chestxray_vit_tpu_torch.models import quantized, vit

    t0 = time.perf_counter()
    pred = cxr.Predictor(params, cfg, batch_size=INT8_BATCH,
                         placement="device", device="cuda",
                         quantize="static", calibration=images[:8])
    pred.warmup()
    warm_s = time.perf_counter() - t0
    results, submitted, done, launches = serve_burst(pred, images)
    rec = {**burst_record("serving_int8", pred, images, results, submitted,
                          done, cfg),
           "quantize": "static", "launches": launches, "warmup_s": warm_s}
    require_forward_launches("serving_int8", launches, pred.forwards, cfg,
                             int8=True)

    dense = cxr.Predictor(params, cfg, batch_size=INT8_BATCH,
                          placement="device", device="cuda")
    dense.warmup()
    d_res, d_sub, d_done, _ = serve_burst(dense, images)
    d_rec = burst_record("serving_dense_b32", dense, images, d_res, d_sub,
                         d_done, cfg)
    rec["dense_b32"] = {k: d_rec[k] for k in ("images_per_s",
                                              "p50_latency_ms",
                                              "max_latency_ms", "forwards")}

    qp = pred._fwd_params
    staged = pred.stage_chunk(images[:INT8_BATCH])
    torch.cuda.synchronize()        # the copy ran on the Predictor's stream
    dyn = quantized.quantize_vit_params(params, None, device="cuda")
    dense_p = dense._fwd_params
    with torch.inference_mode():
        imgs = pred._images_of(staged)
        fwd = {
            "fused": lambda: quantized.apply_quantized(qp, imgs, cfg,
                                                       "pallas"),
            "xla_static": lambda: quantized.apply_quantized(qp, imgs, cfg,
                                                            "xla"),
            "xla_dynamic": lambda: quantized.apply_quantized(dyn, imgs, cfg,
                                                             "xla"),
            "dense_bf16": lambda: vit.apply(dense_p, imgs, cfg)}
        rec["forward_ms_b32"] = {k: time_ms(f, reps=5, inner=3)
                                 for k, f in fwd.items()}
        fused_logits = fwd["fused"]()
    emit(rec)
    del dense, dense_p, dyn
    torch.cuda.empty_cache()
    return qp, imgs, fused_logits, launches


def phase_int8_cross_check(params, cfg, qp, imgs, fused_logits) -> None:
    """The fused route on the card against the port's CPU plain route (the
    same tree and images, 2 of them) and against the card's "xla" route,
    in f32 and in the serving bf16; and the bf16 fused route against the
    card's dense f32 forward."""
    import copy
    import dataclasses

    from chestxray_vit_tpu_torch.models import quantized, vit

    pick = 2
    f32 = dataclasses.replace(cfg, dtype="float32")
    cpu_qp = copy.deepcopy(qp).to("cpu")
    card_params = copy.deepcopy(params).to("cuda")
    imgs32 = imgs.float()

    def fused(tree, x, c):
        return quantized.apply_quantized(tree, x, c, "pallas").cpu()

    with torch.inference_mode():
        out = {
            "bf16": (fused_logits.cpu(), fused(cpu_qp, imgs[:pick].cpu(), cfg),
                     quantized.apply_quantized(qp, imgs, cfg, "xla").cpu()),
            "f32": (fused(qp, imgs32, f32),
                    fused(cpu_qp, imgs32[:pick].cpu(), f32),
                    quantized.apply_quantized(qp, imgs32, f32, "xla").cpu())}
        dense32 = vit.apply(card_params, imgs32, f32).cpu()
        noise = torch.randn(imgs32.shape, device=imgs32.device,
                            generator=torch.Generator(imgs32.device)
                            .manual_seed(SEED))
        nudged = fused(qp, imgs32 + NOISE_STD * noise, f32)

    def corr(a, b):
        return float(np.corrcoef(a.numpy().ravel(), b.numpy().ravel())[0, 1])

    rec = {"phase": "int8_cross_check", "images": INT8_BATCH,
           "cpu_images": pick, "tol": INT8_ROUTE_TOL,
           "min_corr": INT8_ROUTE_MIN_CORR,
           "noise_std": NOISE_STD,
           "noise_sensitivity": (out["f32"][0] - nudged).abs().max().item()}
    for dt, (card, cpu, xla) in out.items():
        require(bool(torch.isfinite(card).all()) and card.shape == (
            INT8_BATCH, cfg.num_classes), f"finite {dt} int8 logits [32, 15]")
        rec[f"{dt}_fused_vs_cpu_plain_max_abs"] = \
            (card[:pick] - cpu).abs().max().item()
        rec[f"{dt}_fused_vs_xla_max_abs"] = (card - xla).abs().max().item()
        rec[f"{dt}_fused_vs_cpu_plain_corr"] = corr(card[:pick], cpu)
        rec[f"{dt}_fused_vs_xla_corr"] = corr(card, xla)
        rec[f"{dt}_fused_vs_dense_f32_max_abs"] = \
            (card - dense32).abs().max().item()
        rec[f"{dt}_xla_vs_dense_f32_max_abs"] = \
            (xla - dense32).abs().max().item()
    card = out["bf16"][0]
    rec["int8_vs_dense_f32_prob_max_abs"] = (
        torch.sigmoid(card) - torch.sigmoid(dense32)).abs().max().item()
    rec["int8_vs_dense_f32_logit_corr"] = corr(card, dense32)
    rec["dense_f32_logits_absmax"] = dense32.abs().max().item()
    emit(rec)
    for dt in out:
        for pair in ("fused_vs_cpu_plain", "fused_vs_xla"):
            d, c = rec[f"{dt}_{pair}_max_abs"], rec[f"{dt}_{pair}_corr"]
            require(d <= INT8_ROUTE_TOL and c > INT8_ROUTE_MIN_CORR,
                    f"{dt} {pair}: {d}, corr {c}")
    require(rec["int8_vs_dense_f32_prob_max_abs"] <= INT8_PROB_TOL
            and rec["int8_vs_dense_f32_logit_corr"] > INT8_MIN_CORR,
            f"int8 vs dense f32: {rec}")


def train_config(mixup_alpha: float = 0.0, **model):
    import chestxray_vit_tpu_torch as cxr
    return cxr.Config(model=cxr.ModelConfig(num_classes=15, **model),
                      data=cxr.DataConfig(mixup_alpha=mixup_alpha),
                      train=cxr.TrainConfig())


def run_steps(train_step, state, batch, warmup: int, timed: int,
              on_first=None) -> dict:
    """``warmup`` then ``timed`` steps on a fixed batch. The timed steps are
    the main path: the launch counts and the peak-memory mark are set to 0
    just before them and read just after. ``on_first(metrics)`` sees the
    first step's metrics before the next step runs."""
    losses, norms, step_counts = [], [], []
    for i in range(warmup + timed):
        if i == warmup:
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
        if i == 0 and on_first is not None:
            on_first(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"losses": torch.stack(losses).tolist(),
            "grad_norms": torch.stack(norms).tolist(),
            "step_counts": step_counts, "wall": wall,
            "step_ms": 1e3 * wall / timed, "launches": launch_counts(),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_train():
    """bench.py's train step on the card: ViT-B/16 @384, bf16, full remat,
    batch 36, TrainConfig defaults, over 10,000 scheduled steps."""
    from chestxray_vit_tpu_torch.models.vit import init_params
    from chestxray_vit_tpu_torch.train import steps

    dev = torch.device("cuda")
    cfg = train_config(remat=True)
    n_layers = cfg.model.num_layers
    per_step = {**dict.fromkeys(_wrappers(), 0),  # every other kernel 0
                "flash_attention_fwd": 2 * n_layers,   # forward + recompute
                "flash_attention_bwd": n_layers,
                "layer_norm": 2 * (2 * n_layers + 1) - 1,  # final LN once
                "layer_norm_bwd": 2 * n_layers + 1}
    batch = bench_batch(TRAIN_BATCH, SEED, dev)
    params = init_params(torch.Generator().manual_seed(SEED), cfg.model, dev)
    state = steps.TrainState.create(params, seed=42)
    train_step = steps.make_train_step(cfg, total_steps=10_000)

    first = []                              # for the no-remat comparison
    run = run_steps(
        train_step, state, batch, WARMUP_STEPS, TIMED_STEPS,
        lambda m: first.extend((m["loss"].clone(), {
            n: p.grad.clone() for n, p in params.named_parameters()})))
    losses, norms, step_counts, launches = (
        run["losses"], run["grad_norms"], run["step_counts"],
        run["launches"])
    rec = {"phase": "train", "batch": TRAIN_BATCH, "remat": "full",
           "dtype": cfg.model.dtype, "warmup_steps": WARMUP_STEPS,
           "timed_steps": TIMED_STEPS, "step_ms": run["step_ms"],
           "images_per_s": TRAIN_BATCH * TIMED_STEPS / run["wall"],
           "max_memory_allocated_gb": run["peak_gb"],
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
    del state, run
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
    return params, cfg, launches, rec["images_per_s"]


def phase_train_dropout() -> dict:
    """The train step of phase_train with attention dropout 0.1 (the
    dropout kernels), hidden dropout 0.1 and mixup α 0.2, drawing from the
    state's generator; then one step with remat and one without on the
    same weights, batch and injected draws, which agree only if every
    recomputed block redraws the same masks."""
    from chestxray_vit_tpu_torch.models.vit import init_params
    from chestxray_vit_tpu_torch.train import steps

    dev = torch.device("cuda")
    drop = {"attention_dropout": DROP_RATE, "hidden_dropout": DROP_RATE}
    cfg = train_config(MIXUP_ALPHA, remat=True, **drop)
    n_layers = cfg.model.num_layers
    per_step = {**dict.fromkeys(_wrappers(), 0),  # dense attention too
                "flash_attention_dropout_fwd": 2 * n_layers,
                "flash_attention_dropout_bwd": n_layers,
                "layer_norm": 2 * (2 * n_layers + 1) - 1,
                "layer_norm_bwd": 2 * n_layers + 1}
    batch = bench_batch(TRAIN_BATCH, SEED, dev)
    params = init_params(torch.Generator().manual_seed(SEED), cfg.model, dev)
    state = steps.TrainState.create(params, seed=42)
    train_step = steps.make_train_step(cfg, total_steps=10_000)

    run = run_steps(train_step, state, batch, DROPOUT_WARMUP_STEPS,
                    DROPOUT_TIMED_STEPS)
    losses, norms, step_counts, launches = (
        run["losses"], run["grad_norms"], run["step_counts"],
        run["launches"])
    rec = {"phase": "train_dropout", "batch": TRAIN_BATCH, "remat": "full",
           "dtype": cfg.model.dtype, **drop, "mixup_alpha": MIXUP_ALPHA,
           "warmup_steps": DROPOUT_WARMUP_STEPS,
           "timed_steps": DROPOUT_TIMED_STEPS, "step_ms": run["step_ms"],
           "images_per_s": TRAIN_BATCH * DROPOUT_TIMED_STEPS / run["wall"],
           "max_memory_allocated_gb": run["peak_gb"],
           "losses": losses, "grad_norms": norms,
           "launches_per_step": step_counts[-1], "launches": launches}
    emit(rec)
    require(all(np.isfinite(losses)) and all(np.isfinite(norms)),
            "finite loss and grad_norm at every dropout step")
    require(all(c == per_step for c in step_counts),
            f"dropout launches per step {step_counts} != {per_step}")
    del state, run, params

    # one step with and one without remat: same weights, batch and draws
    draws = [steps.draw(torch.Generator().manual_seed(SEED + 1), cfg,
                        TRAIN_BATCH)]
    out = []
    for remat in (True, False):
        p = init_params(torch.Generator().manual_seed(SEED), cfg.model, dev)
        step = steps.make_train_step(
            train_config(MIXUP_ALPHA, remat=remat, **drop), 10_000)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        _, m = step(steps.TrainState.create(p, seed=0), batch, draws)
        torch.cuda.synchronize()
        out.append((m["loss"].item(),
                    {n: t.grad for n, t in p.named_parameters()},
                    1e3 * (time.perf_counter() - t1),
                    torch.cuda.max_memory_allocated() / 1e9))
        del p
    (loss_r, grads_r, ms_r, mem_r), (loss_n, grads_n, ms_n, mem_n) = out
    loss_diff = abs(loss_n - loss_r)
    scale = max(g.abs().max().item() for g in grads_r.values())
    grad_diff = max((grads_n[n] - g).abs().max().item()
                    for n, g in grads_r.items()) / scale
    rec_nr = {"phase": "train_dropout_remat_vs_no_remat",
              "batch": TRAIN_BATCH, "loss_remat": loss_r,
              "loss_diff": loss_diff, "grad_rel_diff": grad_diff,
              "tol": [REMAT_LOSS_TOL, REMAT_GRAD_TOL],
              "remat_one_step_ms": ms_r, "remat_max_memory_gb": mem_r,
              "no_remat_one_step_ms": ms_n, "no_remat_max_memory_gb": mem_n}
    emit(rec_nr)
    require(np.isfinite(loss_r) and loss_diff <= REMAT_LOSS_TOL
            and grad_diff <= REMAT_GRAD_TOL,
            f"dropout remat vs no remat: loss {loss_diff}, grads "
            f"{grad_diff}")
    del out, grads_r, grads_n
    torch.cuda.empty_cache()
    return launches


def phase_train_cross_check(phase: str = "train_cross_check",
                            mixup_alpha: float = 0.0, **model) -> None:
    """One train step at full width, depth 2, batch 2: the card in f32 and
    in bf16 against the CPU in f32 (plain versions), same weights and the
    same draws (dropout seeds, mixup λ) injected on both sides."""
    import dataclasses

    from chestxray_vit_tpu_torch.models import bridge
    from chestxray_vit_tpu_torch.models.vit import init_params
    from chestxray_vit_tpu_torch.train import steps

    cfg32 = train_config(mixup_alpha, num_layers=2, dtype="float32", **model)
    cfg16 = dataclasses.replace(cfg32, model=dataclasses.replace(
        cfg32.model, dtype="bfloat16"))
    cpu_params = init_params(torch.Generator().manual_seed(SEED), cfg32.model)
    tree = bridge.params_to_numpy(cpu_params)
    batch = bench_batch(2, SEED + 1, "cpu")
    draws = [steps.draw(torch.Generator().manual_seed(SEED), cfg32, 2)]

    def run(cfg, params, device):
        dev_batch = {k: v.to(device) for k, v in batch.items()}
        state, m = steps.make_train_step(cfg, total_steps=10_000)(
            steps.TrainState.create(params, seed=0), dev_batch, draws)
        return ({k: v.item() for k, v in m.items()},
                _leaves(bridge.grads_to_numpy(state.params)),
                _leaves(bridge.params_to_numpy(state.params)))

    cpu_m, cpu_g, cpu_p = run(cfg32, cpu_params, "cpu")
    g_scale = max(float(np.abs(g).max()) for g in cpu_g)
    rec = {"phase": phase, "depth": 2, "batch": 2, "model": model,
           "mixup_alpha": mixup_alpha, "cpu_f32_loss": cpu_m["loss"], "tol_f32": XCHECK_F32,
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


def packed_launches_per_step(n_layers: int, dropout: bool) -> dict:
    """Full remat: every block's attention forward runs twice, its backward
    once; LayerNorm as in the dense step; no dense attention kernel."""
    name = "flash_attention_packed_dropout" if dropout \
        else "flash_attention_packed"
    return {**dict.fromkeys(_wrappers(), 0),
            f"{name}_fwd": 2 * n_layers, f"{name}_bwd": n_layers,
            "layer_norm": 2 * (2 * n_layers + 1) - 1,
            "layer_norm_bwd": 2 * n_layers + 1}


def merged_layer_tiles(params, cfg, data: dict) -> list:
    """One no-grad merged forward that returns the segment ids each
    layer's attention saw: per layer the length and the tile shares of
    :func:`skipped_tile_share` (merges interleave the ids further at every
    layer, which is what the kernels' tile skip has to live with)."""
    from chestxray_vit_tpu_torch.models import packed as packed_model

    with torch.no_grad():
        _, seen = packed_model.apply_packed_tome(
            params, data["tokens"], data["segment_ids"],
            data["pos_indices"], data["pool_weights"], cfg.model,
            return_segment_ids=True)
    return [{"length": seg.shape[1], **skipped_tile_share(seg)}
            for seg in seen]


def phase_train_packed(phase: str, batch: dict, dense_images_per_s=None,
                       warmup: int = PACKED_WARMUP_STEPS,
                       timed: int = PACKED_TIMED_STEPS, **model) -> tuple:
    """The packed train step at full ViT-B/16 width, bf16, full remat, on a
    fixed batch: step time, images/s, peak memory, falling loss, exact
    launch counts per step. Returns (launches of the timed steps, the
    record)."""
    from chestxray_vit_tpu_torch.models.vit import init_params
    from chestxray_vit_tpu_torch.ops.tome import r_schedule
    from chestxray_vit_tpu_torch.train import steps

    dev = torch.device("cuda")
    cfg = train_config(remat=True, **model)
    dropout = cfg.model.attention_dropout > 0.0
    per_step = packed_launches_per_step(cfg.model.num_layers, dropout)
    params = init_params(torch.Generator().manual_seed(SEED), cfg.model, dev)
    state = steps.TrainState.create(params, seed=42)
    train_step = steps.make_packed_train_step(cfg, total_steps=10_000)
    data, n_images = tensors(batch), batch["n_images"]

    run = run_steps(train_step, state, data, warmup, timed)
    losses, norms, step_counts, launches, wall = (
        run["losses"], run["grad_norms"], run["step_counts"],
        run["launches"], run["wall"])
    seg = batch["segment_ids"]
    rec = {"phase": phase, "sequences": seg.shape[0], "seq_len": seg.shape[1],
           "images": n_images, "pad_share": (seg < 0).float().mean().item(),
           "remat": "full", "dtype": cfg.model.dtype, "model": model,
           "warmup_steps": warmup, "timed_steps": timed,
           "step_ms": run["step_ms"],
           "images_per_s": n_images * timed / wall,
           "tokens_per_s": seg.numel() * timed / wall,
           "max_memory_allocated_gb": run["peak_gb"],
           "losses": losses, "grad_norms": norms,
           "launches_per_step": step_counts[-1], "launches": launches}
    if cfg.model.tome_r:
        rs = r_schedule(cfg.model.tome_r, cfg.model.num_layers,
                        cfg.model.tome_schedule)
        rec["attention_lengths"] = [seg.shape[1] - sum(rs[:i])
                                    for i in range(len(rs))]
        rec["attention_tiles"] = merged_layer_tiles(params, cfg, data)
    if dense_images_per_s is not None:
        rec["dense_b36_images_per_s"] = dense_images_per_s
    emit(rec)
    require(all(np.isfinite(losses)) and all(np.isfinite(norms)),
            f"{phase}: finite loss and grad_norm at every step")
    require(losses[-1] < losses[0],
            f"{phase}: loss fell on the fixed batch: {losses[0]} → "
            f"{losses[-1]}")
    require(all(c == per_step for c in step_counts),
            f"{phase}: launches per step {step_counts[-1]} != {per_step}")
    require(rec.get("attention_lengths", []) == [
        t["length"] for t in rec.get("attention_tiles", [])],
        f"{phase}: the attention lengths follow the merge schedule")
    del state, run, params
    torch.cuda.empty_cache()
    return launches, rec


def phase_packed_remat_vs_no_remat(batch: dict, **model) -> None:
    """One packed step with remat and one without on the same weights,
    sequences and injected draws: they agree only if every recomputed
    block redraws the same masks."""
    from chestxray_vit_tpu_torch.models.vit import init_params
    from chestxray_vit_tpu_torch.train import steps

    dev = torch.device("cuda")
    data = tensors(batch)
    cfg = train_config(remat=True, **model)
    draws = [steps.draw(torch.Generator().manual_seed(SEED + 1), cfg, 0)]
    out = []
    for remat in (True, False):
        p = init_params(torch.Generator().manual_seed(SEED), cfg.model, dev)
        step = steps.make_packed_train_step(
            train_config(remat=remat, **model), 10_000)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        _, m = step(steps.TrainState.create(p, seed=0), data, draws)
        torch.cuda.synchronize()
        out.append((m["loss"].item(),
                    {n: t.grad for n, t in p.named_parameters()},
                    1e3 * (time.perf_counter() - t1),
                    torch.cuda.max_memory_allocated() / 1e9))
        del p
    (loss_r, grads_r, ms_r, mem_r), (loss_n, grads_n, ms_n, mem_n) = out
    loss_diff = abs(loss_n - loss_r)
    scale = max(g.abs().max().item() for g in grads_r.values())
    grad_diff = max((grads_n[n] - g).abs().max().item()
                    for n, g in grads_r.items()) / scale
    emit({"phase": "train_packed_mixed_remat_vs_no_remat",
          "sequences": data["tokens"].shape[0], "loss_remat": loss_r,
          "loss_diff": loss_diff, "grad_rel_diff": grad_diff,
          "tol": [REMAT_LOSS_TOL, REMAT_GRAD_TOL],
          "remat_one_step_ms": ms_r, "remat_max_memory_gb": mem_r,
          "no_remat_one_step_ms": ms_n, "no_remat_max_memory_gb": mem_n})
    require(np.isfinite(loss_r) and loss_diff <= REMAT_LOSS_TOL
            and grad_diff <= REMAT_GRAD_TOL,
            f"packed remat vs no remat: loss {loss_diff}, grads {grad_diff}")
    del out, grads_r, grads_n
    torch.cuda.empty_cache()


def phase_train_packed_cross_check() -> None:
    """One packed train step at full width, depth 2, f32, on the card
    against the CPU (plain versions): two sequences (1024 tokens + 128 pad;
    576 + 576), attention dropout 0.1 on injected seeds (the counter-hash
    mask is equal on both), without and with token merging."""
    from chestxray_vit_tpu_torch.models import bridge
    from chestxray_vit_tpu_torch.models.vit import init_params
    from chestxray_vit_tpu_torch.train import steps

    batch = packed_batch([512, 384, 384], np.random.default_rng(SEED + 2),
                         "cpu")
    for tome_r in (0, TOME_R):
        cfg = train_config(num_layers=2, dtype="float32", remat=True,
                           attention_dropout=DROP_RATE, tome_r=tome_r,
                           tome_schedule=TOME_SCHEDULE)
        draws = [steps.draw(torch.Generator().manual_seed(SEED), cfg, 0)]
        out = {}
        for device in ("cpu", "cuda"):
            params = init_params(torch.Generator().manual_seed(SEED),
                                 cfg.model).to(device)
            data = {k: v.to(device) for k, v in tensors(batch).items()}
            reset_launch_counts()
            state, m = steps.make_packed_train_step(cfg, 10_000)(
                steps.TrainState.create(params, seed=0), data, draws)
            out[device] = ({k: v.item() for k, v in m.items()},
                           _leaves(bridge.grads_to_numpy(state.params)),
                           _leaves(bridge.params_to_numpy(state.params)),
                           launch_counts())
        (cm, cg, cp, cpu_launches), (gm, gg, gp, launches) = \
            out["cpu"], out["cuda"]
        g_scale = max(float(np.abs(g).max()) for g in cg)
        rec = {"phase": "train_packed_cross_check", "depth": 2,
               "sequences": 2, "tome_r": tome_r, "cpu_f32_loss": cm["loss"],
               "tol_f32": XCHECK_F32,
               "loss_diff": abs(gm["loss"] - cm["loss"]),
               "grad_norm_rel_diff": abs(gm["grad_norm"] - cm["grad_norm"])
               / cm["grad_norm"],
               "grads_rel_diff": max(float(np.abs(a - b).max())
                                     for a, b in zip(gg, cg)) / g_scale,
               "params_max_abs_diff": max(float(np.abs(a - b).max())
                                          for a, b in zip(gp, cp)),
               "launches": launches}
        emit(rec)
        for key, tol in (("loss_diff", XCHECK_F32["loss"]),
                         ("grad_norm_rel_diff", XCHECK_F32["grad_norm_rel"]),
                         ("grads_rel_diff", XCHECK_F32["grads_rel"]),
                         ("params_max_abs_diff", XCHECK_F32["params"])):
            require(rec[key] <= tol, f"packed f32 {key}: {rec}")
        require(launches == packed_launches_per_step(2, True)
                and not any(cpu_launches.values()),
                f"packed cross-check launches {launches}, on the CPU "
                f"{cpu_launches}")


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


def phase_eval_int8(params, cfg) -> dict:
    """The int8 eval step on a static tree of ``params`` (calibrated on the
    first eval batch) over the eval batches: finite logits, row losses
    against the host's, exact launch counts (73 int8, 12 attention and 25
    LayerNorm per batch, nothing else)."""
    from chestxray_vit_tpu_torch.models import quantized
    from chestxray_vit_tpu_torch.train import steps

    dev = torch.device("cuda")
    batches = [bench_batch(TRAIN_BATCH, SEED + 10 + i, dev)
               for i in range(EVAL_BATCHES)]
    qp = quantized.quantize_vit_params(
        params, quantized.calibrate_vit_scales(
            params, batches[0]["pixel_values"], cfg.model))
    eval_step = steps.make_inference_eval_step(cfg, quantized=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = [eval_step(qp, b) for b in batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    logits = torch.cat([o[0] for o in outs])
    rows = torch.cat([o[1] for o in outs]).cpu().numpy()
    x = logits.double().cpu().numpy()
    z = torch.cat([b["labels"] for b in batches]).double().cpu().numpy()
    host_rows = (np.maximum(x, 0) - x * z
                 + np.log1p(np.exp(-np.abs(x)))).sum(axis=1)
    row_err = float(np.abs(rows - host_rows).max())
    rec = {"phase": "eval_int8", "batches": EVAL_BATCHES,
           "batch": TRAIN_BATCH, "logits_shape": list(logits.shape),
           "finite": bool(torch.isfinite(logits).all()),
           "row_loss_max_abs_err": row_err, "ms_per_batch":
               1e3 * wall / EVAL_BATCHES, "launches": launches}
    emit(rec)
    require(rec["finite"] and logits.shape == (EVAL_BATCHES * TRAIN_BATCH,
                                               15),
            "finite int8 eval logits of the expected shape")
    require(row_err <= 1e-4, f"int8 row losses vs host: {row_err}")
    require_forward_launches("eval_int8", launches, EVAL_BATCHES, cfg.model,
                             int8=True)
    return launches


KERNELS = (  # name (the kernel_check summary key), source, what it replaces
    ("int8_matmul_fused", "csrc/int8_matmul.cu",
     "chestxray_vit_tpu/ops/int8_pallas.py:51"),
    ("flash_attention_inference", "csrc/flash_attention_inf.cu",
     "chestxray_vit_tpu/ops/flash_attention.py:319"),
    ("layer_norm", "csrc/layer_norm.cu",
     "chestxray_vit_tpu/ops/layer_norm.py:93"),
    ("flash_attention_fwd", "csrc/flash_attention.cu",
     "chestxray_vit_tpu/ops/flash_attention.py:267"),
    ("flash_attention_bwd", "csrc/flash_attention_bwd.cu",
     "chestxray_vit_tpu/ops/flash_attention.py:755"),
    ("layer_norm_bwd", "csrc/layer_norm.cu",
     "chestxray_vit_tpu/ops/layer_norm.py:103"),
    ("flash_attention_dropout_fwd", "csrc/flash_attention_dropout.cu",
     "chestxray_vit_tpu/ops/flash_attention.py:500"),
    ("flash_attention_dropout_debug", "csrc/flash_attention_dropout.cu",
     "chestxray_vit_tpu/ops/flash_attention.py:508"),
    ("flash_attention_dropout_bwd", "csrc/flash_attention_bwd.cu",
     "chestxray_vit_tpu/ops/flash_attention.py:516"),
    ("flash_attention_packed_fwd", "csrc/flash_attention_seg.cu",
     "chestxray_vit_tpu/ops/flash_attention.py:134"),
    ("flash_attention_packed_bwd", "csrc/flash_attention_seg_bwd.cu",
     "chestxray_vit_tpu/ops/flash_attention.py:208"),
    ("flash_attention_packed_dropout_fwd", "csrc/flash_attention_seg.cu",
     "chestxray_vit_tpu/ops/flash_attention.py:140"),
    ("flash_attention_packed_dropout_bwd", "csrc/flash_attention_seg_bwd.cu",
     "chestxray_vit_tpu/ops/flash_attention.py:216"),
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
    # the debug kernel is the mask's oracle and on no main path: its line
    # gives 0 launches there and its kernel_check launches apart
    oracle = {"flash_attention_dropout_debug":
              launch_counts()["flash_attention_dropout_debug"]}

    cfg = ModelConfig()                 # ViT-B/16 @384, 15 classes, bf16
    params = init_params(torch.Generator().manual_seed(SEED), cfg)
    images = make_requests(INT8_REQUESTS)
    card_logits, serve_launches = phase_serving(params, cfg,
                                                images[:REQUESTS])
    phase_cross_check(params, cfg, images, card_logits)
    qp, imgs, fused_logits, serve_int8_launches = phase_serving_int8(
        params, cfg, images)
    phase_int8_cross_check(params, cfg, qp, imgs, fused_logits)
    del params, qp, imgs
    torch.cuda.empty_cache()
    train_params, train_cfg, train_launches, dense_images_per_s = \
        phase_train()
    phase_train_cross_check()
    eval_launches = phase_eval(train_params, train_cfg)
    eval_int8_launches = phase_eval_int8(train_params, train_cfg)
    del train_params
    torch.cuda.empty_cache()
    dropout_launches = phase_train_dropout()
    phase_train_cross_check("train_dropout_cross_check", MIXUP_ALPHA,
                            attention_dropout=DROP_RATE)
    probe = packed_probe_batch("cuda")
    packed_launches, packed_rec = phase_train_packed(
        "train_packed", probe, dense_images_per_s)
    tome_launches, tome_rec = phase_train_packed(
        "train_packed_tome", probe, tome_r=TOME_R,
        tome_schedule=TOME_SCHEDULE)
    emit({"phase": "train_packed_tome_vs_packed",
          "step_ms": [tome_rec["step_ms"], packed_rec["step_ms"]],
          "ratio": tome_rec["step_ms"] / packed_rec["step_ms"]})
    del probe
    drop = {"attention_dropout": DROP_RATE, "hidden_dropout": DROP_RATE}
    mixed = packed_mixed_batch("cuda")
    mixed_launches, _ = phase_train_packed(
        "train_packed_mixed", mixed, warmup=DROPOUT_WARMUP_STEPS,
        timed=DROPOUT_TIMED_STEPS, **drop)
    phase_packed_remat_vs_no_remat(
        {k: v[:8] if k != "n_images" else v for k, v in mixed.items()},
        **drop)
    del mixed
    phase_train_packed_cross_check()
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "chestxray_vit_tpu")]
    require(not loaded, f"no JAX and no JAX-package module imported: "
                        f"{loaded}")

    # launches: the sum over the main paths' runs (serving, int8 serving,
    # the timed train steps, eval, int8 eval, the timed dropout steps, the
    # timed packed, merged and mixed-resolution steps), each counted from 0
    # just before it
    paths = (serve_launches, serve_int8_launches, train_launches,
             eval_launches, eval_int8_launches, dropout_launches,
             packed_launches, tome_launches, mixed_launches)
    summary = []
    for name, source, replaces in KERNELS:
        launches = sum(p.get(name, 0) for p in paths)
        require(launches > 0 or name in oracle,
                f"{name} launched on the main paths")
        rec = checked[name]
        summary.append({
            "name": name, "route": "cuda",
            "source": f"chestxray_vit_tpu_torch/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms")})
        if name in oracle:
            summary[-1]["oracle_launches"] = oracle[name]
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
