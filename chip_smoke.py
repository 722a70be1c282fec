"""Smoke run of the PyTorch port on one NVIDIA GPU: the serving path, the
fine-tune step (dense, with attention dropout, hidden dropout and mixup,
and on the int8 straight-through forward), the eval step, packed variable-resolution training (with and
without within-segment token merging), token merging on the dense
forward (training, serving and eval), the remat policies, the fused Q/K/V
projection, attention maps, the Trainer entry point (a training run
with checkpoints, exact resume and the saved model served), the
PackedTrainer (a packed run with its census, image-count cursor and exact
resume), the data-parallel path in an NCCL group of one process and as
two ranks emulated in one process (with both dropouts and mixup), the
command line (train from an HF folder, eval, predict, quantize, export,
maps, smoke), ViT-H/14 and the other named variants (ViT-L/16, ViT-B/16
@512, ViT-B/32, ViT-S/16, ViT-Ti/16), ViT-B/16 in three heads of 256 and
a model off every multiple of 8, the fsdp and tensor mesh axes (four
ranks on the card, with tensor sizes that cut a head), the examples and
the multi-rank dry run. Every phase's line carries the card's name and
power limit (``nvidia_smi``).

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. device: a CUDA card is required (exit 2 without one, before any
   result); its name and power limit as nvidia-smi prints them.
2. build: the kernels in chestxray_vit_tpu_torch/csrc/ built with nvcc
   (one process per source, all at once; each source's seconds).
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
   redesign (EARLIER_FWD_MS, EARLIER_BWD_MS). The dropout masks at a
   rank's row base: the debug kernel's mask at ROW_BASE_PROBE against the
   plain hash (0 mismatches), and the second half of the batch at its row
   base equal to the whole call's second half bit for bit (dense forward
   and backward at [36, 12, 577, 64], segment forward and backward at
   [32, 12, 1152, 64]). The hidden-dropout kernel at [36, 577, 768] bf16
   and f32 equal to its plain version bit for bit, forward and backward,
   timed beside ``F.dropout`` and its bound.
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
   backwards, 60 hidden-dropout kernels, no dense training attention),
   the profiler's device ms a step and the hidden-dropout kernel's share,
   then one step with and one without remat on the same weights, batch
   and draws.
10. train_dropout_cross_check: 7 with attention and hidden dropout 0.1
   and mixup on the same injected draws (both masks are counter hashes,
   equal on the card and the CPU).
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
   with attention and hidden dropout on injected seeds.
18. train_tome: bench.py's two merged steps (tome_r 16 constant, tome_r 32
   decreasing) at batch 36, full remat: 3 warm-up and 10 timed steps each,
   falling losses, the dense step's exact launch counts per step, each
   layer's attention length (TOME_LENGTHS), images/s and peak memory beside
   phase 6's; then 2 steps of tome_r 16 with both dropouts 0.1 and mixup
   0.2 (train_tome_dropout).
19. tome_cross_check: depth 2, full width, tome_r 16 decreasing: the merged
   train step (full remat, attention dropout on injected seeds) on the
   card in f32 against the CPU, and the merged serving forward (dense f32
   and bf16, static int8 on the fused route) against the CPU; each layer's
   merges that differ from the CPU's are counted, and none may in f32.
20. serving_tome: the fast_serve stack (static int8, tome_r 16 decreasing,
   batch 32) behind the MicroBatcher answering 128 concurrent requests,
   and a dense bf16 tome_r 16 Predictor at batch 8 answering 32: exact
   launches per forwarded batch; the b8 and b32 forward times of dense,
   dense + tome, static int8 and static int8 + tome, which say whether
   the server's auto_accel_config crossover holds on the card.
21. eval_tome: make_inference_eval_step(tome_r=16) on phase 18's merged
   weights, dense and on a static int8 tree, against the host's row
   losses, with exact launch counts.
22. train_remat_policies: bench.py's b36 step under every remat policy
   (full, mlp, attn, attn_mlp, flash_out, dots) and without remat, 1 + 3
   steps each on the same batch from the same weights: step ms, images/s,
   peak memory, exact launches per step (the attention forward twice a
   layer where o and lse are recomputed, once where they are kept), each
   first step against the full-remat step's, bit for bit or within
   POLICY_GRAD_TOL; then flash_out with both dropouts 0.1 against full
   remat on the same draws.
23. train_fused_qkv: the b36 step with model.fused_qkv beside phase 22's
   split step, exact launches; one f32 step fused against split
   (FUSED_GRAD_TOL); the time of the stack autograd makes of the three
   gradient buffers (dq, dk, dv) into the fused product's gradient.
24. serving_maps: a dense b8 Predictor's attention-rollout forward
   (with_maps=True): maps ms beside the plain forward's, peak memory, 25
   LayerNorm launches and no attention kernel, the maps against the CPU's
   f32 (MAPS_TOL, MAPS_MIN_CORR); MAPS_REQUESTS POST /predict?maps=1
   requests through the port's server (200, a 24 x 24 map each); one
   Grad-CAM call at batch GRAD_CAM_BATCH.
25. trainer: ``Trainer`` at full width (bf16, full remat, batch 36,
   random weights) on the fake NIH bucket (300 images of 512 px, memory
   store, host placement, augmentation on): 12 steps, eval and a
   checkpoint every 6, the best one restored; finite losses, the same
   losses in metrics.jsonl and the tfevents file, exactly the saves of
   steps 6 and 12 with their metrics; evaluate(); save_model() and
   Predictor.from_model_dir() against the Trainer's eval logits
   (BF16_LOGIT_TOL); a second Trainer resumed from step 6 gives steps
   7-12, the eval metric and the step-12 checkpoint bit for bit; exact
   launches (18 train steps, 6 forwards of 36). Beside the bare step's
   images/s of phase 6: the Trainer's (ThroughputMeter and wall clock),
   each step's wall time, the host's ms a batch alone, the card's idle
   share over three steady steps, peak memory, the checkpoint's bytes
   and write seconds, evaluate() ms.
26. packed_trainer: ``PackedTrainer`` at full width (bf16, full remat, 32
   sequences of 1152 tokens a step, grids 16 / 24 / 32, random weights)
   over a fake bucket of 360 images (a third each at 256, 384 and 512 px,
   memory store): 12 steps, eval and a checkpoint every 6, the best one
   restored, evaluate(); a second PackedTrainer resumed from step 6 gives
   steps 7-12, the eval metric and the step-12 checkpoint with its
   image-count cursor bit for bit; exactly 24 segment forwards and 12
   segment backwards a step, 12 segment forwards an eval batch, no dense
   attention. Beside phase 14's bare packed step: the census's
   steps_per_epoch and the full batches each epoch packs, tokens/s and
   images/s over three steady steps, the pad share, the host's ms to pack
   a batch alone, the census's seconds, the card's idle share, checkpoint
   bytes and seconds, evaluate() ms, peak memory.
27. ddp_world1: 3 steps of the dense Trainer (b36, both dropouts 0.1,
   mixup 0.2) and 3 of the PackedTrainer (both dropouts) without a process
   group, then the same in an NCCL group of one process (``parallel.distributed.initialize`` on tcp://127.0.0.1,
   a free port): losses, grad norms and the parameters after step 3 equal
   bit for bit, exactly one all-reduce a step (the gradients with the
   loss, or with the packed loss's numerator and denominator), the group
   torn down.
28. cli: the command line at full width, through ``cli.main`` in this
   process. An HF folder (``export_hf_folder``) of seeded ViT-B/16 @384
   weights with the fake bucket's 15 classes, read back bit for bit
   (bytes, write and read seconds); ``train --preset version_b`` from it
   on the memory backend's fake bucket (b8, bf16, 8 steps, one eval and
   one save at step 8): its step-0 parameters equal the folder's bit for
   bit (a local folder that fails to load would degrade to random init
   silently), the attention forward and backward and LayerNorm forward and
   backward kernels launched, steady step ms, images/s, peak memory and
   wall seconds; ``eval`` and ``predict`` from the checkpoint (the report
   written); ``quantize --mode static`` on 4 PNGs and a static int8
   ``Predictor.from_model_dir`` forward on the fused kernel; ``export`` of
   the saved model, read back equal to the trained parameters; ``maps``
   with rollout and gradcam (4 overlays each); ``smoke`` (hidden 64 in
   four heads of 16, as the JAX smoke: the attention kernels at d = 16).
29. train_int8: bench.py's step (b36, bf16, full remat) on the int8
   straight-through forward (``make_train_step(int8_scales=)``, scales
   calibrated on the batch): 3 warm-up and 10 timed steps, finite losses
   that fall, exactly 145 int8 kernel launches a step (the patch
   embedding, then 72 block products in the forward and the recompute)
   beside the dense step's launches, step ms, images/s beside phase 6's,
   peak memory; train_int8_tome, the same merging tome_r 16 (constant)
   over 2 + 5 steps beside phase 18's merged step, each layer's attention
   length; train_int8_remat, the first step under full remat, without
   remat and under ``mlp``, without and with both dropouts 0.1 and mixup
   0.2 on the same draws: equal bits and exact launches.
30. train_int8_cross_check: depth 2, full width, batch 2, f32: the int8
   train step on the card against the CPU's (the same weights, scales and
   draws), without and with attention dropout 0.1 and mixup 0.2, and the
   eval-mode int8 logits (INT8_XCHECK).
31. train_dp_split (after 10): data parallelism with both dropouts 0.1,
   mixup 0.2 and accumulation 2 at full width (b36, bf16, full remat):
   one step over the global batch at a world of one against two ranks of
   18 emulated in this process (each built with its rank, given the
   previous rank's last rows as its mixup neighbours), their gradients
   combined as the all-reduce combines them: loss and gradients within
   REMAT_LOSS_TOL / REMAT_GRAD_TOL, every rank launching what the global
   step launches; dense, merged (tome_r 16), int8 straight-through and
   packed (32 × 1152 mixed-resolution sequences, the dropouts only). Then
   micro-batch 0's first-layer draws and keep masks of each rank at its
   row base against the global ones, bit for bit.
32. serving_dp (after 20): data-parallel serving from one process at
   full width (ViT-B/16 @384, seed-0 weights, placement "device"). The
   card's machine has one card, so two replicas on cuda:0, each with its
   own weights and stream (``Predictor(device=["cuda:0", "cuda:0"])``),
   stand in for two cards (``emulated``); with two cards or more a real
   ``data_parallel=torch.cuda.device_count()`` Predictor runs as well
   (``cards``). For each stack, dense bf16, static int8 (fused kernel),
   fast_serve (static int8 + tome_r 16 decreasing), each with 16 rows a
   replica, and the rollout maps forward at 4 rows a replica (b8 on two):
   128 concurrent requests through the MicroBatcher, with images/s, p50
   and max latency beside a one-replica Predictor at the same batch on
   the same requests, and each replica's ``enqueue_ms``; exactly
   replicas x the per-forward launches (12 attention, 25 LayerNorm, 73
   int8 on the fused route; maps 25 LayerNorm); each replica's rows of 32
   images equal, bit for bit, a one-replica Predictor at the replica's
   batch; the gathered logits (and maps) within BF16_LOGIT_TOL (MAPS_TOL)
   of the one-replica Predictor at the same batch. Two streams on one
   card share it: the emulated line measures no scaling.
33. vit_h14 (after 30): ViT-H/14 @224 (hidden 1280, 32 layers, 16 heads of
   80, 257 tokens; seed-0 random weights) at full width and depth:
   serving_vit_h14_b8 and _b32 (the dense bf16 Predictor, 64 requests,
   exactly 32 attention and 65 LayerNorm launches a forward),
   serving_int8_vit_h14 (static int8 at b32 calibrated on 8 requests, 193
   int8 launches a forward, the patch embedding's K = 588 padded to 640;
   beside it dense b32 and the b32 forward times of four stacks) with
   int8_cross_check_vit_h14 (phase 12's bounds), train_vit_h14 (b32, bf16,
   full remat, 3 + 8 steps: ms a step, images/s, MFU, peak GB, finite
   losses, exact launches a step) and eval_vit_h14 (one b32 eval step,
   AUROC and F1 against the CPU's).
34. vit_h14_cross_check: depth 2 at full width in f32: logits card vs CPU
   (F32_LOGIT_TOL) and one train step (vit_h14_train_cross_check,
   XCHECK_F32), LayerNorm at 1280 in f32 on the card.
35. train_mesh: the fsdp and tensor axes. Four ranks (started through
   the launcher, ``parallel/launch.py``) on cuda:0 in a gloo group, mesh data x fsdp x tensor
   1 x 2 x 2 (ZeRO-3 shards, the Megatron split, the dropout kernels keyed
   by global head), ViT-B/16 @384 at full width and 4 of its 12 layers,
   bf16, full remat, against this process taking the same steps on the
   global batch:
   the dense step (attention and hidden dropout 0.1, mixup 0.2, global
   batch 8; 2 steps and one eval step), the packed step (8 sequences of
   1152 tokens, mixed layout, both dropouts 0.1; 2 steps), the merged
   packed step (r 16 decreasing; 2 steps) and the int8 straight-through
   dense step (b8, scales calibrated on the batch; 2 steps), within
   MESH_BF16_TOL (stated on the phase's first line); then each at depth 2
   in f32 (MESH_F32_TOL). Then the tensor sizes that cut a head
   (MESH_SPLIT_RUNS): ViT-S/16 at full width on 1 x 1 x 4 and ViT-Ti/16
   on 1 x 2 x 2, depth 2, the dense, dropout and packed steps in bf16 and
   f32 within the same bounds, and what the cut costs a rank
   (train_mesh_head_split_cost: the heads it runs against its share, their
   attention ms a step, the gathers' collectives). Step ms beside the
   one-process step, the collectives a step by kind and bytes, exact
   launches a step on every rank. Four ranks share the card: no scaling
   is measured.
36. examples: ``examples/finetune_nih_torch.py --dry-run`` (version_b:
   ViT-B/16 @384, 20 steps) and ``examples/train_smoke_torch.py``, each
   in its own process, with their wall seconds; started at once, and
37. dryrun: ``python -m chestxray_vit_tpu_torch.dryrun 4`` on cuda:0
   beside them (the three share the card and the host).
38. trainer_spawn (run after 35): one process driving several devices
   (``parallel/launch.py``). A lone Trainer on ``["cuda:0"] * 2`` (2 x 1 x
   1, data -1; ViT-B/16 @384 bf16, full remat, global batch 8, 3 steps)
   against the one-process Trainer at the same global batch, one bf16 ulp
   of the loss a step; a lone PackedTrainer on ``["cuda:0"] * 4`` (1 x 2 x
   2 at depth 4, 8 sequences of 1152) uninterrupted, then stopped at step
   2 by ``request_stop`` and resumed by a fresh one, bit for bit. The
   seconds from the call to the first step, step ms beside one process,
   the group's backend, exact launches a step on every rank.
39. variants (after 34): the named variants at full width and depth from
   seeded weights (VARIANT_RUNS, phase_variant): ViT-L/16 @384 (24 layers,
   16 heads of 64, width 1024; dense bf16 serving at b8 and b32, static
   int8 at b32 with its CPU cross-check, the b32 train step with the
   variant's full remat), ViT-B/16 @512 (a 384-grid tree adapted on the
   card to 1025 tokens against the CPU's adaptation; the b32 step with full
   remat and one with attention and hidden dropout 0.1 at Q blocks of
   auto_block_q(1025) = 384), ViT-B/32, ViT-S/16 and ViT-Ti/16 @384 (the
   b36 step): VARIANT_WARMUP_STEPS + VARIANT_TIMED_STEPS steps, ms a step,
   images/s, MFU, peak GB, finite losses, exact launches a step; one eval
   step each with AUROC and F1 against the CPU's; then each one's depth-2
   f32 check against the CPU (<name>_cross_check: logits within
   F32_LOGIT_TOL; one train step within phase_train_cross_check's bounds,
   ViT-B/16 @512 with both dropouts).
40. vit_b16_h3 (after 39): ViT-B/16 @384 in three heads of 256 (the wide
   attention kernels) at full width and depth: dense bf16 serving at b8,
   static int8 at b32 with its forward times and CPU cross-check, the b36
   full-remat train step (3 + 8 steps: ms a step, images/s, MFU, peak GB,
   exact launches a step), an eval step, the depth-2 f32 check.
41. off8_model (after 40): hidden 50 in two heads of 25, MLP 100, 64 px,
   depth 2 (the zero-padded head dim, LayerNorm off the vector, int8 N and
   K off 8 and 64): the f32 forward and train step, the eval step and the
   static int8 Predictor and the int8 straight-through train step, each
   against the CPU, with their launches.

kernel_check also holds the four segment kernels to their plain versions at
[32, 12, 1152, 64] bf16 (f32 at batch 4) in three layouts: two segments of
576; mixed with padding (1024 + 128 pad, 576 + 256 + 256 + 64 pad,
4 x 256 + 128 pad); and ragged with interleaved ids (S = 1136, the order a
token merge leaves). It also holds the int8 kernel to its plain version at the batch-32
serving shapes in its five call forms (INT8_FORMS: patch embed, Q/K/V, the
residual forms of wo and mlp_out, mlp_in with GELU and requantize), and at
the b36 training shapes in the four forms of the int8 train forward
(INT8_TRAIN_FORMS: bf16 out, no residual, GELU or requantize), equal bits
twice. At the lengths token merging leaves on the dense path
(MERGED_LENGTHS: 561, 517, 401, 197) it checks the inference, training and
dropout attention kernels at batch 36 (the debug kernel's mask: 0
mismatches), the LayerNorm forward and backward at 36 · S rows and two
int8 forms at 32 · S rows. At head dims other than 64 (HEAD_DIMS: 16, 80,
128 at HEAD_DIM_LENGTHS; 4, 12, 136, 256, 768 at WIDE_HEAD_DIM_LENGTHS)
it holds every attention kernel to its plain version in bf16 and f32
(the debug kernel's mask equal to the plain hash and to its mask at
d = 64), times the inference, training forward and backward at ViT-B/16's
three heads of 256 (WIDE_ATTN_SHAPES, beside SDPA's backend that takes
them) and ViT-H/14's shapes (VITH_ATTN_SHAPES) beside SDPA's flash kernel,
the LayerNorm forward and backward off the vector and past 2048
(WIDE_LN_CASES), the int8 kernel at N and K off 8 and 64
(OFF8_INT8_FORMS), the
LayerNorm forward and backward at ViT-H/14's 8 · 257 rows of 1280 in bf16
and f32, and the int8 kernel at the patch embedding's K = 588 padded to 640
(equal to the plain version on the unpadded operands). Those records join
the summary line as each kernel's ``head_dims``. Last, the head split
(``check_head_split``): every dropout entry point and the training and
inference kernels on a tensor rank's heads, with ``head_base`` and
``heads_total``, equal to the whole-head call's slice bit for bit, at
d = 64 and 80; and the int8 kernel in the four forms of the int8 step on a
tensor axis of 2 (INT8_TENSOR_FORMS: the column products at N / 2, the row
products at K / 2 as raw int32 sums), equal bits twice, timed beside
``torch._int_mm`` (events and device time), with two emulated ranks' int32
row partials at K = 768 and 3072 (odd partials past 2²⁴) summed to the
one-process product's bits. At the variants' shapes (``check_variants``):
every attention kernel at (heads, tokens) of VARIANT_ATTN (the dropout
mask at auto_block_q: 0 mismatches), the training forward, backward and
dropout forward timed at ViT-B/16 @512's [36, 12, 1025, 64]; the
LayerNorm forward and backward at VARIANT_LN_CASES (ViT-L/16's 1024,
ViT-S/16's 384, ViT-Ti/16's 192, bf16 and f32); the int8 kernel in
VARIANT_INT8_FORMS (ViT-L/16's b32 forms, ViT-B/32's K = 3072 patch
embedding, ViT-Ti/16's N = 192): those records join the summary line as
each kernel's ``variants``. Before every kernel, the tile helpers alone
(``tile_mma_selftest.cu``, ``check_tile_mma``): each bf16 and int8 form,
the 16-wide tiles of the kD = 80 forward among them, against the matmul.

The second-to-last line is the kernels summary, the last one the result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
from typing import Optional

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
# kernel_check's row base for the dropout masks: a rank's batch offset far
# enough out (row · 12 heads · 592 · 640 > 2^32) that the counter wraps
ROW_BASE_PROBE = 100_003

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
# - variants' adapt, the position table resampled on the card against the
#   CPU's (two f32 products by the bicubic matrix, TF32 off, entries of
#   O(0.02)): summation order only.
F32_ADAPT_TOL = 1e-6
# - training attention: o and lse (natural log, O(10)) against ATTN_TOL,
#   absolute; dq, dk, dv relative to each one's largest magnitude, where
#   bf16 rounds P and dS before their products at other points of the sum
#   than the plain version and f32 differs in summation order only.
ATTN_GRAD_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# - head dims other than 64 (check_head_dims, batch 2 of 4 heads): every
#   output and gradient element within ATTN_TOL of the plain version,
#   absolute; each gradient's error relative to its largest is recorded
#   beside it. At this size a gradient's largest element may sit near 1.5,
#   where ATTN_GRAD_TOL allows 1.95 bf16 ulps: one d = 80 case read 2 ulps
#   (0.0102), while the d = 80 kernels equal the d = 128 ones on
#   zero-padded operands bit for bit and d = 64 and 80 show the same error
#   tail over 600 draws (≤ 0.0055; PERF.md §6, PR 18).
# - LayerNorm backward: dx as the forward's output (1 bf16 ulp + 1e-5 in
#   bf16); dscale and dbias sum 20,772 rows in another order: relative 1e-5
#   of the largest in f32, plus one ulp of each element when cast to bf16.
LN_BWD_REL_TOL = 1e-5
# - train: one bf16 step with and without remat runs the same kernels on
#   the same inputs (the card's products may pick other algorithms for the
#   recompute's shapes): loss 1e-3, gradients 1e-2 of the largest.
REMAT_LOSS_TOL, REMAT_GRAD_TOL = 1e-3, 1e-2
# - train_remat_policies: a policy changes what the backward keeps, not what
#   it computes, so each policy's first step equals the full-remat step's
#   bit for bit where the card's products repeat their bits; the largest
#   gradient difference relative to the largest gradient is bounded at
#   1e-5 in case cuBLAS does not.
POLICY_GRAD_TOL = 1e-5
# - train_fused_qkv, f32 with TF32 off: the one [D, 3D] product sums each
#   Q/K/V weight gradient in another order than three [D, D] ones:
#   gradients 1e-4 of the largest, loss 1e-5.
FUSED_GRAD_TOL, FUSED_LOSS_TOL = 1e-4, 1e-5
# - serving_maps: card bf16 rollout maps (in [0, 1]) against the CPU's f32
#   on the same weights and images: bf16 activations through 12 layers and
#   a min-max normalization per map. Bound 5e-2, correlation above 0.99.
MAPS_TOL, MAPS_MIN_CORR = 5e-2, 0.99
# - train_cross_check, f32 card vs f32 CPU: the same math in another
#   summation order. bf16 card vs f32 CPU: bf16 activations; AdamW's first
#   step moves each weight by about lr, so the updated weights can differ
#   by at most ~2 lr where the two gradients disagree in sign.
#   Gradients relative to the largest gradient of the model.
XCHECK_F32 = {"loss": 1e-5, "grad_norm_rel": 1e-4, "grads_rel": 1e-4,
              "params": 1e-5}
XCHECK_BF16 = {"loss": 5e-2, "grads_rel": 5e-2, "params": 2.1e-4}
# - vit_h14_train_cross_check, f32: loss and gradients as XCHECK_F32; the
#   updated weights by the rule above, ~2 lr (the bf16 bound): at hidden
#   1280 more weights have a gradient near 0, where AdamW's first step
#   (m / √v ≈ ±1) turns a summation-order difference of the gradient into
#   up to 2 lr of the weight (read 1.23e-5 on an H100).
VITH_XCHECK_PARAMS = XCHECK_BF16["params"]
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
# - train_int8_cross_check, the card's f32 int8 train step against the
#   CPU's on the same weights, scales and draws: the int8 forward is not
#   continuous (see INT8_ROUTE_TOL), so the eval-mode logits are held to
#   INT8_ROUTE_TOL and INT8_ROUTE_MIN_CORR. The loss, a mean of BCE terms
#   whose slope in their logit is below 1, moves by at most the mean logit
#   difference: INT8_ROUTE_TOL holds it too. The gradients are the dense
#   linear's at the forward's point, each logit's upstream gradient σ(l) − z
#   moving by at most a quarter of its difference: 5e-2 of the largest
#   gradient, XCHECK_BF16's bound for bf16 activations, which move the
#   forward by as much. The weights after one AdamW step: XCHECK_BF16's
#   2.1e-4 (about 2 lr where two gradients disagree in sign).
INT8_XCHECK = {"logits": INT8_ROUTE_TOL, "logit_corr": INT8_ROUTE_MIN_CORR,
               "loss": INT8_ROUTE_TOL, "grads_rel": 5e-2, "params": 2.1e-4}


# Sequence lengths at which the dense attention kernels are held against
# their plain versions beside the serving and training lengths: the edges
# of their 64-row tiles, a tail of one row, and more tiles than the copy
# ring has stages (checked, not timed).
EDGE_LENGTHS = (64, 128, 129, 576, 1025)
# Head dims other than 64 (the kernels pad d to 64 or 128 in shared memory):
# the smoke's 16, ViT-H/14's 80 and the largest, 128; every attention
# kernel at each, in bf16 and f32, at ViT-H/14's 257 tokens, ViT-B/16's
# 577, a short odd 37 and EDGE_LENGTHS, batch 2 of 4 heads
# Then the head dims the JAX kernels take past those: 4 and 12 (off the
# multiple of 8: zero-padded to 8 and 16 by the wrappers), 136, 256 and 768
# (the wide kernels: three and four 64-column chunks of one 256-column
# output block, and three blocks), at the lengths of WIDE_HEAD_DIM_LENGTHS
HEAD_DIMS = (16, 80, 128, 4, 12, 136, 256, 768)
HEAD_DIM_LENGTHS = (257, 577, 37) + EDGE_LENGTHS
WIDE_HEAD_DIM_LENGTHS = (37, 577, 1025)
HEAD_DIM_BATCH, HEAD_DIM_HEADS = 2, 4
# (d, wider d): the kernels at d equal, bit for bit, the kernels at the
# wider d on operands zero-padded to it (the unmasked d = 64 instantiation
# against the masked d = 16; a whole second chunk against its first 16
# columns; d = 12 is the d = 16 call on the wrappers' own padding; the wide
# kernels' last 64-column chunk at 8 columns (d = 136 and 200) against
# whole chunks of one 256-column block, their 16-deep steps of S past d
# against zero steps)
HEAD_DIM_PADS = ((16, 64), (80, 128), (12, 16), (136, 256), (200, 256))
# ViT-B/16 @384 in three heads of 256 (model.num_heads=3): its attention
# timed at the serving and training batches beside the plain version and
# SDPA (the backend that takes d = 256, if any), by the real d's bound
WIDE_ATTN_SHAPES = ((8, 3, 577, 256), (TRAIN_BATCH, 3, 577, 256))
# LayerNorm off the 16-byte vector (the off-8 model's width 50 at the b36
# train rows: a warp a row; 1001 at the b8 serving rows: a block a row)
# and past the register rungs (2560, 6144 at the b8 serving rows: a block
# a row from registers), forward and backward, bf16 rows with a bf16 and
# an f32 scale, the width 50 in f32 too; past ln_bwd_any's widths (the
# forward: the row read once a pass; the backward: a cluster of two blocks
# a row) bf16 9000 with either scale and f32 6144, and bf16 4100 off the
# vector (the backward's two-pass form)
WIDE_LN_CASES = ((TRAIN_BATCH * 577, 50, torch.bfloat16, torch.bfloat16),
                 (TRAIN_BATCH * 577, 50, torch.bfloat16, torch.float32),
                 (TRAIN_BATCH * 577, 50, torch.float32, torch.float32),
                 (8 * 577, 1001, torch.bfloat16, torch.bfloat16),
                 (8 * 577, 2560, torch.bfloat16, torch.bfloat16),
                 (8 * 577, 2560, torch.bfloat16, torch.float32),
                 (8 * 577, 6144, torch.bfloat16, torch.bfloat16),
                 (8 * 577, 6144, torch.bfloat16, torch.float32),
                 (8 * 577, 9000, torch.bfloat16, torch.bfloat16),
                 (8 * 577, 9000, torch.bfloat16, torch.float32),
                 (8 * 577, 6144, torch.float32, torch.float32),
                 (8 * 577, 4100, torch.bfloat16, torch.bfloat16))
# ViT-H/14 @224 (config.VIT_VARIANTS["vit_h14"]): hidden 1280 in 16 heads of
# 80, 257 tokens; its attention timed at the serving and training batches,
# its LayerNorm (forward and backward) at the b8 serving rows in both dtypes
# and at the b32 train step's rows with the block LNs' bf16 scale and the
# final LN's f32 one, its patch embedding's int8 product (K = 3 · 14 · 14 =
# 588, padded to 640) at the b32 rows
VITH_HIDDEN, VITH_TOKENS = 1280, 257
VITH_ATTN_SHAPES = ((8, 16, VITH_TOKENS, 80), (32, 16, VITH_TOKENS, 80))
VITH_LN_CASES = ((8 * VITH_TOKENS, VITH_HIDDEN, torch.bfloat16,
                  torch.bfloat16),
                 (8 * VITH_TOKENS, VITH_HIDDEN, torch.float32,
                  torch.float32),
                 (32 * VITH_TOKENS, VITH_HIDDEN, torch.bfloat16,
                  torch.bfloat16),
                 (32 * VITH_TOKENS, VITH_HIDDEN, torch.bfloat16,
                  torch.float32))
VITH_BATCH, VITH_INT8_BATCH, VITH_TRAIN_BATCH = 8, 32, 32
VITH_REQUESTS = 64
VITH_WARMUP_STEPS, VITH_TIMED_STEPS = 3, 8
# phase 39 (variants): the named variants (config.VIT_VARIANTS) beside
# ViT-B/16 @384 and ViT-H/14 @224, at full width and depth from seeded
# weights: (phase name, variant, image px, what runs). "serve": dense bf16
# serving at b8 and b32 and static int8 at b32 with its cross-check;
# "train": the train step at that batch (the variant's own remat: full for
# ViT-L/16, none for the narrower ones; "remat" switches it on); "adapt":
# the tree drawn at that grid's image size and adapted on the card;
# "dropout": one more step with attention and hidden dropout. Each runs one
# eval step, then its depth-2 f32 check against the CPU (with
# "xcheck_dropout" at both dropouts' rate).
VARIANT_RUNS = (
    ("vit_l16", "vit_l16", 384, dict(serve=True, train=32)),
    ("vit_b16_512", "vit_b16", 512, dict(train=32, remat=True, adapt=384,
                                         dropout=True, xcheck_dropout=True)),
    ("vit_b32", "vit_b32", 384, dict(train=TRAIN_BATCH)),
    ("vit_s16", "vit_s16", 384, dict(train=TRAIN_BATCH)),
    ("vit_ti16", "vit_ti16", 384, dict(train=TRAIN_BATCH)))
VARIANT_WARMUP_STEPS, VARIANT_TIMED_STEPS, VARIANT_REQUESTS = 2, 4, 64
# kernel_check at the variants' shapes (check_variants): the inference
# kernel at each serving batch of 8, the training, dropout (its Q block by
# auto_block_q) and segment kernels at each train batch, as (heads,
# tokens): ViT-Ti/16 and ViT-S/16 @384, ViT-B/32 @384, ViT-L/16 @384,
# ViT-B/16 @512; the training forward, backward and dropout forward timed
# at ViT-B/16 @512's b36 [36, 12, 1025, 64]. LayerNorm forward and backward
# at ViT-L/16's b32 rows of 1024 (the block LNs' bf16 scale, the final LN's
# f32 one) and at the b36 rows of 384 (ViT-S/16) and 192 (ViT-Ti/16) in
# bf16 and in f32. The int8 kernel in ViT-L/16's five b32 serving forms,
# ViT-B/32's patch embedding at K = 3 · 32 · 32 = 3072 and ViT-Ti/16's
# forms at N = 192 (a ragged 128-wide tile).
VARIANT_ATTN = ((3, 577), (6, 577), (12, 145), (16, 577), (12, 1025))
VARIANT_TIMED_ATTN = (TRAIN_BATCH, 12, 1025, 64)
VARIANT_LN_CASES = ((32 * 577, 1024, torch.bfloat16, torch.bfloat16),
                    (32 * 577, 1024, torch.bfloat16, torch.float32),
                    (TRAIN_BATCH * 577, 384, torch.bfloat16, torch.bfloat16),
                    (TRAIN_BATCH * 577, 384, torch.float32, torch.float32),
                    (TRAIN_BATCH * 577, 192, torch.bfloat16, torch.bfloat16),
                    (TRAIN_BATCH * 577, 192, torch.float32, torch.float32))
VARIANT_INT8_FORMS = (
    ("vit_l16_patch_embed", 32 * 576, 768, 1024, False, False),
    ("vit_l16_q", 32 * 577, 1024, 1024, False, False),
    ("vit_l16_wo_resid", 32 * 577, 1024, 1024, True, False),
    ("vit_l16_mlp_in_gelu_requant", 32 * 577, 1024, 4096, False, True),
    ("vit_l16_mlp_out_resid", 32 * 577, 4096, 1024, True, False),
    ("vit_b32_patch_embed", 32 * 144, 3072, 768, False, False),
    ("vit_ti16_q", 32 * 577, 192, 192, False, False),
    ("vit_ti16_mlp_in_gelu_requant", 32 * 577, 192, 768, False, True),
    ("vit_ti16_mlp_out_resid", 32 * 577, 768, 192, True, False))
# The int8 kernel at N and K off 8 and 64: the off-8 model's (hidden 50,
# MLP 100) b8 serving forms, K padded to 64 or 128 inside the wrapper, N a
# tail of 2 or 4 columns; and its int32 out form.
OFF8_INT8_FORMS = (
    ("off8_q", 8 * 577, 50, 50, False, False),
    ("off8_wo_resid", 8 * 577, 50, 50, True, False),
    ("off8_mlp_in_gelu_requant", 8 * 577, 50, 100, False, True),
    ("off8_mlp_out_resid", 8 * 577, 100, 50, True, False))
# The off-8 model on the card (phase off8_model): hidden 50 in two heads of
# 25, MLP 100, patch 16, 64 px, depth 2
OFF8_MODEL = dict(hidden_size=50, num_heads=2, mlp_dim=100, patch_size=16,
                  img_size=64, num_layers=2)
# Attention lengths of the merged dense forward (token merging leaves a
# length no tile divides at every layer): tome_r 16 constant runs 561 and
# 401, tome_r 32 decreasing 517 and 197 (see TOME_LENGTHS).
MERGED_LENGTHS = (561, 517, 401, 197)
# bench.py's two merged steps (tome_r, schedule), and each layer's
# attention length in them at 577 tokens and 12 layers: r_schedule's
# counts, each clamped to ceil(S/2) − 1.
TOME_STEPS = ((16, "constant"), (32, "decreasing"))
TOME_LENGTHS = {
    (16, "constant"): tuple(range(577, 400, -16)),
    (32, "decreasing"): (577, 517, 462, 412, 367, 327, 292, 263, 239, 220,
                         206, 197),
    (16, "decreasing"): (577, 547, 519, 494, 471, 451, 433, 419, 407, 398,
                         391, 387)}
TOME_DROPOUT_STEPS = 2
# train_int8_tome: the int8 step merging tome_r 16 (constant), shorter
INT8_TOME_WARMUP_STEPS, INT8_TOME_TIMED_STEPS = 2, 5
# train_remat_policies: every policy, then the step without remat (None)
REMAT_POLICIES = ("full", "mlp", "attn", "attn_mlp", "flash_out", "dots",
                  None)
POLICY_WARMUP_STEPS, POLICY_TIMED_STEPS = 1, 3
# serving_maps: requests sent with ?maps=1, and the Grad-CAM batch
MAPS_REQUESTS, GRAD_CAM_BATCH = 4, 2
# the server's fast_serve merging: tome_r 16 under the decreasing schedule
TOME_SERVE = (16, "decreasing")
# serving_dp: replicas on one card, and each stack with its rows a replica
DP_REPLICAS = 2
DP_STACKS = (("dense_bf16", 16, {}),
             ("static_int8", 16, {"quantize": "static"}),
             ("fast_serve", 16, {"quantize": "static", "tome_r": TOME_SERVE[0],
                                 "tome_schedule": TOME_SERVE[1]}),
             ("maps", 4, {}))
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
# phase 25 (trainer): the fake NIH bucket, the run and its cadences
TRAINER_IMAGES, TRAINER_IMAGE_SIZE = 300, 512
TRAINER_STEPS, TRAINER_EVERY = 12, 6
# the idle share over steps 2-4: no epoch boundary (after 5 and 10), eval
# or save (after 6 and 12) among them
TRAINER_PROFILE = (2, 4)
TRAINER_METER_WINDOW = 4
# phase 26 (packed_trainer): the variable-resolution bucket (a third each
# at 256, 384 and 512 px), the packed run and its cadences
PACKED_TRAINER_IMAGES = 360
PACKED_TRAINER_SEQ_LEN, PACKED_TRAINER_GRIDS = 1152, (16, 24, 32)
PACKED_TRAINER_SEQS = 32
PACKED_TRAINER_STEPS, PACKED_TRAINER_EVERY = 12, 6
# phase 27 (ddp_world1): steps of each trainer, without and with the group
DDP_STEPS = 3
# phase 31 (train_dp_split): the global batch's step against DP_WORLD ranks
# emulated in one process, with accumulation DP_ACCUM. The ranks run the
# same kernels on the same rows; their products run at 1 / DP_WORLD of the
# rows, where cuBLAS may pick other algorithms and sum in another order,
# and the bf16 activations round accordingly: the tolerance of one step
# with and without remat (REMAT_LOSS_TOL, REMAT_GRAD_TOL), loss absolute,
# gradients relative to the largest.
DP_WORLD, DP_ACCUM = 2, 2
# phase 28 (cli): train steps (version_b's b8; an epoch is 5 steps of the
# CLI's 64-image bucket), the steady steps read (no eval, save or epoch
# boundary after them), and the PNGs quantize, predict and maps read
CLI_STEPS, CLI_STEADY, CLI_IMAGES = 8, (2, 3, 4), 4


# kernel_check's int8 forms on a tensor axis of 2 (models/int8_train.py),
# at the rows of a b8 global batch's slot on 1 x 2 x 2 (4 images): the
# column products (q, k, v; mlp_in) at N / 2, bf16 out, and the row products
# (wo; mlp_out) at K / 2, the int32 out form (the raw sums, no epilogue)
MESH_INT8_ROWS = 4 * 577
INT8_TENSOR_FORMS = (
    ("tensor_col_qkv", MESH_INT8_ROWS, 768, 384, False),
    ("tensor_col_mlp_in", MESH_INT8_ROWS, 768, 1536, False),
    ("tensor_row_wo", MESH_INT8_ROWS, 384, 768, True),
    ("tensor_row_mlp_out", MESH_INT8_ROWS, 1536, 768, True))
# kernel_check's head split: (d, H, S) at ViT-B/16 @384 and ViT-H/14 @224,
# each rank of each tensor size t, at a row base
HEAD_SPLIT_CASES = ((64, 12, 577), (80, 16, 257))
HEAD_SPLIT_TENSOR = (2, 4)
HEAD_SPLIT_BATCH, HEAD_SPLIT_ROW_BASE = 4, 3
# phase 35 (train_mesh): MESH_RANKS ranks on cuda:0, (dcn, data, fsdp,
# tensor), one spawn for every run of MESH_RUNS: (name, path, model, steps).
# The paths: "dense" (the train step with mixup 0.2 on MESH_BATCH images,
# then one eval step), "packed" (the packed step on MESH_PACKED_SEQS
# 1152-token sequences of smoke_batches' mixed layout; merged at the
# train_packed_tome phase's r), "int8" (the int8 straight-through dense
# step on MESH_BATCH images, scales calibrated on them). Full width in bf16
# at MESH_LAYERS of ViT-B/16's 12 layers (the script's time limit: four
# ranks share the card and a full-depth bf16 step took 3.5-5.7 s), then
# each path's f32 counterpart at depth 2.
MESH_RANKS, MESH_SHAPE, MESH_BATCH, MESH_PACKED_SEQS = 4, (1, 1, 2, 2), 8, 8
MESH_LAYERS, MESH_STEPS = 4, 2
_MESH_DROP = dict(attention_dropout=DROP_RATE, hidden_dropout=DROP_RATE)
_MESH_TOME = dict(tome_r=TOME_R, tome_schedule=TOME_SCHEDULE)
_MESH_F32 = dict(dtype="float32", num_layers=2)
MESH_RUNS = (
    ("bf16", "dense", dict(remat=True, num_layers=MESH_LAYERS, **_MESH_DROP),
     MESH_STEPS),
    ("packed_bf16", "packed",
     dict(remat=True, num_layers=MESH_LAYERS, **_MESH_DROP), 2),
    ("packed_tome_bf16", "packed",
     dict(remat=True, num_layers=MESH_LAYERS, **_MESH_TOME), 2),
    ("int8_bf16", "int8", dict(remat=True, num_layers=MESH_LAYERS), 2),
    ("f32", "dense", dict(remat=True, **_MESH_DROP, **_MESH_F32), 2),
    ("packed_f32", "packed", dict(remat=True, **_MESH_DROP, **_MESH_F32), 2),
    ("packed_tome_f32", "packed", dict(remat=True, **_MESH_TOME, **_MESH_F32),
     2),
    ("int8_f32", "int8", dict(remat=True, **_MESH_F32), 2))
# train_mesh's tensor sizes the JAX rule accepts that cut a head (ROADMAP
# #15), in the same spawn: ViT-S/16 at full width (384 in 6 heads of 64,
# MLP 1536) on 1 x 1 x 4 (96 columns a rank: a head and a half, gathered
# into the two heads they touch) and ViT-Ti/16 at full width (192 in 3
# heads, MLP 768) on 1 x 2 x 2 (3 heads over tensor 2), depth 2, 384 px,
# full remat: the dense step (mixup 0.2), the dense step with both
# dropouts 0.1 and the packed step with both dropouts, in bf16 and f32,
# each within MESH_BF16_TOL / MESH_F32_TOL of this process. (name, path,
# model, steps, (dcn, data, fsdp, tensor)); MESH_RUNS run on MESH_SHAPE.
MESH_SPLIT_RUNS = tuple(
    (f"{v}_{kind}_{dt}", path,
     dict(remat=True, num_layers=2, **width, **extra,
          **({"dtype": "float32"} if dt == "f32" else {})), 2, shape)
    for v, width, shape in (
        ("s16", dict(hidden_size=384, num_heads=6, mlp_dim=1536),
         (1, 1, 1, 4)),
        ("ti16", dict(hidden_size=192, num_heads=3, mlp_dim=768),
         (1, 1, 2, 2)))
    for dt in ("bf16", "f32")
    for kind, path, extra in (("dense", "dense", {}),
                              ("dropout", "dense", _MESH_DROP),
                              ("packed", "packed", _MESH_DROP)))
# - train_mesh, bf16, stated before the run: the ranks run the one-process
#   step's kernels on their heads and rows. What differs is where a row
#   product's K is split over the two tensor ranks: each partial is rounded
#   to bf16, the two are summed in f32 and rounded again, where one process
#   rounds the whole sum once, so each of the 24 row products of a forward
#   may land one bf16 ulp away; and the products run at half the rows,
#   where cuBLAS may pick other algorithms (as in train_dp_split). The loss,
#   a mean of BCE terms of f32 logits, is held to one bf16 ulp of itself a
#   step; the eval logits after the steps to 4 bf16 ulps of the largest
#   (AdamW carries the gradients' sign differences into the weights).
# - packed_bf16 and packed_tome_bf16: the same split on the packed forward
#   (the segment kernels on each rank's six heads at head_base 0 or 6);
#   the loss, a masked mean of BCE terms over the real images, is held to
#   one bf16 ulp of itself a step. Under merging a key mean one ulp away
#   may reorder a near tie of the matching scores; a different merge moves
#   one token pair of one sequence, which shifts the mean over ~30 images'
#   BCE terms by far less than the ulp (0.0039 at a loss of 0.7).
# - int8_bf16: the int8 forward is exact on the split (the column products
#   hold whole channels, the row products sum exact int32 partials while
#   below 2^24, the scales are a max), so the first step's loss differs only
#   by the f32 mean over the slots; the backward is the dense bf16 split
#   above: one bf16 ulp of the loss a step, as the dense run.
# - every f32 run at depth 2 but int8_f32: the same math in another
#   summation order: losses 1e-5 relative, parameters 2e-5 of the largest.
# - int8_f32 (restated after the first card run of this check, which read
#   its second step's loss 3.9e-4 relative and its parameters 1.55e-4 of
#   the largest against the 1e-5 / 2e-5 first stated): the first step's
#   loss 1e-5 relative (the forward is exact on the split, as the reading
#   0.0 shows); after it, the int8 forward is not continuous. The first
#   update moves the weights by a fraction of lr in another summation
#   order; a weight moved across an int8 rounding boundary (or a channel's
#   amax) changes the second forward, its loss moves as the bf16 int8
#   run's does (held to one bf16 ulp of the loss, MESH_BF16_TOL), and the
#   gradients that change sign carry about 2 lr into the weights:
#   INT8_XCHECK's 2.1e-4, the bound train_int8_cross_check holds the
#   card's int8 step to against the CPU's.
MESH_BF16_TOL = {"loss_ulps": 1, "logit_ulps": 4}
MESH_F32_TOL = {"loss_rel": 1e-5, "params_of_largest": 2e-5}
MESH_INT8_F32_TOL = {"first_loss_rel": 1e-5, "loss_ulps": 1,
                     "params_of_largest": INT8_XCHECK["params"]}
# phases 36-37: the examples and the dry run, each in its own processes
EXAMPLES_TIMEOUT_S, DRYRUN_RANKS = 300, 4
# phase 38 (trainer_spawn): a lone Trainer and PackedTrainer given several
# devices start one rank a device (parallel/launch.py); the ranks share
# cuda:0, so the group is gloo. (a) Dense: SPAWN_RANKS ranks on 2 x 1 x 1
# (data -1), SPAWN_STEPS steps at a global batch of SPAWN_BATCH (a fake
# bucket of SPAWN_IMAGES), against the one-process Trainer on the same
# global batch: the ranks run the one-process step's kernels on half the
# rows, where cuBLAS may pick other algorithms and the bf16 activations
# round accordingly, so the loss is held to MESH_BF16_TOL's one bf16 ulp of
# itself a step. (b) Packed: SPAWN_PACKED_RANKS ranks on 1 x 2 x 2 (data
# -1, fsdp 2, tensor 2), SPAWN_PACKED_STEPS steps of SPAWN_PACKED_SEQS
# 1152-token sequences over a variable-resolution bucket of
# SPAWN_PACKED_IMAGES, uninterrupted; then stopped at SPAWN_PACKED_STOP by a
# stop request and resumed by a fresh PackedTrainer: losses and the final
# tree bit for bit the uninterrupted run's. Its depth is cut to
# SPAWN_PACKED_LAYERS of 12 (the script's time aim: three spawns of four
# ranks, each step's collectives staged through the host).
SPAWN_IMAGES, SPAWN_RANKS, SPAWN_BATCH, SPAWN_STEPS = 64, 2, 8, 3
SPAWN_PACKED_IMAGES, SPAWN_PACKED_RANKS, SPAWN_PACKED_SEQS = 200, 4, 8
SPAWN_PACKED_LAYERS, SPAWN_PACKED_STEPS, SPAWN_PACKED_STOP = 4, 4, 2
# the census's decodes, on every rank of every spawn (the runs share it, so
# their epochs agree)
SPAWN_CENSUS = 32
SPAWN_HOLD_S = 120


# the card's name and power limit as nvidia-smi prints them (phase_device):
# every phase's line carries them, and the seconds since the script started
# (``t_s``: where the run's time goes)
CARD = {}
STARTED = time.perf_counter()


def emit(obj: dict) -> None:
    if "phase" in obj and CARD and "nvidia_smi" not in obj:
        obj = {**obj, "nvidia_smi": CARD["nvidia_smi"]}
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - STARTED, 1)}
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


def enqueue_ms(fn) -> float:
    """Host milliseconds to issue one call of ``fn`` on an idle card (the
    call returns before the card is done): where it is near the CUDA-event
    time, the host sets the pace."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    return ms


def time_pair(kernel, plain, plain_reps: int = 3,
              plain_inner: int = 3) -> tuple:
    """(kernel ms, plain ms), measured in turns: plain, kernel, kernel,
    plain. The plain version repeats the kernel's arithmetic in plain
    PyTorch (up to ~100 ms a call in the attention forms) and is no
    yardstick of speed: it is timed over 3 x 3 calls a turn, the kernel
    over 7 x 10."""
    p1 = time_ms(plain, plain_reps, plain_inner)
    k1, k2 = time_ms(kernel), time_ms(kernel)
    p2 = time_ms(plain, plain_reps, plain_inner)
    return (k1 + k2) / 2, (p1 + p2) / 2


def device_ms(fn, calls: int = 10, parts: tuple = ()) -> dict:
    """``device_ms``: mean device milliseconds per call of every kernel
    ``fn`` launches, from a ``torch.profiler`` trace of ``calls`` calls (the
    card's time alone, where CUDA events around the calls also time a host
    that cannot keep up); ``<part>_ms`` for each name fragment in
    ``parts``: the kernels whose name holds it. Late in a long process the
    trace can miss some of a kernel's records (whole calls read 0), so each
    kernel counts at its mean time a record times its launches a call
    (``round(records / calls)``), and a kernel with fewer records than
    half the calls, a stray, not at all; ``device_records`` is the share
    of the expected records the trace held. A trace that held none is
    taken again, twice at most, and then reads None (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {"device_ms": 0.0, **{f"{part}_ms": 0.0 for part in parts}}
        held = expected = 0
        for ev in prof.key_averages():
            per_call = round(ev.count / calls)
            if 2 * ev.count >= calls:  # half the records (round(0.5) is 0)
                per_call = max(per_call, 1)
            if ev.device_time_total <= 0 or per_call < 1:
                continue
            ms = ev.device_time_total / 1e3 / ev.count * per_call
            held += ev.count
            expected += per_call * calls
            out["device_ms"] += ms
            for part in parts:
                if part in ev.key:
                    out[f"{part}_ms"] += ms
        if expected:
            out["device_records"] = held / expected
            return out
    return {"device_ms": None, **{f"{part}_ms": None for part in parts},
            "device_records": 0.0}


def device_or_event_ms(fn) -> tuple:
    """(ms, source) of one call of ``fn``: the profiler's device time
    (source "device"), or, where its trace held no kernel of the call, the
    CUDA-event time of :func:`time_ms` (source "events")."""
    ms = device_ms(fn)["device_ms"]
    return (ms, "device") if ms is not None else (time_ms(fn), "events")


def backward_pass_ms(fn, calls: int = 10) -> dict:
    """``dkdv_ms`` and ``dq_ms``: mean device milliseconds per call of an
    attention backward's dK/dV kernel and dQ kernel (``delta_ms``: its
    pre-pass), and ``device_ms``, all of them."""
    got = device_ms(fn, calls, ("attn_bwd_delta", "attn_bwd_dkdv",
                                "attn_bwd_dq"))
    return {"device_ms": got["device_ms"],
            **{f"{part}_ms": got[f"attn_bwd_{part}_ms"]
               for part in ("delta", "dkdv", "dq")}}


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
                           backward=False, hash_passes=0, d=64) -> dict:
    """The segment kernels' bound counts each input and output once (the
    ids too, once for all heads) and only same-segment products: the sum
    over sequences and segments of len², not S²; d is the real head dim."""
    b, s = seg.shape
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


def library_attention_device_ms(q, k, v, do) -> tuple:
    """(forward, backward) device milliseconds of PyTorch's flash SDPA on
    the operands of :func:`library_attention` (the profiler's time of every
    kernel a call launches)."""
    flash = torch.ops.aten._scaled_dot_product_flash_attention
    flash_bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    o, lse, cq, ck, mq, mk, seed, offset, _ = flash(q, k, v, 0.0)
    return (device_ms(lambda: flash(q, k, v, 0.0))["device_ms"],
            device_ms(lambda: flash_bwd(do, q, k, v, o, lse, cq, ck, mq, mk,
                                        0.0, False, seed,
                                        offset))["device_ms"])


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
                      - 7)


def _wrappers() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from chestxray_vit_tpu_torch.ops import flash_attention as fa
    from chestxray_vit_tpu_torch.ops import hidden_dropout as hd
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
                fa.flash_attention_packed_dropout_bwd,
            "hidden_dropout": hd.hidden_dropout_cuda}


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
    CARD["nvidia_smi"] = smi.splitlines()[0]
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
          "library": path.name, "source_s": dict(kernels.BUILD_SECONDS)})


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


def check_tile_mma(gen) -> None:
    """The tile helpers alone (``tile_mma_selftest.cu``) before any kernel
    that uses them: the bf16 forms (modes 0-2, 64 x 64 x 64; 5-6, the
    16-wide tiles of the forward at kD = 80) within 1e-4 of the f32 matmul
    (bf16 products are exact in f32; only the summation order differs),
    the int8 forms (3-4) equal to the exact integer product, and mode 1
    with the A fragments stored into a tile and read back (7: the wide
    attention backward's hand-over of P and dS), each with B whole and
    with only its first 17 rows."""
    from chestxray_vit_tpu_torch import kernels

    lib, stream = kernels.library(), torch.cuda.current_stream().cuda_stream

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    rec = {"phase": "kernel_check", "kernel": "tile_mma_selftest"}
    for mode in range(8):
        if mode in (3, 4):
            a, b = (torch.randint(-128, 128, (64, 128), generator=gen,
                                  device="cuda", dtype=torch.int8)
                    for _ in range(2))
            c = torch.zeros((64, 64), device="cuda", dtype=torch.int32)
        else:
            a = bf16(64, 16 if mode == 5 else 64)
            b = bf16(64, 16 if mode in (5, 6) else 64)
            c = torch.full((64, 16 if mode == 6 else 64), float("nan"),
                           device="cuda")
        for rows in (64, 17):
            kernels.check(lib.cxr_tile_mma_selftest(
                a.data_ptr(), b.data_ptr(), c.data_ptr(), mode, rows, 0,
                stream), f"tile_mma_selftest mode {mode}")
            torch.cuda.synchronize()
            if mode in (3, 4):
                kb = 128 if mode == 3 else 64
                bz = b.long().cpu()[:, :kb]
                bz[rows:] = 0
                ref = a.long().cpu()[:, :kb] @ bz.t()
                err = int((c.long().cpu() != ref).sum())
                ok = err == 0
            else:
                bz = b.float().clone()
                bz[rows:] = 0
                ref = a.float() @ (bz if mode in (1, 6, 7) else bz.t())
                err = (c - ref).abs().max().item()
                ok = err <= 1e-4
            rec[f"mode{mode}_rows{rows}"] = err
            require(ok, f"tile_mma_selftest mode {mode} rows {rows}: {err}")
    emit(rec)


def phase_kernel_check() -> dict:
    from chestxray_vit_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # the records at head dims other than 64, and at the variants' shapes
    summary = {"head_dims": {}, "variants": {}, "wide": {}}
    emit({"phase": "kernel_check", "warm_up_s": warm_up()})
    check_tile_mma(gen)

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
                # the card's time alone: at 0.04 ms the events also time
                # the host's launches
                rec.update(device_ms(
                    lambda: fa.flash_attention_inference(q, k, v)))
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
    check_hidden_dropout(randn, summary)
    check_merged_lengths(randn, gen)
    check_head_dims(randn, summary)
    check_int8_off8(gen, summary)
    check_int8_patch14(gen, summary)
    check_head_split(randn, summary)
    check_int8_tensor_forms(gen, summary)
    check_variants(randn, gen, summary)
    return summary


def check_merged_lengths(randn, gen) -> None:
    """The kernels of the merged dense path at lengths that token merging
    leaves (MERGED_LENGTHS, no multiple of a tile), batch 36, against their
    plain versions (checked, not timed): the inference, training-forward
    and backward attention, the dropout forward and backward at rate 0.1
    and the debug kernel's mask against the plain counter hash (0
    mismatches), the LayerNorm forward and backward at 36 · S rows, and the
    int8 kernel's residual and GELU-requantize forms at 32 · S rows (equal
    outputs)."""
    from chestxray_vit_tpu_torch.ops import flash_attention as fa
    from chestxray_vit_tpu_torch.ops import int8_matmul as i8
    from chestxray_vit_tpu_torch.ops import layer_norm as ln

    for s in MERGED_LENGTHS:
        for dtype in (torch.bfloat16, torch.float32):
            shape = (TRAIN_BATCH, 12, s, 64)
            tol, gtol = ATTN_TOL[dtype], ATTN_GRAD_TOL[dtype]
            x = randn((TRAIN_BATCH, s, 3, 12, 64), dtype)
            q, k, v = (t.transpose(1, 2) for t in x.unbind(2))
            do = randn(shape, dtype)
            rec = {"phase": "kernel_check", "kernel": "merged_lengths",
                   "shape": list(shape), "dtype": str(dtype), "tol": tol,
                   "rel_tol": gtol}
            rec["inference_err"] = (
                fa.flash_attention_inference(q, k, v).float()
                - fa.attention_reference(q, k, v).float()).abs().max().item()
            o, lse = fa.flash_attention_fwd(q, k, v)
            ro, rlse = fa.attention_fwd_reference(q, k, v)
            rec["fwd_err"] = [(o.float() - ro.float()).abs().max().item(),
                              (lse - rlse).abs().max().item()]
            rec["bwd_rel_err"] = [
                rel_err(g, r) for g, r in zip(
                    fa.flash_attention_bwd(q, k, v, o, lse, do),
                    fa.attention_bwd_reference(q, k, v, o, lse, do))]
            block_q = fa.auto_block_q(s)
            args, kw = (DROP_SEED, DROP_RATE), {"block_q": block_q}
            o, lse = fa.flash_attention_dropout_fwd(q, k, v, *args, **kw)
            ro, rlse = fa.attention_dropout_fwd_reference(q, k, v, *args,
                                                          **kw)
            rec["dropout_fwd_err"] = [
                (o.float() - ro.float()).abs().max().item(),
                (lse - rlse).abs().max().item()]
            rec["dropout_bwd_rel_err"] = [
                rel_err(g, r) for g, r in zip(
                    fa.flash_attention_dropout_bwd(q, k, v, o, lse, do,
                                                   *args, **kw),
                    fa.attention_dropout_bwd_reference(q, k, v, o, lse, do,
                                                       *args, **kw))]
            q_pad, s_pad = fa.mask_strides(s, block_q)
            _, keep = fa.flash_attention_dropout_debug(q, k, v, *args, **kw)
            ref_keep = fa.keep_mask(TRAIN_BATCH * 12, q_pad, s_pad, *args,
                                    device=q.device)[:, :s, :s]
            rec["q_pad_s_pad"] = [q_pad, s_pad]
            rec["mask_mismatches"] = int(
                (keep != ref_keep.reshape(keep.shape)).sum())
            del x, q, k, v, do, o, lse, ro, rlse, keep, ref_keep
            if dtype == torch.bfloat16:
                rows = TRAIN_BATCH * s
                xl, dy = randn((rows, 768), dtype) * 3 + 1, randn((rows, 768),
                                                                  dtype)
                sc, bi = randn((768,), dtype), randn((768,), dtype)
                y, ry = (ln.layer_norm_cuda(xl, sc, bi, 1e-12).float(),
                         ln.layer_norm_reference(xl, sc, bi, 1e-12).float())
                ln_ok = bool(((y - ry).abs() <= bf16_ulp(ry) + LN_F32_TOL)
                             .all())
                got = ln.layer_norm_bwd_cuda(xl, sc, dy, 1e-12)
                refs = ln.layer_norm_bwd_reference(xl, sc, dy, 1e-12)
                ln_ok &= bool(((got[0].float() - refs[0].float()).abs()
                               <= bf16_ulp(refs[0].float()) + LN_F32_TOL)
                              .all())
                for g, r in zip(got[1:], refs[1:]):
                    g, r = g.float(), r.float()
                    ln_ok &= bool(((g - r).abs() <= LN_BWD_REL_TOL
                                   * r.abs().max() + bf16_ulp(r)).all())
                rec["layer_norm_rows"], rec["layer_norm_fwd_bwd_ok"] = (
                    rows, ln_ok)
                int8_mismatched = {}
                for name, _, k_, n_, resid, gelu in INT8_FORMS[2:4]:
                    xq, wq, scale, bias, ikw = int8_operands(
                        gen, INT8_BATCH * s, k_, n_, resid, gelu)
                    int8_mismatched[name] = int(
                        (i8.int8_matmul_fused(xq, wq, scale, bias, **ikw)
                         .float() != i8.int8_matmul_fused_reference(
                             xq, wq, scale, bias, **ikw).float()).sum())
                rec["int8_rows"] = INT8_BATCH * s
                rec["int8_mismatched"] = int8_mismatched
            emit(rec)
            require(rec["inference_err"] <= tol and max(rec["fwd_err"]) <= tol
                    and max(rec["dropout_fwd_err"]) <= tol
                    and max(rec["bwd_rel_err"]) <= gtol
                    and max(rec["dropout_bwd_rel_err"]) <= gtol
                    and rec["mask_mismatches"] == 0
                    and rec.get("layer_norm_fwd_bwd_ok", True)
                    and not any(rec.get("int8_mismatched", {}).values()),
                    f"merged length S={s} {dtype}: {rec}")


def check_layer_norm(randn, summary: dict) -> None:
    """The LayerNorm forward kernel against its plain version at the
    serving rows (8 × 577) in three dtype pairs, and in bf16 at the int8
    serving rows (32 × 577: the summary row) and the training rows (36 ×
    577); times by CUDA events and by the profiler's device time, beside
    ``F.layer_norm``'s."""
    from chestxray_vit_tpu_torch.ops import layer_norm as ln

    cases = [(BATCH * 577, 768, torch.bfloat16, torch.bfloat16),
             (BATCH * 577, 768, torch.bfloat16, torch.float32),
             (BATCH * 577, 768, torch.float32, torch.float32),
             (INT8_BATCH * 577, 768, torch.bfloat16, torch.bfloat16),
             (INT8_BATCH * 577, 768, torch.bfloat16, torch.float32),
             (TRAIN_BATCH * 577, 768, torch.bfloat16, torch.bfloat16),
             *VITH_LN_CASES, *VARIANT_LN_CASES, *WIDE_LN_CASES]
    for rows, d, x_dtype, w_dtype in cases:
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
        variant = (rows, d, x_dtype, w_dtype) in VARIANT_LN_CASES
        wide = (rows, d, x_dtype, w_dtype) in WIDE_LN_CASES
        if x_dtype == torch.bfloat16 or d == VITH_HIDDEN or variant or wide:
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
        if d == VITH_HIDDEN:
            summary["head_dims"].setdefault("layer_norm", []).append(rec)
        if variant:
            summary["variants"].setdefault("layer_norm", []).append(rec)
        if wide:
            summary["wide"].setdefault("layer_norm", []).append(rec)
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
# Its call forms in the b36 int8 straight-through train forward
# (models/int8_train.py): no residual, GELU or requantize, bf16 out; q, k,
# v and wo share one form.
INT8_TRAIN_FORMS = (
    ("train_patch_embed", TRAIN_BATCH * 576, 768, 768, False, False),
    ("train_qkv_wo", TRAIN_BATCH * 577, 768, 768, False, False),
    ("train_mlp_in", TRAIN_BATCH * 577, 768, 3072, False, False),
    ("train_mlp_out", TRAIN_BATCH * 577, 3072, 768, False, False))


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
    shapes, in the call forms of the fused route (INT8_FORMS), and at the
    b36 training shapes in the call forms of the int8 train forward
    (INT8_TRAIN_FORMS): outputs equal, int8 included; times by CUDA events
    and by the profiler's device time beside ``torch._int_mm``'s (the int32
    product alone, on the same operands). The serving mlp_in form is the
    summary row."""
    for form in INT8_FORMS + INT8_TRAIN_FORMS:
        rec = int8_form_check(gen, *form)
        if form[-1]:
            summary["int8_matmul_fused"] = rec


def int8_form_check(gen, name: str, m: int, k: int, n: int,
                    with_resid: bool, gelu: bool) -> dict:
    """One call form of the int8 kernel against its plain version (every
    output equal, twice the same bits), timed by CUDA events and by the
    profiler's device time beside ``torch._int_mm``; its record."""
    from chestxray_vit_tpu_torch.ops import int8_matmul as i8

    xq, wq, scale, bias, kw = int8_operands(gen, m, k, n, with_resid, gelu)
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
        lambda: i8.int8_matmul_fused_reference(xq, wq, scale, bias, **kw))
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
           **({"earlier_ms": EARLIER_INT8_MS[name][0],
               "earlier_device_ms": EARLIER_INT8_MS[name][1]}
              if name in EARLIER_INT8_MS else {}),
           # torch._int_mm takes K and N multiples of 8 only
           "library_ms": time_ms(lambda: torch._int_mm(xq, wt))
           if k % 8 == 0 and n % 8 == 0 else None,
           "library_device_ms": device_ms(
               lambda: torch._int_mm(xq, wt))["device_ms"]
           if k % 8 == 0 and n % 8 == 0 else None,
           "tops": 2 * m * k * n / ms / 1e9,
           **bound(m * k + n * k + 8 * n + 2 * m * n * with_resid
                   + out_bytes, 2 * m * k * n, torch.int8,
                   core_ops=ops * m * n)}
    emit(rec)
    require(bool(torch.isfinite(out.float()).all()) and flips == 0
            and equal_twice,
            f"int8_matmul_fused {name}: {flips} mismatched, max "
            f"{diff.max().item()}, equal twice {equal_twice}")
    return rec


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
    the scale share a dtype or x is bf16 (the library then takes the scale
    in bf16: it takes one dtype), and the kernel's time before its redesign
    (EARLIER_LN_BWD_MS)."""
    from chestxray_vit_tpu_torch.ops import layer_norm as ln

    cases = [(TRAIN_BATCH * 577, 768, torch.bfloat16, torch.bfloat16),
             (TRAIN_BATCH * 577, 768, torch.bfloat16, torch.float32),
             (TRAIN_BATCH * 577, 768, torch.float32, torch.float32),
             (PACKED_SEQS * 1152, 768, torch.bfloat16, torch.bfloat16),
             (PACKED_SEQS * 1152, 768, torch.bfloat16, torch.float32),
             (BATCH * 577 - 1, 768, torch.bfloat16, torch.bfloat16),
             *VITH_LN_CASES, *VARIANT_LN_CASES, *WIDE_LN_CASES]
    for rows, d, x_dtype, w_dtype in cases:
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
        if x_dtype == w_dtype or x_dtype == torch.bfloat16:
            # the library's backward takes the forward's statistics; for an
            # f32 scale with bf16 x it takes the scale cast to bf16, so its
            # dscale / dbias come out in bf16, not the kernel's f32
            ls = scale.to(x_dtype)
            _, mean, rstd = torch.ops.aten.native_layer_norm(
                x, [d], ls, torch.zeros_like(ls), 1e-12)

            def library():
                return torch.ops.aten.native_layer_norm_backward(
                    dy, x, [d], mean, rstd, ls, ls, [True] * 3)
            rec["library_ms"] = time_ms(library)
            rec["library_device_ms"] = device_ms(library)["device_ms"]
            rec["library_scale_dtype"] = str(ls.dtype)
        earlier = EARLIER_LN_BWD_MS.get((rows, str(w_dtype)))
        if x_dtype == torch.bfloat16 and earlier is not None:
            rec["earlier_ms"], rec["earlier_device_ms"] = earlier
        if (rows == TRAIN_BATCH * 577
                and x_dtype == w_dtype == torch.bfloat16):
            summary["layer_norm_bwd"] = rec
        if d == VITH_HIDDEN:
            summary["head_dims"].setdefault("layer_norm_bwd", []).append(rec)
        if (rows, d, x_dtype, w_dtype) in VARIANT_LN_CASES:
            summary["variants"].setdefault("layer_norm_bwd", []).append(rec)
        if (rows, d, x_dtype, w_dtype) in WIDE_LN_CASES:
            summary["wide"].setdefault("layer_norm_bwd", []).append(rec)
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
        # a rank's row base: the debug kernel's mask at global batch row
        # ROW_BASE_PROBE (far enough out that the uint32 counter wraps)
        _, keep_b = fa.flash_attention_dropout_debug(
            q, k, v, *args, **kw, row_base=ROW_BASE_PROBE)
        ref_keep = fa.keep_mask(TRAIN_BATCH * 12, q_pad, s_pad, *args,
                                device=q.device,
                                bh_base=ROW_BASE_PROBE * 12)[:, :s, :s]
        base_mismatches = int((keep_b != ref_keep.reshape(keep_b.shape))
                              .sum())
        del ref_keep, keep_b
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
                 "row_base": ROW_BASE_PROBE,
                 "row_base_mask_mismatches": base_mismatches,
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
        # the split: the second half of the batch with its row base equals
        # the second half of the whole call, forward and backward
        h = TRAIN_BATCH // 2
        o_h, lse_h = fa.flash_attention_dropout_fwd(q[h:], k[h:], v[h:],
                                                    *args, **kw, row_base=h)
        grads_h = fa.flash_attention_dropout_bwd(
            q[h:], k[h:], v[h:], o[h:], lse[h:], do[h:], *args, **kw,
            row_base=h)
        split_equal = (torch.equal(o_h, o[h:]) and torch.equal(lse_h, lse[h:])
                       and all(torch.equal(a, b[h:])
                               for a, b in zip(grads_h, grads)))
        del grads, refs, again, grads_h, o_h, lse_h
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
                 "split_at_row_base_equal": split_equal,
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
        require(mismatches == 0 and base_mismatches == 0,
                f"dropout mask {dtype}: {mismatches} mismatches, "
                f"{base_mismatches} at row base {ROW_BASE_PROBE}")
        require(split_equal, f"dropout fwd/bwd {dtype}: rows {h}-"
                             f"{TRAIN_BATCH - 1} at row base {h} equal the "
                             f"whole call's, bit for bit")
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
                split_equal = None
                if rate and layout == "two_segments":
                    # the second half of the sequences at their row base
                    # equals the whole call's second half, bit for bit
                    h = batch // 2
                    o_h, lse_h = fwd(q[h:], k[h:], v[h:], seg[h:], *extra, h)
                    grads_h = bwd(q[h:], k[h:], v[h:], seg[h:], o[h:],
                                  lse[h:], do[h:], *extra, h)
                    split_equal = (
                        torch.equal(o_h, o[h:]) and torch.equal(lse_h, lse[h:])
                        and all(torch.equal(a, b[h:])
                                for a, b in zip(grads_h, grads)))
                    del o_h, lse_h, grads_h
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
                       "split_at_row_base_equal": split_equal,
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
                require(split_equal is not False,
                        f"{fwd.__name__} {layout} {dtype}: the second half "
                        f"at its row base differs from the whole call's")


def hidden_dropout_bound(shape, dtype) -> dict:
    """The hidden-dropout kernel reads x and writes y once; per element the
    hash (HASH_OPS integer operations) and one f32 divide."""
    n = int(np.prod(shape))
    e = torch.empty((), dtype=dtype).element_size()
    return bound(2 * n * e, 0, dtype, core_ops=n, int_ops=HASH_OPS * n)


def check_hidden_dropout(randn, summary: dict) -> None:
    """The hidden-dropout kernel at the b36 step's sites ([36 · 577, 768] as
    [36, 577, 768]), bf16 and f32, rate 0.1, at a row base: forward and
    backward (the same kernel on the upstream gradient, through the
    autograd function) equal the plain version bit for bit, twice; the
    second half of the batch at its row base equals the whole call's
    second half; times beside ``F.dropout`` (the same work on another mask
    stream) and the bound."""
    from chestxray_vit_tpu_torch.ops import hidden_dropout as hd

    shape = (TRAIN_BATCH, 577, 768)
    seed, base = 1234567, ROW_BASE_PROBE
    for dtype in (torch.bfloat16, torch.float32):
        x, dy = randn(shape, dtype), randn(shape, dtype)
        y = hd.hidden_dropout_cuda(x, seed, DROP_RATE, base)
        ref = hd.hidden_dropout_reference(x, seed, DROP_RATE, base)
        err = (y.float() - ref.float()).abs().max().item()
        fwd_equal = torch.equal(y, ref) and torch.equal(
            hd.hidden_dropout_cuda(x, seed, DROP_RATE, base), y)
        keep_share = (ref != 0).float().mean().item()
        del ref
        xg = x.detach().requires_grad_()
        hd.hidden_dropout(xg, seed, DROP_RATE, base).backward(dy)
        bwd_equal = torch.equal(
            xg.grad, hd.hidden_dropout_reference(dy, seed, DROP_RATE, base))
        h = TRAIN_BATCH // 2
        split_equal = torch.equal(
            hd.hidden_dropout_cuda(x[h:], seed, DROP_RATE, base + h), y[h:])
        del xg
        torch.cuda.synchronize()
        ms, plain_ms = time_pair(
            lambda: hd.hidden_dropout_cuda(x, seed, DROP_RATE, base),
            lambda: hd.hidden_dropout_reference(x, seed, DROP_RATE, base))
        rec = {"phase": "kernel_check", "kernel": "hidden_dropout",
               "shape": list(shape), "dtype": str(dtype), "rate": DROP_RATE,
               "row_base": base, "fwd_equal": fwd_equal,
               "bwd_equal": bwd_equal, "split_at_row_base_equal": split_equal,
               "keep_share": keep_share,
               "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms,
               **device_ms(lambda: hd.hidden_dropout_cuda(x, seed, DROP_RATE,
                                                          base)),
               **hidden_dropout_bound(shape, dtype)}
        rec["library_ms"] = time_ms(lambda: torch.nn.functional.dropout(
            x, DROP_RATE, training=True))
        # x (32 or 64 MB) stays in the 50 MB L2 between back-to-back calls;
        # a step's call finds it colder: the kernel alone after a write of
        # 128 MB
        flush = torch.empty(2 ** 25, dtype=torch.float32, device=x.device)
        rec["cold_l2_device_ms"] = device_ms(
            lambda: (flush.zero_(), hd.hidden_dropout_cuda(
                x, seed, DROP_RATE, base)),
            parts=("hidden_dropout",))["hidden_dropout_ms"]
        del flush
        emit(rec)
        if dtype == torch.bfloat16:
            summary["hidden_dropout"] = rec
        del x, dy, y
        torch.cuda.empty_cache()
        require(fwd_equal and bwd_equal and split_equal,
                f"hidden dropout {dtype}: forward {fwd_equal}, backward "
                f"{bwd_equal}, split {split_equal}")
        require(abs(keep_share - (1 - DROP_RATE)) < 1e-3,
                f"hidden dropout keep share {keep_share}")


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


def serve_burst(pred, images: list, with_maps: bool = False) -> tuple:
    """Every image submitted to a MicroBatcher over ``pred`` from
    CLIENT_THREADS threads at once (with ``with_maps``, as maps
    requests), with the launch counts and the Predictor's forward count
    set to 0 just before: (results, submit times, done times,
    launches)."""
    import chestxray_vit_tpu_torch as cxr

    batcher = cxr.MicroBatcher(pred)
    submitted = [0.0] * len(images)
    done = [0.0] * len(images)
    futures = [None] * len(images)

    def client(idx):
        for i in idx:
            submitted[i] = time.perf_counter()
            fut = batcher.submit(images[i], with_maps=with_maps)
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


def phase_serving(params, cfg, images: list, phase: str = "serving",
                  batch_size: int = BATCH):
    import chestxray_vit_tpu_torch as cxr

    t0 = time.perf_counter()
    pred = cxr.Predictor(params, cfg, batch_size=batch_size,
                         placement="device", device="cuda")
    pred.warmup()
    warm_s = time.perf_counter() - t0
    # the counts cover exactly the main path's run
    results, submitted, done, launches = serve_burst(pred, images)
    rec = {**burst_record(phase, pred, images, results, submitted, done,
                          cfg),
           "attention_launches": launches["flash_attention_inference"],
           "layer_norm_launches": launches["layer_norm"], "warmup_s": warm_s}
    emit(rec)
    require_forward_launches(phase, launches, pred.forwards, cfg,
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


def phase_serving_int8(params, cfg, images: list,
                       phase: str = "serving_int8"):
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
    rec = {**burst_record(phase, pred, images, results, submitted,
                          done, cfg),
           "quantize": "static", "launches": launches, "warmup_s": warm_s}
    require_forward_launches(phase, launches, pred.forwards, cfg,
                             int8=True)

    dense = cxr.Predictor(params, cfg, batch_size=INT8_BATCH,
                          placement="device", device="cuda")
    dense.warmup()
    d_res, d_sub, d_done, _ = serve_burst(dense, images)
    d_rec = burst_record(f"{phase}_dense_b32", dense, images, d_res, d_sub,
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
    return qp, imgs, fused_logits, launches, rec


def phase_int8_cross_check(params, cfg, qp, imgs, fused_logits,
                           phase: str = "int8_cross_check") -> None:
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

    rec = {"phase": phase, "images": INT8_BATCH,
           "cpu_images": pick, "tol": INT8_ROUTE_TOL,
           "min_corr": INT8_ROUTE_MIN_CORR,
           "noise_std": NOISE_STD,
           "noise_sensitivity": (out["f32"][0] - nudged).abs().max().item()}
    for dt, (card, cpu, xla) in out.items():
        require(bool(torch.isfinite(card).all()) and card.shape == (
            len(imgs), cfg.num_classes), f"finite {dt} int8 logits [32, 15]")
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


def hidden_launches_per_step(n_layers: int, policy: Optional[str]) -> int:
    """The hidden-dropout kernel a step: two sites a block, each once in
    the forward and once in the backward, and the first again where the
    backward recomputes the block (``full``, ``flash_out``, ``dots``; the
    saved-tensor policies rebuild only their named values). The recompute
    stops at the last tensor the backward needs, which comes before the
    block's closing dropout: that one saves nothing."""
    recompute = 1 if policy in ("full", "flash_out", "dots") else 0
    return (4 + recompute) * n_layers


def dense_launches_per_step(n_layers: int, dropout: bool,
                            policy: str = "full",
                            hidden: Optional[bool] = None) -> dict:
    """Launches per dense train step under a remat policy (None: no
    remat), merging or not: every block's attention forward twice where
    the backward recomputes it (``full``, ``dots``), once where o and lse
    are kept; its backward once; every LayerNorm forward once, and again
    but the final one where the block is checkpointed (``full``,
    ``flash_out``, ``dots``); every LayerNorm backward once; with
    ``hidden`` (by default ``dropout``: both dropouts on) the hidden-dropout
    kernel (:func:`hidden_launches_per_step`); no other kernel."""
    name = "flash_attention_dropout" if dropout else "flash_attention"
    attn = 2 if policy in ("full", "dots") else 1
    ln = 2 if policy in ("full", "flash_out", "dots") else 1
    hidden = dropout if hidden is None else hidden
    return {**dict.fromkeys(_wrappers(), 0),
            f"{name}_fwd": attn * n_layers, f"{name}_bwd": n_layers,
            "layer_norm": ln * (2 * n_layers + 1) - (ln - 1),
            "layer_norm_bwd": 2 * n_layers + 1,
            "hidden_dropout": (hidden_launches_per_step(n_layers, policy)
                               if hidden else 0)}


def record_merges(fn) -> tuple:
    """(``fn()``, one entry per merge the merging forwards made in it:
    (the token count entering the merge, which is the length the layer's
    attention ran at; each A token's destination in the B set, int64 [B,
    |A|] on the host, −1 where it is kept, None where the clamp left no
    merge)). Records around ``ops.tome.tome_merge_clamped`` in the two
    modules that call it; the matching is recomputed on the same inputs."""
    from chestxray_vit_tpu_torch.models import quantized, tome_forward
    from chestxray_vit_tpu_torch.ops import tome

    seen, merge = [], tome.tome_merge_clamped

    def recording(x, metric, sizes, r):
        s, r_l = x.shape[1], min(r, (x.shape[1] + 1) // 2 - 1)
        dest = None
        if r_l > 0:
            _, src, dst = tome.bipartite_soft_matching(metric, r_l)
            dest = torch.full((x.shape[0], (s + 1) // 2), -1,
                              dtype=torch.int64, device=x.device
                              ).scatter_(1, src, dst).cpu()
        seen.append((s, dest))
        return merge(x, metric, sizes, r)

    tome_forward.tome_merge_clamped = recording
    quantized.tome_merge_clamped = recording
    try:
        out = fn()
    finally:
        tome_forward.tome_merge_clamped = merge
        quantized.tome_merge_clamped = merge
    return out, seen


def merges_differing(a: list, b: list) -> list:
    """Per recorded merge of two runs: how many A tokens went elsewhere."""
    require([s for s, _ in a] == [s for s, _ in b],
            f"the same lengths: {[s for s, _ in a]} {[s for s, _ in b]}")
    return [0 if da is None else int((da != db).sum())
            for (_, da), (_, db) in zip(a, b)]


def phase_train():
    """bench.py's train step on the card: ViT-B/16 @384, bf16, full remat,
    batch 36, TrainConfig defaults, over 10,000 scheduled steps."""
    from chestxray_vit_tpu_torch.models.vit import init_params
    from chestxray_vit_tpu_torch.train import steps

    dev = torch.device("cuda")
    cfg = train_config(remat=True)
    per_step = dense_launches_per_step(cfg.model.num_layers, dropout=False)
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
    return params, cfg, launches, rec


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
    per_step = dense_launches_per_step(cfg.model.num_layers, dropout=True)
    batch = bench_batch(TRAIN_BATCH, SEED, dev)
    params = init_params(torch.Generator().manual_seed(SEED), cfg.model, dev)
    state = steps.TrainState.create(params, seed=42)
    train_step = steps.make_train_step(cfg, total_steps=10_000)

    run = run_steps(train_step, state, batch, DROPOUT_WARMUP_STEPS,
                    DROPOUT_TIMED_STEPS)
    losses, norms, step_counts, launches = (
        run["losses"], run["grad_norms"], run["step_counts"],
        run["launches"])
    # the card's time a step (profiler, 2 steps after one), and the
    # hidden-dropout kernel's share of it
    prof = device_ms(lambda: train_step(state, batch), calls=2,
                     parts=("hidden_dropout",))
    rec = {"phase": "train_dropout", "batch": TRAIN_BATCH, "remat": "full",
           "device_ms_per_step": prof["device_ms"],
           "hidden_dropout_device_ms_per_step": prof["hidden_dropout_ms"],
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


def phase_train_dp_split() -> dict:
    """Data parallelism with both dropouts and mixup, on the one card: the
    b36 step (ViT-B/16 @384, bf16, f32 masters, full remat, attention and
    hidden dropout 0.1, mixup 0.2, accumulation DP_ACCUM) over the global
    batch at a world of one, then as DP_WORLD ranks of 18 emulated in this
    process, each built with its rank (so its row base and its slice of
    λ) and given its mixup neighbour (``steps.mixup_neighbours`` of the
    previous rank's batch), their gradients combined as the all-reduce
    combines them. Loss and gradients within DP_SPLIT tolerances, each
    rank launching what the global step launches; then merged (``tome_r``
    16), on the int8 straight-through forward, and the packed step (32 ×
    1152 mixed-resolution sequences, the two dropouts). The keep masks of
    micro-batch 0's first layer, bit for bit: each rank's draws and the
    dropout kernels' masks at its row base against the global ones.
    Returns the launches (the global steps and the ranks', every count set
    to 0 just before)."""
    import copy

    from chestxray_vit_tpu_torch.models.vit import init_params
    from chestxray_vit_tpu_torch.ops import flash_attention as fa
    from chestxray_vit_tpu_torch.ops import hidden_dropout as hd
    from chestxray_vit_tpu_torch.train import steps

    dev = torch.device("cuda")
    drop = {"attention_dropout": DROP_RATE, "hidden_dropout": DROP_RATE}
    keys = ("tokens", "segment_ids", "pos_indices", "pool_weights", "labels",
            "image_mask")
    reset_launch_counts()
    for variant in ("dense", "tome", "int8", "packed"):
        packed = variant == "packed"
        model = dict(remat=True, **drop)
        if variant == "tome":
            model.update(tome_r=TOME_STEPS[0][0],
                         tome_schedule=TOME_STEPS[0][1])
        cfg = train_config(0.0 if packed else MIXUP_ALPHA, **model)
        cfg.train.gradient_accumulation_steps = DP_ACCUM
        if packed:
            mixed = packed_mixed_batch("cuda")
            batch = {k: mixed[k] for k in keys}
        else:
            batch = bench_batch(TRAIN_BATCH, SEED, dev)
        n = next(iter(batch.values())).shape[0]
        half = n // DP_WORLD
        halves = [{k: v[r * half:(r + 1) * half] for k, v in batch.items()}
                  for r in range(DP_WORLD)]
        params0 = init_params(torch.Generator().manual_seed(SEED), cfg.model,
                              dev)
        scales = (calibrated_scales(params0, cfg, batch)
                  if variant == "int8" else None)

        def run(rank, world, data, **kw):
            params = copy.deepcopy(params0)
            if packed:
                step = steps.make_packed_train_step(cfg, 10_000, rank=rank,
                                                    world=world)
            else:
                step = steps.make_train_step(cfg, 10_000, int8_scales=scales,
                                             rank=rank, world=world)
            before = launch_counts()
            _, m = step(steps.TrainState.create(params, seed=42), data, **kw)
            torch.cuda.synchronize()
            after = launch_counts()
            return (m["loss"].item(),
                    {k: p.grad for k, p in params.named_parameters()},
                    {k: after[k] - before[k] for k in after})

        want_loss, want, want_launches = run(0, 1, batch)
        parts = []
        for r in range(DP_WORLD):
            kw = {} if packed else {"neighbours": steps.mixup_neighbours(
                cfg, halves[(r - 1) % DP_WORLD])}
            parts.append(run(r, DP_WORLD, halves[r], **kw))
        if packed:       # the all-reduce sums Σnum and Σden over the ranks
            dens = [float(h["image_mask"].sum()) for h in halves]
            w = [d / sum(dens) for d in dens]
        else:            # the dense mean over equal slices
            w = [1.0 / DP_WORLD] * DP_WORLD
        loss = sum(wi * lo for wi, (lo, _, _) in zip(w, parts))
        scale = max(g.abs().max().item() for g in want.values())
        grad_rel = max((sum(wi * gr[k] for wi, (_, gr, _) in zip(w, parts))
                        - g).abs().max().item()
                       for k, g in want.items()) / scale
        rec = {"phase": "train_dp_split", "variant": variant,
               "global_batch": n, "world": DP_WORLD, "accum": DP_ACCUM,
               "dtype": cfg.model.dtype, "remat": "full", **drop,
               "mixup_alpha": cfg.data.mixup_alpha,
               "tome_r": cfg.model.tome_r, "global_loss": want_loss,
               "rank_losses": [lo for lo, _, _ in parts],
               "loss_diff": abs(loss - want_loss), "grad_rel_diff": grad_rel,
               "tol": [REMAT_LOSS_TOL, REMAT_GRAD_TOL],
               "launches_per_step": want_launches,
               "ranks_launch_as_global": all(
                   c == want_launches for _, _, c in parts)}
        emit(rec)
        del parts, want, params0
        torch.cuda.empty_cache()
        require(np.isfinite(want_loss) and rec["loss_diff"] <= REMAT_LOSS_TOL
                and grad_rel <= REMAT_GRAD_TOL,
                f"train_dp_split {variant}: loss {rec['loss_diff']}, "
                f"grads {grad_rel}")
        require(rec["ranks_launch_as_global"] and all(
            want_launches[k] > 0 for k in ("hidden_dropout",
                                           "layer_norm_bwd")),
                f"train_dp_split {variant}: launches {want_launches}")
    launches = launch_counts()

    # the keep masks of micro-batch 0's first layer: each rank's draws are
    # the global draws at its row base, and the kernels' masks there are
    # the global masks' rows
    cfg = train_config(MIXUP_ALPHA, remat=True, **drop)
    cfg.train.gradient_accumulation_steps = DP_ACCUM
    micro = TRAIN_BATCH // DP_ACCUM
    m = micro // DP_WORLD
    glob = steps.draw(torch.Generator().manual_seed(42), cfg, micro)
    ranks = [steps.draw(torch.Generator().manual_seed(42), cfg, m, r,
                        DP_WORLD) for r in range(DP_WORLD)]
    draws_ok = all(d.seeds == glob.seeds and d.row_base == r * m
                   and np.array_equal(d.lam, glob.lam[r * m:(r + 1) * m])
                   for r, d in enumerate(ranks))
    attn_seed, hidden_seed, _ = glob.seeds[0]
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    q, k, v = (torch.randn((micro, 12, 577, 64), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    bq = fa.auto_block_q(577)
    _, keep = fa.flash_attention_dropout_debug(q, k, v, attn_seed, DROP_RATE,
                                               block_q=bq)
    ones = torch.ones((micro, 577, 768), dtype=torch.bfloat16, device=dev)
    hidden = hd.hidden_dropout_cuda(ones, hidden_seed, DROP_RATE)
    masks_ok = True
    for r, d in enumerate(ranks):
        sl = slice(r * m, (r + 1) * m)
        _, keep_r = fa.flash_attention_dropout_debug(
            q[sl], k[sl], v[sl], attn_seed, DROP_RATE, block_q=bq,
            row_base=d.row_base)
        masks_ok &= torch.equal(keep_r, keep[sl]) and torch.equal(
            hd.hidden_dropout_cuda(ones[sl], hidden_seed, DROP_RATE,
                                   d.row_base), hidden[sl])
    torch.cuda.synchronize()
    emit({"phase": "train_dp_split_masks", "micro_batch": micro,
          "rank_rows": m, "row_bases": [d.row_base for d in ranks],
          "draws_equal": draws_ok, "keep_masks_equal": masks_ok})
    require(draws_ok and masks_ok,
            f"train_dp_split: draws {draws_ok}, masks {masks_ok}")
    del q, k, v, keep, ones, hidden
    torch.cuda.empty_cache()
    return launches


def phase_train_cross_check(phase: str = "train_cross_check",
                            mixup_alpha: float = 0.0,
                            dtypes: tuple = ("f32", "bf16"),
                            img_size: int = 384,
                            params_tol: float = XCHECK_F32["params"],
                            **model) -> None:
    """One train step at full width, depth 2, batch 2: the card in f32 and
    in bf16 against the CPU in f32 (plain versions), same weights and the
    same draws (dropout seeds, mixup λ) injected on both sides. With
    ``tome_r`` also the merges of every layer (forward and recompute)
    that differ from the CPU's: none in f32."""
    import dataclasses

    from chestxray_vit_tpu_torch.models import bridge
    from chestxray_vit_tpu_torch.models.vit import init_params
    from chestxray_vit_tpu_torch.train import steps

    cfg32 = train_config(mixup_alpha, num_layers=2, dtype="float32",
                         img_size=img_size, **model)
    cfg16 = dataclasses.replace(cfg32, model=dataclasses.replace(
        cfg32.model, dtype="bfloat16"))
    cpu_params = init_params(torch.Generator().manual_seed(SEED), cfg32.model)
    tree = bridge.params_to_numpy(cpu_params)
    batch = bench_batch(2, SEED + 1, "cpu", img_size)
    draws = [steps.draw(torch.Generator().manual_seed(SEED), cfg32, 2)]

    def run(cfg, params, device):
        dev_batch = {k: v.to(device) for k, v in batch.items()}
        (state, m), merges = record_merges(
            lambda: steps.make_train_step(cfg, total_steps=10_000)(
                steps.TrainState.create(params, seed=0), dev_batch, draws))
        return ({k: v.item() for k, v in m.items()},
                _leaves(bridge.grads_to_numpy(state.params)),
                _leaves(bridge.params_to_numpy(state.params)), merges)

    cpu_m, cpu_g, cpu_p, cpu_merges = run(cfg32, cpu_params, "cpu")
    g_scale = max(float(np.abs(g).max()) for g in cpu_g)
    rec = {"phase": phase, "depth": 2, "batch": 2, "model": model,
           "mixup_alpha": mixup_alpha, "cpu_f32_loss": cpu_m["loss"],
           "tol_f32": XCHECK_F32, "tol_bf16": XCHECK_BF16}
    if cpu_merges:
        rec["merge_lengths"] = [n for n, _ in cpu_merges]
    for name, cfg in (("f32", cfg32), ("bf16", cfg16)):
        if name not in dtypes:
            continue
        card = bridge.params_from_jax(tree, cfg.model).to("cuda")
        m, g, p, merges = run(cfg, card, "cuda")
        if cpu_merges:
            rec[f"card_{name}_merges_differing"] = merges_differing(
                merges, cpu_merges)
        rec[f"card_{name}_loss_diff"] = abs(m["loss"] - cpu_m["loss"])
        rec[f"card_{name}_grad_norm_rel_diff"] = (
            abs(m["grad_norm"] - cpu_m["grad_norm"]) / cpu_m["grad_norm"])
        rec[f"card_{name}_grads_rel_diff"] = max(
            float(np.abs(a - b).max()) for a, b in zip(g, cpu_g)) / g_scale
        rec[f"card_{name}_params_max_abs_diff"] = max(
            float(np.abs(a - b).max()) for a, b in zip(p, cpu_p))
    rec["params_tol_f32"] = params_tol
    emit(rec)
    for key, tol in (("loss_diff", XCHECK_F32["loss"]),
                     ("grad_norm_rel_diff", XCHECK_F32["grad_norm_rel"]),
                     ("grads_rel_diff", XCHECK_F32["grads_rel"]),
                     ("params_max_abs_diff", params_tol)):
        require(rec[f"card_f32_{key}"] <= tol, f"f32 {key}: {rec}")
    require(not any(rec.get("card_f32_merges_differing", [])),
            f"f32 merges as on the CPU: {rec}")
    if "bf16" in dtypes:
        for key, tol in (("loss_diff", XCHECK_BF16["loss"]),
                         ("grads_rel_diff", XCHECK_BF16["grads_rel"]),
                         ("params_max_abs_diff", XCHECK_BF16["params"])):
            require(rec[f"card_bf16_{key}"] <= tol, f"bf16 {key}: {rec}")


def packed_launches_per_step(n_layers: int, dropout: bool,
                             hidden: Optional[bool] = None) -> dict:
    """Full remat: every block's attention forward runs twice, its backward
    once; LayerNorm as in the dense step; with ``hidden`` (by default
    ``dropout``) the hidden-dropout kernel as in the dense step; no dense
    attention kernel."""
    name = "flash_attention_packed_dropout" if dropout \
        else "flash_attention_packed"
    hidden = dropout if hidden is None else hidden
    return {**dict.fromkeys(_wrappers(), 0),
            f"{name}_fwd": 2 * n_layers, f"{name}_bwd": n_layers,
            "layer_norm": 2 * (2 * n_layers + 1) - 1,
            "layer_norm_bwd": 2 * n_layers + 1,
            "hidden_dropout": (hidden_launches_per_step(n_layers, "full")
                               if hidden else 0)}


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
    per_step = packed_launches_per_step(cfg.model.num_layers, dropout,
                                        cfg.model.hidden_dropout > 0.0)
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
    576 + 576), attention and hidden dropout 0.1 on injected seeds (the
    counter-hash masks are equal on both), without and with token
    merging."""
    from chestxray_vit_tpu_torch.models import bridge
    from chestxray_vit_tpu_torch.models.vit import init_params
    from chestxray_vit_tpu_torch.train import steps

    batch = packed_batch([512, 384, 384], np.random.default_rng(SEED + 2),
                         "cpu")
    for tome_r in (0, TOME_R):
        cfg = train_config(num_layers=2, dtype="float32", remat=True,
                           attention_dropout=DROP_RATE,
                           hidden_dropout=DROP_RATE, tome_r=tome_r,
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


def phase_eval_accel(params, cfg, phase: str = "eval_int8",
                     quantized: bool = True, tome_r: int = 0) -> dict:
    """The serving-accelerated eval step (``make_inference_eval_step``)
    over the eval batches of 8: int8 on a static tree of ``params``
    (calibrated on the first eval batch) and / or token merging. Finite
    logits, row losses against the host's, exact launch counts (12
    attention and 25 LayerNorm per batch, 73 int8 on a static tree,
    nothing else)."""
    from chestxray_vit_tpu_torch.models import quantized as qmod
    from chestxray_vit_tpu_torch.train import steps

    dev = torch.device("cuda")
    batches = [bench_batch(TRAIN_BATCH, SEED + 10 + i, dev)
               for i in range(EVAL_BATCHES)]
    tree = params
    if quantized:
        tree = qmod.quantize_vit_params(
            params, qmod.calibrate_vit_scales(
                params, batches[0]["pixel_values"], cfg.model))
    eval_step = steps.make_inference_eval_step(cfg, quantized=quantized,
                                               tome_r=tome_r)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = [eval_step(tree, b) for b in batches]
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
    rec = {"phase": phase, "batches": EVAL_BATCHES, "batch": TRAIN_BATCH,
           "quantized": quantized, "tome_r": tome_r,
           "tome_schedule": cfg.model.tome_schedule,
           "logits_shape": list(logits.shape),
           "finite": bool(torch.isfinite(logits).all()),
           "row_loss_max_abs_err": row_err, "ms_per_batch":
               1e3 * wall / EVAL_BATCHES, "launches": launches}
    if tome_r:
        with torch.no_grad():
            _, seen = record_merges(lambda: eval_step(tree, batches[0]))
        rec["attention_lengths"] = [n for n, _ in seen]
    emit(rec)
    require(rec["finite"] and logits.shape == (EVAL_BATCHES * TRAIN_BATCH,
                                               15),
            f"{phase}: finite logits of the expected shape")
    require(row_err <= 1e-4, f"{phase}: row losses vs host: {row_err}")
    require_forward_launches(phase, launches, EVAL_BATCHES, cfg.model,
                             int8=quantized)
    if tome_r:
        require(rec["attention_lengths"] == list(TOME_LENGTHS[
            (tome_r, cfg.model.tome_schedule)]),
            f"{phase}: attention lengths {rec['attention_lengths']}")
    return launches


def phase_train_tome(dense_rec: dict):
    """bench.py's two merged steps (tome_r 16 constant, 32 decreasing):
    ViT-B/16 @384, bf16, full remat, batch 36, seed-0 weights, bench.py's
    batch; 3 warm-up and 10 timed steps each, finite losses that fall, the
    dense step's exact launch counts per step, and each layer's attention
    length against TOME_LENGTHS; images/s and peak memory beside phase 6's
    dense step. Then 2 steps of tome_r 16 with attention and hidden
    dropout 0.1 and mixup 0.2: the dropout kernels at the merged lengths.
    Returns (the launches of the timed runs, the tome_r 16 weights after
    their steps, images/s of the two merged steps by (tome_r, schedule))."""
    from chestxray_vit_tpu_torch.models import vit
    from chestxray_vit_tpu_torch.train import steps

    dev = torch.device("cuda")
    batch = bench_batch(TRAIN_BATCH, SEED, dev)
    launches, kept, rates = {}, None, {}
    drop = {"attention_dropout": DROP_RATE, "hidden_dropout": DROP_RATE}
    runs = [(r, schedule, 0.0, {}, WARMUP_STEPS, TIMED_STEPS)
            for r, schedule in TOME_STEPS]
    runs.append((16, "constant", MIXUP_ALPHA, drop, 0, TOME_DROPOUT_STEPS))
    for r, schedule, alpha, extra, warmup, timed in runs:
        cfg = train_config(alpha, remat=True, tome_r=r,
                           tome_schedule=schedule, **extra)
        per_step = dense_launches_per_step(cfg.model.num_layers,
                                           dropout=bool(extra))
        params = vit.init_params(torch.Generator().manual_seed(SEED),
                                 cfg.model, dev)
        state = steps.TrainState.create(params, seed=42)
        run = run_steps(steps.make_train_step(cfg, total_steps=10_000),
                        state, batch, warmup, timed)
        with torch.no_grad():
            _, seen = record_merges(lambda: vit.apply(
                params, batch["pixel_values"][:2], cfg.model))
        lengths = [n for n, _ in seen]
        losses, norms = run["losses"], run["grad_norms"]
        name = "train_tome" + ("_dropout" if extra else "")
        rec = {"phase": name, "tome_r": r, "tome_schedule": schedule,
               "batch": TRAIN_BATCH, "remat": "full",
               "dtype": cfg.model.dtype, **extra, "mixup_alpha": alpha,
               "warmup_steps": warmup, "timed_steps": timed,
               "step_ms": run["step_ms"],
               "images_per_s": TRAIN_BATCH * timed / run["wall"],
               "max_memory_allocated_gb": run["peak_gb"],
               "attention_lengths": lengths,
               "attention_length_mean": sum(lengths) / len(lengths),
               "losses": losses, "grad_norms": norms,
               "launches_per_step": run["step_counts"][-1],
               "launches": run["launches"]}
        if not extra:
            rec.update(dense_b36_images_per_s=dense_rec["images_per_s"],
                       dense_b36_max_memory_gb=dense_rec[
                           "max_memory_allocated_gb"],
                       images_per_s_vs_dense=rec["images_per_s"]
                       / dense_rec["images_per_s"])
        emit(rec)
        require(all(np.isfinite(losses)) and all(np.isfinite(norms)),
                f"{name} r={r}: finite loss and grad_norm at every step")
        require(extra or losses[-1] < losses[0],
                f"{name} r={r}: loss went down: {losses}")
        require(all(c == per_step for c in run["step_counts"]),
                f"{name} r={r}: launches per step {run['step_counts']} != "
                f"{per_step}")
        require(lengths == list(TOME_LENGTHS[(r, schedule)]),
                f"{name} r={r}: attention lengths {lengths}")
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
        if (r, schedule, extra) == (16, "constant", {}):
            kept = params
        if not extra:
            rates[(r, schedule)] = rec["images_per_s"]
        del state, run
        torch.cuda.empty_cache()
    return launches, kept, rates


def phase_tome_cross_check() -> None:
    """Full width, depth 2, batch 2, merging tome_r 16 under the decreasing
    schedule (577 → 555 → 545 tokens). The merged train step (full remat,
    attention dropout on injected seeds) on the card in f32 against the CPU
    (phase 7's comparison, each layer's merges in the forward and the
    recompute: none may differ); then the merged serving forward: dense in
    f32 (F32_LOGIT_TOL, no merge may differ) and bf16 (BF16_LOGIT_TOL; the
    merges that differ are counted), and a static int8 tree on the fused
    route, f32 and bf16, against the CPU's fused route (its plain twins)
    and plain route (INT8_ROUTE_TOL, correlation above
    INT8_ROUTE_MIN_CORR)."""
    import copy
    import dataclasses

    import chestxray_vit_tpu_torch as cxr
    from chestxray_vit_tpu_torch.models import quantized, tome_forward, vit

    merge = {"tome_r": TOME_SERVE[0], "tome_schedule": TOME_SERVE[1]}
    phase_train_cross_check("tome_cross_check_train", dtypes=("f32",),
                            remat=True, attention_dropout=DROP_RATE, **merge)

    cfg32 = cxr.ModelConfig(num_layers=2, dtype="float32")
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
    params = vit.init_params(torch.Generator().manual_seed(SEED), cfg32)
    x = bench_batch(2, SEED + 3, "cpu")["pixel_values"]
    qp = quantized.quantize_vit_params(
        params, quantized.calibrate_vit_scales(params, x, cfg32))
    r, schedule = TOME_SERVE

    def fwd(tree, c, quant=False, backend="xla", device="cpu"):
        return record_merges(lambda: tome_forward.apply_tome(
            tree, x.to(device), c, r, quantized=quant, schedule=schedule,
            backend=backend).cpu())

    def corr(a, b):
        return float(np.corrcoef(a.numpy().ravel(), b.numpy().ravel())[0, 1])

    rec = {"phase": "tome_cross_check_forward", "depth": 2, "batch": 2,
           "tome_r": r, "tome_schedule": schedule, "tol_f32": F32_LOGIT_TOL,
           "tol_bf16": BF16_LOGIT_TOL, "tol_int8": INT8_ROUTE_TOL,
           "min_corr_int8": INT8_ROUTE_MIN_CORR}
    with torch.inference_mode():
        cpu, cpu_seen = fwd(params, cfg32)
        cpu_fused, cpu_q_seen = fwd(qp, cfg32, True, "pallas")
        cpu_plain, _ = fwd(qp, cfg32, True, "xla")
        card_params = copy.deepcopy(params).to("cuda")
        card_qp = copy.deepcopy(qp).to("cuda")
        rec["attention_lengths"] = [n for n, _ in cpu_seen]
        for name, c in (("f32", cfg32), ("bf16", cfg16)):
            card, seen = fwd(card_params, c, device="cuda")
            rec[f"dense_{name}_max_abs"] = (card - cpu).abs().max().item()
            rec[f"dense_{name}_merges_differing"] = merges_differing(
                seen, cpu_seen)
            card, seen = fwd(card_qp, c, True, "pallas", "cuda")
            for ref_name, ref in (("cpu_fused", cpu_fused),
                                  ("cpu_plain", cpu_plain)):
                rec[f"int8_{name}_vs_{ref_name}_max_abs"] = (
                    card - ref).abs().max().item()
                rec[f"int8_{name}_vs_{ref_name}_corr"] = corr(card, ref)
            rec[f"int8_{name}_merges_differing"] = merges_differing(
                seen, cpu_q_seen)
    rec["cpu_f32_logits_absmax"] = cpu.abs().max().item()
    emit(rec)
    require(rec["dense_f32_max_abs"] <= F32_LOGIT_TOL
            and not any(rec["dense_f32_merges_differing"]),
            f"merged forward f32 card vs CPU: {rec}")
    require(rec["dense_bf16_max_abs"] <= BF16_LOGIT_TOL,
            f"merged forward bf16 card vs CPU f32: {rec}")
    for name in ("f32", "bf16"):
        for ref_name in ("cpu_fused", "cpu_plain"):
            d = rec[f"int8_{name}_vs_{ref_name}_max_abs"]
            c = rec[f"int8_{name}_vs_{ref_name}_corr"]
            require(d <= INT8_ROUTE_TOL and c > INT8_ROUTE_MIN_CORR,
                    f"merged int8 {name} vs {ref_name}: {d}, corr {c}")


def phase_serving_tome(int8_rec: dict) -> dict:
    """The fast_serve stack behind the MicroBatcher: a static-int8 Predictor
    with tome_r 16 decreasing at batch 32 (calibrated on 8 of the request
    images) answering 128 concurrent requests, and a dense bf16 tome_r 16
    Predictor at batch 8 answering 32: 15 finite probabilities each, 12
    attention, 25 LayerNorm (and 73 int8) launches per forwarded batch, the
    attention lengths of the schedule. Then the b8 and b32 forward times
    of dense bf16, dense + tome, static int8 and static int8 + tome on the
    same images, in turns, which say whether ``auto_accel_config``'s
    crossover (the stack at batch >= 32, plain bf16 below) holds on the
    card; phase 11's b32 routes beside them. Returns the launches of the
    two bursts."""
    import chestxray_vit_tpu_torch as cxr
    from chestxray_vit_tpu_torch.models import quantized, tome_forward, vit

    cfg = cxr.ModelConfig()
    params = vit.init_params(torch.Generator().manual_seed(SEED), cfg)
    images = make_requests(INT8_REQUESTS)
    r, schedule = TOME_SERVE
    t0 = time.perf_counter()
    pred = cxr.Predictor(params, cfg, batch_size=INT8_BATCH,
                         placement="device", device="cuda",
                         quantize="static", calibration=images[:8],
                         tome_r=r, tome_schedule=schedule)
    pred.warmup()
    warm_s = time.perf_counter() - t0
    results, submitted, done, launches = serve_burst(pred, images)
    rec = {**burst_record("serving_tome", pred, images, results, submitted,
                          done, cfg),
           "quantize": "static", "tome_r": r, "tome_schedule": schedule,
           "launches": launches, "warmup_s": warm_s,
           "int8_b32_images_per_s": int8_rec["images_per_s"],
           "dense_b32_images_per_s": int8_rec["dense_b32"]["images_per_s"]}
    require_forward_launches("serving_tome", launches, pred.forwards, cfg,
                             int8=True)

    dense = cxr.Predictor(params, cfg, batch_size=BATCH, placement="device",
                          device="cuda", tome_r=r, tome_schedule=schedule)
    dense.warmup()
    d_res, d_sub, d_done, d_launches = serve_burst(dense, images[:REQUESTS])
    d_rec = burst_record("serving_tome_dense_b8", dense, images[:REQUESTS],
                         d_res, d_sub, d_done, cfg)
    rec["dense_tome_b8"] = {k: d_rec[k] for k in (
        "images_per_s", "p50_latency_ms", "max_latency_ms", "forwards")}
    require_forward_launches("serving_tome_dense_b8", d_launches,
                             dense.forwards, cfg, int8=False)

    qp, dense_p = pred._fwd_params, dense._fwd_params
    staged = pred.stage_chunk(images[:INT8_BATCH])
    torch.cuda.synchronize()        # the copy ran on the Predictor's stream
    with torch.inference_mode():
        imgs = pred._images_of(staged)
        _, seen = record_merges(lambda: tome_forward.apply_tome(
            qp, imgs, cfg, r, quantized=True, schedule=schedule,
            backend="pallas"))
        rec["attention_lengths"] = [n for n, _ in seen]
        fwd = {
            "dense_bf16": lambda x: vit.apply(dense_p, x, cfg),
            "dense_tome": lambda x: tome_forward.apply_tome(
                dense_p, x, cfg, r, schedule=schedule),
            "static_fused": lambda x: quantized.apply_quantized(
                qp, x, cfg, "pallas"),
            "static_tome": lambda x: tome_forward.apply_tome(
                qp, x, cfg, r, quantized=True, schedule=schedule,
                backend="pallas")}
        for b in (BATCH, INT8_BATCH):
            x = imgs[:b]
            # in turns, forward then backward through the stacks: the
            # merged stacks can be host-bound, and the host's pace drifts
            turns = {k: [] for k in fwd}
            for order in (list(fwd), list(fwd)[::-1]):
                for k in order:
                    turns[k].append(time_ms(lambda f=fwd[k]: f(x), reps=5,
                                            inner=3))
            rec[f"forward_ms_b{b}"] = {k: sum(v) / 2
                                       for k, v in turns.items()}
            rec[f"forward_ms_b{b}_turns"] = turns
            rec[f"enqueue_ms_b{b}"] = {k: enqueue_ms(lambda f=f: f(x))
                                       for k, f in fwd.items()}
    rec["forward_ms_b32_phase_11"] = int8_rec["forward_ms_b32"]
    b8, b32 = rec[f"forward_ms_b{BATCH}"], rec[f"forward_ms_b{INT8_BATCH}"]
    rec["auto_accel_crossover"] = {
        "b32_stack_faster_than_dense": b32["static_tome"] < b32["dense_bf16"],
        "b8_dense_faster_than_stack": b8["dense_bf16"] <= b8["static_tome"]}
    rec["auto_accel_crossover"]["holds"] = all(
        rec["auto_accel_crossover"].values())
    emit(rec)
    require(rec["attention_lengths"] == list(TOME_LENGTHS[TOME_SERVE]),
            f"serving_tome: attention lengths {rec['attention_lengths']}")
    del pred, dense, qp, dense_p, imgs
    torch.cuda.empty_cache()
    return {k: launches[k] + d_launches[k] for k in launches}


def dp_layouts() -> list:
    """(name, Predictor device options, replicas) of the data-parallel
    serving runs: two replicas on cuda:0, and every card where there are
    two or more."""
    cards = torch.cuda.device_count()
    layouts = [("emulated", {"device": ["cuda:0"] * DP_REPLICAS},
                DP_REPLICAS)]
    if cards >= 2:
        layouts.append(("cards", {"device": "cuda", "data_parallel": cards},
                        cards))
    return layouts


def phase_serving_dp() -> dict:
    """Data-parallel serving (phase 32): for each layout of
    :func:`dp_layouts` and each stack of DP_STACKS, a Predictor over the
    layout's replicas answers INT8_REQUESTS concurrent requests beside a
    one-replica Predictor at the same batch; exact launches (replicas x the
    per-forward rule), each replica's rows bit for bit against a
    one-replica Predictor at the replica's batch, the gathered outputs
    within BF16_LOGIT_TOL (maps MAPS_TOL) of the one-replica ones, and each
    replica's enqueue_ms. Returns the data-parallel bursts' launches."""
    import chestxray_vit_tpu_torch as cxr
    from chestxray_vit_tpu_torch.serve import attention_maps
    from chestxray_vit_tpu_torch.models import vit

    cfg = cxr.ModelConfig()
    params = vit.init_params(torch.Generator().manual_seed(SEED), cfg)
    images = make_requests(INT8_REQUESTS)
    held = images[:INT8_BATCH]
    total = {}
    for layout, where, n in dp_layouts():
        for stack, share, kw in DP_STACKS:
            maps = stack == "maps"
            if kw.get("quantize") == "static":
                kw = {**kw, "calibration": images[:8]}

            def build(batch_size, **dev):
                pred = cxr.Predictor(params, cfg, batch_size=batch_size,
                                     placement="device", **dev, **kw)
                pred.warmup(with_maps=maps)
                return pred

            t0 = time.perf_counter()
            pred = build(share * n, **where)
            warm_s = time.perf_counter() - t0
            results, submitted, done, launches = serve_burst(
                pred, images, with_maps=maps)
            phase = f"serving_dp_{layout}_{stack}"
            rec = {**burst_record(phase, pred, images, results, submitted,
                                  done, cfg),
                   "phase": "serving_dp", "layout": layout, "stack": stack,
                   "cards": torch.cuda.device_count(),
                   "emulated": layout == "emulated", "replicas": n,
                   "devices": [str(d) for d in pred.devices],
                   "rows_per_replica": share, "launches": launches,
                   "warmup_s": warm_s}
            if layout == "emulated":
                rec["note"] = ("two replicas and two streams share one "
                               "card: this measures no scaling")
            forwards = pred.forwards * pred.replicas
            if maps:
                require(launches == {**dict.fromkeys(launches, 0),
                                     "layer_norm": (2 * cfg.num_layers + 1)
                                     * forwards},
                        f"{phase}: launches {launches} for {forwards} "
                        f"replica forwards")
            else:
                require_forward_launches(phase, launches, forwards, cfg,
                                         int8=kw.get("quantize") == "static")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v

            one = build(share * n, device=pred.devices[0])
            o_res, o_sub, o_done, _ = serve_burst(one, images,
                                                  with_maps=maps)
            o_rec = burst_record(phase + "_one", one, images, o_res, o_sub,
                                 o_done, cfg)
            rec[f"one_replica_b{share * n}"] = {k: o_rec[k] for k in (
                "images_per_s", "p50_latency_ms", "max_latency_ms",
                "forwards")}
            rec["gathered_vs_one_replica_max_abs"] = float(np.abs(
                np.stack([r.logits for r in results])
                - np.stack([r.logits for r in o_res])).max())
            rec["tol"] = BF16_LOGIT_TOL
            if maps:
                rec["gathered_maps_vs_one_replica_max_abs"] = float(np.abs(
                    np.stack([r.attn_map for r in results])
                    - np.stack([r.attn_map for r in o_res])).max())
                rec["maps_tol"] = MAPS_TOL
            del one
            torch.cuda.empty_cache()

            # each replica's rows against one replica at its batch
            part = build(share, device=pred.devices[0])
            got = pred.predict_arrays(held, with_maps=maps)
            want = part.predict_arrays(held, with_maps=maps)
            rec["replica_rows_equal_bits"] = bool(
                np.array_equal(got.logits, want.logits)
                and (not maps or np.array_equal(got.maps, want.maps)))
            del part
            torch.cuda.empty_cache()

            staged = pred.stage_chunk(images[:share * n])
            torch.cuda.synchronize()
            rec["enqueue_ms"] = []
            with torch.inference_mode():
                for r, operands in enumerate(staged):
                    with pred._on_stream(r):
                        x = pred._images_of(operands)
                        fwd = ((lambda r=r, x=x: attention_maps
                                .compute_rollout(pred._dense_params(r), x,
                                                 cfg)) if maps else
                               (lambda r=r, x=x: pred._logits(r, x)))
                        rec["enqueue_ms"].append(enqueue_ms(fwd))
            emit(rec)
            require(rec["replica_rows_equal_bits"],
                    f"{phase}: each replica's rows equal one replica at "
                    f"batch {share}, bit for bit")
            require(rec["gathered_vs_one_replica_max_abs"] <= BF16_LOGIT_TOL,
                    f"{phase}: gathered logits against one replica "
                    f"{rec['gathered_vs_one_replica_max_abs']}")
            require(not maps or rec["gathered_maps_vs_one_replica_max_abs"]
                    <= MAPS_TOL, f"{phase}: gathered maps against one "
                                 f"replica")
            del pred, staged
            torch.cuda.empty_cache()
    return total


def _first_step(step, params, batch, draws=None) -> tuple:
    """(loss, the gradients on the host) of one step from fresh state."""
    from chestxray_vit_tpu_torch.train import steps

    _, m = step(steps.TrainState.create(params, seed=42), batch, draws)
    return m["loss"].item(), {n: p.grad.cpu()
                              for n, p in params.named_parameters()}


def _against(got: tuple, ref: tuple) -> dict:
    """A first step against the reference's: equal bits, and the largest
    loss and relative gradient differences."""
    scale = max(g.abs().max().item() for g in ref[1].values())
    return {"bit_equal": got[0] == ref[0] and all(
                torch.equal(got[1][n], g) for n, g in ref[1].items()),
            "loss_diff": abs(got[0] - ref[0]),
            "grad_rel_diff": max((got[1][n] - g).abs().max().item()
                                 for n, g in ref[1].items()) / scale}


def _same_step(cmp: dict) -> bool:
    """Equal bits, or loss and gradients within POLICY_GRAD_TOL (the loss
    is O(1))."""
    return cmp["bit_equal"] or (cmp["loss_diff"] <= POLICY_GRAD_TOL and
                                cmp["grad_rel_diff"] <= POLICY_GRAD_TOL)


def phase_train_remat_policies(dense_rec: dict) -> tuple:
    """bench.py's dense b36 step (ViT-B/16 @384, bf16) under every remat
    policy and without remat, from the same weights on the same batch:
    POLICY_WARMUP_STEPS + POLICY_TIMED_STEPS steps each, with step ms,
    images/s, peak memory and the exact launches per step (the attention
    forward twice a layer where o and lse are recomputed, once where they
    are kept); each first step's loss and gradients against the
    full-remat step's (bit for bit, or within POLICY_GRAD_TOL). Then
    ``flash_out`` with attention and hidden dropout 0.1 (the dropout
    kernels' saves) against full remat on the same draws. Returns (the
    launches of the timed steps summed over the runs, the rows)."""
    from chestxray_vit_tpu_torch.models.vit import init_params
    from chestxray_vit_tpu_torch.train import steps

    dev = torch.device("cuda")
    batch = bench_batch(TRAIN_BATCH, SEED, dev)
    rows, total, ref = {}, {}, None
    for policy in REMAT_POLICIES:
        cfg = train_config(remat=policy is not None,
                           remat_policy=policy or "full")
        per_step = dense_launches_per_step(cfg.model.num_layers, False,
                                           policy)
        params = init_params(torch.Generator().manual_seed(SEED), cfg.model,
                             dev)
        step = steps.make_train_step(cfg, total_steps=10_000)
        first = _first_step(step, params, batch)
        ref = ref or first
        torch.cuda.empty_cache()
        run = run_steps(step, steps.TrainState.create(params, seed=42),
                        batch, POLICY_WARMUP_STEPS, POLICY_TIMED_STEPS)
        counts = run["step_counts"][-1]
        rows[str(policy)] = {
            "step_ms": run["step_ms"],
            "images_per_s": TRAIN_BATCH * POLICY_TIMED_STEPS / run["wall"],
            "max_memory_allocated_gb": run["peak_gb"],
            "attention_fwd_per_step": counts["flash_attention_fwd"],
            "attention_bwd_per_step": counts["flash_attention_bwd"],
            "layer_norm_per_step": counts["layer_norm"],
            "losses": run["losses"],
            "vs_full_remat": _against(first, ref)}
        require(all(np.isfinite(run["losses"])),
                f"policy {policy}: finite losses")
        require(all(c == per_step for c in run["step_counts"]),
                f"policy {policy}: launches per step {run['step_counts']} "
                f"!= {per_step}")
        require(_same_step(rows[str(policy)]["vs_full_remat"]),
                f"policy {policy} against full remat: "
                f"{rows[str(policy)]['vs_full_remat']}")
        total = {k: total.get(k, 0) + v for k, v in run["launches"].items()}
        del params, step, run, first
        torch.cuda.empty_cache()
    rec = {"phase": "train_remat_policies", "batch": TRAIN_BATCH,
           "dtype": "bfloat16", "warmup_steps": POLICY_WARMUP_STEPS,
           "timed_steps": POLICY_TIMED_STEPS, "policies": rows,
           "tol_grad_rel": POLICY_GRAD_TOL,
           "phase_6_full_remat_images_per_s": dense_rec["images_per_s"]}
    emit(rec)

    # flash_out with both dropouts: its saves are the dropout kernels'
    drop = {"attention_dropout": DROP_RATE, "hidden_dropout": DROP_RATE}
    draws = [steps.draw(torch.Generator().manual_seed(SEED + 1),
                        train_config(**drop), TRAIN_BATCH)]
    firsts = {}
    for policy in ("full", "flash_out"):
        cfg = train_config(remat=True, remat_policy=policy, **drop)
        params = init_params(torch.Generator().manual_seed(SEED), cfg.model,
                             dev)
        step = steps.make_train_step(cfg, total_steps=10_000)
        firsts[policy] = _first_step(step, params, batch, draws)
        del params
        torch.cuda.empty_cache()
    run = run_steps(step, steps.TrainState.create(
        init_params(torch.Generator().manual_seed(SEED), cfg.model, dev),
        seed=42), batch, POLICY_WARMUP_STEPS, POLICY_TIMED_STEPS)
    per_step = dense_launches_per_step(cfg.model.num_layers, True,
                                       "flash_out")
    drec = {"phase": "train_remat_flash_out_dropout", "batch": TRAIN_BATCH,
            **drop, "step_ms": run["step_ms"],
            "images_per_s": TRAIN_BATCH * POLICY_TIMED_STEPS / run["wall"],
            "max_memory_allocated_gb": run["peak_gb"],
            "launches_per_step": run["step_counts"][-1],
            "vs_full_remat_same_draws": _against(firsts["flash_out"],
                                                 firsts["full"])}
    emit(drec)
    require(all(c == per_step for c in run["step_counts"]),
            f"flash_out with dropout: launches per step "
            f"{run['step_counts']} != {per_step}")
    require(_same_step(drec["vs_full_remat_same_draws"]),
            f"flash_out with dropout against full remat: "
            f"{drec['vs_full_remat_same_draws']}")
    total = {k: total.get(k, 0) + v for k, v in run["launches"].items()}
    del run, step, firsts
    torch.cuda.empty_cache()
    return total, rows


def phase_train_fused_qkv(rows: dict) -> dict:
    """bench.py's b36 step (bf16, full remat) with ``fused_qkv``: step ms
    beside phase 22's split full-remat step and exact launches; one f32
    step (TF32 off) fused against split on the same weights and batch
    (FUSED_GRAD_TOL); and the copy autograd makes of the kernels' three
    separate dq, dk, dv buffers into the fused projection's gradient (the
    stack of three [36, 577, 12, 64] bf16 gradients, 12 a step). Returns
    the timed steps' launches."""
    from chestxray_vit_tpu_torch.models.vit import init_params
    from chestxray_vit_tpu_torch.train import steps

    dev = torch.device("cuda")
    batch = bench_batch(TRAIN_BATCH, SEED, dev)
    cfg = train_config(remat=True, fused_qkv=True)
    per_step = dense_launches_per_step(cfg.model.num_layers, False)
    params = init_params(torch.Generator().manual_seed(SEED), cfg.model, dev)
    run = run_steps(steps.make_train_step(cfg, total_steps=10_000),
                    steps.TrainState.create(params, seed=42), batch,
                    POLICY_WARMUP_STEPS, POLICY_TIMED_STEPS)
    del params
    torch.cuda.empty_cache()
    firsts = {}
    for fused in (False, True):
        c32 = train_config(remat=True, fused_qkv=fused, dtype="float32")
        params = init_params(torch.Generator().manual_seed(SEED), c32.model,
                             dev)
        firsts[fused] = _first_step(
            steps.make_train_step(c32, total_steps=10_000), params, batch)
        del params
        torch.cuda.empty_cache()
    d = TRAIN_BATCH, cfg.model.seq_len, cfg.model.num_heads, \
        cfg.model.head_dim
    grads = [torch.randn(d, device=dev, dtype=torch.bfloat16)
             for _ in range(3)]
    stack_ms = time_ms(lambda: torch.stack(grads, dim=2))
    nbytes = 2 * 3 * grads[0].numel() * grads[0].element_size()
    rec = {"phase": "train_fused_qkv", "batch": TRAIN_BATCH,
           "remat": "full", "step_ms": run["step_ms"],
           "images_per_s": TRAIN_BATCH * POLICY_TIMED_STEPS / run["wall"],
           "split_step_ms_phase_22": rows["full"]["step_ms"],
           "max_memory_allocated_gb": run["peak_gb"],
           "launches_per_step": run["step_counts"][-1],
           "f32_fused_vs_split": _against(firsts[True], firsts[False]),
           "tol_f32": [FUSED_LOSS_TOL, FUSED_GRAD_TOL],
           "grad_stack_ms_per_layer": stack_ms,
           "grad_stack_ms_per_step": cfg.model.num_layers * stack_ms,
           "grad_stack_bound_ms_per_layer": 1e3 * nbytes / HBM_BYTES_PER_S}
    emit(rec)
    require(all(np.isfinite(run["losses"])), "fused_qkv: finite losses")
    require(all(c == per_step for c in run["step_counts"]),
            f"fused_qkv: launches per step {run['step_counts']} != "
            f"{per_step}")
    cmp = rec["f32_fused_vs_split"]
    require(cmp["loss_diff"] <= FUSED_LOSS_TOL
            and cmp["grad_rel_diff"] <= FUSED_GRAD_TOL,
            f"fused_qkv against split in f32: {cmp}")
    return run["launches"]


def phase_serving_maps() -> dict:
    """Attention-rollout maps through the port's entry points: a dense bf16
    Predictor at batch 8 (ViT-B/16 @384, seed-0 weights) runs one maps
    forward of 8 request images (the main path: 25 LayerNorm launches, the
    plain attention with f32 scores and softmax, probabilities of every
    layer kept), with its ms, the plain forward's ms and the peak memory;
    the maps [8, 24, 24] in [0, 1] against the CPU's f32 on the same
    weights (2 images, MAPS_TOL and MAPS_MIN_CORR); MAPS_REQUESTS
    ``POST /predict?maps=1`` requests through the port's server; one
    Grad-CAM call at batch GRAD_CAM_BATCH. Returns the maps forward's
    launches."""
    import dataclasses
    import io
    import urllib.request

    from PIL import Image

    import chestxray_vit_tpu_torch as cxr
    from chestxray_vit_tpu_torch.models.vit import init_params
    from chestxray_vit_tpu_torch.serve import attention_maps
    from chestxray_vit_tpu_torch.serve.server import serve

    cfg = cxr.ModelConfig()
    g = cfg.img_size // cfg.patch_size
    params = init_params(torch.Generator().manual_seed(SEED), cfg)
    images = make_requests(BATCH)
    pred = cxr.Predictor(params, cfg, batch_size=BATCH, placement="device",
                         device="cuda")
    t0 = time.perf_counter()
    pred.warmup(with_maps=True)
    warm_s = time.perf_counter() - t0
    staged = pred.stage_chunk(images)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = pred.forward_staged(staged, BATCH, with_maps=True)
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    maps_ms = time_ms(lambda: pred.forward_staged(staged, BATCH,
                                                  with_maps=True),
                      reps=5, inner=2)
    plain_ms = time_ms(lambda: pred.forward_staged(staged, BATCH),
                       reps=5, inner=2)
    cpu = cxr.Predictor(params, dataclasses.replace(cfg, dtype="float32"),
                        batch_size=2, placement="device",
                        device="cpu").predict_arrays(images[:2],
                                                     with_maps=True)
    card, ref = out.maps[:2].ravel(), cpu.maps.ravel()

    def png(a) -> bytes:
        buf = io.BytesIO()
        Image.fromarray(a, "L").save(buf, format="PNG")
        return buf.getvalue()

    server = serve(pred, host="127.0.0.1", port=0, block=False)
    answers = []
    try:
        for img in images[:MAPS_REQUESTS]:
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.server_port}/predict?maps=1",
                data=png(img), method="POST")
            with urllib.request.urlopen(req, timeout=300) as resp:
                answers.append((resp.status, json.loads(resp.read())))
    finally:
        server.shutdown()
        server.server_close()
    amaps = [np.asarray(a.get("attention_map", []), np.float32)
             for _, a in answers]

    with torch.inference_mode():
        x = pred._images_of(pred.stage_chunk(images[:GRAD_CAM_BATCH]))
    x = x.clone()
    cam_ms = time_ms(lambda: attention_maps.grad_cam(
        pred._fwd_params, x, cfg, 0), reps=3, inner=1)
    _, cam = attention_maps.grad_cam(pred._fwd_params, x, cfg, 0)
    rec = {"phase": "serving_maps", "batch": BATCH, "warmup_s": warm_s,
           "maps_forward_ms": maps_ms, "plain_forward_ms": plain_ms,
           "max_memory_allocated_gb": peak_gb, "base_memory_gb": base_gb,
           "probabilities_gb": 4 * cfg.num_layers * BATCH * cfg.num_heads
           * cfg.seq_len ** 2 / 1e9,
           "maps_shape": list(out.maps.shape), "launches": launches,
           "card_bf16_vs_cpu_f32_maps_max_abs": float(np.abs(card - ref)
                                                      .max()),
           "card_bf16_vs_cpu_f32_maps_corr": float(np.corrcoef(card, ref)
                                                   [0, 1]),
           "tol": [MAPS_TOL, MAPS_MIN_CORR],
           "server_statuses": [st for st, _ in answers],
           "server_map_shapes": [list(m.shape) for m in amaps],
           "grad_cam_batch": GRAD_CAM_BATCH, "grad_cam_ms": cam_ms,
           "grad_cam_shape": list(cam.shape)}
    emit(rec)
    maps_ok = (np.isfinite(out.maps).all() and out.maps.min() >= 0.0
               and out.maps.max() <= 1.0 and np.isfinite(out.logits).all())
    require(out.maps.shape == (BATCH, g, g) and maps_ok,
            f"serving_maps: maps {out.maps.shape} finite in [0, 1]")
    require(launches == {**dict.fromkeys(launches, 0),
                         "layer_norm": 2 * cfg.num_layers + 1},
            f"serving_maps: launches {launches}")
    require(rec["card_bf16_vs_cpu_f32_maps_max_abs"] <= MAPS_TOL
            and rec["card_bf16_vs_cpu_f32_maps_corr"] > MAPS_MIN_CORR,
            f"serving_maps: card against CPU {rec}")
    require(all(st == 200 for st, _ in answers)
            and all(m.shape == (g, g) and np.isfinite(m).all()
                    and m.min() >= 0.0 and m.max() <= 1.0 for m in amaps),
            f"serving_maps: server answers {rec['server_statuses']} "
            f"{rec['server_map_shapes']}")
    require(tuple(cam.shape) == (GRAD_CAM_BATCH, g, g)
            and bool(torch.isfinite(cam).all()),
            f"serving_maps: Grad-CAM {tuple(cam.shape)}")
    del pred, params, out
    torch.cuda.empty_cache()
    return launches

def device_busy_ms(trace_path: str) -> tuple:
    """(ms, count) of the union of the card's kernel, copy and set
    intervals in a ``torch.profiler`` Chrome trace."""
    with open(trace_path) as f:
        trace = json.load(f)
    device = sorted(
        (e["ts"], e["ts"] + e["dur"])
        for e in (trace["traceEvents"] if isinstance(trace, dict) else trace)
        if e.get("ph") == "X"
        and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for a, b in device:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, len(device)


class StepClock:
    """Wraps a Trainer's step function: the host clock at each step's
    call (each logged step syncs, so the gap between two calls is one
    step with what the loop did after it), and a CUDA-only profile from
    the call of step ``window[0]`` to that of step ``window[1] + 1`` for
    the card's busy share of that wall time (the trace is written and read
    in :meth:`profiled`, after the run, off the clock)."""

    def __init__(self, step_fn, trace_path: str = "", window=None):
        self.step_fn, self.trace_path, self.window = (step_fn, trace_path,
                                                      window)
        self.calls, self.prof, self.wall_ms = [], None, None

    def __call__(self, state, batch):
        from torch.profiler import ProfilerActivity, profile
        step = state.step + 1                   # the step this call runs
        self.calls.append((step, time.perf_counter()))
        if self.window and step == self.window[0]:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
            self.t0 = time.perf_counter()
        elif self.window and step == self.window[1] + 1:
            torch.cuda.synchronize()
            self.wall_ms = 1e3 * (time.perf_counter() - self.t0)
            self.prof.stop()
        return self.step_fn(state, batch)

    def profiled(self) -> dict:
        """The profiled window's wall ms, the card's busy ms and its idle
        share."""
        self.prof.export_chrome_trace(self.trace_path)
        busy, kernels = device_busy_ms(self.trace_path)
        return {"profiled_steps": list(self.window),
                "profile_wall_ms": self.wall_ms, "device_busy_ms": busy,
                "device_kernels": kernels,
                "device_idle_share": 1.0 - busy / self.wall_ms}

    def step_ms(self) -> dict:
        """{step: ms from its call to the next step's call}."""
        return {a: 1e3 * (tb - ta) for (a, ta), (_, tb)
                in zip(self.calls, self.calls[1:])}


def _trainer_config(out_dir: str, **train):
    import chestxray_vit_tpu_torch as cxr
    kw = dict(batch_size_per_core=TRAIN_BATCH, max_steps=TRAINER_STEPS,
              eval_steps=TRAINER_EVERY, save_steps=TRAINER_EVERY,
              save_total_limit=2, load_best_model_at_end=True,
              logging_steps=1, report_to="tensorboard", output_dir=out_dir)
    kw.update(train)
    return cxr.Config(
        data=cxr.DataConfig(backend="memory", augment=True,
                            preprocess_placement="host"),
        model=cxr.ModelConfig(remat=True),      # ViT-B/16 @384 bf16, full
        train=cxr.TrainConfig(**kw))


def _logged(out_dir: str, prefix: str = "train", key: str = "loss") -> list:
    import os
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [(r["step"], r[key]) for r in recs if r["prefix"] == prefix]


def _quiet(fn):
    """``fn()`` with what it prints captured: (result, the text). The text
    goes to stderr, so stdout keeps one JSON line a phase."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    sys.stderr.write(buf.getvalue())
    return out, buf.getvalue()


def phase_trainer(dense_rec: dict) -> dict:
    """The Trainer entry point on the card (ViT-B/16 @384 bf16, full
    remat, batch 36) over the fake NIH bucket (TRAINER_IMAGES images of
    TRAINER_IMAGE_SIZE px, memory backend, host placement, augmentation
    on): TRAINER_STEPS steps with eval and a checkpoint every
    TRAINER_EVERY, the best checkpoint restored at the end; then
    evaluate(), save_model() and Predictor.from_model_dir() against the
    Trainer's eval logits; then a second Trainer resumed from the step-6
    checkpoint in a fresh directory, whose losses, eval metrics and step-12
    checkpoint equal the first run's bit for bit (its step 7 traced through
    ``train.profile_steps``); and the host's time to produce a batch alone.
    The card's idle share over the first run's steps TRAINER_PROFILE comes
    from a CUDA-only profile against the host clock. Each step's wall time is the gap between two
    step calls (every step syncs to log its loss). Returns the launches of
    all of it."""
    import os
    import shutil
    import tempfile

    from chestxray_vit_tpu_torch.data import pipeline as pipe
    from chestxray_vit_tpu_torch.data.testing import build_fake_nih
    from chestxray_vit_tpu_torch.serve.inference import Predictor
    from chestxray_vit_tpu_torch.train.trainer import Trainer
    from chestxray_vit_tpu_torch.utils.logging import ThroughputMeter
    from chestxray_vit_tpu_torch.utils.tfevents import read_scalars

    t0 = time.perf_counter()
    fake = build_fake_nih(num_images=TRAINER_IMAGES,
                          image_size=TRAINER_IMAGE_SIZE, seed=17)
    fake_s = time.perf_counter() - t0
    rec = {"phase": "trainer", "images": TRAINER_IMAGES,
           "image_px": TRAINER_IMAGE_SIZE, "batch": TRAIN_BATCH,
           "steps": TRAINER_STEPS, "fake_bucket_s": fake_s,
           "bare_step_images_per_s": dense_rec["images_per_s"]}
    with tempfile.TemporaryDirectory(prefix="cxr_trainer_") as tmp:
        out_a, out_b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        tr = Trainer(_trainer_config(out_a), store=fake.store,
                     pretrained=False)
        rec.update(train_images=len(tr.bundle.train),
                   val_images=len(tr.bundle.val),
                   steps_per_epoch=tr.steps_per_epoch)
        # the default meter window (50 steps or 10 s) is longer than this
        # run: a window of TRAINER_METER_WINDOW steps gives it a reading
        tr._meter = ThroughputMeter(window=TRAINER_METER_WINDOW)
        clock = tr._train_step = StepClock(
            tr._train_step, os.path.join(tmp, "idle.json"), TRAINER_PROFILE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        result, log_a = _quiet(tr.train)
        torch.cuda.synchronize()
        rec["train_wall_s"] = time.perf_counter() - t0
        rec["train_result"] = result
        rec["max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
        losses = _logged(out_a)
        ips = [v for _, v in _logged(out_a, key="images_per_sec")]
        rec["losses"] = [v for _, v in losses]
        rec["step_ms"] = clock.step_ms()
        rec.update(clock.profiled())
        rec["meter_images_per_s"] = max(ips)
        rec["meter_readings"] = sorted({round(v, 3) for v in ips if v})
        rec["trainer_images_per_s_wall"] = result["train_samples_per_second"]
        rec["checkpoint_save"] = tr.ckpt.last_save
        require(result["train_steps"] == TRAINER_STEPS
                and [s for s, _ in losses] == list(
                    range(1, TRAINER_STEPS + 1))
                and all(np.isfinite(v) for _, v in losses),
                f"trainer: {TRAINER_STEPS} steps, every loss finite: "
                f"{losses}")
        require(rec["meter_images_per_s"] > 0, "trainer: the meter read")
        (tb,) = os.listdir(os.path.join(out_a, "tb"))
        tb_losses = [(s, v) for s, tag, v in read_scalars(
            os.path.join(out_a, "tb", tb)) if tag == "train/loss"]
        require([s for s, _ in tb_losses] == [s for s, _ in losses]
                and np.array_equal(np.float32([v for _, v in tb_losses]),
                                   np.float32([v for _, v in losses])),
                "trainer: metrics.jsonl and tfevents hold the same losses")
        ckdir = os.path.join(out_a, "checkpoints")
        saves = sorted(os.listdir(ckdir), key=int)
        metas = {}
        for s in saves:
            with open(os.path.join(ckdir, s, "meta.json")) as f:
                metas[s] = json.load(f)
        evals = dict(_logged(out_a, "eval", "avg_auroc"))
        rec.update(saves=saves, eval_avg_auroc=evals,
                   best_step=tr.ckpt.best_step())
        require(saves == [str(TRAINER_EVERY), str(TRAINER_STEPS)]
                and all(np.isfinite(m["metrics"]["avg_auroc"])
                        and m["metrics"]["avg_auroc"] == evals[int(s)]
                        for s, m in metas.items()),
                f"trainer: saves {saves} carry their eval metrics")
        printed = [int(line.split("(step ")[1].rstrip(")"))
                   for line in log_a.splitlines()
                   if "loaded best checkpoint" in line]
        require(printed == [tr.ckpt.best_step()]
                and tr.state.step == tr.ckpt.best_step(),
                f"trainer: best checkpoint restored: printed {printed}, "
                f"best {tr.ckpt.best_step()}, state {tr.state.step}")

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev = tr.evaluate()
        torch.cuda.synchronize()
        rec["evaluate_ms"] = 1e3 * (time.perf_counter() - t0)
        rec["evaluate"] = {k: ev[k] for k in ("avg_auroc", "f1_micro",
                                              "eval_loss")}
        require(all(np.isfinite(v) for v in rec["evaluate"].values()),
                f"trainer: evaluate() finite: {rec['evaluate']}")

        want, _, _ = tr._forward_all(tr.bundle.val)
        model_dir = os.path.join(tmp, "model")
        t0 = time.perf_counter()
        _quiet(lambda: tr.save_model(model_dir))
        rec["save_model_s"] = time.perf_counter() - t0
        loader = tr._loader(tr.bundle.val, augment=False)
        pixels = [loader.load(i)["pixel_values_u8"]
                  for i in range(len(tr.bundle.val))]
        pred = Predictor.from_model_dir(model_dir, batch_size=TRAIN_BATCH,
                                        device="cuda")
        got = pred.predict_arrays(pixels).logits
        d = float(np.abs(got - want).max())
        rec["predictor_vs_trainer_logits_max_abs"] = d
        rec["predictor_tol"] = BF16_LOGIT_TOL
        require(got.shape == want.shape and np.isfinite(got).all()
                and d <= BF16_LOGIT_TOL,
                f"trainer: Predictor.from_model_dir vs the Trainer's eval "
                f"logits: {d}")
        best_a = tr.ckpt.best_step()
        tr.close()
        del tr, pred
        torch.cuda.empty_cache()

        # exact resume: the step-6 checkpoint in a fresh directory
        os.makedirs(os.path.join(out_b, "checkpoints"))
        shutil.copytree(os.path.join(ckdir, str(TRAINER_EVERY)),
                        os.path.join(out_b, "checkpoints",
                                     str(TRAINER_EVERY)))
        tr_b = Trainer(_trainer_config(
            out_b, resume_from_checkpoint=str(TRAINER_EVERY),
            profile_steps=(TRAINER_EVERY, TRAINER_EVERY + 1)),
            store=fake.store, pretrained=False)
        clock_b = tr_b._train_step = StepClock(tr_b._train_step)
        _quiet(tr_b.train)
        torch.cuda.synchronize()
        launches = launch_counts()
        resumed = _logged(out_b)
        rec["resumed_losses"] = [v for _, v in resumed]
        require(resumed == losses[TRAINER_EVERY:],
                f"trainer: resumed losses equal bit for bit: {resumed} "
                f"{losses[TRAINER_EVERY:]}")
        require(_logged(out_b, "eval", "avg_auroc") == [
            (TRAINER_STEPS, evals[TRAINER_STEPS])]
            and tr_b.ckpt.best_step() == best_a,
            "trainer: resumed eval metric and best step equal")
        last = str(TRAINER_STEPS)
        sa, sb = (torch.load(os.path.join(o, "checkpoints", last,
                                          "state.pt"), weights_only=True)
                  for o in (out_a, out_b))
        same = all(torch.equal(sa[k][n], sb[k][n])
                   for k in ("params", "mu", "nu") for n in sa[k])
        require(same and sa["step"] == sb["step"] == TRAINER_STEPS,
                "trainer: the resumed step-12 checkpoint equals the "
                "uninterrupted one bit for bit")
        del sa, sb
        rec["resumed_step_ms"] = clock_b.step_ms()
        # train.profile_steps traced step 7 of the resumed run
        trace = os.path.join(out_b, "profile", "trace_{}_{}.json".format(
            TRAINER_EVERY, TRAINER_EVERY + 1))
        rec["profile_steps_trace_kernels"] = device_busy_ms(trace)[1]
        require(rec["profile_steps_trace_kernels"] > 0,
                "trainer: train.profile_steps wrote a trace with the "
                "card's kernels")
        tr_b.close()

        # the host alone: batches from the decode pool, no device
        loader = tr_b._loader(tr_b.bundle.train, augment=True)
        cfg = tr_b.cfg
        it = pipe.iterate_batches(
            loader, TRAIN_BATCH, epoch=0, shuffle=True,
            seed=cfg.data.shuffle_buffer_seed,
            num_workers=cfg.data.num_workers,
            prefetch_batches=cfg.data.prefetch_depth, drop_last=True)
        t0 = time.perf_counter()
        n = sum(1 for _ in it)
        rec["host_batch_ms"] = 1e3 * (time.perf_counter() - t0) / n
        rec["host_batches"] = n
        rec["host_workers"] = cfg.data.num_workers
        del tr_b
        torch.cuda.empty_cache()
    rec["launches"] = launches
    emit(rec)
    # train steps: 12 in the first run, 6 resumed; forwards: the cadence
    # evals (2 + 1), evaluate(), the cross-check's _forward_all and the
    # Predictor's, one batch of 36 each
    steps, forwards = TRAINER_STEPS + TRAINER_EVERY, 6
    per_step = dense_launches_per_step(12, dropout=False)
    want_l = {k: steps * v for k, v in per_step.items()}
    want_l["flash_attention_inference"] += 12 * forwards
    want_l["layer_norm"] += 25 * forwards
    require(launches == want_l,
            f"trainer: launches {launches}, expected {want_l}")
    return launches


def varres_bucket(images: int = PACKED_TRAINER_IMAGES):
    """The fake NIH bucket of phases 26-27 (38: ``images`` of them):
    PACKED_TRAINER_IMAGES images of 512 px, a third rewritten at 256 px and a third at 384 px (grids 16, 24
    and 32 of ViT-B/16: 256, 576 and 1024 tokens), as
    ``tests/test_packed_trainer.py`` does at its small size; and the seconds
    it took to make."""
    import io

    from PIL import Image

    from chestxray_vit_tpu_torch.data.testing import build_fake_nih

    t0 = time.perf_counter()
    fake = build_fake_nih(num_images=images, image_size=512, seed=23)
    rng = np.random.default_rng(0)
    for i, name in enumerate(fake.image_names):
        size = (256, 384, 512)[i % 3]
        if size == 512:
            continue
        key = f"images_{(i % 12) + 1:03d}/images/{name}"
        require(fake.store.exists(key), f"varres bucket: {key} exists")
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, (size, size), np.uint8),
                        "L").save(buf, format="PNG")
        fake.store.put(key, buf.getvalue())
    return fake, time.perf_counter() - t0


def _packed_trainer_config(out_dir: str, **train):
    import chestxray_vit_tpu_torch as cxr
    kw = dict(max_steps=PACKED_TRAINER_STEPS,
              eval_steps=PACKED_TRAINER_EVERY,
              save_steps=PACKED_TRAINER_EVERY, save_total_limit=2,
              load_best_model_at_end=True, logging_steps=1,
              report_to="none", output_dir=out_dir)
    kw.update(train)
    return cxr.Config(data=cxr.DataConfig(backend="memory"),
                      model=cxr.ModelConfig(remat=True),   # ViT-B/16, bf16
                      train=cxr.TrainConfig(**kw))


def _packed_trainer(cfg, fake):
    from chestxray_vit_tpu_torch.train.packed_trainer import PackedTrainer
    return PackedTrainer(cfg, seq_len=PACKED_TRAINER_SEQ_LEN,
                         grids=PACKED_TRAINER_GRIDS,
                         batch_seqs=PACKED_TRAINER_SEQS, store=fake.store,
                         pretrained=False)


def packed_epochs(tr, steps: int) -> list:
    """The host alone, through the PackedTrainer's own packer, for the
    epochs that ``steps`` steps reach: per epoch the full batches it packs,
    their images and pad share, and the ms a batch takes to pack (decode,
    resize, patchify, pack)."""
    out, epoch = [], 0
    while sum(e["full_batches"] for e in out) < steps:
        t0 = time.perf_counter()
        full = images = pad = 0
        n = 0
        for b in tr._packed_iter(tr.bundle.train, epoch,
                                 batch_seqs=tr._local_step_seqs):
            n += 1
            if int(b["n_seqs"]) == tr._local_step_seqs:
                full += 1
                images += int(b["n_images"])
                pad += float((b["segment_ids"] < 0).mean())
        require(full > 0, f"packed_trainer: epoch {epoch} packs a batch")
        out.append({"epoch": epoch, "full_batches": full,
                    "images": images, "pad_share": pad / full,
                    "host_batch_ms": 1e3 * (time.perf_counter() - t0) / n})
        epoch += 1
    return out


def phase_packed_trainer(fake, fake_s: float, packed_rec: dict) -> dict:
    """The PackedTrainer entry point on the card (ViT-B/16 @384 bf16, full
    remat, PACKED_TRAINER_SEQS sequences of 1152 tokens a step, grids 16,
    24 and 32) over the variable-resolution bucket: PACKED_TRAINER_STEPS
    steps with eval and a checkpoint every PACKED_TRAINER_EVERY, the best
    one restored, evaluate(); then a second PackedTrainer resumed from the
    step-6 checkpoint in a fresh directory, whose losses, eval metric and
    step-12 checkpoint (the image-count cursor included) equal the first
    run's bit for bit. Exact launches: 24 segment forwards and 12 segment
    backwards a step, the eval forwards' 12, no dense attention. Reports
    the census's steps_per_epoch beside the full batches each epoch
    packed, tokens/s and images/s beside phase 14's bare packed step, the
    pad share, the host's ms to pack a batch alone, the census's seconds,
    the card's idle share over three steady steps, checkpoint bytes and
    seconds, evaluate() ms, peak memory. Returns the launches."""
    import os
    import shutil
    import tempfile

    from chestxray_vit_tpu_torch.data import packing as pk
    from chestxray_vit_tpu_torch.utils.logging import ThroughputMeter

    rec = {"phase": "packed_trainer", "images": PACKED_TRAINER_IMAGES,
           "image_px": [256, 384, 512], "seq_len": PACKED_TRAINER_SEQ_LEN,
           "batch_seqs": PACKED_TRAINER_SEQS,
           "steps": PACKED_TRAINER_STEPS, "fake_bucket_s": fake_s,
           "bare_step": {k: packed_rec[k] for k in (
               "images_per_s", "tokens_per_s", "step_ms", "pad_share")}}
    with tempfile.TemporaryDirectory(prefix="cxr_packed_") as tmp:
        out_a, out_b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        t0 = time.perf_counter()
        tr = _packed_trainer(_packed_trainer_config(out_a), fake)
        rec["init_s"] = time.perf_counter() - t0
        cfg = tr.cfg
        t0 = time.perf_counter()
        pk.sample_token_counts(tr.bundle.train, tr.bundle.blob_map,
                               tr.bundle.store, patch=cfg.model.patch_size,
                               grids=PACKED_TRAINER_GRIDS, sample=128,
                               num_workers=cfg.data.num_workers)
        rec["census_s"] = time.perf_counter() - t0
        spe = tr.steps_per_epoch
        epochs = packed_epochs(tr, PACKED_TRAINER_STEPS)
        rec.update(train_images=len(tr.bundle.train),
                   val_images=len(tr.bundle.val), steps_per_epoch=spe,
                   epochs_packed=epochs,
                   host_batch_ms=statistics.median(
                       e["host_batch_ms"] for e in epochs),
                   pad_share=statistics.mean(e["pad_share"] for e in epochs),
                   host_workers=cfg.data.num_workers)
        # the steps after which the loop leaves the steady state: an epoch
        # boundary (each epoch runs to the full batches it packs), an eval
        # and a save; the idle share is read over three steps before none
        bounds = set(np.cumsum([e["full_batches"] for e in epochs]).tolist())
        bounds |= set(range(PACKED_TRAINER_EVERY, PACKED_TRAINER_STEPS + 1,
                            PACKED_TRAINER_EVERY))
        first = next((a for a in range(2, PACKED_TRAINER_STEPS - 2)
                      if not bounds & {a, a + 1, a + 2}), None)
        require(first is not None,
                f"packed_trainer: three steady steps among {sorted(bounds)}")
        window = (first, first + 2)
        tr._meter = ThroughputMeter(window=TRAINER_METER_WINDOW)
        clock = StepClock(tr._train_step, os.path.join(tmp, "idle.json"),
                          window)
        images = []

        def step(state, batch):
            images.append(int(batch["image_mask"].sum()))
            return clock(state, batch)

        tr._train_step = step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        result, log_a = _quiet(tr.train)
        torch.cuda.synchronize()
        rec["train_wall_s"] = time.perf_counter() - t0
        rec["max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
        losses = _logged(out_a)
        rec["losses"] = [v for _, v in losses]
        rec["images_per_step"] = images
        ms = clock.step_ms()
        rec["step_ms"] = ms
        steady = [ms[s] for s in range(window[0], window[1] + 1)]
        steady_ms = statistics.median(steady)
        steady_images = statistics.mean(images[s - 1] for s in range(
            window[0], window[1] + 1))
        rec.update(clock.profiled())
        rec["steady_step_ms"] = steady_ms
        rec["tokens_per_s"] = (PACKED_TRAINER_SEQS * PACKED_TRAINER_SEQ_LEN
                               / (steady_ms / 1e3))
        rec["images_per_s"] = steady_images / (steady_ms / 1e3)
        rec["run_images_per_s"] = sum(images) / rec["train_wall_s"]
        rec["checkpoint_save"] = tr.ckpt.last_save
        require(result["train_steps"] == PACKED_TRAINER_STEPS
                and [s for s, _ in losses] == list(
                    range(1, PACKED_TRAINER_STEPS + 1))
                and all(np.isfinite(v) for _, v in losses),
                f"packed_trainer: {PACKED_TRAINER_STEPS} steps, every loss "
                f"finite: {losses}")
        ckdir = os.path.join(out_a, "checkpoints")
        saves = sorted(os.listdir(ckdir), key=int)
        metas = {}
        for s in saves:
            with open(os.path.join(ckdir, s, "meta.json")) as f:
                metas[s] = json.load(f)
        evals = dict(_logged(out_a, "eval", "avg_auroc"))
        rec.update(saves=saves, eval_avg_auroc=evals,
                   cursors={s: m["cursor"] for s, m in metas.items()},
                   best_step=tr.ckpt.best_step())
        require(saves == [str(PACKED_TRAINER_EVERY),
                          str(PACKED_TRAINER_STEPS)]
                and all(m["metrics"]["avg_auroc"] == evals[int(s)]
                        for s, m in metas.items()),
                f"packed_trainer: saves {saves} carry their eval metrics")
        require(tr.state.step == tr.ckpt.best_step()
                and "loaded best checkpoint" in log_a,
                "packed_trainer: the best checkpoint restored")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev = tr.evaluate()
        torch.cuda.synchronize()
        rec["evaluate_ms"] = 1e3 * (time.perf_counter() - t0)
        rec["evaluate"] = {k: ev[k] for k in ("avg_auroc", "f1_micro",
                                              "eval_loss")}
        require(all(np.isfinite(v) for v in rec["evaluate"].values()),
                f"packed_trainer: evaluate() finite: {rec['evaluate']}")
        eval_batches = sum(1 for _ in tr._packed_iter(
            tr.bundle.val, 0, batch_seqs=PACKED_TRAINER_SEQS, shuffle=False))
        best_a = tr.ckpt.best_step()
        tr.close()
        del tr
        torch.cuda.empty_cache()

        # exact resume: the step-6 checkpoint in a fresh directory
        os.makedirs(os.path.join(out_b, "checkpoints"))
        shutil.copytree(os.path.join(ckdir, str(PACKED_TRAINER_EVERY)),
                        os.path.join(out_b, "checkpoints",
                                     str(PACKED_TRAINER_EVERY)))
        tr_b = _packed_trainer(_packed_trainer_config(
            out_b, resume_from_checkpoint=str(PACKED_TRAINER_EVERY)), fake)
        _quiet(tr_b.train)
        torch.cuda.synchronize()
        launches = launch_counts()
        resumed = _logged(out_b)
        rec["resumed_losses"] = [v for _, v in resumed]
        require(resumed == losses[PACKED_TRAINER_EVERY:],
                f"packed_trainer: resumed losses equal bit for bit: "
                f"{resumed} {losses[PACKED_TRAINER_EVERY:]}")
        require(_logged(out_b, "eval", "avg_auroc") == [
            (PACKED_TRAINER_STEPS, evals[PACKED_TRAINER_STEPS])]
            and tr_b.ckpt.best_step() == best_a,
            "packed_trainer: resumed eval metric and best step equal")
        last = str(PACKED_TRAINER_STEPS)
        with open(os.path.join(out_b, "checkpoints", last, "meta.json")) as f:
            cursor_b = json.load(f)["cursor"]
        sa, sb = (torch.load(os.path.join(o, "checkpoints", last,
                                          "state.pt"), weights_only=True)
                  for o in (out_a, out_b))
        same = all(torch.equal(sa[k][n], sb[k][n])
                   for k in ("params", "mu", "nu") for n in sa[k])
        require(same and sa["step"] == sb["step"] == PACKED_TRAINER_STEPS
                and cursor_b == metas[last]["cursor"],
                f"packed_trainer: the resumed step-12 checkpoint and cursor "
                f"equal the uninterrupted ones bit for bit: {cursor_b} "
                f"{metas[last]['cursor']}")
        del sa, sb
        tr_b.close()
        del tr_b
        torch.cuda.empty_cache()
    rec["launches"] = launches
    emit(rec)
    # train steps: 12 in the first run, 6 resumed; eval forwards: the
    # cadence evals (2 + 1) and evaluate(), eval_batches each
    steps = PACKED_TRAINER_STEPS + PACKED_TRAINER_EVERY
    forwards = 4 * eval_batches
    per_step = packed_launches_per_step(12, dropout=False)
    want = {k: steps * v for k, v in per_step.items()}
    want["flash_attention_packed_fwd"] += 12 * forwards
    want["layer_norm"] += 25 * forwards
    require(launches == want,
            f"packed_trainer: launches {launches}, expected {want}")
    return launches


def phase_ddp_world1(fake) -> dict:
    """The data-parallel path on the one card: DDP_STEPS steps of the
    dense Trainer (batch 36, attention and hidden dropout 0.1, mixup 0.2)
    and of the PackedTrainer (both dropouts), first without a process
    group, then in an NCCL group of one process
    (``parallel.distributed.initialize`` at tcp://127.0.0.1 on a free
    port), where every step sums its gradients (and its loss, or the packed
    loss's numerator and denominator) in one all-reduce. The two runs'
    losses, grad norms and parameters after the last step must be equal bit
    for bit, with exactly one all-reduce a step. The group is torn down at
    the end. Returns the launches of the four runs."""
    import os
    import socket
    import tempfile

    import torch.distributed as td

    from chestxray_vit_tpu_torch.parallel import distributed as dist
    from chestxray_vit_tpu_torch.train.trainer import Trainer

    def dense(out):
        cfg = _trainer_config(out, max_steps=DDP_STEPS, eval_strategy="no",
                              save_strategy="no",
                              load_best_model_at_end=False,
                              report_to="none")
        cfg.model.attention_dropout = cfg.model.hidden_dropout = DROP_RATE
        cfg.data.mixup_alpha = MIXUP_ALPHA
        return Trainer(cfg, store=fake.store, pretrained=False)

    def packed(out):
        cfg = _packed_trainer_config(
            out, max_steps=DDP_STEPS, eval_strategy="no",
            save_strategy="no", load_best_model_at_end=False)
        cfg.model.attention_dropout = cfg.model.hidden_dropout = DROP_RATE
        return _packed_trainer(cfg, fake)

    def run(make, out):
        tr = make(out)
        t0 = time.perf_counter()
        _quiet(tr.train)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {"losses": [v for _, v in _logged(out)],
               "grad_norms": [v for _, v in _logged(out, key="grad_norm")],
               "params": {n: p.detach().clone()
                          for n, p in tr.state.params.named_parameters()},
               "wall_s": wall}
        tr.close()
        return got

    rec = {"phase": "ddp_world1", "steps": DDP_STEPS}
    calls = []
    real_all_reduce = td.all_reduce

    def counting(tensor, *a, **kw):
        calls.append(tensor.numel())
        return real_all_reduce(tensor, *a, **kw)

    runs = {}
    reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="cxr_ddp_") as tmp:
        for mode in ("alone", "group"):
            if mode == "group":
                with socket.socket() as s:
                    s.bind(("127.0.0.1", 0))
                    port = s.getsockname()[1]
                t0 = time.perf_counter()
                device = dist.initialize(f"tcp://127.0.0.1:{port}", 1, 0,
                                         device="cuda")
                rec["init_s"] = time.perf_counter() - t0
                rec["backend"] = td.get_backend()
                require(dist.is_initialized() and dist.world() == 1
                        and device == torch.device("cuda", 0)
                        and rec["backend"] == "nccl",
                        f"ddp_world1: an NCCL group of one on {device}")
                td.all_reduce = counting
            try:
                runs[mode] = {name: run(make, os.path.join(tmp, mode, name))
                              for name, make in (("dense", dense),
                                                 ("packed", packed))}
            finally:
                td.all_reduce = real_all_reduce
        torch.distributed.destroy_process_group()
    launches = launch_counts()
    require(not dist.is_initialized(), "ddp_world1: the group torn down")
    n_params = sum(p.numel() for p in runs["alone"]["dense"]["params"]
                   .values())
    rec["all_reduce_numels"] = calls
    for name in ("dense", "packed"):
        a, g = runs["alone"][name], runs["group"][name]
        rec[name] = {"losses": a["losses"], "grad_norms": a["grad_norms"],
                     "wall_s": [a["wall_s"], g["wall_s"]]}
        require(a["losses"] == g["losses"]
                and a["grad_norms"] == g["grad_norms"]
                and len(a["losses"]) == DDP_STEPS
                and all(torch.equal(a["params"][n], g["params"][n])
                        for n in a["params"]),
                f"ddp_world1: {name}: the group's losses, grad norms and "
                f"parameters equal the run without a group bit for bit: "
                f"{a['losses']} {g['losses']} {a['grad_norms']} "
                f"{g['grad_norms']}")
    # one all-reduce a step: the gradients with the loss (dense), or with
    # the numerator and denominator (packed), in one flat buffer
    require(calls == [n_params + 1] * DDP_STEPS + [n_params + 2] * DDP_STEPS,
            f"ddp_world1: all-reduce sizes {calls}")
    emit(rec)
    del runs
    torch.cuda.empty_cache()
    want = {k: 2 * DDP_STEPS * v for k, v in dense_launches_per_step(
        12, dropout=True).items()}
    for k, v in packed_launches_per_step(12, dropout=True).items():
        want[k] += 2 * DDP_STEPS * v
    require(launches == want,
            f"ddp_world1: launches {launches}, expected {want}")
    return launches


def _equal_params(a, b) -> list:
    """The names of the parameters of two ``ViT``s that differ (bits)."""
    other = dict(b.named_parameters()) if hasattr(b, "named_parameters") \
        else b
    return [n for n, p in a.named_parameters()
            if not torch.equal(p.detach(), other[n].detach().to(p.device))]


def phase_cli() -> dict:
    """The port's command line at full width on the card, through
    ``cli.main([...])`` in this process: an HF folder written by
    ``export_hf_folder`` from seeded ViT-B/16 @384 weights (the fake
    bucket's 15 classes) and read back bit for bit; ``train`` from that
    folder (``--preset version_b``, b8, bf16, the memory backend's fake
    bucket: CLI_STEPS steps, one eval and one save), its step-0 parameters
    equal to the folder's; ``eval`` and ``predict`` from the checkpoint;
    ``quantize --mode static`` on CLI_IMAGES PNGs and an int8
    ``Predictor.from_model_dir`` forward; ``export`` of the saved model,
    read back equal to the trained parameters; ``maps`` with rollout and
    gradcam; ``smoke``. Returns the launches of all of it."""
    import os
    import tempfile

    from chestxray_vit_tpu_torch import cli
    from chestxray_vit_tpu_torch.config import DataConfig, ModelConfig
    from chestxray_vit_tpu_torch.data import pipeline as pipe
    from chestxray_vit_tpu_torch.data.testing import build_fake_nih
    from chestxray_vit_tpu_torch.models.export_hf import export_hf_folder
    from chestxray_vit_tpu_torch.models.import_hf import (
        params_from_safetensors)
    from chestxray_vit_tpu_torch.models.vit import init_params
    from chestxray_vit_tpu_torch.serve.inference import Predictor

    rec = {"phase": "cli"}
    t_phase = time.perf_counter()
    fake = build_fake_nih(num_images=64)       # the CLI's memory bucket
    classes = pipe.build_datasets(DataConfig(backend="memory"),
                                  fake.store).classes
    cfg = ModelConfig(num_classes=len(classes))   # ViT-B/16 @384
    launches: dict = {}

    def run(name: str, argv: list) -> float:
        """``cli.main(argv)`` with what it prints on stderr; its wall
        seconds, and its launches added to the phase's."""
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, _ = _quiet(lambda: cli.main(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        rec[f"{name}_launches"] = {k: v for k, v in counts.items() if v}
        rec[f"{name}_wall_s"] = wall
        require(rc == 0, f"cli: {name} exit code {rc}")
        return wall

    with tempfile.TemporaryDirectory(prefix="cxr_cli_") as tmp:
        # 1. the HF folder round trip
        folder = os.path.join(tmp, "hf")
        seeded = init_params(torch.Generator().manual_seed(SEED), cfg,
                             device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        export_hf_folder(folder, seeded, cfg, classes)
        rec["hf_write_s"] = time.perf_counter() - t0
        rec["hf_bytes"] = os.path.getsize(
            os.path.join(folder, "model.safetensors"))
        t0 = time.perf_counter()
        back = params_from_safetensors(folder, cfg, device="cuda")
        torch.cuda.synchronize()
        rec["hf_read_s"] = time.perf_counter() - t0
        rec["hf_params"] = sum(p.numel() for p in back.parameters())
        differ = _equal_params(seeded, back)
        require(not differ, f"cli: HF folder read back bit for bit: "
                            f"{differ[:3]}")
        del seeded

        # 2. train from the folder, the Trainer caught for its checks
        out = os.path.join(tmp, "out")
        common = ["--device", "cuda", "--preset", "version_b",
                  "--set", "data.backend=memory",
                  "--set", f"model.model_name={folder}",
                  "--set", f"train.output_dir={out}"]
        seen = []
        build = cli._build_trainer

        def caught(cfg_, device, pretrained=True):
            tr = build(cfg_, device, pretrained)
            if pretrained and not seen:
                start = {n: p.detach().clone()
                         for n, p in tr.state.params.named_parameters()}
                tr._train_step = StepClock(tr._train_step)
                seen.append((tr, start))
            return tr

        cli._build_trainer = caught
        try:
            torch.cuda.reset_peak_memory_stats()
            run("train", ["train", *common,
                          "--set", f"train.max_steps={CLI_STEPS}",
                          "--set", f"train.eval_steps={CLI_STEPS}",
                          "--set", f"train.save_steps={CLI_STEPS}",
                          "--set", "train.logging_steps=1"])
            rec["train_max_memory_allocated_gb"] = \
                torch.cuda.max_memory_allocated() / 1e9
        finally:
            cli._build_trainer = build
        tr, start = seen[0]
        differ = _equal_params(back, start)
        require(not differ, f"cli: train's step-0 parameters are the "
                            f"folder's bit for bit: {differ[:3]}")
        step_ms = tr._train_step.step_ms()
        steady = [step_ms[s] for s in CLI_STEADY if s in step_ms]
        losses = [v for _, v in _logged(out)]
        rec.update(batch=tr.global_batch, steps=int(tr.state.step),
                   train_images=len(tr.bundle.train), losses=losses,
                   step_ms=step_ms, steady_step_ms=statistics.median(steady),
                   steady_images_per_s=tr.global_batch * 1e3
                   / statistics.median(steady),
                   eval_avg_auroc=_logged(out, "eval", "avg_auroc"),
                   checkpoint_save=tr.ckpt.last_save)
        require(len(losses) == CLI_STEPS and all(np.isfinite(losses))
                and os.listdir(os.path.join(out, "checkpoints"))
                == [str(CLI_STEPS)] and len(rec["eval_avg_auroc"]) == 2,
                f"cli: train ran {CLI_STEPS} finite steps, one cadence "
                f"eval (+ the final one) and one save: {rec}")
        moved = rec["train_launches"]
        require(all(moved.get(k, 0) > 0 for k in (
            "flash_attention_fwd", "flash_attention_bwd", "layer_norm",
            "layer_norm_bwd", "flash_attention_inference")),
            f"cli: train launched the attention and LayerNorm kernels: "
            f"{moved}")

        # 3. eval and predict from the checkpoint
        resume = ["--set", "train.resume_from_checkpoint=auto"]
        run("eval", ["eval", *common, *resume])
        run("predict", ["predict", *common, *resume])
        report = os.path.join(out, "final_classification_report.txt")
        with open(report) as f:
            text = f.read()
        require("samples avg" in text and os.path.exists(
            os.path.join(out, "eval_results.json")),
            "cli: eval_results.json and the classification report written")

        # 4. quantize on PNGs, then an int8 Predictor from the directory
        pngs = []
        for i, name in enumerate(fake.image_names[:CLI_IMAGES]):
            path = os.path.join(tmp, f"img{i}.png")
            with open(path, "wb") as f:
                f.write(fake.store.get(
                    f"images_{i % 12 + 1:03d}/images/{name}"))
            pngs.append(path)
        model_dir = os.path.join(out, "model")
        run("quantize", ["quantize", "--device", "cuda", "--model-dir",
                         model_dir, "--mode", "static", "--calibration",
                         *pngs])
        reset_launch_counts()
        pred = Predictor.from_model_dir(model_dir, quantize="static",
                                        batch_size=8, device="cuda")
        blobs = []
        for path in pngs:
            with open(path, "rb") as f:
                blobs.append(f.read())
        probs = pred.predict_bytes(blobs).probs
        torch.cuda.synchronize()
        counts = launch_counts()
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        rec["int8_predictor_launches"] = {k: v for k, v in counts.items()
                                          if v}
        require(probs.shape == (CLI_IMAGES, len(classes))
                and np.isfinite(probs).all()
                and counts["int8_matmul_fused"] > 0,
                f"cli: the int8 Predictor served on the fused kernel: "
                f"{counts}")
        del pred

        # 5. export the saved model: equal to the trained parameters
        hf2 = os.path.join(tmp, "hf2")
        run("export", ["export", "--model-dir", model_dir, "--out", hf2])
        exported = params_from_safetensors(hf2, cfg, device="cuda")
        differ = _equal_params(tr.state.params, exported)
        require(not differ, f"cli: the export equals the trained "
                            f"parameters bit for bit: {differ[:3]}")
        del exported, back, tr, start, seen

        # 6. maps, both methods
        for method in ("rollout", "gradcam"):
            maps_dir = os.path.join(tmp, f"maps_{method}")
            run(f"maps_{method}", ["maps", *pngs, "--model-dir", model_dir,
                                   "--out-dir", maps_dir, "--method",
                                   method, "--device", "cuda"])
            written = sorted(os.listdir(maps_dir))
            require(written == sorted(f"img{i}_attn.png"
                                      for i in range(CLI_IMAGES)),
                    f"cli: {method} overlays written: {written}")

        # 7. smoke (hidden 64 in four heads of 16: d = 16 on the card)
        run("smoke", ["smoke", "--device", "cuda", "--set",
                      f"train.output_dir={os.path.join(tmp, 'smoke')}"])
        require(rec["smoke_launches"].get("flash_attention_bwd", 0) > 0,
                f"cli: smoke ran the kernels: {rec['smoke_launches']}")
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    rec["launches"] = launches
    emit(rec)
    return launches


def int8_step_launches(n_layers: int, dropout: bool,
                       policy: Optional[str] = "full") -> dict:
    """Launches per int8 straight-through train step: the dense step's
    (:func:`dense_launches_per_step`) and the int8 kernel's, once for the
    patch embedding (outside the blocks), six times a block in the forward
    and again where the backward recomputes the block (``full``,
    ``flash_out``, ``dots``), or q, k and v again where it rebuilds them
    (``attn``, ``attn_mlp``)."""
    blocks = 2 if policy in ("full", "flash_out", "dots") else 1
    rebuilt = 3 if policy in ("attn", "attn_mlp") else 0
    return {**dense_launches_per_step(n_layers, dropout, policy),
            "int8_matmul_fused": 1 + (6 * blocks + rebuilt) * n_layers}


def calibrated_scales(params, cfg, batch: dict) -> dict:
    """``calibrate_vit_scales`` on the batch's prepared pixels, as a user
    calibrates the int8 train step on its first batch."""
    from chestxray_vit_tpu_torch.models.quantized import calibrate_vit_scales
    from chestxray_vit_tpu_torch.ops.preprocess import prepare_pixel_values

    images = prepare_pixel_values(batch, out_size=cfg.model.img_size,
                                  mean=cfg.data.image_mean,
                                  std=cfg.data.image_std)
    return calibrate_vit_scales(params, images, cfg.model)


def phase_train_int8(dense_rec: dict, tome_rates: dict) -> dict:
    """bench.py's step (ViT-B/16 @384, bf16, f32 masters, full remat, b36,
    seed-0 weights) on the int8 straight-through forward
    (``make_train_step(int8_scales=)``, scales calibrated on the batch):
    3 warm-up and 10 timed steps, step ms, images/s beside phase 6's dense
    step, peak memory, finite losses that fall, exact launches per step;
    then ``train_int8_tome``, the same merging tome_r 16 (constant) over 2 +
    5 steps beside phase 18's merged dense step, with each layer's
    attention length. Then ``train_int8_remat``: the first step under full
    remat, without remat and under ``mlp`` on the same weights and batch,
    without and with attention and hidden dropout 0.1 and mixup 0.2 on the
    same draws: equal bits, exact launches. Returns the launches of the
    timed runs."""
    from chestxray_vit_tpu_torch.models import tome_forward
    from chestxray_vit_tpu_torch.models.vit import init_params
    from chestxray_vit_tpu_torch.train import steps

    dev = torch.device("cuda")
    batch = bench_batch(TRAIN_BATCH, SEED, dev)
    launches, scales = {}, None
    r16 = TOME_STEPS[0]
    runs = (("train_int8", 0, "constant", WARMUP_STEPS, TIMED_STEPS,
             "dense", dense_rec["images_per_s"]),
            ("train_int8_tome", *r16, INT8_TOME_WARMUP_STEPS,
             INT8_TOME_TIMED_STEPS, f"tome_{r16[0]}_{r16[1]}",
             tome_rates[r16]))
    for name, r, schedule, warmup, timed, ref_name, ref_rate in runs:
        cfg = train_config(remat=True, tome_r=r, tome_schedule=schedule)
        per_step = int8_step_launches(cfg.model.num_layers, False)
        params = init_params(torch.Generator().manual_seed(SEED), cfg.model,
                             dev)
        if scales is None:
            t0 = time.perf_counter()
            scales = calibrated_scales(params, cfg, batch)
            calibrate_s = time.perf_counter() - t0
        run = run_steps(steps.make_train_step(cfg, total_steps=10_000,
                                              int8_scales=scales),
                        steps.TrainState.create(params, seed=42), batch,
                        warmup, timed)
        losses, norms = run["losses"], run["grad_norms"]
        rec = {"phase": name, "batch": TRAIN_BATCH, "remat": "full",
               "dtype": cfg.model.dtype, "tome_r": r,
               "tome_schedule": schedule, "warmup_steps": warmup,
               "timed_steps": timed, "step_ms": run["step_ms"],
               "images_per_s": TRAIN_BATCH * timed / run["wall"],
               f"{ref_name}_images_per_s": ref_rate,
               f"images_per_s_vs_{ref_name}":
                   TRAIN_BATCH * timed / run["wall"] / ref_rate,
               "max_memory_allocated_gb": run["peak_gb"],
               **({} if r else {"calibrate_s": calibrate_s}),
               "losses": losses,
               "grad_norms": norms,
               "launches_per_step": run["step_counts"][-1],
               "launches": run["launches"]}
        if r:
            with torch.no_grad():
                _, seen = record_merges(lambda: tome_forward.apply_tome_train(
                    params, batch["pixel_values"][:2], cfg.model, r,
                    train=False, schedule=schedule, int8_scales=scales))
            rec["attention_lengths"] = [n for n, _ in seen]
        emit(rec)
        require(all(np.isfinite(losses)) and all(np.isfinite(norms)),
                f"{name}: finite loss and grad_norm at every step")
        require(losses[-1] < losses[0], f"{name}: loss went down: {losses}")
        require(all(c == per_step for c in run["step_counts"]),
                f"{name}: launches per step {run['step_counts']} != "
                f"{per_step}")
        require(not r or rec["attention_lengths"] == list(
            TOME_LENGTHS[(r, schedule)]),
            f"{name}: attention lengths {rec.get('attention_lengths')}")
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
        del params, run
        torch.cuda.empty_cache()

    # full remat, none and mlp: equal bits on the same draws
    rows = {}
    drop = {"attention_dropout": DROP_RATE, "hidden_dropout": DROP_RATE}
    for label, alpha, extra in (("plain", 0.0, {}),
                                ("dropout_mixup", MIXUP_ALPHA, drop)):
        draws = [steps.draw(torch.Generator().manual_seed(SEED + 1),
                            train_config(alpha, **extra), TRAIN_BATCH)]
        ref = None
        for policy in ("full", None, "mlp"):
            cfg = train_config(alpha, remat=policy is not None,
                               remat_policy=policy or "full", **extra)
            params = init_params(torch.Generator().manual_seed(SEED),
                                 cfg.model, dev)
            step = steps.make_train_step(cfg, 10_000, int8_scales=scales)
            before = launch_counts()
            first = _first_step(step, params, batch, draws)
            after = launch_counts()
            counts = {k: after[k] - before[k] for k in after}
            ref = ref or first
            rows[f"{label}_{policy}"] = {
                "loss": first[0], "vs_full_remat": _against(first, ref),
                "launches": counts}
            require(rows[f"{label}_{policy}"]["vs_full_remat"]["bit_equal"],
                    f"int8 {label} remat {policy} against full remat: "
                    f"{rows[f'{label}_{policy}']['vs_full_remat']}")
            want = int8_step_launches(cfg.model.num_layers, bool(extra),
                                      policy)
            require(counts == want, f"int8 {label} remat {policy}: launches "
                                    f"{counts} != {want}")
            del params, step, first
            torch.cuda.empty_cache()
    emit({"phase": "train_int8_remat", "batch": TRAIN_BATCH,
          "dtype": "bfloat16",
          "dropout_mixup": {**drop, "mixup_alpha": MIXUP_ALPHA},
          "steps": rows})
    return launches


def phase_train_int8_cross_check(phase: str = "train_int8_cross_check",
                                 **model) -> None:
    """Depth 2, full width, batch 2, f32 (``model`` overrides fields, as
    phase_off8_model's OFF8_MODEL): the int8 train step on the card
    against the CPU (plain versions) on the same weights, scales
    (calibrated on the CPU) and injected draws, without and with attention
    dropout 0.1 and mixup 0.2 (hidden dropout draws from a generator of
    the tensor's device, so train_int8_remat covers it); and the
    eval-mode int8 forward's logits (the forward-only attention kernel)
    against the CPU's, before the step. Bounds: INT8_XCHECK."""
    from chestxray_vit_tpu_torch.models import bridge, int8_train
    from chestxray_vit_tpu_torch.models.vit import init_params
    from chestxray_vit_tpu_torch.train import steps

    rec = {"phase": phase, "depth": 2, "batch": 2, "tol": INT8_XCHECK,
           **({"model": model} if model else {})}
    for label, alpha, extra in (("plain", 0.0, {}),
                                ("dropout_mixup", MIXUP_ALPHA,
                                 {"attention_dropout": DROP_RATE})):
        cfg = train_config(alpha, **{"num_layers": 2, "dtype": "float32",
                                     **extra, **model})
        cpu_params = init_params(torch.Generator().manual_seed(SEED),
                                 cfg.model)
        tree = bridge.params_to_numpy(cpu_params)
        batch = bench_batch(2, SEED + 1, "cpu", cfg.model.img_size)
        scales = calibrated_scales(cpu_params, cfg, batch)
        draws = [steps.draw(torch.Generator().manual_seed(SEED), cfg, 2)]

        def run(params, device):
            dev_batch = {k: v.to(device) for k, v in batch.items()}
            with torch.no_grad():
                logits = int8_train.apply_int8_train(
                    params, dev_batch["pixel_values"], cfg.model, scales,
                    train=False).cpu()
            state, m = steps.make_train_step(cfg, 10_000,
                                             int8_scales=scales)(
                steps.TrainState.create(params, seed=0), dev_batch, draws)
            return (logits, m["loss"].item(),
                    _leaves(bridge.grads_to_numpy(state.params)),
                    _leaves(bridge.params_to_numpy(state.params)))

        c_logits, c_loss, c_g, c_p = run(cpu_params, "cpu")
        logits, loss, g, p = run(
            bridge.params_from_jax(tree, cfg.model).to("cuda"), "cuda")
        g_scale = max(float(np.abs(a).max()) for a in c_g)
        rec[label] = {
            "cpu_loss": c_loss,
            "logits_max_abs_diff": (logits - c_logits).abs().max().item(),
            "logit_corr": float(np.corrcoef(logits.numpy().ravel(),
                                            c_logits.numpy().ravel())[0, 1]),
            "logits_absmax": c_logits.abs().max().item(),
            "loss_diff": abs(loss - c_loss),
            "grads_rel_diff": max(float(np.abs(a - b).max())
                                  for a, b in zip(g, c_g)) / g_scale,
            "params_max_abs_diff": max(float(np.abs(a - b).max())
                                       for a, b in zip(p, c_p))}
    emit(rec)
    for label in ("plain", "dropout_mixup"):
        r = rec[label]
        require(bool(np.isfinite(r["cpu_loss"]))
                and r["logits_max_abs_diff"] <= INT8_XCHECK["logits"]
                and r["logit_corr"] > INT8_XCHECK["logit_corr"]
                and r["loss_diff"] <= INT8_XCHECK["loss"]
                and r["grads_rel_diff"] <= INT8_XCHECK["grads_rel"]
                and r["params_max_abs_diff"] <= INT8_XCHECK["params"],
                f"int8 train {label} {phase} card vs CPU: {r}")


def vith_config(**model):
    """ViT-H/14 @224 (``config.vit_variant_config("vit_h14")``: hidden 1280,
    32 layers, 16 heads of 80, MLP 5120, patch 14, 257 tokens), 15 classes,
    bf16 with f32 master weights and the variant's full remat; ``model``
    overrides fields (depth, dtype)."""
    return variant_config("vit_h14", 224, **model)


def variant_config(variant: str, img_size: int, **model):
    """A named variant's config (``config.vit_variant_config``: its width,
    depth, heads, MLP, patch and remat) at ``img_size``, 15 classes, bf16
    with f32 master weights; ``model`` overrides fields."""
    import dataclasses

    import chestxray_vit_tpu_torch as cxr
    from chestxray_vit_tpu_torch.config import vit_variant_config

    m = dataclasses.replace(vit_variant_config(variant, img_size=img_size),
                            **model)
    return cxr.Config(model=m, data=cxr.DataConfig(),
                      train=cxr.TrainConfig())


def phase_vit_h14(images: list) -> tuple:
    """ViT-H/14 @224 at full width and depth on the card, from seeded random
    weights: the dense bf16 Predictor at b8 and b32 (64 requests each:
    images/s, p50 ms, 32 attention and 65 LayerNorm launches a forward),
    the static int8 Predictor at b32 calibrated on 8 of the requests (193
    int8 launches a forward: the patch embedding's K = 588 padded to 640)
    and its cross-check against the CPU's static route (INT8_ROUTE_TOL,
    INT8_ROUTE_MIN_CORR), then the train step (VITH_TRAIN_BATCH, full remat:
    VITH_WARMUP_STEPS + VITH_TIMED_STEPS steps, ms a step, images/s, MFU by
    ``utils/flops``, peak GB, finite losses, exact launches a step) and one
    eval step with AUROC and F1 against the CPU's. Returns the launches of
    each main path's run."""
    return phase_variant("vit_h14", vith_config(), images[:VITH_REQUESTS],
                         serve=True, train=VITH_TRAIN_BATCH,
                         warmup=VITH_WARMUP_STEPS, timed=VITH_TIMED_STEPS)


def phase_variant(name: str, cfg, images: list, *, serve: bool = False,
                  train: int = TRAIN_BATCH, remat: bool = False,
                  adapt: Optional[int] = None, dropout: bool = False,
                  warmup: int = VARIANT_WARMUP_STEPS,
                  timed: int = VARIANT_TIMED_STEPS,
                  xcheck_dropout: bool = False,
                  serve_batches: tuple = (VITH_BATCH, VITH_INT8_BATCH)
                  ) -> tuple:
    """One named variant at full width and depth on the card, from seeded
    random weights (``<name>_init``): with ``adapt`` the tree is drawn at
    that image size and its position embeddings resampled on the card to
    ``cfg``'s grid (``<name>_adapt``: seconds, and the table against the
    CPU's adaptation of the same tree); with ``serve`` the dense bf16
    Predictor at each of ``serve_batches`` (b8 and b32: images/s, p50 ms,
    exact launches a forward)
    and the static int8 Predictor at b32 calibrated on 8 of the requests
    with its cross-check against the CPU's static route (INT8_ROUTE_TOL,
    INT8_ROUTE_MIN_CORR); the train step at batch ``train`` (``remat``
    turns full remat on where the variant runs without it), ``warmup`` +
    ``timed`` steps: ms a step, images/s, MFU by ``utils/flops``, peak GB,
    finite losses, exact launches a step; with ``dropout`` two more steps
    with attention and hidden dropout 0.1 (the mask strides of
    ``auto_block_q`` at the model's length; exact launches); one eval step
    with AUROC and F1 against the CPU's. Returns the launches of each main
    path's run."""
    import dataclasses

    from chestxray_vit_tpu_torch.eval import metrics
    from chestxray_vit_tpu_torch.models import vit
    from chestxray_vit_tpu_torch.ops import flash_attention as fa
    from chestxray_vit_tpu_torch.train import steps
    from chestxray_vit_tpu_torch.utils import flops

    dev = torch.device("cuda")
    if remat:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, remat=True))
    gen = torch.Generator().manual_seed(SEED)
    t0 = time.perf_counter()
    drawn = (dataclasses.replace(cfg.model, img_size=adapt) if adapt
             else cfg.model)
    params = vit.init_params(gen, drawn)
    emit({"phase": f"{name}_init", "seconds": time.perf_counter() - t0,
          "parameters": sum(p.numel() for p in params.parameters()),
          "head_dim": cfg.model.head_dim, "tokens": drawn.seq_len})
    if adapt:
        want = vit.adapt_params_to_img_size(params, cfg.model).pos_embed
        params = params.to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = vit.adapt_params_to_img_size(params, cfg.model)
        torch.cuda.synchronize()
        rec = {"phase": f"{name}_adapt", "from_img_size": adapt,
               "img_size": cfg.model.img_size, "from_tokens": drawn.seq_len,
               "tokens": cfg.model.seq_len,
               "seconds": time.perf_counter() - t0,
               "pos_embed_shape": list(params.pos_embed.shape),
               "pos_embed_vs_cpu_max_abs": (params.pos_embed.detach().cpu()
                                            - want).abs().max().item(),
               "tol": F32_ADAPT_TOL}
        emit(rec)
        require(rec["pos_embed_shape"] == [1, cfg.model.seq_len,
                                           cfg.model.hidden_size]
                and rec["pos_embed_vs_cpu_max_abs"] <= F32_ADAPT_TOL,
                f"{name}: the adapted position table: {rec}")
        params = params.cpu()
    launches = []
    if serve:
        for batch in serve_batches:
            launches.append(phase_serving(
                params, cfg.model, images, f"serving_{name}_b{batch}",
                batch)[1])
        torch.cuda.empty_cache()
        qp, imgs, fused_logits, serve_int8, _ = phase_serving_int8(
            params, cfg.model, images, f"serving_int8_{name}")
        phase_int8_cross_check(params, cfg.model, qp, imgs, fused_logits,
                               f"int8_cross_check_{name}")
        launches.append(serve_int8)
        del qp, imgs, fused_logits
        torch.cuda.empty_cache()

    params = params.to(dev)
    layers = cfg.model.num_layers
    policy = cfg.model.remat_policy if cfg.model.remat else None
    per_step = dense_launches_per_step(layers, dropout=False, policy=policy)
    batch = bench_batch(train, SEED, dev, cfg.model.img_size)
    state = steps.TrainState.create(params, seed=42)
    run = run_steps(steps.make_train_step(cfg, total_steps=10_000), state,
                    batch, warmup, timed)
    images_per_s = train * timed / run["wall"]
    rec = {"phase": f"train_{name}", "batch": train, "remat": policy,
           "dtype": cfg.model.dtype, "warmup_steps": warmup,
           "timed_steps": timed, "step_ms": run["step_ms"],
           "images_per_s": images_per_s,
           "model_flops_per_image": flops.model_flops_per_image(cfg.model),
           "peak_flops": flops.chip_peak_flops(),
           "mfu": flops.mfu(images_per_s, cfg.model),
           "max_memory_allocated_gb": run["peak_gb"],
           "losses": run["losses"], "grad_norms": run["grad_norms"],
           "launches_per_step": run["step_counts"][-1],
           "launches": run["launches"]}
    if name != "vit_h14":
        rec.update(variant=name, tokens=cfg.model.seq_len,
                   hidden=cfg.model.hidden_size, layers=layers,
                   heads=cfg.model.num_heads, mlp=cfg.model.mlp_dim,
                   patch=cfg.model.patch_size)
    emit(rec)
    require(all(np.isfinite(run["losses"]))
            and all(np.isfinite(run["grad_norms"])),
            f"train_{name}: finite losses: {rec}")
    require(name != "vit_h14" or cfg.model.remat,
            f"train_{name}: full remat: {rec}")
    require(all(c == per_step for c in run["step_counts"]),
            f"train_{name} launches per step {run['step_counts']} != "
            f"{per_step}")
    launches.append(run["launches"])
    del state, run
    torch.cuda.empty_cache()

    if dropout:
        drop_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, attention_dropout=DROP_RATE,
            hidden_dropout=DROP_RATE))
        want = dense_launches_per_step(layers, dropout=True, policy=policy)
        state = steps.TrainState.create(params, seed=42)
        run = run_steps(steps.make_train_step(drop_cfg, total_steps=10_000),
                        state, batch, 1, 1)
        s = cfg.model.seq_len
        rec = {"phase": f"train_{name}_dropout", "batch": train,
               "rate": DROP_RATE, "tokens": s, "block_q": fa.auto_block_q(s),
               "mask_strides": list(fa.mask_strides(s, fa.auto_block_q(s))),
               "step_ms": run["step_ms"], "losses": run["losses"],
               "max_memory_allocated_gb": run["peak_gb"],
               "launches_per_step": run["step_counts"][-1]}
        emit(rec)
        require(all(np.isfinite(run["losses"])),
                f"train_{name}_dropout: finite losses: {rec}")
        require(all(c == want for c in run["step_counts"]),
                f"train_{name}_dropout launches {run['step_counts']} != "
                f"{want}")
        launches.append(run["launches"])
        del state, run
        torch.cuda.empty_cache()
    del batch

    eval_batch = bench_batch(train, SEED + 10, dev, cfg.model.img_size)
    reset_launch_counts()
    logits, rows = steps.make_eval_step(cfg)(params, eval_batch)
    torch.cuda.synchronize()
    eval_launches = launch_counts()
    card = metrics.compute_metrics(logits, eval_batch["labels"])
    cpu = metrics.compute_metrics(logits.cpu(), eval_batch["labels"].cpu())
    rec = {"phase": f"eval_{name}", "batch": train,
           "logits_shape": list(logits.shape),
           "finite": bool(torch.isfinite(logits).all()
                          and torch.isfinite(rows).all()),
           "metrics_card": card, "metrics_cpu": cpu,
           "launches": eval_launches}
    emit(rec)
    require(rec["finite"] and logits.shape == (train, 15),
            f"eval_{name}: finite logits [{train}, 15]")
    require(all(abs(card[k] - cpu[k]) <= 1e-6 for k in card),
            f"eval_{name} metrics card vs CPU: {card} {cpu}")
    require(eval_launches["flash_attention_inference"] == layers
            and eval_launches["layer_norm"] == 2 * layers + 1,
            f"eval_{name} launches {eval_launches}")
    launches.append(eval_launches)
    del params, eval_batch, logits, rows
    torch.cuda.empty_cache()
    return tuple(launches)


def phase_vit_h14_cross_check() -> None:
    """ViT-H/14 at full width and depth 2, in f32: the card's logits (the
    inference kernel, LayerNorm at 1280 in f32) against the CPU's plain
    versions on the same weights and images (F32_LOGIT_TOL), and one train
    step's loss and gradients (phase_train_cross_check's bounds)."""
    phase_variant_cross_check("vit_h14", vith_config(num_layers=2,
                                                     dtype="float32"))


def phase_variant_cross_check(name: str, cfg, dropout: bool = False) -> None:
    """A variant at full width and depth 2, in f32: the card's logits
    against the CPU's plain versions on the same weights and images
    (F32_LOGIT_TOL), and one train step's loss, gradients and parameters
    (phase_train_cross_check's bounds; the parameters by VITH_XCHECK_PARAMS'
    ~2 lr: a wide model has weights whose gradient is near 0, where AdamW's
    first step turns a summation-order difference into up to 2 lr). With
    ``dropout``, the train step with attention and hidden dropout 0.1 on
    injected seeds."""
    from chestxray_vit_tpu_torch.models import vit

    cfg = cfg.model if hasattr(cfg, "model") else cfg
    params = vit.init_params(torch.Generator().manual_seed(SEED), cfg)
    x = bench_batch(2, SEED + 1, "cpu", cfg.img_size)["pixel_values"]
    with torch.no_grad():
        cpu = vit.apply(params, x, cfg, train=False)
        card = vit.apply(params.to("cuda"), x.cuda(), cfg, train=False).cpu()
    diff = (card - cpu).abs().max().item()
    rec = {"phase": f"{name}_cross_check", "depth": 2, "batch": 2,
           "dtype": "float32", "logits_max_abs_diff": diff,
           "tol": F32_LOGIT_TOL, "cpu_logits_absmax": cpu.abs().max().item()}
    if name != "vit_h14":
        rec.update(img_size=cfg.img_size, hidden=cfg.hidden_size,
                   heads=cfg.num_heads)
    emit(rec)
    require(bool(torch.isfinite(card).all()) and diff <= F32_LOGIT_TOL,
            f"{name} logits card vs CPU: {diff}")
    del params
    model = {k: getattr(cfg, k) for k in ("hidden_size", "num_heads",
                                          "mlp_dim", "patch_size")}
    if dropout:
        model.update(attention_dropout=DROP_RATE, hidden_dropout=DROP_RATE)
    phase_train_cross_check(f"{name}_train_cross_check", dtypes=("f32",),
                            img_size=cfg.img_size,
                            params_tol=VITH_XCHECK_PARAMS, **model)


def phase_variants(images: list) -> list:
    """Phase 39: every run of VARIANT_RUNS (:func:`phase_variant`), each
    followed by its depth-2 f32 check against the CPU
    (:func:`phase_variant_cross_check`). Returns the launches of every main
    path's run."""
    launches = []
    for name, variant, img, kw in VARIANT_RUNS:
        kw = dict(kw)
        xcheck_dropout = kw.pop("xcheck_dropout", False)
        cfg = variant_config(variant, img)
        launches += phase_variant(name, cfg, images[:VARIANT_REQUESTS],
                                  **kw)
        phase_variant_cross_check(
            name, variant_config(variant, img, num_layers=2,
                                 dtype="float32"), dropout=xcheck_dropout)
    return launches


def phase_vit_b16_h3(images: list) -> tuple:
    """Phase 40: ViT-B/16 @384 in three heads of 256 at full width and depth
    (the JAX CLI's ``--model vit_b16 --set model.num_heads=3``), from
    seeded weights, on the wide attention kernels: the dense bf16
    Predictor at b8, the static int8 Predictor at b32 with its forward
    times and its cross-check against the CPU, bench.py's train step (b36,
    full remat, 3 + 8 steps: ms a step, images/s, MFU, peak GB, exact
    launches a step), one eval step, then the depth-2 f32 check against
    the CPU (logits, loss, gradients, parameters after one step). Returns
    the launches of each main path's run."""
    launches = phase_variant(
        "vit_b16_h3", variant_config("vit_b16", 384, num_heads=3),
        images[:VARIANT_REQUESTS], serve=True, serve_batches=(VITH_BATCH,),
        train=TRAIN_BATCH, remat=True, warmup=3, timed=8)
    phase_variant_cross_check(
        "vit_b16_h3", variant_config("vit_b16", 384, num_heads=3,
                                     num_layers=2, dtype="float32"))
    return launches


def phase_off8_model(images: list) -> tuple:
    """Phase 41: a model off every multiple of 8 on the card (OFF8_MODEL:
    hidden 50 in two heads of 25, MLP 100, patch 16, 64 px, depth 2), which
    needs the zero-padded head dim, the any-width LayerNorm and the int8
    tail and K padding together: the f32 forward and one f32 train step
    against the CPU (phase_variant_cross_check, train_cross_check's
    bounds), the f32 eval step's logits and metrics against the CPU's, and
    the static int8 Predictor (bf16, b8, calibrated on 8 requests) against
    the CPU's on the same weights and calibration (INT8_ROUTE_TOL), and
    the int8 straight-through train step against the CPU
    (phase_train_int8_cross_check's INT8_XCHECK, without and with dropout
    and mixup). Each card run's launches are counted from 0 and returned:
    the attention, LayerNorm and int8 kernels must all have run."""
    import dataclasses

    import chestxray_vit_tpu_torch as cxr
    from chestxray_vit_tpu_torch.eval import metrics
    from chestxray_vit_tpu_torch.models import vit
    from chestxray_vit_tpu_torch.train import steps

    cfg = train_config(dtype="float32", **OFF8_MODEL)
    reset_launch_counts()
    phase_variant_cross_check("off8", cfg)
    fwd_launches = launch_counts()
    params = vit.init_params(torch.Generator().manual_seed(SEED), cfg.model)
    batch = bench_batch(8, SEED + 2, "cpu", OFF8_MODEL["img_size"])
    cpu_logits, _ = steps.make_eval_step(cfg)(params, batch)
    reset_launch_counts()
    card_logits, rows = steps.make_eval_step(cfg)(
        params.to("cuda"), {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    eval_launches = launch_counts()
    diff = (card_logits.cpu() - cpu_logits).abs().max().item()
    card = metrics.compute_metrics(card_logits, batch["labels"].cuda())
    cpu = metrics.compute_metrics(cpu_logits, batch["labels"])
    rec = {"phase": "eval_off8", "model": OFF8_MODEL, "batch": 8,
           "logits_max_abs_diff": diff, "tol": F32_LOGIT_TOL,
           "metrics_card": card, "metrics_cpu": cpu,
           "launches": eval_launches}
    emit(rec)
    require(bool(torch.isfinite(card_logits).all()) and diff <= F32_LOGIT_TOL
            and all(abs(card[k] - cpu[k]) <= 1e-6 for k in card),
            f"eval_off8 card vs CPU: {rec}")

    bf16 = dataclasses.replace(cfg.model, dtype="bfloat16")
    params = params.cpu()
    kw = dict(batch_size=BATCH, placement="device", quantize="static",
              calibration=images[:8])
    reset_launch_counts()
    pred = cxr.Predictor(params, bf16, device="cuda", **kw)
    got = pred.predict_arrays(images[:BATCH]).logits
    torch.cuda.synchronize()
    int8_launches = launch_counts()
    want = cxr.Predictor(params, bf16, device="cpu", **kw).predict_arrays(
        images[:BATCH]).logits
    diff = float(np.abs(got - want).max())
    shapes = {key: list(getattr(pred._fwd_params.blocks[0], key).qw.q.shape)
              for key in ("wq", "wo", "mlp_in", "mlp_out")}
    rec = {"phase": "serving_int8_off8", "model": OFF8_MODEL, "batch": BATCH,
           "logits_max_abs_diff": diff, "tol": INT8_ROUTE_TOL,
           "int8_weight_shapes": shapes, "launches": int8_launches}
    emit(rec)
    require(np.isfinite(got).all() and diff <= INT8_ROUTE_TOL,
            f"serving_int8_off8 card vs CPU: {rec}")
    reset_launch_counts()
    phase_train_int8_cross_check("train_int8_off8", **OFF8_MODEL)
    int8_train_launches = launch_counts()
    for name, runs in (("flash_attention_inference", (fwd_launches,
                                                      eval_launches,
                                                      int8_launches,
                                                      int8_train_launches)),
                       ("layer_norm", (fwd_launches, eval_launches,
                                       int8_launches, int8_train_launches)),
                       ("int8_matmul_fused", (int8_launches,
                                              int8_train_launches))):
        require(all(r.get(name, 0) > 0 for r in runs),
                f"off8 runs launched {name}: {runs}")
    return fwd_launches, eval_launches, int8_launches, int8_train_launches


def head_dim_segments(b: int, s: int, dev) -> torch.Tensor:
    """int32 [b, s] ids: two segments and a pad tail of s // 8 (id −1),
    rolled by 7 · row so that the rows differ."""
    ids = np.repeat([0, 1, -1], [s // 2, s - s // 2 - s // 8, s // 8])
    return torch.tensor(np.stack([np.roll(ids, 7 * i) for i in range(b)]),
                        dtype=torch.int32, device=dev)


def check_head_dims(randn, summary: dict) -> None:
    """Every attention kernel at the head dims of HEAD_DIMS, in bf16 and f32,
    at HEAD_DIM_LENGTHS, within ATTN_TOL of its plain version: the
    inference, training and dropout forwards (o, lse) and their backwards
    (every element of dq, dk, dv; the relative error of each is recorded
    beside it), the four segment kernels likewise on two segments and a pad
    tail; the debug kernel's mask equal to the plain counter hash and to
    its mask at d = 64 on the same S, seed and row base (the counter holds
    no d). Then the padding itself, bit for bit (HEAD_DIM_PADS): the
    training forward and backward, dense and packed, at d equal the same
    kernels at a wider d on operands zero-padded to it, so the columns past
    d add nothing and the last chunk's skipped steps change no bit. Then
    the inference, training forward and backward timed at ViT-H/14's shapes
    (VITH_ATTN_SHAPES) beside the plain versions, SDPA's flash kernel and
    the bound by the real d (80: the kernels compute a 128-wide tile, the
    bound does not count the padding)."""
    from chestxray_vit_tpu_torch.ops import flash_attention as fa

    b, h = HEAD_DIM_BATCH, HEAD_DIM_HEADS
    worst = {}                       # kernel -> {d: largest error}

    def note(name, d, err):
        by_d = worst.setdefault(name, {})
        by_d[d] = max(by_d.get(d, 0.0), err)

    for d in HEAD_DIMS:
        lengths = (HEAD_DIM_LENGTHS if d % 8 == 0 and d <= 128
                   else WIDE_HEAD_DIM_LENGTHS)
        for dtype in (torch.bfloat16, torch.float32):
            tol = ATTN_TOL[dtype]
            for s in lengths:
                shape = (b, h, s, d)
                x = randn((b, s, 3, h, d), dtype)
                q, k, v = (t.transpose(1, 2) for t in x.unbind(2))
                do = randn(shape, dtype)
                seg = head_dim_segments(b, s, q.device)
                bq, pbq = fa.auto_block_q(s), fa.packed_block_q(s)
                drop = (DROP_SEED, DROP_RATE)
                rec = {"phase": "kernel_check", "kernel": "head_dims",
                       "shape": list(shape), "dtype": str(dtype)}

                def fwd_err(name, got, ref):
                    err = max((got[0].float() - ref[0].float()).abs().max()
                              .item(), (got[1] - ref[1]).abs().max().item())
                    rec[name] = err
                    note(name, d, err)
                    require(bool(torch.isfinite(got[0]).all())
                            and err <= tol,
                            f"{name} d={d} S={s} {dtype}: {err}")
                    return got

                def bwd_err(name, got, ref):
                    err = max((g.float() - r.float()).abs().max().item()
                              for g, r in zip(got, ref))
                    rec[name] = err
                    rec[f"{name}_rel"] = max(rel_err(g, r)
                                             for g, r in zip(got, ref))
                    note(name, d, err)
                    require(all(bool(torch.isfinite(g).all()) for g in got)
                            and err <= tol,
                            f"{name} d={d} S={s} {dtype}: {err}")

                out = fa.flash_attention_inference(q, k, v)
                err = (out.float() - fa.attention_reference(q, k, v)
                       .float()).abs().max().item()
                rec["flash_attention_inference"] = err
                note("flash_attention_inference", d, err)
                require(bool(torch.isfinite(out).all()) and err <= tol,
                        f"inference d={d} S={s} {dtype}: {err}")
                o, lse = fwd_err("flash_attention_fwd",
                                 fa.flash_attention_fwd(q, k, v),
                                 fa.attention_fwd_reference(q, k, v))
                bwd_err("flash_attention_bwd",
                        fa.flash_attention_bwd(q, k, v, o, lse, do),
                        fa.attention_bwd_reference(q, k, v, o, lse, do))
                o, lse = fwd_err(
                    "flash_attention_dropout_fwd",
                    fa.flash_attention_dropout_fwd(q, k, v, *drop,
                                                   block_q=bq),
                    fa.attention_dropout_fwd_reference(q, k, v, *drop,
                                                       block_q=bq))
                bwd_err("flash_attention_dropout_bwd",
                        fa.flash_attention_dropout_bwd(
                            q, k, v, o, lse, do, *drop, block_q=bq),
                        fa.attention_dropout_bwd_reference(
                            q, k, v, o, lse, do, *drop, block_q=bq))
                o_dbg, keep = fa.flash_attention_dropout_debug(
                    q, k, v, *drop, block_q=bq, row_base=ROW_BASE_PROBE)
                x64 = randn((b, s, 3, h, 64), dtype)
                _, keep64 = fa.flash_attention_dropout_debug(
                    *(t.transpose(1, 2) for t in x64.unbind(2)), *drop,
                    block_q=bq, row_base=ROW_BASE_PROBE)
                ref_keep = fa._keep(q, *drop, bq, ROW_BASE_PROBE)
                err = (o_dbg.float() - fa.attention_dropout_fwd_reference(
                    q, k, v, *drop, block_q=bq, row_base=ROW_BASE_PROBE)[0]
                    .float()).abs().max().item()
                rec["flash_attention_dropout_debug"] = err
                note("flash_attention_dropout_debug", d, err)
                rec["mask_mismatches"] = int((keep != ref_keep).sum())
                rec["mask_equals_d64"] = torch.equal(keep, keep64)
                require(err <= tol and rec["mask_mismatches"] == 0
                        and rec["mask_equals_d64"],
                        f"dropout debug d={d} S={s} {dtype}: {rec}")
                for name, fwd, rfwd, bwd, rbwd, extra in (
                        ("flash_attention_packed",
                         fa.flash_attention_packed_fwd,
                         fa.attention_packed_fwd_reference,
                         fa.flash_attention_packed_bwd,
                         fa.attention_packed_bwd_reference, ()),
                        ("flash_attention_packed_dropout",
                         fa.flash_attention_packed_dropout_fwd,
                         fa.attention_packed_dropout_fwd_reference,
                         fa.flash_attention_packed_dropout_bwd,
                         fa.attention_packed_dropout_bwd_reference,
                         (*drop, None, pbq))):
                    o, lse = fwd_err(f"{name}_fwd",
                                     fwd(q, k, v, seg, *extra),
                                     rfwd(q, k, v, seg, *extra))
                    bwd_err(f"{name}_bwd",
                            bwd(q, k, v, seg, o, lse, do, *extra),
                            rbwd(q, k, v, seg, o, lse, do, *extra))
                emit(rec)
                del x, q, k, v, do, o, lse, x64
            torch.cuda.empty_cache()

    for d, wide in HEAD_DIM_PADS:
        s, dtype = VITH_TOKENS, torch.bfloat16
        x = randn((b, s, 3, h, d), dtype)
        q, k, v = (t.transpose(1, 2) for t in x.unbind(2))
        do = randn((b, h, s, d), dtype)
        seg = head_dim_segments(b, s, q.device)
        padded = [torch.nn.functional.pad(t, (0, wide - d)).contiguous()
                  for t in (q, k, v, do)]
        scale = d ** -0.5
        rec = {"phase": "kernel_check", "kernel": "head_dim_padding",
               "shape": [b, h, s, d], "against_d": wide, "dtype": str(dtype)}
        for name, fwd, bwd, extra in (
                ("dense", fa.flash_attention_fwd, fa.flash_attention_bwd, ()),
                ("packed", fa.flash_attention_packed_fwd,
                 fa.flash_attention_packed_bwd, (seg,))):
            o, lse = fwd(q, k, v, *extra, scale)
            ow, lsew = fwd(*padded[:3], *extra, scale)
            grads = bwd(q, k, v, *extra, o, lse, do, scale)
            wgrads = bwd(*padded[:3], *extra, ow, lsew, padded[3], scale)
            rec[name] = (torch.equal(o, ow[..., :d]) and torch.equal(lse, lsew)
                         and not bool(ow[..., d:].any())
                         and all(torch.equal(g, w[..., :d])
                                 for g, w in zip(grads, wgrads)))
        emit(rec)
        require(rec["dense"] and rec["packed"],
                f"head dim {d} against {wide} zero-padded: {rec}")
        del x, q, k, v, do, padded

    timed = {}
    for shape in WIDE_ATTN_SHAPES:
        time_wide_attention(randn, shape, summary)
    for shape in VITH_ATTN_SHAPES:
        dtype = torch.bfloat16
        x = randn((shape[0], shape[2], 3, shape[1], shape[3]), dtype)
        q, k, v = (t.transpose(1, 2) for t in x.unbind(2))
        do = randn(shape, dtype)
        o, lse = fa.flash_attention_fwd(q, k, v)
        lib_fwd, lib_bwd = library_attention(q, k, v, do)
        lib_fwd_dev, lib_bwd_dev = library_attention_device_ms(q, k, v, do)
        for name, kernel, plain, kw in (
                ("flash_attention_inference",
                 lambda: fa.flash_attention_inference(q, k, v),
                 lambda: fa.attention_reference(q, k, v), {}),
                ("flash_attention_fwd",
                 lambda: fa.flash_attention_fwd(q, k, v),
                 lambda: fa.attention_fwd_reference(q, k, v), {"lse": True}),
                ("flash_attention_bwd",
                 lambda: fa.flash_attention_bwd(q, k, v, o, lse, do),
                 lambda: fa.attention_bwd_reference(q, k, v, o, lse, do),
                 {"backward": True})):
            ms, plain_ms = time_pair(kernel, plain)
            rec = {"phase": "kernel_check", "kernel": name,
                   "model": "vit_h14", "shape": list(shape),
                   "dtype": str(dtype), "ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_bwd if name.endswith("bwd")
                   else lib_fwd,
                   "library_device_ms": lib_bwd_dev if name.endswith("bwd")
                   else lib_fwd_dev,
                   **attention_bound(shape, dtype, **kw)}
            rec.update(backward_pass_ms(kernel) if name.endswith("bwd")
                       else device_ms(kernel))
            emit(rec)
            timed.setdefault(name, []).append(
                {k: rec[k] for k in ("shape", "ms", "device_ms", "plain_ms",
                                     "library_ms", "library_device_ms",
                                     "bound_ms", "bound_by")})
        del x, q, k, v, do, o, lse
        torch.cuda.empty_cache()
    for name, by_d in worst.items():
        entry = {"max_err_by_d": {str(d): e for d, e in by_d.items()}}
        if name in timed:
            entry["vit_h14"] = timed[name]
        summary["head_dims"][name] = entry


def library_sdpa(q, k, v, do) -> dict:
    """The first of SDPA's fused backends (flash, memory-efficient, cuDNN)
    that takes the shape: its name and its forward and backward times (CUDA
    events and the profiler's device time) on contiguous copies of the
    operands; backend "—" and no times where none takes it. A yardstick,
    never called by the port: a backend that refuses the shape raises at
    its first call, and the next one is asked."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION"):
        backend = getattr(SDPBackend, name)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        try:
            with sdpa_kernel(backend):
                o = sdpa(*leaves)
            torch.autograd.grad(o, leaves, do, retain_graph=True)
            torch.cuda.synchronize()
        except RuntimeError:
            continue

        def fwd():
            with sdpa_kernel(backend), torch.no_grad():
                return sdpa(q, k, v)

        def bwd():
            return torch.autograd.grad(o, leaves, do, retain_graph=True)
        return {"library_backend": name.lower(), "library_ms": time_ms(fwd),
                "library_bwd_ms": time_ms(bwd),
                "library_device_ms": device_ms(fwd)["device_ms"],
                "library_bwd_device_ms": device_ms(bwd)["device_ms"]}
    return {"library_backend": "—", "library_ms": None,
            "library_bwd_ms": None, "library_device_ms": None,
            "library_bwd_device_ms": None}


def time_wide_attention(randn, shape, summary: dict) -> None:
    """The wide attention kernels at a WIDE_ATTN_SHAPES shape (q, k, v as
    the projections' [B, S, H, d] views): the inference kernel at the
    serving batch, the training forward and backward at the train batch,
    each held against its plain version on the same inputs (the output
    and lse within ATTN_TOL, dq, dk, dv within ATTN_GRAD_TOL of the
    largest), then timed by CUDA events and the profiler's device time
    (the backward by pass) beside the plain version, SDPA (library_sdpa:
    the backend that ran) and the bound by the real d."""
    from chestxray_vit_tpu_torch.ops import flash_attention as fa

    dtype = torch.bfloat16
    tol, gtol = ATTN_TOL[dtype], ATTN_GRAD_TOL[dtype]
    x = randn((shape[0], shape[2], 3, shape[1], shape[3]), dtype)
    q, k, v = (t.transpose(1, 2) for t in x.unbind(2))
    do = randn(shape, dtype)
    o, lse = fa.flash_attention_fwd(q, k, v)
    lib = library_sdpa(q, k, v, do)
    if shape[0] == TRAIN_BATCH:
        cases = (("flash_attention_fwd",
                  lambda: fa.flash_attention_fwd(q, k, v),
                  lambda: fa.attention_fwd_reference(q, k, v), {"lse": True}),
                 ("flash_attention_bwd",
                  lambda: fa.flash_attention_bwd(q, k, v, o, lse, do),
                  lambda: fa.attention_bwd_reference(q, k, v, o, lse, do),
                  {"backward": True}))
    else:
        cases = (("flash_attention_inference",
                  lambda: fa.flash_attention_inference(q, k, v),
                  lambda: fa.attention_reference(q, k, v), {}),)
    for name, kernel, plain, kw in cases:
        bwd = name.endswith("bwd")
        got, ref = kernel(), plain()
        if bwd:
            err = max(rel_err(g, r) for g, r in zip(got, ref))
        elif isinstance(got, tuple):
            err = max((got[0].float() - ref[0].float()).abs().max().item(),
                      (got[1] - ref[1]).abs().max().item())
        else:
            err = (got.float() - ref.float()).abs().max().item()
        del got, ref
        require(err <= (gtol if bwd else tol),
                f"{name} at {list(shape)} against its plain version: {err}")
        ms, plain_ms = time_pair(kernel, plain)
        rec = {"phase": "kernel_check", "kernel": name, "model": "vit_b16_h3",
               "shape": list(shape), "dtype": str(dtype), "max_err": err,
               "ms": ms,
               "plain_ms": plain_ms, "library_backend": lib["library_backend"],
               "library_ms": lib["library_bwd_ms" if bwd else "library_ms"],
               "library_device_ms": lib["library_bwd_device_ms" if bwd
                                         else "library_device_ms"],
               **attention_bound(shape, dtype, **kw)}
        rec.update(backward_pass_ms(kernel) if bwd else device_ms(kernel))
        emit(rec)
        summary["wide"].setdefault(name, []).append(
            {k: rec[k] for k in ("shape", "max_err", "ms", "device_ms",
                                 "plain_ms", "library_backend", "library_ms",
                                 "library_device_ms", "bound_ms",
                                 "bound_by")})
    del x, q, k, v, do, o, lse
    torch.cuda.empty_cache()


def check_int8_off8(gen, summary: dict) -> None:
    """The int8 kernel at N and K off 8 and 64 (OFF8_INT8_FORMS: the
    wrapper pads K with zero columns, the kernel's tail epilogue writes N
    element by element) against its plain version, every output equal and
    the same bits twice, timed beside the plain version (torch._int_mm
    takes no such K or N: no library time), and the int32 out form at
    N = 50."""
    from chestxray_vit_tpu_torch.ops import int8_matmul as i8

    for form in OFF8_INT8_FORMS:
        rec = int8_form_check(gen, *form)
        summary["wide"].setdefault("int8_matmul_fused", []).append(
            {k: rec[k] for k in ("form", "m_k_n", "mismatched", "ms",
                                 "device_ms", "plain_ms", "library_ms",
                                 "bound_ms", "bound_by")})
    xq, wq, _, _, _ = int8_operands(gen, 8 * 577, 100, 50, False, False)
    got = i8.int8_matmul_fused(xq, wq, out_dtype=torch.int32)
    ref = i8.int8_matmul_fused_reference(xq, wq, out_dtype=torch.int32)
    rec = {"phase": "kernel_check", "kernel": "int8_matmul_fused",
           "form": "off8_int32", "m_k_n": [8 * 577, 100, 50],
           "mismatched": int((got != ref).sum())}
    emit(rec)
    require(rec["mismatched"] == 0, f"int8 int32 out at N = 50: {rec}")


def check_int8_patch14(gen, summary: dict) -> None:
    """The int8 kernel at ViT-H/14's patch embedding: K = 3 · 14 · 14 = 588,
    xq and wq zero-padded to 640 (ops/int8_matmul.pad_k) as the int8 paths
    pad them. The output equals the plain version's on the unpadded
    operands (on the CPU: the card's plain product takes K a multiple of
    8 only) at 8 images of 256 patches; timed at the b32 rows beside
    ``torch._int_mm`` on the padded operands, the bound counting the real
    K."""
    from chestxray_vit_tpu_torch.ops import int8_matmul as i8

    k, n = 3 * 14 * 14, VITH_HIDDEN
    for m, timed in ((8 * 256, False), (VITH_INT8_BATCH * 256, True)):
        xq, wq, scale, bias, _ = int8_operands(gen, m, k, n, False, False)
        xp, wp = i8.pad_k(xq), i8.pad_k(wq)
        out = i8.int8_matmul_fused(xp, wp, scale, bias)
        rec = {"phase": "kernel_check", "kernel": "int8_matmul_fused",
               "form": "vit_h14_patch_embed", "m_k_n": [m, k, n],
               "k_padded": xp.shape[1]}
        if not timed:
            ref = i8.int8_matmul_fused_reference(xq.cpu(), wq.cpu(),
                                                 scale.cpu(), bias.cpu())
            rec["mismatched"] = int((out.cpu() != ref).sum())
            emit(rec)
            require(rec["mismatched"] == 0,
                    f"int8 K=588 padded against unpadded: {rec}")
            continue
        wt = wp.t()
        rec.update(ms=time_ms(lambda: i8.int8_matmul_fused(xp, wp, scale,
                                                           bias)),
                   plain_ms=time_ms(lambda: i8.int8_matmul_fused_reference(
                       xp, wp, scale, bias)),
                   library_ms=time_ms(lambda: torch._int_mm(xp, wt)),
                   **bound(m * k + n * k + 8 * n + 2 * m * n, 2 * m * k * n,
                           torch.int8, core_ops=INT8_EPI_OPS["base"] * m * n))
        emit(rec)
        summary["head_dims"]["int8_matmul_fused"] = {
            key: rec[key] for key in ("form", "m_k_n", "k_padded", "ms",
                                      "plain_ms", "library_ms", "bound_ms",
                                      "bound_by")}


def check_variants(randn, gen, summary: dict) -> None:
    """The attention kernels at the variants' shapes (VARIANT_ATTN), bf16,
    against their plain versions: the inference kernel at b8 (ATTN_TOL);
    at the train batch the training forward (o, lse within ATTN_TOL) and
    backward (dq, dk, dv within ATTN_GRAD_TOL of the largest), the dropout
    forward and backward at ``auto_block_q`` (the debug kernel's mask
    against the plain counter hash: 0 mismatches) and the segment forward
    and backward, with and without dropout, on two segments and a pad
    tail. Then the training forward, backward and dropout forward timed at
    VARIANT_TIMED_ATTN beside their plain versions, SDPA's flash kernel
    (``dropout_p`` 0.1 for the dropout forward: another mask stream) and
    their bounds, and the int8 kernel in VARIANT_INT8_FORMS
    (:func:`int8_form_check`). The LayerNorm rows at the variants' widths
    are check_layer_norm's and check_layer_norm_bwd's (VARIANT_LN_CASES).
    The records join the summary line as each kernel's ``variants``."""
    from chestxray_vit_tpu_torch.ops import flash_attention as fa

    dtype = torch.bfloat16
    tol, gtol = ATTN_TOL[dtype], ATTN_GRAD_TOL[dtype]
    drop = (DROP_SEED, DROP_RATE)
    worst: dict = {}

    def heads(b, h, s):
        x = randn((b, s, 3, h, 64), dtype)
        return tuple(t.transpose(1, 2) for t in x.unbind(2))

    def fwd_err(got, ref):
        return max((got[0].float() - ref[0].float()).abs().max().item(),
                   (got[1] - ref[1]).abs().max().item())

    def bwd_err(got, ref):
        return max(rel_err(g, r) for g, r in zip(got, ref))

    for h, s in VARIANT_ATTN:
        rec = {"phase": "kernel_check", "kernel": "variant_attention",
               "heads": h, "tokens": s, "dtype": str(dtype),
               "serving_batch": BATCH, "train_batch": TRAIN_BATCH}
        q, k, v = heads(BATCH, h, s)
        out = fa.flash_attention_inference(q, k, v)
        rec["flash_attention_inference"] = (
            out.float() - fa.attention_reference(q, k, v).float()
        ).abs().max().item()
        q, k, v = heads(TRAIN_BATCH, h, s)
        do = randn((TRAIN_BATCH, h, s, 64), dtype)
        bq, pbq = fa.auto_block_q(s), fa.packed_block_q(s)
        seg = head_dim_segments(TRAIN_BATCH, s, q.device)
        rec["block_q"], rec["packed_block_q"] = bq, pbq
        o, lse = fa.flash_attention_fwd(q, k, v)
        rec["flash_attention_fwd"] = fwd_err(
            (o, lse), fa.attention_fwd_reference(q, k, v))
        rec["flash_attention_bwd"] = bwd_err(
            fa.flash_attention_bwd(q, k, v, o, lse, do),
            fa.attention_bwd_reference(q, k, v, o, lse, do))
        o, lse = fa.flash_attention_dropout_fwd(q, k, v, *drop, block_q=bq)
        rec["flash_attention_dropout_fwd"] = fwd_err(
            (o, lse), fa.attention_dropout_fwd_reference(q, k, v, *drop,
                                                         block_q=bq))
        rec["flash_attention_dropout_bwd"] = bwd_err(
            fa.flash_attention_dropout_bwd(q, k, v, o, lse, do, *drop,
                                           block_q=bq),
            fa.attention_dropout_bwd_reference(q, k, v, o, lse, do, *drop,
                                               block_q=bq))
        _, keep = fa.flash_attention_dropout_debug(q, k, v, *drop,
                                                   block_q=bq)
        rec["mask_mismatches"] = int((keep != fa._keep(q, *drop, bq)).sum())
        del keep
        for name, fwd, rfwd, bwd, rbwd, extra in (
                ("flash_attention_packed", fa.flash_attention_packed_fwd,
                 fa.attention_packed_fwd_reference,
                 fa.flash_attention_packed_bwd,
                 fa.attention_packed_bwd_reference, ()),
                ("flash_attention_packed_dropout",
                 fa.flash_attention_packed_dropout_fwd,
                 fa.attention_packed_dropout_fwd_reference,
                 fa.flash_attention_packed_dropout_bwd,
                 fa.attention_packed_dropout_bwd_reference,
                 (*drop, None, pbq))):
            o, lse = fwd(q, k, v, seg, *extra)
            rec[f"{name}_fwd"] = fwd_err((o, lse), rfwd(q, k, v, seg, *extra))
            rec[f"{name}_bwd"] = bwd_err(
                bwd(q, k, v, seg, o, lse, do, *extra),
                rbwd(q, k, v, seg, o, lse, do, *extra))
        torch.cuda.synchronize()
        emit(rec)
        for name, err in rec.items():
            if name.endswith(("_inference", "_fwd", "_bwd")):
                worst[name] = max(worst.get(name, 0.0), err)
                limit = gtol if name.endswith("_bwd") else tol
                require(err <= limit, f"{name} at {h} heads, S={s}: {err}")
        require(rec["mask_mismatches"] == 0,
                f"dropout mask at S={s}: {rec['mask_mismatches']}")
        del q, k, v, do, o, lse, seg
        torch.cuda.empty_cache()

    shape = VARIANT_TIMED_ATTN
    b, h, s, _ = shape
    q, k, v = heads(b, h, s)
    do = randn(shape, dtype)
    bq = fa.auto_block_q(s)
    o, lse = fa.flash_attention_fwd(q, k, v)
    lib_fwd, lib_bwd = library_attention(q, k, v, do)
    lib_fwd_dev, lib_bwd_dev = library_attention_device_ms(q, k, v, do)
    lib_drop = library_attention(q, k, v, rate=DROP_RATE)[0]
    for name, kernel, plain, kw, lib, lib_dev in (
            ("flash_attention_fwd", lambda: fa.flash_attention_fwd(q, k, v),
             lambda: fa.attention_fwd_reference(q, k, v), {"lse": True},
             lib_fwd, lib_fwd_dev),
            ("flash_attention_bwd",
             lambda: fa.flash_attention_bwd(q, k, v, o, lse, do),
             lambda: fa.attention_bwd_reference(q, k, v, o, lse, do),
             {"backward": True}, lib_bwd, lib_bwd_dev),
            ("flash_attention_dropout_fwd",
             lambda: fa.flash_attention_dropout_fwd(q, k, v, *drop,
                                                    block_q=bq),
             lambda: fa.attention_dropout_fwd_reference(q, k, v, *drop,
                                                        block_q=bq),
             {"lse": True, "hash_passes": 1}, lib_drop, None)):
        ms, plain_ms = time_pair(kernel, plain)
        rec = {"phase": "kernel_check", "kernel": name,
               "model": "vit_b16_512", "shape": list(shape),
               "dtype": str(dtype), "block_q": bq, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib,
               "library_device_ms": lib_dev,
               **attention_bound(shape, dtype, **kw)}
        rec.update(backward_pass_ms(kernel) if name.endswith("bwd")
                   else device_ms(kernel))
        emit(rec)
        summary["variants"].setdefault(name, []).append(
            {key: rec[key] for key in (
                "model", "shape", "ms", "device_ms", "plain_ms",
                "library_ms", "library_device_ms", "bound_ms", "bound_by")})
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    for name, err in worst.items():
        summary["variants"].setdefault(name, []).append(
            {"max_err_at": [list(a) for a in VARIANT_ATTN],
             "max_err": err})
    for form in VARIANT_INT8_FORMS:
        rec = int8_form_check(gen, *form)
        summary["variants"].setdefault("int8_matmul_fused", []).append(
            {key: rec[key] for key in (
                "form", "m_k_n", "ms", "device_ms", "plain_ms", "library_ms",
                "library_device_ms", "bound_ms", "bound_by")})


# ---------------------------------------------------------------------------
# The fsdp, tensor and dcn mesh axes (phases 35-37, kernel_check's head split)
# ---------------------------------------------------------------------------

def check_head_split(randn, summary: dict) -> None:
    """A tensor-parallel rank's call on heads [h0, h0 + H/t) of H, with
    ``head_base`` and ``heads_total``: every dropout entry point (the
    forward, the debug mask, the backward, the segment forward and
    backward) and the training forward, backward and inference kernels
    give, bit for bit, the slice of the whole-head call (o, lse, the mask,
    dq, dk, dv), at a row base, at d = 64 and 80 (HEAD_SPLIT_CASES), in
    bf16 and f32, for every rank of t = 2 and 4."""
    from chestxray_vit_tpu_torch.ops import flash_attention as fa

    drop, rb = (DROP_SEED, DROP_RATE), HEAD_SPLIT_ROW_BASE
    records = []
    for d, h, s in HEAD_SPLIT_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            b = HEAD_SPLIT_BATCH
            x = randn((b, s, 3, h, d), dtype)
            q, k, v = (t.transpose(1, 2) for t in x.unbind(2))
            do = randn((b, h, s, d), dtype)
            seg = head_dim_segments(b, s, q.device)
            bq, pbq = fa.auto_block_q(s), fa.packed_block_q(s)

            def calls(q, k, v, do, sl=slice(None), **heads):
                """Every kernel on (q, k, v); the backwards on the whole
                call's o and lse, sliced."""
                out = {"inference": (fa.flash_attention_inference(q, k, v),),
                       "fwd": fa.flash_attention_fwd(q, k, v),
                       "dropout_fwd": fa.flash_attention_dropout_fwd(
                           q, k, v, *drop, block_q=bq, row_base=rb, **heads),
                       "dropout_debug": fa.flash_attention_dropout_debug(
                           q, k, v, *drop, block_q=bq, row_base=rb,
                           **heads),
                       "packed_dropout_fwd":
                           fa.flash_attention_packed_dropout_fwd(
                               q, k, v, seg, *drop, block_q=pbq, row_base=rb,
                               **heads)}
                o, lse = (t[:, sl] for t in whole["fwd"]) if whole else \
                    out["fwd"]
                out["bwd"] = fa.flash_attention_bwd(q, k, v, o,
                                                    lse.contiguous(), do)
                o, lse = ((t[:, sl] for t in whole["dropout_fwd"]) if whole
                          else out["dropout_fwd"])
                out["dropout_bwd"] = fa.flash_attention_dropout_bwd(
                    q, k, v, o, lse.contiguous(), do, *drop, block_q=bq,
                    row_base=rb, **heads)
                o, lse = ((t[:, sl] for t in whole["packed_dropout_fwd"])
                          if whole else out["packed_dropout_fwd"])
                out["packed_dropout_bwd"] = \
                    fa.flash_attention_packed_dropout_bwd(
                        q, k, v, seg, o, lse.contiguous(), do, *drop,
                        block_q=pbq, row_base=rb, **heads)
                return out

            whole = None
            whole = calls(q, k, v, do)
            equal = {}
            for t in HEAD_SPLIT_TENSOR:
                n = h // t
                for r in range(t):
                    sl = slice(r * n, (r + 1) * n)
                    part = calls(q[:, sl], k[:, sl], v[:, sl], do[:, sl], sl,
                                 head_base=r * n, heads_total=h)
                    for name, got in part.items():
                        equal[name] = equal.get(name, True) and all(
                            torch.equal(a, w[:, sl])
                            for a, w in zip(got, whole[name]))
            torch.cuda.synchronize()
            rec = {"phase": "kernel_check", "kernel": "head_split",
                   "shape": [b, h, s, d], "dtype": str(dtype),
                   "tensor": list(HEAD_SPLIT_TENSOR), "row_base": rb,
                   "equal": equal}
            emit(rec)
            records.append(rec)
            require(all(equal.values()),
                    f"head split d={d} {dtype}: {equal}")
            del whole, x, q, k, v, do
    summary["head_split"] = records


def check_int8_tensor_forms(gen, summary: dict) -> None:
    """The int8 kernel in the call forms of the int8 straight-through step
    on a tensor axis of 2 (INT8_TENSOR_FORMS, at a b8 global batch's slot
    of 1 x 2 x 2): the column products at N / 2, the row products at K / 2
    in the int32 out form (the raw sums). Each equals its plain twin bit
    for bit and itself twice, timed (events and device) beside
    ``torch._int_mm`` and its bound. Then the row form's emulation: the
    int32 partials of two ranks at K = 768 (``wo``) and 3072 (``mlp_out``,
    row 0's partials odd and past 2²⁴, where f32 partials would round),
    summed as int32 under the epilogue once, equal the one-process
    product's bits."""
    from chestxray_vit_tpu_torch.models import int8_train
    from chestxray_vit_tpu_torch.ops import int8_matmul as i8

    records = []
    for name, m, k, n, raw in INT8_TENSOR_FORMS:
        xq, wq, scale, bias, _ = int8_operands(gen, m, k, n, False, False)
        kw = ({"out_dtype": torch.int32} if raw else
              {"scale": scale, "bias": bias, "out_dtype": torch.bfloat16})

        def call():
            return i8.int8_matmul_fused(xq, wq, **kw)
        out, again = call(), call()
        ref = i8.int8_matmul_fused_reference(xq, wq, **kw)
        torch.cuda.synchronize()
        mismatched = int((out != ref).sum())
        equal_twice = torch.equal(out, again)
        del again
        ms, plain_ms = time_pair(
            call, lambda: i8.int8_matmul_fused_reference(xq, wq, **kw))
        wt = wq.t()
        rec = {"phase": "kernel_check", "kernel": "int8_matmul_fused",
               "form": name, "m_k_n": [m, k, n], "out_dtype": str(out.dtype),
               "mismatched": mismatched, "equal_twice": equal_twice,
               "max_abs_err": (out.float() - ref.float()).abs().max().item(),
               "tol": "equal", "ms": ms, "plain_ms": plain_ms,
               **device_ms(call),
               "library_ms": time_ms(lambda: torch._int_mm(xq, wt)),
               "library_device_ms": device_ms(
                   lambda: torch._int_mm(xq, wt))["device_ms"],
               "tops": 2 * m * k * n / ms / 1e9,
               **bound(m * k + n * k + (0 if raw else 8 * n)
                       + m * n * out.element_size(), 2 * m * k * n,
                       torch.int8,
                       core_ops=0 if raw else INT8_EPI_OPS["base"] * m * n)}
        emit(rec)
        records.append(rec)
        require(mismatched == 0 and equal_twice,
                f"int8 tensor form {name}: {mismatched} mismatched, equal "
                f"twice {equal_twice}")
    # two emulated ranks of a row product at K = 768 (wo) and 3072
    # (mlp_out): the exact int32 sum
    m, n = INT8_TENSOR_FORMS[0][1], 768
    for k in (768, 3072):
        xq, wq, scale, bias, _ = int8_operands(gen, m, k, n, False, False)
        xq[0], wq[0] = 127, 127       # the largest sum, k · 127²
        half = k // 2
        if k == 3072:                 # odd partials past 2²⁴
            wq[0, 0], wq[0, half:half + 2] = 126, 126
        largest = k * 127 ** 2 - (3 * 127 if k == 3072 else 0)
        parts = [int8_train.row_partial(xq[:, sl].contiguous(),
                                        wq[:, sl].contiguous())
                 for sl in (slice(0, half), slice(half, k))]
        acc = parts[0] + parts[1]
        for out_dtype in (torch.bfloat16, torch.float32):
            whole = i8.int8_matmul_fused(xq, wq, scale, bias,
                                         out_dtype=out_dtype)
            got = (acc.float() * scale + bias).to(out_dtype)
            torch.cuda.synchronize()
            rec = {"phase": "kernel_check", "kernel": "int8_row_partials",
                   "ranks": 2, "m_k_n": [m, k, n],
                   "out_dtype": str(out_dtype),
                   "partials": [int(p[0, 0]) for p in parts],
                   "largest_sum": int(acc[0, 0]),
                   "mismatched": int((got != whole).sum())}
            emit(rec)
            records.append(rec)
            require(acc.dtype == torch.int32 and rec["mismatched"] == 0
                    and rec["largest_sum"] == largest,
                    f"int8 row partials of two ranks: {rec}")
    summary["int8_tensor_forms"] = records


def _collective_counter():
    """Wrap the torch.distributed collectives the mesh runs, counting the
    calls and bytes of each kind; returns the tally dict (reset it by
    clearing)."""
    import torch.distributed as td

    tally: dict = {}

    def nbytes(t):
        return t.numel() * t.element_size()

    def wrap(name, size_of):
        real = getattr(td, name)

        def counted(*args, **kw):
            rec = tally.setdefault(name, {"calls": 0, "bytes": 0})
            rec["calls"] += 1
            rec["bytes"] += size_of(*args)
            return real(*args, **kw)
        setattr(td, name, counted)

    wrap("all_reduce", lambda t, *a: nbytes(t))
    wrap("all_gather_into_tensor", lambda out, inp, *a: nbytes(out))
    wrap("reduce_scatter_tensor", lambda out, inp, *a: nbytes(inp))
    wrap("all_gather", lambda parts, t, *a: nbytes(t) * len(parts))
    return tally


_MESH_PACKED = {}


def mesh_inputs(path: str, cfg, dev) -> tuple:
    """(the global batch, the full seed-0 model on ``dev``, the int8 scales
    calibrated on the batch or None) of a train_mesh run: the same in every
    rank and in this process."""
    from chestxray_vit_tpu_torch.models.vit import init_params

    params = init_params(torch.Generator().manual_seed(SEED), cfg.model, dev)
    if path == "packed":
        if dev not in _MESH_PACKED:
            _MESH_PACKED[dev] = tensors(packed_mixed_batch(dev,
                                                           MESH_PACKED_SEQS))
        batch = _MESH_PACKED[dev]
    else:
        batch = bench_batch(MESH_BATCH, SEED, dev)
    scales = calibrated_scales(params, cfg, batch) if path == "int8" else None
    return batch, params, scales


def mesh_config(path: str, model: dict):
    """A train_mesh run's config: mixup 0.2 on the dense path only."""
    return train_config(MIXUP_ALPHA if path == "dense" else 0.0, **model)


def mesh_step(path: str, cfg, scales, mesh=None):
    from chestxray_vit_tpu_torch.train import steps

    if path == "packed":
        return steps.make_packed_train_step(cfg, 10_000, mesh=mesh)
    return steps.make_train_step(cfg, 10_000, int8_scales=scales, mesh=mesh)


def mesh_launches_per_step(path: str, model: dict) -> dict:
    """What one process launches a step on the run's path; a rank launches
    the same, on its heads and rows."""
    layers = model.get("num_layers", MESH_LAYERS)
    dropout = model.get("attention_dropout", 0.0) > 0.0
    if path == "packed":
        return packed_launches_per_step(layers, dropout)
    if path == "int8":
        return int8_step_launches(layers, dropout)
    return dense_launches_per_step(layers, dropout)


def mesh_runs() -> tuple:
    """Every train_mesh run as (name, path, model, steps, mesh shape)."""
    return tuple((*run, MESH_SHAPE) for run in MESH_RUNS) + MESH_SPLIT_RUNS


def mesh_worker(dev) -> dict:
    """One rank of phase train_mesh (the launcher's object for it is its
    device, cuda:0; a gloo group of MESH_RANKS on the MESH_SHAPE mesh):
    every run of MESH_RUNS and MESH_SPLIT_RUNS (its steps on the rank's
    slot of the global batch, each on its own mesh; after the dense bf16
    run one eval step). Returns (as the call's
    value, rank 0's) every rank's records and rank 0's gathered parameters
    of each f32 run."""
    import torch.distributed as td

    import chestxray_vit_tpu_torch as cxr
    from chestxray_vit_tpu_torch.parallel import distributed as dist
    from chestxray_vit_tpu_torch.parallel import fsdp
    from chestxray_vit_tpu_torch.parallel import mesh as mesh_lib
    from chestxray_vit_tpu_torch.train import steps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:     # every rank builds them in one order
            c, d, f, t = shape
            meshes[shape] = mesh_lib.build_mesh(cxr.MeshConfig(
                dcn_data=c, data=d, fsdp=f, tensor=t))
        return meshes[shape]

    mesh = mesh_of(MESH_SHAPE)
    rank = dist.rank()
    tally = _collective_counter()
    res = {"rank": rank, "coords": mesh.coords, "dp_index": mesh.dp_index}
    params_out = {}
    for name, path, model, n_steps, shape in mesh_runs():
        mesh = mesh_of(shape)
        slots = mesh_lib.dp_size(mesh)
        cfg = mesh_config(path, model)
        batch, full, scales = mesh_inputs(path, cfg, dev)
        per = next(iter(batch.values())).shape[0] // slots
        rows = slice(mesh.dp_index * per, (mesh.dp_index + 1) * per)
        local = {k: v[rows] for k, v in batch.items()}
        params = fsdp.shard_params(full, mesh)
        state = steps.TrainState.create(params, seed=42)
        step = mesh_step(path, cfg, scales, mesh)
        rec = res[name] = {"losses": [], "step_ms": [], "launches": [],
                           "collectives": []}
        for _ in range(n_steps):
            td.barrier()
            torch.cuda.synchronize()
            reset_launch_counts()
            tally.clear()
            t0 = time.perf_counter()
            state, m = step(state, local)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            rec["step_ms"].append(1e3 * (time.perf_counter() - t0))
            rec["losses"].append(loss)
            rec["launches"].append(launch_counts())
            rec["collectives"].append({k: dict(v) for k, v in tally.items()})
        tally.clear()
        if name == "bf16":
            reset_launch_counts()
            with torch.no_grad():
                logits, _ = steps.make_eval_step(cfg)(state.params, local)
            rec["eval_launches"] = launch_counts()
            rec["eval_collectives"] = {k: dict(v) for k, v in tally.items()}
            rec["eval_logits"] = dist.process_allgather(
                logits.float(), mesh.axis("batch")).tolist()
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if cfg.model.dtype == "float32":
            full = fsdp.gather_params(state.params)
            if rank == 0:
                params_out[name] = {n: p.detach().cpu()
                                    for n, p in full.named_parameters()}
        del state, params, step, full, scales
        torch.cuda.empty_cache()
    ranks = [None] * dist.world()
    td.all_gather_object(ranks, res)
    return {"ranks": ranks, "params": params_out}


def phase_train_mesh(dense_rec: dict) -> dict:
    """The fsdp and tensor axes on the card: MESH_RANKS ranks on cuda:0 in
    a gloo group (NCCL refuses two ranks on one card), mesh data x fsdp x
    tensor 1 x 2 x 2, ViT-B/16 @384 at full width and MESH_LAYERS layers,
    bf16, full remat, every run of MESH_RUNS against this process taking
    the same steps on the global batch: the dense step (attention and hidden
    dropout 0.1, mixup 0.2, global batch MESH_BATCH) and one eval step; the
    packed step (MESH_PACKED_SEQS 1152-token sequences of the mixed layout,
    both dropouts 0.1); the merged packed step (r 16 decreasing); the int8
    straight-through dense step (scales calibrated on the batch); then the
    f32 counterpart of each at depth 2. The bounds (MESH_BF16_TOL,
    MESH_F32_TOL) are stated in the first line, before the ranks run. Each
    run's step ms beside the one-process step's, the collectives a step by
    kind with their bytes, and the kernel launches a step (exact: each
    rank launches what one process does, on its heads). Four ranks sharing
    one card measure correctness and collective counts, not scaling.
    Returns the ranks' launches (every run's steps and the eval) summed."""
    from chestxray_vit_tpu_torch.parallel import launch
    from chestxray_vit_tpu_torch.train import steps

    dev = torch.device("cuda")
    emit({"phase": "train_mesh", "stated_before_the_run": True,
          "mesh": "x".join(map(str, MESH_SHAPE[1:])), "ranks": MESH_RANKS,
          "global_batch": MESH_BATCH, "global_sequences": MESH_PACKED_SEQS,
          "runs": [[name, path, n, "x".join(map(str, shape[1:]))]
                   for name, path, _, n, shape in mesh_runs()],
          "bf16_bound": MESH_BF16_TOL, "f32_bound": MESH_F32_TOL,
          "int8_f32_bound": MESH_INT8_F32_TOL,
          "reasoning": {
              "bf16": "row products split over 2 tensor ranks round each "
                      "partial to bf16 and the f32 sum again: a row product "
                      "may land one bf16 ulp away; products at half the "
                      "rows may take other cuBLAS algorithms. Loss: one "
                      "bf16 ulp of itself a step; eval logits 4 ulps of "
                      "the largest",
              "packed": "the same split on the packed forward, the segment "
                        "kernels on each rank's heads; a merge reordered "
                        "by a near tie moves one token pair of one "
                        "sequence, far under the ulp",
              "int8": "the int8 forward is exact on the split (whole "
                      "channels, exact int32 partials under 2^24, a max "
                      "for the scales); the backward is the dense bf16 "
                      "split: one bf16 ulp of the loss a step",
              "f32": "the same math in another summation order: losses "
                     "1e-5 relative, parameters 2e-5 of the largest",
              "int8_f32": "the first step's loss 1e-5 relative (an exact "
                          "forward); then the int8 forward is not "
                          "continuous: later losses one bf16 ulp, "
                          "parameters about 2 lr (INT8_XCHECK)"}})
    refs = {}
    for name, path, model, n_steps, _ in mesh_runs():
        cfg = mesh_config(path, model)
        batch, params, scales = mesh_inputs(path, cfg, dev)
        state = steps.TrainState.create(params, seed=42)
        step = mesh_step(path, cfg, scales)
        rec = refs[name] = {"losses": [], "step_ms": []}
        for _ in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            rec["losses"].append(float(m["loss"]))
            torch.cuda.synchronize()
            rec["step_ms"].append(1e3 * (time.perf_counter() - t0))
        if name == "bf16":
            with torch.no_grad():
                rec["eval_logits"] = steps.make_eval_step(cfg)(
                    state.params, batch)[0].float().cpu().numpy()
        if cfg.model.dtype == "float32":
            rec["params"] = {n: p.detach().cpu()
                             for n, p in state.params.named_parameters()}
        del state, params, step, scales
        torch.cuda.empty_cache()
    _MESH_PACKED.clear()
    torch.cuda.empty_cache()

    # the ranks through the launcher (parallel/launch.py): a rank's
    # failure is raised here with its output's tail
    t0 = time.perf_counter()
    ranks_of, _ = _quiet(lambda: launch.Ranks(
        ["cuda:0"] * MESH_RANKS, what="train_mesh's ranks"))
    try:
        got, _ = _quiet(lambda: ranks_of.call(mesh_worker))
    finally:
        ranks_of.close()
    wall = time.perf_counter() - t0
    ranks = got["ranks"]
    emit({"phase": "train_mesh", "ranks_wall_s": wall, "shared_card": True,
          "rank_coords": [rk["coords"] for rk in ranks]})

    launches = dict.fromkeys(_wrappers(), 0)
    steady = slice(1, None)          # the first step builds the groups' use
    for name, path, model, n_steps, shape in mesh_runs():
        ref = refs[name]
        want = mesh_launches_per_step(path, model)
        exact = all(c == want for rk in ranks for c in rk[name]["launches"])
        loss_diff = max(abs(a - b) for rk in ranks
                        for a, b in zip(rk[name]["losses"], ref["losses"]))
        mesh_ms = max(float(np.median(rk[name]["step_ms"][steady]))
                      for rk in ranks)
        one_ms = float(np.median(ref["step_ms"][steady]))
        rec = {"phase": "train_mesh", "run": name, "path": path,
               "model": model, "steps": n_steps,
               "mesh": "x".join(map(str, shape[1:])),
               "mesh_losses": ranks[0][name]["losses"],
               "one_process_losses": ref["losses"], "loss_diff": loss_diff,
               "first_step_loss_diff": max(
                   abs(rk[name]["losses"][0] - ref["losses"][0])
                   for rk in ranks),
               "step_ms_per_rank": [rk[name]["step_ms"] for rk in ranks],
               "step_ms": mesh_ms, "one_process_step_ms": one_ms,
               "collectives_per_step": ranks[0][name]["collectives"][-1],
               "launches_per_step": ranks[0][name]["launches"][-1],
               "launches_exact": exact,
               "peak_gb_per_rank": [rk[name]["peak_gb"] for rk in ranks]}
        ok = all(np.isfinite(rk[name]["losses"]).all() for rk in ranks)
        if cfg_dtype(model) == "bfloat16":
            rec["loss_bound"] = MESH_BF16_TOL["loss_ulps"] * float(
                bf16_ulp(torch.tensor(max(ref["losses"]))))
            ok = ok and loss_diff <= rec["loss_bound"]
        else:
            got_params = got["params"][name]
            scale = max(float(p.abs().max()) for p in ref["params"].values())
            rec["param_diff_of_largest"] = max(
                float((got_params[n] - p).abs().max())
                for n, p in ref["params"].items()) / scale
            rec["loss_rel_diff"] = max(abs(a - b) / abs(b) for rk in ranks
                                       for a, b in zip(rk[name]["losses"],
                                                       ref["losses"]))
            if path == "int8":
                rec["bound"] = tol = MESH_INT8_F32_TOL
                rec["first_loss_rel_diff"] = rec["first_step_loss_diff"] \
                    / abs(ref["losses"][0])
                rec["loss_bound"] = tol["loss_ulps"] * float(
                    bf16_ulp(torch.tensor(max(ref["losses"]))))
                ok = (ok and rec["first_loss_rel_diff"]
                      <= tol["first_loss_rel"]
                      and loss_diff <= rec["loss_bound"])
            else:
                rec["bound"] = tol = MESH_F32_TOL
                ok = ok and rec["loss_rel_diff"] <= tol["loss_rel"]
            ok = ok and (rec["param_diff_of_largest"]
                         <= tol["params_of_largest"])
        if name == "bf16":
            logit_diff = float(np.abs(
                np.asarray(ranks[0][name]["eval_logits"])
                - ref["eval_logits"]).max())
            logit_bound = MESH_BF16_TOL["logit_ulps"] * float(bf16_ulp(
                torch.tensor(float(np.abs(ref["eval_logits"]).max()))))
            eval_want = {**dict.fromkeys(_wrappers(), 0),
                         "flash_attention_inference": MESH_LAYERS,
                         "layer_norm": 2 * MESH_LAYERS + 1}
            eval_exact = all(rk[name]["eval_launches"] == eval_want
                             for rk in ranks)
            rec.update(
                mixup_alpha=MIXUP_ALPHA, eval_logit_diff=logit_diff,
                eval_logit_bound=logit_bound, eval_launches_exact=eval_exact,
                eval_collectives=ranks[0][name]["eval_collectives"],
                images_per_s=MESH_BATCH / mesh_ms * 1e3,
                one_process_images_per_s=MESH_BATCH / one_ms * 1e3,
                dense_b36_images_per_s=dense_rec["images_per_s"])
            ok = ok and logit_diff <= logit_bound
            exact = exact and eval_exact
        emit(rec)
        require(ok, f"train_mesh {name}: {rec}")
        require(exact, f"train_mesh {name} launches: "
                       f"{rec['launches_per_step']} != {want}")
        for rk in ranks:
            for counts in rk[name]["launches"] + (
                    [rk[name]["eval_launches"]] if name == "bf16" else []):
                for k, n in counts.items():
                    launches[k] += n
    head_split_cost(ranks)
    return launches


def head_split_cost(ranks: list) -> None:
    """What cutting heads costs a rank on the dense bf16 split runs
    (MESH_SPLIT_RUNS): the heads the busiest rank runs (``vit.RankHeads``:
    every head its columns touch) against its share of the model's (H / t),
    the attention forward and backward timed at the rank's heads and at
    the whole model's heads over the per-slot batch (device ms, or CUDA
    events where the profiler's trace held none: ``attention_ms_from``; a
    step runs the forward twice under full remat and the backward once a
    layer), the extra attention ms a step that follows, and the
    collectives a step the gathers add (the ranks' tally) beside the step
    ms."""
    import types

    from chestxray_vit_tpu_torch.config import ModelConfig
    from chestxray_vit_tpu_torch.models.vit import RankHeads
    from chestxray_vit_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for name, path, model, _, shape in MESH_SPLIT_RUNS:
        if path != "dense" or "dtype" in model or "attention_dropout" in model:
            continue
        cfg = ModelConfig(**{k: v for k, v in model.items()
                             if k in ("hidden_size", "num_heads", "mlp_dim",
                                      "num_layers")})
        t = shape[3]
        busiest = max((RankHeads(cfg, types.SimpleNamespace(size=t, index=i))
                       for i in range(t)), key=lambda r: r.h1 - r.h0)
        b = MESH_BATCH // (shape[0] * shape[1] * shape[2])
        ms, sources = {}, set()
        for key, h in (("rank", busiest.h1 - busiest.h0),
                       ("model", cfg.num_heads)):
            q, k, v, do = (torch.randn((b, h, 577, 64), generator=gen,
                                       device=dev).to(torch.bfloat16)
                           for _ in range(4))
            o, lse = fa.flash_attention_fwd(q, k, v)
            timed = [device_or_event_ms(fn) for fn in (
                lambda: fa.flash_attention_fwd(q, k, v),
                lambda: fa.flash_attention_bwd(q, k, v, o, lse, do))]
            ms[key] = tuple(t for t, _ in timed)
            sources.update(src for _, src in timed)
        layers = cfg.num_layers
        per_step = {key: layers * (2 * f + bw) for key, (f, bw) in ms.items()}
        rec = {"phase": "train_mesh_head_split_cost", "run": name,
               "mesh": "x".join(map(str, shape[1:])),
               "heads": cfg.num_heads, "tensor": t,
               "columns_a_rank": busiest.cols,
               "heads_run_by_busiest_rank": busiest.h1 - busiest.h0,
               "heads_share": cfg.num_heads / t, "batch_a_slot": b,
               "attention_fwd_bwd_ms": {k: list(v) for k, v in ms.items()},
               "attention_ms_from": sorted(sources),
               "attention_ms_a_step_rank": per_step["rank"],
               "attention_ms_a_step_share": per_step["model"] / t,
               "extra_attention_ms_a_step": per_step["rank"]
               - per_step["model"] / t,
               "collectives_per_step": ranks[0][name]["collectives"][-1],
               "step_ms_per_rank": [rk[name]["step_ms"] for rk in ranks]}
        emit(rec)


def cfg_dtype(model: dict) -> str:
    """A MESH_RUNS model's compute dtype (bf16 unless it says f32)."""
    return model.get("dtype", "bfloat16")


def _started(args: list, cwd: str) -> tuple:
    """A subprocess started now in ``cwd``, its output to temporary files:
    (process, start time, the two files)."""
    import tempfile

    out, err = (tempfile.TemporaryFile("w+") for _ in range(2))
    p = subprocess.Popen(args, cwd=cwd, stdout=out, stderr=err, text=True)
    return p, time.perf_counter(), out, err


def _finished(run: tuple, what: str) -> tuple:
    """(exit code, stdout, stderr, wall s) of a :func:`_started` process,
    waited for up to EXAMPLES_TIMEOUT_S from its start, killed past it."""
    p, t0, out, err = run
    try:
        p.wait(timeout=max(1.0, EXAMPLES_TIMEOUT_S
                           - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
    wall = time.perf_counter() - t0
    texts = []
    for f in (out, err):
        f.seek(0)
        texts.append(f.read())
        f.close()
    require(p.returncode is not None, f"{what}: not ended")
    return p.returncode, texts[0], texts[1], wall


def phase_examples() -> dict:
    """The port's two examples as a user runs them, each in its own
    process on the card: ``finetune_nih_torch.py --dry-run`` (the
    version_b preset: ViT-B/16 @384, bf16, b8, 20 steps with an eval and a
    save at 10 and 20, the int8 and merged-eval fidelity gates, the report)
    and ``train_smoke_torch.py``; their wall seconds. They run at once, and
    beside them the multi-rank dry run (:func:`phase_dryrun`): the three
    share the card and the host, so each wall time holds the others' load.
    Returns the dry run's summary."""
    import os
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    runs = {"finetune_nih_torch": ["--dry-run", "--preset", "version_b",
                                   "--output-dir", "ft",
                                   "--expect-quant-band", "1.0",
                                   "--expect-tome-band", "16:1.0"],
            "train_smoke_torch": []}
    started = {name: _started(
        [sys.executable, os.path.join(here, "examples", f"{name}.py"), *args],
        tempfile.mkdtemp(prefix=f"{name}_")) for name, args in runs.items()}
    dryrun = _dryrun_started()
    for name, args in runs.items():
        code, out, err, wall = _finished(started[name], name)
        lines = out.strip().splitlines()
        emit({"phase": "examples", "example": name, "args": args,
              "exit": code, "wall_s": wall, "last_lines": lines[-3:],
              "beside": "the other example and the dry run"})
        require(code == 0, f"{name} exit {code}: {err[-3000:]}")
    return phase_dryrun(dryrun)


def _dryrun_started() -> tuple:
    import os

    return _started([sys.executable, "-m", "chestxray_vit_tpu_torch.dryrun",
                     str(DRYRUN_RANKS)],
                    os.path.dirname(os.path.abspath(__file__)))


def phase_dryrun(run: Optional[tuple] = None) -> dict:
    """``python -m chestxray_vit_tpu_torch.dryrun 4``: four ranks on cuda:0
    in a gloo group, the data x fsdp 2 x 2 and dcn 2 x 1 x 2 meshes, each
    one's train step, merged step and static int8 eval against one
    process. ``run``: the process already started (:func:`phase_examples`
    starts it beside the examples), else it starts here."""
    code, out, err, wall = _finished(run or _dryrun_started(), "dryrun")
    require(code == 0, f"dryrun exit {code}: {out[-2000:]} {err[-3000:]}")
    summary = json.loads(out.strip().splitlines()[-1])
    emit({"phase": "dryrun", "ranks": DRYRUN_RANKS, "wall_s": wall,
          **summary})
    require(summary["ok"], f"dryrun: {summary}")
    return summary


class SpawnClock:
    """Wraps a Trainer's step function on a rank (or in this process): the
    wall clock at each step's call (``time.time()``, comparable across the
    processes of one host; each logged step syncs, so the gap between two
    calls is one step with what the loop did after it) and the kernel
    launches of each step, counted from 0 at its call."""

    def __init__(self, step_fn):
        self.step_fn, self.calls, self.launches = step_fn, [], []

    def __call__(self, state, batch):
        self.calls.append(time.time())
        reset_launch_counts()
        out = self.step_fn(state, batch)
        self.launches.append(launch_counts())
        return out


def spawn_clock(tr) -> None:
    """On every rank: clock the trainer's steps (:class:`SpawnClock`)."""
    tr._train_step = SpawnClock(tr._train_step)


def spawn_readings(tr, want: dict) -> dict:
    """On every rank: the clock's readings, the group's backend, the
    peak memory; ``all_ranks_exact``: every step of every rank launched
    ``want`` (agreed over the group)."""
    import torch.distributed as td

    from chestxray_vit_tpu_torch.parallel import distributed as dist

    clock = tr._train_step
    exact = all(c == want for c in clock.launches)
    return {"calls": clock.calls, "launches": clock.launches,
            "backend": td.get_backend(),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "all_ranks_exact": not dist.agree_flag(not exact)}


def held_marker(out_dir: str, step: int) -> str:
    """The file that ``hold_until_stop``'s rank 0 writes in the run's
    output directory once it holds ``step``."""
    import os
    return os.path.join(out_dir, f"held_step_{step}")


def hold_until_stop(tr, step: int) -> None:
    """On every rank: the step that reaches ``step`` returns only once a
    stop was requested (within SPAWN_HOLD_S), so the caller's request lands
    there. Rank 0 writes ``held_marker`` as it starts to hold: every rank
    has then passed the stop check of the step before, so a request sent
    after the marker appears lands on ``step``."""
    import os

    from chestxray_vit_tpu_torch.parallel import distributed as dist
    inner = tr._train_step
    marker = held_marker(os.path.expanduser(tr.cfg.train.output_dir), step)

    def held(state, batch):
        out = inner(state, batch)
        if out[0].step == step:
            if dist.rank() == 0:
                open(marker, "w").close()
            deadline = time.monotonic() + SPAWN_HOLD_S
            while (not tr._stop_requested
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        return out
    tr._train_step = held


def _spawn_config(out_dir: str, batch: int):
    return _trainer_config(out_dir, batch_size_per_core=batch,
                           max_steps=SPAWN_STEPS, eval_strategy="no",
                           save_strategy="no", load_best_model_at_end=False,
                           report_to="none")


def _spawn_packed(fake, out_dir: str, **train):
    import chestxray_vit_tpu_torch as cxr
    from chestxray_vit_tpu_torch.train.packed_trainer import PackedTrainer
    cfg = _packed_trainer_config(
        out_dir, max_steps=SPAWN_PACKED_STEPS, eval_strategy="no",
        save_strategy="no", load_best_model_at_end=False,
        lr_schedule="constant", **train)
    cfg.model.num_layers = SPAWN_PACKED_LAYERS
    cfg.mesh = cxr.MeshConfig(data=-1, fsdp=2, tensor=2)
    return PackedTrainer(cfg, seq_len=PACKED_TRAINER_SEQ_LEN,
                         grids=PACKED_TRAINER_GRIDS,
                         batch_seqs=SPAWN_PACKED_SEQS,
                         census_sample=SPAWN_CENSUS, store=fake.store,
                         pretrained=False,
                         device=["cuda:0"] * SPAWN_PACKED_RANKS)


def _spawn_steps(readings: dict, t_call: float) -> dict:
    calls = readings["calls"]
    return {"call_to_first_step_s": calls[0] - t_call,
            "step_ms": [1e3 * (b - a) for a, b in zip(calls, calls[1:])]}


def phase_trainer_spawn() -> dict:
    """A lone Trainer and PackedTrainer given several devices
    (``device=["cuda:0"] * n``: one rank a device through
    ``parallel/launch.py``, the ranks sharing the one card in a gloo
    group). (a) Dense, ViT-B/16 @384 bf16 full remat on 2 x 1 x 1:
    SPAWN_STEPS steps against the one-process Trainer on the same global
    batch within one bf16 ulp of the loss a step. (b) Packed on 1 x 2 x 2
    at SPAWN_PACKED_LAYERS layers: an uninterrupted run, then a run stopped
    at SPAWN_PACKED_STOP by ``request_stop`` and resumed by a fresh
    PackedTrainer, equal to it bit for bit. For each: the seconds from the
    call to the first step, step ms (beside the one-process Trainer's),
    the group's backend, and one rank's launches a step, which every rank
    must match exactly (the ranks run the kernels, never the plain
    versions). A failed rank fails the phase. Returns rank 0's launches
    of the timed runs with this process's."""
    import concurrent.futures
    import os
    import tempfile

    from chestxray_vit_tpu_torch.data.testing import build_fake_nih
    from chestxray_vit_tpu_torch.train.trainer import SpawnedTrainer, Trainer

    emit({"phase": "trainer_spawn", "stated_before_the_run": True,
          "dense": {"ranks": SPAWN_RANKS, "mesh": "2x1x1 (data -1)",
                    "global_batch": SPAWN_BATCH, "steps": SPAWN_STEPS,
                    "against": "the one-process Trainer at batch "
                               f"{SPAWN_BATCH}",
                    "loss_bound": "MESH_BF16_TOL: one bf16 ulp of the "
                                  "loss a step"},
          "packed": {"ranks": SPAWN_PACKED_RANKS,
                     "mesh": "1x2x2 (data -1, fsdp 2, tensor 2)",
                     "sequences": SPAWN_PACKED_SEQS,
                     "steps": SPAWN_PACKED_STEPS,
                     "stop_at": SPAWN_PACKED_STOP,
                     "bound": "bit for bit the uninterrupted run",
                     "depth_cut": f"{SPAWN_PACKED_LAYERS} of 12 layers "
                                  f"(the script's time aim)"},
          "devices": "ranks sharing cuda:0 (one card on this machine)"})
    launches = dict.fromkeys(_wrappers(), 0)

    def add(counts_list):
        for counts in counts_list:
            for k, n in counts.items():
                launches[k] += n

    fake = build_fake_nih(num_images=SPAWN_IMAGES,
                          image_size=TRAINER_IMAGE_SIZE, seed=17)
    want = dense_launches_per_step(12, dropout=False)
    with tempfile.TemporaryDirectory(prefix="cxr_spawn_") as tmp:
        one = Trainer(_spawn_config(os.path.join(tmp, "one"), SPAWN_BATCH),
                      store=fake.store, pretrained=False, device="cuda:0")
        clock = one._train_step = SpawnClock(one._train_step)
        _quiet(one.train)
        one.close()
        del one
        torch.cuda.empty_cache()
        one_losses = [v for _, v in _logged(os.path.join(tmp, "one"))]
        one_ms = [1e3 * (b - a) for a, b in zip(clock.calls, clock.calls[1:])]
        add(clock.launches)

        t_call = time.time()
        tr, _ = _quiet(lambda: Trainer(
            _spawn_config(os.path.join(tmp, "spawned"),
                          SPAWN_BATCH // SPAWN_RANKS),
            store=fake.store, pretrained=False,
            device=["cuda:0"] * SPAWN_RANKS))
        try:
            ready_s = time.time() - t_call
            require(isinstance(tr, SpawnedTrainer)
                    and (tr.mesh.data, tr.mesh.fsdp, tr.mesh.tensor)
                    == (SPAWN_RANKS, 1, 1)
                    and tr.global_batch == SPAWN_BATCH,
                    f"trainer_spawn: {SPAWN_RANKS} ranks on "
                    f"{SPAWN_RANKS}x1x1, global batch {SPAWN_BATCH}")
            tr.call(spawn_clock)
            _quiet(tr.train)
            got = tr.call(spawn_readings, want)
        finally:
            _quiet(tr.close)
        losses = [v for _, v in _logged(os.path.join(tmp, "spawned"))]
    add(got["launches"])
    bound = MESH_BF16_TOL["loss_ulps"] * float(
        bf16_ulp(torch.tensor(max(one_losses))))
    diff = max(abs(a - b) for a, b in zip(losses, one_losses))
    rec = {"phase": "trainer_spawn", "run": "dense", "ranks": SPAWN_RANKS,
           "construct_s": ready_s, **_spawn_steps(got, t_call),
           "one_process_step_ms": one_ms, "backend": got["backend"],
           "losses": losses, "one_process_losses": one_losses,
           "loss_diff": diff, "loss_bound": bound,
           "launches_per_step": got["launches"][-1],
           "launches_exact": got["all_ranks_exact"],
           "rank0_peak_gb": got["peak_gb"]}
    emit(rec)
    require(len(losses) == SPAWN_STEPS and np.isfinite(losses).all()
            and diff <= bound, f"trainer_spawn dense: {rec}")
    require(got["all_ranks_exact"], f"trainer_spawn dense launches: "
                                    f"{got['launches']} != {want}")

    fake, _ = varres_bucket(SPAWN_PACKED_IMAGES)
    want = packed_launches_per_step(SPAWN_PACKED_LAYERS, dropout=False)
    with tempfile.TemporaryDirectory(prefix="cxr_spawn_packed_") as tmp:
        run_dir, stop_dir = os.path.join(tmp, "run"), os.path.join(tmp, "stop")
        t_call = time.time()
        run, _ = _quiet(lambda: _spawn_packed(fake, run_dir))
        try:
            ready_s = time.time() - t_call
            require((run.mesh.data, run.mesh.fsdp, run.mesh.tensor)
                    == (1, 2, 2) and run.steps_per_epoch > SPAWN_PACKED_STEPS,
                    f"trainer_spawn packed: 1x2x2 and an epoch of more than "
                    f"{SPAWN_PACKED_STEPS} steps ({run.steps_per_epoch})")
            run.call(spawn_clock)
            _quiet(run.train)
            packed_got = run.call(spawn_readings, want)
            full = run.state
        finally:
            _quiet(run.close)
        add(packed_got["launches"])

        def stop_and_resume():
            stopped = _spawn_packed(fake, stop_dir)
            try:
                stopped.call(hold_until_stop, SPAWN_PACKED_STOP)
                with concurrent.futures.ThreadPoolExecutor(1) as pool:
                    result = pool.submit(stopped.train)
                    marker = held_marker(stop_dir, SPAWN_PACKED_STOP)
                    while not os.path.exists(marker):
                        if result.done():       # raises a rank's error
                            require(False, f"trainer_spawn stop: the run "
                                           f"ended first: {result.result()}")
                        time.sleep(0.05)
                    stopped.request_stop()
                    steps = result.result()["train_steps"]
            finally:
                stopped.close()
            resumed = _spawn_packed(fake, stop_dir,
                                    resume_from_checkpoint="auto")
            try:
                resumed.train()
                return steps, resumed.state
            finally:
                resumed.close()
        (stop_steps, again), _ = _quiet(stop_and_resume)
        with open(os.path.join(stop_dir, "checkpoints",
                               str(SPAWN_PACKED_STOP), "meta.json")) as fh:
            cursor = json.load(fh)["cursor"]
        run_losses = [v for _, v in _logged(run_dir)]
        stop_losses = [v for _, v in _logged(stop_dir)]
    want_params = dict(full.params.named_parameters())
    unequal = [n for n, p in again.params.named_parameters()
               if not torch.equal(p, want_params[n])]
    rec = {"phase": "trainer_spawn", "run": "packed",
           "ranks": SPAWN_PACKED_RANKS, "layers": SPAWN_PACKED_LAYERS,
           "construct_s": ready_s, **_spawn_steps(packed_got, t_call),
           "backend": packed_got["backend"], "losses": run_losses,
           "stopped_at": stop_steps, "cursor": cursor,
           "resumed_losses": stop_losses,
           "resumed_params_unequal": unequal,
           "launches_per_step": packed_got["launches"][-1],
           "launches_exact": packed_got["all_ranks_exact"],
           "rank0_peak_gb": packed_got["peak_gb"]}
    emit(rec)
    require(stop_steps == SPAWN_PACKED_STOP
            and len(cursor.get("per_host") or []) == 2
            and cursor["batch_in_epoch"] > 0,
            f"trainer_spawn packed: stopped mid-epoch at "
            f"{SPAWN_PACKED_STOP}: {rec}")
    require(np.isfinite(run_losses).all() and stop_losses == run_losses
            and not unequal, f"trainer_spawn packed resume: {rec}")
    require(packed_got["all_ranks_exact"],
            f"trainer_spawn packed launches: {packed_got['launches']} != "
            f"{want}")
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
    ("layer_norm_bwd", "csrc/layer_norm_bwd.cu",
     "chestxray_vit_tpu/ops/layer_norm.py:103"),
    ("flash_attention_dropout_fwd", "csrc/flash_attention_dropout.cu",
     "chestxray_vit_tpu/ops/flash_attention.py:500"),
    ("flash_attention_dropout_debug", "csrc/flash_attention_dropout_debug.cu",
     "chestxray_vit_tpu/ops/flash_attention.py:508"),
    ("flash_attention_dropout_bwd", "csrc/flash_attention_bwd_dropout.cu",
     "chestxray_vit_tpu/ops/flash_attention.py:516"),
    ("flash_attention_packed_fwd", "csrc/flash_attention_seg.cu",
     "chestxray_vit_tpu/ops/flash_attention.py:134"),
    ("flash_attention_packed_bwd", "csrc/flash_attention_seg_bwd.cu",
     "chestxray_vit_tpu/ops/flash_attention.py:208"),
    ("flash_attention_packed_dropout_fwd",
     "csrc/flash_attention_seg_dropout.cu",
     "chestxray_vit_tpu/ops/flash_attention.py:140"),
    ("flash_attention_packed_dropout_bwd",
     "csrc/flash_attention_seg_bwd_dropout.cu",
     "chestxray_vit_tpu/ops/flash_attention.py:216"),
    # no Pallas kernel: the JAX package draws jax.random.bernoulli in XLA
    ("hidden_dropout", "csrc/hidden_dropout.cu",
     "chestxray_vit_tpu/models/vit.py:222"),
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
    qp, imgs, fused_logits, serve_int8_launches, int8_rec = \
        phase_serving_int8(params, cfg, images)
    phase_int8_cross_check(params, cfg, qp, imgs, fused_logits)
    del params, qp, imgs
    torch.cuda.empty_cache()
    train_params, train_cfg, train_launches, train_rec = phase_train()
    dense_images_per_s = train_rec["images_per_s"]
    phase_train_cross_check()
    eval_launches = phase_eval(train_params, train_cfg)
    eval_int8_launches = phase_eval_accel(train_params, train_cfg)
    del train_params
    torch.cuda.empty_cache()
    dropout_launches = phase_train_dropout()
    phase_train_cross_check("train_dropout_cross_check", MIXUP_ALPHA,
                            attention_dropout=DROP_RATE,
                            hidden_dropout=DROP_RATE)
    dp_split_launches = phase_train_dp_split()
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
    tome_train_launches, tome_params, tome_rates = phase_train_tome(
        train_rec)
    phase_tome_cross_check()
    serve_tome_launches = phase_serving_tome(int8_rec)
    serve_dp_launches = phase_serving_dp()
    tome_cfg = train_config(tome_r=TOME_STEPS[0][0],
                            tome_schedule=TOME_STEPS[0][1])
    eval_tome_launches = [
        phase_eval_accel(tome_params, tome_cfg, f"eval_tome_{name}",
                         quantized=quant, tome_r=TOME_STEPS[0][0])
        for name, quant in (("dense", False), ("int8", True))]
    del tome_params
    torch.cuda.empty_cache()
    policy_launches, policy_rows = phase_train_remat_policies(train_rec)
    fused_launches = phase_train_fused_qkv(policy_rows)
    maps_launches = phase_serving_maps()
    trainer_launches = phase_trainer(train_rec)
    fake, fake_s = varres_bucket()
    packed_trainer_launches = phase_packed_trainer(fake, fake_s, packed_rec)
    ddp_launches = phase_ddp_world1(fake)
    del fake
    cli_launches = phase_cli()
    int8_train_launches = phase_train_int8(train_rec, tome_rates)
    phase_train_int8_cross_check()
    vit_h14_launches = phase_vit_h14(images)
    phase_vit_h14_cross_check()
    variant_launches = phase_variants(images)
    b16_h3_launches = phase_vit_b16_h3(images)
    off8_launches = phase_off8_model(images)
    mesh_launches = phase_train_mesh(train_rec)
    spawn_launches = phase_trainer_spawn()
    phase_examples()                    # and the dry run beside them
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "chestxray_vit_tpu")]
    require(not loaded, f"no JAX and no JAX-package module imported: "
                        f"{loaded}")

    # launches: the sum over the main paths' runs (serving, int8 serving,
    # the timed train steps, eval, int8 eval, the timed dropout steps, the
    # global and emulated data-parallel steps, data-parallel serving, the
    # timed packed, merged and mixed-resolution steps, the timed merged
    # dense steps, merged serving and merged eval, the timed steps of
    # every remat policy and of fused_qkv, the maps forward, the Trainer's
    # runs, the PackedTrainer's runs, the runs without and in a process
    # group, the command line's commands, the timed int8 train steps,
    # plain and merged, ViT-H/14's dense b8, b32 and int8 b32 serving, its
    # timed train steps and its eval step, the same of every variant run
    # (ViT-L/16's serving; ViT-B/16 @512's dropout steps), the mesh ranks'
    # train steps and eval step, the spawned ranks' steps (rank 0's) and the
    # one-process Trainer beside them), each counted from 0 just before it
    paths = (serve_launches, serve_int8_launches, train_launches,
             eval_launches, eval_int8_launches, dropout_launches,
             packed_launches, tome_launches, mixed_launches,
             tome_train_launches, serve_tome_launches, *eval_tome_launches,
             policy_launches, fused_launches, maps_launches,
             trainer_launches, packed_trainer_launches, ddp_launches,
             cli_launches, int8_train_launches, dp_split_launches,
             serve_dp_launches, *vit_h14_launches, *variant_launches,
             *b16_h3_launches, *off8_launches, mesh_launches,
             spawn_launches)
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
        other = checked["head_dims"].get(name)
        if isinstance(other, list):     # LayerNorm at ViT-H/14's 1280
            other = [{k: r.get(k) for k in (
                "shape", "dtype", "scale_dtype", "max_abs_err", "ms",
                "device_ms", "plain_ms", "library_ms", "library_device_ms",
                "library_scale_dtype", "bound_ms", "bound_by")}
                for r in other]
        if other is not None:
            summary[-1]["head_dims"] = other
        other = checked["wide"].get(name)
        if other is not None:           # the widths of ViT-B/16 in 3 heads,
            summary[-1]["wide"] = other  # LayerNorm and int8 off the vector
        other = checked["variants"].get(name)
        if other is not None:           # at the variants' shapes
            summary[-1]["variants"] = [
                {k: r.get(k) for k in (
                    "model", "form", "m_k_n", "shape", "dtype", "scale_dtype",
                    "max_err", "max_err_at", "max_abs_err", "ms",
                    "device_ms", "plain_ms", "library_ms",
                    "library_device_ms", "bound_ms", "bound_by")
                 if k in r} for r in other]
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
