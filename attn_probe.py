"""The hand-written kernels under several builds, on one NVIDIA GPU.

    python3 attn_probe.py [--only fwd|bwd|int8|ln] [--parent DIR]
                          ["<nvcc flags>" ...]

Each argument is one build's extra nvcc flags (``CXR_NVCC_FLAGS``; the
empty string is the tree as it stands, and the only build when no argument
is given), for example ``-DCXR_NO_TILE_SKIP``. ``--parent DIR`` adds one
build of another checkout (say a ``git archive`` of the parent commit under
``_scratch/``), whose package is imported in place of this tree's (the
timing helpers and shapes stay this tree's ``chip_smoke.py``). Every build
runs in its own process (the library is loaded once per process), in the
order given and then in reverse, so that each build is timed twice on the
same card. A build:

- multiplies through the tile helpers alone (``tile_mma_selftest.cu``) in
  its three bf16 forms, the fragments stored into a tile and read back
  (mode 7), the two 16-wide forms of the forward at kD = 80,
  whole and ragged, against ``torch.matmul``, and in its two int8 forms
  exactly against the integer product (a build without them reports so);
- forward (``--only fwd``; with no ``--only``, the two attention parts):
  holds the inference, training and
  dropout forwards against their plain versions at S = 1 … 1025 (largest
  absolute error of o and lse), the debug kernel's mask against the plain
  hash (mismatches), the segment forwards in two layouts, calls the
  training forward twice (equal bits), and times the inference forward at
  [8, 12, 577, 64] and [32, 12, 577, 64], the training, dropout and debug
  forwards at [36, 12, 577, 64], the inference and training forwards at
  ViT-H/14's [8 | 32, 16, 257, 80] (``vith_*``) and the segment forwards
  at [32, 12, S, 64] (median of 7 x 10 calls, CUDA events; the inference
  and training forwards also by the profiler's device time,
  ``fwd_device_ms``); then the wide forwards (d > 128,
  ``wide_forward``): every form against its plain version at d = 136 ...
  768, each form's bits twice, and their times at ViT-B/16 @384 in three
  heads of 256 (``wide_inf_b8``, ``wide_fwd_b36`` beside SDPA's device
  time in the same process; ``wide_dropout_b36``, ``wide_debug_b36``,
  ``wide_packed_b32``, ``wide_packed_dropout_b32``);
- backward (``--only bwd``, or both): holds the dense, dropout and segment
  backward against their plain versions at a few sequence lengths (largest
  error relative to each gradient's largest magnitude), calls each twice
  (equal bits), times the dense and dropout backward at [36, 12, 577, 64],
  the dense backward at ViT-H/14's [8 | 32, 16, 257, 80] (``vith_bwd_b*``,
  held against the plain version and beside SDPA's device time), the
  wide backward at the three-head step's [36, 3, 577, 256]
  (``wide_bwd_b36``, the same, with its Delta pass apart) and the
  segment backward in two layouts, and the dK/dV and dQ kernels apart
  (``torch.profiler`` over ten calls);
- int8 (``--only int8``): the int8 kernel in chip_smoke.py's five call
  forms of the batch-32 int8 forward: mismatches against the plain version
  (0 expected), equal bits twice, CUDA-event and profiler device times
  beside ``torch._int_mm``'s; and its GELU bit for bit against the plain
  version's on every float of |y| in [2^-24, 2^5) (``gelu_sweep``);
- ln (``--only ln``): the LayerNorm forward at the serving, int8 serving
  and training rows (x 768, bf16; the int8 rows with an f32 scale too), at
  ViT-H/14's serving and training rows (8 | 32 × 257, x 1280; the
  training rows with an f32 scale too), at chip_smoke.py's
  VARIANT_LN_CASES (1024, 384, 192) and WIDE_LN_CASES (the any-D kernels:
  50, 1001, 2560, 6144, 9000): error against the plain version, equal
  bits twice, CUDA-event and device times beside ``F.layer_norm``'s;
  the backward at the dense and packed training rows (36 × 577, 32 ×
  1152, x 768) and at ViT-H/14's serving and training rows (8 | 32 × 257,
  x 1280) with a bf16 and an f32 scale, and at WIDE_LN_CASES: errors,
  equal bits twice, event and device times (its column pass apart), the
  host's µs a call (``host_us``: 200 calls
  enqueued, a sync after) and of the wrapper's block count alone
  (``blocks_us``: ``_bwd_blocks``, 2000 calls) beside
  ``aten.native_layer_norm_backward``'s;
- reports the registers, spills and shared memory of the part's kernels
  from the build log (``-Xptxas -v``).

Prints one JSON line per run and a last line with the card's name and
power limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import torch

RATE, SEED = 0.1, -123456789
TRAIN_SHAPE = (36, 12, 577, 64)
LENGTHS = (1, 37, 64, 65, 128, 129, 577, 1025)


def selftest(gen) -> dict:
    """Largest |error| of the 64 x 64 x 64 bf16 products through the tile
    helpers against ``torch.matmul`` in f32, per orientation and row count
    (mode 7: A's fragments stored into a tile and read back first), the
    same of the 16-wide ones (mode 5: 64 x 64 x 16 through K-major
    32-byte swizzled tiles; mode 6: 64 x 16 x 64, m64n16k16 on an MN-major
    one), and the mismatches of the int8 ones (64 x 64 x 128 and a half k
    tile) against the exact integer product."""
    from chestxray_vit_tpu_torch import kernels

    lib, stream = kernels.library(), torch.cuda.current_stream().cuda_stream
    a = torch.randn((64, 64), generator=gen, device="cuda").to(torch.bfloat16)
    b = torch.randn((64, 64), generator=gen, device="cuda").to(torch.bfloat16)
    out = {}
    # A Bᵀ; A B (the transposed-B form); A Bᵀ with A from shared memory;
    # A B with A's fragments stored into a tile and read back
    for mode in (0, 1, 2, 7):
        for rows in (64, 17):
            c = torch.full((64, 64), float("nan"), device="cuda")
            if lib.cxr_tile_mma_selftest(a.data_ptr(), b.data_ptr(),
                                         c.data_ptr(), mode, rows, 0, stream):
                out[f"mode{mode}_rows{rows}"] = "not in this build"
                continue
            torch.cuda.synchronize()
            bz = b.float().clone()
            bz[rows:] = 0
            ref = a.float() @ (bz if mode in (1, 7) else bz.t())
            out[f"mode{mode}_rows{rows}"] = (c - ref).abs().max().item()
    a16, b16 = (torch.randn((64, 16), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
    for mode, lhs, cols in ((5, a16, 64), (6, a, 16)):
        for rows in (64, 17):
            c = torch.full((64, cols), float("nan"), device="cuda")
            if lib.cxr_tile_mma_selftest(lhs.data_ptr(), b16.data_ptr(),
                                         c.data_ptr(), mode, rows, 0, stream):
                out[f"mode{mode}_rows{rows}"] = "not in this build"
                continue
            torch.cuda.synchronize()
            bz = b16.float().clone()
            bz[rows:] = 0
            ref = lhs.float() @ (bz.t() if mode == 5 else bz)
            out[f"mode{mode}_rows{rows}"] = (c - ref).abs().max().item()
    a8, b8 = (torch.randint(-128, 128, (64, 128), generator=gen,
                            device="cuda", dtype=torch.int8)
              for _ in range(2))
    for mode, k in ((3, 128), (4, 64)):   # the int8 kernel's s8 wgmma
        for rows in (64, 17):
            c = torch.zeros((64, 64), device="cuda", dtype=torch.int32)
            if lib.cxr_tile_mma_selftest(a8.data_ptr(), b8.data_ptr(),
                                         c.data_ptr(), mode, rows, 0, stream):
                out[f"mode{mode}_rows{rows}"] = "not in this build"
                continue
            torch.cuda.synchronize()
            bz = b8.long().cpu()[:, :k]
            bz[rows:] = 0
            ref = a8.long().cpu()[:, :k] @ bz.t()
            out[f"mode{mode}_rows{rows}"] = int((c.long().cpu() != ref).sum())
    return out


# the kernels each part reports from the build log
REPORTED = {"": r"attn_(?:fwd|bwd_d)\w*bf16", "fwd": r"attn_fwd\w*bf16",
            "bwd": r"attn_bwd_d\w*bf16", "int8": r"int8_gemm_fused",
            "ln": r"ln_fwd|ln_bwd"}


def build_report(only: str) -> dict:
    """{kernel: "registers, spills, shared"} of the part's kernels from the
    build log."""
    from chestxray_vit_tpu_torch import kernels

    text = kernels.library_path().with_suffix(".log").read_text()
    out = {}
    for m in re.finditer(
            r"Compiling entry function '(\w*(?:" + REPORTED[only] + r")\w*)'"
            r".*?\n(?:.*?\n)*?.*?(\d+) bytes spill stores, (\d+) bytes spill "
            r"loads\n.*?Used (\d+) registers(.*?)\n", text):
        name = re.sub(r"^_ZN(?:3cxr(?:3bwd)?|12_GLOBAL__N_1)\d+", "",
                      m.group(1))
        out[name] = (f"{m.group(4)} registers, spill {m.group(2)}/"
                     f"{m.group(3)}{m.group(5)}")
    warnings = sorted(set(re.findall(r"warning[^\n]*", text)))
    if warnings:
        out["warnings"] = warnings[:10]
    return out


def operands(gen, b, s, dtype=torch.bfloat16):
    """q, k, v as the projections leave them ([B, H, S, d] views of one
    [B, S, 3, H, d] buffer) and a dO."""
    x = torch.randn((b, s, 3, 12, 64), generator=gen, device="cuda").to(dtype)
    q, k, v = (t.transpose(1, 2) for t in x.unbind(2))
    do = torch.randn((b, 12, s, 64), generator=gen, device="cuda").to(dtype)
    return q, k, v, do


def abs_err(got, ref) -> float:
    return (got.float() - ref.float()).abs().max().item()


def forward(gen, out: dict) -> None:
    from chestxray_vit_tpu_torch.ops import flash_attention as fa
    from chip_smoke import VITH_ATTN_SHAPES, device_ms, time_ms
    from smoke_batches import PACKED_SEQS, packed_layouts

    for s in LENGTHS:
        q, k, v, _ = operands(gen, 2, s)
        bq = fa.auto_block_q(s)
        o_inf = fa.flash_attention_inference(q, k, v)
        o, lse = fa.flash_attention_fwd(q, k, v)
        o2, lse2 = fa.flash_attention_fwd(q, k, v)
        ro, rlse = fa.attention_fwd_reference(q, k, v)
        od, lsed = fa.flash_attention_dropout_fwd(q, k, v, SEED, RATE,
                                                  block_q=bq)
        rod, rlsed = fa.attention_dropout_fwd_reference(q, k, v, SEED, RATE,
                                                        block_q=bq)
        o_dbg, keep = fa.flash_attention_dropout_debug(q, k, v, SEED, RATE,
                                                       block_q=bq)
        q_pad, s_pad = fa.mask_strides(s, bq)
        ref_keep = fa.keep_mask(2 * 12, q_pad, s_pad, SEED, RATE,
                                device=q.device)[:, :s, :s]
        torch.cuda.synchronize()
        out["errors"][f"fwd_S{s}"] = {
            "inference": abs_err(o_inf, ro), "o": abs_err(o, ro),
            "lse": abs_err(lse, rlse), "dropout_o": abs_err(od, rod),
            "dropout_lse": abs_err(lsed, rlsed),
            "debug_o": abs_err(o_dbg, rod),
            "mask_mismatches": int((keep.reshape(ref_keep.shape)
                                    != ref_keep).sum())}
        out["equal_twice"] &= torch.equal(o, o2) and torch.equal(lse, lse2)

    times, device = out["fwd_ms"], out.setdefault("fwd_device_ms", {})
    for b in (8, 32):
        q, k, v = (torch.randn((b, 12, 577, 64), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        times[f"inference_b{b}"] = time_ms(
            lambda: fa.flash_attention_inference(q, k, v))
        device[f"inference_b{b}"] = device_ms(
            lambda: fa.flash_attention_inference(q, k, v))["device_ms"]
    q, k, v, _ = operands(gen, *TRAIN_SHAPE[:1], TRAIN_SHAPE[2])
    bq = fa.auto_block_q(TRAIN_SHAPE[2])
    times["fwd_b36"] = time_ms(lambda: fa.flash_attention_fwd(q, k, v))
    device["fwd_b36"] = device_ms(
        lambda: fa.flash_attention_fwd(q, k, v))["device_ms"]
    times["dropout_fwd_b36"] = time_ms(lambda: fa.flash_attention_dropout_fwd(
        q, k, v, SEED, RATE, block_q=bq))
    times["dropout_debug_b36"] = time_ms(
        lambda: fa.flash_attention_dropout_debug(q, k, v, SEED, RATE,
                                                 block_q=bq))
    del q, k, v
    for b, h, s, d in VITH_ATTN_SHAPES:
        x = torch.randn((b, s, 3, h, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        q, k, v = (t.transpose(1, 2) for t in x.unbind(2))
        for name, fn in (("inference", fa.flash_attention_inference),
                         ("fwd", fa.flash_attention_fwd)):
            times[f"vith_{name}_b{b}"] = time_ms(lambda: fn(q, k, v))
            device[f"vith_{name}_b{b}"] = device_ms(
                lambda: fn(q, k, v))["device_ms"]
        del x, q, k, v

    for name, seg in packed_layouts(PACKED_SEQS).items():
        if name == "mixed_pad":
            continue
        b, s = seg.shape
        q, k, v, _ = operands(gen, b, s)
        drop = (SEED, RATE, None, fa.packed_block_q(s))
        small = slice(0, 2)
        o, lse = fa.flash_attention_packed_fwd(q, k, v, seg)
        od, lsed = fa.flash_attention_packed_dropout_fwd(q, k, v, seg, *drop)
        ro, rlse = fa.attention_packed_fwd_reference(
            q[small], k[small], v[small], seg[small])
        rod, rlsed = fa.attention_packed_dropout_fwd_reference(
            q[small], k[small], v[small], seg[small], *drop)
        torch.cuda.synchronize()
        out["errors"][f"packed_fwd_{name}"] = {
            "o": abs_err(o[small], ro), "lse": abs_err(lse[small], rlse),
            "dropout_o": abs_err(od[small], rod),
            "dropout_lse": abs_err(lsed[small], rlsed)}
        times[f"packed_{name}"] = time_ms(
            lambda: fa.flash_attention_packed_fwd(q, k, v, seg))
        times[f"packed_dropout_{name}"] = time_ms(
            lambda: fa.flash_attention_packed_dropout_fwd(q, k, v, seg,
                                                          *drop))
    del q, k, v
    wide_forward(gen, out)


# the wide forwards' head dims (three and four 64-column chunks, a last
# chunk of 8 columns, 256, and two and three 256-column blocks) and lengths
# (a row, a short odd S, the 128-row block's edge, 577)
WIDE_HEAD_DIMS = (136, 192, 200, 256, 264, 768)
WIDE_LENGTHS = (1, 37, 128, 129, 577)


def wide_forward(gen, out: dict) -> None:
    """The wide forwards (d > 128, ``attention_fwd_wide.cuh``): every form
    (inference, lse, dropout, the debug mask, segment ids with and without
    dropout) against its plain version at WIDE_HEAD_DIMS x WIDE_LENGTHS
    (batch 2, three heads, two segments; the largest absolute error of o
    and lse and the mask's mismatches under ``errors["wide_d<d>_S<s>"]``,
    and each form's bits twice), then timed at ViT-B/16 @384 in three
    heads of 256 (q, k, v as [B, S, 3, H, d] views): ``wide_inf_b8``
    (inference, [8, 3, 577, 256]), ``wide_fwd_b36`` (lse, [36, 3, 577,
    256]), ``wide_dropout_b36`` and ``wide_debug_b36`` (rate 0.1), and the
    packed forms at 32 x 1152 in two segments of 576 (``wide_packed_b32``,
    ``wide_packed_dropout_b32``): CUDA-event and device ms, the bound by
    the real d, and beside the first two SDPA's backend and its event and
    device ms in the same process."""
    from chestxray_vit_tpu_torch.ops import flash_attention as fa
    from chip_smoke import (ATTN_TOL, TRAIN_BATCH, attention_bound,
                            device_ms, library_sdpa, packed_attention_bound,
                            time_ms)
    from smoke_batches import PACKED_SEQS, packed_layouts

    bf16 = torch.bfloat16
    tol = ATTN_TOL[bf16]

    def views(b, s, h, d):
        x = torch.randn((b, s, 3, h, d), generator=gen, device="cuda").to(
            bf16)
        return [t.transpose(1, 2) for t in x.unbind(2)]

    def two_segments(b, s):
        ids = (torch.arange(s, device="cuda") >= s // 2).to(torch.int32)
        return ids.expand(b, s).contiguous()

    within = True
    for d in WIDE_HEAD_DIMS:
        for s in WIDE_LENGTHS:
            q, k, v = views(2, s, 3, d)
            seg = two_segments(2, s)
            bq, pbq = fa.auto_block_q(s), fa.packed_block_q(s)

            def run():
                return {
                    "inference": (fa.flash_attention_inference(q, k, v),),
                    "fwd": fa.flash_attention_fwd(q, k, v),
                    "dropout": fa.flash_attention_dropout_fwd(
                        q, k, v, SEED, RATE, block_q=bq),
                    "debug": fa.flash_attention_dropout_debug(
                        q, k, v, SEED, RATE, block_q=bq),
                    "packed": fa.flash_attention_packed_fwd(q, k, v, seg),
                    "packed_dropout": fa.flash_attention_packed_dropout_fwd(
                        q, k, v, seg, SEED, RATE, None, pbq)}

            got, again = run(), run()
            drop_ref = fa.attention_dropout_fwd_reference(
                q, k, v, SEED, RATE, block_q=bq)
            ref = {"inference": (fa.attention_reference(q, k, v),),
                   "fwd": fa.attention_fwd_reference(q, k, v),
                   "dropout": drop_ref,
                   "debug": (drop_ref[0], fa._keep(q, SEED, RATE, bq)),
                   "packed": fa.attention_packed_fwd_reference(q, k, v, seg),
                   "packed_dropout": fa.attention_packed_dropout_fwd_reference(
                       q, k, v, seg, SEED, RATE, None, pbq)}
            torch.cuda.synchronize()
            errs = {}
            for form, outs in got.items():
                errs[form] = [int((g != r).sum()) if g.dtype == torch.bool
                              else abs_err(g, r)
                              for g, r in zip(outs, ref[form])]
                within &= all(e <= (0 if isinstance(e, int) else tol)
                              for e in errs[form])
                out["equal_twice"] &= all(torch.equal(a, b) for a, b
                                          in zip(outs, again[form]))
            out["errors"][f"wide_d{d}_S{s}"] = errs
            del q, k, v, got, again, ref, drop_ref
    out["wide_within_tol"] = within

    h, s, d = 3, 577, 256
    for key, b, kw in (("wide_inf_b8", 8, {}),
                       ("wide_fwd_b36", TRAIN_BATCH, {"lse": True})):
        shape = (b, h, s, d)
        q, k, v = views(b, s, h, d)
        do = torch.randn(shape, generator=gen, device="cuda").to(bf16)
        fn = ((lambda: fa.flash_attention_inference(q, k, v)) if not kw
              else (lambda: fa.flash_attention_fwd(q, k, v)))
        bound = attention_bound(shape, bf16, **kw)
        lib = library_sdpa(q, k, v, do)
        out[key] = {"ms": time_ms(fn), **device_ms(fn),
                    "library_backend": lib["library_backend"],
                    "library_ms": lib["library_ms"],
                    "library_device_ms": lib["library_device_ms"],
                    "bound_ms": bound["bound_ms"],
                    "bound_by": bound["bound_by"]}
        del q, k, v, do
    shape = (TRAIN_BATCH, h, s, d)
    q, k, v = views(TRAIN_BATCH, s, h, d)
    bq = fa.auto_block_q(s)
    for key, fn, kw in (
            ("wide_dropout_b36",
             lambda: fa.flash_attention_dropout_fwd(q, k, v, SEED, RATE,
                                                    block_q=bq),
             {"lse": True, "hash_passes": 1}),
            ("wide_debug_b36",
             lambda: fa.flash_attention_dropout_debug(q, k, v, SEED, RATE,
                                                      block_q=bq),
             {"hash_passes": 1, "mask_out": True})):
        bound = attention_bound(shape, bf16, **kw)
        out[key] = {"ms": time_ms(fn), **device_ms(fn),
                    "bound_ms": bound["bound_ms"],
                    "bound_by": bound["bound_by"]}
    del q, k, v
    seg = packed_layouts(PACKED_SEQS)["two_segments"]
    b, s = seg.shape
    q, k, v = views(b, s, h, d)
    drop = (SEED, RATE, None, fa.packed_block_q(s))
    small = slice(0, 2)
    for key, fn, plain, kw in (
            ("wide_packed_b32",
             lambda: fa.flash_attention_packed_fwd(q, k, v, seg),
             lambda: fa.attention_packed_fwd_reference(
                 q[small], k[small], v[small], seg[small]), {}),
            ("wide_packed_dropout_b32",
             lambda: fa.flash_attention_packed_dropout_fwd(q, k, v, seg,
                                                           *drop),
             lambda: fa.attention_packed_dropout_fwd_reference(
                 q[small], k[small], v[small], seg[small], *drop),
             {"hash_passes": 1})):
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        out["errors"][key] = [abs_err(g[small], r) for g, r in zip(got, ref)]
        del got, ref
        bound = packed_attention_bound(seg, h, bf16, d=d, **kw)
        out[key] = {"ms": time_ms(fn), **device_ms(fn),
                    "bound_ms": bound["bound_ms"],
                    "bound_by": bound["bound_by"]}
    del q, k, v


def backward(gen, out: dict) -> None:
    from chestxray_vit_tpu_torch.ops import flash_attention as fa
    from chip_smoke import (VITH_ATTN_SHAPES, backward_pass_ms,
                            library_attention_device_ms, rel_err, time_ms)
    from smoke_batches import PACKED_SEQS, packed_layouts

    for s in (1, 37, 64, 65, 129, 577, 1025):
        q, k, v, do = operands(gen, 2, s)
        o, lse = fa.flash_attention_fwd(q, k, v)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do)
        again = fa.flash_attention_bwd(q, k, v, o, lse, do)
        ref = fa.attention_bwd_reference(q, k, v, o, lse, do)
        bq = fa.auto_block_q(s)
        od, lsed = fa.flash_attention_dropout_fwd(q, k, v, SEED, RATE,
                                                  block_q=bq)
        gotd = fa.flash_attention_dropout_bwd(q, k, v, od, lsed, do, SEED,
                                              RATE, block_q=bq)
        refd = fa.attention_dropout_bwd_reference(q, k, v, od, lsed, do, SEED,
                                                  RATE, block_q=bq)
        torch.cuda.synchronize()
        out["errors"][f"dense_S{s}"] = [rel_err(g, r)
                                        for g, r in zip(got, ref)]
        out["errors"][f"dropout_S{s}"] = [rel_err(g, r)
                                          for g, r in zip(gotd, refd)]
        out["equal_twice"] &= all(torch.equal(a, b)
                                  for a, b in zip(got, again))

    q, k, v, do = operands(gen, *TRAIN_SHAPE[:1], TRAIN_SHAPE[2])
    o, lse = fa.flash_attention_fwd(q, k, v)
    bq = fa.auto_block_q(TRAIN_SHAPE[2])
    od, lsed = fa.flash_attention_dropout_fwd(q, k, v, SEED, RATE, block_q=bq)

    def dense():
        return fa.flash_attention_bwd(q, k, v, o, lse, do)

    def dropout():
        return fa.flash_attention_dropout_bwd(q, k, v, od, lsed, do, SEED,
                                              RATE, block_q=bq)

    out["dense"] = {"ms": time_ms(dense), **backward_pass_ms(dense)}
    out["dropout"] = {"ms": time_ms(dropout), **backward_pass_ms(dropout)}
    del q, k, v, do, o, lse, od, lsed

    for b, h, s, d in VITH_ATTN_SHAPES:
        x = torch.randn((b, s, 3, h, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        q, k, v = (t.transpose(1, 2) for t in x.unbind(2))
        do = torch.randn((b, h, s, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        o, lse = fa.flash_attention_fwd(q, k, v)

        def vith():
            return fa.flash_attention_bwd(q, k, v, o, lse, do)

        got, again = vith(), vith()
        ref = fa.attention_bwd_reference(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        out["errors"][f"vith_bwd_b{b}"] = [rel_err(g, r)
                                           for g, r in zip(got, ref)]
        out["equal_twice"] &= all(torch.equal(a, b)
                                  for a, b in zip(got, again))
        del got, again, ref
        out[f"vith_bwd_b{b}"] = {
            "ms": time_ms(vith), **backward_pass_ms(vith),
            "library_device_ms": library_attention_device_ms(q, k, v, do)[1]}
        del x, q, k, v, do, o, lse

    wide_backward(gen, out)

    for name, seg in packed_layouts(PACKED_SEQS).items():
        if name == "mixed_pad":
            continue
        b, s = seg.shape
        q, k, v, do = operands(gen, b, s)
        drop = (SEED, RATE, None, fa.packed_block_q(s))
        o, lse = fa.flash_attention_packed_fwd(q, k, v, seg)
        od, lsed = fa.flash_attention_packed_dropout_fwd(q, k, v, seg, *drop)

        def packed():
            return fa.flash_attention_packed_bwd(q, k, v, seg, o, lse, do)

        def packed_dropout():
            return fa.flash_attention_packed_dropout_bwd(q, k, v, seg, od,
                                                         lsed, do, *drop)

        small = slice(0, 2)
        ref = fa.attention_packed_bwd_reference(
            q[small], k[small], v[small], seg[small], o[small], lse[small],
            do[small])
        refd = fa.attention_packed_dropout_bwd_reference(
            q[small], k[small], v[small], seg[small], od[small], lsed[small],
            do[small], *drop)
        got, again = packed(), packed()
        out["errors"][f"packed_{name}"] = [rel_err(g[small], r)
                                           for g, r in zip(got, ref)]
        out["errors"][f"packed_dropout_{name}"] = [
            rel_err(g[small], r) for g, r in zip(packed_dropout(), refd)]
        out["equal_twice"] &= all(torch.equal(a, b)
                                  for a, b in zip(got, again))
        out[f"packed_{name}"] = {"ms": time_ms(packed),
                                 **backward_pass_ms(packed)}
        out[f"packed_dropout_{name}"] = {"ms": time_ms(packed_dropout)}


def wide_backward(gen, out: dict) -> None:
    """The wide backward (d = 256) at the three-head train step's
    [36, 3, 577, 256] (``wide_bwd_b36``; q, k, v as [B, S, 3, H, d]
    views): relative errors against the plain version, equal bits twice,
    CUDA-event ms and device ms by pass (Delta, dK/dV, dQ), beside flash
    SDPA's device time on contiguous copies."""
    from chestxray_vit_tpu_torch.ops import flash_attention as fa
    from chip_smoke import (TRAIN_BATCH, backward_pass_ms,
                            library_attention_device_ms, rel_err, time_ms)

    b, h, s, d = TRAIN_BATCH, 3, 577, 256
    x = torch.randn((b, s, 3, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = (t.transpose(1, 2) for t in x.unbind(2))
    do = torch.randn((b, h, s, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, k, v)

    def wide():
        return fa.flash_attention_bwd(q, k, v, o, lse, do)

    got, again = wide(), wide()
    ref = fa.attention_bwd_reference(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    out["errors"]["wide_bwd_b36"] = [rel_err(g, r) for g, r in zip(got, ref)]
    out["equal_twice"] &= all(torch.equal(a, b) for a, b in zip(got, again))
    del got, again, ref
    out["wide_bwd_b36"] = {
        "ms": time_ms(wide), **backward_pass_ms(wide),
        "library_device_ms": library_attention_device_ms(q, k, v, do)[1]}
    del x, q, k, v, do, o, lse


def int8(gen, out: dict) -> None:
    from chestxray_vit_tpu_torch.ops import int8_matmul as i8
    from chip_smoke import INT8_FORMS, device_ms, int8_operands, time_ms

    for name, m, k, n, with_resid, gelu in INT8_FORMS:
        xq, wq, scale, bias, kw = int8_operands(gen, m, k, n, with_resid,
                                                gelu)

        def kernel():
            return i8.int8_matmul_fused(xq, wq, scale, bias, **kw)

        def library():
            return torch._int_mm(xq, wq.t())

        got, again = kernel(), kernel()
        ref = i8.int8_matmul_fused_reference(xq, wq, scale, bias, **kw)
        torch.cuda.synchronize()
        out["errors"][f"int8_{name}"] = int((got != ref).sum())
        out["equal_twice"] &= torch.equal(got, again)
        del got, again, ref
        out[f"int8_{name}"] = {
            "ms": time_ms(kernel), **device_ms(kernel),
            "library_ms": time_ms(library),
            "library_device_ms": device_ms(library)["device_ms"]}
    out["gelu_sweep"] = gelu_sweep()


def gelu_sweep() -> dict:
    """The int8 kernel's exact-erf GELU against the plain version's, bit for
    bit, on every float y with |y| in [2^-24, 2^5) (both signs) and a few
    special values: an f32-out GELU call on xq = 0, so that y = bias."""
    from chestxray_vit_tpu_torch.ops import int8_matmul as i8

    dev = torch.device("cuda")
    n = 1 << 23                       # the floats of one binade
    xq = torch.zeros((1, 64), dtype=torch.int8, device=dev)
    wq = torch.zeros((n, 64), dtype=torch.int8, device=dev)
    scale = torch.ones(n, device=dev)
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                            float("nan"), 1e30, -1e30, 1e-40, -1e-40,
                            3.4e38, -3.4e38, 2.0 ** -30, 40.0, -40.0,
                            1e6, -1e6], device=dev)
    values = mismatches = 0
    for e in range(-24, 5):
        y = (torch.arange(n, dtype=torch.int32, device=dev)
             + ((e + 127) << 23)).view(torch.float32)
        for bias in (y, -y):
            got = i8.int8_matmul_fused(xq, wq, scale, bias, gelu=True,
                                       out_dtype=torch.float32)
            ref = i8.int8_matmul_fused_reference(xq, wq, scale, bias,
                                                 gelu=True,
                                                 out_dtype=torch.float32)
            mismatches += int((got.view(torch.int32)
                               != ref.view(torch.int32)).sum())
            values += n
    k = special.numel()
    got = i8.int8_matmul_fused(xq, wq[:k], scale[:k], special, gelu=True,
                               out_dtype=torch.float32)
    ref = i8.int8_matmul_fused_reference(xq, wq[:k], scale[:k], special,
                                         gelu=True, out_dtype=torch.float32)
    same = (got == ref) | (got.isnan() & ref.isnan())
    return {"values": values + k,
            "mismatches": mismatches + int((~same).sum())}


def ln_key(prefix: str, rows: int, d: int, x_dtype, w_dtype) -> str:
    """``<prefix>_<rows>_<d>_<scale dtype>``, ``_x_float32`` after it for
    f32 rows."""
    key = f"{prefix}_{rows}_{d}_{str(w_dtype).split('.')[-1]}"
    return key + ("_x_float32" if x_dtype == torch.float32 else "")


def layer_norm(gen, out: dict) -> None:
    from chestxray_vit_tpu_torch.ops import layer_norm as ln
    from chip_smoke import (VARIANT_LN_CASES, WIDE_LN_CASES, bf16_ulp,
                            device_ms, time_ms)

    bf16 = torch.bfloat16
    for rows, d, x_dtype, w_dtype in ((8 * 577, 768, bf16, bf16),
                                      (32 * 577, 768, bf16, bf16),
                                      (32 * 577, 768, bf16, torch.float32),
                                      (36 * 577, 768, bf16, bf16),
                                      (8 * 257, 1280, bf16, bf16),
                                      (32 * 257, 1280, bf16, bf16),
                                      (32 * 257, 1280, bf16, torch.float32),
                                      *VARIANT_LN_CASES, *WIDE_LN_CASES):
        x = (torch.randn((rows, d), generator=gen, device="cuda") * 3 + 1
             ).to(x_dtype)
        s, b = (torch.randn((d,), generator=gen, device="cuda").to(w_dtype)
                for _ in range(2))
        ls, lb = s.to(x_dtype), b.to(x_dtype)

        def kernel():
            return ln.layer_norm_cuda(x, s, b, 1e-12)

        def library():
            return torch.nn.functional.layer_norm(x, (d,), ls, lb, 1e-12)

        ref = ln.layer_norm_reference(x, s, b, 1e-12).float()
        y = kernel()
        out["equal_twice"] &= torch.equal(y, kernel())
        diff = (y.float() - ref).abs()
        key = ln_key("ln", rows, d, x_dtype, w_dtype)
        ulp = bf16_ulp(ref) if x_dtype == bf16 else 1e-5 * ref.abs()
        out["errors"][key] = {
            "max_abs_err": diff.max().item(),
            "within_1ulp_1e-5": bool((diff <= ulp + 1e-5).all())}
        out[key] = {"ms": time_ms(kernel), **device_ms(kernel),
                    "library_ms": time_ms(library),
                    "library_device_ms": device_ms(library)["device_ms"]}
    layer_norm_bwd(gen, out)


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn`` over ``calls`` calls enqueued back
    to back (a sync before and after; where the card is the slower, the
    launch queue fills and this reads the card)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return us


def layer_norm_bwd(gen, out: dict) -> None:
    """The LayerNorm backward at the dense and packed training rows (x 768,
    bf16; the block LNs' bf16 scale and the final LN's f32 scale), at
    ViT-H/14's b32 training rows (x 1280, the same two scales) and at
    chip_smoke.py's WIDE_LN_CASES (the any-D kernel: width 50, 1001, 2560,
    6144, 9000):
    errors against the plain version, equal bits twice, CUDA-event and
    device times (``second_pass_ms``: the column pass, ``ln_bwd_cols``),
    beside
    ``aten.native_layer_norm_backward``'s with the scale in x's dtype."""
    from chestxray_vit_tpu_torch.ops import layer_norm as ln
    from chip_smoke import WIDE_LN_CASES, device_ms, rel_err, time_ms

    bf16 = torch.bfloat16
    cases = [(rows, d, bf16, w_dtype)
             for rows, d in ((36 * 577, 768), (32 * 1152, 768),
                             (8 * 257, 1280), (32 * 257, 1280))
             for w_dtype in (bf16, torch.float32)]
    for rows, d, x_dtype, w_dtype in (*cases, *WIDE_LN_CASES):
        x, dy = ((torch.randn((rows, d), generator=gen, device="cuda")
                  * k + m).to(x_dtype) for k, m in ((3, 1), (1, 0)))
        s = torch.randn((d,), generator=gen, device="cuda").to(w_dtype)

        def kernel():
            return ln.layer_norm_bwd_cuda(x, s, dy, 1e-12)

        got, again = kernel(), kernel()
        ref = ln.layer_norm_bwd_reference(x, s, dy, 1e-12)
        torch.cuda.synchronize()
        key = ln_key("ln_bwd", rows, d, x_dtype, w_dtype)
        out["errors"][key] = {"dx": abs_err(got[0], ref[0]),
                              "dscale_dbias_rel": [rel_err(g, r) for g, r
                                                   in zip(got[1:],
                                                          ref[1:])]}
        out["equal_twice"] &= all(torch.equal(a, b)
                                  for a, b in zip(got, again))
        dev = device_ms(kernel, parts=("ln_bwd_cols",))
        out[key] = {"ms": time_ms(kernel), "device_ms": dev["device_ms"],
                    "second_pass_ms": dev["ln_bwd_cols_ms"],
                    "host_us": host_us(kernel),
                    "blocks_us": host_us(
                        lambda: ln._bwd_blocks(x, s, rows), 2000)}
        ls = s.to(x_dtype)
        _, mean, rstd = torch.ops.aten.native_layer_norm(
            x, [d], ls, torch.zeros_like(ls), 1e-12)

        def library():
            return torch.ops.aten.native_layer_norm_backward(
                dy, x, [d], mean, rstd, ls, ls, [True] * 3)

        out[key]["library_ms"] = time_ms(library)
        out[key]["library_device_ms"] = device_ms(library)["device_ms"]


def child(only: str) -> int:
    import chip_smoke  # this tree's helpers, before DIR joins the path

    tree = os.environ.get("CXR_PROBE_TREE")
    if tree:                       # import another checkout's package
        sys.path.insert(0, tree)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"build": tree or os.environ.get("CXR_NVCC_FLAGS", ""),
           "selftest": selftest(gen), "errors": {}, "equal_twice": True,
           "fwd_ms": {}}
    chip_smoke.warm_up()
    if only in ("", "fwd"):
        forward(gen, out)
    if only in ("", "bwd"):
        backward(gen, out)
    if only == "int8":
        int8(gen, out)
    if only == "ln":
        layer_norm(gen, out)
    out["kernels"] = build_report(only)
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("attn_probe: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    only = ""
    if "--only" in args:
        i = args.index("--only")
        only = args[i + 1]
        del args[i:i + 2]
    if "--child" in args:
        return child(only)
    builds = []                    # (environment additions, label)
    if "--parent" in args:
        i = args.index("--parent")
        tree = os.path.abspath(args[i + 1])
        builds.append(({"CXR_PROBE_TREE": tree, "CXR_NVCC_FLAGS": ""},
                       f"parent {args[i + 1]}"))
        del args[i:i + 2]
    builds += [({"CXR_NVCC_FLAGS": f}, f) for f in args or [""]]
    order = builds + builds[::-1] if len(builds) > 1 else builds
    failed = 0
    for extra, label in order:
        env = dict(os.environ, **extra)
        cmd = [sys.executable, os.path.abspath(__file__), "--child"]
        done = subprocess.run(cmd + (["--only", only] if only else []),
                              env=env, capture_output=True, text=True,
                              check=False,
                              cwd=extra.get("CXR_PROBE_TREE") or None)
        if done.returncode:
            failed += 1
            print(json.dumps({"build": label, "failed": done.returncode,
                              "stderr": done.stderr[-3000:]}), flush=True)
        else:
            print(done.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({"nvidia_smi": smi,
                      "builds": [label for _, label in order]}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
