"""The bf16 attention kernels under several builds, on one NVIDIA GPU.

    python3 attn_probe.py [--only fwd|bwd] [--parent DIR] ["<nvcc flags>" ...]

Each argument is one build's extra nvcc flags (``CXR_NVCC_FLAGS``; the
empty string is the tree as it stands, and the only build when no argument
is given), for example ``-DCXR_NO_TILE_SKIP``. ``--parent DIR`` adds one
build of another checkout (say a ``git archive`` of the parent commit under
``_scratch/``), whose package and ``chip_smoke.py`` are imported in place of
this tree's. Every build runs in its own process (the library is loaded
once per process), in the order given and then in reverse, so that each
build is timed twice on the same card. A build:

- multiplies through the tile helpers alone (``tile_mma_selftest.cu``) in
  its three forms, whole and ragged, against ``torch.matmul``;
- forward (``--only fwd``, or both): holds the inference, training and
  dropout forwards against their plain versions at S = 1 … 1025 (largest
  absolute error of o and lse), the debug kernel's mask against the plain
  hash (mismatches), the segment forwards in two layouts, calls the
  training forward twice (equal bits), and times the inference forward at
  [8, 12, 577, 64] and [32, 12, 577, 64], the training, dropout and debug
  forwards at [36, 12, 577, 64] and the segment forwards at [32, 12, S, 64]
  (median of 7 x 10 calls, CUDA events);
- backward (``--only bwd``, or both): holds the dense, dropout and segment
  backward against their plain versions at a few sequence lengths (largest
  error relative to each gradient's largest magnitude), calls each twice
  (equal bits), times the dense and dropout backward at [36, 12, 577, 64]
  and the segment backward in two layouts, and the dK/dV and dQ kernels
  apart (``torch.profiler`` over ten calls);
- reports each bf16 attention kernel's registers, spills and shared memory
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

import torch

RATE, SEED = 0.1, -123456789
TRAIN_SHAPE = (36, 12, 577, 64)
LENGTHS = (1, 37, 64, 65, 128, 129, 577, 1025)


def selftest(gen) -> dict:
    """Largest |error| of the 64 x 64 x 64 product through the tile helpers
    against ``torch.matmul`` in f32, per orientation and row count."""
    from chestxray_vit_tpu_torch import kernels

    a = torch.randn((64, 64), generator=gen, device="cuda").to(torch.bfloat16)
    b = torch.randn((64, 64), generator=gen, device="cuda").to(torch.bfloat16)
    out = {}
    # A Bᵀ; A B (the transposed-B form); A Bᵀ with A from shared memory
    for mode in (0, 1, 2):
        for rows in (64, 17):
            c = torch.full((64, 64), float("nan"), device="cuda")
            kernels.check(kernels.library().cxr_tile_mma_selftest(
                a.data_ptr(), b.data_ptr(), c.data_ptr(), mode, rows, 0,
                torch.cuda.current_stream().cuda_stream), "tile_mma_selftest")
            torch.cuda.synchronize()
            bz = b.float().clone()
            bz[rows:] = 0
            ref = a.float() @ (bz if mode == 1 else bz.t())
            out[f"mode{mode}_rows{rows}"] = (c - ref).abs().max().item()
    return out


def build_report() -> dict:
    """{kernel: "registers, spills, shared"} of the bf16 attention kernels
    from the build log."""
    from chestxray_vit_tpu_torch import kernels

    text = kernels.library_path().with_suffix(".log").read_text()
    out = {}
    for m in re.finditer(
            r"Compiling entry function '(\w*attn_(?:fwd|bwd_d)\w*bf16\w*)'"
            r".*?\n(?:.*?\n)*?.*?(\d+) bytes spill stores, (\d+) bytes spill "
            r"loads\n.*?Used (\d+) registers(.*?)\n", text):
        name = re.sub(r"^_ZN3cxr(?:3bwd)?\d+", "", m.group(1))
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
    from chip_smoke import time_ms
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

    times = out["fwd_ms"]
    for b in (8, 32):
        q, k, v = (torch.randn((b, 12, 577, 64), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        times[f"inference_b{b}"] = time_ms(
            lambda: fa.flash_attention_inference(q, k, v))
    q, k, v, _ = operands(gen, *TRAIN_SHAPE[:1], TRAIN_SHAPE[2])
    bq = fa.auto_block_q(TRAIN_SHAPE[2])
    times["fwd_b36"] = time_ms(lambda: fa.flash_attention_fwd(q, k, v))
    times["dropout_fwd_b36"] = time_ms(lambda: fa.flash_attention_dropout_fwd(
        q, k, v, SEED, RATE, block_q=bq))
    times["dropout_debug_b36"] = time_ms(
        lambda: fa.flash_attention_dropout_debug(q, k, v, SEED, RATE,
                                                 block_q=bq))
    del q, k, v

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


def backward(gen, out: dict) -> None:
    from chestxray_vit_tpu_torch.ops import flash_attention as fa
    from chip_smoke import backward_pass_ms, rel_err, time_ms
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


def child(only: str) -> int:
    tree = os.environ.get("CXR_PROBE_TREE")
    if tree:                       # import another checkout's package
        sys.path.insert(0, tree)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"build": tree or os.environ.get("CXR_NVCC_FLAGS", ""),
           "selftest": selftest(gen), "errors": {}, "equal_twice": True,
           "fwd_ms": {}}
    if only in ("", "fwd"):
        forward(gen, out)
    if only in ("", "bwd"):
        backward(gen, out)
    out["kernels"] = build_report()
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
