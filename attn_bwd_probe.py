"""The attention backward kernels under several builds, on one NVIDIA GPU.

    python3 attn_bwd_probe.py ["<nvcc flags>" ...]

Each argument is one build's extra nvcc flags (``CXR_NVCC_FLAGS``; the
empty string is the tree as it stands, and the only build when no argument
is given), for example ``-DCXR_NO_TILE_SKIP``. Every build runs in its own
process (the library is loaded once per process), in the order given and
then in reverse, so that each build is timed twice on the same card. A build:

- multiplies through the tile helpers alone (``tile_mma_selftest.cu``) in
  its three forms, whole and ragged, against ``torch.matmul``;
- holds the dense, dropout and segment backward against their plain
  versions at a few sequence lengths (largest error relative to each
  gradient's largest magnitude) and calls each twice (equal bits);
- times the dense and dropout backward at [36, 12, 577, 64] bf16 and the
  segment backward at [32, 12, S, 64] in two layouts (median of 7 x 10
  calls, CUDA events), and the dK/dV and dQ kernels apart
  (``torch.profiler`` over ten calls);
- reports each backward kernel's registers, spills and shared memory from
  the build log (``-Xptxas -v``).

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

from chip_smoke import backward_pass_ms, rel_err, time_ms
from smoke_batches import PACKED_SEQS, packed_layouts

RATE, SEED = 0.1, -123456789
TRAIN_SHAPE = (36, 12, 577, 64)


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
    """{kernel: "registers, spills, shared"} of the backward's bf16 kernels
    from the build log."""
    from chestxray_vit_tpu_torch import kernels

    text = kernels.library_path().with_suffix(".log").read_text()
    out = {}
    for m in re.finditer(
            r"Compiling entry function '(\w*attn_bwd_d\w+bf16\w*)'.*?\n"
            r"(?:.*?\n)*?.*?(\d+) bytes spill stores, (\d+) bytes spill "
            r"loads\n.*?Used (\d+) registers(.*?)\n", text):
        name = re.sub(r"^_ZN3cxr3bwd\d+", "", m.group(1))
        out[name] = (f"{m.group(4)} registers, spill {m.group(2)}/"
                     f"{m.group(3)}{m.group(5)}")
    warnings = sorted(set(re.findall(r"warning[^\n]*", text)))
    if warnings:
        out["warnings"] = warnings[:10]
    return out


def child() -> int:
    from chestxray_vit_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"flags": os.environ.get("CXR_NVCC_FLAGS", ""),
           "selftest": selftest(gen), "errors": {}, "equal_twice": True}

    def operands(b, s, dtype=torch.bfloat16):
        x = torch.randn((b, s, 3, 12, 64), generator=gen, device="cuda"
                        ).to(dtype)
        q, k, v = (t.transpose(1, 2) for t in x.unbind(2))
        do = torch.randn((b, 12, s, 64), generator=gen, device="cuda"
                         ).to(dtype)
        return q, k, v, do

    for s in (1, 37, 64, 65, 129, 577, 1025):
        q, k, v, do = operands(2, s)
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

    q, k, v, do = operands(*TRAIN_SHAPE[:1], TRAIN_SHAPE[2])
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
        q, k, v, do = operands(b, s)
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
        out[f"packed_{name}"] = {"ms": time_ms(packed), **backward_pass_ms(packed)}
        out[f"packed_dropout_{name}"] = {"ms": time_ms(packed_dropout)}
    out["build"] = build_report()
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("attn_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    if "--child" in sys.argv[1:]:
        return child()
    builds = sys.argv[1:] or [""]
    order = builds + builds[::-1] if len(builds) > 1 else builds
    failed = 0
    for flags in order:
        env = dict(os.environ, CXR_NVCC_FLAGS=flags)
        done = subprocess.run([sys.executable, __file__, "--child"], env=env,
                              capture_output=True, text=True, check=False)
        if done.returncode:
            failed += 1
            print(json.dumps({"flags": flags, "failed": done.returncode,
                              "stderr": done.stderr[-3000:]}), flush=True)
        else:
            print(done.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "builds": order}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
