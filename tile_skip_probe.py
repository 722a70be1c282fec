"""What the segment kernels' tile skip costs and saves, on one NVIDIA GPU.

    python3 tile_skip_probe.py

The four segment attention kernels test, per 64-key tile, whether any id of
the tile lies in the block's id range, and skip the tile if none does
(``csrc/common.cuh``): a range scan per block and a block-wide vote (one
more barrier) per tile. This script builds the kernels twice, as they are
and with ``-DCXR_NO_TILE_SKIP`` (no scan, no vote, every tile computed),
and times both at [32, 12, S, 64] bf16 in four layouts: chip_smoke.py's
three (two segments of 576; mixed with padding; interleaved ragged
S = 1136) and ``fragmented`` (two segments after five merges' reordering:
what the later layers of the merged step see, where the test skips
nothing). Each build runs in its own process (the library is loaded once
per process), in the order skip, no skip, no skip, skip; the median of
7 x 10 calls each, the two runs of a build averaged. Prints one JSON line.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import torch

from smoke_batches import (PACKED_SEQS, merged_order, packed_layouts,
                           skipped_tile_share)

RATE, SEED = 0.1, -123456789
NO_SKIP = "-DCXR_NO_TILE_SKIP"


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


def layouts() -> dict:
    out = packed_layouts(PACKED_SEQS)
    ids = out["two_segments"][0].cpu().numpy()
    for _ in range(5):
        ids = merged_order(ids)
    out["fragmented"] = torch.tensor(ids, dtype=torch.int32, device="cuda"
                                     ).repeat(PACKED_SEQS, 1)
    return out


def child() -> int:
    """Times the four kernels of this process's build in every layout."""
    from chestxray_vit_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, seg in layouts().items():
        b, s = seg.shape
        x = torch.randn((b, s, 3, 12, 64), generator=gen, device="cuda"
                        ).to(torch.bfloat16)
        q, k, v = (t.transpose(1, 2) for t in x.unbind(2))
        do = torch.randn((b, 12, s, 64), generator=gen, device="cuda"
                         ).to(torch.bfloat16)
        drop = (SEED, RATE, None, fa.packed_block_q(s))
        o, lse = fa.flash_attention_packed_fwd(q, k, v, seg)
        od, lsed = fa.flash_attention_packed_dropout_fwd(q, k, v, seg, *drop)
        out[name] = {
            "fwd": time_ms(lambda: fa.flash_attention_packed_fwd(
                q, k, v, seg)),
            "bwd": time_ms(lambda: fa.flash_attention_packed_bwd(
                q, k, v, seg, o, lse, do)),
            "dropout_fwd": time_ms(
                lambda: fa.flash_attention_packed_dropout_fwd(
                    q, k, v, seg, *drop)),
            "dropout_bwd": time_ms(
                lambda: fa.flash_attention_packed_dropout_bwd(
                    q, k, v, seg, od, lsed, do, *drop)),
            # a fingerprint: the two builds must compute the same function
            "o_sum": o.float().sum().item(),
            "lse_sum": lse.sum().item()}
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("tile_skip_probe: no CUDA device", file=sys.stderr)
        return 2
    if "--child" in sys.argv[1:]:
        return child()
    runs = {"skip": [], "no_skip": []}
    for build in ("skip", "no_skip", "no_skip", "skip"):
        env = dict(os.environ)
        if build == "no_skip":
            env["CXR_NVCC_FLAGS"] = NO_SKIP
        done = subprocess.run([sys.executable, __file__, "--child"], env=env,
                              capture_output=True, text=True, check=False)
        if done.returncode:
            print(done.stderr[-4000:], file=sys.stderr)
            return 1
        runs[build].append(json.loads(done.stdout.strip().splitlines()[-1]))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    result = {"nvidia_smi": smi, "shape": [PACKED_SEQS, 12, "S", 64],
              "dtype": "bfloat16", "rate": RATE, "layouts": {}}
    for name, seg in layouts().items():
        rec = {"S": seg.shape[1], **skipped_tile_share(seg)}
        for kernel in ("fwd", "bwd", "dropout_fwd", "dropout_bwd"):
            for build, rs in runs.items():
                rec[f"{kernel}_{build}_ms"] = statistics.mean(
                    r[name][kernel] for r in rs)
                rec[f"{kernel}_{build}_runs_ms"] = [r[name][kernel]
                                                    for r in rs]
        a, b = runs["skip"][0][name], runs["no_skip"][0][name]
        rec["same_function"] = (abs(a["o_sum"] - b["o_sum"]) <= 1e-3 * max(
            1.0, abs(a["o_sum"])) and abs(a["lse_sum"] - b["lse_sum"])
            <= 1e-6 * abs(a["lse_sum"]))
        result["layouts"][name] = rec
    print(json.dumps(result), flush=True)
    return 0 if all(r["same_function"]
                    for r in result["layouts"].values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
