"""The multi-device dry run of the port: the counterpart of the JAX
package's ``__graft_entry__.dryrun_multichip``.

    python -m chestxray_vit_tpu_torch.dryrun N [--device cpu]

Starts N ranks (one process each, through the launcher's spawn and
``file://`` rendezvous, ``parallel/launch.py``) over the mesh the JAX dry
run picks: fsdp = 2 when N ≥ 4 and even, tensor = 2 when
N ≥ 8 as well, data the rest; with N ≥ 4 also a dcn mesh (dcn_data = 2).
On each mesh the ranks run, on a tiny bf16 model with every axis's
collectives in it, what the launcher runs in one process on the global
batch, and the launcher compares:

- the full train step (forward, backward, clip, AdamW): loss within 5e-5;
- the merged train step (``tome_r`` 1, decreasing): loss within 5e-5;
- the static int8 eval (the gathered tree quantized once on the global
  batch, each batch slot its rows): logits within 1e-4.

Ranks run on the cards unless ``--device cpu`` is given: rank r on
``cuda:r % cards``. The group's backend follows the placement: NCCL with
a card a rank, gloo where ranks share a card (staged through the host, so
it needs no card a rank) or run on the CPU. Without a card the run stops
with an error; it never falls back to the CPU. Exit code 0 when
every check passes; the last line of the output is a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from chestxray_vit_tpu_torch.config import (Config, MeshConfig, ModelConfig,
                                            TrainConfig)

LOSS_TOL, LOGIT_TOL = 5e-5, 1e-4
PER_SLOT = 2                 # the JAX dry run's batch_size_per_core
TOTAL_STEPS = 10


def _config(**model) -> Config:
    """The JAX dry run's tiny model, bf16, with every axis's collectives
    in it (4 heads of 16 split whole over tensor = 2)."""
    return Config(
        model=ModelConfig(img_size=32, patch_size=16, hidden_size=64,
                          num_layers=2, num_heads=4, mlp_dim=128,
                          num_classes=15, dtype="bfloat16", **model),
        train=TrainConfig(batch_size_per_core=PER_SLOT))


def meshes(n: int) -> List[Tuple[int, int, int, int]]:
    """(dcn_data, data, fsdp, tensor) of the dry run of ``n`` ranks: the
    JAX dry run's axes, then the dcn mesh when n ≥ 4."""
    fsdp = 2 if n % 2 == 0 and n >= 4 else 1
    tensor = 2 if n % (2 * fsdp) == 0 and n >= 8 else 1
    out = [(1, n // (fsdp * tensor), fsdp, tensor)]
    if n >= 4 and n % (2 * fsdp * tensor) == 0:
        out.append((2, n // (2 * fsdp * tensor), fsdp, tensor))
    return out


def _batch(n: int, device) -> Dict[str, torch.Tensor]:
    b = PER_SLOT * n
    rng = np.random.default_rng(0)
    return {"pixel_values": torch.from_numpy(rng.standard_normal(
        (b, 32, 32, 3)).astype(np.float32)).to(device),
            "labels": torch.from_numpy((rng.random((b, 15)) < 0.2).astype(
                np.float32)).to(device)}


def _init(cfg: Config, device):
    from chestxray_vit_tpu_torch.models import vit
    return vit.init_params(torch.Generator().manual_seed(0), cfg.model,
                           device=device)


def _step_loss(cfg: Config, params, batch, mesh=None) -> float:
    from chestxray_vit_tpu_torch.train import steps as S
    step = S.make_train_step(cfg, TOTAL_STEPS, mesh=mesh,
                             **({} if mesh else {"rank": 0, "world": 1}))
    _, m = step(S.TrainState.create(params, 0), batch)
    return float(m["loss"])


def _int8_logits(cfg: Config, params, images, batch) -> torch.Tensor:
    from chestxray_vit_tpu_torch.models import quantized
    from chestxray_vit_tpu_torch.parallel import fsdp
    from chestxray_vit_tpu_torch.train import steps as S
    full = fsdp.gather_params(params)
    scales = quantized.calibrate_vit_scales(full, images, cfg.model)
    qp = quantized.quantize_vit_params(full, scales)
    with torch.no_grad():
        return S.make_quantized_eval_step(cfg)(qp, batch)[0]


def worker(dev: torch.device, world: int) -> list:
    """One rank (the launcher's object for it is its device): every mesh's
    three checks; rank 0's results are the call's value."""
    from chestxray_vit_tpu_torch.parallel import distributed as dist
    from chestxray_vit_tpu_torch.parallel import fsdp
    from chestxray_vit_tpu_torch.parallel import mesh as mesh_lib
    from chestxray_vit_tpu_torch.train import steps as S

    torch.set_num_threads(1)
    glob = _batch(world, dev)
    res = []
    for c, d, f, t in meshes(world):
        mesh = mesh_lib.build_mesh(MeshConfig(dcn_data=c, data=d, fsdp=f,
                                              tensor=t))
        per = PER_SLOT * world // mesh_lib.dp_size(mesh)
        rows = slice(mesh.dp_index * per, (mesh.dp_index + 1) * per)
        batch = {k: v[rows] for k, v in glob.items()}
        rec = {"mesh": [c, d, f, t]}
        for kind, cfg in (("dense", _config()),
                          ("tome", _config(tome_r=1,
                                           tome_schedule="decreasing"))):
            params = fsdp.shard_params(_init(cfg, dev), mesh)
            rec[f"{kind}_loss"] = _step_loss(cfg, params, batch, mesh)
        cfg = _config()
        params = fsdp.shard_params(_init(cfg, dev), mesh)
        logits = _int8_logits(cfg, params, S._images(cfg, glob), batch)
        rec["int8_logits"] = dist.process_allgather(
            logits, mesh.axis("batch")).tolist()
        res.append(rec)
    dist.barrier("dry run done")
    return res


def dryrun(n: int, device: str = "cuda") -> dict:
    """Run the dry run over ``n`` ranks on ``device``; returns the summary
    (``ok`` and each mesh's differences) and raises when a check fails or
    a rank does."""
    from chestxray_vit_tpu_torch.parallel import launch

    if n < 1:
        raise ValueError(f"the dry run needs a rank at least, got {n}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the dry run runs on the cards (no CUDA device "
                           "is available); pass --device cpu for the CPU")
    cards = torch.cuda.device_count() if device == "cuda" else 1
    devices = [torch.device(device, r % cards) if device == "cuda"
               else torch.device(device) for r in range(n)]
    t0 = time.perf_counter()
    ranks = launch.Ranks(devices, what=f"the dry run's {n} ranks")
    try:
        refs = _references(n, device)     # while the ranks start
        ranks_res = ranks.call(worker, n)
    finally:
        ranks.close()
    summary = {"ranks": n, "device": device, "meshes": [], "ok": True}
    for rec in ranks_res:
        row = {"mesh": "x".join(map(str, rec["mesh"])),
               "dense_loss_delta": abs(rec["dense_loss"] - refs["dense"]),
               "tome_loss_delta": abs(rec["tome_loss"] - refs["tome"]),
               "int8_logit_delta": float(np.abs(
                   np.asarray(rec["int8_logits"]) - refs["int8"]).max()),
               "loss": rec["dense_loss"]}
        row["ok"] = bool(row["dense_loss_delta"] < LOSS_TOL
                         and row["tome_loss_delta"] < LOSS_TOL
                         and row["int8_logit_delta"] < LOGIT_TOL
                         and np.isfinite(rec["dense_loss"]))
        summary["ok"] &= row["ok"]
        summary["meshes"].append(row)
        print(f"dryrun({n}) mesh dcn x data x fsdp x tensor = {row['mesh']}"
              f": loss={rec['dense_loss']:.4f} single_process_delta="
              f"{row['dense_loss_delta']:.2e} tome={row['tome_loss_delta']:.2e}"
              f" int8_logits={row['int8_logit_delta']:.2e} "
              f"{'OK' if row['ok'] else 'FAILED'}", flush=True)
    summary["seconds"] = time.perf_counter() - t0
    if not summary["ok"]:
        raise AssertionError(f"dry run failed: {summary}")
    return summary


def _references(n: int, device: str) -> dict:
    """The one-process runs on the global batch (this process joins no
    group, so its steps sum nothing)."""
    from chestxray_vit_tpu_torch.train import steps as S
    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        device)
    batch = _batch(n, dev)
    cfg = _config()
    out = {"dense": _step_loss(cfg, _init(cfg, dev), batch)}
    tcfg = _config(tome_r=1, tome_schedule="decreasing")
    out["tome"] = _step_loss(tcfg, _init(tcfg, dev), batch)
    out["int8"] = _int8_logits(cfg, _init(cfg, dev), S._images(cfg, batch),
                               batch).float().cpu().numpy()
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(
        prog="python -m chestxray_vit_tpu_torch.dryrun",
        description="multi-rank dry run of the train step over a "
                    "(dcn, data, fsdp, tensor) mesh against one process")
    ap.add_argument("n", type=int, help="ranks to spawn")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ns = ap.parse_args(argv)
    summary = dryrun(ns.n, ns.device)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
