"""Packed training and the PackedTrainer on fsdp and tensor meshes, and int8
straight-through training on a tensor axis, on the CPU: four gloo
processes against one process and against the JAX package.

One spawn of four ranks hosts every mesh in turn (data × fsdp × tensor
1 × 2 × 2, 2 × 2 × 1, 2 × 1 × 2, 1 × 4 × 1, 1 × 1 × 4, and dcn 2 × 1 × 2 ×
1). On each, from the JAX package's init of the packed tests' model (2
layers, 4 heads of 16, hidden 64, grids 2 / 3 / 4 at patch 16, f32) cut to
the rank's shards, each batch slot taking its sequences of a global batch
of 8 packed sequences:

- two packed steps equal the JAX package's one-device
  ``make_packed_train_step`` (jitted, its segment kernels interpreted) on
  the global batch: loss atol 1e-5, params atol 2e-5, as
  ``tests/test_train_steps.py`` holds the JAX meshes;
- the same with ``gradient_accumulation_steps`` 2, the slots and the
  micro-batches packing unequal real-image counts;
- two merged packed steps (``tome_r`` 2) equal the port's one process
  (2e-5) and the JAX package's (1e-4 of the largest leaf);
- two packed steps with attention and hidden dropout 0.1 equal the port's
  one process on the global batch (rtol 2e-5).

int8 straight-through training (``int8_scales``, the dense tiny model of
``tests/test_torch_fsdp_tp.py``) on 1 × 2 × 2, 1 × 1 × 4 and 2 × 1 × 2
(and merged, ``tome_r`` 2, on 1 × 1 × 4) equals the port's one process;
the row products (``wo``, ``mlp_out``), split over the tensor ranks and
summed unscaled, equal one process's product bit for bit.

The ``PackedTrainer`` (a fake bucket, a third of it at 32 / 48 px): on
1 × 1 × 4 (one slot) it equals the one-process PackedTrainer; on 1 × 4 × 1
it equals 4 × 1 × 1; on 1 × 2 × 2 a save at step 2 resumed on 1 × 2 × 2
equals the uninterrupted run bit for bit, the cursor holds one entry a
slot, the tensor ranks of a slot load the same sequences (and a slot whose
tensor ranks load others is refused at the first step), and every rank's
eval equals one process's evaluate of the gathered tree.

The worker is this file run as a script (``python
tests/test_torch_packed_mesh.py <rank> <dir>``, the ranks meeting at a
file in ``<dir>``); it imports no JAX and reads the JAX init and the
batches from ``.npz`` files.
"""

import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from chestxray_vit_tpu_torch import config as tconfig  # noqa: E402
from chestxray_vit_tpu_torch.data.testing import build_fake_nih  # noqa: E402
from chestxray_vit_tpu_torch.models import bridge  # noqa: E402
from chestxray_vit_tpu_torch.models import int8_train  # noqa: E402
from chestxray_vit_tpu_torch.models import quantized  # noqa: E402
from chestxray_vit_tpu_torch.parallel import distributed as dist  # noqa: E402
from chestxray_vit_tpu_torch.parallel import fsdp  # noqa: E402
from chestxray_vit_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from chestxray_vit_tpu_torch.train import steps as tsteps  # noqa: E402
from chestxray_vit_tpu_torch.train.packed_trainer import (  # noqa: E402
    PackedTrainer)

WORLD = 4
WORKER_TIMEOUT_S = 300
# (dcn_data, data, fsdp, tensor)
MESHES = ((1, 1, 2, 2), (1, 2, 2, 1), (1, 2, 1, 2), (1, 1, 4, 1),
          (1, 1, 1, 4), (2, 1, 2, 1))
INT8_MESHES = ((1, 1, 2, 2), (1, 1, 1, 4), (1, 2, 1, 2))
GRIDS = (2, 3, 4)          # 32 / 48 / 64 px at patch 16
SEQ_LEN, GLOBAL_SEQS, STEPS, TOTAL_STEPS = 32, 8, 2, 100
KEYS = ("tokens", "segment_ids", "pos_indices", "pool_weights", "labels",
        "image_mask")
PACKED_MODEL = dict(img_size=64, patch_size=16, hidden_size=64,
                    num_layers=2, num_heads=4, mlp_dim=128, num_classes=5,
                    dtype="float32", attention_impl="pallas")
DENSE_MODEL = dict(img_size=32, patch_size=16, hidden_size=64, num_layers=2,
                   num_heads=4, mlp_dim=128, num_classes=5, dtype="float32")
DENSE_BATCH = 8
TOME = dict(tome_r=2)
DROPOUT = dict(attention_dropout=0.1, hidden_dropout=0.1)
# the PackedTrainer runs: the fake bucket, its sequences, 4 steps, a save
# at 2 (a constant learning rate)
TRAINER_SEQ_LEN, TRAINER_SEQS, TRAINER_STEPS, TRAINER_RESUME = 48, 8, 4, 2
TRAINER_MODEL = dict(PACKED_MODEL, num_classes=15)


def mesh_name(m) -> str:
    c, d, f, t = m
    return (f"dcn{c}x" if c > 1 else "") + f"{d}x{f}x{t}"


def mesh_config(m) -> tconfig.MeshConfig:
    c, d, f, t = m
    return tconfig.MeshConfig(dcn_data=c, data=d, fsdp=f, tensor=t)


def packed_config(accum: int = 1, **model) -> tconfig.Config:
    return tconfig.Config(
        model=tconfig.ModelConfig(**{**PACKED_MODEL, **model}),
        train=tconfig.TrainConfig(learning_rate=2e-3, warmup_steps=1,
                                  gradient_accumulation_steps=accum))


def dense_config(**model) -> tconfig.Config:
    return tconfig.Config(
        model=tconfig.ModelConfig(**{**DENSE_MODEL, **model}),
        train=tconfig.TrainConfig(learning_rate=1e-3))


def load_npz(path):
    """A ``.npz`` of '/'-joined keys → the nested dict."""
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *head, leaf = key.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[leaf] = z[key]
    return tree


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def as_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def run_packed(cfg, params, batch, mesh=None, steps=STEPS, **kw):
    """(losses, state) of ``steps`` packed steps from ``params``."""
    state = tsteps.TrainState.create(params, 0)
    step = tsteps.make_packed_train_step(cfg, TOTAL_STEPS, GRIDS, mesh=mesh,
                                         **kw)
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses, state


def run_dense(cfg, params, batch, mesh=None, steps=STEPS, **kw):
    state = tsteps.TrainState.create(params, 0)
    step = tsteps.make_train_step(cfg, 10, mesh=mesh, **kw)
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses, state


def varres_fake():
    """The fake bucket with a third of its images rewritten at 32 or 48 px
    (``tests/test_torch_packed_trainer.py``'s)."""
    fake = build_fake_nih(num_images=60, image_size=64, seed=21)
    rng = np.random.default_rng(0)
    for i, name in enumerate(fake.image_names):
        if i % 3 == 0:
            size = int(rng.choice([32, 48]))
            arr = rng.integers(0, 255, (size, size), np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr, "L").save(buf, format="PNG")
            fake.store.put(f"images_{(i % 12) + 1:03d}/images/{name}",
                           buf.getvalue())
    return fake


def trainer_config(out_dir, mesh=None, **train):
    kw = dict(learning_rate=1e-3, lr_schedule="constant",
              max_steps=TRAINER_STEPS, eval_strategy="no",
              save_strategy="steps", save_steps=TRAINER_RESUME,
              logging_steps=1, load_best_model_at_end=False,
              output_dir=str(out_dir), report_to="none", seed=0)
    kw.update(train)
    return tconfig.Config(data=tconfig.DataConfig(backend="memory"),
                          model=tconfig.ModelConfig(**TRAINER_MODEL),
                          train=tconfig.TrainConfig(**kw),
                          mesh=mesh or tconfig.MeshConfig())


def packed_trainer(cfg, fake):
    return PackedTrainer(cfg, seq_len=TRAINER_SEQ_LEN, grids=GRIDS,
                         batch_seqs=TRAINER_SEQS, census_sample=8,
                         store=fake.store, pretrained=False, device="cpu")


def logged(out_dir, rank=0, key="loss"):
    name = "metrics.jsonl" if rank == 0 else f"metrics.rank{rank}.jsonl"
    with open(os.path.join(out_dir, name)) as fh:
        recs = [json.loads(x) for x in fh]
    return [r[key] for r in recs if r["prefix"] == "train"]


def checksum(batch) -> list:
    return [float(torch.as_tensor(batch[k]).double().sum())
            for k in ("tokens", "segment_ids", "pool_weights", "labels")]


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

def worker(rank: int, out: str) -> None:
    torch.set_num_threads(1)
    dist.initialize(f"file://{os.path.join(out, 'rendezvous')}", WORLD, rank,
                    device="cpu")
    tree = load_npz(os.path.join(out, "init.npz"))
    dense_tree = load_npz(os.path.join(out, "dense_init.npz"))
    batches = {k: load_npz(os.path.join(out, f"{k}.npz"))
               for k in ("plain", "unequal")}
    dense = load_npz(os.path.join(out, "dense_batch.npz"))
    res = {}

    def save(name, state):
        full = bridge.gather_params(state.params)      # every rank
        if rank == 0:
            np.savez(os.path.join(out, f"{name}.npz"), **flatten(full))

    for m in MESHES:
        name = mesh_name(m)
        mesh = mesh_lib.build_mesh(mesh_config(m))
        per = GLOBAL_SEQS // mesh_lib.dp_size(mesh)
        rows = slice(mesh.dp_index * per, (mesh.dp_index + 1) * per)
        local = {k: as_torch({n: v[rows] for n, v in b.items()})
                 for k, b in batches.items()}
        r = res[name] = {"images": int(local["unequal"]["image_mask"].sum())}
        for kind, cfg, batch in (
                ("plain", packed_config(), local["plain"]),
                ("accum", packed_config(accum=2), local["unequal"]),
                ("tome", packed_config(**TOME), local["plain"]),
                ("dropout", packed_config(**DROPOUT), local["plain"])):
            r[kind], state = run_packed(
                cfg, bridge.shard_params(tree, cfg.model, mesh), batch,
                mesh=mesh)
            save(f"{kind}_{name}", state)

    # int8 straight-through on the tensor meshes (the dense model)
    pixels = torch.from_numpy(dense["pixel_values"])
    labels = torch.from_numpy(dense["labels"])
    cfg = dense_config()
    full = bridge.params_from_jax(dense_tree, cfg.model)
    scales = quantized.calibrate_vit_scales(
        full, tsteps._images(cfg, {"pixel_values": pixels,
                                   "labels": labels}), cfg.model)
    for m in INT8_MESHES:
        name = mesh_name(m)
        mesh = mesh_lib.build_mesh(mesh_config(m))
        per = DENSE_BATCH // mesh_lib.dp_size(mesh)
        rows = slice(mesh.dp_index * per, (mesh.dp_index + 1) * per)
        batch = {"pixel_values": pixels[rows], "labels": labels[rows]}
        kinds = [("int8", dense_config())]
        if m == (1, 1, 1, 4):
            kinds.append(("int8_tome", dense_config(**TOME)))
        for kind, cfg in kinds:
            res.setdefault(name, {})[kind], state = run_dense(
                cfg, bridge.shard_params(dense_tree, cfg.model, mesh),
                batch, mesh=mesh, int8_scales=scales)
            save(f"{kind}_{name}", state)
        res[name]["row_products"] = row_products(mesh)

    res["trainer"] = run_trainers(rank, out)
    dist.barrier("done")
    torch.distributed.destroy_process_group()
    with open(os.path.join(out, f"result{rank}.json"), "w") as fh:
        json.dump(res, fh)


def row_products(mesh) -> dict:
    """A row-split ``wo`` (K = 64) and ``mlp_out`` (K = 128) on the tensor
    axis against the whole product of one process: equal bits, f32 and bf16
    out, and the input's gradient equal to the whole one's slice."""
    tp = mesh.axis("tensor")
    gen = torch.Generator().manual_seed(7)
    out = {}
    for k, dt in ((64, torch.float32), (128, torch.float32),
                  (128, torch.bfloat16)):
        x = torch.randn(3, 17, k, generator=gen)
        w = torch.randn(k, 64, generator=gen) * 0.05
        b = torch.randn(64, generator=gen) * 0.1
        scale = float(x.abs().max()) / 127.0
        xw = x.clone().requires_grad_(True)
        whole = int8_train.int8_linear_ste(xw, w.to(dt), b.to(dt), scale, dt)
        whole.float().sum().backward()
        n = k // tp.size
        sl = slice(tp.index * n, (tp.index + 1) * n)
        xl = x[..., sl].clone().requires_grad_(True)
        part = int8_train.int8_row_linear_ste(xl, w[sl].to(dt), b.to(dt),
                                              scale, dt, tp)
        part.float().sum().backward()
        out[f"k{k}_{dt}"] = {
            "equal": bool(torch.equal(part, whole)),
            "max_abs": float((part.float() - whole.float()).abs().max()),
            "grad_equal": bool(torch.equal(xl.grad, xw.grad[..., sl]))}
    return out


def run_trainers(rank: int, out: str) -> dict:
    """The PackedTrainer on 1 x 1 x 4, 1 x 4 x 1, 4 x 1 x 1 and 1 x 2 x 2
    (uninterrupted, then resumed from its step-2 save); the 1 x 2 x 2
    run's first batch checksum, cursor and eval, and its gathered tree (on
    rank 0) for the one-process evaluate."""
    fake = varres_fake()
    res = {}
    for m in ((1, 1, 1, 4), (1, 1, 4, 1), (1, 4, 1, 1), (1, 1, 2, 2)):
        name = mesh_name(m)
        tr_dir = os.path.join(out, f"trainer_{name}")
        tr = packed_trainer(trainer_config(tr_dir, mesh_config(m)), fake)
        rec = res[name] = {"per_host_slots": tr._hosts}
        if m == (1, 1, 2, 2):
            gen = tr._train_batches(0)
            rec["first_batch"] = checksum(next(gen))
            gen.close()
        tr.train()
        rec["eval"] = tr.evaluate()
        tr.close()
        rec["losses"] = logged(tr_dir, rank)
        if m == (1, 1, 2, 2):
            meta = json.load(open(os.path.join(
                tr_dir, "checkpoints", str(TRAINER_RESUME), "meta.json")))
            rec["cursor"] = meta["cursor"]
            full = bridge.gather_params(tr.state.params)
            if rank == 0:
                np.savez(os.path.join(out, "trainer_1x2x2.npz"),
                         **flatten(full))
            want = fsdp.gather_params(tr.state.params)
            # resumed on the same mesh from the step-2 save
            res_dir = os.path.join(out, "trainer_resumed")
            if rank == 0:
                shutil.copytree(
                    os.path.join(tr_dir, "checkpoints", str(TRAINER_RESUME)),
                    os.path.join(res_dir, "checkpoints",
                                 str(TRAINER_RESUME)))
            dist.barrier("copied")
            again = packed_trainer(trainer_config(
                res_dir, mesh_config(m),
                resume_from_checkpoint=str(TRAINER_RESUME)), fake)
            again.train()
            again.close()
            rec["resumed_losses"] = logged(res_dir, rank)
            got = fsdp.gather_params(again.state.params)
            rec["resumed_params_equal"] = all(
                torch.equal(a, b) for a, b in zip(got.parameters(),
                                                  want.parameters()))
            rec["refused"] = refuses_other_sequences(tr)
    return res


def refuses_other_sequences(tr) -> bool:
    """A slot whose tensor ranks load other sequences fails at the first
    step's check, on every rank of the group."""
    t = tr.mesh.axis("tensor")
    batch = {k: torch.full((2, 3), float(t.index))
             for k in ("tokens", "segment_ids", "pool_weights", "labels")}
    probe = types.SimpleNamespace(mesh=tr.mesh, _slot_checked=False)
    try:
        PackedTrainer._check_slot_batch(probe, batch)
    except RuntimeError as e:
        return "loaded other sequences" in str(e)
    return False


if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2])
    raise SystemExit(0)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eight_seqs(seed):
    """8 packed sequences of ``SEQ_LEN`` tokens from the JAX package's
    packer whose two strided micro-batches, and whose slots on every mesh,
    hold unequal real-image counts (``tests/test_torch_packed.py``'s
    ``unequal_batch``)."""
    from chestxray_vit_tpu.data import packing as jpk
    rng = np.random.default_rng(seed)
    sizes = [int(rng.choice([32, 48, 64])) for _ in range(GLOBAL_SEQS * 2)]
    imgs = [rng.integers(0, 255, (s, s), np.uint8) for s in sizes]
    labs = [(rng.random(5) < 0.4).astype(np.float32) for _ in sizes]
    b = jpk.pack_images(imgs, labs, patch=16, seq_len=SEQ_LEN, grids=GRIDS)
    out = {}
    for k in KEYS:
        x = getattr(b, k)
        y = np.zeros((GLOBAL_SEQS,) + x.shape[1:], x.dtype)
        y[:min(GLOBAL_SEQS, x.shape[0])] = x[:GLOBAL_SEQS]
        out[k] = y
    out["segment_ids"][b.segment_ids.shape[0]:] = jpk.PAD_SEGMENT
    mask = out["image_mask"]
    if mask[0::2].sum() == mask[1::2].sum():
        s = next(i for i in range(0, GLOBAL_SEQS, 2) if mask[i].any())
        mask[s, int(np.nonzero(mask[s])[0][-1])] = False
    return out


def _jax_init(model: dict):
    import jax

    from chestxray_vit_tpu import config as jconfig
    from chestxray_vit_tpu.models import vit as jvit
    tree = jvit.init_params(jax.random.key(0), jconfig.ModelConfig(
        **{**model, "attention_impl": "xla"}))
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    out = tmp_path_factory.mktemp("packed_mesh")
    np.savez(out / "init.npz", **flatten(_jax_init(PACKED_MODEL)))
    np.savez(out / "dense_init.npz", **flatten(_jax_init(DENSE_MODEL)))
    np.savez(out / "plain.npz", **_eight_seqs(1))
    np.savez(out / "unequal.npz", **_eight_seqs(0))
    rng = np.random.default_rng(0)
    np.savez(out / "dense_batch.npz", pixel_values=rng.standard_normal(
        (DENSE_BATCH, 32, 32, 3)).astype(np.float32),
        labels=(rng.random((DENSE_BATCH, 5)) < 0.3).astype(np.float32))
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = REPO
    procs = []
    for rank in range(WORLD):
        log = open(out / f"log{rank}.txt", "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank), str(out)],
            env=env, cwd=REPO, stdout=log,
            stderr=subprocess.STDOUT), log))
    return out, procs


def _jax_cfg(cfg):
    from chestxray_vit_tpu import config as jconfig
    return jconfig.Config(**{
        f.name: getattr(jconfig, type(getattr(cfg, f.name)).__name__)(
            **dataclasses.asdict(getattr(cfg, f.name)))
        for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module")
def refs(workers, tmp_path_factory):
    """The one-process references, computed while the ranks run: the JAX
    package's one-device packed steps and the port's one-process runs."""
    import jax
    import jax.numpy as jnp

    from chestxray_vit_tpu.train import steps as jsteps

    out, _ = workers
    tree = load_npz(out / "init.npz")
    batches = {k: load_npz(out / f"{k}.npz") for k in ("plain", "unequal")}
    got = {}
    for kind, cfg, batch in (("plain", packed_config(), "plain"),
                             ("accum", packed_config(accum=2), "unequal"),
                             ("tome", packed_config(**TOME), "plain")):
        step = jax.jit(jsteps.make_packed_train_step(_jax_cfg(cfg),
                                                     TOTAL_STEPS, GRIDS))
        state = jsteps.TrainState.create(jax.tree.map(jnp.asarray, tree),
                                         seed=0)
        jb = {k: jnp.asarray(v) for k, v in batches[batch].items()}
        losses = []
        for _ in range(STEPS):
            state, m = step(state, jb)
            losses.append(float(m["loss"]))
        got[f"jax_{kind}"] = (losses, flatten(jax.tree.map(np.asarray,
                                                           state.params)))
    for kind, cfg in (("tome", packed_config(**TOME)),
                      ("dropout", packed_config(**DROPOUT))):
        losses, state = run_packed(cfg, bridge.params_from_jax(
            tree, cfg.model), as_torch(batches["plain"]), rank=0, world=1)
        got[f"port_{kind}"] = (losses, flatten(bridge.params_to_numpy(
            state.params)))

    dense_tree = load_npz(out / "dense_init.npz")
    data = load_npz(out / "dense_batch.npz")
    batch = {"pixel_values": torch.from_numpy(data["pixel_values"]),
             "labels": torch.from_numpy(data["labels"])}
    cfg = dense_config()
    scales = quantized.calibrate_vit_scales(
        bridge.params_from_jax(dense_tree, cfg.model),
        tsteps._images(cfg, batch), cfg.model)
    for kind, cfg in (("int8", dense_config()),
                      ("int8_tome", dense_config(**TOME))):
        losses, state = run_dense(cfg, bridge.params_from_jax(
            dense_tree, cfg.model), batch, rank=0, world=1,
            int8_scales=scales)
        got[f"port_{kind}"] = (losses, flatten(bridge.params_to_numpy(
            state.params)))

    # the one-process PackedTrainer on the same bucket
    tr_dir = tmp_path_factory.mktemp("one_process")
    tr = packed_trainer(trainer_config(tr_dir), varres_fake())
    tr.train()
    got["trainer_losses"] = logged(tr_dir)
    got["trainer_one"] = tr         # evaluates the gathered tree, then closes
    return got


@pytest.fixture(scope="module")
def results(workers, refs):
    """Every rank's results; a rank that fails stops the others."""
    out, procs = workers
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    try:
        while any(p.poll() is None for p, _ in procs):
            failed = any(p.poll() not in (None, 0) for p, _ in procs)
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    for rank, (p, _) in enumerate(procs):
        assert p.returncode == 0, (out / f"log{rank}.txt").read_text()[-4000:]
    return [json.loads((out / f"result{r}.json").read_text())
            for r in range(WORLD)]


def _assert_params(out, name, want, atol):
    got = flatten(load_npz(out / f"{name}.npz"))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=atol,
                                   err_msg=f"{name} {key}")


def _max_diff(out, name, want) -> float:
    got = flatten(load_npz(out / f"{name}.npz"))
    return max(float(np.abs(got[k] - want[k]).max()) for k in want)


@pytest.mark.parametrize("m", MESHES, ids=mesh_name)
def test_packed_step_equals_the_jax_one_device_step(m, workers, results,
                                                    refs):
    out, _ = workers
    want_losses, want_params = refs["jax_plain"]
    for r in results:
        np.testing.assert_allclose(r[mesh_name(m)]["plain"], want_losses,
                                   atol=1e-5)
    _assert_params(out, f"plain_{mesh_name(m)}", want_params, 2e-5)


@pytest.mark.parametrize("m", MESHES, ids=mesh_name)
def test_packed_accumulation_over_unequal_counts_equals_jax(m, workers,
                                                            results, refs):
    """accum 2 on the mesh against JAX's accum 2 on the global batch; the
    slots (where there are several) pack unequal real-image counts, so
    only Σnum / Σden over the batch group gives this loss."""
    out, _ = workers
    want_losses, want_params = refs["jax_accum"]
    for r in results:
        np.testing.assert_allclose(r[mesh_name(m)]["accum"], want_losses,
                                   atol=1e-5)
    _assert_params(out, f"accum_{mesh_name(m)}", want_params, 2e-5)
    slots = {r[mesh_name(m)]["images"] for r in results}
    c, d, f, _ = m
    assert len(slots) > 1 or c * d * f == 1


@pytest.mark.parametrize("m", MESHES, ids=mesh_name)
def test_merged_packed_step_equals_one_process_and_jax(m, workers, results,
                                                       refs):
    out, _ = workers
    for r in results:
        np.testing.assert_allclose(r[mesh_name(m)]["tome"],
                                   refs["port_tome"][0], atol=1e-5)
        np.testing.assert_allclose(r[mesh_name(m)]["tome"],
                                   refs["jax_tome"][0], atol=1e-5)
    _assert_params(out, f"tome_{mesh_name(m)}", refs["port_tome"][1], 2e-5)
    want = refs["jax_tome"][1]
    scale = max(float(np.abs(v).max()) for v in want.values())
    _assert_params(out, f"tome_{mesh_name(m)}", want, 1e-4 * scale)


@pytest.mark.parametrize("m", MESHES, ids=mesh_name)
def test_packed_dropout_equals_one_process(m, workers, results, refs):
    """Attention and hidden dropout 0.1: each slot keys its masks by its
    sequences' places in the global batch and each tensor rank by its
    heads' places in the model."""
    out, _ = workers
    want_losses, want_params = refs["port_dropout"]
    for r in results:
        np.testing.assert_allclose(r[mesh_name(m)]["dropout"], want_losses,
                                   rtol=2e-5)
    _assert_params(out, f"dropout_{mesh_name(m)}", want_params, 2e-5)
    # dropout was on: the weights moved elsewhere than without it
    plain = flatten(load_npz(out / f"plain_{mesh_name(m)}.npz"))
    assert _max_diff(out, f"dropout_{mesh_name(m)}", plain) > 1e-4


@pytest.mark.parametrize("kind,m", [("int8", m) for m in INT8_MESHES]
                         + [("int8_tome", (1, 1, 1, 4))],
                         ids=lambda v: v if isinstance(v, str)
                         else mesh_name(v))
def test_int8_straight_through_on_a_tensor_axis(kind, m, workers, results,
                                                refs, capsys):
    """int8 straight-through steps on a tensor axis (merged on 1 x 1 x 4)
    against the port's one process: loss rtol 5e-4 and parameters atol
    1e-4, the bounds ``tests/test_torch_fsdp_tp.py`` holds the fsdp meshes
    to; the readings are printed."""
    out, _ = workers
    want_losses, want_params = refs[f"port_{kind}"]
    for r in results:
        np.testing.assert_allclose(r[mesh_name(m)][kind], want_losses,
                                   rtol=5e-4)
    _assert_params(out, f"{kind}_{mesh_name(m)}", want_params, 1e-4)
    loss = max(abs(a - b) for r in results
               for a, b in zip(r[mesh_name(m)][kind], want_losses))
    params = _max_diff(out, f"{kind}_{mesh_name(m)}", want_params)
    with capsys.disabled():
        print(f"\n{kind} {mesh_name(m)}: loss diff {loss:.3e}, params "
              f"diff {params:.3e}")


@pytest.mark.parametrize("m", INT8_MESHES, ids=mesh_name)
def test_int8_row_products_equal_one_process_bit_for_bit(m, results):
    """The row products' unscaled partials summed over the tensor ranks
    equal the one-process int8 product's bits (K = 64 and 128, f32 and
    bf16 out), and the input's gradient is the whole one's slice."""
    for r in results:
        for case, rec in r[mesh_name(m)]["row_products"].items():
            assert rec["equal"] and rec["grad_equal"], (case, rec)


def test_packed_trainer_one_slot_equals_one_process(results, refs):
    """1 x 1 x 4: one batch slot over four tensor ranks trains as one
    process does."""
    for r in results:
        np.testing.assert_allclose(r["trainer"]["1x1x4"]["losses"],
                                   refs["trainer_losses"], rtol=2e-5)


def test_packed_trainer_fsdp_equals_data(results):
    """1 x 4 x 1 (four slots, ZeRO-3 shards) equals 4 x 1 x 1 (four slots,
    replicas): each slot packs its shard of the stream alike."""
    for r in results:
        np.testing.assert_allclose(r["trainer"]["1x4x1"]["losses"],
                                   r["trainer"]["4x1x1"]["losses"],
                                   rtol=2e-5)
        assert r["trainer"]["1x4x1"]["per_host_slots"] == 4


def test_packed_trainer_resumes_on_its_mesh(results):
    """1 x 2 x 2 saved at step 2 and resumed on 1 x 2 x 2: the resumed
    steps and the final tree equal the uninterrupted run's bit for bit."""
    for r in results:
        rec = r["trainer"]["1x2x2"]
        assert rec["resumed_losses"] == rec["losses"][TRAINER_RESUME:]
        assert rec["resumed_params_equal"]


def test_packed_trainer_cursor_has_a_slot_entry(results):
    """The cursor's per_host has one entry a batch slot (dp_size = 2 on
    1 x 2 x 2), not one a process."""
    cursors = [r["trainer"]["1x2x2"]["cursor"] for r in results]
    assert all(c == cursors[0] for c in cursors)
    assert len(cursors[0]["per_host"]) == 2
    assert sum(cursors[0]["per_host"]) == cursors[0]["batch_in_epoch"] > 0


def test_tensor_ranks_of_a_slot_load_the_same_sequences(results):
    """Ranks 0, 1 (slot 0) and 2, 3 (slot 1) of 1 x 2 x 2 load the same
    first batch within a slot and other ones across slots; a slot whose
    tensor ranks hold other sequences is refused on every rank."""
    first = [r["trainer"]["1x2x2"]["first_batch"] for r in results]
    assert first[0] == first[1] and first[2] == first[3]
    assert first[0] != first[2]
    assert all(r["trainer"]["1x2x2"]["refused"] for r in results)


def test_packed_trainer_eval_on_a_mesh(workers, results, refs):
    """Every rank's eval on 1 x 2 x 2 is the same, and equals one
    process's evaluate of the gathered tree."""
    out, _ = workers
    evals = [r["trainer"]["1x2x2"]["eval"] for r in results]
    assert all(e == evals[0] for e in evals)
    one = refs["trainer_one"]
    one.state = tsteps.TrainState.create(bridge.params_from_jax(
        load_npz(out / "trainer_1x2x2.npz"), one.cfg.model), 0)
    want = one.evaluate()
    one.close()
    assert evals[0]["eval_loss"] == pytest.approx(want["eval_loss"],
                                                  rel=1e-5)
    assert evals[0]["avg_auroc"] == pytest.approx(want["avg_auroc"],
                                                  abs=1e-6)
