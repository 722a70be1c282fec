"""The fsdp, tensor and dcn mesh axes of the port's training path, on the
CPU: four gloo processes against one process and against the JAX package.

One spawn of four ranks hosts every mesh in turn (data × fsdp × tensor
1 × 2 × 2, 2 × 2 × 1, 2 × 1 × 2, 1 × 4 × 1, 1 × 1 × 4, and dcn 2 × 1 × 2 ×
1). On each, from the JAX package's init of the tiny model (2 layers, 4
heads of 16, hidden 64, 32 px) cut to the rank's shards:

- two steps of ``make_train_step`` equal the JAX package's one-device
  step on the global batch (loss atol 1e-5, params atol 2e-5, as
  ``tests/test_train_steps.py`` holds its fsdp and tensor meshes);
- two merged steps (``tome_r`` 2, decreasing) equal the port's
  one-process steps (loss atol 1e-5, params atol 2e-5) and the JAX
  package's (loss atol 1e-5, params within 1e-4 of the largest, as
  ``tests/test_torch_tome_dense.py`` holds the one-process merged step:
  on this batch that step is already 3.6e-5 from the JAX one in one
  element after one step);
- two steps with attention dropout 0.1, hidden dropout 0.1 and mixup 0.2
  equal the port's one-process step on the global batch (rtol 2e-5);
- the eval step and the static int8 eval (the gathered tree quantized
  once, each batch slot its rows) equal one process (1e-4);
- on the meshes without a tensor axis, two int8 straight-through steps
  equal one process's.

On the 1 × 2 × 2 mesh every remat policy gives the step without remat,
``fused_qkv`` the one-process fused step,
and a ``Trainer`` run saved at step 2 is evaluated and resumed in one
process, which then matches the uninterrupted one-process run.

The worker is this file run as a script (``python
tests/test_torch_fsdp_tp.py <rank> <dir>``, the ranks meeting at a file in
``<dir>``); it imports no JAX and reads the JAX init and the batch from
``.npz`` files.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from chestxray_vit_tpu_torch import config as tconfig  # noqa: E402
from chestxray_vit_tpu_torch.data.testing import build_fake_nih  # noqa: E402
from chestxray_vit_tpu_torch.models import bridge  # noqa: E402
from chestxray_vit_tpu_torch.models import quantized  # noqa: E402
from chestxray_vit_tpu_torch.parallel import distributed as dist  # noqa: E402
from chestxray_vit_tpu_torch.parallel import fsdp  # noqa: E402
from chestxray_vit_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from chestxray_vit_tpu_torch.train import steps as tsteps  # noqa: E402
from chestxray_vit_tpu_torch.train.trainer import Trainer  # noqa: E402

WORLD = 4
WORKER_TIMEOUT_S = 240
# (dcn_data, data, fsdp, tensor)
MESHES = ((1, 1, 2, 2), (1, 2, 2, 1), (1, 2, 1, 2), (1, 1, 4, 1),
          (1, 1, 1, 4), (2, 1, 2, 1))
TINY = dict(img_size=32, patch_size=16, hidden_size=64, num_layers=2,
            num_heads=4, mlp_dim=128, num_classes=5, dtype="float32")
GLOBAL_BATCH, STEPS, TOTAL_STEPS = 8, 2, 10
TOME = dict(tome_r=2, tome_schedule="decreasing")
DROPOUT = dict(attention_dropout=0.1, hidden_dropout=0.1)
MIXUP = 0.2
POLICIES = ("full", "mlp", "attn", "attn_mlp", "flash_out", "dots")
# the Trainer run: a constant learning rate, so the run of 2 steps and
# the run of 4 share their first two
TRAINER_STEPS, TRAINER_RESUME = 4, 2


def mesh_name(m) -> str:
    c, d, f, t = m
    return (f"dcn{c}x" if c > 1 else "") + f"{d}x{f}x{t}"


def config(mixup: float = 0.0, **model) -> tconfig.Config:
    return tconfig.Config(
        data=tconfig.DataConfig(mixup_alpha=mixup),
        model=tconfig.ModelConfig(**{**TINY, **model}),
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


def trainer_config(out_dir, batch_size_per_core, mesh=None,
                   max_steps=TRAINER_STEPS):
    return tconfig.Config(
        data=tconfig.DataConfig(backend="memory", augment=False),
        model=tconfig.ModelConfig(**{**TINY, "num_classes": 15}),
        train=tconfig.TrainConfig(
            batch_size_per_core=batch_size_per_core, learning_rate=2e-3,
            lr_schedule="constant", max_steps=max_steps,
            eval_strategy="no", save_strategy="steps",
            save_steps=TRAINER_RESUME, load_best_model_at_end=False,
            logging_steps=1, output_dir=str(out_dir), report_to="none",
            seed=0),
        mesh=mesh or tconfig.MeshConfig())


def fake():
    return build_fake_nih(num_images=48, image_size=32, seed=5)


def run_steps(cfg, params, batch, steps=STEPS, mesh=None, **kw):
    """(losses, state) of ``steps`` train steps from ``params``."""
    state = tsteps.TrainState.create(params, 0)
    step = tsteps.make_train_step(cfg, TOTAL_STEPS, mesh=mesh, **kw)
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses, state


def int8_eval(cfg, params, images_global, batch, mesh=None):
    """The static int8 eval step on the full tree, calibrated on the
    global batch: this rank's logits."""
    full = fsdp.gather_params(params)
    scales = quantized.calibrate_vit_scales(full, images_global, cfg.model)
    qp = quantized.quantize_vit_params(full, scales)
    return tsteps.make_quantized_eval_step(cfg)(qp, batch)[0]


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

def worker(rank: int, out: str) -> None:
    torch.set_num_threads(1)
    dist.initialize(f"file://{os.path.join(out, 'rendezvous')}", WORLD, rank,
                    device="cpu")
    tree = load_npz(os.path.join(out, "init.npz"))
    data = load_npz(os.path.join(out, "batch.npz"))
    pixels = torch.from_numpy(data["pixel_values"])
    labels = torch.from_numpy(data["labels"])
    res = {}

    def params_of(cfg, mesh):
        return bridge.shard_params(tree, cfg.model, mesh)

    def save(name, state, moments=False):
        full = bridge.gather_params(state.params)      # every rank
        if moments:
            opt = bridge.gather_opt_state(state.opt_state, state.params)
        if rank == 0:
            np.savez(os.path.join(out, f"{name}.npz"), **flatten(full))
            if moments:
                np.savez(os.path.join(out, f"{name}_opt.npz"),
                         **flatten(opt))

    for m in MESHES:
        c, d, f, t = m
        name = mesh_name(m)
        mesh = mesh_lib.build_mesh(tconfig.MeshConfig(
            dcn_data=c, data=d, fsdp=f, tensor=t))
        slots = mesh_lib.dp_size(mesh)
        per = GLOBAL_BATCH // slots
        rows = slice(mesh.dp_index * per, (mesh.dp_index + 1) * per)
        batch = {"pixel_values": pixels[rows], "labels": labels[rows]}
        r = res[name] = {"dp_index": mesh.dp_index, "coords": mesh.coords,
                         "host_batch_slice": dist.host_batch_slice(
                             GLOBAL_BATCH, mesh)}

        cfg = config()
        params = params_of(cfg, mesh)
        r["shapes"] = {n: list(p.shape)
                       for n, p in params.named_parameters()}
        with torch.no_grad():
            logits = tsteps.make_eval_step(cfg)(params, batch)[0]
            r["eval_logits"] = dist.process_allgather(
                logits, mesh.axis("batch")).tolist()
            images = tsteps._images(cfg, data_global(pixels, labels))
            logits = int8_eval(cfg, params, images, batch)
            r["int8_logits"] = dist.process_allgather(
                logits, mesh.axis("batch")).tolist()
        r["dense"], state = run_steps(cfg, params, batch, mesh=mesh)
        save(f"dense_{name}", state, moments=True)
        # the moments carried onto the shards and back are the same bits
        opt = bridge.gather_opt_state(state.opt_state, state.params)
        again = bridge.gather_opt_state(
            bridge.shard_opt_state(opt, state.params), state.params)
        r["opt_round_trip"] = all(
            np.array_equal(a, b) for a, b in zip(
                flatten(opt).values(), flatten(again).values()))

        cfg = config(**TOME)
        r["tome"], state = run_steps(cfg, params_of(cfg, mesh), batch,
                                     mesh=mesh)
        save(f"tome_{name}", state)

        cfg = config(MIXUP, **DROPOUT)
        r["dropout"], state = run_steps(cfg, params_of(cfg, mesh), batch,
                                        mesh=mesh)
        save(f"dropout_{name}", state)

        if t == 1:
            cfg = config()
            scales = quantized.calibrate_vit_scales(
                bridge.params_from_jax(tree, cfg.model), images, cfg.model)
            r["int8_train"], state = run_steps(
                cfg, params_of(cfg, mesh), batch, mesh=mesh,
                int8_scales=scales)
            save(f"int8_train_{name}", state)

    # every remat policy on the 1 x 2 x 2 mesh, against no remat
    mesh = mesh_lib.build_mesh(tconfig.MeshConfig(data=1, fsdp=2, tensor=2))
    rows = slice(mesh.dp_index * 4, mesh.dp_index * 4 + 4)
    batch = {"pixel_values": pixels[rows], "labels": labels[rows]}
    res["remat"] = {}
    for policy in POLICIES:
        cfg = config(**DROPOUT, remat=True, remat_policy=policy)
        losses, state = run_steps(cfg, params_of(cfg, mesh), batch, steps=1,
                                  mesh=mesh)
        res["remat"][policy] = losses
        save(f"remat_{policy}", state)
    cfg = config(**DROPOUT)
    res["remat"]["none"], state = run_steps(cfg, params_of(cfg, mesh),
                                            batch, steps=1, mesh=mesh)
    save("remat_none", state)
    # the fused Q/K/V product stacks the local columns
    cfg = config(**DROPOUT, fused_qkv=True)
    res["remat"]["fused_qkv"], state = run_steps(
        cfg, params_of(cfg, mesh), batch, steps=1, mesh=mesh)
    save("remat_fused_qkv", state)

    # the Trainer on the 1 x 2 x 2 mesh: 2 steps, saved, evaluated
    tr_dir = os.path.join(out, "trainer")
    tr = Trainer(trainer_config(tr_dir, 4, tconfig.MeshConfig(
        data=1, fsdp=2, tensor=2), max_steps=TRAINER_RESUME),
        store=fake().store, pretrained=False, device="cpu")
    full = bridge.params_from_jax(load_npz(os.path.join(out, "init15.npz")),
                                  tr.cfg.model)
    tr.state = tsteps.TrainState.create(fsdp.shard_params(full, tr.mesh), 0)
    tr.train()
    res["trainer_eval"] = tr.evaluate()
    tr.cfg.train.eval_quantize = "static"
    res["trainer_eval_static"] = tr.evaluate()
    tr.close()
    name = "metrics.jsonl" if rank == 0 else f"metrics.rank{rank}.jsonl"
    with open(os.path.join(tr_dir, name)) as fh:
        res["trainer_losses"] = [json.loads(x)["loss"] for x in fh
                                 if json.loads(x)["prefix"] == "train"]

    dist.barrier("done")
    torch.distributed.destroy_process_group()
    with open(os.path.join(out, f"result{rank}.json"), "w") as fh:
        json.dump(res, fh)


def data_global(pixels, labels):
    return {"pixel_values": pixels, "labels": labels}


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


def _jax_init(num_classes: int):
    import jax

    from chestxray_vit_tpu import config as jconfig
    from chestxray_vit_tpu.models import vit as jvit
    tree = jvit.init_params(jax.random.key(0), jconfig.ModelConfig(
        **{**TINY, "num_classes": num_classes, "attention_impl": "xla"}))
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(0)
    np.savez(out / "init.npz", **flatten(_jax_init(5)))
    np.savez(out / "init15.npz", **flatten(_jax_init(15)))
    np.savez(out / "batch.npz", pixel_values=rng.standard_normal(
        (GLOBAL_BATCH, 32, 32, 3)).astype(np.float32),
        labels=(rng.random((GLOBAL_BATCH, 5)) < 0.3).astype(np.float32))
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


@pytest.fixture(scope="module")
def refs(workers):
    """The one-process references, computed while the ranks run: the JAX
    package's one-device steps and the port's one-process runs."""
    import jax
    import jax.numpy as jnp

    from chestxray_vit_tpu import config as jconfig
    from chestxray_vit_tpu.train import steps as jsteps

    out, _ = workers
    data = load_npz(out / "batch.npz")
    tree = load_npz(out / "init.npz")
    out_refs = {}
    for kind, model in (("dense", {}), ("tome", TOME)):
        jcfg = jconfig.Config(
            model=jconfig.ModelConfig(**{**TINY, **model,
                                         "attention_impl": "xla"}),
            train=jconfig.TrainConfig(learning_rate=1e-3))
        state = jsteps.TrainState.create(
            jax.tree.map(jnp.asarray, tree), seed=0)
        step = jax.jit(jsteps.make_train_step(jcfg, TOTAL_STEPS))
        batch = {k: jnp.asarray(v) for k, v in data.items()}
        losses = []
        for _ in range(STEPS):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        out_refs[kind] = (losses, flatten(jax.tree.map(np.asarray,
                                                       state.params)))
        if kind == "dense":
            out_refs["dense_opt"] = flatten(jax.tree.map(
                np.asarray, state.opt_state))

    pixels = torch.from_numpy(data["pixel_values"])
    labels = torch.from_numpy(data["labels"])
    batch = {"pixel_values": pixels, "labels": labels}
    for kind, cfg, n in (("dropout", config(MIXUP, **DROPOUT), STEPS),
                         ("tome_port", config(**TOME), STEPS),
                         ("fused_qkv", config(**DROPOUT, fused_qkv=True),
                          1)):
        losses, state = run_steps(cfg, bridge.params_from_jax(
            tree, cfg.model), batch, steps=n, world=1, rank=0)
        out_refs[kind] = (losses, flatten(bridge.params_to_numpy(
            state.params)))
    cfg = config()
    params = bridge.params_from_jax(tree, cfg.model)
    with torch.no_grad():
        out_refs["eval_logits"] = tsteps.make_eval_step(cfg)(
            params, batch)[0].numpy()
        images = tsteps._images(cfg, batch)
        out_refs["int8_logits"] = int8_eval(cfg, params, images,
                                            batch).numpy()
    scales = quantized.calibrate_vit_scales(params, images, cfg.model)
    losses, state = run_steps(cfg, bridge.params_from_jax(tree, cfg.model),
                              batch, world=1, rank=0, int8_scales=scales)
    out_refs["int8_train"] = (losses, flatten(bridge.params_to_numpy(
        state.params)))
    return out_refs


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
    got = load_npz(out / f"{name}.npz")
    got = flatten(got)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=atol,
                                   err_msg=f"{name} {key}")


@pytest.mark.parametrize("m", MESHES, ids=mesh_name)
def test_step_equals_the_jax_one_device_step(m, workers, results, refs):
    out, _ = workers
    want_losses, want_params = refs["dense"]
    for r in results:
        np.testing.assert_allclose(r[mesh_name(m)]["dense"], want_losses,
                                   atol=1e-5)
    _assert_params(out, f"dense_{mesh_name(m)}", want_params, 2e-5)


@pytest.mark.parametrize("m", MESHES, ids=mesh_name)
def test_sharded_moments_equal_the_jax_moments(m, workers, results, refs):
    """The AdamW moments after the two steps, gathered from the shards,
    equal the JAX package's within 1e-4 of the largest (as
    ``tests/test_torch_tome_dense.py`` holds them), and carrying them onto
    the shards and back changes no bit."""
    out, _ = workers
    got = flatten(load_npz(out / f"dense_{mesh_name(m)}_opt.npz"))
    want = refs["dense_opt"]
    assert set(got) == set(want)
    for moment in ("mu", "nu"):
        keys = [k for k in want if k.startswith(moment + "/")]
        scale = max(float(np.abs(want[k]).max()) for k in keys)
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], atol=1e-4 * scale,
                                       err_msg=k)
    assert all(r[mesh_name(m)]["opt_round_trip"] for r in results)


@pytest.mark.parametrize("m", MESHES, ids=mesh_name)
def test_merged_step_equals_the_jax_one_device_step(m, workers, results,
                                                    refs):
    out, _ = workers
    for kind in ("tome", "tome_port"):
        for r in results:
            np.testing.assert_allclose(r[mesh_name(m)]["tome"],
                                       refs[kind][0], atol=1e-5)
    _assert_params(out, f"tome_{mesh_name(m)}", refs["tome_port"][1], 2e-5)
    want = refs["tome"][1]
    scale = max(float(np.abs(v).max()) for v in want.values())
    _assert_params(out, f"tome_{mesh_name(m)}", want, 1e-4 * scale)


@pytest.mark.parametrize("m", MESHES, ids=mesh_name)
def test_dropout_and_mixup_equal_one_process(m, workers, results, refs):
    out, _ = workers
    want_losses, want_params = refs["dropout"]
    for r in results:
        np.testing.assert_allclose(r[mesh_name(m)]["dropout"], want_losses,
                                   rtol=2e-5)
    _assert_params(out, f"dropout_{mesh_name(m)}", want_params, 2e-5)


@pytest.mark.parametrize("m", MESHES, ids=mesh_name)
def test_eval_and_static_int8_eval_equal_one_process(m, results, refs):
    for r in results:
        np.testing.assert_allclose(r[mesh_name(m)]["eval_logits"],
                                   refs["eval_logits"], atol=1e-5)
        np.testing.assert_allclose(r[mesh_name(m)]["int8_logits"],
                                   refs["int8_logits"], atol=1e-4)


@pytest.mark.parametrize("m", [m for m in MESHES if m[3] == 1],
                         ids=mesh_name)
def test_int8_straight_through_on_fsdp_equals_one_process(m, workers,
                                                          results, refs):
    out, _ = workers
    want_losses, want_params = refs["int8_train"]
    for r in results:
        np.testing.assert_allclose(r[mesh_name(m)]["int8_train"],
                                   want_losses, rtol=5e-4)
    _assert_params(out, f"int8_train_{mesh_name(m)}", want_params, 1e-4)


@pytest.mark.parametrize("m", MESHES, ids=mesh_name)
def test_ranks_hold_their_slot_and_shards(m, results):
    """A rank's batch slot and coordinates follow reshape(dcn, data, fsdp,
    tensor); its shards have the layout's local shapes."""
    c, d, f, t = m
    per = GLOBAL_BATCH // (c * d * f)
    full = bridge.params_from_jax(_jax_init(5), config().model)
    for rank, r in enumerate(results):
        rec = r[mesh_name(m)]
        want = np.unravel_index(rank, (c, d, f, t))
        assert tuple(rec["coords"]) == tuple(int(i) for i in want)
        assert rec["dp_index"] == rank // t
        slot = rank // t
        assert rec["host_batch_slice"] == (
            None if c * d * f == 1 else [slot * per, slot * per + per])
        layout = mesh_lib.param_layout(mesh_lib.build_mesh(
            tconfig.MeshConfig(dcn_data=c, data=d, fsdp=f, tensor=t),
            world=WORLD, rank=rank), full)
        assert rec["shapes"] == {
            n: list(fsdp.local_slice(layout, n, p.detach()).shape)
            for n, p in full.named_parameters()}
    if t > 1:       # the Megatron split: columns of wq, rows of wo
        assert results[0][mesh_name(m)]["shapes"][
            "blocks.0.wq.kernel"][1] == 64 // t
        assert results[0][mesh_name(m)]["shapes"][
            "blocks.0.wo.kernel"][0] == 64 // t


@pytest.mark.parametrize("policy", POLICIES)
def test_every_remat_policy_on_a_mesh(policy, workers, results):
    """Each remat policy on the 1 x 2 x 2 mesh gives the step without
    remat: the recompute gathers again."""
    out, _ = workers
    for r in results:
        np.testing.assert_allclose(r["remat"][policy], r["remat"]["none"],
                                   rtol=1e-6)
    want = flatten(load_npz(out / "remat_none.npz"))
    _assert_params(out, f"remat_{policy}", want, 1e-6)


def test_fused_qkv_on_a_mesh_equals_one_process(workers, results, refs):
    """The fused Q/K/V product on the 1 x 2 x 2 mesh stacks each rank's
    columns: its step equals the one-process fused step."""
    out, _ = workers
    want_losses, want_params = refs["fused_qkv"]
    for r in results:
        np.testing.assert_allclose(r["remat"]["fused_qkv"], want_losses,
                                   rtol=2e-5)
    _assert_params(out, "remat_fused_qkv", want_params, 2e-5)


def test_trainer_on_a_mesh_resumes_in_one_process(workers, results,
                                                   tmp_path):
    """A 1 x 2 x 2 Trainer run saved at step 2: one process evaluates the
    saved tree as the mesh did, and resumed from it matches the
    uninterrupted one-process run."""
    out, _ = workers
    init = load_npz(out / "init15.npz")

    def one_process(out_dir):
        tr = Trainer(trainer_config(out_dir, 8), store=fake().store,
                     pretrained=False, device="cpu")
        tr.state = tsteps.TrainState.create(
            bridge.params_from_jax(init, tr.cfg.model), 0)
        return tr

    whole = one_process(tmp_path / "whole")
    whole.train()
    whole.close()
    with open(tmp_path / "whole" / "metrics.jsonl") as fh:
        want = [json.loads(x)["loss"] for x in fh
                if json.loads(x)["prefix"] == "train"]
    for r in results:
        np.testing.assert_allclose(r["trainer_losses"],
                                   want[:TRAINER_RESUME], rtol=2e-5)

    resumed_dir = tmp_path / "resumed"
    shutil.copytree(out / "trainer", resumed_dir)
    (resumed_dir / "metrics.jsonl").unlink()
    tr = one_process(resumed_dir)
    tr.state, _, _ = tr.ckpt.restore(TRAINER_RESUME, tr.state)
    ev = tr.evaluate()
    tr.cfg.train.eval_quantize = "static"
    ev_static = tr.evaluate()
    tr.cfg.train.eval_quantize = None
    for r in results:
        assert r["trainer_eval"]["eval_loss"] == pytest.approx(
            ev["eval_loss"], rel=1e-5)
        assert r["trainer_eval"]["avg_auroc"] == pytest.approx(
            ev["avg_auroc"], abs=1e-6)
        assert r["trainer_eval_static"]["eval_loss"] == pytest.approx(
            ev_static["eval_loss"], rel=1e-4)
    tr.cfg.train.resume_from_checkpoint = str(TRAINER_RESUME)
    tr.train()
    tr.close()
    with open(resumed_dir / "metrics.jsonl") as fh:
        got = [json.loads(x)["loss"] for x in fh
               if json.loads(x)["prefix"] == "train"]
    np.testing.assert_allclose(got, want[TRAINER_RESUME:], rtol=2e-5)
