"""Data parallelism of the port over ``torch.distributed``, on the CPU: two
gloo processes against one process and against the JAX package.

- The process layer's one-process defaults (the counterpart of
  ``tests/test_distributed.py``), an explicit group that cannot be joined,
  and the steps #12 once refused building on the fsdp and tensor axes
  (the packed step, int8 straight-through training on a tensor axis).
- The dense ``Trainer``: a two-rank run (each rank loading its slice of
  the global batch of 16) equals, on both ranks, the port's one-process
  run and the JAX package's one-process ``Trainer`` on the same weights
  and batches (losses, eval_loss, avg_auroc at the JAX multi-process
  test's rtol 2e-5, ``tests/test_multihost_trainer.py``); its static int8
  eval, calibrated on the gathered global batch, equals the one-process
  one.
- The ``PackedTrainer``: a two-rank run agrees across ranks, writes a
  cursor with per-rank image counts, evaluates alike on both ranks, and
  its losses equal the JAX in-process simulation that concatenates the two
  ranks' packed shards through the JAX packed step
  (``tests/test_packed_multihost.py``).
- One packed step whose ranks hold unequal real-image counts equals one
  step on the concatenated batch, which a mean of per-rank losses would
  not.
- Attention dropout, hidden dropout and mixup across processes: a dense
  two-rank Trainer run with both dropouts at 0.1, mixup 0.2 and
  accumulation 2 equals the port's one-process run on the global batch
  (losses and eval), and a two-rank PackedTrainer run with both dropouts
  equals the port's packed step on the concatenated shards. Without a
  group, two ranks emulated in one process (each with its rank, its row
  base and its mixup neighbour passed in) equal the global step, dense,
  merged, int8 straight-through and packed.

The worker is this file run as a script (``python
tests/test_torch_distributed.py <rank> <port> <dir>``); it imports no JAX
and reads the JAX package's init from ``.npz`` files the test writes.
"""

import copy
import json
import os
import socket
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
from chestxray_vit_tpu_torch.data import packing as pk  # noqa: E402
from chestxray_vit_tpu_torch.data.testing import build_fake_nih  # noqa: E402
from chestxray_vit_tpu_torch.models import bridge  # noqa: E402
from chestxray_vit_tpu_torch.models import packed as packed_model  # noqa: E402
from chestxray_vit_tpu_torch.models import quantized  # noqa: E402
from chestxray_vit_tpu_torch.parallel import distributed as dist  # noqa: E402
from chestxray_vit_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from chestxray_vit_tpu_torch.train import steps as tsteps  # noqa: E402
from chestxray_vit_tpu_torch.train.packed_trainer import (  # noqa: E402
    PackedTrainer)
from chestxray_vit_tpu_torch.train.trainer import Trainer  # noqa: E402

GRIDS = (2, 3, 4)
SEQ_LEN = 48
WORKER_TIMEOUT_S = 300
# the unequal-count step: sequences a rank, images on each rank
STEP_SEQS, STEP_IMAGES = 4, (12, 4)

DENSE_MODEL = dict(img_size=64, patch_size=16, hidden_size=64, num_layers=2,
                   num_heads=4, mlp_dim=128, dtype="float32",
                   attention_impl="xla")
PACKED_MODEL = dict(img_size=64, patch_size=16, hidden_size=32,
                    num_layers=1, num_heads=2, mlp_dim=64, dtype="float32",
                    attention_impl="xla")
# the random transforms across processes (ROADMAP Queue 1 #14)
DROPOUT = dict(attention_dropout=0.1, hidden_dropout=0.1)
MIXUP = 0.2
PACKED_KEYS = ("tokens", "segment_ids", "pos_indices", "pool_weights",
               "labels", "image_mask")


def dense_train(out_dir, batch_size_per_core, **kw):
    """``tests/test_multihost_trainer.py``'s run: a global batch of 16."""
    return dict(batch_size_per_core=batch_size_per_core, learning_rate=2e-3,
                max_steps=4, eval_strategy="no", save_strategy="steps",
                save_steps=10_000, load_best_model_at_end=False,
                logging_steps=1, output_dir=str(out_dir), report_to="none",
                seed=0, **kw)


def packed_train(out_dir):
    """``tests/_packed_multihost_worker.py``'s run, with an eval and a save
    at its last step and the best checkpoint restored."""
    return dict(learning_rate=2e-3, max_steps=3, eval_strategy="steps",
                eval_steps=3, save_strategy="steps", save_steps=3,
                logging_steps=1, load_best_model_at_end=True,
                output_dir=str(out_dir), report_to="none", seed=0)


def dense_fake():
    return build_fake_nih(num_images=80, image_size=64, seed=11)


def packed_fake():
    return build_fake_nih(num_images=96, image_size=64, seed=13)


def load_tree(path):
    """A ``.npz`` of '/'-joined keys → the nested parameter dict."""
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *head, leaf = key.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[leaf] = z[key]
    return tree


def with_params(tr, tree):
    """Give a trainer the bridged weights (its state from step 0)."""
    tr.state = tsteps.TrainState.create(
        bridge.params_from_jax(tree, tr.cfg.model), tr.cfg.train.seed)
    return tr


def logged(out_dir, name="metrics.jsonl", key="loss"):
    with open(os.path.join(out_dir, name)) as f:
        return [r[key] for r in map(json.loads, f) if r["prefix"] == "train"]


def packed_step_batch(rank):
    """Rank ``rank``'s half of the unequal-count packed batch: STEP_SEQS
    sequences holding STEP_IMAGES[rank] real 64 px images (3 a sequence
    at most), the rest empty."""
    rng = np.random.default_rng(100 + rank)
    n = STEP_IMAGES[rank]
    images = [rng.integers(0, 255, (64, 64), np.uint8) for _ in range(n)]
    labels = [(rng.random(15) < 0.3).astype(np.float32) for _ in range(n)]
    pb = pk.pack_images(images, labels, patch=16, seq_len=SEQ_LEN,
                        grids=GRIDS, max_imgs_per_seq=3)
    out = {k: getattr(pb, k) for k in ("tokens", "segment_ids",
                                        "pos_indices", "pool_weights",
                                        "labels", "image_mask")}
    short = STEP_SEQS - out["tokens"].shape[0]
    fill = {"segment_ids": pk.PAD_SEGMENT}
    return {k: np.concatenate([v, np.full((short,) + v.shape[1:],
                                          fill.get(k, 0), v.dtype)])
            for k, v in out.items()}


def dropout_config(out_dir, batch_size_per_core):
    """The dense run with attention and hidden dropout 0.1, mixup 0.2 and
    accumulation 2."""
    return tconfig.Config(
        data=tconfig.DataConfig(backend="memory", augment=True,
                                mixup_alpha=MIXUP),
        model=tconfig.ModelConfig(**DENSE_MODEL, **DROPOUT),
        train=tconfig.TrainConfig(**dense_train(
            out_dir, batch_size_per_core, gradient_accumulation_steps=2)))


def packed_step(state, batch, total_steps=3):
    cfg = tconfig.Config(model=state.params.cfg,
                         train=tconfig.TrainConfig(learning_rate=2e-3))
    step = tsteps.make_packed_train_step(cfg, total_steps, GRIDS)
    state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = {n: p.grad.clone() for n, p in state.params.named_parameters()}
    return state, {k: float(v) for k, v in m.items()}, grads


# ---------------------------------------------------------------------------
# the worker: one rank of a two-process gloo group
# ---------------------------------------------------------------------------

def worker(rank: int, port: int, out: str) -> None:
    torch.set_num_threads(1)
    device = dist.initialize(f"tcp://127.0.0.1:{port}", 2, rank,
                             device="cpu")
    assert device.type == "cpu" and dist.world() == 2
    res = {"rank": dist.rank(), "world": dist.world(),
           "is_primary": dist.is_primary(),
           "host_batch_slice": dist.host_batch_slice(16),
           "agree": [dist.agree_flag(rank == 1), dist.agree_flag(False)],
           "gathered": dist.process_allgather(
               np.full((2, 3), rank, np.float32)).tolist()}

    # the dense Trainer: 8 samples a rank, a global batch of 16
    dense_dir = os.path.join(out, "dense")
    cfg = tconfig.Config(
        data=tconfig.DataConfig(backend="memory", augment=True),
        model=tconfig.ModelConfig(**DENSE_MODEL),
        train=tconfig.TrainConfig(**dense_train(dense_dir, 8)))
    tr = with_params(Trainer(cfg, store=dense_fake().store,
                             pretrained=False, device="cpu"),
                     load_tree(os.path.join(out, "dense.npz")))
    assert tr.global_batch == 16 and tr.eval_batch == 16
    tr.train()
    res["dense_eval"] = tr.evaluate()
    tr.cfg.train.eval_quantize = "static"
    res["dense_eval_static"] = tr.evaluate()
    tr.close()
    res["dense_losses"] = logged(
        dense_dir, "metrics.jsonl" if rank == 0 else f"metrics.rank{rank}.jsonl")

    # the same with both dropouts, mixup and accumulation 2: 4 samples a
    # micro-batch and rank, a global batch of 16
    drop_dir = os.path.join(out, "dense_dropout")
    tr = with_params(Trainer(
        dropout_config(drop_dir, 4), store=dense_fake().store,
        pretrained=False, device="cpu"), load_tree(os.path.join(
            out, "dense.npz")))
    assert tr.global_batch == 16
    tr.train()
    res["dropout_eval"] = tr.evaluate()
    tr.close()
    res["dropout_losses"] = logged(
        drop_dir, "metrics.jsonl" if rank == 0 else f"metrics.rank{rank}.jsonl")

    # the PackedTrainer: host-sharded packing, 4 sequences a rank
    packed_dir = os.path.join(out, "packed")
    cfg = tconfig.Config(
        data=tconfig.DataConfig(backend="memory", num_workers=2),
        model=tconfig.ModelConfig(**PACKED_MODEL),
        train=tconfig.TrainConfig(**packed_train(packed_dir)))
    tr = with_params(PackedTrainer(
        cfg, seq_len=SEQ_LEN, grids=GRIDS, batch_seqs=8,
        store=packed_fake().store, pretrained=False, device="cpu",
        census_sample=8), load_tree(os.path.join(out, "packed.npz")))
    assert tr._hosts == 2 and tr._local_step_seqs == 4
    tr.train()
    res["packed_eval"] = tr.evaluate()
    res["packed_steps_per_epoch"] = tr.steps_per_epoch
    res["packed_best_step"] = tr.state.step
    tr.close()
    res["packed_losses"] = logged(
        packed_dir,
        "metrics.jsonl" if rank == 0 else f"metrics.rank{rank}.jsonl")
    with open(os.path.join(packed_dir, "checkpoints", "3", "meta.json")) as f:
        res["packed_cursor"] = json.load(f)["cursor"]
    res["packed_checkpoints"] = sorted(os.listdir(
        os.path.join(packed_dir, "checkpoints")))

    # the PackedTrainer with both dropouts, no eval or save
    drop_dir = os.path.join(out, "packed_dropout")
    cfg = tconfig.Config(
        data=tconfig.DataConfig(backend="memory", num_workers=2),
        model=tconfig.ModelConfig(**PACKED_MODEL, **DROPOUT),
        train=tconfig.TrainConfig(**{
            **packed_train(drop_dir), "eval_strategy": "no",
            "save_strategy": "no", "load_best_model_at_end": False}))
    tr = with_params(PackedTrainer(
        cfg, seq_len=SEQ_LEN, grids=GRIDS, batch_seqs=8,
        store=packed_fake().store, pretrained=False, device="cpu",
        census_sample=8), load_tree(os.path.join(out, "packed.npz")))
    tr.train()
    tr.close()
    np.savez(os.path.join(out, f"packed_dropout_grads{rank}.npz"),
             **{n: p.grad.numpy()
                for n, p in tr.state.params.named_parameters()})
    name = "metrics.jsonl" if rank == 0 else f"metrics.rank{rank}.jsonl"
    res["packed_dropout_losses"] = logged(drop_dir, name)
    res["packed_dropout_grad_norms"] = logged(drop_dir, name, "grad_norm")

    # one packed step, the ranks holding unequal real-image counts
    mcfg = tconfig.ModelConfig(**PACKED_MODEL, num_classes=15)
    state = tsteps.TrainState.create(bridge.params_from_jax(
        load_tree(os.path.join(out, "packed.npz")), mcfg), 0)
    _, metrics, grads = packed_step(state, packed_step_batch(rank))
    res["step_metrics"] = metrics
    np.savez(os.path.join(out, f"step_grads{rank}.npz"),
             **{n: g.numpy() for n, g in grads.items()})

    dist.barrier("done")
    torch.distributed.destroy_process_group()
    with open(os.path.join(out, f"result{rank}.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_init(model: dict):
    """The JAX package's init (as its Trainer draws it, seed 0), 15
    classes."""
    import jax

    from chestxray_vit_tpu import config as jconfig
    from chestxray_vit_tpu.models import vit as jvit
    tree = jvit.init_params(jax.random.key(0), jconfig.ModelConfig(
        **model, num_classes=15))
    return jax.tree.map(np.asarray, tree)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """Start the two ranks (the references are computed while they
    run)."""
    out = tmp_path_factory.mktemp("ddp")
    for name, model in (("dense", DENSE_MODEL), ("packed", PACKED_MODEL)):
        np.savez(out / f"{name}.npz", **_flatten(_jax_init(model)))
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = REPO
    procs = []
    for rank in (0, 1):
        log = open(out / f"log{rank}.txt", "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank), str(port),
             str(out)], env=env, cwd=REPO, stdout=log,
            stderr=subprocess.STDOUT), log))
    return out, procs


@pytest.fixture(scope="module")
def results(workers, refs):
    """Both ranks' results; a rank that fails stops the other."""
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
    return [json.loads((out / f"result{r}.json").read_text()) for r in (0, 1)]


@pytest.fixture(scope="module")
def refs(workers, tmp_path_factory):
    """The one-process runs: the port's and the JAX package's."""
    import jax
    import jax.numpy as jnp

    from chestxray_vit_tpu import config as jconfig
    from chestxray_vit_tpu.data import packing as jpk
    from chestxray_vit_tpu.data.pipeline import build_datasets
    from chestxray_vit_tpu.data.testing import build_fake_nih as jfake
    from chestxray_vit_tpu.models import vit as jvit
    from chestxray_vit_tpu.train import steps as jsteps
    from chestxray_vit_tpu.train.trainer import Trainer as JTrainer

    out, _ = workers
    refs = {}
    # the port's one process: a batch of 16
    d = tmp_path_factory.mktemp("one")
    tr = with_params(Trainer(tconfig.Config(
        data=tconfig.DataConfig(backend="memory", augment=True),
        model=tconfig.ModelConfig(**DENSE_MODEL),
        train=tconfig.TrainConfig(**dense_train(d, 16))),
        store=dense_fake().store, pretrained=False, device="cpu"),
        load_tree(out / "dense.npz"))
    tr.train()
    refs["port"] = {"losses": logged(d), "eval": tr.evaluate()}
    tr.cfg.train.eval_quantize = "static"
    refs["port"]["eval_static"] = tr.evaluate()
    tr.close()

    # the port's one process with both dropouts, mixup and accumulation 2
    d = tmp_path_factory.mktemp("one_dropout")
    tr = with_params(Trainer(dropout_config(d, 8), store=dense_fake().store,
                             pretrained=False, device="cpu"),
                     load_tree(out / "dense.npz"))
    assert tr.global_batch == 16
    tr.train()
    refs["port_dropout"] = {"losses": logged(d), "eval": tr.evaluate()}
    tr.close()

    # the JAX package's one process: 2 a device on its 8-device CPU mesh
    d = tmp_path_factory.mktemp("jax")
    jtr = JTrainer(jconfig.Config(
        data=jconfig.DataConfig(backend="memory", augment=True),
        model=jconfig.ModelConfig(**DENSE_MODEL),
        train=jconfig.TrainConfig(**dense_train(d, 2))),
        store=jfake(num_images=80, image_size=64, seed=11).store,
        pretrained=False)
    assert jtr.global_batch == 16
    jtr.train()
    refs["jax"] = {"losses": logged(d), "eval": jtr.evaluate()}
    jtr.close()

    # the JAX in-process simulation of the two-rank packed run: each
    # rank's shard packed (order[rank::2], 4 sequences a step), the
    # shards' batches concatenated, the JAX packed step
    fake = jfake(num_images=96, image_size=64, seed=13)
    bundle = build_datasets(jconfig.DataConfig(backend="memory"),
                            store=fake.store)
    cfg = jconfig.Config(model=jconfig.ModelConfig(
        **PACKED_MODEL, num_classes=len(bundle.classes)),
        train=jconfig.TrainConfig(learning_rate=2e-3, seed=0))
    spe = refs["packed_spe"] = _packed_census(bundle, fake.store)
    pairs, epoch = [], 0
    while len(pairs) < 3:
        streams = [[b for b in jpk.iterate_packed_batches(
            bundle.train, bundle.blob_map, fake.store, batch_seqs=4,
            patch=16, seq_len=SEQ_LEN, grids=GRIDS, epoch=epoch,
            shuffle=True, seed=42, num_workers=2, host_shard=(r, 2))
            if int(b["n_seqs"]) == 4] for r in (0, 1)]
        pairs.extend(list(zip(*streams))[:spe])
        epoch += 1
    state = jsteps.TrainState.create(
        jvit.init_params(jax.random.key(0), cfg.model), 0)
    step = jax.jit(jsteps.make_packed_train_step(cfg, 3, GRIDS))
    losses = []
    for b0, b1 in pairs[:3]:
        state, m = step(state, {
            k: jnp.asarray(np.concatenate([b0[k], b1[k]]))
            for k in ("tokens", "segment_ids", "pos_indices",
                      "pool_weights", "labels", "image_mask")})
        losses.append(float(m["loss"]))
    refs["jax_packed_losses"] = losses

    # the port's packed step with both dropouts on the same concatenated
    # shards, in one process: the global batch of the two-rank run
    pcfg = tconfig.Config(
        model=tconfig.ModelConfig(**PACKED_MODEL, **DROPOUT,
                                  num_classes=len(bundle.classes)),
        train=tconfig.TrainConfig(learning_rate=2e-3, seed=0))
    tstate = tsteps.TrainState.create(bridge.params_from_jax(
        load_tree(out / "packed.npz"), pcfg.model), 0)
    tstep = tsteps.make_packed_train_step(pcfg, 3, GRIDS)
    losses, norms = [], []
    for b0, b1 in pairs[:3]:
        tstate, m = tstep(tstate, {
            k: torch.from_numpy(np.concatenate([b0[k], b1[k]]))
            for k in PACKED_KEYS})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    refs["port_packed_dropout"] = {
        "losses": losses, "grad_norms": norms,
        "grads": {n: p.grad.numpy()
                  for n, p in tstate.params.named_parameters()}}
    return refs


def _packed_census(bundle, store):
    """steps_per_epoch as the two-rank PackedTrainer derives it."""
    counts = pk.sample_token_counts(bundle.train, bundle.blob_map, store,
                                    patch=16, grids=GRIDS, sample=8,
                                    num_workers=2)
    seqs = pk.estimate_sequences_per_epoch(
        counts, len(bundle.train) // 2, SEQ_LEN, SEQ_LEN // 4)
    return max(seqs // 4, 1)


# -- the process layer -------------------------------------------------------

def test_single_process_defaults(capsys, monkeypatch):
    for k in ("WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert dist.initialize(device="cpu") == torch.device("cpu")
    assert not dist.is_initialized()
    assert (dist.rank(), dist.world(), dist.is_primary()) == (0, 1, True)
    dist.barrier("test")                              # no-op
    assert list(dist.host_shard_range(32)) == list(range(32))
    assert dist.host_batch_slice(32) is None
    assert dist.agree_flag(True) and not dist.agree_flag(False)
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_array_equal(dist.process_allgather(x), x)
    np.testing.assert_array_equal(
        dist.process_allgather(torch.from_numpy(x)), x)
    # the gradient all-reduce is a no-op without a group
    lin = torch.nn.Linear(3, 2)
    lin(torch.ones(1, 3)).sum().backward()
    before = [p.grad.clone() for p in lin.parameters()]
    loss = torch.tensor(0.5)
    assert dist.all_reduce_grads(lin, loss, average=True) == (loss,)
    assert all(torch.equal(a, p.grad)
               for a, p in zip(before, lin.parameters()))
    # a world size without an address joins nothing, and says so
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert dist.initialize(device="cpu") == torch.device("cpu")
    assert not dist.is_initialized()
    assert "single-process mode" in capsys.readouterr().out


def test_explicit_group_that_cannot_be_joined_raises(monkeypatch):
    """An explicitly configured group fails loudly: no fallback to one
    process."""
    with pytest.raises(RuntimeError, match="rendezvous"):
        dist.initialize("nosuch://127.0.0.1:1", 2, 1, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "not-a-port")
    with pytest.raises(ValueError):
        dist.initialize(device="cpu")
    assert not dist.is_initialized()


@pytest.mark.parametrize("what,axis", [("packed", "fsdp"),
                                       ("packed", "tensor"),
                                       ("int8_scales", "tensor")])
def test_mesh_axes_beyond_data_build(what, axis):
    """The steps the fsdp and tensor axes once refused build there: the
    packed step, and int8 straight-through training on a tensor axis (its
    row products take their per-channel scales over the tensor ranks).
    ``tests/test_torch_packed_mesh.py`` runs them against one process."""
    mesh = mesh_lib.build_mesh(tconfig.MeshConfig(data=1, **{axis: 2}),
                               world=2)
    cfg = tconfig.Config(model=tconfig.ModelConfig(**DENSE_MODEL))
    if what == "packed":
        step = tsteps.make_packed_train_step(cfg, 10, GRIDS, mesh=mesh)
    else:
        step = tsteps.make_train_step(cfg, 10, int8_scales={}, mesh=mesh)
    assert callable(step)


def test_mesh_data_axis():
    """data -1 takes the ranks the other axes leave; a group smaller than
    its mesh raises the JAX ``build_mesh``'s ValueError, with the hint that
    a lone process starts one rank a device."""
    assert mesh_lib.build_mesh().data == 1
    mesh = mesh_lib.build_mesh(tconfig.MeshConfig(data=-1), world=4)
    assert mesh_lib.dp_size(mesh) == 4
    assert mesh_lib.local_batch_to_global(8, mesh) == 32
    assert mesh_lib.build_mesh(tconfig.MeshConfig(data=2), world=2).data == 2
    with pytest.raises(ValueError, match=r"mesh 2x1x1 != 1 devices: .*"
                                         r"one rank a device"):
        mesh_lib.build_mesh(tconfig.MeshConfig(data=2), world=1)


def test_group_collectives(results):
    for rank, r in enumerate(results):
        assert (r["rank"], r["world"], r["is_primary"]) == \
            (rank, 2, rank == 0)
        assert r["host_batch_slice"] == [8 * rank, 8 * rank + 8]
        assert r["agree"] == [True, False]
        assert r["gathered"] == [[0.0] * 3] * 2 + [[1.0] * 3] * 2


# -- the dense Trainer -------------------------------------------------------

def test_dense_two_ranks_agree(results):
    r0, r1 = results
    assert len(r0["dense_losses"]) == 4
    assert r0["dense_losses"] == r1["dense_losses"]
    assert r0["dense_eval"] == r1["dense_eval"]


@pytest.mark.parametrize("ref", ["port", "jax"])
def test_dense_two_ranks_match_one_process(ref, results, refs):
    want = refs[ref]
    for r in results:
        np.testing.assert_allclose(r["dense_losses"], want["losses"],
                                   rtol=2e-5, atol=1e-6)
        for k in ("eval_loss", "avg_auroc"):
            np.testing.assert_allclose(r["dense_eval"][k], want["eval"][k],
                                       rtol=2e-5, atol=1e-6, err_msg=k)


def test_dense_static_int8_eval_calibrates_on_the_global_batch(results,
                                                               refs):
    r0, r1 = results
    assert r0["dense_eval_static"] == r1["dense_eval_static"]
    want = refs["port"]["eval_static"]
    for k in ("eval_loss", "avg_auroc"):
        np.testing.assert_allclose(r0["dense_eval_static"][k], want[k],
                                   rtol=2e-5, atol=1e-6, err_msg=k)


# -- the PackedTrainer -------------------------------------------------------

def test_packed_two_ranks_agree(results):
    r0, r1 = results
    assert len(r0["packed_losses"]) == 3
    assert r0["packed_losses"] == r1["packed_losses"]
    assert r0["packed_eval"] == r1["packed_eval"]
    assert np.isfinite(r0["packed_eval"]["eval_loss"])
    # the primary wrote the one checkpoint, which both ranks restored
    assert r0["packed_checkpoints"] == ["3"]
    assert r0["packed_best_step"] == r1["packed_best_step"] == 3


def test_packed_cursor_carries_per_rank_image_counts(results):
    cur = results[0]["packed_cursor"]
    assert cur == results[1]["packed_cursor"]
    assert len(cur["per_host"]) == 2 and all(v > 0 for v in cur["per_host"])
    assert cur["batch_in_epoch"] == sum(cur["per_host"])


def test_packed_two_ranks_match_jax_simulation(results, refs):
    assert results[0]["packed_steps_per_epoch"] == refs["packed_spe"]
    np.testing.assert_allclose(results[0]["packed_losses"],
                               refs["jax_packed_losses"], rtol=2e-5,
                               atol=1e-6)


def test_packed_step_over_unequal_ranks_equals_the_concatenated_batch(
        results, workers):
    """Rank 0 holds 12 real images, rank 1 holds 4. The two-rank step sums
    Σnum and Σden over the ranks before dividing, so its loss, gradient
    norm and gradients equal one step on the concatenated batch; a mean of
    the ranks' own losses (what averaging per-rank gradients computes)
    is another function."""
    out, _ = workers
    halves = [packed_step_batch(r) for r in (0, 1)]
    assert [int(h["image_mask"].sum()) for h in halves] == list(STEP_IMAGES)
    mcfg = tconfig.ModelConfig(**PACKED_MODEL, num_classes=15)
    tree = load_tree(out / "packed.npz")

    def fresh():
        return tsteps.TrainState.create(
            bridge.params_from_jax(tree, mcfg), 0)

    whole = {k: np.concatenate([halves[0][k], halves[1][k]])
             for k in halves[0]}
    _, want, want_grads = packed_step(fresh(), whole)
    for rank, r in enumerate(results):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(r["step_metrics"][k], want[k],
                                       rtol=1e-5, err_msg=k)
        with np.load(out / f"step_grads{rank}.npz") as z:
            for n, g in want_grads.items():
                np.testing.assert_allclose(z[n], g.numpy(), rtol=1e-5,
                                           atol=1e-7, err_msg=n)

    # the per-rank mean: ½ Σ_r num_r / den_r and its gradient
    params = fresh().params
    parts = []
    for h in halves:
        t = {k: torch.from_numpy(v) for k, v in h.items()}
        logits = packed_model.apply_packed(
            params, t["tokens"], t["segment_ids"], t["pos_indices"],
            t["pool_weights"], mcfg, GRIDS, train=True)
        parts.append(packed_model.packed_bce_parts(logits, t["labels"],
                                                   t["image_mask"]))
    mean_of_ranks = sum(n / d for n, d in parts) / 2
    mean_of_ranks.backward()
    # both lie near ln 2 at the init: apart by more than 10x the tolerance
    # the equality above is held to
    assert abs(float(mean_of_ranks.detach()) - want["loss"]) > \
        10 * 1e-5 * want["loss"]
    rel = max(float((p.grad - want_grads[n]).abs().max()
                    / want_grads[n].abs().max().clamp_min(1e-12))
              for n, p in params.named_parameters()
              if want_grads[n].abs().max() > 0)
    assert rel > 1e-2


def test_refusal_messages_name_roadmap_items():
    """The port's refusals name the ROADMAP items that lift them: #15 (a
    tensor size that splits a head); #8 (across devices: one process
    driving several is done, several cards wait for hardware) and #12 (the
    mesh axes beyond data, done) keep their lines."""
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        roadmap = f.read()
    for item, title in (("8", "`parallel/` and serving across devices"),
                        ("12", "The rest"),
                        ("15", "Tensor sizes that split a head")):
        assert f"\n{item}. **{title}" in roadmap, item


# -- attention dropout, hidden dropout and mixup across processes ------------

def test_dropout_mixup_two_ranks_match_one_process(results, refs):
    """Both dropouts, mixup and accumulation 2 at a world of two: each
    rank keys its masks by its rows of the global batch, slices the
    global λ and mixes its first row with the previous rank's last, so the
    run equals the port's one process on the global batch."""
    r0, r1 = results
    assert len(r0["dropout_losses"]) == 4
    assert r0["dropout_losses"] == r1["dropout_losses"]
    assert r0["dropout_eval"] == r1["dropout_eval"]
    want = refs["port_dropout"]
    np.testing.assert_allclose(r0["dropout_losses"], want["losses"],
                               rtol=2e-5, atol=1e-6)
    for k in ("eval_loss", "avg_auroc"):
        np.testing.assert_allclose(r0["dropout_eval"][k], want["eval"][k],
                                   rtol=2e-5, atol=1e-6, err_msg=k)
    # the transforms were on: the run differs from the one without them
    assert abs(r0["dropout_losses"][-1] - r0["dense_losses"][-1]) > 1e-3


def test_packed_dropout_two_ranks_match_one_process(results, refs,
                                                   workers):
    """Both dropouts in the PackedTrainer at a world of two: each rank keys
    its masks by its sequences' places in the global batch, so the run
    equals the port's packed step on the two ranks' shards concatenated:
    losses, gradient norms and the last step's gradients."""
    r0, r1 = results
    assert len(r0["packed_dropout_losses"]) == 3
    assert r0["packed_dropout_losses"] == r1["packed_dropout_losses"]
    want = refs["port_packed_dropout"]
    np.testing.assert_allclose(r0["packed_dropout_losses"], want["losses"],
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(r0["packed_dropout_grad_norms"],
                               want["grad_norms"], rtol=2e-5, atol=1e-6)
    # this small model's loss and gradient norm at its init barely feel the
    # masks (the head's gradient dominates); the blocks' gradients do
    out, _ = workers
    for rank in (0, 1):
        with np.load(out / f"packed_dropout_grads{rank}.npz") as z:
            for n, g in want["grads"].items():
                np.testing.assert_allclose(z[n], g, rtol=2e-5, atol=1e-6,
                                           err_msg=n)


def test_accumulation_micro_batches_are_contiguous():
    """The strided split of accumulation hands every micro-batch over
    contiguous: the segment kernels read the ids in place, so a strided
    view would be refused on the card."""
    batch = {k: torch.from_numpy(v) for k, v in packed_step_batch(0).items()}
    micros = tsteps.micro_batches(batch, 2)
    assert len(micros) == 2
    for i, micro in enumerate(micros):
        for k, v in micro.items():
            assert v.is_contiguous(), k
            assert torch.equal(v, batch[k][i::2])
    assert tsteps.micro_batches(batch, 1) == [batch]


EMU_MODEL = dict(img_size=32, patch_size=8, hidden_size=64, num_layers=2,
                 num_heads=1, mlp_dim=128, num_classes=5, dtype="float32",
                 **DROPOUT)


def _emulated_cfg(kind):
    model = {"tome": dict(EMU_MODEL, tome_r=2),
             "packed": dict(PACKED_MODEL, num_classes=15, **DROPOUT)}.get(
                 kind, EMU_MODEL)
    return tconfig.Config(
        model=tconfig.ModelConfig(**model),
        data=tconfig.DataConfig(mixup_alpha=0.0 if kind == "packed"
                                else MIXUP),
        train=tconfig.TrainConfig(learning_rate=2e-3, warmup_steps=1,
                                  gradient_accumulation_steps=(
                                      1 if kind == "packed" else 2)))


@pytest.mark.parametrize("kind", ["dense", "tome", "int8", "packed"])
def test_emulated_ranks_equal_the_global_step(kind):
    """No process group: the step of a global batch at a world of one, and
    the same step as two ranks emulated in one process, each built with
    its rank and given its half and (mixup) the previous rank's last rows.
    The ranks' gradients combined as the all-reduce would (the dense mean;
    the packed sums over the global denominator) equal the global step's,
    and so does the loss."""
    cfg = _emulated_cfg(kind)
    init = packed_model.vit.init_params(torch.Generator().manual_seed(0),
                                        cfg.model)
    if kind == "packed":
        halves = [{k: torch.from_numpy(v) for k, v in
                   packed_step_batch(r).items()} for r in (0, 1)]
        whole = {k: torch.cat([halves[0][k], halves[1][k]])
                 for k in halves[0]}
    else:
        rng = np.random.default_rng(4)
        whole = {"pixel_values": torch.from_numpy(rng.standard_normal(
            (16, 32, 32, 3)).astype(np.float32)),
            "labels": torch.from_numpy((rng.random((16, 5)) < 0.3)
                                       .astype(np.float32))}
        halves = [{k: v[8 * r:8 * r + 8] for k, v in whole.items()}
                  for r in (0, 1)]

    def build(rank, world):
        if kind == "packed":
            return tsteps.make_packed_train_step(cfg, 10, GRIDS, rank=rank,
                                                 world=world)
        scales = None
        if kind == "int8":
            scales = quantized.calibrate_vit_scales(
                init, tsteps._images(cfg, whole), cfg.model)
        return tsteps.make_train_step(cfg, 10, int8_scales=scales,
                                      rank=rank, world=world)

    def run(rank, world, batch, **kw):
        params = copy.deepcopy(init)
        _, m = build(rank, world)(tsteps.TrainState.create(params, 3),
                                  batch, **kw)
        return float(m["loss"]), {n: p.grad.clone()
                                  for n, p in params.named_parameters()}

    want_loss, want = run(0, 1, whole)
    parts = []
    for r in (0, 1):
        kw = {}
        if kind != "packed":
            kw["neighbours"] = tsteps.mixup_neighbours(cfg, halves[1 - r])
        parts.append(run(r, 2, halves[r], **kw))
    if kind == "packed":
        dens = [float(h["image_mask"].sum()) for h in halves]
        w = [d / sum(dens) for d in dens]
    else:
        w = [0.5, 0.5]
    loss = sum(wi * lo for wi, (lo, _) in zip(w, parts))
    np.testing.assert_allclose(loss, want_loss, rtol=2e-5, atol=1e-6)
    for n, g in want.items():
        got = sum(wi * gr[n] for wi, (_, gr) in zip(w, parts))
        np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=2e-5,
                                   atol=1e-6, err_msg=n)
    if kind != "packed":
        # a rank emulated without its neighbours cannot ask a group
        with pytest.raises(ValueError, match="neighbours"):
            run(1, 2, halves[1])
    # rank 1 built as rank 0 keys its masks by the wrong rows
    other = run(0, 2, halves[1], **kw)
    assert other[0] != parts[1][0]
