"""One process driving several devices (``parallel/launch.py``): a lone
``Trainer`` or ``PackedTrainer`` given several devices starts one rank a
device, as the JAX package's one process trains over every device.

- The mesh rule: ``mesh.mesh_shape`` over n devices equals the JAX
  ``build_mesh`` over ``jax.devices()[:n]`` (the conftest's virtual CPU
  devices), shapes and refusals alike.
- The JAX golden run literally: ``Trainer(device=["cpu"] * 8)`` on the
  goldens' own mesh (8 × 1 × 1, batch 2 a device) from the JAX init,
  against ``golden_run.json``; its output directory lists the files of
  one process's.
- The PackedTrainer on 1 × 2 × 2 (``data = -1`` over four CPU devices)
  against one process on the same global sequences, and a stop request
  mid-epoch resumed bit for bit.
- Failures: a rank's error is raised here and leaves no process; a
  sequence of devices in a group, an argument that cannot be pickled and
  cards without a card are refused; SIGTERM reaches the ranks' handlers.

One torch thread a rank, tiny models.
"""

import concurrent.futures
import io
import json
import multiprocessing as mp
import os
import signal
import threading
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as td
from PIL import Image

from chestxray_vit_tpu import config as jconfig
from chestxray_vit_tpu.parallel import mesh as jmesh
from chestxray_vit_tpu_torch import cli
from chestxray_vit_tpu_torch import config as tconfig
from chestxray_vit_tpu_torch.data.testing import build_fake_nih
from chestxray_vit_tpu_torch.models import vit as tvit
from chestxray_vit_tpu_torch.parallel import distributed as dist
from chestxray_vit_tpu_torch.parallel import launch
from chestxray_vit_tpu_torch.parallel import mesh as tmesh
from chestxray_vit_tpu_torch.train import steps as tsteps
from chestxray_vit_tpu_torch.train.packed_trainer import PackedTrainer
from chestxray_vit_tpu_torch.train.trainer import SpawnedTrainer, Trainer
from _launch_hooks import exit_on_rank_1, hold_until_stop, raise_on_rank_1
from test_torch_packed_mesh import (TRAINER_SEQ_LEN, TRAINER_SEQS, GRIDS,
                                    trainer_config)
from test_torch_trainer import GOLDEN, _cfg, _jax_params

# test_golden_trajectory's bounds; test_torch_packed_mesh.py's for the
# PackedTrainer against one process (losses) and for parameters
LOSS_RTOL, AUROC_ATOL, EVAL_LOSS_RTOL = 5e-4, 5e-3, 5e-4
PACKED_LOSS_RTOL, PACKED_PARAM_ATOL = 2e-5, 2e-5
# the bucket of test_torch_packed_mesh.py's PackedTrainer, grown so that an
# epoch over two slots is longer than the run (a stop lands mid-epoch)
PACKED_IMAGES, PACKED_STEPS, PACKED_STOP = 200, 4, 2
FAIL_WITHIN_S = 60


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The caller's one thread: each CPU rank takes max(1, threads // n)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_rank_left(pids) -> bool:
    for pid in pids:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            continue
        return False
    return not mp.active_children()


def _files(root) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


# ---------------------------------------------------------------------------
# the mesh rule
# ---------------------------------------------------------------------------

MESH_CASES = [dict(data=-1), dict(data=-1, fsdp=2), dict(data=-1, tensor=2),
              dict(data=-1, dcn_data=2), dict(data=-1, fsdp=2, tensor=2),
              dict(data=-1, dcn_data=2, fsdp=2),
              dict(data=-1, dcn_data=2, fsdp=2, tensor=2),
              dict(data=1), dict(data=2), dict(data=4), dict(data=2, fsdp=2),
              dict(data=1, fsdp=2, tensor=2), dict(data=2, fsdp=2, tensor=2),
              dict(data=1, fsdp=4), dict(data=3)]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("axes", MESH_CASES,
                         ids=lambda a: "-".join(f"{k}{v}"
                                                for k, v in a.items()))
def test_mesh_rule_is_the_jax_build_mesh(axes, n):
    """The shape, or the ValueError's message, of the JAX ``build_mesh``
    over ``jax.devices()[:n]``, for the devices a lone Trainer is given
    (``device=["cpu"] * n``)."""
    try:
        m = jmesh.build_mesh(jconfig.MeshConfig(**axes),
                             devices=jax.devices()[:n])
        want = (m.shape.get("dcn", 1), m.shape["data"], m.shape["fsdp"],
                m.shape["tensor"])
    except ValueError as e:
        want = str(e)
    devices = launch.train_devices(["cpu"] * n)
    try:
        got = tmesh.mesh_shape(tconfig.MeshConfig(**axes), devices)
    except ValueError as e:
        got = str(e)
    assert got == want


def test_device_arguments(monkeypatch):
    """'cuda' is every visible card (as ``jax.devices()``), 'cuda:k' that
    card, a list those devices; the CLI's comma-separated list is a list.
    Cards asked for without one raise: nothing runs on the CPU instead."""
    assert launch.train_devices("cpu") == [torch.device("cpu")]
    assert launch.train_devices(["cpu"] * 3) == [torch.device("cpu")] * 3
    assert cli._pop_device(["--device", "cuda:0,cuda:0"]) == \
        (["cuda:0", "cuda:0"], [])
    for device in ("cuda", "cuda:0", ["cuda:0", "cuda:0"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.train_devices(device)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    cards = launch.train_devices("cuda")
    assert cards == [torch.device("cuda", i) for i in range(8)]
    assert tmesh.mesh_shape(tconfig.MeshConfig(fsdp=2), cards) == (1, 4, 2, 1)
    assert launch.train_devices("cuda:3") == [torch.device("cuda", 3)]
    with pytest.raises(ValueError, match="no card"):
        launch.train_devices(["cuda:0", "cuda:8"])
    with pytest.raises(ValueError, match="several types"):
        launch.train_devices(["cuda:0", "cpu"])


@pytest.mark.parametrize("placement,want", [
    (["cpu"] * 4, "gloo"), (["cuda:0", "cuda:0"], "gloo"),
    (["cuda:0", "cuda:1", "cuda:0"], "gloo"),
    (["cuda:0", "cuda:1", "cuda:2", "cuda:3"], "nccl"),
    (["cuda:1"], "nccl")])
def test_backend_by_placement(placement, want):
    """NCCL where every rank has a card of its own, gloo where ranks share
    one or run on the CPU (the rule only: one card here at most)."""
    assert dist.backend_for(placement) == want


# ---------------------------------------------------------------------------
# the JAX golden run, literally
# ---------------------------------------------------------------------------

def _golden_run(out, device, batch_size_per_core, fake):
    cfg = _cfg(out, batch_size_per_core=batch_size_per_core)
    tr = Trainer(cfg, store=fake.store, pretrained=False, device=device)
    tr.state = tsteps.TrainState.create(_jax_params(cfg.model),
                                        cfg.train.seed)
    tr.train()
    ev = tr.evaluate()
    tr.save_metrics("eval", ev, log=True)
    tr.save_model()
    tr.save_state()
    return tr, ev


def test_lone_trainer_on_eight_devices_is_the_jax_golden_run(tmp_path):
    """8 CPU ranks at batch 2 a device on the goldens' mesh 8 x 1 x 1,
    from the JAX init: every one of the 20 losses within rtol 5e-4,
    avg_auroc within 5e-3, eval_loss within rtol 5e-4 of
    ``golden_run.json``; the full state comes back to the caller; the
    output directory lists one process's files, no metrics.rank*.jsonl."""
    fake = build_fake_nih(num_images=120, image_size=64, seed=17)
    tr, ev = _golden_run(tmp_path / "spawned", ["cpu"] * 8, 2, fake)
    try:
        assert isinstance(tr, SpawnedTrainer)
        assert (tr.mesh.dcn, tr.mesh.data, tr.mesh.fsdp, tr.mesh.tensor) \
            == (1, 8, 1, 1)
        assert tr.global_batch == 16 and tr.total_steps == 20
        state = tr.state
        assert state.step == 20 and state.params.layout is None
    finally:
        tr.close()
    with open(tmp_path / "spawned" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss"] for r in recs if r["prefix"] == "train"]
    assert len(losses) == 20
    np.testing.assert_allclose(losses, GOLDEN["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(ev["avg_auroc"], GOLDEN["avg_auroc"],
                               atol=AUROC_ATOL)
    np.testing.assert_allclose(ev["eval_loss"], GOLDEN["eval_loss"],
                               rtol=EVAL_LOSS_RTOL)
    one, _ = _golden_run(tmp_path / "one", "cpu", 16, fake)
    one.close()
    assert _files(tmp_path / "spawned") == _files(tmp_path / "one")
    assert not any("rank" in f for f in _files(tmp_path / "spawned"))


# ---------------------------------------------------------------------------
# the PackedTrainer on 1 x 2 x 2
# ---------------------------------------------------------------------------

_VARRES = {}


def _varres_store():
    """``test_torch_packed_mesh.varres_fake``'s bucket at PACKED_IMAGES
    images: 64 px, a third rewritten at 32 or 48 px."""
    if not _VARRES:
        fake = build_fake_nih(num_images=PACKED_IMAGES, image_size=64,
                              seed=21)
        rng = np.random.default_rng(0)
        for i, name in enumerate(fake.image_names):
            if i % 3 == 0:
                size = int(rng.choice([32, 48]))
                buf = io.BytesIO()
                Image.fromarray(rng.integers(0, 255, (size, size), np.uint8),
                                "L").save(buf, format="PNG")
                fake.store.put(f"images_{(i % 12) + 1:03d}/images/{name}",
                               buf.getvalue())
        _VARRES["store"] = fake.store
    return _VARRES["store"]


def _packed(out, device, **train):
    cfg = trainer_config(out, tconfig.MeshConfig(data=-1, fsdp=2, tensor=2)
                         if isinstance(device, list) else None,
                         max_steps=PACKED_STEPS, save_steps=10_000, **train)
    return PackedTrainer(cfg, seq_len=TRAINER_SEQ_LEN, grids=GRIDS,
                         batch_seqs=TRAINER_SEQS, census_sample=8,
                         store=_varres_store(), pretrained=False,
                         device=device)


def _losses(out) -> list:
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [r["loss"] for r in map(json.loads, f)
                if r["prefix"] == "train"]


def _one_process_on_the_slots(cfg_dir, slots: int, steps: int):
    """One process's packed steps on the global batches of ``slots`` batch
    slots: each step the slots' sequences (``host_shard``) concatenated in
    slot order, from the seed-0 init the ranks draw."""
    one = _packed(cfg_dir, "cpu")
    per = one.batch_seqs // slots
    shards = [one._packed_iter(one.bundle.train, 0, batch_seqs=per,
                               host_shard=(s, slots)) for s in range(slots)]
    step = tsteps.make_packed_train_step(one.cfg, one.total_steps, GRIDS)
    state = tsteps.TrainState.create(tvit.init_params(
        torch.Generator().manual_seed(one.cfg.train.seed), one.cfg.model),
        one.cfg.train.seed)
    losses = []
    while len(losses) < steps:
        parts = [next(s) for s in shards]
        if any(int(p["n_seqs"]) < per for p in parts):
            continue
        batch = {k: torch.from_numpy(np.concatenate([p[k] for p in parts]))
                 for k in parts[0] if k not in ("n_seqs", "n_images")}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    one.close()
    return losses, state


def test_lone_packed_trainer_on_a_mesh_and_its_resume(tmp_path):
    """1 x 2 x 2 (data -1 over four CPU devices: two batch slots of two
    tensor ranks) against one process on the slots' global sequences:
    losses rtol 2e-5, parameters atol 2e-5. A stop request at step 2 of 4
    (mid-epoch: the cursor holds one image count a slot), then a fresh
    trainer resumed "auto" in the same directory: the losses and the
    final tree equal the uninterrupted run's bit for bit."""
    run = _packed(tmp_path / "run", ["cpu"] * 4)
    try:
        assert (run.mesh.data, run.mesh.fsdp, run.mesh.tensor) == (1, 2, 2)
        assert run.steps_per_epoch > PACKED_STEPS
        run.train()
        want = run.state
    finally:
        run.close()
    losses = _losses(tmp_path / "run")
    ref_losses, ref = _one_process_on_the_slots(tmp_path / "one", 2,
                                                PACKED_STEPS)
    np.testing.assert_allclose(losses, ref_losses, rtol=PACKED_LOSS_RTOL)
    ref_params = dict(ref.params.named_parameters())
    for n, p in want.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   ref_params[n].detach().numpy(),
                                   atol=PACKED_PARAM_ATOL, err_msg=n)

    stopped = _packed(tmp_path / "stop", ["cpu"] * 4)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        try:
            stopped.call(hold_until_stop, PACKED_STOP)
            result = pool.submit(stopped.train)
            deadline = time.monotonic() + 60
            while (not os.path.exists(tmp_path / "stop" / "metrics.jsonl")
                   or not _losses(tmp_path / "stop")):
                assert time.monotonic() < deadline and not result.done()
                time.sleep(0.05)
            stopped.request_stop()
            assert result.result(timeout=120)["train_steps"] == PACKED_STOP
        finally:
            stopped.close()
    meta = json.loads((tmp_path / "stop" / "checkpoints" / str(PACKED_STOP)
                       / "meta.json").read_text())
    assert len(meta["cursor"]["per_host"]) == 2
    assert meta["cursor"]["epoch"] == 0 and \
        sum(meta["cursor"]["per_host"]) == meta["cursor"]["batch_in_epoch"] > 0
    resumed = _packed(tmp_path / "stop", ["cpu"] * 4,
                      resume_from_checkpoint="auto")
    try:
        resumed.train()
        got = resumed.state
    finally:
        resumed.close()
    assert _losses(tmp_path / "stop") == losses
    want_params = dict(want.params.named_parameters())
    for n, p in got.params.named_parameters():
        assert torch.equal(p, want_params[n]), n


# ---------------------------------------------------------------------------
# failures and refusals
# ---------------------------------------------------------------------------

def test_a_failing_rank_raises_here_and_leaves_no_process(tmp_path):
    """A cfg that only the ranks check (``eval_quantize='int4'``) raises its
    ValueError here, within 60 s; a rank that raises while the other waits
    in a collective raises its KeyError with the rank's traceback, and
    every rank is stopped."""
    fake = build_fake_nih(num_images=40, image_size=64, seed=17)
    cfg = _cfg(tmp_path, model={"num_layers": 1}, batch_size_per_core=2)
    cfg.train.eval_quantize = "int4"
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="int4") as err:
        Trainer(cfg, store=fake.store, pretrained=False,
                device=["cpu"] * 2)
    assert time.monotonic() - t0 < FAIL_WITHIN_S
    assert any("rank" in note for note in err.value.__notes__)
    assert _no_rank_left([])

    ranks = launch.Ranks(["cpu"] * 2)
    pids = ranks.pids
    t0 = time.monotonic()
    with pytest.raises(KeyError, match="rank 1 alone") as err:
        ranks.call(raise_on_rank_1)
    assert time.monotonic() - t0 < FAIL_WITHIN_S
    assert any("raised in rank 1 of 2" in note
               for note in err.value.__notes__)
    assert not ranks.alive and _no_rank_left(pids)
    with pytest.raises(RuntimeError, match="stopped"):
        ranks.call(raise_on_rank_1)


def test_a_rank_that_dies_raises_here():
    """A rank that exits without an answer (a crash) raises a RuntimeError
    naming it and its exit code; the other rank, waiting in a collective,
    is stopped."""
    ranks = launch.Ranks(["cpu"] * 2)
    pids = ranks.pids
    with pytest.raises(RuntimeError, match="rank 1 of 2 .*exit.* code 3"):
        ranks.call(exit_on_rank_1)
    assert not ranks.alive and _no_rank_left(pids)


def test_refusals(tmp_path):
    """An argument that cannot be pickled is refused here, by name, before
    any rank starts; a sequence of devices in a process group is refused
    (one rank drives one device)."""
    cfg = _cfg(tmp_path, model={"num_layers": 1})
    with pytest.raises(TypeError, match="store .*cannot be pickled"):
        Trainer(cfg, store=threading.Lock(), pretrained=False,
                device=["cpu"] * 2)
    assert _no_rank_left([])
    td.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                          world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="one rank drives one device"):
            Trainer(cfg, store=None, pretrained=False, device=["cpu"] * 2)
    finally:
        td.destroy_process_group()


def test_sigterm_reaches_the_ranks_and_checkpoints(tmp_path):
    """SIGTERM sent to the caller while ``train`` runs is forwarded: the
    ranks' handlers agree the stop, checkpoint at the step the request
    lands on, and ``train`` returns after it, as one process does."""
    fake = build_fake_nih(num_images=40, image_size=64, seed=17)
    cfg = _cfg(tmp_path, model={"num_layers": 1}, batch_size_per_core=2,
               max_steps=6)
    tr = Trainer(cfg, store=fake.store, pretrained=False, device=["cpu"] * 2)
    before = signal.getsignal(signal.SIGTERM)
    try:
        tr.call(hold_until_stop, 2)

        def kill_when_training():
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                path = tmp_path / "metrics.jsonl"
                if path.exists() and path.read_text():
                    os.kill(os.getpid(), signal.SIGTERM)
                    return
                time.sleep(0.05)
        killer = threading.Thread(target=kill_when_training, daemon=True)
        killer.start()
        assert tr.train()["train_steps"] == 2
        killer.join(5)
        assert not killer.is_alive()
    finally:
        tr.close()
    assert os.listdir(tmp_path / "checkpoints") == ["2"]
    assert signal.getsignal(signal.SIGTERM) is before
