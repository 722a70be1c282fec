"""The port's ``PackedTrainer`` on the CPU against the JAX package's: the
same fake variable-resolution bucket, the same weights (the JAX init
bridged into the port's state), f32, at the JAX tests' tiny sizes
(``tests/test_packed_trainer.py``: grids 2/3/4, seq_len 48, 8 sequences a
step). Held: the losses of six steps at the trainer tests' rtol 5e-4 and
the eval metrics, ``steps_per_epoch`` exactly; resume that skips I/O and
re-packs the uninterrupted stream's tail; a checkpoint resume equal to
the uninterrupted run bit for bit, its cursor counting consumed images
only; a zero cursor at an epoch-boundary save after a resume; both
topology refusals; the accelerated-eval refusal; accumulation consuming
accum × batch_seqs sequences."""

import dataclasses
import io
import json
import shutil

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from chestxray_vit_tpu import config as jconfig
from chestxray_vit_tpu.data.testing import build_fake_nih as jbuild_fake_nih
from chestxray_vit_tpu.models import vit as jvit
from chestxray_vit_tpu.train.packed_trainer import PackedTrainer as JPacked
from chestxray_vit_tpu_torch import config as tconfig
from chestxray_vit_tpu_torch.data import packing as pk
from chestxray_vit_tpu_torch.data.pipeline import build_datasets
from chestxray_vit_tpu_torch.data.testing import build_fake_nih
from chestxray_vit_tpu_torch.models import bridge
from chestxray_vit_tpu_torch.parallel import distributed as dist
from chestxray_vit_tpu_torch.train import checkpoint as tckpt
from chestxray_vit_tpu_torch.train import steps as tsteps
from chestxray_vit_tpu_torch.train.packed_trainer import PackedTrainer

GRIDS = (2, 3, 4)   # 32/48/64 px at patch 16
SEQ_LEN = 48
BATCH_SEQS = 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny models: intra-op threads only add barriers, and cost 50x on a
    host loaded by several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rewrite_varres(fake):
    """A third of the images rewritten at 32 or 48 px (the packed use
    case), as ``tests/test_packed_trainer.py`` does."""
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


@pytest.fixture(scope="module")
def varres():
    """(port bucket, JAX bucket): the same bytes, built by each package."""
    return (_rewrite_varres(build_fake_nih(num_images=60, image_size=64,
                                           seed=21)),
            _rewrite_varres(jbuild_fake_nih(num_images=60, image_size=64,
                                            seed=21)))


@pytest.fixture(scope="module")
def uniform():
    return build_fake_nih(num_images=240, image_size=64, seed=3)


def _train_kw(out_dir, **train):
    kw = dict(learning_rate=1e-3, max_steps=6, eval_strategy="no",
              save_strategy="steps", save_steps=1000, logging_steps=1,
              load_best_model_at_end=False, output_dir=str(out_dir),
              report_to="none")
    kw.update(train)
    return kw


_MODEL = dict(img_size=64, patch_size=16, hidden_size=64, num_layers=2,
              num_heads=4, mlp_dim=128, dtype="float32", attention_impl="xla")


def _cfg(out_dir, **train):
    return tconfig.Config(data=tconfig.DataConfig(backend="memory"),
                          model=tconfig.ModelConfig(**_MODEL),
                          train=tconfig.TrainConfig(**_train_kw(out_dir,
                                                                **train)))


def _trainer(cfg, store, bridged=True, **kw):
    """A port PackedTrainer on the CPU; ``bridged`` gives it the JAX
    PackedTrainer's init."""
    kw = {"seq_len": SEQ_LEN, "grids": GRIDS, "batch_seqs": BATCH_SEQS, **kw}
    tr = PackedTrainer(cfg, store=store, pretrained=False, device="cpu",
                       **kw)
    if bridged:
        jp = jvit.init_params(jax.random.key(cfg.train.seed),
                              jconfig.ModelConfig(
                                  **dataclasses.asdict(tr.cfg.model)))
        tr.state = tsteps.TrainState.create(
            bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                   tr.cfg.model), cfg.train.seed)
    return tr


def _logged(out_dir, prefix="train", key="loss"):
    with open(out_dir / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    return [(r["step"], r[key]) for r in recs if r["prefix"] == prefix]


@pytest.fixture(scope="module")
def runs(varres, tmp_path_factory):
    """Six steps of each package's PackedTrainer, then evaluate and
    predict."""
    fake, jfake = varres
    out = {}
    jdir = tmp_path_factory.mktemp("jax")
    jcfg = jconfig.Config(data=jconfig.DataConfig(backend="memory"),
                          model=jconfig.ModelConfig(**_MODEL),
                          train=jconfig.TrainConfig(**_train_kw(jdir)))
    jtr = JPacked(jcfg, seq_len=SEQ_LEN, grids=GRIDS, batch_seqs=BATCH_SEQS,
                  store=jfake.store, pretrained=False)
    jtr.train()
    out["jax"] = (jtr.steps_per_epoch, [v for _, v in _logged(jdir)],
                  jtr.evaluate(), jtr.predict()[0].shape)
    jtr.close()
    tdir = tmp_path_factory.mktemp("port")
    tr = _trainer(_cfg(tdir), fake.store)
    result = tr.train()
    out["port"] = (tr.steps_per_epoch, [v for _, v in _logged(tdir)],
                   tr.evaluate(), tr.predict()[0].shape)
    out["port_result"], out["port_test"] = result, len(tr.bundle.test)
    tr.close()
    return out


def test_packed_trainer_matches_jax(runs):
    spe, losses, ev, pred_shape = runs["port"]
    jspe, jlosses, jev, jpred_shape = runs["jax"]
    assert spe == jspe
    assert runs["port_result"]["train_steps"] == 6 and len(losses) == 6
    np.testing.assert_allclose(losses, jlosses, rtol=5e-4)
    np.testing.assert_allclose(ev["avg_auroc"], jev["avg_auroc"], atol=5e-3)
    np.testing.assert_allclose(ev["eval_loss"], jev["eval_loss"], rtol=5e-4)
    # packed predict over the test split: one logit row per image
    assert pred_shape == jpred_shape == (runs["port_test"], 15)


def test_packed_steps_per_epoch_is_measured(uniform, tmp_path):
    """With uniform resolutions the census simulation is exact: it
    matches the batches the epoch really packs."""
    tr = _trainer(_cfg(tmp_path), uniform.store, bridged=False,
                  census_sample=16)
    real = sum(1 for _ in tr._train_batches(epoch=0))
    assert tr.steps_per_epoch == real
    tr.close()


class CountingStore:
    """Store wrapper counting get() calls (I/O accounting for resume)."""

    def __init__(self, inner):
        self.inner = inner
        self.gets = 0

    def get(self, key):
        self.gets += 1
        return self.inner.get(key)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_packed_resume_skips_io_and_matches_prefix(varres):
    """skip_images resumes before any fetch or decode: exactly the
    remaining images are fetched, and the re-packed batches equal the
    uninterrupted run's tail."""
    fake = varres[0]
    bundle = build_datasets(tconfig.DataConfig(backend="memory"),
                            store=fake.store)
    kw = dict(batch_seqs=2, patch=16, seq_len=SEQ_LEN, grids=GRIDS,
              epoch=0, shuffle=True, seed=42, num_workers=2)
    full = list(pk.iterate_packed_batches(
        bundle.train, bundle.blob_map, fake.store, **kw))
    skip = int(full[0]["n_images"]) + int(full[1]["n_images"])
    counting = CountingStore(fake.store)
    resumed = list(pk.iterate_packed_batches(
        bundle.train, bundle.blob_map, counting, skip_images=skip, **kw))
    assert counting.gets == len(bundle.train) - skip
    assert len(resumed) == len(full) - 2
    for a, b in zip(resumed, full[2:]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_packed_trainer_checkpoint_resume(uniform, tmp_path):
    """Stop at step 2 of 4 (mid-epoch), resume from its checkpoint in a
    fresh directory: the cursor counts the images of the two CONSUMED
    batches (not those the prefetch thread packed ahead), the resumed run
    fetches no skipped image, and steps 3-4 and the final weights equal
    the uninterrupted run's bit for bit."""
    full = _trainer(_cfg(tmp_path / "a", max_steps=4, save_steps=2),
                    uniform.store, census_sample=4)
    full.train()
    full.close()
    want = _logged(tmp_path / "a")
    expected, n_full = 0, 0
    for b in pk.iterate_packed_batches(
            full.bundle.train, full.bundle.blob_map, uniform.store,
            batch_seqs=BATCH_SEQS, patch=16, seq_len=SEQ_LEN, grids=GRIDS,
            epoch=0, shuffle=True, seed=full.cfg.data.shuffle_buffer_seed,
            num_workers=2):
        if int(b["n_seqs"]) == BATCH_SEQS:
            expected += int(b["n_images"])
            n_full += 1
            if n_full == 2:
                break
    meta = json.loads((tmp_path / "a" / "checkpoints" / "2" /
                       "meta.json").read_text())
    assert meta["cursor"] == {"epoch": 0, "batch_in_epoch": expected}
    assert 0 < expected < len(full.bundle.train)

    (tmp_path / "b" / "checkpoints").mkdir(parents=True)
    shutil.copytree(tmp_path / "a" / "checkpoints" / "2",
                    tmp_path / "b" / "checkpoints" / "2")
    counting = CountingStore(uniform.store)
    resumed = _trainer(_cfg(tmp_path / "b", max_steps=4, save_steps=2,
                            resume_from_checkpoint="2"), counting,
                       bridged=False, census_sample=4)
    gets_before = counting.gets          # census and metadata reads
    resumed.train()
    resumed.close()
    assert resumed._restored_cursor.batch_in_epoch == expected
    assert counting.gets - gets_before <= len(full.bundle.train) - expected
    assert _logged(tmp_path / "b") == want[2:]
    for n, p in resumed.state.params.named_parameters():
        assert torch.equal(p, dict(full.state.params.named_parameters())[n])
    a, b = (torch.load(d / "checkpoints" / "4" / "state.pt",
                       weights_only=True) for d in (tmp_path / "a",
                                                    tmp_path / "b"))
    assert all(torch.equal(a[k][n], b[k][n])
               for k in ("params", "mu", "nu") for n in a[k])


def test_epoch_boundary_save_after_resume_writes_zero_cursor(varres,
                                                             tmp_path):
    """An epoch-boundary save (batch_idx 0) after a mid-epoch resume
    writes image count 0 for the new epoch, not the finished epoch's
    resume offset."""
    tr = _trainer(_cfg(tmp_path), varres[0].store, bridged=False,
                  census_sample=4)
    tr._resume_skip = 30
    tr._local_skip = 30
    tr._images_cum = [30]
    tr._save(step=5, epoch=1, batch_idx=0)
    tr.ckpt.wait()
    meta = json.loads((tmp_path / "checkpoints" / "5" /
                       "meta.json").read_text())
    assert meta["cursor"] == {"epoch": 1, "batch_in_epoch": 0}
    tr.close()


@pytest.mark.parametrize("case", ["single_of_multi", "multi_without_counts",
                                  "multi_of_other_count"])
def test_topology_refusals(case, varres, tmp_path):
    """A mid-epoch packed resume cannot change the process count: one
    process resuming a two-process cursor, and two processes resuming a
    cursor without per-process counts or with another count, raise
    before any batch is packed; a one-process cursor resumes."""
    tr = _trainer(_cfg(tmp_path), varres[0].store, bridged=False,
                  census_sample=4)
    if case == "single_of_multi":
        tr._restored_cursor = tckpt.DataCursor(0, 5, per_host=[3, 2])
        match = "host count"
    else:
        tr._hosts = 2          # what a rank of a two-process group holds
        per_host = None if case == "multi_without_counts" else [1, 2, 2]
        tr._restored_cursor = tckpt.DataCursor(0, 5, per_host=per_host)
        match = ("per-host image counts" if per_host is None
                 else "host count")
    with pytest.raises(ValueError, match=match):
        next(tr._train_batches(0, skip=5))
    if case == "single_of_multi":
        tr._restored_cursor = tckpt.DataCursor(0, 5, per_host=[5])
        batch = next(tr._train_batches(0, skip=5))
        assert batch["tokens"].shape == (BATCH_SEQS, SEQ_LEN, 768)
        assert "n_images" not in batch and "n_seqs" not in batch
    tr.close()


@pytest.mark.parametrize("knob,value", [("eval_quantize", "static"),
                                        ("eval_tome_r", 2)])
def test_accelerated_eval_refused(knob, value, varres, tmp_path):
    cfg = _cfg(tmp_path)
    setattr(cfg.train, knob, value)
    with pytest.raises(ValueError, match="do not compose"):
        _trainer(cfg, varres[0].store, bridged=False)


def test_batch_seqs_must_divide_over_processes(varres, tmp_path,
                                               monkeypatch):
    monkeypatch.setattr(dist, "world", lambda: 2)
    with pytest.raises(ValueError, match="not divisible by host count .* 2"):
        _trainer(_cfg(tmp_path), varres[0].store, bridged=False,
                 batch_seqs=3)


def test_accum_consumes_accum_x_batch_seqs(tmp_path):
    fake = build_fake_nih(num_images=120, image_size=64, seed=5)
    tr = _trainer(_cfg(tmp_path, max_steps=2,
                       gradient_accumulation_steps=2), fake.store,
                  bridged=False, census_sample=8)
    assert tr._local_step_seqs == 16          # 8 seqs × accum 2
    batches = list(tr._train_batches(epoch=0))
    assert batches and all(b["tokens"].shape[0] == 16 for b in batches)
    tr.train()
    assert tr.state.step == 2
    tr.close()
