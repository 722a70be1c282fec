"""The port's ``Trainer`` on the CPU (``device="cpu"``): the four golden
trajectories of ``tests/golden_run.json`` from the JAX package's init
bridged into the trainer's state, the accelerated-eval agreement pins,
checkpoint retention against the JAX manager, exact resume (by step, and
"auto" after a stop request), ``save_model`` → ``Predictor.from_model_dir``
with and without the int8 artifact, ``trainer_state.json``,
``merged_floor_hint``, the dense warmup, the NaN guard and the refusals.

The goldens ran on the JAX package's 8-device CPU mesh at batch 2 per
device (a global batch of 16, eval batch 16); the port runs batch 16 on
one device and sees the same batches, because the loader's augmentation
keys on the global position in the batch."""

import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from chestxray_vit_tpu import config as jconfig
from chestxray_vit_tpu.models import vit as jvit
from chestxray_vit_tpu.train import checkpoint as jckpt
from chestxray_vit_tpu.train import steps as jsteps
from chestxray_vit_tpu.train import trainer as jtrainer
from chestxray_vit_tpu_torch import config as tconfig
from chestxray_vit_tpu_torch.data import pipeline as tpipe
from chestxray_vit_tpu_torch.data.testing import build_fake_nih
from chestxray_vit_tpu_torch.models import bridge
from chestxray_vit_tpu_torch.models import vit as tvit
from chestxray_vit_tpu_torch.serve.inference import Predictor
from chestxray_vit_tpu_torch.train import checkpoint as tckpt
from chestxray_vit_tpu_torch.train import steps as tsteps
from chestxray_vit_tpu_torch.train import trainer as ttrainer

with open(os.path.join(os.path.dirname(__file__), "golden_run.json")) as f:
    GOLDEN = json.load(f)

# (golden key prefix, model overrides) of test_golden_run.py's four runs
GOLDEN_RUNS = {
    "dense": ("", {}),
    "tome": ("tome_", {"tome_r": 2}),
    "tome_decreasing": ("tome_dec_", {"tome_r": 2,
                                      "tome_schedule": "decreasing"}),
    "deep_tome": ("deep_", {"tome_r": 1, "tome_schedule": "decreasing",
                            "num_layers": 32}),
}

# The decreasing run's golden avg_auroc rests on a tie: in the JAX
# package's val logits the Edema column's one positive lies one f32 ulp
# (6e-8) below a negative (-0.8406484 against -0.8406483); the port's
# logits, within 4.2e-7 of JAX's, order that pair the other way, which
# moves Edema's AUROC by 1/14 and the mean by 0.0089 (ROADMAP Queue 3).
# There the port is held to its own measured value, at the same atol.
PORT_AVG_AUROC = {"tome_decreasing": 0.48351648}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models here are tiny, so intra-op threads only add barriers;
    on a host loaded by several test workers those cost 50x (10 golden
    steps: 35 s on 8 threads, 0.7 s on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fake():
    return build_fake_nih(num_images=120, image_size=64, seed=17)


def _cfg(out_dir, model=None, **train):
    """test_golden_run.py's configuration, on one device at batch 16."""
    model = {"num_layers": 4, **(model or {})}
    kw = dict(batch_size_per_core=16, learning_rate=1e-3, max_steps=20,
              eval_strategy="no", save_strategy="steps", save_steps=10_000,
              load_best_model_at_end=False, logging_steps=1,
              output_dir=str(out_dir), report_to="none", seed=0)
    kw.update(train)
    return tconfig.Config(
        data=tconfig.DataConfig(backend="memory", augment=True),
        model=tconfig.ModelConfig(img_size=64, patch_size=16, hidden_size=64,
                                  num_heads=4, mlp_dim=256, dtype="float32",
                                  attention_impl="xla", **model),
        train=tconfig.TrainConfig(**kw))


def _jax_params(cfg: tconfig.ModelConfig):
    """The JAX package's init for ``cfg`` (as its Trainer draws it), as a
    port ``ViT``."""
    jp = jvit.init_params(jax.random.key(0), jconfig.ModelConfig(
        **dataclasses.asdict(cfg)))
    return bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg)


def _trainer(cfg, fake, bridged=True):
    tr = ttrainer.Trainer(cfg, store=fake.store, pretrained=False,
                          device="cpu")
    if bridged:
        tr.state = tsteps.TrainState.create(_jax_params(cfg.model),
                                            cfg.train.seed)
    return tr


def _logged(out_dir, prefix="train", key="loss"):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [(r["step"], r[key]) for r in recs if r["prefix"] == prefix]


_RUNS = {}


def _golden_run(name, fake, tmp_path_factory):
    """(losses, evaluate(), trainer) of one golden run, once per module."""
    if name not in _RUNS:
        out = tmp_path_factory.mktemp(name)
        tr = _trainer(_cfg(out, GOLDEN_RUNS[name][1]), fake)
        tr.train()
        ev = tr.evaluate()
        _RUNS[name] = ([v for _, v in _logged(out)], ev, tr)
    return _RUNS[name]


@pytest.mark.parametrize("name", list(GOLDEN_RUNS))
def test_golden_trajectory(name, fake, tmp_path_factory):
    key, _ = GOLDEN_RUNS[name]
    losses, ev, _ = _golden_run(name, fake, tmp_path_factory)
    assert len(losses) == 20
    np.testing.assert_allclose(losses, GOLDEN[f"{key}losses"], rtol=5e-4,
                               err_msg=f"{name} trajectory drifted from "
                                       f"the golden run")
    np.testing.assert_allclose(
        ev["avg_auroc"], PORT_AVG_AUROC.get(name, GOLDEN[f"{key}avg_auroc"]),
        atol=5e-3)
    np.testing.assert_allclose(ev["eval_loss"], GOLDEN[f"{key}eval_loss"],
                               rtol=5e-4)
    assert losses[-1] < 0.75 * losses[0]


def test_golden_accelerated_eval_agreement(fake, tmp_path_factory):
    """eval_quantize='static' (the port's fused int8 route, its plain twin
    here) and eval_tome_r=2 against the dense eval on the golden-trained
    weights, held to the JAX package's pins and tolerances (the static
    pin is JAX's "xla" route; in f32 the two routes agree within it)."""
    _, _, tr = _golden_run("dense", fake, tmp_path_factory)
    base, _, _ = tr._forward_all(tr.bundle.val)
    got = {}
    for path, knob, value in (("quant", "eval_quantize", "static"),
                              ("tome", "eval_tome_r", 2)):
        setattr(tr.cfg.train, knob, value)
        other, _, _ = tr._forward_all(tr.bundle.val)
        setattr(tr.cfg.train, knob, None if knob == "eval_quantize" else 0)
        got[path] = {
            "corr": float(np.corrcoef(base.ravel(), other.ravel())[0, 1]),
            "mean_abs": float(np.mean(np.abs(base - other)))}
    for path, want in GOLDEN["agreement"].items():
        np.testing.assert_allclose(got[path]["corr"], want["corr"],
                                   atol=2e-3, err_msg=f"{path} corr")
        np.testing.assert_allclose(got[path]["mean_abs"], want["mean_abs"],
                                   rtol=0.25, err_msg=f"{path} mean|Δ|")


def test_tome_warmup_runs_the_dense_step_first(fake, tmp_path):
    """train.tome_warmup=3: steps 1-3 are the dense run's, bit for bit,
    and the merged step takes over at step 4."""
    runs = {}
    for name, model, warm in (("dense", {}, 0), ("warm", {"tome_r": 2}, 3)):
        tr = _trainer(_cfg(tmp_path / name, model, max_steps=5,
                           tome_warmup=warm), fake)
        assert tr._tome_warmup_steps == warm
        tr.train()
        tr.close()
        runs[name] = [v for _, v in _logged(tmp_path / name)]
    assert runs["warm"][:3] == runs["dense"][:3]
    assert runs["warm"][3] != runs["dense"][3]
    frac = _trainer(_cfg(tmp_path / "f", {"tome_r": 2}, max_steps=8,
                         tome_warmup=0.375), fake, bridged=False)
    assert frac._tome_warmup_steps == 3
    for bad, err in (({"tome_warmup": 1.5}, "integer step count"),
                     ({"tome_warmup": -1}, ">= 0")):
        with pytest.raises(ValueError, match=err):
            _trainer(_cfg(tmp_path / "b", {"tome_r": 2}, **bad), fake,
                     bridged=False)
    with pytest.raises(ValueError, match="requires model.tome_r"):
        _trainer(_cfg(tmp_path / "c", tome_warmup=2), fake, bridged=False)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

RETENTION_CASES = {
    # (save_total_limit, metric_for_best, greater_is_better, saves)
    "best_kept": (2, "avg_auroc", True,
                  [(1, {"avg_auroc": 0.6}), (2, {"avg_auroc": 0.9}),
                   (3, {"avg_auroc": 0.7}), (4, {"avg_auroc": 0.5})]),
    "latest_kept": (2, "avg_auroc", True,
                    [(1, {"avg_auroc": 0.80}), (2, {"avg_auroc": 0.84}),
                     (3, {"avg_auroc": 0.83}), (4, {"avg_auroc": 0.82})]),
    "metricless_bounded": (2, "avg_auroc", True,
                           [(s, None) for s in range(1, 7)]),
    "missing_key_and_nan_worst": (
        2, "avg_auroc", True,
        [(1, {"avg_auroc": 0.9})] + [(s, {"eval_loss": 0.5,
                                          "avg_auroc": float("nan")})
                                     for s in (2, 3, 4)]),
    "mixed_lower_is_better": (
        2, "eval_loss", False,
        [(1, {"eval_loss": 0.4}), (2, None), (3, {"eval_loss": 0.3}),
         (4, {"eval_loss": 0.3}), (5, None), (6, {"eval_loss": 0.5})]),
    "no_best_metric": (3, None, True,
                       [(s, {"avg_auroc": 0.1 * s}) for s in range(1, 6)]),
}


def _tiny_states():
    mcfg = tconfig.ModelConfig(img_size=32, patch_size=16, hidden_size=32,
                               num_layers=1, num_heads=2, mlp_dim=64,
                               num_classes=3, dtype="float32")
    jparams = jvit.init_params(jax.random.key(0), jconfig.ModelConfig(
        **dataclasses.asdict(mcfg)))
    tparams = tvit.init_params(torch.Generator().manual_seed(0), mcfg)
    return (jsteps.TrainState.create(jparams, 0),
            tsteps.TrainState.create(tparams, 0))


@pytest.mark.parametrize("case", list(RETENTION_CASES))
def test_retention_matches_jax(case, tmp_path):
    limit, metric, gib, saves = RETENTION_CASES[case]
    jstate, tstate = _tiny_states()
    kw = dict(save_total_limit=limit, metric_for_best=metric,
              greater_is_better=gib)
    jm = jckpt.CheckpointManager(str(tmp_path / "j"), **kw)
    tm = tckpt.CheckpointManager(str(tmp_path / "t"), **kw)
    for step, metrics in saves:
        jm.save(step, jstate, metrics=metrics)
        jm.wait()
        tm.save(step, tstate, metrics=metrics)
        tm.wait()
        assert tm.all_steps() == sorted(jm.all_steps()), step
        assert (tm.latest_step(), tm.best_step()) == \
            (jm.latest_step(), jm.best_step()), step
    assert sorted(os.listdir(tmp_path / "t")) == \
        [str(s) for s in tm.all_steps()]
    # a new manager over the directory sees the same saves and ranking
    again = tckpt.CheckpointManager(str(tmp_path / "t"), **kw)
    assert (again.all_steps(), again.best_step()) == \
        (tm.all_steps(), tm.best_step())
    with pytest.raises(ValueError, match="already exists"):
        tm.save(tm.latest_step(), tstate)
    jm.close()


def test_checkpoint_round_trip_is_exact(tmp_path):
    _, state = _tiny_states()
    for p in state.params.parameters():
        p.grad = torch.randn_like(p)
    step_fn = tsteps.make_train_step(tconfig.Config(
        model=state.params.cfg, data=tconfig.DataConfig(mixup_alpha=0.2)),
        10)
    batch = {"pixel_values": torch.randn(2, 32, 32, 3),
             "labels": torch.ones(2, 3)}
    state, _ = step_fn(state, batch)
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, state, cursor=tckpt.DataCursor(2, 7),
             metrics={"avg_auroc": 0.5}, extra={"note": "x"})
    before = {n: p.detach().clone()
              for n, p in state.params.named_parameters()}
    mu = {n: t.clone() for n, t in state.opt_state["mu"].items()}
    generator = state.generator.get_state()
    state, _ = step_fn(state, batch)            # the live state moves on
    _, fresh = _tiny_states()
    restored, cursor, extra = mgr.restore(1, fresh)
    assert restored.step == 1 and (cursor.epoch, cursor.batch_in_epoch) == \
        (2, 7) and extra == {"note": "x"}
    for n, p in restored.params.named_parameters():
        assert torch.equal(p, before[n]), n
        assert torch.equal(restored.opt_state["mu"][n], mu[n]), n
    # the generator (mixup's λ stream) continues where it was saved
    assert torch.equal(restored.generator.get_state(), generator)
    meta = json.loads((tmp_path / "ck" / "1" / "meta.json").read_text())
    assert meta["metrics"] == {"avg_auroc": 0.5}
    with pytest.raises(FileNotFoundError):
        tckpt.CheckpointManager(str(tmp_path / "empty")).restore(None, fresh)


def test_exact_resume_by_step(fake, tmp_path):
    """Stop at step 4 (mid-epoch: 5 batches an epoch), resume from its
    checkpoint in a fresh output directory: steps 5-8 and the final
    weights equal the uninterrupted run's, bit for bit."""
    full = _trainer(_cfg(tmp_path / "a", max_steps=8, save_steps=4), fake)
    full.train()
    full.close()
    want = _logged(tmp_path / "a")
    (tmp_path / "b" / "checkpoints").mkdir(parents=True)
    shutil.copytree(tmp_path / "a" / "checkpoints" / "4",
                    tmp_path / "b" / "checkpoints" / "4")
    resumed = _trainer(_cfg(tmp_path / "b", max_steps=8, save_steps=4,
                            resume_from_checkpoint="4"), fake,
                       bridged=False)
    resumed.train()
    resumed.close()
    assert _logged(tmp_path / "b") == want[4:]
    for n, p in resumed.state.params.named_parameters():
        assert torch.equal(p, dict(full.state.params.named_parameters())[n])
    assert resumed.ckpt.all_steps() == [4, 8]


def test_stop_request_checkpoints_and_auto_resumes(fake, tmp_path):
    """A stop request (what SIGTERM / SIGINT do) checkpoints the exact
    cursor; resume_from_checkpoint='auto' continues to the same losses."""
    ref = _trainer(_cfg(tmp_path / "ref", max_steps=7), fake)
    ref.train()
    ref.close()
    want = _logged(tmp_path / "ref")
    cfg = _cfg(tmp_path / "run", max_steps=7)
    tr = _trainer(cfg, fake)
    step_fn = tr._train_step

    def stopping(state, batch):
        out = step_fn(state, batch)
        if out[0].step == 6:
            tr.request_stop()
        return out

    tr._train_step = stopping
    tr.train()
    assert tr.ckpt.all_steps() == [6]
    meta = json.loads((tmp_path / "run" / "checkpoints" / "6" /
                       "meta.json").read_text())
    assert meta["cursor"] == {"epoch": 1, "batch_in_epoch": 1}
    tr.close()
    cfg.train.resume_from_checkpoint = "auto"
    again = _trainer(cfg, fake, bridged=False)
    again.train()
    assert _logged(tmp_path / "run") == want


def test_cadence_best_restore_and_trainer_state(fake, tmp_path):
    """eval and save every 3 steps with best-model restore: both saves
    carry their eval metrics, the best one is loaded at the end, and
    trainer_state.json has HF's shape; the losses reach TensorBoard's file
    and profile_steps writes a trace."""
    cfg = _cfg(tmp_path, max_steps=6, eval_strategy="steps", eval_steps=3,
               save_steps=3, load_best_model_at_end=True, save_total_limit=1,
               report_to="tensorboard", profile_steps=(1, 2))
    tr = _trainer(cfg, fake)
    result = tr.train()
    assert result["train_steps"] == 6
    evals = dict(_logged(tmp_path, "eval", "avg_auroc"))
    assert sorted(evals) == [3, 6]
    assert tr.ckpt.all_steps() in ([3, 6], [6])
    best = tr.ckpt.best_step()
    assert evals[best] == max(evals.values())
    assert tr.state.step == best
    state = json.loads(open(tr.save_state()).read())
    assert state["global_step"] == best and state["max_steps"] == 6
    assert state["best_metric"] == evals[best]
    assert state["best_model_checkpoint"].endswith(f"checkpoints/{best}")
    assert [r["step"] for r in state["log_history"]
            if "eval_avg_auroc" in r] == [3, 6]
    assert len([r for r in state["log_history"] if "loss" in r]) == 6
    # train.profile_steps=(1, 2) traced step 2 into a Chrome trace
    trace = json.loads((tmp_path / "profile" / "trace_1_2.json").read_text())
    assert trace["traceEvents"]
    from chestxray_vit_tpu_torch.utils.tfevents import read_scalars
    (tb,) = (tmp_path / "tb").iterdir()
    tb_losses = [(s, v) for s, t, v in read_scalars(str(tb))
                 if t == "train/loss"]
    np.testing.assert_array_equal(
        [v for _, v in tb_losses],
        np.float32([v for _, v in _logged(tmp_path)]))
    # predict with calibrated thresholds and the report
    _, _, metrics = tr.predict(report_path=str(tmp_path / "report.txt"),
                               calibrate=True)
    assert {"avg_auroc", "f1_micro", "test_loss",
            "f1_micro_calibrated"} <= set(metrics)
    assert "calibrated per-class thresholds" in \
        (tmp_path / "report.txt").read_text()
    tr.close()


def _val_pixels(tr):
    loader = tr._loader(tr.bundle.val, augment=False)
    return [loader.load(i)["pixel_values_u8"]
            for i in range(len(tr.bundle.val))]


def test_save_model_to_predictor(fake, tmp_path, capsys):
    """save_model → load_model → Predictor.from_model_dir serves the val
    images with the Trainer's eval logits; with quantize='static' a
    matching quantized/ artifact is loaded, a stale one is ignored."""
    tr = _trainer(_cfg(tmp_path, max_steps=2), fake)
    tr.train()
    model_dir = tmp_path / "model"
    tr.save_model(str(model_dir))
    assert {"params.pt", "config.json", "classes.json",
            "preprocessor_config.json"} <= set(os.listdir(model_dir))
    params, classes = tckpt.load_model(str(model_dir), tvit.ViT(
        tr.cfg.model))
    assert classes == tr.bundle.classes
    for n, p in params.named_parameters():
        assert torch.equal(p, dict(tr.state.params.named_parameters())[n])
    want, _, _ = tr._forward_all(tr.bundle.val)
    pixels = _val_pixels(tr)
    pred = Predictor.from_model_dir(str(model_dir), batch_size=8,
                                    device="cpu")
    assert pred.classes == tr.bundle.classes
    np.testing.assert_allclose(pred.predict_arrays(pixels).logits, want,
                               atol=1e-5)

    static = Predictor.from_model_dir(str(model_dir), batch_size=8,
                                      device="cpu", quantize="static",
                                      calibration=pixels[:4])
    static.save_quantized(str(model_dir / "quantized"))
    capsys.readouterr()
    loaded = Predictor.from_model_dir(str(model_dir), batch_size=8,
                                      device="cpu", quantize="static")
    assert "loaded int8 artifact" in capsys.readouterr().err
    for (n, a), (_, b) in zip(loaded._fwd_params.named_buffers(),
                              static._fwd_params.named_buffers()):
        assert torch.equal(a, b), n
    np.testing.assert_array_equal(loaded.predict_arrays(pixels).logits,
                                  static.predict_arrays(pixels).logits)
    Predictor.from_model_dir(str(model_dir), batch_size=8, device="cpu",
                             quantize="dynamic")
    assert "re-quantizing" in capsys.readouterr().err
    meta_path = model_dir / "quantized" / "quantized.json"
    meta = json.loads(meta_path.read_text())
    meta_path.write_text(json.dumps({**meta, "fingerprint": "0" * 32}))
    Predictor.from_model_dir(str(model_dir), batch_size=8, device="cpu",
                             quantize="static", calibration=pixels[:4])
    assert "DIFFERENT weights" in capsys.readouterr().err
    with pytest.raises(FileNotFoundError, match="params.pt"):
        tckpt.load_model(str(tmp_path), tvit.ViT(tr.cfg.model))
    tr.close()


def test_server_model_dir_flag():
    from chestxray_vit_tpu_torch.serve import server
    ns = server.parse_args(["--model-dir", "outputs/model", "--device",
                            "cpu"])
    assert ns.model_dir == "outputs/model" and ns.seed == 0
    assert server.parse_args([]).model_dir is None


# ---------------------------------------------------------------------------
# guards and refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("history,step,total,r,warm", [
    ([(2, 0.50), (4, 0.505)], 7, 10, 16, 0),
    ([(2, 0.50), (4, 0.60)], 7, 10, 16, 0),
    ([(2, 0.50), (4, 0.505)], 5, 10, 16, 0),
    ([(2, 0.50), (4, 0.505)], 7, 10, 0, 0),
    ([(2, 0.50), (4, 0.505)], 7, 10, 16, 3),
    ([(2, 0.50)], 9, 10, 16, 0)])
def test_merged_floor_hint_matches_jax(history, step, total, r, warm):
    got = ttrainer.merged_floor_hint(history, step, total, r, warm)
    assert got == jtrainer.merged_floor_hint(history, step, total, r, warm)


def test_nan_guard_raises_and_releases_the_loader(fake, tmp_path):
    tr = _trainer(_cfg(tmp_path, max_steps=4), fake, bridged=False)
    step_fn = tr._train_step

    def diverging(state, batch):
        state, m = step_fn(state, batch)
        return state, {**m, "loss": torch.tensor(float("nan"))}

    tr._train_step = diverging
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        tr.train()
    tr.close()


class _Reached(Exception):
    pass


@pytest.mark.parametrize("what", ["mesh", "pretrained", "gs", "hf_dataset",
                                  "eval_quantize", "eval_tome_r"])
def test_refusals(what, fake, tmp_path, monkeypatch, capsys):
    """What the Trainer refuses. ``mesh``: a mesh that does not tile the
    devices raises the JAX ``build_mesh``'s ValueError (one CPU device
    against a data axis of 2), with the hint that a lone process starts one
    rank a device (``tests/test_torch_launch.py`` runs that). ``pretrained``, ``hf_dataset`` and
    ``gs://`` checkpoints are ported: ``pretrained`` now checks the
    reference's degrade to random init for a local folder that cannot be
    read, ``hf_dataset`` that the backend reaches ``load_hf_dataset``,
    and ``gs`` that model and log directories stay local (a gs://
    CheckpointManager is tested against the GCS emulator,
    ``test_torch_gcs_checkpoint.py``)."""
    cfg = _cfg(tmp_path)
    kw = {"pretrained": False}
    err, match = NotImplementedError, "ROADMAP Queue 1 #"
    if what == "mesh":
        cfg.mesh.data, err = 2, ValueError
        match = r"mesh 2x1x1 != 1 devices: .*one rank a device"
    elif what == "pretrained":
        cfg.model.model_name = str(tmp_path)      # no model.safetensors
        tr = ttrainer.Trainer(cfg, store=fake.store, device="cpu",
                              pretrained=True)
        assert "[import_hf] local load failed" in capsys.readouterr().out
        init = tvit.init_params(torch.Generator().manual_seed(
            cfg.train.seed), cfg.model)
        assert all(torch.equal(a, b) for a, b in zip(
            tr.state.params.parameters(), init.parameters()))
        tr.close()
        return
    elif what == "gs":
        with pytest.raises(ValueError, match="local path"):
            tckpt.save_model("gs://bucket/model", None, "{}")
        with pytest.raises(ValueError, match="local path"):
            tckpt.load_model("gs://bucket/model", None)
        with pytest.raises(ValueError, match="local path"):
            Predictor.from_model_dir("gs://bucket/model", device="cpu")
        cfg.train.output_dir, err, match = ("gs://bucket/out", ValueError,
                                            "local path")
    elif what == "hf_dataset":
        from chestxray_vit_tpu_torch.data import hf_datasets

        def reached(*args, **kwargs):
            raise _Reached(args, kwargs)

        monkeypatch.setattr(hf_datasets, "load_hf_dataset", reached)
        cfg.data.backend, err = "hf_dataset", _Reached
        match = "kerem/nih-chest-xray-14.*'img_size': 64"
    elif what == "eval_quantize":
        cfg.train.eval_quantize, err, match = "int4", ValueError, "int4"
    else:
        cfg.model.tome_r, cfg.train.eval_tome_r = 2, 4
        err, match = ValueError, "conflicts"
    with pytest.raises(err, match=match):
        ttrainer.Trainer(cfg, store=fake.store, device="cpu", **kw)


def test_cuda_trainer_refuses_without_a_card(fake, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: Trainer(device='cuda') runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.Trainer(_cfg(tmp_path), store=fake.store,
                         pretrained=False)


def test_prefetcher_batches_reach_the_step_on_the_trainer_device(fake,
                                                                 tmp_path):
    tr = _trainer(_cfg(tmp_path, max_steps=1), fake, bridged=False)
    (batch,) = list(tpipe.DevicePrefetcher(tr._train_batches(0, skip=4),
                                           tr.device))
    assert batch["pixel_values_u8"].shape == (16, 64, 64)
    assert batch["labels"].shape == (16, 15)
    assert batch["pixel_values_u8"].device == tr.device
    tr.close()
