"""The port's token merging on the dense forward (``models/tome_forward.py``)
and every entry point that reaches it, against the JAX package's, on the
CPU: the serving forward on dense and int8 trees, the differentiable
forward and its gradients, ``vit.apply``'s dispatch, the train and eval
steps, the ``Predictor`` and the server's flags.

Both sides take the same numpy-seeded inputs and the same weights (drawn
by the JAX package's ``init_params`` and bridged). The JAX side runs as
its own tests run it: ``attention_impl="pallas"`` interprets its kernels
on the CPU, ``"xla"`` takes its plain path; the port runs its plain
kernel twins, which is what its wrappers do for CPU tensors.

Tolerances: f32 logits 2e-5 (summation order), bf16 2e-2 (the two CPU
backends round bf16 products at other points); int8 as in
tests/test_torch_quant.py (1e-4 in f32 on one route, 2e-2 where the port
takes the fused route and the JAX package the plain one); gradients 1e-4
of the largest, as tests/test_torch_packed.py holds them. The matching is
discrete: one pair matched apart moves the logits by far more than these
tolerances, so each case also shows that both sides merged the same pairs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chestxray_vit_tpu.models import quantized as jq
from chestxray_vit_tpu.models import tome_forward as jtf
from chestxray_vit_tpu.models import vit as jvit
from chestxray_vit_tpu.serve import server as jserver
from chestxray_vit_tpu.serve.inference import Predictor as JaxPredictor
from chestxray_vit_tpu.train import steps as jsteps
from chestxray_vit_tpu_torch.config import Config, ModelConfig, TrainConfig
from chestxray_vit_tpu_torch.models import bridge
from chestxray_vit_tpu_torch.models import quantized as tq
from chestxray_vit_tpu_torch.models import tome_forward as ttf
from chestxray_vit_tpu_torch.models import vit as tvit
from chestxray_vit_tpu_torch.serve import server
from chestxray_vit_tpu_torch.serve.inference import Predictor
from chestxray_vit_tpu_torch.train import steps as tsteps

from test_torch_packed import (assert_trees_close, jax_attention_seeds,
                               jax_cfg, to_np)

torch.backends.cuda.matmul.allow_tf32 = False

F32_TOL, BF16_TOL = 2e-5, 2e-2
INT8_TOL = {("xla", "float32"): 1e-4, ("xla", "bfloat16"): 2e-2,
            ("pallas", "float32"): 2e-2, ("pallas", "bfloat16"): 2e-2}
GRAD_RTOL = 1e-4
# (r, schedule): S = 17 at img 32 / patch 8. r = 8 runs into the clamp
# from the second layer on: 17 → 9 → 5 → 3
MERGES = [(2, "constant"), (3, "decreasing"), (8, "constant")]


def small_cfg(dtype="float32", impl="pallas", **kw):
    """img 32, patch 8 (17 tokens), width 64, 4 heads, MLP 128, 3 layers,
    5 classes."""
    base = dict(img_size=32, patch_size=8, hidden_size=64, num_layers=3,
                num_heads=4, mlp_dim=128, num_classes=5, dtype=dtype,
                attention_impl=impl)
    return ModelConfig(**{**base, **kw})


def params_pair(cfg, seed=0):
    jp = jvit.init_params(jax.random.key(seed), jax_cfg(cfg))
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg)


def images(n=3, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


def step_cfg(**model):
    return Config(model=small_cfg(**model),
                  train=TrainConfig(learning_rate=2e-3, warmup_steps=1))


# ---------------------------------------------------------------------------
# The serving forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,schedule", MERGES)
@pytest.mark.parametrize("dtype,impl,tol", [
    ("float32", "pallas", F32_TOL), ("float32", "xla", F32_TOL),
    ("bfloat16", "pallas", BF16_TOL)])
def test_apply_tome_matches_jax(r, schedule, dtype, impl, tol):
    cfg = small_cfg(dtype, impl)
    jp, tp = params_pair(cfg)
    x = images()
    ref = jax.jit(lambda p, a: jtf.apply_tome(
        p, a, jax_cfg(cfg), r, schedule=schedule))(jp, jnp.asarray(x))
    with torch.no_grad():
        got = ttf.apply_tome(tp, torch.from_numpy(x), cfg, r,
                             schedule=schedule)
    assert got.dtype == torch.float32 and got.shape == (3, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,backend", [("dynamic", "xla"),
                                          ("static", "xla"),
                                          ("static", "pallas")])
def test_apply_tome_quantized_matches_jax(mode, backend, dtype):
    """The int8 trees; the JAX package merges on its plain route only, the
    port's ``backend="pallas"`` on the fused kernel (its plain twin
    here)."""
    cfg = small_cfg(dtype)
    jp, _ = params_pair(cfg)
    x = images()
    scales = (jq.calibrate_vit_scales(jp, jnp.asarray(images(seed=9)),
                                      jax_cfg(cfg))
              if mode == "static" else None)
    jqp = jq.quantize_vit_params(jp, scales)
    tqp = bridge.qparams_from_jax(jax.tree.map(np.asarray, jqp), cfg)
    ref = jax.jit(lambda p, a: jtf.apply_tome(
        p, a, jax_cfg(cfg), 3, quantized=True, schedule="decreasing"))(
        jqp, jnp.asarray(x))
    with torch.no_grad():
        got = ttf.apply_tome(tqp, torch.from_numpy(x), cfg, 3,
                             quantized=True, schedule="decreasing",
                             backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=INT8_TOL[(backend, dtype)])


def test_apply_tome_refusals():
    cfg = small_cfg()
    _, tp = params_pair(cfg)
    x = torch.from_numpy(images(1))
    with pytest.raises(ValueError, match="positive"):
        ttf.apply_tome(tp, x, cfg, 0)
    with pytest.raises(ValueError, match="schedule"):
        ttf.apply_tome(tp, x, cfg, 2, schedule="linear")
    with pytest.raises(ValueError, match="static int8"):
        ttf.apply_tome(tp, x, cfg, 2, backend="pallas")
    with pytest.raises(ValueError, match="static"):
        ttf.apply_tome(tq.quantize_vit_params(tp), x, cfg, 2, quantized=True,
                       backend="pallas")


# ---------------------------------------------------------------------------
# The differentiable forward, vit.apply's dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
def test_tome_train_forward_and_grads_match_jax(remat):
    """Logits and the gradient of every leaf of Σ w·logits, through the
    size-weighted merges, with and without per-block checkpointing."""
    cfg = small_cfg(tome_r=3, tome_schedule="decreasing", remat=remat)
    jp, tp = params_pair(cfg)
    x = images()
    w = np.random.default_rng(5).standard_normal((3, 5)).astype(np.float32)

    def jloss(p):
        lg = jvit.apply(p, jnp.asarray(x), jax_cfg(cfg), train=True)
        return jnp.sum(lg * w), lg

    (_, ref), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    got = tvit.apply(tp, torch.from_numpy(x), cfg, train=True)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=F32_TOL)
    assert_trees_close(bridge.grads_to_numpy(tp), grads, rtol=GRAD_RTOL)


def test_apply_dispatch_and_eval_consistency():
    """``vit.apply`` with ``tome_r`` runs the merged forward: eval equals
    the serving forward (the model evaluated is the model trained) and the
    reference's ``vit.apply``; ``return_features`` keeps the full-token
    forward, as there; merging does merge."""
    cfg = small_cfg(tome_r=4)
    jp, tp = params_pair(cfg)
    x = images(4)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        got = tvit.apply(tp, tx, cfg, train=False)
        serving = ttf.apply_tome(tp, tx, cfg, 4)
        plain = tvit.apply(tp, tx, dataclasses.replace(cfg, tome_r=0))
        feats = tvit.apply(tp, tx, cfg, return_features=True)[0]
    ref = jax.jit(lambda p, a: jvit.apply(p, a, jax_cfg(cfg)))(
        jp, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), serving.numpy(), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F32_TOL)
    np.testing.assert_array_equal(feats.numpy(), plain.numpy())
    assert float((plain - got).abs().max()) > 1e-4


def test_apply_tome_train_refuses_what_the_reference_refuses():
    cfg = small_cfg(tome_r=2)
    _, tp = params_pair(cfg)
    x = torch.from_numpy(images(1))
    with pytest.raises(ValueError, match="positive"):
        ttf.apply_tome_train(tp, x, cfg, 0)
    with pytest.raises(ValueError, match="fused_qkv"):
        tvit.apply(tp, x, dataclasses.replace(cfg, fused_qkv=True))
    # the int8 straight-through forward composes with merging: it builds
    # and runs (tests/test_torch_int8_train.py holds it to the reference)
    logits = ttf.apply_tome_train(tp, x, cfg, 2, int8_scales=(
        tq.calibrate_vit_scales(tp, x, cfg)))
    assert logits.shape == (1, 5) and bool(torch.isfinite(logits).all())
    # the selective policies are ported (tests/test_torch_remat.py): the
    # merged forward runs under one, with the forward's logits
    with torch.no_grad():
        plain = tvit.apply(tp, x, cfg)
    torch.testing.assert_close(
        tvit.apply(tp, x, dataclasses.replace(cfg, remat=True,
                                              remat_policy="mlp"),
                   train=True).detach(), plain, atol=0, rtol=0)
    with pytest.raises(ValueError, match="remat_policy"):
        tvit.apply(tp, x, dataclasses.replace(cfg, remat=True,
                                              remat_policy="mlp_hidden"),
                   train=True)
    with pytest.raises(ValueError, match="seed triples"):
        tvit.apply(tp, x, cfg, train=True, dropout_seeds=[(1, 2, 3)])


# ---------------------------------------------------------------------------
# The train and eval steps
# ---------------------------------------------------------------------------

def _batches(n, b=4, seed=0):
    rng = np.random.default_rng(seed)
    return [{"pixel_values": rng.standard_normal((b, 32, 32, 3))
             .astype(np.float32),
             "labels": (rng.random((b, 5)) < 0.3).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.parametrize("remat,dropout", [(False, 0.0), (True, 0.0),
                                           (True, 0.2)])
def test_tome_train_steps_match_jax(remat, dropout):
    """Three steps of ``make_train_step`` on a merging model: loss,
    grad_norm and lr per step, then the weights and AdamW moments. With
    attention dropout the JAX step's per-layer attention seeds are
    injected (the counter-hash mask at each layer's own length)."""
    cfg = step_cfg(tome_r=3, tome_schedule="decreasing", remat=remat,
                   attention_dropout=dropout)
    jp, tp = params_pair(cfg.model)
    jstep = jax.jit(jsteps.make_train_step(jax_cfg(cfg), 100))
    tstep = tsteps.make_train_step(cfg, 100)
    jstate = jsteps.TrainState.create(jp, seed=0)
    tstate = tsteps.TrainState.create(tp, seed=0)
    for batch in _batches(3):
        draws = (jax_attention_seeds(jstate.rng, cfg) if dropout else
                 [tsteps.Draws()])
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, draws)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert tstate.step == int(jstate.step) == 3
    got = bridge.opt_state_to_numpy(tstate.opt_state)
    for moment in ("mu", "nu"):
        assert_trees_close(got[moment], jstate.opt_state[moment],
                           rtol=GRAD_RTOL)
    assert_trees_close(bridge.params_to_numpy(tstate.params), jstate.params,
                       rtol=GRAD_RTOL)


@pytest.mark.parametrize("mode", [None, "dynamic", "static"])
def test_inference_eval_step_tome_matches_jax(mode):
    """``make_inference_eval_step(tome_r=2)``: dense, and int8 trees (the
    port's static tree on the fused route, JAX's on its plain one)."""
    cfg = Config(model=small_cfg(tome_schedule="decreasing"))
    jp, tp = params_pair(cfg.model)
    batch = _batches(1)[0]
    params = tp
    tol = F32_TOL
    if mode is not None:
        scales = (jq.calibrate_vit_scales(jp, jnp.asarray(images(seed=9)),
                                          jax_cfg(cfg.model))
                  if mode == "static" else None)
        jp = jq.quantize_vit_params(jp, scales)
        params = bridge.qparams_from_jax(jax.tree.map(np.asarray, jp),
                                         cfg.model)
        tol = INT8_TOL[("pallas" if mode == "static" else "xla", "float32")]
    jl, jr = jax.jit(jsteps.make_inference_eval_step(
        jax_cfg(cfg), quantized=mode is not None, tome_r=2))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tr = tsteps.make_inference_eval_step(
        cfg, quantized=mode is not None, tome_r=2)(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tl.shape == (4, 5) and tr.shape == (4,)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=5 * tol)


# ---------------------------------------------------------------------------
# The Predictor and the server
# ---------------------------------------------------------------------------

def _grays(n=5, seed=3):
    rng = np.random.default_rng(seed)
    shapes = [(48, 64), (64, 40), (64, 64), (30, 30), (80, 70)]
    return [rng.integers(0, 256, shapes[i % 5], np.uint8) for i in range(n)]


@pytest.mark.parametrize("quantize", [False, "static", "dynamic"])
def test_predictor_tome_matches_jax(quantize):
    """``Predictor(tome_r=1)`` for each ``quantize``, against the JAX
    Predictor on the same images (f32; static trees on the port's fused
    route, the JAX package's plain one)."""
    cfg = small_cfg(impl="xla")
    jp, tp = params_pair(cfg, seed=2)
    calib = _grays(4, seed=7) if quantize == "static" else None
    kw = dict(batch_size=4, canvas_size=64, placement="device",
              quantize=quantize, calibration=calib, tome_r=1,
              tome_schedule="constant")
    ref = JaxPredictor(jp, jax_cfg(cfg), **kw).predict_arrays(_grays())
    pred = Predictor(tp, cfg, device="cpu", **kw)
    out = pred.predict_arrays(_grays())
    # int8: tests/test_torch_quant.py's Predictor bound. The two packages'
    # preprocessing rounds apart, and an activation that lands that close
    # to an int8 step boundary quantizes one step apart (2e-3 in a logit,
    # merged or not)
    tol = F32_TOL if not quantize else INT8_TOL[("pallas", "float32")]
    assert out.probs.shape == (5, 5) and pred.forwards == 2
    np.testing.assert_allclose(out.logits, ref.logits, atol=tol)


def test_predictor_small_batch_note(capsys):
    """As the JAX Predictor: merging or int8 below batch 16 prints a note
    on stderr; plain bf16 at a small batch and the stack at batch 32 do
    not. A bad schedule is refused when the Predictor is built."""
    cfg = small_cfg()
    _, tp = params_pair(cfg)
    Predictor(tp, cfg, device="cpu", batch_size=8, tome_r=2)
    assert "SLOWER" in capsys.readouterr().err
    Predictor(tp, cfg, device="cpu", batch_size=8)
    assert "SLOWER" not in capsys.readouterr().err
    Predictor(tp, cfg, device="cpu", batch_size=32, tome_r=2)
    assert "SLOWER" not in capsys.readouterr().err
    with pytest.raises(ValueError, match="schedule"):
        Predictor(tp, cfg, device="cpu", tome_r=2, tome_schedule="linear")


def _stack(ns):
    return ns.batch_size, ns.quantize, ns.tome_r, ns.tome_schedule


def test_server_presets_and_auto_accel_follow_jax():
    """``SERVE_PRESETS`` and ``auto_accel_config`` equal the JAX server's;
    explicit flags win over the preset; ``--auto-accel`` picks by batch
    size and refuses an explicit stack flag."""
    assert server.SERVE_PRESETS == jserver.SERVE_PRESETS
    for b in range(1, 65):
        assert server.auto_accel_config(b) == jserver.auto_accel_config(b)
    parse = server.parse_args
    assert _stack(parse([])) == (8, None, 0, "constant")
    assert _stack(parse(["--preset", "fast_serve"])) == (
        32, "static", 16, "decreasing")
    assert _stack(parse(["--preset", "fast_serve", "--tome-r", "0",
                         "--batch-size", "64"])) == (
        64, "static", 0, "decreasing")
    assert _stack(parse(["--auto-accel"])) == (8, None, 0, "constant")
    assert _stack(parse(["--auto-accel", "--batch-size", "32"])) == (
        32, "static", 16, "decreasing")
    for extra in (["--tome-r", "4"], ["--quantize", "static"],
                  ["--tome-schedule", "constant"],
                  ["--preset", "fast_serve"]):
        with pytest.raises(SystemExit):
            parse(["--auto-accel", *extra])
