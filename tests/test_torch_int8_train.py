"""The port's int8 straight-through training forward
(``models/int8_train.py``, ``make_train_step(int8_scales=)``, the int8 ×
token-merging forward) against the JAX package's, on the CPU.

Both sides take the same weights (drawn by the JAX package's
``init_params`` and bridged), the same numpy-seeded images and the same
activation scales (the JAX package's calibration, as numpy leaves). The
JAX side runs as tests/test_int8_train.py runs it (``attention_impl="xla"``;
``"pallas"``, interpreted, where attention dropout must draw the same
mask); the port runs its plain kernel twins, which is what its wrappers do
for CPU tensors, and its int8 product's plain version, which equals
``ops.quant.int8_matmul_static`` bit for bit.

Tolerances, each with its reason:

- the op: forward exact (the same integer sums and f32 epilogue);
  backward rtol 1e-5 against the dense linear's gradients, as the
  reference's own test;
- logits: 1e-4 in f32, 2e-2 in bf16, the bounds of tests/test_torch_quant.py
  (LayerNorm and attention sum in another order, and an activation on a
  rounding boundary quantizes one int8 step apart; in bf16 the two CPU
  backends also round the bf16 products and epilogues at other points);
- gradients against JAX's in f32: 1e-4 of the largest gradient of the tree,
  as tests/test_torch_packed.py holds the dense ones: the backward is the
  dense linear's at the forward's point, which agrees to the logits' bound;
- gradients against the dense forward's: cosine above 0.95 per leaf (the
  reference's bound: quantization moves the point the gradient is taken
  at);
- remat: bit for bit against no remat, under every policy (the recompute
  runs the same kernels on the same inputs);
- train-step losses: rtol 5e-4, as tests/test_torch_trainer.py holds the
  trajectories, over six steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chestxray_vit_tpu import config as jconfig
from chestxray_vit_tpu.models import int8_train as ji8
from chestxray_vit_tpu.models import quantized as jq
from chestxray_vit_tpu.models import tome_forward as jtf
from chestxray_vit_tpu.models import vit as jvit
from chestxray_vit_tpu.train import steps as jsteps
from chestxray_vit_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                            TrainConfig)
from chestxray_vit_tpu_torch.models import bridge
from chestxray_vit_tpu_torch.models import int8_train as ti8
from chestxray_vit_tpu_torch.models import quantized as tq
from chestxray_vit_tpu_torch.models import tome_forward as ttf
from chestxray_vit_tpu_torch.models import vit as tvit
from chestxray_vit_tpu_torch.ops import quant as tquant
from chestxray_vit_tpu_torch.train import steps as tsteps

from test_torch_dropout import _jax_draws
from test_torch_packed import assert_trees_close, jax_cfg

torch.backends.cuda.matmul.allow_tf32 = False

LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
GRAD_RTOL = 1e-4
MIN_COS = 0.95
LOSS_RTOL = 5e-4
STEPS = 6
POLICIES = ("full", "mlp", "attn", "attn_mlp", "flash_out", "dots")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg(dtype="float32", **kw):
    """tests/test_int8_train.py's model: img 64, patch 16 (17 tokens),
    width 64, 4 heads, MLP 128, 3 layers, 5 classes."""
    base = dict(img_size=64, patch_size=16, hidden_size=64, num_layers=3,
                num_heads=4, mlp_dim=128, num_classes=5, dtype=dtype,
                attention_impl="xla")
    return ModelConfig(**{**base, **kw})


def step_cfg(accum=1, **model):
    return Config(model=small_cfg(**model),
                  train=TrainConfig(learning_rate=2e-3, warmup_steps=1,
                                    gradient_accumulation_steps=accum))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# the model at widths off 8 and 64: hidden 50 in two heads of 25, MLP 100
# (the int8 products' N = 50, 100 and K = 50, 100, padded to 64, 128)
OFF8 = dict(hidden_size=50, num_heads=2, mlp_dim=100)


@pytest.fixture(scope="module")
def setup():
    """(JAX params, port params, images [4, 64, 64, 3], the JAX package's
    calibrated scales as numpy leaves)."""
    return _setup(small_cfg())


def _setup(cfg):
    jp = jvit.init_params(jax.random.key(0), jax_cfg(cfg))
    tp = bridge.params_from_jax(_np(jp), cfg)
    imgs = (np.random.default_rng(0).standard_normal((4, 64, 64, 3)) * 0.5
            ).astype(np.float32)
    scales = _np(jq.calibrate_vit_scales(jp, jnp.asarray(imgs),
                                         jax_cfg(cfg)))
    return jp, tp, imgs, scales


def fresh(tp):
    """A copy of the port's params with no gradients."""
    return bridge.params_from_jax(bridge.params_to_numpy(tp), tp.cfg)


def labels(n=4, seed=3):
    return (np.random.default_rng(seed).random((n, 5)) < 0.3).astype(
        np.float32)


def _cos(a, b) -> float:
    a, b = np.ravel(a), np.ravel(b)
    return float(a @ b / (max(np.linalg.norm(a), 1e-12) * np.linalg.norm(b)))


def assert_cosine(got, ref):
    """Per leaf, cosine above MIN_COS; leaves whose gradient is zero on
    both sides (the key bias cancels in softmax) are skipped, as in the
    reference's test."""
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    for (path, b), a in zip(flat, jax.tree.leaves(got)):
        if np.linalg.norm(b) < 1e-8 and np.linalg.norm(a) < 1e-8:
            continue
        assert _cos(a, b) > MIN_COS, (jax.tree_util.keystr(path), _cos(a, b))


# ---------------------------------------------------------------------------
# The straight-through op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ste_op_forward_matches_jax_and_static_matmul(dtype):
    """Forward: the JAX op's output, and the port's int8_matmul_static on
    the weight quantized from the same (here bf16-rounded) values."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    w = rng.standard_normal((32, 16)).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    xs = np.float32(np.abs(x).max() / 100.0)      # a few values saturate
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    tx, tw = (torch.tensor(np.asarray(a.astype(jnp.float32))).to(tdt)
              for a in (jx, jw))
    ref = ji8.int8_linear_ste(jx, jw, jnp.asarray(b), xs, out_dtype=jdt)
    got = ti8.int8_linear_ste(tx, tw, torch.from_numpy(b), xs, tdt)
    static = tquant.int8_matmul_static(tx, tquant.quantize_weight(tw), xs,
                                       torch.from_numpy(b), out_dtype=tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    torch.testing.assert_close(got, static, atol=0, rtol=0)
    # a shared quantize gives the same product
    xq = tquant.quantize_static(tx, torch.tensor(xs))
    torch.testing.assert_close(
        ti8.int8_linear_ste(tx, tw, torch.from_numpy(b), xs, tdt, xq=xq),
        got, atol=0, rtol=0)


def test_ste_op_backward_is_dense_linear():
    """The three gradients are the dense linear's (rtol 1e-5, the
    reference's bound) and the JAX op's, including batched x; the scale
    gets none."""
    rng = np.random.default_rng(2)
    x, w = rng.standard_normal((2, 7, 32)), rng.standard_normal((32, 16))
    b, g = rng.standard_normal(16), rng.standard_normal((2, 7, 16))
    x, w, b, g = (a.astype(np.float32) for a in (x, w, b, g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    scale = torch.tensor(0.02, requires_grad=True)
    (ti8.int8_linear_ste(*leaves, scale, torch.float32)
     * torch.from_numpy(g)).sum().backward()
    dense = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    ((dense[0] @ dense[1] + dense[2]) * torch.from_numpy(g)).sum().backward()
    jgrads = jax.grad(lambda x, w, b: jnp.sum(ji8.int8_linear_ste(
        x, w, b, jnp.float32(0.02), out_dtype=jnp.float32) * g),
        argnums=(0, 1, 2))(x, w, b)
    for got, want, jwant in zip(leaves, dense, jgrads):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(jwant),
                                   rtol=1e-5, atol=1e-5)
    assert scale.grad is None


@pytest.mark.parametrize("t", [2, 4])
def test_row_partials_are_int32_and_sum_to_the_whole_product(t):
    """``row_partial`` on each of t K slices (K = 3072, ``mlp_out``'s)
    returns int32, and the int32 partials sum to the exact whole product,
    odd and past 2²⁴ in row 0 where f32 partials would round."""
    rng = np.random.default_rng(t)
    xq = rng.integers(-127, 128, (3, 3072)).astype(np.int8)
    wq = rng.integers(-127, 128, (8, 3072)).astype(np.int8)
    xq[0], wq[0] = 127, 127
    wq[0, ::1000] = 126
    n = 3072 // t
    parts = [ti8.row_partial(torch.from_numpy(xq[:, i * n:(i + 1) * n]
                                              .copy()),
                             torch.from_numpy(wq[:, i * n:(i + 1) * n]
                                              .copy()))
             for i in range(t)]
    assert all(p.dtype == torch.int32 for p in parts)
    exact = xq.astype(np.int64) @ wq.T.astype(np.int64)
    np.testing.assert_array_equal(sum(parts).numpy(), exact)
    assert exact[0, 0] == 3072 * 127 ** 2 - 4 * 127


def test_row_ste_on_an_axis_of_one_equals_the_linear_ste():
    """``int8_row_linear_ste`` on a tensor axis of one (its all-reduces
    the identity) equals ``int8_linear_ste`` bit for bit in f32 and bf16,
    at K = 3072."""
    from chestxray_vit_tpu_torch.parallel.distributed import Axis
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 5, 3072))
                         .astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3072, 16)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    scale = float(x.abs().max()) / 127.0
    for dt in (torch.float32, torch.bfloat16):
        args = (x.to(dt), w.to(dt), b.to(dt), scale, dt)
        assert torch.equal(ti8.int8_row_linear_ste(*args, Axis()),
                           ti8.int8_linear_ste(*args))


def test_ste_op_gradients_keep_the_operands_dtypes():
    """bf16 x and kernel with an f32 bias and out_dtype bf16: dx and dW
    leave in bf16, db in f32 (the reference's casts), and a bf16 kernel
    cast from an f32 master passes its gradient on to the master."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32)
                         ).to(torch.bfloat16).requires_grad_()
    master = torch.from_numpy(rng.standard_normal((64, 8)).astype(
        np.float32)).requires_grad_()
    bias = torch.zeros(8, requires_grad=True)
    y = ti8.int8_linear_ste(x, master.to(torch.bfloat16), bias, 0.03)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16
    assert master.grad.dtype == torch.float32 and bias.grad.dtype == \
        torch.float32
    np.testing.assert_array_equal(bias.grad.numpy(), np.full(8, 5.0))


# ---------------------------------------------------------------------------
# apply_int8_train
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(setup, dtype):
    """Eval-mode logits against the JAX forward's (LOGIT_TOL); in f32 also
    equal to the port's static serving forward on a tree of the same
    weights and scales, to 1e-5 (the reference's own pin)."""
    jp, tp, imgs, scales = setup
    cfg = small_cfg(dtype)
    with torch.no_grad():
        got = ti8.apply_int8_train(tp, torch.from_numpy(imgs), cfg, scales,
                                   train=False)
    ref = ji8.apply_int8_train(jp, jnp.asarray(imgs), jax_cfg(cfg),
                               scales, train=False)
    assert got.dtype == torch.float32 and got.shape == (4, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=LOGIT_TOL[dtype])
    if dtype == "float32":
        with torch.no_grad():
            qp = tq.quantize_vit_params(tp, scales)
            for backend in ("xla", "pallas"):
                np.testing.assert_allclose(
                    got.numpy(), tq.apply_quantized(
                        qp, torch.from_numpy(imgs), cfg, backend).numpy(),
                    atol=1e-5)


def test_forward_differs_from_dense_and_ignores_fused_qkv(setup):
    _, tp, imgs, scales = setup
    cfg = small_cfg()
    x = torch.from_numpy(imgs)
    with torch.no_grad():
        got = ti8.apply_int8_train(tp, x, cfg, scales, train=False)
        fused = ti8.apply_int8_train(tp, x, dataclasses.replace(
            cfg, fused_qkv=True), scales, train=False)
        dense = tvit.apply(tp, x, cfg)
    torch.testing.assert_close(fused, got, atol=0, rtol=0)
    assert 0 < float((got - dense).abs().max()) < 0.1


def _bce(logits, y):
    return tsteps.bce_with_logits(logits, torch.from_numpy(y))


def _jbce(logits, y):
    return jsteps.bce_with_logits(logits, jnp.asarray(y))


def port_grads(tp, fwd):
    """The port's gradients of ``fwd(params)`` (a loss), by JAX path."""
    p = fresh(tp)
    fwd(p).backward()
    return bridge.grads_to_numpy(p)


def test_gradients_match_jax_and_track_the_dense_step(setup):
    """f32 gradients of the BCE loss through the training forward against
    JAX's (GRAD_RTOL), and against the dense forward's gradients: cosine
    above MIN_COS per leaf, as the reference pins its own."""
    jp, tp, imgs, scales = setup
    cfg, y, x = small_cfg(), labels(), torch.from_numpy(imgs)
    got = port_grads(tp, lambda p: _bce(ti8.apply_int8_train(
        p, x, cfg, scales), y))
    ref = jax.jit(jax.grad(lambda p: _jbce(ji8.apply_int8_train(
        p, jnp.asarray(imgs), jax_cfg(cfg), scales, train=True), y)))(jp)
    assert_trees_close(got, ref, GRAD_RTOL)
    dense = port_grads(tp, lambda p: _bce(tvit.apply(p, x, cfg, train=True),
                                          y))
    assert_cosine(got, dense)


def _seeds(cfg, base=7):
    return [(base + 3 * i, base + 3 * i + 1, base + 3 * i + 2)
            for i in range(cfg.num_layers)]


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_grads_exact(setup, policy):
    """Every remat policy gives the gradients of the forward without
    remat bit for bit, with attention and hidden dropout on (a recomputed
    block redraws the same masks)."""
    _, tp, imgs, scales = setup
    cfg = small_cfg(attention_dropout=0.2, hidden_dropout=0.2)
    x, seeds = torch.from_numpy(imgs), _seeds(cfg)

    def loss(c):
        return lambda p: (ti8.apply_int8_train(
            p, x, c, scales, dropout_seeds=seeds) ** 2).sum()

    plain = port_grads(tp, loss(cfg))
    rematted = port_grads(tp, loss(dataclasses.replace(
        cfg, remat=True, remat_policy=policy)))
    for a, b in zip(jax.tree.leaves(plain), jax.tree.leaves(rematted)):
        np.testing.assert_array_equal(a, b)


def test_dropout_is_seeded_and_off_in_eval(setup):
    _, tp, imgs, scales = setup
    cfg = small_cfg(attention_dropout=0.2, hidden_dropout=0.2)
    x = torch.from_numpy(imgs)
    with torch.no_grad():
        off = ti8.apply_int8_train(tp, x, small_cfg(), scales)
        same = [ti8.apply_int8_train(tp, x, cfg, scales,
                                     dropout_seeds=_seeds(cfg))
                for _ in range(2)]
        other = ti8.apply_int8_train(tp, x, cfg, scales,
                                     dropout_seeds=_seeds(cfg, 8))
        unseeded = ti8.apply_int8_train(tp, x, cfg, scales)
    torch.testing.assert_close(same[0], same[1], atol=0, rtol=0)
    torch.testing.assert_close(unseeded, off, atol=0, rtol=0)
    assert float((same[0] - other).abs().max()) > 1e-4
    assert float((same[0] - off).abs().max()) > 1e-4
    with pytest.raises(ValueError, match="seed triples"):
        ti8.apply_int8_train(tp, x, cfg, scales, dropout_seeds=[(1, 2, 3)])


def test_scales_are_placed_once(setup):
    """numpy leaves, CPU tensors and a placed tree give the same forward;
    placing a placed tree keeps its tensors."""
    _, tp, imgs, scales = setup
    x = torch.from_numpy(imgs)
    placed = ti8.place_scales(scales, x.device)
    assert ti8.place_scales(placed, x.device)["patch"] is placed["patch"]
    assert placed["blocks"]["mlp_mid"].shape == (3,)
    as_torch = {"patch": torch.tensor(scales["patch"]),
                "blocks": {k: torch.from_numpy(v)
                           for k, v in scales["blocks"].items()}}
    with torch.no_grad():
        outs = [ti8.apply_int8_train(tp, x, small_cfg(), s, train=False)
                for s in (scales, as_torch, placed)]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], atol=0, rtol=0)


# ---------------------------------------------------------------------------
# make_train_step(int8_scales=)
# ---------------------------------------------------------------------------

def _jax_step_losses(jp, cfg, batch, scales, steps=STEPS):
    step = jax.jit(jsteps.make_train_step(jax_cfg(cfg), 100,
                                          int8_scales=scales))
    state = jsteps.TrainState.create(jax.tree.map(jnp.array, jp), seed=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for _ in range(steps):
        state, m = step(state, jb)
        losses.append(float(m["loss"]))
    return losses


def _port_step_losses(tp, cfg, batch, scales, steps=STEPS, draws=None):
    step = tsteps.make_train_step(cfg, 100, int8_scales=scales)
    state = tsteps.TrainState.create(fresh(tp), seed=0)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = []
    for i in range(steps):
        state, m = step(state, tb, draws(i) if draws else None)
        losses.append(float(m["loss"]))
    return losses


def _batch(imgs, n=8):
    return {"pixel_values": np.concatenate([imgs, imgs])[:n],
            "labels": labels(n, 5)}


@pytest.mark.parametrize("accum,widths", [
    pytest.param(1, {}, id="1"), pytest.param(2, {}, id="2"),
    pytest.param(1, OFF8, id="off8")])
def test_train_step_matches_jax(setup, accum, widths):
    """Six steps of make_train_step(int8_scales=) on a fixed batch: losses
    against the JAX step's (LOSS_RTOL), finite and falling; with gradient
    accumulation the micro-batches split as there; at OFF8's widths the
    int8 products pad K and write N off 8."""
    cfg = step_cfg(accum, **widths)
    jp, tp, imgs, scales = _setup(cfg.model) if widths else setup
    batch = _batch(imgs)
    got = _port_step_losses(tp, cfg, batch, scales)
    ref = _jax_step_losses(jp, cfg, batch, scales)
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    assert all(np.isfinite(got)) and got[-1] < got[0]


def test_train_step_with_attention_dropout_and_mixup_matches_jax():
    """Attention dropout 0.3 and mixup 0.2 with the JAX step's draws
    injected (the attention mask is the counter hash on both sides, the
    JAX kernel interpreted; hidden dropout draws from another generator on
    each side and stays off): two steps' losses within LOSS_RTOL."""
    jcfg = jconfig.Config(
        model=jconfig.ModelConfig(
            img_size=32, patch_size=8, hidden_size=128, num_layers=2,
            num_heads=2, mlp_dim=256, num_classes=5, dtype="float32",
            attention_impl="pallas", attention_dropout=0.3),
        data=jconfig.DataConfig(mixup_alpha=0.2),
        train=jconfig.TrainConfig(warmup_steps=1, learning_rate=2e-3))
    cfg = Config(model=ModelConfig(**dataclasses.asdict(jcfg.model)),
                 data=DataConfig(mixup_alpha=0.2),
                 train=TrainConfig(warmup_steps=1, learning_rate=2e-3))
    jp = jvit.init_params(jax.random.key(1), jcfg.model)
    tp = bridge.params_from_jax(_np(jp), cfg.model)
    rng = np.random.default_rng(6)
    batch = {"pixel_values": rng.standard_normal((4, 32, 32, 3)).astype(
        np.float32), "labels": labels(4, 7)}
    scales = _np(jq.calibrate_vit_scales(
        jp, jnp.asarray(batch["pixel_values"]), jcfg.model))
    jstep = jax.jit(jsteps.make_train_step(jcfg, 10, int8_scales=scales))
    tstep = tsteps.make_train_step(cfg, 10, int8_scales=scales)
    jstate = jsteps.TrainState.create(jp, seed=0)
    tstate = tsteps.TrainState.create(tp, seed=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(2):
        draws = _jax_draws(jstate.rng, jcfg, 4)
        assert draws[0].seeds and draws[0].lam is not None
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb, draws)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)


# ---------------------------------------------------------------------------
# int8 × token merging
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["constant", "decreasing"])
def test_tome_int8_forward_matches_jax_and_serving(setup, schedule):
    """The composed forward in eval mode against JAX's
    ``apply_tome_train(int8_scales=)`` (LOGIT_TOL) and, to 1e-5, against
    the port's int8 merged serving forward on a static tree of the same
    weights and scales (the reference's pin)."""
    jp, tp, imgs, scales = setup
    cfg = small_cfg()
    x = torch.from_numpy(imgs)
    with torch.no_grad():
        got = ttf.apply_tome_train(tp, x, cfg, 2, train=False,
                                   schedule=schedule, int8_scales=scales)
        serving = ttf.apply_tome(tq.quantize_vit_params(tp, scales), x, cfg,
                                 2, quantized=True, schedule=schedule)
        unmerged = ti8.apply_int8_train(tp, x, cfg, scales, train=False)
    ref = jax.jit(lambda p, a: jtf.apply_tome_train(
        p, a, jax_cfg(cfg), 2, train=False, schedule=schedule,
        int8_scales=scales))(jp, jnp.asarray(imgs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=LOGIT_TOL["float32"])
    np.testing.assert_allclose(got.numpy(), serving.numpy(), atol=1e-5)
    assert float((got - unmerged).abs().max()) > 1e-4


def test_tome_int8_gradients_match_jax_and_track_dense_tome(setup):
    """Composed-path f32 gradients against JAX's (GRAD_RTOL), under full
    remat too, and cosine above MIN_COS against the dense merged forward's
    gradients (the merge routing is shared)."""
    jp, tp, imgs, scales = setup
    cfg, y, x = small_cfg(), labels(4, 7), torch.from_numpy(imgs)
    ref = jax.jit(jax.grad(lambda p: _jbce(jtf.apply_tome_train(
        p, jnp.asarray(imgs), jax_cfg(cfg), 2, train=True,
        int8_scales=scales), y)))(jp)
    for c in (cfg, dataclasses.replace(cfg, remat=True)):
        got = port_grads(tp, lambda p: _bce(ttf.apply_tome_train(
            p, x, c, 2, int8_scales=scales), y))
        assert_trees_close(got, ref, GRAD_RTOL)
    dense = port_grads(tp, lambda p: _bce(ttf.apply_tome_train(p, x, cfg, 2),
                                          y))
    assert_cosine(got, dense)


def test_train_step_int8_scales_respects_tome_r(setup):
    """With ``model.tome_r`` the int8 step runs the composed forward: its
    first loss is the composed forward's, not the unmerged int8 one's, and
    six losses follow the JAX step's (LOSS_RTOL) and fall."""
    jp, tp, imgs, scales = setup
    cfg = step_cfg(tome_r=2, tome_schedule="decreasing")
    batch = _batch(imgs)
    x = torch.from_numpy(batch["pixel_values"])
    with torch.no_grad():
        composed = float(_bce(ttf.apply_tome_train(
            tp, x, cfg.model, 2, schedule="decreasing", int8_scales=scales),
            batch["labels"]))
        unmerged = float(_bce(ti8.apply_int8_train(tp, x, cfg.model, scales),
                              batch["labels"]))
    got = _port_step_losses(tp, cfg, batch, scales)
    assert got[0] == composed and got[0] != unmerged
    ref = _jax_step_losses(jp, cfg, batch, scales)
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    assert all(np.isfinite(got)) and got[-1] < got[0]
