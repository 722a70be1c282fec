"""The port's attention dropout, hidden dropout and mixup against the JAX
package's, on the CPU.

Inputs come from numpy seeds and go to both sides. The JAX side runs its
dropout kernels interpreted (``attention_impl="pallas"``), as
tests/test_flash_dropout.py does; the port runs the plain versions, which
is what its wrappers do for CPU tensors. The attention mask is a counter
hash of the element index and the seed on both sides, so it is compared
bit for bit, and the port's train step is given the seeds and mixup λ that
the JAX step derives from its key. Hidden dropout draws from
``jax.random`` there and from a torch generator here, so it is held to its
statistics and to replaying under remat instead.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chestxray_vit_tpu.config import Config, DataConfig, ModelConfig, \
    TrainConfig
from chestxray_vit_tpu.models import vit as jvit
from chestxray_vit_tpu.ops import flash_attention as jfa
from chestxray_vit_tpu.train import steps as jsteps
from chestxray_vit_tpu_torch import config as tconfig
from chestxray_vit_tpu_torch.models import bridge
from chestxray_vit_tpu_torch.models import vit as tvit
from chestxray_vit_tpu_torch.ops import flash_attention as tfa
from chestxray_vit_tpu_torch.train import steps as tsteps

torch.backends.cuda.matmul.allow_tf32 = False

RATE, SEED = 0.3, 12345
_TORCH = {np.float32: torch.float32, "bfloat16": torch.bfloat16}
_JAX = {np.float32: jnp.float32, "bfloat16": jnp.bfloat16}
# f32: summation order only; bf16: P and dS round at other points than in
# the interpreted TPU kernel (the bound of tests/test_flash_attention.py)
_TOL = {np.float32: 1e-5, "bfloat16": 3e-2}


def _pair(arr, dtype):
    j = jnp.asarray(arr, _JAX[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(_TORCH[dtype])
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_scaled(got, ref, tol):
    """|got − ref| ≤ tol · max(1, max |ref|)."""
    got, ref = _np(got), _np(ref)
    bound = tol * max(1.0, float(np.abs(ref).max()))
    assert np.abs(got - ref).max() <= bound, (np.abs(got - ref).max(), bound)


def _qkv(seed, dtype=np.float32, shape=(2, 3, 77, 64)):
    rng = np.random.default_rng(seed)
    return [_pair(rng.standard_normal(shape).astype(np.float32), dtype)
            for _ in range(3)]


def _port(cfg: Config) -> tconfig.Config:
    """The port's config with the JAX config's fields."""
    return tconfig.Config(**{
        f.name: getattr(tconfig, type(getattr(cfg, f.name)).__name__)(
            **dataclasses.asdict(getattr(cfg, f.name)))
        for f in dataclasses.fields(cfg)})


# ---------------------------------------------------------------------------
# The keep mask and the dropout attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_q,seed", [
    (128, SEED), (32, SEED), (128, -SEED), (32, -2 ** 31)],
    ids=["single-block", "multi-block", "negative-seed",
         "int32-min-multi-block"])
def test_keep_mask_equals_jax_debug_mask(block_q, seed):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(0)
    b, h, s, _ = tq.shape
    _, jkeep = jfa.flash_attention_dropout_debug(
        jq, jk, jv, jnp.asarray([seed], jnp.int32), RATE, None, block_q)
    jkeep = np.asarray(jkeep) > 0.5
    q_pad, s_pad = tfa.mask_strides(s, block_q)
    assert (q_pad, s_pad) == (jfa._q_blocking(s, block_q)[0],
                              jfa._pad_len(s, 128))
    keep = tfa.keep_mask(b * h, q_pad, s_pad, seed, RATE)
    assert keep.shape == (b * h, q_pad, s_pad) and keep.dtype == torch.bool
    np.testing.assert_array_equal(
        keep[:, :s, :s].reshape(b, h, s, s).numpy(), jkeep)
    # the debug wrapper's plain path returns the same mask
    _, tkeep = tfa.flash_attention_dropout_debug(tq, tk, tv, seed, RATE,
                                                 block_q=block_q)
    np.testing.assert_array_equal(tkeep.numpy(), jkeep)
    assert abs(jkeep.mean() - (1 - RATE)) < 0.02


def test_mask_strides_at_vit_b16():
    """S = 577 with the automatic Q block (640): one block, rows padded to
    16 (592), keys to 128 (640); a 128-row block pads rows to 640."""
    assert tfa.auto_block_q(577) == jfa.auto_block_q(577) == 640
    assert tfa.mask_strides(577, 640) == (592, 640)
    assert tfa.mask_strides(577, 128) == (640, 640)
    assert tfa.auto_block_q(1025) == jfa.auto_block_q(1025)


def test_dropout_constants_wrap_like_uint32():
    for seed in (0, 1, -1, 12345, -2 ** 31, 2 ** 31 - 1):
        mix, thr = tfa.dropout_constants(seed, RATE)
        with np.errstate(over="ignore"):       # uint32 wraps, as on the TPU
            want = np.int32(seed).view(np.uint32) * np.uint32(0x9E3779B9)
        assert mix == int(want)
        assert thr == min(int(RATE * 2.0 ** 32), 2 ** 32 - 1)
    assert tfa.dropout_constants(5, 0.0)[1] == 0
    with pytest.raises(ValueError):
        tfa.dropout_constants(5, 1.0)


@pytest.mark.parametrize("block_q", [128, 32])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_dropout_forward_matches_jax(block_q, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, dtype)
    ref = jfa.flash_attention_dropout(jq, jk, jv, jnp.asarray([SEED],
                                                              jnp.int32),
                                      RATE, None, block_q)
    o, lse = tfa.attention_dropout_fwd_reference(tq, tk, tv, SEED, RATE,
                                                 block_q=block_q)
    assert o.dtype == tq.dtype and lse.dtype == torch.float32
    _close_scaled(o, ref, _TOL[dtype])
    # lse is the clean softmax's, as the dense forward writes it
    torch.testing.assert_close(lse, tfa.attention_fwd_reference(tq, tk,
                                                                tv)[1])
    before = tfa.flash_attention_dropout_fwd.launches
    o2, _ = tfa.flash_attention_dropout_fwd(tq, tk, tv, SEED, RATE,
                                            block_q=block_q)
    torch.testing.assert_close(o2, o, atol=0, rtol=0)
    assert tfa.flash_attention_dropout_fwd.launches == before


# S = 65 and 129: one row past an edge of the CUDA kernels' 64-row tiles
# (the plain versions held here are those kernels' oracle on the card)
@pytest.mark.parametrize("block_q,s", [
    pytest.param(128, 77, id="128"), pytest.param(32, 77, id="32"),
    pytest.param(128, 65, id="128-S65"), pytest.param(32, 65, id="32-S65"),
    pytest.param(128, 129, id="128-S129"),
    pytest.param(32, 129, id="32-S129")])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_dropout_gradients_match_jax_grad(block_q, s, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, dtype, (2, 3, s, 64))
    do = np.random.default_rng(3).standard_normal(tq.shape).astype(
        np.float32)
    _, tdo = _pair(do, dtype)
    jdo = jnp.asarray(_np(tdo))
    seed = jnp.asarray([SEED], jnp.int32)

    def f(q, k, v):
        o = jfa.flash_attention_dropout(q, k, v, seed, RATE, None, block_q)
        return jnp.sum(o.astype(jnp.float32) * jdo)

    ref = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    tol = _TOL[dtype]

    o, lse = tfa.attention_dropout_fwd_reference(tq, tk, tv, SEED, RATE,
                                                 block_q=block_q)
    plain = tfa.attention_dropout_bwd_reference(tq, tk, tv, o, lse, tdo,
                                                SEED, RATE, block_q=block_q)
    wrapped = tfa.flash_attention_dropout_bwd(tq, tk, tv, o, lse, tdo, SEED,
                                              RATE, block_q=block_q)
    for got, again, r in zip(plain, wrapped, ref):
        assert got.dtype == tq.dtype
        torch.testing.assert_close(again, got, atol=0, rtol=0)
        _close_scaled(got, r, tol)

    # the dispatch (the autograd function on CPU tensors too) and the
    # autograd function (its plain wrappers on the CPU) give the same
    # gradients
    for run in (lambda q, k, v: tfa.flash_attention_dropout(
                    q, k, v, SEED, RATE, block_q=block_q),
                lambda q, k, v: tfa.FlashAttentionDropout.apply(
                    q, k, v, SEED, RATE, None, block_q)):
        leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
        (run(*leaves).float() * tdo.float()).sum().backward()
        for leaf, r in zip(leaves, ref):
            _close_scaled(leaf.grad, r, tol)


def test_dropout_seed_changes_the_mask_deterministically():
    (_, tq), (_, tk), (_, tv) = _qkv(4)
    a = tfa.flash_attention_dropout(tq, tk, tv, SEED, RATE)
    b = tfa.flash_attention_dropout(tq, tk, tv, SEED, RATE)
    c = tfa.flash_attention_dropout(tq, tk, tv, SEED + 1, RATE)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.allclose(a, c)
    # impl 'xla' keeps the counter-hash mask (the reference's XLA path
    # draws from jax.random instead)
    torch.testing.assert_close(tfa.attention_dropout(tq, tk, tv, SEED, RATE,
                                                     impl="xla"), a,
                               atol=0, rtol=0)


# ---------------------------------------------------------------------------
# Hidden dropout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.1, 0.3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hidden_dropout_keep_share_and_scale(rate, dtype):
    x = (torch.rand((16, 577, 128), generator=torch.Generator().manual_seed(
        0)) + 0.5).to(dtype)
    y = tvit._dropout(x, rate, 77)
    assert y.dtype == dtype and y.shape == x.shape
    kept = y != 0
    n = x.numel()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(kept.float().mean().item() - (1 - rate)) <= 4 * sigma
    # survivors are x / (1 − rate) in x's dtype, as the reference computes
    torch.testing.assert_close(y[kept], (x / (1 - rate))[kept], atol=0,
                               rtol=0)
    torch.testing.assert_close(tvit._dropout(x, rate, 77), y, atol=0,
                               rtol=0)
    assert not torch.equal(tvit._dropout(x, rate, 78), y)
    assert tvit._dropout(x, 0.0, 77) is x and tvit._dropout(x, rate, None) \
        is x


# ---------------------------------------------------------------------------
# The ViT train step
# ---------------------------------------------------------------------------

def tiny_cfg(accum=1, remat=False, mixup=0.0, **model):
    """img 32, patch 8, hidden 128, 2 heads of dim 64, MLP 256, 2 layers,
    15 classes, f32, the JAX side's kernels interpreted."""
    return Config(
        model=ModelConfig(img_size=32, patch_size=8, hidden_size=128,
                          num_layers=2, num_heads=2, mlp_dim=256,
                          num_classes=15, dtype="float32",
                          attention_impl="pallas", remat=remat, **model),
        data=DataConfig(mixup_alpha=mixup),
        train=TrainConfig(gradient_accumulation_steps=accum,
                          warmup_steps=1))


def _params(cfg, seed=0):
    jp = jvit.init_params(jax.random.key(seed), cfg.model)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                      _port(cfg).model)


def _batch(b=4, seed=0):
    rng = np.random.default_rng(seed)
    return {"pixel_values": rng.standard_normal((b, 32, 32, 3))
            .astype(np.float32),
            "labels": (rng.random((b, 15)) < 0.2).astype(np.float32)}


def _jax_draws(state_rng, cfg, batch_size):
    """The draws of JAX's train step from ``state.rng``: the step key is
    split per micro-batch, each micro-batch's key per layer in the scan,
    and ``_dropout_seed(sub, 2)`` gives the attention seed; λ is
    Beta(α, α) from ``fold_in(key, 7)``. Returned as the port's Draws."""
    accum = max(cfg.train.gradient_accumulation_steps, 1)
    _, step_rng = jax.random.split(state_rng)
    keys = [step_rng] if accum == 1 else list(jax.random.split(step_rng,
                                                              accum))
    out = []
    for r in keys:
        d = tsteps.Draws()
        if cfg.model.attention_dropout > 0:
            key, d.seeds = r, []
            for _ in range(cfg.model.num_layers):
                key, sub = jax.random.split(key)
                d.seeds.append((int(jvit._dropout_seed(sub, 2)[0]), 0, 0))
        if cfg.data.mixup_alpha > 0:
            a = cfg.data.mixup_alpha
            d.lam = np.asarray(jax.random.beta(
                jax.random.fold_in(r, 7), a, a,
                (batch_size // accum, 1, 1, 1))).reshape(-1)
        out.append(d)
    return out


def _jax_grads(params, cfg, batch, draws_rng):
    """The gradient of JAX's loss for one micro-batch step (accum 1)."""
    def loss(p):
        logits = jvit.apply(p, batch["pixel_values"], cfg.model, train=True,
                            rng=draws_rng)
        return jsteps.bce_with_logits(logits, batch["labels"])
    return jax.jit(jax.grad(loss))(params)


def _assert_trees_close(got, ref, rtol):
    """Leaf by leaf within rtol of the largest |ref| over the tree."""
    ref_leaves = [np.asarray(a, np.float32) for a in jax.tree.leaves(ref)]
    scale = max(float(np.abs(a).max()) for a in ref_leaves)
    for g, r in zip(jax.tree.leaves(got), ref_leaves):
        assert float(np.abs(g - r).max()) <= rtol * scale


@pytest.mark.parametrize("remat", [False, True])
def test_attention_dropout_train_step_matches_jax(remat):
    """Two steps at attention_dropout 0.3 with the JAX step's seeds
    injected: loss, grad_norm and every gradient leaf."""
    cfg = tiny_cfg(remat=remat, attention_dropout=0.3)
    jp, tp = _params(cfg)
    jstep = jax.jit(jsteps.make_train_step(cfg, total_steps=10))
    tstep = tsteps.make_train_step(_port(cfg), total_steps=10)
    jstate = jsteps.TrainState.create(jp, seed=0)
    tstate = tsteps.TrainState.create(tp, seed=0)
    for i in range(2):
        batch = _batch(seed=i)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        draws = _jax_draws(jstate.rng, cfg, 4)
        grads = _jax_grads(jstate.params, cfg, jb,
                           jax.random.split(jstate.rng)[1])
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, draws)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        _assert_trees_close(bridge.grads_to_numpy(tstate.params), grads,
                            rtol=1e-4)
    # dropout was on: the seeds move the loss
    _, tp2 = _params(cfg)
    other = [tsteps.Draws(seeds=[(s + 1, 0, 0) for s, _, _ in
                                 _jax_draws(jax.random.key(0), cfg,
                                            4)[0].seeds])]
    _, m2 = tstep(tsteps.TrainState.create(tp2, 0), {
        k: torch.from_numpy(v) for k, v in _batch(seed=0).items()}, other)
    _, m1 = tstep(tsteps.TrainState.create(_params(cfg)[1], 0), {
        k: torch.from_numpy(v) for k, v in _batch(seed=0).items()},
        _jax_draws(jax.random.key(0), cfg, 4))
    assert float(m1["loss"]) != float(m2["loss"])


def test_dropout_replays_under_remat():
    """Attention and hidden dropout and mixup on: one step with and one
    without remat on the same weights, batch and draws give the same loss
    and gradients (each block's recompute draws the same masks)."""
    out = []
    for remat in (False, True):
        cfg = _port(tiny_cfg(remat=remat, mixup=0.2, attention_dropout=0.2,
                             hidden_dropout=0.2))
        _, tp = _params(tiny_cfg())
        draws = [tsteps.draw(torch.Generator().manual_seed(5), cfg, 4)]
        assert draws[0].seeds is not None and draws[0].lam is not None
        _, m = tsteps.make_train_step(cfg, 10)(
            tsteps.TrainState.create(tp, 0),
            {k: torch.from_numpy(v) for k, v in _batch().items()}, draws)
        out.append((m, bridge.grads_to_numpy(tp)))
    (m0, g0), (m1, g1) = out
    assert float(m0["loss"]) == float(m1["loss"])
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_array_equal(a, b)


def test_hidden_dropout_changes_the_step_and_is_seeded():
    cfg = _port(tiny_cfg(hidden_dropout=0.3))
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    losses = []
    for seed in (1, 1, 2):
        _, tp = _params(tiny_cfg())
        _, m = tsteps.make_train_step(cfg, 10)(
            tsteps.TrainState.create(tp, seed), batch)
        losses.append(float(m["loss"]))
    _, tp = _params(tiny_cfg())
    _, m = tsteps.make_train_step(_port(tiny_cfg()), 10)(
        tsteps.TrainState.create(tp, 1), batch)
    assert losses[0] == losses[1] != losses[2]
    assert float(m["loss"]) not in losses


# ---------------------------------------------------------------------------
# Mixup
# ---------------------------------------------------------------------------

def test_mixup_equals_jax_formula():
    rng = np.random.default_rng(0)
    images = rng.standard_normal((6, 32, 32, 3)).astype(np.float32)
    labels = (rng.random((6, 15)) < 0.3).astype(np.float32)
    lam = rng.beta(0.2, 0.2, 6).astype(np.float32)
    # chestxray_vit_tpu/train/steps.py, the mixup lines of loss_fn
    jl = jnp.asarray(lam).reshape(6, 1, 1, 1)
    want_i = jl * images + (1.0 - jl) * jnp.roll(images, 1, 0)
    lam_l = jl[:, :, 0, 0]
    want_l = (lam_l * labels + (1.0 - lam_l) * jnp.roll(labels, 1, 0))
    got_i, got_l = tsteps.mixup(torch.from_numpy(images),
                                torch.from_numpy(labels), lam)
    assert got_i.dtype == torch.float32 and got_l.dtype == torch.float32
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), atol=1e-6)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=1e-6)


def test_mixup_draws_are_seeded_beta():
    cfg = _port(tiny_cfg(mixup=0.2))
    a = tsteps.draw(torch.Generator().manual_seed(3), cfg, 4096)
    torch.manual_seed(123)           # the global RNG plays no part
    b = tsteps.draw(torch.Generator().manual_seed(3), cfg, 4096)
    c = tsteps.draw(torch.Generator().manual_seed(4), cfg, 4096)
    assert a.seeds is None and a.lam.dtype == np.float32
    np.testing.assert_array_equal(a.lam, b.lam)
    assert not np.array_equal(a.lam, c.lam)
    assert abs(float(a.lam.mean()) - 0.5) < 0.03
    assert 0.0 <= a.lam.min() and a.lam.max() <= 1.0
    # Beta(0.2, 0.2) is U-shaped: most mass near 0 and 1
    assert ((a.lam < 0.1) | (a.lam > 0.9)).mean() > 0.5


@pytest.mark.parametrize("accum", [1, 2])
def test_mixup_train_step_matches_jax(accum):
    """JAX's λ injected per micro-batch: loss, grad_norm and gradients
    match, so with accumulation each micro-batch mixes within itself as
    the reference's scan does."""
    cfg = tiny_cfg(accum=accum, mixup=0.2)
    jp, tp = _params(cfg)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = jsteps.TrainState.create(jp, seed=0)
    draws = _jax_draws(jstate.rng, cfg, 4)
    _, jm = jax.jit(jsteps.make_train_step(cfg, 10))(jstate, jb)
    mixed = []
    orig = tsteps.mixup

    def spy(images, labels, lam):
        out = orig(images, labels, lam)
        mixed.append((images, lam, out[0]))
        return out

    tsteps.mixup = spy
    try:
        _, tm = tsteps.make_train_step(_port(cfg), 10)(
            tsteps.TrainState.create(tp, 0),
            {k: torch.from_numpy(v) for k, v in batch.items()}, draws)
    finally:
        tsteps.mixup = orig
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    assert len(mixed) == accum
    for i, (images, lam, out) in enumerate(mixed):
        rows = batch["pixel_values"][i::accum]
        np.testing.assert_array_equal(images.numpy(), rows)
        partner = np.roll(rows, 1, 0)       # within the micro-batch
        want = (lam[:, None, None, None] * rows
                + (1 - lam[:, None, None, None]) * partner)
        np.testing.assert_allclose(out.numpy(), want, atol=1e-6)
