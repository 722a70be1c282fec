"""Head dims other than 64, and the widths off the kernels' vectors: the
port against the JAX package on the CPU.

The port's attention kernels take any head dim d (a multiple of 8 up to
128 at a padded width of 64, 80 or 128 whose extra columns live in shared
memory only; above 128 the wide kernels that split the output columns;
any other d zero-padded to a multiple of 8 by the wrappers). On the CPU its
wrappers run their plain versions; here they are held against the JAX
package's Pallas kernels, interpreted as the JAX tests run them, at the
dims of the CLI smoke (16, four heads of hidden 64), of ViT-H/14 (80,
sixteen heads of hidden 1280), at 12 (off the multiple of 8) and at 256
(ViT-B/16's width in three heads), with the tolerances of the d = 64 tests
of the same functions (tests/test_torch_grads.py,
tests/test_torch_dropout.py, tests/test_torch_packed.py). The wrappers'
zero-padding is held to the plain math it relies on. LayerNorm at D = 50
(off the 16-byte vector) and 2560 (past the register rungs) against the
interpreted ``_forward_pallas`` / ``_bwd_pallas``.

Then two narrow models carried across with ``models/bridge.py``: a
ViT-H-shaped one (hidden 160 in two heads of 80, MLP 320, patch 14, 56 px,
two layers; its patch embedding has K = 3 · 14 · 14 = 588, which the int8
serving tree pads to 640) and one off every multiple of 8 (hidden 50 in two
heads of 25, MLP 100, patch 16, 32 px: every int8 projection's K padded to
64 or 128, N = 50 and 100): logits, one train step's loss and gradients,
the eval step and the static int8 Predictor against the JAX package;
ViT-H/14's parameter shapes at 224 px read from meta tensors and
``jax.eval_shape`` (nothing allocated); and the port's smoke model against
the JAX smoke's.

Inputs are seeded numpy arrays handed to both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chestxray_vit_tpu import cli as jcli
from chestxray_vit_tpu import config as jconfig
from chestxray_vit_tpu.models import vit as jvit
from chestxray_vit_tpu.ops import flash_attention as jfa
from chestxray_vit_tpu.ops import layer_norm as jln
from chestxray_vit_tpu.serve.inference import Predictor as JaxPredictor
from chestxray_vit_tpu.train import steps as jsteps
from chestxray_vit_tpu_torch import cli as tcli
from chestxray_vit_tpu_torch import config as tconfig
from chestxray_vit_tpu_torch.config import Config, ModelConfig, TrainConfig
from chestxray_vit_tpu_torch.models import bridge
from chestxray_vit_tpu_torch.models import vit as tvit
from chestxray_vit_tpu_torch.ops import flash_attention as tfa
from chestxray_vit_tpu_torch.ops import layer_norm as tln
from chestxray_vit_tpu_torch.serve.inference import Predictor
from chestxray_vit_tpu_torch.train import steps as tsteps
from test_torch_packed import attention_inputs, close_on_real_rows, pair

torch.backends.cuda.matmul.allow_tf32 = False

HEAD_DIMS = [16, 80, 12, 256]
DTYPES = ["float32", "bfloat16"]
# f32: summation order only; bf16: P and dS round at other points than in
# the interpreted TPU kernel (the d = 64 bound, tests/test_torch_grads.py)
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
RATE, SEED = 0.3, -12345
S = 37                      # a short odd length: a ragged tail everywhere


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The shapes here are small: intra-op threads would only add
    barriers on a host loaded by several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, ref, tol):
    """|got − ref| ≤ tol · max(1, max |ref|)."""
    got, ref = _np(got), _np(ref)
    bound = tol * max(1.0, float(np.abs(ref).max()))
    assert np.abs(got - ref).max() <= bound, (np.abs(got - ref).max(), bound)


def _qkv_do(d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((2, 2, S, d)).astype(np.float32)
            for _ in range(4)]
    return [pair(a, dtype) for a in arrs]


# ---------------------------------------------------------------------------
# The attention functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_forward_with_lse_matches_jax(d, dtype):
    """The serving forward and the training forward with its logsumexp
    against the interpreted ``flash_attention_inference`` and
    ``_flash_fwd_rule``; the softmax scale is the real d's."""
    (jq, tq), (jk, tk), (jv, tv), _ = _qkv_do(d, dtype)
    bq = jfa.auto_block_q(S)
    _close(tfa.attention(tq, tk, tv, inference=True),
           jfa.flash_attention_inference(jq, jk, jv), TOL[dtype])
    o_ref, res = jfa._flash_fwd_rule(jq, jk, jv, None, bq)
    o, lse = tfa.flash_attention_fwd(tq, tk, tv)
    assert o.shape == (2, 2, S, d) and lse.shape == (2, 2, S)
    _close(o, o_ref, TOL[dtype])
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(res[4])[:, :S, 0].reshape(2, 2, S),
        atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_gradients_match_jax(d, dtype):
    """``attention(inference=False)`` (the autograd function over the
    training kernels' plain versions) against ``jax.grad`` through the
    interpreted ``flash_attention``."""
    (jq, tq), (jk, tk), (jv, tv), (_, tdo) = _qkv_do(d, dtype, seed=1)
    jdo = jnp.asarray(_np(tdo))

    def f(q, k, v):
        o = jfa.flash_attention(q, k, v, None, jfa.auto_block_q(S))
        return jnp.sum(o.astype(jnp.float32) * jdo)

    ref = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    q, k, v = (t.clone().requires_grad_() for t in (tq, tk, tv))
    tfa.attention(q, k, v, inference=False).backward(tdo)
    for got, r in zip((q.grad, k.grad, v.grad), ref):
        assert got.dtype == tq.dtype and got.shape == tq.shape
        _close(got, r, TOL[dtype])


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_dropout_mask_forward_and_gradients_match_jax(d, dtype):
    """The dropout mask bit for bit against the JAX debug kernel's (it
    holds no d), the dropout forward against ``flash_attention_dropout``
    and its gradients against ``jax.grad`` through it."""
    (jq, tq), (jk, tk), (jv, tv), (_, tdo) = _qkv_do(d, dtype, seed=2)
    bq = jfa.auto_block_q(S)
    seed = jnp.asarray([SEED], jnp.int32)
    _, jkeep = jfa.flash_attention_dropout_debug(jq, jk, jv, seed, RATE,
                                                 None, bq)
    _, keep = tfa.flash_attention_dropout_debug(tq, tk, tv, SEED, RATE,
                                                block_q=bq)
    assert torch.equal(keep, torch.from_numpy(np.array(jkeep)[..., :S]))
    jdo = jnp.asarray(_np(tdo))

    def f(q, k, v):
        o = jfa.flash_attention_dropout(q, k, v, seed, RATE, None, bq)
        return jnp.sum(o.astype(jnp.float32) * jdo), o

    (_, ref_o), ref = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(jq, jk, jv)
    q, k, v = (t.clone().requires_grad_() for t in (tq, tk, tv))
    o = tfa.attention_dropout(q, k, v, SEED, RATE)
    _close(o, ref_o, TOL[dtype])
    o.backward(tdo)
    for got, r in zip((q.grad, k.grad, v.grad), ref):
        _close(got, r, TOL[dtype])


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rate", [0.0, RATE])
def test_packed_attention_matches_jax(d, dtype, rate):
    """The segment forward and gradients, with and without dropout,
    against the interpreted ``flash_attention_packed`` and
    ``flash_attention_packed_dropout``, on rows with an id ≥ 0."""
    ((jq, tq), (jk, tk), (jv, tv)), seg, (jdo, tdo), bq = attention_inputs(
        "ragged-multi-block", dtype, seed=3, d=d)
    tseg, jseg = torch.from_numpy(seg), jnp.asarray(seg)
    jseed = jnp.asarray([SEED], jnp.int32)
    jdo32 = jdo.astype(jnp.float32)

    def f(q, k, v):
        if rate:
            o = jfa.flash_attention_packed_dropout(q, k, v, jseg, jseed,
                                                   rate, None, bq)
        else:
            o = jfa.flash_attention_packed(q, k, v, jseg, None, bq)
        return jnp.sum(o.astype(jnp.float32) * jdo32), o

    (_, ref_o), ref = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(jq, jk, jv)
    q, k, v = (t.clone().requires_grad_() for t in (tq, tk, tv))
    if rate:
        o = tfa.flash_attention_packed_dropout(q, k, v, tseg, SEED, rate,
                                               None, bq)
    else:
        o = tfa.flash_attention_packed(q, k, v, tseg, None, bq)
    close_on_real_rows(o, ref_o, seg, TOL[dtype])
    o.backward(tdo)
    for got, r in zip((q.grad, k.grad, v.grad), ref):
        close_on_real_rows(got, r, seg, TOL[dtype])


# ---------------------------------------------------------------------------
# The wrappers' zero-padding of a head dim off the multiple of 8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,want", [(1, 8), (4, 8), (8, 8), (12, 16),
                                    (25, 32), (80, 80), (136, 136),
                                    (250, 256), (768, 768)])
def test_kernel_head_dim_rounds_up_to_the_step(d, want):
    assert tfa.kernel_head_dim(d) == want
    assert tfa.kernel_head_dim(d) % tfa.HEAD_DIM_STEP == 0


def test_kernel_head_dim_refuses_nothing_but_empty_heads():
    with pytest.raises(ValueError, match="head dim must be >= 1"):
        tfa.kernel_head_dim(0)


@pytest.mark.parametrize("d", [4, 12, 25])
def test_zero_padded_head_dim_is_the_real_one(d):
    """What the CUDA wrappers do for d off 8: the plain forward and backward
    on q, k, v, o, dO zero-padded by ``_padded`` with the real d's scale
    equal the real d's sliced back (1e-6: the padded products sum the same
    terms and some zeros, possibly in another order), and every padded
    column of o, dq, dk, dv is exactly 0."""
    rng = np.random.default_rng(d)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 3, S, d))
                                    .astype(np.float32)) for _ in range(4))
    scale = d ** -0.5
    o, lse = tfa.attention_fwd_reference(q, k, v)
    grads = tfa.attention_bwd_reference(q, k, v, o, lse, do)
    pq, pk, pv, po, pdo = tfa._padded(d, q, k, v, o, do)
    width = tfa.kernel_head_dim(d)
    assert pq.shape[-1] == width and tfa._padded(width, pq)[0] is pq
    o_pad, lse_pad = tfa.attention_fwd_reference(pq, pk, pv, scale)
    torch.testing.assert_close(o_pad[..., :d], o, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lse_pad, lse, atol=1e-6, rtol=1e-6)
    assert not o_pad[..., d:].any()
    padded = tfa.attention_bwd_reference(pq, pk, pv, po, lse, pdo, scale)
    for g, gp in zip(grads, padded):
        torch.testing.assert_close(gp[..., :d], g, atol=1e-6, rtol=1e-6)
        assert not gp[..., d:].any()


# ---------------------------------------------------------------------------
# LayerNorm off the vector width and past the register rungs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [50, 1001, 2560, 9000])
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_layer_norm_any_width_matches_jax(d, w_dtype):
    """The port's LayerNorm forward and backward (their plain versions on
    the CPU, the oracles of the any-width kernels) against the interpreted
    ``_forward_pallas`` and ``_bwd_pallas``, f32 rows with an f32 or bf16
    scale, at a width of each branch of the any-D kernels (50: a warp a
    row; 1001: a block a row off the vector; 2560: a block a row of whole
    vectors; 9000: past the register widths); within 1e-5 of the largest
    value (f32 summation order)."""
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((3, 37, d)) * 3 + 1).astype(np.float32)
    sb = [rng.standard_normal(d).astype(np.float32) for _ in range(2)]
    dy = rng.standard_normal((3, 37, d)).astype(np.float32)
    (jx, tx), (jdy, tdy) = pair(x, "float32"), pair(dy, "float32")
    (js, ts), (jb, tb) = (pair(a, w_dtype) for a in sb)
    _close(tln.layer_norm(tx, ts, tb, 1e-12),
           jln._forward_pallas(jx, js, jb, 1e-12), 1e-5)
    got = tln.layer_norm_bwd_reference(tx, ts, tdy, 1e-12)
    ref = jln._bwd_pallas(1e-12, jx, js, jdy)
    assert [g.dtype for g in got] == [tx.dtype, ts.dtype, ts.dtype]
    for g, r in zip(got, ref):
        assert tuple(g.shape) == tuple(r.shape)
        _close(g, r, 1e-5 if w_dtype == "float32" or g is got[0] else 8e-3)


# ---------------------------------------------------------------------------
# Narrow models: ViT-H-shaped (heads of 80, patch 14) and off 8
# ---------------------------------------------------------------------------

# the narrow models' widths: ViT-H/14's head dim and patch (17 tokens),
# and every width off the multiple of 8 (5 tokens)
NARROW = {"vith": dict(img_size=56, patch_size=14, hidden_size=160,
                       num_heads=2, mlp_dim=320),
          "off8": dict(img_size=32, patch_size=16, hidden_size=50,
                       num_heads=2, mlp_dim=100)}


def narrow_cfg(shape: str, dtype="float32") -> Config:
    """A two-layer narrow model of NARROW, 15 classes."""
    return Config(
        model=ModelConfig(**NARROW[shape], num_layers=2, num_classes=15,
                          dtype=dtype, attention_impl="pallas"),
        train=TrainConfig(warmup_steps=1))


def vith_cfg(dtype="float32") -> Config:
    """ViT-H/14's head dim and patch at a narrow width: hidden 160 in two
    heads of 80, MLP 320, two layers, 56 px (17 tokens)."""
    return narrow_cfg("vith", dtype)


def _jcfg(cfg: Config) -> jconfig.Config:
    return jconfig.Config(**{
        f.name: getattr(jconfig, type(getattr(cfg, f.name)).__name__)(
            **dataclasses.asdict(getattr(cfg, f.name)))
        for f in dataclasses.fields(cfg)})


def _params(cfg: Config, seed=0):
    jp = jvit.init_params(jax.random.key(seed), _jcfg(cfg).model)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                      cfg.model)


def _batch(b=4, seed=0, px=56):
    rng = np.random.default_rng(seed)
    return {"pixel_values": rng.standard_normal((b, px, px, 3))
            .astype(np.float32),
            "labels": (rng.random((b, 15)) < 0.2).astype(np.float32)}


@pytest.mark.parametrize("dtype", DTYPES)
def test_vith_shaped_logits_match_jax(dtype):
    cfg = vith_cfg(dtype)
    assert cfg.model.head_dim == 80
    _logits_match_jax(cfg)


@pytest.mark.parametrize("dtype", DTYPES)
def test_off8_narrow_logits_match_jax(dtype):
    """Hidden 50 in two heads of 25, MLP 100: the head dim, the LayerNorm
    width and the int8 N off the multiple of 8."""
    cfg = narrow_cfg("off8", dtype)
    assert cfg.model.head_dim == 25
    _logits_match_jax(cfg)


def _logits_match_jax(cfg: Config):
    jp, tp = _params(cfg)
    dtype = cfg.model.dtype
    x = _batch(px=cfg.model.img_size)["pixel_values"]
    ref = jvit.apply(jp, jnp.asarray(x), _jcfg(cfg).model, train=False)
    with torch.no_grad():
        got = tvit.apply(tp, torch.from_numpy(x), cfg.model, train=False)
    assert got.dtype == torch.float32 and got.shape == (4, 15)
    # f32: the bound of tests/test_torch_train.py's eval step; bf16: the
    # bf16 activations round at other points in the two frameworks
    tol = {"float32": 2e-5, "bfloat16": 5e-2}[dtype]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol,
                               rtol=tol)


def test_vith_shaped_train_step_matches_jax():
    """One f32 train step: the loss, the gradient norm and every gradient
    leaf (within 1e-4 of the largest, tests/test_torch_train.py's bound)."""
    _train_step_matches_jax(vith_cfg())


def test_off8_narrow_train_step_matches_jax():
    """The train step of the off-8 model, as the ViT-H-shaped one's."""
    _train_step_matches_jax(narrow_cfg("off8"))


def _train_step_matches_jax(cfg: Config):
    jp, tp = _params(cfg)
    batch = _batch(seed=1, px=cfg.model.img_size)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jcfg = _jcfg(cfg)

    def loss(p):
        logits = jvit.apply(p, jb["pixel_values"], jcfg.model, train=True)
        return jsteps.bce_with_logits(logits, jb["labels"])

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(jp)
    _, jm = jax.jit(jsteps.make_train_step(jcfg, total_steps=10))(
        jsteps.TrainState.create(jp, seed=0), jb)
    state, tm = tsteps.make_train_step(cfg, total_steps=10)(
        tsteps.TrainState.create(tp, seed=0),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jloss), atol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    got = jax.tree.leaves(bridge.grads_to_numpy(state.params))
    ref = [np.asarray(a, np.float32) for a in jax.tree.leaves(jgrads)]
    scale = max(float(np.abs(a).max()) for a in ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert float(np.abs(g - r).max()) <= 1e-4 * scale


def test_vith_shaped_eval_step_matches_jax():
    _eval_step_matches_jax(vith_cfg())


def test_off8_narrow_eval_step_matches_jax():
    _eval_step_matches_jax(narrow_cfg("off8"))


def _eval_step_matches_jax(cfg: Config):
    jp, tp = _params(cfg, seed=1)
    batch = _batch(b=5, seed=3, px=cfg.model.img_size)
    jl, jr = jax.jit(jsteps.make_eval_step(_jcfg(cfg)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tr = tsteps.make_eval_step(cfg)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tl.shape == (5, 15) and tr.shape == (5,)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5)


def _grays(n=5, seed=3):
    rng = np.random.default_rng(seed)
    shapes = [(48, 64), (64, 40), (64, 64), (30, 30), (80, 70)]
    return [rng.integers(0, 256, shapes[i % 5], np.uint8) for i in range(n)]


def test_vith_shaped_static_int8_predictor_matches_jax():
    """The static int8 Predictor (the fused route, the patch embedding's
    K = 588 padded to 640 in the tree and in the patches) against the
    JAX Predictor (its "xla" route), within tests/test_torch_quant.py's
    route bound; the tree crosses the bridge at the JAX layout, 588."""
    tree = _static_int8_matches_jax(vith_cfg("bfloat16"))
    assert tuple(tree.patch_embed.qw.q.shape) == (160, 640)
    assert not tree.patch_embed.qw.q[:, 588:].any()
    assert bridge.qparams_to_numpy(tree)["patch_embed"]["qw"]["q"].shape \
        == (588, 160)


def test_off8_narrow_static_int8_predictor_matches_jax():
    """The off-8 model's static int8 Predictor: every block projection's
    K (50, and 100 for mlp_out) padded to 64 or 128 in the tree, N = 50
    and 100; the tree crosses the bridge at the JAX layout."""
    tree = _static_int8_matches_jax(narrow_cfg("off8", "bfloat16"))
    block = tree.blocks[0]
    for key, shape in (("wq", (50, 64)), ("wo", (50, 64)),
                       ("mlp_in", (100, 64)), ("mlp_out", (50, 128))):
        q = getattr(block, key).qw.q
        assert tuple(q.shape) == shape, key
        assert not q[:, getattr(block, key).in_features:].any(), key
    jtree = bridge.qparams_to_numpy(tree)["blocks"]
    assert jtree["mlp_out"]["qw"]["q"].shape == (2, 100, 50)


def _static_int8_matches_jax(cfg: Config):
    """The static int8 Predictor against the JAX one on the same weights
    and calibration images; returns the port's quantized tree."""
    jp, tp = _params(cfg, seed=2)
    kw = dict(batch_size=4, canvas_size=64, placement="device",
              quantize="static", calibration=_grays(4, seed=7))
    ref = JaxPredictor(jp, _jcfg(cfg).model, **kw)
    pred = Predictor(tp, cfg.model, device="cpu", **kw)
    grays = _grays()
    out, want = pred.predict_arrays(grays), ref.predict_arrays(grays)
    np.testing.assert_allclose(out.logits, want.logits, atol=2e-2)
    return pred._fwd_params


# ---------------------------------------------------------------------------
# ViT-H/14 itself, and the smoke
# ---------------------------------------------------------------------------

def test_vit_h14_parameter_shapes_match_jax():
    """``vit_variant_config("vit_h14", img_size=224)``: heads of 80, 257
    tokens, and every parameter's shape that of the JAX package's tree
    (read from meta tensors and ``jax.eval_shape``, nothing allocated)."""
    cfg = tconfig.vit_variant_config("vit_h14", img_size=224)
    jcfg = jconfig.vit_variant_config("vit_h14", img_size=224)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.head_dim == 80 and cfg.seq_len == 257 and cfg.remat
    assert tfa.kernel_head_dim(cfg.head_dim) == cfg.head_dim
    with torch.device("meta"):
        model = tvit.ViT(cfg)
    shapes = jax.eval_shape(lambda: jvit.init_params(jax.random.key(0),
                                                     jcfg))
    n = 0
    for name, p in model.named_parameters():
        parts = name.split(".")
        node = shapes["blocks"] if parts[0] == "blocks" else shapes
        for part in parts[2:] if parts[0] == "blocks" else parts:
            node = node[part]
        want = node.shape[1:] if parts[0] == "blocks" else node.shape
        assert tuple(p.shape) == tuple(want), name
        n += p.numel()
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert 630e6 < n < 635e6


def _smoke_model(mod, argv, **kw):
    """The model config the CLI's ``smoke`` builds its trainer with."""
    seen = {}

    class Stop(Exception):
        pass

    def capture(cfg, *args, **kwargs):
        seen["model"] = dataclasses.asdict(cfg.model)
        raise Stop

    orig = mod._build_trainer
    mod._build_trainer = capture
    try:
        with pytest.raises(Stop):
            mod.main(argv)
    finally:
        mod._build_trainer = orig
    return seen["model"]


def test_smoke_model_is_the_jax_smokes():
    """Four heads of 16 on both sides, every model field equal."""
    got = _smoke_model(tcli, ["smoke", "--device", "cpu"])
    want = _smoke_model(jcli, ["smoke"])
    assert got == want
    assert got["num_heads"] == 4 and got["hidden_size"] // 4 == 16
