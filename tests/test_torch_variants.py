"""The named ViT variants (``config.VIT_VARIANTS``): the port against the
JAX package on the CPU.

For ViT-Ti/16, ViT-S/16, ViT-B/32 and ViT-L/16 a variant-shaped narrow
model (the variant's heads of 64, ViT-L's 16 cut to 4; its patch and its
MLP ratio of 4; two layers, two or four patches a side) is carried across
with ``models/bridge.py`` and held against the JAX package: the logits
(f32 and bf16), one train step's loss and gradients, the eval step and
the static int8 Predictor, at the tolerances ``tests/test_torch_head_dims.py``
holds the same functions to, but the int8 Predictor: at these widths the
routes of the static int8 forward differ by int8 steps (INT8_ROUTE_TOL).
The int8 products at the variants' shapes equal the JAX kernel's bits:
ViT-Ti/16's have N = 192 (a ragged 128-wide tile on the card) and
ViT-B/32's patch embedding K = 3072.

ViT-B/16 @512: a 384-grid tree adapted to 1025 tokens against the JAX
``adapt_params_to_img_size`` and its forward at 512 px; the dropout mask
at S = 1025 with ``auto_block_q`` (Q blocks of 384, strides 1152) against
the JAX debug kernel's, and the dropout forward and gradients there.

Every full variant's parameter shapes, read from meta tensors against
``jax.eval_shape`` (nothing allocated).

Inputs are seeded numpy arrays handed to both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chestxray_vit_tpu import config as jconfig
from chestxray_vit_tpu.models import vit as jvit
from chestxray_vit_tpu.ops import flash_attention as jfa
from chestxray_vit_tpu.serve.inference import Predictor as JaxPredictor
from chestxray_vit_tpu.train import steps as jsteps
from chestxray_vit_tpu_torch import config as tconfig
from chestxray_vit_tpu_torch.config import Config, ModelConfig, TrainConfig
from chestxray_vit_tpu_torch.models import bridge
from chestxray_vit_tpu_torch.models import vit as tvit
from chestxray_vit_tpu_torch.ops import flash_attention as tfa
from chestxray_vit_tpu_torch.serve.inference import Predictor
from chestxray_vit_tpu_torch.train import steps as tsteps

torch.backends.cuda.matmul.allow_tf32 = False

# name → (heads of 64, patch, image px): each variant's heads (ViT-L/16's
# 16 cut to 4), its patch, two or four patches a side
SHAPED = {"vit_ti16": (3, 16, 32), "vit_s16": (6, 16, 32),
          "vit_b32": (12, 32, 64), "vit_l16": (4, 16, 32)}
DTYPES = ["float32", "bfloat16"]
RATE, SEED = 0.3, -12345


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The shapes here are small: intra-op threads would only add
    barriers on a host loaded by several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shaped_cfg(variant: str, dtype: str = "float32") -> Config:
    """The variant's heads of 64, patch and MLP ratio at two layers."""
    heads, patch, img = SHAPED[variant]
    hidden, _, v_heads, mlp, v_patch, _ = tconfig.VIT_VARIANTS[variant]
    assert hidden // v_heads == 64 and mlp == 4 * hidden and patch == v_patch
    return Config(
        model=ModelConfig(img_size=img, patch_size=patch,
                          hidden_size=64 * heads, num_layers=2,
                          num_heads=heads, mlp_dim=4 * 64 * heads,
                          num_classes=15, dtype=dtype,
                          attention_impl="pallas"),
        train=TrainConfig(warmup_steps=1))


def _jcfg(cfg: Config) -> jconfig.Config:
    return jconfig.Config(**{
        f.name: getattr(jconfig, type(getattr(cfg, f.name)).__name__)(
            **dataclasses.asdict(getattr(cfg, f.name)))
        for f in dataclasses.fields(cfg)})


def _params(cfg: Config, seed=0):
    jp = jvit.init_params(jax.random.key(seed), _jcfg(cfg).model)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                      cfg.model)


def _batch(img: int, b=4, seed=0):
    rng = np.random.default_rng(seed)
    return {"pixel_values": rng.standard_normal((b, img, img, 3))
            .astype(np.float32),
            "labels": (rng.random((b, 15)) < 0.2).astype(np.float32)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", list(SHAPED))
def test_variant_shaped_logits_match_jax(variant, dtype):
    cfg = shaped_cfg(variant, dtype)
    assert cfg.model.head_dim == 64
    jp, tp = _params(cfg)
    x = _batch(cfg.model.img_size)["pixel_values"]
    jmodel = _jcfg(cfg).model
    ref = jax.jit(lambda p, x: jvit.apply(p, x, jmodel, train=False))(
        jp, jnp.asarray(x))
    with torch.no_grad():
        got = tvit.apply(tp, torch.from_numpy(x), cfg.model, train=False)
    assert got.dtype == torch.float32 and got.shape == (4, 15)
    tol = {"float32": 1e-5, "bfloat16": 3e-2}[dtype]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("variant", list(SHAPED))
def test_variant_shaped_train_step_matches_jax(variant):
    """One f32 train step: the loss and every gradient leaf (within 1e-4
    of the largest, tests/test_torch_train.py's bound)."""
    cfg = shaped_cfg(variant)
    jp, tp = _params(cfg)
    batch = _batch(cfg.model.img_size, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jcfg = _jcfg(cfg)

    def loss(p):
        logits = jvit.apply(p, jb["pixel_values"], jcfg.model, train=True)
        return jsteps.bce_with_logits(logits, jb["labels"])

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(jp)
    state, tm = tsteps.make_train_step(cfg, total_steps=10)(
        tsteps.TrainState.create(tp, seed=0),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jloss), atol=1e-5)
    got = jax.tree.leaves(bridge.grads_to_numpy(state.params))
    ref = [np.asarray(a, np.float32) for a in jax.tree.leaves(jgrads)]
    scale = max(float(np.abs(a).max()) for a in ref)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert float(np.abs(g - r).max()) <= 1e-4 * scale


@pytest.mark.parametrize("variant", list(SHAPED))
def test_variant_shaped_eval_step_matches_jax(variant):
    cfg = shaped_cfg(variant)
    jp, tp = _params(cfg, seed=1)
    batch = _batch(cfg.model.img_size, b=5, seed=3)
    jl, jr = jax.jit(jsteps.make_eval_step(_jcfg(cfg)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tr = tsteps.make_eval_step(cfg)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tl.shape == (5, 15) and tr.shape == (5,)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5)


# (M, K, N, form) of the variants' int8 products at two images' rows:
# ViT-B/32's patch embedding (K = 3072), ViT-Ti/16's q (N = 192) and MLP
# pair, ViT-S/16's MLP pair
INT8_FORMS = ((8, 3072, 768, "plain"), (10, 192, 192, "plain"),
              (10, 192, 768, "gelu_requant"), (10, 768, 192, "resid"),
              (10, 384, 1536, "gelu_requant"), (10, 1536, 384, "resid"))


@pytest.mark.parametrize("m,k,n,form", INT8_FORMS,
                         ids=[f"{k}x{n}-{f}" for _, k, n, f in INT8_FORMS])
def test_variant_int8_products_equal_the_jax_kernel(m, k, n, form):
    """The fused int8 kernel's plain twin against the JAX package's
    kernel, interpreted, at the variants' shapes: equal bits (bf16 out,
    int8 out of the requantizing form), as tests/test_torch_quant.py holds
    it at K = 64."""
    from chestxray_vit_tpu.ops import int8_pallas as jp8
    from chestxray_vit_tpu_torch.ops import int8_matmul as tp8

    rng = np.random.default_rng(k + n)
    xq = rng.integers(-127, 128, (1, m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = rng.uniform(1e-4, 1e-3, (n,)).astype(np.float32)
    bias = rng.standard_normal((n,)).astype(np.float32)
    resid = rng.standard_normal((1, m, n)).astype(np.float32)
    jkw, tkw = {"out_dtype": jnp.bfloat16}, {"out_dtype": torch.bfloat16}
    if form == "resid":
        jkw["resid"] = jnp.asarray(resid, jnp.bfloat16)
        tkw["resid"] = torch.from_numpy(resid).to(torch.bfloat16)
    if form == "gelu_requant":
        jkw.update(gelu=True, out_quant_scale=jnp.float32(0.05))
        tkw.update(gelu=True, out_quant_scale=torch.tensor(0.05))
    ref = np.asarray(jp8.int8_matmul_fused(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale),
        jnp.asarray(bias), **jkw).astype(jnp.float32))
    got = tp8.int8_matmul_fused(
        torch.from_numpy(xq), torch.from_numpy(wq.T.copy()),
        torch.from_numpy(scale), torch.from_numpy(bias), **tkw)
    assert got.shape == (1, m, n)
    np.testing.assert_array_equal(got.float().numpy(), ref)


def _grays(n=5, seed=3):
    rng = np.random.default_rng(seed)
    shapes = [(48, 64), (64, 40), (64, 64), (30, 30), (80, 70)]
    return [rng.integers(0, 256, shapes[i % 5], np.uint8) for i in range(n)]


# The static int8 forward is not continuous: an activation within a
# rounding error of an int8 step quantizes one step apart, and the two
# packages' LayerNorm, attention and GELU round in other orders, so at the
# variants' widths the routes re-draw the quantization noise. The JAX
# package's own two routes ("xla", "pallas") on one bf16 tree differ by
# 0.010 / 0.028 / 0.032 / 0.016 in logits of O(1) (Ti/16, S/16, B/32,
# L/16-shaped), past tests/test_torch_quant.py's 2e-2 measured at width
# 64; the port's fused route against JAX's "pallas" by 0.013–0.033, and in
# f32 by 0.0034 (Ti/16) and 0.013 (B/32), where JAX's routes agree. Bound:
# chip_smoke.py's route bound, 0.15 with a logit correlation above 0.995;
# a wrong scale, bias or padding moves logits by O(1). The products
# themselves are exact (test_variant_int8_products_equal_the_jax_kernel).
INT8_ROUTE_TOL, INT8_ROUTE_MIN_CORR = 0.15, 0.995


@pytest.mark.parametrize("variant", list(SHAPED))
def test_variant_shaped_static_int8_predictor_matches_jax(variant):
    """The static int8 Predictor (the fused route) against the JAX
    Predictor (its "xla" route), within INT8_ROUTE_TOL and
    INT8_ROUTE_MIN_CORR: ViT-Ti/16's products at N = 192, ViT-B/32's patch
    embedding at K = 3 · 32 · 32 = 3072."""
    cfg = shaped_cfg(variant, "bfloat16")
    jp, tp = _params(cfg, seed=2)
    kw = dict(batch_size=4, canvas_size=64, placement="device",
              quantize="static", calibration=_grays(4, seed=7))
    ref = JaxPredictor(jp, _jcfg(cfg).model, **kw)
    pred = Predictor(tp, cfg.model, device="cpu", **kw)
    tree = pred._fwd_params
    k = 3 * cfg.model.patch_size ** 2
    assert tuple(tree.patch_embed.qw.q.shape) == (cfg.model.hidden_size, k)
    assert tuple(tree.blocks[0].wq.qw.q.shape) == (cfg.model.hidden_size,) * 2
    grays = _grays()
    out, want = pred.predict_arrays(grays), ref.predict_arrays(grays)
    np.testing.assert_allclose(out.logits, want.logits, atol=INT8_ROUTE_TOL)
    corr = np.corrcoef(np.ravel(out.logits), np.ravel(want.logits))[0, 1]
    assert corr > INT8_ROUTE_MIN_CORR, corr


# ---------------------------------------------------------------------------
# ViT-B/16 @512: the adapted tree and attention at 1025 tokens
# ---------------------------------------------------------------------------

def test_adapt_384_tree_to_512_matches_jax():
    """A 384-grid tree (24 × 24 patches, hidden 64) adapted to 512 px: the
    position embeddings [1, 1025, 64] against the JAX package's
    ``adapt_params_to_img_size`` (f32 products in both, 1e-6), every other
    leaf the same bits, and the adapted forward at 512 px against the JAX
    one (f32, 1e-5)."""
    small = dict(hidden_size=64, num_layers=1, num_heads=1, mlp_dim=128,
                 num_classes=3, dtype="float32", attention_impl="xla")
    c384, c512 = (ModelConfig(img_size=s, **small) for s in (384, 512))
    j384, j512 = (jconfig.ModelConfig(img_size=s, **small)
                  for s in (384, 512))
    jp = jvit.init_params(jax.random.key(3), j384)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), c384)
    jad = jvit.adapt_params_to_img_size(jp, j512)
    tad = tvit.adapt_params_to_img_size(tp, c512)
    assert tad is not tp and tad.cfg.seq_len == 1025
    assert tuple(tad.pos_embed.shape) == (1, 1025, 64)
    assert tvit.adapt_params_to_img_size(tad, c512) is tad
    got = bridge.params_to_numpy(tad)
    np.testing.assert_allclose(got["pos_embed"],
                               np.asarray(jad["pos_embed"]), atol=1e-6)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(jax.tree.map(np.asarray, jad))):
        if "pos_embed" not in jax.tree_util.keystr(path):
            np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(4).standard_normal(
        (1, 512, 512, 3)).astype(np.float32)
    ref = jvit.apply(jad, jnp.asarray(x), j512, train=False)
    with torch.no_grad():
        out = tvit.apply(tad, torch.from_numpy(x), c512, train=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_dropout_at_1025_tokens_uses_auto_block_q_and_matches_jax():
    """S = 1025 (ViT-B/16 @512): both packages pick Q blocks of 384, whose
    mask strides are (1152, 1152); the mask of ``attention_dropout`` (the
    model's call) is the JAX debug kernel's bit for bit, and its forward
    and gradients match ``flash_attention_dropout`` (f32, 1e-5)."""
    s = 1025
    assert tfa.auto_block_q(s) == jfa.auto_block_q(s) == 384
    assert tfa.mask_strides(s, 384) == (1152, 1152)
    rng = np.random.default_rng(5)
    q, k, v, do = (rng.standard_normal((1, 2, s, 16)).astype(np.float32)
                   for _ in range(4))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    seed = jnp.asarray([SEED], jnp.int32)
    _, jkeep = jfa.flash_attention_dropout_debug(jq, jk, jv, seed, RATE,
                                                 None, 384)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    _, keep = tfa.flash_attention_dropout_debug(tq, tk, tv, SEED, RATE,
                                                block_q=tfa.auto_block_q(s))
    assert torch.equal(keep, torch.from_numpy(np.array(jkeep)[..., :s]))

    def f(q, k, v):
        o = jfa.flash_attention_dropout(q, k, v, seed, RATE, None, 384)
        return jnp.sum(o * jnp.asarray(do)), o

    (_, ref_o), ref = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(jq, jk, jv)
    tq, tk, tv = (t.clone().requires_grad_() for t in (tq, tk, tv))
    o = tfa.attention_dropout(tq, tk, tv, SEED, RATE)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(ref_o),
                               atol=1e-5)
    o.backward(torch.from_numpy(do))
    for got, r in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), atol=1e-5)


# ---------------------------------------------------------------------------
# Every full variant's parameter shapes
# ---------------------------------------------------------------------------

FULL = [(v, 384) for v in tconfig.VIT_VARIANTS if v != "vit_h14"] + [
    ("vit_b16", 512), ("vit_h14", 224)]


@pytest.mark.parametrize("variant,img", FULL,
                         ids=[f"{v}@{i}" for v, i in FULL])
def test_full_variant_parameter_shapes_match_jax(variant, img):
    """``vit_variant_config(variant, img)`` equals the JAX package's, and
    every parameter's shape is that of the JAX tree (read from meta
    tensors and ``jax.eval_shape``, nothing allocated); heads of 64 but
    ViT-H/14's 80, which the kernels take."""
    cfg = tconfig.vit_variant_config(variant, img_size=img)
    jcfg = jconfig.vit_variant_config(variant, img_size=img)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.head_dim == (80 if variant == "vit_h14" else 64)
    assert tfa.kernel_head_dim(cfg.head_dim) == cfg.head_dim
    assert cfg.remat == (cfg.hidden_size >= 1024)
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
