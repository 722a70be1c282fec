"""The port's int8 serving slice against the JAX package's, on the CPU.

Both sides take the same numpy-seeded inputs and the same weights (drawn by
the JAX package's ``init_params`` and bridged). The JAX fused int8 kernel
runs in Pallas interpret mode, as its own tests run it on the CPU; the
port's ``int8_matmul_fused`` takes its plain version for CPU tensors.

Tolerances, each with its reason:

- quantization, the products and the fused epilogue: exact (int8 equal,
  f32 and bf16 outputs equal); the scales within rtol 1e-6. The integer
  sums are exact on both sides and the f32 epilogue rounds at the same
  points, except that the interpreted JAX kernel's f32 output is one f32
  ulp off where XLA fuses its multiply-add.
- calibration: f32 scales rtol 1e-5 (f32 summation order in LayerNorm,
  attention and the products); bf16 at most one bf16 ulp of each amax.
- quantized forwards in f32 and the fused route in bf16: 1e-4 in logits of
  O(0.3) (summation order, and a value that lands on a rounding boundary
  moves one int8 step); the "xla" route in bf16: 2e-2, since the two CPU
  backends round the bf16 products and their eager epilogues in other
  orders. Where the port takes the fused route and the JAX package the
  "xla" route (the static ``Predictor`` and eval step), 2e-2, the bound of
  the JAX package's own pallas-vs-xla test.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chestxray_vit_tpu import config as jconfig
from chestxray_vit_tpu.models import quantized as jq
from chestxray_vit_tpu.models import vit as jvit
from chestxray_vit_tpu.ops import int8_pallas as jp8
from chestxray_vit_tpu.ops import quant as jquant
from chestxray_vit_tpu.serve.inference import Predictor as JaxPredictor
from chestxray_vit_tpu.train import steps as jsteps
from chestxray_vit_tpu_torch.config import Config, ModelConfig
from chestxray_vit_tpu_torch.models import bridge
from chestxray_vit_tpu_torch.models import quantized as tq
from chestxray_vit_tpu_torch.models import tome_forward
from chestxray_vit_tpu_torch.ops import int8_matmul as tp8
from chestxray_vit_tpu_torch.ops import quant as tquant
from chestxray_vit_tpu_torch.serve import server
from chestxray_vit_tpu_torch.serve.inference import Predictor
from chestxray_vit_tpu_torch.train import steps as tsteps

LOGIT_TOL = {("xla", "float32"): 1e-4, ("pallas", "float32"): 1e-4,
             ("xla", "bfloat16"): 2e-2, ("pallas", "bfloat16"): 1e-4}
ROUTE_TOL = 2e-2          # port fused route vs JAX "xla" route


def tiny_cfg(dtype="float32", **kw):
    base = dict(img_size=32, patch_size=8, hidden_size=64, num_layers=2,
                num_heads=4, mlp_dim=128, num_classes=5, dtype=dtype)
    base.update(kw)
    return ModelConfig(**base)


def _jax(cfg):
    return jconfig.ModelConfig(**dataclasses.asdict(cfg))


def _pair(cfg, seed=0):
    jp = jvit.init_params(jax.random.key(seed), _jax(cfg))
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg)


def _images(n=3, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 32, 32, 3)).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# (a) quantize_weight, quantize_rows, quantize_static
# ---------------------------------------------------------------------------

def test_quantize_weight_matches_jax(rng):
    w = rng.standard_normal((64, 32)).astype(np.float32)
    w[:, 3] = 0.0                               # an all-zero channel
    ref = jquant.quantize_weight(jnp.asarray(w))
    got = tquant.quantize_weight(torch.from_numpy(w))
    assert got.q.dtype == torch.int8 and got.q.shape == (32, 64)
    np.testing.assert_array_equal(got.q.t().numpy(), np.asarray(ref.q))
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(ref.scale),
                               rtol=1e-6)
    np.testing.assert_array_equal(tquant.dequantize(got).numpy(),
                                  np.asarray(jquant.dequantize(ref)))


def test_quantize_rows_matches_jax(rng):
    x = rng.standard_normal((3, 7, 64)).astype(np.float32) * 4
    qr, sr = jquant.quantize_rows(jnp.asarray(x))
    qg, sg = tquant.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(qg.numpy(), np.asarray(qr))
    np.testing.assert_allclose(sg.numpy(), np.asarray(sr), rtol=1e-6)


def test_quantize_static_matches_jax(rng):
    x = rng.standard_normal((3, 5, 8)).astype(np.float32) * 3
    for s in (0.02, 0.005):     # the second saturates
        ref = jp8.quantize_static(jnp.asarray(x), jnp.float32(s))
        got = tp8.quantize_static(torch.from_numpy(x), torch.tensor(s))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# (b) int8_matmul, int8_matmul_static
# ---------------------------------------------------------------------------

def _weights(rng, k=64, n=48):
    w = rng.standard_normal((k, n)).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32)
    return (jquant.quantize_weight(jnp.asarray(w)),
            tquant.quantize_weight(torch.from_numpy(w)), b)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_matmul_matches_jax(rng, out_dtype):
    x = rng.standard_normal((4, 33, 64)).astype(np.float32)
    jw, tw, b = _weights(rng)
    ref = jquant.int8_matmul(jnp.asarray(x), jw, jnp.asarray(b),
                             out_dtype=jnp.dtype(out_dtype))
    got = tquant.int8_matmul(torch.from_numpy(x), tw, torch.from_numpy(b),
                             out_dtype=getattr(torch, out_dtype))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref, np.float32))


@pytest.mark.parametrize("margin", [1.0, 0.25])   # 0.25: most values clip
def test_int8_matmul_static_matches_jax(rng, margin):
    x = rng.standard_normal((5, 32, 64)).astype(np.float32)
    xs = np.float32(np.abs(x).max() * margin / 127.0)
    jw, tw, b = _weights(rng)
    ref = jquant.int8_matmul_static(jnp.asarray(x), jw, jnp.float32(xs),
                                    jnp.asarray(b), out_dtype=jnp.float32)
    got = tquant.int8_matmul_static(torch.from_numpy(x), tw,
                                    torch.tensor(xs), torch.from_numpy(b),
                                    out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_int8_matmul_static_saturates_beyond_calibration():
    x = np.asarray([[1.0, -1000.0]], np.float32)
    w = np.eye(2, dtype=np.float32)
    ref = jquant.int8_matmul_static(
        jnp.asarray(x), jquant.quantize_weight(jnp.asarray(w)),
        jnp.float32(1.0 / 127.0), out_dtype=jnp.float32)
    got = tquant.int8_matmul_static(
        torch.from_numpy(x), tquant.quantize_weight(torch.from_numpy(w)),
        torch.tensor(1.0 / 127.0, dtype=torch.float32),
        out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_allclose(got.numpy()[0], [1.0, -1.0], atol=0.01)


def test_int8_product_is_exact_past_f32(rng):
    """Sums beyond 2²⁴ (K = 3072 of ±127): the f64 product is exact, then
    rounds to f32 once, as the int32 sum does."""
    xq = np.full((2, 3072), 127, np.int8)
    wq = np.full((8, 3072), 127, np.int8)
    xq[1, ::2] = -127
    got = tquant.int8_product(torch.from_numpy(xq), torch.from_numpy(wq))
    exact = xq.astype(np.int64) @ wq.T.astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))


def test_int32_out_form_is_exact_int32(rng):
    """The int8 kernel's int32 out form, plain twin: the exact sums as
    int32 (past 2²⁴ and odd, where f32 would round) equal to the int64
    product and to JAX's ``dot_general`` with an int32 accumulator."""
    xq = rng.integers(-127, 128, (5, 3072)).astype(np.int8)
    wq = rng.integers(-127, 128, (8, 3072)).astype(np.int8)
    xq[0], wq[0] = 127, 127
    wq[0, :3] = 126                        # 49,548,288 - 3 · 127, odd
    got = tp8.int8_matmul_fused(torch.from_numpy(xq), torch.from_numpy(wq),
                                out_dtype=torch.int32)
    assert got.dtype == torch.int32
    exact = xq.astype(np.int64) @ wq.T.astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), exact)
    assert int(got[0, 0]) == 3072 * 127 ** 2 - 3 * 127
    jsum = jax.lax.dot_general(jnp.asarray(xq), jnp.asarray(wq.T),
                               (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsum))


@pytest.mark.parametrize("kx,kw,k", [(64, 64, 64), (50, 50, 64),
                                     (100, 128, 128), (588, 640, 640)])
def test_fused_wrapper_brings_xq_and_wq_to_one_k(rng, kx, kw, k):
    """``int8_matmul_fused`` takes xq at wq's K, or at the K a padded wq
    (QuantDense's storage) held before padding, and brings both to one
    multiple of K_STEP with zero columns: the sums are the unpadded
    product's, at N = 10 (off 8)."""
    xq = rng.integers(-127, 128, (3, kx)).astype(np.int8)
    wq = np.zeros((10, kw), np.int8)
    wq[:, :kx] = rng.integers(-127, 128, (10, kx))
    xt, wt = tp8._at_one_k(torch.from_numpy(xq), torch.from_numpy(wq))
    assert xt.shape == (3, k) and wt.shape == (10, k)
    got = tp8.int8_matmul_fused(torch.from_numpy(xq), torch.from_numpy(wq),
                                out_dtype=torch.int32)
    np.testing.assert_array_equal(
        got.numpy(), xq.astype(np.int64) @ wq[:, :kx].T.astype(np.int64))


@pytest.mark.parametrize("operand", ["scale", "bias", "resid", "gelu",
                                     "out_quant_scale"])
def test_int32_out_form_refuses_an_epilogue(operand):
    """The int32 out form writes the raw sums: a scale, bias, residual,
    GELU or requantize scale is refused (the card's launch refuses them
    with out code 3 too), and the other forms still need scale and bias."""
    xq = torch.ones((2, 64), dtype=torch.int8)
    wq = torch.ones((8, 64), dtype=torch.int8)
    kw = {"scale": torch.ones(8), "bias": torch.zeros(8),
          "resid": torch.zeros((2, 8), dtype=torch.int32), "gelu": True,
          "out_quant_scale": torch.tensor(1.0)}
    with pytest.raises(ValueError, match=f"takes no {operand}"):
        tp8.int8_matmul_fused(xq, wq, out_dtype=torch.int32,
                              **{operand: kw[operand]})
    if operand in ("scale", "bias"):
        with pytest.raises(ValueError, match="needs a scale and a bias"):
            tp8.int8_matmul_fused(xq, wq, **{operand: kw[operand]},
                                  out_dtype=torch.float32)


# ---------------------------------------------------------------------------
# (c) the fused kernel's plain version against the JAX kernel, interpreted
# ---------------------------------------------------------------------------

def _fused_operands(rng, b=2, s=7, k=64, n=24):
    return (rng.integers(-127, 128, (b, s, k)).astype(np.int8),
            rng.integers(-127, 128, (k, n)).astype(np.int8),
            rng.uniform(0.001, 0.01, (n,)).astype(np.float32),
            rng.standard_normal((n,)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32))


@pytest.mark.parametrize("form", ["plain", "plain_f32", "resid",
                                  "gelu_requant", "resid_requant"])
def test_fused_reference_matches_jax_kernel(rng, form):
    xq, wq, scale, bias, resid = _fused_operands(rng)
    dtype = "float32" if form == "plain_f32" else "bfloat16"
    jkw = {"out_dtype": jnp.dtype(dtype)}
    tkw = {"out_dtype": getattr(torch, dtype)}
    if "resid" in form:
        jkw["resid"] = jnp.asarray(resid, jnp.bfloat16)
        tkw["resid"] = torch.from_numpy(resid).to(torch.bfloat16)
    if form == "gelu_requant":
        jkw["gelu"] = tkw["gelu"] = True
    if form.endswith("requant"):
        jkw["out_quant_scale"] = jnp.float32(0.05)
        tkw["out_quant_scale"] = torch.tensor(0.05)
    ref = np.asarray(jp8.int8_matmul_fused(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale),
        jnp.asarray(bias), **jkw))
    got = tp8.int8_matmul_fused(
        torch.from_numpy(xq), torch.from_numpy(wq.T.copy()),
        torch.from_numpy(scale), torch.from_numpy(bias), **tkw)
    want = torch.int8 if form.endswith("requant") else getattr(torch, dtype)
    assert got.dtype == want and got.shape == (2, 7, 24)
    if form == "plain_f32":
        # XLA's CPU compiler contracts the interpreted kernel's acc·scale +
        # bias into one FMA; the port rounds the product first (as the
        # card's kernel does): one f32 ulp, which no bf16 or int8 output
        # of these inputs shows
        np.testing.assert_allclose(got.numpy(), ref, rtol=2.4e-7, atol=0)
    else:
        np.testing.assert_array_equal(got.float().numpy(),
                                      ref.astype(np.float32))


# ---------------------------------------------------------------------------
# (d) calibration
# ---------------------------------------------------------------------------

def _bf16_ulp(x):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_calibrate_vit_scales_matches_jax(dtype):
    cfg = tiny_cfg(dtype)
    jp, tp = _pair(cfg)
    x = _images()
    ref = jq.calibrate_vit_scales(jp, jnp.asarray(x), _jax(cfg), margin=1.5)
    got = tq.calibrate_vit_scales(tp, torch.from_numpy(x), cfg, margin=1.5)
    pairs = [(got["patch"], ref["patch"])] + [
        (got["blocks"][s], ref["blocks"][s]) for s in ref["blocks"]]
    assert set(got["blocks"]) == set(ref["blocks"])
    for g, r in pairs:
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape and g.dtype == np.float32
        if dtype == "float32":
            np.testing.assert_allclose(g, r, rtol=1e-5)
        else:     # one bf16 ulp of the amax, in scale units
            assert (np.abs(g - r) <= _bf16_ulp(r * 127 / 1.5) * 1.5 / 127
                    + 1e-7 * r).all()


# ---------------------------------------------------------------------------
# (e) the quantized forward, both routes, on bridged trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,backend", [("dynamic", "xla"),
                                          ("static", "xla"),
                                          ("static", "pallas")])
def test_apply_quantized_matches_jax(dtype, mode, backend):
    cfg = tiny_cfg(dtype)
    jp, _ = _pair(cfg)
    x = _images()
    scales = (jq.calibrate_vit_scales(jp, jnp.asarray(_images(seed=9)),
                                      _jax(cfg)) if mode == "static" else None)
    jqp = jq.quantize_vit_params(jp, scales)
    tqp = bridge.qparams_from_jax(_np(jqp), cfg)
    assert tqp.static == (mode == "static")
    ref = np.asarray(jq.apply_quantized(jqp, jnp.asarray(x), _jax(cfg),
                                        backend=backend))
    with torch.no_grad():
        got = tq.apply_quantized(tqp, torch.from_numpy(x), cfg,
                                 backend=backend)
    assert got.dtype == torch.float32 and got.shape == (3, 5)
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=LOGIT_TOL[(backend, dtype)])


def test_quantize_vit_params_matches_jax():
    """The port's own quantization of bridged weights gives the bridged JAX
    tree leaf for leaf (the static scales from each package's
    calibration, f32 within 1e-5)."""
    cfg = tiny_cfg()
    jp, tp = _pair(cfg)
    x = _images()
    jqp = jq.quantize_vit_params(
        jp, jq.calibrate_vit_scales(jp, jnp.asarray(x), _jax(cfg)))
    tqp = tq.quantize_vit_params(
        tp, tq.calibrate_vit_scales(tp, torch.from_numpy(x), cfg))
    got = dict(tq._flatten(bridge.qparams_to_numpy(tqp)))
    ref = dict(tq._flatten(bridge.qparams_to_numpy(
        bridge.qparams_from_jax(_np(jqp), cfg))))
    assert got.keys() == ref.keys()
    for path, r in ref.items():
        if "act" in path or "xs" in path:
            np.testing.assert_allclose(got[path], r, rtol=1e-5)
        else:
            np.testing.assert_array_equal(got[path], r, err_msg=str(path))


def test_apply_quantized_refusals():
    cfg = tiny_cfg()
    _, tp = _pair(cfg)
    x = torch.zeros(1, 32, 32, 3)
    dynamic = tq.quantize_vit_params(tp)
    with pytest.raises(ValueError, match="static"):
        tq.apply_quantized(dynamic, x, cfg, backend="pallas")
    with pytest.raises(ValueError, match="backend"):
        tq.apply_quantized(dynamic, x, cfg, backend="wat")
    tanh = tiny_cfg(gelu_approximate=True)
    static = tq.quantize_vit_params(
        tp, tq.calibrate_vit_scales(tp, x, tanh))
    with pytest.raises(ValueError, match="gelu"):
        tq.apply_quantized(static, x, tanh, backend="pallas")


# ---------------------------------------------------------------------------
# (f) the Predictor
# ---------------------------------------------------------------------------

def _grays(n=5, seed=3):
    rng = np.random.default_rng(seed)
    shapes = [(48, 64), (64, 40), (64, 64), (30, 30), (80, 70)]
    return [rng.integers(0, 256, shapes[i % 5], np.uint8) for i in range(n)]


@pytest.mark.parametrize("quantize", [True, "dynamic", "static"])
def test_predictor_quantize_matches_jax(quantize):
    """The JAX Predictor serves static trees on its "xla" route, the
    port's through the fused route: ROUTE_TOL. Dynamic trees take the
    "xla" route on both sides: LOGIT_TOL."""
    cfg = tiny_cfg("bfloat16")
    jp, tp = _pair(cfg, seed=2)
    grays = _grays()
    calib = _grays(4, seed=7) if quantize == "static" else None
    kw = dict(batch_size=4, canvas_size=64, placement="device",
              quantize=quantize, calibration=calib)
    ref = JaxPredictor(jp, _jax(cfg), **kw)
    pred = Predictor(tp, cfg, device="cpu", **kw)
    assert pred.quantize and pred.quantize_mode == ref.quantize_mode
    out, want = pred.predict_arrays(grays), ref.predict_arrays(grays)
    tol = ROUTE_TOL if quantize == "static" else LOGIT_TOL[("xla",
                                                            "bfloat16")]
    np.testing.assert_allclose(out.logits, want.logits, atol=tol)
    assert pred.forwards == 2


def test_predictor_static_synthetic_calibration(capsys):
    """None warns on stderr and calibrates on the seeded noise batch, as
    'synthetic' does silently; both give the JAX Predictor's tree."""
    cfg = tiny_cfg()
    jp, tp = _pair(cfg)
    warned = Predictor(tp, cfg, device="cpu", quantize="static")
    assert "WARNING" in capsys.readouterr().err
    quiet = Predictor(tp, cfg, device="cpu", quantize="static",
                      calibration="synthetic")
    assert "WARNING" not in capsys.readouterr().err
    ref = JaxPredictor(jp, _jax(cfg), quantize="static",
                       calibration="synthetic")
    for p in (warned, quiet):
        for site in ("attn_in", "attn_out", "mlp_in", "mlp_mid"):
            got = [getattr(b.act, site).item() for b in p._fwd_params.blocks]
            np.testing.assert_allclose(
                got, np.asarray(ref._qparams["blocks"]["act"][site]),
                rtol=1e-5)


def test_predictor_quantize_refusals():
    cfg = tiny_cfg()
    _, tp = _pair(cfg)
    with pytest.raises(ValueError, match="quantize"):
        Predictor(tp, cfg, device="cpu", quantize="int4")
    with pytest.raises(ValueError, match="EMPTY"):
        Predictor(tp, cfg, device="cpu", quantize="static", calibration=[])
    with pytest.raises(ValueError, match="dynamic"):
        Predictor(tp, cfg, device="cpu", quantize="static",
                  qparams=tq.quantize_vit_params(tp))
    with pytest.raises(ValueError, match="gelu"):
        Predictor(tp, tiny_cfg(gelu_approximate=True), device="cpu",
                  quantize="static", calibration="synthetic")
    with pytest.raises(ValueError, match="without quantize"):
        Predictor(tp, cfg, device="cpu").save_quantized("unused")


def test_predictor_prebuilt_qparams(tmp_path):
    """A prebuilt tree serves as built; save_quantized writes the artifact
    that load_quantized reads back."""
    cfg = tiny_cfg()
    _, tp = _pair(cfg)
    pred = Predictor(tp, cfg, device="cpu", quantize="static",
                     calibration=_grays(3), canvas_size=64)
    d = pred.save_quantized(str(tmp_path / "q"))
    loaded = tq.load_quantized(d, cfg)
    again = Predictor(tp, cfg, device="cpu", quantize="static",
                      qparams=loaded, canvas_size=64)
    grays = _grays(3)
    np.testing.assert_array_equal(pred.predict_arrays(grays).logits,
                                  again.predict_arrays(grays).logits)


# ---------------------------------------------------------------------------
# (g) the int8 eval step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("static", [False, True])
def test_quantized_eval_step_matches_jax(static):
    cfg = Config(model=tiny_cfg("bfloat16", num_classes=15))
    jcfg = jconfig.Config(model=_jax(cfg.model))
    jp, tp = _pair(cfg.model)
    rng = np.random.default_rng(5)
    batch = {"pixel_values": rng.standard_normal((4, 32, 32, 3))
             .astype(np.float32),
             "labels": (rng.random((4, 15)) < 0.2).astype(np.float32)}
    x = batch["pixel_values"]
    jqp = jq.quantize_vit_params(
        jp, jq.calibrate_vit_scales(jp, jnp.asarray(x), jcfg.model)
        if static else None)
    tqp = bridge.qparams_from_jax(_np(jqp), cfg.model)
    jl, jr = jax.jit(jsteps.make_inference_eval_step(jcfg, quantized=True))(
        jqp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tr = tsteps.make_quantized_eval_step(cfg)(
        tqp, {k: torch.from_numpy(v) for k, v in batch.items()})
    tol = ROUTE_TOL if static else LOGIT_TOL[("xla", "bfloat16")]
    assert tl.shape == (4, 15) and tr.shape == (4,)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)
    # 15 BCE terms, each within tol · 1 of the other's
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=15 * tol)
    # with token merging, the merged int8 forward on the same route
    # (against the reference: tests/test_torch_tome_dense.py)
    ml, mr = tsteps.make_inference_eval_step(cfg, quantized=True, tome_r=2)(
        tqp, {k: torch.from_numpy(v) for k, v in batch.items()})
    with torch.no_grad():
        want = tome_forward.apply_tome(
            tqp, torch.from_numpy(x), cfg.model, 2, quantized=True,
            backend="pallas" if static else "xla")
    torch.testing.assert_close(ml, want, atol=0, rtol=0)
    assert mr.shape == (4,) and (ml - tl).abs().max() > 0


# ---------------------------------------------------------------------------
# (h) the artifact, across the two packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("static", [False, True])
def test_jax_artifact_loads_in_port(tmp_path, static):
    cfg = tiny_cfg()
    jp, _ = _pair(cfg, seed=1)
    x = _images()
    jqp = jq.quantize_vit_params(
        jp, jq.calibrate_vit_scales(jp, jnp.asarray(x), _jax(cfg))
        if static else None)
    d = jq.save_quantized(str(tmp_path / "q"), jqp)
    tqp = tq.load_quantized(d, cfg)
    assert tqp.static == static
    ref = np.asarray(jq.apply_quantized(jqp, jnp.asarray(x), _jax(cfg)))
    with torch.no_grad():
        got = tq.apply_quantized(tqp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=LOGIT_TOL[("xla", "float32")])


@pytest.mark.parametrize("static", [False, True])
def test_port_artifact_loads_in_jax(tmp_path, static):
    cfg = tiny_cfg()
    jp, tp = _pair(cfg, seed=1)
    x = _images()
    tqp = tq.quantize_vit_params(
        tp, tq.calibrate_vit_scales(tp, torch.from_numpy(x), cfg)
        if static else None)
    fp = tq.model_fingerprint(tp)
    d = tq.save_quantized(str(tmp_path / "q"), tqp, fingerprint=fp)
    meta = json.load(open(os.path.join(d, "quantized.json")))
    assert meta == {"format": 1, "mode": "static" if static else "dynamic",
                    "fingerprint": fp}
    jqp = jq.load_quantized(d, _jax(cfg))
    ref = np.asarray(jq.apply_quantized(jqp, jnp.asarray(x), _jax(cfg)))
    with torch.no_grad():
        got = tq.apply_quantized(tqp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=LOGIT_TOL[("xla", "float32")])


def test_model_fingerprint_matches_jax():
    cfg = tiny_cfg()
    jp, tp = _pair(cfg, seed=2)
    assert tq.model_fingerprint(tp) == jq.model_fingerprint(jp)
    with torch.no_grad():
        tp.blocks[1].mlp_out.kernel[0, 0] += 1e-3
    assert tq.model_fingerprint(tp) != jq.model_fingerprint(jp)


def test_load_quantized_refuses_mismatch(tmp_path):
    cfg = tiny_cfg()
    _, tp = _pair(cfg)
    d = tq.save_quantized(str(tmp_path / "q"), tq.quantize_vit_params(tp))
    with pytest.raises(ValueError, match="shape"):
        tq.load_quantized(d, tiny_cfg(hidden_size=32, mlp_dim=64))
    data = dict(np.load(os.path.join(d, "qparams.npz")))
    del data["['head']['bias']"]
    np.savez(os.path.join(d, "qparams.npz"), **data)
    with pytest.raises(ValueError, match="missing leaf"):
        tq.load_quantized(d, cfg)


# ---------------------------------------------------------------------------
# (i) the server's flags
# ---------------------------------------------------------------------------

def test_server_parses_quantize_flags(tmp_path):
    assert server.parse_args([]).quantize is None
    assert server.parse_args(["--quantize"]).quantize == "dynamic"
    ns = server.parse_args(["--quantize", "static", "--calibration",
                            "synthetic"])
    assert (ns.quantize, ns.calibration) == ("static", "synthetic")
    files = []
    for i in range(2):
        files.append(str(tmp_path / f"{i}.png"))
        with open(files[-1], "wb") as f:
            f.write(bytes([i]) * 5)
    ns = server.parse_args(["--quantize", "static", "--calibration",
                            *files])
    assert ns.calibration == [b"\x00" * 5, b"\x01" * 5]
    with pytest.raises(SystemExit):
        server.parse_args(["--quantize", "static", "--calibration"])


@pytest.mark.parametrize("flags,stack", [
    (["--preset", "fast_serve"], (32, "static", 16, "decreasing")),
    (["--auto-accel"], (8, None, 0, "constant")),
    (["--tome-r", "16"], (8, None, 16, "constant"))])
def test_server_resolves_token_merging(flags, stack):
    """The token-merging flags resolve into the Predictor's arguments as
    the JAX server resolves them (the rules in full:
    tests/test_torch_tome_dense.py)."""
    ns = server.parse_args(flags)
    assert (ns.batch_size, ns.quantize, ns.tome_r, ns.tome_schedule) == stack
