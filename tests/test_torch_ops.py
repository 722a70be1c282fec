"""The port's ops against the JAX package's, on the CPU.

Inputs are drawn with numpy from a seed and fed to both. Where the JAX
function reaches a Pallas kernel it runs in interpret mode, as the JAX
package's own tests run it on the CPU; the port takes its plain versions
here, which is what its wrappers do for CPU tensors.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from chestxray_vit_tpu.ops import flash_attention as jfa
from chestxray_vit_tpu.ops import gelu as jgelu
from chestxray_vit_tpu.ops import layer_norm as jln
from chestxray_vit_tpu.ops import preprocess as jpre
from chestxray_vit_tpu_torch.ops import flash_attention as tfa
from chestxray_vit_tpu_torch.ops import gelu as tgelu
from chestxray_vit_tpu_torch.ops import layer_norm as tln
from chestxray_vit_tpu_torch.ops import preprocess as tpre

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_TORCH = {np.float32: torch.float32, "bfloat16": torch.bfloat16}
_JAX = {np.float32: jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(arr: np.ndarray, dtype):
    """The same values as a JAX array and a torch tensor in ``dtype``."""
    j = jnp.asarray(arr, _JAX[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(_TORCH[dtype])
    return j, t


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


# ---------------------------------------------------------------------------
# GELU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_matches_jax(rng, approximate):
    x = (rng.standard_normal((4, 257)) * 4).astype(np.float32)
    jx, tx = _pair(x, np.float32)
    ref = np.asarray(jgelu.gelu(jx, approximate=approximate))
    got = _np(tgelu.gelu(tx, approximate=approximate))
    # same polynomial in f32 on both sides: agreement to f32 rounding
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_erf_fast_matches_jax(rng):
    x = (rng.standard_normal(1000) * 3).astype(np.float32)
    jx, tx = _pair(x, np.float32)
    np.testing.assert_allclose(_np(tgelu.erf_fast(tx)),
                               np.asarray(jgelu.erf_fast(jx)), atol=1e-6)


def test_gelu_bf16_keeps_dtype(rng):
    _, tx = _pair(rng.standard_normal((3, 8)).astype(np.float32),
                  "bfloat16")
    assert tgelu.gelu(tx).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------

def _ln_inputs(rng, x_dtype, w_dtype, shape=(3, 37, 256)):
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    s = rng.standard_normal(shape[-1:]).astype(np.float32)
    b = rng.standard_normal(shape[-1:]).astype(np.float32)
    return _pair(x, x_dtype), _pair(s, w_dtype), _pair(b, w_dtype)


@pytest.mark.parametrize("d", [256, 1280])     # 1280: ViT-H/14's width
@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("x_dtype,w_dtype", [
    (np.float32, np.float32), ("bfloat16", "bfloat16"),
    ("bfloat16", np.float32)])
def test_layer_norm_matches_jax(rng, reference, x_dtype, w_dtype, d):
    (jx, tx), (js, ts), (jb, tb) = _ln_inputs(rng, x_dtype, w_dtype,
                                              (3, 37, d))
    fn = (jln._forward_xla if reference == "xla" else jln._forward_pallas)
    ref = np.asarray(fn(jx, js, jb, 1e-12).astype(jnp.float32))
    out = tln.layer_norm(tx, ts, tb, 1e-12)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    got = _np(out)
    if x_dtype == np.float32:
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    else:
        # f32 statistics on both sides, one rounding to bf16 at the end:
        # a different f32 summation order may flip that rounding by 1 ulp
        diff, ulp = np.abs(got - ref), _bf16_ulp(ref)
        # Only where x̂·s + b cancels (float64 |y| below 2^-14 of
        # |x̂·s| + |b|) can the two f32 values differ by the rounding of
        # the terms rather than of y: there 2^-22 of the terms is allowed
        # on top, and the port must be no farther than JAX from the
        # float64 value (at 1280 one element of 142,080 cancels, to
        # y ≈ -1.5e-5). Every other element keeps the 1-ulp bound.
        x64 = _np(tx).astype(np.float64)
        xhat = (x64 - x64.mean(-1, keepdims=True)) / np.sqrt(
            x64.var(-1, keepdims=True) + 1e-12)
        s64, b64 = (_np(t).astype(np.float64) for t in (ts, tb))
        y64 = xhat * s64 + b64
        terms = np.abs(xhat * s64) + np.abs(b64)
        cancels = np.abs(y64) < 2.0 ** -14 * terms
        assert (diff[~cancels] <= ulp[~cancels]).all()
        assert (diff[cancels] <= (ulp + 2.0 ** -22 * terms)[cancels]).all()
        assert (np.abs(got - y64) <= np.abs(ref - y64))[cancels].all()


def test_layer_norm_bwd_asks_its_wave_once_per_width_and_dtypes(
        monkeypatch):
    """The backward wrapper's block count asks the library for the wave (its
    blocks resident at once) once per (device, D, x dtype, scale dtype):
    a launch then makes one ctypes call, the kernel's own."""
    asked = []

    class Library:
        def cxr_layer_norm_bwd_wave(self, d, x_code, w_code, device, blocks):
            asked.append((d, x_code, w_code))
            blocks._obj.value = 264
            return 0

    monkeypatch.setattr(tln.kernels, "library", Library)
    monkeypatch.setattr(tln, "_BWD_WAVES", {})
    meta = dict(device="meta")
    x = torch.empty((32 * 257, 1280), dtype=torch.bfloat16, **meta)
    bf16, f32 = (torch.empty(1280, dtype=t, **meta)
                 for t in (torch.bfloat16, torch.float32))
    assert [tln._bwd_blocks(x, bf16, 32 * 257) for _ in range(3)] == [264] * 3
    assert tln._bwd_blocks(x, bf16, 7) == 1
    assert tln._bwd_blocks(x, f32, 32 * 257) == 264
    x768 = torch.empty((8, 768), dtype=torch.bfloat16, **meta)
    assert tln._bwd_blocks(x768, bf16[:768], 8) == 1
    assert asked == [(1280, 1, 1), (1280, 1, 0), (768, 1, 1)]


def test_layer_norm_cpu_path_is_plain_and_counts_no_launch(rng):
    (_, tx), (_, ts), (_, tb) = _ln_inputs(rng, np.float32, np.float32)
    before = tln.layer_norm_cuda.launches
    out = tln.layer_norm(tx, ts, tb, 1e-12)
    torch.testing.assert_close(out, tln.layer_norm_reference(tx, ts, tb,
                                                             1e-12),
                               atol=0, rtol=0)
    assert tln.layer_norm_cuda.launches == before


def test_layer_norm_cuda_refuses_cpu_tensors(rng):
    (_, tx), (_, ts), (_, tb) = _ln_inputs(rng, np.float32, np.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tln.layer_norm_cuda(tx, ts, tb, 1e-12)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _qkv(rng, s, dtype, b=1, h=2, d=64):
    return [_pair(rng.standard_normal((b, h, s, d)).astype(np.float32),
                  dtype) for _ in range(3)]


@pytest.mark.parametrize("s", [37, 64, 65, 128, 129, 137])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_attention_matches_jax_inference_kernel(rng, s, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, s, dtype)
    ref = np.asarray(jfa.flash_attention_inference(jq, jk, jv)
                     .astype(jnp.float32))
    out = tfa.attention(tq, tk, tv, impl="auto", inference=True)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    # the tolerances of tests/test_flash_attention.py
    tol = 1e-5 if dtype == np.float32 else 3e-2
    np.testing.assert_allclose(_np(out), ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_attention_reference_matches_attention_xla(rng, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 50, dtype, b=2, h=3)
    ref = np.asarray(jfa.attention_xla(jq, jk, jv).astype(jnp.float32))
    got = _np(tfa.attention_reference(tq, tk, tv))
    tol = 1e-5 if dtype == np.float32 else 1e-2   # bf16 output rounding
    np.testing.assert_allclose(got, ref, atol=tol, rtol=tol)


def test_attention_strongly_negative_scores(rng):
    """Every valid score in a row strongly negative (the case
    tests/test_flash_attention.py pins for the TPU kernel): finite and
    equal to the oracle."""
    s, d = 130, 64
    q = np.full((1, 1, s, d), 10.0, np.float32)
    k = np.full((1, 1, s, d), -10.0, np.float32)
    v = rng.standard_normal((1, 1, s, d)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, np.float32) for a in (q, k, v))
    ref = np.asarray(jfa.flash_attention_inference(jq, jk, jv))
    got = _np(tfa.attention(tq, tk, tv, inference=True))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_attention_dispatch_on_cpu(rng):
    (_, tq), (_, tk), (_, tv) = _qkv(rng, 40, np.float32)
    ref = tfa.attention_reference(tq, tk, tv)
    before = tfa.flash_attention_inference.launches
    for impl in ("auto", "pallas", "xla"):
        for inference in (True, False):
            torch.testing.assert_close(
                tfa.attention(tq, tk, tv, impl=impl, inference=inference),
                ref, atol=0, rtol=0)
    torch.testing.assert_close(tfa.flash_attention_inference(tq, tk, tv),
                               ref, atol=0, rtol=0)
    assert tfa.flash_attention_inference.launches == before
    with pytest.raises(ValueError, match="impl"):
        tfa.attention(tq, tk, tv, impl="triton")


def test_attention_kernel_check_refuses_cpu_tensors(rng):
    (_, tq), (_, tk), (_, tv) = _qkv(rng, 40, np.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tfa._check(tq, tk, tv)


# ---------------------------------------------------------------------------
# Preprocessing
# ---------------------------------------------------------------------------

def test_normalize_u8_matches_jax(rng):
    u8 = rng.integers(0, 256, (3, 20, 24), np.uint8)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(jpre.normalize_u8(jnp.asarray(u8), dtype=jdt)
                         .astype(jnp.float32))
        out = tpre.normalize_u8(torch.from_numpy(u8), dtype=tdt)
        assert out.shape == (3, 20, 24, 3) and out.dtype == tdt
        np.testing.assert_allclose(_np(out), ref, atol=1e-5)


@pytest.mark.parametrize("stretch", [False, True])
def test_fused_preprocess_matches_jax(rng, stretch):
    c, out_size = 64, 24
    canvases = rng.integers(0, 256, (7, c, c), np.uint8)
    boxes = np.array([
        [0, 0, 64, 64],        # full canvas
        [5, 3, 20, 50],        # tall box
        [2, 10, 60, 12],       # wide box
        [40, 50, 40, 30],      # reaches past the canvas: black padding
        [10, 10, 1, 1],        # degenerate pad box
        [7, 0, 31, 16],        # odd w - h: integer halving of the offset
        [30, 2, 12, 33],       # odd h - w
    ], np.int32)
    flips = np.array([False, True, False, True, False, False, True])
    ref = np.asarray(jpre.fused_preprocess(
        jnp.asarray(canvases), jnp.asarray(boxes), out_size, stretch,
        flips=jnp.asarray(flips)))
    got = tpre.fused_preprocess(
        torch.from_numpy(canvases), torch.from_numpy(boxes), out_size,
        stretch, flips=torch.from_numpy(flips)).numpy()
    assert got.shape == (7, out_size, out_size, 3)
    # f32 products of the same weights on both sides; normalized pixels
    # lie in [-1, 1]
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_fused_preprocess_per_sample_stretch_and_bf16(rng):
    canvases = rng.integers(0, 256, (2, 32, 32), np.uint8)
    boxes = np.array([[0, 4, 32, 20], [3, 0, 16, 32]], np.int32)
    stretches = np.array([True, False])
    ref = np.asarray(jpre.fused_preprocess(
        jnp.asarray(canvases), jnp.asarray(boxes), 16,
        stretches=jnp.asarray(stretches), dtype=jnp.bfloat16)
        .astype(jnp.float32))
    got = tpre.fused_preprocess(
        torch.from_numpy(canvases), torch.from_numpy(boxes), 16,
        stretches=torch.from_numpy(stretches), dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # equal f32 values may round to bf16 either side of a tie only when
    # they differ in the last f32 bits: allow one bf16 ulp
    assert (np.abs(_np(got) - ref) <= _bf16_ulp(ref)).all()


def test_bf16_ulp_helper():
    vals = np.array([1.0, 1.5, 3.0, -0.25], np.float32)
    ulp = _bf16_ulp(vals)
    nxt = (vals.astype(ml_dtypes.bfloat16).view(np.uint16) + 1).view(
        ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(np.abs(nxt - vals), ulp)


@pytest.mark.parametrize("placement", ["pixel_values", "pixel_values_u8",
                                       "canvas_u8"])
def test_prepare_pixel_values_matches_jax(rng, placement):
    canvases = rng.integers(0, 256, (3, 48, 48), np.uint8)
    batch = {
        "pixel_values": rng.standard_normal((3, 16, 16, 3))
        .astype(np.float32),
        "pixel_values_u8": rng.integers(0, 256, (3, 16, 16), np.uint8),
        "canvas_u8": canvases,
        "boxes": np.array([[0, 0, 48, 48], [4, 2, 20, 40], [1, 9, 44, 13]],
                          np.int32),
        "flips": np.array([False, True, False]),
        "stretches": np.array([False, False, True]),
    }
    keep = {"pixel_values": ["pixel_values"],
            "pixel_values_u8": ["pixel_values_u8"],
            "canvas_u8": ["canvas_u8", "boxes", "flips", "stretches"]}
    sub = {k: batch[k] for k in keep[placement]}
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    ref = np.asarray(jpre.prepare_pixel_values(
        {k: jnp.asarray(v) for k, v in sub.items()}, out_size=16,
        mean=mean, std=std))
    got = tpre.prepare_pixel_values(
        {k: torch.from_numpy(v) for k, v in sub.items()}, out_size=16,
        mean=mean, std=std)
    assert got.shape == (3, 16, 16, 3) and got.dtype == torch.float32
    # f32 products of the same weights on both sides (ImageNet std scales
    # the [0, 1] pixels up to ~2.6)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)
