"""The port's attention maps (``serve/attention_maps.py``,
``serve/visualize.py``) and the Predictor's maps against the JAX
package's, on the CPU.

Both sides take the same numpy-seeded inputs and the same weights (drawn
by the JAX package's ``init_params`` and bridged). Tolerances: f32
logits 1e-5 (the two CPU backends sum in other orders). Maps, in [0, 1],
1e-4 where a model makes them: each is min-max normalized, and at these
random weights its range is about 1 % of the rollout's scale, which lifts
the summation-order differences of the rollout's products (2e-8 in the
probabilities) to ~2e-5; 1e-5 for the rollout of given probabilities.
The host-side rendering equals the original, byte for byte.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from chestxray_vit_tpu.serve import attention_maps as jam
from chestxray_vit_tpu.serve import visualize as jviz
from chestxray_vit_tpu_torch.serve import attention_maps as tam
from chestxray_vit_tpu_torch.serve import visualize as tviz
from chestxray_vit_tpu_torch.serve.inference import Predictor

from test_torch_packed import jax_cfg
from test_torch_remat import images, params_pair, small_cfg

torch.backends.cuda.matmul.allow_tf32 = False

TOL, MAP_TOL = 1e-5, 1e-4


@pytest.mark.parametrize("head_fuse", ["mean", "max", "min"])
def test_attention_rollout_matches_jax(head_fuse):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 2, 4, 17, 17)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    ref = jam.attention_rollout(jnp.asarray(probs), head_fuse=head_fuse)
    got = tam.attention_rollout(torch.from_numpy(probs), head_fuse=head_fuse)
    assert got.shape == (2, 4, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
    with pytest.raises(ValueError, match="head_fuse"):
        tam.attention_rollout(torch.from_numpy(probs), head_fuse="sum")


def test_compute_rollout_matches_jax():
    cfg = small_cfg()
    jp, tp = params_pair(cfg)
    x = images()
    ref_logits, ref_maps = jam.compute_rollout(jp, jnp.asarray(x),
                                               jax_cfg(cfg))
    with torch.no_grad():
        logits, maps = tam.compute_rollout(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(maps.numpy(), np.asarray(ref_maps),
                               atol=MAP_TOL)


@pytest.mark.parametrize("layer,class_idx", [(None, 2), (0, [0, 3, 4])])
def test_grad_cam_matches_jax(layer, class_idx):
    cfg = small_cfg()
    jp, tp = params_pair(cfg)
    x = images()
    ref_logits, ref_maps = jam.grad_cam(jp, jnp.asarray(x), jax_cfg(cfg),
                                        jnp.asarray(class_idx), layer)
    with torch.no_grad():            # grad_cam turns gradients on itself
        logits, maps = tam.grad_cam(tp, torch.from_numpy(x), cfg,
                                    torch.tensor(class_idx), layer)
    assert maps.shape == (3, 4, 4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(maps.numpy(), np.asarray(ref_maps),
                               atol=MAP_TOL)


@pytest.mark.parametrize("g,out", [(4, 16), (24, 384), (5, 17), (8, 3),
                                   (6, 6)])
def test_upsample_map_matches_jax_image_resize(g, out):
    """Edges included, and a shrink (where jax.image.resize widens the
    kernel: F.interpolate would not)."""
    maps = np.random.default_rng(g).random((2, g, g)).astype(np.float32)
    ref = jam.upsample_map(jnp.asarray(maps), out)
    got = tam.upsample_map(torch.from_numpy(maps), out)
    assert got.shape == (2, out, out)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_render_overlay_equals_the_original():
    rng = np.random.default_rng(3)
    gray = rng.integers(0, 256, (50, 70), np.uint8)
    map01 = rng.random((5, 5)).astype(np.float32)
    np.testing.assert_array_equal(tam.render_overlay(gray, map01),
                                  jam.render_overlay(gray, map01))


def test_visualize_equals_the_original(tmp_path):
    rng = np.random.default_rng(4)
    gray = rng.integers(0, 256, (40, 56), np.uint8)
    sal = rng.random((6, 6)).astype(np.float32)
    np.testing.assert_array_equal(tviz.overlay_heatmap(gray, sal, 0.3),
                                  jviz.overlay_heatmap(gray, sal, 0.3))
    np.testing.assert_array_equal(tviz._bilinear_upsample(sal, 13, 9),
                                  jviz._bilinear_upsample(sal, 13, 9))
    np.testing.assert_array_equal(tviz._jet(sal), jviz._jet(sal))
    findings = [{"label": "A", "probability": 0.9},
                {"label": "B", "probability": 0.2}]
    for fn in ("save_overlay", "save_prediction_panel"):
        args = (gray, sal) if fn == "save_overlay" else (gray, sal, findings)
        got = getattr(tviz, fn)(str(tmp_path / f"t_{fn}.png"), *args)
        ref = getattr(jviz, fn)(str(tmp_path / f"j_{fn}.png"), *args)
        np.testing.assert_array_equal(np.asarray(Image.open(got)),
                                      np.asarray(Image.open(ref)))


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr, "L").save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("kw", [
    {}, {"quantize": "static", "calibration": "synthetic"},
    {"tome_r": 2}, {"quantize": "dynamic", "tome_r": 2}],
    ids=["dense", "static", "tome", "dynamic_tome"])
def test_predictor_maps_match_jax_rollout(kw):
    """Maps run the full-token dense model whatever the Predictor serves,
    and the logits returned with them are the rollout forward's, as in the
    JAX Predictor: both equal JAX's ``compute_rollout`` on the images the
    Predictor staged."""
    cfg = small_cfg()
    jp, tp = params_pair(cfg)
    rng = np.random.default_rng(5)
    grays = [rng.integers(0, 256, s, np.uint8)
             for s in ((40, 32), (32, 32), (50, 60))]
    pred = Predictor(tp, cfg, batch_size=4, canvas_size=64, device="cpu",
                     **kw)
    pred.warmup(with_maps=True)
    out = pred.predict_arrays(grays, with_maps=True)
    staged = pred._to_device(pred._stage(grays, 1))     # bucket of 4
    x = pred._images_of(staged).numpy()
    ref_logits, ref_maps = jam.compute_rollout(jp, jnp.asarray(x),
                                               jax_cfg(cfg))
    assert out.maps.shape == (3, 4, 4)
    np.testing.assert_allclose(out.maps, np.asarray(ref_maps)[:3],
                               atol=MAP_TOL)
    np.testing.assert_allclose(out.logits, np.asarray(ref_logits)[:3],
                               atol=TOL, rtol=TOL)
    plain = pred.predict_arrays(grays)
    assert plain.maps is None
    if kw:       # the served stack is not the model the maps explain
        assert np.abs(plain.logits - out.logits).max() > 1e-4
    else:
        np.testing.assert_allclose(plain.logits, out.logits, atol=TOL)
