"""HF weight interop of the port against the JAX package and HF itself:
the port's safetensors reader and writer (``utils/safetensors.py``)
against the ``safetensors`` package both ways, the import
(``models/import_hf.py``) and export (``models/export_hf.py``) against the
JAX package's and against ``transformers``, the image processor
(``data/processor.py``), and what holding a merged dense Predictor's
LayerNorm gains in bf16 costs against the JAX Predictor.

The HF model is a small random ``ViTForImageClassification`` built in
memory from a seed (2 layers, hidden 64, 4 heads, img 32, patch 8); its
LayerNorm gains and biases are redrawn, so that they are not HF's init
(ones and zeros). No weights are downloaded.

Tolerances: parameters bit for bit (the transforms are copies); f32
logits 1e-4 against HF (the README's bound) and 2e-5 against JAX (as
tests/test_vit_parity.py), the resampled position table 1e-5 (as
tests/test_torch_packed.py's bicubic test), processor pixels 1e-5 against
HF (as tests/test_processor.py), exact against the JAX processor.
"""

import dataclasses
import json
import sys
import types

import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
safetensors_numpy = pytest.importorskip("safetensors.numpy")
safetensors_torch = pytest.importorskip("safetensors.torch")

from chestxray_vit_tpu import config as jconfig  # noqa: E402
from chestxray_vit_tpu.data.processor import (  # noqa: E402
    ImageProcessor as JaxImageProcessor)
from chestxray_vit_tpu.models import export_hf as jexport  # noqa: E402
from chestxray_vit_tpu.models import import_hf as jimport  # noqa: E402
from chestxray_vit_tpu.models import vit as jvit  # noqa: E402
from chestxray_vit_tpu.serve.inference import (  # noqa: E402
    Predictor as JaxPredictor)
from chestxray_vit_tpu_torch import config as tconfig  # noqa: E402
from chestxray_vit_tpu_torch.data.processor import ImageProcessor  # noqa: E402
from chestxray_vit_tpu_torch.models import bridge  # noqa: E402
from chestxray_vit_tpu_torch.models import export_hf as texport  # noqa: E402
from chestxray_vit_tpu_torch.models import import_hf as timport  # noqa: E402
from chestxray_vit_tpu_torch.models import vit as tvit  # noqa: E402
from chestxray_vit_tpu_torch.serve.inference import Predictor  # noqa: E402
from chestxray_vit_tpu_torch.utils import safetensors as st  # noqa: E402

HF_TOL, JAX_TOL, POS_TOL, PIXEL_TOL = 1e-4, 2e-5, 1e-5, 1e-5
# The merged dense bf16 Predictor against the JAX one on these weights
# (measured on the CPU, one torch thread: 2.84e-3 merged at r 2, 2.21e-3
# unmerged; holding the gains in bf16 instead of f32 moves the port's
# merged logits by 3.46e-3):
# the bf16 gains cost no more than the CPU's bf16 rounding already does.
MERGED_BF16_PIN = 5e-3
CLASSES = 5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(num_classes=CLASSES, img_size=32, dtype="float32"):
    return tconfig.ModelConfig(img_size=img_size, patch_size=8,
                               hidden_size=64, num_layers=2, num_heads=4,
                               mlp_dim=128, num_classes=num_classes,
                               dtype=dtype, attention_impl="xla")


def jax_cfg(cfg):
    return jconfig.ModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def hf_model():
    torch.manual_seed(0)
    model = transformers.ViTForImageClassification(transformers.ViTConfig(
        image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        num_labels=CLASSES)).eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "layernorm" in name:
                base = 1.0 if name.endswith("weight") else 0.0
                p.copy_(base + 0.3 * torch.randn(p.shape, generator=gen))
    return model


@pytest.fixture(scope="module")
def state_dict(hf_model):
    return {k: v.clone() for k, v in hf_model.state_dict().items()}


def images_nchw(n=3, size=32, seed=7):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, size, size)).astype(np.float32)


def port_logits(params, cfg, x_nchw):
    with torch.no_grad():
        return tvit.apply(params, torch.from_numpy(
            x_nchw.transpose(0, 2, 3, 1).copy()), cfg).numpy()


def assert_trees_equal(got, want):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, a), (_, b) in zip(flat_g, flat_w):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

def _tensors():
    gen = torch.Generator().manual_seed(0)
    return {"f32": torch.randn(3, 4, generator=gen),
            "bf16": torch.randn(5, 2, generator=gen).bfloat16(),
            "f16": torch.randn(7, generator=gen).half(),
            "f64": torch.randn(2, 3, generator=gen).double(),
            "i64": torch.arange(6, dtype=torch.int64).reshape(2, 3),
            "u8": torch.arange(5, dtype=torch.uint8),
            "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 3)}


def test_safetensors_port_files_load_in_the_library(tmp_path):
    want = _tensors()
    path = str(tmp_path / "port.safetensors")
    st.save_file(want, path, metadata={"format": "pt"})
    got = safetensors_torch.load_file(path)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    # numpy has no bf16: the numpy reader gets the rest
    del want["bf16"]
    st.save_file(want, path)
    arrays = safetensors_numpy.load_file(path)
    for k, v in want.items():
        np.testing.assert_array_equal(arrays[k], v.numpy(), err_msg=k)


def test_safetensors_library_files_read_in_the_port(tmp_path):
    want = _tensors()
    path = str(tmp_path / "lib.safetensors")
    safetensors_torch.save_file(want, path, metadata={"format": "pt"})
    got = st.load_file(path)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        assert torch.equal(got[k], v), k
    arrays = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
              "b": np.ones((2,), np.float64)}
    npath = str(tmp_path / "np.safetensors")
    safetensors_numpy.save_file(arrays, npath)
    back = st.load_file(npath)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


def test_safetensors_rejects_a_truncated_file(tmp_path):
    path = str(tmp_path / "t.safetensors")
    st.save_file({"x": torch.ones(64)}, path)
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:-8])
    with pytest.raises(ValueError, match="offsets"):
        st.load_file(path)


# ---------------------------------------------------------------------------
# import
# ---------------------------------------------------------------------------

def test_import_equals_jax_bit_for_bit(state_dict):
    cfg = port_cfg()
    port = timport.params_from_hf_state_dict(state_dict, cfg, device="cpu")
    ref = jimport.params_from_hf_state_dict(state_dict, jax_cfg(cfg))
    assert_trees_equal(bridge.params_to_numpy(port),
                       jax.tree.map(np.asarray, ref))
    assert port.cfg is cfg


def test_import_logits_match_hf_and_jax(hf_model, state_dict):
    cfg = port_cfg()
    port = timport.params_from_hf_state_dict(state_dict, cfg, device="cpu")
    x = images_nchw()
    got = port_logits(port, cfg, x)
    with torch.no_grad():
        hf = hf_model(pixel_values=torch.from_numpy(x)).logits.numpy()
    jp = jimport.params_from_hf_state_dict(state_dict, jax_cfg(cfg))
    ref = np.asarray(jvit.apply(jp, x.transpose(0, 2, 3, 1), jax_cfg(cfg)))
    np.testing.assert_allclose(got, hf, atol=HF_TOL)
    np.testing.assert_allclose(got, ref, atol=JAX_TOL)


@pytest.mark.parametrize("case", ["mismatched", "missing"])
def test_fresh_head(state_dict, case):
    """Another class count, or no classifier: a fresh head drawn from
    ``torch.Generator(seed)`` (trunc-normal, std 0.02, |w| ≤ 2σ, zero
    bias); everything else as imported."""
    sd = dict(state_dict)
    if case == "missing":
        del sd["classifier.weight"], sd["classifier.bias"]
    cfg = port_cfg(num_classes=24)
    got = timport.params_from_hf_state_dict(sd, cfg, seed=3, device="cpu")
    w = got.head.kernel.detach()
    assert w.shape == (64, 24)
    assert 0.015 < float(w.std()) < 0.025
    assert float(w.abs().max()) <= 0.04
    assert torch.equal(got.head.bias.detach(), torch.zeros(24))
    again = timport.params_from_hf_state_dict(sd, cfg, seed=3, device="cpu")
    other = timport.params_from_hf_state_dict(sd, cfg, seed=4, device="cpu")
    assert torch.equal(again.head.kernel, got.head.kernel)
    assert not torch.equal(other.head.kernel, got.head.kernel)
    full = timport.params_from_hf_state_dict(state_dict, port_cfg(),
                                             device="cpu")
    body = {n: p for n, p in full.named_parameters()
            if not n.startswith("head.")}
    for n, p in got.named_parameters():
        if not n.startswith("head."):
            assert torch.equal(p, body[n]), n


def test_adapt_to_another_img_size_matches_jax(state_dict):
    """A 32 px checkpoint fine-tuned at 48 px: the import keeps the
    checkpoint's 4 × 4 grid, ``adapt_params_to_img_size`` resamples it to
    6 × 6 as the JAX package does."""
    cfg = port_cfg(img_size=48)
    port = timport.params_from_hf_state_dict(state_dict, cfg, device="cpu")
    assert port.pos_embed.shape == (1, 17, 64) and port.cfg.img_size == 32
    adapted = tvit.adapt_params_to_img_size(port, cfg)
    assert adapted.cfg is cfg and adapted.pos_embed.shape == (1, 37, 64)
    jp = jvit.adapt_params_to_img_size(
        jimport.params_from_hf_state_dict(state_dict, jax_cfg(cfg)),
        jax_cfg(cfg))
    np.testing.assert_allclose(adapted.pos_embed.detach().numpy(),
                               np.asarray(jp["pos_embed"]), atol=POS_TOL)
    x = images_nchw(2, 48)
    ref = np.asarray(jvit.apply(jp, x.transpose(0, 2, 3, 1), jax_cfg(cfg)))
    np.testing.assert_allclose(port_logits(adapted, cfg, x), ref,
                               atol=JAX_TOL)


def test_load_pretrained_paths(state_dict, tmp_path, monkeypatch, capsys):
    """A local folder loads; a local path that cannot be read and a name
    ``transformers`` cannot resolve both print and return None (random
    init follows), as in the reference. The name branch runs against a
    stand-in ``transformers`` module: no hub is contacted."""
    cfg = port_cfg()
    folder = tmp_path / "hf"
    jexport.export_hf_folder(
        str(folder), jimport.params_from_hf_state_dict(state_dict,
                                                       jax_cfg(cfg)),
        jax_cfg(cfg))
    got = timport.load_pretrained(str(folder), cfg, device="cpu")
    want = timport.params_from_hf_state_dict(state_dict, cfg, device="cpu")
    assert_trees_equal(bridge.params_to_numpy(got),
                       bridge.params_to_numpy(want))

    (tmp_path / "empty").mkdir()
    assert timport.load_pretrained(str(tmp_path / "empty"), cfg,
                                   device="cpu") is None
    assert "[import_hf] local load failed" in capsys.readouterr().out

    seen = []

    class Model:
        @staticmethod
        def from_pretrained(name, **kw):
            seen.append((name, kw))
            if name == "org/missing":
                raise OSError("not cached")
            return types.SimpleNamespace(state_dict=lambda: state_dict)

    monkeypatch.setitem(sys.modules, "transformers", types.SimpleNamespace(
        ViTForImageClassification=Model))
    assert timport.load_pretrained("org/missing", cfg, device="cpu") is None
    assert "pretrained load failed" in capsys.readouterr().out
    hub = timport.load_pretrained("org/vit", cfg, device="cpu")
    assert_trees_equal(bridge.params_to_numpy(hub),
                       bridge.params_to_numpy(want))
    assert seen[-1] == ("org/vit", {"num_labels": CLASSES,
                                    "ignore_mismatched_sizes": True})


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def test_export_state_dict_equals_jax(state_dict):
    cfg = port_cfg()
    port = timport.params_from_hf_state_dict(state_dict, cfg, device="cpu")
    got = texport.hf_state_dict_from_params(port, cfg.patch_size)
    want = jexport.hf_state_dict_from_params(
        jimport.params_from_hf_state_dict(state_dict, jax_cfg(cfg)),
        cfg.patch_size)
    assert sorted(got) == sorted(want) == sorted(state_dict)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(got[k], state_dict[k].numpy(),
                                      err_msg=k)


def test_exported_folder_loads_in_hf_and_jax(state_dict, tmp_path):
    """The port's folder: ``from_pretrained`` gives the port's logits
    within 1e-4; JAX's reader and the port's own read it back bit for bit;
    its config and processor files equal the JAX package's."""
    cfg = port_cfg()
    classes = [f"c{i}" for i in range(CLASSES)]
    port = timport.params_from_hf_state_dict(state_dict, cfg, device="cpu")
    out = tmp_path / "port_hf"
    texport.export_hf_folder(str(out), port, cfg, classes,
                             image_mean=(0.4, 0.5, 0.6))
    hf = transformers.ViTForImageClassification.from_pretrained(
        str(out)).eval()
    x = images_nchw()
    with torch.no_grad():
        theirs = hf(pixel_values=torch.from_numpy(x)).logits.numpy()
    np.testing.assert_allclose(port_logits(port, cfg, x), theirs,
                               atol=HF_TOL)
    assert hf.config.id2label[0] == "c0"
    assert_trees_equal(
        jax.tree.map(np.asarray, jimport.params_from_safetensors(
            str(out), jax_cfg(cfg))),
        bridge.params_to_numpy(port))
    back = timport.params_from_safetensors(str(out), cfg, device="cpu")
    assert_trees_equal(bridge.params_to_numpy(back),
                       bridge.params_to_numpy(port))

    jout = tmp_path / "jax_hf"
    jexport.export_hf_folder(
        str(jout), jimport.params_from_hf_state_dict(state_dict,
                                                     jax_cfg(cfg)),
        jax_cfg(cfg), classes, image_mean=(0.4, 0.5, 0.6))
    from_jax = timport.params_from_safetensors(str(jout), cfg, device="cpu")
    assert_trees_equal(bridge.params_to_numpy(from_jax),
                       bridge.params_to_numpy(port))
    for name in ("config.json", "preprocessor_config.json"):
        assert json.loads((out / name).read_text()) == \
            json.loads((jout / name).read_text()), name


def test_exported_processor_config_matches_vit_image_processor(tmp_path):
    texport.write_preprocessor_config(str(tmp_path), 64)
    proc = transformers.ViTImageProcessor.from_pretrained(str(tmp_path))
    img = np.random.default_rng(0).integers(0, 255, (100, 86, 3), np.uint8)
    theirs = proc(images=[img], return_tensors="np")["pixel_values"]
    got = ImageProcessor(size=64)(images=[img])["pixel_values"]
    np.testing.assert_allclose(got, theirs, atol=PIXEL_TOL)


# ---------------------------------------------------------------------------
# processor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 64), (100, 80), (48, 128, 3)])
def test_processor_matches_jax_and_hf(shape):
    from PIL import Image
    arr = np.random.default_rng(42).integers(0, 255, shape, dtype=np.uint8)
    rgb = Image.fromarray(arr, "L" if arr.ndim == 2 else "RGB").convert(
        "RGB")
    got = ImageProcessor(size=64)(images=[rgb])["pixel_values"]
    np.testing.assert_array_equal(
        got, JaxImageProcessor(size=64)(images=[rgb])["pixel_values"])
    ref = transformers.ViTImageProcessor(
        size={"height": 64, "width": 64})(images=[rgb],
                                          return_tensors="np")
    assert got.shape == (1, 3, 64, 64)
    np.testing.assert_allclose(got, ref["pixel_values"], atol=PIXEL_TOL)


def test_processor_numpy_channels_last_and_torch():
    arr = np.random.default_rng(1).integers(0, 255, (32, 32), np.uint8)
    last = ImageProcessor(size=16, data_format="channels_last")(arr)
    np.testing.assert_array_equal(
        last["pixel_values"],
        JaxImageProcessor(size=16, data_format="channels_last")(arr)
        ["pixel_values"])
    assert last["pixel_values"].shape == (1, 16, 16, 3)
    pt = ImageProcessor(size=16)(arr, return_tensors="pt")["pixel_values"]
    assert isinstance(pt, torch.Tensor) and pt.dtype == torch.float32
    np.testing.assert_array_equal(
        pt.numpy(), ImageProcessor(size=16)(arr)["pixel_values"])


# ---------------------------------------------------------------------------
# the merged dense Predictor on imported (not init) LayerNorm gains
# ---------------------------------------------------------------------------

def test_merged_dense_predictor_on_trained_gains_against_jax(state_dict):
    """The port's dense Predictor holds every block weight, LayerNorm
    gains included, in the compute dtype; the JAX Predictor's merged
    forward reads the gains in f32. On imported gains that are not ones,
    in bf16, the merged Predictor's logits stay within MERGED_BF16_PIN of
    the JAX one's, as the unmerged one's do; and the cost of the bf16
    gains alone (the same port forward with f32 gains) is of the same
    size."""
    cfg = port_cfg(dtype="bfloat16")
    rng = np.random.default_rng(3)
    grays = [rng.integers(0, 256, (48, 64), np.uint8) for _ in range(4)]
    port = timport.params_from_hf_state_dict(state_dict, cfg, device="cpu")
    jp = jimport.params_from_hf_state_dict(state_dict, jax_cfg(cfg))
    deltas = {}
    for r in (0, 2):
        kw = dict(batch_size=4, canvas_size=64, placement="device", tome_r=r)
        pred = Predictor(port, cfg, device="cpu", **kw)
        got = pred.predict_arrays(grays).logits
        ref = JaxPredictor(jp, jax_cfg(cfg), **kw).predict_arrays(
            grays).logits
        deltas[r] = float(np.abs(got - ref).max())
    assert pred._fwd_params.blocks[0].ln1.scale.dtype == torch.bfloat16
    with torch.no_grad():
        for blk, master in zip(pred._fwd_params.blocks, port.blocks):
            for ln in ("ln1", "ln2"):
                for leaf in ("scale", "bias"):
                    setattr(getattr(blk, ln), leaf, torch.nn.Parameter(
                        getattr(getattr(master, ln), leaf).detach().clone(),
                        requires_grad=False))
    f32_gains = pred.predict_arrays(grays).logits
    gain_cost = float(np.abs(got - f32_gains).max())
    assert 0 < deltas[2] <= MERGED_BF16_PIN, deltas
    assert deltas[0] <= MERGED_BF16_PIN, deltas
    assert 0 < gain_cost <= MERGED_BF16_PIN, gain_cost
