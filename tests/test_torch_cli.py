"""The port's command line (``chestxray_vit_tpu_torch/cli.py``) against the
JAX package's (``chestxray_vit_tpu/cli.py``).

Both ``train`` commands start from one HF folder, written by the port's
``export_hf_folder`` from seeded weights with the fake bucket's class
count, so both Trainers start from the same weights (the pretrained path
of ``model.model_name``), at one global batch of 16 (the port's one
device takes all of it; the JAX package splits it over the devices of its
CPU mesh, 8 under tests/conftest.py); f32, no dropout, no mixup. Their
losses agree within the golden rtol 5e-4 and their final ``avg_auroc``
within 5e-3, as tests/test_torch_trainer.py holds the Trainers. The other commands are
driven on the port's run as tests/test_cli.py drives the JAX ones, on the
CPU (``--device cpu``). One training run per package, shared by the
module.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from chestxray_vit_tpu import cli as jcli
from chestxray_vit_tpu_torch import cli
from chestxray_vit_tpu_torch import config as tconfig
from chestxray_vit_tpu_torch.data import pipeline as tpipe
from chestxray_vit_tpu_torch.data.testing import build_fake_nih
from chestxray_vit_tpu_torch.models import bridge
from chestxray_vit_tpu_torch.models import vit as tvit
from chestxray_vit_tpu_torch.models.export_hf import export_hf_folder
from chestxray_vit_tpu_torch.models.import_hf import params_from_safetensors
from chestxray_vit_tpu_torch.serve.inference import Predictor
from chestxray_vit_tpu_torch.train.checkpoint import load_model

LOSS_RTOL, AUROC_ATOL, HF_TOL = 5e-4, 5e-3, 1e-4
GLOBAL_BATCH = 16

TINY = [
    "--set", f"train.batch_size_per_core={GLOBAL_BATCH}",
    "--set", "data.backend=memory",
    "--set", "model.img_size=64",
    "--set", "model.patch_size=16",
    "--set", "model.hidden_size=64",
    "--set", "model.num_layers=2",
    "--set", "model.num_heads=4",
    "--set", "model.mlp_dim=128",
    "--set", "model.dtype=float32",
    "--set", "model.attention_impl=xla",
    "--set", "train.max_steps=3",
    "--set", "train.eval_strategy=no",
    "--set", "train.save_strategy=steps",
    "--set", "train.save_steps=2",
    "--set", "train.logging_steps=1",
    "--set", "train.report_to=none",
    "--set", "train.load_best_model_at_end=false",
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hf_folder(tmp_path_factory):
    """Seeded port weights as an HF folder, with the class count the
    CLI's fake bucket (``build_fake_nih(64)``) gives the Trainers."""
    classes = tpipe.build_datasets(tconfig.DataConfig(backend="memory"),
                                   build_fake_nih(num_images=64).store
                                   ).classes
    cfg = tconfig.ModelConfig(img_size=64, patch_size=16, hidden_size=64,
                              num_layers=2, num_heads=4, mlp_dim=128,
                              num_classes=len(classes))
    params = tvit.init_params(torch.Generator().manual_seed(5), cfg)
    folder = tmp_path_factory.mktemp("hf") / "vit"
    export_hf_folder(str(folder), params, cfg, classes)
    return folder


@pytest.fixture(scope="module")
def runs(hf_folder, tmp_path_factory):
    """{package: output dir} of one ``train`` each from the folder."""
    root = tmp_path_factory.mktemp("cli")
    args = [*TINY, "--set", f"model.model_name={hf_folder}"]
    out = {"port": root / "port", "jax": root / "jax"}
    assert cli.main(["train", *args, "--set",
                     f"train.output_dir={out['port']}", "--device",
                     "cpu"]) == 0
    per_device = GLOBAL_BATCH // jax.device_count()
    assert jcli.main(["train", *args, "--set",
                      f"train.output_dir={out['jax']}", "--set",
                      f"train.batch_size_per_core={per_device}"]) == 0
    return out


def _losses(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r["loss"] for r in recs if r["prefix"] == "train"]


def _png(path, shape, seed):
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 255, shape, np.uint8), "L").save(path)
    return str(path)


def test_train_matches_the_jax_cli(runs):
    got, want = _losses(runs["port"]), _losses(runs["jax"])
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    ev = {k: json.loads((v / "eval_results.json").read_text())
          for k, v in runs.items()}
    assert abs(ev["port"]["avg_auroc"] - ev["jax"]["avg_auroc"]) <= \
        AUROC_ATOL
    for name in ("train_results.json", "trainer_state.json",
                 "model/classes.json", "model/params.pt",
                 "model/preprocessor_config.json"):
        assert (runs["port"] / name).exists(), name
    assert json.loads((runs["port"] / "model" / "classes.json").read_text()) \
        == json.loads((runs["jax"] / "model" / "classes.json").read_text())


def test_train_starts_from_the_folder(hf_folder, tmp_path):
    """Step 0 of the CLI's Trainer holds the folder's weights bit for bit
    (a local folder that failed to load would silently start random)."""
    cfg = tconfig.parse_cli([*TINY, "--set", f"model.model_name={hf_folder}",
                             "--set", f"train.output_dir={tmp_path}"])
    tr = cli._build_trainer(cfg, "cpu")
    want = params_from_safetensors(str(hf_folder), cfg.model, device="cpu")
    got = bridge.params_to_numpy(tr.state.params)
    for (path, a), (_, b) in zip(
            sorted(_flat(got).items()),
            sorted(_flat(bridge.params_to_numpy(want)).items())):
        np.testing.assert_array_equal(a, b, err_msg=path)
    tr.close()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def test_eval_from_checkpoint(runs, hf_folder, capsys):
    rc = cli.main(["eval", *TINY, "--set", f"model.model_name={hf_folder}",
                   "--set", f"train.output_dir={runs['port']}",
                   "--set", "train.resume_from_checkpoint=auto",
                   "--device", "cpu"])
    assert rc == 0
    assert "avg_auroc" in capsys.readouterr().out


def test_predict_writes_report(runs, hf_folder):
    rc = cli.main(["predict", *TINY, "--set", f"model.model_name={hf_folder}",
                   "--set", f"train.output_dir={runs['port']}",
                   "--set", "train.resume_from_checkpoint=auto",
                   "--device=cpu"])
    assert rc == 0
    text = (runs["port"] / "final_classification_report.txt").read_text()
    assert "precision" in text and "samples avg" in text


def test_export_reads_back_bit_for_bit_and_in_hf(runs, tmp_path):
    transformers = pytest.importorskip("transformers")
    model_dir = runs["port"] / "model"
    out = tmp_path / "hf_export"
    assert cli.main(["export", "--model-dir", str(model_dir),
                     "--out", str(out)]) == 0
    cfg = tconfig.Config.from_json((model_dir / "config.json").read_text())
    params, classes = load_model(str(model_dir), tvit.ViT(cfg.model))
    back = params_from_safetensors(str(out), cfg.model, device="cpu")
    for (n, a), b in zip(params.named_parameters(), back.parameters()):
        assert torch.equal(a, b), n
    hf = transformers.ViTForImageClassification.from_pretrained(
        str(out)).eval()
    x = np.random.default_rng(0).standard_normal(
        (2, 3, 64, 64)).astype(np.float32)
    with torch.no_grad():
        theirs = hf(pixel_values=torch.from_numpy(x)).logits.numpy()
        ours = tvit.apply(params, torch.from_numpy(
            x.transpose(0, 2, 3, 1).copy()), cfg.model).numpy()
    np.testing.assert_allclose(ours, theirs, atol=HF_TOL)
    assert hf.config.id2label[0] == classes[0]
    cfg_json = json.loads((out / "config.json").read_text())
    assert cfg_json["problem_type"] == "multi_label_classification"


@pytest.mark.parametrize("method", ["rollout", "gradcam"])
def test_maps_write_overlays(runs, tmp_path, capsys, method):
    paths = [_png(tmp_path / f"x{i}.png", shape, i)
             for i, shape in enumerate([(96, 80), (64, 64)])]
    out_dir = tmp_path / "overlays"
    rc = cli.main(["maps", *paths, "--model-dir",
                   str(runs["port"] / "model"), "--out-dir", str(out_dir),
                   "--method", method, "--device", "cpu"])
    assert rc == 0
    for i, shape in enumerate([(96, 80), (64, 64)]):
        overlay = np.asarray(Image.open(out_dir / f"x{i}_attn.png"))
        assert overlay.shape == (*shape, 3)
    assert capsys.readouterr().out.count("top:") == 2


def test_quantize_writes_the_artifact(runs, tmp_path, capsys):
    model_dir = runs["port"] / "model"
    calib = [_png(tmp_path / f"c{i}.png", (64, 64), 10 + i)
             for i in range(2)]
    rc = cli.main(["quantize", "--model-dir", str(model_dir), "--mode",
                   "static", "--calibration", *calib, "--device", "cpu"])
    assert rc == 0
    meta = json.loads((model_dir / "quantized" / "quantized.json")
                      .read_text())
    assert meta["mode"] == "static"
    pred = Predictor.from_model_dir(str(model_dir), quantize="static",
                                    device="cpu")
    assert "loaded int8 artifact" in capsys.readouterr().err
    out = pred.predict_arrays([np.zeros((64, 64), np.uint8)])
    assert out.probs.shape == (1, len(pred.classes))
    with pytest.raises(SystemExit, match="matched no files"):
        cli.main(["quantize", "--model-dir", str(model_dir),
                  "--calibration", "--device", "cpu"])
    # the XLA compile cache flag of the JAX CLI is not taken
    with pytest.raises(SystemExit):
        cli.main(["quantize", "--model-dir", str(model_dir),
                  "--compilation-cache", str(tmp_path)])


def test_smoke(tmp_path, capsys):
    assert cli.main(["smoke", "--device", "cpu", "--set",
                     f"train.output_dir={tmp_path}"]) == 0
    assert "'smoke': 'ok'" in capsys.readouterr().out


def test_unknown_command_and_help(capsys):
    assert cli.main(["frobnicate"]) == 2
    assert "unknown command" in capsys.readouterr().out
    assert cli.main([]) == 0
    assert cli.main(["--help"]) == 0
    text = capsys.readouterr().out
    for cmd in ("train", "eval", "predict", "smoke", "maps", "export",
                "quantize", "serve", "--device"):
        assert cmd in text, cmd


def test_serve_routes_to_the_server(monkeypatch):
    from chestxray_vit_tpu_torch.serve import server
    seen = []
    monkeypatch.setattr(server, "main", lambda argv: seen.append(argv) or 0)
    argv = ["--model-dir", "m", "--device", "cpu", "--port", "0"]
    assert cli.main(["serve", *argv]) == 0
    assert seen == [argv]


def test_device_option():
    assert cli._pop_device(["--set", "a=b"]) == ("cuda", ["--set", "a=b"])
    assert cli._pop_device(["--device", "cpu", "--set", "a=b"]) == \
        ("cpu", ["--set", "a=b"])
    assert cli._pop_device(["--set", "a=b", "--device=cuda:1"]) == \
        ("cuda:1", ["--set", "a=b"])
