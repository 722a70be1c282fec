"""The port's examples (``examples/train_smoke_torch.py`` and
``examples/finetune_nih_torch.py``) run on the CPU, and the fine-tune
runbook takes the JAX script's flags plus ``--device``."""

import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
# the tiny model the CPU runs the fine-tune's dry run at
TINY_SETS = ("model.img_size=64", "model.hidden_size=64",
             "model.num_layers=2", "model.num_heads=4", "model.mlp_dim=128",
             "train.batch_size_per_core=4", "train.bf16=false")


def _run(args, cwd, timeout=600):
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _flags(name):
    with open(os.path.join(EXAMPLES, name)) as f:
        return set(re.findall(r'add_argument\(\s*"(--[a-z-]+)"', f.read()))


def test_train_smoke_torch_on_the_cpu(tmp_path):
    out = _run([os.path.join(EXAMPLES, "train_smoke_torch.py"), "--device",
                "cpu"], tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "top findings:" in out.stdout
    assert "attention map grid: (1, 4, 4)" in out.stdout
    assert (tmp_path / "smoke_outputs" / "model" / "params.pt").exists()


def test_finetune_nih_torch_dry_run_on_the_cpu(tmp_path):
    args = [os.path.join(EXAMPLES, "finetune_nih_torch.py"), "--dry-run",
            "--device", "cpu", "--output-dir", str(tmp_path / "ft"),
            "--expect-quant-band", "1.0", "--expect-tome-band", "1:1.0"]
    for kv in TINY_SETS:
        args += ["--set", kv]
    out = _run(args, tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "int8-static eval AUC" in out.stdout
    assert "tome r=1 eval AUC" in out.stdout
    ft = tmp_path / "ft"
    assert (ft / "model" / "params.pt").exists()
    assert (ft / "final_classification_report.txt").exists()
    with open(ft / "train_results.json") as f:
        assert json.load(f)["train_steps"] == 20
    assert sorted(os.listdir(ft / "checkpoints")) == ["10", "20"]


def test_finetune_flags_are_the_jax_scripts(tmp_path):
    jax_flags = _flags("finetune_nih.py")
    assert len(jax_flags) >= 10
    assert _flags("finetune_nih_torch.py") == jax_flags | {"--device"}
    assert _flags("train_smoke_torch.py") == {"--device"}


@pytest.mark.parametrize("weights", ["google/vit-base-patch16-384", None])
def test_finetune_refuses_a_hub_name(weights, tmp_path):
    """Without --dry-run the weights must be a local folder: a hub name (or
    the preset's default model name) is refused, nothing is fetched."""
    args = [os.path.join(EXAMPLES, "finetune_nih_torch.py"), "--device",
            "cpu", "--data-root", str(tmp_path)]
    if weights:
        args += ["--weights", weights]
    out = _run(args, tmp_path)
    assert out.returncode == 2
    assert "hub" in out.stdout + out.stderr
