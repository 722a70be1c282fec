"""The PyTorch port imports no JAX, no Triton, nothing of the JAX package
(``chestxray_vit_tpu``) and no compiled library; neither does
``chip_smoke.py``. The HF and cloud packages the card's machine may lack
(``transformers``, ``safetensors``, ``datasets``, ``google.cloud``) are
imported only inside the functions that need them, never at import time.

The modules are imported in a fresh interpreter, so that nothing the test
process already imported (the JAX package's tests import JAX) can hide an
import. Imports inside functions run only when the function does, so every
source file is also read for import statements.
"""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "triton", "chestxray_vit_tpu")
# (torch itself loads the ``google`` namespace package)
LAZY = ("transformers", "safetensors", "datasets", "google.cloud.storage")

MODULES = [
    "chestxray_vit_tpu_torch",
    "chestxray_vit_tpu_torch.config",
    "chestxray_vit_tpu_torch.cli",
    "chestxray_vit_tpu_torch.kernels",
    "chestxray_vit_tpu_torch.data.decode",
    "chestxray_vit_tpu_torch.data.geometry",
    "chestxray_vit_tpu_torch.data.packing",
    "chestxray_vit_tpu_torch.data.storage",
    "chestxray_vit_tpu_torch.data.metadata",
    "chestxray_vit_tpu_torch.data.pipeline",
    "chestxray_vit_tpu_torch.data.testing",
    "chestxray_vit_tpu_torch.data.processor",
    "chestxray_vit_tpu_torch.data.hf_datasets",
    "chestxray_vit_tpu_torch.utils.logging",
    "chestxray_vit_tpu_torch.utils.tfevents",
    "chestxray_vit_tpu_torch.utils.flops",
    "chestxray_vit_tpu_torch.utils.profiling",
    "chestxray_vit_tpu_torch.utils.safetensors",
    "chestxray_vit_tpu_torch.ops.gelu",
    "chestxray_vit_tpu_torch.ops.layer_norm",
    "chestxray_vit_tpu_torch.ops.flash_attention",
    "chestxray_vit_tpu_torch.ops.hidden_dropout",
    "chestxray_vit_tpu_torch.ops.preprocess",
    "chestxray_vit_tpu_torch.ops.quant",
    "chestxray_vit_tpu_torch.ops.int8_matmul",
    "chestxray_vit_tpu_torch.ops.tome",
    "chestxray_vit_tpu_torch.models.remat",
    "chestxray_vit_tpu_torch.models.vit",
    "chestxray_vit_tpu_torch.models.bridge",
    "chestxray_vit_tpu_torch.models.quantized",
    "chestxray_vit_tpu_torch.models.packed",
    "chestxray_vit_tpu_torch.models.tome_forward",
    "chestxray_vit_tpu_torch.models.int8_train",
    "chestxray_vit_tpu_torch.models.export_hf",
    "chestxray_vit_tpu_torch.models.import_hf",
    "chestxray_vit_tpu_torch.train.optimizer",
    "chestxray_vit_tpu_torch.train.steps",
    "chestxray_vit_tpu_torch.train.checkpoint",
    "chestxray_vit_tpu_torch.train.trainer",
    "chestxray_vit_tpu_torch.train.packed_trainer",
    "chestxray_vit_tpu_torch.parallel.distributed",
    "chestxray_vit_tpu_torch.parallel.mesh",
    "chestxray_vit_tpu_torch.parallel.fsdp",
    "chestxray_vit_tpu_torch.parallel.tensor",
    "chestxray_vit_tpu_torch.parallel.launch",
    "chestxray_vit_tpu_torch.dryrun",
    "chestxray_vit_tpu_torch.eval.metrics",
    "chestxray_vit_tpu_torch.serve.batcher",
    "chestxray_vit_tpu_torch.serve.attention_maps",
    "chestxray_vit_tpu_torch.serve.visualize",
    "chestxray_vit_tpu_torch.serve.inference",
    "chestxray_vit_tpu_torch.serve.server",
    "chip_smoke",
]
# every module of the package with code (empty package markers are
# imported with their modules)
PACKAGE = sorted(
    os.path.relpath(p, REPO)[:-3].replace(os.sep, ".").removesuffix(
        ".__init__")
    for p in glob.glob(os.path.join(REPO, "chestxray_vit_tpu_torch", "**",
                                    "*.py"), recursive=True)
    if os.path.getsize(p))
SOURCES = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "chestxray_vit_tpu_torch", "**", "*.py"),
              recursive=True)
    + [os.path.join(REPO, f) for f in ("chip_smoke.py", "profile_step.py",
                                            "smoke_batches.py",
                                            "tile_skip_probe.py",
                                            "attn_probe.py",
                                            "examples/train_smoke_torch.py",
                                            "examples/finetune_nih_torch.py"
                                            )])


@pytest.fixture(scope="module")
def imported():
    """Import the modules one after another in one fresh interpreter and
    record, after each, which JAX, Triton or JAX-package modules are loaded,
    which of the LAZY packages are, and whether the kernel library is. A module that pulls one in shows it at its own step
    (what earlier steps loaded is already recorded against them)."""
    code = (
        "import importlib, json, sys\n"
        "out = {}\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "    from chestxray_vit_tpu_torch import kernels\n"
        "    out[name] = {'mods': sorted(m for m in sys.modules if "
        f"m.split('.')[0] in {FORBIDDEN!r}),"
        " 'lib_loaded': kernels._lib is not None,"
        " 'lazy': sorted(m for m in sys.modules if any("
        f"(m + '.').startswith(p + '.') for p in {LAZY!r}))}}\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_every_module_of_the_port_is_walked():
    """A module added to the package joins MODULES, so the fresh
    interpreter imports it too."""
    assert sorted(set(PACKAGE) - set(MODULES)) == []


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_no_jax_or_triton(imported, module):
    assert imported[module] == {"mods": [], "lib_loaded": False,
                                "lazy": []}


@pytest.mark.parametrize("source", SOURCES)
def test_source_has_no_forbidden_import(source):
    """No import statement, at top level or inside a function, names JAX,
    Triton or the JAX package."""
    with open(os.path.join(REPO, source)) as f:
        tree = ast.parse(f.read(), source)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert [n for n in names if n.split(".")[0] in FORBIDDEN] == []
