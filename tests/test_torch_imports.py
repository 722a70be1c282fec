"""The PyTorch port imports no JAX, no Triton and no compiled library.

The modules are imported in a fresh interpreter, so that nothing the test
process already imported (the JAX package's tests import JAX) can hide an
import.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "chestxray_vit_tpu_torch",
    "chestxray_vit_tpu_torch.kernels",
    "chestxray_vit_tpu_torch.ops.gelu",
    "chestxray_vit_tpu_torch.ops.layer_norm",
    "chestxray_vit_tpu_torch.ops.flash_attention",
    "chestxray_vit_tpu_torch.ops.preprocess",
    "chestxray_vit_tpu_torch.models.vit",
    "chestxray_vit_tpu_torch.models.bridge",
    "chestxray_vit_tpu_torch.train.optimizer",
    "chestxray_vit_tpu_torch.train.steps",
    "chestxray_vit_tpu_torch.eval.metrics",
    "chestxray_vit_tpu_torch.serve.inference",
    "chestxray_vit_tpu_torch.serve.server",
]


@pytest.fixture(scope="module")
def imported():
    """Import the modules one after another in one fresh interpreter and
    record, after each, which JAX/Triton modules are loaded and whether the
    kernel library is. A module that pulls one in shows it at its own step
    (what earlier steps loaded is already recorded against them)."""
    code = (
        "import importlib, json, sys\n"
        "out = {}\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "    from chestxray_vit_tpu_torch import kernels\n"
        "    out[name] = {'mods': sorted(m for m in sys.modules if "
        "m.split('.')[0] in ('jax', 'jaxlib', 'triton')),"
        " 'lib_loaded': kernels._lib is not None}\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_no_jax_or_triton(imported, module):
    assert imported[module] == {"mods": [], "lib_loaded": False}
