"""chestxray_vit_tpu_torch — the PyTorch/CUDA port of ``chestxray_vit_tpu``
for NVIDIA Hopper (H100).

The JAX package beside it is the reference and stays unchanged; this
package mirrors its layout module for module. Framework-free modules of the
JAX package (``config``, ``data.decode``, ``data.geometry``,
``data.pipeline``, ``serve.batcher``) are imported from it, not copied.
Every TPU (Pallas) kernel on a ported path is a hand-written Hopper kernel
in ``csrc/``, built at first use (``kernels``), with a plain PyTorch twin
beside its wrapper.

Ported so far, at ViT-B/16 @384:

- the dense serving path (``serve.inference.Predictor``, ``serve.server``);
- the dense fine-tune and eval steps (``train.steps.make_train_step``,
  ``make_eval_step``) with AdamW, global-norm clipping, full remat and
  gradient accumulation (``train.optimizer``), and the on-device AUROC and
  F1 (``eval.metrics``).

Importing the package imports no JAX, no Triton and loads no compiled
library.
"""

__version__ = "0.1.0"

from chestxray_vit_tpu.config import (  # noqa: F401
    Config, ModelConfig, TrainConfig)

_LAZY = {
    "Predictor": ("chestxray_vit_tpu_torch.serve.inference", "Predictor"),
    "MicroBatcher": ("chestxray_vit_tpu.serve.batcher", "MicroBatcher"),
}


def __getattr__(name):
    """Lazy top-level serving API, as in the JAX package (keeps
    ``import chestxray_vit_tpu_torch`` light)."""
    if name in _LAZY:
        import importlib
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
