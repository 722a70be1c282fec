"""chestxray_vit_tpu_torch — the PyTorch/CUDA port of ``chestxray_vit_tpu``
for NVIDIA Hopper (H100).

The JAX package beside it is the reference and stays unchanged; this
package mirrors its layout module for module and imports nothing of it.
Where the port needs a framework-free module of the JAX package, it keeps
its own copy (``config``, ``data.decode``, ``data.geometry`` with
``host_resize``, ``data.packing``, ``data.storage``, ``data.metadata``,
``data.testing``, ``data.processor``, ``data.hf_datasets``,
``serve.batcher``, ``utils.logging``, ``utils.tfevents``,
``utils.flops``). Every TPU (Pallas) kernel on a ported
path is a hand-written Hopper kernel in ``csrc/``, built at first use
(``kernels``), with a plain PyTorch twin beside its wrapper.

Ported so far, at ViT-B/16 @384:

- the serving path (``serve.inference.Predictor``, ``serve.server``), dense
  and int8 (``quantize='static'`` through the fused int8 kernel, or
  ``'dynamic'``; ``models.quantized`` with the JAX package's artifact
  format);
- attention-rollout maps and Grad-CAM (``serve.attention_maps``,
  ``Predictor(..., with_maps=True)``, the server's ``?maps=1``) and their
  host-side rendering (``serve.visualize``);
- the fine-tune and eval steps (``train.steps.make_train_step``,
  ``make_eval_step``) with AdamW, global-norm clipping, every remat
  policy of the reference (``models.remat``), the fused Q/K/V projection
  and gradient accumulation (``train.optimizer``), attention dropout (the
  fused dropout kernels), hidden dropout and per-sample mixup, and the
  on-device AUROC and F1 (``eval.metrics``), and the int8 eval step;
- packed variable-resolution training (``data.packing``,
  ``models.packed``, ``train.steps.make_packed_train_step``) over the
  segment-masked attention kernels, with within-segment token merging
  (``ops.tome``) when ``model.tome_r`` is set;
- the training run (``train.trainer.Trainer``: cadences, checkpoints with
  exact resume in ``train.checkpoint``, evaluate / predict / save_model),
  its host data layer (``data.pipeline``) and logging (``utils``), and
  ``Predictor.from_model_dir`` for the model it saves;
- the packed training run (``train.packed_trainer.PackedTrainer``: the
  token census, host-sharded packing streams, image-count cursors, the
  packed eval);
- data-parallel training of both trainers over ``torch.distributed``
  (``parallel.distributed``, ``parallel.mesh``: one process per device
  under ``torchrun``, NCCL on the card, gloo on the CPU);
- data-parallel serving from one process
  (``Predictor(data_parallel=N)``, the server's ``--data-parallel N``:
  one weight replica and one stream per card, the bucket's rows split
  evenly and the outputs gathered in card order); ``device`` may list one
  device per replica, repeats allowed, so the CPU tests hold
  ``["cpu"] * N`` replicas against the JAX package's virtual devices and
  the card's smoke run emulates two cards with ``["cuda:0", "cuda:0"]``;
- the command line (``cli``: train, eval, predict, smoke, maps, export,
  quantize, serve, with ``--device``), HF weight import and export
  (``models.import_hf``, ``models.export_hf``, over the port's own
  safetensors reader and writer, ``utils.safetensors``), so the Trainer
  starts from HF weights, the ``hf_dataset`` backend and ``gs://``
  checkpoints.

Importing the package imports no JAX, no Triton and loads no compiled
library.
"""

__version__ = "0.1.0"

from chestxray_vit_tpu_torch.config import (  # noqa: F401
    Config, DataConfig, MeshConfig, ModelConfig, TrainConfig)

_LAZY = {
    "Trainer": ("chestxray_vit_tpu_torch.train.trainer", "Trainer"),
    "PackedTrainer": ("chestxray_vit_tpu_torch.train.packed_trainer",
                      "PackedTrainer"),
    "build_mesh": ("chestxray_vit_tpu_torch.parallel.mesh", "build_mesh"),
    "Predictor": ("chestxray_vit_tpu_torch.serve.inference", "Predictor"),
    "MicroBatcher": ("chestxray_vit_tpu_torch.serve.batcher", "MicroBatcher"),
}


def __getattr__(name):
    """Lazy top-level API, as in the JAX package (keeps
    ``import chestxray_vit_tpu_torch`` light)."""
    if name in _LAZY:
        import importlib
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
