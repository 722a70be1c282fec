"""HF → port parameter import, from ``chestxray_vit_tpu/models/import_hf.py``.

The reference fine-tunes from ``ViTForImageClassification.from_pretrained``.
Here the same checkpoints (an HF folder or a ``.safetensors`` file, read by
the port's own reader, ``utils/safetensors.py``) become a port ``ViT``:
the layout transforms run in numpy as the JAX package's do (each torch
``nn.Linear`` ``[out, in]`` transposed, the patch conv ``[out, c, kh, kw]``
permuted to ``[kh·kw·c, out]``, the blocks stacked ``[L, …]``), and
``models/bridge.params_from_jax`` builds the ``ViT`` from that tree, so
the parameter names stay in one place.

The position embeddings keep the checkpoint's grid (the returned ``ViT``'s
``cfg`` has the checkpoint's image size); ``vit.adapt_params_to_img_size``
resamples them to the configured one, as the Trainer does.

A missing classifier, or one for another class count, is replaced by a
fresh head: truncated normal (std 0.02, cut at ±2σ), zero bias, drawn from
a ``torch.Generator`` seeded with ``seed``. That is HF's init for the new
head, not JAX's ``jax.random.key(seed)`` draw (ROADMAP Queue 3, "Random
streams").
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

from chestxray_vit_tpu_torch.config import ModelConfig
from chestxray_vit_tpu_torch.models import bridge
from chestxray_vit_tpu_torch.models.vit import ViT
from chestxray_vit_tpu_torch.utils import safetensors as st


def _to_np(t: Any) -> np.ndarray:
    """torch.Tensor (bf16 included) / np.ndarray → np.ndarray."""
    if isinstance(t, np.ndarray):
        return t
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def _fresh_head(d: int, num_classes: int, seed: int,
                dt: np.dtype) -> tuple:
    kernel = torch.empty(d, num_classes)
    nn.init.trunc_normal_(kernel, std=0.02, a=-0.04, b=0.04,
                          generator=torch.Generator().manual_seed(seed))
    return kernel.numpy().astype(dt), np.zeros((num_classes,), dt)


def params_from_hf_state_dict(state_dict: Mapping[str, Any],
                              cfg: ModelConfig,
                              dtype: str = "float32",
                              seed: int = 0, device="cuda") -> ViT:
    """An HF ``ViTForImageClassification`` state dict (torch tensors or
    numpy arrays) → a port ``ViT`` on ``device``, its leaves rounded to
    ``dtype`` and held in ``cfg.param_dtype``."""
    sd = {k: _to_np(v) for k, v in state_dict.items()}
    dt = np.dtype(dtype)
    g = lambda k: sd[k].astype(dt)

    d, l = cfg.hidden_size, cfg.num_layers
    conv = g("vit.embeddings.patch_embeddings.projection.weight")
    patch_kernel = conv.transpose(2, 3, 1, 0).reshape(-1, d)

    def lin(prefix):
        # stacked kernels [L, in, out], stacked biases [L, out]
        ks = [g(f"vit.encoder.layer.{i}.{prefix}.weight").T for i in range(l)]
        bs = [g(f"vit.encoder.layer.{i}.{prefix}.bias") for i in range(l)]
        return np.stack(ks), np.stack(bs)

    def ln(prefix):
        return (np.stack([g(f"vit.encoder.layer.{i}.{prefix}.weight")
                          for i in range(l)]),
                np.stack([g(f"vit.encoder.layer.{i}.{prefix}.bias")
                          for i in range(l)]))

    blocks = {}
    for ours, hf in (("wq", "attention.attention.query"),
                     ("wk", "attention.attention.key"),
                     ("wv", "attention.attention.value"),
                     ("wo", "attention.output.dense"),
                     ("mlp_in", "intermediate.dense"),
                     ("mlp_out", "output.dense")):
        kernel, bias = lin(hf)
        blocks[ours] = {"kernel": kernel, "bias": bias}
    for ours, hf in (("ln1", "layernorm_before"), ("ln2", "layernorm_after")):
        scale, bias = ln(hf)
        blocks[ours] = {"scale": scale, "bias": bias}

    tree = {
        "patch_embed": {
            "kernel": patch_kernel,
            "bias": g("vit.embeddings.patch_embeddings.projection.bias"),
        },
        "cls_token": g("vit.embeddings.cls_token"),
        "pos_embed": g("vit.embeddings.position_embeddings"),
        "blocks": blocks,
        "final_ln": {"scale": g("vit.layernorm.weight"),
                     "bias": g("vit.layernorm.bias")},
    }
    head = None
    if "classifier.weight" in sd:
        head = (g("classifier.weight").T, g("classifier.bias"))
        if head[0].shape[1] != cfg.num_classes:
            # the reference passes ignore_mismatched_sizes=True and
            # initializes a head for its own class count
            head = None
    if head is None:
        head = _fresh_head(d, cfg.num_classes, seed, dt)
    tree["head"] = {"kernel": head[0], "bias": head[1]}
    # the checkpoint's own grid: adapt_params_to_img_size resamples it
    img_size = cfg.patch_size * int(round(
        (tree["pos_embed"].shape[1] - 1) ** 0.5))
    if img_size != cfg.img_size:
        cfg = dataclasses.replace(cfg, img_size=img_size)
    return bridge.params_from_jax(tree, cfg).to(device)


def params_from_safetensors(path: str, cfg: ModelConfig,
                            dtype: str = "float32", seed: int = 0,
                            device="cuda") -> ViT:
    """Load from a ``model.safetensors`` file (an HF folder works too)."""
    if os.path.isdir(path):
        path = os.path.join(path, "model.safetensors")
    return params_from_hf_state_dict(st.load_file(path), cfg, dtype,
                                     seed=seed, device=device)


def load_pretrained(name_or_path: str, cfg: ModelConfig,
                    dtype: str = "float32", seed: int = 0,
                    device="cuda") -> Optional[ViT]:
    """Best-effort pretrained load: a local safetensors path or HF folder,
    else (with ``transformers`` installed) the HF cache or hub. Returns
    None when the weights are unreachable, and the caller falls back to
    random init, as the reference prints and degrades; a local path that
    fails to load degrades the same way."""
    if os.path.exists(name_or_path):
        try:
            return params_from_safetensors(name_or_path, cfg, dtype,
                                           seed=seed, device=device)
        except Exception as e:                        # noqa: BLE001
            print(f"[import_hf] local load failed: {e}")
            return None
    try:
        from transformers import ViTForImageClassification
        model = ViTForImageClassification.from_pretrained(
            name_or_path,
            num_labels=cfg.num_classes,
            ignore_mismatched_sizes=True,
        )
        return params_from_hf_state_dict(model.state_dict(), cfg, dtype,
                                         seed=seed, device=device)
    except Exception as e:                            # noqa: BLE001
        print(f"[import_hf] pretrained load failed ({e}); using random init")
        return None
