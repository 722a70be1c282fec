"""Port ``ViT`` → HF weight export, from
``chestxray_vit_tpu/models/export_hf.py`` (the inverse of
``models/import_hf.py``).

A model fine-tuned in the port loads back into HF
``ViTForImageClassification`` (torch): ``hf_state_dict_from_params`` undoes
the import's layout transforms in numpy on the JAX parameter tree that
``models/bridge.params_to_numpy`` gives, so the names stay in one place;
``export_hf_folder`` writes a ``from_pretrained``-loadable folder through
the port's own safetensors writer (``utils/safetensors.py``), so no
``safetensors`` package is needed.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping

import numpy as np
import torch

from chestxray_vit_tpu_torch.config import PROCESSOR_MEAN, PROCESSOR_STD
from chestxray_vit_tpu_torch.models import bridge
from chestxray_vit_tpu_torch.models.vit import ViT
from chestxray_vit_tpu_torch.utils import safetensors as st


def hf_state_dict_from_params(params: ViT, patch_size: int = 16
                              ) -> Dict[str, np.ndarray]:
    """A port ``ViT`` → the HF ``ViTForImageClassification`` state dict,
    as f32 numpy arrays."""
    p = _flatten(bridge.params_to_numpy(params))
    d = p["patch_embed/kernel"].shape[1]
    sd: Dict[str, np.ndarray] = {}

    conv = p["patch_embed/kernel"].reshape(patch_size, patch_size, 3, d)
    sd["vit.embeddings.patch_embeddings.projection.weight"] = \
        conv.transpose(3, 2, 0, 1)
    sd["vit.embeddings.patch_embeddings.projection.bias"] = \
        p["patch_embed/bias"]
    sd["vit.embeddings.cls_token"] = p["cls_token"]
    sd["vit.embeddings.position_embeddings"] = p["pos_embed"]
    sd["vit.layernorm.weight"] = p["final_ln/scale"]
    sd["vit.layernorm.bias"] = p["final_ln/bias"]
    sd["classifier.weight"] = p["head/kernel"].T
    sd["classifier.bias"] = p["head/bias"]

    l = p["blocks/wq/kernel"].shape[0]
    pairs = [
        ("attention.attention.query", "wq"),
        ("attention.attention.key", "wk"),
        ("attention.attention.value", "wv"),
        ("attention.output.dense", "wo"),
        ("intermediate.dense", "mlp_in"),
        ("output.dense", "mlp_out"),
    ]
    for i in range(l):
        base = f"vit.encoder.layer.{i}"
        for hf_name, ours in pairs:
            sd[f"{base}.{hf_name}.weight"] = p[f"blocks/{ours}/kernel"][i].T
            sd[f"{base}.{hf_name}.bias"] = p[f"blocks/{ours}/bias"][i]
        sd[f"{base}.layernorm_before.weight"] = p["blocks/ln1/scale"][i]
        sd[f"{base}.layernorm_before.bias"] = p["blocks/ln1/bias"][i]
        sd[f"{base}.layernorm_after.weight"] = p["blocks/ln2/scale"][i]
        sd[f"{base}.layernorm_after.bias"] = p["blocks/ln2/bias"][i]
    return sd


def save_safetensors(path: str, params: ViT, patch_size: int = 16) -> None:
    """Write ``params``' HF state dict as f32 to a ``.safetensors`` file."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
          for k, v in hf_state_dict_from_params(params, patch_size).items()}
    st.save_file(sd, path, metadata={"format": "pt"})


def write_preprocessor_config(directory: str, img_size: int,
                              image_mean=None, image_std=None) -> None:
    """Emit ``preprocessor_config.json`` so
    ``ViTImageProcessor.from_pretrained(directory)`` reproduces this
    framework's preprocessing (resize → 1/255 rescale → mean/std
    normalize), as the reference's ``Trainer(tokenizer=processor)
    .save_model()`` writes it. Defaults are the google/vit processor's
    0.5 / 0.5."""
    cfg = {
        "image_processor_type": "ViTImageProcessor",
        "do_resize": True,
        "size": {"height": img_size, "width": img_size},
        "resample": 2,                      # PILImageResampling.BILINEAR
        "do_rescale": True,
        "rescale_factor": 1.0 / 255.0,
        "do_normalize": True,
        "image_mean": list(image_mean or PROCESSOR_MEAN),
        "image_std": list(image_std or PROCESSOR_STD),
    }
    path = os.path.join(os.path.expanduser(directory),
                        "preprocessor_config.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2)


def export_hf_folder(directory: str, params: ViT, model_cfg, classes=None,
                     image_mean=None, image_std=None) -> None:
    """Write a complete ``from_pretrained``-loadable folder:
    ``model.safetensors`` + an HF ``ViTForImageClassification``
    config.json (multi-label problem type, id2label from ``classes``) +
    ``preprocessor_config.json`` (``ViTImageProcessor``-loadable)."""
    directory = os.path.expanduser(directory)
    os.makedirs(directory, exist_ok=True)
    save_safetensors(os.path.join(directory, "model.safetensors"),
                     params, model_cfg.patch_size)
    write_preprocessor_config(directory, model_cfg.img_size,
                              image_mean, image_std)
    names = (list(classes) if classes
             else [str(i) for i in range(model_cfg.num_classes)])
    hf_cfg = {
        "architectures": ["ViTForImageClassification"],
        "model_type": "vit",
        "image_size": model_cfg.img_size,
        "patch_size": model_cfg.patch_size,
        "num_channels": 3,
        "hidden_size": model_cfg.hidden_size,
        "num_hidden_layers": model_cfg.num_layers,
        "num_attention_heads": model_cfg.num_heads,
        "intermediate_size": model_cfg.mlp_dim,
        "hidden_act": "gelu",
        "layer_norm_eps": model_cfg.layernorm_eps,
        "hidden_dropout_prob": model_cfg.hidden_dropout,
        "attention_probs_dropout_prob": model_cfg.attention_dropout,
        "qkv_bias": True,
        "problem_type": "multi_label_classification",
        "id2label": {str(i): n for i, n in enumerate(names)},
        "label2id": {n: i for i, n in enumerate(names)},
    }
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out
