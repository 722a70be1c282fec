"""HF export of the port, from ``chestxray_vit_tpu/models/export_hf.py``:
so far only ``write_preprocessor_config``, which ``Trainer.save_model``
writes beside the weights. The weight export to an HF
``ViTForImageClassification`` state dict waits for ROADMAP Queue 1 #6.
"""

from __future__ import annotations

import json
import os

from chestxray_vit_tpu_torch.config import PROCESSOR_MEAN, PROCESSOR_STD


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
