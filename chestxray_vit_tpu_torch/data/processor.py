"""HF-compatible image processor of the port, a copy of
``chestxray_vit_tpu/data/processor.py``.

The reference preprocesses with HF ``ViTImageProcessor``; migrating users
keep the same call shape here:

    proc = ImageProcessor()                  # vit-base-patch16-384 defaults
    out = proc(images=[pil_or_numpy, ...])   # {'pixel_values': f32 [B,3,H,W]}

Numerics match HF for its default path (bilinear resize → rescale 1/255 →
mean/std 0.5 normalize). ``return_tensors="pt"`` returns a torch tensor
where the JAX package's ``"jax"`` returns a JAX array.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple, Union

import numpy as np

from chestxray_vit_tpu_torch.config import PROCESSOR_MEAN, PROCESSOR_STD


@dataclass
class ImageProcessor:
    size: int = 384
    do_resize: bool = True
    do_rescale: bool = True
    do_normalize: bool = True
    image_mean: Tuple[float, ...] = PROCESSOR_MEAN
    image_std: Tuple[float, ...] = PROCESSOR_STD
    data_format: str = "channels_first"   # HF default; 'channels_last' too

    def __call__(self, images: Union[Sequence, object],
                 return_tensors: str = "np") -> Dict[str, object]:
        if not isinstance(images, (list, tuple)):
            images = [images]
        out = np.stack([self._one(img) for img in images])
        if self.data_format == "channels_first":
            out = out.transpose(0, 3, 1, 2)
        if return_tensors == "pt":
            import torch
            return {"pixel_values": torch.from_numpy(
                np.ascontiguousarray(out))}
        return {"pixel_values": out}

    def _one(self, img) -> np.ndarray:
        from PIL import Image
        if isinstance(img, np.ndarray):
            mode = "L" if img.ndim == 2 else "RGB"
            img = Image.fromarray(img.astype(np.uint8), mode)
        img = img.convert("RGB")
        if self.do_resize:
            img = img.resize((self.size, self.size), Image.BILINEAR)
        x = np.asarray(img, dtype=np.float32)
        if self.do_rescale:
            x = x / 255.0
        if self.do_normalize:
            x = (x - np.asarray(self.image_mean, np.float32)) \
                / np.asarray(self.image_std, np.float32)
        return x
