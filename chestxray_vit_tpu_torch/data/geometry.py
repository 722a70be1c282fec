"""Preprocessing geometry of the port and the host resize, copied from
``chestxray_vit_tpu/data/geometry.py`` (with ``BBox`` from
``data/metadata.py``) and ``data/pipeline.py::host_resize``.

The reference's PIL geometry as index math: crop windows and centered
pad-to-square. Both the host path (``host_resize``) and the device path
(``ops/preprocess.py``) read these offsets. The bounding-box crop
(``clamp_bbox``, ``select_crop``) is not copied yet: nothing in the port
crops to a box.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from chestxray_vit_tpu_torch.data import decode as dec


@dataclass(frozen=True)
class BBox:
    """One row of BBox_List_2017.csv: a finding's box in pixels."""
    label: str
    x: float
    y: float
    w: float
    h: float


@dataclass(frozen=True)
class CropBox:
    """Integer crop window in source-image coordinates."""
    left: int
    top: int
    width: int
    height: int


def full_image_box(img_w: int, img_h: int) -> CropBox:
    return CropBox(0, 0, img_w, img_h)


def pad_to_square_offsets(width: int, height: int) -> Tuple[int, int, int]:
    """(side, left_offset, top_offset) for centered pad-to-square: side =
    max(w, h), the image pasted at (0, (w-h)//2) when w > h and at
    ((h-w)//2, 0) when h > w."""
    side = max(width, height)
    if width > height:
        return side, 0, (width - height) // 2
    if height > width:
        return side, (height - width) // 2, 0
    return side, 0, 0


def host_resize(gray: np.ndarray, box: CropBox, out_size: int,
                stretch: bool = False, flip: bool = False,
                prefer_native: bool = True) -> np.ndarray:
    """The reference's host chain: crop → centered pad-to-square →
    bilinear resize to out_size² (``stretch=True`` skips the padding). The
    C++ stage when built (PIL-bit-exact), PIL otherwise."""
    if prefer_native:
        out = dec.crop_pad_resize_native(
            gray, box.left, box.top, box.width, box.height, out_size,
            stretch=stretch, flip=flip)
        if out is not None:
            return out
    from PIL import Image
    crop = gray[box.top:box.top + box.height, box.left:box.left + box.width]
    if stretch:
        square = crop
    else:
        side, left_off, top_off = pad_to_square_offsets(box.width, box.height)
        square = np.zeros((side, side), np.uint8)
        square[top_off:top_off + box.height,
               left_off:left_off + box.width] = crop
    out = Image.fromarray(square).resize((out_size, out_size),
                                         Image.BILINEAR)
    arr = np.asarray(out, dtype=np.uint8)
    return arr[:, ::-1] if flip else arr
