"""Preprocessing geometry of the port and the host resize, copied from
``chestxray_vit_tpu/data/geometry.py`` (with ``BBox`` from
``data/metadata.py``) and ``data/pipeline.py::host_resize``.

The reference's PIL geometry as index math: the first-bbox crop with its
clamping and degenerate fallback (``clamp_bbox``, ``select_crop``),
centered pad-to-square, and torchvision's ``RandomResizedCrop`` window
(``sample_random_resized_crop``). Both the host path (``host_resize``) and
the device path (``ops/preprocess.py``) read these offsets.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

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


def clamp_bbox(bbox: BBox, img_w: int, img_h: int) -> Optional[CropBox]:
    """The reference's clamping: int-cast, clamp to the image; a
    degenerate result (empty crop or non-positive bbox) returns None and
    the caller falls back to the full image (pad_to_square)."""
    x, y, w, h = int(bbox.x), int(bbox.y), int(bbox.w), int(bbox.h)
    left = max(0, x)
    upper = max(0, y)
    right = min(img_w, x + w)
    lower = min(img_h, y + h)
    if right <= left or lower <= upper or w <= 0 or h <= 0:
        return None
    return CropBox(left, upper, right - left, lower - upper)


def select_crop(bbox: Optional[BBox], img_w: int, img_h: int) -> CropBox:
    """First-bbox-only semantics: crop to the clamped bbox when present and
    non-degenerate, else the whole image."""
    if bbox is not None:
        clamped = clamp_bbox(bbox, img_w, img_h)
        if clamped is not None:
            return clamped
    return full_image_box(img_w, img_h)


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


def sample_random_resized_crop(
    rng: np.random.Generator, img_w: int, img_h: int,
    scale: Tuple[float, float] = (0.08, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> CropBox:
    """torchvision ``RandomResizedCrop.get_params`` semantics (the
    reference's Version A train transform): 10 attempts at a random-area,
    log-uniform-ratio crop, then a center-crop fallback clamped to the
    ratio range."""
    area = img_h * img_w
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= img_w and 0 < h <= img_h:
            top = int(rng.integers(0, img_h - h + 1))
            left = int(rng.integers(0, img_w - w + 1))
            return CropBox(left, top, w, h)
    # fallback: center crop at the closest valid ratio
    in_ratio = img_w / img_h
    if in_ratio < ratio[0]:
        w = img_w
        h = int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        h = img_h
        w = int(round(h * ratio[1]))
    else:
        w, h = img_w, img_h
    top = (img_h - h) // 2
    left = (img_w - w) // 2
    return CropBox(left, top, w, h)


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
