"""Device-side preprocessing (``fused_preprocess``, ``normalize_u8`` and the
batch resolver ``prepare_pixel_values``), ported from
``chestxray_vit_tpu/ops/preprocess.py``.

Raw u8 grayscale canvases plus crop boxes in, normalized NHWC RGB out: the
crop, centered square padding, PIL-parity antialiased bilinear resize,
grayscale→RGB broadcast and processor normalization run on the tensor's
device. The separable resize is two f32 matrix products per image
(out = Wy · img · Wxᵀ), left to ``torch.matmul`` as the JAX package leaves
them to XLA; they need TF32 off on the card
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default) to
match the reference. The JAX ``vmap`` over images is an explicit batch dim.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from chestxray_vit_tpu_torch.config import PROCESSOR_MEAN, PROCESSOR_STD


def _resize_weights(out_size: int, src_extent: torch.Tensor, max_in: int
                    ) -> torch.Tensor:
    """[B, out_size, max_in] PIL-BILINEAR weights for resizing 1-D signals
    of length ``src_extent`` [B] living in slots [0, src_extent) of a
    ``max_in`` buffer.

    PIL semantics: scale = in/out; filter support = max(scale, 1); out pixel
    i samples around center (i+0.5)*scale; weights are clipped to the image
    extent and renormalized over in-bounds taps.
    """
    dev = src_extent.device
    src = src_extent.float()[:, None, None]                         # [B,1,1]
    scale = src / out_size
    fscale = torch.clamp(scale, min=1.0)
    centers = (torch.arange(out_size, dtype=torch.float32, device=dev)
               + 0.5)[None, :, None] * scale                        # [B,O,1]
    taps = (torch.arange(max_in, dtype=torch.float32, device=dev)
            + 0.5)[None, None, :]                                   # [1,1,I]
    dist = (centers - taps).abs() / fscale
    w = torch.clamp(1.0 - dist, min=0.0)
    w = torch.where(taps < src, w, 0.0)       # clip to image extent
    norm = w.sum(dim=-1, keepdim=True)
    return w / torch.clamp(norm, min=1e-12)


def _gather_axis(canvas: torch.Tensor, start: torch.Tensor,
                 offset: torch.Tensor, extent: torch.Tensor,
                 axis: int) -> torch.Tensor:
    """Map square-space positions to canvas positions along ``axis`` (1 or
    2 of [B, C, C]): square slot y holds canvas[start + y - offset] when
    offset ≤ y < offset + extent, else 0 (the centered black padding)."""
    n = canvas.shape[axis]
    pos = torch.arange(n, device=canvas.device)[None, :]             # [1, n]
    idx = pos - offset[:, None] + start[:, None]                     # [B, n]
    valid = (pos >= offset[:, None]) & (pos < (offset + extent)[:, None])
    # a box reaching past the canvas must yield black padding like the PIL
    # reference, not edge-replicated rows from a clamped index
    valid &= (idx >= 0) & (idx < n)
    idx = idx.clamp(0, n - 1)
    shape = [canvas.shape[0], 1, 1]
    shape[axis] = n
    idx = idx.reshape(shape).expand(canvas.shape)
    out = torch.gather(canvas, axis, idx)
    return out * valid.reshape(shape)


def _preprocess_batch(canvases: torch.Tensor, boxes: torch.Tensor,
                      out_size: int, stretch: torch.Tensor,
                      flip: torch.Tensor) -> torch.Tensor:
    """u8 [B, C, C] canvases + crop boxes (left, top, w, h) [B, 4] →
    f32 [B, out, out] in [0, 1]; ``stretch`` and ``flip`` are bool [B]."""
    cmax = canvases.shape[1]
    boxes = boxes.to(torch.int32)
    left, top, w, h = boxes.unbind(dim=1)

    side = torch.maximum(w, h)
    side_y = torch.where(stretch, h, side)
    side_x = torch.where(stretch, w, side)
    # centered pad offsets with integer halving; zero when stretching
    zero = torch.zeros_like(w)
    off_y = torch.where(stretch, zero,
                        torch.where(w > h, (w - h) // 2, zero))
    off_x = torch.where(stretch, zero,
                        torch.where(h > w, (h - w) // 2, zero))

    img = canvases.float()
    sq = _gather_axis(img, top, off_y, h, axis=1)
    sq = _gather_axis(sq, left, off_x, w, axis=2)

    wy = _resize_weights(out_size, side_y, cmax)            # [B, O, C]
    wx = _resize_weights(out_size, side_x, cmax)            # [B, O, C]
    out = torch.matmul(torch.matmul(wy, sq), wx.transpose(1, 2))
    out = torch.where(flip[:, None, None], out.flip(-1), out)
    return out / 255.0


def _normalize(gray: torch.Tensor, mean, std, dtype) -> torch.Tensor:
    mean_a = torch.tensor(mean, dtype=torch.float32, device=gray.device)
    std_a = torch.tensor(std, dtype=torch.float32, device=gray.device)
    return ((gray[..., None] - mean_a) / std_a).to(dtype)


def fused_preprocess(
    canvases: torch.Tensor,                  # u8 [B, C, C] grayscale
    boxes: torch.Tensor,                     # int [B, 4] (left, top, w, h)
    out_size: int = 384,
    stretch: bool = False,                   # False: pad-to-square
    flips: Optional[torch.Tensor] = None,    # bool [B] horizontal flip
    mean: Tuple[float, ...] = PROCESSOR_MEAN,
    std: Tuple[float, ...] = PROCESSOR_STD,
    dtype: torch.dtype = torch.float32,
    stretches: Optional[torch.Tensor] = None,   # bool [B] per-sample
) -> torch.Tensor:
    """Fused crop/pad/resize/normalize: [B, C, C] u8 → [B, out, out, 3].

    ``stretch=False`` crops, pads to a centered square and resizes;
    ``stretch=True`` resizes each axis independently. ``stretches``
    selects per sample instead."""
    b = canvases.shape[0]
    dev = canvases.device
    if flips is None:
        flips = torch.zeros(b, dtype=torch.bool, device=dev)
    if stretches is None:
        stretches = torch.full((b,), stretch, dtype=torch.bool, device=dev)
    gray = _preprocess_batch(canvases, boxes.to(dev), out_size,
                             stretches.to(dev), flips.to(dev))
    return _normalize(gray, mean, std, dtype)


def normalize_u8(images_u8: torch.Tensor,
                 mean: Tuple[float, ...] = PROCESSOR_MEAN,
                 std: Tuple[float, ...] = PROCESSOR_STD,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Host-resized path: u8 grayscale [B, H, W] → normalized RGB
    [B, H, W, 3] (rescale 1/255, processor mean/std)."""
    return _normalize(images_u8.float() / 255.0, mean, std, dtype)


def prepare_pixel_values(batch: dict, dtype: torch.dtype = torch.float32, *,
                         out_size: int = 384,
                         mean: Tuple[float, ...] = PROCESSOR_MEAN,
                         std: Tuple[float, ...] = PROCESSOR_STD
                         ) -> torch.Tensor:
    """Resolve a batch dict of tensors to normalized [B, H, W, 3] pixel
    values, from any of the three pipeline placements:

    - ``pixel_values``: pre-normalized NHWC, returned as it is;
    - ``pixel_values_u8``: host-resized [B, H, W] grayscale, normalized on
      the tensors' device;
    - ``canvas_u8`` + ``boxes`` (+ ``flips`` / ``stretches``): raw decode
      canvases, cropped, padded, resized and normalized on the device.
    """
    if "pixel_values" in batch:
        return batch["pixel_values"]
    if "canvas_u8" in batch:
        return fused_preprocess(
            batch["canvas_u8"], batch["boxes"], out_size,
            flips=batch.get("flips"), mean=mean, std=std, dtype=dtype,
            stretches=batch.get("stretches"))
    return normalize_u8(batch["pixel_values_u8"], mean=mean, std=std,
                        dtype=dtype)
