"""Attention-map extraction, ported from
``chestxray_vit_tpu/serve/attention_maps.py``: attention rollout and
Grad-CAM.

- **attention rollout** (Abnar & Zuidema 2020): fuse the heads of each
  layer, add the residual identity, row-normalize, and chain-multiply over
  the layers; the CLS row over the patch tokens becomes a [grid × grid]
  saliency map.
- **Grad-CAM** adapted to the ViT: gradients of a class logit with respect
  to the tokens entering a block (the last by default); the
  channel-weighted, ReLU'd sum over the patch tokens.

Both run the unrolled forward of ``models/vit.py`` (``run_block``): plain
attention with f32 scores and softmax, LayerNorm on its kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from chestxray_vit_tpu_torch.config import ModelConfig
from chestxray_vit_tpu_torch.models import vit


def _normalize01(maps: torch.Tensor) -> torch.Tensor:
    """Each [g, g] map min-max normalized to [0, 1]."""
    mn = maps.amin(dim=(1, 2), keepdim=True)
    mx = maps.amax(dim=(1, 2), keepdim=True)
    return (maps - mn) / (mx - mn).clamp_min(1e-12)


def attention_rollout(attn_probs: torch.Tensor, head_fuse: str = "mean",
                      residual_alpha: float = 0.5) -> torch.Tensor:
    """[L, B, H, S, S] attention probabilities → [B, g, g] CLS saliency.

    Per layer: fuse the heads (mean / max / min), blend with the identity
    for the residual stream (A ← α·A + (1 − α)·I, re-normalized), then
    multiply the chain bottom-up. The CLS row over the patch tokens,
    normalized to [0, 1], reshaped to the patch grid."""
    if head_fuse == "mean":
        fused = attn_probs.mean(dim=2)
    elif head_fuse == "max":
        fused = attn_probs.amax(dim=2)
    elif head_fuse == "min":
        fused = attn_probs.amin(dim=2)
    else:
        raise ValueError(f"unknown head_fuse {head_fuse!r}")
    fused = fused.float()                                # [L, B, S, S]
    _, b, s, _ = fused.shape
    eye = torch.eye(s, dtype=torch.float32, device=fused.device)
    blended = residual_alpha * fused + (1.0 - residual_alpha) * eye
    blended = blended / blended.sum(dim=-1, keepdim=True)
    rollout = eye.expand(b, s, s)
    for a in blended:                                    # the reference's scan
        rollout = torch.matmul(a, rollout)
    g = int((s - 1) ** 0.5)
    return _normalize01(rollout[:, 0, 1:].reshape(b, g, g))


def compute_rollout(params: vit.ViT, images: torch.Tensor, cfg: ModelConfig,
                    head_fuse: str = "mean"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward and rollout in one call: (logits, [B, g, g] maps)."""
    logits, probs = vit.apply_with_attention(params, images, cfg)
    return logits, attention_rollout(probs, head_fuse=head_fuse)


def grad_cam(params: vit.ViT, images: torch.Tensor, cfg: ModelConfig,
             class_idx: Union[torch.Tensor, int],
             layer: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ViT Grad-CAM: (logits, [B, g, g] maps) for ``class_idx`` (an int or
    one index per image). ``layer`` selects which block's input tokens act
    as the feature map (default: the last block; gradients still reach the
    patch tokens through its attention, unlike the CLS-only head). Runs
    ``torch.autograd.grad`` through ``vit.run_block``, also where the
    caller has gradients off."""
    dt = vit.torch_dtype(cfg.dtype)
    layer = cfg.num_layers - 1 if layer is None else layer
    with torch.no_grad():
        blocks = vit.unstack_blocks(params, cfg, dt)
        x = vit.embed(params, images, cfg, dt)
        for bp in blocks[:layer]:
            x, _ = vit.run_block(x, bp, cfg)
    feats = x.requires_grad_()                           # [B, S, D]
    with torch.enable_grad():
        y = feats
        for bp in blocks[layer:]:
            y, _ = vit.run_block(y, bp, cfg)
        logits = vit.head_logits(params, y, cfg)         # [B, C]
        idx = torch.as_tensor(class_idx, device=logits.device).broadcast_to(
            (logits.shape[0],))
        score = logits.gather(1, idx[:, None].long()).sum()
        grads, = torch.autograd.grad(score, feats)
    feats32 = feats.detach().float()
    # channel weights: the mean gradient over tokens (GAP in CNN Grad-CAM)
    weights = grads.float().mean(dim=1, keepdim=True)    # [B, 1, D]
    cam = (weights * feats32).sum(-1).clamp_min(0.0)[:, 1:]   # drop CLS
    g = int(cam.shape[1] ** 0.5)
    return logits.detach(), _normalize01(cam.reshape(-1, g, g))


def _bilinear_weights(out_size: int, in_size: int) -> np.ndarray:
    """[out, in] f32 resampling matrix of ``jax.image.resize(method=
    "bilinear")`` along one axis (``compute_weight_mat`` with the triangle
    kernel, antialiased): sample points (i + 0.5)/scale − 0.5, the kernel
    widened by 1/scale when shrinking, each column's weights renormalized
    over the taps inside the input (so the edges replicate), and samples
    outside [−0.5, in − 0.5] zero. Built in f32, as there."""
    f32 = np.float32
    inv_scale = f32(1.0) / (f32(out_size) / f32(in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale \
        - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).T.astype(f32)


def upsample_map(maps: torch.Tensor, out_size: int) -> torch.Tensor:
    """[B, g, g] → [B, out, out] bilinear resize for overlay rendering,
    the numerics of ``jax.image.resize(..., method="bilinear")`` (edges
    and shrinking included) as two matrix products."""
    wh = torch.from_numpy(_bilinear_weights(out_size, maps.shape[1])).to(
        maps.device)
    ww = torch.from_numpy(_bilinear_weights(out_size, maps.shape[2])).to(
        maps.device)
    return torch.matmul(torch.matmul(wh, maps.float()), ww.T).to(maps.dtype)


def render_overlay(gray, map01, alpha: float = 0.45):
    """u8 [H, W] radiograph + [g, g] normalized attention map → RGB u8
    overlay (red-yellow heat blended over the image): the host-side
    rendering. Pure numpy/PIL."""
    from PIL import Image

    h, w = gray.shape
    m = np.asarray(
        Image.fromarray((np.clip(np.asarray(map01, np.float32), 0, 1)
                         * 255).astype(np.uint8), "L")
        .resize((w, h), Image.BILINEAR), np.float32) / 255.0
    base = (1.0 - alpha) * gray.astype(np.float32)
    out = np.stack([
        base + alpha * 255.0 * m,              # red ∝ attention
        base + alpha * 255.0 * 0.6 * m * m,    # yellow tint at the peak
        base,
    ], axis=-1)
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)
