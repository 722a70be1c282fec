"""Attention-map overlay rendering, the port's copy of the framework-free
``chestxray_vit_tpu/serve/visualize.py`` (numpy, PIL, and matplotlib when
it is installed; held equal to the original by
``tests/test_torch_attention_maps.py``).

Turns [g, g] saliency maps (attention rollout / Grad-CAM) into heatmap
overlays on the source X-ray, saved as PNG.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def overlay_heatmap(gray: np.ndarray, saliency: np.ndarray,
                    alpha: float = 0.45) -> np.ndarray:
    """u8 grayscale [H, W] + [g, g] map → u8 RGB [H, W, 3] overlay.

    The map is bilinearly upsampled to the image size and blended with a
    matplotlib 'jet'-like colormap computed inline (no matplotlib needed in
    the serving path)."""
    h, w = gray.shape
    sal = _bilinear_upsample(saliency.astype(np.float32), h, w)
    sal = (sal - sal.min()) / max(sal.max() - sal.min(), 1e-12)
    heat = _jet(sal)                                     # [H, W, 3] f32
    base = np.repeat(gray[..., None].astype(np.float32) / 255.0, 3, axis=2)
    out = (1 - alpha) * base + alpha * heat
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)


def save_overlay(path: str, gray: np.ndarray, saliency: np.ndarray,
                 alpha: float = 0.45,
                 title: Optional[str] = None) -> str:
    from PIL import Image
    img = overlay_heatmap(gray, saliency, alpha)
    Image.fromarray(img, "RGB").save(path)
    return path


def save_prediction_panel(path: str, gray: np.ndarray,
                          saliency: np.ndarray,
                          findings: Sequence[dict]) -> str:
    """Side-by-side panel (original | overlay) with top findings as the
    title, via matplotlib when available; falls back to the bare overlay."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:                                   # noqa: BLE001
        return save_overlay(path, gray, saliency)
    fig, axes = plt.subplots(1, 2, figsize=(8, 4))
    axes[0].imshow(gray, cmap="gray")
    axes[0].set_title("input")
    axes[1].imshow(overlay_heatmap(gray, saliency))
    axes[1].set_title("attention")
    for ax in axes:
        ax.axis("off")
    label = ", ".join(f"{f['label']} {f['probability']:.2f}"
                      for f in findings[:3])
    fig.suptitle(label)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def _bilinear_upsample(x: np.ndarray, h: int, w: int) -> np.ndarray:
    gh, gw = x.shape
    ys = (np.arange(h) + 0.5) * gh / h - 0.5
    xs = (np.arange(w) + 0.5) * gw / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, gh - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, gw - 1)
    y1 = np.clip(y0 + 1, 0, gh - 1)
    x1 = np.clip(x0 + 1, 0, gw - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None]
    wx = np.clip(xs - x0, 0, 1)[None, :]
    a = x[np.ix_(y0, x0)]
    b = x[np.ix_(y0, x1)]
    c = x[np.ix_(y1, x0)]
    d = x[np.ix_(y1, x1)]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)


def _jet(v: np.ndarray) -> np.ndarray:
    """Minimal jet colormap on [0, 1] values → RGB f32."""
    r = np.clip(1.5 - np.abs(4 * v - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * v - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * v - 1), 0, 1)
    return np.stack([r, g, b], axis=-1)
