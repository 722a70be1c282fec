"""Analytic FLOPs accounting and MFU of the port, a copy of
``chestxray_vit_tpu/utils/flops.py``: model FLOPs per image (and per packed
sequence) from the ModelConfig, and MFU against the device's bf16 peak.

The peak table is the JAX package's TPU table with the NVIDIA H100 SXM's
dense bf16 peak (989 TFLOP/s, NVIDIA's data sheet) added; the device kind
comes from ``torch.cuda.get_device_name()``.
"""

from __future__ import annotations

from typing import Optional

from chestxray_vit_tpu_torch.config import ModelConfig

# bf16 dense peak FLOP/s by device kind (public spec sheets); the first
# key found in the lowered kind wins.
_PEAKS = (
    ("h100", 989e12),
    ("v5 lite", 197e12),
    ("v5e", 197e12),
    ("v6e", 918e12),
    ("v6", 918e12),
    ("v5p", 459e12),
    ("v5", 459e12),
    ("v4", 275e12),
    ("v3", 123e12),
)
_DEFAULT_PEAK = 197e12


def chip_peak_flops(device_kind: Optional[str] = None) -> float:
    """Peak bf16 FLOP/s for a device kind (default: the local CUDA
    device's name)."""
    if device_kind is None:
        import torch
        device_kind = torch.cuda.get_device_name()
    kind = device_kind.lower()
    for key, peak in _PEAKS:
        if key in kind:
            return peak
    return _DEFAULT_PEAK


def model_flops_per_image(cfg: ModelConfig, fwd_only: bool = False) -> float:
    """Analytic matmul FLOPs for one image (MACs ×2; elementwise is noise).

    ``fwd_only=False`` returns the fine-tune step cost (fwd + bwd = 3× fwd).
    Remat recompute is deliberately NOT counted: MFU measures useful math
    (the standard convention), so full-remat configs pay their recompute as
    lost MFU.
    """
    s = cfg.seq_len
    d, m = cfg.hidden_size, cfg.mlp_dim
    macs = cfg.num_patches * (cfg.patch_size ** 2 * 3) * d   # patch embed
    per_layer = (4 * s * d * d                               # qkv + proj
                 + 2 * s * s * d                             # QKᵀ + attn·V
                 + 2 * s * d * m)                            # mlp in + out
    macs += cfg.num_layers * per_layer
    macs += d * cfg.num_classes                              # head
    fwd = 2.0 * macs
    return fwd if fwd_only else 3.0 * fwd


def packed_flops_per_sequence(cfg: ModelConfig, seq_len: int,
                              fwd_only: bool = False) -> float:
    """Analytic matmul FLOPs for ONE packed sequence of ``seq_len`` tokens.
    Counts the full seq_len² attention area the segment-masked kernel
    executes (cross-segment products are computed, then masked), so packed
    MFU is executed-math utilization, an upper bound on useful-math MFU."""
    s = seq_len
    d, m = cfg.hidden_size, cfg.mlp_dim
    macs = s * (cfg.patch_size ** 2 * 3) * d                 # token embed
    per_layer = (4 * s * d * d + 2 * s * s * d + 2 * s * d * m)
    macs += cfg.num_layers * per_layer
    macs += d * cfg.num_classes
    fwd = 2.0 * macs
    return fwd if fwd_only else 3.0 * fwd


def mfu(images_per_sec_per_chip: float, cfg: ModelConfig,
        device_kind: Optional[str] = None) -> float:
    """Model FLOPs utilization of a measured training throughput."""
    return (images_per_sec_per_chip * model_flops_per_image(cfg)
            / chip_peak_flops(device_kind))
