"""Symmetric int8 quantization primitives for the serving forward, ported
from ``chestxray_vit_tpu/ops/quant.py``.

- weights: symmetric per-output-channel int8 (scale = max|W[:, o]| / 127),
  computed once at load time (:func:`quantize_weight`);
- activations: per-row (per-token) dynamic int8 (:func:`int8_matmul`) or a
  static calibrated scalar scale (:func:`int8_matmul_static`);
- the product: int8 × int8 with exact integer sums, rescaled in an f32
  epilogue in the JAX order, ``acc · (x_scale · w_scale)`` then ``+ bias``.

Layout: a :class:`QuantizedWeight` keeps ``q`` as ``[out, in]``
(K-contiguous), the layout the hand-written int8 kernel and cuBLASLt read;
the JAX package keeps ``[in, out]``, and ``models/bridge.py`` transposes.

The int32 product here is the "xla" route's plain large product, which the
JAX package leaves to XLA outside any Pallas kernel: ``torch._int_mm``
(cuBLASLt) on the card, and on the CPU an exact float64 product (every
partial sum is an integer below 127²·K < 2⁵³). Rounding is ``torch.round``,
half to even as ``jnp.round``. Divisions by a constant divide by a device
scalar, because PyTorch's CUDA division by a Python number multiplies by
its reciprocal, which can differ from the JAX quotient in the last bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn


class QuantizedWeight(nn.Module):
    """Per-output-channel symmetric int8 weight: ``q`` int8 ``[out, in]``,
    ``scale`` f32 ``[out]``; ``w ≈ (q · scale[:, None])ᵀ``."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true f32 division on any device (see the module
    docstring)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _to_int8(q: torch.Tensor) -> torch.Tensor:
    return torch.clamp(q, -127.0, 127.0).to(torch.int8)


def weight_amax(w: torch.Tensor) -> torch.Tensor:
    """f32 ``max |w[:, o]|`` per output channel of an ``[in, out]``
    weight: the first half of :func:`quantize_weight_tensors`. A weight
    split over its input rows takes the max of the parts' (exact)."""
    return w.float().abs().amax(dim=0)                        # [out]


def quantize_weight_with_amax(w: torch.Tensor, amax: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The second half of :func:`quantize_weight_tensors`: ``w`` ``[in,
    out]`` (or some of its input rows) quantized at the scales of the
    per-channel ``amax`` → (int8 ``[out, in]``, f32 scales ``[out]``)."""
    scale = _div(torch.clamp_min(amax, 1e-8), 127.0)
    q = _to_int8(torch.round(w.float() / scale))
    return q.t().contiguous(), scale


def quantize_weight_tensors(w: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32/bf16 ``[in, out]`` (the JAX orientation) → (int8 ``[out, in]``,
    f32 per-output-channel scales ``[out]``): symmetric per-channel
    quantization as tensors, for a caller that quantizes live weights every
    step (the int8 training forward) and keeps no module."""
    return quantize_weight_with_amax(w, weight_amax(w))


def quantize_weight(w: torch.Tensor) -> QuantizedWeight:
    """f32/bf16 ``[in, out]`` (the JAX orientation) → per-output-channel
    symmetric int8, stored ``[out, in]``."""
    return QuantizedWeight(*quantize_weight_tensors(w))


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., in]`` → (int8 ``[..., in]``, f32 row scales ``[..., 1]``):
    symmetric per-row (per-token) dynamic quantization."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = _div(torch.clamp_min(amax, 1e-8), 127.0)
    return _to_int8(torch.round(xf / scale)), scale


def int8_sums(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact ``xq @ wqᵀ`` for int8 ``xq [..., K]`` and ``wq [N, K]``, as
    int32 ``[..., N]`` (the ``preferred_element_type=int32`` sums). A plain
    product outside any kernel: ``torch._int_mm`` on the card, float64 on
    the CPU (exact, see the module docstring) cast to int32."""
    lead, k = xq.shape[:-1], xq.shape[-1]
    n = wq.shape[0]
    x2 = xq.reshape(-1, k)
    if xq.device.type == "cpu":
        acc = torch.matmul(x2.double(), wq.double().t()).to(torch.int32)
    else:
        m = x2.shape[0]
        if m <= 16:     # cuBLASLt's int8 product takes more than 16 rows
            x2 = torch.cat([x2, x2.new_zeros(32 - m, k)])
        # ... and K and N multiples of 8: zero columns add nothing, zero
        # weight rows give columns that are sliced off
        pk, pn = -k % 8, -n % 8
        if pk or pn:
            x2 = torch.nn.functional.pad(x2, (0, pk))
            wq = torch.nn.functional.pad(wq, (0, pk, 0, pn))
        acc = torch._int_mm(x2.contiguous(), wq.t())[:m, :n]
    return acc.reshape(*lead, n)


def int8_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """:func:`int8_sums` as f32 (the int32 sums rounded to f32 once, as
    ``acc.astype(f32)`` does)."""
    return int8_sums(xq, wq).float()


def _epilogue(acc: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor], out_dtype) -> torch.Tensor:
    y = acc * scale
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def int8_matmul(x: torch.Tensor, qw: QuantizedWeight,
                bias: Optional[torch.Tensor] = None,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """``y = x @ dequantize(qw) + bias`` through one int8 product, with the
    row scale ⊗ channel scale applied to the integer sums.

    x: ``[..., in]`` float."""
    xq, xs = quantize_rows(x)
    return _epilogue(int8_product(xq, qw.q), xs * qw.scale, bias, out_dtype)


def quantize_static(x: torch.Tensor, x_scale) -> torch.Tensor:
    """``clip(round(x / x_scale), −127, 127)`` as int8, with a static
    (calibrated) f32 scalar scale. Plain elementwise work on both devices:
    the JAX package leaves it to XLA fusion (``int8_pallas.quantize_static``)."""
    s = torch.as_tensor(x_scale, dtype=torch.float32, device=x.device)
    return _to_int8(torch.round(x.float() / s))


def int8_matmul_static(x: torch.Tensor, qw: QuantizedWeight, x_scale,
                       bias: Optional[torch.Tensor] = None,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """:func:`int8_matmul` with a precomputed (calibration) activation
    scale, an f32 scalar; values beyond the calibration range saturate at
    ±127 by design."""
    s = torch.as_tensor(x_scale, dtype=torch.float32, device=x.device)
    return _epilogue(int8_product(quantize_static(x, s), qw.q),
                     s * qw.scale, bias, out_dtype)


def dequantize(qw: QuantizedWeight) -> torch.Tensor:
    """f32 reconstruction in the JAX orientation ``[in, out]``."""
    return qw.q.t().float() * qw.scale
