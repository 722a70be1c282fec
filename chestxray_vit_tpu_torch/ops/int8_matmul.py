"""int8 matmul with the fused static-int8 serving epilogue, ported from
``chestxray_vit_tpu/ops/int8_pallas.py``.

``int8_matmul_fused`` computes ``act(xq @ wqᵀ · scale + bias) [+ resid]``
with the int8 × int8 → int32 product, the per-channel dequantize, the bias,
an optional exact-erf GELU, an optional residual add and an optional
requantize to int8 for the next matmul, in one pass; with ``out_dtype``
int32 and no scale or bias it returns the exact int32 sums themselves (the
partial of a row product split over a tensor axis, summed over the ranks
as int32 before its one epilogue: ``models/int8_train.row_partial``):

- CUDA tensors launch the hand-written Hopper kernel
  (``csrc/int8_matmul.cu``, the port of ``_kernel``), with a launch
  counter; anything it does not take raises, there is no fallback;
- CPU tensors take :func:`int8_matmul_fused_reference`, the plain version
  and the kernel's oracle, whose outputs the kernel equals bit for bit.

The weight is ``[N, K]`` (K-contiguous, the port's ``QuantizedWeight``
layout), where the JAX function takes ``[K, N]``. ``quantize_static``
stays plain elementwise work on both devices, as the JAX package leaves it
to XLA fusion.
"""

from __future__ import annotations

from typing import Optional

import torch

from chestxray_vit_tpu_torch import kernels
from chestxray_vit_tpu_torch.ops.gelu import gelu as _gelu
from chestxray_vit_tpu_torch.ops.quant import (int8_product, int8_sums,
                                               quantize_static)

__all__ = ["int8_matmul_fused", "int8_matmul_fused_reference",
           "pad_k", "quantize_static"]

_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
              torch.int32: 3}
K_STEP = 64          # the kernel's K step (half its k tile): K is padded to it


def padded_k(k: int) -> int:
    """``k`` rounded up to a multiple of :data:`K_STEP`."""
    return -(-k // K_STEP) * K_STEP


def pad_k(t: torch.Tensor, k: Optional[int] = None) -> torch.Tensor:
    """``t [..., K]`` with zero columns appended up to ``k`` (default: K
    rounded up to a multiple of :data:`K_STEP`); ``t`` itself when it is
    that wide already. Exact for the int8 product: a zero column adds
    nothing to an integer sum and changes no absmax scale. A patch-14
    patch has K = 3 · 14 · 14 = 588, padded to 640."""
    k = padded_k(t.shape[-1]) if k is None else k
    if t.shape[-1] == k:
        return t
    return torch.nn.functional.pad(t, (0, k - t.shape[-1]))


def _at_one_k(xq: torch.Tensor, wq: torch.Tensor) -> tuple:
    """``xq`` and ``wq`` at one K that is a multiple of :data:`K_STEP`: a
    ``wq`` stored padded (``models/quantized.QuantDense``) takes ``xq``
    zero-padded up to it; operands that share a K off the step are both
    padded (one copy of each). Exact: a zero column adds nothing to an
    integer sum. Operands that fit neither are left for the check."""
    kx, kw = xq.shape[-1], wq.shape[-1]
    if kx == kw:
        return (xq, wq) if kx % K_STEP == 0 else (pad_k(xq), pad_k(wq))
    if kw == padded_k(kx):
        return pad_k(xq, kw), wq
    return xq, wq


def _check_int32_out(scale, bias, resid, gelu, qs, out_dtype) -> None:
    """The int32 out form takes no epilogue operand, every other form
    takes a scale and a bias."""
    if out_dtype == torch.int32:
        given = [name for name, t in (("scale", scale), ("bias", bias),
                                      ("resid", resid),
                                      ("out_quant_scale", qs))
                 if t is not None] + (["gelu"] if gelu else [])
        if given:
            raise ValueError(f"the int32 out form writes the raw sums and "
                             f"takes no {', '.join(given)}")
    elif scale is None or bias is None:
        raise ValueError(f"out_dtype {out_dtype} needs a scale and a bias "
                         f"(only the int32 out form takes neither)")


def int8_matmul_fused_reference(xq: torch.Tensor, wq: torch.Tensor,
                                scale: Optional[torch.Tensor] = None,
                                bias: Optional[torch.Tensor] = None, *,
                                resid: Optional[torch.Tensor] = None,
                                gelu: bool = False,
                                out_quant_scale: Optional[torch.Tensor] = None,
                                out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of :func:`int8_matmul_fused`, in the epilogue
    order of the TPU kernel: ``acc · scale + bias``, GELU, ``+ resid``,
    then ``clip(round(y · (1 / qs)))`` to int8 or a cast to ``out_dtype``;
    with ``out_dtype`` int32 the exact sums (``ops.quant.int8_sums``)."""
    _check_int32_out(scale, bias, resid, gelu, out_quant_scale, out_dtype)
    if out_dtype == torch.int32:
        return int8_sums(xq, wq)
    y = int8_product(xq, wq) * scale.float() + bias.float()
    if gelu:
        y = _gelu(y)
    if resid is not None:
        y = y + resid.float()
    if out_quant_scale is not None:
        inv = 1.0 / out_quant_scale.float()
        return torch.clamp(torch.round(y * inv), -127.0, 127.0).to(torch.int8)
    return y.to(out_dtype)


def _check(xq, wq, scale, bias, resid, qs, out_dtype) -> None:
    """Raise on any operand the kernel does not take."""
    dev = xq.device
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"xq and wq must be int8, got {xq.dtype}, {wq.dtype}")
    if wq.dim() != 2 or xq.shape[-1] != wq.shape[1]:
        raise ValueError(f"xq {tuple(xq.shape)} and wq [N, K] "
                         f"{tuple(wq.shape)} do not share K")
    n, k = wq.shape
    if k % K_STEP:
        raise ValueError(f"the int8 kernel takes K a multiple of {K_STEP}, "
                         f"got {k}: int8_matmul_fused pads it (pad_k)")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and (t.shape != (n,) or t.dtype != torch.float32):
            raise ValueError(f"{name} must be f32 [{n}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if out_dtype not in (torch.float32, torch.bfloat16, torch.int32):
        raise TypeError(f"out_dtype {out_dtype}: the kernel writes f32, "
                        f"bf16 or int32 (or int8 with out_quant_scale)")
    if resid is not None and (resid.shape != (*xq.shape[:-1], n)
                              or resid.dtype != out_dtype):
        raise ValueError(f"resid must be {out_dtype} {[*xq.shape[:-1], n]}, "
                         f"got {resid.dtype} {tuple(resid.shape)}")
    if qs is not None and qs.numel() != 1:
        raise ValueError(f"out_quant_scale must be a scalar, got "
                         f"{tuple(qs.shape)}")
    for name, t in (("xq", xq), ("wq", wq), ("scale", scale), ("bias", bias),
                    ("resid", resid), ("out_quant_scale", qs)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, xq on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("xq and wq must be 16-byte aligned (the kernel "
                         "copies 16-byte chunks of their rows)")


def int8_matmul_fused(xq: torch.Tensor, wq: torch.Tensor,
                      scale: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None, *,
                      resid: Optional[torch.Tensor] = None,
                      gelu: bool = False,
                      out_quant_scale: Optional[torch.Tensor] = None,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """``y = act(xq @ wqᵀ · scale + bias) [+ resid]`` in one kernel.

    xq: int8 ``[..., K]`` (pre-quantized activation, rows = every leading
    dim); wq: int8 ``[N, K]``; scale: f32 ``[N]``, the combined activation
    × per-channel weight scale (``x_scale * qw.scale``); bias: f32 ``[N]``.
    ``gelu`` applies the exact-erf GELU (before the residual); ``resid``
    (``[..., N]`` in ``out_dtype``) fuses the skip-connection add;
    ``out_quant_scale`` (f32 scalar tensor) requantizes the result to int8
    for the next matmul. Returns ``[..., N]`` in ``out_dtype`` or int8.
    ``out_dtype`` int32 takes none of scale, bias, resid, gelu and
    ``out_quant_scale`` and returns the exact sums ``xq @ wqᵀ``.
    Any N and K: xq's K may be wq's real K or, where wq is stored padded
    (``models/quantized.QuantDense``), that K before padding; a K off
    :data:`K_STEP` costs a zero-padded copy of xq, and of a wq not stored
    padded, a call (:func:`_at_one_k`); an N off 8 runs the kernel's
    element-wise tail epilogue.
    CPU tensors take :func:`int8_matmul_fused_reference`."""
    xq, wq = _at_one_k(xq, wq)
    if xq.device.type == "cpu":
        return int8_matmul_fused_reference(
            xq, wq, scale, bias, resid=resid, gelu=gelu,
            out_quant_scale=out_quant_scale, out_dtype=out_dtype)
    _check_int32_out(scale, bias, resid, gelu, out_quant_scale, out_dtype)
    if out_dtype != torch.int32:
        scale, bias = scale.float(), bias.float()
    qs = (out_quant_scale.float().reshape(1).contiguous()
          if out_quant_scale is not None else None)
    _check(xq, wq, scale, bias, resid, qs, out_dtype)
    # the kernel reads scale, bias and the residual in 16-byte pieces
    scale, bias, resid = (t.clone() if t is not None and t.data_ptr() % 16
                          else t for t in (scale, bias, resid))
    n, k = wq.shape
    out = torch.empty((*xq.shape[:-1], n), device=xq.device,
                      dtype=torch.int8 if qs is not None else out_dtype)
    err = kernels.library().cxr_int8_matmul_fused(
        xq.data_ptr(), wq.data_ptr(),
        scale.data_ptr() if scale is not None else None,
        bias.data_ptr() if bias is not None else None,
        resid.data_ptr() if resid is not None else None,
        qs.data_ptr() if qs is not None else None, out.data_ptr(),
        xq.numel() // k, n, k, int(gelu), _OUT_CODES[out.dtype],
        _OUT_CODES[resid.dtype] if resid is not None else -1,
        xq.device.index, torch.cuda.current_stream(xq.device).cuda_stream)
    kernels.check(err, "int8_matmul_fused")
    int8_matmul_fused.launches += 1
    return out


int8_matmul_fused.launches = 0   # kernel launches, read by chip_smoke.py
