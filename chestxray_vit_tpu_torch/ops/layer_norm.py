"""LayerNorm over the last dim: f32 statistics, HF eps 1e-12, output in
x's dtype, with the memory-lean gradient of the JAX package's custom VJP.

- ``layer_norm``: a ``torch.autograd.Function`` that saves only ``x`` and
  ``scale`` (as ``chestxray_vit_tpu/ops/layer_norm.py``'s ``_fwd`` does) and
  recomputes mean, var and x̂ in the backward. CUDA tensors take the
  hand-written kernels in both directions (``csrc/layer_norm.cu`` and
  ``csrc/layer_norm_bwd.cu``: the ports of ``_ln_fwd_kernel`` and
  ``_ln_bwd_kernel``); CPU tensors take the plain versions.
- ``layer_norm_reference`` / ``layer_norm_bwd_reference``: plain PyTorch,
  the math of ``_forward_xla`` / ``_bwd_xla``, and the oracles the kernels
  are held against.
- ``layer_norm_cuda`` / ``layer_norm_bwd_cuda``: the kernel wrappers, each
  with a launch counter.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from chestxray_vit_tpu_torch import kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain PyTorch LayerNorm (the math of ``_forward_xla``)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    xhat = (x32 - mean) * torch.rsqrt(var + eps)
    y = xhat * scale.float() + bias.float()
    return y.to(x.dtype)


def layer_norm_bwd_reference(x: torch.Tensor, scale: torch.Tensor,
                             dy: torch.Tensor, eps: float
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain LayerNorm backward (the math of ``_bwd_xla``): dx in x's
    dtype, dscale and dbias summed over every leading dim and cast to
    ``scale.dtype``."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = (x32 - mean) * inv
    dy32 = dy.float()
    rows = tuple(range(dy32.dim() - 1))
    dscale = (dy32 * xhat).sum(dim=rows)
    dbias = dy32.sum(dim=rows)
    g = dy32 * scale.float()
    dx = (g - g.mean(dim=-1, keepdim=True)
          - xhat * (g * xhat).mean(dim=-1, keepdim=True)) * inv
    return dx.to(x.dtype), dscale.to(scale.dtype), dbias.to(scale.dtype)


class LayerNorm(torch.autograd.Function):
    """LayerNorm whose backward saves only x and scale."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        if x.device.type == "cpu":
            return layer_norm_reference(x, scale, bias, eps)
        return layer_norm_cuda(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, ds, db = layer_norm_bwd_reference(x, scale, dy, ctx.eps)
        else:
            dx, ds, db = layer_norm_bwd_cuda(x, scale, dy, ctx.eps)
        return dx, ds, db, None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis: the CUDA kernels for CUDA tensors, the
    plain versions for CPU tensors, in both directions."""
    return LayerNorm.apply(x, scale, bias, eps)


def _check_params(x: torch.Tensor, *params: Tuple[str, torch.Tensor]
                  ) -> None:
    d = x.shape[-1]
    for name, t in params:
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if t.shape != (d,) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous [{d}], got "
                             f"{tuple(t.shape)}")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} dtype {t.dtype} not supported")
    if x.dtype not in _DTYPE_CODES or len({t.dtype for _, t in params}) > 1:
        raise TypeError(f"unsupported dtypes x {x.dtype}, "
                        + ", ".join(f"{n} {t.dtype}" for n, t in params))
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(
            f"layer_norm kernel needs a contiguous, 16-byte aligned x; got "
            f"shape {tuple(x.shape)}, strides {x.stride()}")


def layer_norm_cuda(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch the LayerNorm forward kernel: x contiguous [..., D] in f32 or
    bf16 (any D ≥ 1: rows of up to 2048 columns in whole 16-byte vectors
    run the register rungs, any other D the any-D kernel of
    ``csrc/layer_norm.cu``: a warp a row off the vector up to 256 columns,
    else a block a row from registers, read once a pass past 4096 columns
    off the vector, 8192 bf16 or 4096 f32 in whole vectors), scale/bias
    contiguous [D] in f32 or bf16 on x's device. Builds no graph: gradients
    go through :func:`layer_norm`."""
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_cuda needs CUDA tensors, got {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        raise RuntimeError("layer_norm_cuda builds no autograd graph; call "
                           "layer_norm for gradients")
    _check_params(x, ("scale", scale), ("bias", bias))
    # the kernel reads scale and bias in 16-byte pieces
    scale, bias = (t.clone() if t.data_ptr() % 16 else t
                   for t in (scale, bias))
    d = x.shape[-1]
    y = torch.empty_like(x)
    err = kernels.library().cxr_layer_norm_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        x.numel() // d, d, eps, _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype],
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "layer_norm")
    layer_norm_cuda.launches += 1
    return y


layer_norm_cuda.launches = 0     # kernel launches, read by chip_smoke.py


# rows of a backward block's first turn: its eight warps' (a row a warp on
# the rungs and off the vector up to 256 columns; a block a row past them,
# a cluster of blocks a row of whole vectors past 8192 bf16 / 4096 f32
# columns, and a range of rows of the two-pass form take them one after
# another)
_BWD_ROWS_PER_BLOCK = 8
# the backward's wave (its blocks resident on the card at once) by (device
# index, D, x dtype, scale dtype): asked of the library once, so that a
# launch makes one ctypes call
_BWD_WAVES: dict = {}


def _bwd_blocks(x: torch.Tensor, scale: torch.Tensor, rows: int) -> int:
    """Blocks of the backward kernel for ``rows`` rows (clusters of blocks
    or ranges of rows at the widest rows: what the library's wave counts):
    one a ``_BWD_ROWS_PER_BLOCK`` rows, at most one wave
    (``_BWD_WAVES``)."""
    key = (x.device.index, x.shape[-1], x.dtype, scale.dtype)
    wave = _BWD_WAVES.get(key)
    if wave is None:
        got = ctypes.c_int(0)
        kernels.check(kernels.library().cxr_layer_norm_bwd_wave(
            x.shape[-1], _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype],
            x.device.index, ctypes.byref(got)), "layer_norm_bwd")
        wave = _BWD_WAVES[key] = got.value
    return max(1, min(-(-rows // _BWD_ROWS_PER_BLOCK), wave))


def _bwd_two_pass(d: int, x_dtype: torch.dtype) -> bool:
    """Whether the backward at width ``d`` takes the library's two-pass
    form, which writes four f32 statistics a row after the partials: rows
    off the 16-byte vector past 4096 columns, and rows of whole vectors
    past a cluster of eight blocks (bf16 d > 65536, f32 d > 32768)."""
    per_vector = 128 // torch.finfo(x_dtype).bits
    if d % per_vector:
        return d > 4096
    return d // per_vector > 8 * 1024


def _bwd_workspace(n_blocks: int, rows: int, d: int, x_dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """The backward's f32 workspace: ``n_blocks`` partial [2, d] rows, then
    four statistics a row where the two-pass form runs
    (``_bwd_two_pass``)."""
    stats = 4 * rows if _bwd_two_pass(d, x_dtype) else 0
    return torch.empty(n_blocks * 2 * d + stats, dtype=torch.float32,
                       device=device)


def layer_norm_bwd_cuda(x: torch.Tensor, scale: torch.Tensor,
                        dy: torch.Tensor, eps: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the LayerNorm backward kernel: (dx in x's dtype, dscale and
    dbias in scale's dtype). Deterministic: each block of one wave (a
    cluster of blocks a row of whole vectors past 8192 bf16 or 4096 f32
    columns) keeps its rows' f32 sums on chip and writes them once, and a
    column pass adds the blocks' sums in block order; off the vector past
    4096 columns and past a cluster of eight, a pass writes each row's
    statistics and column-tiled blocks walk ranges of rows."""
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_bwd_cuda needs CUDA tensors, got "
                         f"{x.device}")
    _check_params(x, ("scale", scale))
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} on {dy.device} does not "
                         f"match x {tuple(x.shape)} on {x.device}")
    dy = dy.to(x.dtype).contiguous()
    if dy.data_ptr() % 16:
        dy = dy.clone()
    d = x.shape[-1]
    rows = x.numel() // d
    n_blocks = _bwd_blocks(x, scale, rows)
    dx = torch.empty_like(x)
    dscale = torch.empty(d, dtype=scale.dtype, device=x.device)
    dbias = torch.empty(d, dtype=scale.dtype, device=x.device)
    work = _bwd_workspace(n_blocks, rows, d, x.dtype, x.device)
    err = kernels.library().cxr_layer_norm_bwd(
        x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dscale.data_ptr(), dbias.data_ptr(), work.data_ptr(), rows, d, eps,
        n_blocks, _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype],
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "layer_norm_bwd")
    layer_norm_bwd_cuda.launches += 1
    return dx, dscale, dbias


layer_norm_bwd_cuda.launches = 0   # kernel launches, read by chip_smoke.py
