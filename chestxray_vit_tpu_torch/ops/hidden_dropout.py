"""Hidden dropout: ``where(keep, x / (1 − rate), 0)`` in x's dtype, the keep
mask a counter hash of each element's global index.

The reference (``chestxray_vit_tpu/models/vit.py``, ``_dropout``) draws
``jax.random.bernoulli`` at the global batch's shape inside one jitted
step. The port draws from the attention dropout's hash instead
(``flash_attention.keep_mask``: murmur3's finalizer of a uint32 counter
XOR the mixed seed): element (b, t, c) of an activation [B, S, D] whose
first row is global batch row ``row_base`` hashes the counter
((row_base + b)·S + t)·D + c. So the mask depends on the seed and the
global position alone: a data-parallel rank's slice draws the rows of the
global batch's mask, a remat recompute redraws the same bits, and the card
and the CPU draw equal masks. The JAX package's stream (``jax.random``) is
another one, as it is for the attention dropout's XLA path.

- ``hidden_keep_mask``: the mask, plain integer tensor code (uint32
  arithmetic in int64).
- ``hidden_dropout_reference``: the plain function on any device; the
  CPU path and the kernel's oracle.
- ``hidden_dropout_cuda``: the kernel wrapper (``csrc/hidden_dropout.cu``,
  which has no Pallas counterpart), with a launch counter.
- ``hidden_dropout``: the differentiable entry point. The backward is the
  same function on the upstream gradient (the mask is regenerated, none
  is stored). CPU tensors take the plain version, CUDA tensors the kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch

from chestxray_vit_tpu_torch import kernels
from chestxray_vit_tpu_torch.ops.flash_attention import (_M32, _fmix32,
                                                         _mul32,
                                                         dropout_constants)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def hidden_keep_mask(shape: Sequence[int], seed: int, rate: float,
                     row_base: int = 0, device=None) -> torch.Tensor:
    """The keep mask, bool ``shape`` = [B, S, D] (the middle dims, if more
    than one, count as one S): element (b, t, c) hashes the counter
    ((row_base + b)·S + t)·D + c (uint32, wrapping) XOR the mixed seed of
    :func:`dropout_constants` and is kept when the hash reaches its
    threshold."""
    b, d = shape[0], shape[-1]
    s = 1
    for n in shape[1:-1]:
        s *= n
    seed_mix, threshold = dropout_constants(seed, rate)
    kw = {"dtype": torch.int64, "device": device}
    row = (torch.arange(b, **kw) + (int(row_base) & _M32)) & _M32
    token = (_mul32(row, s)[:, None] + torch.arange(s, **kw)) & _M32
    counter = (_mul32(token, d)[..., None] + torch.arange(d, **kw)) & _M32
    return (_fmix32(counter ^ seed_mix) >= threshold).reshape(shape)


def hidden_dropout_reference(x: torch.Tensor, seed: int, rate: float,
                             row_base: int = 0) -> torch.Tensor:
    """Plain hidden dropout on x's device: survivors divided by 1 − rate
    in f32 (a tensor divisor, so the card divides as the CPU does) and
    rounded once to x's dtype, the rest 0."""
    keep = hidden_keep_mask(x.shape, seed, rate, row_base, x.device)
    keep_prob = torch.tensor(1.0 - rate, dtype=torch.float32,
                             device=x.device)
    return torch.where(keep, x.float() / keep_prob, 0.0).to(x.dtype)


def hidden_dropout_cuda(x: torch.Tensor, seed: int, rate: float,
                        row_base: int = 0) -> torch.Tensor:
    """Launch the hidden-dropout kernel on a CUDA tensor (f32 or bf16, made
    contiguous): a new tensor of x's shape and dtype. Builds no graph:
    gradients go through :func:`hidden_dropout`."""
    if x.device.type != "cuda":
        raise ValueError(f"hidden_dropout_cuda needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"hidden dropout kernel takes f32 or bf16, got "
                        f"{x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"expected [B, ..., D], got {tuple(x.shape)}")
    seed_mix, threshold = dropout_constants(seed, rate)
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    err = kernels.library().cxr_hidden_dropout(
        x.data_ptr(), y.data_ptr(), x.numel(), x[0].numel(),
        int(row_base) & _M32, seed_mix, threshold, 1.0 - rate,
        _DTYPE_CODES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "hidden_dropout")
    hidden_dropout_cuda.launches += 1
    return y


hidden_dropout_cuda.launches = 0     # kernel launches, read by chip_smoke.py


def _drop(x: torch.Tensor, seed: int, rate: float,
          row_base: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return hidden_dropout_reference(x, seed, rate, row_base)
    return hidden_dropout_cuda(x, seed, rate, row_base)


class HiddenDropout(torch.autograd.Function):
    """Hidden dropout in both directions through :func:`_drop`: the
    backward drops the upstream gradient with the same mask and scale, so
    nothing is saved."""

    @staticmethod
    def forward(ctx, x, seed, rate, row_base):
        ctx.args = (int(seed), rate, int(row_base))
        return _drop(x, *ctx.args)

    @staticmethod
    def backward(ctx, dy):
        return _drop(dy, *ctx.args), None, None, None


def hidden_dropout(x: torch.Tensor, seed: int, rate: float,
                   row_base: int = 0) -> torch.Tensor:
    """Hidden dropout of x [B, S, D] with ``seed`` at ``rate``, x's first
    row global batch row ``row_base``: the kernel for CUDA tensors, the
    plain version for CPU tensors, in both directions."""
    return HiddenDropout.apply(x, seed, rate, row_base)
