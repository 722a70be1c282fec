"""Multi-head attention: softmax(QKᵀ·d^-½)·V, for serving and training.

- ``attention_reference``: plain PyTorch, the math of the JAX package's
  ``attention_xla`` (f32 scores and softmax, probabilities cast to v's
  dtype, f32-accumulated PV). The CPU path and the forward kernels' oracle.
- ``attention_fwd_reference`` / ``attention_bwd_reference``: the plain
  forward-with-logsumexp and backward, the math of the TPU kernels
  ``_fwd_kernel`` and ``_bwd_kernel``; the training kernels' oracles.
- ``flash_attention_inference``: the forward-only CUDA kernel
  (``csrc/flash_attention_inf.cu``, the port of ``_fwd_kernel_inf``).
- ``flash_attention_fwd`` / ``flash_attention_bwd``: the training kernels
  (``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``, the
  ports of ``_fwd_kernel`` and ``_bwd_kernel``), joined by the autograd
  function ``FlashAttention``, which saves q, k, v, o and lse as the JAX
  custom VJP does (``flash_residual`` and ``flash_out``).
- ``attention``: the dispatch of ``chestxray_vit_tpu.ops.flash_attention
  .attention``.

Each kernel wrapper runs its plain version for CPU tensors and launches its
kernel (or raises) for CUDA tensors. The TPU wrapper's tiling
(``_pick_block_bh``, ``_vmem_block_bh``, ``_q_blocking``, ``_prep`` and the
16/128-row padding) has no counterpart: the kernels read q, k, v, o and dO
in place through their strides and mask the ragged tail themselves.

The bf16 kernels round P to bf16 after the exp2, where the TPU kernels
round the exp2 argument (``flash_attention.py:332-334``); the plain
versions here round P at the same point as the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from chestxray_vit_tpu_torch import kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64       # the one head dim the kernel is built for


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention on [B, H, S, d] with f32 scores and softmax; output
    in q's dtype. Upcasting bf16 operands before the products gives the
    f32-accumulated product that ``preferred_element_type=f32`` asks for
    in the JAX reference."""
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def _scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return sm_scale if sm_scale is not None else 1.0 / (q.shape[-1] ** 0.5)


def attention_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, sm_scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward with the natural-log logsumexp: (o in q's dtype,
    lse f32 [B, H, S] = log Σ_k exp(s·scale), i.e. m·scale + ln l)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale(
        q, sm_scale)
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o.to(q.dtype), torch.logsumexp(s, dim=-1)


def attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            sm_scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain backward from the forward's o and lse (the math of
    ``_bwd_kernel``): P recomputed from lse and rounded to q's dtype,
    dV = Pᵀ·dO, dP = dO·Vᵀ, Δ = rowsum(dO∘O) in f32, dS = P∘(dP − Δ)
    rounded to q's dtype, dQ = dS·K·scale, dK = dSᵀ·Q·scale. Returns
    (dq, dk, dv) in q's dtype."""
    scale = _scale(q, sm_scale)
    qf, kf, vf = q.float(), k.float(), v.float()
    dof = do.to(q.dtype).float()
    s = torch.matmul(qf, kf.transpose(-1, -2))
    p = torch.exp(s * scale - lse.float()[..., None]).to(q.dtype).float()
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(q.dtype).float()
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _heads_merged(q: torch.Tensor) -> torch.Tensor:
    """An empty [B, H, S, d] view of a [B, S, H, d] buffer: merging the
    heads (or reading the projections' gradient) is then a view."""
    b, h, s, d = q.shape
    return torch.empty((b, s, h, d), dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_inference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              sm_scale: Optional[float] = None
                              ) -> torch.Tensor:
    """Forward-only fused attention for eval/serving (no lse output).

    q, k, v: [B, H, S, 64] in f32 or bf16, any strides with a contiguous
    head dim (the projections' [B, S, H, d] views are read in place). CPU
    tensors take :func:`attention_reference`. The output is [B, H, S, d]
    in q's dtype, laid out as [B, S, H, d] in memory so that merging the
    heads for the output projection is a view.
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v, sm_scale)
    _check(q, k, v)
    b, h, s, d = q.shape
    out = _heads_merged(q)
    err = kernels.library().cxr_attention_fwd_inf(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, s, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        _scale(q, sm_scale), _DTYPE_CODES[q.dtype], q.device.index,
        _stream(q))
    kernels.check(err, "flash_attention_inference")
    flash_attention_inference.launches += 1
    return out


flash_attention_inference.launches = 0   # kernel launches (chip_smoke.py)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward: (o, lse f32 [B, H, S]). CPU tensors take
    :func:`attention_fwd_reference`; CUDA tensors launch the kernel, which
    takes what :func:`flash_attention_inference` takes. o is laid out as
    [B, S, H, d] in memory."""
    if q.device.type == "cpu":
        return attention_fwd_reference(q, k, v, sm_scale)
    _check(q, k, v)
    b, h, s, d = q.shape
    out = _heads_merged(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = kernels.library().cxr_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, s, d, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *out.stride()[:3], _scale(q, sm_scale),
        _DTYPE_CODES[q.dtype], q.device.index, _stream(q))
    kernels.check(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0         # kernel launches (chip_smoke.py)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training backward: (dq, dk, dv) in q's dtype. CPU tensors take
    :func:`attention_bwd_reference`; CUDA tensors launch the kernel, and
    the gradients come back as [B, H, S, d] views of [B, S, H, d] buffers,
    the layout the projections' backward reads without a copy."""
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, o, lse, do, sm_scale)
    do = do.to(q.dtype)
    if not _fits(do):
        do = do.contiguous()
    _check(q, k, v, o=o, do=do)
    b, h, s, d = q.shape
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous f32 [{b}, {h}, {s}], got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    dq, dk, dv = _heads_merged(q), _heads_merged(q), _heads_merged(q)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    strides = [st for t in (q, k, v, o, do, dq, dk, dv)
               for st in t.stride()[:3]]
    strides_c = (ctypes.c_longlong * len(strides))(*strides)
    err = kernels.library().cxr_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, h, s, d,
        ctypes.addressof(strides_c), _scale(q, sm_scale),
        _DTYPE_CODES[q.dtype], q.device.index, _stream(q))
    kernels.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0         # kernel launches (chip_smoke.py)


class FlashAttention(torch.autograd.Function):
    """Attention with the training kernels in both directions. Saves q, k,
    v, o and lse, the residuals of the JAX custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale=None):
        o, lse = flash_attention_fwd(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.sm_scale)
        return dq, dk, dv, None


def _fits(t: torch.Tensor) -> bool:
    """A contiguous head dim, 16-byte aligned rows and (b, h, s) strides
    in whole 16-byte vectors: what the kernels read in place."""
    vec = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % vec == 0 for st in t.stride()[:3]))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           **more: torch.Tensor) -> None:
    """Raise on any operand the kernels do not take."""
    if q.device.type != "cuda":
        raise ValueError(f"the attention kernel needs CUDA tensors, got "
                         f"{q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "the attention kernel wrappers build no autograd graph; use "
            "attention(..., inference=False) or FlashAttention.apply for "
            "gradients")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"attention kernel takes f32 or bf16, got {q.dtype}")
    operands = {"k": k, "v": v, **more}
    for name, t in operands.items():
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, q is "
                             f"{q.dtype} on {q.device}")
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape "
                             f"{tuple(q.shape)}")
    if q.dim() != 4:
        raise ValueError(f"expected [B, H, S, d], got {tuple(q.shape)}")
    if q.shape[-1] != HEAD_DIM:
        raise NotImplementedError(
            f"head dim {q.shape[-1]}: the kernel is built for d = "
            f"{HEAD_DIM} only (other head dims are ROADMAP Queue 1 #13)")
    for name, t in {"q": q, **operands}.items():
        if not _fits(t):
            raise ValueError(
                f"{name} needs a contiguous head dim, 16-byte aligned rows "
                f"and strides that are multiples of "
                f"{16 // t.element_size()}; got strides {t.stride()}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              impl: str = "auto", inference: bool = False) -> torch.Tensor:
    """Dispatch as in the JAX package: ``impl='xla'`` runs the plain version
    on any device; ``'auto'`` and ``'pallas'`` run the kernels for CUDA
    tensors (the forward-only one when ``inference``, else
    :class:`FlashAttention`) and the plain version, under plain autograd,
    for CPU tensors."""
    if impl == "xla":
        return attention_reference(q, k, v)
    if impl not in ("auto", "pallas"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    if inference:
        return flash_attention_inference(q, k, v)
    return FlashAttention.apply(q, k, v)
