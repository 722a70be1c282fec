"""int8 forward inside the train step, ported from
``chestxray_vit_tpu/models/int8_train.py``.

The forward computes every large projection as a static-scale int8
product, while the backward takes the gradients of the dense linear: the
straight-through estimator of quantization-aware training (round-trip
quantization is piecewise constant, so its gradient is taken as the
identity).

- Weights are quantized per output channel from the live weights at every
  forward (``ops.quant.quantize_weight_tensors``). The block weights are
  cast to the compute dtype first, as the reference casts its block tree
  before the layer scan, so in a bf16 run each channel's amax is taken
  over bf16-rounded weights; the patch embedding is quantized from f32.
- Activations use per-site static scalar scales calibrated once
  (``models.quantized.calibrate_vit_scales``); values beyond the range
  saturate at ±127 by design.
- The product is ``ops.int8_matmul.int8_matmul_fused`` with no GELU, no
  residual and no requantize: the hand-written int8 kernel on the card,
  its plain version (which equals ``ops.quant.int8_matmul_static`` bit for
  bit) on the CPU. The reference runs XLA's int8 ``dot_general`` here; its
  results are the same integer sums under the same f32 epilogue. GELU and
  the residual stay outside the kernel: the backward and hidden dropout
  need the pre-activation and the projection before the add.
- Backward: ``dx = g·Wᵀ`` and ``dW = xᵀ·g`` in the compute dtype, ``db =
  Σ g`` in f32, as plain products (the reference leaves them to XLA); no
  gradient for the scales.

Under full remat the backward recomputes this int8 forward, so the int8
products are half of all the forward passes' products.

On a tensor axis (a tree sharded by ``parallel/fsdp.shard_params``) the
block splits as ``vit._block`` splits it:

- the column products (``wq``, ``wk``, ``wv``, ``mlp_in``) hold whole
  output channels, so their per-channel scales are the whole tree's; the
  input passes ``tensor.copy_in`` before its one shared quantize;
- the row products (``wo``, ``mlp_out``) take the max of their local rows'
  per-channel amax over the tensor group (exact: the scales equal one
  process's bit for bit), quantize their rows, run the int8 kernel's
  int32 out form on the local K slice (the raw sums, no epilogue), sum
  the int32 partials over the group (exact in any order, as the one int32
  sum of the reference's ``dot_general`` is) and apply the reference's
  epilogue once, ``f32(acc) · (x_scale · w_scale) + bias``, cast to the
  compute dtype. That equals the one-process product bit for bit at every
  K (|acc| ≤ 3072 · 127² < 2³¹ at the largest, ``mlp_out``); partials
  rounded to f32 and summed in f32 would not, once a sum passes 2²⁴;
- the backward is the dense Megatron pair;
- a pair whose width the tensor size does not divide runs whole on every
  tensor rank, as one process runs it (no collective); q, k and v columns
  that cut a head are gathered into whole heads before the attention
  (``vit.RankHeads``), the int8 products staying on the rank's columns.
"""

from __future__ import annotations

import types
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from chestxray_vit_tpu_torch.config import ModelConfig
from chestxray_vit_tpu_torch.models import vit
from chestxray_vit_tpu_torch.models.quantized import _cls_pos
from chestxray_vit_tpu_torch.models.remat import checkpoint_name
from chestxray_vit_tpu_torch.ops.int8_matmul import (int8_matmul_fused,
                                                     quantize_static)
from chestxray_vit_tpu_torch.ops.layer_norm import layer_norm
from chestxray_vit_tpu_torch.ops.quant import (quantize_weight_tensors,
                                               quantize_weight_with_amax,
                                               weight_amax)
from chestxray_vit_tpu_torch.parallel import fsdp, tensor

Scales = Dict[str, Any]


class _Int8LinearSTE(torch.autograd.Function):
    """``y = int8(x / sx) · int8(W / sw) · (sx · sw) + b`` forward, the
    dense linear's gradients backward."""

    @staticmethod
    def forward(ctx, x, kernel, bias, x_scale, out_dtype, xq):
        wq, w_scale = quantize_weight_tensors(kernel)
        if xq is None:
            xq = quantize_static(x, x_scale)
        ctx.save_for_backward(x, kernel)
        ctx.out_dtype, ctx.bias_dtype = out_dtype, bias.dtype
        return int8_matmul_fused(xq, wq, x_scale * w_scale, bias.float(),
                                 out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        return _dense_grads(ctx, g) + (None, None, None)


def _dense_grads(ctx, g):
    """(dx, dkernel, dbias) of the dense linear ``x @ kernel + bias``:
    products in the compute dtype, the bias sum in f32."""
    x, kernel = ctx.saved_tensors
    dt = ctx.out_dtype
    gc = g.to(dt)
    dx = dk = db = None
    if ctx.needs_input_grad[0]:
        dx = torch.matmul(gc, kernel.to(dt).t()).to(x.dtype)
    if ctx.needs_input_grad[1]:
        dk = torch.matmul(x.to(dt).reshape(-1, x.shape[-1]).t(),
                          gc.reshape(-1, gc.shape[-1])).to(kernel.dtype)
    if ctx.needs_input_grad[2]:
        db = g.sum(dim=tuple(range(g.dim() - 1)),
                   dtype=torch.float32).to(ctx.bias_dtype)
    return dx, dk, db


def row_partial(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The exact int32 ``xq @ wqᵀ`` partial of a row-split product on the
    int8 kernel's int32 out form (which pads a local K off its step, as a
    slice of 32 at width 64)."""
    return int8_matmul_fused(xq, wq, out_dtype=torch.int32)


class _Int8RowSTE(torch.autograd.Function):
    """The row-parallel int8 straight-through linear on a tensor axis:
    forward, the per-channel scales over the tensor group (a max), the
    local int8 partials summed as int32 over the group, one epilogue in the
    reference's order; the dense row product's gradients backward (the
    identity of ``tensor.reduce_out`` before it)."""

    @staticmethod
    def forward(ctx, x, kernel, bias, x_scale, out_dtype, axis):
        amax = axis.all_reduce(weight_amax(kernel), op="max")
        wq, w_scale = quantize_weight_with_amax(kernel, amax)
        acc = axis.all_reduce(row_partial(quantize_static(x, x_scale), wq))
        ctx.save_for_backward(x, kernel)
        ctx.out_dtype, ctx.bias_dtype = out_dtype, bias.dtype
        return (acc.float() * (x_scale * w_scale)
                + bias.float()).to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        return _dense_grads(ctx, g) + (None, None, None)


def int8_linear_ste(x: torch.Tensor, kernel: torch.Tensor,
                    bias: torch.Tensor, x_scale,
                    out_dtype: torch.dtype = torch.bfloat16,
                    xq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 straight-through linear: ``x [..., in]``, ``kernel [in,
    out]`` (the JAX orientation), ``bias [out]``, ``x_scale`` an f32
    scalar (a calibration constant: no gradient); the result ``[...,
    out]`` in ``out_dtype``. Gradients reach x, kernel and bias in their
    dtypes. ``xq``, when given, is ``quantize_static(x, x_scale)`` already
    computed (one quantize shared by projections of the same input)."""
    s = torch.as_tensor(x_scale, dtype=torch.float32, device=x.device)
    return _Int8LinearSTE.apply(x, kernel, bias, s, out_dtype, xq)


def int8_row_linear_ste(x: torch.Tensor, kernel: torch.Tensor,
                        bias: torch.Tensor, x_scale, out_dtype: torch.dtype,
                        tp) -> torch.Tensor:
    """:func:`int8_linear_ste` of a row-parallel product whose ``kernel``
    holds this rank's input rows and ``x`` the matching input columns, on
    the tensor axis ``tp`` (a ``mesh.Axis``): the whole product, on every
    rank of the axis."""
    s = torch.as_tensor(x_scale, dtype=torch.float32, device=x.device)
    return _Int8RowSTE.apply(x, kernel, bias, s, out_dtype, tp)


def place_scales(scales: Scales, device) -> Scales:
    """A ``calibrate_vit_scales`` tree (torch or numpy leaves) as f32
    tensors on ``device``: ``{"patch": [], "blocks": {site: [L]}}``. Leaves
    already there are kept, so placing a placed tree copies nothing."""
    def put(v):
        if isinstance(v, torch.Tensor):
            return v.to(device=device, dtype=torch.float32)
        return torch.tensor(np.asarray(v, np.float32), device=device)
    return {"patch": put(scales["patch"]),
            "blocks": {site: put(v) for site, v in scales["blocks"].items()}}


def layer_scales(scales: Scales, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s four activation scales, by site."""
    return {site: v[i] for site, v in scales["blocks"].items()}


def embed(params: vit.ViT, images: torch.Tensor, cfg: ModelConfig,
          compute_dtype: torch.dtype, patch_scale) -> torch.Tensor:
    """The patch embedding on the int8 straight-through product (from the
    f32 patches and the f32 kernel), then CLS and position embeddings (a
    sharded tree's gathered at use, ``parallel/fsdp.py``)."""
    layout = params.layout
    pe = params.patch_embed
    x = int8_linear_ste(vit.patchify(images.float(), cfg.patch_size),
                        fsdp.use(layout, "patch_embed.kernel", pe.kernel,
                                 torch.float32),
                        fsdp.use(layout, "patch_embed.bias", pe.bias,
                                 pe.bias.dtype),
                        patch_scale, compute_dtype)
    if layout is not None:
        params = types.SimpleNamespace(**{
            n: fsdp.use(layout, n, getattr(params, n), compute_dtype)
            for n in ("cls_token", "pos_embed")})
    return _cls_pos(params, x, cfg)


def _proj(y: torch.Tensor, p, x_scale, dt: torch.dtype,
          xq: Optional[torch.Tensor] = None) -> torch.Tensor:
    return int8_linear_ste(y, p.kernel.to(dt), p.bias.to(dt), x_scale, dt,
                           xq)


def _row_proj(y: torch.Tensor, p, x_scale, dt: torch.dtype,
              tp) -> torch.Tensor:
    """:func:`_proj` of a row-parallel product (``wo``, ``mlp_out``): on a
    tensor axis ``tp`` the scales and the sum span the group."""
    if tp is None:
        return _proj(y, p, x_scale, dt)
    return int8_row_linear_ste(y, p.kernel.to(dt), p.bias.to(dt), x_scale,
                               dt, tp)


def attention_residual(x: torch.Tensor, bp, cfg: ModelConfig,
                       dt: torch.dtype, train: bool,
                       seeds: Optional[vit.LayerSeeds],
                       act: Dict[str, torch.Tensor],
                       return_key_mean: bool = False, row_base: int = 0,
                       tp=None):
    """``x + drop(wo(attention(q, k, v)))`` on LN1(x), every projection on
    the int8 straight-through product. The attention input is quantized
    once for q, k and v (the reference quantizes it three times with the
    same scale: the same int8 bits). q, k and v are named ``attn_heads``
    for the remat policies (the reference's ``attn`` policies drop them as
    the attention kernel's ``flash_residual``). With ``return_key_mean``
    also the keys' mean over heads, the token-merging metric. On a tensor
    axis ``tp`` ``bp`` holds the rank's columns and rows
    (``vit.RankHeads``): its whole heads, or the heads its columns touch
    after a gather, ``wo`` the row product, every head's keys for the
    metric."""
    attn_seed, seed_attn_out, _ = seeds or (None, None, None)
    hidden = cfg.hidden_dropout if train else 0.0
    a_in = layer_norm(x, bp.ln1.scale.to(dt), bp.ln1.bias.to(dt),
                      cfg.layernorm_eps)
    a_in, rh = vit._local_heads(a_in, cfg, tp)

    def heads():
        a8 = quantize_static(a_in, act["attn_in"])
        return tuple(rh.heads(_proj(a_in, getattr(bp, key), act["attn_in"],
                                    dt, a8))
                     for key in ("wq", "wk", "wv"))

    q, k, v = checkpoint_name("attn_heads", heads)
    o = vit.attend(rh.own(q), rh.own(k), rh.own(v), cfg, cfg.attention_impl,
                   train, attn_seed, row_base, rh.h0)
    attn_out = _row_proj(rh.merge(o), bp.wo, act["attn_out"], dt, tp)
    x = x + vit._dropout(attn_out, hidden, seed_attn_out, row_base)
    return (x, rh.key_mean(k)) if return_key_mean else x


def mlp_residual(x: torch.Tensor, bp, cfg: ModelConfig, dt: torch.dtype,
                 train: bool, seeds: Optional[vit.LayerSeeds],
                 act: Dict[str, torch.Tensor],
                 row_base: int = 0, tp=None) -> torch.Tensor:
    """``x + drop(mlp_out(GELU(mlp_in(LN2(x)))))`` on the int8
    straight-through product, the GELU output named ``mlp_hidden`` (on a
    tensor axis ``tp``, this rank's MLP columns, ``mlp_out`` the row
    product)."""
    seed_mlp_out = seeds[2] if seeds else None
    hidden = cfg.hidden_dropout if train else 0.0
    m_in = layer_norm(x, bp.ln2.scale.to(dt), bp.ln2.bias.to(dt),
                      cfg.layernorm_eps)
    if tp is not None:
        m_in = tensor.copy_in(m_in, tp)
    hmid = vit._gelu_named(_proj(m_in, bp.mlp_in, act["mlp_in"], dt),
                           cfg.gelu_approximate)
    out = _row_proj(hmid, bp.mlp_out, act["mlp_mid"], dt, tp)
    return x + vit._dropout(out, hidden, seed_mlp_out, row_base)


def _block(x: torch.Tensor, bp, cfg: ModelConfig, dt: torch.dtype,
           train: bool, seeds: Optional[vit.LayerSeeds],
           act: Dict[str, torch.Tensor], row_base: int,
           layout=None) -> torch.Tensor:
    if layout is not None:      # a sharded tree: gathered at use
        bp = fsdp.gather_block(layout, bp, dt)
    x = attention_residual(x, bp, cfg, dt, train, seeds, act,
                           row_base=row_base, tp=vit._tensor_axis(layout))
    return mlp_residual(x, bp, cfg, dt, train, seeds, act, row_base,
                        vit._tensor_axis(layout, "mlp_in"))


def apply_int8_train(params: vit.ViT, images: torch.Tensor,
                     cfg: ModelConfig, scales: Scales, *, train: bool = True,
                     dropout_seeds: Optional[Sequence[vit.LayerSeeds]] = None,
                     row_base: int = 0) -> torch.Tensor:
    """:func:`vit.apply` with every projection on the int8 straight-through
    product: NHWC images → f32 logits [B, num_classes].

    ``scales`` is a ``calibrate_vit_scales`` tree, calibrated on a real
    batch (placed on the images' device by :func:`place_scales`; place it
    once where the forward runs every step). LayerNorm, attention (the
    training kernels, the dropout ones with ``attention_dropout`` and a
    seed, the forward-only one with ``train=False``: run that under
    ``torch.no_grad()``), GELU and the head stay as in ``vit.apply``, as do
    ``dropout_seeds``, ``row_base`` and ``cfg.remat`` under every
    ``remat_policy``.
    ``cfg.fused_qkv`` is ignored, as the reference's int8 body never reads
    it: q, k and v are three products. A tree sharded over ``fsdp`` gathers
    each layer at use; one split over ``tensor`` runs each block's heads and
    columns on the rank (see the module docstring)."""
    vit._check_supported(cfg, dropout_seeds)
    dt = vit.torch_dtype(cfg.dtype)
    scales = place_scales(scales, images.device)
    x = embed(params, images, cfg, dt, scales["patch"])
    policy = (vit.remat_policy(cfg)
              if train and cfg.remat and torch.is_grad_enabled() else None)
    for i, bp in enumerate(params.blocks):
        args = (x, bp, cfg, dt, train,
                tuple(dropout_seeds[i]) if dropout_seeds is not None
                else None, layer_scales(scales, i), row_base, params.layout)
        x = policy(_block, *args) if policy else _block(*args)
    return vit.head_logits(params, x, cfg)

