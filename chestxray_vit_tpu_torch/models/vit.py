"""Vision Transformer forward for serving and training, ported from
``chestxray_vit_tpu/models/vit.py``.

Parameters live in an ``nn.Module`` tree whose names mirror the JAX
parameter dict (``blocks.3.wq.kernel`` is ``params["blocks"]["wq"]
["kernel"][3]``). Dense kernels keep the JAX orientation ``[in, out]`` and
images stay NHWC with the (row, col, channel) patch flatten order, so the
bridge to the JAX tree is a copy (``models/bridge.py``).

Numerics follow the reference: block and embedding weights run in the
compute dtype, LayerNorm upcasts to f32 statistics (the final LN keeps its
f32 scale), GELU computes in f32, attention takes f32 scores and softmax,
and the classifier head runs in f32 on the CLS features.

Training (``train=True``) runs the dense forward with gradients through
the training attention and LayerNorm kernels; master parameters stay in
``param_dtype`` and are cast to the compute dtype inside every step, so
gradients reach them through the casts. ``remat=True`` with the ``full``
policy checkpoints each block (``jax.checkpoint(scan_body, policy=None)``
in the reference). Not ported yet, each raising ``NotImplementedError``
with its ROADMAP item: the other remat policies, dropout, the fused Q/K/V
projection and token merging (``tome_r``).
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn

from chestxray_vit_tpu.config import ModelConfig
from chestxray_vit_tpu_torch.ops.flash_attention import attention
from chestxray_vit_tpu_torch.ops.gelu import gelu
from chestxray_vit_tpu_torch.ops.layer_norm import layer_norm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a ModelConfig dtype name (f32 or bf16: the two
    the kernels take)."""
    if name not in _DTYPES:
        raise ValueError(f"dtype {name!r}: the port runs float32 or bfloat16")
    return _DTYPES[name]


class Dense(nn.Module):
    """``x @ kernel + bias`` with a JAX-oriented ``[in, out]`` kernel."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(d_in, d_out, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(d_out, dtype=dtype))


class Norm(nn.Module):
    """LayerNorm parameters (scale ones, bias zeros)."""

    def __init__(self, d: int, dtype: torch.dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(d, dtype=dtype))


class Block(nn.Module):
    """Parameters of one pre-LN encoder block (HF ViTLayer)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        d, m = cfg.hidden_size, cfg.mlp_dim
        self.ln1, self.ln2 = Norm(d, dtype), Norm(d, dtype)
        self.wq, self.wk = Dense(d, d, dtype), Dense(d, d, dtype)
        self.wv, self.wo = Dense(d, d, dtype), Dense(d, d, dtype)
        self.mlp_in, self.mlp_out = Dense(d, m, dtype), Dense(m, d, dtype)


class ViT(nn.Module):
    """The parameter tree of ``vit.init_params``; ``forward`` is
    :func:`apply`."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        pdt = torch_dtype(cfg.param_dtype)
        d = cfg.hidden_size
        self.patch_embed = Dense(cfg.patch_size * cfg.patch_size * 3, d, pdt)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, dtype=pdt))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.seq_len, d,
                                                  dtype=pdt))
        self.blocks = nn.ModuleList(Block(cfg, pdt)
                                    for _ in range(cfg.num_layers))
        self.final_ln = Norm(d, pdt)
        self.head = Dense(d, cfg.num_classes, pdt)

    def forward(self, images: torch.Tensor,
                return_features: bool = False):
        return apply(self, images, self.cfg, return_features=return_features)


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: Optional[torch.device] = None) -> ViT:
    """HF ViT init: trunc-normal(0.02) weights (cut at ±2 std, as
    ``jax.nn.initializers.truncated_normal``), zero biases, unit LN
    scales. Drawn on the CPU from ``generator`` (the same seed gives the
    same weights on any device), then moved to ``device``."""
    params = ViT(cfg)
    trunc = [params.patch_embed.kernel, params.cls_token, params.pos_embed,
             params.head.kernel]
    for blk in params.blocks:
        trunc += [blk.wq.kernel, blk.wk.kernel, blk.wv.kernel,
                  blk.wo.kernel, blk.mlp_in.kernel, blk.mlp_out.kernel]
    with torch.no_grad():
        for t in trunc:
            nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)
    return params.to(device) if device is not None else params


def inference_params(params: ViT, device: torch.device) -> ViT:
    """A frozen copy of ``params`` on ``device`` with every weight that
    :func:`apply` casts to the compute dtype already cast, so a serving
    forward does not re-cast 85M weights per call. The final LN and the
    head keep the parameter dtype, as ``apply`` reads them."""
    cfg = params.cfg
    out = copy.deepcopy(params).to(device=device,
                                   dtype=torch_dtype(cfg.dtype))
    out.final_ln = copy.deepcopy(params.final_ln).to(device)
    out.head = copy.deepcopy(params.head).to(device)
    return out.requires_grad_(False)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def _linear(x: torch.Tensor, p: Dense, dtype: torch.dtype) -> torch.Tensor:
    # product and bias add round separately, as jnp.dot(x, k) + b does
    return torch.matmul(x, p.kernel.to(dtype)) + p.bias.to(dtype)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """NHWC [B, H, W, 3] → [B, N, patch*patch*3], flattened per patch as
    (row-in-patch, col-in-patch, channel)."""
    b, h, w, c = images.shape
    nh, nw = h // patch, w // patch
    x = images.reshape(b, nh, patch, nw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)                # [B, nh, nw, p, p, c]
    return x.reshape(b, nh * nw, patch * patch * c)


def embed(params: ViT, images: torch.Tensor, cfg: ModelConfig,
          compute_dtype: torch.dtype) -> torch.Tensor:
    """Patch-embed + CLS + learned position embeddings (HF ViTEmbeddings)."""
    patches = patchify(images.to(compute_dtype), cfg.patch_size)
    x = _linear(patches, params.patch_embed, compute_dtype)
    cls = params.cls_token.to(compute_dtype).expand(x.shape[0], 1,
                                                    cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    return x + params.pos_embed.to(compute_dtype)


def _mha(x: torch.Tensor, bp: Block, cfg: ModelConfig, attn_impl: str,
         compute_dtype: torch.dtype, train: bool = False) -> torch.Tensor:
    """Multi-head attention on the pre-LN input, non-fused Q/K/V.

    Each projection lands as a [B, H, S, hd] view of its [B, S, D] product
    (no copy); the kernel reads those strides in place and writes heads
    already merged in memory for the output projection."""
    b, s, d = x.shape
    h, hd = cfg.num_heads, cfg.head_dim

    def heads(p: Dense) -> torch.Tensor:
        return _linear(x, p, compute_dtype).view(b, s, h, hd).transpose(1, 2)

    o = attention(heads(bp.wq), heads(bp.wk), heads(bp.wv), impl=attn_impl,
                  inference=not train)
    return _linear(o.transpose(1, 2).reshape(b, s, d), bp.wo, compute_dtype)


def _block(x: torch.Tensor, bp: Block, cfg: ModelConfig, attn_impl: str,
           compute_dtype: torch.dtype, train: bool = False) -> torch.Tensor:
    """One pre-LN encoder block (HF ViTLayer):
    x += MHA(LN1(x)); x += MLP(LN2(x)) with erf GELU."""
    eps = cfg.layernorm_eps
    dt = compute_dtype
    a_in = layer_norm(x, bp.ln1.scale.to(dt), bp.ln1.bias.to(dt), eps)
    x = x + _mha(a_in, bp, cfg, attn_impl, dt, train)
    m_in = layer_norm(x, bp.ln2.scale.to(dt), bp.ln2.bias.to(dt), eps)
    hmid = gelu(_linear(m_in, bp.mlp_in, dt),
                approximate=cfg.gelu_approximate)
    return x + _linear(hmid, bp.mlp_out, dt)


def _check_supported(cfg: ModelConfig, train: bool) -> None:
    # remat and dropout act only when training, where the reference reads
    # them; at inference they are ignored, as there
    later = {
        "tome_r (token merging is ROADMAP Queue 1 #7)":
            getattr(cfg, "tome_r", 0),
        "fused_qkv (ROADMAP Queue 1 #2)": cfg.fused_qkv,
        f"remat_policy={cfg.remat_policy!r} (only 'full' is ported; the "
        f"selective policies are ROADMAP Queue 1 #2)":
            train and cfg.remat and cfg.remat_policy != "full",
        "hidden_dropout / attention_dropout (dropout and the attention "
        "dropout kernels are ROADMAP Queue 1 #9 and Queue 2 #5)":
            train and (cfg.hidden_dropout > 0 or cfg.attention_dropout > 0),
    }
    for what, on in later.items():
        if on:
            raise NotImplementedError(f"{what} is not ported yet")


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def head_logits(params: ViT, tokens: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Final LN + CLS classifier head on encoder output tokens."""
    fl = params.final_ln
    x = layer_norm(tokens, fl.scale, fl.bias, cfg.layernorm_eps)
    return _head(params, x[:, 0, :])


def _head(params: ViT, cls_features: torch.Tensor) -> torch.Tensor:
    head = params.head
    return (torch.matmul(cls_features.float(), head.kernel.float())
            + head.bias.float())


def apply(params: ViT, images: torch.Tensor, cfg: ModelConfig, *,
          train: bool = False, return_features: bool = False):
    """Forward pass.

    Args:
      images: NHWC f32/bf16 [B, img, img, 3].
      train: the training forward (attention through the training
        kernels, which keep what the backward needs; ``cfg.remat``
        checkpoints each block). False takes the forward-only attention
        kernel, which refuses tensors that need a gradient: run eval and
        serving under ``torch.no_grad()`` or ``torch.inference_mode()``.
      return_features: also return the final-LN CLS features.

    Returns logits f32 [B, num_classes] (and features if requested).
    """
    _check_supported(cfg, train)
    compute_dtype = torch_dtype(cfg.dtype)
    x = embed(params, images, cfg, compute_dtype)
    remat = train and cfg.remat and torch.is_grad_enabled()
    for bp in params.blocks:          # the JAX lax.scan over stacked layers
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _block, x, bp, cfg, cfg.attention_impl, compute_dtype, train,
                use_reentrant=False)
        else:
            x = _block(x, bp, cfg, cfg.attention_impl, compute_dtype, train)
    fl = params.final_ln
    x = layer_norm(x, fl.scale, fl.bias, cfg.layernorm_eps)
    cls_features = x[:, 0, :]
    logits = _head(params, cls_features)
    if return_features:
        return logits, cls_features
    return logits
