"""int8-quantized ViT forward for serving, ported from
``chestxray_vit_tpu/models/quantized.py``.

The architecture is :func:`vit.apply`'s (pre-LN blocks, fused attention,
exact-erf GELU, CLS head), with every large matmul run as an int8 product:
per-output-channel int8 weights prepared once (:func:`quantize_vit_params`)
and exact integer sums (``ops/quant.py``). Attention stays in the compute
dtype in its kernel; LayerNorm (with the trained f32 gains), softmax and
the classifier head stay f32.

Two activation-scale modes (weights are per-channel int8 either way):

- *dynamic*: per-token amax scales computed on the fly;
- *static*: per-site scalar scales observed once on a calibration batch
  (:func:`calibrate_vit_scales`).

:func:`apply_quantized` has the JAX package's two routes. ``"xla"`` (the
default, as there) is the plain one: the int8 product (``torch._int_mm`` on
the card) and an eager epilogue. ``"pallas"`` (static scales only) runs
every int8 matmul through ``int8_matmul_fused``, the hand-written kernel
with the dequantize, bias, residual, GELU and requantize fused.

The quantized tree is a :class:`QuantizedViT`, an ``nn.Module`` of buffers
named after the JAX tree: ``blocks.3.wq.qw.q`` is
``qparams["blocks"]["wq"]["qw"].q[3]`` (transposed: the port keeps int8
weights ``[out, in]``, see ``ops/quant.py``), ``blocks.3.act.mlp_in`` is
``qparams["blocks"]["act"]["mlp_in"][3]``. ``models/bridge.py`` converts
between the two; :func:`save_quantized` / :func:`load_quantized` write and
read the JAX package's artifact format, so an artifact written by either
package loads in the other.

Forward-only by design: training keeps its bf16/f32 master weights.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from chestxray_vit_tpu_torch.config import ModelConfig
from chestxray_vit_tpu_torch.models import bridge, vit
from chestxray_vit_tpu_torch.ops.flash_attention import attention
from chestxray_vit_tpu_torch.ops.gelu import gelu as _gelu
from chestxray_vit_tpu_torch.ops.int8_matmul import (int8_matmul_fused,
                                                     pad_k, padded_k,
                                                     quantize_static)
from chestxray_vit_tpu_torch.ops.layer_norm import layer_norm
from chestxray_vit_tpu_torch.ops.quant import (QuantizedWeight, int8_matmul,
                                               int8_matmul_static,
                                               quantize_weight)
from chestxray_vit_tpu_torch.ops.tome import tome_merge_clamped

_QUANT_BLOCK_KEYS = ("wq", "wk", "wv", "wo", "mlp_in", "mlp_out")
# calibration site feeding each projection (wq/wk/wv share one input)
_SITE_OF = {"wq": "attn_in", "wk": "attn_in", "wv": "attn_in",
            "wo": "attn_out", "mlp_in": "mlp_in", "mlp_out": "mlp_mid"}
_SITES = ("attn_in", "attn_out", "mlp_in", "mlp_mid")


# ---------------------------------------------------------------------------
# The quantized tree
# ---------------------------------------------------------------------------

class Buffers(nn.Module):
    """A node of the quantized tree: named buffers only."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for name, t in tensors.items():
            self.register_buffer(name, t)


class QuantDense(nn.Module):
    """An int8 projection: ``qw`` (:class:`QuantizedWeight`) and ``bias``.
    The weight's K is stored zero-padded to a multiple of 64, the int8
    kernel's step (``ops/int8_matmul.pad_k``: the patch-14 embedding's 588,
    a hidden or MLP width off 64), and ``in_features`` keeps the real one:
    the bridge and the artifact see ``[in_features, out]``. The plain
    route pads the activation (:func:`padded_input`); the fused kernel's
    wrapper pads it itself."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype):
        super().__init__()
        self.in_features = d_in
        self.qw = QuantizedWeight(
            torch.zeros(d_out, padded_k(d_in), dtype=torch.int8),
            torch.zeros(d_out))
        self.register_buffer("bias", torch.zeros(d_out, dtype=dtype))


def _norm(d: int, dtype: torch.dtype) -> Buffers:
    return Buffers(scale=torch.ones(d, dtype=dtype),
                   bias=torch.zeros(d, dtype=dtype))


class QuantBlock(nn.Module):
    """One encoder block of the quantized tree; ``act`` holds the block's
    four static activation scales (static trees only)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, static: bool):
        super().__init__()
        d, m = cfg.hidden_size, cfg.mlp_dim
        self.ln1, self.ln2 = _norm(d, dtype), _norm(d, dtype)
        for key in ("wq", "wk", "wv", "wo"):
            setattr(self, key, QuantDense(d, d, dtype))
        self.mlp_in, self.mlp_out = QuantDense(d, m, dtype), \
            QuantDense(m, d, dtype)
        if static:
            self.act = Buffers(**{s: torch.zeros(()) for s in _SITES})


class QuantizedViT(nn.Module):
    """The serving tree of ``quantize_vit_params``: int8 projections, the
    rest of the weights in ``cfg.param_dtype``, and, when ``static``, the
    calibrated activation scales (``patch_embed.xs``, ``blocks.<i>.act``)."""

    def __init__(self, cfg: ModelConfig, static: bool):
        super().__init__()
        self.cfg, self.static = cfg, static
        pdt = vit.torch_dtype(cfg.param_dtype)
        d = cfg.hidden_size
        # K = 3 p² (588 at patch 14) padded for the int8 kernel
        self.patch_embed = QuantDense(cfg.patch_size * cfg.patch_size * 3, d,
                                      pdt)
        if static:
            self.patch_embed.register_buffer("xs", torch.zeros(()))
        self.register_buffer("cls_token", torch.zeros(1, 1, d, dtype=pdt))
        self.register_buffer("pos_embed",
                             torch.zeros(1, cfg.seq_len, d, dtype=pdt))
        self.blocks = nn.ModuleList(QuantBlock(cfg, pdt, static)
                                    for _ in range(cfg.num_layers))
        self.final_ln = _norm(d, pdt)
        self.head = Buffers(kernel=torch.zeros(d, cfg.num_classes, dtype=pdt),
                            bias=torch.zeros(cfg.num_classes, dtype=pdt))


# ---------------------------------------------------------------------------
# Shared forward pieces
# ---------------------------------------------------------------------------

def padded_input(x: torch.Tensor, entry: QuantDense) -> torch.Tensor:
    """``x [..., in_features]`` zero-padded to ``entry``'s stored K (itself
    where no padding is needed): exact, a zero column adds nothing to the
    integer sums and changes no absmax scale."""
    return pad_k(x, entry.qw.q.shape[1])


def _heads(y: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """[B, S, D] → a [B, H, S, hd] view."""
    b, s, _ = y.shape
    return y.view(b, s, cfg.num_heads, cfg.head_dim).transpose(1, 2)


def _merge(o: torch.Tensor) -> torch.Tensor:
    """[B, H, S, hd] → [B, S, H·hd]."""
    b, h, s, hd = o.shape
    return o.transpose(1, 2).reshape(b, s, h * hd)


def _encoder_scan(x: torch.Tensor, blocks, cfg: ModelConfig, proj,
                  collect_amax: bool = False,
                  merges: Optional[Sequence[int]] = None):
    """One copy of the pre-LN block math (LN → QKV → attention → WO +
    residual → LN → GELU MLP + residual) shared by the "xla" quantized
    forward, static calibration and the token-merging serving forward
    (``models/tome_forward.py``), so the ranges calibration observes are
    those of the forward it calibrates.

    ``proj(y, bp, key)`` supplies the projection for block entry ``key``
    (dense weights during calibration, int8 matmuls when serving).
    ``collect_amax`` also returns per-layer max|x| at the four quantized
    matmul inputs, as f32 ``[L]`` tensors per site. ``merges`` (per-layer
    token-merge counts) merges tokens between the attention residual and
    LN2 on the keys' mean over heads. Returns ``(x, sites-or-None)``."""
    eps = cfg.layernorm_eps
    sites = []
    sizes = (torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
             if merges else None)

    def amax(y):
        return y.float().abs().amax()

    for i, bp in enumerate(blocks):       # the JAX lax.scan over layers
        a_in = layer_norm(x, bp.ln1.scale, bp.ln1.bias, eps)
        q, k, v = (_heads(proj(a_in, bp, key), cfg)
                   for key in ("wq", "wk", "wv"))
        merged = _merge(attention(q, k, v, impl=cfg.attention_impl,
                                  inference=True))
        x = x + proj(merged, bp, "wo")
        if merges:
            x, sizes = tome_merge_clamped(x, k.mean(dim=1), sizes, merges[i])
        m_in = layer_norm(x, bp.ln2.scale, bp.ln2.bias, eps)
        mid = _gelu(proj(m_in, bp, "mlp_in"), approximate=cfg.gelu_approximate)
        x = x + proj(mid, bp, "mlp_out")
        if collect_amax:
            sites.append(torch.stack([amax(a_in), amax(merged), amax(m_in),
                                      amax(mid)]))
    return x, (torch.stack(sites).t() if collect_amax else None)


def _cls_pos(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """CLS concat → position embeddings, in the compute dtype."""
    cd = x.dtype
    cls = params.cls_token.to(cd).expand(x.shape[0], 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    return (x + params.pos_embed.to(cd)).to(cd)


def embed_tokens(params, images: torch.Tensor, cfg: ModelConfig,
                 quantized: bool) -> torch.Tensor:
    """Patchify → (dense | int8) patch embed → CLS concat → position
    embeddings: the shared entry stage of the quantized forward and of
    calibration. ``params`` is a :class:`QuantizedViT` when ``quantized``,
    else a dense ``ViT``."""
    cd = vit.torch_dtype(cfg.dtype)
    patches = vit.patchify(images.float(), cfg.patch_size)
    pe = params.patch_embed
    if quantized:
        patches = padded_input(patches, pe)
        if params.static:
            x = int8_matmul_static(patches, pe.qw, pe.xs, pe.bias,
                                   out_dtype=cd)
        else:
            x = int8_matmul(patches, pe.qw, pe.bias, out_dtype=cd)
    else:
        x = patches.to(cd) @ pe.kernel.to(cd) + pe.bias.to(cd)
    return _cls_pos(params, x, cfg)


def dense_proj(cfg: ModelConfig):
    """The projection of a dense tree for :func:`_encoder_scan`: the
    weights cast to the compute dtype at the call."""
    cd = vit.torch_dtype(cfg.dtype)

    def proj(y, bp, key):
        e = getattr(bp, key)
        return y.to(cd) @ e.kernel.to(cd) + e.bias.to(cd)
    return proj


def int8_proj(qparams: "QuantizedViT", cfg: ModelConfig):
    """The projection of a quantized tree on the plain route: static
    per-site or dynamic per-token activation scales."""
    cd = vit.torch_dtype(cfg.dtype)

    def proj(y, bp, key):
        e = getattr(bp, key)
        y = padded_input(y, e)
        if qparams.static:
            return int8_matmul_static(y, e.qw, getattr(bp.act, _SITE_OF[key]),
                                      e.bias, out_dtype=cd)
        return int8_matmul(y, e.qw, e.bias, out_dtype=cd)
    return proj


# ---------------------------------------------------------------------------
# Calibration and quantization
# ---------------------------------------------------------------------------

def _on(params: vit.ViT, device: torch.device) -> vit.ViT:
    """``params`` on ``device``: itself if it is there, else a copy."""
    if next(params.parameters()).device == device:
        return params
    return copy.deepcopy(params).to(device)


@torch.no_grad()
def calibrate_vit_scales(params: vit.ViT, images: torch.Tensor,
                         cfg: ModelConfig, margin: float = 1.0
                         ) -> Dict[str, Any]:
    """Observe activation amax at every quantized matmul input.

    Runs the dense forward once over ``images`` (the calibration batch, on
    the device the forward runs on) in the compute dtype, with the blocks'
    trained f32 LayerNorm gains, and records max|x| at each site; returns
    ``{"patch": f32 scalar, "blocks": {site: f32 [L]}}`` CPU tensors
    (= max(amax·margin, 1e-6)/127) for :func:`quantize_vit_params`."""
    params = _on(params, images.device)
    s_patch = vit.patchify(images.float(), cfg.patch_size).abs().amax()
    x = embed_tokens(params, images, cfg, quantized=False)
    _, sites = _encoder_scan(x, params.blocks, cfg, dense_proj(cfg),
                             collect_amax=True)
    # the few amax values come to the host; the scale math is f32 there,
    # as in the JAX package
    amaxes = torch.cat([s_patch.reshape(1), sites.reshape(-1)]).cpu()
    scales = torch.clamp_min(amaxes * margin, 1e-6) / 127.0
    return {"patch": scales[0],
            "blocks": dict(zip(_SITES, scales[1:].reshape(len(_SITES), -1)))}


@torch.no_grad()
def quantize_vit_params(params: vit.ViT,
                        act_scales: Optional[Dict[str, Any]] = None,
                        device=None) -> QuantizedViT:
    """Dense ``ViT`` → serving tree with int8 kernels, on ``device``
    (default: the parameters' device; the weights are quantized there).
    With ``act_scales`` (from :func:`calibrate_vit_scales`, torch or numpy
    leaves) the tree also carries static per-site activation scales and
    serves through the fused static route."""
    dev = torch.device(device) if device is not None else \
        next(params.parameters()).device
    q = QuantizedViT(params.cfg, static=act_scales is not None).to(dev)

    def put(dst: torch.Tensor, src) -> None:
        dst.copy_(torch.as_tensor(np.asarray(src, np.float32)))

    def quantize_into(qd: QuantDense, dense: vit.Dense) -> None:
        qw = quantize_weight(dense.kernel.to(dev, torch.float32))
        qd.qw.q.copy_(pad_k(qw.q, qd.qw.q.shape[1]))
        qd.qw.scale.copy_(qw.scale)
        qd.bias.copy_(dense.bias)

    for i, (bp, qb) in enumerate(zip(params.blocks, q.blocks)):
        for ln in ("ln1", "ln2"):
            getattr(qb, ln).scale.copy_(getattr(bp, ln).scale)
            getattr(qb, ln).bias.copy_(getattr(bp, ln).bias)
        for key in _QUANT_BLOCK_KEYS:
            quantize_into(getattr(qb, key), getattr(bp, key))
        if act_scales is not None:
            for site in _SITES:
                put(getattr(qb.act, site), act_scales["blocks"][site][i])
    quantize_into(q.patch_embed, params.patch_embed)
    if act_scales is not None:
        put(q.patch_embed.xs, act_scales["patch"])
    for name in ("cls_token", "pos_embed"):
        getattr(q, name).copy_(getattr(params, name))
    for name in ("scale", "bias"):
        getattr(q.final_ln, name).copy_(getattr(params.final_ln, name))
    q.head.kernel.copy_(params.head.kernel)
    q.head.bias.copy_(params.head.bias)
    return q


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def apply_quantized(qparams: QuantizedViT, images: torch.Tensor,
                    cfg: ModelConfig, backend: str = "xla",
                    merges: Optional[Sequence[int]] = None) -> torch.Tensor:
    """int8 forward: NHWC images → f32 logits [B, num_classes].

    ``backend="xla"`` runs the plain route (the JAX default); ``"pallas"``
    (static scales only) runs every int8 matmul through the fused kernel
    (``ops/int8_matmul.py``). The JAX package's default rests on TPU
    measurements; the port's static ``Predictor`` takes ``"pallas"``.
    ``merges`` (per-layer counts) merges tokens after every attention
    block, on either route (``models/tome_forward.apply_tome``). Run under
    ``torch.no_grad()`` or ``torch.inference_mode()``."""
    if backend == "pallas":
        if not qparams.static:
            raise ValueError(
                "backend='pallas' requires static calibrated scales "
                "(quantize_vit_params(..., act_scales=...))")
        if cfg.gelu_approximate:
            raise ValueError("backend='pallas' fuses the exact-erf GELU; "
                             "gelu_approximate is not supported")
        return _apply_static_pallas(qparams, images, cfg, merges)
    if backend != "xla":
        raise ValueError(f"unknown quantized backend {backend!r}")

    x = embed_tokens(qparams, images, cfg, quantized=True)
    x, _ = _encoder_scan(x, qparams.blocks, cfg, int8_proj(qparams, cfg),
                         merges=merges)
    return vit.head_logits(qparams, x, cfg)


def _apply_static_pallas(qparams: QuantizedViT, images: torch.Tensor,
                         cfg: ModelConfig,
                         merges: Optional[Sequence[int]] = None
                         ) -> torch.Tensor:
    """Static-int8 forward on the fused int8 kernel: the same math as the
    "xla" static route, with the residual adds in the matmul epilogue, the
    MLP hidden activation GELU'd and requantized in the kernel (it crosses
    memory once, as int8), and the attention input quantized once for the
    three Q/K/V products. 73 kernel launches per forward at 12 layers.
    ``merges`` merges tokens between the ``wo`` residual product and LN2,
    as :func:`_encoder_scan` does."""
    cd = vit.torch_dtype(cfg.dtype)
    eps = cfg.layernorm_eps

    def proj(x8, entry: QuantDense, x_scale, **kw):
        return int8_matmul_fused(x8, entry.qw.q, x_scale * entry.qw.scale,
                                 entry.bias, out_dtype=cd, **kw)

    pe = qparams.patch_embed
    patches = vit.patchify(images.float(), cfg.patch_size)
    x = _cls_pos(qparams, proj(quantize_static(patches, pe.xs), pe, pe.xs),
                 cfg)
    sizes = (torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
             if merges else None)
    for i, bp in enumerate(qparams.blocks):
        act = bp.act
        a_in = layer_norm(x, bp.ln1.scale, bp.ln1.bias, eps)
        a8 = quantize_static(a_in, act.attn_in)          # shared by q/k/v
        q, k, v = (_heads(proj(a8, getattr(bp, key), act.attn_in), cfg)
                   for key in ("wq", "wk", "wv"))
        merged = _merge(attention(q, k, v, impl=cfg.attention_impl,
                                  inference=True))
        x = proj(quantize_static(merged, act.attn_out), bp.wo, act.attn_out,
                 resid=x)
        if merges:
            x, sizes = tome_merge_clamped(x, k.mean(dim=1), sizes, merges[i])
        m_in = layer_norm(x, bp.ln2.scale, bp.ln2.bias, eps)
        mid8 = proj(quantize_static(m_in, act.mlp_in), bp.mlp_in, act.mlp_in,
                    gelu=True, out_quant_scale=act.mlp_mid)
        x = proj(mid8, bp.mlp_out, act.mlp_mid, resid=x)
    return vit.head_logits(qparams, x, cfg)


# ---------------------------------------------------------------------------
# int8 artifact: the quantized tree saved once, served without recalibrating
# ---------------------------------------------------------------------------

def _flatten(tree: Dict[str, Any], path: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) in the JAX package's flatten order: keys sorted at every
    level."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _flatten(val, path + (key,))
        else:
            yield path + (key,), val


def _keystr(path: Tuple[str, ...]) -> str:
    """``jax.tree_util.keystr`` of a path: ``['blocks']['wq']['qw'].q`` (the
    fields of a ``QuantizedWeight`` named tuple are attributes)."""
    return "".join(f".{k}" if i and path[i - 1] == "qw" else f"['{k}']"
                   for i, k in enumerate(path))


def model_fingerprint(params: vit.ViT) -> str:
    """Content fingerprint of a dense tree, stored with the int8 artifact:
    the JAX package's digest (the same leaf order, key strings, shapes and
    f32 samples: ≤ 1152 elements of every leaf), so a fingerprint from
    either package matches the other's on the same weights."""
    h = hashlib.blake2b(digest_size=16)
    samples = []
    for path, leaf in _flatten(bridge.params_to_numpy(params)):
        arr = leaf.reshape(-1)
        stride = max(1, arr.size // 1024)
        samples.append(np.concatenate([arr[:64], arr[::stride][:1024],
                                       arr[-64:]]).astype(np.float32))
        h.update(_keystr(path).encode())
        h.update(str(np.shape(leaf)).encode())
    h.update(np.concatenate(samples).tobytes())
    return h.hexdigest()


def save_quantized(directory: str, qparams: QuantizedViT,
                   fingerprint: Optional[str] = None) -> str:
    """Write ``qparams`` as the JAX package's artifact: ``qparams.npz``
    (one array per leaf, keyed by its JAX key string, in the JAX layout)
    and ``quantized.json`` (format 1, the mode, the dense weights'
    :func:`model_fingerprint`)."""
    directory = os.path.abspath(os.path.expanduser(directory))
    os.makedirs(directory, exist_ok=True)
    arrays = {_keystr(path): leaf for path, leaf in
              _flatten(bridge.qparams_to_numpy(qparams))}
    np.savez(os.path.join(directory, "qparams.npz"), **arrays)
    meta = {"format": 1, "mode": "static" if qparams.static else "dynamic"}
    if fingerprint:
        meta["fingerprint"] = fingerprint
    with open(os.path.join(directory, "quantized.json"), "w") as f:
        json.dump(meta, f)
    return directory


def load_quantized(directory: str, cfg: ModelConfig) -> QuantizedViT:
    """Read an artifact of :func:`save_quantized` (or of the JAX package's)
    into a :class:`QuantizedViT` on the CPU. A missing leaf or a shape that
    does not fit ``cfg`` raises."""
    directory = os.path.abspath(os.path.expanduser(directory))
    with open(os.path.join(directory, "quantized.json")) as f:
        meta = json.load(f)
    if meta.get("format") != 1:
        raise ValueError(f"unknown quantized artifact format {meta!r}")
    data = np.load(os.path.join(directory, "qparams.npz"))
    template = bridge.qparams_to_numpy(
        QuantizedViT(cfg, static=meta["mode"] == "static"))
    tree: Dict[str, Any] = {}
    for path, tmpl in _flatten(template):
        key = _keystr(path)
        if key not in data:
            raise ValueError(f"quantized artifact missing leaf {key}")
        arr = data[key]
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(
                f"quantized artifact leaf {key} has shape {arr.shape}, "
                f"model config expects {tuple(tmpl.shape)}")
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr
    return bridge.qparams_from_jax(tree, cfg)
