"""Bridge between the JAX package's parameter dict and the port's ``ViT``.

The JAX tree (``chestxray_vit_tpu.models.vit.init_params``) stacks the
encoder blocks as ``[L, ...]`` leaves; the port keeps one ``Block`` per
layer. Both keep dense kernels as ``[in, out]`` and the same patch flatten
order, so each leaf is a copy. A port parameter name maps to one JAX leaf:
``blocks.3.wq.kernel`` is ``tree["blocks"]["wq"]["kernel"][3]`` and
``head.bias`` is ``tree["head"]["bias"]``. The same mapping carries
gradients (``grads_to_numpy``) and the AdamW moments, which the port keys
by parameter name (``opt_state_from_jax`` / ``opt_state_to_numpy``).

The int8 serving tree crosses the same way (``qparams_from_jax`` /
``qparams_to_numpy``): ``blocks.3.wq.qw.q`` is
``qtree["blocks"]["wq"]["qw"].q[3]``, static or dynamic alike. One leaf
is not a copy: the port keeps int8 weights ``[out, in]`` (K-contiguous,
what the int8 kernel reads) where the JAX ``QuantizedWeight.q`` is
``[in, out]``, so ``*.qw.q`` leaves are transposed both ways; and a
weight whose K the port stores zero-padded (the patch embedding's, see
``quantized.QuantDense``) is padded on the way in and cut back to its
``in_features`` on the way out, so the JAX layout never holds the padding.
Leaves cross as numpy arrays: this module imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from chestxray_vit_tpu_torch.config import ModelConfig
from chestxray_vit_tpu_torch.models import quantized
from chestxray_vit_tpu_torch.models.vit import ViT


def _child(node: Any, key: str) -> Any:
    # a QuantizedWeight named tuple in a JAX tree has fields, not keys
    return node[key] if isinstance(node, Mapping) else getattr(node, key)


def _leaf(tree: Mapping[str, Any], name: str) -> np.ndarray:
    """The JAX leaf of a port parameter or buffer name (a block layer's
    slice of the stacked leaf for ``blocks.<i>.…``)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        node = tree["blocks"]
        for p in parts[2:]:
            node = _child(node, p)
        return np.asarray(node)[int(parts[1])]
    node = tree
    for p in parts:
        node = _child(node, p)
    return np.asarray(node)


def _f32(t: torch.Tensor) -> np.ndarray:
    # a copy: for an f32 CPU tensor .numpy() would share its storage, and
    # the in-place optimizer update would then change an exported tree
    return t.detach().float().cpu().numpy().copy()


def _to_tree(named: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """Port-named numpy leaves → the JAX nested dict with the blocks
    stacked to ``[L, ...]``."""
    tree: Dict[str, Any] = {}
    layers: Dict[tuple, list] = {}
    for name, arr in named.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            layers.setdefault(("blocks", *parts[2:]), []).append(
                (int(parts[1]), arr))
            continue
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    for path, items in layers.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.stack([a for _, a in sorted(items,
                                                        key=lambda x: x[0])])
    return tree


def _copy(dst: torch.Tensor, tree: Mapping[str, Any], name: str) -> None:
    arr = _leaf(tree, name)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {arr.shape} != {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.array(arr, np.float32)))


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig) -> ViT:
    """JAX parameter dict (leaves as numpy or JAX arrays) → port ``ViT`` on
    the CPU, in ``cfg.param_dtype``."""
    params = ViT(cfg)
    for name, p in params.named_parameters():
        _copy(p, tree, name)
    return params


def params_to_numpy(params: ViT) -> Dict[str, Any]:
    """Port ``ViT`` → the JAX parameter dict with numpy leaves and stacked
    ``[L, ...]`` blocks (the inverse of :func:`params_from_jax`)."""
    return _to_tree({n: _f32(p) for n, p in params.named_parameters()})


def grads_to_numpy(params: ViT) -> Dict[str, Any]:
    """Every parameter's ``.grad`` as the JAX gradient tree (numpy f32)."""
    missing = [n for n, p in params.named_parameters() if p.grad is None]
    if missing:
        raise ValueError(f"no gradient for {missing[:3]} "
                         f"(+{max(len(missing) - 3, 0)} more)")
    return _to_tree({n: _f32(p.grad) for n, p in params.named_parameters()})


def opt_state_from_jax(opt_state: Dict[str, Any], params: ViT
                       ) -> Dict[str, Dict[str, torch.Tensor]]:
    """JAX AdamW state ``{"mu": tree, "nu": tree}`` → the port's
    ``{"mu": {name: f32 tensor}, "nu": …}`` on the parameters' devices."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for key in ("mu", "nu"):
        out[key] = {}
        for name, p in params.named_parameters():
            t = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            _copy(t, opt_state[key], name)
            out[key][name] = t
    return out


def opt_state_to_numpy(opt_state: Mapping[str, Mapping[str, torch.Tensor]]
                       ) -> Dict[str, Any]:
    """The port's AdamW state → ``{"mu": tree, "nu": tree}`` with numpy
    leaves in the JAX parameter layout."""
    return {key: _to_tree({n: _f32(t) for n, t in opt_state[key].items()})
            for key in ("mu", "nu")}


def _is_int8_weight(name: str) -> bool:
    return name.endswith(".qw.q")


def qparams_from_jax(qtree: Dict[str, Any], cfg: ModelConfig
                     ) -> "quantized.QuantizedViT":
    """A JAX ``quantize_vit_params`` tree (static when it has
    ``blocks.act``; leaves numpy or JAX arrays, ``qw`` a ``QuantizedWeight``
    or a ``{"q", "scale"}`` dict) → the port's ``QuantizedViT`` on the
    CPU. A leaf of the wrong shape raises."""
    qp = quantized.QuantizedViT(cfg, static="act" in qtree["blocks"])
    for name, buf in qp.named_buffers():
        arr = _leaf(qtree, name)
        if _is_int8_weight(name):
            arr = arr.T
            k = qp.get_submodule(name[:-len(".qw.q")]).in_features
            if arr.shape[1] == k and buf.shape[1] > k:
                arr = np.pad(arr, ((0, 0), (0, buf.shape[1] - k)))
        if tuple(arr.shape) != tuple(buf.shape):
            raise ValueError(f"{name}: shape {arr.shape} != "
                             f"{tuple(buf.shape)}")
        buf.copy_(torch.from_numpy(np.array(arr)))
    return qp


def qparams_to_numpy(qparams: "quantized.QuantizedViT") -> Dict[str, Any]:
    """The port's ``QuantizedViT`` → the JAX tree with numpy leaves in
    their own dtypes (int8 weights ``[L, in, out]``), blocks stacked, and
    each ``qw`` a ``{"q", "scale"}`` dict (the inverse of
    :func:`qparams_from_jax`)."""
    named = {}
    for name, buf in qparams.named_buffers():
        t = buf.detach().cpu()
        if _is_int8_weight(name):
            k = qparams.get_submodule(name[:-len(".qw.q")]).in_features
            t = t[:, :k].t()
        named[name] = t.numpy().copy()
    return _to_tree(named)
