"""Bridge between the JAX package's parameter dict and the port's ``ViT``.

The JAX tree (``chestxray_vit_tpu.models.vit.init_params``) stacks the
encoder blocks as ``[L, ...]`` leaves; the port keeps one ``Block`` per
layer. Both keep dense kernels as ``[in, out]`` and the same patch flatten
order, so each leaf is a copy. A port parameter name maps to one JAX leaf:
``blocks.3.wq.kernel`` is ``tree["blocks"]["wq"]["kernel"][3]`` and
``head.bias`` is ``tree["head"]["bias"]``. The same mapping carries
gradients (``grads_to_numpy``) and the AdamW moments, which the port keys
by parameter name (``opt_state_from_jax`` / ``opt_state_to_numpy``).
Leaves cross as numpy arrays: this module imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from chestxray_vit_tpu.config import ModelConfig
from chestxray_vit_tpu_torch.models.vit import ViT


def _leaf(tree: Mapping[str, Any], name: str) -> np.ndarray:
    """The JAX leaf of a port parameter name (a block layer's slice of the
    stacked leaf for ``blocks.<i>.…``)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        node = tree["blocks"]
        for p in parts[2:]:
            node = node[p]
        return np.asarray(node)[int(parts[1])]
    node = tree
    for p in parts:
        node = node[p]
    return np.asarray(node)


def _to_tree(named: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Port-named tensors → the JAX nested dict with numpy f32 leaves and
    the blocks stacked to ``[L, ...]``."""
    tree: Dict[str, Any] = {}
    layers: Dict[tuple, list] = {}
    for name, t in named.items():
        # a copy: for an f32 CPU tensor .numpy() would share its storage,
        # and the in-place optimizer update would then change the tree
        arr = t.detach().float().cpu().numpy().copy()
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
    return _to_tree(dict(params.named_parameters()))


def grads_to_numpy(params: ViT) -> Dict[str, Any]:
    """Every parameter's ``.grad`` as the JAX gradient tree (numpy f32)."""
    missing = [n for n, p in params.named_parameters() if p.grad is None]
    if missing:
        raise ValueError(f"no gradient for {missing[:3]} "
                         f"(+{max(len(missing) - 3, 0)} more)")
    return _to_tree({n: p.grad for n, p in params.named_parameters()})


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
    return {key: _to_tree(opt_state[key]) for key in ("mu", "nu")}
