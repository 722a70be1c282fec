"""Rematerialization of encoder blocks under the policies of the JAX
package's ``vit.remat_policy`` (``cfg.model.remat_policy``).

The JAX model names values with ``jax.ad_checkpoint.checkpoint_name`` and
a ``jax.checkpoint`` policy picks which residuals its backward keeps:

- ``mlp_hidden``: the GELU output of the MLP;
- ``attn_heads``: q, k and v;
- ``flash_residual``: the attention kernel's q, k, v operands. The port's
  kernels read q, k and v in place, with no padded copies, so these are
  the ``attn_heads`` tensors;
- ``flash_out``: the attention kernel's o and lse.

The policies and how the port honours each:

- ``full``: the block is checkpointed (``torch.utils.checkpoint``); the
  backward recomputes all of it.
- ``mlp``, ``attn``, ``attn_mlp`` (the reference's
  ``save_anything_except_these_names``): the block runs once and keeps
  every tensor its autograd nodes save, except those that lie in the
  memory of a value named ``mlp_hidden`` (``mlp``), ``attn_heads``
  (``attn``) or both (``attn_mlp``). Those are dropped as they are saved
  and rebuilt in the backward, once per named value, by the function
  :func:`checkpoint_name` was given for it. A dropped value costs no
  memory: a checkpointed region would not do, since the consumer after it
  would still save its output.
- ``flash_out`` (``save_only_these_names("flash_out")``) and ``dots``
  (``checkpoint_dots``): the block is checkpointed, and the forward keeps
  the outputs of the registered attention forwards
  (``ops.flash_attention.ATTENTION_FWD_OPS``: o and lse) or of the matrix
  products, which the recompute reads instead of running them again
  (PyTorch's selective activation checkpoint). The attention kernel is
  not a matrix product, so under ``dots`` it runs again, as the Pallas
  kernel does under ``checkpoint_dots``.

A policy the port cannot honour raises; nothing falls back to full remat.
"""

from __future__ import annotations

import contextvars
import functools
from typing import Callable, Dict, FrozenSet, Optional, Tuple

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from chestxray_vit_tpu_torch.ops.flash_attention import ATTENTION_FWD_OPS

POLICIES = ("full", "mlp", "attn", "attn_mlp", "flash_out", "dots")

# save anything except values with these names
_EXCEPT: Dict[str, FrozenSet[str]] = {
    "mlp": frozenset({"mlp_hidden"}),
    "attn": frozenset({"attn_heads"}),
    "attn_mlp": frozenset({"attn_heads", "mlp_hidden"}),
}
_aten = torch.ops.aten
# save only the outputs of these ops
_SAVE_ONLY = {
    "flash_out": ATTENTION_FWD_OPS,
    "dots": (_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
             _aten.baddbmm.default),
}

# the block running under a "save anything except" policy, if any
_active: contextvars.ContextVar = contextvars.ContextVar(
    "chestxray_vit_tpu_torch_remat", default=None)


def checkpoint_name(name: str, fn: Callable, *args):
    """``fn(*args)`` (a tensor or a tuple of tensors), named ``name`` for
    the remat policies, as ``jax.ad_checkpoint.checkpoint_name`` names a
    value. Under a policy that recomputes ``name``, the tensors saved in
    the output's memory are dropped and rebuilt in the backward by
    ``fn(*args)`` under ``torch.no_grad()``: give it arguments the
    backward keeps anyway, so that dropping the output saves its memory."""
    out = fn(*args)
    block = _active.get()
    if block is not None and name in block.names:
        block.add(out, fn, args)
    return out


class _Rebuild:
    """One named value's function and arguments: run once, in the
    backward, when the first of its dropped tensors is unpacked."""

    def __init__(self, fn: Callable, args: tuple):
        self.fn, self.args = fn, args
        self.out: Optional[Tuple[torch.Tensor, ...]] = None

    def get(self, i: int) -> torch.Tensor:
        if self.out is None:
            with torch.no_grad():
                out = self.fn(*self.args)
            self.out = tuple(out) if isinstance(out, (tuple, list)) else (out,)
            self.fn = self.args = None
        return self.out[i]


def _address(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class _SaveAnythingExcept(torch.autograd.graph.saved_tensors_hooks):
    """Saved-tensor hooks over one block: a tensor saved for the backward
    is kept unless it lies in the memory of a value named in ``names``;
    then only its place in that memory is kept, and the backward rebuilds
    the value. The named outputs are held until the block ends, so their
    memory is not reused by a tensor the hooks would mistake for them."""

    def __init__(self, names: FrozenSet[str]):
        self.names = names
        # storage address -> (rebuild, output index, its storage offset, it)
        self._named: Dict[int, tuple] = {}
        super().__init__(self._pack, self._unpack)

    def add(self, out, fn: Callable, args: tuple) -> None:
        rebuild = _Rebuild(fn, args)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for i, t in enumerate(outs):
            self._named.setdefault(_address(t),
                                   (rebuild, i, t.storage_offset(), t))

    def _pack(self, t: torch.Tensor):
        hit = self._named.get(_address(t))
        if hit is None:
            return t
        rebuild, i, offset, _ = hit
        return rebuild, i, t.size(), t.stride(), t.storage_offset() - offset

    @staticmethod
    def _unpack(packed):
        if isinstance(packed, torch.Tensor):
            return packed
        rebuild, i, size, stride, offset = packed
        base = rebuild.get(i)
        return base.as_strided(size, stride, base.storage_offset() + offset)

    def __enter__(self):
        self._token = _active.set(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _active.reset(self._token)
        self._named.clear()
        return super().__exit__(*exc)


class Policy:
    """A remat policy by name: ``policy(fn, *args)`` runs one block,
    ``fn(*args)``, keeping for the backward what the policy keeps."""

    def __init__(self, name: str):
        if name not in POLICIES:
            raise ValueError(f"remat_policy {name!r}: the policies are "
                             f"{', '.join(POLICIES)}")
        self.name = name

    def __call__(self, fn: Callable, *args):
        if self.name in _EXCEPT:
            with _SaveAnythingExcept(_EXCEPT[self.name]):
                return fn(*args)
        kw = {}
        if self.name in _SAVE_ONLY:
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts,
                list(_SAVE_ONLY[self.name]))
        return checkpoint(fn, *args, use_reentrant=False, **kw)
