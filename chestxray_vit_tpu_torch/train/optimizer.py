"""AdamW, learning-rate schedules and global-norm clipping, ported from
``chestxray_vit_tpu/train/optimizer.py``.

Plain tensor code in f32, written out term for term as the JAX functions
compute it (``torch.optim.AdamW`` is not used: its parity with the JAX
update is unverified). Parameters, gradients and moments are keyed by the
port's parameter names; the update runs in place under ``torch.no_grad()``
(the JAX version returns new trees).

On a sharded tree (``parallel/fsdp.py``) each rank updates its shards
elementwise, and the global norm counts every element of the full tree
once: a leaf's squares on the ranks that hold distinct parts of it,
summed over the group.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import torch
from torch import nn

from chestxray_vit_tpu_torch.parallel import distributed as dist

OptState = Dict[str, Dict[str, torch.Tensor]]
Schedule = Callable[[int], torch.Tensor]


# ---------------------------------------------------------------------------
# Schedules: step → f32 0-d tensor on the CPU
# ---------------------------------------------------------------------------

def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def linear_schedule(base_lr: float, total_steps: int,
                    warmup_steps: int = 0) -> Schedule:
    """HF Trainer default: linear warmup (0 steps by default) then linear
    decay to 0 at ``total_steps``."""

    def lr(step) -> torch.Tensor:
        step = _f32(step)
        warm = (torch.clamp(step / max(warmup_steps, 1), max=1.0)
                if warmup_steps > 0 else _f32(1.0))
        decay_span = max(total_steps - warmup_steps, 1)
        decay = torch.clamp((total_steps - step) / decay_span, 0.0, 1.0)
        return base_lr * torch.where(step < warmup_steps, warm, decay)

    return lr


def cosine_schedule(base_lr: float, total_steps: int,
                    warmup_steps: int = 0) -> Schedule:
    def lr(step) -> torch.Tensor:
        step = _f32(step)
        warm = step / max(warmup_steps, 1)
        progress = torch.clamp((step - warmup_steps)
                               / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * progress))
        return base_lr * torch.where(step < warmup_steps, warm, cos)

    return lr


def constant_schedule(base_lr: float, *_args) -> Schedule:
    return lambda step: _f32(base_lr)


SCHEDULES = {
    "linear": linear_schedule,
    "cosine": cosine_schedule,
    "constant": constant_schedule,
}


# ---------------------------------------------------------------------------
# Decay mask (HF Trainer get_decay_parameter_names parity)
# ---------------------------------------------------------------------------

def default_decay_mask(params: nn.Module) -> Dict[str, bool]:
    """True where weight decay applies, by parameter name. HF Trainer
    decays everything except biases and LayerNorm weights; cls_token and
    pos_embed DO decay (plain Parameters, not LayerNorm or bias)."""
    out = {}
    for name, _ in params.named_parameters():
        parts = name.split(".")
        in_ln = any(p in ("ln1", "ln2", "final_ln") for p in parts)
        out[name] = not (parts[-1] == "bias" or in_ln)
    return out


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0


def init_opt_state(params: nn.Module) -> OptState:
    """Zero f32 moments on each parameter's device."""
    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.named_parameters()}
    return {"mu": zeros(), "nu": zeros()}


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


def sharded_global_norm(grads: Mapping[str, torch.Tensor], layout
                        ) -> torch.Tensor:
    """:func:`global_norm` of the full tree whose shards ``grads`` holds
    (by name, as ``layout`` splits them): each rank sums the squares of
    the leaves it owns (a leaf split on an axis is owned by every rank of
    that axis, one whole on it by the axis's index 0, and the tree by the
    first dcn × data replica), then one all-reduce over the group."""
    mesh = layout.mesh
    c, d, f, t = mesh.coords
    parts = []
    if c == 0 and d == 0:
        for name, g in grads.items():
            fd, tdim = layout.of(name)
            if (fd is not None or f == 0) and (tdim is not None or t == 0):
                parts.append(torch.sum(torch.square(g.float())))
    dev = next(iter(grads.values())).device
    total = (sum(parts) if parts
             else torch.zeros((), dtype=torch.float32, device=dev))
    return torch.sqrt(dist.world_axis().all_reduce(total.reshape(1))
                      .reshape(()))


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float,
                        layout: Optional[object] = None
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Scale every gradient by min(1, max_norm / (norm + 1e-6)); returns
    the scaled gradients and the norm before clipping. With a sharded
    tree's ``layout`` the norm is the full tree's
    (:func:`sharded_global_norm`)."""
    norm = (global_norm(grads.values()) if layout is None
            else sharded_global_norm(grads, layout))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return {n: g * scale for n, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], opt_state: OptState,
                 params: nn.Module, step: int, lr: torch.Tensor,
                 cfg: AdamWConfig, decay_mask: Mapping[str, bool]) -> None:
    """One AdamW step in place (decoupled weight decay, bias-corrected
    moments). ``step`` is the 0-based completed-step counter; the bias
    correction uses t = step + 1 in f32, as the JAX update does."""
    dev = next(params.parameters()).device
    t = _f32(step + 1).to(dev)
    c1 = 1.0 - _f32(cfg.b1).to(dev) ** t
    c2 = 1.0 - _f32(cfg.b2).to(dev) ** t
    lr = _f32(lr).to(dev)
    for name, p in params.named_parameters():
        g = grads[name].float()
        p32 = p.float()
        mu = cfg.b1 * opt_state["mu"][name] + (1.0 - cfg.b1) * g
        nu = cfg.b2 * opt_state["nu"][name] + (1.0 - cfg.b2) * torch.square(g)
        step_val = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        wd = cfg.weight_decay if decay_mask[name] else 0.0
        p.copy_(p32 - lr * (step_val + wd * p32))
        opt_state["mu"][name] = mu
        opt_state["nu"][name] = nu
