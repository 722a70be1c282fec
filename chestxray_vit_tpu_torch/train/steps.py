"""Train and eval steps, ported from the dense parts of
``chestxray_vit_tpu/train/steps.py``.

One train step: pixel prep on the batch's device, the ViT training forward
(bf16 activations, f32 master weights, ``cfg.model.remat`` with the
``full`` policy), BCE-with-logits, the backward through the training
attention and LayerNorm kernels, global-norm clipping and AdamW, with the
strided micro-batch gradient accumulation of the reference. PyTorch runs
eagerly, so there is no ``jit``: the step mutates the state's parameters
and moments in place and returns the same state with ``step + 1``.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP
item: mixup, the int8 straight-through forward, token merging and the
packed step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Tuple

import torch

from chestxray_vit_tpu.config import Config
from chestxray_vit_tpu_torch.models import vit
from chestxray_vit_tpu_torch.ops.preprocess import prepare_pixel_values
from chestxray_vit_tpu_torch.train import optimizer as opt

Batch = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Loss: multi-label BCE-with-logits
# ---------------------------------------------------------------------------

def bce_elements(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Element-wise numerically stable BCEWithLogits in f32:
    max(x, 0) − x·z + log1p(exp(−|x|))."""
    x = logits.float()
    z = labels.float()
    return torch.clamp(x, min=0.0) - x * z + torch.log1p(torch.exp(-x.abs()))


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Mean BCEWithLogits over all elements (torch.nn.BCEWithLogitsLoss's
    reduction, which HF picks for multi-label heads)."""
    return torch.mean(bce_elements(logits, labels))


# ---------------------------------------------------------------------------
# Train state
# ---------------------------------------------------------------------------

@dataclass
class TrainState:
    step: int                          # completed optimizer steps
    params: vit.ViT                    # f32 master weights
    opt_state: opt.OptState            # AdamW moments (f32), by name
    generator: torch.Generator = field(default_factory=torch.Generator)

    @staticmethod
    def create(params: vit.ViT, seed: int) -> "TrainState":
        """Step 0, zero moments, a generator seeded with ``seed`` (for
        dropout and augmentation, which the dense step does not draw yet)."""
        return TrainState(step=0, params=params,
                          opt_state=opt.init_opt_state(params),
                          generator=torch.Generator().manual_seed(seed))


def _not_ported(cfg: Config) -> None:
    later = {
        "data.mixup_alpha > 0 (per-sample Beta mixup is ROADMAP Queue 1 "
        "#9, beside dropout)": getattr(cfg.data, "mixup_alpha", 0.0) > 0.0,
        "model.tome_r (token merging is ROADMAP Queue 1 #7)":
            getattr(cfg.model, "tome_r", 0),
    }
    for what, on in later.items():
        if on:
            raise NotImplementedError(f"{what} is not ported yet")


def _images(cfg: Config, batch: Batch) -> torch.Tensor:
    return prepare_pixel_values(batch, out_size=cfg.model.img_size,
                                mean=cfg.data.image_mean,
                                std=cfg.data.image_std)


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------

def make_train_step(cfg: Config, total_steps: int, int8_scales=None
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build the dense train step ``(state, batch) → (state, metrics)``;
    ``metrics`` holds 0-d f32 tensors ``loss``, ``grad_norm`` and ``lr``
    on the parameters' device. ``batch`` holds ``labels`` and one pixel
    placement (see ``prepare_pixel_values``), on the parameters' device."""
    if int8_scales is not None:
        raise NotImplementedError(
            "int8_scales (the int8 straight-through train forward is "
            "ROADMAP Queue 1 #10) is not ported yet")
    _not_ported(cfg)
    schedule = opt.SCHEDULES[cfg.train.lr_schedule](
        cfg.train.learning_rate, total_steps, cfg.train.warmup_steps)
    adamw_cfg = opt.AdamWConfig(
        b1=cfg.train.adam_b1, b2=cfg.train.adam_b2, eps=cfg.train.adam_eps,
        weight_decay=cfg.train.weight_decay,
        max_grad_norm=cfg.train.max_grad_norm)
    accum = max(cfg.train.gradient_accumulation_steps, 1)

    def loss_fn(params: vit.ViT, batch: Batch) -> torch.Tensor:
        logits = vit.apply(params, _images(cfg, batch), cfg.model,
                           train=True)
        return bce_with_logits(logits, batch["labels"])

    def grads_of(params: vit.ViT, batch: Batch) -> torch.Tensor:
        """Loss, with the gradients left in ``.grad``. With accumulation
        the batch is split strided (micro-batch i takes rows i, i + k,
        …, as the reference splits it), k forward/backward passes add
        their gradients, and the loss and gradients are scaled by 1/k."""
        for p in params.parameters():
            p.grad = None
        if accum == 1:
            loss = loss_fn(params, batch)
            loss.backward()
            return loss.detach()
        loss_sum = None
        for i in range(accum):
            micro = {key: val[i::accum] for key, val in batch.items()}
            loss = loss_fn(params, micro)
            loss.backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        inv = 1.0 / accum
        for p in params.parameters():
            p.grad.mul_(inv)
        return loss_sum * inv

    def train_step(state: TrainState, batch: Batch):
        params = state.params
        loss = grads_of(params, batch)
        grads, grad_norm = opt.clip_by_global_norm(
            {n: p.grad for n, p in params.named_parameters()},
            adamw_cfg.max_grad_norm)
        lr = schedule(state.step)
        opt.adamw_update(grads, state.opt_state, params, state.step, lr,
                         adamw_cfg, opt.default_decay_mask(params))
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm,
                       "lr": lr.to(loss.device)}

    return train_step


def make_eval_step(cfg: Config) -> Callable[[vit.ViT, Batch],
                                            Tuple[torch.Tensor,
                                                  torch.Tensor]]:
    """Forward-only step returning (f32 logits [B, C], per-row BCE element
    sums [B]). Runs without autograd, so attention takes the forward-only
    kernel (``train=False``)."""
    _not_ported(cfg)

    @torch.no_grad()
    def eval_step(params: vit.ViT, batch: Batch):
        logits = vit.apply(params, _images(cfg, batch), cfg.model,
                           train=False)
        return logits, torch.sum(bce_elements(logits, batch["labels"]),
                                 dim=-1)

    return eval_step


def make_inference_eval_step(cfg: Config, quantized: bool = False,
                             tome_r: int = 0):
    """``make_eval_step`` on the serving-accelerated forwards. Only the
    dense forward is ported: int8 (ROADMAP Queue 1 #10) and token merging
    (Queue 1 #7) raise."""
    if quantized or tome_r:
        raise NotImplementedError(
            "the int8 (ROADMAP Queue 1 #10) and token-merging (Queue 1 #7) "
            "eval forwards are not ported yet")
    return make_eval_step(cfg)


def make_packed_train_step(cfg: Config, total_steps: int,
                           grids=(16, 24, 32)):
    """Packed (NaViT-style) training is not ported yet."""
    raise NotImplementedError(
        "the packed train step and its segment attention kernels are "
        "ROADMAP Queue 1 #11 and Queue 2 #6")
