"""Train and eval steps, ported from ``chestxray_vit_tpu/train/steps.py``:
the dense fine-tune and eval steps and the packed (NaViT-style) train step.

One train step: pixel prep on the batch's device, the ViT training forward
(bf16 activations, f32 master weights, ``cfg.model.remat`` with the
``full`` policy), BCE-with-logits, the backward through the training
attention and LayerNorm kernels, global-norm clipping and AdamW, with the
strided micro-batch gradient accumulation of the reference. PyTorch runs
eagerly, so there is no ``jit``: the step mutates the state's parameters
and moments in place and returns the same state with ``step + 1``.

Random numbers: where the reference splits ``state.rng`` once per step and
once per micro-batch, the port draws from the state's explicit
``torch.Generator`` (never the global RNG), per micro-batch in order: the
per-layer dropout seeds when a dropout rate is set, then the mixup λ when
``data.mixup_alpha`` is. Tests inject the reference's own draws through
``train_step(..., draws=...)``.

With ``model.tome_r`` set, the train and eval steps run the token-merging
forward (``vit.apply`` dispatches to ``models/tome_forward.py``), with
mixup, dropout, accumulation, clipping and AdamW unchanged.

The serving-accelerated eval step (``make_inference_eval_step``) runs a
quantized tree (static trees through the fused int8 kernel, dynamic ones
on the plain route) and / or the token-merging serving forward.

The packed step (``make_packed_train_step``) runs the packed forward of
``models/packed.py`` (with within-segment token merging when
``model.tome_r`` is set) under the same optimizer stack, with the loss's
numerator and denominator accumulated apart.

In a process group (``parallel/distributed.py``) both train steps sum the
gradients over the ranks in one all-reduce after the backward and before
the clip, so the clip and AdamW see the global gradient. The dense step
then divides by the world size (the ranks' batches are equal, so that is
the global batch's mean); the packed step sums its loss's numerator and
denominator in the same all-reduce and divides by the global denominator,
since ranks pack unequal numbers of real images.

A data-parallel step computes what one process computes on the global
batch, random transforms included. Rank r of ``world`` holds global rows
[r·b, (r+1)·b) of the global batch, and its micro-batch i (rows i, i + k,
… under accumulation k) is positions [r·b/k, (r+1)·b/k) of the global
micro-batch i. So each micro-batch has one row base, r·b/k (in sequences
for the packed step): the dropout masks are keyed by it
(:class:`Draws` ``row_base``), λ is drawn at the global micro-batch length
and sliced (every rank's generator stays in one state), and mixup's
partner of the first row is the previous rank's last row
(``distributed.neighbour_last_row``). The builders take ``rank`` and
``world`` (by default the process group's), so one process can compute
any rank's share: an emulated rank passes the neighbour rows in
(``train_step(..., neighbours=mixup_neighbours(cfg, previous_batch))``).

On a mesh with ``fsdp`` or ``tensor`` axes (``parallel/mesh.py``; the
state's parameters this rank's shards, ``parallel/fsdp.shard_params``)
the same step runs on the shards: the forward gathers each layer's fsdp
shards and splits each block over the tensor ranks (``models/vit.py``),
"rank" and "world" above are the batch slot (``Mesh.dp_index``) and the
number of slots (dcn × data × fsdp), the mixup neighbour and the
gradient and loss sums run over the batch group, the clip takes the full
tree's norm and AdamW updates each shard. The result is what one process
computes on the global batch. The packed step runs there alike: the
tensor ranks of a slot take its sequences and its row base, and Σnum and
Σden are summed over the batch group before the one division.

``make_train_step(int8_scales=...)`` trains on the int8 straight-through
forward (``models/int8_train.py``: int8 products forward, the dense
linear's gradients backward), merged when ``model.tome_r`` is also set;
mixup, dropout and accumulation are unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from chestxray_vit_tpu_torch.config import Config
from chestxray_vit_tpu_torch.models import int8_train
from chestxray_vit_tpu_torch.models import packed as packed_model
from chestxray_vit_tpu_torch.models import quantized as quantized_mod
from chestxray_vit_tpu_torch.models import tome_forward, vit
from chestxray_vit_tpu_torch.ops.preprocess import prepare_pixel_values
from chestxray_vit_tpu_torch.parallel import distributed as dist
from chestxray_vit_tpu_torch.parallel import mesh as mesh_lib
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
        """Step 0, zero moments, a CPU generator seeded with ``seed`` for
        the dropout seeds and the mixup λ."""
        return TrainState(step=0, params=params,
                          opt_state=opt.init_opt_state(params),
                          generator=torch.Generator().manual_seed(seed))


@dataclass
class Draws:
    """The random numbers of one micro-batch's forward."""

    # per layer: (attention, hidden after attention, hidden after the MLP);
    # None when no dropout rate is set
    seeds: Optional[List[vit.LayerSeeds]] = None
    # mixup λ per sample, f32 [micro-batch]; None without mixup
    lam: Optional[np.ndarray] = None
    # the global row (sequence) of the micro-batch's first one, which the
    # dropout masks are keyed by
    row_base: int = 0


def draw(generator: torch.Generator, cfg: Config, batch_size: int,
         rank: int = 0, world: int = 1) -> Draws:
    """One micro-batch's draws from ``generator`` for rank ``rank`` of
    ``world``, whose micro-batch of ``batch_size`` rows is positions
    [rank·batch_size, (rank+1)·batch_size) of the global one: 3 seeds per
    layer when a dropout rate is set (the attention one an int32, as the
    reference's ``_dropout_seed`` gives), then λ ~ Beta(α, α) per sample
    of the global micro-batch, sampled on the host by a numpy generator
    seeded from ``generator``, and this rank's slice of it. Every rank
    draws the same numbers, so the generators stay in one state."""
    out = Draws(row_base=rank * batch_size)
    m = cfg.model
    if m.attention_dropout > 0.0 or m.hidden_dropout > 0.0:
        raw = torch.randint(0, 2 ** 32, (m.num_layers, 3),
                            generator=generator, dtype=torch.int64).tolist()
        out.seeds = [(a - 2 ** 32 if a >= 2 ** 31 else a, h0, h1)
                     for a, h0, h1 in raw]
    alpha = cfg.data.mixup_alpha
    if alpha > 0.0:
        seed = int(torch.randint(0, 2 ** 63 - 1, (), generator=generator))
        lam = np.random.default_rng(seed).beta(
            alpha, alpha, batch_size * world).astype(np.float32)
        out.lam = lam[rank * batch_size:(rank + 1) * batch_size]
    return out


def mixup(images: torch.Tensor, labels: torch.Tensor, lam,
          prev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample mixup (the reference's, ``train/steps.py``): sample i
    mixes with the batch rolled by one, ``λ_i·x_i + (1 − λ_i)·x_{i−1}``,
    on the images and, as f32 soft labels, on the labels. ``prev`` (image
    [1, H, W, 3], labels [1, C]) is the row before the first in the global
    micro-batch; without it the roll wraps within ``images``."""
    lam = torch.tensor(lam, dtype=torch.float32).to(images.device)
    if prev is None:
        prev = images[-1:], labels[-1:]
    partner = torch.cat([prev[0].to(images.dtype), images[:-1]])
    partner_labels = torch.cat([prev[1].to(labels.dtype), labels[:-1]])
    li = lam.view(-1, 1, 1, 1)
    images = li * images + (1.0 - li) * partner
    ll = lam.view(-1, 1)
    labels = ll * labels.float() + (1.0 - ll) * partner_labels.float()
    return images, labels


def _images(cfg: Config, batch: Batch) -> torch.Tensor:
    return prepare_pixel_values(batch, out_size=cfg.model.img_size,
                                mean=cfg.data.image_mean,
                                std=cfg.data.image_std)


def micro_batches(batch: Batch, accum: int) -> List[Batch]:
    """The strided split of accumulation: micro-batch i takes rows i,
    i + accum, … (the reference's split), each made contiguous (the
    segment kernels read the ids in place)."""
    if accum == 1:
        return [batch]
    return [{key: val[i::accum].contiguous() for key, val in batch.items()}
            for i in range(accum)]


def mixup_neighbours(cfg: Config, batch: Batch
                     ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per micro-batch of ``batch`` (a rank's local batch), its last row as
    the next rank's mixup partner: (the image after pixel prep [1, H, W,
    3], the labels [1, C]). What ``distributed.neighbour_last_row`` brings
    a rank from its predecessor, for a caller that emulates the ranks in
    one process."""
    accum = max(cfg.train.gradient_accumulation_steps, 1)
    return [(_images(cfg, micro)[-1:], micro["labels"][-1:])
            for micro in micro_batches(batch, accum)]


def _optimizer(cfg: Config, total_steps: int):
    """(learning-rate schedule, AdamW settings) of ``cfg.train``."""
    schedule = opt.SCHEDULES[cfg.train.lr_schedule](
        cfg.train.learning_rate, total_steps, cfg.train.warmup_steps)
    return schedule, opt.AdamWConfig(
        b1=cfg.train.adam_b1, b2=cfg.train.adam_b2, eps=cfg.train.adam_eps,
        weight_decay=cfg.train.weight_decay,
        max_grad_norm=cfg.train.max_grad_norm)


def _update(state: TrainState, loss: torch.Tensor, schedule, adamw_cfg):
    """Clip the gradients left in ``.grad``, take the AdamW step and count
    it: (state, metrics)."""
    params = state.params
    grads, grad_norm = opt.clip_by_global_norm(
        {n: p.grad for n, p in params.named_parameters()},
        adamw_cfg.max_grad_norm, params.layout)
    lr = schedule(state.step)
    opt.adamw_update(grads, state.opt_state, params, state.step, lr,
                     adamw_cfg, opt.default_decay_mask(params))
    state.step += 1
    return state, {"loss": loss, "grad_norm": grad_norm,
                   "lr": lr.to(loss.device)}


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------

def _batch_slots(mesh, rank: Optional[int], world: Optional[int]):
    """(this rank's batch slot, the slots, the batch axis or None): the
    mesh's when one is given, else ``rank`` / ``world`` (by default the
    process group's) over the whole group."""
    if mesh is not None:
        return mesh.dp_index, mesh_lib.dp_size(mesh), mesh.axis("batch")
    return (dist.rank() if rank is None else rank,
            dist.world() if world is None else world, None)


def make_train_step(cfg: Config, total_steps: int, int8_scales=None,
                    rank: Optional[int] = None, world: Optional[int] = None,
                    mesh: Optional[mesh_lib.Mesh] = None
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build the train step ``(state, batch, draws=None, neighbours=None)
    → (state, metrics)``; ``metrics`` holds 0-d f32 tensors ``loss``,
    ``grad_norm`` and ``lr`` on the parameters' device. ``batch`` holds
    ``labels`` and one pixel placement (see ``prepare_pixel_values``), on
    the parameters' device: rank ``rank``'s slice of the global batch of
    ``world`` equal slices (by default the process group's rank and size).
    ``draws`` (one :class:`Draws` per micro-batch) replaces what the step
    would draw from ``state.generator``. ``neighbours`` (one (image,
    labels) per micro-batch, :func:`mixup_neighbours` of the previous
    rank's batch) replaces what mixup would ask the previous rank for;
    a rank emulated outside a process group must pass it. On ``mesh`` (a
    ``parallel.mesh.Mesh``; the state's parameters sharded on it) the rank
    is its batch slot and the world the number of slots.

    ``int8_scales`` (a ``calibrate_vit_scales`` tree) trains on the int8
    straight-through forward, ``apply_int8_train``, or with
    ``model.tome_r`` on the merged one, ``apply_tome_train(int8_scales=)``;
    the tree is placed on the batch's device at the first step and kept
    there; on a tensor axis the row products' per-channel scales are
    taken over the tensor group (``models/int8_train.py``)."""
    schedule, adamw_cfg = _optimizer(cfg, total_steps)
    accum = max(cfg.train.gradient_accumulation_steps, 1)
    rank, world, batch_axis = _batch_slots(mesh, rank, world)
    placed = {}                            # device -> the scales there

    def forward(params: vit.ViT, images: torch.Tensor, d: Draws):
        if int8_scales is None:
            return vit.apply(params, images, cfg.model, train=True,
                             dropout_seeds=d.seeds, row_base=d.row_base)
        if images.device not in placed:
            placed[images.device] = int8_train.place_scales(int8_scales,
                                                            images.device)
        scales = placed[images.device]
        if cfg.model.tome_r:
            return tome_forward.apply_tome_train(
                params, images, cfg.model, cfg.model.tome_r, train=True,
                dropout_seeds=d.seeds, schedule=cfg.model.tome_schedule,
                int8_scales=scales, row_base=d.row_base)
        return int8_train.apply_int8_train(params, images, cfg.model, scales,
                                           train=True, dropout_seeds=d.seeds,
                                           row_base=d.row_base)

    def loss_fn(params: vit.ViT, batch: Batch, d: Draws,
                neighbour) -> torch.Tensor:
        images, labels = _images(cfg, batch), batch["labels"]
        if d.lam is not None:
            if neighbour is None:
                if world > 1 and not dist.is_initialized():
                    raise ValueError(
                        f"rank {rank} of {world} without a process group "
                        f"needs the mixup neighbours passed in")
                neighbour = dist.neighbour_last_row(images[-1:],
                                                    labels[-1:],
                                                    axis=batch_axis)
            images, labels = mixup(images, labels, d.lam, neighbour)
        return bce_with_logits(forward(params, images, d), labels)

    def grads_of(params: vit.ViT, batch: Batch, draws: Sequence[Draws],
                 neighbours) -> torch.Tensor:
        """Loss, with the gradients left in ``.grad``. With accumulation
        the batch is split strided (micro-batch i takes rows i, i + k,
        …, as the reference splits it), k forward/backward passes add
        their gradients, and the loss and gradients are scaled by 1/k.
        Micro-batch i takes ``draws[i]``, so mixup pairs rows within the
        global micro-batch i."""
        for p in params.parameters():
            p.grad = None
        loss_sum = None
        for i, micro in enumerate(micro_batches(batch, accum)):
            loss = loss_fn(params, micro, draws[i],
                           neighbours[i] if neighbours else None)
            loss.backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        if accum == 1:
            return loss_sum
        inv = 1.0 / accum
        for p in params.parameters():
            p.grad.mul_(inv)
        return loss_sum * inv

    def train_step(state: TrainState, batch: Batch,
                   draws: Optional[Sequence[Draws]] = None,
                   neighbours: Optional[Sequence[Tuple[torch.Tensor,
                                                       torch.Tensor]]] = None):
        if draws is None:
            micro = batch["labels"].shape[0] // accum
            draws = [draw(state.generator, cfg, micro, rank, world)
                     for _ in range(accum)]
        if len(draws) != accum:
            raise ValueError(f"{len(draws)} draws for {accum} micro-batches")
        if neighbours is not None and len(neighbours) != accum:
            raise ValueError(f"{len(neighbours)} neighbours for {accum} "
                             f"micro-batches")
        loss = grads_of(state.params, batch, draws, neighbours)
        # the global mean over equal local batches; no-op without a group
        (loss,) = dist.all_reduce_grads(state.params, loss, average=True,
                                        mesh=mesh)
        return _update(state, loss, schedule, adamw_cfg)

    return train_step


def make_eval_step(cfg: Config) -> Callable[[vit.ViT, Batch],
                                            Tuple[torch.Tensor,
                                                  torch.Tensor]]:
    """Forward-only step returning (f32 logits [B, C], per-row BCE element
    sums [B]). Runs without autograd, so attention takes the forward-only
    kernel (``train=False``). ``model.tome_r`` evaluates the merged
    model."""

    @torch.no_grad()
    def eval_step(params: vit.ViT, batch: Batch):
        logits = vit.apply(params, _images(cfg, batch), cfg.model,
                           train=False)
        return logits, torch.sum(bce_elements(logits, batch["labels"]),
                                 dim=-1)

    return eval_step


def make_inference_eval_step(cfg: Config, quantized: bool = False,
                             tome_r: int = 0):
    """``make_eval_step`` on the serving-accelerated forwards: int8 (the
    step takes the quantized tree, ``models.quantized.QuantizedViT``, in
    place of the dense weights) and / or token merging (``tome_r`` pairs
    per layer under ``model.tome_schedule``, ``models/tome_forward.py``),
    with the same (logits, per-row BCE sums) contract. A static tree runs
    through the fused int8 kernel (``backend="pallas"``), a dynamic one on
    the plain route (``"xla"``); the JAX step takes "xla" for both."""

    @torch.no_grad()
    def eval_step(params, batch: Batch):
        images = _images(cfg, batch)
        backend = "pallas" if quantized and params.static else "xla"
        if tome_r:
            logits = tome_forward.apply_tome(
                params, images, cfg.model, tome_r, quantized=quantized,
                schedule=cfg.model.tome_schedule, backend=backend)
        elif quantized:
            logits = quantized_mod.apply_quantized(params, images, cfg.model,
                                                   backend=backend)
        else:
            logits = vit.apply(params, images, cfg.model, train=False)
        return logits, torch.sum(bce_elements(logits, batch["labels"]),
                                 dim=-1)

    return eval_step


def make_quantized_eval_step(cfg: Config):
    """The int8 eval step (the JAX package's alias)."""
    return make_inference_eval_step(cfg, quantized=True)


def make_packed_train_step(cfg: Config, total_steps: int,
                           grids=(16, 24, 32), rank: Optional[int] = None,
                           world: Optional[int] = None,
                           mesh: Optional[mesh_lib.Mesh] = None):
    """Build the train step over NaViT-style packed batches, ``(state,
    batch, draws=None) → (state, metrics)``: the optimizer stack of
    :func:`make_train_step`, segment-masked attention, per-image masked
    BCE. ``batch`` holds tokens, segment_ids, pos_indices, pool_weights,
    labels and image_mask (see ``data/packing.py``) on the parameters'
    device: rank ``rank``'s sequences of a global batch of ``world`` equal
    shares (by default the process group's). ``model.tome_r`` takes the
    within-segment merging forward. ``draws`` as in
    :func:`make_train_step`; the packed step has no mixup, so only the
    dropout seeds and the row base are read. ``mesh`` as in
    :func:`make_train_step`: a rank's sequences are its batch slot's (the
    tensor ranks of a slot hold the same ones and the same row base), and
    the numerator, the denominator and the gradients are summed over the
    batch group (``distributed.all_reduce_grads`` on the state's
    layout)."""
    schedule, adamw_cfg = _optimizer(cfg, total_steps)
    accum = max(cfg.train.gradient_accumulation_steps, 1)
    rank, world, _ = _batch_slots(mesh, rank, world)
    fwd = (packed_model.apply_packed_tome if cfg.model.tome_r > 0
           else packed_model.apply_packed)

    def loss_parts(params: vit.ViT, batch: Batch, d: Draws):
        """(BCE element sum over real images, real images × classes)."""
        logits = fwd(params, batch["tokens"], batch["segment_ids"],
                     batch["pos_indices"], batch["pool_weights"], cfg.model,
                     grids, train=True, dropout_seeds=d.seeds,
                     row_base=d.row_base)
        return packed_model.packed_bce_parts(logits, batch["labels"],
                                             batch["image_mask"])

    def grads_of(params: vit.ViT, batch: Batch,
                 draws: Sequence[Draws]) -> torch.Tensor:
        """Loss, with the gradients left in ``.grad``. With accumulation
        the batch carries accum × batch_seqs sequences, split strided as
        the dense step splits it. The numerators' gradients add up in
        ``.grad`` (and over the ranks) and are divided once by the summed
        denominator, so the result equals one big batch even when
        micro-batches or ranks pack unequal real-image counts."""
        for p in params.parameters():
            p.grad = None
        num_sum = den_sum = None
        for i, micro in enumerate(micro_batches(batch, accum)):
            num, den = loss_parts(params, micro, draws[i])
            num.backward()
            num, den = num.detach(), den.detach()
            num_sum = num if num_sum is None else num_sum + num
            den_sum = den if den_sum is None else den_sum + den
        for p in params.parameters():
            if p.grad is None:      # the CLS token: pooled readout instead
                p.grad = torch.zeros_like(p)
        # the sums over the ranks before the division: ranks pack unequal
        # real-image counts, so only Σnum / Σden is the global batch's loss
        num_sum, den_sum = dist.all_reduce_grads(params, num_sum, den_sum,
                                                 mesh=mesh)
        d = den_sum.clamp_min(1.0)
        for p in params.parameters():
            p.grad.div_(d)
        return num_sum / d

    def train_step(state: TrainState, batch: Batch,
                   draws: Optional[Sequence[Draws]] = None):
        if draws is None:
            micro = batch["tokens"].shape[0] // accum
            draws = [draw(state.generator, cfg, micro, rank, world)
                     for _ in range(accum)]
        if len(draws) != accum:
            raise ValueError(f"{len(draws)} draws for {accum} micro-batches")
        loss = grads_of(state.params, batch, draws)
        return _update(state, loss, schedule, adamw_cfg)

    return train_step
