"""Packed variable-resolution trainer of the port, ported from
``chestxray_vit_tpu/train/packed_trainer.py``.

Subclasses :class:`Trainer` to train over NaViT-style packed sequences:
several variable-resolution images share each ``seq_len``-token sequence,
isolated by the segment-masked attention kernels; evaluation packs too (a
packed-trained model has no trained CLS token: the per-image masked mean
is its readout in both phases).

- Mid-epoch resume is exact and skips before any I/O: emitted packed
  batches always cover a prefix of the epoch order, so the checkpoint
  cursor stores the cumulative image count, and resume re-packs the rest
  of the stream bit for bit without fetching or decoding trained images.
- Steps per epoch come from a sampled token census driven through the
  real next-fit packer (exact for uniform resolutions), so the learning
  rate schedule and the epoch cadence use the true step count.
- An optimizer step consumes ``batch_seqs × gradient_accumulation_steps``
  sequences; ``batch_seqs`` must divide by the number of batch slots.
- Across processes (``torchrun``, or one rank a device when a lone
  process is given several: ``device=["cuda:0"] * 4`` runs 1 × 2 × 2 on
  one card), the ranks form the mesh of ``cfg.mesh`` as in the dense
  Trainer, and the epoch's image stream is
  sharded by batch slot (``Mesh.dp_index`` of ``dp_size``: dcn × data ×
  fsdp; the "hosts" of the messages and of the cursor's ``per_host``)
  before packing (``order[slot::slots]``); each slot packs its shard into
  ``batch_seqs / slots`` sequences a micro-batch, and the tensor ranks of
  one slot load the same sequences (checked once, at the first step, by a
  checksum over the tensor group). On fsdp or tensor axes the state is
  sharded and the packed step gathers and splits as ``train/steps.py``
  says. The step sums the gradients and the loss's numerator and
  denominator over the batch group, so it is the function of the
  concatenated global batch although the slots pack unequal image counts.
  Epochs are capped at the census's ``steps_per_epoch`` on every rank, so
  the collectives never diverge, and the cursor stores each slot's
  consumed-image count (one ``per_host`` entry a slot), so a run resumes
  on the same slot count.
- Eval runs the packed forward over the whole index on every rank, on the
  rank's shards (the same collectives in the same order on every rank),
  so every rank computes the same metrics.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from chestxray_vit_tpu_torch.config import Config
from chestxray_vit_tpu_torch.data import packing as pk
from chestxray_vit_tpu_torch.data import pipeline as pipe
from chestxray_vit_tpu_torch.models import packed as packed_model
from chestxray_vit_tpu_torch.parallel import distributed as dist
from chestxray_vit_tpu_torch.parallel import mesh as mesh_lib
from chestxray_vit_tpu_torch.train import checkpoint as ckpt
from chestxray_vit_tpu_torch.train import steps as S
from chestxray_vit_tpu_torch.train.trainer import Trainer
from chestxray_vit_tpu_torch.utils import flops as F


class PackedTrainer(Trainer):
    def __init__(self, cfg: Config, *, seq_len: int = 1152,
                 grids: Tuple[int, ...] = (16, 24, 32),
                 batch_seqs: int = 8, census_sample: int = 128, **kw):
        self.seq_len = seq_len
        self.grids = tuple(grids)
        self.batch_seqs = batch_seqs
        self._images_cum = [0]     # cumulative images after k consumed batches
        self._resume_skip = 0
        self._local_skip = 0
        super().__init__(cfg, **kw)
        # the host count is the number of batch slots (dcn × data × fsdp);
        # the tensor ranks of a slot load its sequences alike
        self._hosts = mesh_lib.dp_size(self.mesh)
        self._slot_checked = self.mesh.tensor == 1
        if batch_seqs % self._hosts:
            raise ValueError(f"batch_seqs={batch_seqs} not divisible by "
                             f"host count (the data-parallel world size) "
                             f"{self._hosts}")
        self._accum = max(cfg.train.gradient_accumulation_steps, 1)
        # sequences one process loads per optimizer step (micro × accum)
        self._local_step_seqs = (batch_seqs // self._hosts) * self._accum
        # epoch accounting: a sampled token census through the real
        # next-fit packer
        cap = self.seq_len // min(g * g for g in self.grids)
        counts = pk.sample_token_counts(
            self.bundle.train, self.bundle.blob_map, self.bundle.store,
            patch=cfg.model.patch_size, grids=self.grids,
            sample=census_sample, num_workers=cfg.data.num_workers)
        # the smallest shard bounds the agreed epoch length (strided shards
        # differ by at most one image)
        n_local_min = len(self.bundle.train) // self._hosts
        total_seqs_local = pk.estimate_sequences_per_epoch(
            counts, n_local_min, self.seq_len, cap)
        # the tail batch is dropped in training (static shapes)
        self.steps_per_epoch = max(
            total_seqs_local // self._local_step_seqs, 1)
        # the base __init__ derived the schedule's horizon from dense sample
        # counts: re-derive it from the packed steps and rebuild the steps
        new_total = (cfg.train.max_steps
                     or int(math.ceil(self.steps_per_epoch
                                      * cfg.train.num_epochs)))
        if new_total != self.total_steps:
            self.total_steps = new_total
            self._build_steps()
        # throughput and MFU in packed units: a step consumes about
        # len(train) / steps_per_epoch images and costs batch_seqs × accum
        # sequences of seq_len tokens
        self._images_per_step = max(
            len(self.bundle.train) // self.steps_per_epoch, 1)
        self._flops_per_image = (
            F.packed_flops_per_sequence(cfg.model, self.seq_len)
            * self.batch_seqs * self._accum / self._images_per_step)

    def _has_full_batch(self) -> bool:
        return len(self.bundle.train) > 0

    def _view(self):
        return {**super()._view(), "seq_len": self.seq_len,
                "grids": self.grids, "batch_seqs": self.batch_seqs}

    def _build_steps(self) -> None:
        # the accelerated eval knobs run the dense CLS-readout forward; a
        # packed-trained model evaluates through the packed masked mean,
        # which has no int8 or merged-eval variant: refuse rather than
        # report dense numbers for a setting the user thinks is active
        if self.cfg.train.eval_quantize or self.cfg.train.eval_tome_r:
            raise ValueError(
                "train.eval_quantize / train.eval_tome_r do not compose "
                "with PackedTrainer (its eval packs sequences and reads "
                "out a masked mean, not the dense CLS forward those knobs "
                "accelerate) — unset them or use the dense Trainer")
        self._train_step = self._make_step_fn(self.cfg)
        self._eval_step = None  # the packed eval below
        # the dense warmup (train.tome_warmup) composes: the base helper
        # builds the same packed step with tome_r=0 through _make_step_fn
        self._warmup_step = self._build_tome_warmup_step()

    def _make_step_fn(self, cfg):
        step = S.make_packed_train_step(cfg, self.total_steps, self.grids,
                                        mesh=self.mesh)

        def checked_step(state, batch):
            if not self._slot_checked:
                self._check_slot_batch(batch)
            return step(state, batch)
        return checked_step

    def _check_slot_batch(self, batch) -> None:
        """The tensor ranks of a batch slot must train on the same
        sequences: compare a checksum of the first batch over the tensor
        group once (on the main thread, where the step's collectives
        run)."""
        sums = torch.stack([batch[k].double().sum() for k in
                            ("tokens", "segment_ids", "pool_weights",
                             "labels")]).cpu()
        got = self.mesh.axis("tensor").all_gather_rows(sums)
        if not all(torch.equal(g, sums) for g in got):
            raise RuntimeError(
                f"the tensor ranks of batch slot {self.mesh.dp_index} "
                f"loaded other sequences: checksums "
                f"{[g.tolist() for g in got]}")
        self._slot_checked = True

    # ------------------------------------------------------------------

    def _packed_iter(self, index, epoch: int, *, batch_seqs: int,
                     skip_images: int = 0, host_shard=None, shuffle=True
                     ) -> Iterator[Dict[str, np.ndarray]]:
        return pk.iterate_packed_batches(
            index, self.bundle.blob_map, self.bundle.store,
            batch_seqs=batch_seqs,
            patch=self.cfg.model.patch_size,
            seq_len=self.seq_len, grids=self.grids,
            epoch=epoch, shuffle=shuffle,
            seed=self.cfg.data.shuffle_buffer_seed,
            num_workers=self.cfg.data.num_workers,
            skip_images=skip_images,
            host_shard=host_shard)

    def _train_batches(self, epoch: int, skip: int = 0):
        """``skip`` counts IMAGES, not batches: emitted packed batches
        cover a prefix of the epoch order, so skipping the prefix before
        any fetch or decode and re-packing the rest reproduces the
        uninterrupted run's batches exactly. Across batch slots ``skip``
        is the global image count of the cursor, and each slot skips its
        own ``per_host`` entry of its shard. The integers ``n_seqs`` and
        ``n_images`` are popped here, on the host, before the batch is
        copied to the device."""
        hosts, rank = self._hosts, self.mesh.dp_index
        rc = getattr(self, "_restored_cursor", None)
        if hosts > 1:
            local_skip = 0
            if skip:
                if rc is None or rc.per_host is None:
                    raise ValueError(
                        "multi-host packed resume needs a cursor with "
                        "per-host image counts; this checkpoint carries "
                        "none (was it written by a single-host run?)")
                if len(rc.per_host) != hosts:
                    # another host count reshapes every shard
                    # (order[slot::H]): reusing the counts would train some
                    # images twice and skip others
                    raise ValueError(
                        f"checkpoint cursor was written by "
                        f"{len(rc.per_host)} hosts but this run has "
                        f"{hosts}; mid-epoch packed resume cannot change "
                        f"the host count (resume from an epoch boundary "
                        f"or restore the original topology)")
                local_skip = int(rc.per_host[rank])
        else:
            if (skip and rc is not None and rc.per_host is not None
                    and len(rc.per_host) != 1):
                # a multi-host checkpoint consumed interleaved shards; a
                # prefix skip of the unsharded order would train some
                # images twice and never see others
                raise ValueError(
                    f"checkpoint cursor was written by "
                    f"{len(rc.per_host)} hosts but this run has 1; "
                    f"mid-epoch packed resume cannot change the host "
                    f"count (resume from an epoch boundary or restore "
                    f"the original topology)")
            local_skip = skip
        # the cumulative image counts are appended when a batch is PRODUCED
        # (this generator runs in DevicePrefetcher's thread, batches ahead
        # of the step) and indexed when it is CONSUMED (_save, by the train
        # loop's batch_idx): a cursor must count trained images, not images
        # waiting in the prefetch queue
        self._resume_skip = skip       # what the base loop's batch_idx seeds
        self._local_skip = local_skip
        self._images_cum = cum = [local_skip]
        # across processes every epoch has exactly steps_per_epoch batches,
        # so every rank issues the same collectives; the batches consumed
        # this epoch follow from the step counter
        remaining = None
        if hosts > 1:
            done = max(int(self.state.step) - epoch * self.steps_per_epoch,
                       0)
            remaining = self.steps_per_epoch - done
            if remaining <= 0:
                return
        emitted = 0
        for batch in self._packed_iter(
                self.bundle.train, epoch,
                batch_seqs=self._local_step_seqs,
                skip_images=local_skip,
                host_shard=(rank, hosts) if hosts > 1 else None):
            n_seqs = int(batch.pop("n_seqs"))
            n_images = int(batch.pop("n_images"))
            if n_seqs < self._local_step_seqs:
                continue   # drop the zero-padded tail batch (drop_last)
            cum.append(cum[-1] + n_images)
            yield batch
            emitted += 1
            if remaining is not None and emitted >= remaining:
                return
        if remaining is not None and emitted < remaining:
            # fewer batches than the agreed epoch length would leave the
            # other ranks blocked in a collective: fail on this one
            raise RuntimeError(
                f"host {rank} packed only {emitted}/{remaining} batches "
                f"this epoch; the token census over-estimated "
                f"steps_per_epoch for this shard (raise census_sample or "
                f"lower batch_seqs)")

    def _epoch_progress(self, batch_idx: int) -> float:
        """Images this slot consumed / images in its shard (the packed
        batch_idx carries an image-count resume offset, so the base hook's
        batch_idx / steps_per_epoch would mix units)."""
        consumed = batch_idx - self._resume_skip
        if not 0 <= consumed < len(self._images_cum):
            return 0.0
        shard = max(len(self.bundle.train) // self._hosts, 1)
        return self._images_cum[consumed] / shard

    def _save(self, step: int, epoch: int, batch_idx: int) -> None:
        # the packed cursor stores images consumed: the base loop's
        # batch_idx is the resume skip (an IMAGE count here) plus the
        # batches consumed so far this epoch
        metrics = (self._last_eval_metrics
                   if self._last_eval_step == step else None)
        consumed = batch_idx - self._resume_skip
        if batch_idx == 0:
            # an epoch-boundary save: the new epoch starts from image 0 (the
            # resume offset belongs to the finished epoch; leaking it would
            # make a later resume skip never-trained data)
            images = 0
        elif consumed <= 0:
            images = self._local_skip       # resumed, nothing consumed yet
        else:
            images = self._images_cum[consumed]
        if self._hosts > 1:
            # one entry a batch slot, in slot order (the tensor ranks of a
            # slot consumed the same images)
            vec = dist.process_allgather(
                np.asarray([images], np.int64), self._batch_axis).reshape(-1)
            cursor = ckpt.DataCursor(epoch, int(vec.sum()),
                                     per_host=[int(v) for v in vec])
        else:
            cursor = ckpt.DataCursor(epoch, images)
        self.ckpt.save(step, self.state, cursor=cursor, metrics=metrics)

    # ------------------------------------------------------------------

    def _forward_all(self, index):
        """Packed eval: logits per image through the masked mean pooling.
        Every process evaluates the whole index: on a replicated tree
        without collectives, on a sharded one through the sharded packed
        forward, every rank issuing the same gathers and tensor sums in
        the same order (the port's processes stand in for the devices the
        JAX package's jit spans). Duplicated work across processes, but the
        same metrics everywhere, so metric-driven decisions never
        diverge."""
        if len(index) == 0:
            c = self.cfg.model.num_classes
            return (np.zeros((0, c), np.float32),
                    np.zeros((0, c), np.float32), 0.0)
        # model.tome_r merges at eval too, as the dense Trainer's does
        fwd = (packed_model.apply_packed_tome if self.cfg.model.tome_r > 0
               else packed_model.apply_packed)
        logits_all, labels_all = [], []
        total_loss, total_n = 0.0, 0
        for batch in self._packed_iter(index, 0,
                                       batch_seqs=self.batch_seqs,
                                       shuffle=False):
            # batches are always batch_seqs sequences (the tail is padded
            # with empty ones, whose image_mask is False)
            batch.pop("n_seqs")
            batch.pop("n_images")
            placed = pipe.to_device(batch, self.device)
            with torch.no_grad():
                logits_dev = fwd(self.state.params, placed["tokens"],
                                 placed["segment_ids"],
                                 placed["pos_indices"],
                                 placed["pool_weights"], self.cfg.model,
                                 self.grids)
                loss = float(packed_model.packed_bce_loss(
                    logits_dev, placed["labels"], placed["image_mask"]))
            logits = logits_dev.float().cpu().numpy()
            mask = batch["image_mask"]
            got = logits[mask]
            total_loss += loss * got.shape[0]
            total_n += got.shape[0]
            logits_all.append(got)
            labels_all.append(batch["labels"][mask])
        return (np.concatenate(logits_all), np.concatenate(labels_all),
                total_loss / max(total_n, 1))
