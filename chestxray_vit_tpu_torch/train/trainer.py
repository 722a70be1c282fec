"""Training orchestrator of the port, ported from
``chestxray_vit_tpu/train/trainer.py``: the HF-Trainer-equivalent top of
the stack.

``train()`` with steps- or epoch-cadenced eval / save / log, best-model
tracking and its restore at the end, a NaN guard and a checkpoint on
SIGTERM / SIGINT; ``evaluate()`` with avg_auroc and f1_micro; ``predict()``
with the classification report and optional calibrated thresholds;
``save_model()`` and ``save_state()``. Resume is exact: the checkpoint
holds the parameters, the AdamW moments, the generator and the data cursor,
and the loader skips the consumed batches before any decode.

``device`` names the devices as the JAX package's ``jax.devices()`` does
(``parallel/launch.train_devices``): 'cuda' (the default) is every visible
card, 'cuda:k' one, 'cpu' the CPU (as the tests ask), a sequence those
devices, repeats allowed; a card asked for without one raises. One device
runs here. Several devices, in a process outside any group, run as one
rank a device (``parallel/launch.py``): ``Trainer(...)`` then returns a
:class:`SpawnedTrainer`, which relays ``train``, ``evaluate``,
``predict``, ``save_model``, ``save_state``, ``save_metrics``,
``restore``, ``request_stop`` and ``close`` to the ranks, reads ``cfg``,
``mesh`` and the batch and step counts as rank 0 has them, and moves the
full ``state`` between this host and the ranks; its output directory holds
what one process writes, file for file. Batches are decoded on host
threads and copied to the card on a side stream ahead of the step
(``data/pipeline.py``). The step is ``train/steps.py``'s, so the Trainer
runs the port's kernels on the card and their plain twins on the CPU.

Across processes: the ranks a lone process starts, or N processes started
under ``torchrun --nproc_per_node N`` (after
``parallel.distributed.initialize()``; one device each), form the mesh of
``cfg.mesh`` over their devices (``parallel/mesh.py``: dcn_data × data ×
fsdp × tensor = N, data -1 taking the rest, as the JAX ``build_mesh``).
The batch slots (dcn × data × fsdp) share each global batch of
``batch_size_per_core × slots × accumulation`` samples;
each decodes only its slot's rows (``host_batch_slice``; the tensor ranks
of a slot load the same ones). The state is placed by ``param_layout``:
on an fsdp or tensor axis each rank holds its shards of the parameters
and of both AdamW moments (``parallel/fsdp.shard_params``), and the step
gathers and splits as ``train/steps.py`` says. The step sums the
gradients over the batch group before the clip, and eval gathers the
logits, row losses and labels over it, so every rank computes the same
metrics and makes the same best-model decision. Checkpoints and the saved
model hold the full tree, gathered from every rank and written by rank 0,
so a checkpoint from any mesh resumes on any other (each rank reads its
shards of it), as orbax restores into any sharding. The primary rank writes ``metrics.jsonl``,
TensorBoard, the checkpoints, ``trainer_state.json`` and the saved model;
the others log to ``metrics.rank{N}.jsonl`` (in the ranks' own directory
when a lone process started them: the JAX package's one process writes
none). A preemption stop is agreed on the sync cadence, so every rank
stops at the same step.

``pretrained=True`` starts from the HF weights named by
``model.model_name`` (a local HF folder or ``.safetensors`` file, or, with
``transformers`` installed, the HF cache; ``models/import_hf.py``), their
position embeddings resampled to ``model.img_size``; unreachable weights
degrade to random init with a printed line, as in the reference. The
``hf_dataset`` backend reads ``data.hf_dataset_name`` through
``data/hf_datasets.py``. ``output_dir`` is a local directory: it holds the
logs and the saved model, and a ``gs://`` one is refused
(``checkpoint.local_dir``).

Across processes, attention dropout, hidden dropout and mixup draw what
one process draws on the global batch: the steps are built with this
process's rank and the world size (``train/steps.py``).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import pickle
import signal
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from chestxray_vit_tpu_torch.config import Config
from chestxray_vit_tpu_torch.data import pipeline as pipe
from chestxray_vit_tpu_torch.data.storage import Store
from chestxray_vit_tpu_torch.eval import metrics as M
from chestxray_vit_tpu_torch.models import import_hf, vit
from chestxray_vit_tpu_torch.models import quantized as qmod
from chestxray_vit_tpu_torch.models.export_hf import write_preprocessor_config
from chestxray_vit_tpu_torch.ops.preprocess import prepare_pixel_values
from chestxray_vit_tpu_torch.parallel import distributed as dist
from chestxray_vit_tpu_torch.parallel import fsdp
from chestxray_vit_tpu_torch.parallel import launch
from chestxray_vit_tpu_torch.parallel import mesh as mesh_lib
from chestxray_vit_tpu_torch.train import checkpoint as ckpt
from chestxray_vit_tpu_torch.train import steps as S
from chestxray_vit_tpu_torch.utils import flops as F
from chestxray_vit_tpu_torch.utils.logging import MetricLogger, ThroughputMeter
from chestxray_vit_tpu_torch.utils.profiling import StepProfiler


def merged_floor_hint(history, step, total_steps, tome_r, warmup_steps,
                      *, after_frac=0.6, min_progress=0.02):
    """Measured-guidance check for merged training's bad init mode: the
    failure signature is visible mid-run — the eval metric is still at its
    starting floor past ~60% of the schedule, while healthy runs have
    taken off by then. Returns a one-line hint when that signature is
    present, else None. Pure function (the trainer emits it at most once
    per run); ``history`` is [(step, avg_auroc), ...] in order.
    Inapplicable (returns None) when training is dense, a dense warmup is
    already configured (the measured rescue), or fewer than two evals have
    landed."""
    if not tome_r or warmup_steps or len(history) < 2:
        return None
    if step < after_frac * max(total_steps, 1):
        return None
    first = history[0][1]
    best = max(v for _, v in history)
    if best - first >= min_progress:
        return None
    return (f"[trainer] merged training is still at its starting metric "
            f"floor past {int(100 * after_frac)}% of the schedule (best "
            f"avg_auroc {best:.3f} vs first eval {first:.3f}) — the "
            f"measured init-sensitivity bad mode (BENCH_NOTES "
            f"'Dense-warmup rescue'). Restart with train.tome_warmup "
            f"(e.g. 0.375 = 37.5% of total steps) to train dense through "
            f"the takeoff window, then merge.")


def _group_device(device) -> torch.device:
    """The one device a rank of a process group drives; a sequence of
    several is refused there."""
    if isinstance(device, (list, tuple)):
        if len(device) != 1:
            raise ValueError(
                f"device={device!r} in a process group: one rank drives "
                f"one device (start one process a device, or call from a "
                f"process outside any group to start them)")
        device = device[0]
    return torch.device(device)


class Trainer:
    def __new__(cls, *args, device="cuda", **kw):
        """Several devices in a process outside any group: one rank a
        device, driven through a :class:`SpawnedTrainer`."""
        if not dist.is_initialized():
            devices = launch.train_devices(device)
            if len(devices) > 1:
                return SpawnedTrainer(cls, devices, args, kw)
        return super().__new__(cls)

    def __init__(self, cfg: Config, store: Optional[Store] = None,
                 pretrained: bool = True, datasets=None, *, device="cuda"):
        """``datasets`` optionally injects (train, val, test, classes)
        loader adapters directly (objects that ``iterate_batches`` can
        iterate: ``index`` with ``len`` and ``augment``, and ``load``)."""
        self.device = (_group_device(device) if dist.is_initialized()
                       else launch.train_devices(device)[0])
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer(device='cuda') but no CUDA device "
                               "is available")
        self.mesh = mesh_lib.build_mesh(cfg.mesh)
        self._world = mesh_lib.dp_size(self.mesh)
        # the batch group: eval gathers over it
        self._batch_axis = self.mesh.axis("batch")
        ckpt.local_dir(cfg.train.output_dir, "train.output_dir (the logs "
                       "and the saved model)")
        self.cfg = cfg
        if datasets is None and cfg.data.backend == "hf_dataset":
            from chestxray_vit_tpu_torch.data.hf_datasets import (
                load_hf_dataset)
            datasets = load_hf_dataset(cfg.data.hf_dataset_name,
                                       img_size=cfg.model.img_size,
                                       augment_train=cfg.data.augment)
        if datasets is not None:
            train, val, test, classes = datasets
            self.bundle = pipe.DatasetBundle(
                train=train, val=val, test=test, classes=list(classes),
                blob_map={}, store=store)
            self._adapters = True
        else:
            self.bundle = pipe.build_datasets(cfg.data, store=store)
            self._adapters = False
        # the number of classes comes from the data, as in the reference
        cfg.model.num_classes = len(self.bundle.classes)

        # the reference's bf16 switch: off runs the compute in f32
        if not cfg.train.bf16 and cfg.model.dtype == "bfloat16":
            cfg.model.dtype = "float32"

        params = None
        if pretrained:
            params = import_hf.load_pretrained(
                cfg.model.model_name, cfg.model, seed=cfg.train.seed,
                device=self.device)
        if params is None:
            params = vit.init_params(torch.Generator().manual_seed(
                cfg.train.seed), cfg.model, device=self.device)
        else:
            # @512-style fine-tunes reuse @384 checkpoints: resample the
            # position embeddings to the configured grid
            params = vit.adapt_params_to_img_size(params, cfg.model)
        # every rank drew or read the same full tree: keep this rank's
        # shards (the moments follow their shapes)
        params = fsdp.shard_params(params, self.mesh)
        self.state = S.TrainState.create(params, cfg.train.seed)

        # loader batch = micro-batch x processes x accumulation steps (one
        # optimizer update consumes the whole of it; each process loads its
        # slice)
        self.global_batch = (mesh_lib.local_batch_to_global(
            cfg.train.batch_size_per_core, self.mesh)
            * max(cfg.train.gradient_accumulation_steps, 1))
        self.eval_batch = cfg.train.eval_batch_size * self._world

        self.steps_per_epoch = max(
            len(self.bundle.train) // self.global_batch, 1)
        self.total_steps = (cfg.train.max_steps
                            or int(math.ceil(self.steps_per_epoch
                                             * cfg.train.num_epochs)))

        # merged_floor_hint: eval-metric history and the emitted-once latch
        self._auroc_history: list = []
        self._floor_hint_done = False
        self._build_steps()

        out_dir = os.path.expanduser(cfg.train.output_dir)
        # one logical log: the other ranks keep their own jsonl only, in
        # the ranks' own directory when a lone process started them
        primary = dist.is_primary()
        side = None if primary else launch.rank_directory()
        self.logger = MetricLogger(
            side or out_dir, cfg.train.report_to if primary else "none",
            jsonl_name=("metrics.jsonl" if primary
                        else f"metrics.rank{dist.rank()}.jsonl"))
        self.profiler = StepProfiler(side or out_dir, cfg.train.profile_steps)
        self.ckpt = ckpt.CheckpointManager(
            os.path.join(out_dir, "checkpoints"),
            save_total_limit=cfg.train.save_total_limit,
            metric_for_best=(cfg.train.metric_for_best_model
                             if cfg.train.load_best_model_at_end else None),
            greater_is_better=cfg.train.greater_is_better,
            primary=primary)
        self._meter = ThroughputMeter()
        # live MFU accounting (utils/flops) against the card's bf16 peak;
        # none on the CPU
        self._images_per_step = self.global_batch
        self._flops_per_image = F.model_flops_per_image(cfg.model)
        self._chip_peak = (F.chip_peak_flops(
            torch.cuda.get_device_name(self.device))
            if self.device.type == "cuda" else None)
        self._last_eval_metrics: Dict[str, float] = {}
        self._last_eval_step: int = -1

    def _has_full_batch(self) -> bool:
        """Whether the train split can produce at least one full batch
        (subclass hook: packed batching counts sequences)."""
        return len(self.bundle.train) >= self.global_batch

    def _build_steps(self) -> None:
        """Build the train / eval step functions (subclass hook)."""
        self._train_step = self._make_step_fn(self.cfg)
        self._eval_step = S.make_eval_step(self.cfg)
        if self.cfg.train.eval_quantize not in (None, "static", "dynamic"):
            raise ValueError(
                f"train.eval_quantize must be None|'static'|'dynamic', got "
                f"{self.cfg.train.eval_quantize!r}")
        if self.cfg.train.eval_tome_r < 0:
            raise ValueError(
                f"train.eval_tome_r must be >= 0, got "
                f"{self.cfg.train.eval_tome_r}")
        mr = self.cfg.model.tome_r
        if mr and self.cfg.train.eval_tome_r not in (0, mr):
            # a token-merging model already evaluates merged; an
            # accelerated eval at another r would score another function
            raise ValueError(
                f"train.eval_tome_r={self.cfg.train.eval_tome_r} "
                f"conflicts with model.tome_r={mr} — the model trains "
                f"AND evaluates with its own r; leave eval_tome_r unset "
                f"(or equal) and use eval_quantize to accelerate")
        self._warmup_step = self._build_tome_warmup_step()

    def _maybe_floor_hint(self, step: int) -> None:
        """Track eval avg_auroc and emit merged_floor_hint's guidance at
        most once per run."""
        v = (self._last_eval_metrics or {}).get("avg_auroc")
        if v is None or not math.isfinite(float(v)):
            return
        self._auroc_history.append((step, float(v)))
        if self._floor_hint_done or not dist.is_primary():
            return
        hint = merged_floor_hint(
            self._auroc_history, step, self.total_steps,
            self.cfg.model.tome_r, self._tome_warmup_steps)
        if hint:
            self._floor_hint_done = True
            print(hint)

    def _build_tome_warmup_step(self):
        """Dense-warmup step for token-merged training (train.tome_warmup):
        the same train step with model.tome_r=0 — steps 1..tome_warmup run
        it, later steps run the merged step. Parameters, moments and the LR
        schedule are continuous across the switch (merging has no
        parameters; the schedule is built over the shared total_steps).

        Resolves ``self._tome_warmup_steps``: values >= 1 are absolute
        steps; a fraction in (0, 1) means that fraction of total_steps."""
        tw = self.cfg.train.tome_warmup
        if tw < 0:
            raise ValueError(f"train.tome_warmup must be >= 0, got {tw}")
        if tw >= 1 and tw != int(tw):
            raise ValueError(
                f"train.tome_warmup must be an integer step count (>= 1) "
                f"or a fraction of total steps in (0, 1), got {tw}")
        self._tome_warmup_steps = (max(1, int(round(tw * self.total_steps)))
                                   if 0 < tw < 1 else int(tw))
        if not tw:
            return None
        if not self.cfg.model.tome_r:
            raise ValueError(
                "train.tome_warmup requires model.tome_r > 0 — it is the "
                "dense-warmup phase OF token-merged training (unset one)")
        dense_cfg = dataclasses.replace(
            self.cfg, model=dataclasses.replace(self.cfg.model, tome_r=0))
        return self._make_step_fn(dense_cfg)

    def _make_step_fn(self, cfg):
        """Train-step factory (subclass hook)."""
        return S.make_train_step(cfg, self.total_steps, mesh=self.mesh)

    def _inference_eval(self, placed):
        """The accelerated eval path, built from the CURRENT parameters:
        int8 (``eval_quantize``) and / or token merging (``eval_tome_r``).
        For 'static', the activation scales are calibrated once per
        parameter version (keyed on the step) on the first batch offered,
        so repeated evaluate() / predict() calls at one step reuse the same
        scales and int8 tree; a new optimizer step invalidates the
        cache."""
        quantize = self.cfg.train.eval_quantize
        # a token-merging model evaluates merged: the accelerated step
        # inherits its r (a mismatched r is refused at build)
        eval_r = self.cfg.train.eval_tome_r or self.cfg.model.tome_r
        key = (bool(quantize), eval_r)
        if getattr(self, "_inference_eval_key", None) != key:
            self._inference_eval_key = key
            self._inference_eval_step = S.make_inference_eval_step(
                self.cfg, quantized=bool(quantize), tome_r=eval_r)
        step = self._inference_eval_step
        sharded = self.state.params.layout is not None
        if not quantize and not sharded:
            return self.state.params, step
        ck = (int(self.state.step), quantize, eval_r)
        cached = getattr(self, "_qeval_cache", None)
        if cached is not None and cached[0] == ck:
            return cached[1], step
        # the serving forwards run the full tree: a sharded one is gathered
        # on every rank, and each runs its slot's rows on it
        params = fsdp.gather_params(self.state.params)
        if not quantize:
            self._qeval_cache = (ck, params)
            return params, step
        scales = None
        if quantize == "static":
            images = prepare_pixel_values(
                placed, out_size=self.cfg.model.img_size,
                mean=self.cfg.data.image_mean, std=self.cfg.data.image_std)
            if self._world > 1:
                # calibrate on the global batch, as one process would: scales
                # of each rank's slice would give the ranks other int8 trees
                images = torch.from_numpy(dist.process_allgather(
                    images, self._batch_axis)).to(self.device)
            scales = qmod.calibrate_vit_scales(params, images,
                                               self.cfg.model)
        qparams = qmod.quantize_vit_params(params, scales)
        self._qeval_cache = (ck, qparams)
        return qparams, step

    # ------------------------------------------------------------------
    # data plumbing
    # ------------------------------------------------------------------

    def _loader(self, index, augment: bool):
        if self._adapters:
            return index          # the adapter implements the protocol
        return pipe.SampleLoader(
            index, self.bundle.blob_map, self.bundle.store,
            img_size=self.cfg.model.img_size,
            placement=self.cfg.data.preprocess_placement,
            canvas_size=self.cfg.data.decode_canvas,
            augment=augment and self.cfg.data.augment,
            prefer_native_decode=True)

    def _train_batches(self, epoch: int, skip: int = 0
                       ) -> Iterator[Dict[str, np.ndarray]]:
        return pipe.iterate_batches(
            self._loader(self.bundle.train, augment=True),
            self.global_batch, epoch=epoch, shuffle=True,
            seed=self.cfg.data.shuffle_buffer_seed,
            num_workers=self.cfg.data.num_workers,
            prefetch_batches=self.cfg.data.prefetch_depth,
            drop_last=True,
            skip_batches=skip,   # resume skips before any fetch/decode
            # across processes each decodes only its slice
            host_range=dist.host_batch_slice(self.global_batch, self.mesh))

    # ------------------------------------------------------------------
    # train
    # ------------------------------------------------------------------

    def request_stop(self) -> None:
        """Ask the train loop to checkpoint and exit after the current step
        (the SIGTERM / SIGINT handler calls it; safe from any thread)."""
        self._stop_requested = True

    def _install_preemption_handler(self):
        """SIGTERM / SIGINT → one final checkpoint and a clean exit (only
        from the main thread); returns a restore callback."""
        if (not self.cfg.train.save_on_preemption
                or threading.current_thread() is not threading.main_thread()):
            return lambda: None
        previous = {}

        def on_signal(signum, frame):
            print(f"[trainer] signal {signum}: checkpointing before exit")
            self.request_stop()

        for sig in (signal.SIGTERM, signal.SIGINT):
            previous[sig] = signal.signal(sig, on_signal)

        def restore():
            for sig, handler in previous.items():
                signal.signal(sig, handler)

        return restore

    def train(self) -> Dict[str, float]:
        self._stop_requested = False
        restore_handlers = self._install_preemption_handler()
        try:
            return self._train_inner(self.cfg.train)
        finally:
            # on every exit: a crashed run must not leave SIGINT / SIGTERM
            # pointing at a dead trainer's stop flag
            restore_handlers()

    def _train_inner(self, cfg) -> Dict[str, float]:
        cursor = ckpt.DataCursor()
        if cfg.resume_from_checkpoint:
            step = (None if cfg.resume_from_checkpoint == "auto"
                    else int(cfg.resume_from_checkpoint))
            dist.barrier("checkpoint written")
            self.state, cursor, _ = self.ckpt.restore(step, self.state)
            # subclasses with richer cursors (the packed per-process image
            # counts) read the whole of it from here
            self._restored_cursor = cursor
            print(f"[trainer] resumed at step {int(self.state.step)} "
                  f"(epoch {cursor.epoch}, batch {cursor.batch_in_epoch})")

        if not self._has_full_batch():
            raise ValueError(
                f"train split ({len(self.bundle.train)} samples) yields zero "
                f"full batches at global batch {self.global_batch}; shrink "
                f"the batch size, or raise use_subset_data")

        t_start = time.perf_counter()
        step = int(self.state.step)
        start_step = step            # for this run's throughput
        epoch = cursor.epoch
        done = False
        while not done and step < self.total_steps:
            skip = cursor.batch_in_epoch if epoch == cursor.epoch else 0
            prefetch = pipe.DevicePrefetcher(
                self._train_batches(epoch, skip), self.device,
                depth=self.cfg.data.prefetch_depth)
            batch_idx = skip
            step_at_epoch_start = step
            # let up to 16 steps be in flight, then sync on a scalar: an
            # unbounded queue hides errors
            sync_every = max(1, min(16, cfg.logging_steps or 16))
            unmetered_steps = 0
            epoch_exhausted = True
            # every exit from the batch loop (epoch end, max_steps,
            # preemption, a raising step) must release the producer thread
            # and its staged batches
            try:
                for batch in prefetch:
                    self.profiler.maybe_start(step)
                    # dense-warmup dispatch (train.tome_warmup) on the
                    # absolute step, so a resume lands in the right phase
                    step_fn = (self._warmup_step
                               if self._warmup_step is not None
                               and step < self._tome_warmup_steps
                               else self._train_step)
                    self.state, metrics = step_fn(self.state, batch)
                    step += 1
                    batch_idx += 1
                    unmetered_steps += 1
                    if (step % sync_every == 0
                            or self.profiler.in_window(step)):
                        # a scalar fetch is the device completion barrier
                        loss_val = float(metrics["loss"])
                        if (cfg.nan_guard == "raise"
                                and not math.isfinite(loss_val)):
                            raise FloatingPointError(
                                f"non-finite loss ({loss_val}) at step "
                                f"{step}; training diverged — resume from "
                                f"the last checkpoint with a lower lr or "
                                f"stronger clipping "
                                f"(set train.nan_guard=off to disable)")
                        self._meter.step(
                            self._images_per_step * unmetered_steps)
                        unmetered_steps = 0
                    self.profiler.maybe_stop(step)

                    if cfg.logging_steps and step % cfg.logging_steps == 0:
                        ips = self._meter.images_per_sec
                        record = {
                            "loss": float(metrics["loss"]),
                            "grad_norm": float(metrics["grad_norm"]),
                            "lr": float(metrics["lr"]),
                            "epoch": epoch + self._epoch_progress(batch_idx),
                            "images_per_sec": ips,
                        }
                        if self._chip_peak is not None:
                            record["mfu"] = (ips / self._world
                                             * self._flops_per_image
                                             / self._chip_peak)
                        self.logger.log(step, record,
                                        progress=self._progress_text(step,
                                                                     ips))
                    if (cfg.eval_strategy == "steps" and cfg.eval_steps
                            and step % cfg.eval_steps == 0):
                        self._last_eval_metrics = self.evaluate()
                        self._last_eval_step = step
                        self.logger.log(step, self._last_eval_metrics,
                                        "eval")
                        self._maybe_floor_hint(step)
                        # don't bill the eval pause to the next window
                        self._meter.reset()
                    if (cfg.save_strategy == "steps" and cfg.save_steps
                            and step % cfg.save_steps == 0):
                        self._save(step, epoch, batch_idx)
                    if step >= self.total_steps:
                        done = True
                        epoch_exhausted = False
                        break
                    # saves gather across processes, so the stop is agreed
                    # on the sync cadence: a signal lands on the ranks at
                    # different steps, and every rank must stop at one
                    stop = self._stop_requested
                    if self._world > 1:
                        stop = (step % sync_every == 0
                                and dist.agree_flag(stop))
                    if stop:
                        # preemption: persist the exact cursor, so
                        # resume_from_checkpoint=auto continues mid-epoch
                        self._save(step, epoch, batch_idx)
                        print(f"[trainer] stop requested: checkpointed at "
                              f"step {step} (epoch {epoch}, "
                              f"batch {batch_idx})")
                        done = True
                        epoch_exhausted = False
                        break
            finally:
                prefetch.close()
            if epoch_exhausted:
                if step == step_at_epoch_start and skip == 0:
                    raise ValueError(
                        "an epoch produced zero training batches — batch "
                        "configuration cannot be satisfied by the dataset")
                epoch += 1
                if cfg.eval_strategy == "epoch":
                    self._last_eval_metrics = self.evaluate()
                    self._last_eval_step = step
                    self.logger.log(step, self._last_eval_metrics, "eval")
                    self._maybe_floor_hint(step)
                    self._meter.reset()
                if cfg.save_strategy == "epoch":
                    self._save(step, epoch, 0)
                if epoch >= cfg.num_epochs and cfg.max_steps is None:
                    done = True

        self.profiler.stop_if_active()
        self.ckpt.wait()
        dist.barrier("checkpoints written")

        if cfg.load_best_model_at_end and self.ckpt.all_steps():
            best = self.ckpt.best_step() or self.ckpt.latest_step()
            self.state, _, _ = self.ckpt.restore(best, self.state)
            print(f"[trainer] loaded best checkpoint (step {best})")

        elapsed = time.perf_counter() - t_start
        train_metrics = {
            "train_runtime": elapsed,
            "train_steps": step,
            # the rate over the steps THIS run trained
            "train_samples_per_second":
                (step - start_step) * self._images_per_step
                / max(elapsed, 1e-9),
        }
        self.logger.save_results("train", train_metrics)
        return train_metrics

    def save_metrics(self, split: str, metrics: Dict[str, float],
                     log: bool = False) -> None:
        """HF's ``save_metrics``: ``{split}_results.json``; with ``log``
        also the record in ``metrics.jsonl`` at the current step, under
        the prefix ``split``."""
        if log:
            self.logger.log(int(self.state.step), metrics, split)
        self.logger.save_results(split, metrics)

    def restore(self, step: Optional[int] = None) -> None:
        """Load the checkpoint at ``step`` (the latest for None) into the
        state, this rank's shards of it on a mesh."""
        self.state, _, _ = self.ckpt.restore(step, self.state)

    def _progress_text(self, step: int, images_per_sec: float) -> str:
        """``step/total (pct%, eta)`` on the logging cadence."""
        pct = 100.0 * step / max(self.total_steps, 1)
        remaining = max(self.total_steps - step, 0)
        if images_per_sec > 0:
            secs = remaining * self._images_per_step / images_per_sec
            eta = (f"{secs / 3600:.1f}h" if secs >= 3600 else
                   f"{secs / 60:.1f}m" if secs >= 60 else f"{secs:.0f}s")
        else:
            eta = "?"
        return f"{step}/{self.total_steps} ({pct:.1f}%, eta {eta})"

    def _epoch_progress(self, batch_idx: int) -> float:
        """Fraction of the current epoch consumed (subclass hook)."""
        return batch_idx / self.steps_per_epoch

    def _save(self, step: int, epoch: int, batch_idx: int) -> None:
        # only attach eval metrics measured at THIS step: best-checkpoint
        # selection must not rank weights by another step's metric
        metrics = (self._last_eval_metrics
                   if self._last_eval_step == step else None)
        self.ckpt.save(step, self.state,
                       cursor=ckpt.DataCursor(epoch, batch_idx),
                       metrics=metrics)

    # ------------------------------------------------------------------
    # eval / predict
    # ------------------------------------------------------------------

    def _forward_all(self, index) -> Tuple[np.ndarray, np.ndarray, float]:
        """Run the eval loop over a DatasetIndex; returns (logits, labels,
        mean BCE loss) with the padding sliced off."""
        loader = self._loader(index, augment=False)
        if len(index) == 0:
            c = self.cfg.model.num_classes
            print("[trainer] warning: evaluating an empty dataset")
            return (np.zeros((0, c), np.float32),
                    np.zeros((0, c), np.float32), 0.0)
        logits_all, labels_all = [], []
        total_elem_loss, total_n = 0.0, 0
        qparams = qstep = None
        for batch in pipe.iterate_batches(
                loader, self.eval_batch,
                num_workers=self.cfg.data.num_workers,
                prefetch_batches=self.cfg.data.prefetch_depth,
                pad_last=True,
                host_range=dist.host_batch_slice(self.eval_batch,
                                                 self.mesh)):
            n_valid = int(batch.pop("num_valid"))     # of the global batch
            placed = pipe.to_device(batch, self.device)
            if qstep is None and (self.cfg.train.eval_quantize
                                  or self.cfg.train.eval_tome_r):
                qparams, qstep = self._inference_eval(placed)
            logits, row_loss = (
                qstep(qparams, placed) if qstep is not None
                else self._eval_step(self.state.params, placed))
            # every rank gathers the global batch's rows, in slot order
            axis = self._batch_axis
            logits = dist.process_allgather(logits, axis)[:n_valid]
            row_loss = dist.process_allgather(row_loss, axis)[:n_valid]
            total_elem_loss += float(np.sum(row_loss))
            total_n += n_valid
            logits_all.append(logits)
            labels_all.append(
                dist.process_allgather(batch["labels"], axis)[:n_valid])
        c = max(self.cfg.model.num_classes, 1)
        return (np.concatenate(logits_all), np.concatenate(labels_all),
                total_elem_loss / max(total_n * c, 1))

    def evaluate(self, index=None) -> Dict[str, float]:
        """avg_auroc (+ per-class) and f1_micro over the val set."""
        index = index if index is not None else self.bundle.val
        logits, labels, loss = self._forward_all(index)
        out = M.compute_metrics(logits, labels, self.bundle.classes)
        out["eval_loss"] = loss
        return out

    def predict(self, index=None, report_path: Optional[str] = None,
                calibrate: bool = False
                ) -> Tuple[np.ndarray, np.ndarray, Dict[str, float]]:
        """The final test pass: predict on test, with the classification
        report written to ``report_path`` when given (by the primary
        rank).

        ``calibrate=True`` fits per-class decision thresholds on the
        VALIDATION split (max per-class F1) and applies them to the test
        report, where the reference uses a fixed 0.5. Calibration never
        reads the test labels."""
        index = index if index is not None else self.bundle.test
        logits, labels, loss = self._forward_all(index)
        metrics = M.compute_metrics(logits, labels, self.bundle.classes)
        metrics["test_loss"] = loss
        threshold: "float | np.ndarray" = 0.5
        if calibrate:
            val_logits, val_labels, _ = self._forward_all(self.bundle.val)
            threshold = M.calibrate_thresholds(val_logits, val_labels)
            metrics["f1_micro_calibrated"] = M.f1_micro_at(
                logits, labels, threshold)
        if report_path and dist.is_primary():
            text = M.write_classification_report(
                os.path.expanduser(report_path), logits,
                labels.astype(np.int64), self.bundle.classes, threshold)
            print(text)
        return logits, labels, metrics

    # ------------------------------------------------------------------

    def save_model(self, directory: Optional[str] = None) -> None:
        """Write the model directory (the primary rank only)."""
        directory = directory or os.path.join(
            os.path.expanduser(self.cfg.train.output_dir), "model")
        params = fsdp.gather_params(self.state.params)   # every rank
        if not dist.is_primary():
            return
        ckpt.save_model(directory, params, self.cfg.to_json(),
                        self.bundle.classes)
        # HF's Trainer(tokenizer=processor).save_model() also writes the
        # processor's config, so the directory loads with preprocessing
        write_preprocessor_config(directory, self.cfg.model.img_size,
                                  self.cfg.data.image_mean,
                                  self.cfg.data.image_std)
        print(f"[trainer] model saved to {directory}")

    def save_state(self, path: Optional[str] = None) -> str:
        """HF's ``trainer.save_state()``: write ``trainer_state.json`` —
        global step, epoch, best metric and checkpoint, and the log history
        replayed from metrics.jsonl — in HF's shape. The primary rank
        writes it; the others return the path."""
        out_dir = os.path.expanduser(self.cfg.train.output_dir)
        path = path or os.path.join(out_dir, "trainer_state.json")
        if not dist.is_primary():
            return path
        history = []
        jsonl = os.path.join(self.logger.output_dir, "metrics.jsonl")
        if os.path.exists(jsonl):
            with open(jsonl) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    prefix = rec.pop("prefix", "train")
                    step = rec.pop("step", 0)
                    if prefix == "eval":
                        rec = {f"eval_{k}" if not k.startswith("eval_")
                               else k: v for k, v in rec.items()}
                    history.append({"step": step, **rec})
        best_step = self.ckpt.best_step()
        # eval records carry HF-style eval_ prefixes in the history
        keys = (f"eval_{self.cfg.train.metric_for_best_model}",
                self.cfg.train.metric_for_best_model)
        best_metric = None
        if best_step is not None:
            for rec in reversed(history):
                if rec["step"] != best_step:
                    continue
                for k in keys:
                    if k in rec:
                        best_metric = rec[k]
                        break
                if best_metric is not None:
                    break
        state = {
            "global_step": int(self.state.step),
            "max_steps": self.total_steps,
            "num_train_epochs": self.cfg.train.num_epochs,
            "logging_steps": self.cfg.train.logging_steps,
            "eval_steps": self.cfg.train.eval_steps,
            "save_steps": self.cfg.train.save_steps,
            "best_metric": best_metric,
            "best_model_checkpoint": (
                os.path.join(self.ckpt.directory, str(best_step))
                if best_step is not None else None),
            "log_history": history,
        }
        with open(path, "w") as f:
            json.dump(state, f, indent=2)
        return path

    def close(self) -> None:
        self.ckpt.close()
        self.logger.close()

    # -- what a SpawnedTrainer reads and writes on its ranks ----------------

    def _view(self) -> Dict[str, Any]:
        """The attributes a :class:`SpawnedTrainer` reads in the caller."""
        return {"cfg": self.cfg, "global_batch": self.global_batch,
                "total_steps": self.total_steps,
                "steps_per_epoch": self.steps_per_epoch,
                "mesh": dataclasses.replace(self.mesh, groups={})}

    def _set_config(self, cfg: Config) -> None:
        """Take the caller's edits of ``cfg`` in place, as a one-process
        Trainer sees an edit of its ``cfg`` at its next call."""
        def assign(dst, src):
            for f in dataclasses.fields(src):
                value = getattr(src, f.name)
                if dataclasses.is_dataclass(value):
                    assign(getattr(dst, f.name), value)
                else:
                    setattr(dst, f.name, value)
        assign(self.cfg, cfg)

    def _host_state(self) -> Optional[S.TrainState]:
        """The full state on the host (a collective: every rank gathers;
        the primary's copy is returned)."""
        layout = self.state.params.layout
        params = fsdp.gather_params(self.state.params)
        moments = {k: fsdp.gather_named(layout, self.state.opt_state[k])
                   for k in ("mu", "nu")}
        if not dist.is_primary():
            return None
        generator = torch.Generator()
        generator.set_state(self.state.generator.get_state())
        return S.TrainState(
            step=int(self.state.step), params=copy.deepcopy(params).cpu(),
            opt_state={k: {n: t.detach().cpu() for n, t in m.items()}
                       for k, m in moments.items()},
            generator=generator)

    def _place_state(self, full: S.TrainState) -> None:
        """Take a full state from the host: this rank's shards of it, on
        its device."""
        params = fsdp.shard_params(full.params.to(self.device), self.mesh)
        self.state = S.TrainState(
            step=full.step, params=params,
            opt_state={k: {n: t.to(self.device) for n, t in fsdp.shard_named(
                params.layout, full.opt_state[k]).items()}
                for k in ("mu", "nu")},
            generator=full.generator)


class SpawnedTrainer:
    """A Trainer (``cls``, or a subclass) over several devices, driven from
    this process: one rank a device (``parallel/launch.Ranks``), each
    building ``cls(*args, device=<its device>, **kw)``, in one group over
    the mesh of ``cfg.mesh``. ``train``, ``evaluate``, ``predict``,
    ``save_model``, ``save_state``, ``save_metrics``, ``restore``,
    ``request_stop`` and ``close`` behave as a one-process Trainer's;
    ``cfg``, ``mesh``, ``global_batch``, ``total_steps`` and
    ``steps_per_epoch`` (and a PackedTrainer's ``seq_len``, ``grids`` and
    ``batch_seqs``) are rank 0's, and an edit of ``cfg`` here reaches the
    ranks before the next call. ``state`` is the full gathered
    ``TrainState`` on this host; assigning one gives every rank its shards.
    :meth:`call` runs a picklable function with each rank's trainer. While
    ``train`` runs, SIGTERM and SIGINT sent here are forwarded to the
    ranks, whose handlers agree the stop and checkpoint; ``train`` returns
    once the checkpoint is written."""

    def __init__(self, cls, devices, args: tuple, kw: dict):
        self.devices = list(devices)
        self.ranks = launch.Ranks(
            devices, cls, args, kw,
            what=f"{cls.__name__}(device=[{len(devices)} devices])")
        self.__dict__.update(self.ranks.call("_view"))
        self._cfg_sent = pickle.dumps(self.cfg)

    def call(self, fn: Callable, *args, **kw):
        """``fn(trainer, *args, **kw)`` on every rank (``fn`` picklable);
        rank 0's value."""
        blob = pickle.dumps(self.cfg)
        if blob != self._cfg_sent:
            self.ranks.call("_set_config", self.cfg)
            self._cfg_sent = blob
        return self.ranks.call(fn, *args, **kw)

    def train(self) -> Dict[str, float]:
        restore = (launch.forward_signals(self.ranks)
                   if self.cfg.train.save_on_preemption else lambda: None)
        try:
            return self.call("train")
        finally:
            restore()

    def evaluate(self, *args, **kw) -> Dict[str, float]:
        return self.call("evaluate", *args, **kw)

    def predict(self, *args, **kw):
        return self.call("predict", *args, **kw)

    def save_model(self, *args, **kw) -> None:
        return self.call("save_model", *args, **kw)

    def save_state(self, *args, **kw) -> str:
        return self.call("save_state", *args, **kw)

    def save_metrics(self, *args, **kw) -> None:
        return self.call("save_metrics", *args, **kw)

    def restore(self, *args, **kw) -> None:
        return self.call("restore", *args, **kw)

    def request_stop(self) -> None:
        """Ask every rank to checkpoint and stop (safe from any thread)."""
        self.ranks.notify("request_stop")

    @property
    def state(self) -> S.TrainState:
        return self.call("_host_state")

    @state.setter
    def state(self, full: S.TrainState) -> None:
        self.call("_place_state", full)

    def close(self) -> None:
        try:
            if self.ranks.alive:
                self.call("close")
        finally:
            self.ranks.close()
