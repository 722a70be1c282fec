"""Asynchronous checkpoints with retention and best-model tracking, and the
final model export, ported from ``chestxray_vit_tpu/train/checkpoint.py``.

One logical checkpoint holds the whole train state, so resume is exact:
the step, the f32 parameters, the AdamW moments, the state's
``torch.Generator`` state and the data cursor. The JAX package writes it
with orbax (which imports JAX); the port writes its own format with the
same layout of one directory per step::

    <directory>/<step>/state.pt    torch.save of plain tensors: "step",
                                   "params", "mu", "nu" ({name: tensor}),
                                   "generator" (uint8 state)
    <directory>/<step>/meta.json   {"cursor", "extra", "metrics"}

read back with ``torch.load(weights_only=True)``. A local save is written
into ``<directory>/.<step>.tmp`` and renamed into place, so a step
directory exists only whole.

A ``gs://bucket/prefix`` directory keeps the same layout as objects
(``data/storage.GCSStore``; ``google.cloud.storage`` is imported when such
a manager is built, and its absence raises ``ImportError`` there). The
writer thread serialises the state into memory and uploads
``state.pt``, then ``meta.json``: the meta object is the commit, so a step
without it is not listed, and the primary deletes its objects when the
manager is built. Retention deletes a step's objects by prefix.

Saves are asynchronous: ``save`` copies the tensors (on their device, so
the next train step may change the live ones) and hands them to a writer
thread; ``wait`` is the barrier, and it raises what the writer raised.
Retention follows the JAX manager's explicit policy: with
``metric_for_best`` it keeps the latest save plus the
``save_total_limit`` best among the saves that carry metrics (a save
whose metrics lack the key ranks worst; NaN values are dropped, so a NaN
metric counts as missing; with no more saves than the limit every save is
kept, as orbax's ``BestN`` keeps them); without it, the latest
``save_total_limit`` saves.

Across processes (data parallelism) every rank keeps the index, so every
rank ranks the saves alike, but only the primary (``primary=True``)
copies and writes the state; the others record the save's step and
metrics. The trainer passes a barrier after ``wait`` and before a
restore, so the files the others read are whole.

The final model (``save_model`` / ``load_model``) lives in a local
directory; a ``gs://`` one is refused (:func:`local_dir`).
"""

from __future__ import annotations

import dataclasses
import io
import json
import math
import os
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from chestxray_vit_tpu_torch.data.storage import GCSStore
from chestxray_vit_tpu_torch.models import vit
from chestxray_vit_tpu_torch.train.steps import TrainState

STATE_FILE = "state.pt"
META_FILE = "meta.json"
PARAMS_FILE = "params.pt"


def local_dir(directory: str, what: str = "model directory") -> str:
    """The absolute local path of ``directory``; a URI (``gs://…``) raises
    ``ValueError``. Only checkpoints go to a bucket: the logs and the
    saved model are written with local file calls, which would turn
    ``gs://b/m`` into a directory named ``gs:`` under the working
    directory (what the JAX package's ``os.path.abspath`` does)."""
    if "://" in directory:
        raise ValueError(
            f"{what} {directory!r} is a URI; it must be a local path: the "
            f"port writes it with local file calls, which would create a "
            f"directory named 'gs:' under the working directory (only "
            f"CheckpointManager writes to gs://)")
    return os.path.abspath(os.path.expanduser(directory))


class _LocalSteps:
    """Step directories on a local filesystem (``.<step>.tmp`` renamed
    into place)."""

    def __init__(self, directory: str):
        self.directory = local_dir(directory, "checkpoint directory")
        os.makedirs(self.directory, exist_ok=True)

    def committed(self, primary: bool) -> Dict[int, Optional[Dict]]:
        out = {}
        for name in os.listdir(self.directory):
            meta = os.path.join(self.directory, name, META_FILE)
            if name.isdigit() and os.path.exists(meta):
                with open(meta) as f:
                    out[int(name)] = json.load(f).get("metrics")
        return out

    def write(self, step: int, host: Dict[str, Any],
              meta: Dict[str, Any]) -> int:
        tmp = os.path.join(self.directory, f".{step}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(host, os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, META_FILE), "w") as f:
            json.dump(meta, f)
        final = os.path.join(self.directory, str(step))
        os.replace(tmp, final)
        return os.path.getsize(os.path.join(final, STATE_FILE))

    def read(self, step: int) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        path = os.path.join(self.directory, str(step))
        saved = torch.load(os.path.join(path, STATE_FILE),
                           map_location="cpu", weights_only=True)
        with open(os.path.join(path, META_FILE)) as f:
            return saved, json.load(f)

    def delete(self, step: int) -> None:
        shutil.rmtree(os.path.join(self.directory, str(step)))


class _GCSSteps:
    """Step directories as objects under ``gs://<bucket>/<prefix>``;
    ``meta.json``, written last, commits a step."""

    def __init__(self, directory: str):
        bucket, _, prefix = directory[len("gs://"):].partition("/")
        if not bucket:
            raise ValueError(f"checkpoint directory {directory!r}: no "
                             f"bucket")
        self.directory = directory.rstrip("/")
        self._prefix = prefix.strip("/")
        self._store = GCSStore(bucket)

    def _name(self, step, leaf: str = "") -> str:
        return "/".join(p for p in (self._prefix, str(step), leaf) if p)

    def committed(self, primary: bool) -> Dict[int, Optional[Dict]]:
        root = self._name("") + "/" if self._prefix else ""
        leaves: Dict[str, List[str]] = {}
        for name in self._store.list(root):
            step, _, leaf = name[len(root):].partition("/")
            if step.isdigit() and leaf:
                leaves.setdefault(step, []).append(leaf)
        out = {}
        for step, names in leaves.items():
            if META_FILE in names:
                meta = json.loads(self._store.get(
                    self._name(step, META_FILE)))
                out[int(step)] = meta.get("metrics")
            elif primary:           # a write that never committed
                self.delete(int(step))
        return out

    def write(self, step: int, host: Dict[str, Any],
              meta: Dict[str, Any]) -> int:
        buf = io.BytesIO()
        torch.save(host, buf)
        data = buf.getvalue()
        self._store.put(self._name(step, STATE_FILE), data)
        self._store.put(self._name(step, META_FILE),
                        json.dumps(meta).encode())
        return len(data)

    def read(self, step: int) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        saved = torch.load(io.BytesIO(self._store.get(
            self._name(step, STATE_FILE))), map_location="cpu",
            weights_only=True)
        return saved, json.loads(self._store.get(
            self._name(step, META_FILE)))

    def delete(self, step: int) -> None:
        for name in self._store.list(self._name(step) + "/"):
            self._store.delete(name)


@dataclass
class DataCursor:
    """Where the input pipeline stands; part of the checkpoint so resume
    continues mid-epoch instead of replaying data.

    ``per_host``: the packed multi-process trainer's per-process consumed
    image counts (None for dense training, where the batch index is the
    same everywhere)."""
    epoch: int = 0
    batch_in_epoch: int = 0
    per_host: Optional[list] = None

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        if self.per_host is None:
            del d["per_host"]
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "DataCursor":
        return DataCursor(**d)


class CheckpointManager:
    """Async save, retention, best-metric tracking over one directory.

    ``metric_for_best`` + ``greater_is_better`` give HF's
    ``load_best_model_at_end`` semantics: :meth:`best_step` answers which
    save to restore at the end. Saves already in the directory (a resumed
    run's) are indexed at construction. ``primary=False`` indexes saves
    without writing them (another process writes)."""

    def __init__(self, directory: str, save_total_limit: int = 2,
                 metric_for_best: Optional[str] = "avg_auroc",
                 greater_is_better: bool = True, primary: bool = True):
        self._steps = (_GCSSteps(directory) if directory.startswith("gs://")
                       else _LocalSteps(directory))
        self.directory = self._steps.directory
        self.primary = primary
        self.save_total_limit = save_total_limit
        self.metric_for_best = metric_for_best
        self.greater_is_better = greater_is_better
        self._lock = threading.Lock()
        # step → metrics dict (None without metrics), of the finished saves
        self._index: Dict[int, Optional[Dict[str, float]]] = \
            self._steps.committed(primary)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_save: Dict[str, float] = {}

    # -- ranking ------------------------------------------------------------

    def _metric(self, metrics: Dict[str, float]) -> float:
        sentinel = float("-inf") if self.greater_is_better else float("inf")
        return float(metrics.get(self.metric_for_best, sentinel))

    def _by_metric(self, steps: List[int]) -> List[int]:
        """The steps with metrics, worst first (a stable sort over
        ascending steps: of equal metrics the later save ranks better)."""
        with_metrics = [s for s in steps if self._index[s] is not None]
        return sorted(with_metrics,
                      key=lambda s: self._metric(self._index[s]),
                      reverse=not self.greater_is_better)

    def _to_remove(self) -> List[int]:
        """The saves retention drops (a limit ≤ 0 keeps every save)."""
        steps = sorted(self._index)
        n = self.save_total_limit
        if n <= 0 or len(steps) <= n:
            return []
        if not self.metric_for_best:
            return steps[:-n]
        keep = {steps[-1], *self._by_metric(steps)[-n:]}
        return [s for s in steps if s not in keep]

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: TrainState,
             cursor: Optional[DataCursor] = None,
             metrics: Optional[Dict[str, float]] = None,
             extra: Optional[Dict[str, Any]] = None) -> None:
        """Async save; returns once the tensors are copied (the write
        barrier is :meth:`wait`). A step already saved raises, as the JAX
        manager does."""
        self.wait()
        if step in self._index:
            raise ValueError(f"checkpoint for step {step} already exists "
                             f"in {self.directory}")
        clean = {k: float(v) for k, v in (metrics or {}).items()
                 if math.isfinite(float(v))}
        meta = {"cursor": (cursor or DataCursor()).to_dict(),
                "extra": extra or {}, "metrics": clean or None}
        if not self.primary:
            with self._lock:
                self._index[step] = meta["metrics"]
                for s in self._to_remove():
                    del self._index[s]
            return
        with torch.no_grad():
            snapshot = {
                "step": int(state.step),
                "params": {n: p.detach().clone()
                           for n, p in state.params.named_parameters()},
                "mu": {n: t.clone() for n, t in state.opt_state["mu"].items()},
                "nu": {n: t.clone() for n, t in state.opt_state["nu"].items()},
                "generator": state.generator.get_state(),
            }
        copied = None
        if snapshot["mu"] and next(iter(snapshot["mu"].values())).is_cuda:
            copied = torch.cuda.Event()
            copied.record()
        self._writer = threading.Thread(
            target=self._write, args=(step, snapshot, meta, copied),
            daemon=True)
        self._writer.start()

    def _write(self, step: int, snapshot: Dict[str, Any],
               meta: Dict[str, Any], copied) -> None:
        try:
            t0 = time.perf_counter()
            if copied is not None:          # the clones, on the saver's
                copied.synchronize()        # stream, are done
            host = {k: ({n: t.cpu() for n, t in v.items()}
                        if isinstance(v, dict) else v)
                    for k, v in snapshot.items()}
            nbytes = self._steps.write(step, host, meta)
            with self._lock:
                self._index[step] = meta["metrics"]
                removed = self._to_remove()
                for s in removed:
                    del self._index[s]
            for s in removed:
                self._steps.delete(s)
            self.last_save = {"step": step, "bytes": nbytes,
                              "seconds": time.perf_counter() - t0}
        except BaseException as e:          # noqa: BLE001 — raised by wait()
            self._error = e

    def wait(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore ------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        with self._lock:
            return max(self._index) if self._index else None

    def best_step(self) -> Optional[int]:
        """The best save by ``metric_for_best`` (the latest without one);
        None when no save carries metrics."""
        if not self.metric_for_best:
            return self.latest_step()
        with self._lock:
            ranked = self._by_metric(sorted(self._index))
        return ranked[-1] if ranked else None

    def all_steps(self) -> List[int]:
        with self._lock:
            return sorted(self._index)

    def restore(self, step: Optional[int], template: TrainState
                ) -> Tuple[TrainState, DataCursor, Dict[str, Any]]:
        """Restore into ``template``: its parameters are overwritten in
        place, its moments and generator state replaced. ``step=None`` →
        latest."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        if step not in self._index:
            raise FileNotFoundError(f"no checkpoint at step {step} under "
                                    f"{self.directory}")
        saved, meta = self._steps.read(step)
        params = template.params
        _load_params(params, saved["params"])
        opt_state = {key: {n: saved[key][n].to(p.device)
                           for n, p in params.named_parameters()}
                     for key in ("mu", "nu")}
        generator = template.generator
        generator.set_state(saved["generator"])
        state = TrainState(step=int(saved["step"]), params=params,
                           opt_state=opt_state, generator=generator)
        return (state, DataCursor.from_dict(meta.get("cursor", {})),
                meta.get("extra", {}))

    def close(self) -> None:
        self.wait()


def _load_params(params: vit.ViT, named: Dict[str, torch.Tensor]) -> None:
    """Copy saved tensors into ``params`` in place; a missing, extra or
    misshapen leaf raises."""
    own = dict(params.named_parameters())
    if set(own) != set(named):
        missing, extra = set(own) - set(named), set(named) - set(own)
        raise ValueError(f"saved parameters differ: missing "
                         f"{sorted(missing)[:3]}, extra {sorted(extra)[:3]}")
    with torch.no_grad():
        for n, p in own.items():
            if tuple(named[n].shape) != tuple(p.shape):
                raise ValueError(f"{n}: saved shape {tuple(named[n].shape)} "
                                 f"!= {tuple(p.shape)}")
            p.copy_(named[n])


# ---------------------------------------------------------------------------
# Final model export (HF Trainer's save_model)
# ---------------------------------------------------------------------------

def save_model(directory: str, params: vit.ViT, config_json: str,
               classes: Optional[list] = None) -> None:
    """Write the final inference weights (``params.pt``: the f32 tensors by
    parameter name, on the CPU), ``config.json`` and ``classes.json``."""
    directory = local_dir(directory)
    os.makedirs(directory, exist_ok=True)
    torch.save({n: p.detach().cpu() for n, p in params.named_parameters()},
               os.path.join(directory, PARAMS_FILE))
    with open(os.path.join(directory, "config.json"), "w") as f:
        f.write(config_json)
    if classes is not None:
        with open(os.path.join(directory, "classes.json"), "w") as f:
            json.dump(list(classes), f)


def load_model(directory: str, params_template: vit.ViT):
    """Load ``save_model``'s weights into ``params_template`` (in place);
    returns (params, classes or None)."""
    directory = local_dir(directory)
    path = os.path.join(directory, PARAMS_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} missing: not a model directory written by the port's "
            f"save_model (a JAX package model directory holds orbax "
            f"params/, which the port does not read)")
    _load_params(params_template,
                 torch.load(path, map_location="cpu", weights_only=True))
    classes = None
    cpath = os.path.join(directory, "classes.json")
    if os.path.exists(cpath):
        with open(cpath) as f:
            classes = json.load(f)
    return params_template, classes
