"""Observability of the port, a copy of ``chestxray_vit_tpu/utils/logging.py``:
metric logging (stdout, metrics.jsonl, TensorBoard event files),
throughput metering, and the train/eval results files
(``{split}_results.json``, HF's ``save_metrics``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricLogger:
    """Fan-out scalar logger: stdout lines, metrics.jsonl, and TensorBoard
    event files when ``report_to='tensorboard'``."""

    def __init__(self, output_dir: str, report_to: str = "tensorboard",
                 jsonl_name: str = "metrics.jsonl"):
        self.output_dir = os.path.abspath(os.path.expanduser(output_dir))
        os.makedirs(self.output_dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.output_dir, jsonl_name), "a")
        self._tb = None
        if report_to == "tensorboard":
            # the port's own tfevents writer (utils/tfevents.py), no
            # tensorboard package needed
            from chestxray_vit_tpu_torch.utils.tfevents import EventWriter
            self._tb = EventWriter(os.path.join(self.output_dir, "tb"))

    def log(self, step: int, metrics: Dict[str, float],
            prefix: str = "train", progress: Optional[str] = None) -> None:
        """``progress`` is a human-readable 'step/total (pct, eta)' string
        shown on the stdout line only (not a scalar — kept out of
        jsonl/TensorBoard)."""
        clean = {k: float(v) for k, v in metrics.items()}
        line = " ".join(f"{k}={v:.6g}" for k, v in clean.items())
        head = f"step {progress}" if progress else f"step {step}"
        print(f"[{prefix} {head}] {line}", flush=True)
        self._jsonl.write(json.dumps(
            {"step": step, "prefix": prefix, **clean}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in clean.items():
                self._tb.add_scalar(f"{prefix}/{k}", v, step)

    def save_results(self, split: str, metrics: Dict[str, float]) -> str:
        """HF's ``save_metrics``: {split}_results.json."""
        path = os.path.join(self.output_dir, f"{split}_results.json")
        with open(path, "w") as f:
            json.dump({k: float(v) for k, v in metrics.items()}, f, indent=2)
        return path

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class ThroughputMeter:
    """images/sec over a sliding window of synced steps."""

    def __init__(self, window: int = 50):
        self.window = window
        self._t0: Optional[float] = None
        self._images = 0
        self._rate = 0.0

    def step(self, batch_images: int) -> None:
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
            return
        self._images += batch_images
        elapsed = now - self._t0
        if self._images >= self.window * batch_images or elapsed > 10.0:
            self._rate = self._images / elapsed
            self._t0 = now
            self._images = 0

    def reset(self) -> None:
        """Restart the current window (call after eval/checkpoint pauses so
        the stall isn't billed to the next window's rate); the last
        completed rate stays readable."""
        self._t0 = None
        self._images = 0

    @property
    def images_per_sec(self) -> float:
        return self._rate
