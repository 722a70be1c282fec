"""Cross-request micro-batching for serving, a copy of
``chestxray_vit_tpu/serve/batcher.py``.

Concurrent requests coalesce into shared forwards: one worker drains the
queue up to ``predictor.batch_size`` items, waiting at most ``max_wait_ms``
after the first arrival, and resolves per-request futures from one device
call. Requests with and without attention maps group separately.

The two halves of a micro-batch run as a two-stage pipeline: a *stager*
thread does the host work (decode, crop/pad/resize, tail padding, the
host→device copy: ``Predictor.stage_chunk``) and a *device* thread runs the
forward and resolves futures (``Predictor.forward_staged``), so staging of
group N+1 overlaps the forward of group N. A bounded hand-off queue (depth
2, so at most three staged groups hold device memory: two queued, one being
forwarded) keeps latency and memory bounded. ``pipeline=False`` (or env
``CXR_SERVE_PIPELINE=0``) runs both halves on the stager thread.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class _Request:
    data: bytes
    with_maps: bool
    future: "Future"


@dataclass
class BatchedResult:
    logits: np.ndarray                     # [C]
    probs: np.ndarray                      # [C]
    attn_map: Optional[np.ndarray] = None  # [g, g] when requested


class MicroBatcher:
    def __init__(self, predictor, max_wait_ms: float = 5.0,
                 pipeline: Optional[bool] = None):
        self.predictor = predictor
        self.max_wait = max_wait_ms / 1000.0
        if pipeline is None:
            pipeline = os.environ.get("CXR_SERVE_PIPELINE", "1") != "0"
        self.pipeline = bool(pipeline)
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._lock = threading.Lock()
        # bounded hand-off: two queued groups plus the one the device
        # thread holds; backpressure onto the stager
        self._devq: "queue.Queue" = queue.Queue(maxsize=2)
        self._dev_thread: Optional[threading.Thread] = None
        if self.pipeline:
            self._dev_thread = threading.Thread(target=self._run_device,
                                                daemon=True)
            self._dev_thread.start()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------

    def submit(self, data: bytes, with_maps: bool = False) -> "Future":
        """Enqueue one image; the Future resolves to a BatchedResult."""
        fut: "Future" = Future()
        # the lock orders every accepted request before close()'s shutdown
        # sentinel, so no request lands after it and hangs
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._q.put(_Request(data, with_maps, fut))
        return fut

    def predict(self, data: bytes, with_maps: bool = False) -> BatchedResult:
        """Blocking convenience wrapper."""
        return self.submit(data, with_maps).result()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._thread.join(timeout=5)
        if self._dev_thread is not None:
            if self._thread.is_alive():
                # the stager is stuck (it forwards the sentinel on a clean
                # exit): post one directly so the device thread can stop
                try:
                    self._devq.put_nowait(None)
                except queue.Full:
                    pass
            self._dev_thread.join(timeout=5)
        # fail anything still queued (e.g. a worker died)
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item.future.set_exception(RuntimeError("batcher is closed"))
        while True:
            try:
                item = self._devq.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                for r in item[0]:
                    r.future.set_exception(RuntimeError("batcher is closed"))

    # ------------------------------------------------------------------

    def _collect(self, first: _Request) -> List[_Request]:
        group = [first]
        deadline = time.monotonic() + self.max_wait
        while len(group) < self.predictor.batch_size:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if item is None:
                self._q.put(None)          # re-post the shutdown sentinel
                break
            group.append(item)
        return group

    def _resolve(self, sub: List[_Request], flag: bool, staged) -> None:
        """Device half for one homogeneous group: forward + futures."""
        try:
            out = self.predictor.forward_staged(staged, len(sub),
                                                with_maps=flag)
            maps = getattr(out, "maps", None) if flag else None
            for i, r in enumerate(sub):
                r.future.set_result(BatchedResult(
                    logits=out.logits[i], probs=out.probs[i],
                    attn_map=maps[i] if maps is not None else None))
        except Exception as e:                  # noqa: BLE001
            for r in sub:
                r.future.set_exception(e)

    def _put_dev(self, item) -> bool:
        """Backpressured hand-off that cannot deadlock shutdown: poll with
        a short timeout and give up once close() has been signalled (the
        caller then fails the futures), so a wedged forward cannot leave
        the stager blocked in a put forever."""
        while True:
            try:
                self._devq.put(item, timeout=0.1)
                return True
            except queue.Full:
                if self._closed:
                    return False

    def _run(self) -> None:
        """Stager: collect a group, run the host half, hand the staged
        operands to the device thread (or run inline when pipeline=off)."""
        while True:
            item = self._q.get()
            if item is None:
                if self._dev_thread is not None:
                    self._put_dev(None)    # propagate shutdown downstream
                return
            group = self._collect(item)
            for flag in (False, True):
                sub = [r for r in group if r.with_maps == flag]
                if not sub:
                    continue
                try:
                    staged = self.predictor.stage_chunk(
                        [r.data for r in sub])
                except Exception as e:              # noqa: BLE001
                    for r in sub:
                        r.future.set_exception(e)
                    continue
                if self._dev_thread is not None:
                    if not self._put_dev((sub, flag, staged)):
                        for r in sub:
                            r.future.set_exception(
                                RuntimeError("batcher is closed"))
                else:
                    self._resolve(sub, flag, staged)

    def _run_device(self) -> None:
        while True:
            item = self._devq.get()
            if item is None:
                return
            sub, flag, staged = item
            self._resolve(sub, flag, staged)
