"""Profiler hooks of the port (``chestxray_vit_tpu/utils/profiling.py``
over ``torch.profiler``): a trace over the configured step window
``train.profile_steps``, written as a Chrome trace that Perfetto or
``chrome://tracing`` opens."""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch


class StepProfiler:
    """Captures a ``torch.profiler`` trace (host and, with a card, device
    activity) over steps ``profile_steps = (start, stop)`` and writes it to
    ``<output_dir>/profile/trace_<start>_<stop>.json``."""

    def __init__(self, output_dir: str,
                 profile_steps: Optional[Tuple[int, int]] = None):
        self.trace_dir = os.path.join(
            os.path.abspath(os.path.expanduser(output_dir)), "profile")
        self.window = tuple(profile_steps) if profile_steps else None
        self._prof: Optional[torch.profiler.profile] = None

    def in_window(self, step: int) -> bool:
        """True while a trace is (or should be) capturing this step."""
        return bool(self.window
                    and self.window[0] <= step <= self.window[1])

    def maybe_start(self, step: int) -> None:
        if self.window and self._prof is None and step == self.window[0]:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()

    def maybe_stop(self, step: int) -> None:
        if self._prof is not None and (self.window is None
                                       or step >= self.window[1]):
            path = self._stop()
            print(f"[profiling] trace written to {path}")

    def stop_if_active(self) -> None:
        if self._prof is not None:
            self._stop()

    def _stop(self) -> str:
        self._prof.stop()
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(self.trace_dir, "trace_{}_{}.json".format(
            *self.window))
        self._prof.export_chrome_trace(path)
        self._prof = None
        return path
