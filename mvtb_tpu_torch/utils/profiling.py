"""Profiling and step timing (counterpart of mvtb_tpu/utils/profiling.py).

``trace`` wraps ``torch.profiler`` around a block and writes a Chrome trace;
``StepTimer`` records per-step wall times, the warm-up steps excluded from
the summary, and synchronizes the card before each clock read so a step's
time covers its device work (PyTorch returns before the card finishes).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch

from mvtb_tpu_torch._device import DeviceLike, resolve_device


@contextlib.contextmanager
def trace(logdir: str, device: DeviceLike = None):
    """Profile the block with ``torch.profiler`` (the host, and the card
    when ``device`` is CUDA; None means the card) and write its Chrome trace
    to ``logdir/trace.json`` (open it in Perfetto or ``chrome://tracing``)."""
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Wall-clock step timing with warm-up (first-use) exclusion. On a CUDA
    ``device`` (None means the card) the card is synchronized before each
    clock read."""

    def __init__(self, warmup: int = 1, device: DeviceLike = None):
        self.warmup = warmup
        self.device = resolve_device(device)
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.times.append(time.perf_counter() - self._t0)

    def summary(self, items_per_step: float = 1.0) -> Dict[str, float]:
        steady = self.times[self.warmup:] or self.times
        mean = sum(steady) / len(steady)
        return {
            "steps": len(self.times),
            "mean_s": mean,
            "min_s": min(steady),
            "items_per_sec": items_per_step / mean,
            "compile_s": self.times[0] - mean if len(self.times) > self.warmup else 0.0,
        }
