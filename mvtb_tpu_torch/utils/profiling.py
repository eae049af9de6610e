"""Profiling and step timing (counterpart of mvtb_tpu/utils/profiling.py).

``trace`` wraps ``torch.profiler`` around a block and writes a Chrome trace;
``StepTimer`` records per-step wall times, the warm-up steps excluded from
the summary, and synchronizes the card before each clock read so a step's
time covers its device work (PyTorch returns before the card finishes).

``span`` marks a layer of the port in that trace: while a profiler runs, a
``record_function`` range on the profiler's own clock, so each kernel, copy
and fill the trace records lies inside the spans of the host code that
issued it; otherwise one shared no-op. ``counters`` counts work where it
happens (``count``), and ``to_device`` / ``to_host`` move a tensor and
count the bytes that cross between host and card, and those of them that
cross from or into page-locked host memory. Counters are cumulative over
the process: readers take ratios of two of them. Neither reads a device
value, synchronizes, or changes a result.

Spans (parents by nesting on the calling thread): ``mvtb.chunk`` >
``mvtb.step`` > ``mvtb.step.stylize``, ``mvtb.step.optimizer``;
``mvtb.stylize_batch`` > ``mvtb.stylize.h_dft``; ``mvtb.eval.volume`` (one
batch of the harness, the request) > ``mvtb.loader.to_host``,
``mvtb.eval.to_device``, ``mvtb.sw`` > ``mvtb.sw.grid``,
``mvtb.sw.forward``, ``mvtb.sw.blend``; ``mvtb.eval.dice``; in a
SwinUNETR forward (``models/swin_unetr.py``) ``mvtb.swin.encoder`` >
``mvtb.swin.window``, ``mvtb.swin.attn``, and ``mvtb.unetr.conv``; in a
SegMamba forward (``models/segmamba.py``) ``mvtb.mamba.encoder`` >
``mvtb.mamba.gsc``, ``mvtb.mamba.layout``, ``mvtb.mamba.scan``, and
``mvtb.unetr.conv``. Counters:
``copy.h2d_bytes``, ``copy.d2h_bytes``, ``copy.h2d_pinned_bytes``,
``copy.d2h_pinned_bytes`` (the part of each from or into page-locked
memory), ``eval.volumes`` (rows the harness evaluated), ``sw.tiles``
(sliding-window tiles needed), ``sw.tile_slots`` (tile slots forwarded,
padding included), SwinUNETR's ``swin.tokens`` (real tokens entering a
block), ``swin.window_tokens`` (padded tokens it attends) and
``swin.windows``, SegMamba's ``mamba.tokens`` (tokens entering a Mamba
layer), ``mamba.scans`` (scan calls) and ``mamba.scan_positions`` (batch
times length over the scan calls), the UNet's convolution calls
(``models/unet3d.py``):
``unet.convs`` (all, transposed ones included) and ``unet.convs_ndhwc``
(those on a channels-last input), and the hand-written kernels' launches
on the card,
counted inside each custom op's CUDA implementation (``ops/_ops.py``):
``launch.fused_plane``, ``launch.sap``, ``launch.polar``,
``launch.axis_dft.<body>`` and, by route and tier,
``launch.axis_dft.<body>.<route>.<precision>``, ``launch.selective_scan.fwd``
and ``launch.selective_scan.bwd``.
"""

from __future__ import annotations

import collections
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


_NO_SPAN = contextlib.nullcontext()

counters: collections.Counter = collections.Counter()


def span(name: str):
    """A context naming a layer of the port: ``record_function(name)``
    while a ``torch.profiler`` session records and no compile or export
    trace runs (an exported graph holds no profiler op), else one shared
    no-op context, whose cost is the enabled check alone."""
    if torch.autograd._profiler_enabled() and not torch.compiler.is_compiling():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process's counter ``name``."""
    counters[name] += n


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t.to(device)``, its bytes counted in ``copy.h2d_bytes`` when the
    move takes a host tensor to the card (sizes only; nothing is read), and
    in ``copy.h2d_pinned_bytes`` too when that tensor is page-locked."""
    out = t.to(device)
    if t.device.type == "cpu" and out.device.type == "cuda":
        n = t.numel() * t.element_size()
        counters["copy.h2d_bytes"] += n
        if t.is_pinned():
            counters["copy.h2d_pinned_bytes"] += n
    return out


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``. From the card: one blocking copy into
    page-locked memory, which the bus moves at its full rate both ways (a
    later ``to_device`` of the copy too), its bytes counted in
    ``copy.d2h_bytes`` and ``copy.d2h_pinned_bytes``. PyTorch's caching
    host allocator serves the buffer, so once a copy is dropped its block
    serves the next. Any other tensor: ``t.cpu()`` (a host tensor as it is),
    nothing counted."""
    if t.device.type != "cuda":
        return t.cpu()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    n = host.numel() * host.element_size()
    counters["copy.d2h_bytes"] += n
    counters["copy.d2h_pinned_bytes"] += n
    return host


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
