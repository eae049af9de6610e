"""DCGAN generator and discriminator for 128x128 slices, NCHW (counterpart of
mvtb_tpu/models/dcgan.py; the reference's ``50_reconstruction/networks.py``).

G is six transposed convs, z (B, nz, 1, 1) -> (ngf*16, 4, 4) -> ... ->
(nc, 128, 128), with BatchNorm + ReLU and a Tanh head; D mirrors it with
stride-2 convs, LeakyReLU(0.2), BatchNorm after all but the first conv, and
raw logits (B, 1, 1, 1) out. No biases; weights N(0, 0.02), BatchNorm scale
N(1, 0.02) (``networks.py:8-14``). Submodules carry the flax names
(``ConvTranspose_0``, ``bn0``, ``Conv_0``, ...) for :mod:`.convert`.

:class:`BatchNorm` is written out to flax's rule, not ``nn.BatchNorm2d``:
training normalises with the batch statistics (``E[x^2] - E[x]^2``, the
biased variance) and updates the running averages as ``0.9 * old + 0.1 *
batch``, the variance biased too (``nn.BatchNorm2d`` keeps the unbiased
one: 1.6% off at D's last BatchNorm, 64 values a channel); eps 1e-5.
:func:`frozen_batch_stats` runs a training-mode forward that updates no
running average, as a flax ``apply`` whose mutated statistics are dropped.

flax ``ConvTranspose(4, s, padding)`` is ``conv_transpose2d`` with the
kernel flipped in space: ``VALID`` at stride 1 is padding 0, ``SAME`` at
stride 2 is padding 1. D's 4x4 stride-2 ``SAME`` convs pad (1, 1).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mvtb_tpu_torch._device import DeviceLike, resolve_device


class BatchNorm(nn.Module):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)`` over (B, H, W) of an
    NCHW tensor. ``weight``/``bias`` are flax's ``scale``/``bias``; the
    buffers ``running_mean``/``running_var`` its ``batch_stats``."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.update_stats = True
        # a data-parallel step sets this to the sum over the ranks that
        # share the batch, so the statistics are the global batch's
        self.batch_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
        w = torch.empty(features, device=device).normal_(0.0, 0.02, generator=generator)
        self.weight = nn.Parameter(1.0 + w)
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            axes = (0, 2, 3)
            if self.batch_sum is None:
                mean = x.mean(dim=axes)
                msq = (x * x).mean(dim=axes)
            else:
                count = x.new_full((x.shape[1],), float(x.numel() // x.shape[1]))
                s = self.batch_sum(torch.stack([x.sum(dim=axes), (x * x).sum(dim=axes),
                                                count]))
                mean, msq = s[0] / s[2], s[1] / s[2]
            var = torch.clamp(msq - mean * mean, min=0.0)
            if self.update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)


@contextlib.contextmanager
def frozen_batch_stats(*modules: nn.Module):
    """Training-mode forwards inside update no :class:`BatchNorm`'s running
    averages."""
    norms = [m for mod in modules for m in mod.modules() if isinstance(m, BatchNorm)]
    saved = [m.update_stats for m in norms]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m, s in zip(norms, saved):
            m.update_stats = s


class Conv(nn.Module):
    """A bias-free 4x4 conv (``transposed``: a transposed conv, weight
    (cin, cout, 4, 4), the flax kernel flipped in space; else weight
    (cout, cin, 4, 4)) with the given stride and symmetric padding, weights
    N(0, 0.02)."""

    def __init__(self, cin: int, cout: int, stride: int, padding: int,
                 transposed: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding, self.transposed = stride, padding, transposed
        shape = (cin, cout, 4, 4) if transposed else (cout, cin, 4, 4)
        self.weight = nn.Parameter(torch.empty(shape, device=device).normal_(
            0.0, 0.02, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = F.conv_transpose2d if self.transposed else F.conv2d
        return f(x, self.weight, stride=self.stride, padding=self.padding)


class Generator(nn.Module):
    """z (B, nz, 1, 1) -> image (B, nc, 128, 128) in [-1, 1]."""

    def __init__(self, nz: int = 100, ngf: int = 128, nc: int = 1,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        widths = [nz, ngf * 16, ngf * 8, ngf * 4, ngf * 2, ngf, nc]
        for i in range(6):
            # 4x4 VALID from 1x1 (padding 0), then 4x4 stride-2 SAME (padding 1)
            self.add_module(f"ConvTranspose_{i}", Conv(
                widths[i], widths[i + 1], 1 if i == 0 else 2, 0 if i == 0 else 1,
                transposed=True, device=dev, generator=generator))
            if i < 5:
                self.add_module(f"bn{i}", BatchNorm(widths[i + 1], device=dev,
                                                    generator=generator))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = z
        for i in range(5):  # 4, 8, 16, 32, 64
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"ConvTranspose_{i}")(x)))
        return torch.tanh(self.ConvTranspose_5(x))  # 128


class Discriminator(nn.Module):
    """image (B, nc, 128, 128) -> logits (B, 1, 1, 1)."""

    def __init__(self, nc: int = 1, ndf: int = 128, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        widths = [nc, ndf, ndf * 2, ndf * 4, ndf * 8, ndf * 16, 1]
        for i in range(6):
            # 4x4 stride-2 SAME (padding (1, 1)), the last 4x4 VALID
            self.add_module(f"Conv_{i}", Conv(
                widths[i], widths[i + 1], 1 if i == 5 else 2, 0 if i == 5 else 1,
                device=dev, generator=generator))
            if 1 <= i <= 4:
                self.add_module(f"bn{i - 1}", BatchNorm(widths[i + 1], device=dev,
                                                        generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.Conv_0(x), 0.2)  # 64
        for i in range(1, 5):  # 32, 16, 8, 4
            x = F.leaky_relu(getattr(self, f"bn{i - 1}")(getattr(self, f"Conv_{i}")(x)), 0.2)
        return self.Conv_5(x)  # 1x1 logits
