"""ReconGAN networks, NCHW (counterpart of mvtb_tpu/models/resunet_gan.py;
the reference's ``50_reconstruction/reconGan/networks.py``): residual
autoencoder G and encoder D.

``ResidualBlock`` is three Conv-InstanceNorm-PReLU stages nf -> nf/2 -> nf
with an additive skip; ``ResidualEncoder`` goes in at stride 2,
``ResidualDecoder`` out through a stride-2 transposed conv;
``ResUnetGenerator`` is 4 down / 4 up with additive skips, a Tanh head and
an optional global residual ``+ x``; ``ResUnetDiscriminator`` is the encoder
arm and an 8x8 ``VALID`` conv to one logit. Convs have biases and flax's
default lecun-normal init; the instance norm has no affine parameters (flax
``GroupNorm(group_size=1)``, eps 1e-5); PReLU has one slope, init 0.25.
Submodules carry the flax names (``ResidualEncoder_0``, ``Conv_1``,
``PReLU_0``, ...) for :mod:`.convert`.

Padding, flax's ``SAME`` written out: the 3x3 stride-2 conv pads an even
axis (0, 1); the 3x3 stride-2 transposed conv pads the dilated input
(2, 1), which is ``conv_transpose2d`` with the kernel flipped in space,
cropped to ``2n`` from offset 0 (the convention of :mod:`.unet3d`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.models.unet3d import _same_pads

# flax's truncated normal keeps [-2, 2] standard deviations; this rescales
# its draws to unit variance (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``lecun_normal`` in place: a normal truncated at 2 standard
    deviations, scaled to variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


class Conv(nn.Module):
    """flax ``Conv(cout, (k, k), (s, s), padding)`` with bias, NCHW; weight
    (cout, cin, k, k)."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 padding: str = "SAME", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k, self.stride, self.padding = k, stride, padding
        self.weight = nn.Parameter(lecun_normal_(
            torch.empty(cout, cin, k, k, device=device), cin * k * k, generator))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == "SAME":
            pads = []
            for n in reversed(x.shape[2:]):  # F.pad lists the last axis first
                pads += _same_pads(n, self.k, self.stride)
            if any(pads):
                x = F.pad(x, pads)
        return F.conv2d(x, self.weight, self.bias, stride=self.stride)


class ConvTranspose(nn.Module):
    """flax ``ConvTranspose(cout, (k, k), (s, s), "SAME")`` with bias, NCHW;
    weight (cin, cout, k, k), the flax kernel flipped in space."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k, self.stride = k, stride
        self.weight = nn.Parameter(lecun_normal_(
            torch.empty(cin, cout, k, k, device=device), cin * k * k, generator))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.k, self.stride
        # lax.conv_transpose SAME: pad_lo = k-1 if s > k-1 else ceil((k+s-2)/2)
        pad_lo = k - 1 if s > k - 1 else -(-(k + s - 2) // 2)
        start = k - 1 - pad_lo
        H, W = x.shape[2:]
        end_h, end_w = (H - 1) * s + k - start - H * s, (W - 1) * s + k - start - W * s
        if start == end_h == end_w:  # symmetric: the conv's own padding
            return F.conv_transpose2d(x, self.weight, self.bias, stride=s, padding=start)
        y = F.conv_transpose2d(x, self.weight, self.bias, stride=s)
        return y[:, :, start:start + H * s, start:start + W * s]


class PReLU(nn.Module):
    """flax ``PReLU``: one slope (``weight``, shape (1,)), init 0.25."""

    def __init__(self, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight * x)


def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel normalisation over space, no affine, its
    variance in two passes, where flax's ``GroupNorm`` takes one
    (``max(0, E[x^2] - E[x]^2)``): the same values up to rounding, and
    fewer device operations a step (4672 against 6072 a ``gibbs_gan`` step
    on an H100; the A/B's entry in CHANGES.md has the numbers). A spatially
    constant map (a Gibbs-compressed slice whose mask kept nothing is all
    zeros, and so is every map after it) has variance 0:
    ``torch.var_mean``'s backward gives NaN there; this form's gradient,
    like flax's, overflows only where flax's does
    (``tests/test_torch_gan_models.py``)."""
    axes = tuple(range(2, x.ndim))
    d = x - x.mean(dim=axes, keepdim=True)
    return d * torch.rsqrt((d * d).mean(dim=axes, keepdim=True) + eps)


def _norm_act(x: torch.Tensor, act: PReLU) -> torch.Tensor:
    """The JAX package's ``_in_prelu``: instance norm, then PReLU."""
    return act(_instance_norm(x))


class ResidualBlock(nn.Module):
    def __init__(self, nf: int, device=None, generator=None):
        super().__init__()
        widths = [nf, nf // 2, nf]
        c = nf
        for i, w in enumerate(widths):
            self.add_module(f"Conv_{i}", Conv(c, w, device=device, generator=generator))
            self.add_module(f"PReLU_{i}", PReLU(device))
            c = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i in range(3):
            y = _norm_act(getattr(self, f"Conv_{i}")(y), getattr(self, f"PReLU_{i}"))
        return y + x


class ResidualEncoder(nn.Module):
    def __init__(self, cin: int, out_chans: int, device=None, generator=None):
        super().__init__()
        self.Conv_0 = Conv(cin, out_chans, stride=2, device=device, generator=generator)
        self.PReLU_0 = PReLU(device)
        self.ResidualBlock_0 = ResidualBlock(out_chans, device, generator)
        self.Conv_1 = Conv(out_chans, out_chans, device=device, generator=generator)
        self.PReLU_1 = PReLU(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _norm_act(self.Conv_0(x), self.PReLU_0)
        x = self.ResidualBlock_0(x)
        return _norm_act(self.Conv_1(x), self.PReLU_1)


class ResidualDecoder(nn.Module):
    def __init__(self, cin: int, out_chans: int, device=None, generator=None):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose(cin, out_chans, device=device,
                                             generator=generator)
        self.PReLU_0 = PReLU(device)
        self.ResidualBlock_0 = ResidualBlock(out_chans, device, generator)
        self.ConvTranspose_1 = ConvTranspose(out_chans, out_chans, stride=2,
                                             device=device, generator=generator)
        self.PReLU_1 = PReLU(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _norm_act(self.ConvTranspose_0(x), self.PReLU_0)
        x = self.ResidualBlock_0(x)
        return _norm_act(self.ConvTranspose_1(x), self.PReLU_1)


class ResUnetGenerator(nn.Module):
    """Residual autoencoder G: (B, in_chans, 128, 128) -> the same shape."""

    def __init__(self, in_chans: int = 2, nf: int = 16, global_residual: bool = True,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.global_residual = global_residual
        c = in_chans
        for i, m in enumerate((1, 2, 4, 8)):  # 64, 32, 16, 8
            self.add_module(f"ResidualEncoder_{i}",
                            ResidualEncoder(c, nf * m, dev, generator))
            c = nf * m
        for i, m in enumerate((4, 2, 1, 1)):
            self.add_module(f"ResidualDecoder_{i}",
                            ResidualDecoder(c, nf * m, dev, generator))
            c = nf * m
        self.Conv_0 = Conv(nf, in_chans, device=dev, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        en1 = self.ResidualEncoder_0(x)
        en2 = self.ResidualEncoder_1(en1)
        en3 = self.ResidualEncoder_2(en2)
        en4 = self.ResidualEncoder_3(en3)
        de3 = self.ResidualDecoder_0(en4)
        de2 = self.ResidualDecoder_1(de3 + en3)
        de1 = self.ResidualDecoder_2(de2 + en2)
        de0 = self.ResidualDecoder_3(de1 + en1)
        out = torch.tanh(self.Conv_0(de0))
        return out + x if self.global_residual else out


class ResUnetDiscriminator(nn.Module):
    """Encoder arm + an 8x8 ``VALID`` conv: (B, in_chans, 128, 128) ->
    (B, 1, 1, 1) logits."""

    def __init__(self, in_chans: int = 2, nf: int = 16, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        c = in_chans
        for i, m in enumerate((1, 2, 4, 8)):
            self.add_module(f"ResidualEncoder_{i}",
                            ResidualEncoder(c, nf * m, dev, generator))
            c = nf * m
        self.Conv_0 = Conv(c, 1, k=8, padding="VALID", device=dev, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            x = getattr(self, f"ResidualEncoder_{i}")(x)
        return self.Conv_0(x)
