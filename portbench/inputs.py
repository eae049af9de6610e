"""Inputs and weights made on the device from ``--seed``.

The pool follows the program's textured generator
(``mvtb_tpu_torch/data/synthetic.py:make_textured_volume``) at the same
shapes and label layout, rewritten to run batched on the card from one
``torch.Generator``: a warped ellipsoid tumour with nested regions (WT > TC >
ET), label channels (TC, WT, ET); per channel a low-frequency anatomy band, a
high-frequency texture band whose amplitude drops inside the tumour, and a
mean offset that survives low-pass filtering; each channel normalised to
zero mean and unit variance. The same seed gives the same pool, bit for bit,
on the same device.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

TEXTURE_BAND = (0.22, 0.42)
TEX_AMPS = {"out": 1.0, "wt": 0.5, "tc": 0.25, "et": 0.1}
OFFSETS = {"wt": 0.5, "tc": 0.3, "et": 0.3}
ANATOMY_AMP = 0.6


def subseed(seed: int, *tags: int) -> int:
    """A 63-bit seed derived from ``seed`` and ``tags`` (any whole numbers)."""
    words = [int(seed) & (2 ** 64 - 1)] + [int(t) & (2 ** 64 - 1) for t in tags]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1


def generator(seed: int, device, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, *tags))


def _box_smooth(x: torch.Tensor, passes: int, dims: Sequence[int]) -> torch.Tensor:
    for _ in range(passes):
        for d in dims:
            x = (x + torch.roll(x, 1, d) + torch.roll(x, -1, d)) / 3.0
    return x


def _band(noise: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """White noise (..., *spatial) band-passed to radii [lo, hi) in units of
    max(spatial)/2 index steps, scaled to unit variance per volume."""
    spatial = noise.shape[-3:]
    dims = (-3, -2, -1)
    k = torch.fft.rfftn(noise, dim=dims)
    dev = noise.device
    fr = [torch.fft.fftfreq(n, d=1.0 / n, device=dev) for n in spatial[:-1]]
    fr.append(torch.fft.rfftfreq(spatial[-1], d=1.0 / spatial[-1], device=dev))
    r2 = (fr[0].view(-1, 1, 1) ** 2 + fr[1].view(1, -1, 1) ** 2 + fr[2].view(1, 1, -1) ** 2)
    r = torch.sqrt(r2) / (max(spatial) / 2.0)
    y = torch.fft.irfftn(k * ((r >= lo) & (r < hi)), s=spatial, dim=dims)
    return y / (y.std(dim=dims, keepdim=True) + 1e-6)


def textured_pool(seed: int, n: int, channels: int, spatial: Sequence[int],
                  device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(images (n, channels, *spatial), labels (n, 3, *spatial))`` float32."""
    g = generator(seed, device, 1)
    spatial = tuple(int(s) for s in spatial)
    sp = torch.tensor(spatial, dtype=torch.float32, device=device)
    center = (0.35 + 0.3 * torch.rand((n, 3), generator=g, device=device)) * sp
    radii = (0.12 + 0.12 * torch.rand((n, 3), generator=g, device=device)) * sp
    q = 0.0
    for a in range(3):
        view = [1, 1, 1, 1]
        view[1 + a] = spatial[a]
        i = torch.arange(spatial[a], dtype=torch.float32, device=device).view(view)
        q = q + ((i - center[:, a].view(n, 1, 1, 1)) / radii[:, a].view(n, 1, 1, 1)) ** 2
    warp = _box_smooth(torch.randn((n,) + spatial, generator=g, device=device), 6, (1, 2, 3))
    warp = warp / (warp.abs().amax(dim=(1, 2, 3), keepdim=True) + 1e-6)
    q = q * (1.0 + 0.25 * warp)
    wt, tc, et = q < 1.0, q < 0.55, q < 0.25
    amp = torch.full_like(q, TEX_AMPS["out"])
    amp = torch.where(wt, TEX_AMPS["wt"], amp)
    amp = torch.where(tc, TEX_AMPS["tc"], amp)
    amp = torch.where(et, TEX_AMPS["et"], amp)
    offset = OFFSETS["wt"] * wt + OFFSETS["tc"] * tc + OFFSETS["et"] * et
    amp = _box_smooth(amp, 2, (1, 2, 3))[:, None]
    offset = _box_smooth(offset.float(), 2, (1, 2, 3))[:, None]
    images = torch.empty((n, channels) + spatial, device=device)
    for c in range(channels):  # one channel of every volume at a time
        anatomy = ANATOMY_AMP * _band(torch.randn((n,) + spatial, generator=g, device=device),
                                      0.0, 0.12)
        texture = _band(torch.randn((n,) + spatial, generator=g, device=device), *TEXTURE_BAND)
        gain = 0.7 + 0.6 * torch.rand((n, 1, 1, 1), generator=g, device=device)
        images[:, c] = anatomy + amp[:, 0] * texture + gain * offset[:, 0]
    dims = (2, 3, 4)
    images = (images - images.mean(dim=dims, keepdim=True)) / (
        images.std(dim=dims, keepdim=True, correction=0) + 1e-6)
    labels = torch.stack([tc, wt, et], dim=1).float()
    return images, labels


def make_weights(seed: int, shapes: Dict[str, Tuple[int, ...]], device
                 ) -> Dict[str, torch.Tensor]:
    """float32 UNet parameters in one draw: convolution weights normal with
    standard deviation 1/sqrt(fan in) (LeCun normal, the program's
    initialisation), biases 0, PReLU slopes 0.25."""
    g = generator(seed, device, 2)
    conv = {k: s for k, s in shapes.items() if k.endswith(".weight") and len(s) == 5}
    flat = torch.randn(sum(math.prod(s) for s in conv.values()), generator=g, device=device)
    out, i = {}, 0
    for k, s in shapes.items():
        if k in conv:
            # conv weights are (out, in, k, k, k); transposed ones (in, out, k, k, k)
            cin = s[0] if "ConvTranspose" in k else s[1]
            n = math.prod(s)
            out[k] = flat[i:i + n].view(s) / math.sqrt(cin * math.prod(s[2:]))
            i += n
        elif k.endswith("PReLU_0.weight"):
            out[k] = torch.full(s, 0.25, device=device)
        else:
            out[k] = torch.zeros(s, device=device)
    return out
