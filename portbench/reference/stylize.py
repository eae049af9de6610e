"""Plain Gibbs disk mask (``RandFourierDiskMaskd(r, inside_off=False,
prob=1)``): keep the k-space points within radius ``r`` of the centre, by
``torch.fft`` in float32.

A point's offset from the centre on an axis of length ``n`` is its
``fftfreq`` frequency times ``n``; the mask keeps offsets whose squared sum
is below ``r**2``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def disk_mask(spatial, r: float, device) -> torch.Tensor:
    dist = None
    for axis, n in enumerate(spatial):
        f = torch.fft.fftfreq(n, d=1.0 / n, device=device, dtype=torch.float64)
        view = [1] * len(spatial)
        view[axis] = n
        sq = (f * f).view(view)
        dist = sq if dist is None else dist + sq
    return (dist < r * r).to(torch.float32)


def disk_lowpass(x: torch.Tensor, r: Optional[float],
                 quant: Optional[Callable] = None) -> torch.Tensor:
    """``x`` (B, C, H, W, D) low-passed by the disk of radius ``r``; ``r``
    None returns ``x``. ``quant`` rounds the input and the spectrum (the
    control's lower precision). Runs one volume at a time."""
    if r is None:
        return x
    spatial = tuple(x.shape[2:])
    mask = disk_mask(spatial, float(r), x.device)
    out = torch.empty_like(x, dtype=torch.float32)
    q = (lambda t: t) if quant is None else quant
    for b in range(x.shape[0]):
        k = torch.fft.fftn(q(x[b].float()), dim=(1, 2, 3)) * mask
        if quant is not None:
            k = torch.complex(q(k.real.contiguous()), q(k.imag.contiguous()))
        out[b] = torch.fft.ifftn(k, dim=(1, 2, 3)).real
    return out
