"""Centered FFT helpers over trailing spatial axes (counterpart of
mvtb_tpu/ops/fourier.py).

A centered n-D FFT (``fftshift(fftn(x))``) and its inverse
(``ifftn(ifftshift(k))``) over the trailing ``n_dims`` axes only, so leading
batch and channel axes pass through; the inverse's ``.real`` drops the
imaginary leakage, as the reference does. A float32 input gives complex64,
as JAX does without x64. Every function runs on the device of its input.
"""

from __future__ import annotations

import torch


def _spatial_dims(n_dims: int) -> tuple:
    return tuple(range(-n_dims, 0))


def fft_shifted(x: torch.Tensor, n_dims: int) -> torch.Tensor:
    """Centered forward FFT over the trailing ``n_dims`` axes: the zero
    frequency sits at ``floor(n/2)`` of each transformed axis."""
    dims = _spatial_dims(n_dims)
    return torch.fft.fftshift(torch.fft.fftn(x, dim=dims), dim=dims)


def ifft_shifted(k: torch.Tensor, n_dims: int) -> torch.Tensor:
    """Inverse of :func:`fft_shifted`; returns the complex image."""
    dims = _spatial_dims(n_dims)
    return torch.fft.ifftn(torch.fft.ifftshift(k, dim=dims), dim=dims)


def ifft_shifted_real(k: torch.Tensor, n_dims: int) -> torch.Tensor:
    """Inverse centered FFT keeping only the real part (drops leakage)."""
    return ifft_shifted(k, n_dims).real.contiguous()


def from_polar(magnitude: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """``magnitude * e^{i*phase}`` as ``complex(m*cos, m*sin)``, the JAX
    package's formulation."""
    return torch.complex(magnitude * torch.cos(phase), magnitude * torch.sin(phase))
