"""Functional MRI k-space corruption ops (counterpart of
mvtb_tpu/ops/corruptions.py).

Each op takes a channel-first tensor ``x`` whose trailing ``n_dims`` axes
are spatial and returns the corrupted image, on the device of ``x``. Where
the JAX op takes a ``key``, this one takes a ``torch.Generator`` (the two
give different numbers from the same seed); ``salt_and_pepper`` and
``rand_zero_fill`` also take the uniform field itself (``u=``), which is
how a caller replays a field drawn elsewhere bit for bit.

Reference semantics come from the reference's
``source_code/filters_and_operators.py`` (FO) and
``50_reconstruction/reconGan/utils2.py`` (U2), cited per op.
"""

from __future__ import annotations

import numbers

from typing import Optional, Sequence, Tuple, Union

import torch

from mvtb_tpu_torch.ops.fourier import fft_shifted, from_polar, ifft_shifted_real
from mvtb_tpu_torch.ops.masks import disk_mask, gibbs_mask


def _default_n_dims(x: torch.Tensor, n_dims: Optional[int]) -> int:
    """Spatial rank: everything after the leading channel axis (FO:664)."""
    return x.ndim - 1 if n_dims is None else n_dims


def _as_mask(mask, k: torch.Tensor) -> torch.Tensor:
    """A numpy or torch mask as a tensor of ``k``'s real dtype on its device."""
    if not isinstance(mask, torch.Tensor):
        mask = torch.from_numpy(mask)
    return mask.to(device=k.device, dtype=k.real.dtype)


def _uniform(shape, dtype, generator: Optional[torch.Generator],
             device: torch.device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Gibbs ringing
# ---------------------------------------------------------------------------

def fourier_disk_filter(x: torch.Tensor, r, n_dims: int = 3,
                        inside_off: bool = False) -> torch.Tensor:
    """Disk-mask filter in k-space (core of ``RandFourierDiskMaskd``, FO:236-252):
    FFT over the trailing ``n_dims`` axes, multiply by the disk mask of
    radius ``r`` centered at ``floor(n/2)``, inverse FFT, real part."""
    k = fft_shifted(x, n_dims)
    return ifft_shifted_real(k * _as_mask(disk_mask(x.shape[-n_dims:], r, inside_off), k),
                             n_dims)


def gibbs_noise(x: torch.Tensor, alpha, n_dims: Optional[int] = None) -> torch.Tensor:
    """Canonical Gibbs transform (``GibbsNoise``, FO:663-705): keep k-space
    within ``r = (1-alpha) * max(shape) * sqrt(2)/2`` of the true center
    ``(shape-1)/2``; ``alpha=0`` is the identity."""
    nd = _default_n_dims(x, n_dims)
    k = fft_shifted(x, nd)
    return ifft_shifted_real(k * _as_mask(gibbs_mask(x.shape[-nd:], alpha), k), nd)


# ---------------------------------------------------------------------------
# k-space spikes (Herringbone artifact)
# ---------------------------------------------------------------------------

def default_spike_intensity_stats(x: torch.Tensor, n_dims: Optional[int] = None
                                  ) -> torch.Tensor:
    """Per-channel mean log-magnitude of k-space, times 2.5 (FO:932-933,
    FO:1118-1131). Shape ``x.shape[:-n_dims]``."""
    nd = _default_n_dims(x, n_dims)
    log_abs = torch.log(torch.abs(fft_shifted(x, nd)) + 1e-10)
    return torch.mean(log_abs, dim=tuple(range(-nd, 0))) * 2.5


def _set_log_abs(log_abs: torch.Tensor, idx, val) -> None:
    log_abs[idx] = torch.as_tensor(val, dtype=log_abs.dtype).to(log_abs.device)


def kspace_spike(x: torch.Tensor, locs: Sequence[Tuple[int, ...]],
                 intensities: Sequence[Union[float, torch.Tensor]],
                 n_dims: Optional[int] = None) -> torch.Tensor:
    """Write spikes into log-|k| at fixed locations (``KSpaceSpikeNoise``, FO:906-983).

    Splits k into ``log(|k| + 1e-10)`` and phase, writes each intensity at
    its location, recombines ``exp(log|k|) * e^{i*phase}`` and inverts. A
    location of length ``n_dims`` covers every channel (its intensity may
    then be a per-channel vector); one of length ``x.ndim`` one channel.
    """
    nd = _default_n_dims(x, n_dims)
    k = fft_shifted(x, nd)
    log_abs = torch.log(torch.abs(k) + 1e-10)
    phase = torch.angle(k)
    n_lead = x.ndim - nd
    for loc, val in zip(locs, intensities):
        loc = tuple(int(i) for i in loc)
        if len(loc) == x.ndim:
            _set_log_abs(log_abs, loc, val)
        elif len(loc) == nd:
            _set_log_abs(log_abs, (slice(None),) * n_lead + loc, val)
        else:
            raise ValueError(
                f"Spike location {loc} must have length {nd} (all channels) "
                f"or {x.ndim} (single channel).")
    return ifft_shifted_real(from_polar(torch.exp(log_abs), phase), nd)


def kspace_spike_random(x: torch.Tensor, generator: Optional[torch.Generator],
                        intensity_range: Tuple[float, float],
                        channel_wise: bool = True,
                        n_dims: Optional[int] = None,
                        locs: Optional[Sequence[torch.Tensor]] = None,
                        u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One random spike per channel (``channel_wise``) or one shared spatial
    location, each with a log-intensity uniform in ``intensity_range``: the
    on-device analogue of ``RandKSpaceSpikeNoise._randomize`` (FO:1087-1103).
    ``x`` is (C, *spatial); ``generator`` lives on ``x``'s device (None:
    PyTorch's default generator there).

    ``locs`` (one integer tensor an axis, of shape (C,) or, shared, (1,))
    and ``u`` (the value's uniform) replace those draws. The bounds may be
    tensors: the written value carries their gradient (1 for ``lo = hi``)."""
    nd = _default_n_dims(x, n_dims)
    if x.ndim != nd + 1:
        raise ValueError("kspace_spike_random expects (C, *spatial) input.")
    C, spatial, dev = x.shape[0], x.shape[1:], x.device
    k = fft_shifted(x, nd)
    log_abs = torch.log(torch.abs(k) + 1e-10)
    phase = torch.angle(k)
    lo, hi = intensity_range
    width = (C,) if channel_wise else ()
    if locs is None:
        locs = tuple(torch.randint(0, spatial[d], width, generator=generator, device=dev)
                     for d in range(nd))
    if u is None:
        u = _uniform(width, log_abs.dtype, generator, dev)
    vals = lo + (hi - lo) * u
    if channel_wise:
        log_abs[(torch.arange(C, device=dev),) + tuple(locs)] = vals
    else:
        log_abs[(slice(None),) + tuple(locs)] = vals
    return ifft_shifted_real(from_polar(torch.exp(log_abs), phase), nd)


# ---------------------------------------------------------------------------
# Plane waves
# ---------------------------------------------------------------------------

def plane_wave(x: torch.Tensor, loc, intensity, n_dims: int = 3) -> torch.Tensor:
    """One k-space point set to a fixed log-magnitude across all channels
    (core of ``RandPlaneWaves_ellipsoid.__call__``, FO:370-393). The log has
    *no* epsilon, as the reference's ``k.abs().log()``: a zero there is
    ``-inf`` and comes back as 0. ``loc`` is a length-``n_dims`` index
    (tuple or integer tensor)."""
    k = fft_shifted(x, n_dims)
    k_abs_log = torch.log(torch.abs(k))
    k_angle = torch.angle(k)
    n_lead = x.ndim - n_dims
    if isinstance(loc, torch.Tensor):
        point = tuple(loc[d] for d in range(n_dims))
    else:
        point = tuple(int(i) for i in loc)
    _set_log_abs(k_abs_log, (slice(None),) * n_lead + point, intensity)
    return ifft_shifted_real(from_polar(torch.exp(k_abs_log), k_angle), n_dims)


# ---------------------------------------------------------------------------
# Wraparound / aliasing
# ---------------------------------------------------------------------------

def wrap_artifact(x: torch.Tensor, alpha, n_dims: Optional[int] = None) -> torch.Tensor:
    """Scale every odd-indexed k-line by ``alpha`` along each spatial axis
    (``WrapArtifact.__call__``, FO:503-515): one multiply by the per-axis
    weight vectors ``w[i] = alpha if i odd else 1``, for any ``n_dims``."""
    nd = _default_n_dims(x, n_dims)
    k = fft_shifted(x, nd)
    real = k.real.dtype
    alpha = torch.as_tensor(alpha, dtype=real).to(k.device)
    for d in range(-nd, 0):
        n = x.shape[d]
        odd = torch.arange(n, device=k.device) % 2 == 1
        w = torch.where(odd, alpha, torch.ones((), dtype=real, device=k.device))
        shape = [1] * x.ndim
        shape[d] = n
        k = k * w.reshape(shape)
    return ifft_shifted_real(k, nd)


# ---------------------------------------------------------------------------
# Image-domain impulse noise
# ---------------------------------------------------------------------------

def sap_select(x: torch.Tensor, u: torch.Tensor, p: torch.Tensor,
               lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The salt & pepper select: ``lo`` where ``u <= p/2``, ``hi`` where
    ``p/2 < u <= p``, else ``x``. ``u <= p/2`` is inclusive, so at ``p = 0``
    a voxel whose ``u`` is exactly 0 still turns to pepper. Shared by
    :func:`salt_and_pepper`, the plain version of the S&P kernel and the
    fused stack's per-sample stage; the arguments broadcast."""
    half = p / 2
    out = torch.where(u <= half, lo, x)
    return torch.where((u > half) & (u <= p), hi, out)


def salt_and_pepper(x: torch.Tensor, p, generator: Optional[torch.Generator] = None,
                    *, u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Salt-and-pepper impulse noise (``SaltAndPepper.salt_and_pepper``, FO:465-482).

    Per-voxel uniform ``u``: ``u <= p/2`` -> pepper ``min(x)/2``,
    ``p/2 < u <= p`` -> salt ``max(x)/2``, else unchanged. The extrema are
    global over the whole tensor (all channels), as in the reference. Pass
    ``u`` to replay a field, else ``generator`` draws one.
    """
    if u is None:
        if generator is None:
            raise ValueError("salt_and_pepper needs `generator` or a precomputed `u`.")
        u = _uniform(x.shape, x.dtype, generator, x.device)
    p = torch.as_tensor(p, dtype=x.dtype).to(x.device)
    return sap_select(x, u.to(x.device), p, x.min() / 2, x.max() / 2)


# ---------------------------------------------------------------------------
# Random zero-fill (compressed-sensing undersampling)
# ---------------------------------------------------------------------------

def rand_zero_fill(x: torch.Tensor, p, generator: Optional[torch.Generator] = None, *,
                   u: Optional[torch.Tensor] = None,
                   n_dims: Optional[int] = None) -> torch.Tensor:
    """Zero k-space points with probability ``p`` (``RandZF``, U2:34-74); the
    mask covers the whole (channel-inclusive) k-space shape."""
    nd = _default_n_dims(x, n_dims)
    k = fft_shifted(x, nd)
    if u is None:
        if generator is None:
            raise ValueError("rand_zero_fill needs `generator` or a precomputed `u`.")
        u = _uniform(k.shape, x.dtype, generator, x.device)
    # a number is compared as a scalar (in x's type, as the JAX package casts
    # it): no host-to-device copy of it, which the card's stream would wait on
    thr = p if isinstance(p, numbers.Real) else torch.as_tensor(p, dtype=x.dtype).to(x.device)
    keep = u.to(x.device) > thr
    return ifft_shifted_real(k * keep.to(k.real.dtype), nd)
