"""Differentiable stylization layers: the corruption inside the model
(counterpart of mvtb_tpu/models/layers.py).

The reference's ``stylization_layers.py`` puts a Gibbs filter or a k-space
spike in front of the 3D ResUNet. Here the Gibbs cut-off ``alpha`` and the
spike's log-intensity are ``nn.Parameter``s: behind the soft mask
(:func:`~mvtb_tpu_torch.ops.masks.soft_gibbs_mask`) alpha trains by
autograd, and ``hard=True`` gives the reference's mask for the
finite-difference trainer (:mod:`mvtb_tpu_torch.train.learnable`).

Every module is channel-first, ``(B, C, *spatial)``, and ``device=None``
means ``"cuda"``. The UNet of :class:`GibbsUNet` and :class:`SpikesUNet`
computes in float32, as the JAX models build theirs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.models.unet3d import UNet
from mvtb_tpu_torch.ops.corruptions import kspace_spike_random
from mvtb_tpu_torch.ops.fourier import fft_shifted, ifft_shifted_real
from mvtb_tpu_torch.ops.masks import reference_gibbs_layer_mask, soft_gibbs_mask


class GibbsNoiseLayer(nn.Module):
    """Learnable Gibbs filter (``stylization_layers.py:55-116``).

    ``alpha`` (shape (1,)) starts at ``alpha_init`` clipped to [0, 1], or
    U[0, 1) from PyTorch's generator when None, as the reference draws it;
    the forward clips it to [0, 1]. ``alpha = 1`` is close to the identity,
    ``alpha = 0`` zeroes k-space.

    The clip is ``minimum(maximum(alpha, 0), 1)`` with tensor bounds, so at
    a bound the gradient is halved, as ``jnp.clip``'s is (``torch.clamp``
    passes all of it).
    """

    def __init__(self, alpha_init: Optional[float] = None, tau: float = 1.0,
                 hard: bool = False, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        if alpha_init is None:
            alpha = torch.rand((1,), device=dev)
        else:
            alpha = torch.tensor([min(max(alpha_init, 0.0), 1.0)], dtype=torch.float32,
                                 device=dev)
        self.alpha = nn.Parameter(alpha)
        self.tau, self.hard = tau, hard

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        zero = self.alpha.new_zeros(())
        alpha = torch.minimum(torch.maximum(self.alpha[0], zero), zero + 1)
        nd = x.ndim - 2
        spatial = x.shape[-nd:]
        if self.hard:
            mask = reference_gibbs_layer_mask(spatial, alpha)
        else:
            mask = soft_gibbs_mask(spatial, alpha, self.tau)
        k = fft_shifted(x, nd)
        return ifft_shifted_real(k * mask.to(k.real.dtype), nd)


class SpikeLayer(nn.Module):
    """Random-spike layer (``stylization_layers.py:143-151``): one spike a
    sample, at a location shared over its channels, whose log-magnitude is
    ``intensity`` (the reference's ``RandKSpaceSpikeNoise(prob=1,
    intensity_range=(i, i), channel_wise=False)``). With ``learnable`` the
    intensity is a parameter of shape (1,); the written value carries its
    gradient.

    The locations come from ``generator`` (:meth:`sample_locations`), or
    are given as a (B, n_dims) integer tensor, which is how one step's
    forwards share their draws and how a test replays the JAX package's.
    """

    def __init__(self, intensity: float = 15.0, learnable: bool = True,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.learnable = learnable
        if learnable:
            self.intensity = nn.Parameter(
                torch.tensor([intensity], dtype=torch.float32, device=dev))
        else:
            self.intensity = float(intensity)

    @staticmethod
    def sample_locations(x: torch.Tensor,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, n_dims) int64 locations on ``x``'s device, uniform over the
        spatial grid of ``x`` (B, C, *spatial)."""
        return torch.stack([torch.randint(0, n, (x.shape[0],), generator=generator,
                                          device=x.device) for n in x.shape[2:]], dim=1)

    def forward(self, x: torch.Tensor, locs: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if locs is None:
            locs = self.sample_locations(x, generator)
        i = self.intensity[0] if self.learnable else self.intensity
        # the range is the one point i, so the value's uniform plays no part
        u = x.new_zeros(())
        nd = x.ndim - 2
        return torch.stack([
            kspace_spike_random(x[b], None, (i, i), channel_wise=False, n_dims=nd,
                                locs=[locs[b, d:d + 1] for d in range(nd)], u=u)
            for b in range(x.shape[0])])


class GibbsUNet(nn.Module):
    """Gibbs layer -> 3D ResUNet (``stylization_layers.py:119-139``), as
    ``gibbs`` and ``unet``. The reference's ``Gibbs_UNet`` ignores its
    ``alpha`` argument (its line 125); here ``alpha_init`` is honoured, as
    in the JAX package. ``locs`` and ``generator`` are accepted for the
    interface :class:`SpikesUNet` shares and not used: the Gibbs layer
    draws nothing."""

    def __init__(self, alpha_init: Optional[float] = 0.5, tau: float = 1.0,
                 hard: bool = False, out_channels: int = 1,
                 channels: Sequence[int] = (16, 32, 64, 128, 256),
                 strides: Sequence[int] = (2, 2, 2, 2), num_res_units: int = 2,
                 in_channels: int = 1, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.gibbs = GibbsNoiseLayer(alpha_init, tau, hard, device=dev)
        self.unet = UNet(in_channels, out_channels, channels, strides, num_res_units,
                         device=dev)

    def forward(self, x: torch.Tensor, locs: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.unet(self.gibbs(x))


class SpikesUNet(nn.Module):
    """Spike layer -> 3D ResUNet (``stylization_layers.py:154-173``), as
    ``spike`` and ``unet``; ``locs`` / ``generator`` feed the spike layer."""

    def __init__(self, intensity: float = 15.0, learnable: bool = True,
                 out_channels: int = 1,
                 channels: Sequence[int] = (16, 32, 64, 128, 256),
                 strides: Sequence[int] = (2, 2, 2, 2), num_res_units: int = 2,
                 in_channels: int = 1, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.spike = SpikeLayer(intensity, learnable, device=dev)
        self.unet = UNet(in_channels, out_channels, channels, strides, num_res_units,
                         device=dev)

    def forward(self, x: torch.Tensor, locs: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.unet(self.spike(x, locs, generator))


# reference-name aliases
Gibbs_UNet = GibbsUNet
Spikes_UNet = SpikesUNet
spike_layer = SpikeLayer
