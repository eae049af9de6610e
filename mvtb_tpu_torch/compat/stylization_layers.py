"""Import-path shim: ``stylization_layers`` for the reference scripts
(counterpart of mvtb_tpu/compat/stylization_layers.py).

The learnable-layer scripts
(``10_scripts/300_instutional_distribution/350_stylized_layers/*.py``)
define their own

    class Gibbs_UNet(nn.Module):
        def __init__(self, alpha):
            self.gibbs = GibbsNoiseLayer(alpha)
            self.ResUnet = UNet(...)          # the monai shim's UNet

(``gibbs0p7_layer_domain_GD.py:192-212``), call ``model.to(device)`` and
``Adam(model.parameters())``, and assign ``model.gibbs.alpha`` inside a
``@torch.no_grad()`` finite-difference routine
(``gibbs0p7_layer_domain_GD.py:251-269``). So ``alpha`` here is a plain
requires-grad tensor, **not** an ``nn.Parameter``, as in the reference
(``stylization_layers.py:72-77``): ``model.parameters()`` yields only the
UNet's, Adam never moves alpha, and alpha moves by the scripts' updates.
The forward builds the reference's hard mask
(:func:`~mvtb_tpu_torch.ops.masks.reference_gibbs_layer_mask`) from
alpha's current value on the input's device.

The port's trainable layers (alpha an ``nn.Parameter``, behind the soft
mask) are :mod:`mvtb_tpu_torch.models.layers`, re-exported here with a
``Learnable`` prefix.
"""

from __future__ import annotations

import torch

from mvtb_tpu_torch._device import DeviceLike
from mvtb_tpu_torch.compat.filters_and_operators import Fourier  # noqa: F401
from mvtb_tpu_torch.models.layers import (  # noqa: F401
    GibbsNoiseLayer as LearnableGibbsNoiseLayer,
    GibbsUNet as LearnableGibbsUNet,
    SpikeLayer as LearnableSpikeLayer,
    SpikesUNet as LearnableSpikesUNet,
)
from mvtb_tpu_torch.ops.fourier import fft_shifted, ifft_shifted_real
from mvtb_tpu_torch.ops.masks import reference_gibbs_layer_mask
from mvtb_tpu_torch.transforms import RandKSpaceSpikeNoise


class GibbsNoiseLayer(torch.nn.Module):
    """Gibbs layer (``stylization_layers.py:55-116``): the hard mask at the
    current ``alpha`` over every axis past dim 0 (the reference's
    ``n_dims = len(img.shape[1:])``), centred at ``(n-1)/2``.

    ``alpha`` is a plain requires-grad tensor of shape (1,), made on the
    CPU and moved with the module (``model.to(device)``), U[0, 1) from
    PyTorch's generator when None, else clipped to [0, 1].
    The mask's gradient in alpha is zero almost everywhere, hence the
    scripts' finite-difference updates."""

    def __init__(self, alpha=None) -> None:
        super().__init__()
        if alpha is None:
            self.alpha = torch.rand(1, requires_grad=True)
        else:
            alpha = min(max(float(alpha), 0.0), 1.0)
            self.alpha = torch.tensor([alpha], requires_grad=True)

    def _apply(self, fn, recurse=True):
        # ``model.to(device)`` moves alpha too, so the scripts' updates
        # (``old_alpha - lr * delta``, delta a loss on the card) stay on one
        # device; alpha stays out of ``parameters()``
        super()._apply(fn, recurse)
        self.alpha = fn(self.alpha.detach()).requires_grad_(self.alpha.requires_grad)
        return self

    def forward(self, img) -> torch.Tensor:
        x = torch.as_tensor(img)
        a = float(self.alpha.detach().reshape(-1)[0])
        n_dims = x.ndim - 1
        mask = reference_gibbs_layer_mask(x.shape[1:], a, device=x.device)
        k = fft_shifted(x, n_dims)
        return ifft_shifted_real(k * mask.to(k.real.dtype), n_dims)


class spike_layer(torch.nn.Module):
    """Spike layer (``stylization_layers.py:143-151``): a fresh
    ``RandKSpaceSpikeNoise(prob=1, intensity_range=(i, i),
    channel_wise=False)`` per forward on the input's device, with
    ``intensity`` a tensor the spike GD scripts reassign
    (``spikes11_layer_domain_GD.py:262-277``)."""

    def __init__(self, intensity) -> None:
        super().__init__()
        self.intensity = torch.as_tensor(float(intensity))

    def forward(self, x) -> torch.Tensor:
        x = torch.as_tensor(x)
        i = self.intensity.item()
        t = RandKSpaceSpikeNoise(prob=1.0, intensity_range=(i, i),
                                 channel_wise=False, device=x.device)
        return t(x)


def _unet(device: DeviceLike):
    from mvtb_tpu_torch.compat.monai.networks.nets import UNet

    return UNet(dimensions=3, in_channels=1, out_channels=1,
                channels=(16, 32, 64, 128, 256), strides=(2, 2, 2, 2),
                num_res_units=2, device=device)


class Gibbs_UNet(torch.nn.Module):
    """Gibbs layer -> 3D ResUNet(1 -> 1) (``stylization_layers.py:119-139``).

    The reference's ``__init__`` ignores its ``alpha`` argument and
    hard-codes 0.5 (its line 125); here ``alpha`` is honoured, as in the
    JAX shim. ``device`` places the UNet (None: the card)."""

    def __init__(self, alpha=None, device: DeviceLike = None) -> None:
        super().__init__()
        self.gibbs = GibbsNoiseLayer(alpha)
        self.ResUnet = _unet(device)

    def forward(self, img):
        return self.ResUnet(self.gibbs(img))


class Spikes_UNet(torch.nn.Module):
    """Spike layer -> 3D ResUNet(1 -> 1) (``stylization_layers.py:154-173``)."""

    def __init__(self, intensity=15, device: DeviceLike = None) -> None:
        super().__init__()
        self.spike = spike_layer(intensity)
        self.ResUnet = _unet(device)

    def forward(self, img):
        return self.ResUnet(self.spike(img))
