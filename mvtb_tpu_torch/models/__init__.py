"""Models of the port (counterpart of mvtb_tpu/models), and
:func:`build_seg_model`, the segmentation model of a run by name: ``"unet"``
(the reference's 3D ResUNet) or ``"swin_unetr"`` (:class:`SwinUNETR`, a
model the JAX package does not have)."""

import torch

from mvtb_tpu_torch.models.convert import (dcgan_params_from_flax,
                                           fid_encoder_weights_from_flax,
                                           learnable_params_from_flax, params_from_flax,
                                           resunet_gan_params_from_flax,
                                           unet_params_from_flax)
from mvtb_tpu_torch.models.dcgan import Discriminator, Generator
from mvtb_tpu_torch.models.layers import (GibbsNoiseLayer, GibbsUNet, Gibbs_UNet, SpikeLayer,
                                          SpikesUNet, Spikes_UNet, spike_layer)
from mvtb_tpu_torch.models.resunet_gan import ResUnetDiscriminator, ResUnetGenerator
from mvtb_tpu_torch.models.swin_unetr import SwinUNETR
from mvtb_tpu_torch.models.unet3d import UNet

SEG_ARCHS = {"unet": UNet, "swin_unetr": SwinUNETR}


def build_seg_model(arch: str = "unet", in_channels: int = 4, out_channels: int = 3, *,
                    device=None, dtype: torch.dtype = torch.float32, **widths):
    """The segmentation model ``arch`` (a key of ``SEG_ARCHS``), channel-first
    logits in ``dtype`` with float32 parameters, initialised from PyTorch's
    generator; ``widths`` are the model's own (``UNet``: ``channels``,
    ``strides``, ``num_res_units``; ``SwinUNETR``: ``feature_size``,
    ``depths``, ``num_heads``, ``window_size``), its published ones by
    default."""
    if arch not in SEG_ARCHS:
        raise ValueError(f"unknown segmentation model {arch!r}; one of {sorted(SEG_ARCHS)}")
    return SEG_ARCHS[arch](in_channels, out_channels, device=device, dtype=dtype, **widths)


__all__ = ["SEG_ARCHS", "Discriminator", "Generator", "GibbsNoiseLayer", "GibbsUNet",
           "Gibbs_UNet", "ResUnetDiscriminator", "ResUnetGenerator", "SpikeLayer",
           "SpikesUNet", "Spikes_UNet", "SwinUNETR", "UNet", "build_seg_model",
           "dcgan_params_from_flax", "fid_encoder_weights_from_flax",
           "learnable_params_from_flax", "params_from_flax", "resunet_gan_params_from_flax",
           "spike_layer", "unet_params_from_flax"]
