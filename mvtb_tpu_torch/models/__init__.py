"""Models of the port (counterpart of mvtb_tpu/models)."""

from mvtb_tpu_torch.models.convert import (dcgan_params_from_flax,
                                           fid_encoder_weights_from_flax,
                                           learnable_params_from_flax, params_from_flax,
                                           resunet_gan_params_from_flax,
                                           unet_params_from_flax)
from mvtb_tpu_torch.models.dcgan import Discriminator, Generator
from mvtb_tpu_torch.models.layers import (GibbsNoiseLayer, GibbsUNet, Gibbs_UNet, SpikeLayer,
                                          SpikesUNet, Spikes_UNet, spike_layer)
from mvtb_tpu_torch.models.resunet_gan import ResUnetDiscriminator, ResUnetGenerator
from mvtb_tpu_torch.models.unet3d import UNet

__all__ = ["Discriminator", "Generator", "GibbsNoiseLayer", "GibbsUNet", "Gibbs_UNet",
           "ResUnetDiscriminator", "ResUnetGenerator", "SpikeLayer", "SpikesUNet",
           "Spikes_UNet", "UNet", "dcgan_params_from_flax", "fid_encoder_weights_from_flax",
           "learnable_params_from_flax", "params_from_flax", "resunet_gan_params_from_flax",
           "spike_layer", "unet_params_from_flax"]
