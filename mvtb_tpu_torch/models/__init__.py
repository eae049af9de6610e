"""Models of the port (counterpart of mvtb_tpu/models)."""

from mvtb_tpu_torch.models.convert import unet_params_from_flax
from mvtb_tpu_torch.models.unet3d import UNet

__all__ = ["UNet", "unet_params_from_flax"]
