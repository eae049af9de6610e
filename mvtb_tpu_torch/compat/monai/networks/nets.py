"""``monai.networks.nets.UNet``: the port's UNet under MONAI's constructor.

Takes both the MONAI 0.4 (``dimensions=``) and 0.5+ (``spatial_dims=``)
spellings the reference scripts use (``baseline.py:198-205``). The module
is :class:`mvtb_tpu_torch.models.unet3d.UNet` itself: NCDHW, float32
parameters on ``device`` (None: the card), moved by ``.to(device)``, and
trained by the reference's own loop (``optimizer.zero_grad(); loss =
loss_function(model(x), y); loss.backward(); optimizer.step()``).

``state_dict`` has the port's names. ``load_state_dict`` (on the UNet or on
a module holding it) also takes the flax-keyed dict the JAX shim saves
(``"ResidualUnit_0/ConvNormAct_0/Conv_0/kernel"``-style names), converted
by :func:`mvtb_tpu_torch.models.convert.unet_params_from_flax`, so a JAX
shim checkpoint loads here.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from mvtb_tpu_torch._device import DeviceLike
from mvtb_tpu_torch.models.convert import unet_params_from_flax
from mvtb_tpu_torch.models.unet3d import UNet as _PortUNet


def _from_flax_keys(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A flax-keyed flat dict (``"a/b/kernel"``) -> the port's state_dict."""
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else value
    return unet_params_from_flax(tree)


class UNet(_PortUNet):
    def __init__(self, dimensions: Optional[int] = None,
                 in_channels: int = 1, out_channels: int = 1,
                 channels: Sequence[int] = (16, 32, 64, 128, 256),
                 strides: Sequence[int] = (2, 2, 2, 2),
                 num_res_units: int = 0, spatial_dims: Optional[int] = None,
                 kernel_size: int = 3, up_kernel_size: int = 3,
                 act: str = "PRELU", norm: str = "INSTANCE",
                 dropout: float = 0.0, device: DeviceLike = None):
        nd = spatial_dims if spatial_dims is not None else dimensions
        if nd not in (None, 3):
            raise NotImplementedError("the port's UNet is 3D")
        if dropout:
            raise NotImplementedError("the reference never uses dropout")
        if (kernel_size, up_kernel_size) != (3, 3) or (str(act).upper(), str(norm).upper()) != (
                "PRELU", "INSTANCE"):
            raise NotImplementedError("the reference's UNet: kernel 3, PReLU, instance norm")
        super().__init__(in_channels, out_channels, channels, strides, num_res_units,
                         device=device)
        self.spatial_dims = 3
        self.in_channels = int(in_channels)
        self.out_channels = int(out_channels)

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict,
                              missing_keys, unexpected_keys, error_msgs):
        """Convert flax-keyed entries under ``prefix`` before the submodules
        read theirs (``load_state_dict`` loads a module before its
        children, from the same dict)."""
        flax = {k[len(prefix):]: state_dict.pop(k) for k in list(state_dict)
                if k.startswith(prefix) and "/" in k[len(prefix):]}
        if flax:
            for k, v in _from_flax_keys(flax).items():
                state_dict[prefix + k] = v
        super()._load_from_state_dict(state_dict, prefix, local_metadata, strict,
                                      missing_keys, unexpected_keys, error_msgs)
