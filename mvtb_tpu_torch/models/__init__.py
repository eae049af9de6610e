"""Models of the port (counterpart of mvtb_tpu/models), and
:func:`build_seg_model`, the segmentation model of a run by name: ``"unet"``
(the reference's 3D ResUNet), ``"swin_unetr"`` (:class:`SwinUNETR`) or
``"segmamba"`` (:class:`SegMamba`), the last two models the JAX package
does not have. What a run needs to know of a segmenter's published shape
lives here too, in one entry of ``SEG_ARCHS`` a model: its crop and the
most crops a step of it takes (:func:`seg_run_config`, :func:`seg_widths`)."""

import dataclasses
from typing import NamedTuple, Optional, Tuple

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
from mvtb_tpu_torch.models.segmamba import SegMamba
from mvtb_tpu_torch.models.swin_unetr import SwinUNETR
from mvtb_tpu_torch.models.unet3d import UNet

class SegArch(NamedTuple):
    """A segmenter a run can train. ``crop`` is the published crop of a
    model trained at its published widths, and ``max_batch`` the most crops
    a step of it takes: what one replica holds on an 80 GB card without
    activation checkpointing (a ``fast`` profile's batch of 16 is cut to
    it). Both are ``None`` for the config's own UNet, which trains at the
    config's crop, batch and widths."""
    model: type
    crop: Optional[Tuple[int, int, int]] = None
    max_batch: Optional[int] = None


SEG_ARCHS = {"unet": SegArch(UNet),
             "swin_unetr": SegArch(SwinUNETR, (128, 128, 128), 4),
             "segmamba": SegArch(SegMamba, (128, 128, 128), 2)}


def seg_arch(arch: str) -> SegArch:
    """``SEG_ARCHS[arch]``, or a ``ValueError`` naming the choices."""
    if arch not in SEG_ARCHS:
        raise ValueError(f"unknown segmentation model {arch!r}; one of {sorted(SEG_ARCHS)}")
    return SEG_ARCHS[arch]


def build_seg_model(arch: str = "unet", in_channels: int = 4, out_channels: int = 3, *,
                    device=None, dtype: torch.dtype = torch.float32, **widths):
    """The segmentation model ``arch`` (a key of ``SEG_ARCHS``), channel-first
    logits in ``dtype`` with float32 parameters, initialised from PyTorch's
    generator; ``widths`` are the model's own (``UNet``: ``channels``,
    ``strides``, ``num_res_units``; ``SwinUNETR``: ``feature_size``,
    ``depths``, ``num_heads``, ``window_size``; ``SegMamba``:
    ``feature_size``, ``depths``, ``hidden_size``, ``d_state``, ``d_conv``,
    ``expand``, ``num_slices``), its published ones by default."""
    return seg_arch(arch).model(in_channels, out_channels, device=device, dtype=dtype,
                                **widths)


def seg_run_config(cfg, arch: str):
    """A segmentation config as ``arch`` trains it: the config itself for
    the UNet; else renamed ``<name>_<arch>``, on the model's published crop
    and at most its ``max_batch`` crops a step. Raises for an unknown
    ``arch``, and for another model on a config of another kind."""
    spec = seg_arch(arch)
    if spec.crop is None:
        return cfg
    if cfg.kind != "segmentation":
        raise ValueError(f"arch={arch!r} applies to segmentation configs only "
                         f"({cfg.name} is kind={cfg.kind!r})")
    return dataclasses.replace(cfg, name=f"{cfg.name}_{arch}", spatial=spec.crop,
                               batch_size=min(cfg.batch_size, spec.max_batch))


def seg_widths(cfg, arch: str) -> dict:
    """The widths :func:`build_seg_model` takes for a run: the config's
    UNet's, or none (the model's published ones)."""
    if seg_arch(arch).crop is None:
        return dict(channels=cfg.channels, strides=cfg.strides,
                    num_res_units=cfg.num_res_units)
    return {}


__all__ = ["SEG_ARCHS", "Discriminator", "Generator", "GibbsNoiseLayer", "GibbsUNet",
           "Gibbs_UNet", "ResUnetDiscriminator", "ResUnetGenerator", "SegArch", "SegMamba",
           "SpikeLayer", "SpikesUNet", "Spikes_UNet", "SwinUNETR", "UNet", "build_seg_model",
           "dcgan_params_from_flax", "fid_encoder_weights_from_flax",
           "learnable_params_from_flax", "params_from_flax", "resunet_gan_params_from_flax",
           "seg_arch", "seg_run_config", "seg_widths", "spike_layer", "unet_params_from_flax"]
