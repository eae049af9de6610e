"""flax parameter trees -> state_dicts of the port's models.

The caller hands over a flax tree as nested dicts of numpy arrays (fetched
to the host on its side). The same mapping serves every tree with the
structure of the parameters: gradients, and the optimizer's moments
(``mu``, ``nu``, ``nu_max``). Module names are the same on both sides; the
leaves map by rank, 2D and 3D alike:

* conv ``kernel`` (*k, Cin, Cout) -> ``weight`` (Cout, Cin, *k);
* transposed-conv ``kernel`` -> ``weight`` (Cin, Cout, *k), flipped in
  space (PyTorch's transposed conv is the adjoint of its conv);
* ``bias`` -> ``bias``; PReLU ``negative_slope`` () -> ``weight`` (1,);
* BatchNorm ``scale`` -> ``weight`` (``bias`` as above), and its
  ``batch_stats`` ``mean`` / ``var`` -> the ``running_mean`` /
  ``running_var`` buffers.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch


def _leaf(path: str, key: str, value: np.ndarray, parent: str):
    a = np.array(value, dtype=np.float32, copy=True)  # keeps 0-d arrays 0-d
    if key == "kernel":
        nd = a.ndim - 2
        space = tuple(range(nd))
        if parent.startswith("ConvTranspose"):
            return f"{path}weight", np.flip(a, axis=space).transpose(nd, nd + 1, *space)
        return f"{path}weight", a.transpose(nd + 1, nd, *space)
    if key == "negative_slope":
        return f"{path}weight", a.reshape(1)
    if key == "bias":
        return f"{path}bias", a
    if key == "scale":
        return f"{path}weight", a
    if key == "mean":
        return f"{path}running_mean", a
    if key == "var":
        return f"{path}running_var", a
    raise KeyError(f"unexpected flax leaf {path}{key}")


def _walk(tree: Mapping, out: Dict[str, torch.Tensor], prefix: str = "",
          parent: str = "") -> Dict[str, torch.Tensor]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            _walk(v, out, f"{prefix}{k}.", k)
        else:
            name, a = _leaf(prefix, k, v, parent)
            out[name] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def params_from_flax(params: Mapping, batch_stats: Optional[Mapping] = None
                     ) -> Dict[str, torch.Tensor]:
    """Convert a flax ``params`` tree (and, for a model with BatchNorm, its
    ``batch_stats``) into a state_dict of the port's model of the same
    configuration; load it with ``load_state_dict(strict=True)``. A gradient
    or moment tree of the same structure maps the same way, without
    ``batch_stats`` (the map is a per-leaf transpose, flip or reshape)."""
    out = _walk(params, {})
    if batch_stats is not None:
        _walk(batch_stats, out)
    return out


def unet_params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``UNet`` params tree -> state_dict of
    :class:`~mvtb_tpu_torch.models.unet3d.UNet`."""
    return params_from_flax(params)


def dcgan_params_from_flax(params: Mapping, batch_stats: Optional[Mapping] = None
                           ) -> Dict[str, torch.Tensor]:
    """A flax DCGAN ``Generator`` or ``Discriminator`` tree (with its
    ``batch_stats``) -> state_dict of :mod:`.dcgan`'s module."""
    return params_from_flax(params, batch_stats)


def resunet_gan_params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``ResUnetGenerator`` or ``ResUnetDiscriminator`` tree ->
    state_dict of :mod:`.resunet_gan`'s module."""
    return params_from_flax(params)


def fid_encoder_weights_from_flax(params: Mapping) -> Sequence[torch.Tensor]:
    """The JAX ``FrozenFeatureEncoder``'s params (``{"params": {"Conv_i":
    {"kernel"}}}`` or the inner tree) -> the list of conv weights that
    :class:`~mvtb_tpu_torch.eval.fid.FrozenFeatureEncoder` takes."""
    tree = params.get("params", params)
    sd = params_from_flax(tree)
    return [sd[f"Conv_{i}.weight"] for i in range(len(tree))]


def learnable_params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``GibbsUNet`` (``{"gibbs": {"alpha"}, "unet": ...}``) or
    ``SpikesUNet`` (``{"spike": {"intensity"}, "unet": ...}``) params tree
    -> state_dict of :mod:`.layers`' module of the same name."""
    out = {f"unet.{k}": v for k, v in unet_params_from_flax(params["unet"]).items()}
    for layer, leaf in (("gibbs", "alpha"), ("spike", "intensity")):
        if layer in params:
            out[f"{layer}.{leaf}"] = torch.from_numpy(
                np.array(params[layer][leaf], dtype=np.float32, copy=True).reshape(1))
    return out
