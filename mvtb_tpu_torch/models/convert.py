"""flax parameter tree -> state_dict of :class:`~.unet3d.UNet`.

The caller hands over the flax ``params`` tree as nested dicts of numpy
arrays (fetched to the host on its side). The same mapping serves every
tree with the structure of the parameters: gradients, and the optimizer's
``mu``, ``nu`` and ``nu_max``. Module names are the same on both sides;
the leaves map as

* conv ``kernel`` (k, k, k, Cin, Cout) -> ``weight`` (Cout, Cin, k, k, k);
* transposed-conv ``kernel`` -> ``weight`` (Cin, Cout, k, k, k), flipped in
  space (PyTorch's transposed conv is the adjoint of its conv);
* ``bias`` -> ``bias``; PReLU ``negative_slope`` () -> ``weight`` (1,).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _leaf(path: str, key: str, value: np.ndarray, parent: str):
    a = np.array(value, dtype=np.float32, copy=True)  # keeps 0-d arrays 0-d
    if parent.startswith("ConvTranspose") and key == "kernel":
        a = np.flip(a, axis=(0, 1, 2)).transpose(3, 4, 0, 1, 2)
        return f"{path}weight", a
    if key == "kernel":
        return f"{path}weight", a.transpose(4, 3, 0, 1, 2)
    if key == "negative_slope":
        return f"{path}weight", a.reshape(1)
    if key == "bias":
        return f"{path}bias", a
    raise KeyError(f"unexpected flax leaf {path}{key}")


def unet_params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Convert a flax ``UNet`` params tree (``variables["params"]``, numpy
    leaves) into a state_dict for :class:`~mvtb_tpu_torch.models.unet3d.UNet`
    of the same configuration. Load it with ``load_state_dict(strict=True)``.
    A gradient or moment tree of the same structure maps the same way (the
    map is a per-leaf transpose, flip or reshape)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: str, parent: str):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}.", k)
            else:
                name, a = _leaf(prefix, k, v, parent)
                out[name] = torch.from_numpy(np.ascontiguousarray(a))

    walk(params, "", "")
    return out

