"""Import-path shim: ``filters_and_operators`` as the reference scripts use
it (counterpart of mvtb_tpu/compat/filters_and_operators.py).

Experiment scripts do ``sys.path.append(SOURCE_CODE_PATH)`` then ``from
filters_and_operators import ...`` (``baseline.py:60-66``). With
``mvtb_tpu_torch/compat`` on ``sys.path`` those imports resolve against the
port's transforms, with the same class names and constructor signatures;
the k-space transforms also take the port's ``device=`` (None: the card).
The reference's class-style helpers (``disk_mask``, ``ellipsoid``,
``Fourier``) are thin wrappers over the port's ops.
"""

from __future__ import annotations

import numpy as np
import torch

from mvtb_tpu_torch import ops
from mvtb_tpu_torch.transforms import (  # noqa: F401  (the re-exported API)
    Compose,
    ConvertToMultiChannelBasedOnBratsClassesd,
    GibbsNoise,
    KSpaceSpikeNoise,
    MapTransform,
    RandFourierDiskMaskd,
    RandGibbsNoise,
    RandGibbsNoised,
    RandKSpaceSpikeNoise,
    RandKSpaceSpikeNoised,
    RandPlaneWaves_ellipsoid,
    Randomizable,
    RandomizableTransform,
    SaltAndPepper,
    SegmentationSlicesd,
    SelectChanneld,
    Transform,
    WholeTumorTCGA,
    WrapArtifact,
    WrapArtifactd,
    ensure_tuple,
)


class Fourier:
    """Static centered-FFT helpers (the reference's ``Fourier`` mixin), on
    the device of their input."""

    @staticmethod
    def shift_fourier(x, n_dims: int) -> torch.Tensor:
        return ops.fft_shifted(torch.as_tensor(x), n_dims)

    @staticmethod
    def inv_shift_fourier(k, n_dims: int) -> torch.Tensor:
        return ops.ifft_shifted_real(torch.as_tensor(k), n_dims)


class disk_mask:
    """Object-style disk mask (the reference's API: build from a k tensor,
    then ``.apply``). Prefer :func:`mvtb_tpu_torch.ops.disk_mask` in new
    code."""

    def __init__(self, k_tensor, r: float = 2, dim: int = 2, inside_off=True):
        self.r = r
        self.dim = dim
        self.inside_off = inside_off
        self.last_dims = k_tensor.shape[-1]
        spatial = tuple(k_tensor.shape[-dim:])
        mask = np.asarray(ops.disk_mask(spatial, r, inside_off))
        self.binary_mask = np.broadcast_to(mask, tuple(k_tensor.shape))

    def apply(self, k_tensor) -> torch.Tensor:
        if k_tensor.shape[-1] != self.last_dims:
            raise ValueError(f"Last dimension of input must be = {self.last_dims}")
        k = torch.as_tensor(k_tensor)
        mask = torch.as_tensor(np.ascontiguousarray(self.binary_mask),
                               dtype=k.real.dtype, device=k.device)
        return k * mask


class ellipsoid(Randomizable):
    """Object-style ellipsoid shell sampler (the reference's API)."""

    def __init__(self, a: float, b: float, c: float):
        self.a, self.b, self.c = a, b, c

    def binary_mask_3d(self, k_tensor) -> np.ndarray:
        spatial = tuple(k_tensor.shape[-3:])
        mask = ops.ellipsoid_shell_mask(spatial, self.a, self.b, self.c)
        return np.broadcast_to(mask.astype(np.float32), tuple(k_tensor.shape))

    def sample_ellipsoid(self, k_tensor):
        return ops.sample_ellipsoid(tuple(k_tensor.shape[-3:]), self.a, self.b,
                                    self.c, rng=self.R)
