"""k-space mask geometry (counterpart of mvtb_tpu/ops/masks.py).

Two center conventions, as in the reference, because they give different
masks:

* ``disk_mask`` and the ellipsoid shell center at ``floor(n/2)`` per axis;
* ``gibbs_mask`` and the layer masks center at ``(n - 1) / 2``.

Masks with Python-number parameters are built with numpy exactly as the JAX
package builds them (float64 for the Gibbs distance), so the two are
bit-identical; they come back as numpy arrays. A tensor parameter builds the
same grid in torch float32 on the parameter's device, differentiable where
the mask is (``soft_gibbs_mask``).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

from mvtb_tpu_torch._device import DeviceLike, resolve_device


def _is_concrete(*vals) -> bool:
    return all(isinstance(v, (int, float, np.integer, np.floating)) for v in vals)


def _dist_sq_grid(spatial_shape: Tuple[int, ...], center,
                  device: torch.device) -> torch.Tensor:
    """Squared distance from ``center`` on an integer grid, float32."""
    total = torch.zeros(spatial_shape, dtype=torch.float32, device=device)
    for axis, (n, c) in enumerate(zip(spatial_shape, center)):
        view = [1] * len(spatial_shape)
        view[axis] = n
        coord = torch.arange(n, dtype=torch.float32, device=device).view(view)
        total = total + (coord - c) ** 2
    return total


def _param(value, device: DeviceLike) -> torch.Tensor:
    """A float32 tensor of ``value`` (a float64 tensor stays float64) on its
    own device, or on ``device`` (None: the card) for a Python number."""
    if isinstance(value, torch.Tensor):
        return value.to(torch.promote_types(value.dtype, torch.float32))
    return torch.tensor(float(value), dtype=torch.float32, device=resolve_device(device))


# ---------------------------------------------------------------------------
# Disk (circular / spherical) masks: floor(n/2) center, integer grid
# ---------------------------------------------------------------------------

@lru_cache(maxsize=128)
def _disk_mask_np(spatial_shape: Tuple[int, ...], r: float, inside_off: bool) -> np.ndarray:
    """Exact boolean disk mask over an integer grid (cached per geometry)."""
    center = [n // 2 for n in spatial_shape]
    grids = np.ogrid[tuple(slice(0, n) for n in spatial_shape)]
    dist_sq = sum((g - c) ** 2 for g, c in zip(grids, center))
    inside = dist_sq < float(r) ** 2
    mask = ~inside if inside_off else inside
    return mask


def disk_mask(spatial_shape: Sequence[int], r, inside_off: bool = False):
    """Binary disk/ball mask centered at ``floor(n/2)`` of each axis.

    ``inside_off=False`` keeps radius < r (low-pass), ``True`` keeps
    radius >= r (high-pass). A Python ``r`` gives a float32 numpy array; a
    tensor ``r`` gives a float32 tensor on its device.
    """
    spatial_shape = tuple(int(n) for n in spatial_shape)
    if _is_concrete(r):
        return _disk_mask_np(spatial_shape, float(r), bool(inside_off)).astype(np.float32)
    r = _param(r, None)
    center = [n // 2 for n in spatial_shape]
    inside = _dist_sq_grid(spatial_shape, center, r.device) < r ** 2
    mask = torch.logical_not(inside) if inside_off else inside
    return mask.to(torch.float32)


# ---------------------------------------------------------------------------
# Gibbs mask: (n-1)/2 center, float64 distance (reference GibbsNoise)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=128)
def _gibbs_mask_np(spatial_shape: Tuple[int, ...], alpha: float) -> np.ndarray:
    r = (1.0 - alpha) * np.max(spatial_shape) * np.sqrt(2) / 2.0
    center = (np.array(spatial_shape) - 1) / 2
    coords = np.ogrid[tuple(slice(0, n) for n in spatial_shape)]
    dist = np.sqrt(sum((g - c) ** 2 for g, c in zip(coords, center)))
    return dist <= r


def gibbs_mask(spatial_shape: Sequence[int], alpha):
    """Low-pass mask of ``GibbsNoise``: keep ``dist <= (1-alpha)*max(shape)*sqrt(2)/2``
    from the true center ``(shape-1)/2``; ``alpha=0`` is the identity.

    A Python ``alpha`` gives the float64-built numpy bool mask (bit-parity
    with the reference); a tensor ``alpha`` the float32 bool tensor.
    """
    spatial_shape = tuple(int(n) for n in spatial_shape)
    if _is_concrete(alpha):
        return _gibbs_mask_np(spatial_shape, float(alpha))
    alpha = _param(alpha, None)
    center = [(n - 1) / 2 for n in spatial_shape]
    dist = torch.sqrt(_dist_sq_grid(spatial_shape, center, alpha.device))
    r = (1.0 - alpha) * max(spatial_shape) * math.sqrt(2) / 2.0
    return dist <= r


def _center_dist(spatial_shape: Tuple[int, ...], device) -> torch.Tensor:
    center = [(n - 1) / 2 for n in spatial_shape]
    return torch.sqrt(_dist_sq_grid(spatial_shape, center, device))


def reference_gibbs_layer_mask(spatial_shape: Sequence[int], alpha,
                               device: DeviceLike = None) -> torch.Tensor:
    """The reference ``GibbsNoiseLayer`` mask: 1 where
    ``dist <= alpha * dist.max()``, else 0, from the true center
    ``(n-1)/2``. A hard mask: its gradient in ``alpha`` is zero almost
    everywhere (use :func:`soft_gibbs_mask` to train alpha)."""
    spatial_shape = tuple(int(n) for n in spatial_shape)
    alpha = _param(alpha, device)
    dist = _center_dist(spatial_shape, alpha.device)
    norm_dist = dist / (alpha * torch.max(dist))
    one = torch.ones((), dtype=torch.float32, device=alpha.device)
    return torch.where(norm_dist <= 1.0, one, torch.zeros_like(one))


def soft_gibbs_mask(spatial_shape: Sequence[int], alpha, tau: float = 1.0,
                    device: DeviceLike = None) -> torch.Tensor:
    """Differentiable Gibbs mask ``sigmoid((alpha * dist_max - dist) / tau)``:
    a smooth edge of width ``tau`` voxels around the radius
    ``alpha * dist_max``, so ``alpha`` trains by autograd. As ``tau -> 0``
    it tends to :func:`reference_gibbs_layer_mask`."""
    spatial_shape = tuple(int(n) for n in spatial_shape)
    alpha = _param(alpha, device)
    dist = _center_dist(spatial_shape, alpha.device)
    radius = alpha * torch.max(dist)
    return torch.sigmoid((radius - dist) / tau)


# ---------------------------------------------------------------------------
# Ellipsoid shell: the plane-wave sampling geometry
# ---------------------------------------------------------------------------

@lru_cache(maxsize=32)
def _ellipsoid_shell_np(spatial_shape: Tuple[int, ...], a: float, b: float,
                        c: float) -> np.ndarray:
    """Thin ellipsoid shell: 0.95 < (x/a)^2+(y/b)^2+(z/c)^2 < 1.05.

    floor(n/2) center, per-axis squared offsets divided by the semi-axis
    squared in float32 (the reference's torch default dtype).
    """
    center = [n // 2 for n in spatial_shape]
    grids = np.ogrid[tuple(slice(0, n) for n in spatial_shape)]
    semi = (a, b, c)
    q = np.zeros(spatial_shape, np.float32)
    for g, cen, s in zip(grids, center, semi):
        q = q + ((g - cen) ** 2).astype(np.float32) / np.float32(float(s) ** 2)
    return (q > 0.95) & (q < 1.05)


def ellipsoid_shell_mask(spatial_shape: Sequence[int], a: float, b: float,
                         c: float) -> np.ndarray:
    """Boolean shell mask for plane-wave spike location sampling (3D)."""
    return _ellipsoid_shell_np(tuple(int(n) for n in spatial_shape),
                               float(a), float(b), float(c))


@lru_cache(maxsize=32)
def shell_flat_indices(spatial_shape: Tuple[int, ...], a: float, b: float,
                       c: float) -> np.ndarray:
    """Row-major flat indices of the shell voxels (int64). A uniform pick
    among them is the JAX package's categorical draw over the shell."""
    return np.flatnonzero(ellipsoid_shell_mask(spatial_shape, a, b, c))


def sample_ellipsoid(spatial_shape: Sequence[int], a: float, b: float, c: float,
                     rng: np.random.RandomState) -> Tuple[int, ...]:
    """Uniformly sample one shell voxel on the host: the shell's row-major
    coordinates (``np.argwhere``, the order of ``torch.nonzero``) and one
    ``rng.randint`` draw, as the reference does."""
    coords = np.argwhere(ellipsoid_shell_mask(spatial_shape, a, b, c))
    idx = rng.randint(0, len(coords))
    return tuple(int(v) for v in coords[idx])
