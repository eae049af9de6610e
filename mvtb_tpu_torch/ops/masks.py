"""k-space mask geometry (counterpart of mvtb_tpu/ops/masks.py).

Only the ellipsoid shell that the plane-wave stage samples from is ported so
far. It is built with numpy exactly as the JAX package builds it, so the two
masks are bit-identical.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np


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
