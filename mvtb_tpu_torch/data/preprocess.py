"""MONAI-equivalent preprocessing (counterpart of
mvtb_tpu/data/preprocess.py): spacing resample, RAS orientation, crops,
nonzero-normalization, flips, intensity jitter.

These replicate the reference's preprocessing pipelines
(``baseline.py:116-156`` train, ``utils.py:186-198`` val): LoadImaged ->
AsChannelFirstd -> label conversion -> Spacingd(1.5, 1.5, 2.0) ->
Orientationd(RAS) -> [Rand|Center]SpatialCrop(128,128,64) ->
NormalizeIntensityd(nonzero, channel_wise) [-> RandFlip/ScaleIntensity/
ShiftIntensity], with numpy/scipy on the host (they run once per cached
sample) while the corruption runs on the card. The arithmetic is the JAX
package's, step for step, and the random crops, flips and jitters draw from
each transform's ``RandomState`` in its order, so the same seed gives the
same arrays. A dict transform takes numpy arrays or tensors (an earlier
k-space transform may leave one on the card) and returns numpy.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from mvtb_tpu_torch.transforms.array import _to_numpy
from mvtb_tpu_torch.transforms.base import MapTransform, Randomizable

try:  # scipy is available in this image; gate anyway
    from scipy.ndimage import map_coordinates as _map_coordinates
except Exception:  # pragma: no cover
    _map_coordinates = None


# ---------------------------------------------------------------------------
# Orientation
# ---------------------------------------------------------------------------

_AXCODE_VECTORS = {
    "R": (1, 0, 0), "L": (-1, 0, 0),
    "A": (0, 1, 0), "P": (0, -1, 0),
    "S": (0, 0, 1), "I": (0, 0, -1),
}


def orientation_from_affine(affine: np.ndarray) -> str:
    """Closest axis codes (e.g. 'RAS') of a 4x4 voxel->world affine."""
    codes = []
    for axis in range(3):
        direction = affine[:3, axis]
        best, best_dot = None, -np.inf
        for code, vec in _AXCODE_VECTORS.items():
            d = float(np.dot(direction, vec))
            if d > best_dot:
                best, best_dot = code, d
        codes.append(best)
    return "".join(codes)


def reorient(volume: np.ndarray, affine: np.ndarray, axcodes: str = "RAS"
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Reorient a channel-first volume (C, X, Y, Z) + affine to ``axcodes``.

    Axis permutation/flips only (like nibabel ornt transforms used by
    MONAI's ``Orientationd``).
    """
    current = orientation_from_affine(affine)
    targets = [_AXCODE_VECTORS[c] for c in axcodes]

    # For each target axis, find the source axis whose direction matches best.
    dirs = affine[:3, :3] / (np.linalg.norm(affine[:3, :3], axis=0) + 1e-12)
    perm, flips = [], []
    used = set()
    for tvec in targets:
        dots = [abs(float(np.dot(dirs[:, s], tvec))) if s not in used else -1
                for s in range(3)]
        s = int(np.argmax(dots))
        used.add(s)
        perm.append(s)
        flips.append(float(np.dot(dirs[:, s], tvec)) < 0)

    vol = np.transpose(volume, (0,) + tuple(p + 1 for p in perm))
    new_affine = np.eye(4)
    new_affine[:3, :3] = affine[:3, perm]
    new_affine[:3, 3] = affine[:3, 3]
    for axis, flip in enumerate(flips):
        if flip:
            n = vol.shape[axis + 1]
            vol = np.flip(vol, axis=axis + 1)
            new_affine[:3, 3] = new_affine[:3, 3] + new_affine[:3, axis] * (n - 1)
            new_affine[:3, axis] = -new_affine[:3, axis]
    return np.ascontiguousarray(vol), new_affine


# ---------------------------------------------------------------------------
# Spacing (resampling to target voxel size)
# ---------------------------------------------------------------------------

def zoom_affine(affine: np.ndarray, scale: Sequence[float]) -> np.ndarray:
    """MONAI 0.4/0.5 ``zoom_affine(affine, scale, diagonal=False)``: keep the
    rotation of the input affine, set the column scales to ``scale`` (with
    the signs of the input's diagonal zooms), zero the translation (Spacing
    fills it from the corner offset)."""
    affine = np.asarray(affine, np.float64)
    rzs = affine[:-1, :-1]
    zs = np.linalg.cholesky(rzs.T @ rzs).T
    rotation = rzs @ np.linalg.inv(zs)
    s = np.sign(np.diag(zs)) * np.abs(np.asarray(scale, np.float64))
    new_affine = np.eye(len(affine))
    new_affine[:-1, :-1] = rotation @ np.diag(s)
    return new_affine


def compute_shape_offset(spatial_shape: Sequence[int], in_affine: np.ndarray,
                         out_affine: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """MONAI 0.4/0.5 ``compute_shape_offset``: output shape from the extents
    of the input's CORNER voxels mapped into output voxel coordinates —
    ``round(ptp + 1)`` per axis (np.round = round-half-even) — and the world
    coordinate of the corner that lands at output voxel 0.

    This is the rule the 0.5%-Dice-budget preprocessing parity hangs on: it
    differs from the naive ``ceil(n * old / new)`` (e.g. n=11, 1.0 -> 4.0 mm
    gives 4, not 3).
    """
    shape = np.asarray(spatial_shape, np.float64)
    sr = len(shape)
    in_coords = [(0.0, dim - 1.0) for dim in shape]
    corners = np.asarray(np.meshgrid(*in_coords, indexing="ij")).reshape(sr, -1)
    corners = np.concatenate([corners, np.ones_like(corners[:1])])
    corners_world = np.asarray(in_affine) @ corners
    corners_out = np.linalg.inv(np.asarray(out_affine)) @ corners_world
    corners_out = corners_out[:-1] / corners_out[-1]
    out_shape = np.round(np.ptp(corners_out, axis=1) + 1.0).astype(int)
    offset = None
    for i in range(corners.shape[1]):
        min_corner = np.min(corners_out - corners_out[:, i:i + 1], axis=1)
        if np.allclose(min_corner, 0.0):
            offset = corners_world[:-1, i]  # this corner maps to voxel 0
            break
    if offset is None:  # pragma: no cover — non-axis-aligned rotations only
        offset = corners_world[:-1].mean(axis=1) - (
            np.asarray(out_affine)[:-1, :-1] @ ((out_shape - 1) / 2.0))
    return out_shape, offset


def resample_to_spacing(volume: np.ndarray, affine: np.ndarray,
                        pixdim: Sequence[float], mode: str = "bilinear"
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Resample channel-first (C, X, Y, Z) to target ``pixdim`` spacing,
    pinned to MONAI 0.4/0.5 ``Spacing`` semantics (``baseline.py:122-126``):

    * target affine via :func:`zoom_affine` (rotation kept, scales replaced),
    * output shape + origin via :func:`compute_shape_offset` (corner extents),
    * each output voxel sampled at ``inv(in_affine) @ out_affine @ j`` with
      bilinear (order-1, images) or nearest (labels) interpolation and
      border ('nearest') padding — scipy's equivalent of the torch
      ``grid_sample(padding_mode='border')`` MONAI resamples with.
    """
    if _map_coordinates is None:  # pragma: no cover
        raise RuntimeError("scipy is required for resampling")
    affine = np.asarray(affine, np.float64)
    out_affine = zoom_affine(affine, pixdim)
    out_shape, offset = compute_shape_offset(volume.shape[1:], affine,
                                             out_affine)
    out_affine[:3, 3] = offset

    m = np.linalg.inv(affine) @ out_affine  # output voxel -> input voxel
    order = 1 if mode == "bilinear" else 0

    if volume.ndim == 4:  # native fast path (C++ trilinear, ~10x scipy)
        from mvtb_tpu_torch import native

        nat = native.resample3d(volume, m[:3, :4], out_shape, order)
        if nat is not None:
            return nat.astype(volume.dtype), out_affine

    grids = np.meshgrid(*[np.arange(n, dtype=np.float64) for n in out_shape],
                        indexing="ij")
    pts = np.stack([g.ravel() for g in grids])
    coords = (m[:3, :3] @ pts + m[:3, 3:4]).reshape((3,) + tuple(out_shape))
    out = np.stack([
        _map_coordinates(volume[c].astype(np.float64), coords, order=order,
                         mode="nearest")
        for c in range(volume.shape[0])
    ]).astype(volume.dtype)
    return out, out_affine


# ---------------------------------------------------------------------------
# Crops
# ---------------------------------------------------------------------------

def center_crop(volume: np.ndarray, roi: Sequence[int]) -> np.ndarray:
    """Center crop (pad with zeros when smaller), channel-first."""
    out_shape = tuple(volume.shape[:1]) + tuple(roi)
    out = np.zeros(out_shape, volume.dtype)
    src_slices, dst_slices = [slice(None)], [slice(None)]
    for n, r in zip(volume.shape[1:], roi):
        if n >= r:
            start = (n - r) // 2
            src_slices.append(slice(start, start + r))
            dst_slices.append(slice(0, r))
        else:
            start = (r - n) // 2
            src_slices.append(slice(0, n))
            dst_slices.append(slice(start, start + n))
    out[tuple(dst_slices)] = volume[tuple(src_slices)]
    return out


def rand_crop(volume: np.ndarray, roi: Sequence[int],
              rng: np.random.RandomState) -> np.ndarray:
    """Random spatial crop of fixed size (``RandSpatialCropd(random_size=False)``)."""
    slices = [slice(None)]
    for n, r in zip(volume.shape[1:], roi):
        if n > r:
            start = rng.randint(0, n - r + 1)
            slices.append(slice(start, start + r))
        else:
            slices.append(slice(0, n))
    out = volume[tuple(slices)]
    if out.shape[1:] != tuple(roi):
        out = center_crop(out, roi)
    return out


# ---------------------------------------------------------------------------
# Intensity
# ---------------------------------------------------------------------------

def normalize_nonzero(volume: np.ndarray, channel_wise: bool = True) -> np.ndarray:
    """``NormalizeIntensityd(nonzero=True, channel_wise=True)``: per channel,
    standardize over nonzero voxels only; zeros stay zero."""
    out = volume.astype(np.float32).copy()
    chans = out if channel_wise else out.reshape(1, -1)
    for c in range(out.shape[0] if channel_wise else 1):
        ch = out[c] if channel_wise else out
        mask = ch != 0
        if mask.any():
            mean = ch[mask].mean()
            std = ch[mask].std()
            ch[mask] = (ch[mask] - mean) / max(std, 1e-8)
    del chans
    return out


# ---------------------------------------------------------------------------
# Dict transforms wrapping the above
# ---------------------------------------------------------------------------

class Spacingd(MapTransform):
    def __init__(self, keys, pixdim, mode=("bilinear", "nearest"),
                 allow_missing_keys: bool = False):
        super().__init__(keys, allow_missing_keys)
        self.pixdim = tuple(pixdim)
        self.mode = mode if isinstance(mode, (tuple, list)) else (mode,) * len(self.keys)

    def __call__(self, data):
        d = dict(data)
        affine = np.asarray(d.get("affine", np.eye(4)))
        new_affine = affine
        for key, mode in zip(self.keys, self.mode):
            if key not in d:
                if self.allow_missing_keys:
                    continue
                raise KeyError(key)
            d[key], new_affine = resample_to_spacing(_to_numpy(d[key]), affine,
                                                     self.pixdim, mode)
        d["affine"] = new_affine
        return d


class Orientationd(MapTransform):
    def __init__(self, keys, axcodes: str = "RAS", allow_missing_keys: bool = False):
        super().__init__(keys, allow_missing_keys)
        self.axcodes = axcodes

    def __call__(self, data):
        d = dict(data)
        affine = np.asarray(d.get("affine", np.eye(4)))
        new_affine = affine
        for key in self.key_iterator(d):
            d[key], new_affine = reorient(_to_numpy(d[key]), affine, self.axcodes)
        d["affine"] = new_affine
        return d


class CenterSpatialCropd(MapTransform):
    def __init__(self, keys, roi_size, allow_missing_keys: bool = False):
        super().__init__(keys, allow_missing_keys)
        self.roi_size = tuple(roi_size)

    def __call__(self, data):
        d = dict(data)
        for key in self.key_iterator(d):
            d[key] = center_crop(_to_numpy(d[key]), self.roi_size)
        return d


class RandSpatialCropd(MapTransform, Randomizable):
    def __init__(self, keys, roi_size, random_size: bool = False,
                 allow_missing_keys: bool = False):
        MapTransform.__init__(self, keys, allow_missing_keys)
        if random_size:
            raise NotImplementedError("random_size=True is not used by the reference")
        self.roi_size = tuple(roi_size)

    def __call__(self, data):
        d = dict(data)
        starts = None
        for key in self.key_iterator(d):
            vol = _to_numpy(d[key])
            if starts is None:  # same crop for all keys
                starts = [
                    self.R.randint(0, max(n - r, 0) + 1)
                    for n, r in zip(vol.shape[1:], self.roi_size)
                ]
            slices = [slice(None)] + [slice(s, s + r)
                                      for s, r in zip(starts, self.roi_size)]
            d[key] = center_crop(vol[tuple(slices)], self.roi_size)
        return d


class NormalizeIntensityd(MapTransform):
    def __init__(self, keys, nonzero: bool = True, channel_wise: bool = True,
                 allow_missing_keys: bool = False):
        super().__init__(keys, allow_missing_keys)
        self.nonzero = nonzero
        self.channel_wise = channel_wise

    def __call__(self, data):
        d = dict(data)
        for key in self.key_iterator(d):
            vol = _to_numpy(d[key]).astype(np.float32, copy=False)
            if self.nonzero:
                d[key] = normalize_nonzero(vol, self.channel_wise)
            else:
                mean, std = vol.mean(), max(vol.std(), 1e-8)
                d[key] = (vol - mean) / std
        return d


class RandFlipd(MapTransform, Randomizable):
    def __init__(self, keys, prob: float = 0.5, spatial_axis: int = 0,
                 allow_missing_keys: bool = False):
        MapTransform.__init__(self, keys, allow_missing_keys)
        self.prob = prob
        self.spatial_axis = spatial_axis

    def __call__(self, data):
        d = dict(data)
        if self.R.rand() < self.prob:
            for key in self.key_iterator(d):
                d[key] = np.ascontiguousarray(
                    np.flip(_to_numpy(d[key]), axis=self.spatial_axis + 1))
        return d


class RandScaleIntensityd(MapTransform, Randomizable):
    def __init__(self, keys, factors: float = 0.1, prob: float = 0.5,
                 allow_missing_keys: bool = False):
        MapTransform.__init__(self, keys, allow_missing_keys)
        self.factors = factors
        self.prob = prob

    def __call__(self, data):
        d = dict(data)
        if self.R.rand() < self.prob:
            factor = self.R.uniform(-self.factors, self.factors)
            for key in self.key_iterator(d):
                d[key] = _to_numpy(d[key]) * (1.0 + factor)
        return d


class RandShiftIntensityd(MapTransform, Randomizable):
    def __init__(self, keys, offsets: float = 0.1, prob: float = 0.5,
                 allow_missing_keys: bool = False):
        MapTransform.__init__(self, keys, allow_missing_keys)
        self.offsets = offsets
        self.prob = prob

    def __call__(self, data):
        d = dict(data)
        if self.R.rand() < self.prob:
            offset = self.R.uniform(-self.offsets, self.offsets)
            for key in self.key_iterator(d):
                d[key] = _to_numpy(d[key]) + offset
        return d


class ToTensord(MapTransform):
    """Kept for pipeline-spec compatibility: arrays stay numpy on the host,
    as in the JAX package, and the step moves them to the card."""

    def __call__(self, data):
        d = dict(data)
        for key in self.key_iterator(d):
            d[key] = _to_numpy(d[key])
        return d


class AsChannelFirstd(MapTransform):
    """Move the trailing channel axis to the front (BraTS NIfTI layout)."""

    def __init__(self, keys, channel_dim: int = -1, allow_missing_keys: bool = False):
        super().__init__(keys, allow_missing_keys)
        self.channel_dim = channel_dim

    def __call__(self, data):
        d = dict(data)
        for key in self.key_iterator(d):
            d[key] = np.ascontiguousarray(
                np.moveaxis(_to_numpy(d[key]), self.channel_dim, 0))
        return d


class EnsureChannelFirstd(MapTransform):
    """Add a leading channel axis when missing (labels)."""

    def __call__(self, data):
        d = dict(data)
        for key in self.key_iterator(d):
            arr = _to_numpy(d[key])
            if arr.ndim == 3:
                arr = arr[None]
            d[key] = arr
        return d
