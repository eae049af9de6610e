"""Sliding-window inference over large volumes (counterpart of
mvtb_tpu/eval/sliding_window.py).

MONAI's ``sliding_window_inference`` (used by the reference's TCGA
evaluation notebooks, SURVEY.md section 2.4): tile the volume with an
overlapping grid, run the network over tiles in chunks, and blend with
constant or Gaussian importance weighting. The grid, the importance map and
the blend normalizer are built on the host in float32 numpy, as the JAX
package builds them.
"""

from __future__ import annotations

import operator
from functools import partial
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mvtb_tpu_torch._device import DeviceLike, resolve_device


def _grid_positions(size: int, roi: int, overlap: float) -> Tuple[int, ...]:
    """Start offsets covering [0, size) with ~overlap between tiles."""
    if size <= roi:
        return (0,)
    step = max(int(roi * (1.0 - overlap)), 1)
    starts = list(range(0, size - roi + 1, step))
    if starts[-1] != size - roi:
        starts.append(size - roi)
    return tuple(starts)


def _gaussian_importance(roi: Sequence[int], sigma_scale: float = 0.125) -> np.ndarray:
    """Separable Gaussian importance map (MONAI's BlendMode.GAUSSIAN)."""
    out = np.ones(tuple(roi), np.float32)
    for axis, n in enumerate(roi):
        center = (n - 1) / 2.0
        sigma = max(n * sigma_scale, 1e-3)
        g = np.exp(-0.5 * ((np.arange(n) - center) / sigma) ** 2).astype(np.float32)
        g = np.maximum(g, g.max() * 1e-3)  # avoid zero weights at borders
        shape = [1] * len(roi)
        shape[axis] = n
        out = out * g.reshape(shape)
    return out


def _chunking(total: int, tile_batch: int) -> Tuple[int, int]:
    """``(chunk, n_chunks)``: the largest divisor of ``total`` up to
    ``tile_batch`` (no padded forwards), or ``tile_batch`` with a padded
    last chunk when that divisor would underfill it by more than half."""
    tile_batch = max(1, min(tile_batch, total))
    chunk = max(d for d in range(1, tile_batch + 1) if total % d == 0)
    if chunk * 2 < tile_batch and total > tile_batch:
        chunk = tile_batch
    return chunk, -(-total // chunk)


@torch.no_grad()
def sliding_window_inference(
    image,
    roi_size: Sequence[int],
    model: torch.nn.Module,
    *,
    overlap: float = 0.25,
    mode: str = "constant",
    out_channels: int | None = None,
    tile_batch: int = 8,
    low_memory: bool | None = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Tiled inference on a channel-first ``(B, C, *spatial)`` volume
    (tensor or numpy), on ``device`` (None means ``"cuda"``).

    ``model`` maps channel-first tiles ``(chunk, C, *roi)`` to logits
    ``(chunk, oc, *roi)``. Returns float32 logits ``(B, oc, *spatial)``. A
    volume smaller than the ROI on an axis is zero-padded up to it and the
    output cropped back.

    Tiles are flattened into the batch axis (tile ``k`` is grid position
    ``k // B``, batch row ``k % B``) and run up to ``tile_batch`` per
    forward: the largest divisor of ``T * B`` up to ``tile_batch``, or
    ``tile_batch`` with a zero-padded last chunk when that divisor would
    underfill it by more than half (the padded tiles' logits are dropped).
    Per-sample ops (convs, instance norm) make this equal to the per-tile
    loop; batch-coupled ops (train-mode BatchNorm) would couple the tiles of
    a chunk, as MONAI's ``sw_batch_size`` does.

    In eager PyTorch one schedule serves both of the JAX package's: each
    chunk is forwarded, then blended into the float32 accumulator in grid
    order, so the peak holds one chunk's logits plus the accumulator.
    ``low_memory`` is kept for the JAX signature; both values run this
    schedule.
    """
    del low_memory  # one schedule; see the docstring
    try:
        tile_batch = operator.index(tile_batch)
    except TypeError:
        raise TypeError("tile_batch must be a Python int") from None
    dev = resolve_device(device)
    image = torch.as_tensor(image).to(dev)
    nd = len(roi_size)
    roi = tuple(int(r) for r in roi_size)
    spatial = tuple(image.shape[2:])
    if len(spatial) != nd:
        raise ValueError(f"roi rank {nd} != spatial rank {len(spatial)}")

    # pad up to roi when the volume is smaller (F.pad lists the last axis first)
    pads = [max(r - s, 0) for r, s in zip(roi, spatial)]
    if any(pads):
        image = F.pad(image, [p for pad in reversed(pads) for p in (0, pad)])
    padded = tuple(image.shape[2:])

    grids = [_grid_positions(padded[d], roi[d], overlap) for d in range(nd)]
    positions = [()]
    for axis_starts in grids:
        positions = [p + (s,) for p in positions for s in axis_starts]
    T = len(positions)

    importance_np = (_gaussian_importance(roi) if mode == "gaussian"
                     else np.ones(roi, np.float32))
    # the blend normalizer depends only on the grid: built on the host
    norm_np = np.zeros(padded, np.float32)
    for pos in positions:
        norm_np[tuple(slice(s, s + r) for s, r in zip(pos, roi))] += importance_np
    importance = torch.from_numpy(importance_np).to(dev)
    norm = torch.from_numpy(norm_np).to(dev)

    B, C = image.shape[:2]
    total = T * B
    chunk, n_chunks = _chunking(total, tile_batch)

    def tile(k):
        t, b = divmod(k, B)
        sl = tuple(slice(s, s + r) for s, r in zip(positions[t], roi))
        return image[(b, slice(None)) + sl]

    out = None
    for c in range(n_chunks):
        ks = range(c * chunk, min((c + 1) * chunk, total))
        tiles = torch.stack([tile(k) for k in ks])
        if len(ks) < chunk:  # the padded last chunk: zero tiles, dropped below
            tiles = torch.cat([tiles, tiles.new_zeros((chunk - len(ks),) + tiles.shape[1:])])
        logits = model(tiles).float()
        if out is None:
            oc = logits.shape[1] if out_channels is None else out_channels
            out = torch.zeros((B, oc) + padded, dtype=torch.float32, device=dev)
        for j, k in enumerate(ks):
            t, b = divmod(k, B)
            sl = (b, slice(None)) + tuple(slice(s, s + r) for s, r in zip(positions[t], roi))
            out[sl] += logits[j] * importance
    out = out / norm
    return out[(slice(None), slice(None)) + tuple(slice(0, s) for s in spatial)]


def make_sliding_window_fn(roi_size: Sequence[int], model: torch.nn.Module,
                           overlap: float = 0.25, mode: str = "constant",
                           tile_batch: int = 8, low_memory: bool | None = None,
                           device: DeviceLike = None):
    """:func:`sliding_window_inference` with its tiling bound:
    ``fn(image)``."""
    return partial(sliding_window_inference, roi_size=tuple(roi_size), model=model,
                   overlap=overlap, mode=mode, tile_batch=tile_batch,
                   low_memory=low_memory, device=device)
