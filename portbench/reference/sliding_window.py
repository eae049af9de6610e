"""Plain sliding-window inference with constant blending (MONAI's
``sliding_window_inference(overlap=0.25, mode="constant")``): tiles start
every ``int(roi * (1 - overlap))`` voxels on each axis, the last one flush
with the end; overlapping logits are averaged."""

from __future__ import annotations

import itertools
from typing import Callable, List, Sequence, Tuple

import torch


def starts(size: int, roi: int, overlap: float) -> List[int]:
    if size <= roi:
        return [0]
    step = max(int(roi * (1.0 - overlap)), 1)
    out = list(range(0, size - roi + 1, step))
    if out[-1] != size - roi:
        out.append(size - roi)
    return out


def tile_origins(spatial: Sequence[int], roi: Sequence[int],
                 overlap: float) -> List[Tuple[int, ...]]:
    """Tile origins in grid order (the last axis fastest)."""
    return list(itertools.product(*(starts(n, r, overlap) for n, r in zip(spatial, roi))))


def infer(image: torch.Tensor, roi: Sequence[int], tile_logits: Callable,
          overlap: float = 0.25, block: int = 4):
    """``(logits (1, oc, *spatial), tiles (T, oc, *roi))`` of one (1, C,
    *spatial) volume; ``tile_logits`` maps (n, C, *roi) tiles to float32
    logits, called on ``block`` tiles at a time."""
    spatial = tuple(image.shape[2:])
    origins = tile_origins(spatial, roi, overlap)

    def sl(o):
        return tuple(slice(s, s + r) for s, r in zip(o, roi))

    tiles = []
    for i in range(0, len(origins), block):
        x = torch.cat([image[(slice(None), slice(None)) + sl(o)]
                       for o in origins[i:i + block]])
        tiles.append(tile_logits(x).float())
    tiles = torch.cat(tiles)
    acc = torch.zeros((1, tiles.shape[1]) + spatial, device=image.device)
    cnt = torch.zeros((1, 1) + spatial, device=image.device)
    for t, o in zip(tiles, origins):
        acc[(0, slice(None)) + sl(o)] += t
        cnt[(0, slice(None)) + sl(o)] += 1.0
    return acc / cnt, tiles
