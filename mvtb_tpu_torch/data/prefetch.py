"""Host -> device prefetch (counterpart of mvtb_tpu/data/prefetch.py):
overlap the copy of the next batches with the current step's compute.

On a CUDA device each numpy or CPU-tensor leaf is copied into pinned host
memory and sent with ``non_blocking=True``, so the copy is queued behind
the step already on the stream and the host goes on. A ring of ``size``
batches is kept in flight.
"""

from __future__ import annotations

from collections import deque
from itertools import islice
from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch

from mvtb_tpu_torch._device import DeviceLike, resolve_device


def _put(tree: Any, dev: torch.device, sharding) -> Any:
    """Every array leaf of a (nested) tuple, list or dict, as a tensor on
    ``dev``: the leaf's block under ``sharding``, or all of it."""
    if isinstance(tree, dict):
        return {k: _put(v, dev, sharding) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_put(v, dev, sharding) for v in tree)
    t = tree if isinstance(tree, torch.Tensor) else torch.as_tensor(np.asarray(tree))
    if sharding is not None:
        t = sharding.block(t)
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def device_prefetch(iterator: Iterable, size: int = 2, device: DeviceLike = None,
                    sharding: Optional[object] = None) -> Iterator:
    """Yield the items of ``iterator`` as tensors on ``device`` (None means
    ``"cuda"``), with ``size`` items already sent ahead of use.

    Items may be arrays or tensors, or (nested) tuples, lists or dicts of
    them. ``sharding`` (a :class:`~mvtb_tpu_torch.parallel.mesh.
    NamedSharding`, e.g. ``batch_sharding(mesh, ndim)``) sends each leaf's
    block of this process instead: its rows of a global batch.
    """
    if size < 1:
        raise ValueError(f"size must be at least 1, got {size}")
    dev = resolve_device(device)
    it = iter(iterator)
    buf = deque(_put(item, dev, sharding) for item in islice(it, size))
    while buf:
        out = buf.popleft()
        buf.extend(_put(item, dev, sharding) for item in islice(it, 1))
        yield out
