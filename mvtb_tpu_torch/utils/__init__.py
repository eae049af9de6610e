"""Utilities: profiling, step timing, determinism (counterpart of
mvtb_tpu/utils).

The JAX package's ``enable_compilation_cache`` configures XLA's persistent
compilation cache; PyTorch runs the port eagerly and its kernels are built
once per checkout (``ops/_build.py``), so it has no counterpart here.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.utils.profiling import StepTimer, trace

__all__ = ["StepTimer", "set_determinism", "trace"]


def set_determinism(seed: int = 0, device: DeviceLike = None) -> torch.Generator:
    """Seed host-side randomness (the reference's ``set_determinism(seed=0)``,
    ``baseline.py:70``): Python's ``random``, numpy's global generator and
    PyTorch's (every device), and return a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (None means the card) for the port's draws.

    Transforms that carry their own ``R`` states are seeded separately
    (``set_random_state`` / ``Compose.set_random_state``)."""
    dev = resolve_device(device)
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)
    return torch.Generator(device=dev).manual_seed(seed)
