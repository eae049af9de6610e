"""``monai.utils`` names: set_determinism, NumpyPadMode."""

from __future__ import annotations

import enum
import random

import numpy as np
import torch


def set_determinism(seed: int = 0, additional_settings=None) -> None:
    """Seed every generator a reference script draws from
    (``baseline.py:70``): Python's ``random``, numpy's global generator
    (the loaders' shuffles), PyTorch's, and the port's shared
    ``Randomizable`` default stream."""
    from mvtb_tpu_torch.transforms.base import Randomizable

    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)
    Randomizable.R = np.random.RandomState(seed % (2 ** 32))
    if additional_settings is not None:
        for fn in np.atleast_1d(additional_settings):
            fn(seed)


class NumpyPadMode(enum.Enum):
    """The part of MONAI's pad-mode enum the GAN data modules use."""

    CONSTANT = "constant"
    EDGE = "edge"
    REFLECT = "reflect"
    WRAP = "wrap"

    def __str__(self):
        return self.value
