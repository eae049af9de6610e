"""2D slice extraction for the GAN datamodules (counterpart of
mvtb_tpu/data/slices.py).

Reference components: ``Sliced`` (``50_reconstruction/brats_data.py:60-80``)
takes one random axial slice ``c ~ randint(25, 35)`` of a channel-first
volume; ``RandConcatd`` (``reconGan/brats_data.py:61-83``) takes channel 0's
random slice and duplicates it into 2 channels (the ReconGAN G/D are
2-channel nets fed a duplicated slice). Both follow the MONAI Randomizable
protocol so seeded streams reproduce.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from mvtb_tpu_torch.transforms.array import _to_numpy
from mvtb_tpu_torch.transforms.base import MapTransform, Randomizable


class Sliced(MapTransform, Randomizable):
    """Random axial slice ``[:, :, :, c]`` with ``c ~ randint(25, 35)``."""

    def __init__(self, keys, seed: Optional[int] = None,
                 allow_missing_keys: bool = False):
        Randomizable.set_random_state(self, seed=seed)
        MapTransform.__init__(self, keys, allow_missing_keys)

    def __call__(self, data):
        d = dict(data)
        c = self.R.randint(25, 35)
        for key in self.key_iterator(d):
            d[key] = _to_numpy(d[key])[:, :, :, c]
        return d


class RandConcatd(MapTransform, Randomizable):
    """Channel 0's random slice duplicated into two channels."""

    def __init__(self, keys, seed: Optional[int] = None,
                 allow_missing_keys: bool = False):
        Randomizable.set_random_state(self, seed=seed)
        MapTransform.__init__(self, keys, allow_missing_keys)

    def __call__(self, data):
        d = dict(data)
        c = self.R.randint(25, 35)
        for key in self.key_iterator(d):
            s = _to_numpy(d[key])[0, :, :, c][None]
            d[key] = np.concatenate([s, s], axis=0)
        return d
