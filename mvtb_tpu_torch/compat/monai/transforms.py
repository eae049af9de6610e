"""``monai.transforms`` names, backed by the port's transform stack.

Covers the union of the ``from monai.transforms import (...)`` lists of the
reference's T1/T2 script templates and evaluation notebooks
(``baseline.py:27-43``, ``baseline_domain.py``,
``20_results/30_planes_waves/compare.py:14-30``). ``ToTensord`` makes CPU
torch tensors; ``Activations`` and ``AsDiscrete`` work on tensors on any
device (the reference applies them to the model's output on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from mvtb_tpu_torch.data.nifti import read_nifti
from mvtb_tpu_torch.data.preprocess import (  # noqa: F401
    AsChannelFirstd,
    CenterSpatialCropd,
    EnsureChannelFirstd,
    NormalizeIntensityd,
    Orientationd,
    RandFlipd,
    RandScaleIntensityd,
    RandShiftIntensityd,
    RandSpatialCropd,
    Spacingd,
)
from mvtb_tpu_torch.transforms.array import _to_numpy
from mvtb_tpu_torch.transforms.base import (  # noqa: F401
    Compose,
    MapTransform,
    Randomizable,
    RandomizableTransform,
    ReCompose,
    Transform,
)


class LoadImaged(MapTransform):
    """Load NIfTI paths into arrays (``monai.transforms.LoadImaged``): each
    path under ``keys`` becomes its voxel array; the image affine goes to
    ``"affine"`` (read by ``Spacingd``/``Orientationd``) and a
    ``{key}_meta_dict`` carries MONAI's meta layout."""

    def __call__(self, data):
        d = dict(data)
        for key in self.key_iterator(d):
            arr, affine = read_nifti(str(d[key]))
            d[key] = arr
            d[f"{key}_meta_dict"] = {"affine": affine,
                                     "original_affine": affine.copy()}
            d.setdefault("affine", affine)
        return d


class AddChanneld(MapTransform):
    """Prepend a channel axis (``monai.transforms.AddChanneld``)."""

    def __call__(self, data):
        d = dict(data)
        for key in self.key_iterator(d):
            d[key] = _to_numpy(d[key])[None]
        return d


class ToTensord(MapTransform):
    """Arrays to CPU torch tensors (``monai.transforms.ToTensord``), so the
    reference's ``batch["image"].to(device)`` moves them to the card."""

    def __call__(self, data):
        d = dict(data)
        for key in self.key_iterator(d):
            v = d[key]
            d[key] = v.cpu() if isinstance(v, torch.Tensor) else torch.as_tensor(
                np.ascontiguousarray(v))
        return d


class Activations:
    """Sigmoid or softmax over the channels of a channel-first batch
    (``baseline.py:262-264``'s post_trans), on the input's device."""

    def __init__(self, sigmoid: bool = False, softmax: bool = False, other=None):
        self.sigmoid = sigmoid
        self.softmax = softmax
        self.other = other

    def __call__(self, img) -> torch.Tensor:
        x = torch.as_tensor(img).to(torch.float32)
        if self.sigmoid:
            x = 1.0 / (1.0 + torch.exp(-x))
        if self.softmax:
            x = torch.softmax(x, dim=1)
        if self.other is not None:
            x = self.other(x)
        return x


class AsDiscrete:
    """Threshold or argmax discretization. Takes both the MONAI 0.4/0.5
    spelling (``threshold_values=True, logit_thresh=0.5``) and the later
    one (``threshold=0.5``)."""

    def __init__(self, argmax: bool = False, to_onehot=None,
                 threshold_values: bool = False, logit_thresh: float = 0.5,
                 threshold=None, n_classes=None):
        self.argmax = argmax
        self.to_onehot = to_onehot if to_onehot not in (False, None) else None
        self.n_classes = n_classes
        if threshold is not None:
            threshold_values, logit_thresh = True, float(threshold)
        self.threshold_values = threshold_values
        self.logit_thresh = logit_thresh

    def __call__(self, img) -> torch.Tensor:
        x = torch.as_tensor(img).to(torch.float32)
        if self.argmax:
            x = torch.argmax(x, dim=1, keepdim=True).to(torch.float32)
        if self.to_onehot is not None or self.n_classes is not None:
            n = int(self.to_onehot if self.to_onehot is not None else self.n_classes)
            x = torch.movedim(torch.nn.functional.one_hot(x[:, 0].long(), n), -1, 1)
            x = x.to(torch.float32)
        if self.threshold_values:
            x = (x >= self.logit_thresh).to(torch.float32)
        return x
