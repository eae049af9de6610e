"""Dictionary-based transforms (counterpart of
mvtb_tpu/transforms/dictionary.py, reference-compatible signatures).

The constructor signatures and randomization semantics of the reference's
dict transforms (``source_code/filters_and_operators.py``, FO), so
``10_scripts``-style experiment specs rerun unchanged; a seeded transform
draws what the JAX package's draws. The k-space transforms take
``device=None`` (the card; pass ``device="cpu"`` for the CPU) and return
tensors there; the label and channel utilities work on numpy arrays.

.. note:: **Parity path, not the performance path.** Each transform does
   its own FFT round trip per key per call, as the reference does; the
   salt & pepper and zero-fill fields are drawn on the host from the
   transform's ``RandomState``. Training runs the fused engine
   (``mvtb_tpu_torch.ops.fused.stylize_batch``) instead.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Hashable, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from mvtb_tpu_torch import ops
from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.transforms.array import (
    GibbsNoise,
    RandKSpaceSpikeNoise,
    WrapArtifact,
    _format_output,
    _to_numpy,
    _to_tensor,
)
from mvtb_tpu_torch.transforms.base import (
    KeysCollection,
    MapTransform,
    Randomizable,
    RandomizableTransform,
)


# ---------------------------------------------------------------------------
# Label / channel utilities
# ---------------------------------------------------------------------------

class SelectChanneld(MapTransform):
    """Keep one channel of channel-first data per key (FO:25-58).

    ``chan_num`` may be an int (same channel for all keys) or a tuple with one
    entry per key; the channel axis is kept.
    """

    def __init__(self, keys, chan_num: Union[int, Sequence[int]],
                 allow_missing_keys: bool = False):
        self.chan_num = chan_num
        super().__init__(keys, allow_missing_keys)

    def __call__(self, data):
        d = dict(data)
        if isinstance(self.chan_num, Sequence):
            if len(self.chan_num) > 1:
                for i, key in zip(self.chan_num, self.key_iterator(d)):
                    if d[key].shape[0] - 1 < i:
                        raise AssertionError(
                            f"channel index {i} out of range for key '{key}' "
                            f"(only {d[key].shape[0]} channels present)"
                        )
                    d[key] = d[key][i][None]
            else:
                for key in self.key_iterator(d):
                    d[key] = d[key][self.chan_num[0]][None]
        else:
            for key in self.key_iterator(d):
                d[key] = d[key][self.chan_num][None]
        return d


class ConvertToMultiChannelBasedOnBratsClassesd(MapTransform):
    """BraTS labels 1/2/3 -> 3-channel one-hot {TC=2|3, WT=1|2|3, ET=2} (FO:61-87)."""

    def __call__(self, data):
        d = dict(data)
        for key in self.keys:
            lbl = _to_numpy(d[key])
            tc = np.logical_or(lbl == 2, lbl == 3)
            wt = np.logical_or(tc, lbl == 1)
            et = lbl == 2
            d[key] = np.stack([tc, wt, et], axis=0).astype(np.float32)
        return d


class WholeTumorTCGA(MapTransform):
    """TCGA segmentation -> binary whole-tumor mask with channel axis (FO:90-101)."""

    def __call__(self, data):
        d = dict(data)
        for key in self.key_iterator(d):
            d[key] = (_to_numpy(d[key]) != 0)[None].astype(np.float32)
        return d


# ---------------------------------------------------------------------------
# k-space corruption dict transforms
# ---------------------------------------------------------------------------

class RandFourierDiskMaskd(RandomizableTransform, MapTransform):
    """Disk mask on the FT of the given keys (FO:210-279).

    The reference's radius sampling quirk is kept: when ``r`` is a list,
    the *first* ``randomize()`` replaces it with a single uniform draw which
    then stays fixed for the life of the transform (FO:254-261 mutates
    ``self.r``), rather than resampling per call.
    """

    def __init__(self, keys: Union[str, List[str]], r: Union[float, List[float]] = float("inf"),
                 inside_off: bool = False, prob: float = 0.5,
                 allow_missing_keys: bool = False, device: DeviceLike = None) -> None:
        assert 0 <= prob <= 1, "prob must take values in [0,1]"
        self.r = r
        self.inside_off = inside_off
        self.device = resolve_device(device)
        MapTransform.__init__(self, keys, allow_missing_keys)
        RandomizableTransform.__init__(self, prob=prob)

    def randomize(self, data: Any = None) -> None:
        super().randomize(None)
        if type(self.r) == list:
            self.r = self.R.uniform(self.r[0], self.r[1])

    def __call__(self, data):
        d = dict(data)
        self.randomize()
        if not self._do_transform:
            return d
        for key in self.key_iterator(d):
            x = _to_tensor(d[key], self.device)
            d[key] = ops.fourier_disk_filter(x, self.r, 3, self.inside_off)
        return d


class RandPlaneWaves_ellipsoid(RandomizableTransform, MapTransform):
    """Plane-wave spike at a random point on an ellipsoid k-shell (FO:355-414).

    Per applied key, one shell voxel is drawn uniformly (``R.randint`` over the
    shell's nonzero coordinates, row-major — same order as the reference) and
    the log-magnitude there is set to ``intensity_value`` across all channels.
    """

    def __init__(self, keys: Union[str, List[str]] = "image", a: float = 10,
                 b: float = 10, c: float = 10, intensity_value: float = 1,
                 prob: float = 0.2, allow_missing_keys: bool = False,
                 device: DeviceLike = None):
        MapTransform.__init__(self, keys, allow_missing_keys)
        RandomizableTransform.__init__(self, prob=prob)
        self.abc = (a, b, c)
        self.intensity_value = intensity_value
        self.idx = None
        self.device = resolve_device(device)

    def __call__(self, data):
        d = dict(data)
        self.randomize(None)
        if not self._do_transform:
            return d
        for key in self.key_iterator(d):
            x = _to_tensor(d[key], self.device)
            self.idx = ops.sample_ellipsoid(x.shape[1:], *self.abc, rng=self.R)
            d[key] = ops.plane_wave(x, self.idx, self.intensity_value, 3)
        return d


class SaltAndPepper(MapTransform, RandomizableTransform):
    """Salt-and-pepper impulse noise (FO:419-482).

    ``p`` is the corrupted-voxel fraction (0 = identity). The uniform field
    comes from this transform's ``R`` on the host (the reference used
    torch's global RNG — documented stream divergence, same distribution);
    ``ops.pallas_kernels.salt_and_pepper_pallas`` makes it on the card
    instead.
    """

    def __init__(self, p: float = 0, keys: Union[str, List[str]] = "image",
                 prob: float = 1.0, allow_missing_keys: bool = False,
                 device: DeviceLike = None):
        self.p = min(max(0, p), 1.0)
        if p < 0 or p > 1:
            warnings.warn(f"Setting p to {self.p}.")
        self.device = resolve_device(device)
        MapTransform.__init__(self, keys, allow_missing_keys)
        RandomizableTransform.__init__(self, prob=prob)

    def __call__(self, data):
        d = dict(data)
        self.randomize(None)
        if not self._do_transform:
            return d
        for key in self.key_iterator(d):
            x = _to_tensor(d[key], self.device)
            u = torch.from_numpy(self.R.rand(*x.shape).astype(np.float32))
            d[key] = ops.salt_and_pepper(x, self.p, u=u.to(self.device))
        return d


class WrapArtifactd(MapTransform):
    """Dictionary version of :class:`~mvtb_tpu_torch.transforms.array.WrapArtifact` (FO:540-560)."""

    def __init__(self, keys: KeysCollection, alpha: float = 0.5,
                 allow_missing_keys: bool = False, device: DeviceLike = None):
        MapTransform.__init__(self, keys, allow_missing_keys)
        self.transform = WrapArtifact(alpha, device)

    def __call__(self, data):
        d = dict(data)
        for key in self.key_iterator(d):
            d[key] = self.transform(d[key])
        return d


class SegmentationSlicesd(MapTransform, Randomizable):
    """Extract 3 consecutive slices containing a nontrivial segmentation (FO:563-589).

    Rejection-samples ``c in [3, 60)`` until the label at slices ``c +/- 3``
    is present, then returns slices ``c:c+3`` transposed to channel-first.
    """

    def __init__(self, keys, seed: Optional[int] = None, allow_missing_keys: bool = False):
        Randomizable.set_random_state(self, seed=seed)
        MapTransform.__init__(self, keys, allow_missing_keys)

    def __call__(self, data):
        d = dict(data)
        label = _to_numpy(d["label"])
        while True:
            c = self.R.randint(3, 60)
            if label[0, :, :, c - 3].max() == label[0, :, :, c + 3].max() == 1:
                break
        for key in self.key_iterator(d):
            arr = _to_numpy(d[key])[0][:, :, c:c + 3]
            d[key] = np.swapaxes(arr, 0, 2)
        return d


class MultimodalSlicesd(MapTransform, Randomizable):
    """Pick one modality channel at random per sample; fix the label channel.

    Reproduces the inline transform of the ``_3modalities`` scripts
    (``10_scripts/127_gibbs_spikes_wraparound_sap_OneChannel/
    baseline_3modalities.py:73-101``): ``image`` keeps one channel drawn
    uniformly (via ``R.choice``) from ``img_chan_indices``; ``label`` keeps
    channel ``label_idx``; both keep the channel axis.
    """

    def __init__(self, keys, img_chan_indices: Sequence[int] = (0,),
                 label_idx: int = 0, seed: Optional[int] = None,
                 allow_missing_keys: bool = False):
        Randomizable.set_random_state(self, seed=seed)
        MapTransform.__init__(self, keys, allow_missing_keys)
        self.img_chan_indices = list(img_chan_indices)
        self.label_idx = label_idx

    def __call__(self, data):
        d = dict(data)
        c = self.R.choice(self.img_chan_indices)
        for key in self.key_iterator(d):
            if key == "image":
                d[key] = _to_numpy(d[key])[c][None]
            elif key == "label":
                d[key] = _to_numpy(d[key])[self.label_idx][None]
        return d


class RandGibbsNoised(RandomizableTransform, MapTransform):
    """Dictionary version of RandGibbsNoise (FO:771-843); one sampled alpha
    is shared across all transformed keys."""

    def __init__(self, keys: KeysCollection, prob: float = 0.1,
                 alpha: Sequence[float] = (0.0, 1.0), as_tensor_output: bool = True,
                 allow_missing_keys: bool = False, device: DeviceLike = None) -> None:
        MapTransform.__init__(self, keys, allow_missing_keys)
        RandomizableTransform.__init__(self, prob=prob)
        self.alpha = alpha
        self.sampled_alpha = -1.0
        self.as_tensor_output = as_tensor_output
        self.device = resolve_device(device)

    def _randomize(self, _: Any) -> None:
        super().randomize(None)
        self.sampled_alpha = self.R.uniform(self.alpha[0], self.alpha[1])

    def __call__(self, data):
        d = dict(data)
        self._randomize(None)
        transform = None
        for i, key in enumerate(self.key_iterator(d)):
            if self._do_transform:
                if i == 0:
                    transform = GibbsNoise(self.sampled_alpha, self.as_tensor_output,
                                           self.device)
                d[key] = transform(d[key])
            else:
                d[key] = _format_output(_to_tensor(d[key], self.device),
                                        self.as_tensor_output)
        return d


class RandKSpaceSpikeNoised(RandomizableTransform, MapTransform):
    """Dictionary version of RandKSpaceSpikeNoise (FO:1134-1254).

    Holds one per-key ``RandKSpaceSpikeNoise`` (spike intensity is
    amplitude-dependent); a ``global_prob`` gates the whole dict;
    ``common_sampling``/``common_seed`` re-seed all per-key transforms before
    each call so image and label draw identical spikes.
    """

    def __init__(self, keys: KeysCollection, global_prob: float = 1.0,
                 prob: float = 0.1,
                 intensity_ranges: Optional[Mapping[Hashable, Sequence]] = None,
                 channel_wise: bool = True, common_sampling: bool = False,
                 common_seed: int = 42, as_tensor_output: bool = True,
                 allow_missing_keys: bool = False, device: DeviceLike = None):
        MapTransform.__init__(self, keys, allow_missing_keys)
        RandomizableTransform.__init__(self, global_prob)
        self.common_sampling = common_sampling
        self.common_seed = common_seed
        self.as_tensor_output = as_tensor_output
        self.device = resolve_device(device)
        self.transforms: Dict[Hashable, RandKSpaceSpikeNoise] = {}
        for k in self.keys:
            ranges = intensity_ranges[k] if isinstance(intensity_ranges, Mapping) else None
            self.transforms[k] = RandKSpaceSpikeNoise(
                prob, ranges, channel_wise, self.as_tensor_output, self.device)

    def __call__(self, data):
        d = dict(data)
        super().randomize(None)
        if self.common_sampling:
            for k in self.keys:
                self.transforms[k].set_random_state(self.common_seed)
        for key, t in self.key_iterator(d, self.transforms):
            if self._do_transform:
                d[key] = self.transforms[t](d[key])
            else:
                d[key] = _format_output(_to_tensor(d[key], self.device),
                                        self.as_tensor_output)
        return d

    def set_rand_state(self, seed: Optional[int] = None,
                       state: Optional[np.random.RandomState] = None) -> None:
        self.set_random_state(seed, state)
        for key in self.keys:
            self.transforms[key].set_random_state(seed, state)
