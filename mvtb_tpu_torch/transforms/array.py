"""Array-level corruption transforms (counterpart of
mvtb_tpu/transforms/array.py, reference-compatible signatures).

``as_tensor_output=True`` returns a ``torch.Tensor`` on the transform's
device; ``False`` returns ``np.ndarray``. Constructors take ``device=None``,
which means the card (and raises without one); pass ``device="cpu"`` to run
on the CPU. Randomness uses ``np.random.RandomState`` with the reference's
exact draw order, so a seeded transform draws the same parameters as the
JAX package's.

Reference citations: ``source_code/filters_and_operators.py`` (FO),
``50_reconstruction/reconGan/utils2.py`` (U2).
"""

from __future__ import annotations

import warnings
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mvtb_tpu_torch import ops
from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.transforms.base import (
    RandomizableTransform,
    Transform,
    ensure_tuple,
)

ArrayLike = Union[np.ndarray, torch.Tensor]


def _to_tensor(img: ArrayLike, device: torch.device) -> torch.Tensor:
    """``img`` as a tensor on ``device``; float64 becomes float32, as JAX
    without x64 makes it."""
    t = img if isinstance(img, torch.Tensor) else torch.from_numpy(np.asarray(img))
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    return t.to(device)


def _to_numpy(img: ArrayLike) -> np.ndarray:
    return img.detach().cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)


def _format_output(img: torch.Tensor, as_tensor_output: bool) -> ArrayLike:
    return img if as_tensor_output else _to_numpy(img)


class GibbsNoise(Transform):
    """Gibbs ringing via low-pass k-space mask (FO:635-705).

    Args:
        alpha: intensity in [0,1]; 0 is the identity.
        as_tensor_output: True -> torch.Tensor, False -> np.ndarray.
        device: where the op runs; None is the card.
    """

    def __init__(self, alpha: float = 0.5, as_tensor_output: bool = True,
                 device: DeviceLike = None) -> None:
        if alpha > 1 or alpha < 0:
            raise AssertionError("alpha is restricted to the range [0, 1].")
        self.alpha = alpha
        self.as_tensor_output = as_tensor_output
        self.device = resolve_device(device)

    def __call__(self, img: ArrayLike) -> ArrayLike:
        out = ops.gibbs_noise(_to_tensor(img, self.device), self.alpha)
        return _format_output(out, self.as_tensor_output)


class RandGibbsNoise(RandomizableTransform):
    """Random-alpha Gibbs noise (FO:708-768): alpha ~ U[a, b], prob gate."""

    def __init__(self, prob: float = 0.1, alpha: Sequence[float] = (0.0, 1.0),
                 as_tensor_output: bool = True, device: DeviceLike = None) -> None:
        if len(alpha) != 2:
            raise AssertionError("a ranged alpha needs exactly two entries.")
        if alpha[1] > 1 or alpha[0] < 0:
            raise AssertionError("alpha is restricted to the range [0, 1]")
        if alpha[0] > alpha[1]:
            raise AssertionError("a ranged alpha [a, b] requires a < b.")
        self.alpha = alpha
        self.sampled_alpha = -1.0
        self.as_tensor_output = as_tensor_output
        self.device = resolve_device(device)
        RandomizableTransform.__init__(self, prob=prob)

    def _randomize(self, _: Any) -> None:
        # Same draw order as the reference (FO:762-768): prob gate then alpha.
        super().randomize(None)
        self.sampled_alpha = self.R.uniform(self.alpha[0], self.alpha[1])

    def __call__(self, img: ArrayLike) -> ArrayLike:
        self._randomize(None)
        if self._do_transform:
            return GibbsNoise(self.sampled_alpha, self.as_tensor_output, self.device)(img)
        return _format_output(_to_tensor(img, self.device), self.as_tensor_output)


class KSpaceSpikeNoise(Transform):
    """Fixed-location k-space spikes (Herringbone artifact, FO:846-983).

    ``loc`` is one index tuple or a sequence of them; length ``n_dims`` tuples
    broadcast over channels, length ``n_dims+1`` tuples pin a channel.
    ``k_intensity`` defaults to 2.5x the per-channel mean log-magnitude.
    """

    def __init__(self, loc: Union[Tuple, Sequence[Tuple]],
                 k_intensity: Optional[Union[Sequence[float], float]] = None,
                 as_tensor_output: bool = True, device: DeviceLike = None):
        self.loc = ensure_tuple(loc)
        self.k_intensity = k_intensity
        self.as_tensor_output = as_tensor_output
        self.device = resolve_device(device)

        if isinstance(k_intensity, Sequence):
            if not isinstance(loc[0], Sequence):
                raise AssertionError(
                    "a sequence of k_intensity values requires loc to be a "
                    "matching sequence of location tuples"
                )
            if len(k_intensity) != len(loc):
                raise AssertionError(
                    "k_intensity and loc must pair up one-to-one (one value per location tuple)."
                )
        if isinstance(self.loc[0], Sequence) and k_intensity is not None:
            if not isinstance(self.k_intensity, Sequence):
                raise AssertionError(
                    "k_intensity and loc must pair up one-to-one (one value per location tuple)."
                )

    def __call__(self, img: ArrayLike) -> ArrayLike:
        if len(img.shape) < 3:
            raise AssertionError("expected channel-first input with at least (C, H, W) axes.")
        x = _to_tensor(img, self.device)
        n_dims = x.ndim - 1
        self._check_indices(x)

        if isinstance(self.loc[0], Sequence):
            locs: List[Tuple[int, ...]] = [tuple(l) for l in self.loc]
            vals: List[Any] = list(ensure_tuple(self.k_intensity))
        else:
            locs = [tuple(self.loc)]
            if self.k_intensity is None:
                # Data-dependent default: 2.5x per-channel mean log-|k| (FO:932-933).
                stats = ops.default_spike_intensity_stats(x, n_dims)
                if len(self.loc) == x.ndim:
                    vals = [stats[self.loc[0]]]
                else:
                    vals = [stats]  # per-channel vector broadcast at the loc
            else:
                vals = [self.k_intensity]

        # Fill any remaining None intensities with the per-channel default.
        if any(v is None for v in vals):
            stats = ops.default_spike_intensity_stats(x, n_dims)
            vals = [
                (stats[l[0]] if len(l) == x.ndim else stats) if v is None else v
                for v, l in zip(vals, locs)
            ]

        out = ops.kspace_spike(x, locs, vals, n_dims)
        return _format_output(out, self.as_tensor_output)

    def _check_indices(self, img) -> None:
        loc = [l if isinstance(l, Sequence) else self.loc for l in
               (self.loc if isinstance(self.loc[0], Sequence) else [self.loc])]
        padded = [[0] * (len(img.shape) - len(l)) + list(l) for l in loc]
        for i in range(len(img.shape)):
            if img.shape[i] <= max(x[i] for x in padded):
                raise AssertionError(
                    f"spike location axis {i} exceeds the image extent "
                    f"(loc = {self.loc}, image shape = {tuple(img.shape)})."
                )


class RandKSpaceSpikeNoise(RandomizableTransform):
    """Random k-space spikes (FO:986-1131).

    Samples per-channel (``channel_wise=True``) or shared locations uniformly
    over the full k-grid and log-intensities from ``intensity_range``
    (default: ``(0.95x, 1.10x)`` of each channel's mean log-magnitude),
    reproducing the reference's RandomState draw order exactly
    (one ``rand`` gate per channel, one ``randint`` per spatial dim, one
    ``uniform`` per intensity — FO:1087-1103).
    """

    def __init__(self, prob: float = 0.1,
                 intensity_range: Optional[Sequence[Union[Sequence[float], float]]] = None,
                 channel_wise: bool = True, as_tensor_output: bool = True,
                 device: DeviceLike = None):
        self.intensity_range = intensity_range
        self.channel_wise = channel_wise
        self.as_tensor_output = as_tensor_output
        self.device = resolve_device(device)
        self.sampled_k_intensity: List = []
        self.sampled_locs: List[Tuple] = []
        if intensity_range is not None:
            if isinstance(intensity_range[0], Sequence) and not channel_wise:
                raise AssertionError(
                    "with channel_wise=False, intensity_range must be a single "
                    "(low, high) pair or None."
                )
        super().__init__(prob)

    def __call__(self, img: ArrayLike) -> ArrayLike:
        x = _to_tensor(img, self.device)
        if self.intensity_range is not None:
            if isinstance(self.intensity_range[0], Sequence) and \
                    len(self.intensity_range) != x.shape[0]:
                raise AssertionError(
                    "per-channel intensity_range needs exactly one (low, high) "
                    "pair per input channel."
                )

        self.sampled_k_intensity = []
        self.sampled_locs = []

        intensity_range = self._make_sequence(x)
        self._randomize(x, intensity_range)

        if self.sampled_locs:
            t = KSpaceSpikeNoise(self.sampled_locs, self.sampled_k_intensity,
                                 self.as_tensor_output, self.device)
            return t(x)
        return _format_output(x, self.as_tensor_output)

    def _randomize(self, img: torch.Tensor, intensity_range) -> None:
        if self.channel_wise:
            for i in range(img.shape[0]):
                super().randomize(None)
                if self._do_transform:
                    self.sampled_locs.append(
                        (i,) + tuple(self.R.randint(0, k) for k in img.shape[1:])
                    )
                    self.sampled_k_intensity.append(
                        self.R.uniform(intensity_range[i][0], intensity_range[i][1])
                    )
        else:
            super().randomize(None)
            if self._do_transform:
                spatial = tuple(self.R.randint(0, k) for k in img.shape[1:])
                self.sampled_locs = [(i,) + spatial for i in range(img.shape[0])]
                if isinstance(intensity_range[0], Sequence):
                    self.sampled_k_intensity = [self.R.uniform(p[0], p[1])
                                                for p in intensity_range]
                else:
                    self.sampled_k_intensity = [
                        self.R.uniform(intensity_range[0], intensity_range[1])
                    ] * img.shape[0]

    def _make_sequence(self, x: torch.Tensor) -> Sequence[Sequence[float]]:
        if self.intensity_range is not None:
            if not isinstance(self.intensity_range[0], Sequence):
                return (ensure_tuple(self.intensity_range),) * x.shape[0]
            return ensure_tuple(self.intensity_range)
        # Default range (0.95x, 1.10x) of per-channel mean log-|k| (FO:1118-1131).
        stats = _to_numpy(ops.default_spike_intensity_stats(x))
        return tuple((float(i) * 0.95, float(i) * 1.1) for i in stats)


class WrapArtifact(Transform):
    """Wraparound/aliasing artifact (FO:488-537): odd k-lines scaled by alpha."""

    def __init__(self, alpha: float = 0.5, device: DeviceLike = None):
        self.alpha = alpha
        self.device = resolve_device(device)

    def __call__(self, img: ArrayLike) -> torch.Tensor:
        x = _to_tensor(img, self.device)
        return ops.wrap_artifact(x, self.alpha, x.ndim - 1)


class RandZF(Transform):
    """Random zero-fill k-space undersampling (U2:34-74).

    The reference drew its mask from torch's global RNG; here the mask comes
    from a per-instance ``np.random.RandomState`` (documented divergence —
    same distribution, different stream). Use ``set_random_state`` to seed.
    """

    def __init__(self, p: float = 0, device: DeviceLike = None):
        self.p = min(max(0, p), 1.0)
        if p < 0 or p > 1:
            warnings.warn(f"Setting p to {self.p}.")
        self.R = np.random.RandomState()
        self.device = resolve_device(device)

    def set_random_state(self, seed: Optional[int] = None) -> "RandZF":
        self.R = np.random.RandomState(seed)
        return self

    def __call__(self, img: ArrayLike) -> torch.Tensor:
        x = _to_tensor(img, self.device)
        u = torch.from_numpy(self.R.rand(*x.shape).astype(np.float32))
        return ops.rand_zero_fill(x, self.p, u=u.to(self.device), n_dims=x.ndim - 1)
