"""TCGA institutional-distribution pipelines + hold-out-hospital evaluation
(counterpart of mvtb_tpu/data/tcga.py).

Reference structure (``10_scripts/300_instutional_distribution/
baseline_domain.py:95-175``): per-modality manifest sequences ->
0.9/0.1 partition (seeded shuffle) -> per-modality datasets with the
whole-tumor pipeline (AddChannel, WholeTumorTCGA, Spacing(1.5,1.5,2.0), RAS,
crop 128x128x64, nonzero-normalize) -> concatenated; held-out-hospital
loaders come from separate manifests (``tcga_data.py:131-181``). The
evaluation notebooks report in-distribution vs held-out Dice and the
normalized generalization gap.

Real TCGA volumes are not present here; ``synthetic_hospital_samples``
generates per-"hospital" domains with distinct intensity statistics so the
domain-shift machinery (training, hold-out eval, gap tables) is exercised
end-to-end. Every generator and split draws from numpy ``RandomState``
only, so for the same seed the arrays equal the JAX package's bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from mvtb_tpu_torch.data.pipeline import Loader
from mvtb_tpu_torch.data.preprocess import (
    CenterSpatialCropd,
    NormalizeIntensityd,
    Orientationd,
    RandFlipd,
    RandScaleIntensityd,
    RandShiftIntensityd,
    RandSpatialCropd,
    Spacingd,
    ToTensord,
)
from mvtb_tpu_torch.data.synthetic import _band_noise, _box_smooth, _smooth_noise
from mvtb_tpu_torch.transforms import Compose, WholeTumorTCGA
from mvtb_tpu_torch.transforms.array import _to_numpy
from mvtb_tpu_torch.transforms.base import MapTransform


class AddChanneld(MapTransform):
    """Prepend a channel axis (MONAI ``AddChanneld``)."""

    def __call__(self, data):
        d = dict(data)
        for key in self.key_iterator(d):
            d[key] = _to_numpy(d[key])[None]
        return d


def tcga_train_pipeline(roi_size: Sequence[int] = (128, 128, 64),
                        pixdim: Sequence[float] = (1.5, 1.5, 2.0)) -> Compose:
    """Whole-tumor training preprocessing (``baseline_domain.py:97-117``)."""
    return Compose([
        AddChanneld(keys="image"),
        WholeTumorTCGA(keys="label"),
        Spacingd(keys=["image", "label"], pixdim=pixdim,
                 mode=("bilinear", "nearest")),
        Orientationd(keys=["image", "label"], axcodes="RAS"),
        RandSpatialCropd(keys=["image", "label"], roi_size=roi_size),
        RandFlipd(keys=["image", "label"], prob=0.5, spatial_axis=0),
        NormalizeIntensityd(keys="image", nonzero=True, channel_wise=True),
        RandScaleIntensityd(keys="image", factors=0.1, prob=0.5),
        RandShiftIntensityd(keys="image", offsets=0.1, prob=0.5),
        ToTensord(keys=["image", "label"]),
    ])


def tcga_val_pipeline(roi_size: Sequence[int] = (128, 128, 64),
                      pixdim: Sequence[float] = (1.5, 1.5, 2.0)) -> Compose:
    """Whole-tumor validation preprocessing (``baseline_domain.py:119-135``)."""
    return Compose([
        AddChanneld(keys="image"),
        WholeTumorTCGA(keys="label"),
        Spacingd(keys=["image", "label"], pixdim=pixdim,
                 mode=("bilinear", "nearest")),
        Orientationd(keys=["image", "label"], axcodes="RAS"),
        CenterSpatialCropd(keys=["image", "label"], roi_size=roi_size),
        NormalizeIntensityd(keys="image", nonzero=True, channel_wise=True),
        ToTensord(keys=["image", "label"]),
    ])


def partition_dataset(seq: List, ratios: Sequence[float] = (0.9, 0.1),
                      shuffle: bool = True, seed: int = 0) -> Tuple[List, List]:
    """MONAI ``partition_dataset`` semantics for two ratios + seeded shuffle."""
    idx = np.arange(len(seq))
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    cut = int(round(len(seq) * ratios[0] / sum(ratios)))
    return [seq[i] for i in idx[:cut]], [seq[i] for i in idx[cut:]]


# ---------------------------------------------------------------------------
# Synthetic hospital domains
# ---------------------------------------------------------------------------

_DOMAIN_PARAMS = {
    # (intensity gain, background offset, tumor contrast, smoothing passes)
    "hospital_A": (1.0, 0.0, 1.5, 2),
    "hospital_B": (1.3, 0.4, 1.1, 1),
    "hospital_C": (0.8, -0.3, 1.9, 3),
    "holdout": (1.6, 0.8, 0.7, 1),  # deliberately far from the training mix
}


def synthetic_hospital_samples(hospital: str, n: int, seed: int,
                               spatial: Tuple[int, ...] = (64, 64, 32)
                               ) -> List[dict]:
    """Whole-tumor samples with hospital-specific acquisition statistics."""
    gain, offset, contrast, passes = _DOMAIN_PARAMS[hospital]
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        grids = np.ogrid[tuple(slice(0, s) for s in spatial)]
        center = [rng.uniform(0.35, 0.65) * s for s in spatial]
        radii = [rng.uniform(0.12, 0.2) * s for s in spatial]
        q = sum(((g - c) / r) ** 2 for g, c, r in zip(grids, center, radii))
        wt = (q < 1.0).astype(np.float32)
        img = _smooth_noise(rng, spatial, passes) * gain + offset + contrast * wt
        img = (img - img.mean()) / (img.std() + 1e-6)
        out.append({"image": img[None].astype(np.float32),
                    "label": wt[None]})
    return out


# Hospital-specific acquisition-texture bands (units of max(shape)/2, the
# disk_mask index-space convention — see synthetic._band_noise). On a
# 128-grid every band lies at index radius >= 0.22*64 ~ 14, entirely outside
# the flagship r=12.5 Gibbs disk, so stylization erases every hospital
# signature — the mechanism behind the reference's institutional-
# distribution experiments (``baseline_domain.py`` vs the
# ``stylized_*_domain`` variants).
_HOSPITAL_BANDS = {
    "hospital_A": (0.22, 0.34),
    "hospital_B": (0.32, 0.44),
    "hospital_C": (0.42, 0.54),
    "holdout": (0.58, 0.74),  # a scanner signature never seen in training
}
# Per-hospital signature amplitude: the held-out scanner is not only in an
# unseen band but louder — a genuinely different acquisition, like the
# reference's fourth institution.
_HOSPITAL_NOISE_AMP = {
    "hospital_A": 0.9,
    "hospital_B": 1.0,
    "hospital_C": 1.1,
    "holdout": 1.4,
}


def textured_hospital_samples(hospital: str, n: int, seed: int,
                              spatial: Tuple[int, ...] = (128, 128, 64)
                              ) -> List[dict]:
    """Whole-tumor samples with a label-INDEPENDENT hospital texture.

    Each hospital's scanner stamps the volume with additive band-limited
    acquisition noise in its own k-band at its own amplitude
    (``_HOSPITAL_BANDS`` / ``_HOSPITAL_NOISE_AMP``); the label cue is a
    low-frequency mean step at the tumor (plus low-k anatomy), identical
    across hospitals. A clean-trained baseline must segment the step THROUGH
    acquisition noise whose statistics shift on the held-out hospital
    (unseen band, higher amplitude) — the corruption-robustness failure the
    reference's T2 family measures. The Gibbs-stylized model's disk filter
    removes every hospital band at train AND eval time, normalizing the
    institutions away, which is exactly the reference's proposed mechanism
    for shrinking the gap.

    Design note: with label-CORRELATED texture bands (tumor texture
    suppressed in the hospital's own band) a baseline learns a generic
    band-agnostic texture-energy detector and generalizes flat, so that
    construction cannot produce the phenomenon (the JAX package's design
    note has its measurement). The domain shift must live in the
    label-independent acquisition statistics, as here.
    """
    band = _HOSPITAL_BANDS[hospital]
    noise_amp = _HOSPITAL_NOISE_AMP[hospital]
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        grids = np.ogrid[tuple(slice(0, s) for s in spatial)]
        center = [rng.uniform(0.35, 0.65) * s for s in spatial]
        radii = [rng.uniform(0.12, 0.22) * s for s in spatial]
        q = sum(((g - c) / r) ** 2 for g, c, r in zip(grids, center, radii))
        warp = _smooth_noise(rng, spatial, passes=6)
        warp /= np.abs(warp).max() + 1e-6
        q = q * (1.0 + 0.25 * warp)
        wt = (q < 1.0).astype(np.float32)

        offset = _box_smooth(0.5 * wt, 2)
        anatomy = 0.6 * _band_noise(rng, spatial, 0.0, 0.12)
        gain = 0.7 + 0.6 * rng.rand()
        img = (anatomy + noise_amp * _band_noise(rng, spatial, *band)
               + gain * offset)
        img = (img - img.mean()) / (img.std() + 1e-6)
        out.append({"image": img[None].astype(np.float32),
                    "label": wt[None]})
    return out


def domain_loaders(batch_size: int = 2, n_per_hospital: int = 8, seed: int = 0,
                   spatial: Tuple[int, ...] = (64, 64, 32),
                   kind: str = "smooth") -> Tuple[Loader, Dict[str, Loader]]:
    """(train loader over 3 hospitals, {name: val loader} incl. holdout).

    ``kind="smooth"`` varies gain/offset/contrast per hospital (the
    machinery check); ``kind="textured"`` varies the acquisition-texture
    band (:func:`textured_hospital_samples`) so the stylization-shrinks-
    the-gap claim is actually falsifiable.
    """
    gen = {"smooth": synthetic_hospital_samples,
           "textured": textured_hospital_samples}[kind]
    train_samples: List[dict] = []
    val_loaders: Dict[str, Loader] = {}
    for i, hospital in enumerate(["hospital_A", "hospital_B", "hospital_C"]):
        samples = gen(hospital, n_per_hospital, seed + i, spatial)
        train, val = partition_dataset(samples, (0.75, 0.25), seed=seed)
        train_samples += train
        val_loaders[hospital] = Loader(val, batch_size=batch_size)
    val_loaders["holdout"] = Loader(
        gen("holdout", max(n_per_hospital // 2, 2), seed + 99, spatial),
        batch_size=batch_size)
    return Loader(train_samples, batch_size=batch_size, shuffle=True,
                  seed=seed), val_loaders


def generalization_gap(eval_dict: Dict[str, float]) -> Dict[str, float]:
    """In-dist mean vs holdout Dice + normalized gap — the quantity the TCGA
    notebooks plot (``TCGA_hospital_distribution_test.ipynb`` cells 13-24)."""
    in_dist = [v for k, v in eval_dict.items() if k != "holdout"]
    in_mean = float(np.mean(in_dist))
    holdout = float(eval_dict["holdout"])
    return {
        "in_dist_mean": in_mean,
        "holdout": holdout,
        "gap": in_mean - holdout,
        "normalized_gap": (in_mean - holdout) / in_mean if in_mean else np.nan,
    }
