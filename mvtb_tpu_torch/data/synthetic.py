"""Synthetic BraTS-like data (counterpart of mvtb_tpu/data/synthetic.py):
smooth multi-channel "MRI" volumes with blob tumors and nested 3-class
labels (TC in WT, ET in TC, the label topology of
``ConvertToMultiChannelBasedOnBratsClassesd``), and textured volumes whose
label signal lives in high-k texture.

The generators draw from numpy ``RandomState`` only, so for the same seed
they give the JAX package's arrays bit for bit. They serve as the test and
smoke vehicle (the reference's datasets live on a private cluster) and as
the experiment runner's input when no dataset root is configured, and
fill the on-disk Decathlon and TCGA trees (``build_decathlon_tree``,
``build_tcga_tree``) in the reference's NIfTI layouts.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Iterator, Optional, Tuple

import numpy as np

from mvtb_tpu_torch.data.nifti import write_nifti

# generate_pool's default cache directory, resolved at call time
# (tempfile.gettempdir() may probe the file system)
_DEFAULT_CACHE = object()


def _smooth_noise(rng: np.random.RandomState, shape, passes: int = 2) -> np.ndarray:
    """Cheap separable box-smoothing of white noise (no scipy dependency)."""
    x = rng.randn(*shape).astype(np.float32)
    for _ in range(passes):
        for ax in range(x.ndim):
            x = (x + np.roll(x, 1, ax) + np.roll(x, -1, ax)) / 3.0
    return x


def make_volume(rng: np.random.RandomState, channels: int = 4,
                spatial: Tuple[int, ...] = (128, 128, 64),
                n_classes: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """One sample: (image (C, *spatial) float32 ~ N(0,1)ish, label one-hot
    (n_classes, *spatial) float32 with nested tumor regions)."""
    grids = np.ogrid[tuple(slice(0, n) for n in spatial)]
    center = [rng.uniform(0.3, 0.7) * n for n in spatial]
    radii = [rng.uniform(0.10, 0.22) * n for n in spatial]
    q = sum(((g - c) / r) ** 2 for g, c, r in zip(grids, center, radii))
    wt = q < 1.0
    tc = q < 0.55
    et = q < 0.25

    image = np.stack([
        _smooth_noise(rng, spatial) + 1.5 * wt.astype(np.float32) * (0.5 + 0.5 * rng.rand())
        for _ in range(channels)
    ])
    image = (image - image.mean(axis=tuple(range(1, image.ndim)), keepdims=True)) / (
        image.std(axis=tuple(range(1, image.ndim)), keepdims=True) + 1e-6
    )
    if n_classes == 3:
        label = np.stack([tc, wt, et]).astype(np.float32)
    elif n_classes == 1:
        label = wt[None].astype(np.float32)
    else:
        raise ValueError("n_classes must be 1 or 3")
    return image.astype(np.float32), label


def _box_smooth(x: np.ndarray, passes: int = 2) -> np.ndarray:
    """Separable 3-tap box smoothing (tapers sharp region edges)."""
    for _ in range(passes):
        for ax in range(x.ndim):
            x = (x + np.roll(x, 1, ax) + np.roll(x, -1, ax)) / 3.0
    return x


def _band_noise(rng: np.random.RandomState, shape,
                lo: float, hi: float) -> np.ndarray:
    """Unit-variance white noise band-passed to the radial band ``[lo, hi)``
    in *voxel-index* units scaled by ``M = max(shape)/2`` — the same
    spherical index-space geometry the reference's ``disk_mask`` uses, so a
    disk filter of radius ``r`` voxels removes the band iff ``r < lo * M``.
    """
    x = rng.randn(*shape).astype(np.float32)
    k = np.fft.rfftn(x)
    grids = np.meshgrid(*[np.fft.fftfreq(n) * n for n in shape[:-1]]
                        + [np.fft.rfftfreq(shape[-1]) * shape[-1]],
                        indexing="ij")
    r = np.sqrt(sum(g * g for g in grids)) / (max(shape) / 2.0)
    y = np.fft.irfftn(k * ((r >= lo) & (r < hi)), s=shape,
                      axes=tuple(range(len(shape))))
    return (y / (y.std() + 1e-6)).astype(np.float32)


# Radial band (units of max(shape)/2 voxels) carrying the tumor-texture
# signal. On a (128, 128, 64) grid this is index radius [14, 27] — entirely
# OUTSIDE the r=12.5 Gibbs disk, so the reference's flagship stylization
# erases it (larger radii erase progressively less, as on real MRI).
_TEXTURE_BAND = (0.22, 0.42)
# Per-region texture amplitudes: healthy tissue is texture-rich; tumor
# compartments progressively texture-suppressed ("solid" core) — the local
# high-band energy is the strongest label cue on clean data.
_TEX_AMPS = {"out": 1.0, "wt": 0.5, "tc": 0.25, "et": 0.1}
# Mean offsets that SURVIVE low-pass filtering: the weaker, corruption-robust
# cue a stylized-trained model can fall back on. They compete with the
# anatomy band's random local level (amplitude _ANATOMY_AMP below), so a
# model must read them as a local step at the tumor boundary.
_OFFSETS = {"wt": 0.5, "tc": 0.3, "et": 0.3}
_ANATOMY_AMP = 0.6


def make_textured_volume(rng: np.random.RandomState, channels: int = 4,
                         spatial: Tuple[int, ...] = (128, 128, 64),
                         n_classes: int = 3, return_parts: bool = False):
    """One textured sample: label information lives in fine-scale texture.

    The plain :func:`make_volume` blobs carry their label signal as a big
    low-frequency mean offset, so k-space corruption barely hurts a trained
    model and the reference's robustness-gain effect is unfalsifiable on
    it. Here the *discriminative* signal is (a) a strong
    difference in band-limited high-k texture amplitude between tumor
    compartments and healthy tissue — which Gibbs/disk filtering at the
    reference's radii destroys completely — plus (b) a small mean offset
    that survives low-pass, mirroring how real MRI tumor texture vs
    intensity behaves (reference baseline 0.7433 -> 0.6101 clean -> gibbs9,
    BASELINE.md). Tumor geometry is a randomly warped ellipsoid so shape
    alone is not trivially learnable.
    """
    grids = np.ogrid[tuple(slice(0, n) for n in spatial)]
    center = [rng.uniform(0.35, 0.65) * n for n in spatial]
    radii = [rng.uniform(0.12, 0.24) * n for n in spatial]
    q = sum(((g - c) / r) ** 2 for g, c, r in zip(grids, center, radii))
    # low-order boundary warp: +-25% radius modulation
    warp = _smooth_noise(rng, spatial, passes=6)
    warp /= np.abs(warp).max() + 1e-6
    q = q * (1.0 + 0.25 * warp)
    wt = q < 1.0
    tc = q < 0.55
    et = q < 0.25

    amp = np.full(spatial, _TEX_AMPS["out"], np.float32)
    amp[wt] = _TEX_AMPS["wt"]
    amp[tc] = _TEX_AMPS["tc"]
    amp[et] = _TEX_AMPS["et"]
    offset = (_OFFSETS["wt"] * wt + _OFFSETS["tc"] * tc
              + _OFFSETS["et"] * et).astype(np.float32)
    # taper the region edges: a hard step on the amplitude map leaks texture
    # energy into low k (AM sidebands), which would let some texture signal
    # survive the disk filter
    amp = _box_smooth(amp, 2)
    offset = _box_smooth(offset, 2)

    chans, parts = [], []
    for _ in range(channels):
        anatomy = _ANATOMY_AMP * _band_noise(rng, spatial, 0.0, 0.12)
        texture = _band_noise(rng, spatial, *_TEXTURE_BAND)
        gain = 0.7 + 0.6 * rng.rand()  # per-channel contrast variation
        img = anatomy + amp * texture + gain * offset
        chans.append(img)
        parts.append({"anatomy": anatomy, "texture": amp * texture,
                      "offset": gain * offset})
    image = np.stack(chans)
    mu = image.mean(axis=tuple(range(1, image.ndim)), keepdims=True)
    sd = image.std(axis=tuple(range(1, image.ndim)), keepdims=True) + 1e-6
    image = (image - mu) / sd
    if n_classes == 3:
        label = np.stack([tc, wt, et]).astype(np.float32)
    elif n_classes == 1:
        label = wt[None].astype(np.float32)
    else:
        raise ValueError("n_classes must be 1 or 3")
    if return_parts:
        # components in *normalized* units (per-channel scale applied)
        scaled = [{k: v / sd[c].ravel()[0] for k, v in p.items()}
                  for c, p in enumerate(parts)]
        return image.astype(np.float32), label, scaled
    return image.astype(np.float32), label


_GENERATORS = {"smooth": make_volume, "textured": make_textured_volume}


def batches(seed: int, batch_size: int, channels: int = 4,
            spatial: Tuple[int, ...] = (128, 128, 64),
            n_classes: int = 3, kind: str = "smooth"
            ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless iterator of (image, label) channel-first batches."""
    gen = _GENERATORS[kind]
    rng = np.random.RandomState(seed)
    while True:
        imgs, lbls = zip(*[gen(rng, channels, spatial, n_classes)
                           for _ in range(batch_size)])
        yield np.stack(imgs), np.stack(lbls)


def cached_batches(seed: int, batch_size: int, pool: int = 32,
                   channels: int = 4, spatial: Tuple[int, ...] = (128, 128, 64),
                   n_classes: int = 3, kind: str = "smooth"
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless batches sampled from a pre-generated in-memory pool.

    The analogue of the reference's ``CacheDataset``: volume synthesis (like
    its NIfTI decode + preprocessing) is paid once, so a 1-core host can feed
    the device at step rate.
    """
    imgs, lbls = generate_pool(seed, pool, channels, spatial, n_classes, kind)
    # dedicated sampling stream (NOT the post-generation generator state, so
    # a disk-cached pool yields the same batch sequence as a fresh one)
    rng = np.random.RandomState((seed * 1000003 + 12345) % (2 ** 31))
    while True:
        idx = rng.randint(0, pool, batch_size)
        yield imgs[idx], lbls[idx]


def generate_pool(seed: int, pool: int, channels: int,
                  spatial: Tuple[int, ...], n_classes: int, kind: str,
                  cache_dir: Optional[str] = _DEFAULT_CACHE
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic synthetic volume pool with a host-side disk cache.

    Textured-volume synthesis runs on one host core (about a second a
    4x128x128x64 volume) and would be paid on every launch, resumes
    included. The pool is a pure function of the key, so it is cached:
    the first generation writes ``{kind}_s{seed}_... .npz`` under
    ``cache_dir``, later runs load it. ``cache_dir`` defaults to
    ``mvtb_pools`` in the system's temporary directory
    (``tempfile.gettempdir()``); None disables the cache. Delete the
    directory to force regeneration.
    """
    # the generator-source hash in the key invalidates cached pools when a
    # generator changes: a stale pool would silently change a run's inputs
    # across code revisions
    import hashlib
    import inspect

    try:
        gen_src = inspect.getsource(_GENERATORS[kind])
    except (OSError, TypeError):  # pyc-only installs, partials, REPL defs
        gen_src = repr(_GENERATORS[kind])
    gen_tag = hashlib.sha1(gen_src.encode()).hexdigest()[:10]
    if cache_dir is _DEFAULT_CACHE:
        cache_dir = os.path.join(tempfile.gettempdir(), "mvtb_pools")
    key = (f"{kind}_s{seed}_n{pool}_c{channels}_"
           f"{'x'.join(map(str, spatial))}_k{n_classes}_g{gen_tag}")
    path = os.path.join(cache_dir, key + ".npz") if cache_dir else None
    if path and os.path.exists(path):
        with np.load(path) as z:
            return z["imgs"], z["lbls"]
    gen = _GENERATORS[kind]
    rng = np.random.RandomState(seed)
    volumes = [gen(rng, channels, spatial, n_classes) for _ in range(pool)]
    imgs = np.stack([v[0] for v in volumes])
    lbls = np.stack([v[1] for v in volumes])
    if path:
        os.makedirs(cache_dir, exist_ok=True)
        # .npz suffix on the temp name: np.savez appends one otherwise
        tmp = path + f".{os.getpid()}.tmp.npz"
        np.savez(tmp, imgs=imgs, lbls=lbls)  # uncompressed: load speed
        os.replace(tmp, path)
    return imgs, lbls


def decathlon_style_dicts(seed: int, n: int, channels: int = 4,
                          spatial: Tuple[int, ...] = (128, 128, 64),
                          n_classes: int = 3):
    """A list of ``{"image", "label"}`` dicts for transform-pipeline testing."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        img, lbl = make_volume(rng, channels, spatial, n_classes)
        out.append({"image": img, "label": lbl})
    return out


def onehot_to_brats_ids(label_onehot: np.ndarray) -> np.ndarray:
    """(TC, WT, ET) one-hot -> raw BraTS class-id volume.

    Inverts ``ConvertToMultiChannelBasedOnBratsClassesd``
    (``filters_and_operators.py:61-87``): ET -> 2, TC outside ET -> 3,
    WT outside TC -> 1, background 0.
    """
    tc, wt, et = (label_onehot[i].astype(bool) for i in range(3))
    ids = np.zeros(label_onehot.shape[1:], np.float32)
    ids[wt] = 1.0
    ids[tc] = 3.0
    ids[et] = 2.0
    return ids


def build_decathlon_tree(root_dir: str, n: int = 8, channels: int = 4,
                         spatial: Tuple[int, ...] = (64, 64, 32),
                         kind: str = "textured", seed: int = 0,
                         task: str = "Task01_BrainTumour",
                         gzip_files: bool = True,
                         affine: np.ndarray = None) -> str:
    """Write a synthetic on-disk Decathlon tree in the real BraTS layout.

    Images land channel-LAST ``(X, Y, Z, C)`` ``.nii.gz`` (the raw BraTS
    NIfTI layout that ``AsChannelFirstd`` transposes), labels as raw class
    ids 0..3. The tree is a drop-in stand-in for the real dataset: when
    BraTS is at hand, point the same pipeline at its root instead. For the
    same arguments the files hold the JAX package's arrays.
    """
    gen = _GENERATORS[kind]
    rng = np.random.RandomState(seed)
    task_dir = os.path.join(root_dir, task)
    return _write_tree(task_dir, gen, rng, n, channels, spatial, gzip_files,
                       affine)


def _write_tree(task_dir, gen, rng, n, channels, spatial, gzip_files, affine,
                squeeze_channel=False):
    os.makedirs(os.path.join(task_dir, "imagesTr"), exist_ok=True)
    os.makedirs(os.path.join(task_dir, "labelsTr"), exist_ok=True)
    ext = ".nii.gz" if gzip_files else ".nii"
    entries = []
    for i in range(n):
        img, lbl = gen(rng, channels, spatial, 3)
        # BraTS layout: channel-LAST (*sp, C); TCGA volumes are plain 3-D
        # (AddChanneld prepends the channel axis at load time)
        raw_img = img[0] if squeeze_channel else np.moveaxis(img, 0, -1)
        raw_lbl = onehot_to_brats_ids(lbl)
        img_rel = f"imagesTr/synth_{i:03d}{ext}"
        lbl_rel = f"labelsTr/synth_{i:03d}{ext}"
        write_nifti(os.path.join(task_dir, img_rel), raw_img, affine)
        write_nifti(os.path.join(task_dir, lbl_rel), raw_lbl, affine)
        entries.append({"image": img_rel, "label": lbl_rel})
    with open(os.path.join(task_dir, "dataset.json"), "w") as f:
        json.dump({"name": "synthetic-brats", "training": entries}, f)
    return task_dir


def build_tcga_tree(root_dir: str, n_per_modality: int = 4,
                    spatial: Tuple[int, ...] = (24, 24, 12),
                    kind: str = "textured", seed: int = 0,
                    affine: np.ndarray = None) -> str:
    """Write a synthetic TCGA-style tree + per-modality JSON manifest.

    The T2 (institutional-distribution) template loads
    ``train_sequence_by_modality.json`` — a dict of modality name ->
    ``[{"image": path, "label": path}, ...]`` — and builds four
    ``CacheDataset``s from it (``baseline_domain.py:147-172``). Volumes are
    single-channel NIfTI (``AddChanneld`` prepends the channel axis), labels
    raw class ids (``WholeTumorTCGA`` binarizes them). Paths in the manifest
    are absolute, like the reference's cluster paths.
    """
    gen = _GENERATORS[kind]
    rng = np.random.RandomState(seed)
    manifest = {}
    for modality in ("FLAIR", "T1", "T1Gd", "T2"):
        task_dir = _write_tree(os.path.join(root_dir, modality), gen, rng,
                               n_per_modality, 1, spatial, True, affine,
                               squeeze_channel=True)
        with open(os.path.join(task_dir, "dataset.json")) as f:
            entries = json.load(f)["training"]
        manifest[modality] = [
            {k: os.path.join(task_dir, rel) for k, rel in e.items()}
            for e in entries
        ]
    with open(os.path.join(root_dir, "train_sequence_by_modality.json"),
              "w") as f:
        json.dump(manifest, f)
    return root_dir
