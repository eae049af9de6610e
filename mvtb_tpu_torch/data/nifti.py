"""NIfTI ingest + Decathlon/TCGA dataset plumbing (counterpart of
mvtb_tpu/data/nifti.py).

The reference loads BraTS via MONAI's ``DecathlonDataset`` (JSON manifest of
NIfTI pairs) and TCGA via per-modality JSON manifests
(``baseline_domain.py:147-172``). Without nibabel or the datasets, this
module:

* reads uncompressed/gzipped NIfTI-1 directly (a small self-contained
  parser, or the native decoder of :mod:`mvtb_tpu_torch.native`),
* exposes ``DecathlonDataset``-style manifest loading + the reference's
  deterministic 48/48 validation split (``torch.randperm``),
* caches preprocessed channel-first arrays as ``.npz`` so the host's
  preprocessing cost is paid once; the corruption itself runs on the card.
"""

from __future__ import annotations

import gzip
import json
import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mvtb_tpu_torch.transforms.array import _to_numpy

_NIFTI_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
    64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32,
}


def read_nifti(path: str, prefer_native: bool = True
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Read a NIfTI-1 file -> (data array, 4x4 voxel->world affine).

    Supports the single-file ``.nii``/``.nii.gz`` layout BraTS/TCGA use.
    When the native decoder is available (``mvtb_tpu_torch.native.nifti_read``,
    one fused inflate+convert pass) it is used and the result dtype is
    float32; the pure-Python path below preserves the on-disk dtype.
    """
    if prefer_native:
        from mvtb_tpu_torch import native

        out = native.nifti_read(path)
        if out is not None:
            return out
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        header = f.read(348)
        if len(header) < 348 or struct.unpack("<i", header[:4])[0] != 348:
            raise ValueError(f"{path}: not a little-endian NIfTI-1 file")
        dim = struct.unpack("<8h", header[40:56])
        datatype = struct.unpack("<h", header[70:72])[0]
        vox_offset = int(struct.unpack("<f", header[108:112])[0])
        scl_slope = struct.unpack("<f", header[112:116])[0]
        scl_inter = struct.unpack("<f", header[116:120])[0]
        srow_x = struct.unpack("<4f", header[280:296])
        srow_y = struct.unpack("<4f", header[296:312])
        srow_z = struct.unpack("<4f", header[312:328])

        ndim = dim[0]
        shape = tuple(int(d) for d in dim[1:1 + ndim])
        dtype = _NIFTI_DTYPES.get(datatype)
        if dtype is None:
            raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
        f.seek(vox_offset)
        data = np.frombuffer(f.read(), dtype=dtype,
                             count=int(np.prod(shape)))
    data = data.reshape(shape, order="F")
    if scl_slope not in (0.0, 1.0):
        # float64 scaling arithmetic (nibabel semantics; the native decoder
        # computes the same product in double before narrowing to float32)
        data = data.astype(np.float64) * scl_slope + scl_inter
    affine = np.eye(4)
    affine[0], affine[1], affine[2] = srow_x, srow_y, srow_z
    if not np.isfinite(affine).all() or np.allclose(affine[:3, :3], 0):
        affine = np.eye(4)
    return np.asarray(data), affine


_NIFTI_CODES = {np.dtype(v).name: k for k, v in _NIFTI_DTYPES.items()}


def write_nifti(path: str, data: np.ndarray,
                affine: Optional[np.ndarray] = None) -> None:
    """Write a little-endian single-file NIfTI-1 volume (``.nii``/``.nii.gz``).

    The inverse of :func:`read_nifti` (same header subset: dim, datatype,
    vox_offset, scl_slope=1, srow affine); used to build synthetic on-disk
    Decathlon trees for rehearsal runs and tests.
    """
    data = np.asarray(data)
    code = _NIFTI_CODES.get(data.dtype.name)
    if code is None:
        data = data.astype(np.float32)
        code = 16
    if affine is None:
        affine = np.eye(4)
    header = bytearray(352)
    struct.pack_into("<i", header, 0, 348)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", header, 40, *dim)
    struct.pack_into("<h", header, 70, code)
    struct.pack_into("<h", header, 72, data.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<f", header, 108, 352.0)  # vox_offset
    struct.pack_into("<f", header, 112, 1.0)  # scl_slope
    struct.pack_into("<h", header, 254, 1)  # sform_code
    struct.pack_into("<4f", header, 280, *np.asarray(affine[0], np.float64))
    struct.pack_into("<4f", header, 296, *np.asarray(affine[1], np.float64))
    struct.pack_into("<4f", header, 312, *np.asarray(affine[2], np.float64))
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(bytes(header))
        f.write(np.ascontiguousarray(data, data.dtype).tobytes(order="F"))


class DecathlonDataset:
    """Manifest-driven dataset matching MONAI's Decathlon layout.

    Expects ``root_dir/task/dataset.json`` with ``training`` entries of
    ``{"image": ..., "label": ...}`` relative paths. Split membership is
    pinned to MONAI 0.4/0.5 ``DecathlonDataset._split_datalist``: the index
    list is SHUFFLED with ``np.random.RandomState(seed)`` (seed 0 default,
    as in every reference script), validation = the first
    ``int(n * val_frac)`` shuffled indices, training = the remainder, both
    kept in shuffled order. Samples pass through ``transform`` and are
    memoized to ``cache_dir``.
    """

    def __init__(self, root_dir: str, task: str = "Task01_BrainTumour",
                 transform=None, section: str = "training",
                 cache_dir: Optional[str] = None, val_frac: float = 0.2,
                 seed: int = 0):
        self.root = os.path.join(root_dir, task)
        manifest = os.path.join(self.root, "dataset.json")
        with open(manifest) as f:
            entries = json.load(f)["training"]
        indices = np.arange(len(entries))
        np.random.RandomState(seed).shuffle(indices)
        val_length = int(len(entries) * val_frac)
        if section == "training":
            self.entries = [entries[i] for i in indices[val_length:]]
        elif section == "validation":
            self.entries = [entries[i] for i in indices[:val_length]]
        else:
            raise ValueError(section)
        self.transform = transform
        self.cache_dir = cache_dir
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

    def __len__(self) -> int:
        return len(self.entries)

    def _load_raw(self, entry: Dict) -> Dict:
        img_path = os.path.join(self.root, entry["image"])
        lbl_path = os.path.join(self.root, entry["label"])
        image, affine = read_nifti(img_path)
        label, _ = read_nifti(lbl_path)
        return {"image": image, "label": label, "affine": affine}

    def __getitem__(self, idx: int) -> Dict:
        if self.cache_dir:
            tag = os.path.basename(self.entries[idx]["image"]).split(".")[0]
            cache = os.path.join(self.cache_dir, f"{tag}.npz")
            if os.path.exists(cache):
                with np.load(cache) as z:
                    return {k: z[k] for k in z.files}
        sample = self._load_raw(self.entries[idx])
        if self.transform is not None:
            sample = self.transform(sample)
        if self.cache_dir:
            np.savez(cache, **{k: _to_numpy(v) for k, v in sample.items()
                               if isinstance(v, (np.ndarray, torch.Tensor))
                               or k in ("image", "label")})
        return sample


def reference_val_split(n: int = 96, split: Sequence[int] = (48, 48),
                        seed: int = 0) -> Tuple[List[int], List[int]]:
    """The reference's deterministic ``random_split([48, 48], seed 0)``
    (``baseline.py:186``, ``utils.py:212``): a seeded permutation of indices
    cut into consecutive chunks: ``torch.randperm`` under a CPU generator
    seeded ``seed``, so the exact 48-volume eval subset matches."""
    g = torch.Generator().manual_seed(seed)
    perm = torch.randperm(n, generator=g).tolist()
    first = perm[:split[0]]
    second = perm[split[0]:split[0] + split[1]]
    return first, second


def tcga_manifest_datasets(manifest_paths: Sequence[str], transform=None,
                           partition: float = 0.9, seed: int = 0):
    """TCGA per-modality JSON manifests -> (train_entries, val_entries) per
    manifest, with the reference's 0.9/0.1 partition
    (``baseline_domain.py:147-154``)."""
    out = []
    rng = np.random.RandomState(seed)
    for path in manifest_paths:
        with open(path) as f:
            entries = json.load(f)
        if isinstance(entries, dict):
            entries = entries.get("training", entries.get("data", []))
        idx = rng.permutation(len(entries))
        cut = int(len(entries) * partition)
        train = [entries[i] for i in idx[:cut]]
        val = [entries[i] for i in idx[cut:]]
        out.append((train, val))
    return out
