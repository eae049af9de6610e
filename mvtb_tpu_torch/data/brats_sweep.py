"""BratsValIterDataset: the reference's dataset-of-datasets sweep class
(counterpart of mvtb_tpu/data/brats_sweep.py).

Constructor-compatible with ``source_code/utils.py:159-235``: for each entry
of ``transforms`` ({name: corruption transform}), build the base BraTS
validation pipeline (spacing 1.5/1.5/2.0, RAS, center-crop 128x128x64,
nonzero-normalize) + the appended corruption over ``root_dir``'s Decathlon
Task01 data, take the reference's deterministic 48/48 split (torch-seeded
permutation), and yield ``(name, dataset-or-loader)``.
"""

from __future__ import annotations

from typing import Dict, Optional

from mvtb_tpu_torch.data.nifti import DecathlonDataset, reference_val_split
from mvtb_tpu_torch.data.pipeline import Loader, brats_val_pipeline
from mvtb_tpu_torch.transforms import ReCompose


class BratsValIterDataset:
    """Iterate ``(name, Loader-or-dataset)`` over named corruption variants.

    Args:
        root_dir: Decathlon data root (contains ``Task01_BrainTumour``).
        cache_num: retained for signature parity (caching here is the
            preprocessed ``.npz`` cache of :class:`DecathlonDataset`).
        transforms: ``{name: dict-transform}`` appended to the val pipeline.
        return_loader: True -> yield batch-2 loaders (reference default
            loaders); False -> yield indexable datasets.
    """

    def __init__(self, root_dir: str, cache_num: int = 0,
                 transforms: Optional[Dict] = None,
                 return_loader: bool = False,
                 cache_dir: Optional[str] = None,
                 roi_size=(128, 128, 64), pixdim=(1.5, 1.5, 2.0)):
        self.root_dir = root_dir
        self.cache_num = cache_num
        self.transforms = transforms or {}
        self.return_loader = return_loader
        self.cache_dir = cache_dir
        # trailing kwargs beyond the reference signature: scale the base
        # pipeline for rehearsal/test runs (reference defaults preserved)
        self.pipe = brats_val_pipeline(roi_size=roi_size, pixdim=pixdim)

    def _build(self, transform):
        pipe = ReCompose(list(self.pipe.transforms))
        pipe.append(transform)
        ds = DecathlonDataset(self.root_dir, "Task01_BrainTumour",
                              transform=pipe, section="validation",
                              cache_dir=self.cache_dir)
        n = len(ds)
        half = n // 2
        _, test_idx = reference_val_split(n, (n - half, half), seed=0)
        if self.return_loader:
            return Loader(ds, batch_size=2, indices=test_idx)

        class _Subset:
            def __init__(self, base, idx):
                self.base, self.idx = base, idx

            def __len__(self):
                return len(self.idx)

            def __getitem__(self, i):
                return self.base[self.idx[i]]

        return _Subset(ds, test_idx)

    def __iter__(self):
        for name, t in self.transforms.items():
            yield name, self._build(t)

    def __getitem__(self, key: str):
        return self._build(self.transforms[key])
