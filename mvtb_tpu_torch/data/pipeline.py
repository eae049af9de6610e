"""Reference preprocessing pipelines, assembled (counterpart of
mvtb_tpu/data/pipeline.py).

``brats_train_pipeline``/``brats_val_pipeline`` reproduce the transform
stacks of ``baseline.py:116-156`` (train: rand crop + flips + intensity
jitter) and ``utils.py:186-198`` (val: center crop), minus the corruption,
which the train step applies on the card via
:class:`~mvtb_tpu_torch.ops.fused.StylizeConfig`. Host pipelines stay numpy;
the step moves a batch to the card.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.data.preprocess import (
    AsChannelFirstd,
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
from mvtb_tpu_torch.transforms import Compose, ConvertToMultiChannelBasedOnBratsClassesd
from mvtb_tpu_torch.transforms.array import _to_numpy
from mvtb_tpu_torch.utils.profiling import span, to_host


def brats_train_pipeline(roi_size: Sequence[int] = (128, 128, 64),
                         pixdim: Sequence[float] = (1.5, 1.5, 2.0)) -> Compose:
    """Training preprocessing (``baseline.py:116-138``)."""
    return Compose([
        AsChannelFirstd(keys="image"),
        # label arrives (X, Y, Z); the BraTS conversion adds the channel axis
        ConvertToMultiChannelBasedOnBratsClassesd(keys="label"),
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


def brats_val_pipeline(roi_size: Sequence[int] = (128, 128, 64),
                       pixdim: Sequence[float] = (1.5, 1.5, 2.0)) -> Compose:
    """Validation preprocessing (``utils.py:186-198``)."""
    return Compose([
        AsChannelFirstd(keys="image"),
        # label arrives (X, Y, Z); the BraTS conversion adds the channel axis
        ConvertToMultiChannelBasedOnBratsClassesd(keys="label"),
        Spacingd(keys=["image", "label"], pixdim=pixdim,
                 mode=("bilinear", "nearest")),
        Orientationd(keys=["image", "label"], axcodes="RAS"),
        CenterSpatialCropd(keys=["image", "label"], roi_size=roi_size),
        NormalizeIntensityd(keys="image", nonzero=True, channel_wise=True),
        ToTensord(keys=["image", "label"]),
    ])


class StylizedLoader:
    """Wrap a loader so every image batch passes through a stylization config.

    The counterpart of putting the corruption transform in the VAL pipeline,
    which the reference's domain scripts do
    (``300_instutional_distribution/gibbs15_domain.py:120-136``:
    ``RandFourierDiskMaskd(..., prob=1.)`` appears in BOTH
    ``train_transform`` and ``val_transform``), so a stylized model is
    evaluated under its own filtering. Each batch runs
    :func:`mvtb_tpu_torch.ops.fused.stylize_batch` on ``device`` (None means
    ``"cuda"``), its draws taken from one ``torch.Generator`` seeded
    ``seed`` at the start of each pass, in place of the JAX package's
    per-batch key split (deterministic for a fixed-parameter prob=1
    config). Images come back as channel-first numpy in page-locked memory
    (from the card; ``utils/profiling.py:to_host``), which the array holds
    for as long as the caller keeps it, as a ``pin_memory`` loader's
    batches are.
    """

    def __init__(self, loader, stylize, seed: int = 0, device: DeviceLike = None):
        self.loader = loader
        self.stylize = stylize
        self.seed = seed
        self.device = resolve_device(device)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator[dict]:
        from mvtb_tpu_torch.ops.fused import stylize_batch

        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        for batch in self.loader:
            img = stylize_batch(torch.from_numpy(np.asarray(batch["image"])),
                                self.stylize, generator=generator, device=self.device)
            with span("mvtb.loader.to_host"):
                img = to_host(img).numpy()
            yield {**batch, "image": img}


class Loader:
    """Minimal batching loader over an indexable dataset of sample dicts.

    Single-process: the heavy work (corruption, training) runs on the card
    and the loader only stacks cached arrays. The shuffle draws from
    ``RandomState(seed)``, one permutation per pass, as the JAX package's.
    Samples may hold tensors (a k-space transform's output); batches are
    numpy.
    """

    def __init__(self, dataset, batch_size: int = 2, shuffle: bool = False,
                 seed: int = 0, indices: Optional[List[int]] = None,
                 drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.indices = list(range(len(dataset))) if indices is None else list(indices)
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        order = list(self.indices)
        if self.shuffle:
            self.rng.shuffle(order)
        for i in range(0, len(order), self.batch_size):
            chunk = order[i:i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            samples = [self.dataset[j] for j in chunk]
            yield {
                "image": np.stack([_to_numpy(s["image"]) for s in samples]),
                "label": np.stack([_to_numpy(s["label"]) for s in samples]),
            }
