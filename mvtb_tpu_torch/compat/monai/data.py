"""``monai.data`` names: Dataset, CacheDataset, partition_dataset,
DataLoader. Batches are CPU torch tensors, so the reference's
``batch["image"].to(device)`` lines move them to the card."""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from mvtb_tpu_torch.transforms.base import Compose, Randomizable


def _split_at_first_random(transform):
    """(deterministic prefix, random suffix) of a Compose: MONAI's
    CacheDataset rule (cache up to the first Randomizable)."""
    if not isinstance(transform, Compose):
        if isinstance(transform, Randomizable) or transform is None:
            return None, transform
        return transform, None
    ts = list(transform.transforms)
    for i, t in enumerate(ts):
        if isinstance(t, Randomizable):
            return (Compose(ts[:i]) if i else None), Compose(ts[i:])
    return transform, None


class Dataset:
    """List-of-dicts dataset with a transform (``monai.data.Dataset``)."""

    def __init__(self, data: Sequence[Dict], transform: Optional[Callable] = None):
        self.data = list(data)
        self.transform = transform

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int):
        sample = dict(self.data[idx])
        return self.transform(sample) if self.transform else sample


class CacheDataset(Dataset):
    """Deterministic-prefix in-memory caching (``monai.data.CacheDataset``):
    the transform chain up to its first ``Randomizable`` runs once per item
    and is cached for the first ``cache_num`` items; the random suffix runs
    on a deep copy at every access."""

    def __init__(self, data: Sequence[Dict], transform: Optional[Callable] = None,
                 cache_num: int = 2 ** 31, cache_rate: float = 1.0,
                 num_workers: int = 0):
        super().__init__(data, transform)
        self.cache_num = min(int(cache_num), int(len(self.data) * cache_rate))
        self._prefix, self._suffix = _split_at_first_random(transform)
        self._cache: Dict[int, Any] = {}

    def __getitem__(self, idx: int):
        if idx < self.cache_num and self._prefix is not None:
            if idx not in self._cache:
                self._cache[idx] = self._prefix(dict(self.data[idx]))
            sample = copy.deepcopy(self._cache[idx])
            return self._suffix(sample) if self._suffix else sample
        return super().__getitem__(idx)


def partition_dataset(data: Sequence, ratios: Optional[Sequence[float]] = None,
                      num_partitions: Optional[int] = None,
                      shuffle: bool = False, seed: int = 0,
                      drop_last: bool = False, even_divisible: bool = False,
                      ) -> List[List]:
    """MONAI's list partitioner (the T2 template's ``ratios=[0.9, 0.1]``,
    ``baseline_domain.py:147-154``): an optional seeded shuffle, then a split
    at the cumulative ratio boundaries."""
    items = list(data)
    if shuffle:
        np.random.RandomState(seed).shuffle(items)
    if ratios is not None:
        total = float(sum(ratios))
        n = len(items)
        bounds = [0]
        acc = 0.0
        for r in ratios:
            acc += r
            bounds.append(int(n * acc / total))
        return [items[bounds[i]:bounds[i + 1]] for i in range(len(ratios))]
    if num_partitions:
        return [list(p) for p in np.array_split(items, num_partitions)]
    raise ValueError("one of ratios / num_partitions is required")


def _tensor(v) -> torch.Tensor:
    return v.cpu() if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(v))


def _collate(samples: List):
    if isinstance(samples[0], dict):
        out = {}
        for key in samples[0]:
            vals = [s[key] for s in samples]
            if isinstance(vals[0], (dict, str, bytes)):  # *_meta_dict, paths
                out[key] = vals
            else:
                out[key] = torch.stack([_tensor(v) for v in vals])
        return out
    return torch.stack([_tensor(s) for s in samples])


class DataLoader:
    """Batch iterator (``monai.data.DataLoader``), in this process.

    ``num_workers`` is accepted and ignored: the corruption runs on the
    card in the step, not in loader workers. Shuffling draws from numpy's
    global generator, which ``monai.utils.set_determinism`` seeds."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 num_workers: int = 0, drop_last: bool = False,
                 collate_fn: Optional[Callable] = None, **_ignored):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn or _collate

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.shuffle(idx)
        for start in range(0, len(idx), self.batch_size):
            chunk = idx[start:start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield self.collate_fn([self.dataset[int(i)] for i in chunk])
