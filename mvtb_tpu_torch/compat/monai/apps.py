"""``monai.apps.DecathlonDataset`` on the port.

Yields path dicts through the whole transform pipeline (so a pipeline
starting with ``LoadImaged`` works, MONAI's layout), with MONAI 0.4/0.5's
split (seeded shuffle, the first ``val_frac`` for validation) and
CacheDataset-style deterministic-prefix caching for ``cache_num`` items.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .data import CacheDataset


class DecathlonDataset(CacheDataset):
    def __init__(self, root_dir: str, task: str = "Task01_BrainTumour",
                 transform=None, section: str = "training",
                 download: bool = False, num_workers: int = 0,
                 cache_num: int = 2 ** 31, cache_rate: float = 1.0,
                 val_frac: float = 0.2, seed: int = 0):
        if section not in ("training", "validation"):
            raise ValueError(f"unsupported section: {section}")
        root = os.path.join(root_dir, task)
        manifest = os.path.join(root, "dataset.json")
        if not os.path.exists(manifest):
            raise RuntimeError(
                f"{manifest} not found. Nothing is downloaded: point root_dir "
                "at an existing Decathlon tree (or build a synthetic one with "
                "mvtb_tpu_torch.data.synthetic.build_decathlon_tree).")
        with open(manifest) as f:
            entries = json.load(f)["training"]
        # MONAI 0.4/0.5 _split_datalist: a shuffled index split, both
        # sections kept in shuffled order
        indices = np.arange(len(entries))
        np.random.RandomState(seed).shuffle(indices)
        val_len = int(len(entries) * val_frac)
        picked = indices[:val_len] if section == "validation" else indices[val_len:]
        data = [{"image": os.path.join(root, e["image"]),
                 "label": os.path.join(root, e["label"])}
                for e in (entries[i] for i in picked)]
        super().__init__(data, transform, cache_num=cache_num,
                         cache_rate=cache_rate, num_workers=num_workers)
