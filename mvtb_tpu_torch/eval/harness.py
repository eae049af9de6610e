"""Evaluation harness: the reference's ``model_evaluation`` + sweep pattern
(counterpart of mvtb_tpu/eval/harness.py).

``ModelEvaluation`` accumulates Dice metrics per named dataset
(``source_code/utils.py:241-465``): ``dataset_eval_single`` for 1-label
models, ``dataset_eval_multi`` for the 3-label BraTS head returning
``(mean, ET, TC, WT)`` with the reference's nan-weighted accumulation and
channel order (TC=ch0, WT=ch1, ET=ch2). Results persist as JSON (and a
pickle sidecar, for drop-in parity with the reference's ``.pickle``
tables), with the JAX package's record keys.

``TransformSweep`` is the ``BratsValIterDataset`` analogue: a fixed base
dataset x a dict of named corruption transforms, yielding ``(name,
loader)``.
"""

from __future__ import annotations

import json
import pickle
from collections import defaultdict
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.eval.dice import dice_metric, threshold_predictions
from mvtb_tpu_torch.eval.sliding_window import sliding_window_inference
from mvtb_tpu_torch.transforms.array import _to_numpy


class ModelEvaluation:
    """Dice evaluation record for one model across many datasets.

    Args:
        model: an ``nn.Module`` on channel-first tensors (in place of the
            reference's ``.pth`` loading; :meth:`from_checkpoint` restores
            one from the port's checkpoints), already on ``device``.
        instance_name: label used for the saved results file.
        out_channels: 3 -> multi-label (mean, ET, TC, WT); 1 -> scalar Dice.
        roi_size: evaluate through sliding-window inference (the
            reference's TCGA_data_augmentation notebook pattern).
        device: where the forward runs; None means ``"cuda"``.
    """

    def __init__(self, model: Optional[torch.nn.Module] = None,
                 instance_name: Optional[str] = None, in_channels: int = 4,
                 out_channels: int = 3,
                 roi_size: Optional[Tuple[int, ...]] = None,
                 device: DeviceLike = None):
        self.model = model
        self.instance_name = instance_name
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.roi_size = tuple(roi_size) if roi_size else None
        self.device = resolve_device(device)
        self.eval_dict: Dict[str, object] = defaultdict(list)

    @torch.no_grad()
    def _eval_batch(self, batch: dict):
        """``((mean, not_nans), [(mean, not_nans) per channel])`` of one
        channel-first batch, as 0-d tensors on the card."""
        image = torch.as_tensor(_to_numpy(batch["image"])).to(self.device)
        label = torch.as_tensor(_to_numpy(batch["label"])).to(self.device)
        if self.roi_size is not None:
            logits = sliding_window_inference(image, self.roi_size, self.model,
                                              device=self.device)
        else:
            logits = self.model(image)
        preds = threshold_predictions(logits)
        overall = dice_metric(preds, label)
        per_class = [dice_metric(preds[:, c:c + 1], label[:, c:c + 1])
                     for c in range(label.shape[1])]
        return overall, per_class

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, instance_name: Optional[str] = None,
                        in_channels: int = 4, out_channels: int = 3,
                        gibbs_unet: bool = False, spikes_unet: bool = False,
                        step: Optional[int] = None,
                        device: DeviceLike = None) -> "ModelEvaluation":
        """Restore a full-width ``UNet(in_channels, out_channels)`` from the
        port's checkpoints (:class:`~mvtb_tpu_torch.train.checkpoint.
        CheckpointManager`, a segmentation run's ``ckpt/``), the latest step
        unless ``step`` is given. The framework analogue of the reference's
        ``load_UNet`` .pth loading (``utils.py:286-311``). A JAX Orbax
        checkpoint is not read: convert its parameters with
        :mod:`mvtb_tpu_torch.models.convert` on the caller's side."""
        if gibbs_unet or spikes_unet:
            raise NotImplementedError(
                "the stylization UNets (gibbs_unet / spikes_unet): "
                "ROADMAP.md section 1, item 6")
        from mvtb_tpu_torch.models import UNet
        from mvtb_tpu_torch.train.checkpoint import CheckpointManager
        from mvtb_tpu_torch.train.seg import create_seg_state

        dev = resolve_device(device)
        state = create_seg_state(UNet(in_channels, out_channels, device=dev), device=dev)
        mgr = CheckpointManager(ckpt_dir)
        state = mgr.restore(state, step=step)
        mgr.close()
        state.model.eval()
        return cls(state.model, instance_name=instance_name, in_channels=in_channels,
                   out_channels=out_channels, device=dev)

    # -- dataset-level metrics ------------------------------------------------

    def dataset_eval_single(self, loader: Iterable[dict]) -> float:
        """The not-NaN-weighted mean Dice over the loader's batches."""
        metric_sum, metric_count = 0.0, 0.0
        for batch in loader:
            (value, not_nans), _ = self._eval_batch(batch)
            metric_sum += float(value) * float(not_nans)
            metric_count += float(not_nans)
        return metric_sum / metric_count

    def dataset_eval_multi(self, loader: Iterable[dict]) -> Tuple[float, float, float, float]:
        """``(mean, ET, TC, WT)``, each not-NaN-weighted over the batches."""
        sums = np.zeros(4)
        counts = np.zeros(4)
        for batch in loader:
            (value, not_nans), per_class = self._eval_batch(batch)
            sums[0] += float(value) * float(not_nans)
            counts[0] += float(not_nans)
            for i, (v, n) in enumerate(per_class):  # channels: TC, WT, ET
                sums[1 + i] += float(v) * float(n)
                counts[1 + i] += float(n)
        metric, metric_tc, metric_wt, metric_et = (float(v) for v in sums / counts)
        # reference return order: (mean, ET, TC, WT) (utils.py:415)
        return metric, metric_et, metric_tc, metric_wt

    def add_eval(self, name: Optional[str] = None, test_loader=None,
                 data_dict: Optional[dict] = None) -> None:
        eval_fn = (self.dataset_eval_multi if self.out_channels > 1
                   else self.dataset_eval_single)
        if data_dict is None:
            self.eval_dict[name] = eval_fn(test_loader)
        else:
            for key in data_dict:
                self.eval_dict[key] = eval_fn(data_dict[key])

    # -- persistence ----------------------------------------------------------

    def save(self, path: Optional[str] = None) -> str:
        """JSON (+pickle sidecar) of the eval record, model stripped."""
        base = path or self.instance_name or "model_evaluation"
        record = {
            "instance_name": self.instance_name,
            "in_channels": self.in_channels,
            "out_channels": self.out_channels,
            "eval_dict": {k: ([float(x) for x in v] if isinstance(v, (tuple, list))
                              else float(v))
                          for k, v in self.eval_dict.items()},
        }
        with open(base + ".json", "w") as f:
            json.dump(record, f, indent=2)
        with open(base + ".pickle", "wb") as f:
            pickle.dump(record, f)
        return base + ".json"

    def load_dict(self, filename: str) -> None:
        if filename.endswith(".pickle"):
            with open(filename, "rb") as f:
                record = pickle.load(f)
        else:
            with open(filename) as f:
                record = json.load(f)
        self.instance_name = record.get("instance_name", self.instance_name)
        self.eval_dict = defaultdict(list, record["eval_dict"])


class TransformSweep:
    """Named-corruption sweep over a fixed validation set
    (``BratsValIterDataset``, ``source_code/utils.py:159-235``).

    Args:
        samples: list of ``{"image", "label"}`` channel-first dicts — the
            preprocessed validation split.
        transforms: ``{name: dict-transform}``; each is appended to the
            (already applied) base pipeline, i.e. applied to ``samples``
            lazily. Outputs may be tensors (the port's k-space transforms);
            batches are stacked to numpy.
        batch_size: loader batch size (reference uses 2); the last batch is
            short when the samples do not divide.
    """

    def __init__(self, samples: List[dict], transforms: Dict[str, Callable],
                 batch_size: int = 2):
        self.samples = samples
        self.transforms = transforms
        self.batch_size = batch_size

    def _loader(self, transform) -> Iterator[dict]:
        batch_imgs, batch_lbls = [], []
        for s in self.samples:
            out = transform(dict(s)) if transform is not None else s
            batch_imgs.append(_to_numpy(out["image"]))
            batch_lbls.append(_to_numpy(out["label"]))
            if len(batch_imgs) == self.batch_size:
                yield {"image": np.stack(batch_imgs), "label": np.stack(batch_lbls)}
                batch_imgs, batch_lbls = [], []
        if batch_imgs:
            yield {"image": np.stack(batch_imgs), "label": np.stack(batch_lbls)}

    def __iter__(self) -> Iterator[Tuple[str, Iterator[dict]]]:
        for name, t in self.transforms.items():
            yield name, self._loader(t)

    def __getitem__(self, key: str) -> Iterator[dict]:
        return self._loader(self.transforms[key])
