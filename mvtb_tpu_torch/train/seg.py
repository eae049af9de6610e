"""Segmentation evaluation (counterpart of mvtb_tpu/train/seg.py).

Ported so far: :func:`seg_eval_step`, the corrupted-validation step (fused
k-space stylization -> UNet forward -> sigmoid threshold -> Dice), and
:class:`EpochMetrics`. The training step waits for the next slice
(ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.eval.dice import dice_scores, threshold_predictions
from mvtb_tpu_torch.ops.fused import StageDraws, StylizeConfig, stylize_batch


@torch.no_grad()
def seg_eval_step(model: torch.nn.Module, image: torch.Tensor,
                  label: torch.Tensor,
                  stylize_cfg: Optional[StylizeConfig] = None,
                  draws: Optional[StageDraws] = None,
                  generator: Optional[torch.Generator] = None,
                  device: DeviceLike = None, return_logits: bool = False):
    """Per-(sample, class) hard Dice on a channel-first batch; NaN where
    undefined. Returns ``(B, C)``, or ``(dice, logits)`` with
    ``return_logits``.

    ``stylize_cfg`` corrupts the image first (the reference's corrupted
    validation); ``draws`` or ``generator`` feed its random parameters, as
    in :func:`~mvtb_tpu_torch.ops.fused.stylize_batch`. ``device=None``
    means ``"cuda"``; the model must already live there.
    """
    dev = resolve_device(device)
    image, label = image.to(dev), label.to(dev)
    if stylize_cfg is not None and stylize_cfg.any_enabled:
        image = stylize_batch(image, stylize_cfg, draws=draws,
                              generator=generator, device=dev)
    logits = model(image)
    dice = dice_scores(threshold_predictions(logits), label)
    return (dice, logits) if return_logits else dice


@dataclasses.dataclass
class EpochMetrics:
    """Reference-style nan-weighted accumulators for mean and per-class Dice."""

    sums: Any = None
    counts: Any = None

    def update(self, scores) -> None:
        if isinstance(scores, torch.Tensor):
            scores = scores.detach().cpu().numpy()
        scores = np.asarray(scores)  # (B, C)
        finite = np.isfinite(scores)
        per_class_sum = np.where(finite, scores, 0.0).sum(axis=0)
        per_class_cnt = finite.sum(axis=0)
        overall = np.nanmean(scores, axis=1)  # per-sample class mean
        o_finite = np.isfinite(overall)
        row = np.concatenate([[np.where(o_finite, overall, 0.0).sum()],
                              per_class_sum])
        cnt = np.concatenate([[o_finite.sum()], per_class_cnt])
        if self.sums is None:
            self.sums, self.counts = row, cnt
        else:
            self.sums = self.sums + row
            self.counts = self.counts + cnt

    def result(self):
        with np.errstate(invalid="ignore", divide="ignore"):
            vals = self.sums / self.counts
        return {"mean": float(vals[0]),
                "per_class": [float(v) for v in vals[1:]]}
