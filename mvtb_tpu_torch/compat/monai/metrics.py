"""``monai.metrics.DiceMetric`` over :mod:`mvtb_tpu_torch.eval.dice`.

MONAI 0.4's call convention as the reference uses it
(``baseline.py:261,277-301``): ``value, not_nans = dice_metric(y_pred=...,
y=...)``, a NaN-aware mean over the defined (sample, class) entries, as 0-d
tensors on the prediction's device."""

from __future__ import annotations

import torch

from mvtb_tpu_torch.eval.dice import dice_metric, dice_scores


class DiceMetric:
    def __init__(self, include_background: bool = True,
                 reduction: str = "mean", **_ignored):
        if not include_background:
            raise NotImplementedError("the reference always uses include_background=True")
        self.reduction = reduction

    def __call__(self, y_pred, y):
        pred = torch.as_tensor(y_pred)
        tgt = torch.as_tensor(y).to(pred.device)
        if self.reduction in ("mean", "mean_batch"):
            return dice_metric(pred, tgt)
        if self.reduction == "none":
            return dice_scores(pred, tgt), None
        raise NotImplementedError(self.reduction)
