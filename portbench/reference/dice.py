"""Plain Dice: MONAI's ``DiceLoss(sigmoid=True, squared_pred=True)`` with
``smooth_nr = smooth_dr = 1e-5`` (``baseline.py:207``), and the hard Dice of
``DiceMetric(include_background=True)`` after a sigmoid thresholded at 0.5,
reported as the evaluation harness reports it: ``(mean, ET, TC, WT)`` with
label channels (TC, WT, ET)."""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch


def dice_loss_terms(logits: torch.Tensor, labels: torch.Tensor,
                    quant: Optional[Callable] = None) -> torch.Tensor:
    """Per-(sample, channel) soft Dice loss terms; the loss is their mean.
    ``quant`` rounds the sigmoid and each sum (the control's precision)."""
    q = (lambda t: t) if quant is None else quant
    p = q(torch.sigmoid(logits.float()))
    dims = tuple(range(2, p.ndim))
    inter = q((labels * p).sum(dims))
    denom = q(q((labels * labels).sum(dims)) + q((p * p).sum(dims)))
    return 1.0 - (2.0 * inter + 1e-5) / (denom + 1e-5)


def hard_dice(logits: torch.Tensor, labels: torch.Tensor,
              quant: Optional[Callable] = None) -> Tuple[float, ...]:
    """``(mean, ET, TC, WT)`` of one volume's (1, 3, ...) logits: each the
    mean of the defined (non-empty) per-channel Dice values, in float64.
    ``quant`` rounds the sigmoid, each sum and each quotient (the
    control's precision)."""
    q = (lambda t: t) if quant is None else quant
    pred = (q(torch.sigmoid(logits.double())) >= 0.5).double()
    y = labels.double()
    dims = tuple(range(2, pred.ndim))
    inter = q((pred * y).sum(dims))[0]
    denom = q(q(pred.sum(dims)) + q(y.sum(dims)))[0]
    per = [float(q(2 * i / d)) if d > 0 else math.nan for i, d in zip(inter, denom)]
    defined = [v for v in per if not math.isnan(v)]
    mean = sum(defined) / len(defined) if defined else math.nan
    tc, wt, et = per
    return mean, et, tc, wt
