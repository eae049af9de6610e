"""NaN-aware hard Dice (counterpart of mvtb_tpu/eval/dice.py).

MONAI ``DiceMetric(include_background=True, reduction="mean")`` semantics: a
(sample, class) pair whose prediction and ground truth are both empty has
undefined Dice, NaN. The port keeps PyTorch's channel-first layout:
``(B, C, *spatial)``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def dice_scores(y_pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-(batch, channel) Dice ``2|X∩Y| / (|X|+|Y|)`` of binarized
    channel-first inputs; NaN where the denominator is zero.
    ``(B, C, *spatial)`` -> ``(B, C)``."""
    axes = tuple(range(2, y_pred.ndim))
    y = y.to(y_pred.dtype)
    intersection = torch.sum(y_pred * y, dim=axes)
    denom = torch.sum(y_pred, dim=axes) + torch.sum(y, dim=axes)
    nan = torch.full_like(denom, float("nan"))
    return torch.where(denom > 0, 2.0 * intersection / denom, nan)


def dice_metric(y_pred: torch.Tensor, y: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean Dice over defined entries and the count of defined entries,
    ``(mean, not_nans)``, as the reference's per-batch ``dice_metric``."""
    f = dice_scores(y_pred, y)
    finite = torch.isfinite(f)
    not_nans = finite.sum()
    total = torch.where(finite, f, torch.zeros_like(f)).sum()
    mean = torch.where(not_nans > 0, total / not_nans,
                       torch.full_like(total, float("nan")))
    return mean, not_nans


def threshold_predictions(logits: torch.Tensor,
                          threshold: float = 0.5) -> torch.Tensor:
    """Sigmoid, then binarize at ``threshold``, written as the JAX package
    writes it (``1 / (1 + exp(-x))``) so both round alike at the boundary."""
    probs = 1.0 / (1.0 + torch.exp(-logits))
    return (probs >= threshold).to(logits.dtype)
