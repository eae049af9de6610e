"""Losses (counterpart of mvtb_tpu/train/losses.py).

``dice_loss`` is MONAI's ``DiceLoss`` as the reference configures it
(``sigmoid=True, squared_pred=True, include_background=True,
smooth_nr=smooth_dr=1e-5``, mean over batch and channel). The port keeps
PyTorch's channel-first layout, ``(B, C, *spatial)``, where the JAX package
takes channel-last arrays. Arithmetic runs in the inputs' types, as in the
JAX package: bfloat16 logits give a bfloat16 sigmoid.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def dice_loss(logits: torch.Tensor, targets: torch.Tensor, *,
              sigmoid: bool = True, squared_pred: bool = True,
              smooth_nr: float = 1e-5, smooth_dr: float = 1e-5,
              include_background: bool = True,
              sum_over: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
              ) -> torch.Tensor:
    """Soft Dice loss over channel-first ``(B, C, *spatial)`` tensors:
    ``1 - (2*intersection + nr) / (sum(p^2) + sum(t^2) + dr)`` per
    (batch, channel), averaged. ``sum_over`` completes each spatial sum
    when the volume is split over processes (an all-reduce)."""
    pred = logits
    if sigmoid:
        pred = 1.0 / (1.0 + torch.exp(-pred))
    if not include_background and pred.shape[1] > 1:
        pred = pred[:, 1:]
        targets = targets[:, 1:]
    axes = tuple(range(2, pred.ndim))
    total = (lambda t: torch.sum(t, dim=axes)) if sum_over is None else (
        lambda t: sum_over(torch.sum(t, dim=axes)))
    intersection = total(targets * pred)
    if squared_pred:
        denom = total(targets ** 2) + total(pred ** 2)
    else:
        denom = total(targets) + total(pred)
    f = 1.0 - (2.0 * intersection + smooth_nr) / (denom + smooth_dr)
    return torch.mean(f)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on raw logits (optax's
    ``sigmoid_binary_cross_entropy``, torch's ``BCEWithLogitsLoss``)."""
    return torch.mean(-labels * F.logsigmoid(logits)
                      - (1.0 - labels) * F.logsigmoid(-logits))


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)
