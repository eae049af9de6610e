"""The numbers that decide ``correct``: gaps between what the measured
program produced and what the plain reference computes from the same
inputs and weights."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Sequence

import torch

# a leaf whose reference gradient is below this share of the median leaf's
# moves under Adam by round-off alone (a bias under a normalisation)
STILL_LEAF = 1e-3


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref`` hold ``losses`` (one a step), ``mean_loss``
    (their mean, as the chunk returns it), ``grad`` (the norm of each leaf's
    first gradient as the optimizer takes it) and ``change`` (the norm of
    each leaf's change over the steps).

    A leaf's gap is the gap between its two norms, against the larger of
    that leaf's reference norm and the median leaf's; leaves the reference
    holds still are left out of the change. Returns the widest loss gap and,
    for the gradient and the change, the median leaf's gap (``*_median``,
    the numbers compared) and the worst leaf's (``*_worst``: a one-number
    PReLU slope sums millions of terms that cancel, so its gap is the noise
    of one small leaf and swings from seed to seed). The loss gap is the
    widest over the steps and the mean."""
    if len(prog["losses"]) != len(ref["losses"]):
        return {k: math.inf for k in ("loss_gap", "grad_gap_median", "change_gap_median",
                                      "grad_gap_worst", "change_gap_worst")}
    loss_gap = max(abs(a - b) for a, b in zip(prog["losses"] + [prog["mean_loss"]],
                                              ref["losses"] + [ref["mean_loss"]]))
    gmed = statistics.median(ref["grad"].values())
    grad = [abs(prog["grad"][k] - g) / max(g, gmed) for k, g in ref["grad"].items()]
    moving = [k for k, g in ref["grad"].items() if g >= STILL_LEAF * gmed]
    cmed = statistics.median(ref["change"][k] for k in moving)
    change = [abs(prog["change"][k] - ref["change"][k]) / max(ref["change"][k], cmed)
              for k in moving]
    return {"loss_gap": loss_gap,
            "grad_gap_median": statistics.median(grad), "change_gap_median": statistics.median(change),
            "grad_gap_worst": max(grad), "change_gap_worst": max(change)}


def rel_max_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest absolute difference over the reference's largest magnitude."""
    got, want = got.float(), want.float()
    return float((got - want).abs().amax() / want.abs().amax().clamp_min(1e-30))


def dice_gap(got: Sequence[float], want: Sequence[float]) -> float:
    """Widest gap between two ``(mean, ET, TC, WT)`` tuples; a value defined
    on one side only counts as a gap of 1."""
    worst = 0.0
    for a, b in zip(got, want):
        if (a != a) != (b != b):
            return 1.0
        if a == a:
            worst = max(worst, abs(a - b))
    return worst
