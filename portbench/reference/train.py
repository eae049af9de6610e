"""Plain training steps: disk low-pass -> UNet -> Dice loss -> amsgrad,
with the batch's gradient summed over blocks of rows so that a large batch
fits (the loss is a mean over independent per-sample terms, and the model
normalises each sample alone)."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
from torch.func import functional_call

from portbench.reference.dice import dice_loss_terms
from portbench.reference.optim import Amsgrad
from portbench.reference.stylize import disk_lowpass
from portbench.reference.unet import UNet


def build(model_cfg: dict, weights: Dict[str, torch.Tensor], device) -> UNet:
    m = UNet(model_cfg["in_channels"], model_cfg["out_channels"], model_cfg["channels"],
             model_cfg["strides"], model_cfg["num_res_units"]).to(device)
    m.load_state_dict(weights)
    return m


def loss_and_grads(model: UNet, params: Dict[str, torch.Tensor], images, labels,
                   r: Optional[float], quant: Optional[Callable] = None,
                   block: int = 4, rows: Optional[slice] = None):
    """(loss, grads) of one batch. ``rows`` keeps only those rows and
    averages over them (a planted fault: part of the batch left out)."""
    if rows is not None:
        images, labels = images[rows], labels[rows]
    B, C = images.shape[0], labels.shape[1]
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    total = 0.0
    for b0 in range(0, B, block):
        x = disk_lowpass(images[b0:b0 + block], r, quant)
        logits = functional_call(model, leaves, (x,), {"quant": quant})
        part = dice_loss_terms(logits, labels[b0:b0 + block], quant).sum() / (B * C)
        g = torch.autograd.grad(part, list(leaves.values()))
        for k, gi in zip(leaves, g):
            grads[k] += gi
        total += float(part.detach())
    return total, grads


def train_steps(model_cfg: dict, weights: Dict[str, torch.Tensor], batches: List,
                r: Optional[float], lr: float, wd: float, device,
                quant: Optional[Callable] = None, block: int = 4,
                fault: Optional[str] = None):
    """Run ``len(batches)`` steps from ``weights``; returns the losses, the
    first gradient as the optimizer takes it (``grad + wd * p``), the
    gradient of step 1 alone, and the final parameters.

    ``fault`` plants one of the faults the comparison has to catch:
    ``"half_batch"`` averages each step over the first half of its rows."""
    model = build(model_cfg, weights, device)
    params = {k: v.detach().clone().float() for k, v in model.state_dict().items()}
    opt = Amsgrad(params, lr, wd)
    losses, first = [], None
    for images, labels in batches:
        rows = slice(0, images.shape[0] // 2) if fault == "half_batch" else None
        loss, grads = loss_and_grads(model, params, images, labels, r, quant, block, rows)
        if first is None:
            first = {k: grads[k] + wd * params[k] for k in params}
        opt.step(grads)
        losses.append(loss)
    return losses, first, params
