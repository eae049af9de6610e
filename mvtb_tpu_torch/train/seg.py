"""Segmentation training and evaluation (counterpart of
mvtb_tpu/train/seg.py).

The training step is the reference's hot loop: fused k-space stylization
of the batch (outside the gradient) -> UNet forward and backward ->
``dice_loss`` -> optimizer step. :func:`reference_optimizer` is the JAX
package's ``optax.chain(add_decayed_weights(1e-5), amsgrad(1e-4))``
written out. It is NOT ``torch.optim.Adam(amsgrad=True)``: optax keeps the
running max of the BIAS-CORRECTED second moment, torch the max of the raw
moment, corrected afterwards, so the two part after the first step (a
gradient of 1 then 0 gives a step-2 denominator of 1.0 in optax and 0.707
in torch).

The evaluation step is :func:`seg_eval_step` (corrupted validation), with
:class:`EpochMetrics`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.eval.dice import dice_scores, threshold_predictions
from mvtb_tpu_torch.ops.fused import StageDraws, StylizeConfig, sample_draws, stylize_batch
from mvtb_tpu_torch.parallel import dp
from mvtb_tpu_torch.train.losses import dice_loss
from mvtb_tpu_torch.utils.profiling import span


# optax.amsgrad's defaults, which the reference keeps
B1, B2, EPS = 0.9, 0.999, 1e-8


class ReferenceAmsgrad(torch.optim.Optimizer):
    """``optax.chain(add_decayed_weights(wd), amsgrad(lr))``, with optax's
    b1 = 0.9, b2 = 0.999 and eps = 1e-8 (outside the square root).

    Per parameter and step t (from 1), in float32:

        g = grad + wd * p                      (coupled L2)
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * g**2 + b2 * nu
        nu_max = max(nu_max, nu / (1 - b2**t))
        p = p - lr * (mu / (1 - b1**t)) / (sqrt(nu_max) + eps)

    The state of each parameter holds ``mu``, ``nu``, ``nu_max`` and the
    step ``count``, as optax's ``ScaleByAmsgradState``.

    The parameters that share a count are updated together, each line
    above one ``torch._foreach_*`` call over all of them (on the card a
    few multi-tensor launches a call, not one launch a parameter), with
    the same float32 operations in the same order.
    """

    def __init__(self, params, lr: float = 1e-4, weight_decay: float = 1e-5):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            by_count = {}
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                    st["nu_max"] = torch.zeros_like(p)
                st["count"] += 1
                by_count.setdefault(st["count"], []).append(p)
            for t, ps in by_count.items():
                self._update(ps, t, group["lr"], group["weight_decay"])
        return loss

    def _update(self, ps: List[torch.Tensor], t: int, lr: float, wd: float) -> None:
        sts = [self.state[p] for p in ps]
        mu, nu, nu_max = ([st[k] for st in sts] for k in ("mu", "nu", "nu_max"))
        g = torch._foreach_mul(ps, wd)
        torch._foreach_add_(g, [p.grad for p in ps])
        d = torch._foreach_mul(g, 1 - B1)
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, d)
        torch._foreach_mul_(g, g)
        torch._foreach_mul_(g, 1 - B2)
        torch._foreach_mul_(nu, B2)
        torch._foreach_add_(nu, g)
        # optax's bias corrections: 1 - decay**count in float32, handed to
        # the division as the exact float32 scalar (no host-to-device copy)
        bc1 = float(1 - torch.tensor(B1, dtype=torch.float32) ** t)
        bc2 = float(1 - torch.tensor(B2, dtype=torch.float32) ** t)
        torch._foreach_maximum_(nu_max, torch._foreach_div(nu, bc2))
        d = torch._foreach_sqrt(nu_max)
        torch._foreach_add_(d, EPS)
        g = torch._foreach_div(mu, bc1)
        torch._foreach_div_(g, d)
        torch._foreach_mul_(g, -lr)
        torch._foreach_add_(ps, g)


def reference_optimizer(params: Iterable, lr: float = 1e-4,
                        weight_decay: float = 1e-5) -> ReferenceAmsgrad:
    """The reference's optimizer (``baseline.py:209-210``): Adam(lr) with
    amsgrad and coupled L2 weight decay, computed as optax computes it
    (:class:`ReferenceAmsgrad`)."""
    return ReferenceAmsgrad(params, lr=lr, weight_decay=weight_decay)


@dataclasses.dataclass
class SegState:
    """Model, optimizer and the count of steps taken (the port's
    counterpart of the flax ``TrainState``; updated in place)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_seg_state(model: torch.nn.Module,
                     optimizer: Optional[torch.optim.Optimizer] = None,
                     device: DeviceLike = None) -> SegState:
    """Move ``model`` to ``device`` (None means ``"cuda"``) and pair it with
    ``optimizer``, by default :func:`reference_optimizer` over its
    parameters. Any optimizer works, as the JAX function takes any ``tx``."""
    dev = resolve_device(device)
    model = model.to(dev)
    if optimizer is None:
        optimizer = reference_optimizer(model.parameters())
    return SegState(model=model, optimizer=optimizer)


def seg_train_step(state: SegState, image: torch.Tensor, label: torch.Tensor,
                   stylize_cfg: Optional[StylizeConfig] = None,
                   augment_label: bool = False, remat: bool = False,
                   draws: Optional[StageDraws] = None,
                   label_draws: Optional[StageDraws] = None,
                   generator: Optional[torch.Generator] = None,
                   device: DeviceLike = None, mesh=None) -> torch.Tensor:
    """One forward, backward and update step; returns the (detached) loss.

    ``image`` and ``label`` are channel-first ``(B, C, *spatial)``.
    ``stylize_cfg`` corrupts the image first, outside the gradient (and the
    label too, with its own draws, when ``augment_label``); ``draws`` /
    ``label_draws`` fix the random parameters, else they come from
    ``generator``. ``remat`` recomputes the forward during the backward
    (``torch.utils.checkpoint``), trading compute for activation memory.
    ``device=None`` means ``"cuda"``; the state must already live there.

    ``mesh`` (a :class:`~mvtb_tpu_torch.parallel.mesh.Mesh`) makes the step
    data-parallel: ``image`` and ``label`` are this rank's rows of the
    global batch, the draws are the global batch's (``draws`` given, or
    drawn from ``generator``, which must then be seeded alike on every
    rank) cut to its rows, the gradients are averaged over ``data`` before
    the optimizer, and the loss returned is the global mean. The state is
    the replicated one (:func:`~mvtb_tpu_torch.parallel.mesh.replicate`), or
    tensor-parallel (:func:`~mvtb_tpu_torch.parallel.tp.shard_state_tp`).
    """
    dev = resolve_device(device)
    with span("mvtb.step"):
        image, label = image.to(dev), label.to(dev)
        if stylize_cfg is not None and stylize_cfg.any_enabled:
            with span("mvtb.step.stylize"):
                image = _stylize(image, stylize_cfg, draws, generator, dev, mesh)
                if augment_label:
                    label = _stylize(label, stylize_cfg, label_draws, generator, dev, mesh)
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=True)
        if remat:
            logits = checkpoint(model, image, use_reentrant=False)
        else:
            logits = model(image)
        loss = dice_loss(logits, label)
        loss.backward()
        with span("mvtb.step.optimizer"):
            if mesh is not None:
                dp.mean_gradients(model.parameters(), mesh)
            opt.step()
        state.step += 1
        return loss.detach() if mesh is None else dp.global_mean(loss, mesh)


def _stylize(x: torch.Tensor, cfg: StylizeConfig, draws: Optional[StageDraws],
             generator: Optional[torch.Generator], dev: torch.device,
             mesh) -> torch.Tensor:
    """``stylize_batch`` of a batch, or of this rank's rows of the global
    batch under a mesh (the global draws cut to its rows)."""
    if mesh is not None:
        B = x.shape[0]
        if draws is None:
            draws = sample_draws(cfg, x.shape[2:], dp.global_batch_size(mesh, B),
                                 x.shape[1], generator=generator, device=dev)
        draws = draws.rows(dp.data_rows(mesh, B))
    return stylize_batch(x, cfg, draws=draws, generator=generator, device=dev)


def train_segmentation(state: SegState, data_iter, num_steps: int,
                       stylize_cfg: Optional[StylizeConfig] = None,
                       generator: Optional[torch.Generator] = None,
                       log_every: int = 0,
                       log_fn: Callable[[str], None] = print,
                       device: DeviceLike = None) -> List[float]:
    """Simple host loop driving :func:`seg_train_step` over ``(image,
    label)`` pairs from ``data_iter``; returns the per-step losses. The
    losses are read back once at the end (or at each log line), so the
    loop does not wait for the card every step."""
    losses = []
    for step in range(num_steps):
        image, label = next(data_iter)
        loss = seg_train_step(state, image, label, stylize_cfg,
                              generator=generator, device=device)
        losses.append(loss)
        if log_every and (step + 1) % log_every == 0:
            log_fn(f"step {step + 1}/{num_steps} loss {float(loss):.4f}")
    return [float(l) for l in losses]


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
