"""Roundings for the controls: the reference computed one precision below
what a configuration states.

A rounding keeps the value in float32. ``fp8`` rounds a matrix product's
operands to float8 e4m3 on the way forward, and its ``grad`` rounds the
gradient that reaches a product's output to float8 e5m2 on the way back,
as fp8 training computes all three products of a layer; ``bf16`` rounds to
bfloat16. The gradient of a rounding is passed through unrounded (a
straight-through rounding), so a control differs from the reference by the
roundings alone.
"""

from __future__ import annotations

import torch

FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _round(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` with one scale per tensor (its largest
    magnitude onto the format's largest value), as fp8 products take their
    operands; returned in ``t``'s type."""
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = FP8_MAX[dtype] / amax
    return ((t.detach().float() * scale).to(dtype).float() / scale).to(t.dtype)


class _GradFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def fp8(t: torch.Tensor) -> torch.Tensor:
    return t + (_round(t, torch.float8_e4m3fn) - t).detach()


fp8.grad = _GradFp8.apply


def bf16(t: torch.Tensor) -> torch.Tensor:
    q = t.detach().to(torch.bfloat16).to(t.dtype)
    return t + (q - t).detach()


ROUNDINGS = {"fp8": fp8, "bf16": bf16}


def below(precision: str) -> str:
    """The rounding one step below a stated precision."""
    return {"bfloat16": "fp8", "float32": "bf16"}[precision]
