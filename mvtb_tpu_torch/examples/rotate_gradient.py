"""Gradient through a geometric parameter, the autograd way (the port of
``examples/rotate_gradient.py``).

The reference's ``350_stylized_layers/rotate.py`` asks whether a gradient
flows through a 2x2 matrix applied to a vector: the proof of concept that
led to the soft (differentiable) Gibbs mask of ``GibbsNoiseLayer``. Here
the rotation is parameterised by its angle, the matrix is built inside the
function, and autograd differentiates end to end: the mechanism
``mvtb_tpu_torch.models.layers.GibbsNoiseLayer`` uses to learn its alpha
without finite differences. Gradient descent turns x-hat onto y-hat
(theta -> pi/2).

Run: ``python -m mvtb_tpu_torch.examples.rotate_gradient`` (``--device
cpu`` off the card).
"""

from __future__ import annotations

import math

import torch

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.examples import _common as C


def rotate(theta: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    m = torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
    return m @ v


def value_and_grad(theta: torch.Tensor, v: torch.Tensor, target: torch.Tensor):
    """``(loss, d loss / d theta)`` of ``sum((rotate(theta, v) - target)**2)``."""
    theta = theta.detach().requires_grad_(True)
    loss = torch.sum((rotate(theta, v) - target) ** 2)
    (grad,) = torch.autograd.grad(loss, theta)
    return loss.detach(), grad


def run(iters: int = 30, lr: float = 0.1, theta0: float = 0.3, device: DeviceLike = None,
        log=print) -> dict:
    """Gradient descent on theta; returns the per-iteration losses and
    thetas and the final theta."""
    dev = resolve_device(device)
    v = torch.tensor([1.0, 0.0], device=dev)
    target = torch.tensor([0.0, 1.0], device=dev)  # x-hat onto y-hat: theta = pi/2
    theta = torch.tensor(theta0, device=dev)
    losses, thetas = [], []
    for it in range(iters):
        val, g = value_and_grad(theta, v, target)
        theta = theta - lr * g
        losses.append(float(val))
        thetas.append(float(theta))
        if it % 5 == 0:
            log(f"it {it:2d} loss {losses[-1]:.6f} theta {thetas[-1]:.4f}")
    log(f"final theta {thetas[-1]:.4f} (target {math.pi / 2:.4f})")
    return {"losses": losses, "thetas": thetas, "final_theta": thetas[-1]}


def main(argv=None) -> dict:
    return C.env_main(run, {}, argv, __doc__.splitlines()[0])


if __name__ == "__main__":
    main()
