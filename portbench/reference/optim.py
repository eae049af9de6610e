"""Plain Adam with amsgrad and coupled L2 (the reference's
``Adam(lr=1e-4, weight_decay=1e-5, amsgrad=True)``, ``baseline.py:209-210``),
with the running maximum taken of the bias-corrected second moment, as the
measured program defines its optimizer. Per leaf and step ``t`` (from 1):

    g = grad + wd * p
    mu = b1 * mu + (1 - b1) * g
    nu = b2 * nu + (1 - b2) * g * g
    nu_max = max(nu_max, nu / (1 - b2**t))
    p = p - lr * (mu / (1 - b1**t)) / (sqrt(nu_max) + eps)
"""

from __future__ import annotations

from typing import Dict

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


class Amsgrad:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float, wd: float):
        self.params, self.lr, self.wd, self.t = params, lr, wd, 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu_max = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        bc1, bc2 = 1 - B1 ** self.t, 1 - B2 ** self.t
        for k, p in self.params.items():
            g = grads[k] + self.wd * p
            self.mu[k] = B1 * self.mu[k] + (1 - B1) * g
            self.nu[k] = B2 * self.nu[k] + (1 - B2) * g * g
            self.nu_max[k] = torch.maximum(self.nu_max[k], self.nu[k] / bc2)
            p -= self.lr * (self.mu[k] / bc1) / (torch.sqrt(self.nu_max[k]) + EPS)
