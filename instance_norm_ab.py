#!/usr/bin/env python3
"""The ReconGAN instance norm's statistics in two forms, on one card.

    python3 instance_norm_ab.py

from the root of a checkout, with one CUDA card. The port's norm
(``mvtb_tpu_torch/models/resunet_gan.py:_instance_norm``) computes its
variance in two passes, ``mean((x - mean(x))^2)``; flax's ``GroupNorm``
computes one pass, ``max(0, mean(x^2) - mean(x)^2)``. Both give the same
values up to rounding. This script times ``recon_gan_step`` (the Gibbs
GAN's configuration: registry width nf = 16, batch 4, 128x128, the 2D Gibbs
compress, the frequency-consistency loss) with each form in turns, 4
rounds of 8 steps after one warm-up step, each step bracketed by
``torch.cuda.synchronize()``, and counts the device operations of one step
with ``torch.profiler``. It prints one JSON line with the card's
``nvidia-smi`` name and power limit. Exits 2 without a card.
"""

import json
import statistics
import subprocess
import sys
import time

import torch

ROUNDS, STEPS = 4, 8


def one_pass(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """flax's statistics: ``jnp.maximum(0, E[x^2] - E[x]^2)``, the tie's
    gradient split as ``torch.maximum`` splits it."""
    axes = tuple(range(2, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = (x * x).mean(dim=axes, keepdim=True) - mean * mean
    return (x - mean) * torch.rsqrt(torch.maximum(var, var.new_zeros(())) + eps)


def main() -> int:
    if not torch.cuda.is_available():
        print("instance_norm_ab: no CUDA device is visible; nothing was run", file=sys.stderr)
        return 2
    from mvtb_tpu_torch.models import resunet_gan as rg
    from mvtb_tpu_torch.train.gan import create_gan_state, recon_gan_step, sample_recon_draws

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    forms = {"two_pass": rg._instance_norm, "one_pass": one_pass}
    dev = torch.device("cuda")
    torch.manual_seed(0)
    g = create_gan_state(rg.ResUnetGenerator(1, 16, global_residual=False, device=dev), 1e-4)
    d = create_gan_state(rg.ResUnetDiscriminator(1, 16, device=dev), 1e-4)
    gen = torch.Generator(device=dev).manual_seed(1)
    real = torch.rand(4, 1, 128, 128, generator=gen, device=dev) * 2 - 1
    draws = sample_recon_draws("gibbs", real.shape, gen, device=dev)

    def step():
        recon_gan_step(g, d, real, draws, alpha=15.0, gamma=0.1, freq_domain=True,
                       compress_kind="gibbs")

    ms, ops = {k: [] for k in forms}, {}
    try:
        for r in range(ROUNDS):
            for name in (list(forms) if r % 2 == 0 else list(forms)[::-1]):
                rg._instance_norm = forms[name]
                step()
                for _ in range(STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step()
                    torch.cuda.synchronize()
                    ms[name].append((time.perf_counter() - t0) * 1e3)
        for name, f in forms.items():
            rg._instance_norm = f
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
            ops[name] = sum(e.count for e in prof.key_averages()
                            if e.device_type == torch.autograd.DeviceType.CUDA)
    finally:
        rg._instance_norm = forms["two_pass"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "ms_per_step": ms,
                      "median_ms": {k: statistics.median(v) for k, v in ms.items()},
                      "quartiles_ms": {k: statistics.quantiles(v, n=4) for k, v in ms.items()},
                      "device_ops_per_step": ops}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
