"""DCGAN training and FID report (the port of ``examples/dcgan_fid_report.py``).

The reference's DCGAN (``50_reconstruction/dcgan.py``) is judged by eye
(fixed-noise grids). This trains the registry's ``dcgan`` setup (G and D
at width 64 here, as the JAX script builds them) on 128x128 synthetic
slices and scores a frozen-encoder Frechet distance
(:func:`~mvtb_tpu_torch.eval.fid.dcgan_fid`: a fixed-seed feature net, so
the curve compares across runs of the port) after each round, writing the
FID curve and, where matplotlib imports, a sample grid.

Run on the card: ``python -m mvtb_tpu_torch.examples.dcgan_fid_report``.
Env: ROUNDS, STEPS_PER_ROUND, OUTDIR (default ``runs_torch/dcgan_fid``).
Writes ``<OUTDIR>/fid_curve.json`` with the JAX script's keys.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.examples import _common as C

KNOBS = {"ROUNDS": ("rounds", int), "STEPS_PER_ROUND": ("steps", int),
         "OUTDIR": ("outdir", str)}


def run(rounds: int = 4, steps: int = 60, outdir: Optional[str] = None, nf: int = 64,
        device: DeviceLike = None, log=print) -> dict:
    """``rounds`` x ``steps`` DCGAN iterations with an FID after each round;
    writes and returns ``fid_curve.json``'s contents. ``nf`` is G's and D's
    base width."""
    from mvtb_tpu_torch.eval.fid import dcgan_fid
    from mvtb_tpu_torch.experiments import get
    from mvtb_tpu_torch.experiments.runner import _slices_iter, epoch_generator
    from mvtb_tpu_torch.models import Discriminator, Generator
    from mvtb_tpu_torch.train.gan import create_gan_state, dcgan_step

    dev = resolve_device(device)
    cpu = torch.device("cpu")
    outdir = outdir or C.outdir("dcgan_fid")
    os.makedirs(outdir, exist_ok=True)
    cfg = get("dcgan")
    data_it = _slices_iter(cfg, 0, cfg.batch_size)
    g = Generator(cfg.nz, nf, cfg.in_channels, device=cpu, generator=epoch_generator(0, 0, cpu))
    d = Discriminator(cfg.in_channels, nf, device=cpu, generator=epoch_generator(0, 1, cpu))
    g_state = create_gan_state(g.to(dev), cfg.gan_lr, cfg.gan_beta1)
    d_state = create_gan_state(d.to(dev), cfg.gan_lr, cfg.gan_beta1)
    z_gen = torch.Generator(device=dev).manual_seed(0)

    fid_curve = []
    real_eval = [next(data_it) for _ in range(4)]
    for rnd in range(rounds):
        for _ in range(steps):
            real = C.on(dev, next(data_it))
            z = torch.randn((real.shape[0], cfg.nz, 1, 1), generator=z_gen, device=dev)
            m = dcgan_step(g_state, d_state, real, z)
        fid = dcgan_fid(g_state.model, d_state.model, real_eval,
                        generator=torch.Generator(device=dev).manual_seed(99 + rnd), nz=cfg.nz)
        fid_curve.append({"step": (rnd + 1) * steps, "fid": float(fid),
                          "g_loss": float(m["g_loss"]), "d_loss": float(m["d_loss"])})
        log(f"round {rnd + 1}/{rounds}: step {(rnd + 1) * steps} FID {fid:.2f} "
            f"G {fid_curve[-1]['g_loss']:.3f} D {fid_curve[-1]['d_loss']:.3f}")
    out = {"config": "dcgan", "steps_per_round": steps, "curve": fid_curve}
    with open(os.path.join(outdir, "fid_curve.json"), "w") as f:
        json.dump(out, f, indent=2)

    g_state.model.eval()
    with torch.no_grad():
        z = torch.randn((16, cfg.nz, 1, 1), generator=torch.Generator(device=dev).manual_seed(123),
                        device=dev)
        fake = g_state.model(z).movedim(1, -1).cpu().numpy()
    g_state.model.train()

    def plot():
        from mvtb_tpu_torch.eval.plots import save_image_grid

        save_image_grid(fake, os.path.join(outdir, "samples.png"), nrow=4, title="DCGAN samples")

    C.best_effort_plot(plot, log)
    log(f"wrote {outdir}")
    return out


def main(argv=None) -> dict:
    return C.env_main(run, KNOBS, argv, __doc__.splitlines()[0])


if __name__ == "__main__":
    main()
