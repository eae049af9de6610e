"""Learnable-Gibbs alpha trajectories: finite differences against autograd
(the port of ``examples/learnable_trajectory.py``).

The reference trains ``Gibbs_UNet`` with its alpha moved by two extra
forward passes a step (``gibbs0p7_layer_domain_GD.py:252-298``); the port's
native mode moves the same parameter by autograd through the soft mask.
This runs both modes side by side on the same data and batches (the FD mode
on the hard mask, ``fd_train_step`` with h = 0.01, lr = 0.02; the grad mode
``learnable_train_step``) and writes the trajectory files the reference
logs (``gibbs_trajectory_*.txt``) and, where matplotlib imports, the
overlay plot.

Run on the card: ``python -m mvtb_tpu_torch.examples.learnable_trajectory``.
Env: STEPS, BATCH, SPATIAL, ALPHA0, OUTDIR, SEED. Writes
``<OUTDIR>/learnable_trajectories.json`` (default OUTDIR
``runs_torch/learnable_gd``) with the JAX script's keys.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.examples import _common as C

KNOBS = {"SPATIAL": ("spatial", C.ints), "STEPS": ("steps", int), "BATCH": ("batch", int),
         "ALPHA0": ("alpha0", float), "OUTDIR": ("outdir", str), "SEED": ("seed", int)}


def run(spatial=(64, 64, 32), steps: int = 240, batch: int = 4, alpha0: float = 0.7,
        outdir: Optional[str] = None, seed: int = 0, device: DeviceLike = None,
        log=print) -> dict:
    """Both modes over a pool of 16 textured 1-channel volumes; writes the
    trajectories and the JSON, returns ``{mode: {trajectory, losses,
    final_alpha, wall_s}}``."""
    from mvtb_tpu_torch.models import GibbsUNet
    from mvtb_tpu_torch.train.learnable import (create_learnable_state, fd_train_step,
                                                learnable_train_step)

    dev = resolve_device(device)
    spatial = tuple(spatial)
    outdir = outdir or C.outdir("learnable_gd")
    os.makedirs(outdir, exist_ok=True)
    imgs, lbls = C.textured_pool(seed, 16, spatial, channels=1, classes=1)
    pool_i, pool_l = C.on(dev, imgs, lbls)

    results = {}
    for mode in ("fd", "grad"):
        with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
            torch.manual_seed(seed)
            model = GibbsUNet(alpha_init=alpha0, hard=(mode == "fd"), out_channels=1,
                              channels=(8, 16, 32), strides=(2, 2), num_res_units=1,
                              device=dev)
        state = create_learnable_state(model, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        srng = np.random.RandomState(seed + 7)
        alphas, losses = [], []
        t0 = time.perf_counter()
        for step in range(steps):
            idx = torch.from_numpy(srng.randint(0, pool_i.shape[0], batch)).to(dev)
            img, lbl = pool_i.index_select(0, idx), pool_l.index_select(0, idx)
            if mode == "fd":
                loss, alpha = fd_train_step(state, img, lbl, generator=gen, h=0.01, lr=0.02,
                                            device=dev)
            else:
                loss, alpha = learnable_train_step(state, img, lbl, generator=gen, device=dev)
            alphas.append(alpha)
            losses.append(loss)
            if step % 40 == 0:
                log(f"[{mode}] step {step}/{steps} loss {float(loss):.4f} alpha "
                    f"{float(alpha):.4f} ({time.perf_counter() - t0:.0f}s)")
        traj = torch.stack(alphas).float().cpu().numpy()  # one host read a run
        results[mode] = {"trajectory": [float(a) for a in traj],
                         "losses": [float(v) for v in torch.stack(losses).float().cpu()],
                         "final_alpha": float(traj[-1]),
                         "wall_s": time.perf_counter() - t0}
        np.savetxt(os.path.join(outdir, f"gibbs_trajectory_{mode}.txt"), traj)

    with open(os.path.join(outdir, "learnable_trajectories.json"), "w") as f:
        json.dump({"alpha0": alpha0, "steps": steps, "spatial": spatial,
                   **{m: {k: v for k, v in r.items() if k != "trajectory"}
                      for m, r in results.items()}}, f, indent=2)

    def plot():
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 5))
        for mode, r in results.items():
            ax.plot(r["trajectory"], label=f"{mode} (final {r['final_alpha']:.3f}, "
                    f"{r['wall_s']:.0f}s)")
        ax.set_xlabel("step")
        ax.set_ylabel("alpha")
        ax.set_title(f"Learnable Gibbs alpha from {alpha0}: FD vs autograd")
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(outdir, "alpha_trajectories.png"))
        plt.close(fig)
        log(f"wrote {os.path.join(outdir, 'alpha_trajectories.png')}")

    C.best_effort_plot(plot, log)
    return results


def main(argv=None) -> dict:
    return C.env_main(run, KNOBS, argv, __doc__.splitlines()[0])


if __name__ == "__main__":
    main()
