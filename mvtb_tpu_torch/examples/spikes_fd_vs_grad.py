"""FD mode against grad mode for the learnable spike layer (the port of
``examples/spikes_fd_vs_grad.py``).

Does the spike log-intensity move as the estimator predicts? Both
estimators run through the runner's chunked learnable path at matched
data, seed and length:

* FD -- the reference's finite-difference rule with the spikes scripts'
  constants (``spikes11_layer_domain_GD.py:262-277``: h = 0.05, lr = 0.1):
  two extra forwards a step, ``i -= 0.1 * (L(i + h) - L(i)) / h``;
* grad -- the intensity is a parameter moved by the same optimizer as the
  UNet, by autograd through the log-magnitude spike write.

Run on the card: ``python -m mvtb_tpu_torch.examples.spikes_fd_vs_grad``.
Env knobs: EPOCHS (110), STEPS (50 an epoch), OUTDIR (default
``runs_torch/spikes_fd_vs_grad``). Writes ``<OUTDIR>/comparison.json``
with the JAX script's keys, and the trajectory overlay where matplotlib
imports.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Union

import numpy as np

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.examples import _common as C
from mvtb_tpu_torch.experiments.registry import ExperimentConfig, get
from mvtb_tpu_torch.experiments.runner import run as run_experiment

KNOBS = {"EPOCHS": ("epochs", int), "STEPS": ("steps", int), "OUTDIR": ("outdir", str)}


def run(epochs: int = 110, steps: int = 50, outdir: Optional[str] = None,
        config: Union[str, ExperimentConfig] = "spikes11_layer_GD", pool: int = 48,
        device: DeviceLike = None, log=print) -> dict:
    """Both modes of ``config`` (an FD entry); writes and returns
    ``comparison.json``'s contents."""
    dev = resolve_device(device)
    outdir = outdir or C.outdir("spikes_fd_vs_grad")
    os.makedirs(outdir, exist_ok=True)
    base = get(config) if isinstance(config, str) else config
    results = {}
    for mode, cfg in [("fd", base),
                      ("grad", dataclasses.replace(base, name=f"{base.name}_grad",
                                                   fd_mode=False))]:
        r = run_experiment(cfg, epochs=epochs, steps_per_epoch=steps, chunked=True,
                           workdir=os.path.join(outdir, mode), pool=pool, device=dev,
                           verbose=False)
        traj = [float(a) for a in r["trajectory"]]
        results[mode] = {"start": traj[0], "end": traj[-1], "delta": traj[-1] - traj[0],
                         "per_1k_steps": (traj[-1] - traj[0]) / len(traj) * 1000,
                         "final_loss": float(r["losses"][-1]),
                         "trajectory_every_50": traj[::50]}
        log(f"[{mode}] intensity {traj[0]:.3f} -> {traj[-1]:.3f} "
            f"({results[mode]['per_1k_steps']:+.4f}/1k steps)")
    out = {"epochs": epochs, "steps_per_epoch": steps, "fd_h": base.fd_h,
           "fd_lr": base.fd_lr, "results": results}
    with open(os.path.join(outdir, "comparison.json"), "w") as f:
        json.dump(out, f, indent=2)

    def plot():
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(9, 4))
        for mode in results:
            t = results[mode]["trajectory_every_50"]
            ax.plot(np.arange(len(t)) * 50, t, label=f"{mode} mode")
        ax.set_xlabel("step")
        ax.set_ylabel("spike log-intensity")
        ax.legend()
        ax.set_title(f"{base.name}: FD (h={base.fd_h}, lr={base.fd_lr}) vs autograd")
        fig.tight_layout()
        fig.savefig(os.path.join(outdir, "fd_vs_grad.png"), dpi=110)
        plt.close(fig)

    C.best_effort_plot(plot, log)
    return out


def main(argv=None) -> dict:
    return C.env_main(run, KNOBS, argv, __doc__.splitlines()[0])


if __name__ == "__main__":
    main()
