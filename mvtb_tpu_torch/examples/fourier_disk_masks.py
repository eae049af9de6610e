"""Mask-design gallery -- the reference's ``fourier_images_disk_masks.ipynb``
(44 cells of visual k-space mask exploration) as a script (the port of
``examples/fourier_disk_masks.py``).

For one textured 2-D slice it renders image and log-|k| panels for the
clean slice, low-pass disk filters at several radii (Gibbs ringing), the
high-pass complement (``disk_inside_off``), ``GibbsNoise`` alphas (the
(n-1)/2-centred mask, a different mask from the disk, kept as in the
reference), wraparound and a k-space spike, each through the fused 2-D
stylize on the device it is given (draws from a generator seeded 0).

Run: ``python -m mvtb_tpu_torch.examples.fourier_disk_masks`` (``--device
cpu`` off the card; env OUTDIR, default ``runs_torch/mask_gallery``).
Writes ``<OUTDIR>/fourier_disk_masks.png`` where matplotlib imports.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.examples import _common as C
from mvtb_tpu_torch.ops.fused import StylizeConfig, stylize_batch

KNOBS = {"OUTDIR": ("outdir", str)}


def slice2d() -> np.ndarray:
    """The gallery's slice: z = 4 of a textured 96x96x8 volume from
    ``RandomState(0)``."""
    from mvtb_tpu_torch.data.synthetic import make_textured_volume

    vol, _ = make_textured_volume(np.random.RandomState(0), channels=1, spatial=(96, 96, 8))
    return np.asarray(vol[0, :, :, 4], np.float32)


def cases() -> List[Tuple[str, Optional[StylizeConfig]]]:
    out = [("clean", None)]
    for r in (8.0, 16.0, 32.0):
        out.append((f"disk r={r:g} (low-pass)", StylizeConfig(n_dims=2, disk_r=r)))
    out.append(("disk r=16 inside_off (high-pass)",
                StylizeConfig(n_dims=2, disk_r=16.0, disk_inside_off=True)))
    for a in (0.4, 0.7):
        out.append((f"GibbsNoise alpha={a:g}", StylizeConfig(n_dims=2, gibbs_alpha=a)))
    out.append(("wraparound alpha=0.25", StylizeConfig(n_dims=2, wrap_alpha=0.25)))
    out.append(("k-space spike", StylizeConfig(n_dims=2, spike=True, spike_range=(11.0, 11.0))))
    return out


def panels(device: DeviceLike = None) -> List[Tuple[str, np.ndarray]]:
    """``(title, image)`` of every case, computed on ``device``."""
    dev = resolve_device(device)
    x2d = slice2d()
    x = torch.from_numpy(x2d)[None, None].to(dev)  # (B=1, C=1, H, W)
    out = []
    for title, cfg in cases():
        if cfg is None:
            out.append((title, x2d))
            continue
        g = torch.Generator(device=dev).manual_seed(0)
        out.append((title, stylize_batch(x, cfg, generator=g, device=dev)[0, 0].cpu().numpy()))
    return out


def run(outdir: Optional[str] = None, device: DeviceLike = None, log=print) -> dict:
    """Compute the panels and draw the gallery; returns ``{"panels",
    "path"}`` (``path`` None where matplotlib is missing)."""
    shown = panels(device)
    outdir = outdir or C.outdir("mask_gallery")
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "fourier_disk_masks.png")

    def plot():
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(2, len(shown), figsize=(2.1 * len(shown), 4.6))
        for col, (title, img) in enumerate(shown):
            axes[0, col].imshow(img, cmap="gray", origin="lower")
            axes[0, col].set_title(title, fontsize=8)
            axes[0, col].axis("off")
            k = np.fft.fftshift(np.fft.fft2(img))
            axes[1, col].imshow(np.log(np.abs(k) + 1e-9), cmap="gray", origin="lower")
            axes[1, col].set_title("log |k|", fontsize=7)
            axes[1, col].axis("off")
        fig.suptitle("k-space mask gallery (reference: fourier_images_disk_masks.ipynb)",
                     fontsize=10)
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
        log(f"wrote {path}")
        return path

    return {"panels": shown, "path": C.best_effort_plot(plot, log)}


def main(argv=None) -> dict:
    return C.env_main(run, KNOBS, argv, __doc__.splitlines()[0])


if __name__ == "__main__":
    main()
