"""Real-data drop-in rehearsal: the whole BraTS experiment flow as one
command (the port of ``examples/brats_rehearsal.py``).

    python -m mvtb_tpu_torch.examples.brats_rehearsal --root_dir /data/decathlon

runs, in order, what a reference user runs across ``baseline.py`` and
``comparison_on_gibbs.ipynb`` (``utils.py:159-235``):

1. ingest and preprocess: a Decathlon ``dataset.json`` tree of ``.nii.gz``
   volumes through the reference train pipeline (spacing 1.5/1.5/2.0, RAS,
   crop, nonzero-normalize), one random crop a volume into a pool on the
   card;
2. train: the 3D ResUNet 4 -> 3 with Dice loss in chunks
   (``train_chunked``), a checkpoint at the end (``ckpt/<steps>.pt``);
3. sweep: ``BratsValIterDataset`` across the clean set and Gibbs disk radii;
4. tables: ``ModelEvaluation.add_eval`` per dataset, saved as JSON and
   pickle;
5. plot: ``plot_model_performance``, where matplotlib imports.

When no ``dataset.json`` exists under ``--root_dir`` a textured tree is
synthesized there first (``--synthesize`` forces it), with the port's own
NIfTI writer, so the flow is rehearsed end to end; with real BraTS only
``--root_dir`` changes. Outputs go to ``--out_dir`` (default
``runs_torch/brats_rehearsal``); ``summary.json`` has the JAX script's keys.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.examples import _common as C


def run(root_dir: str, out_dir: Optional[str] = None, steps: int = 400, batch: int = 2,
        chunk: int = 50, roi: Sequence[int] = (128, 128, 64),
        pixdim: Sequence[float] = (1.5, 1.5, 2.0),
        gibbs_radii: Sequence[float] = (25.0, 15.0, 9.0), synthesize: bool = False,
        n_volumes: int = 12, raw_size: Sequence[int] = (144, 144, 80), seed: int = 0,
        device: DeviceLike = None, unet: Optional[dict] = None,
        model_dtype: str = "bfloat16", log=print) -> dict:
    """The five steps; writes ``summary.json`` and returns it. ``unet`` /
    ``model_dtype`` shrink the full-width bf16 UNet (tests)."""
    from mvtb_tpu_torch.data.brats_sweep import BratsValIterDataset
    from mvtb_tpu_torch.data.nifti import DecathlonDataset
    from mvtb_tpu_torch.data.pipeline import brats_train_pipeline
    from mvtb_tpu_torch.data.synthetic import build_decathlon_tree
    from mvtb_tpu_torch.eval.harness import ModelEvaluation
    from mvtb_tpu_torch.train.checkpoint import CheckpointManager
    from mvtb_tpu_torch.train.chunked import train_chunked
    from mvtb_tpu_torch.transforms import RandFourierDiskMaskd

    dev = resolve_device(device)
    out_dir = out_dir or C.outdir("brats_rehearsal")
    os.makedirs(out_dir, exist_ok=True)
    roi, pixdim = tuple(roi), tuple(pixdim)
    manifest = os.path.join(root_dir, "Task01_BrainTumour", "dataset.json")
    if synthesize or not os.path.exists(manifest):
        log(f"[rehearsal] no dataset at {manifest}; synthesizing {n_volumes} textured "
            f"volumes {tuple(raw_size)}")
        # the affine matches the target pixdim, so the synthetic leg runs the
        # whole pipeline without resampling made-up geometry
        build_decathlon_tree(root_dir, n=n_volumes, spatial=tuple(raw_size), kind="textured",
                             seed=seed, affine=np.diag(list(pixdim) + [1.0]))

    t0 = time.perf_counter()
    # 1. ingest + preprocess the training section into a pool on the card
    train_ds = DecathlonDataset(root_dir, "Task01_BrainTumour",
                                transform=brats_train_pipeline(roi_size=roi, pixdim=pixdim),
                                section="training",
                                cache_dir=os.path.join(out_dir, "cache_train"))
    imgs, lbls = [], []
    for i in range(len(train_ds)):
        s = train_ds[i]
        imgs.append(np.asarray(s["image"], np.float32))
        lbls.append(np.asarray(s["label"], np.float32))
    pool_i, pool_l = C.on(dev, np.stack(imgs), np.stack(lbls))
    log(f"[rehearsal] preprocessed {len(imgs)} training volumes {tuple(pool_i.shape)} in "
        f"{time.perf_counter() - t0:.0f}s")

    # 2. train
    state = C.seg_state(4, 3, seed, dev, model_dtype, unet)
    state, losses = train_chunked(
        state, pool_i, pool_l, steps=steps, batch_size=batch,
        generator=torch.Generator(device=dev).manual_seed(seed + 1), chunk=chunk,
        log=log, name="rehearsal", device=dev)
    ckpt_dir = os.path.abspath(os.path.join(out_dir, "ckpt"))
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(steps, state)
    mgr.wait()
    mgr.close()
    log(f"[rehearsal] trained {steps} steps; checkpoint at {ckpt_dir}")

    # 3. the corruption sweep over the validation section (the val pipeline
    # plus the appended corruption, BratsValIterDataset's semantics)
    sweep_transforms = {"baseline_data": None}
    for r in gibbs_radii:
        sweep_transforms[f"gibbs{r:g}_data"] = RandFourierDiskMaskd(
            keys="image", r=r, inside_off=False, prob=1.0, device=dev)
    sweep = BratsValIterDataset(root_dir, cache_num=50, transforms=sweep_transforms,
                                return_loader=True, roi_size=roi, pixdim=pixdim)

    # 4. evaluation tables
    me = ModelEvaluation(state.model, instance_name="rehearsal_model", in_channels=4,
                         out_channels=3, device=dev)
    for name, loader in sweep:
        me.add_eval(name, loader)
        log(f"[rehearsal] {name}: {me.eval_dict[name]}")
    table_path = me.save(os.path.join(out_dir, "rehearsal_model"))

    # 5. plot
    def plot():
        from mvtb_tpu_torch.eval.plots import plot_model_performance

        return plot_model_performance({"rehearsal_model": me.eval_dict},
                                      os.path.join(out_dir, "model_performance.png"))

    png = C.best_effort_plot(plot, log)
    summary = {"root_dir": root_dir, "steps": steps,
               "final_loss": losses[-1]["loss"] if losses else None,
               "eval": {k: [float(x) for x in v] if isinstance(v, (tuple, list)) else float(v)
                        for k, v in me.eval_dict.items()},
               "tables": table_path, "plot": png, "checkpoint": ckpt_dir,
               "wall_s": round(time.perf_counter() - t0, 1)}
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    log(f"[rehearsal] done in {summary['wall_s']}s -> {out_dir}")
    return summary


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root_dir", required=True,
                   help="Decathlon root (contains Task01_BrainTumour)")
    p.add_argument("--out_dir", default=C.outdir("brats_rehearsal"))
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--chunk", type=int, default=50)
    p.add_argument("--roi", type=int, nargs=3, default=[128, 128, 64])
    p.add_argument("--pixdim", type=float, nargs=3, default=[1.5, 1.5, 2.0])
    p.add_argument("--gibbs_radii", type=float, nargs="+", default=[25.0, 15.0, 9.0],
                   help="disk radii for the corruption sweep")
    p.add_argument("--synthesize", action="store_true",
                   help="force building a synthetic tree at root_dir")
    p.add_argument("--n_volumes", type=int, default=12, help="synthetic tree size")
    p.add_argument("--raw_size", type=int, nargs=3, default=[144, 144, 80],
                   help="synthetic raw volume size (pre-crop)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    a = parse_args(argv)
    return run(a.root_dir, a.out_dir, a.steps, a.batch, a.chunk, a.roi, a.pixdim,
               a.gibbs_radii, a.synthesize, a.n_volumes, a.raw_size, a.seed, a.device)


if __name__ == "__main__":
    main()
