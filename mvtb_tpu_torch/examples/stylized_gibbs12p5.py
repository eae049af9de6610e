"""Stylized-Gibbs training script in the reference's own style (the port of
``examples/stylized_gibbs12p5.py``).

It follows the structure of the reference's
``10_scripts/20_Gibbs_filters/stylized_gibbs12p5.py`` (experiment
constants, the transform pipeline with the corruption appended, UNet +
Dice loss + Adam, an epoch loop with periodic Dice validation and
best-checkpointing), its corruption imported by the reference's bare name
through the port's shims (``mvtb_tpu_torch.compat``): a reference
experiment spec reruns on the port.

Run on the card: ``python -m mvtb_tpu_torch.examples.stylized_gibbs12p5``
(synthetic data stands in for BraTS; DATA_ROOT points it at a Decathlon
``Task01_BrainTumour`` tree). Env: MAX_EPOCHS, STEPS_PER_EPOCH, DATA_ROOT,
WORKDIR (default ``runs_torch/gibbs12.5``).
"""

from __future__ import annotations

import importlib
import os
from typing import Optional

import torch

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.examples import _common as C

KNOBS = {"MAX_EPOCHS": ("max_epochs", int), "STEPS_PER_EPOCH": ("steps_per_epoch", int),
         "DATA_ROOT": ("data_root", str), "WORKDIR": ("workdir", str)}

# ---- the experiment constants (the only lines that differ between the ~90
# reference clones)
MASK_RADIUS = 12.5
JOB_NAME = f"gibbs{MASK_RADIUS}"
VAL_INTERVAL = 2
BATCH_SIZE = 2


def reference_corruption(device: torch.device):
    """``RandFourierDiskMaskd`` imported as the reference script imports it,
    ``from filters_and_operators import ...``, once the port's shims are on
    the path (an earlier ``filters_and_operators`` in the process, another
    package's shim, is refused)."""
    from mvtb_tpu_torch import compat

    compat.install()
    fo = importlib.import_module("filters_and_operators")
    expected = os.path.join(os.path.dirname(compat.__file__), "filters_and_operators.py")
    if os.path.abspath(fo.__file__) != os.path.abspath(expected):
        raise RuntimeError(f"filters_and_operators resolves to {fo.__file__}, not the port's")
    return fo.RandFourierDiskMaskd(keys="image", r=MASK_RADIUS, inside_off=False, prob=1.0,
                                   device=device)


def run(max_epochs: int = 4, steps_per_epoch: int = 8, data_root: Optional[str] = None,
        workdir: Optional[str] = None, spatial=(64, 64, 32), device: DeviceLike = None,
        model_dtype: str = "float32", log=print) -> dict:
    """The reference script's loop; returns its ``history`` with the best
    Dice and epoch."""
    from mvtb_tpu_torch.data.pipeline import Loader
    from mvtb_tpu_torch.data.synthetic import decathlon_style_dicts
    from mvtb_tpu_torch.ops.fused import StylizeConfig
    from mvtb_tpu_torch.train import (EpochMetrics, reference_optimizer, seg_eval_step,
                                      seg_train_step)
    from mvtb_tpu_torch.train.checkpoint import CheckpointManager

    dev = resolve_device(device)
    spatial = tuple(spatial)
    workdir = workdir or C.outdir(JOB_NAME)
    corruption = reference_corruption(dev)
    # ---- data: the corruption is part of the spec as the reference writes it;
    # training maps it onto the fused stylize
    if data_root:
        from mvtb_tpu_torch.data import DecathlonDataset, brats_train_pipeline

        train_ds = DecathlonDataset(data_root, "Task01_BrainTumour",
                                    transform=brats_train_pipeline(spatial),
                                    section="training",
                                    cache_dir=os.path.join(workdir, "cache"))
        samples = [train_ds[i] for i in range(len(train_ds))]
    else:
        samples = decathlon_style_dicts(0, 16, channels=4, spatial=spatial, n_classes=3)
    val_samples = [corruption(dict(s)) for s in samples[-4:]]
    train_samples = samples[:-4]
    train_loader = Loader(train_samples, batch_size=BATCH_SIZE, shuffle=True, seed=0)
    val_loader = Loader(val_samples, batch_size=BATCH_SIZE)

    # ---- model / loss / optimizer (baseline.py:198-210)
    state = C.seg_state(4, 3, 0, dev, model_dtype)
    state.optimizer = reference_optimizer(state.model.parameters(), 1e-4, 1e-5)
    n_params = sum(p.numel() for p in state.model.parameters())
    log(f"Model instantiated with number of parameters = {n_params}")
    train_stylize = StylizeConfig(disk_r=MASK_RADIUS, disk_prob=1.0)

    # ---- training loop (baseline.py:232-318)
    os.makedirs(workdir, exist_ok=True)
    ckpt = CheckpointManager(os.path.join(workdir, "ckpt"), best_metric="mean_dice",
                             best_mode="max")
    gen = torch.Generator(device=dev).manual_seed(1)
    best_metric, best_epoch = -1.0, -1
    history = {"loss": [], "dice": [], "epochs": []}
    for epoch in range(max_epochs):
        log("-" * 10)
        log(f"epoch {epoch + 1}/{max_epochs}")
        losses = []
        for batch in train_loader:
            losses.append(seg_train_step(state, torch.from_numpy(batch["image"]),
                                         torch.from_numpy(batch["label"]), train_stylize,
                                         generator=gen, device=dev))
            if len(losses) >= steps_per_epoch:
                break
        epoch_loss = float(torch.stack(losses).float().mean())
        history["loss"].append(epoch_loss)
        log(f"epoch {epoch + 1} average loss: {epoch_loss:.4f}")

        if (epoch + 1) % VAL_INTERVAL == 0:
            metrics = EpochMetrics()
            for batch in val_loader:
                metrics.update(seg_eval_step(state.model, torch.from_numpy(batch["image"]),
                                             torch.from_numpy(batch["label"]), device=dev))
            result = metrics.result()
            history["dice"].append(result)
            history["epochs"].append(epoch + 1)
            tc, wt, et = result["per_class"]
            metric = result["mean"]
            if metric > best_metric:
                best_metric, best_epoch = metric, epoch + 1
                ckpt.save(epoch + 1, state, metrics={"mean_dice": metric})
                log("saved new best metric model")
            log(f"current epoch: {epoch + 1} current mean dice: {metric:.4f} tc: {tc:.4f} "
                f"wt: {wt:.4f} et: {et:.4f}\nbest mean dice: {best_metric:.4f} at epoch: "
                f"{best_epoch}")
    log(f"train completed, best_metric: {best_metric:.4f} at epoch: {best_epoch}")
    ckpt.wait()
    ckpt.close()

    def plot():
        from mvtb_tpu_torch.eval.plots import save_learning_curves

        return save_learning_curves(history, os.path.join(
            workdir, f"trainLoss_and_meanValScore_{JOB_NAME}.png"))

    if C.best_effort_plot(plot, log):
        log(f"learning curves saved to {workdir}")
    return {"history": history, "best_metric": best_metric, "best_epoch": best_epoch}


def main(argv=None) -> dict:
    return C.env_main(run, KNOBS, argv, __doc__.splitlines()[0])


if __name__ == "__main__":
    main()
