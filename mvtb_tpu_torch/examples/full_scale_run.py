"""Reference-scale experiment and resume drill (the port of
``examples/full_scale_run.py``).

Runs a registry config (``gibbs12p5`` by default) at the reference's
training length -- 180 epochs x 194 steps x batch 2 (``baseline.py:219,188``:
388 volumes / batch 2), validation every 2 epochs, checkpoints on -- on
textured synthetic volumes, through the runner's chunked path (one host
read an epoch). Stop it at any point and run it again with ``--resume``: it
continues from the latest checkpoint (``torch.save``, ``ckpt/``) with
continuous loss and Dice curves.

    python -m mvtb_tpu_torch.examples.full_scale_run                # start
    python -m mvtb_tpu_torch.examples.full_scale_run --resume       # continue
    python -m mvtb_tpu_torch.examples.full_scale_run --epochs 60    # shorter

Writes into ``--out_dir`` (default ``runs_torch/full_scale``):
``history.json`` (curves), ``ckpt/``, the learning-curve PNGs where
matplotlib imports, and ``summary.json`` (the JAX script's keys: wall
clock, vol/s, best Dice, resume events).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Union

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.examples import _common as C
from mvtb_tpu_torch.experiments.registry import ExperimentConfig, get
from mvtb_tpu_torch.experiments.runner import run as run_experiment


def run(config: Union[str, ExperimentConfig] = "gibbs12p5", epochs: int = 180,
        steps_per_epoch: int = 194, pool: int = 48, val_batches: int = 12,
        out_dir: Optional[str] = None, resume: bool = False, seed: int = 0,
        device: DeviceLike = None, verbose: bool = True) -> dict:
    """One start or resume of the drill; appends its event to
    ``summary.json`` and returns the summary."""
    dev = resolve_device(device)
    cfg = get(config) if isinstance(config, str) else config
    out_dir = out_dir or C.outdir("full_scale")
    os.makedirs(out_dir, exist_ok=True)
    events_path = os.path.join(out_dir, "summary.json")
    events = []
    if os.path.exists(events_path):
        with open(events_path) as f:
            events = json.load(f).get("events", [])

    t0 = time.perf_counter()
    result = run_experiment(cfg, epochs=epochs, steps_per_epoch=steps_per_epoch, seed=seed,
                            workdir=out_dir, val_batches=val_batches, chunked=True,
                            resume=resume, pool=pool, device=dev, verbose=verbose)
    wall = time.perf_counter() - t0

    start = result.get("resumed_from", 0)
    vols = (epochs - start) * steps_per_epoch * cfg.batch_size
    events.append({"kind": "resume" if resume and start else "start",
                   "from_epoch": start, "to_epoch": epochs, "wall_s": round(wall, 1),
                   "train_vol_per_sec": round(vols / wall, 2) if wall else None})
    summary = {"config": cfg.name, "epochs": epochs, "steps_per_epoch": steps_per_epoch,
               "batch_size": cfg.batch_size, "total_steps": epochs * steps_per_epoch,
               "best_dice": result["best_dice"],
               "final_loss": result["history"]["loss"][-1], "events": events}
    with open(events_path, "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="gibbs12p5")
    p.add_argument("--epochs", type=int, default=180)
    p.add_argument("--steps_per_epoch", type=int, default=194)
    p.add_argument("--pool", type=int, default=48, help="training pool on the card (volumes)")
    p.add_argument("--val_batches", type=int, default=12)
    p.add_argument("--out_dir", default=C.outdir("full_scale"))
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    summary = run(args.config, args.epochs, args.steps_per_epoch, args.pool, args.val_batches,
                  args.out_dir, args.resume, args.seed, args.device)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
