"""Cross-corruption Dice matrix: every model evaluated on every corruption
(the port of ``examples/cross_corruption_matrix.py``).

The reference's flagship results asset (``20_results/80_common_evaluations/
comparison_on_*.ipynb`` and its pickled ``model_evaluation`` tables): a
grid of stylized-trained models crossed with a grid of corrupted
validation sets, showing diagonal dominance (each stylized model best on
its own corruption) and baseline fragility, at the reference geometry on
textured synthetic data. With ``LEARNABLE=1`` (the default) a learnable row
is added: a ``GibbsUNet`` whose alpha trains by autograd on clean data,
evaluated with its own stylization layer, as the reference evaluates its
layer models.

Run on the card: ``python -m mvtb_tpu_torch.examples.cross_corruption_matrix``
(``FAST=1``: batch 16, every stylize on ``plane_fast``, the hand-written
plane kernel). Env knobs as the JAX script's: SPATIAL, STEPS, BATCH, CHUNK,
POOL, VAL_POOL, OUTDIR, SEED, FAST, LEARNABLE. Writes ``<OUTDIR>/matrix.json``
(the JAX script's keys) and ``matrix.md`` (default OUTDIR
``runs_torch/cross_corruption``), and a grouped-bar figure where matplotlib
imports.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.examples import _common as C
from mvtb_tpu_torch.examples.robustness_gain import evaluate
from mvtb_tpu_torch.ops.fused import StylizeConfig
from mvtb_tpu_torch.train import train_chunked

KNOBS = {"SPATIAL": ("spatial", C.ints), "STEPS": ("steps", int), "BATCH": ("batch", int),
         "CHUNK": ("chunk", int), "POOL": ("pool", int), "VAL_POOL": ("val_pool", int),
         "OUTDIR": ("outdir", str), "SEED": ("seed", int), "FAST": ("fast", C.flag),
         "LEARNABLE": ("learnable", C.flag)}

SHELL = (55.0, 55.0, 30.0)


def grids(fast: bool = False, shell=SHELL):
    """``(train grid, eval grid)``: name -> StylizeConfig (None = clean);
    ``fast`` puts every stylize on ``plane_fast``. ``shell`` holds the
    plane-wave writes (the reference's (55, 55, 30) needs H, W >= 111 and
    D >= 61)."""
    backend = {"fft_backend": "plane_fast"} if fast else {}

    def cfg(**kw):
        return StylizeConfig(**kw, **backend)

    train = {
        "baseline": None,
        "gibbs12p5": cfg(disk_r=12.5, disk_prob=1.0),
        "planes14": cfg(plane_axes=shell, plane_intensity=14.0, plane_prob=1.0),
        "sap0p15": cfg(sap_p=0.15, sap_prob=1.0),
        "wrap0p5": cfg(wrap_alpha=0.5, wrap_prob=1.0),
    }
    evals = {
        "clean": None,
        "gibbs12p5": train["gibbs12p5"],
        "gibbs20": cfg(disk_r=20.0, disk_prob=1.0),
        "planes14": train["planes14"],
        "planes16": cfg(plane_axes=shell, plane_intensity=16.0, plane_prob=1.0),
        "sap0p15": train["sap0p15"],
        "sap0p35": cfg(sap_p=0.35, sap_prob=1.0),
        "wrap0p5": train["wrap0p5"],
        "wrap0": cfg(wrap_alpha=0.0, wrap_prob=1.0),
    }
    return train, evals


def diagonal_summary(table: Dict[str, dict], eval_grid: dict) -> dict:
    """On each corruption: the best model, every score, and whether the
    model trained on it beats the baseline."""
    summary = {}
    for ename in eval_grid:
        if ename == "clean" or ename not in table:
            continue
        scores = {m: table[m][ename]["mean"] for m in table}
        summary[ename] = {"best_model": max(scores, key=scores.get), "scores": scores,
                          "own_beats_baseline": scores[ename] > scores["baseline"]}
    return summary


def train_learnable(pool_i, pool_l, steps: int, batch: int, chunk: int, seed: int,
                    dev: torch.device, unet: Optional[dict] = None, log=print):
    """The learnable row: a ``GibbsUNet`` (alpha from 0.7, 4 -> 3) trained
    jointly by autograd in chunks; returns ``(model, alpha trajectory)``."""
    from mvtb_tpu_torch.models import GibbsUNet
    from mvtb_tpu_torch.train import create_learnable_state, make_learnable_chunk_fn

    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(seed)
        model = GibbsUNet(alpha_init=0.7, out_channels=3, in_channels=4,
                          **{**C.FULL_UNET, **(unet or {})}, device=dev)
    state = create_learnable_state(model, device=dev)
    chunk_fn = make_learnable_chunk_fn(False, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1000)
    srng = np.random.RandomState(seed + 17)
    done, traj, t0 = 0, [], time.perf_counter()
    while done < steps:
        n = min(chunk, steps - done)
        idxs = torch.from_numpy(srng.randint(0, pool_i.shape[0], (n, batch))).to(dev)
        state, gen, loss, tr = chunk_fn(state, gen, pool_i, pool_l, idxs)
        done += n
        traj.extend(float(a) for a in tr.cpu().numpy())
        log(f"[learnable_gd] step {done}/{steps} loss {float(loss):.4f} alpha "
            f"{traj[-1]:.4f} ({time.perf_counter() - t0:.0f}s)")
    return state.model, traj


def run(spatial=(128, 128, 64), steps: int = 2500, batch: Optional[int] = None,
        chunk: int = 125, pool: int = 48, val_pool: int = 24, outdir: Optional[str] = None,
        seed: int = 0, fast: bool = False, learnable: bool = True,
        device: DeviceLike = None, unet: Optional[dict] = None,
        model_dtype: str = "bfloat16", shell=SHELL, log=print) -> dict:
    """Train every model of the grid (and the learnable row), fill the
    matrix, write ``matrix.json`` / ``matrix.md``; returns the JSON's
    contents plus ``models`` and ``timing``. ``batch`` defaults to 8, 16
    with ``fast``. ``unet`` / ``model_dtype`` shrink the full-width bf16
    UNet and ``shell`` the plane-wave shell with the volume (tests)."""
    dev = resolve_device(device)
    spatial = tuple(spatial)
    batch = batch or (16 if fast else 8)
    outdir = outdir or C.outdir("cross_corruption")
    os.makedirs(outdir, exist_ok=True)
    log(f"pools: {pool} train / {val_pool} val at {spatial}")
    t0 = time.perf_counter()
    pool_i, pool_l = C.on(dev, *C.textured_pool(seed, pool, spatial))
    va_i, va_l = C.on(dev, *C.textured_pool(seed + 9999, val_pool, spatial))
    timing = {"pool_s": C.clock(dev) - t0}
    log(f"pools ready in {timing['pool_s']:.0f}s")

    train_grid, eval_grid = grids(fast, shell)
    models, histories = {}, {}
    for i, (name, sty) in enumerate(train_grid.items()):
        state = C.seg_state(4, 3, seed, dev, model_dtype, unet)
        chunk_clock = C.ChunkClock(log)
        state, histories[name] = train_chunked(
            state, pool_i, pool_l, steps=steps, batch_size=batch,
            generator=torch.Generator(device=dev).manual_seed(seed + 1 + i), stylize=sty,
            chunk=chunk, sample_rng=np.random.RandomState(seed + 17), log=chunk_clock,
            name=name, device=dev)
        models[name] = state.model
        timing[name] = chunk_clock.rates(batch, histories[name])
    if learnable:
        t0 = time.perf_counter()
        models["learnable_gd"], traj = train_learnable(pool_i, pool_l, steps, batch, chunk,
                                                       seed, dev, unet, log)
        histories["learnable_gd"] = {"alpha_trajectory_tail": traj[-20:],
                                     "alpha_final": traj[-1]}
        timing["learnable_gd"] = {"train_s": C.clock(dev) - t0}

    t0 = time.perf_counter()
    table = {}
    for mname, model in models.items():
        table[mname] = {}
        for ename, esty in eval_grid.items():
            # one cell: the model (a GibbsUNet runs its own layer) on the pool
            # stylized by esty, draws from a generator seeded seed + 4242
            table[mname][ename] = evaluate(model, va_i, va_l, esty, batch, seed, dev)
            log(f"{mname} on {ename}: {table[mname][ename]['mean']:.4f}")
    timing["eval_s"] = C.clock(dev) - t0

    out = {"spatial": spatial, "steps": steps, "batch": batch, "pool": pool,
           "val_pool": val_pool, "seed": seed, "fast": fast, "table": table,
           "diagonal_summary": diagonal_summary(table, eval_grid), "histories": histories}
    with open(os.path.join(outdir, "matrix.json"), "w") as f:
        json.dump(out, f, indent=2)
    cols = list(eval_grid)
    lines = ["# Cross-corruption Dice matrix (textured synthetic, "
             f"{spatial}, {steps} steps/model)", "",
             "| model \\ val | " + " | ".join(cols) + " |",
             "|" + "---|" * (len(cols) + 1)]
    for m in table:
        lines.append("| " + m + " | " + " | ".join(
            f"{table[m][c]['mean']:.3f}" for c in cols) + " |")
    with open(os.path.join(outdir, "matrix.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    log("\n".join(lines))

    def plot():
        from mvtb_tpu_torch.eval.plots import plot_model_performance

        perf = {m: {c: table[m][c]["mean"] for c in cols} for m in table}
        plot_model_performance(perf, os.path.join(outdir, "matrix.png"),
                               title="cross-corruption Dice")

    C.best_effort_plot(plot, log)
    return {**out, "models": models, "timing": timing}


def main(argv=None) -> dict:
    res = C.env_main(run, KNOBS, argv, __doc__.splitlines()[0])
    print(json.dumps({"timing": res["timing"], "kernel_launches": C.kernel_launches()}))
    return res


if __name__ == "__main__":
    main()
