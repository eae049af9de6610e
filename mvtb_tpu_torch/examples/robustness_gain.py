"""Robustness-gain experiment: stylized-trained vs baseline under corruption
(the port of ``examples/robustness_gain.py``).

The reference's core claim on textured synthetic data: a 3D UNet trained on
Gibbs-stylized volumes beats the clean-trained baseline on Gibbs-corrupted
validation data, while the baseline degrades steeply (reference shape:
baseline 0.7433 clean -> 0.6101 on gibbs9; stylized diagonal 0.7194 vs
baseline 0.6777 on gibbs12.5 -- BASELINE.md). Families, as in the JAX
script: ``disk`` (Gibbs ringing), ``planes`` (a plane-wave write on the
(55, 55, 30) shell), ``wrap`` (aliasing), ``sap`` (salt & pepper) and
``combo`` (the stacked Gibbs -> planes -> wrap -> sap pipeline, evaluated
on the stack and on each component).

Both models train from the same initial weights over the same pool rows
(``RandomState(seed + 17)``), in chunks of :func:`~mvtb_tpu_torch.train.
chunked.train_chunked` (one host read a chunk), with ``reference_optimizer``
and a bf16 UNet. Evaluation corrupts each validation batch with a radius,
alpha or p handed in as a tensor, so one function serves the whole sweep.
``FAST=1`` is the fast-science profile: batch 16 and the ``plane_fast``
stylize, the hand-written plane kernel (``csrc/fused_plane.cu``) on the
card; ``FFT_BACKEND=dft_pallas`` runs the hand-written axis kernels
(``csrc/axis_dft.cu``) instead.

Run on the card: ``FAST=1 python -m mvtb_tpu_torch.examples.robustness_gain``;
on the CPU at a tiny size add ``--device cpu`` with e.g.
``SPATIAL=32,32,32 STEPS=4 POOL=4 VAL_POOL=4``. Env knobs as the JAX
script's: SPATIAL, STEPS, BATCH, CHUNK, FAMILY, DISK_R, PLANE_I, WRAP_ALPHA,
SAP_P, POOL, VAL_POOL, OUTDIR, EVAL_RADII / EVAL_INTENSITIES / EVAL_ALPHAS /
EVAL_PS (comma lists), SEED, FAST, FFT_BACKEND. VAL_POOL need not be a
multiple of BATCH here (the last validation batch may be short). Writes
``<OUTDIR>/robustness_gain[_<family>].json`` (default OUTDIR
``runs_torch/robustness_gain``) with the JAX script's keys, and loss curves
where matplotlib imports.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.examples import _common as C
from mvtb_tpu_torch.ops.corruptions import sap_select, wrap_artifact
from mvtb_tpu_torch.ops.fused import StylizeConfig, _raw_dist_sq, stylize_batch
from mvtb_tpu_torch.train import EpochMetrics, seg_eval_step, train_chunked

KNOBS = {
    "SPATIAL": ("spatial", C.ints), "STEPS": ("steps", int), "BATCH": ("batch", int),
    "CHUNK": ("chunk", int), "FAMILY": ("family", str), "DISK_R": ("disk_r", float),
    "PLANE_I": ("plane_i", float), "WRAP_ALPHA": ("wrap_alpha", float),
    "SAP_P": ("sap_p", float), "POOL": ("pool", int), "VAL_POOL": ("val_pool", int),
    "OUTDIR": ("outdir", str), "EVAL_RADII": ("eval_radii", C.floats),
    "EVAL_INTENSITIES": ("eval_intensities", C.floats),
    "EVAL_ALPHAS": ("eval_alphas", C.floats), "EVAL_PS": ("eval_ps", C.floats),
    "SEED": ("seed", int), "FAST": ("fast", C.flag), "FFT_BACKEND": ("fft_backend", str),
}

SHELL = (55.0, 55.0, 30.0)

# the reference's pickled Dice tables for each family (BASELINE.md)
REFERENCE_SHAPE = {
    "disk": {"baseline_clean": 0.7433, "baseline_on_gibbs9": 0.6101,
             "stylized12p5_on_gibbs12p5": 0.7194, "baseline_on_gibbs12p5": 0.6777},
    # plane waves are catastrophic for the baseline, recoverable by
    # stylization (20_results/30_planes_waves)
    "planes": {"baseline_clean": 0.7433, "baseline_on_planes17": 0.0180,
               "planes17_on_planes17": 0.7113},
    # 20_results/80_common_evaluations/50_evaluations_on_wrap
    "wrap": {"baseline_clean": 0.7433, "baseline_on_wrap0": 0.1197, "wrap0_on_wrap0": 0.6212},
    # 20_results/40_sap
    "sap": {"baseline_clean": 0.7433, "baseline_on_sap0p35": 0.4403,
            "sap35_on_sap0p35": 0.7125},
    # no pickled table survives for the 127_ stack; the per-component tables
    # above are the shape anchors
    "combo": {"baseline_clean": 0.7433},
}


def make_pool(seed: int, n: int, spatial):
    """The JAX script's ``_make_pool``: ``n`` textured 4-channel volumes
    with 3 classes from ``RandomState(seed)``, as numpy."""
    return C.textured_pool(seed, n, spatial)


def corrupt_disk(x: torch.Tensor, r) -> torch.Tensor:
    """The reference-geometry disk low-pass (raw-coordinate mask, as the
    fused stack builds it) of a (B, C, H, W, D) batch, ``r`` a float32
    tensor or number."""
    axes = (-3, -2, -1)
    r = torch.as_tensor(r, dtype=torch.float32, device=x.device)
    k = torch.fft.fftn(x, dim=axes)
    d2 = _raw_dist_sq(x.shape[-3:], (0.0,) * 3, device=x.device)
    return torch.fft.ifftn(k * (d2 < r * r).to(torch.float32), dim=axes).real.to(x.dtype)


def corrupt_wrap(x: torch.Tensor, alpha) -> torch.Tensor:
    """Odd-k-line scaling by ``alpha`` over every axis after the batch's
    first, as the JAX script applies ``wrap_artifact`` to the batch (its
    channel axis included)."""
    return wrap_artifact(x, alpha)


def corrupt_sap(x: torch.Tensor, p, u: torch.Tensor) -> torch.Tensor:
    """Salt & pepper with per-sample extrema (over C, H, W, D), the
    reference transform applied to each volume, from the uniform field
    ``u``."""
    dims = tuple(range(1, x.ndim))
    p = torch.as_tensor(p, dtype=x.dtype, device=x.device)
    return sap_select(x, u, p, x.amin(dim=dims, keepdim=True) / 2,
                      x.amax(dim=dims, keepdim=True) / 2)


def evaluate(model: torch.nn.Module, va_i: torch.Tensor, va_l: torch.Tensor, corrupt,
             batch: int, seed: int = 0, device: DeviceLike = None) -> dict:
    """Mean and per-class Dice of ``model`` (a UNet, or a GibbsUNet that
    runs its own layer) over the validation pool in batches of ``batch``.
    ``corrupt``: None, a disk radius, a ``("wrap", alpha)`` / ``("sap", p)``
    tag, or a :class:`StylizeConfig` (the plane-wave family here, every
    set of ``cross_corruption_matrix``). The random draws come from one
    generator seeded ``seed + 4242``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed + 4242)
    metrics = EpochMetrics()
    scores = []
    for i in range(0, va_i.shape[0], batch):
        img = va_i[i:i + batch]
        if isinstance(corrupt, StylizeConfig):
            img = stylize_batch(img, corrupt, generator=g, device=dev)
        elif isinstance(corrupt, tuple):
            kind, param = corrupt
            param = torch.tensor(param, dtype=torch.float32, device=dev)
            if kind == "wrap":
                img = corrupt_wrap(img, param)
            else:
                img = corrupt_sap(img, param, torch.rand(img.shape, generator=g, device=dev))
        elif corrupt is not None:
            img = corrupt_disk(img, corrupt)
        scores.append(seg_eval_step(model, img, va_l[i:i + batch], device=dev).float())
    scores = torch.cat(scores).cpu().numpy()  # one host read for the set
    for i in range(0, len(scores), batch):
        metrics.update(scores[i:i + batch])
    return metrics.result()


def family_sets(name: str, disk_r: float, plane_i: float, wrap_alpha: float, sap_p: float,
                eval_radii: Sequence[float], eval_intensities: Sequence[float],
                eval_alphas: Sequence[float], eval_ps: Sequence[float], shell=SHELL):
    """``(train stylize, stylized model's name, eval sets, diagonal)`` of a
    corruption family, as the JAX script builds them (its names print the
    parameters as floats: ``gibbs9.0``). ``shell`` holds the plane-wave
    writes (the reference's (55, 55, 30) needs H, W >= 111 and D >= 61)."""
    disk_r, plane_i, wrap_alpha, sap_p = map(float, (disk_r, plane_i, wrap_alpha, sap_p))
    eval_radii, eval_intensities, eval_alphas, eval_ps = (
        [float(v) for v in vs] for vs in (eval_radii, eval_intensities, eval_alphas, eval_ps))
    if name == "disk":
        sets = {"clean": None, **{f"gibbs{r}": r for r in eval_radii}}
        return (StylizeConfig(disk_r=disk_r, disk_prob=1.0), f"gibbs{disk_r}", sets,
                f"gibbs{disk_r}")
    if name == "planes":
        sets = {"clean": None, **{
            f"planes{i}": StylizeConfig(plane_axes=shell, plane_intensity=float(i),
                                        plane_prob=1.0) for i in eval_intensities}}
        sty = StylizeConfig(plane_axes=shell, plane_intensity=plane_i, plane_prob=1.0)
        return sty, f"planes{plane_i}", sets, f"planes{plane_i}"
    if name == "wrap":
        sets = {"clean": None, **{f"wrap{a}": ("wrap", a) for a in eval_alphas}}
        sets.setdefault(f"wrap{wrap_alpha}", ("wrap", wrap_alpha))
        return (StylizeConfig(wrap_alpha=wrap_alpha, wrap_prob=1.0), f"wrap{wrap_alpha}",
                sets, f"wrap{wrap_alpha}")
    if name == "sap":
        sets = {"clean": None, **{f"sap{p}": ("sap", p) for p in eval_ps}}
        sets.setdefault(f"sap{sap_p}", ("sap", sap_p))
        return (StylizeConfig(sap_p=sap_p, sap_prob=1.0), f"sap{sap_p}", sets, f"sap{sap_p}")
    if name == "combo":
        # 127_gibbs_spikes_wraparound_sap: Gibbs r=12.5 -> plane write I=15 on
        # the shell -> wrap alpha=0.5 -> sap p=0.05, in the reference's order
        sty = StylizeConfig(disk_r=12.5, disk_prob=1.0, plane_axes=shell,
                            plane_intensity=15.0, plane_prob=1.0, wrap_alpha=0.5,
                            wrap_prob=1.0, sap_p=0.05, sap_prob=1.0)
        sets = {"clean": None, "combo": sty, "gibbs12.5": 12.5,
                "planes15": StylizeConfig(plane_axes=shell, plane_intensity=15.0,
                                          plane_prob=1.0),
                "wrap0.5": ("wrap", 0.5), "sap0.05": ("sap", 0.05)}
        return sty, "combo", sets, "combo"
    raise ValueError(f"unknown FAMILY {name}")


def effect_of(table: dict, diag: str, family_name: str) -> dict:
    """The JAX script's ``effect`` block."""
    base_clean = table["baseline"]["clean"]["mean"]
    base_corr = table["baseline"][diag]["mean"]
    styl_corr = table[diag][diag]["mean"]
    return {"baseline_clean": base_clean, "baseline_on_corrupted": base_corr,
            "stylized_on_corrupted": styl_corr,
            "baseline_degradation": base_clean - base_corr,
            "robustness_gain": styl_corr - base_corr,
            "effect_reproduced": bool(styl_corr > base_corr
                                      and (base_clean - base_corr) > 0.05),
            "reference_shape": REFERENCE_SHAPE[family_name]}


def run(spatial=(128, 128, 64), steps: int = 4000, batch: Optional[int] = None,
        chunk: int = 100, family: str = "disk", disk_r: float = 12.5,
        plane_i: float = 14.0, wrap_alpha: float = 0.0, sap_p: float = 0.35,
        pool: int = 64, val_pool: int = 24, outdir: Optional[str] = None,
        eval_radii: Sequence[float] = (9.0, 12.5, 15.0, 20.0, 25.0),
        eval_intensities: Sequence[float] = (12.0, 14.0, 16.0),
        eval_alphas: Sequence[float] = (0.0, 0.25, 0.5, 0.75),
        eval_ps: Sequence[float] = (0.05, 0.15, 0.25, 0.35), seed: int = 0,
        fast: bool = False, fft_backend: Optional[str] = None,
        device: DeviceLike = None, unet: Optional[dict] = None,
        model_dtype: str = "bfloat16", shell=SHELL, log=print) -> dict:
    """Train the baseline and the stylized model, evaluate both on every
    set, write the JSON; returns its contents plus ``models`` (name ->
    trained model) and ``timing`` (pool, per-model train and eval seconds,
    train vol/s), which the file leaves out. ``batch`` defaults to 8, 16
    with ``fast``; ``fft_backend`` to ``"auto"``, ``"plane_fast"`` with
    ``fast``. ``unet`` / ``model_dtype`` shrink the full-width bf16 UNet
    and ``shell`` the plane-wave shell with the volume (tests)."""
    dev = resolve_device(device)
    spatial = tuple(spatial)
    batch = batch or (16 if fast else 8)
    fft_backend = fft_backend or ("plane_fast" if fast else "auto")
    outdir = outdir or C.outdir("robustness_gain")
    os.makedirs(outdir, exist_ok=True)
    t_all = time.perf_counter()
    log(f"building pools: train {pool}, val {val_pool} at {spatial}")
    t0 = time.perf_counter()
    pool_i, pool_l = C.on(dev, *make_pool(seed, pool, spatial))
    va_i, va_l = C.on(dev, *make_pool(seed + 9999, val_pool, spatial))
    timing = {"pool_s": C.clock(dev) - t0}
    log(f"pools ready in {timing['pool_s']:.0f}s")

    sty, styl_name, eval_sets, diag = family_sets(
        family, disk_r, plane_i, wrap_alpha, sap_p, eval_radii, eval_intensities,
        eval_alphas, eval_ps, shell)
    models, histories = {}, {}
    for i, (name, train_sty) in enumerate([("baseline", None), (styl_name, sty)]):
        if train_sty is not None:
            train_sty = dataclasses.replace(train_sty, fft_backend=fft_backend)
        state = C.seg_state(4, 3, seed, dev, model_dtype, unet)
        gen = torch.Generator(device=dev).manual_seed(seed + 1 + i)
        chunk_clock = C.ChunkClock(log)
        state, histories[name] = train_chunked(
            state, pool_i, pool_l, steps=steps, batch_size=batch, generator=gen,
            stylize=train_sty, chunk=chunk, sample_rng=np.random.RandomState(seed + 17),
            log=chunk_clock, name=name, device=dev)
        models[name] = state.model
        timing[name] = chunk_clock.rates(batch, histories[name])

    table = {}
    for mname, model in models.items():
        t0 = time.perf_counter()
        table[mname] = {}
        for ename, corrupt in eval_sets.items():
            res = evaluate(model, va_i, va_l, corrupt, batch, seed, dev)
            table[mname][ename] = res
            log(f"eval {mname} on {ename}: mean {res['mean']:.4f} "
                f"per-class {[round(v, 4) for v in res['per_class']]}")
        timing[mname]["eval_s"] = C.clock(dev) - t0
    effect = effect_of(table, diag, family)
    out = {"spatial": spatial, "steps": steps, "batch": batch, "family": family,
           "disk_r": disk_r, "plane_i": plane_i, "wrap_alpha": wrap_alpha, "sap_p": sap_p,
           "pool": pool, "val_pool": val_pool, "fast": fast, "fft_backend": fft_backend,
           "seed": seed, "table": table, "effect": effect, "histories": histories}
    suffix = "" if family == "disk" else f"_{family}"
    path = os.path.join(outdir, f"robustness_gain{suffix}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    timing["wall_s"] = time.perf_counter() - t_all
    log(json.dumps(effect, indent=2))
    log(f"wrote {path}")

    def plot():
        from mvtb_tpu_torch.eval.plots import save_learning_curves

        for name, hist in histories.items():
            save_learning_curves({"loss": [h["loss"] for h in hist], "dice": [], "epochs": []},
                                 os.path.join(outdir, f"loss_{name}.png"), 1, title=name)

    C.best_effort_plot(plot, log)
    return {**out, "models": models, "timing": timing}


def main(argv=None) -> dict:
    res = C.env_main(run, KNOBS, argv, __doc__.splitlines()[0])
    print(json.dumps({"timing": res["timing"], "kernel_launches": C.kernel_launches()}))
    return res


if __name__ == "__main__":
    main()
