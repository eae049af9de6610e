"""Hold-out-hospital experiment: does stylization shrink the generalization
gap? (the port of ``examples/holdout_hospital.py``).

The reference's institutional-distribution claim (``10_scripts/
300_instutional_distribution/baseline_domain.py`` and the
``stylized_*_domain`` variants): a model trained on three hospitals and
evaluated on a fourth pays a generalization gap, and k-space stylization at
train time shrinks it by erasing institution-specific acquisition
signatures. Shown here on textured synthetic hospitals
(:func:`~mvtb_tpu_torch.data.tcga.textured_hospital_samples`): each
hospital's healthy tissue carries a scanner-specific high-k texture band
outside the r = 12.5 disk, and a weaker band-independent offset is the
domain-invariant cue.

Each arm trains a bf16 UNet (1 -> 1) in chunks over a pool on the device,
then is scored on each hospital under its OWN val pipeline (the domain
scripts put the disk mask in the val transform too,
``gibbs15_domain.py:120-136``), with a clean-input Dice kept as a
diagnostic; the augmentation arm is scored clean, as the reference's
30_augmentation scripts are.

Run on the card: ``python -m mvtb_tpu_torch.examples.holdout_hospital``.
Env knobs as the JAX script's: SPATIAL, STEPS, BATCH, EVAL_BATCH, CHUNK,
N_PER_HOSPITAL, DISK_R, OUTDIR, SEED, FAMILIES (a comma list of baseline,
gibbs, spikes, sap, gibbs_aug). Writes ``<OUTDIR>/holdout_hospital.json``
(default OUTDIR ``runs_torch/holdout_hospital``) with the JAX script's keys.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.data.tcga import (generalization_gap, partition_dataset,
                                      textured_hospital_samples)
from mvtb_tpu_torch.examples import _common as C
from mvtb_tpu_torch.ops.fused import StylizeConfig
from mvtb_tpu_torch.train import EpochMetrics, seg_eval_step, train_chunked

KNOBS = {"SPATIAL": ("spatial", C.ints), "STEPS": ("steps", int), "BATCH": ("batch", int),
         "EVAL_BATCH": ("eval_batch", int), "CHUNK": ("chunk", int),
         "N_PER_HOSPITAL": ("n_per_hospital", int), "DISK_R": ("disk_r", float),
         "OUTDIR": ("outdir", str), "SEED": ("seed", int), "FAMILIES": ("families", C.words)}

HOSPITALS = ["hospital_A", "hospital_B", "hospital_C"]


def _stack(samples):
    imgs = np.stack([s["image"] for s in samples])
    lbls = np.stack([s["label"] for s in samples])
    return imgs.astype(np.float32), lbls.astype(np.float32)


def make_pools(seed: int, n_per_hospital: int, spatial, eval_batch: int = 4):
    """``((train images, labels), {hospital: (images, labels)})`` as numpy,
    the membership of ``data.tcga.domain_loaders(kind="textured")``:
    per-hospital seeds ``seed + i``, a 0.75/0.25 partition at ``seed``, the
    holdout at ``seed + 99`` with ``max(n_per_hospital // 2, eval_batch)``
    volumes."""
    spatial = tuple(spatial)
    train_samples, val_sets = [], {}
    for i, hospital in enumerate(HOSPITALS):
        samples = textured_hospital_samples(hospital, n_per_hospital, seed + i, spatial)
        tr, va = partition_dataset(samples, (0.75, 0.25), seed=seed)
        train_samples += tr
        val_sets[hospital] = _stack(va)
    val_sets["holdout"] = _stack(textured_hospital_samples(
        "holdout", max(n_per_hospital // 2, eval_batch), seed + 99, spatial))
    return _stack(train_samples), val_sets


def arms(disk_r: float) -> dict:
    """family -> ``(model name, train stylize, eval mode)``: ``"same"``
    scores under the train stylize, None clean."""
    return {
        "baseline": ("baseline", None, None),
        "gibbs": (f"gibbs{disk_r}", StylizeConfig(disk_r=disk_r, disk_prob=1.0), "same"),
        # a point write that leaves the hospital band: negative control
        "spikes": ("spikes10", StylizeConfig(spike=True, spike_range=(10.0, 10.0),
                                             spike_prob=1.0), "same"),
        # an image-domain impulse that leaves the band too: second control
        "sap": ("sap0p15", StylizeConfig(sap_p=0.15, sap_prob=1.0), "same"),
        # the 30_augmentation family (RandGibbsNoised("image", 0.1, alpha=(0, 0.4)),
        # baseline_domain_augment_alpha0p4.py:118), scored clean
        "gibbs_aug": ("gibbs_aug0p4", StylizeConfig(gibbs_alpha=(0.0, 0.4), gibbs_prob=0.1),
                      None),
    }


def evaluate(model: torch.nn.Module, imgs: np.ndarray, lbls: np.ndarray, eval_batch: int,
             cfg: Optional[StylizeConfig] = None, device: DeviceLike = None) -> float:
    """Mean Dice of ``model`` on one hospital in batches of ``eval_batch``,
    each batch stylized by ``cfg`` with draws from a generator seeded 0 (the
    JAX script hands ``key(0)`` to every batch)."""
    dev = resolve_device(device)
    scores = []
    for i in range(0, imgs.shape[0], eval_batch):
        xb, yb = C.on(dev, imgs[i:i + eval_batch], lbls[i:i + eval_batch])
        g = torch.Generator(device=dev).manual_seed(0)
        scores.append(seg_eval_step(model, xb, yb, cfg, generator=g, device=dev).float())
    scores = torch.cat(scores).cpu().numpy()
    metrics = EpochMetrics()
    for i in range(0, len(scores), eval_batch):
        metrics.update(scores[i:i + eval_batch])
    return metrics.result()["mean"]


def run(spatial=(128, 128, 64), steps: int = 2500, batch: int = 8, eval_batch: int = 4,
        chunk: int = 100, n_per_hospital: int = 16, disk_r: float = 12.5,
        outdir: Optional[str] = None, seed: int = 0,
        families: Sequence[str] = ("baseline", "gibbs"), device: DeviceLike = None,
        unet: Optional[dict] = None, model_dtype: str = "bfloat16", log=print) -> dict:
    """Train each arm of ``families``, score it on every hospital, write the
    JSON; returns its contents plus ``models`` and ``timing``. ``unet`` /
    ``model_dtype`` shrink the full-width bf16 UNet (tests)."""
    dev = resolve_device(device)
    spatial = tuple(spatial)
    disk_r = float(disk_r)
    outdir = outdir or C.outdir("holdout_hospital")
    os.makedirs(outdir, exist_ok=True)
    t_all = time.perf_counter()
    log(f"building hospital pools at {spatial}")
    (tr_i, tr_l), val_sets = make_pools(seed, n_per_hospital, spatial, eval_batch)
    log(f"pools ready in {time.perf_counter() - t_all:.0f}s: train {tr_i.shape}, "
        + ", ".join(f"{k} {v[0].shape[0]}" for k, v in val_sets.items()))
    pool_i, pool_l = C.on(dev, tr_i, tr_l)
    timing = {"pool_s": C.clock(dev) - t_all}

    results, histories, models = {}, {}, {}
    arm_cfgs = arms(disk_r)
    for i, fam in enumerate(families):
        name, train_sty, eval_mode = arm_cfgs[fam]
        eval_sty = train_sty if eval_mode == "same" else None
        state = C.seg_state(1, 1, seed, dev, model_dtype, unet)
        chunk_clock = C.ChunkClock(log)
        state, histories[name] = train_chunked(
            state, pool_i, pool_l, steps=steps, batch_size=batch,
            generator=torch.Generator(device=dev).manual_seed(seed + 1 + i),
            stylize=train_sty, chunk=chunk, sample_rng=np.random.RandomState(seed + 17),
            log=chunk_clock, name=name, device=dev)
        models[name] = state.model
        timing[name] = chunk_clock.rates(batch, histories[name])
        eval_dict, clean_dict = {}, {}
        for hospital, (vi, vl) in val_sets.items():
            eval_dict[hospital] = evaluate(state.model, vi, vl, eval_batch, eval_sty, dev)
            clean_dict[hospital] = (eval_dict[hospital] if eval_sty is None
                                    else evaluate(state.model, vi, vl, eval_batch, None, dev))
            log(f"eval {name} on {hospital}: {eval_dict[hospital]:.4f} "
                f"(clean diagnostic {clean_dict[hospital]:.4f})")
        gap = generalization_gap(eval_dict)
        results[name] = {"eval_dict": eval_dict, "clean_eval": clean_dict, "gap": gap}
        log(f"[{name}] in-dist {gap['in_dist_mean']:.4f} holdout {gap['holdout']:.4f} "
            f"gap {gap['gap']:.4f} (normalized {gap['normalized_gap']:.3f})")

    effect = {name: {"gap": r["gap"]["gap"], "normalized_gap": r["gap"]["normalized_gap"]}
              for name, r in results.items()}
    if "baseline" in results and f"gibbs{disk_r}" in results:
        base_g, styl_g = results["baseline"]["gap"], results[f"gibbs{disk_r}"]["gap"]
        effect.update({"baseline_gap": base_g["gap"], "stylized_gap": styl_g["gap"],
                       "gap_shrunk": bool(styl_g["gap"] < base_g["gap"]),
                       "baseline_normalized_gap": base_g["normalized_gap"],
                       "stylized_normalized_gap": styl_g["normalized_gap"]})
    timing["wall_s"] = time.perf_counter() - t_all
    out = {"spatial": spatial, "steps": steps, "batch": batch,
           "n_per_hospital": n_per_hospital, "disk_r": disk_r, "seed": seed,
           "results": results, "effect": effect, "histories": histories,
           "wall_s": round(timing["wall_s"], 1)}
    path = os.path.join(outdir, "holdout_hospital.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    log(f"wrote {path}; gaps: " + ", ".join(
        f"{n} {r['gap']['gap']:+.4f}" for n, r in results.items()))
    return {**out, "models": models, "timing": timing}


def main(argv=None) -> dict:
    res = C.env_main(run, KNOBS, argv, __doc__.splitlines()[0])
    print(json.dumps({"timing": res["timing"]}))
    return res


if __name__ == "__main__":
    main()
