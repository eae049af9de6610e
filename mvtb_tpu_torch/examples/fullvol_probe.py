"""Single-card no-crop training probe: one full-volume BraTS segmentation
step (the port of ``examples/fullvol_tpu_probe.py``).

The reference crops every volume to 128x128x64 because a full 4x240x240x155
volume does not fit its training budget (``baseline.py:128-130``). This
probe measures whether one card trains on whole volumes: one train step at
240x240x160 (D padded 155 -> 160 for the stride-16 UNet), batch ``BATCH``,
the full-width UNet in bf16 with float32 parameters and optimizer, the
flagship Gibbs disk stylization inside the step. It records ms a step on
the card (CUDA events around ``TIMED`` steps after two warm ones), vol/s,
the peak memory (``torch.cuda.max_memory_allocated``), the loss, and the
same steps through the chunked trainer. A step that runs out of memory is
recorded as the boundary and D is halved towards the crop size, as the JAX
script does; any other error is raised.

Run on the card: ``python -m mvtb_tpu_torch.examples.fullvol_probe``
(``BATCH=2`` probes the boundary). Env knobs: SPATIAL, BATCH, OUTDIR.
Writes ``<OUTDIR>/fullvol.json`` (default OUTDIR ``runs_torch/fullvol_probe``):
the JAX script's keys, each attempt also with ``peak_gb``.
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
from mvtb_tpu_torch.ops.fused import StylizeConfig
from mvtb_tpu_torch.train import make_chunk_fn, seg_train_step

KNOBS = {"SPATIAL": ("spatial", C.ints), "BATCH": ("batch", int), "OUTDIR": ("outdir", str)}

TIMED = 10


def _elapsed_ms(fn, steps: int, dev: torch.device) -> float:
    """Milliseconds for ``steps`` calls of ``fn``: CUDA events on the card,
    the host clock elsewhere."""
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    return (time.perf_counter() - t0) * 1e3


def probe(spatial, batch: int, device: DeviceLike = None, timed: int = TIMED,
          unet: Optional[dict] = None, model_dtype: str = "bfloat16") -> dict:
    """ms a step (direct and chunked), vol/s, peak GB and the last loss of
    the full stylize + train step at ``spatial`` and ``batch``."""
    dev = resolve_device(device)
    state = C.seg_state(4, 3, 0, dev, model_dtype, unet)
    sty = StylizeConfig(disk_r=12.5, disk_prob=1.0)  # the flagship Gibbs
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randn(batch, 4, *spatial).astype(np.float32)).to(dev)
    lbl = torch.from_numpy((rng.rand(batch, 3, *spatial) > 0.7).astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    losses = []

    def step():
        losses.append(seg_train_step(state, img, lbl, sty, generator=gen, device=dev))

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(2):  # warm: cuDNN's algorithm choice, the DFT matrices
        step()
    ms = _elapsed_ms(step, timed, dev) / timed
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None
    loss = float(losses[-1])

    # the chunked trainer over a pool of the same two volumes
    chunk_fn = make_chunk_fn(sty, dev)
    pool_i, pool_l = torch.cat([img, img]), torch.cat([lbl, lbl])
    idxs = torch.from_numpy(rng.randint(0, 2, (timed, batch))).to(dev)
    chunk_fn(state, gen, pool_i, pool_l, idxs[:2])
    chunked_ms = _elapsed_ms(lambda: chunk_fn(state, gen, pool_i, pool_l, idxs), 1, dev) / timed
    return {"ms": ms, "vol_per_s": batch / (ms / 1e3), "loss": loss,
            "chunked_ms": chunked_ms, "peak_gb": peak_gb}


def run(spatial=(240, 240, 160), batch: int = 1, outdir: Optional[str] = None,
        device: DeviceLike = None, timed: int = TIMED, unet: Optional[dict] = None,
        model_dtype: str = "bfloat16", log=print) -> dict:
    """Probe ``spatial`` at ``batch``, halving D on running out of memory
    (down to 64); writes and returns the JSON's contents."""
    dev = resolve_device(device)
    outdir = outdir or C.outdir("fullvol_probe")
    os.makedirs(outdir, exist_ok=True)
    spatial = tuple(spatial)
    out = {"batch": batch, "requested_spatial": spatial, "attempts": []}
    while True:
        t0 = time.perf_counter()
        try:
            r = probe(spatial, batch, dev, timed, unet, model_dtype)
        except torch.OutOfMemoryError as e:  # the boundary is the result
            msg = str(e)[:400]
            out["attempts"].append({"spatial": spatial, "ok": False, "error": msg})
            log(f"fullvol {spatial} b{batch}: out of memory: {msg}")
            torch.cuda.empty_cache()
            if spatial[-1] <= 64:
                break
            spatial = spatial[:-1] + (spatial[-1] // 2,)
            continue
        out["attempts"].append({
            "spatial": spatial, "ok": True, "ms_per_step": round(r["ms"], 3),
            "vol_per_s": round(r["vol_per_s"], 3),
            "chunked_ms_per_step": round(r["chunked_ms"], 3), "loss": r["loss"],
            "wall_s": round(time.perf_counter() - t0, 1), "peak_gb": r["peak_gb"]})
        log(f"fullvol {spatial} b{batch}: {r['ms']:.1f} ms/step ({r['vol_per_s']:.2f} "
            f"vol/s), chunked {r['chunked_ms']:.1f} ms/step, loss {r['loss']:.4f}, "
            f"peak {r['peak_gb']} GB")
        break
    path = os.path.join(outdir, "fullvol.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    log(f"wrote {path}")
    return out


def main(argv=None) -> dict:
    return C.env_main(run, KNOBS, argv, __doc__.splitlines()[0])


if __name__ == "__main__":
    main()
