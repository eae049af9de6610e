"""Corrupting volumes in batches, as the corrupted evaluation sets are
built: batches drawn from a pool on the card go through
``ops/fused.py:stylize_batch``, and each output is consumed on the device.
One client, closed loop; the host reads back once every ``sync_every``
batches."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import compare, inputs, roofline
from portbench.reference import lowp
from portbench.reference.precision import full_float32
from portbench.reference.stylize import disk_lowpass


def make_pool(ctx):
    return inputs.textured_pool(ctx.seed, ctx.wl["pool"], ctx.cfg["model"]["in_channels"],
                                ctx.wl["spatial"], torch.device(ctx.device))[0]


def run(ctx) -> None:
    from mvtb_tpu_torch.ops.fused import StylizeConfig, stylize_batch

    cfg, wl, dev = ctx.cfg, ctx.wl, torch.device(ctx.device)
    B, P = wl["batch"], wl["pool"]
    pool = make_pool(ctx)
    ctx.mark("inputs")
    sty = StylizeConfig(**cfg["stylize"])
    gen = inputs.generator(ctx.seed, dev, 3)
    rng = np.random.default_rng(inputs.subseed(ctx.seed, 8))
    acc = torch.zeros((), device=dev)

    def call(rows):
        nonlocal acc
        out = stylize_batch(pool.index_select(0, rows), sty, generator=gen, device=dev)
        acc = acc + out[..., 0].sum()  # consume the output on the device
        return out

    def draw():
        return torch.from_numpy(rng.choice(P, B, replace=False)).to(dev)

    call(draw())
    float(acc)
    ctx.setup_done()

    sample = set(rng.choice(wl["check_within"], wl["check_batches"], replace=False).tolist())
    kept, done = {}, 0
    t0 = time.perf_counter()
    while True:
        rows = draw()
        out = call(rows)
        if done in sample:
            kept[done] = (rows, out)
        done += 1
        if done % wl["sync_every"] == 0:
            float(acc)
            if time.perf_counter() - t0 >= ctx.seconds:
                break
    window = time.perf_counter() - t0
    for i in range(done, max(sample) + 1):  # sampled batches past the window
        rows = draw()
        out = call(rows)
        if i in sample:
            kept[i] = (rows, out)
    ctx.window_done(window)
    C = cfg["model"]["in_channels"]
    ctx.attempted = done * B
    ctx.e2e["stylize_vol_per_s"] = done * B / window
    rec = ctx.record
    rec["counters"].update(volumes=done * B, peak=cfg["precision"]["stylize"],
                           flops_per_volume=roofline.stylize_flops([1, C] + list(wl["spatial"])))
    if cfg["stylize"]["fft_backend"].startswith("plane"):
        rec["counters"]["plane_shape"] = [B * C] + list(wl["spatial"])
    if ctx.trace_on:
        def work():
            for _ in range(wl["sync_every"]):
                call(draw())
            float(acc)

        ctx.traced(work)
    del out
    gap = 0.0
    with full_float32():
        for rows, got in kept.values():
            gap = max(gap, compare.rel_max_gap(got, disk_lowpass(pool[rows],
                                                                 cfg["stylize"]["disk_r"])))
    ctx.check("stylize_gap", gap)


def control_gap(ctx, pool, rows_list) -> float:
    """The control's gap: the reference one precision below the
    configuration's, judged against the reference."""
    squant = lowp.ROUNDINGS[lowp.below(ctx.cfg["precision"]["stylize"])]
    r = ctx.cfg["stylize"]["disk_r"]
    with full_float32():
        return max(compare.rel_max_gap(disk_lowpass(pool[rows], r, squant),
                                       disk_lowpass(pool[rows], r)) for rows in rows_list)
