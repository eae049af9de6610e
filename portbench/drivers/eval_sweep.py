"""Full-volume evaluation, as the study's Dice tables are made: one client
asks for one volume at a time; each is stylized at the next level in turn by
``data/pipeline.py:StylizedLoader`` and evaluated by
``eval/harness.py:ModelEvaluation.dataset_eval_multi`` through the
sliding window, its Dice read back on the host. Closed loop.

The pool is made on the card from the seed and then held on the host in
page-locked memory, because the loader takes host batches, as a user's
loader with ``pin_memory`` yields them.

What is judged, for a sample of the window's volumes drawn from the seed:
the loader's stylized volume, the sliding window's blended logits (kept by
a recording wrapper on the name the harness calls), and the Dice the
harness returns, against the plain reference's Dice of those same logits.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import compare, flops, inputs
from portbench.reference import lowp
from portbench.reference import sliding_window as ref_sw
from portbench.reference.dice import hard_dice
from portbench.reference.precision import full_float32
from portbench.reference.stylize import disk_lowpass
from portbench.reference.train import build as build_reference
from portbench.reference.unet import param_shapes

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class TimedLoader:
    """The loader handed to the harness, with the benchmark's span around
    each ``next()``; keeps the batch it yields when ``keep`` is set."""

    def __init__(self, loader, spans, keep: bool):
        self.loader, self.spans, self.keep, self.kept = loader, spans, keep, None

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.spans.append(time.perf_counter() - t)
            if self.keep:
                self.kept = batch
            yield batch


def to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``, page-locked where a card is used."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
    host.copy_(t)
    return host.numpy()


def make_inputs(ctx):
    cfg, wl, dev = ctx.cfg, ctx.wl, torch.device(ctx.device)
    m = cfg["model"]
    weights = inputs.make_weights(ctx.seed, param_shapes(m), dev)
    pool_i, pool_l = inputs.textured_pool(ctx.seed, wl["pool"], m["in_channels"],
                                          wl["spatial"], dev)
    return weights, to_host(pool_i), to_host(pool_l)


def schedule(ctx, n: int):
    """(pool row, level index) of the first ``n`` requests: the rows in a
    seeded order, the levels in turn."""
    wl = ctx.wl
    rng = np.random.default_rng(inputs.subseed(ctx.seed, 5))
    rows = np.concatenate([rng.permutation(wl["pool"]) for _ in range(-(-n // wl["pool"]))])
    return [(int(rows[i]), i % len(wl["levels"])) for i in range(n)]


def reference_outputs(ctx, weights, image, level, quant=None, squant=None):
    """(stylized volume, blended logits) of the plain reference for one
    volume; ``quant``/``squant`` round the model's and the corruption's
    operands (the control)."""
    wl, dev = ctx.wl, torch.device(ctx.device)
    model = build_reference(ctx.cfg["model"], weights, dev)
    x = torch.from_numpy(image).to(dev)
    x = disk_lowpass(x, wl["levels"][level], squant)
    with torch.no_grad():
        logits, _ = ref_sw.infer(x, wl["roi"], lambda t: model(t, quant), wl["overlap"],
                                 wl["reference_block"])
    return x, logits


def run(ctx) -> None:
    import mvtb_tpu_torch.eval.harness as harness
    from mvtb_tpu_torch.data.pipeline import StylizedLoader
    from mvtb_tpu_torch.models import UNet
    from mvtb_tpu_torch.ops.fused import StylizeConfig

    cfg, wl, dev = ctx.cfg, ctx.wl, torch.device(ctx.device)
    m = cfg["model"]
    weights, host_i, host_l = make_inputs(ctx)
    ctx.mark("inputs")
    model = UNet(m["in_channels"], m["out_channels"], m["channels"], m["strides"],
                 m["num_res_units"], device=dev, dtype=DTYPES[cfg["precision"]["model"]])
    model.load_state_dict(weights)
    model.eval()
    ev = harness.ModelEvaluation(model, in_channels=m["in_channels"],
                                 out_channels=m["out_channels"], roi_size=tuple(wl["roi"]),
                                 device=dev)
    stys = [None if r is None else StylizeConfig(disk_r=float(r), disk_prob=1.0,
                                                 fft_backend=cfg["stylize"]["fft_backend"])
            for r in wl["levels"]]
    blended, capturing = [], [False]
    real_window = harness.sliding_window_inference

    def recording_window(*args, **kwargs):  # keeps a sampled volume's logits
        out = real_window(*args, **kwargs)
        if capturing[0]:
            blended.append(out)
        return out

    loader_spans = ctx.record["spans"]["loader_next"]

    def evaluate(row, level, spans, keep=False):
        batch = [{"image": host_i[row:row + 1], "label": host_l[row:row + 1]}]
        sty = stys[level]
        loader = batch if sty is None else StylizedLoader(
            batch, sty, seed=inputs.subseed(ctx.seed, 6), device=dev)
        timed = TimedLoader(loader, spans, keep)
        return ev.dataset_eval_multi(timed), timed.kept

    ctx.mark("program")
    for level in range(len(stys)):  # every shape and level the window uses
        evaluate(level % wl["pool"], level, [])
    ctx.setup_done()

    plan = schedule(ctx, 100000)
    rng = np.random.default_rng(inputs.subseed(ctx.seed, 7))
    sample = set(rng.choice(wl["check_within"], wl["check_volumes"], replace=False).tolist())
    kept, lat, done = {}, [], 0

    def one(i):
        row, level = plan[i]
        capturing[0] = i in sample
        dice, batch = evaluate(row, level, loader_spans, keep=capturing[0])
        if capturing[0]:
            kept[i] = (row, level, batch["image"], blended.pop(), dice)
        capturing[0] = False

    harness.sliding_window_inference = recording_window
    try:
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            one(done)
            lat.append(time.perf_counter() - a)
            done += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        window = time.perf_counter() - t0
        for i in range(done, max(sample) + 1):  # sampled volumes past the window
            one(i)
    finally:
        harness.sliding_window_inference = real_window
    ctx.window_done(window)
    ctx.attempted = done
    ctx.e2e["eval_vol_per_s"] = done / window
    ctx.e2e["eval_ms_p95"] = 1e3 * float(np.percentile(lat, 95))
    T = flops.sliding_window_tiles(wl["spatial"], wl["roi"], wl["overlap"])
    rec = ctx.record
    rec["counters"].update(volumes=done, tiles_per_volume=T, peak=cfg["precision"]["peak"],
                           flops_per_volume=T * flops.unet_flops(m, wl["roi"]))
    if cfg["stylize"]["fft_backend"].startswith("plane"):
        rec["counters"]["plane_shape"] = [m["in_channels"]] + list(wl["spatial"])
    if ctx.trace_on:
        n = wl["trace_volumes"]

        def work():
            for i in range(done, done + n):
                evaluate(*plan[i], [])

        ctx.traced(work)
        rec["trace"]["volumes"] = n
    del ev, model
    if ctx.device != "cpu":
        torch.cuda.empty_cache()

    gaps = {"stylize_gap": 0.0, "logit_gap": 0.0, "dice_gap": 0.0}
    for row, level, image, logits, dice in kept.values():
        with full_float32():
            x, ref_logits = reference_outputs(ctx, weights, host_i[row:row + 1], level)
            label = torch.from_numpy(host_l[row:row + 1]).to(dev)
            gaps["dice_gap"] = max(gaps["dice_gap"],
                                   compare.dice_gap(dice, hard_dice(logits, label)))
        gaps["stylize_gap"] = max(gaps["stylize_gap"], compare.rel_max_gap(
            torch.from_numpy(np.asarray(image)).to(dev), x))
        gaps["logit_gap"] = max(gaps["logit_gap"], compare.rel_max_gap(logits, ref_logits))
    for name in ctx.wl["limits"]:
        ctx.check(name, gaps[name])


def control_gaps(ctx, weights, host_i, host_l, picks):
    """The control's gaps on ``picks`` [(row, level)]: the reference one
    precision below the configuration's, judged against the reference. Its
    Dice is taken in the precision below the program's float32 Dice."""
    prec = ctx.cfg["precision"]
    quant = lowp.ROUNDINGS[lowp.below(prec["model"])]
    squant = lowp.ROUNDINGS[lowp.below(prec["stylize"])]
    dquant = lowp.ROUNDINGS[lowp.below("float32")]
    gaps = {"stylize_gap": 0.0, "logit_gap": 0.0, "dice_gap": 0.0}
    for row, level in picks:
        args = (ctx, weights, host_i[row:row + 1], level)
        label = torch.from_numpy(host_l[row:row + 1]).to(torch.device(ctx.device))
        with full_float32():
            x, t = reference_outputs(*args)
            cx, ct = reference_outputs(*args, quant=quant, squant=squant)
            gaps["dice_gap"] = max(gaps["dice_gap"], compare.dice_gap(
                hard_dice(ct, label, dquant), hard_dice(ct, label)))
        gaps["stylize_gap"] = max(gaps["stylize_gap"], compare.rel_max_gap(cx, x))
        gaps["logit_gap"] = max(gaps["logit_gap"], compare.rel_max_gap(ct, t))
    return gaps
