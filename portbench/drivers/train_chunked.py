"""Training in chunks, as the program's runner trains: a pool of volumes on
the card, K-step chunks of ``train/chunked.py:make_chunk_fn`` (K
``seg_train_step`` calls: stylize -> UNet forward and backward -> Dice loss
-> amsgrad), one loss read a chunk, one client, closed loop.

Set-up builds one training state from the seed and drives it through its
first chunk, a call of the window's own K steps on rows that all differ,
which also warms the window's shapes; the reference follows those K steps.
The same state then trains through the window.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import compare, flops, inputs
from portbench.reference import lowp, train as ref_train
from portbench.reference.precision import full_float32
from portbench.reference.stylize import disk_lowpass
from portbench.reference.unet import param_shapes

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_inputs(ctx):
    """Weights, pool and the rows of the first chunk's K steps, from the seed."""
    cfg, wl, dev = ctx.cfg, ctx.wl, torch.device(ctx.device)
    m = cfg["model"]
    weights = inputs.make_weights(ctx.seed, param_shapes(m), dev)
    pool_i, pool_l = inputs.textured_pool(ctx.seed, wl["pool"], m["in_channels"],
                                          wl["spatial"], dev)
    rng = np.random.default_rng(inputs.subseed(ctx.seed, 4))
    B, K = wl["batch"], wl["chunk_steps"]
    if K * B > wl["pool"]:
        raise ValueError("the first chunk needs chunk_steps * batch distinct pool rows")
    first = torch.from_numpy(rng.permutation(wl["pool"])[:K * B].reshape(K, B)).to(dev)
    return weights, pool_i, pool_l, first, rng


def build_program(ctx, weights):
    from mvtb_tpu_torch.models import UNet
    from mvtb_tpu_torch.ops.fused import StylizeConfig
    from mvtb_tpu_torch.train.chunked import make_chunk_fn
    from mvtb_tpu_torch.train.seg import create_seg_state, reference_optimizer

    cfg, dev = ctx.cfg, torch.device(ctx.device)
    m, opt = cfg["model"], cfg["optimizer"]
    model = UNet(m["in_channels"], m["out_channels"], m["channels"], m["strides"],
                 m["num_res_units"], device=dev, dtype=DTYPES[cfg["precision"]["model"]])
    model.load_state_dict(weights)
    state = create_seg_state(model, reference_optimizer(
        model.parameters(), opt["lr"], opt["weight_decay"]), device=dev)
    return state, make_chunk_fn(StylizeConfig(**cfg["stylize"]), dev)


def program_first_chunk(state, chunk_fn, gen, pool_i, pool_l, first):
    """The first chunk through the window's own call. A recording wrapper
    on the step the chunk calls keeps each step's loss and, after step 1,
    the first gradient read back from the optimizer's state (``mu = (1 -
    b1) * g``); the change is taken after the chunk. Returns the state, the
    generator and the readings."""
    import mvtb_tpu_torch.train.chunked as chunked
    from mvtb_tpu_torch.train.seg import B1

    named = dict(state.model.named_parameters())
    p0 = {k: p.detach().clone() for k, p in named.items()}
    losses, grad = [], {}
    real = chunked.seg_train_step

    def recording(st, *args, **kwargs):
        loss = real(st, *args, **kwargs)
        losses.append(loss.detach().float().clone())
        if len(losses) == 1:
            opt = st.optimizer.state  # a leaf the step left alone reads 0
            grad.update({k: (opt[p]["mu"] / (1 - B1)).norm() if "mu" in opt.get(p, {})
                         else torch.zeros(()) for k, p in named.items()})
        return loss

    chunked.seg_train_step = recording
    try:
        state, gen, mean = chunk_fn(state, gen, pool_i, pool_l, first)
    finally:
        chunked.seg_train_step = real
    change = {k: float((p.detach() - p0[k]).norm()) for k, p in named.items()}
    readings = {"losses": [float(v) for v in losses], "mean_loss": float(mean),
                "grad": {k: float(v) for k, v in grad.items()}, "change": change}
    return state, gen, readings


def reference_first_steps(ctx, weights, pool_i, pool_l, first, control: bool = False,
                          fault=None) -> dict:
    """The plain reference's steps from the same weights and rows (one
    step a row of ``first``); ``control`` computes it one precision below
    the configuration's."""
    cfg = ctx.cfg
    prec = cfg["precision"]
    quant = lowp.ROUNDINGS[lowp.below(prec["model"])] if control else None
    squant = lowp.ROUNDINGS[lowp.below(prec["stylize"])] if control else None
    batches = [(pool_i[rows], pool_l[rows]) for rows in first]
    r = cfg["stylize"].get("disk_r")
    if control:  # the control stylizes below the stated precision too
        batches = [(disk_lowpass(i, r, squant), l) for i, l in batches]
        r = None
    losses, first_g, params = ref_train.train_steps(
        cfg["model"], weights, batches, r, cfg["optimizer"]["lr"],
        cfg["optimizer"]["weight_decay"], pool_i.device, quant=quant,
        block=ctx.wl["reference_block"], fault=fault)
    return {"losses": losses, "mean_loss": sum(losses) / len(losses),
            "grad": {k: float(v.norm()) for k, v in first_g.items()},
            "change": {k: float((params[k] - weights[k]).norm()) for k in params}}


def run(ctx) -> None:
    wl, dev = ctx.wl, torch.device(ctx.device)
    B, K, P = wl["batch"], wl["chunk_steps"], wl["pool"]
    weights, pool_i, pool_l, first, rng = make_inputs(ctx)
    ctx.mark("inputs")
    state, chunk_fn = build_program(ctx, weights)
    gen = inputs.generator(ctx.seed, dev, 3)
    ctx.mark("program")
    state, gen, prog = program_first_chunk(state, chunk_fn, gen, pool_i, pool_l, first)
    ctx.setup_done("first_chunk")

    def draw():
        return torch.from_numpy(rng.integers(0, P, (K, B))).to(dev)

    issue, steps, bad = [], 0, 0
    t0 = time.perf_counter()
    while True:
        idxs = draw()
        a = time.perf_counter()
        state, gen, loss = chunk_fn(state, gen, pool_i, pool_l, idxs)
        issue.append([time.perf_counter() - a, K])
        bad += 0 if math.isfinite(float(loss)) else 1
        steps += K
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    ctx.sync()
    window = time.perf_counter() - t0
    ctx.window_done(window)
    ctx.attempted, ctx.failed = steps * B, bad * K * B
    ctx.e2e["train_vol_per_s"] = steps * B / window
    rec = ctx.record
    rec["counters"].update(steps=steps, volumes=steps * B, peak=ctx.cfg["precision"]["peak"],
                           flops_per_volume=flops.unet_flops(ctx.cfg["model"], wl["spatial"],
                                                             backward=True))
    rec["spans"]["chunk_issue"] = issue
    if ctx.cfg["stylize"].get("fft_backend", "").startswith("plane"):
        rec["counters"]["plane_shape"] = [B * ctx.cfg["model"]["in_channels"]] + list(wl["spatial"])
    if ctx.trace_on:
        n = wl["trace_chunks"]

        def work():
            nonlocal state, gen
            for _ in range(n):
                state, gen, loss = chunk_fn(state, gen, pool_i, pool_l, draw())
                float(loss)

        ctx.traced(work)
        rec["trace"]["steps"] = n * K
    del state, chunk_fn, loss
    if ctx.device != "cpu":
        torch.cuda.empty_cache()

    with full_float32():
        ref = reference_first_steps(ctx, weights, pool_i, pool_l, first)
    gaps = compare.train_gaps(prog, ref)
    for name in ctx.wl["limits"]:
        ctx.check(name, gaps[name])
