"""Training in chunks, as ``train_chunked`` trains the ResUNet, of the model
the configuration names by ``model.kind`` (``SwinUNETR``): a pool of
volumes on the card, K-step chunks of ``train/chunked.py:make_chunk_fn``
(K ``seg_train_step`` calls: stylize -> model forward and backward -> Dice
loss -> amsgrad), one loss read a chunk, one client, closed loop.

The program's model comes from ``mvtb_tpu_torch.models.build_seg_model``,
the reference's from its plain module under ``portbench/reference/``; the
first chunk is read as ``train_chunked`` reads it (its
``program_first_chunk``, by import), and the reference follows the same K
steps. Set-up builds one training state from the seed and drives it
through that first chunk, which also warms the window's shapes; the same
state then trains through the window.

The port's model module is imported before anything else is done, so a
program without it fails at once.
"""

from __future__ import annotations

import math
import time
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

import mvtb_tpu_torch.models.swin_unetr  # noqa: F401  (the model this kind measures)
from portbench import compare, flops_swin, inputs
from portbench.harness import load_file
from portbench.reference import lowp, swin_unetr as ref_swin, train as ref_train
from portbench.reference.optim import Amsgrad
from portbench.reference.precision import full_float32
from portbench.reference.stylize import disk_lowpass

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# model.kind -> (the port's name for it in build_seg_model, its plain reference,
# its operations per volume)
MODELS = {"SwinUNETR": ("swin_unetr", ref_swin, flops_swin.swin_unetr_flops)}
TABLE_STD = 0.02

_base = load_file(Path(__file__).with_name("train_chunked.py"), "portbench_driver_train_chunked")
program_first_chunk = _base.program_first_chunk


def widths(model_cfg: dict) -> dict:
    return {k: v for k, v in model_cfg.items()
            if k not in ("kind", "in_channels", "out_channels")}


def make_weights(seed: int, shapes: Dict[str, Tuple[int, ...]], device) -> Dict[str, torch.Tensor]:
    """float32 parameters in one draw: the weight of every convolution and
    linear layer normal with standard deviation 1/sqrt(fan in) (a
    transposed convolution's fan in is its input channels times its
    kernel), the relative-position bias tables normal with standard
    deviation 0.02, LayerNorm scales 1, biases 0."""
    g = inputs.generator(seed, device, 2)
    drawn = {k: s for k, s in shapes.items() if len(s) in (2, 5)}
    flat = torch.randn(sum(math.prod(s) for s in drawn.values()), generator=g, device=device)
    out, i = {}, 0
    for k, s in shapes.items():
        if k in drawn:
            n = math.prod(s)
            if k.endswith("relative_position_bias_table"):
                scale = TABLE_STD
            else:
                fan_in = s[0] if "transp_conv" in k else s[1]
                scale = 1.0 / math.sqrt(fan_in * math.prod(s[2:]))
            out[k] = flat[i:i + n].view(s) * scale
            i += n
        elif k.endswith("norm.weight") or k.endswith("norm1.weight") or k.endswith("norm2.weight"):
            out[k] = torch.ones(s, device=device)
        else:
            out[k] = torch.zeros(s, device=device)
    return out


def make_inputs(ctx):
    """Weights, pool and the rows of the first chunk's K steps, from the seed."""
    cfg, wl, dev = ctx.cfg, ctx.wl, torch.device(ctx.device)
    m = cfg["model"]
    weights = make_weights(ctx.seed, MODELS[m["kind"]][1].param_shapes(m), dev)
    pool_i, pool_l = inputs.textured_pool(ctx.seed, wl["pool"], m["in_channels"],
                                          wl["spatial"], dev)
    rng = np.random.default_rng(inputs.subseed(ctx.seed, 4))
    B, K = wl["batch"], wl["chunk_steps"]
    if K * B > wl["pool"]:
        raise ValueError("the first chunk needs chunk_steps * batch distinct pool rows")
    first = torch.from_numpy(rng.permutation(wl["pool"])[:K * B].reshape(K, B)).to(dev)
    return weights, pool_i, pool_l, first, rng


def build_program(ctx, weights):
    from mvtb_tpu_torch.models import build_seg_model
    from mvtb_tpu_torch.ops.fused import StylizeConfig
    from mvtb_tpu_torch.train.chunked import make_chunk_fn
    from mvtb_tpu_torch.train.seg import create_seg_state, reference_optimizer

    cfg, dev = ctx.cfg, torch.device(ctx.device)
    m, opt = cfg["model"], cfg["optimizer"]
    model = build_seg_model(MODELS[m["kind"]][0], m["in_channels"], m["out_channels"],
                            device=dev, dtype=DTYPES[cfg["precision"]["model"]], **widths(m))
    model.load_state_dict(weights)
    state = create_seg_state(model, reference_optimizer(
        model.parameters(), opt["lr"], opt["weight_decay"]), device=dev)
    return state, make_chunk_fn(StylizeConfig(**cfg["stylize"]), dev)


def train_steps(model_cfg: dict, weights, batches, r, lr: float, wd: float, device,
                quant=None, block: int = 1, fault=None):
    """The reference's steps from ``weights`` (one a batch): the losses,
    the first gradient as the optimizer takes it (``grad + wd * p``) and
    the final parameters. ``fault="half_batch"`` averages each step over
    the first half of its rows."""
    model = MODELS[model_cfg["kind"]][1].build(model_cfg).to(device)
    params = {k: v.detach().clone().float() for k, v in weights.items()}
    opt = Amsgrad(params, lr, wd)
    losses, first = [], None
    for images, labels in batches:
        rows = slice(0, images.shape[0] // 2) if fault == "half_batch" else None
        loss, grads = ref_train.loss_and_grads(model, params, images, labels, r, quant,
                                               block, rows)
        if first is None:
            first = {k: grads[k] + wd * params[k] for k in params}
        opt.step(grads)
        losses.append(loss)
    return losses, first, params


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
    losses, first_g, params = train_steps(
        cfg["model"], weights, batches, r, cfg["optimizer"]["lr"],
        cfg["optimizer"]["weight_decay"], pool_i.device, quant=quant,
        block=ctx.wl["reference_block"], fault=fault)
    return {"losses": losses, "mean_loss": sum(losses) / len(losses),
            "grad": {k: float(v.norm()) for k, v in first_g.items()},
            "change": {k: float((params[k] - weights[k]).norm()) for k in params}}


def upper_readings(ctx) -> dict:
    """The gaps of the control (the reference one precision below the
    configuration's, in the program's place) and of a step that averages
    over half of its batch, against the reference."""
    weights, pool_i, pool_l, first, _ = make_inputs(ctx)
    with full_float32():
        ref = reference_first_steps(ctx, weights, pool_i, pool_l, first)
        ctrl = reference_first_steps(ctx, weights, pool_i, pool_l, first, control=True)
        half = reference_first_steps(ctx, weights, pool_i, pool_l, first, fault="half_batch")
    return {"control": compare.train_gaps(ctrl, ref), "half_batch": compare.train_gaps(half, ref)}


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
    rec, m = ctx.record, ctx.cfg["model"]
    rec["counters"].update(steps=steps, volumes=steps * B, peak=ctx.cfg["precision"]["peak"],
                           flops_per_volume=MODELS[m["kind"]][2](m, wl["spatial"],
                                                                 backward=True))
    rec["spans"]["chunk_issue"] = issue
    if ctx.cfg["stylize"].get("fft_backend", "").startswith("plane"):
        rec["counters"]["plane_shape"] = [B * m["in_channels"]] + list(wl["spatial"])
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
