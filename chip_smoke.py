#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mvtb_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

from the root of a checkout. It needs one CUDA card and the CUDA toolkit
(``nvcc``); it exits non-zero, printing no result, without them. Phases, in
order, each fatal on failure:

1. environment: ``nvidia-smi`` name and power limit, torch and CUDA
   versions, the float32 precision flags as set here (TF32 off everywhere,
   so the plain versions are float32-exact references);
2. build: every kernel of the port compiled from ``mvtb_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel);
3. kernel phase: the fused plane kernel against its plain PyTorch version
   on the card, both precision tiers, at (N, H, W, D) = (8, 240, 240, 160),
   (16, 240, 240, 155) and (3, 15, 13, 11), for every stage combination of
   the JAX package's plane tests; relative-of-max error at most 1e-5
   (``plane``) and 2e-2 (``plane_fast``);
4. slice phase: a small end-to-end reference (``seg_eval_step`` on the card
   against the same step on the CPU, same weights and draws, logits within
   1e-4 of their max), then the main path: ``seg_eval_step`` with the
   full-width 4,810,074-parameter UNet on a 2x4x240x240x160 batch under the
   bench stack (``fft_backend="plane"``); it must launch the kernel, never
   call the plain version on a CUDA tensor, and give finite logits and a
   (2, 3) Dice;
5. timing with CUDA events: kernel, plain version and ``torch.fft``
   (fft2 + ifft2 over the same planes: the transform part only) at the
   slice and bench shapes, ``stylize_batch`` vol/s at the bench's
   4x4x240x240x155, and the eval step's ms.

The last lines are the card's ``nvidia-smi`` line, one ``{"kernels": ...}``
JSON object and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

# NVIDIA H100 SXM data sheet, dense: HBM bytes/s, float32 CUDA-core and bf16
# tensor-core FLOP/s.
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

# The stage combinations of tests/test_fused_plane.py (JAX package).
FLAG_CASES = [
    dict(disk_r=6.0),
    dict(disk_r=6.0, disk_inside_off=True),
    dict(gibbs_alpha=0.4),
    dict(wrap_alpha=0.25),
    dict(gibbs_alpha=0.3, disk_r=7.0, wrap_alpha=0.75),
    dict(spike=True, spike_range=(10.0, 11.0)),
    dict(spike=True, spike_range=(10.0, 11.0), spike_channel_wise=False),
    dict(plane_axes=(6.0, 5.0, 4.0), plane_intensity=9.0),
    dict(disk_r=12.5, plane_axes=(6.0, 5.0, 4.0), plane_intensity=9.0),
    dict(disk_r=6.0, wrap_alpha=0.5, spike=True, spike_range=(9.0, 10.0),
         plane_axes=(6.0, 5.0, 4.0), plane_intensity=8.0),
    dict(gibbs_alpha=(0.2, 0.5), disk_r=(5.0, 8.0), wrap_alpha=(0.3, 0.8),
         spike=True, spike_range=(9.0, 10.0)),
]
# bench.py's five-stage stack
BENCH_STACK = dict(disk_r=(10.0, 25.0), plane_axes=(55.0, 55.0, 30.0),
                   plane_intensity=14.0, spike=True, spike_range=(12.0, 13.0),
                   wrap_alpha=0.5, sap_p=0.05)
# the same stages scaled to a 32^3 volume
SMALL_STACK = dict(disk_r=(3.0, 6.0), plane_axes=(6.0, 5.0, 4.0),
                   plane_intensity=12.0, spike=True, spike_range=(10.0, 11.0),
                   wrap_alpha=0.5, sap_p=0.05)
TOL = {"plane": 1e-5, "plane_fast": 2e-2}
KERNEL_SHAPES = [(8, 240, 240, 160), (16, 240, 240, 155), (3, 15, 13, 11)]
SLICE_SHAPE = (2, 4, 240, 240, 160)
BENCH_SHAPE = (4, 4, 240, 240, 155)


def out(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device ms per call over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def plane_case(cfg, shape, dev, seed):
    """Kernel inputs for one (N, H, W, D) shape: the half spectrum of a
    random volume and parameters drawn through the port's own path."""
    from mvtb_tpu_torch.ops import dft, fused, fused_plane

    N, H, W, D = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    draws = fused.sample_draws(cfg, (H, W, D), N, 1, generator=g, device=dev)
    flags, *params = fused_plane.plane_params(cfg, (H, W, D), draws, N, 1, dev)
    x = torch.randn(N, H, W, D, generator=g, device=dev)
    k_re, k_im = dft.half_dft_axis(x, 1)
    return (k_re, k_im, (H, W, D), flags, *params)


def plane_bound(shape):
    N, H, W, D = shape
    Hh = H // 2 + 1
    flops = 12.0 * W * D * (W + D) * N * Hh
    nbytes = 4.0 * (4 * N * Hh * W * D + 6 * W * W + 6 * D * D + 9 * N)
    return flops, nbytes


def kernel_phase(dev) -> dict:
    from mvtb_tpu_torch.ops import fused, fused_plane

    worst = {}
    for shape in KERNEL_SHAPES:
        for backend in ("plane", "plane_fast"):
            fast = backend == "plane_fast"
            for i, kw in enumerate(FLAG_CASES):
                cfg = fused.StylizeConfig(**kw, fft_backend=backend)
                args = plane_case(cfg, shape, dev, seed=i)
                got = fused_plane.plane_stylize_half(*args, fast=fast)
                ref = fused_plane.plane_stylize_half_plain(*args, fast=fast)
                torch.cuda.synchronize()
                err = max(rel_err(a, b) for a, b in zip(got, ref))
                check(all(bool(torch.isfinite(a).all()) for a in got),
                      f"non-finite kernel output {shape} {backend} {kw}")
                check(err <= TOL[backend],
                      f"kernel vs plain {shape} {backend} {kw}: {err:.3e} > {TOL[backend]}")
                key = f"{backend} {shape}"
                worst[key] = max(worst.get(key, 0.0), err)
    return worst


def slice_phase(dev) -> dict:
    from mvtb_tpu_torch.models import UNet
    from mvtb_tpu_torch.ops import fused, fused_plane
    from mvtb_tpu_torch.train import seg_eval_step

    torch.manual_seed(0)
    model = UNet(4, 3, device=dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == 4_810_074, f"UNet has {n_params} parameters")

    # small end-to-end reference: the same step on the CPU (plain versions)
    cpu_model = UNet(4, 3, device="cpu").eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    small = fused.StylizeConfig(**SMALL_STACK, fft_backend="plane")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 4, 32, 32, 32, generator=g)
    lab = (torch.rand(1, 3, 32, 32, 32, generator=g) < 0.3).float()
    draws = fused.sample_draws(small, (32, 32, 32), 1, 4, generator=g, device="cpu")
    d_cpu, lo_cpu = seg_eval_step(cpu_model, x, lab, small, draws=draws,
                                  device="cpu", return_logits=True)
    d_gpu, lo_gpu = seg_eval_step(model, x, lab, small, draws=draws,
                                  device=dev, return_logits=True)
    small_err = rel_err(lo_gpu.cpu(), lo_cpu)
    check(small_err <= 1e-4, f"card vs CPU logits at 1x4x32^3: {small_err:.3e}")

    # the main path
    cfg = fused.StylizeConfig(**BENCH_STACK, fft_backend="plane")
    g = torch.Generator(device=dev).manual_seed(2)
    image = torch.randn(SLICE_SHAPE, generator=g, device=dev)
    label = (torch.rand((2, 3) + SLICE_SHAPE[2:], generator=g, device=dev) < 0.3).float()
    plain = fused_plane.plane_stylize_half_plain
    plain_on_card = []

    def watched_plain(k_re, *a, **kw):
        if k_re.is_cuda:
            plain_on_card.append(tuple(k_re.shape))
        return plain(k_re, *a, **kw)

    fused_plane.plane_stylize_half_plain = watched_plain
    try:
        fused_plane.plane_stylize_half.launches = 0
        dice, logits = seg_eval_step(model, image, label, cfg, generator=g,
                                     device=dev, return_logits=True)
        torch.cuda.synchronize()
        launches = fused_plane.plane_stylize_half.launches
    finally:
        fused_plane.plane_stylize_half_plain = plain
    check(launches > 0, "the main path never launched the plane kernel")
    check(not plain_on_card, f"plain version ran on the card: {plain_on_card}")
    check(tuple(dice.shape) == (2, 3), f"dice shape {tuple(dice.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    check(tuple(logits.shape) == (2, 3) + SLICE_SHAPE[2:], "logits shape")

    step_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seg_eval_step(model, image, label, cfg, generator=g, device=dev)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    # the step's two halves on their own, device time
    with torch.no_grad():
        stylize_ms = cuda_ms(lambda: fused.stylize_batch(
            image, cfg, generator=g, device=dev), 3)
        unet_ms = cuda_ms(lambda: model(image), 3)
    return {"unet_params": n_params, "small_ref_logits_rel_err": small_err,
            "stylize_batch_ms": stylize_ms, "unet_forward_ms": unet_ms,
            "launches": launches, "dice": dice.cpu().tolist(),
            "eval_step_ms": [s * 1e3 for s in step_s],
            "eval_step_ms_median": statistics.median(step_s) * 1e3}


def timing_phase(dev) -> dict:
    from mvtb_tpu_torch.ops import fused, fused_plane

    res = {}
    for name, (B, C, H, W, D) in (("slice", SLICE_SHAPE), ("bench", BENCH_SHAPE)):
        shape = (B * C, H, W, D)
        flops, nbytes = plane_bound(shape)
        for backend in ("plane", "plane_fast"):
            fast = backend == "plane_fast"
            cfg = fused.StylizeConfig(**BENCH_STACK, fft_backend=backend)
            args = plane_case(cfg, shape, dev, seed=3)
            got = fused_plane.plane_stylize_half(*args, fast=fast)
            ref = fused_plane.plane_stylize_half_plain(*args, fast=fast)
            torch.cuda.synchronize()
            abs_err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
            rel = max(rel_err(a, b) for a, b in zip(got, ref))
            del got, ref
            kc = torch.complex(args[0], args[1])
            peak = BF16_FLOPS if fast else F32_FLOPS
            res[f"{backend} {name}"] = {
                "shape": list(shape),
                "ms": cuda_ms(lambda: fused_plane.plane_stylize_half(*args, fast=fast), 10),
                "plain_ms": cuda_ms(lambda: fused_plane.plane_stylize_half_plain(*args, fast=fast), 5),
                "library_ms_fft2_ifft2_transform_only": cuda_ms(
                    lambda: torch.fft.ifft2(torch.fft.fft2(kc)), 10),
                "gflop": flops / 1e9, "gbytes": nbytes / 1e9,
                "bound_ms": max(flops / peak, nbytes / HBM_BPS) * 1e3,
                "bound_by": "operations" if flops / peak > nbytes / HBM_BPS else "bytes",
                "bound_peak": "bf16 tensor core" if fast else "float32 CUDA core",
                "max_abs_err": abs_err, "max_rel_err": rel}
            del kc, args
        torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(BENCH_SHAPE, generator=g, device=dev)
    for backend in ("plane", "plane_fast"):
        cfg = fused.StylizeConfig(**BENCH_STACK, fft_backend=backend)
        ms = cuda_ms(lambda: fused.stylize_batch(x, cfg, generator=g, device=dev), 5)
        res[f"stylize_batch {backend} bench"] = {"ms": ms, "vol_per_s": BENCH_SHAPE[0] / ms * 1e3}
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run", file=sys.stderr)
        return 2
    from mvtb_tpu_torch.ops import _build

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = smi_line()
    out({"env": {"nvidia_smi": smi, "torch": torch.__version__,
                 "cuda": torch.version.cuda, "python": sys.version.split()[0],
                 "device_count": torch.cuda.device_count(),
                 "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                 "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                 "float32_matmul_precision": torch.get_float32_matmul_precision()}})

    t0 = time.perf_counter()
    built = _build.build()
    out({"build_s": time.perf_counter() - t0, "per_kernel_s": built})
    for name in _build.SOURCES:
        log = (_build.BUILD_DIR / f"{name}.log")
        if log.is_file():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    out(f"ptxas {name}: {line.strip()}")

    t0 = time.perf_counter()
    worst = kernel_phase(dev)
    out({"kernel_phase_max_rel_err": worst, "tolerance": TOL,
         "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    sl = slice_phase(dev)
    sl["seconds"] = time.perf_counter() - t0
    out({"slice_phase": sl})

    t0 = time.perf_counter()
    tm = timing_phase(dev)
    out({"timing": tm, "card": smi, "seconds": time.perf_counter() - t0})

    main_t = tm["plane slice"]
    out(smi_line())
    out({"kernels": [{
        "name": "fused_plane", "route": "cuda",
        "source": "mvtb_tpu_torch/csrc/fused_plane.cu",
        "replaces": "mvtb_tpu/ops/fused_plane.py:218",
        "launches": sl["launches"], "max_abs_err": main_t["max_abs_err"],
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms_fft2_ifft2_transform_only"]}]})
    out({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
