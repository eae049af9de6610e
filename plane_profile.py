"""Where the fused plane kernel's time goes, on the card.

Builds ``mvtb_tpu_torch/csrc/fused_plane.cu`` with its stage-loop cycle
counters compiled in (``-DMVTB_PLANE_PROFILE``) into ``build/profile/``, runs
it once per precision tier on the eval slice's planes (2x4x240x240x160:
968 planes of 240x160, ``chip_smoke.py``'s bench stack) and prints one JSON
line per tier and pass kind (W or D contraction): the mean cycles a stage
of thread 0 of each block spends waiting for its copies (and the first
barrier), issuing the next stage's copies, converting, at the second
barrier, issuing and waiting for its wgmma, and in tile epilogues (per
stage, averaged over the tile), with the kernel's time without counters.

    python3 plane_profile.py

Needs a CUDA device and ``nvcc``; exits 2 without a device.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from mvtb_tpu_torch.ops import _build, fused, fused_plane

PHASES = ("wait", "issue", "convert", "barrier", "wgmma", "epilogue")
BLOCKS = 8192  # rows of the kernel's counter array


def cuda_ms(fn, iters: int) -> float:
    """Mean device ms per call over ``iters`` back-to-back calls after one
    warm-up call, by CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_profiled() -> ctypes.CDLL:
    out = _build.BUILD_DIR.parent / "profile"
    out.mkdir(parents=True, exist_ok=True)
    lib_file = out / "fused_plane_profile.so"
    cmd = [_build.find_nvcc() or "nvcc", *_build.NVCC_FLAGS, "-DMVTB_PLANE_PROFILE",
           "-o", str(lib_file), str(_build.CSRC / "fused_plane.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(lib_file))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mvtb_fused_plane.argtypes = [p] * 12 + [i] * 8 + [p]
    lib.mvtb_fused_plane.restype = i
    lib.mvtb_fused_plane_scratch_floats.argtypes = [i] * 4
    lib.mvtb_fused_plane_scratch_floats.restype = ctypes.c_longlong
    lib.mvtb_cuda_error_string.argtypes = [i]
    lib.mvtb_cuda_error_string.restype = ctypes.c_char_p
    lib.mvtb_plane_profile_take.argtypes = [p]
    lib.mvtb_plane_profile_take.restype = i
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("plane_profile: no CUDA device is visible; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, C, H, W, D = cs.SLICE_SHAPE
    shape = (B * C, H, W, D)
    blocks = B * C * (H // 2 + 1)
    assert blocks <= BLOCKS
    profiled = build_profiled()
    print(cs.smi_line(), flush=True)
    for backend in ("plane", "plane_fast"):
        fast = backend == "plane_fast"
        args = cs.plane_case(fused.StylizeConfig(**cs.BENCH_STACK, fft_backend=backend),
                             shape, dev, seed=3)
        fused_plane._LIB.pop("fused_plane", None)  # the build without counters
        ms = cuda_ms(lambda: fused_plane.plane_stylize_half(*args, fast=fast), 10)
        fused_plane._LIB["fused_plane"] = profiled
        counts = np.zeros((BLOCKS, 2, 8), np.uint64)
        fused_plane.plane_stylize_half(*args, fast=fast)  # warm-up
        torch.cuda.synchronize()
        check = profiled.mvtb_plane_profile_take(counts.ctypes.data)
        cs.check(check == 0, f"reading the counters failed ({check})")
        fused_plane.plane_stylize_half(*args, fast=fast)
        torch.cuda.synchronize()
        cs.check(profiled.mvtb_plane_profile_take(counts.ctypes.data) == 0, "counters")
        fused_plane._LIB.pop("fused_plane", None)
        total = counts[:blocks].astype(np.float64).sum(axis=0)
        for kind, name in enumerate(("W", "D")):
            stages = total[kind, 6]
            per = {ph: total[kind, i] / stages for i, ph in enumerate(PHASES)}
            print(json.dumps({"tier": backend, "shape": list(shape), "pass": name,
                              "kernel_ms": ms, "stages_per_block": stages / blocks,
                              "cycles_per_stage": sum(per.values()),
                              "phase_cycles_per_stage": per}), flush=True)
        del args
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
