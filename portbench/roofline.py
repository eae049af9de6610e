"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W) and
the least time a kernel's function needs.

A kernel's roofline share is that least time over the kernel's measured
time. The least time is the larger of the function's operations over the
highest dense non-fp8 rate and its bytes over the memory bandwidth, with
every input byte read once and every output byte written once, so no
rewrite of the kernel can lift the share past 100%."""

from __future__ import annotations

from typing import Sequence, Tuple

from portbench.flops import fft_flops

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12, "fp8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
TOP_DENSE_FLOPS = PEAK_FLOPS["bfloat16"]  # highest dense non-fp8 rate


def least_seconds(ops: float, nbytes: float) -> Tuple[float, str]:
    t_ops, t_bytes = ops / TOP_DENSE_FLOPS, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def plane_work(shape: Sequence[int], point_writes: int = 0) -> Tuple[float, float]:
    """(operations, bytes) of one fused plane call on an (N, H, W, D) batch
    of volumes: on each of the N * (H//2 + 1) planes of the H-axis half
    spectrum, a forward and an inverse 2D transform over (W, D); read the
    float32 (re, im) planes and five float32 parameters a plane row, plus
    each point write's location and four values; write the (re, im)
    planes."""
    N, H, W, D = (int(v) for v in shape)
    planes = N * (H // 2 + 1)
    ops = planes * 2 * fft_flops((W, D))
    nbytes = (2 * 2 * 4.0 * planes * W * D + 4.0 * 5 * N
              + point_writes * N * (3 * 4.0 + 4 * 4.0))
    return ops, nbytes


def plane_least_seconds(shape: Sequence[int], point_writes: int = 0) -> float:
    return least_seconds(*plane_work(shape, point_writes))[0]


def stylize_flops(shape: Sequence[int]) -> float:
    """Operations of the disk corruption of a (B, C, H, W, D) batch: a
    forward and an inverse complex 3D transform of every channel."""
    B, C = int(shape[0]), int(shape[1])
    return B * C * 2 * fft_flops(shape[2:])

