"""The work of SegMamba's selective scans, counted from the configuration's
widths and the crop, whatever computes them.

One scan over ``B`` volumes of a stage with ``d = expand C`` channels, ``L``
tokens and ``N`` states is the function ``out = (C . h + D u) * silu(z)``
of ``h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t``, ``dt = softplus(delta +
bias)``, and its gradient:

* operations: ``B d L N`` state updates, 7 each forward (``dt A``, its
  exp, the two products and the sum of ``h``, ``C h`` and its sum) and
  twice that backward; and ``B d L`` positions, 11 each forward (the
  softplus and its bias, ``dt u``, ``D u`` and its sum, the gate's
  sigmoid, product and the output's product), twice that backward;
* bytes, each input and output once in its type: forward ``u``, ``delta``
  and ``z`` in and the output out, ``(B, d, L)`` each, and ``B`` and ``C``
  in, ``(B, L, N)`` each, in the model's type, ``A`` ``(d, N)``, ``D`` and
  the bias ``(d,)`` in float32; backward those inputs and the output's
  gradient in, and the gradient of every input out.

Its least time (``portbench/roofline.py``) is the larger of the operations
over the top dense rate and the bytes over the memory bandwidth; a step's
least time is the sum over its scans, forward and backward.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

from portbench.roofline import least_seconds

SIZES = {"bfloat16": 2, "float16": 2, "float32": 4}
KERNEL = "selective_scan_"  # the scan's kernels are named selective_scan_*
FWD_PER_UPDATE, FWD_PER_POSITION = 7, 11
F32 = 4


def stage_grids(model: dict, spatial: Sequence[int]) -> List[Tuple[int, ...]]:
    """The token grid of each stage: the stem halves the crop (stride 2,
    kernel 7, padding 3: ``ceil(n / 2)``), each downsample halves it again
    (stride 2, kernel 2: ``floor(n / 2)``)."""
    grid = tuple(-(-n // 2) for n in spatial)
    grids = [grid]
    for _ in model["feature_size"][1:]:
        grid = tuple(n // 2 for n in grid)
        grids.append(grid)
    return grids


def scans(model: dict, spatial: Sequence[int]) -> List[dict]:
    """Every scan of one forward on one volume: its channels, tokens and
    states (three orders a Mamba layer)."""
    out = []
    for c, depth, grid in zip(model["feature_size"], model["depths"],
                              stage_grids(model, spatial)):
        for _ in range(3 * depth):
            out.append({"d": model["expand"] * c, "L": math.prod(grid), "N": model["d_state"]})
    return out


def scan_work(d: int, L: int, N: int, batch: int, dtype: str = "bfloat16",
              backward: bool = False) -> Tuple[float, float]:
    """(operations, bytes) of one scan over ``batch`` volumes, forward or
    backward."""
    s = SIZES[dtype]
    rows, seq = batch * d * L, batch * L * N
    ops = FWD_PER_UPDATE * rows * N + FWD_PER_POSITION * rows
    params = F32 * (d * N + 2 * d)
    if not backward:
        return float(ops), float(s * (4 * rows + 2 * seq) + params)
    # in: u, delta, z, dout, B, C and the parameters; out: du, ddelta, dz,
    # dB, dC and the parameters' gradients
    return 2.0 * ops, float(s * (7 * rows + 4 * seq) + 2 * params)


def step_work(model: dict, spatial: Sequence[int], batch: int,
              dtype: str = "bfloat16") -> List[Tuple[float, float]]:
    """(operations, bytes) of every scan call of a training step, forward
    then backward."""
    calls = scans(model, spatial)
    return ([scan_work(c["d"], c["L"], c["N"], batch, dtype) for c in calls]
            + [scan_work(c["d"], c["L"], c["N"], batch, dtype, backward=True) for c in calls])


def step_least_seconds(model: dict, spatial: Sequence[int], batch: int,
                       dtype: str = "bfloat16") -> float:
    """The least time of a training step's scans, forward and backward."""
    return sum(least_seconds(ops, nbytes)[0]
               for ops, nbytes in step_work(model, spatial, batch, dtype))


def scan_flops(model: dict, spatial: Sequence[int], backward: bool = False) -> float:
    """Operations of one volume's scans, forward (and backward)."""
    return sum(scan_work(c["d"], c["L"], c["N"], 1)[0] * (3 if backward else 1)
               for c in scans(model, spatial))


def device_ms(trace) -> float:
    """Device milliseconds of the scan's kernels (by name) in a traced
    window; 0 where it has none."""
    return 1e-3 * sum(e["dur"] for e in (trace or {}).get("device", [])
                      if e["cat"] == "kernel" and KERNEL in e["name"])
