"""The work of SwinUNETR's window attention, counted from the configuration's
widths and the crop, whatever computes it, and the share of the attended
tokens that are real.

One block's attention over ``B`` volumes is the function ``softmax(q k^T /
sqrt(d) + bias (+ mask)) v`` on its stage's padded grid of ``Np`` tokens a
volume, in windows of ``N`` tokens, ``C`` channels: ``4 B Np N C``
operations (``q k^T`` and ``attn @ v``); bytes read and written once in
bfloat16: ``q``, ``k`` and ``v`` in and the output out (``8 B Np C``), the
``(heads, N, N)`` bias, and in a shifted block the ``(windows, N, N)``
mask. Its least time (``portbench/roofline.py``) is the larger of the
operations over the bf16 peak and the bytes over the memory bandwidth; a
pass's least time is the sum over its blocks."""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

from portbench.flops_swin import stage_grids, windows
from portbench.roofline import least_seconds

BF16 = 2


def blocks(model: dict, spatial: Sequence[int]) -> List[dict]:
    """Every Swin block of a forward on one volume: its stage's channels,
    heads, real and padded tokens, window tokens, windows and whether it
    shifts (odd blocks, where some axis is longer than the window)."""
    out = []
    for s, grid in enumerate(stage_grids(model, spatial)):
        ws, padded = windows(grid, model["window_size"])
        n = math.prod(ws)
        for i in range(model["depths"][s]):
            out.append({"channels": model["feature_size"] * 2 ** s,
                        "heads": model["num_heads"][s], "real": math.prod(grid),
                        "padded": math.prod(padded), "n": n,
                        "windows": math.prod(p // w for p, w in zip(padded, ws)),
                        "shifted": i % 2 == 1 and any(g > model["window_size"] for g in grid)})
    return out


def attn_work(model: dict, spatial: Sequence[int], batch: int) -> List[Tuple[float, float]]:
    """(operations, bytes) of each block's attention over ``batch`` volumes."""
    work = []
    for b in blocks(model, spatial):
        n, c = b["n"], b["channels"]
        ops = 4.0 * batch * b["padded"] * n * c
        nbytes = BF16 * (4.0 * batch * b["padded"] * c + b["heads"] * n * n
                         + (b["windows"] * n * n if b["shifted"] else 0))
        work.append((ops, nbytes))
    return work


def attn_least_seconds(model: dict, spatial: Sequence[int], batch: int) -> float:
    """The least time of a forward's attention over ``batch`` volumes."""
    return sum(least_seconds(ops, nbytes)[0] for ops, nbytes in attn_work(model, spatial, batch))


def window_fill(model: dict, spatial: Sequence[int]) -> float:
    """Real tokens over attended (padded) tokens of a forward, in %."""
    bs = blocks(model, spatial)
    return 100.0 * sum(b["real"] for b in bs) / sum(b["padded"] for b in bs)
