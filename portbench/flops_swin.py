"""Operations of SwinUNETR's products, counted from the configuration's
widths and the crop as ``torch.utils.flop_counter`` counts them on the
plain reference (``portbench/reference/swin_unetr.py``): two operations a
multiply-add; a convolution ``2 * batch * prod(weight) * voxels`` (the
output's voxels, the input's for a transposed one); a linear layer ``2 *
rows * in * out``, over the padded windows' tokens for ``qkv`` and
``proj`` and the real tokens otherwise; window attention ``q k^T`` and
``attn @ v``, ``2 * windows * N * N * C`` each. Norms, softmax,
activations and biases are not counted. A backward pass counts the input
gradient of every product whose input needs one (all but the convolutions
reading the network's input) and the weight gradient of every layer with
weights, each as many operations as the forward; both operands of an
attention product need their gradient."""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

from portbench.flops import Conv

# (operations of the forward, operations of the backward)
Work = Tuple[float, float]


def stage_grids(model: dict, spatial: Sequence[int]) -> List[Tuple[int, ...]]:
    """The token grid of each Swin stage: the patch embedding halves the
    crop, each stage's merge halves it again (rounding up)."""
    grid = tuple(-(-n // 2) for n in spatial)
    grids = []
    for _ in model["depths"]:
        grids.append(grid)
        grid = tuple(-(-n // 2) for n in grid)
    return grids


def windows(grid: Sequence[int], window: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(window, padded grid) of a stage: an axis of at most ``window`` takes
    its own length as window; the grid is padded up to a multiple."""
    ws = tuple(g if g <= window else window for g in grid)
    return ws, tuple(-(-g // w) * w for g, w in zip(grid, ws))


def unetr_convs(model: dict, spatial: Sequence[int]) -> List[Conv]:
    """Every convolution of the model, on one volume: ``(cin, cout, k,
    voxels, reads the network input)``; a transposed one's voxels are its
    input's."""
    f, cin = model["feature_size"], model["in_channels"]
    full = math.prod(spatial)
    grids = stage_grids(model, spatial)
    vox = [math.prod(g) for g in grids] + [math.prod(-(-n // 2) for n in grids[-1])]
    convs: List[Conv] = [(cin, f, 2, vox[0], True)]  # patch embedding

    def res(a, b, v, first=False):
        convs.append((a, b, 3, v, first))
        convs.append((b, b, 3, v, False))
        if a != b:
            convs.append((a, b, 1, v, first))

    res(cin, f, full, first=True)          # encoder1 on the input
    res(f, f, vox[0])                      # encoder2 on x0
    res(2 * f, 2 * f, vox[1])              # encoder3 on x1
    res(4 * f, 4 * f, vox[2])              # encoder4 on x2
    res(16 * f, 16 * f, vox[4])            # encoder10 on x4
    for c_in, c_out, v_in, v_out in ((16 * f, 8 * f, vox[4], vox[3]),
                                     (8 * f, 4 * f, vox[3], vox[2]),
                                     (4 * f, 2 * f, vox[2], vox[1]),
                                     (2 * f, f, vox[1], vox[0]),
                                     (f, f, vox[0], full)):
        convs.append((c_in, c_out, 2, v_in, False))  # transposed, input's voxels
        res(2 * c_out, c_out, v_out)
    convs.append((f, model["out_channels"], 1, full, False))  # head
    return convs


def swin_products(model: dict, spatial: Sequence[int]) -> List[Work]:
    """(forward, backward) operations of the Swin encoder's linear layers
    and attention products, on one volume."""
    out: List[Work] = []
    f, window = model["feature_size"], model["window_size"]
    for s, (grid, depth) in enumerate(zip(stage_grids(model, spatial), model["depths"])):
        c = f * 2 ** s
        ws, padded = windows(grid, window)
        real, pad, n = math.prod(grid), math.prod(padded), math.prod(ws)
        for _ in range(depth):
            for rows, a, b in ((pad, c, 3 * c), (pad, c, c), (real, c, 4 * c), (real, 4 * c, c)):
                out.append((2.0 * rows * a * b, 4.0 * rows * a * b))
            attn = 2.0 * 2 * pad * n * c  # q k^T and attn @ v
            out.append((attn, 2 * attn))
        merged = math.prod(-(-g // 2) for g in grid)
        out.append((2.0 * merged * 8 * c * 2 * c, 4.0 * merged * 8 * c * 2 * c))
    return out


def swin_unetr_flops(model: dict, spatial: Sequence[int], batch: int = 1,
                     backward: bool = False) -> float:
    """Forward (or forward + backward) operations of ``batch`` volumes."""
    total = 0.0
    for cin, cout, k, vox, first in unetr_convs(model, spatial):
        fwd = 2.0 * cin * cout * k ** 3 * vox
        total += fwd + (fwd * (1 if first else 2) if backward else 0.0)
    for fwd, bwd in swin_products(model, spatial):
        total += fwd + (bwd if backward else 0.0)
    return batch * total
