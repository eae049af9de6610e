"""Operations of SegMamba, counted from the configuration's widths and the
crop: its products as ``torch.utils.flop_counter`` counts them on the
plain reference (``portbench/reference/segmamba.py``), two operations a
multiply-add (a convolution ``2 * prod(weight) / groups-share * output
voxels``, a transposed one over its input's voxels, the causal ``conv1d``
over its ``L + d_conv - 1`` padded outputs; a linear layer ``2 * rows *
in * out``), plus the selective scans' own (``portbench/scan_work.py``),
which the flop counter does not see. Norms, activations, biases and the
reorders are not counted. A backward pass counts the input gradient of
every product whose input needs one (all but the two convolutions reading
the network's input) and the weight gradient of every product with
weights, each as many operations as the forward; a scan's backward
counts twice its forward."""

from __future__ import annotations

import math
from typing import List, Sequence

from portbench.flops import Conv
from portbench.scan_work import scan_flops, stage_grids


def convs(model: dict, spatial: Sequence[int]) -> List[Conv]:
    """Every 3D convolution of one volume: ``(cin, cout, k, voxels, reads
    the network input)``; a transposed one's voxels are its input's."""
    f, cin, hidden = list(model["feature_size"]), model["in_channels"], model["hidden_size"]
    grids = [math.prod(g) for g in stage_grids(model, spatial)]
    full = math.prod(spatial)
    out: List[Conv] = [(cin, f[0], 7, grids[0], True)]  # stem
    for i in range(1, len(f)):
        out.append((f[i - 1], f[i], 2, grids[i], False))  # downsample
    for c, v in zip(f, grids):
        out += [(c, c, 3, v, False), (c, c, 3, v, False), (c, c, 1, v, False),
                (c, c, 1, v, False)]  # GSC
        out += [(c, 2 * c, 1, v, False), (2 * c, c, 1, v, False)]  # MLP

    def res(a, b, v, first=False):
        out.append((a, b, 3, v, first))
        out.append((b, b, 3, v, False))
        if a != b:
            out.append((a, b, 1, v, first))

    res(cin, f[0], full, first=True)  # encoder1 on the input
    for i in range(1, len(f)):
        res(f[i - 1], f[i], grids[i - 1])  # encoder2..4 on out_0..2
    res(f[-1], hidden, grids[-1])  # encoder5 on out_3
    ups = [(hidden, f[-1])] + [(f[i], f[i - 1]) for i in range(len(f) - 1, 0, -1)]
    vox_in = grids[::-1]
    vox_out = grids[-2::-1] + [full]
    for (a, b), vi, vo in zip(ups, vox_in, vox_out):
        out.append((a, b, 2, vi, False))  # transposed, its input's voxels
        res(2 * b, b, vo)
    res(f[0], f[0], full)  # decoder1
    out.append((f[0], model["out_channels"], 1, full, False))  # head
    return out


def mamba_products(model: dict, spatial: Sequence[int]) -> List[float]:
    """Forward operations of the Mamba layers' products on one volume."""
    out: List[float] = []
    N, k = model["d_state"], model["d_conv"]
    for c, depth, grid in zip(model["feature_size"], model["depths"],
                              stage_grids(model, spatial)):
        L, d, R = math.prod(grid), model["expand"] * c, math.ceil(c / 16)
        for _ in range(depth):
            out.append(2.0 * L * c * 2 * d)  # in_proj
            for _ in range(3):
                out.append(2.0 * (L + k - 1) * d * k)  # causal depthwise conv1d
                out.append(2.0 * L * d * (R + 2 * N))  # x_proj
                out.append(2.0 * L * R * d)  # dt_proj
            out.append(2.0 * L * d * c)  # out_proj
    return out


def segmamba_flops(model: dict, spatial: Sequence[int], batch: int = 1,
                   backward: bool = False) -> float:
    """Forward (or forward + backward) operations of ``batch`` volumes."""
    total = 0.0
    for cin, cout, k, vox, first in convs(model, spatial):
        fwd = 2.0 * cin * cout * k ** 3 * vox
        total += fwd + (fwd * (1 if first else 2) if backward else 0.0)
    total += sum(p * (3 if backward else 1) for p in mamba_products(model, spatial))
    return batch * (total + scan_flops(model, spatial, backward))
