"""Operations of the model's convolutions, counted from the configuration's
widths and the input shape as ``torch.utils.flop_counter`` counts them:
two operations a multiply-add, ``2 * batch * prod(weight) * prod(voxels)``
with the output's voxels for a convolution and the input's for a transposed
one; biases, norms and activations are not counted. A backward pass counts
the input gradient of every convolution whose input needs one (all but
those reading the network's input) and the weight gradient of every one,
each as many operations as the forward."""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

# (cin, cout, kernel, voxels counted, reads the network input)
Conv = Tuple[int, int, int, int, bool]


def _out(spatial: Sequence[int], stride: int) -> Tuple[int, ...]:
    return tuple(-(-n // stride) for n in spatial)


def unet_convs(model: dict, spatial: Sequence[int]) -> List[Conv]:
    """Every convolution of the residual UNet ``model`` describes, on one
    volume of ``spatial`` voxels."""
    convs: List[Conv] = []
    nres = model["num_res_units"]

    def unit(cin, cout, stride, sp, subunits, first):
        out = _out(sp, stride)
        c = cin
        for i in range(subunits):
            convs.append((c, cout, 3, math.prod(out), first and i == 0))
            c = cout
        if stride != 1 or cin != cout:
            convs.append((cin, cout, 3 if stride != 1 else 1, math.prod(out), first))
        return out

    def level(cin, cout, channels, strides, sp, top):
        c, s = channels[0], strides[0]
        down = unit(cin, c, s, sp, nres, top)
        if len(channels) > 2:
            level(c, c, channels[1:], strides[1:], down, False)
            sub_out = c
        else:
            unit(c, channels[1], 1, down, nres, False)
            sub_out = channels[1]
        convs.append((c + sub_out, cout, 3, math.prod(down), False))  # transposed
        unit(cout, cout, 1, sp, 1, False)

    level(model["in_channels"], model["out_channels"], tuple(model["channels"]),
          tuple(model["strides"]), tuple(spatial), True)
    return convs


def unet_flops(model: dict, spatial: Sequence[int], batch: int = 1,
               backward: bool = False) -> float:
    """Forward (or forward + backward) operations of ``batch`` volumes."""
    total = 0.0
    for cin, cout, k, vox, first in unet_convs(model, spatial):
        f = 2.0 * batch * cin * cout * k ** 3 * vox
        total += f
        if backward:
            total += f * (1 if first else 2)
    return total


def sliding_window_tiles(spatial: Sequence[int], roi: Sequence[int],
                         overlap: float) -> int:
    """Tiles of MONAI's dense grid: on each axis a tile every
    ``int(roi * (1 - overlap))`` voxels, the last flush with the end."""
    counts = []
    for n, r in zip(spatial, roi):
        if n <= r:
            counts.append(1)
            continue
        step = max(int(r * (1.0 - overlap)), 1)
        counts.append(len(range(0, n - r + 1, step)) + ((n - r) % step != 0))
    return math.prod(counts)


def fft_flops(lengths: Sequence[int]) -> float:
    """Real operations of one complex transform over axes of ``lengths``:
    ``5 n log2 n`` for ``n`` the product of the lengths."""
    n = math.prod(lengths)
    return 5.0 * n * math.log2(n)

