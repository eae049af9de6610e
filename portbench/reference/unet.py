"""Plain 3D ResUNet: the reference's model (``baseline.py:198-206``, MONAI
``UNet(spatial_dims=3, in_channels=4, out_channels=3, channels=(16, 32, 64,
128, 256), strides=(2, 2, 2, 2), num_res_units=2)``) written out in plain
PyTorch, float32 throughout.

Structure: each level is a residual unit of two conv -> instance norm ->
PReLU blocks (the first strided) plus a projection; the bottom is a
residual unit at stride 1; each decoder level is a stride-2 transposed conv
-> norm -> PReLU on the concatenated skip, then a one-block residual unit
(the top one ends in a bare conv). Instance norm has eps 1e-5 and no affine;
PReLU has one slope.

Padding follows XLA's ``SAME`` rule, which the measured program keeps from
the package it was ported from: an axis of length ``n`` under kernel ``k``
and stride ``s`` is padded by ``max((ceil(n/s) - 1) * s + k - n, 0)`` in
all, the smaller half before. A ``SAME`` transposed conv is the full
``conv_transpose3d`` cropped to ``n * s`` outputs starting at ``k - 1 -
pad_lo``, ``pad_lo = k - 1`` if ``s > k - 1`` else ``ceil((k + s - 2) / 2)``.

Parameter names follow the flax module names (``ResidualUnit_0.ConvNormAct_1
.Conv_0.weight``), the layout the benchmark's weights are made in, so one
state dict loads into this module and into the measured one.

``quant`` rounds every activation and every convolution's operands (input
and weight), and its ``grad``, where it has one, rounds the gradient
reaching each convolution's output: the precision policy of a model whose
activations all live in one low type. It is None for the reference; the
control passes a rounding below the configuration's type (:mod:`.lowp`).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def same_pads(n: int, k: int, s: int):
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dims = tuple(range(2, x.ndim))
    mean = x.mean(dim=dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def _q(quant: Quant, t: torch.Tensor) -> torch.Tensor:
    return t if quant is None else quant(t)


def _qo(quant: Quant, y: torch.Tensor) -> torch.Tensor:
    """A product's output, whose gradient ``quant.grad`` rounds, if it has one."""
    return y if getattr(quant, "grad", None) is None else quant.grad(y)


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1):
        super().__init__()
        self.k, self.stride = k, stride
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, quant: Quant = None):
        pads = []
        for n in reversed(x.shape[2:]):
            pads += same_pads(n, self.k, self.stride)
        x = F.pad(x, pads)
        y = F.conv3d(_q(quant, x), _q(quant, self.weight), stride=self.stride)
        return _q(quant, _qo(quant, y) + self.bias.view(-1, 1, 1, 1))


class ConvTranspose(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 2):
        super().__init__()
        self.k, self.stride = k, stride
        self.weight = nn.Parameter(torch.zeros(cin, cout, k, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, quant: Quant = None):
        k, s = self.k, self.stride
        pad_lo = k - 1 if s > k - 1 else -(-(k + s - 2) // 2)
        a = k - 1 - pad_lo
        y = F.conv_transpose3d(_q(quant, x), _q(quant, self.weight), stride=s)
        h, w, d = (n * s for n in x.shape[2:])
        y = y[:, :, a:a + h, a:a + w, a:a + d]
        return _q(quant, _qo(quant, y) + self.bias.view(-1, 1, 1, 1))


class ConvNormAct(nn.Module):
    def __init__(self, cin, cout, stride=1, transposed=False, conv_only=False):
        super().__init__()
        if transposed:
            self.ConvTranspose_0 = ConvTranspose(cin, cout, 3, stride)
        else:
            self.Conv_0 = Conv(cin, cout, 3, stride)
        self.transposed, self.conv_only = transposed, conv_only
        if not conv_only:
            self.PReLU_0 = nn.Module()
            self.PReLU_0.weight = nn.Parameter(torch.zeros(1))

    def forward(self, x, quant: Quant = None):
        conv = self.ConvTranspose_0 if self.transposed else self.Conv_0
        x = conv(x, quant)
        if self.conv_only:
            return x
        x = _q(quant, instance_norm(x))
        return _q(quant, torch.where(x >= 0, x, self.PReLU_0.weight * x))


class ResidualUnit(nn.Module):
    def __init__(self, cin, cout, stride=1, subunits=2, last_conv_only=False):
        super().__init__()
        c = cin
        for i in range(subunits):
            self.add_module(f"ConvNormAct_{i}", ConvNormAct(
                c, cout, stride if i == 0 else 1,
                conv_only=last_conv_only and i == subunits - 1))
            c = cout
        self.subunits = subunits
        self.has_res = stride != 1 or cin != cout
        if self.has_res:
            self.Conv_0 = Conv(cin, cout, 3 if stride != 1 else 1, stride)

    def forward(self, x, quant: Quant = None):
        y = x
        for i in range(self.subunits):
            y = getattr(self, f"ConvNormAct_{i}")(y, quant)
        return _q(quant, y + (self.Conv_0(x, quant) if self.has_res else x))


class UNet(nn.Module):
    """``UNet(in_channels, out_channels, channels, strides, num_res_units)``
    on channel-first ``(B, C, H, W, D)`` float32 tensors; returns logits."""

    def __init__(self, in_channels: int, out_channels: int,
                 channels: Sequence[int] = (16, 32, 64, 128, 256),
                 strides: Sequence[int] = (2, 2, 2, 2), num_res_units: int = 2):
        super().__init__()
        self.nres = num_res_units
        self._n = {"ResidualUnit": 0, "ConvNormAct": 0}
        self.plan = self._level(in_channels, out_channels, tuple(channels),
                                tuple(strides), True)

    def _add(self, kind, module):
        name = f"{kind}_{self._n[kind]}"
        self._n[kind] += 1
        self.add_module(name, module)
        return name

    def _level(self, cin, cout, channels, strides, top):
        c, s = channels[0], strides[0]
        down = self._add("ResidualUnit", ResidualUnit(cin, c, s, self.nres))
        if len(channels) > 2:
            sub, sub_out = self._level(c, c, channels[1:], strides[1:], False), c
        else:
            sub = self._add("ResidualUnit", ResidualUnit(c, channels[1], 1, self.nres))
            sub_out = channels[1]
        up = (self._add("ConvNormAct", ConvNormAct(c + sub_out, cout, s, transposed=True)),
              self._add("ResidualUnit", ResidualUnit(cout, cout, 1, 1, last_conv_only=top)))
        return down, sub, up

    def _run(self, plan, x, quant):
        down, sub, up = plan
        d = getattr(self, down)(x, quant)
        y = self._run(sub, d, quant) if isinstance(sub, tuple) else getattr(self, sub)(d, quant)
        y = torch.cat([d, y], dim=1)
        for name in up:
            y = getattr(self, name)(y, quant)
        return y

    def forward(self, x: torch.Tensor, quant: Quant = None) -> torch.Tensor:
        return self._run(self.plan, x, quant)


def param_shapes(model_cfg: dict):
    """Ordered ``{name: shape}`` of the model a config describes, built on
    the meta device (no memory)."""
    with torch.device("meta"):
        m = UNet(model_cfg["in_channels"], model_cfg["out_channels"],
                 model_cfg["channels"], model_cfg["strides"], model_cfg["num_res_units"])
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}
