"""Plain SegMamba: Xing, Ye, Yang, Liu and Zhu, "SegMamba: Long-range
Sequential Modeling Mamba for 3D Medical Image Segmentation" (MICCAI 2024,
arXiv:2401.13560), at the widths ``github.com/ge-xing/SegMamba``
(``model_segmamba/segmamba.py``) gives it for BraTS: 4 MRI modalities in,
widths ``(48, 96, 192, 384)``, depths ``(2, 2, 2, 2)``, hidden 768, and its
Mamba fork's tri-orientated layer (``mamba_simple.py``,
``bimamba_type="v3"``: ``d_state`` 16, ``d_conv`` 4, ``expand`` 2,
``dt_rank = ceil(C / 16)``, ``num_slices`` ``(64, 32, 16, 8)``), written
out in plain PyTorch, float32 throughout, with no fused kernel.

The encoder works on ``(B, C, D, H, W)`` grids:

* stem ``Conv3d(in, C0, 7, stride 2, padding 3)``; before stages 1-3
  instance norm then ``Conv3d(C_{i-1}, C_i, 2, stride 2)``; every
  convolution of the encoder has a bias; instance norm is eps 1e-5 without
  affine;
* per stage ``x = GSC(x)``: ``a = ReLU(IN(conv3(ReLU(IN(conv3(x))))))``,
  ``b = ReLU(IN(conv1(x)))``, ``x + ReLU(IN(conv1(a + b)))``; then its Mamba
  layers; the stage's output is ``fc2(GELU(fc1(IN(x))))``, ``fc1`` a
  ``1x1x1`` convolution to twice the channels;
* a Mamba layer: the grid's tokens ``(B, L, C)`` in row-major ``(D, H,
  W)`` order, LayerNorm (eps 1e-5, affine), the tri-orientated Mamba, back
  to the grid, plus the layer's input;
* the tri-orientated Mamba: ``xz = t W_in^T`` (``C -> 2d``, no bias), as
  ``(B, 2d, L)``; three orders ``f`` (as is), ``b`` (reversed) and ``s``
  (``L`` viewed as ``(S, L / S)`` and transposed), each with its own
  parameters: ``u = SiLU(conv1d(x, kernel 4, left pad 3, groups d) + bias)``
  on the first ``d`` rows, ``[delta | B | C] = u^T W_x^T``, ``dt =
  softplus(delta W_dt^T + b_dt)``, ``A = -exp(A_log)``, the scan ``h_t =
  exp(dt_t A) h_{t-1} + dt_t u_t B_t``, ``y_t = C_t . h_t + D u_t``, gated
  by ``SiLU(z)`` (the last ``d`` rows), put back in token order; the three
  summed, ``W_out`` (``d -> C``, no bias).

The scan is the recurrence itself, in float32. The sequence is cut into
chunks that run side by side: within a chunk a loop over its positions,
from a zero state, gives each chunk's end state and the product of its
decays; an associative combine of (decay product, state) pairs over the
chunks, in ``log2`` steps of products and sums, gives each chunk's start
state; a second loop over the positions gives the outputs. Its gradient is
autograd's, through checkpoints every ``SCAN_SEGMENT`` positions, so the
graph holds a few chunk states at a time.

The decoder is MONAI's ``UnetrBasicBlock`` / ``UnetrUpBlock`` /
``UnetOutBlock`` (``res_block=True``, instance norm, LeakyReLU 0.01,
convolutions without bias), as :mod:`.swin_unetr` writes them: ``enc1 =
Res(in, C0)(x_in)``, ``enc2..enc4 = Res(C_{i-1}, C_i)(out_{i-1})``,
``hidden = Res(C3, hidden)(out_3)``, up blocks ``(hidden, C3)`` with
``enc4``, ``(C3, C2)`` with ``enc3``, ``(C2, C1)`` with ``enc2``, ``(C1,
C0)`` with ``enc1``, then ``Res(C0, C0)`` and ``Conv3d(C0, out, 1)`` with
bias. Parameter names are the measured program's (each encoder
convolution held as ``.conv``), so one state dict loads in both.

Departures from the published description: three sigmoid outputs (TC,
WT, ET) under the study's Dice loss, in place of the BraTS 2023 head;
the scan's float32 sums taken chunk by chunk (another order than a
position-by-position loop over the whole sequence).

``quant`` rounds every activation and the operands of every product
(convolution, ``conv1d``, linear layer), and its ``grad``, where it has
one, the gradient reaching each product's output (:mod:`.lowp`); the
scan's own state stays float32, as the measured program keeps it. It is
None for the reference.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from portbench.reference.swin_unetr import (ConvLayer, LayerNorm, UnetrBasicBlock,
                                            UnetrUpBlock, instance_norm, linear)

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]

SCAN_CHUNKS = 2048   # chunks of the sequence that run side by side
SCAN_SEGMENT = 16    # positions between two checkpoints of the scan's loops
ORDERS = ("", "_b", "_s")


def _q(quant: Quant, t: torch.Tensor) -> torch.Tensor:
    return t if quant is None else quant(t)


def _qo(quant: Quant, y: torch.Tensor) -> torch.Tensor:
    return y if getattr(quant, "grad", None) is None else quant.grad(y)


def chunk_length(L: int) -> int:
    """Positions a chunk: the least divisor of ``L`` that leaves at most
    ``SCAN_CHUNKS`` chunks."""
    n = max(1, -(-L // SCAN_CHUNKS))
    while L % n:
        n += 1
    return n


def _local(h, P, a_in, x, Bc, A, j0, j1):
    for j in range(j0, j1):
        a = torch.exp(a_in[..., j, None] * A)
        h = a * h + x[..., j, None] * Bc[:, :, :, j]
        P = P * a
    return h, P


def _outputs(h, a_in, x, Bc, Cc, A, j0, j1):
    ys = []
    for j in range(j0, j1):
        h = torch.exp(a_in[..., j, None] * A) * h + x[..., j, None] * Bc[:, :, :, j]
        ys.append((h * Cc[:, :, :, j]).sum(-1))
    return h, torch.stack(ys, -1)


def selective_scan(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor) -> torch.Tensor:
    """``y_t = C_t . h_t`` of ``h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t``
    (``h_{-1} = 0``): ``u`` and ``dt`` ``(b, d, L)``, ``A`` ``(d, N)``, ``B``
    and ``C`` ``(b, L, N)``; float32."""
    b, d, L = u.shape
    N = A.shape[1]
    n = chunk_length(L)
    K = L // n
    a_in = dt.reshape(b, d, K, n)
    x = (dt * u).reshape(b, d, K, n)
    Bc = B.reshape(b, 1, K, n, N)
    Cc = C.reshape(b, 1, K, n, N)
    A = A[:, None, :]  # (d, 1, N) against (b, d, K, N)
    h = u.new_zeros(b, d, K, N)
    P = u.new_ones(b, d, K, N)
    for j0 in range(0, n, SCAN_SEGMENT):
        h, P = checkpoint(_local, h, P, a_in, x, Bc, A, j0, min(n, j0 + SCAN_SEGMENT),
                          use_reentrant=False)
    s = 1
    while s < K:  # inclusive scan of the chunks' affine maps
        h = torch.cat([h[:, :, :s], P[:, :, s:] * h[:, :, :-s] + h[:, :, s:]], 2)
        P = torch.cat([P[:, :, :s], P[:, :, s:] * P[:, :, :-s]], 2)
        s *= 2
    h = torch.cat([torch.zeros_like(h[:, :, :1]), h[:, :, :-1]], 2)  # each chunk's start
    ys = []
    for j0 in range(0, n, SCAN_SEGMENT):
        h, y = checkpoint(_outputs, h, a_in, x, Bc, Cc, A, j0, min(n, j0 + SCAN_SEGMENT),
                          use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, -1).reshape(b, d, L)


def reorder(x: torch.Tensor, order: str, slices: int) -> torch.Tensor:
    """``(B, c, L)`` in an order's sequence."""
    if order == "_b":
        return torch.flip(x, (-1,))
    if order == "_s":
        B, c, L = x.shape
        return torch.stack(torch.chunk(x, slices, dim=-1), dim=-1).flatten(-2)
    return x


def restore(x: torch.Tensor, order: str, slices: int) -> torch.Tensor:
    if order == "_s":
        B, c, L = x.shape
        return x.reshape(B, c, L // slices, slices).permute(0, 1, 3, 2).flatten(-2)
    return reorder(x, order, slices)


class Conv3d(nn.Module):
    """``nn.Conv3d`` with a bias, held as ``.conv``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.conv = nn.Module()
        self.conv.weight = nn.Parameter(torch.zeros(cout, cin, k, k, k))
        self.conv.bias = nn.Parameter(torch.zeros(cout))
        self.stride, self.padding = stride, padding

    def forward(self, x, quant: Quant = None):
        y = F.conv3d(_q(quant, x), _q(quant, self.conv.weight), stride=self.stride,
                     padding=self.padding)
        return _q(quant, _qo(quant, y) + self.conv.bias.view(-1, 1, 1, 1))


class Linear(nn.Module):
    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None


class Mamba(nn.Module):
    def __init__(self, dim: int, d_state: int, d_conv: int, expand: int, slices: int):
        super().__init__()
        d, R = expand * dim, math.ceil(dim / 16)
        self.d, self.R, self.N, self.k, self.slices = d, R, d_state, d_conv, slices
        self.in_proj = Linear(dim, 2 * d, bias=False)
        for o in ORDERS:
            conv = nn.Module()
            conv.weight = nn.Parameter(torch.zeros(d, 1, d_conv))
            conv.bias = nn.Parameter(torch.zeros(d))
            setattr(self, f"conv1d{o}", conv)
            setattr(self, f"x_proj{o}", Linear(d, R + 2 * d_state, bias=False))
            setattr(self, f"dt_proj{o}", Linear(R, d))
            setattr(self, "A_log" if o == "" else f"A{o}_log",
                    nn.Parameter(torch.zeros(d, d_state)))
            setattr(self, f"D{o}", nn.Parameter(torch.zeros(d)))
        self.out_proj = Linear(d, dim, bias=False)

    def forward(self, t: torch.Tensor, quant: Quant = None) -> torch.Tensor:
        """``t`` normalised tokens ``(B, L, C)``; returns ``(B, L, C)``."""
        L = t.shape[1]
        d, R, N = self.d, self.R, self.N
        xz = linear(t, self.in_proj.weight, None, quant).transpose(1, 2)  # (B, 2d, L)
        total = 0.0
        for o in ORDERS:
            xo = reorder(xz, o, self.slices)
            conv = getattr(self, f"conv1d{o}")
            u = F.conv1d(_q(quant, xo[:, :d]), _q(quant, conv.weight), padding=self.k - 1,
                         groups=d)[..., :L]
            u = _q(quant, F.silu(_q(quant, _qo(quant, u) + conv.bias[:, None])))
            x_dbl = linear(u.transpose(1, 2), getattr(self, f"x_proj{o}").weight, None, quant)
            dtp = getattr(self, f"dt_proj{o}")
            delta = linear(x_dbl[..., :R], dtp.weight, None, quant).transpose(1, 2)
            dt = F.softplus(delta + dtp.bias[:, None])
            A = -torch.exp(getattr(self, "A_log" if o == "" else f"A{o}_log"))
            y = selective_scan(u, dt, A, x_dbl[..., R:R + N], x_dbl[..., R + N:])
            y = y + getattr(self, f"D{o}")[:, None] * u
            y = _q(quant, y * F.silu(xo[:, d:]))
            total = total + restore(y, o, self.slices)
        return linear(total.transpose(1, 2), self.out_proj.weight, None, quant)


class MambaLayer(nn.Module):
    def __init__(self, dim: int, d_state: int, d_conv: int, expand: int, slices: int):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.mamba = Mamba(dim, d_state, d_conv, expand, slices)

    def forward(self, x, quant: Quant = None):
        B, C = x.shape[:2]
        t = x.reshape(B, C, -1).transpose(1, 2)
        y = self.mamba(self.norm(t, quant), quant)
        return _q(quant, x + y.transpose(1, 2).reshape(x.shape))


class GSC(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.proj, self.proj2 = Conv3d(c, c, 3, padding=1), Conv3d(c, c, 3, padding=1)
        self.proj3, self.proj4 = Conv3d(c, c, 1), Conv3d(c, c, 1)

    def forward(self, x, quant: Quant = None):
        def norm_relu(y):
            return _q(quant, F.relu(_q(quant, instance_norm(y))))

        a = norm_relu(self.proj2(norm_relu(self.proj(x, quant)), quant))
        b = norm_relu(self.proj3(x, quant))
        return _q(quant, norm_relu(self.proj4(_q(quant, a + b), quant)) + x)


class MlpChannel(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.fc1, self.fc2 = Conv3d(c, 2 * c, 1), Conv3d(2 * c, c, 1)

    def forward(self, x, quant: Quant = None):
        return self.fc2(_q(quant, F.gelu(self.fc1(x, quant))), quant)


class Downsample(nn.Module):
    """``nn.Sequential`` of the published encoder: the stem alone at index
    0, instance norm (no parameters) at 0 and the convolution at 1 after."""

    def __init__(self, conv: Conv3d, norm: bool):
        super().__init__()
        self.norm = norm
        self.add_module("1" if norm else "0", conv)

    def forward(self, x, quant: Quant = None):
        if self.norm:
            return getattr(self, "1")(_q(quant, instance_norm(x)), quant)
        return getattr(self, "0")(x, quant)


class MambaEncoder(nn.Module):
    def __init__(self, in_chans: int, depths, dims, slices, d_state, d_conv, expand):
        super().__init__()
        self.downsample_layers = nn.ModuleList(
            [Downsample(Conv3d(in_chans, dims[0], 7, 2, 3), norm=False)]
            + [Downsample(Conv3d(dims[i], dims[i + 1], 2, 2), norm=True)
               for i in range(len(dims) - 1)])
        self.gscs = nn.ModuleList(GSC(c) for c in dims)
        self.stages = nn.ModuleList(
            nn.ModuleList(MambaLayer(c, d_state, d_conv, expand, s) for _ in range(n))
            for c, n, s in zip(dims, depths, slices))
        self.mlps = nn.ModuleList(MlpChannel(c) for c in dims)

    def forward(self, x, quant: Quant = None):
        outs = []
        for i in range(len(self.stages)):
            x = self.gscs[i](self.downsample_layers[i](x, quant), quant)
            for layer in self.stages[i]:
                x = layer(x, quant)
            outs.append(self.mlps[i](_q(quant, instance_norm(x)), quant))
        return outs


class SegMamba(nn.Module):
    def __init__(self, in_channels: int = 4, out_channels: int = 3,
                 feature_size: Sequence[int] = (48, 96, 192, 384),
                 depths: Sequence[int] = (2, 2, 2, 2), hidden_size: int = 768,
                 d_state: int = 16, d_conv: int = 4, expand: int = 2,
                 num_slices: Sequence[int] = (64, 32, 16, 8)):
        super().__init__()
        f = list(feature_size)
        self.vit = MambaEncoder(in_channels, depths, f, num_slices, d_state, d_conv, expand)
        self.encoder1 = UnetrBasicBlock(in_channels, f[0])
        self.encoder2 = UnetrBasicBlock(f[0], f[1])
        self.encoder3 = UnetrBasicBlock(f[1], f[2])
        self.encoder4 = UnetrBasicBlock(f[2], f[3])
        self.encoder5 = UnetrBasicBlock(f[3], hidden_size)
        self.decoder5 = UnetrUpBlock(hidden_size, f[3])
        self.decoder4 = UnetrUpBlock(f[3], f[2])
        self.decoder3 = UnetrUpBlock(f[2], f[1])
        self.decoder2 = UnetrUpBlock(f[1], f[0])
        self.decoder1 = UnetrBasicBlock(f[0], f[0])
        self.out = nn.Module()
        self.out.conv = ConvLayer(f[0], out_channels, 1, bias=True)

    def forward(self, x_in: torch.Tensor, quant: Quant = None) -> torch.Tensor:
        outs = self.vit(x_in, quant)
        enc1 = self.encoder1(x_in, quant)
        enc2 = self.encoder2(outs[0], quant)
        enc3 = self.encoder3(outs[1], quant)
        enc4 = self.encoder4(outs[2], quant)
        hidden = self.encoder5(outs[3], quant)
        dec3 = self.decoder5(hidden, enc4, quant)
        dec2 = self.decoder4(dec3, enc3, quant)
        dec1 = self.decoder3(dec2, enc2, quant)
        dec0 = self.decoder2(dec1, enc1, quant)
        return self.out.conv(self.decoder1(dec0, quant), quant)


MODEL_KEYS = ("in_channels", "out_channels", "feature_size", "depths", "hidden_size",
              "d_state", "d_conv", "expand", "num_slices")


def build(model_cfg: dict) -> SegMamba:
    return SegMamba(**{k: model_cfg[k] for k in MODEL_KEYS if k in model_cfg})


def param_shapes(model_cfg: dict):
    """Ordered ``{name: shape}`` of the model a config describes, built on
    the meta device (no memory)."""
    with torch.device("meta"):
        m = build(model_cfg)
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}
