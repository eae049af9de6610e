"""SegMamba in NCDHW: Xing, Ye, Yang, Liu and Zhu, "SegMamba: Long-range
Sequential Modeling Mamba for 3D Medical Image Segmentation" (MICCAI 2024,
arXiv:2401.13560), as ``github.com/ge-xing/SegMamba``'s
``model_segmamba/segmamba.py`` builds it for BraTS (4 MRI modalities in,
widths 48-96-192-384, depths 2-2-2-2, hidden 768, 128^3 crops), with the
tri-orientated Mamba of its Mamba fork (``mamba_simple.py``,
``bimamba_type="v3"``; Mamba: Gu and Dao, arXiv:2312.00752).

The encoder (``MambaEncoder``, ``self.vit``):

* a stem ``Conv3d(in -> C0, k7, s2, p3, bias)``; before stages 1-3 a
  downsample, instance norm then ``Conv3d(k2, s2, p0, bias)``;
* each stage: ``x = GSC(x)``, then its Mamba layers, then the stage's
  output ``MLP(IN(x))``; the un-normalised ``x`` goes on;
* ``GSC(C)``: ``a = ReLU(IN(Conv3(ReLU(IN(Conv3(x))))))``, ``b =
  ReLU(IN(Conv1(x)))``, ``x + ReLU(IN(Conv1(a + b)))`` (convolutions with
  bias); ``MLP(C)``: ``Conv1(C -> 2C)``, exact GELU, ``Conv1(2C -> C)``;
* a Mamba layer: ``x + TriMamba(LayerNorm(t))`` over the grid's tokens
  ``t`` in row-major ``(D, H, W)`` order (LayerNorm affine, eps 1e-5);
* TriMamba: ``xz = W_in t`` (``C -> 2d``, ``d = expand C``, no bias); three
  orders share it, each with its own causal depthwise ``conv1d`` (kernel
  ``d_conv``, bias), ``x_proj`` (``d -> R + 2N``, ``R = ceil(C / 16)``),
  ``dt_proj`` (``R -> d``, bias), ``A_log`` and ``D``: ``f`` the tokens in
  order, ``b`` reversed, ``s`` the sequence viewed as ``(S, L / S)`` and
  transposed (``S = num_slices``, the grid's first axis at the published
  crop: the scan crosses the depth slices at each in-plane position). Per
  order, on the reordered ``(u, z)``: ``u = SiLU(conv1d(u))``, ``[delta |
  B | C] = x_proj(u)``, the selective scan
  (:func:`~mvtb_tpu_torch.ops.selective_scan.selective_scan`, ``A =
  -exp(A_log)``, ``dt = softplus(dt_proj.weight delta + dt_proj.bias)``,
  the gate ``SiLU(z)``), put back in token order; ``out = W_out (o_f + o_b
  + o_s)`` (``d -> C``, no bias).

The decoder is MONAI's UNETR blocks, the same modules as SwinUNETR's
(:mod:`.swin_unetr`): ``enc1 = Basic(in -> C0)(x_in)``, ``enc2..enc4 =
Basic(C_{i-1} -> C_i)(out_{i-1})``, ``hid = Basic(C3 -> hidden)(out_3)``,
four up blocks back to the full crop, ``Basic(C0 -> C0)`` and the head
``Conv1(C0 -> out, bias)``.

Parameter names follow the published module tree (``vit.stages.0.0.mamba.
in_proj.weight``, ``vit.stages.0.0.mamba.A_b_log``, ``decoder5.transp_conv.
conv.weight``); each of the encoder's ``nn.Conv3d`` is held as ``.conv`` by
the shared ``Conv`` block (``vit.gscs.0.proj.conv.weight``), as MONAI's
``Convolution`` holds its own. 291 tensors and 67,416,147 parameters at
the published widths.

``dtype`` follows :mod:`.unet3d` and :mod:`.swin_unetr`: parameters stay
float32 and are cast at use, the layer and instance norms take their
statistics in float32 and round to ``dtype``, every activation is
``dtype``; the scan keeps its states in float32 and takes ``A``, ``D`` and
the ``dt`` bias in float32 (float64 for a float64 model).

The token grid is never transposed for the projections: ``in_proj`` and
``out_proj`` are products against the channel-first grid, so ``xz`` comes
out ``(B, 2d, L)`` and the output ``(B, C, L)``. Spans
(:func:`~mvtb_tpu_torch.utils.profiling.span`): ``mvtb.mamba.encoder``
(stem through the four MLP outputs), inside it ``mvtb.mamba.gsc`` (each
GSC), ``mvtb.mamba.layout`` (the tokens' transpose for the LayerNorm, the
flips and the slice transposes and their inverses) and
``mvtb.mamba.scan`` (the scan calls alone); ``mvtb.unetr.conv`` around
each UNETR block and the head. Counters: ``mamba.tokens`` (tokens entering
each Mamba layer), ``mamba.scans`` (scan calls), ``mamba.scan_positions``
(batch times length, summed over scan calls).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.models.swin_unetr import (BasicBlock, Conv, LayerNorm, Linear, UpBlock,
                                              _stats_type)
from mvtb_tpu_torch.models.unet3d import _instance_norm
from mvtb_tpu_torch.ops.selective_scan import selective_scan
from mvtb_tpu_torch.utils.profiling import count, span

ORDERS = ("", "_b", "_s")  # parameter suffixes of the f, b and s orders
DT_RANGE = (1e-3, 1e-1)
DT_FLOOR = 1e-4


class InstanceNorm(nn.Module):
    """``InstanceNorm3d`` without affine (eps 1e-5), float32 statistics,
    output in ``dtype``."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _instance_norm(_stats_type(x)).to(self.dtype)


class GSC(nn.Module):
    """The gated spatial convolution before each stage's Mamba layers."""

    def __init__(self, c: int, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(bias=True, device=device, dtype=dtype)
        self.proj, self.proj2 = Conv(c, c, 3, **kw), Conv(c, c, 3, **kw)
        self.proj3, self.proj4 = Conv(c, c, 1, **kw), Conv(c, c, 1, **kw)
        self.norm = InstanceNorm(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("mvtb.mamba.gsc"):
            n = self.norm
            a = F.relu(n(self.proj2(F.relu(n(self.proj(x))))))
            b = F.relu(n(self.proj3(x)))
            return F.relu(n(self.proj4(a + b))) + x.to(a.dtype)


class MlpChannel(nn.Module):
    def __init__(self, c: int, hidden: int, device=None, dtype=torch.float32):
        super().__init__()
        self.fc1 = Conv(c, hidden, 1, bias=True, device=device, dtype=dtype)
        self.fc2 = Conv(hidden, c, 1, bias=True, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


def reorder(x: torch.Tensor, order: str, slices: int) -> torch.Tensor:
    """``(B, c, L)`` tokens in an order's sequence: as they are (``""``),
    reversed (``"_b"``), or ``L`` viewed as ``(slices, L / slices)`` and
    transposed (``"_s"``)."""
    if order == "":
        return x
    if order == "_b":
        return x.flip(-1)
    B, c, L = x.shape
    return x.view(B, c, slices, L // slices).transpose(-1, -2).reshape(B, c, L)


def restore(x: torch.Tensor, order: str, slices: int) -> torch.Tensor:
    """:func:`reorder`'s inverse."""
    if order != "_s":
        return reorder(x, order, slices)
    B, c, L = x.shape
    return x.view(B, c, L // slices, slices).transpose(-1, -2).reshape(B, c, L)


class TriMamba(nn.Module):
    """Mamba with ``bimamba_type="v3"``: the f, b and s orders over one
    ``in_proj`` and one ``out_proj``."""

    def __init__(self, dim: int, d_state: int = 16, d_conv: int = 4, expand: int = 2,
                 num_slices: int = 1, device=None, dtype=torch.float32):
        super().__init__()
        d, R = expand * dim, math.ceil(dim / 16)
        self.d, self.R, self.N, self.k = d, R, d_state, d_conv
        self.slices, self.dtype = num_slices, dtype
        self.in_proj = Linear(dim, 2 * d, bias=False, device=device, dtype=dtype)
        for o in ORDERS:
            conv = nn.Module()
            conv.weight = nn.Parameter(torch.empty(d, 1, d_conv, device=device))
            conv.bias = nn.Parameter(torch.empty(d, device=device))
            setattr(self, f"conv1d{o}", conv)
            setattr(self, f"x_proj{o}", Linear(d, R + 2 * d_state, bias=False, device=device,
                                               dtype=dtype))
            setattr(self, f"dt_proj{o}", Linear(R, d, device=device, dtype=dtype))
            name = "A_log" if o == "" else f"A{o}_log"
            setattr(self, name, nn.Parameter(torch.empty(d, d_state, device=device)))
            setattr(self, f"D{o}", nn.Parameter(torch.empty(d, device=device)))
        self.out_proj = Linear(d, dim, bias=False, device=device, dtype=dtype)
        self.reset_mamba_parameters()

    def reset_mamba_parameters(self) -> None:
        """Mamba's published initialisation of what is its own: ``A_log =
        log(1..N)`` on every channel, ``D = 1``, ``dt_proj.weight`` uniform
        in ``+-R^-1/2``, ``dt_proj.bias = softplus^-1(dt)`` with ``dt`` log-
        uniform in ``[1e-3, 1e-1]`` floored at 1e-4, the causal
        convolution as ``nn.Conv1d`` draws it."""
        with torch.no_grad():
            for o in ORDERS:
                conv, dtp = getattr(self, f"conv1d{o}"), getattr(self, f"dt_proj{o}")
                bound = 1.0 / math.sqrt(self.k)
                conv.weight.uniform_(-bound, bound)
                conv.bias.uniform_(-bound, bound)
                dtp.weight.uniform_(-self.R ** -0.5, self.R ** -0.5)
                lo, hi = (math.log(v) for v in DT_RANGE)
                dt = torch.exp(torch.rand_like(dtp.bias) * (hi - lo) + lo).clamp_min(DT_FLOOR)
                dtp.bias.copy_(dt + torch.log(-torch.expm1(-dt)))
                a_log = getattr(self, "A_log" if o == "" else f"A{o}_log")
                a_log.copy_(torch.log(torch.arange(1, self.N + 1, dtype=torch.float32,
                                                   device=a_log.device)).expand_as(a_log))
                getattr(self, f"D{o}").fill_(1.0)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        """``h`` normalised tokens ``(B, L, C)``; returns ``(B, C, L)``."""
        B, L, _ = h.shape
        if L % self.slices:
            raise ValueError(f"TriMamba: {L} tokens do not split into {self.slices} slices")
        dt, d, R, N = self.dtype, self.d, self.R, self.N
        p = torch.promote_types(dt, torch.float32)
        xz = torch.matmul(self.in_proj.weight.to(dt), h.transpose(1, 2))  # (B, 2d, L)
        total = None
        for o in ORDERS:
            with span("mvtb.mamba.layout"):
                xo = reorder(xz, o, self.slices)
            conv = getattr(self, f"conv1d{o}")
            u = F.conv1d(xo[:, :d], conv.weight.to(dt), conv.bias.to(dt), padding=self.k - 1,
                         groups=d)
            u = F.silu(u[..., :L])
            x_dbl = F.linear(u.transpose(1, 2), getattr(self, f"x_proj{o}").weight.to(dt))
            dtp = getattr(self, f"dt_proj{o}")
            delta = torch.matmul(dtp.weight.to(dt), x_dbl[..., :R].transpose(1, 2))
            Bm = x_dbl[..., R:R + N].contiguous()
            Cm = x_dbl[..., R + N:].contiguous()
            A = -torch.exp(getattr(self, "A_log" if o == "" else f"A{o}_log").to(p))
            count("mamba.scans")
            count("mamba.scan_positions", B * L)
            with span("mvtb.mamba.scan"):
                y = selective_scan(u, delta, xo[:, d:], Bm, Cm, A,
                                   getattr(self, f"D{o}").to(p), dtp.bias.to(p))
            with span("mvtb.mamba.layout"):
                y = restore(y, o, self.slices)
            total = y if total is None else total + y
        return torch.matmul(self.out_proj.weight.to(dt), total)


class MambaLayer(nn.Module):
    """``x + TriMamba(LayerNorm(tokens(x)))`` on a ``(B, C, D, H, W)`` grid."""

    def __init__(self, dim: int, d_state: int = 16, d_conv: int = 4, expand: int = 2,
                 num_slices: int = 1, device=None, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = LayerNorm(dim, device, dtype)
        self.mamba = TriMamba(dim, d_state, d_conv, expand, num_slices, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[:2]
        L = math.prod(x.shape[2:])
        count("mamba.tokens", B * L)
        with span("mvtb.mamba.layout"):
            tokens = x.reshape(B, C, L).transpose(1, 2).contiguous()
        out = self.mamba(self.norm(tokens))
        return x.to(self.dtype) + out.view(x.shape)


class MambaEncoder(nn.Module):
    """The stem, three downsamples, a GSC and the Mamba layers a stage, and
    the four stages' ``MLP(IN(x))`` outputs."""

    def __init__(self, in_chans: int, depths: Sequence[int], dims: Sequence[int],
                 num_slices: Sequence[int], d_state: int, d_conv: int, expand: int,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.downsample_layers = nn.ModuleList(
            [nn.Sequential(Conv(in_chans, dims[0], 7, 2, bias=True, padding=3, **kw))]
            + [nn.Sequential(InstanceNorm(dtype),
                             Conv(dims[i], dims[i + 1], 2, 2, bias=True, padding=0, **kw))
               for i in range(len(dims) - 1)])
        self.gscs = nn.ModuleList(GSC(c, **kw) for c in dims)
        self.stages = nn.ModuleList(
            nn.Sequential(*[MambaLayer(c, d_state, d_conv, expand, s, **kw) for _ in range(n)])
            for c, n, s in zip(dims, depths, num_slices))
        self.mlps = nn.ModuleList(MlpChannel(c, 2 * c, **kw) for c in dims)
        self.norm = InstanceNorm(dtype)

    def forward(self, x: torch.Tensor):
        outs = []
        for down, gsc, stage, mlp in zip(self.downsample_layers, self.gscs, self.stages,
                                         self.mlps):
            x = stage(gsc(down(x)))
            outs.append(mlp(self.norm(x)))
        return outs


class SegMamba(nn.Module):
    """``SegMamba(in_channels, out_channels, feature_size, depths,
    hidden_size, d_state, d_conv, expand, num_slices)`` on channel-first
    ``(B, C, D, H, W)`` tensors whose spatial sizes are multiples of 16 and
    whose stage grids split into ``num_slices``; returns logits in
    ``dtype``. ``device=None`` means ``"cuda"``."""

    def __init__(self, in_channels: int = 4, out_channels: int = 3,
                 feature_size: Sequence[int] = (48, 96, 192, 384),
                 depths: Sequence[int] = (2, 2, 2, 2), hidden_size: int = 768,
                 d_state: int = 16, d_conv: int = 4, expand: int = 2,
                 num_slices: Sequence[int] = (64, 32, 16, 8), device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if not len(feature_size) == len(depths) == len(num_slices) == 4:
            raise ValueError("SegMamba has four stages")
        dev = resolve_device(device)
        f = tuple(feature_size)
        self.dtype = dtype
        kw = dict(device=dev, dtype=dtype)
        self.vit = MambaEncoder(in_channels, depths, f, num_slices, d_state, d_conv, expand,
                                **kw)
        self.encoder1 = BasicBlock(in_channels, f[0], **kw)
        self.encoder2 = BasicBlock(f[0], f[1], **kw)
        self.encoder3 = BasicBlock(f[1], f[2], **kw)
        self.encoder4 = BasicBlock(f[2], f[3], **kw)
        self.encoder5 = BasicBlock(f[3], hidden_size, **kw)
        self.decoder5 = UpBlock(hidden_size, f[3], **kw)
        self.decoder4 = UpBlock(f[3], f[2], **kw)
        self.decoder3 = UpBlock(f[2], f[1], **kw)
        self.decoder2 = UpBlock(f[1], f[0], **kw)
        self.decoder1 = BasicBlock(f[0], f[0], **kw)
        self.out = nn.Module()
        self.out.conv = Conv(f[0], out_channels, 1, bias=True, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if any(n % 16 for n in x.shape[2:]):
            raise ValueError(f"SegMamba takes spatial sizes divisible by 16, got "
                             f"{tuple(x.shape[2:])}")
        with span("mvtb.mamba.encoder"):
            outs = self.vit(x)
        enc1 = self.encoder1(x)
        enc2 = self.encoder2(outs[0])
        enc3 = self.encoder3(outs[1])
        enc4 = self.encoder4(outs[2])
        hidden = self.encoder5(outs[3])
        dec3 = self.decoder5(hidden, enc4)
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        dec0 = self.decoder2(dec1, enc1)
        out = self.decoder1(dec0)
        with span("mvtb.unetr.conv"):
            return self.out.conv(out)
