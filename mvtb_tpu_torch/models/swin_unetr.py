"""SwinUNETR in NCDHW: Hatamizadeh et al., "Swin UNETR: Swin Transformers
for Semantic Segmentation of Brain Tumors in MRI Images" (BrainLes 2021,
arXiv:2201.01266), as MONAI's ``monai/networks/nets/swin_unetr.py`` builds
it for BraTS 2021 (``feature_size=48``, 4 -> 3 channels, 128^3 crops).

A shifted-window transformer encodes the volume; a UNETR convolutional
path decodes it:

* patch embedding ``Conv3d(in -> C, k=2, s=2)``, no norm;
* four stages of Swin blocks at ``C, 2C, 4C, 8C`` channels, each ending in
  a patch merge (the 8 neighbours of each 2x2x2 cell concatenated once
  each, ``LayerNorm(8c)``, ``Linear(8c -> 2c, no bias)``);
* a Swin block is ``x + proj(W-MSA(pad(LN1(x))))`` then ``x +
  MLP(LN2(x))`` (``Linear(c -> 4c)``, exact GELU, ``Linear(4c -> c)``).
  The grid is zero-padded after ``LN1`` up to a multiple of the window;
  odd blocks roll the padded grid by ``-floor(w/2)`` on every axis and
  mask attention between tokens of different regions (-100), then roll
  back and crop. Where a grid axis is at most ``w`` long the window
  shrinks to it and that axis does not shift (MONAI's
  ``get_window_size``);
* W-MSA is ``softmax(q k^T / sqrt(d) + B + M) v`` over the windows, with
  ``qkv = Linear(c -> 3c)``, ``B`` the learned relative-position bias (a
  ``((2w-1)^3, heads)`` table indexed by the relative offset of two tokens)
  and ``M`` the shift mask, then ``Linear(c -> c)``;
* each of the five encoder outputs ``x0..x4`` (``patch embedding`` and the
  four stages) is layer-normalised over channels without affine;
* the UNETR path: residual blocks ``conv3 -> IN -> LeakyReLU(0.01) ->
  conv3 -> IN`` (+ ``conv1 -> IN`` when the channels change), add,
  LeakyReLU, convolutions without bias and instance norm without affine;
  up blocks ``ConvTranspose(k=2, s=2, no bias)``, concatenation with the
  skip, a residual block; a ``Conv1(c -> out, bias)`` head.

Parameter names are MONAI's (``swinViT.layers1.0.blocks.0.attn.qkv.weight``,
``decoder5.transp_conv.conv.weight``, ``out.conv.conv.bias``), 151 tensors
and 62,191,941 parameters at the published widths. Two departures from
MONAI, both in the published equations' favour: the patch merge
concatenates the eight neighbours once each (``PatchMergingV2``'s order;
MONAI's default ``PatchMerging`` keeps a legacy order that takes two of
them twice, for old checkpoints), and a shrunk window takes its bias by
the relative offsets of its own tokens (MONAI slices the full window's
index table to the shrunk window's token count). Neither changes a grid
at the published 128^3 crop, where no window shrinks.

``dtype`` follows :mod:`.unet3d`: parameters stay float32 and are cast at
use, LayerNorm and instance norm take their statistics in float32 and
round their output to ``dtype``, and every activation is ``dtype``.
Window attention is ``scaled_dot_product_attention`` with one additive
tensor; on the card it takes the memory-efficient backend (head dim 16 at
the published widths), which accepts an additive bias and returns its
gradient. The bias ``(heads, N, N)``
goes in as a view broadcast over the windows; a shifted block adds the
``(windows, N, N)`` mask to it once, ``(windows, heads, N, N)``, and runs
one call a sample, so no ``(batch * windows, heads, N, N)`` tensor is kept
for the backward. Both are padded to a multiple of 16 columns and sliced
back, the alignment the backend asks of a bias, so it copies neither.
The relative-bias index and the shift mask are built once per grid on
the device and cached on the model.

Spans (:func:`~mvtb_tpu_torch.utils.profiling.span`): ``mvtb.swin.encoder``
(patch embedding through ``x4``), inside it per block ``mvtb.swin.window``
(pad, roll, partition and the additive tensor's assembly, and the index
and mask when their cache misses; reverse, roll back and crop) and
``mvtb.swin.attn`` (the attention call alone); ``mvtb.unetr.conv`` around
each UNETR block and the head. Counters per block and forward:
``swin.tokens`` (real tokens entering it), ``swin.window_tokens`` (padded
tokens attended) and ``swin.windows``.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.models.unet3d import _instance_norm
from mvtb_tpu_torch.utils.profiling import count, span

SHIFT_MASK = -100.0
BIAS_ALIGN = 16  # columns: the memory-efficient backend's alignment of a bias


def window_plan(grid: Sequence[int], window: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(window, shift) per axis on a ``grid``: ``window`` and ``window //
    2``, or the axis's length and no shift where it is at most ``window``
    (MONAI's ``get_window_size``)."""
    ws = tuple(g if g <= window else window for g in grid)
    shift = tuple(0 if g <= window else window // 2 for g in grid)
    return ws, shift


def relative_index(ws: Sequence[int], window: int, device=None) -> torch.Tensor:
    """``(N, N)`` rows of the ``(2 window - 1)^3`` bias table for the tokens
    of a ``ws`` window (row-major, ``N = prod(ws)``): each pair's offset
    ``p_i - p_j`` shifted by ``window - 1`` per axis."""
    coords = torch.stack(torch.meshgrid(*[torch.arange(n, device=device) for n in ws],
                                        indexing="ij")).flatten(1)  # (3, N)
    rel = coords[:, :, None] - coords[:, None, :] + (window - 1)
    span_ = 2 * window - 1
    return (rel[0] * span_ + rel[1]) * span_ + rel[2]


def region_ids(padded: Sequence[int], ws: Sequence[int], shift: Sequence[int],
               device=None) -> torch.Tensor:
    """Region of each token of the rolled, padded grid: on an axis that
    shifts, ``[0, L - w)``, ``[L - w, L - s)`` and ``[L - s, L)`` are three
    regions (MONAI's ``compute_mask`` slices); an axis that does not is one."""
    ids = None
    for L, w, s in zip(padded, ws, shift):
        x = torch.arange(L, device=device)
        r = (x >= L - w).long() + (x >= L - s).long() if s else torch.zeros_like(x)
        ids = r if ids is None else ids[..., None] * 3 + r
    return ids


def partition(x: torch.Tensor, ws: Sequence[int]) -> torch.Tensor:
    """``(B, D, H, W, C)`` -> ``(B * windows, N, C)``, windows in grid order
    and tokens row-major within each."""
    B, D, H, W, C = x.shape
    x = x.view(B, D // ws[0], ws[0], H // ws[1], ws[1], W // ws[2], ws[2], C)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, math.prod(ws), C)


def reverse(w: torch.Tensor, ws: Sequence[int], B: int, padded: Sequence[int]) -> torch.Tensor:
    """:func:`partition`'s inverse."""
    D, H, W = padded
    x = w.view(B, D // ws[0], H // ws[1], W // ws[2], ws[0], ws[1], ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, D, H, W, -1)


def _stats_type(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or float64 if it is (a norm's statistics type)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _aligned(n: int) -> int:
    return -(-n // BIAS_ALIGN) * BIAS_ALIGN


class Linear(nn.Module):
    """``nn.Linear``'s parameters, cast to ``dtype`` at use."""

    def __init__(self, cin: int, cout: int, bias: bool = True, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device)) if bias else None
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / math.sqrt(cin))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class LayerNorm(nn.Module):
    """``nn.LayerNorm`` (eps 1e-5, affine) with float32 statistics; the
    output in ``dtype``."""

    def __init__(self, c: int, device=None, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _stats_type(x)
        return F.layer_norm(x, self.weight.shape, self.weight.to(x.dtype), self.bias.to(x.dtype),
                            1e-5).to(self.dtype)


class Conv(nn.Module):
    """``Conv3d(cin, cout, k, stride, padding)``, ``padding`` ``k // 2``
    unless given (MONAI's ``Convolution`` holds it as ``.conv``);
    ``transposed`` is ``ConvTranspose3d(k, stride, padding=0)``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, bias: bool = False,
                 transposed: bool = False, device=None, dtype=torch.float32,
                 padding: Optional[int] = None):
        super().__init__()
        self.conv = nn.Module()
        shape = (cin, cout) if transposed else (cout, cin)
        self.conv.weight = nn.Parameter(torch.empty(*shape, k, k, k, device=device))
        self.conv.bias = nn.Parameter(torch.zeros(cout, device=device)) if bias else None
        with torch.no_grad():
            self.conv.weight.normal_(0.0, 1.0 / math.sqrt(cin * k ** 3))
        self.k, self.stride, self.transposed, self.dtype = k, stride, transposed, dtype
        self.padding = k // 2 if padding is None else padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv.weight.to(self.dtype)
        b = None if self.conv.bias is None else self.conv.bias.to(self.dtype)
        if self.transposed:
            return F.conv_transpose3d(x.to(self.dtype), w, b, stride=self.stride)
        return F.conv3d(x.to(self.dtype), w, b, stride=self.stride, padding=self.padding)


class ResBlock(nn.Module):
    """MONAI's ``UnetResBlock`` (kernel 3, stride 1, instance norm)."""

    def __init__(self, cin: int, cout: int, device=None, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3, device=device, dtype=dtype)
        self.conv2 = Conv(cout, cout, 3, device=device, dtype=dtype)
        if cin != cout:
            self.conv3 = Conv(cin, cout, 1, device=device, dtype=dtype)
        self.dtype = dtype

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        return _instance_norm(_stats_type(x)).to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.leaky_relu(self._norm(self.conv1(x)), 0.01)
        y = self._norm(self.conv2(y))
        res = self._norm(self.conv3(x)) if hasattr(self, "conv3") else x.to(self.dtype)
        return F.leaky_relu(y + res, 0.01)


class BasicBlock(nn.Module):
    """MONAI's ``UnetrBasicBlock`` with ``res_block=True``."""

    def __init__(self, cin: int, cout: int, device=None, dtype=torch.float32):
        super().__init__()
        self.layer = ResBlock(cin, cout, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("mvtb.unetr.conv"):
            return self.layer(x)


class UpBlock(nn.Module):
    """MONAI's ``UnetrUpBlock``: a stride-2 transposed convolution, the skip
    concatenated after it, a residual block."""

    def __init__(self, cin: int, cout: int, device=None, dtype=torch.float32):
        super().__init__()
        self.transp_conv = Conv(cin, cout, 2, 2, transposed=True, device=device, dtype=dtype)
        self.conv_block = ResBlock(2 * cout, cout, device, dtype)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        with span("mvtb.unetr.conv"):
            y = self.transp_conv(x)
            return self.conv_block(torch.cat([y, skip.to(y.dtype)], dim=1))


class WindowAttention(nn.Module):
    """W-MSA's parameters (the bias table, ``qkv``, ``proj``) and its
    forward over ``(B * windows, N, c)`` tokens."""

    def __init__(self, dim: int, heads: int, window: int, device=None, dtype=torch.float32):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 3, heads, device=device))
        with torch.no_grad():
            nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.qkv = Linear(dim, 3 * dim, device=device, dtype=dtype)
        self.proj = Linear(dim, dim, device=device, dtype=dtype)

    def additive(self, geo: "Geometry") -> torch.Tensor:
        """The bias, plus the shift mask where the block shifts: ``(1,
        heads, N, N)`` or ``(windows, heads, N, N)``, ``dtype``, its rows
        ``BIAS_ALIGN``-aligned."""
        table = self.relative_position_bias_table.to(self.dtype).t()  # (heads, T)
        bias = table.index_select(1, geo.index).view(1, self.heads, geo.n, -1)
        if geo.mask is not None:
            bias = bias + geo.mask[:, None]
        return bias[..., :geo.n]

    def forward(self, windows: torch.Tensor, additive: torch.Tensor, B: int) -> torch.Tensor:
        n, N, c = windows.shape
        qkv = self.qkv(windows).view(n, N, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        with span("mvtb.swin.attn"):
            out = _attention(qkv[0], qkv[1], qkv[2], additive, B)
        return self.proj(out.transpose(1, 2).reshape(n, N, c))


def _attention(q, k, v, additive: torch.Tensor, B: int) -> torch.Tensor:
    """``softmax(q k^T / sqrt(d) + additive) v``: one call where the
    additive tensor is one for every window, else one a sample (it holds
    a sample's windows)."""
    if additive.shape[0] == 1:
        return _sdpa(q, k, v, additive)
    n = q.shape[0] // B
    return torch.cat([_sdpa(q[i:i + n], k[i:i + n], v[i:i + n], additive)
                      for i in range(0, B * n, n)])


def _sdpa(q, k, v, additive):
    """On the card: the memory-efficient backend, else (a head dim that is
    not a multiple of 8, which only narrowed widths have) the written-out
    one; never the flash backend, which takes no bias."""
    if q.is_cuda:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=additive)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=additive)


class Geometry:
    """What a stage's blocks share on one grid: the padded grid, the
    window and shift, the flat relative-bias index ``(N * N_aligned,)``
    and, for the shifted blocks, the mask ``(windows, N, N_aligned)``."""

    def __init__(self, grid: Sequence[int], window: int, shifted: bool, device, dtype):
        self.ws, shift = window_plan(grid, window)
        self.shift = shift if shifted and any(shift) else (0, 0, 0)
        self.padded = tuple(-(-g // w) * w for g, w in zip(grid, self.ws))
        self.n = math.prod(self.ws)
        self.windows = math.prod(p // w for p, w in zip(self.padded, self.ws))
        cols = _aligned(self.n) - self.n
        self.index = F.pad(relative_index(self.ws, window, device), (0, cols)).reshape(-1)
        self.mask = None
        if any(self.shift):
            ids = region_ids(self.padded, self.ws, self.shift, device)
            ids = partition(ids[None, ..., None], self.ws)[..., 0]  # (windows, N)
            same = ids[:, :, None] == ids[:, None, :]
            mask = torch.where(same, 0.0, SHIFT_MASK).to(dtype)
            self.mask = F.pad(mask, (0, cols))


class SwinBlock(nn.Module):
    """MONAI's ``SwinTransformerBlock`` (drop path 0)."""

    def __init__(self, dim: int, heads: int, window: int, shifted: bool, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.shifted, self.dtype = shifted, dtype
        self.norm1 = LayerNorm(dim, device, dtype)
        self.attn = WindowAttention(dim, heads, window, device, dtype)
        self.norm2 = LayerNorm(dim, device, dtype)
        self.mlp = nn.Module()
        self.mlp.linear1 = Linear(dim, 4 * dim, device=device, dtype=dtype)
        self.mlp.linear2 = Linear(4 * dim, dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, geo: Geometry) -> torch.Tensor:
        """``x`` channel-last ``(B, D, H, W, c)``."""
        B, D, H, W, _ = x.shape
        count("swin.tokens", B * D * H * W)
        count("swin.window_tokens", B * math.prod(geo.padded))
        count("swin.windows", B * geo.windows)
        h = self.norm1(x)
        with span("mvtb.swin.window"):
            pads = [0, 0]
            for g, p in zip(reversed((D, H, W)), reversed(geo.padded)):
                pads += [0, p - g]
            h = F.pad(h, pads)
            if any(geo.shift):
                h = torch.roll(h, [-s for s in geo.shift], (1, 2, 3))
            windows = partition(h, geo.ws)
            additive = self.attn.additive(geo)
        out = self.attn(windows, additive, B)
        with span("mvtb.swin.window"):
            h = reverse(out, geo.ws, B, geo.padded)
            if any(geo.shift):
                h = torch.roll(h, list(geo.shift), (1, 2, 3))
            h = h[:, :D, :H, :W]
        x = x + h
        m = self.mlp
        return x + m.linear2(F.gelu(m.linear1(self.norm2(x))))


class PatchMerging(nn.Module):
    """The 8 neighbours of each 2x2x2 cell concatenated once each (offsets
    in ``itertools.product`` order), ``LayerNorm(8c)``, ``Linear(8c ->
    2c, no bias)``; an odd axis is zero-padded first."""

    def __init__(self, dim: int, device=None, dtype=torch.float32):
        super().__init__()
        self.norm = LayerNorm(8 * dim, device, dtype)
        self.reduction = Linear(8 * dim, 2 * dim, bias=False, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        D, H, W = x.shape[1:4]
        if D % 2 or H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2, 0, D % 2))
        x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in itertools.product(range(2), repeat=3)],
                      dim=-1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    """One stage: ``depth`` Swin blocks, odd ones shifted, then a patch
    merge. Holds the stage's :class:`Geometry` per grid, device and type."""

    def __init__(self, dim: int, depth: int, heads: int, window: int, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.window = window
        self.blocks = nn.ModuleList(SwinBlock(dim, heads, window, i % 2 == 1, device, dtype)
                                    for i in range(depth))
        self.downsample = PatchMerging(dim, device, dtype)
        self._geometry: Dict[tuple, Geometry] = {}

    def geometry(self, grid: Sequence[int], shifted: bool, x: torch.Tensor) -> Geometry:
        key = (tuple(grid), shifted, x.device, x.dtype)
        geo = self._geometry.get(key)
        if geo is None:
            with span("mvtb.swin.window"):
                geo = self._geometry[key] = Geometry(grid, self.window, shifted,
                                                     x.device, x.dtype)
        return geo

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        grid = x.shape[1:4]
        for blk in self.blocks:
            x = blk(x, self.geometry(grid, blk.shifted, x))
        return self.downsample(x)


class SwinTransformer(nn.Module):
    """MONAI's ``SwinTransformer`` (patch 2, MLP ratio 4, qkv bias, no
    patch norm, dropouts 0): the five encoder outputs, each layer-normalised
    over channels (no affine) and channel-first."""

    def __init__(self, in_channels: int, dim: int, depths: Sequence[int],
                 heads: Sequence[int], window: int, device=None, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.patch_embed = nn.Module()
        self.patch_embed.proj = Conv(in_channels, dim, 2, 2, bias=True, device=device,
                                     dtype=dtype).conv
        for i, (d, h) in enumerate(zip(depths, heads)):
            self.add_module(f"layers{i + 1}", nn.ModuleList(
                [BasicLayer(dim * 2 ** i, d, h, window, device, dtype)]))
        self.n_stages = len(depths)

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(_stats_type(x), x.shape[-1:]).to(self.dtype)
        return y.permute(0, 4, 1, 2, 3)

    def forward(self, x: torch.Tensor):
        p = self.patch_embed.proj
        x = F.conv3d(x.to(self.dtype), p.weight.to(self.dtype), p.bias.to(self.dtype), stride=2)
        x = x.permute(0, 2, 3, 4, 1)  # channel-last through the stages
        outs = [self._out(x)]
        for i in range(self.n_stages):
            x = getattr(self, f"layers{i + 1}")[0](x)
            outs.append(self._out(x))
        return outs


class SwinUNETR(nn.Module):
    """``SwinUNETR(in_channels, out_channels, feature_size, depths,
    num_heads, window_size)`` on channel-first ``(B, C, H, W, D)`` tensors
    whose spatial sizes are multiples of 32; returns logits in ``dtype``.
    ``device=None`` means ``"cuda"``."""

    def __init__(self, in_channels: int = 4, out_channels: int = 3, feature_size: int = 48,
                 depths: Sequence[int] = (2, 2, 2, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if len(depths) != 4 or len(num_heads) != 4:
            raise ValueError("SwinUNETR has four stages")
        dev = resolve_device(device)
        f = feature_size
        self.dtype = dtype
        self.swinViT = SwinTransformer(in_channels, f, depths, num_heads, window_size,
                                       dev, dtype)
        kw = dict(device=dev, dtype=dtype)
        self.encoder1 = BasicBlock(in_channels, f, **kw)
        self.encoder2 = BasicBlock(f, f, **kw)
        self.encoder3 = BasicBlock(2 * f, 2 * f, **kw)
        self.encoder4 = BasicBlock(4 * f, 4 * f, **kw)
        self.encoder10 = BasicBlock(16 * f, 16 * f, **kw)
        self.decoder5 = UpBlock(16 * f, 8 * f, **kw)
        self.decoder4 = UpBlock(8 * f, 4 * f, **kw)
        self.decoder3 = UpBlock(4 * f, 2 * f, **kw)
        self.decoder2 = UpBlock(2 * f, f, **kw)
        self.decoder1 = UpBlock(f, f, **kw)
        self.out = nn.Module()
        self.out.conv = Conv(f, out_channels, 1, bias=True, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if any(n % 32 for n in x.shape[2:]):
            raise ValueError(f"SwinUNETR takes spatial sizes divisible by 32, got "
                             f"{tuple(x.shape[2:])}")
        with span("mvtb.swin.encoder"):
            hidden = self.swinViT(x)
        enc0 = self.encoder1(x)
        enc1 = self.encoder2(hidden[0])
        enc2 = self.encoder3(hidden[1])
        enc3 = self.encoder4(hidden[2])
        dec4 = self.encoder10(hidden[4])
        dec3 = self.decoder5(dec4, hidden[3])
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        dec0 = self.decoder2(dec1, enc1)
        out = self.decoder1(dec0, enc0)
        with span("mvtb.unetr.conv"):
            return self.out.conv(out)
