"""Plain SwinUNETR: Hatamizadeh et al., "Swin UNETR: Swin Transformers for
Semantic Segmentation of Brain Tumors in MRI Images" (BrainLes 2021,
arXiv:2201.01266), at the widths MONAI's ``monai/networks/nets/
swin_unetr.py`` gives it for BraTS 2021 (Project-MONAI research-
contributions ``SwinUNETR/BRATS21``: 4 -> 3 channels, ``feature_size=48``,
depths ``(2, 2, 2, 2)``, heads ``(3, 6, 12, 24)``, window 7, patch 2, MLP
ratio 4, qkv bias, dropout and drop path 0, ``normalize=True``), written
out in plain PyTorch, float32 throughout, with no cache and no fused
kernel: attention is ``softmax(q k^T * scale + B + M) @ v`` in blocks of
windows.

The encoder works channel-last, ``(B, D, H, W, C)``, as MONAI's does:

* patch embedding ``Conv3d(in, C, 2, stride 2)`` with bias, no norm;
* per stage, ``depth`` Swin blocks, then a patch merge. A block:
  ``h = LN1(x)``, zero-padded at the end of each axis to a multiple of the
  window; in odd blocks rolled by ``-shift`` on every axis; cut into
  windows (MONAI's ``window_partition``); W-MSA; windows put back
  (``window_reverse``); rolled back; cropped; ``x = x + h``; then ``x = x +
  Linear2(GELU(Linear1(LN2(x))))``. The window and shift of a grid are
  MONAI's ``get_window_size``: an axis no longer than the window takes its
  own length as window and does not shift;
* W-MSA: ``qkv = Linear(c, 3c)``, heads of ``c / heads`` channels, ``q``
  scaled by ``head_dim ** -0.5``, ``attn = q k^T + B``, plus in shifted
  blocks the mask ``M`` (MONAI's ``compute_mask``: the rolled grid cut by
  the slices ``[:-w]``, ``[-w:-s]``, ``[-s:]`` of each axis into regions,
  -100 between two tokens of different regions, 0 within one), softmax,
  ``@ v``, ``proj = Linear(c, c)``. ``B[h, i, j]`` is row ``((d_i - d_j +
  w - 1) (2w - 1) + h_i - h_j + w - 1) (2w - 1) + w_i - w_j + w - 1`` of
  the ``((2w - 1)^3, heads)`` table (MONAI's ``relative_position_index``);
* patch merge: the eight ``x[:, i::2, j::2, k::2]``, ``(i, j, k)`` in
  ``itertools.product(range(2), repeat=3)`` order, concatenated over
  channels, ``LN(8c)``, ``Linear(8c, 2c)`` without bias;
* the five encoder outputs (the embedding and each stage's merge) each
  ``F.layer_norm`` over channels without affine, then channel-first.

The decoder (MONAI's ``UnetrBasicBlock``, ``UnetrUpBlock`` and
``UnetOutBlock`` with ``res_block=True`` and ``norm_name="instance"``):
``Res(a, b)`` is ``conv3 -> IN -> LeakyReLU(0.01) -> conv3 -> IN``, plus
``conv1 -> IN`` of its input when ``a != b``, added, LeakyReLU; its
convolutions have no bias and pad by 1; IN is instance norm with eps
1e-5 and no affine. ``enc0 = Res(x_in)``, ``enc1..enc3 = Res(x0..x2)``,
``dec4 = Res(x4)``; each up step ``ConvTranspose3d(k=2, stride 2, no
bias)``, concatenated with its skip (upsampled first), ``Res(2c, c)``:
``dec4 + x3``, ``+ enc3``, ``+ enc2``, ``+ enc1``, ``+ enc0``; the head
``Conv3d(C, out, 1)`` with bias.

Departures from what MONAI builds by default, each taken for the paper's
equations: the patch merge takes the eight neighbours once each, in
``PatchMergingV2``'s order (MONAI's default ``PatchMerging`` keeps, for old
checkpoints, an order that takes two neighbours twice and two never);
where a window shrinks (an axis of at most ``w``), its bias rows are
those of its own tokens' offsets (MONAI slices the full window's index to
``[:n, :n]``, whose rows are other offsets). At a 128^3 crop no window
shrinks. Parameter names are MONAI's, so one state dict loads here and
into the measured program.

``quant`` rounds every activation and the operands of every product
(convolution, linear, ``q k^T`` and ``attn @ v``), and its ``grad``, where
it has one, rounds the gradient reaching each product's output: the
precision policy of a model whose activations all live in one low type
(:mod:`.lowp`). It is None for the reference.
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]

WINDOW_BLOCK = 128  # windows a step of the attention loop computes


def _q(quant: Quant, t: torch.Tensor) -> torch.Tensor:
    return t if quant is None else quant(t)


def _qo(quant: Quant, y: torch.Tensor) -> torch.Tensor:
    return y if getattr(quant, "grad", None) is None else quant.grad(y)


def linear(x, weight, bias, quant: Quant):
    y = _qo(quant, _q(quant, x) @ _q(quant, weight).t())
    return _q(quant, y if bias is None else y + bias)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dims = tuple(range(2, x.ndim))
    mean = x.mean(dim=dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    return y if weight is None else y * weight + bias


def window_size(grid: Sequence[int], window: int):
    ws = [window] * 3
    shift = [window // 2] * 3
    for i, g in enumerate(grid):
        if g <= window:
            ws[i], shift[i] = g, 0
    return ws, shift


def window_partition(x: torch.Tensor, ws) -> torch.Tensor:
    b, d, h, w, c = x.shape
    x = x.view(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).contiguous().view(-1, ws[0] * ws[1] * ws[2], c)


def window_reverse(windows: torch.Tensor, ws, dims) -> torch.Tensor:
    b, d, h, w = dims
    x = windows.view(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1], ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).contiguous().view(b, d, h, w, -1)


def compute_mask(dims, ws, shift, device) -> torch.Tensor:
    """MONAI's ``compute_mask``: ``(windows, N, N)``, 0 or -100."""
    d, h, w = dims
    img = torch.zeros((1, d, h, w, 1), device=device)
    cnt = 0
    slices = [(slice(-ws[i]), slice(-ws[i], -shift[i]), slice(-shift[i], None))
              for i in range(3)]
    for sd in slices[0]:
        for sh in slices[1]:
            for sw in slices[2]:
                img[:, sd, sh, sw, :] = cnt
                cnt += 1
    mw = window_partition(img, ws).squeeze(-1)
    diff = mw.unsqueeze(1) - mw.unsqueeze(2)
    return torch.where(diff != 0, torch.tensor(-100.0, device=device),
                       torch.tensor(0.0, device=device))


def relative_position_index(ws, window: int, device) -> torch.Tensor:
    """MONAI's ``relative_position_index`` over the tokens of a ``ws``
    window, offsets shifted and scaled by the full ``window``."""
    coords = torch.stack(torch.meshgrid(*[torch.arange(n, device=device) for n in ws],
                                        indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel += window - 1
    rel[:, :, 0] *= (2 * window - 1) * (2 * window - 1)
    rel[:, :, 1] *= 2 * window - 1
    return rel.sum(-1)


class Linear(nn.Module):
    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x, quant: Quant = None):
        return linear(x, self.weight, self.bias, quant)


class LayerNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x, quant: Quant = None):
        return _q(quant, layer_norm(x, self.weight, self.bias))


class ConvLayer(nn.Module):
    """MONAI's ``Convolution`` (``.conv`` holds the weights)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, bias: bool = False,
                 transposed: bool = False):
        super().__init__()
        self.conv = nn.Module()
        shape = (cin, cout, k, k, k) if transposed else (cout, cin, k, k, k)
        self.conv.weight = nn.Parameter(torch.zeros(shape))
        self.conv.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.k, self.stride, self.transposed = k, stride, transposed

    def forward(self, x, quant: Quant = None):
        w = _q(quant, self.conv.weight)
        if self.transposed:
            y = F.conv_transpose3d(_q(quant, x), w, stride=self.stride)
        else:
            y = F.conv3d(_q(quant, x), w, stride=self.stride, padding=self.k // 2)
        y = _qo(quant, y)
        if self.conv.bias is not None:
            y = y + self.conv.bias.view(-1, 1, 1, 1)
        return _q(quant, y)


class UnetResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = ConvLayer(cin, cout, 3)
        self.conv2 = ConvLayer(cout, cout, 3)
        self.downsample = cin != cout
        if self.downsample:
            self.conv3 = ConvLayer(cin, cout, 1)

    def forward(self, x, quant: Quant = None):
        out = _q(quant, instance_norm(self.conv1(x, quant)))
        out = _q(quant, F.leaky_relu(out, 0.01))
        out = _q(quant, instance_norm(self.conv2(out, quant)))
        res = _q(quant, instance_norm(self.conv3(x, quant))) if self.downsample else x
        return _q(quant, F.leaky_relu(_q(quant, out + res), 0.01))


class UnetrBasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.layer = UnetResBlock(cin, cout)

    def forward(self, x, quant: Quant = None):
        return self.layer(x, quant)


class UnetrUpBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.transp_conv = ConvLayer(cin, cout, 2, 2, transposed=True)
        self.conv_block = UnetResBlock(2 * cout, cout)

    def forward(self, x, skip, quant: Quant = None):
        return self.conv_block(torch.cat((self.transp_conv(x, quant), skip), dim=1), quant)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads, self.window = heads, window
        self.scale = (dim // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 3, heads))
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x, ws, mask, quant: Quant = None):
        """``x`` (windows, N, c); ``mask`` (windows of one sample, N, N) or None."""
        b, n, c = x.shape
        index = relative_position_index(ws, self.window, x.device)
        bias = self.relative_position_bias_table[index.reshape(-1)].reshape(n, n, -1)
        bias = bias.permute(2, 0, 1)
        qkv = self.qkv(x, quant).reshape(b, n, 3, self.heads, c // self.heads)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        outs = []
        for i in range(0, b, WINDOW_BLOCK):
            q, k, v = (t[i:i + WINDOW_BLOCK] for t in qkv)
            q = _q(quant, q * self.scale)
            attn = _qo(quant, q @ _q(quant, k).transpose(-2, -1)) + bias.unsqueeze(0)
            if mask is not None:
                nw = mask.shape[0]
                rows = torch.arange(i, i + q.shape[0], device=x.device) % nw
                attn = attn + mask[rows].unsqueeze(1)
            attn = _q(quant, torch.softmax(attn, dim=-1))
            outs.append(_q(quant, _qo(quant, attn @ _q(quant, v))))
        out = torch.cat(outs).transpose(1, 2).reshape(b, n, c)
        return self.proj(out, quant)


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shifted: bool):
        super().__init__()
        self.window, self.shifted = window, shifted
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = LayerNorm(dim)
        self.mlp = nn.Module()
        self.mlp.linear1 = Linear(dim, 4 * dim)
        self.mlp.linear2 = Linear(4 * dim, dim)

    def forward(self, x, quant: Quant = None):
        b, d, h, w, c = x.shape
        ws, shift = window_size((d, h, w), self.window)
        if not self.shifted:
            shift = [0, 0, 0]
        shortcut = x
        x = self.norm1(x, quant)
        pads = [(ws[i] - n % ws[i]) % ws[i] for i, n in enumerate((d, h, w))]
        x = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        _, dp, hp, wp, _ = x.shape
        mask = None
        if any(s > 0 for s in shift):
            x = torch.roll(x, shifts=(-shift[0], -shift[1], -shift[2]), dims=(1, 2, 3))
            mask = compute_mask((dp, hp, wp), ws, shift, x.device)
        windows = self.attn(window_partition(x, ws), ws, mask, quant)
        x = window_reverse(windows, ws, (b, dp, hp, wp))
        if mask is not None:
            x = torch.roll(x, shifts=tuple(shift), dims=(1, 2, 3))
        x = _q(quant, shortcut + x[:, :d, :h, :w, :])
        m = self.mlp
        y = _q(quant, F.gelu(m.linear1(self.norm2(x, quant), quant)))
        return _q(quant, x + m.linear2(y, quant))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(8 * dim)
        self.reduction = Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x, quant: Quant = None):
        d, h, w = x.shape[1:4]
        if d % 2 or h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x = torch.cat([x[:, i::2, j::2, k::2, :]
                       for i, j, k in itertools.product(range(2), range(2), range(2))], -1)
        return self.reduction(self.norm(x, quant), quant)


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int):
        super().__init__()
        self.blocks = nn.ModuleList(SwinTransformerBlock(dim, heads, window, i % 2 == 1)
                                    for i in range(depth))
        self.downsample = PatchMerging(dim)

    def forward(self, x, quant: Quant = None):
        for blk in self.blocks:
            x = blk(x, quant)
        return self.downsample(x, quant)


class SwinTransformer(nn.Module):
    def __init__(self, in_channels: int, dim: int, depths, heads, window: int):
        super().__init__()
        self.patch_embed = nn.Module()
        self.patch_embed.proj = ConvLayer(in_channels, dim, 2, 2, bias=True).conv
        self.stages = len(depths)
        for i in range(self.stages):
            self.add_module(f"layers{i + 1}", nn.ModuleList(
                [BasicLayer(dim * 2 ** i, depths[i], heads[i], window)]))

    @staticmethod
    def proj_out(x, quant: Quant):
        return _q(quant, layer_norm(x, None, None)).permute(0, 4, 1, 2, 3)

    def forward(self, x, quant: Quant = None):
        p = self.patch_embed.proj
        x = _qo(quant, F.conv3d(_q(quant, x), _q(quant, p.weight), stride=2))
        x = _q(quant, x + p.bias.view(-1, 1, 1, 1)).permute(0, 2, 3, 4, 1)
        outs = [self.proj_out(x, quant)]
        for i in range(self.stages):
            x = getattr(self, f"layers{i + 1}")[0](x, quant)
            outs.append(self.proj_out(x, quant))
        return outs


class SwinUNETR(nn.Module):
    """``SwinUNETR(in_channels, out_channels, feature_size, depths,
    num_heads, window_size)`` on channel-first ``(B, C, H, W, D)`` float32
    tensors (spatial sizes multiples of 32); returns logits."""

    def __init__(self, in_channels: int = 4, out_channels: int = 3, feature_size: int = 48,
                 depths: Sequence[int] = (2, 2, 2, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7):
        super().__init__()
        f = feature_size
        self.swinViT = SwinTransformer(in_channels, f, depths, num_heads, window_size)
        self.encoder1 = UnetrBasicBlock(in_channels, f)
        self.encoder2 = UnetrBasicBlock(f, f)
        self.encoder3 = UnetrBasicBlock(2 * f, 2 * f)
        self.encoder4 = UnetrBasicBlock(4 * f, 4 * f)
        self.encoder10 = UnetrBasicBlock(16 * f, 16 * f)
        self.decoder5 = UnetrUpBlock(16 * f, 8 * f)
        self.decoder4 = UnetrUpBlock(8 * f, 4 * f)
        self.decoder3 = UnetrUpBlock(4 * f, 2 * f)
        self.decoder2 = UnetrUpBlock(2 * f, f)
        self.decoder1 = UnetrUpBlock(f, f)
        self.out = nn.Module()
        self.out.conv = ConvLayer(f, out_channels, 1, bias=True)

    def forward(self, x_in: torch.Tensor, quant: Quant = None) -> torch.Tensor:
        hidden = self.swinViT(x_in, quant)
        enc0 = self.encoder1(x_in, quant)
        enc1 = self.encoder2(hidden[0], quant)
        enc2 = self.encoder3(hidden[1], quant)
        enc3 = self.encoder4(hidden[2], quant)
        dec4 = self.encoder10(hidden[4], quant)
        dec3 = self.decoder5(dec4, hidden[3], quant)
        dec2 = self.decoder4(dec3, enc3, quant)
        dec1 = self.decoder3(dec2, enc2, quant)
        dec0 = self.decoder2(dec1, enc1, quant)
        out = self.decoder1(dec0, enc0, quant)
        return self.out.conv(out, quant)


def build(model_cfg: dict) -> SwinUNETR:
    return SwinUNETR(model_cfg["in_channels"], model_cfg["out_channels"],
                     model_cfg["feature_size"], model_cfg["depths"], model_cfg["num_heads"],
                     model_cfg["window_size"])


def param_shapes(model_cfg: dict):
    """Ordered ``{name: shape}`` of the model a config describes, built on
    the meta device (no memory)."""
    with torch.device("meta"):
        m = build(model_cfg)
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}
