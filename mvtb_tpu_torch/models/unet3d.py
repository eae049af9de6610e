"""3D ResUNet in NCDHW (counterpart of mvtb_tpu/models/unet3d.py).

The same topology as the JAX package's ``UNet`` (MONAI's ``UNet`` with
channels=(16,32,64,128,256), strides=(2,2,2,2), num_res_units=2: PReLU,
InstanceNorm without affine, concatenating skips; 4,810,074 parameters for
4 -> 3 channels). Submodules carry the flax module names (``ResidualUnit_0``,
``ConvNormAct_1``, ``Conv_0``, ...) so that :mod:`.convert` maps a flax
parameter tree onto this module by path.

Two places where PyTorch's conventions differ from flax's, both handled
here:

* flax ``padding="SAME"`` pads an even axis of a stride-2, kernel-3 conv by
  (0, 1), where ``Conv3d(padding=1)`` pads (1, 1); :class:`Conv` pads
  explicitly with flax's rule and convolves unpadded.
* flax ``ConvTranspose(k, s, "SAME")`` is ``conv_transpose3d`` with the
  kernel flipped in space, cropped to ``n * s`` outputs from offset
  ``k - 1 - pad_lo`` (see :class:`ConvTranspose`).

The JAX package's slab lowering of stride-1 convs is a TPU reformulation of
the same convolution and is not ported; the tests hold this module against
it.

``dtype`` is the compute type of the JAX modules: parameters stay float32
and are cast at use. The casts are written out where flax rounds (not
``torch.autocast``, which keeps the norms in float32): each conv casts its
input and weight to ``dtype`` and adds the bias in the output's type; the
normalisation computes its statistics in float32 and rounds its output to
``dtype``; PReLU casts its slope to the input's type. So with
``dtype=torch.bfloat16`` every activation is bfloat16, as in the JAX
package's default training configuration.

On the card at a 16-bit compute type the UNet runs channels-last (NDHWC),
the form cuDNN's Hopper tensor-core convolutions take, so that cuDNN makes
no layout copy of a bf16 operand: ``UNet.forward`` lays out a CUDA input
whose ``dtype`` is bfloat16 or float16 channels-last in the one cast it
makes, and hands back one contiguous NCDHW tensor. The modules follow
their input: on a channels-last input (:func:`_ndhwc`) each convolution
casts its weight channels-last, and one whose pads are symmetric on every
axis pads inside cuDNN rather than by a copy (with the copy, cuDNN takes a
CUDA-core data gradient for some layers). Channel counts stay as they are:
cuDNN pads the 4-channel input itself and runs the forward of the layers
of 3 output channels on its CUDA-core sgemm, which costs less than
carrying zero channels to 8 through the full-resolution layers. Parameters keep their shapes and layout; gradients reach them
through the cast. Elsewhere (the CPU, float32, and any NCDHW tensor, such
as the tensor-parallel gather's output) nothing changes.
Counters (``utils/profiling.py``): ``unet.convs`` (every convolution call,
transposed ones included), ``unet.convs_ndhwc`` (those on a channels-last
input).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.utils.profiling import count

_NDHWC = torch.channels_last_3d


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA ``SAME`` padding of one axis: total ``max((ceil(n/s)-1)*s +
    k - n, 0)``, the smaller half before."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel normalisation over space, no affine. Written
    out because PyTorch's instance norm refuses a 1x1x1 volume in training
    mode, which flax's group norm maps to 0 (a 16^3 input reaches one)."""
    var, mean = torch.var_mean(x, dim=tuple(range(2, x.ndim)), keepdim=True,
                               correction=0)
    return (x - mean) * torch.rsqrt(var + eps)


def _ndhwc(x: torch.Tensor) -> bool:
    """Whether ``x`` is laid out channels-last and not also channels-first
    (a tensor of one channel or one voxel is both, and counts as NCDHW)."""
    return x.is_contiguous(memory_format=_NDHWC) and not x.is_contiguous()


def _engages(x: torch.Tensor, dtype: torch.dtype) -> bool:
    """Whether ``UNet.forward`` runs channels-last: a CUDA input at a 16-bit
    compute type."""
    return x.is_cuda and dtype in (torch.bfloat16, torch.float16)


def _cast_weight(w: torch.Tensor, dtype: torch.dtype, ndhwc: bool) -> torch.Tensor:
    """``w`` in ``dtype``, channels-last where ``ndhwc``: one cast."""
    return w.to(dtype=dtype, memory_format=_NDHWC) if ndhwc else w.to(dtype)


def _keep_ndhwc(y: torch.Tensor, ndhwc: bool) -> torch.Tensor:
    """A convolution's output channels-last where its input was: cuDNN's
    already is; a CPU convolution without a channels-last kernel (float64)
    returns NCDHW."""
    return y.contiguous(memory_format=_NDHWC) if ndhwc else y


def _count_conv(ndhwc: bool) -> None:
    count("unet.convs")
    if ndhwc:
        count("unet.convs_ndhwc")


def _lecun_normal_(w: torch.Tensor, fan_in: int) -> None:
    with torch.no_grad():
        w.normal_(0.0, 1.0 / math.sqrt(fan_in))


class Conv(nn.Module):
    """3D convolution with flax ``SAME`` padding. Weight (Cout, Cin, k, k, k)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, device=None, dtype=torch.float32):
        super().__init__()
        k = kernel_size
        self.kernel_size, self.stride, self.dtype = k, stride, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, k, device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))
        _lecun_normal_(self.weight, cin * k ** 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ndhwc = _ndhwc(x)
        _count_conv(ndhwc)
        axis_pads = [_same_pads(n, self.kernel_size, self.stride) for n in x.shape[2:]]
        w = _cast_weight(self.weight, self.dtype, ndhwc)
        x = x.to(self.dtype)
        if ndhwc and all(lo == hi for lo, hi in axis_pads):
            # symmetric pads: cuDNN pads, no copy of the input
            y = F.conv3d(x, w, stride=self.stride,
                         padding=tuple(lo for lo, _ in axis_pads))
        else:
            pads = [p for lo_hi in reversed(axis_pads) for p in lo_hi]  # last axis first
            if any(pads):
                x = F.pad(x, pads)
            y = F.conv3d(x, w, stride=self.stride)
        y = _keep_ndhwc(y, ndhwc)
        return y + self.bias.to(y.dtype).view(-1, 1, 1, 1)


class ConvTranspose(nn.Module):
    """flax ``ConvTranspose(k, s, padding="SAME")``. Weight (Cin, Cout, k, k, k),
    which is the flax kernel flipped in space."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 2, device=None, dtype=torch.float32):
        super().__init__()
        k = kernel_size
        self.kernel_size, self.stride, self.dtype = k, stride, dtype
        self.weight = nn.Parameter(torch.empty(cin, cout, k, k, k, device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))
        _lecun_normal_(self.weight, cin * k ** 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size, self.stride
        # lax.conv_transpose SAME: pad_lo = k-1 if s > k-1 else ceil((k+s-2)/2)
        pad_lo = k - 1 if s > k - 1 else -(-(k + s - 2) // 2)
        start = k - 1 - pad_lo
        ndhwc = _ndhwc(x)
        _count_conv(ndhwc)
        w = _cast_weight(self.weight, self.dtype, ndhwc)
        y = _keep_ndhwc(F.conv_transpose3d(x.to(self.dtype), w, stride=s), ndhwc)
        n = x.shape[2:]
        y = y[:, :, start:start + n[0] * s, start:start + n[1] * s,
              start:start + n[2] * s]
        return y + self.bias.to(y.dtype).view(-1, 1, 1, 1)


class ConvNormAct(nn.Module):
    """Conv (optionally transposed) -> InstanceNorm (eps 1e-5, no affine) ->
    PReLU (one slope, init 0.25); ``conv_only`` drops norm and act."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 kernel_size: int = 3, transposed: bool = False,
                 conv_only: bool = False, device=None, dtype=torch.float32):
        super().__init__()
        if transposed:
            self.ConvTranspose_0 = ConvTranspose(cin, cout, kernel_size,
                                                 stride, device, dtype)
        else:
            self.Conv_0 = Conv(cin, cout, kernel_size, stride, device, dtype)
        self.transposed = transposed
        self.dtype = dtype
        self.conv_only = conv_only
        if not conv_only:
            self.PReLU_0 = nn.PReLU(1, init=0.25, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ConvTranspose_0(x) if self.transposed else self.Conv_0(x)
        if not self.conv_only:
            # flax GroupNorm(dtype=...): float32 statistics (float64 kept),
            # output in dtype
            x = _instance_norm(x.to(torch.promote_types(x.dtype, torch.float32))).to(self.dtype)
            # flax PReLU: the slope cast to the input's type
            slope = self.PReLU_0.weight.to(x.dtype)
            x = torch.where(x >= 0, x, slope * x)
        return x


class ResidualUnit(nn.Module):
    """``subunits`` ConvNormAct blocks (the first carries the stride) plus a
    projection residual when the shape or the channel count changes."""

    def __init__(self, cin: int, cout: int, stride: int = 1, subunits: int = 2,
                 last_conv_only: bool = False, kernel_size: int = 3,
                 device=None, dtype=torch.float32):
        super().__init__()
        c = cin
        for i in range(subunits):
            conv_only = last_conv_only and i == subunits - 1
            self.add_module(f"ConvNormAct_{i}", ConvNormAct(
                c, cout, stride if i == 0 else 1, kernel_size,
                conv_only=conv_only, device=device, dtype=dtype))
            c = cout
        self.subunits = subunits
        self.has_res = stride != 1 or cin != cout
        if self.has_res:
            rk = kernel_size if stride != 1 else 1
            self.Conv_0 = Conv(cin, cout, rk, stride, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i in range(self.subunits):
            y = getattr(self, f"ConvNormAct_{i}")(y)
        return y + (self.Conv_0(x) if self.has_res else x)


class UNet(nn.Module):
    """Recursive encoder/decoder with concatenating skips (MONAI ``UNet``).

    Input and output are channel-first ``(B, C, H, W, D)``; the output is
    logits (no final activation) in ``dtype``, the compute type (parameters
    stay float32). ``device=None`` means ``"cuda"``. A CUDA input at a 16-bit
    ``dtype`` runs channels-last inside (the module docstring).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 channels: Sequence[int] = (16, 32, 64, 128, 256),
                 strides: Sequence[int] = (2, 2, 2, 2),
                 num_res_units: int = 2, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.num_res_units = num_res_units
        self.dtype = dtype
        self._counts = {"ResidualUnit": 0, "ConvNormAct": 0}
        self._plan = self._build(in_channels, out_channels, tuple(channels),
                                 tuple(strides), True, dev)
        del self._counts

    def _add(self, kind: str, module: nn.Module) -> str:
        name = f"{kind}_{self._counts[kind]}"
        self._counts[kind] += 1
        self.add_module(name, module)
        return name

    def _down(self, cin, cout, stride, dev) -> str:
        if self.num_res_units > 0:
            return self._add("ResidualUnit", ResidualUnit(
                cin, cout, stride, subunits=self.num_res_units, device=dev,
                dtype=self.dtype))
        return self._add("ConvNormAct", ConvNormAct(cin, cout, stride, device=dev,
                                                    dtype=self.dtype))

    def _up(self, cin, cout, stride, is_top, dev) -> Tuple[str, ...]:
        conv_only = is_top and self.num_res_units == 0
        names = [self._add("ConvNormAct", ConvNormAct(
            cin, cout, stride, transposed=True, conv_only=conv_only,
            device=dev, dtype=self.dtype))]
        if self.num_res_units > 0:
            names.append(self._add("ResidualUnit", ResidualUnit(
                cout, cout, 1, subunits=1, last_conv_only=is_top, device=dev,
                dtype=self.dtype)))
        return tuple(names)

    def _build(self, cin, cout, channels, strides, is_top, dev):
        """The flax ``_block`` recursion, creating submodules in flax's
        order; returns the plan ``(down, sub, up)`` that forward walks."""
        c, s = channels[0], strides[0]
        down = self._down(cin, c, s, dev)
        if len(channels) > 2:
            sub = self._build(c, c, channels[1:], strides[1:], False, dev)
            sub_out = c
        else:
            sub = self._down(c, channels[1], 1, dev)  # bottom layer
            sub_out = channels[1]
        up = self._up(c + sub_out, cout, s, is_top, dev)
        return (down, sub, up)

    def _run(self, plan, x):
        down, sub, up = plan
        d = getattr(self, down)(x)
        y = self._run(sub, d) if isinstance(sub, tuple) else getattr(self, sub)(d)
        y = torch.cat([d, y], dim=1)
        for name in up:
            y = getattr(self, name)(y)
        return y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _engages(x, self.dtype):
            return self._forward_ndhwc(x)
        return self._run(self._plan, x)

    def _forward_ndhwc(self, x: torch.Tensor) -> torch.Tensor:
        """The forward channels-last inside, on any device: NCDHW in and out."""
        x = x.to(dtype=self.dtype, memory_format=_NDHWC)
        return self._run(self._plan, x).contiguous()
