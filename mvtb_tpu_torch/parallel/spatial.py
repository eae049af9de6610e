"""The UNet train step on a volume split over H across processes (what GSPMD
does for the JAX step when the image's H axis is sharded over the mesh:
``tests/test_parallel.py``'s spatial case, ``dryrun_multichip``'s
full-volume step).

Each rank holds an H block ``(B, C, H/n, W, D)`` of the image and label,
and the whole UNet (replicated parameters). :func:`spatial_forward` walks
the UNet's own modules and weights (``models/unet3d.py``) with:

* a halo exchange (:func:`~.collectives.halo_exchange`) before each
  convolution that reads across the H boundary. The H pads come from
  ``_same_pads`` of the *global* extent: a stride-2 convolution on an even
  axis pads (0, 1), so it reads one row of the next block only. The
  transposed convolution's crop is taken in global coordinates. W and D
  pad and crop locally;
* the instance norm's mean, then its biased variance, over the global
  volume from all-reduced sums (two passes, as ``var_mean``), with the
  zero-volume rule of the one-device norm;
* a level whose global H does not divide the group (240 over 2 ranks
  reaches 15 at the 4th stride) runs on the all-gathered tensor,
  replicated, and is split again on the way back up, where the transposed
  convolution's output divides.

:func:`spatial_train_step` adds the Dice loss with its sums all-reduced
before the ratio, and sums the parameter gradients over the group. Every
collective's backward is its adjoint (a sum over ranks), so each rank
backpropagates its 1/n share of the loss that all of them hold.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.models.unet3d import (Conv, ConvNormAct, ConvTranspose, ResidualUnit,
                                          UNet, _instance_norm, _same_pads)
from mvtb_tpu_torch.parallel import dp
from mvtb_tpu_torch.parallel.collectives import all_gather, all_reduce_sum, halo_exchange
from mvtb_tpu_torch.parallel.mesh import Mesh
from mvtb_tpu_torch.train.losses import dice_loss

H_DIM = 2  # (B, C, H, W, D)


@dataclasses.dataclass
class Block:
    """An activation along H: this rank's block of a global extent ``H``
    (``split``), or the whole axis, the same on every rank."""

    x: torch.Tensor
    H: int
    split: bool


class _Walk:
    """One forward of a UNet over a split volume on ``group`` (``n`` ranks,
    this one ``r``)."""

    def __init__(self, mesh: Mesh, axis_name: str):
        self.group = mesh.group(axis_name)
        self.n, self.r = mesh.size(axis_name), mesh.rank(axis_name)

    def gather(self, t: Block) -> Block:
        if not t.split:
            return t
        return Block(all_gather(t.x, H_DIM, self.group), t.H, False)

    def resplit(self, t: Block) -> Block:
        """A whole-axis activation whose extent divides the group, cut back
        to this rank's block."""
        if t.split or t.H % self.n:
            return t
        h = t.H // self.n
        return Block(t.x.narrow(H_DIM, self.r * h, h), t.H, True)

    def conv(self, conv: Conv, t: Block) -> Block:
        k, s = conv.kernel_size, conv.stride
        h_out = -(-t.H // s)
        if t.split and (h_out % self.n or h_out * s != t.H):
            t = self.gather(t)  # the output would not split evenly
        x = t.x.to(conv.dtype)
        pads = []
        for n in reversed(x.shape[H_DIM + 1:]):  # F.pad lists the last axis first
            pads += _same_pads(n, k, s)
        lo, hi = _same_pads(t.H, k, s)
        if t.split:
            # rows [r*h - lo, (r+1)*h - s - lo + k - 1] feed this block's
            # outputs: lo rows of the previous block, k - s - lo of the
            # next (the global zero pad at the ends)
            x = halo_exchange(x, H_DIM, lo, k - s - lo, self.group)
            lo = hi = 0
        pads += [lo, hi]
        if any(pads):
            x = F.pad(x, pads)
        y = F.conv3d(x, conv.weight.to(conv.dtype), stride=s)
        y = y + conv.bias.to(y.dtype).view(-1, 1, 1, 1)
        return self.resplit(Block(y, h_out, t.split))

    def conv_transpose(self, ct: ConvTranspose, t: Block) -> Block:
        k, s = ct.kernel_size, ct.stride
        pad_lo = k - 1 if s > k - 1 else -(-(k + s - 2) // 2)
        start = k - 1 - pad_lo
        x = t.x.to(ct.dtype)
        lo, off, h = 0, start, t.H
        if t.split:
            # the global outputs of this block, [r*h*s, (r+1)*h*s) after the
            # crop, read inputs ceil((f - k + 1)/s) .. floor(f/s) of their
            # uncropped index f
            h = t.H // self.n
            f0, f1 = self.r * h * s + start, (self.r + 1) * h * s - 1 + start
            lo = max(self.r * h - -(-(f0 - k + 1) // s), 0)
            hi = max(f1 // s - ((self.r + 1) * h - 1), 0)
            x = halo_exchange(x, H_DIM, lo, hi, self.group)
            off = start + s * lo
        y = F.conv_transpose3d(x, ct.weight.to(ct.dtype), stride=s)
        W, D = t.x.shape[H_DIM + 1:]
        y = y[:, :, off:off + h * s, start:start + W * s, start:start + D * s]
        y = y + ct.bias.to(y.dtype).view(-1, 1, 1, 1)
        return self.resplit(Block(y, t.H * s, t.split))

    def norm(self, t: Block, eps: float = 1e-5) -> torch.Tensor:
        x = t.x.to(torch.promote_types(t.x.dtype, torch.float32))
        if not t.split:
            return _instance_norm(x, eps)
        count = float(t.H * x.shape[H_DIM + 1] * x.shape[H_DIM + 2])
        axes = tuple(range(H_DIM, x.ndim))
        mean = all_reduce_sum(x.sum(dim=axes, keepdim=True), self.group) / count
        d = x - mean
        var = all_reduce_sum((d * d).sum(dim=axes, keepdim=True), self.group) / count
        return d * torch.rsqrt(var + eps)

    def conv_norm_act(self, m: ConvNormAct, t: Block) -> Block:
        t = (self.conv_transpose(m.ConvTranspose_0, t) if m.transposed
             else self.conv(m.Conv_0, t))
        if m.conv_only:
            return t
        x = self.norm(t).to(m.dtype)
        slope = m.PReLU_0.weight.to(x.dtype)
        return Block(torch.where(x >= 0, x, slope * x), t.H, t.split)

    def residual(self, m: ResidualUnit, t: Block) -> Block:
        y = t
        for i in range(m.subunits):
            y = self.conv_norm_act(getattr(m, f"ConvNormAct_{i}"), y)
        res = self.conv(m.Conv_0, t) if m.has_res else t
        res = self.match(res, y)
        return Block(y.x + res.x, y.H, y.split)

    def match(self, t: Block, like: Block) -> Block:
        """``t`` in ``like``'s layout (split or whole)."""
        if t.split == like.split:
            return t
        return self.resplit(t) if like.split else self.gather(t)

    def module(self, m: torch.nn.Module, t: Block) -> Block:
        return self.residual(m, t) if isinstance(m, ResidualUnit) else self.conv_norm_act(m, t)

    def run(self, model: UNet, plan, t: Block) -> Block:
        down, sub, up = plan
        d = self.module(getattr(model, down), t)
        y = (self.run(model, sub, d) if isinstance(sub, tuple)
             else self.module(getattr(model, sub), d))
        d = self.match(d, y)
        y = Block(torch.cat([d.x, y.x], dim=1), y.H, y.split)
        for name in up:
            y = self.module(getattr(model, name), y)
        return y


def spatial_forward(model: UNet, image: torch.Tensor, mesh: Mesh,
                    axis_name: str = "data") -> torch.Tensor:
    """The UNet's logits for this rank's H block of the image (``(B, C,
    H/n, W, D)`` in, ``(B, out, H/n, W, D)`` out); the global H must divide
    the axis size."""
    walk = _Walk(mesh, axis_name)
    out = walk.run(model, model._plan, Block(image, image.shape[H_DIM] * walk.n, True))
    return walk.resplit(out).x


def spatial_train_step(state, image: torch.Tensor, label: torch.Tensor, mesh: Mesh,
                       axis_name: str = "data", device: DeviceLike = None) -> torch.Tensor:
    """One forward, backward and update of a replicated UNet state on a
    volume split over H: ``image`` and ``label`` are this rank's blocks
    ``(B, C, H/n, W, D)``. Returns the (detached) global Dice loss, the same
    on every rank. Stylize the volume first with
    :func:`~.sharded_fft.stylize_kspace_sharded`. ``device=None`` means
    ``"cuda"``; the state must already live there."""
    dev = resolve_device(device)
    image, label = image.to(dev), label.to(dev)
    model, opt = state.model, state.optimizer
    group = mesh.group(axis_name)
    opt.zero_grad(set_to_none=True)
    logits = spatial_forward(model, image, mesh, axis_name)
    loss = dice_loss(logits, label, sum_over=lambda t: all_reduce_sum(t, group))
    (loss / mesh.size(axis_name)).backward()
    dp.all_reduce_gradients(model.parameters(), group)
    opt.step()
    state.step += 1
    return loss.detach()
