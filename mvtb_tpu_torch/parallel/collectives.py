"""Collectives with gradients, written as ``torch.autograd.Function``s.

``torch.distributed.nn.functional``'s gather fails in its backward over a
sub-group on gloo, and the sharded steps need exactly these few
operations, each with the backward its use calls for:

* :func:`all_reduce_sum`: forward and backward both sum over the group
  (its adjoint). Each rank's output feeds that rank's own part of the
  objective, as a sharded norm's statistics or a data-parallel BatchNorm's.
* :func:`all_gather` along a dim: the adjoint of a gather is a
  reduce-scatter (every rank's gradient of the full tensor, summed, and
  this rank's block taken).
* :func:`copy_to_group` (identity forward, summed backward) and
  :func:`gather_from_group` (gather forward, this rank's block of the
  gradient backward): the tensor-parallel pair, where everything downstream
  of the gather is the same computation on every rank of the group, so the
  objective is counted once.
* :func:`halo_exchange`: the rows a sharded convolution reads from its
  neighbours along one dim; its backward sends their gradients back.

Every exchange goes through ``all_gather`` or ``all_reduce``, which gloo
also carries on CUDA tensors (gloo's point-to-point send fails there).
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def _gather_list(x: torch.Tensor, group) -> List[torch.Tensor]:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    per = x.shape[dim] // n
    return x.narrow(dim, r * per, per).contiguous()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return torch.cat(_gather_list(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _block(_summed(g, ctx.group), ctx.dim, ctx.group), None, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return torch.cat(_gather_list(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.group), None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _AllGather.apply(x, dim, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _GatherFromGroup.apply(x, dim, group)


def _edges(x: torch.Tensor, dim: int, lo: int, hi: int) -> torch.Tensor:
    """This rank's first ``hi`` and last ``lo`` rows along ``dim``, packed:
    the rows its neighbours read."""
    n = x.shape[dim]
    parts = [x.narrow(dim, 0, hi), x.narrow(dim, n - lo, lo)]
    return torch.cat(parts, dim=dim)


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, lo, hi, group):
        ctx.dim, ctx.lo, ctx.hi, ctx.group = dim, lo, hi, group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        edges = _gather_list(_edges(x, dim, lo, hi), group)
        zero = lambda k: x.new_zeros(x.shape[:dim] + (k,) + x.shape[dim + 1:])
        # the previous rank's last lo rows; the next rank's first hi rows
        left = edges[r - 1].narrow(dim, hi, lo) if r > 0 else zero(lo)
        right = edges[r + 1].narrow(dim, 0, hi) if r < n - 1 else zero(hi)
        return torch.cat([left, x, right], dim=dim)

    @staticmethod
    def backward(ctx, g):
        dim, lo, hi, group = ctx.dim, ctx.lo, ctx.hi, ctx.group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        m = g.shape[dim] - lo - hi
        g_left, g_mid, g_right = g.split([lo, m, hi], dim=dim)
        # send the left halo's gradient to the previous rank (its last lo
        # rows) and the right halo's to the next (its first hi rows)
        sent = _gather_list(torch.cat([g_right, g_left], dim=dim), group)
        g_x = g_mid.clone()
        if r > 0 and hi:  # the previous rank's right halo is my first hi rows
            g_x.narrow(dim, 0, hi).add_(sent[r - 1].narrow(dim, 0, hi))
        if r < n - 1 and lo:  # the next rank's left halo is my last lo rows
            g_x.narrow(dim, m - lo, lo).add_(sent[r + 1].narrow(dim, hi, lo))
        return g_x, None, None, None, None


def halo_exchange(x: torch.Tensor, dim: int, lo: int, hi: int, group) -> torch.Tensor:
    """``x`` with ``lo`` rows of the previous rank before it and ``hi`` rows
    of the next rank after it along ``dim``; zeros beyond the first and last
    rank (a convolution's own zero padding there). ``lo, hi`` at most the
    local extent."""
    if lo == hi == 0:
        return x
    if min(lo, hi) < 0 or lo > x.shape[dim] or hi > x.shape[dim]:
        raise ValueError(f"halo ({lo}, {hi}) exceeds the local extent {x.shape[dim]}")
    return _HaloExchange.apply(x, dim, lo, hi, group)
