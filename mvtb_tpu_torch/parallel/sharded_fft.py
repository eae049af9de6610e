"""k-space stylization of one volume split over H across processes
(counterpart of mvtb_tpu/parallel/sharded_fft.py).

Each rank holds an H block ``(C, H/n, W, D)`` of a ``(C, H, W, D)`` volume.
The full :class:`~mvtb_tpu_torch.ops.fused.StylizeConfig` stack runs as:

1. a local transform over the unsplit axes (W, D);
2. ``all_to_all_single`` to trade the split: H gathers, W splits (rank r
   then holds the W block starting at ``w0 = r * W/n``);
3. a local transform over the now whole H axis;
4. the k-space edits on *global* raw-index grids (the H iota, the W iota
   plus ``w0``, the D iota): the radial masks and wrap parity as one
   weight, with the one-device path's own float32 arithmetic; zero-fill
   from the one-device draws; spike and plane writes where the global index
   matches, with the data-dependent spike range from an ``all_reduce`` of
   the log-magnitude sums;
5. the inverse transforms mirroring 1-3, then salt & pepper on the H block
   with the global extrema from ``all_reduce`` (MIN, MAX).

The draws are the one-device :func:`~mvtb_tpu_torch.ops.fused.sample_draws`
draws of the whole volume (B = 1), the same on every rank, so the result
equals ``stylize_kspace`` of the whole volume. The one-device path runs on
the rfft half spectrum; this one on the full complex grid, so zero-fill
expands the half-grid pair draws onto it, each conjugate pair taking its
half bin's weight. That holds pointwise, not only in distribution, because
a later spike or plane write reads the spectrum at its point.

The local transforms follow the JAX package's per-shard mapping: the plane
backends and ``dft_pallas`` run the matmul DFT (``plane``, ``dft_pallas``
-> ``dft``; ``plane_fast`` -> ``dft_fast``), since the plane kernel is a
one-device program; ``hybrid`` and ``xla`` (``torch.fft``) run as named.
So this path launches no hand-written kernel.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from mvtb_tpu_torch.ops import dft as _dft
from mvtb_tpu_torch.ops.corruptions import sap_select
from mvtb_tpu_torch.ops.fused import (StageDraws, StylizeConfig, _resolve_backend,
                                      _to_raw_index, _weight_of, _weight_parts,
                                      sample_draws, spike_log_values, zero_fill_weight)
from mvtb_tpu_torch.parallel.mesh import Mesh

Transform = Callable[[torch.Tensor, Tuple[int, ...]], torch.Tensor]


def shard_backend(cfg: StylizeConfig, spatial, device) -> str:
    """The backend of the per-shard transforms (the JAX package's mapping)."""
    backend = _resolve_backend(cfg.fft_backend, spatial, device)
    if backend in ("plane", "plane_fast", "dft_pallas"):
        return "dft_fast" if backend == "plane_fast" else "dft"
    return backend


def _local_transforms(backend: str) -> Tuple[Transform, Transform, Transform]:
    """(forward, inverse, real part of the inverse), each ``(array, axes)``."""
    if backend in ("dft", "dft_fast"):
        prec = "default" if backend == "dft_fast" else "highest"
        return (lambda a, axes: _dft.dft_nd(a, axes, prec),
                lambda a, axes: _dft.idft_nd(a, axes, prec),
                lambda a, axes: _dft.idft_nd_real(a, axes, prec))
    if backend == "hybrid":
        return _dft.hybrid_dft_nd, _dft.hybrid_idft_nd, _dft.hybrid_idft_nd_real

    def fwd(a, axes):
        if not a.is_complex() and a.dtype != torch.float64:
            a = a.to(torch.float32)
        return torch.fft.fftn(a, dim=axes)

    return (fwd, lambda a, axes: torch.fft.ifftn(a, dim=axes),
            lambda a, axes: torch.fft.ifftn(a, dim=axes).real)


def _trade(k: torch.Tensor, n: int, group, forward: bool) -> torch.Tensor:
    """All-to-all over the group. Forward: this rank's H block of every W
    block ``(C, H/n, W, D)`` -> every H block of its W block ``(C, H, W/n,
    D)``; the inverse mirrors it."""
    if forward:
        C, Hl, W, D = k.shape
        send = k.reshape(C, Hl, n, W // n, D).permute(2, 0, 1, 3, 4)
    else:
        C, H, Wl, D = k.shape
        send = k.reshape(C, n, H // n, Wl, D).permute(1, 0, 2, 3, 4)
    send = torch.view_as_real(send.contiguous())
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    recv = torch.view_as_complex(recv)  # block i came from rank i
    _, C, Hl, Wl, D = recv.shape
    if forward:
        return recv.permute(1, 0, 2, 3, 4).reshape(C, n * Hl, Wl, D)
    return recv.permute(1, 2, 0, 3, 4).reshape(C, Hl, n * Wl, D)


def _zf_weight_block(draws: StageDraws, p: float, spatial, w0: int, Wl: int) -> torch.Tensor:
    """The zero-fill weight of this rank's W block of the full complex grid,
    ``(C, H, W/n, D)``, from the one-device draws: the half-grid pair weight
    (``zero_fill_weight``) with the lower half of D taking its own bin and
    the upper half its conjugate mirror's bin ``(-h, -w, D - d)``; or, for
    the complex path's full-grid draws (no ``zf_u2``), the keep ``u > p``."""
    H, W, D = spatial
    dev = draws.zf_u.device
    wg = w0 + torch.arange(Wl, device=dev)
    if draws.zf_u2 is None:
        return (draws.zf_u[0].index_select(2, wg) > p).to(torch.float32)
    half = zero_fill_weight(draws.zf_u, draws.zf_u2, p, spatial)[0]  # (C, H, W, D//2+1)
    d = torch.arange(D, device=dev)
    lower = d <= D // 2
    low = half.index_select(2, wg).index_select(3, torch.where(lower, d, 0))
    mh = (-torch.arange(H, device=dev)) % H
    up = (half.index_select(1, mh).index_select(2, (-wg) % W)
          .index_select(3, torch.where(lower, 0, D - d)))
    return torch.where(lower, low, up)


def _point_update(k: torch.Tensor, raw: torch.Tensor, mag: torch.Tensor,
                  gates: torch.Tensor, w0: int) -> torch.Tensor:
    """Set ``|k|`` to ``mag`` (keeping the phase) at the per-channel global
    raw points ``raw`` (C, 3) that fall in this rank's W block, where
    ``gates`` allow: the one-device complex path's set write. An exact zero
    is read as +0 before its phase is taken (angle(-0) would be pi)."""
    C, _, Wl, _ = k.shape
    inside = (raw[:, 1] >= w0) & (raw[:, 1] < w0 + Wl)
    idx = (torch.arange(C, device=k.device), raw[:, 0],
           (raw[:, 1] - w0).clamp(0, Wl - 1), raw[:, 2])
    old = k[idx]
    zero = torch.zeros((), dtype=old.real.dtype, device=k.device)
    both0 = (old.real == 0) & (old.imag == 0)
    ang = torch.atan2(torch.where(both0, zero, old.imag), torch.where(both0, zero, old.real))
    new = torch.complex(mag * torch.cos(ang), mag * torch.sin(ang)).to(old.dtype)
    return k.index_put(idx, torch.where(gates & inside, new, old))


def _check_shape(x_local: torch.Tensor, cfg: StylizeConfig, n: int, group) -> Tuple[int, ...]:
    """The global (H, W, D); raises ``ValueError`` (on every rank alike)
    unless every rank holds an equal H block and W divides the group."""
    if x_local.ndim != 4:
        raise ValueError(f"expected this rank's (C, H/n, W, D) block, got {tuple(x_local.shape)}")
    if cfg.n_dims != 3:
        raise ValueError("the sharded path is 3D")
    C, Hl, W, D = x_local.shape
    sizes = [torch.zeros(1, dtype=torch.int64, device=x_local.device) for _ in range(n)]
    dist.all_gather(sizes, torch.full((1,), Hl, dtype=torch.int64, device=x_local.device),
                    group=group)
    heights = [int(s) for s in sizes]
    if len(set(heights)) != 1 or W % n:
        raise ValueError(f"H={sum(heights)} (blocks {heights}) and W={W} must divide "
                         f"the mesh axis of size {n}")
    return Hl * n, W, D


def stylize_kspace_sharded(x_local: torch.Tensor, cfg: StylizeConfig, mesh: Mesh,
                           draws: Optional[StageDraws] = None,
                           generator: Optional[torch.Generator] = None,
                           axis_name: str = "data") -> torch.Tensor:
    """The fused corruption stack on one ``(C, H, W, D)`` volume split over
    H across ``axis_name``: ``x_local`` is this rank's block ``(C, H/n, W,
    D)`` and so is the result.

    ``draws`` are the one-device draws of the whole volume (B = 1), the
    same on every rank; without them they come from ``generator``, which
    must then be seeded alike on every rank. H and W must divide the axis
    size, and the config must be 3D (``ValueError`` otherwise)."""
    n, r, group = mesh.size(axis_name), mesh.rank(axis_name), mesh.group(axis_name)
    spatial = _check_shape(x_local, cfg, n, group)
    if not cfg.any_enabled:
        return x_local
    H, W, D = spatial
    C, Hl = x_local.shape[:2]
    dev = x_local.device
    if draws is None:
        draws = sample_draws(cfg, spatial, 1, C, generator=generator, device=dev)
    draws = draws.to(dev)
    out = x_local
    if cfg.kspace_needed:
        fwd, inv, inv_real = _local_transforms(shard_backend(cfg, spatial, dev))
        k = fwd(x_local, (-2, -1))
        k = fwd(_trade(k, n, group, forward=True), (1,))
        Wl = W // n
        w0 = r * Wl
        parts, wrap_val = _weight_parts(cfg, spatial, draws, sym=False)
        if parts:
            iotas = (torch.arange(H, device=dev).view(H, 1, 1),
                     (w0 + torch.arange(Wl, device=dev)).view(1, Wl, 1),
                     torch.arange(D, device=dev).view(1, 1, D))
            k = k * _weight_of(parts, iotas, (1, 1, 1, 1))
        if cfg.zf_p is not None:
            draws.require("zf_u", "zf_gate")
            one = torch.ones((), dtype=torch.float32, device=dev)
            k = k * torch.where(draws.zf_gate[0], _zf_weight_block(draws, cfg.zf_p, spatial,
                                                                   w0, Wl), one)

        one = torch.ones((), dtype=torch.float32, device=dev)

        def wrap_at(shifted):  # (C, 3) shifted-space points
            f = one
            if wrap_val is not None:
                for d in range(3):
                    f = f * torch.where(shifted[:, d] % 2 == 1, wrap_val[0], one)
            return f

        def to_raw(shifted):
            return torch.stack([_to_raw_index(shifted[:, d], spatial[d])
                                for d in range(3)], dim=-1)

        if cfg.spike:
            draws.require("spike_shifted", "spike_u", "spike_gates")
            means = None
            if cfg.spike_range is None:
                total = torch.log(torch.abs(k) + 1e-10).sum(dim=(1, 2, 3))
                dist.all_reduce(total, group=group)
                means = (total / float(H * W * D))[None]
            sh = draws.spike_shifted[0].long()
            mag = torch.exp(spike_log_values(cfg, draws, means))[0] * wrap_at(sh)
            k = _point_update(k, to_raw(sh), mag, draws.spike_gates[0], w0)
        if cfg.plane_axes is not None:
            draws.require("plane_shifted", "plane_gate")
            sh = draws.plane_shifted[0].long()[None, :].expand(C, 3)
            mag = torch.exp(torch.tensor(cfg.plane_intensity, dtype=torch.float32,
                                         device=dev)) * wrap_at(sh)
            k = _point_update(k, to_raw(sh), mag, draws.plane_gate[0].expand(C), w0)
        k = _trade(inv(k, (1,)), n, group, forward=False)
        out = inv_real(k, (-2, -1)).to(x_local.dtype)
    if cfg.sap_p is not None:
        draws.require("sap_p", "sap_gate", "sap_u")
        p = torch.where(draws.sap_gate[0], draws.sap_p[0].to(out.dtype),
                        torch.zeros((), dtype=out.dtype, device=dev))
        lo, hi = out.min().reshape(1), out.max().reshape(1)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
        out = sap_select(out, draws.sap_u[0, :, r * Hl:(r + 1) * Hl], p, lo / 2, hi / 2)
    return out
