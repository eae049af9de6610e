"""Fused k-space stylization (counterpart of mvtb_tpu/ops/fused.py).

The JAX package draws every random stage parameter from a threefry key
(``stage_keys``), which torch cannot replay. The port separates the draws
from the arithmetic instead: :class:`StageDraws` holds the raw per-sample
draws, :func:`sample_draws` makes them from a ``torch.Generator``, and
:func:`stylize_batch` takes either. Handing the same draws to both packages
makes their outputs comparable element by element.

Two paths, as in the JAX package:

* the plane backends (``"plane"``, ``"plane_fast"``) with a plane-eligible
  config run the fused plane kernel of :mod:`.fused_plane`;
* everything else runs the general half-spectrum path, batched over B with
  per-sample parameters broadcast: ``rfftn`` over (H, W, D) with the half
  axis LAST (D) -> the multiplicative weights (Gibbs with its even-axis
  mirror average, disk, wrap) -> the one-pass spike / plane-wave point
  writes -> ``irfftn`` -> image-domain salt & pepper. Its backends are
  ``"dft"`` / ``"dft_fast"`` (:mod:`.dft` on ``torch.matmul``),
  ``"dft_pallas"`` (the hand-written axis kernels of :mod:`.pallas_dft`, at
  their bf16x3 ``"high"`` tier, as the JAX package runs them) and
  ``"xla"`` (``torch.fft``); ``"auto"`` picks ``"dft"`` on a CUDA device and
  ``"xla"`` on the CPU.

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
item: the zero-fill stage, the data-dependent spike range, the complex
path, the ``"hybrid"`` backend and ``n_dims=2``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.ops import dft as _dft
from mvtb_tpu_torch.ops.corruptions import sap_select
from mvtb_tpu_torch.ops.masks import shell_flat_indices

ParamSpec = Union[float, Tuple[float, float]]  # fixed value or U[lo,hi] range

# Where the not-yet-ported paths are queued (ROADMAP.md, section 1).
_TODO_FUSED = "ROADMAP.md section 1, item 2 (fused stylization, the rest)"

BACKENDS = ("xla", "dft", "dft_fast", "hybrid", "dft_pallas", "plane",
            "plane_fast")


@dataclasses.dataclass(frozen=True)
class StylizeConfig:
    """Static configuration of the fused corruption stack; the same fields
    and meanings as the JAX package's ``StylizeConfig``.

    Every stage is optional (None disables it). A ``ParamSpec`` is either a
    fixed float or a ``(lo, hi)`` tuple sampled uniformly per sample.
    ``*_prob`` gates each stage per sample with a Bernoulli draw.
    """

    n_dims: int = 3
    gibbs_alpha: Optional[ParamSpec] = None
    gibbs_prob: float = 1.0
    disk_r: Optional[ParamSpec] = None
    disk_inside_off: bool = False
    disk_prob: float = 1.0
    wrap_alpha: Optional[ParamSpec] = None
    wrap_prob: float = 1.0
    spike: bool = False
    spike_range: Optional[Tuple[float, float]] = None
    spike_channel_wise: bool = True
    spike_prob: float = 1.0
    plane_axes: Optional[Tuple[float, float, float]] = None
    plane_intensity: float = 1.0
    plane_prob: float = 1.0
    zf_p: Optional[float] = None
    zf_prob: float = 1.0
    sap_p: Optional[ParamSpec] = None
    sap_prob: float = 1.0
    fft_backend: str = "auto"

    @property
    def any_enabled(self) -> bool:
        return any(
            v is not None
            for v in (self.gibbs_alpha, self.disk_r, self.wrap_alpha,
                      self.plane_axes, self.zf_p, self.sap_p)
        ) or self.spike

    @property
    def kspace_needed(self) -> bool:
        return (self.gibbs_alpha is not None or self.disk_r is not None
                or self.wrap_alpha is not None or self.spike
                or self.plane_axes is not None or self.zf_p is not None)


def _off_of(i: torch.Tensor, n: int) -> torch.Tensor:
    """Offset-from-center of raw FFT index ``i``: ``i`` for ``i < n - n//2``,
    else ``i - n``."""
    c = n // 2
    return torch.where(i < n - c, i, i - n)


def _to_raw_index(shifted_idx, n: int):
    """Map a shifted-space index to raw FFT coordinates: ``(s - c) mod n``."""
    return (shifted_idx - n // 2) % n


@dataclasses.dataclass
class StageDraws:
    """The raw per-sample random draws of one stylize call, batched over B.

    A field is None when its stage is off. Shapes (B samples, C channels):

    * ``gibbs_alpha``, ``disk_r``, ``wrap_alpha``, ``sap_p``: (B,) float32;
    * ``gibbs_gate``, ``disk_gate``, ``wrap_gate``, ``plane_gate``,
      ``sap_gate``: (B,) bool;
    * ``spike_shifted``: (B, C, 3) int, fftshifted-space spike locations;
      ``spike_vals``: (B, C) float32 log-magnitudes (before ``exp``);
      ``spike_gates``: (B, C) bool;
    * ``plane_shifted``: (B, 3) int, shifted-space location on the shell;
    * ``sap_u``: (B, C, *spatial) float32 uniforms of salt & pepper.
    """

    gibbs_alpha: Optional[torch.Tensor] = None
    gibbs_gate: Optional[torch.Tensor] = None
    disk_r: Optional[torch.Tensor] = None
    disk_gate: Optional[torch.Tensor] = None
    wrap_alpha: Optional[torch.Tensor] = None
    wrap_gate: Optional[torch.Tensor] = None
    spike_shifted: Optional[torch.Tensor] = None
    spike_vals: Optional[torch.Tensor] = None
    spike_gates: Optional[torch.Tensor] = None
    plane_shifted: Optional[torch.Tensor] = None
    plane_gate: Optional[torch.Tensor] = None
    sap_p: Optional[torch.Tensor] = None
    sap_gate: Optional[torch.Tensor] = None
    sap_u: Optional[torch.Tensor] = None

    def to(self, device: DeviceLike) -> "StageDraws":
        return StageDraws(**{
            f.name: (None if getattr(self, f.name) is None
                     else getattr(self, f.name).to(device))
            for f in dataclasses.fields(self)})

    def require(self, *names: str) -> None:
        missing = [n for n in names if getattr(self, n) is None]
        if missing:
            raise ValueError(f"StageDraws lacks {missing} for this config")


def sample_draws(cfg: StylizeConfig, spatial, B: int, C: int,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None) -> StageDraws:
    """Draw every random stage parameter for a (B, C, *spatial) batch.

    The distributions are the JAX package's (uniform parameters, Bernoulli
    gates, uniform spike locations, a uniform pick on the ellipsoid shell);
    the numbers differ, since the generator differs. ``generator`` must live
    on ``device``; None uses PyTorch's default generator there.
    """
    dev = resolve_device(device)
    spatial = tuple(int(n) for n in spatial)

    def uniform(shape):
        return torch.rand(shape, generator=generator, device=dev)

    def param(spec):
        if isinstance(spec, tuple):
            return spec[0] + (spec[1] - spec[0]) * uniform((B,))
        return torch.full((B,), float(spec), device=dev)

    def gate(prob):
        if prob >= 1.0:
            return torch.ones((B,), dtype=torch.bool, device=dev)
        return uniform((B,)) < prob

    d = StageDraws()
    if cfg.gibbs_alpha is not None:
        d.gibbs_alpha, d.gibbs_gate = param(cfg.gibbs_alpha), gate(cfg.gibbs_prob)
    if cfg.disk_r is not None:
        d.disk_r, d.disk_gate = param(cfg.disk_r), gate(cfg.disk_prob)
    if cfg.wrap_alpha is not None:
        d.wrap_alpha, d.wrap_gate = param(cfg.wrap_alpha), gate(cfg.wrap_prob)
    if cfg.spike:
        if cfg.spike_range is None:
            raise NotImplementedError(
                "data-dependent spike range: " + _TODO_FUSED)
        lo, hi = cfg.spike_range
        width = C if cfg.spike_channel_wise else 1
        locs = torch.stack([
            torch.randint(0, n, (B, width), generator=generator, device=dev)
            for n in spatial], dim=-1)
        vals = lo + (hi - lo) * uniform((B, width))
        gates = (uniform((B, width)) < cfg.spike_prob if cfg.spike_channel_wise
                 else gate(cfg.spike_prob)[:, None])
        d.spike_shifted = locs.expand(B, C, 3)
        d.spike_vals = vals.expand(B, C)
        d.spike_gates = gates.expand(B, C)
    if cfg.plane_axes is not None:
        flat = torch.from_numpy(
            shell_flat_indices(spatial, *map(float, cfg.plane_axes))).to(dev)
        pick = torch.randint(0, flat.numel(), (B,), generator=generator,
                             device=dev)
        d.plane_shifted = torch.stack(
            torch.unravel_index(flat[pick], spatial), dim=-1)
        d.plane_gate = gate(cfg.plane_prob)
    if cfg.sap_p is not None:
        d.sap_p, d.sap_gate = param(cfg.sap_p), gate(cfg.sap_prob)
        d.sap_u = uniform((B, C) + spatial)
    return d


def _resolve_backend(backend: str, spatial, device: DeviceLike) -> str:
    """Resolve ``StylizeConfig.fft_backend`` to a concrete backend.

    ``"auto"`` picks the all-axis matmul DFT (``"dft"``) on a CUDA device
    when every spatial dim is within :data:`~.dft.MATMUL_DFT_MAX_N`, and
    ``torch.fft`` (``"xla"``) otherwise, on the CPU too, as the JAX package
    does on its CPU backend.
    """
    if backend != "auto":
        if backend not in BACKENDS:
            raise ValueError(f"unknown fft_backend {backend!r}")
        return backend
    if torch.device(device).type == "cuda" and _dft.use_matmul_dft(spatial):
        return "dft"
    return "xla"


def _rfft_eligible(cfg: StylizeConfig, spatial) -> bool:
    """True when the k-space part runs on the rfft half spectrum: every
    k-space stage does (the JAX package's seam of the same name; its
    complex path is not ported)."""
    del spatial
    return cfg.kspace_needed


def _check_general(cfg: StylizeConfig, spatial, backend: str) -> None:
    """Raise for what the general path does not implement yet."""
    if backend == "hybrid":
        raise NotImplementedError(
            "fft_backend='hybrid' (per-axis torch.fft / matmul DFT): " + _TODO_FUSED)
    if cfg.zf_p is not None:
        raise NotImplementedError(
            "the zero-fill stage (zf_p) with its pair-iid rule: " + _TODO_FUSED)
    if cfg.spike and cfg.spike_range is None:
        raise NotImplementedError(
            "data-dependent spike range (spike_range=None): " + _TODO_FUSED)
    if cfg.kspace_needed and not _rfft_eligible(cfg, spatial):
        raise NotImplementedError("the complex (full-spectrum) path: " + _TODO_FUSED)


def _salt_and_pepper(out: torch.Tensor, draws: StageDraws) -> torch.Tensor:
    """Image-domain salt & pepper with per-sample extrema over (C, *spatial)."""
    draws.require("sap_p", "sap_gate", "sap_u")
    B = out.shape[0]
    view = (B,) + (1,) * (out.ndim - 1)
    p = torch.where(draws.sap_gate, draws.sap_p.to(out.dtype),
                    torch.zeros((), dtype=out.dtype, device=out.device))
    p = p.view(view)
    flat = out.reshape(B, -1)
    lo = (flat.amin(dim=1) / 2).view(view)
    hi = (flat.amax(dim=1) / 2).view(view)
    return sap_select(out, draws.sap_u, p, lo, hi)


def _forward(x: torch.Tensor, backend: str):
    """(re, im) of ``rfftn`` over the three spatial axes, half axis last."""
    axes = (2, 3, 4)
    if backend == "xla":
        k = torch.fft.rfftn(x.to(torch.float32), dim=axes)
        return k.real.contiguous(), k.imag.contiguous()
    if backend == "dft_pallas":
        from mvtb_tpu_torch.ops import pallas_dft as _pdft

        return _pdft.rdft_nd_pair(x, axes, "high")
    return _dft.rdft_nd_pair(x, axes, "default" if backend == "dft_fast"
                             else "highest")


def _inverse(re: torch.Tensor, im: torch.Tensor, spatial, backend: str):
    """``irfftn`` of the (re, im) half spectrum back to a real volume."""
    axes = (2, 3, 4)
    if backend == "xla":
        return torch.fft.irfftn(torch.complex(re, im), s=spatial, dim=axes)
    if backend == "dft_pallas":
        from mvtb_tpu_torch.ops import pallas_dft as _pdft

        return _pdft.irdft_nd_real_pair(re, im, spatial, axes, "high")
    return _dft.irdft_nd_real_pair(re, im, spatial, axes,
                                   "default" if backend == "dft_fast" else "highest")


def _weight_parts(cfg: StylizeConfig, spatial, draws: StageDraws):
    """The multiplicative weight stages as callables ``part(idx, view)``:
    ``idx`` holds per-axis integer index tensors (a broadcast grid, or
    (B, C) point locations) and ``view`` the shape that broadcasts a (B,)
    parameter against them. The same float32 arithmetic in the same order
    as the JAX package's ``gibbs_part`` / ``disk_part`` / ``wrap_part``, so
    the grid weight and the weight at a point agree bit for bit. Returns
    ``(parts, wrap_val)``, ``wrap_val`` the gated (B,) wrap alpha or None."""
    f32 = torch.float32
    nd = len(spatial)
    parts = []

    def ones_like(t):
        return torch.ones((), dtype=f32, device=t.device)

    if cfg.gibbs_alpha is not None:
        draws.require("gibbs_alpha", "gibbs_gate")
        # GibbsNoise center is (n-1)/2: shifted-center delta (n-1)/2 - n//2
        deltas = tuple((n - 1) / 2 - n // 2 for n in spatial)
        r_g = (1.0 - draws.gibbs_alpha.to(f32)) * max(spatial) * (2.0 ** 0.5) / 2.0
        r2_g = r_g * r_g
        g_g = draws.gibbs_gate
        sym = any(d != 0 for d in deltas)

        def gibbs_part(idx, view):
            dist = None
            for axis in range(nd):
                off = _off_of(idx[axis].to(f32), spatial[axis]) - deltas[axis]
                sq = off * off
                dist = sq if dist is None else dist + sq
            m = (dist <= r2_g.view(view)).to(f32)
            if sym:
                # even axes make the (n-1)/2-centred mask mod-n asymmetric;
                # the half spectrum carries its mirror average. The mirror
                # of offset o is -o, except the self-mirrored Nyquist
                # offset -n/2 of an even axis.
                dist_m = None
                for axis in range(nd):
                    n = spatial[axis]
                    off = _off_of(idx[axis].to(f32), n)
                    off_m = -off
                    if n % 2 == 0:
                        off_m = torch.where(off == -(n // 2), off, off_m)
                    dd = off_m - deltas[axis]
                    sq = dd * dd
                    dist_m = sq if dist_m is None else dist_m + sq
                m = (m + (dist_m <= r2_g.view(view)).to(f32)) * 0.5
            return torch.where(g_g.view(view), m, ones_like(m))

        parts.append(gibbs_part)

    if cfg.disk_r is not None:
        draws.require("disk_r", "disk_gate")
        r_d = draws.disk_r.to(f32)
        r2_d = r_d * r_d
        g_d = draws.disk_gate

        def disk_part(idx, view):
            dist = None
            for axis in range(nd):
                off = _off_of(idx[axis].to(f32), spatial[axis]) - 0.0
                sq = off * off
                dist = sq if dist is None else dist + sq
            inside = dist < r2_d.view(view)
            m = (~inside if cfg.disk_inside_off else inside).to(f32)
            return torch.where(g_d.view(view), m, ones_like(m))

        parts.append(disk_part)

    wrap_val = None
    if cfg.wrap_alpha is not None:
        draws.require("wrap_alpha", "wrap_gate")
        one = torch.ones((), dtype=f32, device=draws.wrap_alpha.device)
        wrap_val = torch.where(draws.wrap_gate, draws.wrap_alpha.to(f32), one)

        def wrap_part(idx, view):
            w = None
            for d in range(nd):
                n = spatial[d]
                c = n // 2
                i = idx[d]
                s = torch.where(i < n - c, i + c, i + c - n)  # shifted
                wd = torch.where(s % 2 == 1, wrap_val.view(view), one)
                w = wd if w is None else w * wd
            return w

        parts.append(wrap_part)
    return parts, wrap_val


def _weight_of(parts, idx, view):
    w = None
    for part in parts:
        f = part(idx, view)
        w = f if w is None else w * f
    return w


def _stylize_general(x: torch.Tensor, cfg: StylizeConfig, draws: StageDraws,
                     backend: str) -> torch.Tensor:
    """The general half-spectrum path of ``stylize_kspace`` on a
    (B, C, H, W, D) batch (JAX: mvtb_tpu/ops/fused.py, the ``use_rfft``
    branch with its one-pass point writes)."""
    B, C = x.shape[:2]
    spatial = tuple(int(n) for n in x.shape[2:])
    nd = len(spatial)
    dev = x.device
    out = x
    if cfg.kspace_needed:
        re, im = _forward(x, backend)
        grid = spatial[:-1] + (spatial[-1] // 2 + 1,)
        parts, wrap_val = _weight_parts(cfg, spatial, draws)
        deltas = (_point_deltas(cfg, spatial, grid, draws, parts, wrap_val, re, im)
                  if cfg.spike or cfg.plane_axes is not None else [])
        if parts:
            iotas = tuple(torch.arange(n, device=dev).view(
                tuple(n if a == d else 1 for a in range(nd)))
                for d, n in enumerate(grid))
            w = _weight_of(parts, iotas, (B,) + (1,) * nd)
            w = w.expand((B,) + grid)[:, None]
            re, im = re * w, im * w
        bi = torch.arange(B, device=dev)[:, None]
        ci = torch.arange(C, device=dev)[None, :]
        for locs, d_re, d_im in deltas:  # spike, then plane wave
            idx = (bi, ci) + tuple(locs[..., d] for d in range(nd))
            re = re.index_put(idx, d_re, accumulate=True)
            im = im.index_put(idx, d_im, accumulate=True)
        out = _inverse(re, im, spatial, backend).to(x.dtype)
    if cfg.sap_p is not None:
        out = _salt_and_pepper(out, draws)
    return out


def _point_deltas(cfg: StylizeConfig, spatial, grid, draws: StageDraws,
                  parts, wrap_val, re: torch.Tensor, im: torch.Tensor):
    """The spike and plane-wave writes as ``[(locs, d_re, d_im), ...]`` in
    stage order: (B, C, 3) canonical half-grid points and the (B, C) deltas
    to add there. Every point is read from the RAW spectrum and weighted
    with the grid weight's own arithmetic at that point; the plane wave
    reads what a spike at the same point of the same channel wrote."""
    B, C = re.shape[:2]
    nd = len(spatial)
    f32 = torch.float32
    dev = re.device
    one = torch.ones((), dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    bi = torch.arange(B, device=dev)[:, None]
    ci = torch.arange(C, device=dev)[None, :]

    def wrap_at(shifted):  # (B, C, 3) shifted-space points
        f = one
        if wrap_val is None:
            return f
        for d in range(nd):
            f = f * torch.where(shifted[..., d] % 2 == 1, wrap_val[:, None], one)
        return f

    def to_raw(shifted):
        return torch.stack([_to_raw_index(shifted[..., d], spatial[d])
                            for d in range(nd)], dim=-1)

    def canon(raw):
        """Raw full-grid points -> the stored half grid: a point whose last
        index lies in the dropped half mirrors through ``-s mod n``."""
        in_half = raw[..., -1] < grid[-1]
        locs = torch.stack([torch.where(in_half, raw[..., d],
                                        (spatial[d] - raw[..., d]) % spatial[d])
                            for d in range(nd)], dim=-1)
        return locs, in_half

    def read(locs):
        """Weighted spectrum at the points; an exact zero reads as +0
        (JAX's ``canon_zero``: the phase of -0 would be pi)."""
        idx = (bi, ci) + tuple(locs[..., d] for d in range(nd))
        r, i = re[idx], im[idx]
        if parts:
            wa = _weight_of(parts, tuple(locs[..., d] for d in range(nd)), (B, 1))
            r, i = r * wa, i * wa
        both0 = (r == 0) & (i == 0)
        return torch.where(both0, zero, r), torch.where(both0, zero, i)

    def delta(r, i, locs, in_half, mag, gates):
        """``H[c] += (w - k[s]) * scale``: ``k[s]`` is the read, conjugated
        for a mirrored point; ``w`` has magnitude ``mag`` and the phase of
        ``k[s]``; scale 1 on the self-mirrored last-axis bins (0 and n/2),
        else 1/2; the delta is conjugated back for a mirrored point."""
        old_re, old_im = r, torch.where(in_half, i, -i)
        ang = torch.atan2(old_im, old_re)
        new_re, new_im = mag * torch.cos(ang), mag * torch.sin(ang)
        z_self = (locs[..., -1] == 0) | (2 * locs[..., -1] == spatial[-1])
        scale = torch.where(z_self, one, 0.5 * one)
        d_re = (new_re - old_re) * scale
        d_im = (new_im - old_im) * scale
        d_im = torch.where(in_half, d_im, -d_im)
        return torch.where(gates, d_re, zero), torch.where(gates, d_im, zero)

    out = []
    spike = None
    if cfg.spike:
        draws.require("spike_shifted", "spike_vals", "spike_gates")
        sh = draws.spike_shifted.long()
        locs, in_half = canon(to_raw(sh))
        mag = torch.exp(draws.spike_vals.to(f32)) * wrap_at(sh)
        d_re, d_im = delta(*read(locs), locs, in_half, mag, draws.spike_gates)
        spike = (locs, d_re, d_im)
        out.append(spike)
    if cfg.plane_axes is not None:
        draws.require("plane_shifted", "plane_gate")
        sh = draws.plane_shifted.long()[:, None, :].expand(B, C, nd)
        locs, in_half = canon(to_raw(sh))
        mag = torch.exp(torch.tensor(cfg.plane_intensity, dtype=f32, device=dev))
        mag = mag * wrap_at(sh)
        r, i = read(locs)
        if spike is not None:
            coll = (locs == spike[0]).all(dim=-1)
            r = r + torch.where(coll, spike[1], zero)
            i = i + torch.where(coll, spike[2], zero)
        gates = draws.plane_gate[:, None].expand(B, C)
        out.append((locs, *delta(r, i, locs, in_half, mag, gates)))
    return out


def stylize_batch(x: torch.Tensor, cfg: StylizeConfig,
                  draws: Optional[StageDraws] = None,
                  generator: Optional[torch.Generator] = None,
                  device: DeviceLike = None) -> torch.Tensor:
    """Apply the configured corruption stack to a ``(B, C, *spatial)`` batch.

    ``draws`` fixes every random parameter; without it they are drawn with
    :func:`sample_draws` from ``generator``. ``device=None`` means
    ``"cuda"``; ``x`` and ``draws`` are moved there.
    """
    dev = resolve_device(device)
    nd = cfg.n_dims
    if nd != 3:
        raise NotImplementedError(f"n_dims={nd} (2D stylization): " + _TODO_FUSED)
    x = x.to(dev)
    if x.ndim != nd + 2:
        raise ValueError(
            f"expected (B, C, *spatial) with {nd} spatial dims, got {tuple(x.shape)}")
    if not cfg.any_enabled:
        return x
    spatial = tuple(x.shape[2:])
    backend = _resolve_backend(cfg.fft_backend, spatial, dev)
    if backend in ("plane", "plane_fast"):
        from mvtb_tpu_torch.ops import fused_plane

        if fused_plane.plane_kernel_eligible(cfg, spatial):
            if draws is None:
                draws = sample_draws(cfg, spatial, x.shape[0], x.shape[1],
                                     generator=generator, device=dev)
            return fused_plane.stylize_kspace_plane(x, cfg, draws.to(dev))
        backend = "dft_fast" if backend == "plane_fast" else "dft"
    _check_general(cfg, spatial, backend)
    if draws is None:
        draws = sample_draws(cfg, spatial, x.shape[0], x.shape[1],
                             generator=generator, device=dev)
    return _stylize_general(x, cfg, draws.to(dev), backend)


def stylize_kspace(x: torch.Tensor, cfg: StylizeConfig,
                   draws: Optional[StageDraws] = None,
                   generator: Optional[torch.Generator] = None,
                   device: DeviceLike = None) -> torch.Tensor:
    """One channel-first ``(C, *spatial)`` volume: :func:`stylize_batch` with
    B = 1 (``draws``, if given, are batched with B = 1)."""
    return stylize_batch(x[None], cfg, draws=draws, generator=generator,
                         device=device)[0]
