"""Fused k-space stylization (counterpart of mvtb_tpu/ops/fused.py).

The JAX package draws every random stage parameter from a threefry key
(``stage_keys``), which torch cannot replay. The port separates the draws
from the arithmetic instead: :class:`StageDraws` holds the raw per-sample
draws, :func:`sample_draws` makes them from a ``torch.Generator``, and
:func:`stylize_batch` takes either. Handing the same draws to both packages
makes their outputs comparable element by element.

Only the plane backends are ported so far (``fft_backend="plane"`` and
``"plane_fast"`` with a plane-eligible config); they run the fused plane
kernel of :mod:`mvtb_tpu_torch.ops.fused_plane`. Every other backend or
config raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.ops.masks import shell_flat_indices

ParamSpec = Union[float, Tuple[float, float]]  # fixed value or U[lo,hi] range

# Where each not-yet-ported path is queued (ROADMAP.md, section 1).
_TODO_FUSED = "ROADMAP.md section 1, item 2 (fused stylization, pure-torch path)"


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


def _check_ported(cfg: StylizeConfig, spatial) -> None:
    from mvtb_tpu_torch.ops.fused_plane import plane_kernel_eligible

    if cfg.fft_backend not in ("plane", "plane_fast"):
        raise NotImplementedError(
            f"fft_backend={cfg.fft_backend!r}: only 'plane' and 'plane_fast' "
            f"are ported; the rest is {_TODO_FUSED}, and 'dft_pallas' also "
            "waits for ROADMAP.md section 2, items 2-4")
    if not plane_kernel_eligible(cfg, spatial):
        raise NotImplementedError(
            "this config is not plane-kernel eligible (2D, zero-fill, "
            "data-dependent spike range, no k-space stage or an axis over "
            f"the matmul-DFT bound); its path is {_TODO_FUSED}")


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
    x = x.to(dev)
    nd = cfg.n_dims
    if x.ndim != nd + 2:
        raise ValueError(
            f"expected (B, C, *spatial) with {nd} spatial dims, got {tuple(x.shape)}")
    if not cfg.any_enabled:
        return x
    spatial = tuple(x.shape[2:])
    _check_ported(cfg, spatial)
    if draws is None:
        draws = sample_draws(cfg, spatial, x.shape[0], x.shape[1],
                             generator=generator, device=dev)
    from mvtb_tpu_torch.ops.fused_plane import stylize_kspace_plane

    return stylize_kspace_plane(x, cfg, draws.to(dev))


def stylize_kspace(x: torch.Tensor, cfg: StylizeConfig,
                   draws: Optional[StageDraws] = None,
                   generator: Optional[torch.Generator] = None,
                   device: DeviceLike = None) -> torch.Tensor:
    """One channel-first ``(C, *spatial)`` volume: :func:`stylize_batch` with
    B = 1 (``draws``, if given, are batched with B = 1)."""
    return stylize_batch(x[None], cfg, draws=draws, generator=generator,
                         device=device)[0]
