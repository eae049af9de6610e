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
* everything else runs the general path, batched over B with per-sample
  parameters broadcast, on ``(B, C, *spatial)`` with ``n_dims`` 2 or 3
  spatial axes: the forward transform over the spatial axes -> the
  multiplicative weights (Gibbs, disk, wrap) -> random zero-fill -> the
  spike and plane-wave point writes (spike range explicit or from the
  spectrum's log-magnitude mean) -> the inverse -> image-domain salt &
  pepper. Every k-space config runs on the rfft half spectrum (half axis
  LAST), whose Hermitian representation is the realified state; the
  complex full-spectrum path stays behind the :func:`_rfft_eligible` seam.
  Its backends are ``"dft"`` / ``"dft_fast"`` (:mod:`.dft` on
  ``torch.matmul``), ``"dft_pallas"`` (the hand-written axis kernels of
  :mod:`.pallas_dft`, at their bf16x3 ``"high"`` tier, as the JAX package
  runs them), ``"hybrid"`` (``torch.fft`` on 2/3/5-smooth axes, the matmul
  DFT on the rest) and ``"xla"`` (``torch.fft``); ``"auto"`` picks
  ``"dft"`` on a CUDA device and ``"xla"`` on the CPU.

The point writes run in the JAX package's sequential form (each write reads
the spectrum the stages before it left); without zero-fill the JAX package
fuses them into one pass, which computes the same values.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.ops import dft as _dft
from mvtb_tpu_torch.ops.corruptions import sap_select
from mvtb_tpu_torch.ops.masks import shell_flat_indices

ParamSpec = Union[float, Tuple[float, float]]  # fixed value or U[lo,hi] range

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


def _rfft_eligible(cfg: StylizeConfig, spatial) -> bool:
    """True when the k-space part runs on the rfft half spectrum: every
    k-space stage does. The JAX package's seam of the same name: tests patch
    it to False to drive the complex full-spectrum path. Keep it a
    module-level function."""
    del spatial
    return cfg.kspace_needed


def _stored_grid(spatial, use_rfft: bool) -> Tuple[int, ...]:
    """The spectrum's stored shape: the half grid (last axis n//2 + 1) on
    the rfft path, the full grid on the complex one."""
    spatial = tuple(int(n) for n in spatial)
    return spatial[:-1] + (spatial[-1] // 2 + 1,) if use_rfft else spatial


@dataclasses.dataclass
class StageDraws:
    """The raw per-sample random draws of one stylize call, batched over B.

    A field is None when its stage is off. Shapes (B samples, C channels,
    nd spatial axes):

    * ``gibbs_alpha``, ``disk_r``, ``wrap_alpha``, ``sap_p``: (B,) float32;
    * ``gibbs_gate``, ``disk_gate``, ``wrap_gate``, ``zf_gate``,
      ``plane_gate``, ``sap_gate``: (B,) bool;
    * ``zf_u``: (B, C, *grid) float32 uniforms of zero-fill on the stored
      grid (the half grid on the rfft path); ``zf_u2``: the second field of
      the half grid's off-grid mirrors (None on the complex path);
    * ``spike_shifted``: (B, C, nd) int, fftshifted-space spike locations;
      ``spike_u``: (B, C) float32 uniforms of the spike's log-magnitude in
      its range (explicit, or from the spectrum); ``spike_gates``: (B, C)
      bool;
    * ``plane_shifted``: (B, nd) int, shifted-space location on the shell
      (in 2D the ellipse of the first two semi-axes, as in the JAX package);
    * ``sap_u``: (B, C, *spatial) float32 uniforms of salt & pepper.
    """

    gibbs_alpha: Optional[torch.Tensor] = None
    gibbs_gate: Optional[torch.Tensor] = None
    disk_r: Optional[torch.Tensor] = None
    disk_gate: Optional[torch.Tensor] = None
    wrap_alpha: Optional[torch.Tensor] = None
    wrap_gate: Optional[torch.Tensor] = None
    zf_u: Optional[torch.Tensor] = None
    zf_u2: Optional[torch.Tensor] = None
    zf_gate: Optional[torch.Tensor] = None
    spike_shifted: Optional[torch.Tensor] = None
    spike_u: Optional[torch.Tensor] = None
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

    def rows(self, rows: slice) -> "StageDraws":
        """The draws of the samples ``rows`` (every field leads with B)."""
        return StageDraws(**{
            f.name: (None if getattr(self, f.name) is None
                     else getattr(self, f.name)[rows])
            for f in dataclasses.fields(self)})

    def require(self, *names: str) -> None:
        missing = [n for n in names if getattr(self, n) is None]
        if missing:
            raise ValueError(f"StageDraws lacks {missing} for this config")


# An export input: a stylize exports as ``fn(x, draws)`` with the draws as
# tensor inputs (the counterpart of JAX's key data); None fields stay None.
torch.export.register_dataclass(
    StageDraws, serialized_type_name="mvtb_tpu_torch.ops.fused.StageDraws")


def sample_draws(cfg: StylizeConfig, spatial, B: int, C: int,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None) -> StageDraws:
    """Draw every random stage parameter for a (B, C, *spatial) batch.

    The distributions are the JAX package's (uniform parameters, Bernoulli
    gates, uniform spike locations, a uniform pick on the ellipsoid shell,
    uniform zero-fill fields on the stored grid); the numbers differ, since
    the generator differs. ``generator`` must live on ``device``; None uses
    PyTorch's default generator there.
    """
    dev = resolve_device(device)
    spatial = tuple(int(n) for n in spatial)
    nd = len(spatial)

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
    if cfg.zf_p is not None:
        use_rfft = _rfft_eligible(cfg, spatial)
        field = (B, C) + _stored_grid(spatial, use_rfft)
        d.zf_u = uniform(field)
        d.zf_u2 = uniform(field) if use_rfft else None
        d.zf_gate = gate(cfg.zf_prob)
    if cfg.spike:
        width = C if cfg.spike_channel_wise else 1
        locs = torch.stack([
            torch.randint(0, n, (B, width), generator=generator, device=dev)
            for n in spatial], dim=-1)
        u = uniform((B, width))
        gates = (uniform((B, width)) < cfg.spike_prob if cfg.spike_channel_wise
                 else gate(cfg.spike_prob)[:, None])
        d.spike_shifted = locs.expand(B, C, nd)
        d.spike_u = u.expand(B, C)
        d.spike_gates = gates.expand(B, C)
    if cfg.plane_axes is not None:
        flat = torch.from_numpy(
            shell_flat_indices(spatial, *map(float, cfg.plane_axes))).to(dev)
        if flat.numel() == 0:
            raise ValueError(f"the plane-wave shell {cfg.plane_axes} holds no "
                             f"point of the {spatial} grid")
        pick = torch.randint(0, flat.numel(), (B,), generator=generator,
                             device=dev)
        d.plane_shifted = torch.stack(
            torch.unravel_index(flat[pick], spatial), dim=-1)
        d.plane_gate = gate(cfg.plane_prob)
    if cfg.sap_p is not None:
        d.sap_p, d.sap_gate = param(cfg.sap_p), gate(cfg.sap_prob)
        d.sap_u = uniform((B, C) + spatial)
    return d


def spike_log_values(cfg: StylizeConfig, draws: StageDraws,
                     means: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, C) float32 spike log-magnitudes ``lo + (hi - lo) * u``: the range
    is ``cfg.spike_range``, or ``0.95 * means`` to ``1.10 * means`` for the
    data-dependent default (``means`` the (B, C) log-magnitude means of the
    weighted spectrum). The same float32 arithmetic as the JAX package."""
    draws.require("spike_u")
    u = draws.spike_u.to(torch.float32)
    if cfg.spike_range is None:
        if means is None:
            raise ValueError("the data-dependent spike range needs the spectrum's means")
        lo, hi = means * 0.95, means * 1.10
    else:
        lo, hi = (torch.tensor(v, dtype=torch.float32, device=u.device)
                  for v in cfg.spike_range)
    return lo + (hi - lo) * u


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


def _pair(k: torch.Tensor):
    return k.real.contiguous(), k.imag.contiguous()


def _forward(x: torch.Tensor, backend: str, nd: int, use_rfft: bool):
    """(re, im) of ``rfftn`` (half axis last) or ``fftn`` over the ``nd``
    spatial axes of a (B, C, *spatial) batch."""
    axes = tuple(range(2, 2 + nd))
    if backend == "xla":
        f = torch.fft.rfftn if use_rfft else torch.fft.fftn
        return _pair(f(x.to(torch.float32), dim=axes))
    if backend == "hybrid":
        f = _dft.hybrid_rdft_nd if use_rfft else _dft.hybrid_dft_nd
        return _pair(f(x, axes))
    if backend == "dft_pallas":
        from mvtb_tpu_torch.ops import pallas_dft as _pdft

        if use_rfft:
            return _pdft.rdft_nd_pair(x, axes, "high")
        return _pair(_pdft.dft_nd(x, axes, "high"))
    precision = "default" if backend == "dft_fast" else "highest"
    if use_rfft:
        return _dft.rdft_nd_pair(x, axes, precision)
    return _pair(_dft.dft_nd(x, axes, precision))


def _inverse(re: torch.Tensor, im: torch.Tensor, spatial, backend: str,
             use_rfft: bool):
    """The real volume back from the (re, im) spectrum: ``irfftn`` of the
    half spectrum, or the real part of ``ifftn`` of the full one."""
    axes = tuple(range(2, 2 + len(spatial)))
    if backend == "xla":
        k = torch.complex(re, im)
        if use_rfft:
            return torch.fft.irfftn(k, s=spatial, dim=axes)
        return torch.fft.ifftn(k, dim=axes).real
    if backend == "hybrid":
        k = torch.complex(re, im)
        if use_rfft:
            return _dft.hybrid_irdft_nd_real(k, spatial, axes)
        return _dft.hybrid_idft_nd_real(k, axes)
    if backend == "dft_pallas":
        from mvtb_tpu_torch.ops import pallas_dft as _pdft

        if use_rfft:
            return _pdft.irdft_nd_real_pair(re, im, spatial, axes, "high")
        return _pdft.idft_nd_real(torch.complex(re, im), axes, "high")
    precision = "default" if backend == "dft_fast" else "highest"
    if use_rfft:
        return _dft.irdft_nd_real_pair(re, im, spatial, axes, precision)
    return _dft.idft_nd_real(torch.complex(re, im), axes, precision)


def _weight_parts(cfg: StylizeConfig, spatial, draws: StageDraws, sym: bool):
    """The multiplicative weight stages as callables ``part(idx, view)``:
    ``idx`` holds per-axis integer index tensors (a broadcast grid) and
    ``view`` the shape that broadcasts a (B,) parameter against them. The
    same float32 arithmetic in the same order as the JAX package's
    ``gibbs_part`` / ``disk_part`` / ``wrap_part``. ``sym`` (the half
    spectrum) gives the Gibbs mask its even-axis mirror average. Returns
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
        sym = sym and any(d != 0 for d in deltas)

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


def zero_fill_weight(zf_u: torch.Tensor, zf_u2: Optional[torch.Tensor],
                     p: float, spatial) -> torch.Tensor:
    """The zero-fill stage's multiplicative weight on the stored grid (ungated),
    from the stage's uniform fields.

    Complex path (``zf_u2`` None): ``keep = u > p``. Half spectrum: the
    realified full-grid weight at a conjugate pair is ``(b_i + b_{-i}) / 2``
    with iid Bernoulli keeps. Interior bins pair with an off-grid mirror,
    whose keep is the second field; bins whose last index is self-mirrored
    (0, and n/2 for even n) pair within the slab at the other axes' mirrored
    position, ``roll(flip(b, ax), 1, ax)`` over every other spatial axis
    (the index-space form of the Gibbs mask's offset mirror); a fully
    self-paired point degenerates to its single draw."""
    f32 = torch.float32
    b1 = (zf_u > p).to(f32)
    if zf_u2 is None:
        return b1
    b2 = (zf_u2 > p).to(f32)
    nd = len(spatial)
    b1m = b1
    for ax in range(b1.ndim - nd, b1.ndim - 1):
        b1m = torch.roll(torch.flip(b1m, (ax,)), 1, ax)
    n_last = int(spatial[-1])
    h = torch.arange(b1.shape[-1], device=b1.device)
    h_self = (h == 0) | ((n_last % 2 == 0) & (h == n_last // 2))
    return torch.where(h_self, (b1 + b1m) * 0.5, (b1 + b2) * 0.5)


def _log_magnitude_means(re: torch.Tensor, im: torch.Tensor, spatial,
                         use_rfft: bool) -> torch.Tensor:
    """(B, C) means over the full grid of ``log(|k| + 1e-10)``. From the half
    spectrum, interior last-axis bins stand for two points of the full grid
    (|k| at a point equals |k| at its mirror): weights 1, 2, ..., 2, 1 (the
    last 1 only for even n), over the full grid's size."""
    axes = tuple(range(2, re.ndim))
    logmag = torch.log(torch.hypot(re, im) + 1e-10)
    if not use_rfft:
        return logmag.mean(dim=axes)
    w_last = torch.full((re.shape[-1],), 2.0, dtype=torch.float32, device=re.device)
    w_last[0] = 1.0
    if spatial[-1] % 2 == 0:
        w_last[-1] = 1.0
    return (logmag * w_last).sum(dim=axes) / float(math.prod(spatial))


def _point_update(re: torch.Tensor, im: torch.Tensor, spatial, use_rfft: bool,
                  raw: torch.Tensor, mag: torch.Tensor, gates: torch.Tensor):
    """Set ``|k|`` to ``mag`` (keeping its phase) at the (B, C, nd) raw
    full-grid points ``raw`` where the (B, C) ``gates`` allow: the JAX
    package's sequential ``point_update``.

    Each point is read from the spectrum as it stands, an exact zero read as
    +0 (the JAX read is a masked sum, whose +0 filler folds -0, whose phase
    would be pi). Complex path: a select write (set semantics). Half
    spectrum: the realified write ``H[c] += (w - k[s]) * scale`` at the
    point's canonical half-grid representative ``c`` (a point in the dropped
    half mirrors through ``-s mod n``, its read and delta conjugated), scale
    1 on the self-mirrored last-axis bins (0 and n/2), else 1/2."""
    B, C = re.shape[:2]
    nd = len(spatial)
    dev = re.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    if use_rfft:
        in_half = raw[..., -1] < spatial[-1] // 2 + 1
        locs = torch.stack([torch.where(in_half, raw[..., d],
                                        (spatial[d] - raw[..., d]) % spatial[d])
                            for d in range(nd)], dim=-1)
    else:
        locs = raw
    idx = ((torch.arange(B, device=dev)[:, None], torch.arange(C, device=dev)[None, :])
           + tuple(locs[..., d] for d in range(nd)))
    r, i = re[idx], im[idx]
    both0 = (r == 0) & (i == 0)
    r, i = torch.where(both0, zero, r), torch.where(both0, zero, i)
    if not use_rfft:
        ang = torch.atan2(i, r)
        new_re = torch.where(gates, mag * torch.cos(ang), re[idx])
        new_im = torch.where(gates, mag * torch.sin(ang), im[idx])
        return re.index_put(idx, new_re), im.index_put(idx, new_im)
    old_im = torch.where(in_half, i, -i)
    ang = torch.atan2(old_im, r)
    z_self = (locs[..., -1] == 0) | (2 * locs[..., -1] == spatial[-1])
    scale = torch.where(z_self, one, 0.5 * one)
    d_re = (mag * torch.cos(ang) - r) * scale
    d_im = (mag * torch.sin(ang) - old_im) * scale
    d_im = torch.where(in_half, d_im, -d_im)
    d_re, d_im = torch.where(gates, d_re, zero), torch.where(gates, d_im, zero)
    return (re.index_put(idx, d_re, accumulate=True),
            im.index_put(idx, d_im, accumulate=True))


def _stylize_general(x: torch.Tensor, cfg: StylizeConfig, draws: StageDraws,
                     backend: str) -> torch.Tensor:
    """The general path of ``stylize_kspace`` on a (B, C, *spatial) batch
    (JAX: mvtb_tpu/ops/fused.py, the rfft and complex branches)."""
    B, C = x.shape[:2]
    spatial = tuple(int(n) for n in x.shape[2:])
    nd = len(spatial)
    dev = x.device
    f32 = torch.float32
    out = x
    if cfg.kspace_needed:
        use_rfft = _rfft_eligible(cfg, spatial)
        re, im = _forward(x, backend, nd, use_rfft)
        grid = _stored_grid(spatial, use_rfft)
        parts, wrap_val = _weight_parts(cfg, spatial, draws, sym=use_rfft)
        if parts:
            iotas = tuple(torch.arange(n, device=dev).view(
                tuple(n if a == d else 1 for a in range(nd)))
                for d, n in enumerate(grid))
            w = _weight_of(parts, iotas, (B,) + (1,) * nd)
            w = w.expand((B,) + grid)[:, None]
            re, im = re * w, im * w
        if cfg.zf_p is not None:
            draws.require("zf_u", "zf_gate")
            if use_rfft:
                draws.require("zf_u2")
            w_zf = zero_fill_weight(draws.zf_u, draws.zf_u2 if use_rfft else None,
                                    cfg.zf_p, spatial)
            gate = draws.zf_gate.view((B,) + (1,) * (nd + 1))
            w_zf = torch.where(gate, w_zf, torch.ones((), dtype=f32, device=dev))
            re, im = re * w_zf, im * w_zf

        one = torch.ones((), dtype=f32, device=dev)

        def wrap_at(shifted):  # (B, C, nd) shifted-space points
            f = one
            if wrap_val is None:
                return f
            for d in range(nd):
                f = f * torch.where(shifted[..., d] % 2 == 1, wrap_val[:, None], one)
            return f

        def to_raw(shifted):
            return torch.stack([_to_raw_index(shifted[..., d], spatial[d])
                                for d in range(nd)], dim=-1)

        if cfg.spike:
            draws.require("spike_shifted", "spike_u", "spike_gates")
            means = (_log_magnitude_means(re, im, spatial, use_rfft)
                     if cfg.spike_range is None else None)
            sh = draws.spike_shifted.long()
            mag = torch.exp(spike_log_values(cfg, draws, means)) * wrap_at(sh)
            re, im = _point_update(re, im, spatial, use_rfft, to_raw(sh), mag,
                                   draws.spike_gates)
        if cfg.plane_axes is not None:
            draws.require("plane_shifted", "plane_gate")
            sh = draws.plane_shifted.long()[:, None, :].expand(B, C, nd)
            mag = torch.exp(torch.tensor(cfg.plane_intensity, dtype=f32, device=dev))
            re, im = _point_update(re, im, spatial, use_rfft, to_raw(sh),
                                   mag * wrap_at(sh),
                                   draws.plane_gate[:, None].expand(B, C))
        out = _inverse(re, im, spatial, backend, use_rfft).to(x.dtype)
    if cfg.sap_p is not None:
        out = _salt_and_pepper(out, draws)
    return out


def stylize_batch(x: torch.Tensor, cfg: StylizeConfig,
                  draws: Optional[StageDraws] = None,
                  generator: Optional[torch.Generator] = None,
                  device: DeviceLike = None) -> torch.Tensor:
    """Apply the configured corruption stack to a ``(B, C, *spatial)`` batch,
    ``len(spatial) == cfg.n_dims``.

    ``draws`` fixes every random parameter; without it they are drawn with
    :func:`sample_draws` from ``generator``. ``device=None`` means
    ``"cuda"``; ``x`` and ``draws`` are moved there.
    """
    dev = resolve_device(device)
    nd = cfg.n_dims
    x = x.to(dev)
    if x.ndim != nd + 2:
        raise ValueError(
            f"expected (B, C, *spatial) with {nd} spatial dims, got {tuple(x.shape)}")
    if not cfg.any_enabled:
        return x
    spatial = tuple(x.shape[2:])
    backend = _resolve_backend(cfg.fft_backend, spatial, dev)
    if draws is None:
        draws = sample_draws(cfg, spatial, x.shape[0], x.shape[1],
                             generator=generator, device=dev)
    draws = draws.to(dev)
    if backend in ("plane", "plane_fast"):
        from mvtb_tpu_torch.ops import fused_plane

        if fused_plane.plane_kernel_eligible(cfg, spatial):
            return fused_plane.stylize_kspace_plane(x, cfg, draws)
        backend = "dft_fast" if backend == "plane_fast" else "dft"
    return _stylize_general(x, cfg, draws, backend)


def stylize_kspace(x: torch.Tensor, cfg: StylizeConfig,
                   draws: Optional[StageDraws] = None,
                   generator: Optional[torch.Generator] = None,
                   device: DeviceLike = None) -> torch.Tensor:
    """One channel-first ``(C, *spatial)`` volume: :func:`stylize_batch` with
    B = 1 (``draws``, if given, are batched with B = 1)."""
    return stylize_batch(x[None], cfg, draws=draws, generator=generator,
                         device=device)[0]
