"""The fused plane kernel: the whole k-space stack per (W, D) plane
(counterpart of mvtb_tpu/ops/fused_plane.py).

For each (channel, half-H) plane of the H-axis half spectrum the kernel runs

    forward DFT over W -> forward DFT over D -> multiplicative k-space
    weights (Gibbs / disk / wraparound) -> spike & plane-wave point writes
    -> inverse DFT over D -> inverse DFT over W

with Gauss's 3-product complex contraction against the matrices of
:mod:`mvtb_tpu_torch.ops.dft`. :func:`plane_stylize_half` calls the custom
op ``mvtb::fused_plane`` (:mod:`._ops`), which ``torch.export`` traces: on a
CUDA tensor it launches the CUDA kernel (``csrc/fused_plane.cu``,
:func:`launch`) or raises; on a CPU tensor it runs
:func:`plane_stylize_half_plain`, the same function in plain PyTorch.

Precision tiers, the TPU kernel's own: ``fast=False`` (``fft_backend="plane"``)
is bf16x3: every operand x splits into bfloat16 ``hi = bf16(x)`` and
``lo = bf16(x - hi)`` (:func:`.dft.split_bf16`, the JAX package's ``_split_bf16``)
and each product is ``hi.hi + hi.lo + lo.hi`` with float32 accumulation;
``fast=True`` (``"plane_fast"``) rounds every operand to bfloat16 once and
accumulates in float32. The plain version computes the same products
(exact in float32) with float32 ``torch.matmul``; the kernel runs them on
the tensor cores.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Tuple

import torch

from mvtb_tpu_torch.ops import dft as _dft
from mvtb_tpu_torch.ops.dft import split_bf16  # noqa: F401  (the plane tiers' split, re-exported)
from mvtb_tpu_torch.ops.fused import (StageDraws, StylizeConfig, _off_of,
                                      _salt_and_pepper, _to_raw_index,
                                      spike_log_values)
from mvtb_tpu_torch.utils.profiling import count, span

# Bits of the kernel's ``flags`` argument (csrc/fused_plane.cu).
_F_GIBBS, _F_GIBBS_SYM, _F_DISK, _F_INSIDE_OFF, _F_WRAP = 1, 2, 4, 8, 16


def plane_kernel_eligible(cfg: StylizeConfig, spatial) -> bool:
    """True when :func:`stylize_kspace_plane` implements ``cfg`` exactly:
    3D, some k-space stage, no zero-fill (a dense random field between the
    weights and the writes), spikes only with an explicit range (the
    data-dependent default needs a global reduction), and every axis within
    the matmul-DFT bound. The kernel streams its plane through device
    memory, so unlike the TPU kernel it has no on-chip size limit."""
    if len(spatial) != 3 or not cfg.kspace_needed:
        return False
    if cfg.zf_p is not None:
        return False
    if cfg.spike and cfg.spike_range is None:
        return False
    return max(spatial) <= _dft.MATMUL_DFT_MAX_N


# --------------------------------------------------------------------------
# Index helpers: the same integer maps as the JAX kernel's _mirror_off and
# _shifted (its _off is fused._off_of).
# --------------------------------------------------------------------------

def _mirror_off(off: torch.Tensor, n: int) -> torch.Tensor:
    """Conjugate mirror of a raw offset: ``-off``, except the self-mirrored
    Nyquist offset ``-n/2`` of an even axis."""
    if n % 2 == 0:
        return torch.where(off == -(n // 2), off, -off)
    return -off


def _shifted(i: torch.Tensor, n: int) -> torch.Tensor:
    """fftshifted index of raw index ``i``."""
    c = n // 2
    return torch.where(i < n - c, i + c, i + c - n)


# --------------------------------------------------------------------------
# Matrices
# --------------------------------------------------------------------------

def _tier_values(t: torch.Tensor, fast: bool) -> Tuple[torch.Tensor, ...]:
    """:func:`.dft.tier_parts` as float32 values (their products are exact)."""
    return tuple(p.to(torch.float32) for p in _dft.tier_parts(t, fast))


def _gauss_mats(n: int, inverse: bool):
    """(cos, cos+sin, sin-cos) float32, the kernel's term order."""
    cos, smc, cps = _dft._gauss_dft_matrices_np(n, inverse)
    return cos, cps, smc


# The plane's four contractions: (axis length, inverse) for W fwd, D fwd,
# W inv, D inv, the kernel's section order.
def _sections(W: int, D: int):
    return ((W, False), (D, False), (W, True), (D, True))


@lru_cache(maxsize=16)
def _plane_mats(W: int, D: int, fast: bool, device: torch.device):
    """The plain version's matrices: for each section the three Gauss
    matrices, each as its tier's float32-valued parts (see
    :func:`_tier_values`)."""
    return [tuple(_tier_values(torch.from_numpy(m).to(device), fast)
                  for m in _gauss_mats(n, inverse))
            for n, inverse in _sections(W, D)]


# Tile sizes of csrc/fused_plane.cu: rows of a W-contraction tile, columns
# of a D-contraction tile, and the depth of one stage.
_TILE_M, _TILE_N, _TILE_K = 128, 160, 16


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@lru_cache(maxsize=16)
def _kernel_mats(W: int, D: int, fast: bool, device: torch.device) -> torch.Tensor:
    """The kernel's matrices, pre-lowered for its tier and laid out as its
    wgmma descriptors read them, packed flat in bf16. Per section
    (:func:`_sections`), per term (cos, cos+sin, sin-cos), per part (bf16;
    or hi, lo): the matrix zero-padded to (Rp, Kp) rows x depth (Rp a
    multiple of the section's tile rows, Kp of 16), in 16-deep chunks, each
    chunk a K-major grid of 8 x 8 core matrices ([Kp/16][Rp/8][2][8][8]).
    The matrices are symmetric, so rows may index either axis."""
    flat = []
    for (n, inverse), rows in zip(_sections(W, D), (_TILE_M, _TILE_N) * 2):
        Rp, Kp = _round_up(n, rows), _round_up(n, _TILE_K)
        for m in _gauss_mats(n, inverse):
            for part in _dft.tier_parts(torch.from_numpy(m), fast):
                full = torch.zeros((Rp, Kp), dtype=torch.bfloat16)
                full[:n, :n] = part
                tiles = full.view(Rp // 8, 8, Kp // 16, 2, 8).permute(2, 0, 3, 1, 4)
                flat.append(tiles.reshape(-1))
    return torch.cat(flat).to(device)


# --------------------------------------------------------------------------
# Plain version
# --------------------------------------------------------------------------

def _plane_weight(spatial, flags, wparams: torch.Tensor, Hh: int) -> torch.Tensor:
    """The multiplicative weight on the (N, Hh, W, D) half grid: the JAX
    kernel's ``weight_of`` with the same float32 formulas in the same order
    (gibbs, disk, wrap; factors multiplied left to right)."""
    H, W, D = spatial
    has_gibbs, gibbs_sym, has_disk, inside_off, has_wrap = flags[:5]
    dev = wparams.device
    ih = torch.arange(Hh, device=dev).view(Hh, 1, 1)
    iw = torch.arange(W, device=dev).view(1, W, 1)
    idd = torch.arange(D, device=dev).view(1, 1, D)
    offs = [_off_of(ih, H), _off_of(iw, W), _off_of(idd, D)]
    offs_f = [o.to(torch.float32) for o in offs]
    wp = [wparams[:, j].view(-1, 1, 1, 1) for j in range(5)]
    w = None

    def mul(w, f):
        return f if w is None else w * f

    if has_gibbs:
        gd = [(n - 1) / 2 - n // 2 for n in spatial]
        d2 = ((offs_f[0] - gd[0]) ** 2 + (offs_f[1] - gd[1]) ** 2
              + (offs_f[2] - gd[2]) ** 2)
        m = (d2 <= wp[0]).to(torch.float32)
        if gibbs_sym:
            mo = [_mirror_off(o, n).to(torch.float32)
                  for o, n in zip(offs, spatial)]
            d2m = ((mo[0] - gd[0]) ** 2 + (mo[1] - gd[1]) ** 2
                   + (mo[2] - gd[2]) ** 2)
            m = (m + (d2m <= wp[0]).to(torch.float32)) * 0.5
        w = mul(w, wp[1] * m + (1.0 - wp[1]))
    if has_disk:
        d2 = offs_f[0] ** 2 + offs_f[1] ** 2 + offs_f[2] ** 2
        inside = d2 < wp[2]
        m = (~inside if inside_off else inside).to(torch.float32)
        w = mul(w, wp[3] * m + (1.0 - wp[3]))
    if has_wrap:
        one = torch.ones((), device=dev)
        for off, n in zip(offs, spatial):
            sh = _shifted(off + torch.where(off < 0, n, 0), n)
            w = mul(w, torch.where(sh % 2 == 1, wp[4], one))
    return w


def _point_writes(re, im, locs, vals, gates, conjs, scales) -> None:
    """Sequential masked polar writes (spike, then plane), in place.

    The read canonicalizes a signed zero to +0, as the kernel's masked-sum
    read does; the write adds the delta to the raw value."""
    N = re.shape[0]
    rows = torch.arange(N, device=re.device)
    for s in range(locs.shape[0]):
        idx = (rows,) + tuple(locs[s, :, d].long() for d in range(3))
        raw_re, raw_im = re[idx], im[idx]
        p_re = torch.where(raw_re == 0, torch.zeros_like(raw_re), raw_re)
        p_im = torch.where(raw_im == 0, torch.zeros_like(raw_im), raw_im)
        sgn = conjs[s]
        old_re, old_im = p_re, sgn * p_im
        r = torch.sqrt(old_re * old_re + old_im * old_im)
        pos = r > 0
        safe = torch.where(pos, r, torch.ones_like(r))
        cos_t = torch.where(pos, old_re / safe, torch.ones_like(r))
        sin_t = torch.where(pos, old_im / safe, torch.zeros_like(r))
        scale = scales[s] * gates[s]
        d_re = (vals[s] * cos_t - old_re) * scale
        d_im = (vals[s] * sin_t - old_im) * scale * sgn
        re[idx] = raw_re + d_re
        im[idx] = raw_im + d_im


def plane_stylize_half_plain(k_re, k_im, spatial, flags, wparams, locs, vals,
                             gates, conjs, scales, fast: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch version of :func:`plane_stylize_half` (same arguments)."""
    H, W, D = spatial
    Hh = k_re.shape[1]
    (wf, df, wi, di) = _plane_mats(W, D, fast, k_re.device)

    def gauss(m, re, im, mat_left):
        def mm(mat, dat):
            return torch.matmul(mat, dat) if mat_left else torch.matmul(dat, mat)

        def dot(mat, dat):  # the tier's product, in the JAX kernel's order
            if fast:
                return mm(mat[0], dat[0])
            return mm(mat[0], dat[0]) + mm(mat[0], dat[1]) + mm(mat[1], dat[0])

        terms = [_tier_values(t, fast) for t in (re + im, im, re)]
        k1, k2, k3 = (dot(mt, dt) for mt, dt in zip(m, terms))
        return k1 - k2, k1 + k3

    re, im = gauss(wf, k_re, k_im, True)  # mat @ plane: contract W
    re, im = gauss(df, re, im, False)  # plane @ mat: contract D
    if any(flags[:5]):
        w = _plane_weight(spatial, flags, wparams, Hh)
        re, im = re * w, im * w
    _point_writes(re, im, locs, vals, gates, conjs, scales)
    re, im = gauss(di, re, im, False)
    return gauss(wi, re, im, True)


def plane_stylize_half_exact(k_re, k_im, spatial, flags, wparams, locs, vals,
                             gates, conjs, scales):
    """The function of :func:`plane_stylize_half` in complex128 through
    ``torch.fft`` (the plain version's weights and point writes): the
    yardstick of both tiers' accuracy. Returns float64 (re, im)."""
    k = torch.fft.fft2(torch.complex(k_re.double(), k_im.double()))
    if any(flags[:5]):
        k = k * _plane_weight(spatial, flags, wparams, k_re.shape[1]).double()
    re, im = k.real.contiguous(), k.imag.contiguous()
    _point_writes(re, im, locs, vals, gates, conjs, scales)
    out = torch.fft.ifft2(torch.complex(re, im))
    return out.real, out.imag


# --------------------------------------------------------------------------
# Kernel wrapper
# --------------------------------------------------------------------------

_LIB = {}


def _lib():
    if "fused_plane" not in _LIB:
        from mvtb_tpu_torch.ops import _build

        lib = _build.load("fused_plane")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mvtb_fused_plane.argtypes = [p] * 12 + [i] * 8 + [p]
        lib.mvtb_fused_plane.restype = i
        lib.mvtb_fused_plane_scratch_floats.argtypes = [i] * 4
        lib.mvtb_fused_plane_scratch_floats.restype = ctypes.c_longlong
        lib.mvtb_cuda_error_string.argtypes = [i]
        lib.mvtb_cuda_error_string.restype = ctypes.c_char_p
        _LIB["fused_plane"] = lib
    return _LIB["fused_plane"]


def _flag_bits(flags) -> int:
    has_gibbs, gibbs_sym, has_disk, inside_off, has_wrap = flags[:5]
    return ((_F_GIBBS if has_gibbs else 0) | (_F_GIBBS_SYM if gibbs_sym else 0)
            | (_F_DISK if has_disk else 0) | (_F_INSIDE_OFF if inside_off else 0)
            | (_F_WRAP if has_wrap else 0))


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def plane_stylize_half(k_re, k_im, spatial, flags, wparams, locs, vals, gates,
                       conjs, scales, fast: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the fused plane stack over an (N, Hh, W, D) half spectrum.

    ``N`` is batch x channel, ``Hh = H//2 + 1``; ``spatial = (H, W, D)``.
    ``flags`` is the static stage tuple (has_gibbs, gibbs_sym, has_disk,
    inside_off, has_wrap, has_spike, has_plane); ``wparams`` (N, 5) holds
    (gibbs r^2, gibbs gate, disk r^2, disk gate, gated wrap alpha);
    ``locs`` (S, N, 3) int32 canonical half-grid points and ``vals``,
    ``gates``, ``conjs``, ``scales`` (S, N) float32 describe the S point
    writes in stage order. Returns the (re, im) float32 planes.

    A thin call of the custom op ``mvtb::fused_plane`` (:mod:`._ops`): a
    CPU tensor runs :func:`plane_stylize_half_plain`; a CUDA tensor
    launches the kernel (:func:`launch`), which counts the launch in
    ``profiling.counters["launch.fused_plane"]``; any other device raises.
    """
    if k_re.device.type not in ("cpu", "cuda"):
        raise ValueError(f"plane_stylize_half: no kernel for {k_re.device}")
    from mvtb_tpu_torch.ops import _ops

    return _ops.fused_plane(k_re, k_im, [int(n) for n in spatial],
                            [bool(f) for f in flags], wparams, locs, vals, gates,
                            conjs, scales, bool(fast))


def launch(k_re, k_im, spatial, flags, wparams, locs, vals, gates, conjs,
           scales, fast: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel launch behind :func:`plane_stylize_half` on CUDA tensors
    (the CUDA implementation of ``mvtb::fused_plane``): checks every
    argument, allocates the outputs and the scratch, launches on the
    current stream and counts the launch. Raises on what the kernel does
    not take or on a failed launch."""
    H, W, D = (int(n) for n in spatial)
    N, Hh = k_re.shape[:2]
    S = locs.shape[0]
    dev = k_re.device
    if Hh != H // 2 + 1:
        raise ValueError(f"half axis {Hh} does not match H={H}")
    _check("k_re", k_re, torch.float32, (N, Hh, W, D), dev)
    _check("k_im", k_im, torch.float32, (N, Hh, W, D), dev)
    _check("wparams", wparams, torch.float32, (N, 5), dev)
    _check("locs", locs, torch.int32, (S, N, 3), dev)
    for name, t in (("vals", vals), ("gates", gates), ("conjs", conjs),
                    ("scales", scales)):
        _check(name, t, torch.float32, (S, N), dev)
    if max(W, D) > _dft.MATMUL_DFT_MAX_N:
        raise ValueError(f"plane {W}x{D} exceeds the matmul-DFT bound")
    lib = _lib()
    mats = _kernel_mats(W, D, bool(fast), dev)
    o_re, o_im = torch.empty_like(k_re), torch.empty_like(k_im)
    scratch = torch.empty(lib.mvtb_fused_plane_scratch_floats(N, Hh, W, D),
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mvtb_fused_plane(
            k_re.data_ptr(), k_im.data_ptr(), o_re.data_ptr(), o_im.data_ptr(),
            scratch.data_ptr(), mats.data_ptr(),
            wparams.data_ptr(), locs.data_ptr(), vals.data_ptr(),
            gates.data_ptr(), conjs.data_ptr(), scales.data_ptr(),
            N, Hh, H, W, D, S, _flag_bits(flags), int(bool(fast)), stream)
    if err != 0:
        msg = lib.mvtb_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_plane kernel launch failed: {msg} ({err})")
    count("launch.fused_plane")
    return o_re, o_im


# --------------------------------------------------------------------------
# Draws -> kernel parameters, and the whole plane path
# --------------------------------------------------------------------------

def plane_params(cfg: StylizeConfig, spatial, draws: StageDraws, B: int,
                 C: int, device: torch.device):
    """Turn per-sample draws into the kernel's per-(b, c) parameters.

    Returns ``(flags, wparams, locs, vals, gates, conjs, scales)`` with
    N = B*C rows (row ``b*C + c``). Point writes are canonicalized onto the
    stored half grid: a point whose H index falls in the dropped half is
    mirrored through ``-s mod n`` and written conjugated (``conjs = -1``);
    ``scales`` is the Hermitian completion factor (1 on the self-mirrored
    H bins 0 and H/2, else 1/2).
    """
    H, W, D = spatial
    Hh = H // 2 + 1
    nd = 3
    f32 = torch.float32
    dev = device
    one = torch.ones((), dtype=f32, device=dev)
    wp = torch.zeros((B, 5), dtype=f32, device=dev)
    has_gibbs = cfg.gibbs_alpha is not None
    gibbs_sym = has_gibbs and any(n % 2 == 0 for n in spatial)
    if has_gibbs:
        draws.require("gibbs_alpha", "gibbs_gate")
        r_g = (1.0 - draws.gibbs_alpha.to(f32)) * max(spatial) * math.sqrt(2.0) / 2.0
        wp[:, 0] = r_g * r_g
        wp[:, 1] = draws.gibbs_gate.to(f32)
    has_disk = cfg.disk_r is not None
    if has_disk:
        draws.require("disk_r", "disk_gate")
        r_d = draws.disk_r.to(f32)
        wp[:, 2] = r_d * r_d
        wp[:, 3] = draws.disk_gate.to(f32)
    has_wrap = cfg.wrap_alpha is not None
    wrap_val = None
    if has_wrap:
        draws.require("wrap_alpha", "wrap_gate")
        wrap_val = torch.where(draws.wrap_gate, draws.wrap_alpha.to(f32), one)
        wp[:, 4] = wrap_val
    wparams = wp.repeat_interleave(C, dim=0)

    def wrap_at(shifted):  # shifted: (B, C, 3)
        f = torch.ones(shifted.shape[:-1], dtype=f32, device=dev)
        if wrap_val is None:
            return f
        for d in range(nd):
            f = f * torch.where(shifted[..., d] % 2 == 1, wrap_val[:, None], one)
        return f

    stages = []  # (raw (B, C, 3), vals (B, C), gates (B, C))
    if cfg.spike:
        draws.require("spike_shifted", "spike_u", "spike_gates")
        sh = draws.spike_shifted.long()
        raw = torch.stack([_to_raw_index(sh[..., d], spatial[d])
                           for d in range(nd)], dim=-1)
        stages.append((raw, torch.exp(spike_log_values(cfg, draws)) * wrap_at(sh),
                       draws.spike_gates.to(f32)))
    if cfg.plane_axes is not None:
        draws.require("plane_shifted", "plane_gate")
        sh = draws.plane_shifted.long()[:, None, :].expand(B, C, nd)
        raw = torch.stack([_to_raw_index(sh[..., d], spatial[d])
                           for d in range(nd)], dim=-1)
        mag = torch.exp(torch.tensor(cfg.plane_intensity, dtype=f32, device=dev))
        stages.append((raw, mag * wrap_at(sh),
                       draws.plane_gate.to(f32)[:, None].expand(B, C)))

    N = B * C
    locs_l, vals_l, gates_l, conjs_l, scales_l = [], [], [], [], []
    for raw, v, g in stages:
        in_half = raw[..., 0] < Hh
        canon = torch.stack([torch.where(in_half, raw[..., d],
                                         (spatial[d] - raw[..., d]) % spatial[d])
                             for d in range(nd)], dim=-1)
        z_self = (canon[..., 0] == 0) | (2 * canon[..., 0] == H)
        locs_l.append(canon.reshape(N, nd).to(torch.int32))
        vals_l.append(v.reshape(N))
        gates_l.append(g.reshape(N))
        conjs_l.append(torch.where(in_half, one, -one).reshape(N))
        scales_l.append(torch.where(z_self, one, 0.5 * one).reshape(N))
    S = len(stages)
    if S:
        locs = torch.stack(locs_l)
        vals, gates = torch.stack(vals_l), torch.stack(gates_l)
        conjs, scales = torch.stack(conjs_l), torch.stack(scales_l)
    else:
        locs = torch.zeros((0, N, nd), dtype=torch.int32, device=dev)
        vals = gates = conjs = scales = torch.zeros((0, N), dtype=f32, device=dev)
    flags = (has_gibbs, gibbs_sym, has_disk, cfg.disk_inside_off, has_wrap,
             cfg.spike, cfg.plane_axes is not None)
    return (flags, wparams.contiguous(), locs.contiguous(),
            vals.contiguous(), gates.contiguous(), conjs.contiguous(),
            scales.contiguous())


def stylize_kspace_plane(x: torch.Tensor, cfg: StylizeConfig,
                         draws: StageDraws) -> torch.Tensor:
    """Plane-kernel execution of the stylize contract on a (B, C, H, W, D)
    batch: H-axis half DFT -> fused plane stack -> inverse -> salt & pepper.
    """
    B, C, H, W, D = x.shape
    spatial = (H, W, D)
    flags, *params = plane_params(cfg, spatial, draws, B, C, x.device)
    with span("mvtb.stylize.h_dft"):
        k_re, k_im = _dft.half_dft_axis(x.reshape(B * C, H, W, D), axis=1)
    o_re, o_im = plane_stylize_half(k_re, k_im, spatial, flags, *params,
                                    fast=cfg.fft_backend == "plane_fast")
    with span("mvtb.stylize.h_dft"):
        out = _dft.half_idft_axis_real(o_re, o_im, H, axis=1)
    out = out.reshape(B, C, H, W, D).to(x.dtype)
    if cfg.sap_p is not None:
        out = _salt_and_pepper(out, draws)
    return out
