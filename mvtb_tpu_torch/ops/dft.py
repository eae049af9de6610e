"""DFT-by-matmul: matrices, one-axis transforms and the n-D transforms of
the ``dft`` / ``dft_fast`` backends (counterpart of mvtb_tpu/ops/dft.py).

The matrices are built in float64 with numpy exactly as the JAX package
builds them, then rounded to float32, so both sides contract against the
same numbers. Complex arithmetic is written as real products; complex-input
axes use Gauss's 3-product contraction (:func:`_gauss_dft_matrices_np`).

The JAX package leaves these products to XLA, outside any Pallas kernel, so
the port runs them on ``torch.matmul``. On the card they are
float32-accurate only while ``torch.backends.cuda.matmul.allow_tf32`` is
False (PyTorch's default).

``precision`` is a string: ``"highest"`` contracts float32 operands;
``"default"`` rounds every operand to bfloat16 and accumulates in float32,
as JAX's ``Precision.DEFAULT`` does (the ``dft_fast`` backend). The n-D functions keep the JAX contracts
(``fftn`` / ``ifftn`` / ``rfftn`` / ``irfftn``) on complex64 tensors; the
``*_pair`` forms take and return the (re, im) float32 pair that the fused
stylize path carries.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# Axis lengths up to this bound use the matmul DFT.
MATMUL_DFT_MAX_N = 4096

PRECISIONS = ("highest", "default")


def _dft_matrix_f64(n: int, inverse: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) parts of the (i)DFT matrix in float64.

    Forward: W[j, k] = exp(-2i pi j k / n); inverse: conj / n.
    """
    jk = np.outer(np.arange(n, dtype=np.float64), np.arange(n, dtype=np.float64))
    theta = 2.0 * np.pi * (jk % n) / n  # reduce before cos/sin for accuracy
    sign = 1.0 if inverse else -1.0
    cos = np.cos(theta)
    sin = sign * np.sin(theta)
    if inverse:
        cos /= n
        sin /= n
    return cos, sin


@lru_cache(maxsize=64)
def _dft_matrix_np(n: int, inverse: bool) -> Tuple[np.ndarray, np.ndarray]:
    """float32 (cos, sin) parts of the (i)DFT matrix, computed in float64."""
    cos, sin = _dft_matrix_f64(n, inverse)
    return cos.astype(np.float32), sin.astype(np.float32)


@lru_cache(maxsize=64)
def _gauss_dft_matrices_np(
        n: int, inverse: bool) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(cos, sin-cos, cos+sin) for Gauss's 3-matmul complex contraction:
    for X = re + i*im and W = cos + i*sin,
    ``k1 = (re + im) @ cos``, ``Re(XW) = k1 - im @ (cos+sin)``,
    ``Im(XW) = k1 + re @ (sin-cos)``. Combined in float64, then rounded."""
    cos, sin = _dft_matrix_f64(n, inverse)
    return (cos.astype(np.float32),
            (sin - cos).astype(np.float32),
            (cos + sin).astype(np.float32))


@lru_cache(maxsize=64)
def _half_dft_matrix_np(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of the forward half-spectrum DFT matrix, shape (n, n//2+1)."""
    h = n // 2 + 1
    jk = np.outer(np.arange(n, dtype=np.float64), np.arange(h, dtype=np.float64))
    theta = 2.0 * np.pi * (jk % n) / n
    return np.cos(theta).astype(np.float32), (-np.sin(theta)).astype(np.float32)


@lru_cache(maxsize=64)
def _half_idft_matrix_np(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(cosT, sinT) of the real-output inverse half-spectrum DFT, (n//2+1, n),
    with the Hermitian pair weight ``c_k/n`` folded in (``c_k = 2`` except on
    the self-mirrored bins k=0 and, for even n, n/2)."""
    h = n // 2 + 1
    kj = np.outer(np.arange(h, dtype=np.float64), np.arange(n, dtype=np.float64))
    theta = 2.0 * np.pi * (kj % n) / n
    c = np.full((h, 1), 2.0)
    c[0] = 1.0
    if n % 2 == 0:
        c[-1] = 1.0
    c /= n
    return ((np.cos(theta) * c).astype(np.float32),
            (np.sin(theta) * c).astype(np.float32))


def _split(x: torch.Tensor, axis: int):
    # math.prod keeps a symbolic batch size symbolic under torch.export
    axis = axis % x.ndim
    pre = math.prod(x.shape[:axis])
    post = math.prod(x.shape[axis + 1:])
    return axis, x.reshape(pre, x.shape[axis], post)


def half_dft_axis(x: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real-input half-spectrum DFT over ONE axis: the ``rfft(x, axis=axis)``
    contract, returned as contiguous (re, im) float32 tensors.

    The transform axis is contracted in place (:func:`contract`), so no
    transpose copy is made.
    """
    x = x.to(torch.float32)
    cos, sin = device_mats("half", x.shape[axis], False, x.device)
    return contract(x, cos, axis), contract(x, sin, axis)


def half_idft_axis_real(re: torch.Tensor, im: torch.Tensor, n: int,
                        axis: int) -> torch.Tensor:
    """Hermitian half spectrum on ONE axis -> real volume (the
    ``irfft(x, n=n, axis=axis)`` contract)."""
    cos_t, sin_t = device_mats("half_inv", n, True, re.device)
    return contract(re, cos_t, axis) - contract(im, sin_t, axis)


# --------------------------------------------------------------------------
# Precision tiers and matrices on a device
# --------------------------------------------------------------------------

def is_fast(precision: str) -> bool:
    """True for the single-pass bf16 tier (``"default"``); raises on an
    unknown precision."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return precision == "default"


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to the nearest bfloat16 value, kept in float32."""
    return t.to(torch.bfloat16).to(torch.float32)


_F32_MIN_NORMAL = 2.0 ** -126


def _ftz(t: torch.Tensor) -> torch.Tensor:
    """Float32 denormals flushed to a zero of their sign."""
    return torch.where(t.abs() < _F32_MIN_NORMAL, t * 0.0, t)


def split_bf16(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """bf16 (hi, lo) split of a float32 tensor, bit for bit the JAX
    package's ``pallas_dft._split_bf16`` as XLA computes it: ``hi = bf16(t)``
    and ``lo = bf16(t - hi)``, both rounded to nearest even, the subtraction
    with float32 denormals flushed to zero on input and output (XLA's float32
    arithmetic, and the kernels' ``sub.rn.ftz.f32``)."""
    hi = t.to(torch.bfloat16)
    return hi, _ftz(_ftz(t) - _ftz(hi.to(torch.float32))).to(torch.bfloat16)


def tier_parts(t: torch.Tensor, fast: bool) -> Tuple[torch.Tensor, ...]:
    """An operand as a bf16 tensor-core tier sees it, in bf16: (bf16(t),)
    for the single-pass tier, (hi, lo) for bf16x3."""
    return (t.to(torch.bfloat16),) if fast else split_bf16(t)


@lru_cache(maxsize=128)
def device_mats(kind: str, n: int, inverse: bool,
                device: torch.device) -> Tuple[torch.Tensor, ...]:
    """float32 matrices on ``device``, each (n_in, n_out) for
    ``out[k] = sum_j x[j] * mat[j, k]``:

    * ``"full"``: (cos, sin) of the (i)DFT matrix, (n, n);
    * ``"gauss"``: (cos, cos+sin, sin-cos), (n, n), in the order of the
      three Gauss products ``(re+im)*cos``, ``im*(cos+sin)``, ``re*(sin-cos)``;
    * ``"half"``: (cos, sin) of the forward half DFT, (n, n//2+1);
    * ``"half_inv"``: (cosT, sinT) of the real-output inverse, (n//2+1, n)
      (``inverse`` is ignored for the two half kinds).
    """
    if kind == "full":
        mats = _dft_matrix_np(n, inverse)
    elif kind == "gauss":
        cos, smc, cps = _gauss_dft_matrices_np(n, inverse)
        mats = (cos, cps, smc)
    elif kind == "half":
        mats = _half_dft_matrix_np(n)
    elif kind == "half_inv":
        mats = _half_idft_matrix_np(n)
    else:
        raise ValueError(f"unknown matrix kind {kind!r}")
    # Made outside torch.export's fake and tracing modes, so the cache holds
    # real tensors and an exported program lifts them as constants on the
    # export device instead of copying them from the host on every call.
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        return tuple(torch.from_numpy(m).to(device) for m in mats)


def contract(x: torch.Tensor, mat: torch.Tensor, axis: int,
             fast: bool = False) -> torch.Tensor:
    """``out[..., k, ...] = sum_j x[..., j, ...] * mat[j, k]`` over ``axis``.

    The last axis is a right product on the free (M, n) view; an interior
    axis is a left product ``mat.T @ x`` on the free (pre, n, post) view, so
    no transpose copy of ``x`` is made. ``fast`` rounds both operands to
    bfloat16 first (float32 accumulation).
    """
    if fast:
        x, mat = bf16_round(x), bf16_round(mat)
    axis = axis % x.ndim
    if axis == x.ndim - 1:
        return torch.matmul(x, mat)
    _, x3 = _split(x, axis)
    out = torch.matmul(mat.T, x3)
    return out.reshape(x.shape[:axis] + (mat.shape[1],) + x.shape[axis + 1:])


def _axis_dft(re: torch.Tensor, im: Optional[torch.Tensor], axis: int,
              inverse: bool, precision: str = "highest"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One full-spectrum axis transform: two real products for a real input
    (``im`` None), Gauss's three for a complex one."""
    fast = is_fast(precision)
    n = re.shape[axis]
    if im is None:
        cos, sin = device_mats("full", n, inverse, re.device)
        return contract(re, cos, axis, fast), contract(re, sin, axis, fast)
    cos, cps, smc = device_mats("gauss", n, inverse, re.device)
    k1 = contract(re + im, cos, axis, fast)
    return (k1 - contract(im, cps, axis, fast),
            k1 + contract(re, smc, axis, fast))


def _parts(x: torch.Tensor):
    """(re, im) float32 parts of ``x``; im is None for a real input."""
    if x.is_complex():
        return x.real.to(torch.float32).contiguous(), x.imag.to(torch.float32).contiguous()
    return x.to(torch.float32), None


def _axes(axes: Sequence[int], ndim: int):
    return [a % ndim for a in axes]


def dft_nd(x: torch.Tensor, axes: Sequence[int],
           precision: str = "highest") -> torch.Tensor:
    """Forward n-D DFT over ``axes`` (unshifted): the ``fftn`` contract,
    real or complex input, complex64 output."""
    re, im = _parts(x)
    for axis in _axes(axes, x.ndim):
        re, im = _axis_dft(re, im, axis, False, precision)
    return torch.complex(re, im)


def idft_nd(x: torch.Tensor, axes: Sequence[int],
            precision: str = "highest") -> torch.Tensor:
    """Inverse n-D DFT over ``axes`` (norm="backward"): the ``ifftn``
    contract."""
    re, im = _parts(x)
    for axis in _axes(axes, x.ndim):
        re, im = _axis_dft(re, im, axis, True, precision)
    return torch.complex(re, im)


def idft_nd_real(x: torch.Tensor, axes: Sequence[int],
                 precision: str = "highest") -> torch.Tensor:
    """Real part of the inverse n-D DFT. The last axis runs the 2-product
    real-output contraction, so its imaginary output is never computed."""
    fast = is_fast(precision)
    axes = _axes(axes, x.ndim)
    re, im = _parts(x)
    for axis in axes[:-1]:
        re, im = _axis_dft(re, im, axis, True, precision)
    cos, sin = device_mats("full", re.shape[axes[-1]], True, re.device)
    out = contract(re, cos, axes[-1], fast)
    if im is not None:
        out = out - contract(im, sin, axes[-1], fast)
    return out


def rdft_nd_pair(x: torch.Tensor, axes: Sequence[int],
                 precision: str = "highest"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`rdft_nd` as an (re, im) float32 pair."""
    fast = is_fast(precision)
    axes = _axes(axes, x.ndim)
    x = x.to(torch.float32)
    cos, sin = device_mats("half", x.shape[axes[-1]], False, x.device)
    re, im = contract(x, cos, axes[-1], fast), contract(x, sin, axes[-1], fast)
    for axis in axes[:-1]:
        re, im = _axis_dft(re, im, axis, False, precision)
    return re, im


def irdft_nd_real_pair(re: torch.Tensor, im: torch.Tensor, s: Sequence[int],
                       axes: Sequence[int], precision: str = "highest"
                       ) -> torch.Tensor:
    """:func:`irdft_nd_real` on an (re, im) float32 pair."""
    fast = is_fast(precision)
    axes = _axes(axes, re.ndim)
    for axis in axes[:-1]:
        re, im = _axis_dft(re, im, axis, True, precision)
    cos_t, sin_t = device_mats("half_inv", int(s[-1]), True, re.device)
    return (contract(re, cos_t, axes[-1], fast)
            - contract(im, sin_t, axes[-1], fast))


def rdft_nd(x: torch.Tensor, axes: Sequence[int],
            precision: str = "highest") -> torch.Tensor:
    """Real-input n-D DFT with the half spectrum on the LAST of ``axes``:
    the ``rfftn`` contract. The last axis is a 2-product contraction against
    the (n, n//2+1) half matrix, the rest full complex DFTs."""
    return torch.complex(*rdft_nd_pair(x, axes, precision))


def irdft_nd_real(x: torch.Tensor, s: Sequence[int], axes: Sequence[int],
                  precision: str = "highest") -> torch.Tensor:
    """Inverse of :func:`rdft_nd`, Hermitian half spectrum -> real volume:
    the ``irfftn(x, s=s, axes=axes)`` contract."""
    re, im = _parts(x)
    if im is None:
        im = torch.zeros_like(re)
    return irdft_nd_real_pair(re, im, s, axes, precision)


def use_matmul_dft(spatial: Sequence[int]) -> bool:
    """Matmul DFT for every axis within the bound."""
    return all(n <= MATMUL_DFT_MAX_N for n in spatial)


# --------------------------------------------------------------------------
# Hybrid per-axis backend: torch.fft on axes whose length is 2/3/5-smooth,
# the matmul DFT at "highest" on the rest (the JAX package's hybrid_*; XLA's
# TPU FFT only transforms innermost axes, so the JAX functions transpose the
# smooth axes there first; torch.fft transforms any axis in place). The split
# of the axes and the order of the passes are the JAX package's.
# --------------------------------------------------------------------------

def _smooth235(n: int) -> bool:
    """True when ``n`` factors entirely into 2, 3 and 5."""
    if n <= 0:
        return False  # 0 % p == 0 forever
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


def _split_smooth(shape, axes: Sequence[int]):
    smooth = [a for a in axes if _smooth235(shape[a])]
    return smooth, [a for a in axes if not _smooth235(shape[a])]


def _fft_axes(re: torch.Tensor, im: Optional[torch.Tensor], axes: Sequence[int],
              inverse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Complex (i)FFT over ``axes`` with ``torch.fft``, as an (re, im) pair."""
    k = torch.complex(re, torch.zeros_like(re) if im is None else im)
    k = (torch.fft.ifftn if inverse else torch.fft.fftn)(k, dim=tuple(axes))
    return k.real.contiguous(), k.imag.contiguous()


def hybrid_rdft_nd(x: torch.Tensor, axes: Sequence[int]) -> torch.Tensor:
    """The ``rfftn(x, axes=axes)`` contract with the per-axis hybrid backend
    (half spectrum on the last of ``axes``)."""
    axes = _axes(axes, x.ndim)
    last = axes[-1]
    smooth_lead, mat_lead = _split_smooth(x.shape, axes[:-1])
    x = x.to(torch.float32)
    if _smooth235(x.shape[last]):
        if not mat_lead:
            return torch.fft.rfftn(x, dim=tuple(axes))
        k = torch.fft.rfft(x, dim=last)
        re, im = k.real.contiguous(), k.imag.contiguous()
    else:
        cos, sin = device_mats("half", x.shape[last], False, x.device)
        re, im = contract(x, cos, last), contract(x, sin, last)
    for a in mat_lead:
        re, im = _axis_dft(re, im, a, False)
    if smooth_lead:
        re, im = _fft_axes(re, im, smooth_lead, False)
    return torch.complex(re, im)


def hybrid_irdft_nd_real(x: torch.Tensor, s: Sequence[int],
                         axes: Sequence[int]) -> torch.Tensor:
    """The ``irfftn(x, s=s, axes=axes)`` contract with the per-axis hybrid
    backend."""
    axes = _axes(axes, x.ndim)
    last = axes[-1]
    n = int(s[-1])
    smooth_lead, mat_lead = _split_smooth(x.shape, axes[:-1])
    if _smooth235(n) and not mat_lead:
        return torch.fft.irfftn(x, s=tuple(int(v) for v in s), dim=tuple(axes))
    re, im = _parts(x)
    if smooth_lead:
        re, im = _fft_axes(re, im, smooth_lead, True)
    for a in mat_lead:
        re, im = _axis_dft(re, im, a, True)
    if im is None:
        im = torch.zeros_like(re)
    if _smooth235(n):
        return torch.fft.irfft(torch.complex(re, im), n=n, dim=last)
    cos_t, sin_t = device_mats("half_inv", n, True, re.device)
    return contract(re, cos_t, last) - contract(im, sin_t, last)


def hybrid_dft_nd(x: torch.Tensor, axes: Sequence[int]) -> torch.Tensor:
    """The ``fftn(x, axes=axes)`` contract with the per-axis hybrid backend:
    the matmul axes first, then one ``fftn`` over the smooth ones."""
    axes = _axes(axes, x.ndim)
    smooth, mat = _split_smooth(x.shape, axes)
    re, im = _parts(x)
    for a in mat:
        re, im = _axis_dft(re, im, a, False)
    if smooth:
        re, im = _fft_axes(re, im, smooth, False)
    return torch.complex(re, torch.zeros_like(re) if im is None else im)


def hybrid_idft_nd(x: torch.Tensor, axes: Sequence[int]) -> torch.Tensor:
    """The ``ifftn(x, axes=axes)`` contract (complex output) with the per-axis
    hybrid backend: one ``ifftn`` over the smooth axes, then the matmul
    axes."""
    axes = _axes(axes, x.ndim)
    smooth, mat = _split_smooth(x.shape, axes)
    re, im = _parts(x)
    if smooth:
        re, im = _fft_axes(re, im, smooth, True)
    for a in mat:
        re, im = _axis_dft(re, im, a, True)
    return torch.complex(re, torch.zeros_like(re) if im is None else im)


def hybrid_idft_nd_real(x: torch.Tensor, axes: Sequence[int]) -> torch.Tensor:
    """Real part of the inverse n-D DFT with the per-axis hybrid backend: one
    ``ifftn`` over the smooth axes, then the matmul axes, the last of them
    the 2-product real-output contraction."""
    axes = _axes(axes, x.ndim)
    smooth, mat = _split_smooth(x.shape, axes)
    re, im = _parts(x)
    if smooth:
        re, im = _fft_axes(re, im, smooth, True)
    if not mat:
        return re
    for a in mat[:-1]:
        re, im = _axis_dft(re, im, a, True)
    cos, sin = device_mats("full", re.shape[mat[-1]], True, re.device)
    out = contract(re, cos, mat[-1])
    if im is not None:
        out = out - contract(im, sin, mat[-1])
    return out
