"""DFT-by-matmul matrices and the one-axis half-spectrum transforms
(counterpart of mvtb_tpu/ops/dft.py).

The matrices are built in float64 with numpy exactly as the JAX package
builds them, then rounded to float32, so both sides contract against the
same numbers. The H-axis half DFT of the plane path is a plain large matrix
product outside any kernel and stays on ``torch.matmul``; on the card it is
float32-accurate only while ``torch.backends.cuda.matmul.allow_tf32`` is
False (PyTorch's default).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

# Axis lengths up to this bound use the matmul DFT.
MATMUL_DFT_MAX_N = 4096


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


@lru_cache(maxsize=32)
def _half_mats_t(n: int, inverse: bool, device: torch.device):
    """The half matrices transposed for a left multiply, on ``device``."""
    a, b = _half_idft_matrix_np(n) if inverse else _half_dft_matrix_np(n)
    return (torch.from_numpy(np.ascontiguousarray(a.T)).to(device),
            torch.from_numpy(np.ascontiguousarray(b.T)).to(device))


def _split(x: torch.Tensor, axis: int):
    axis = axis % x.ndim
    pre = int(np.prod(x.shape[:axis], dtype=np.int64))
    post = int(np.prod(x.shape[axis + 1:], dtype=np.int64))
    return axis, x.reshape(pre, x.shape[axis], post)


def half_dft_axis(x: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real-input half-spectrum DFT over ONE axis: the ``rfft(x, axis=axis)``
    contract, returned as contiguous (re, im) float32 tensors.

    The transform axis is contracted in place (``M^T @ x`` over a free
    ``(pre, n, post)`` view), so no transpose copy is made.
    """
    x = x.to(torch.float32)
    n = x.shape[axis % x.ndim]
    axis, x3 = _split(x, axis)
    cos_t, sin_t = _half_mats_t(n, False, x.device)
    shape = x.shape[:axis] + (n // 2 + 1,) + x.shape[axis + 1:]
    return (torch.matmul(cos_t, x3).reshape(shape),
            torch.matmul(sin_t, x3).reshape(shape))


def half_idft_axis_real(re: torch.Tensor, im: torch.Tensor, n: int,
                        axis: int) -> torch.Tensor:
    """Hermitian half spectrum on ONE axis -> real volume (the
    ``irfft(x, n=n, axis=axis)`` contract)."""
    axis, re3 = _split(re, axis)
    _, im3 = _split(im, axis)
    cos_t, sin_t = _half_mats_t(n, True, re.device)
    shape = re.shape[:axis] + (n,) + re.shape[axis + 1:]
    return (torch.matmul(cos_t, re3) - torch.matmul(sin_t, im3)).reshape(shape)
