"""The image-domain pointwise kernels (counterpart of
mvtb_tpu/ops/pallas_kernels.py) and the magnitude-edit tail that runs one.

Two kernels, one source (``csrc/pointwise.cu``):

* ``sap``: salt & pepper with its uniform field made inside the kernel by
  Philox4x32-10, so the field never exists in device memory. Element ``e``
  takes word ``e % 4`` of the Philox block at counter
  ``(e // 4 low, e // 4 high, 0, 0)`` under key ``(uint32(seed), 0)``, and
  ``u = (word >> 8) * 2^-24``, the TPU kernel's 24-bit rule. The stream
  depends on (seed, element index) only. It is not the TPU's stream (that
  PRNG is the TPU's own), and the Pallas interpreter's PRNG gives zeros.
  The extrema ``min(x)/2`` and ``max(x)/2`` are global and reduced before
  the kernel, as the JAX function does.
* ``polar``: the whole-volume round trip ``exp(log(|k| + 1e-10)) *
  (re/|k|, im/|k|)``, with ``(mag, 0)`` where ``|k| = 0``.

Each wrapper is a thin call of a custom op (:mod:`._ops`), which
``torch.export`` traces. On a CUDA tensor the op launches its kernel (or
raises) and adds one to the process's counter ``launch.<name>``
(``utils/profiling.py``); on a CPU tensor it runs the
plain PyTorch version
(:func:`salt_and_pepper_plain`, :func:`polar_roundtrip_plain`), which
repeats the kernel's arithmetic, Philox stream included, and counts
nothing. Both kernels take float32 only.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from mvtb_tpu_torch.ops.corruptions import sap_select
from mvtb_tpu_torch.ops.fourier import from_polar
from mvtb_tpu_torch.utils.profiling import count

_LIB = {}

_MASK = 0xFFFFFFFF
# Philox4x32 multipliers and Weyl key increments (Random123)
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
PHILOX_ROUNDS = 10


def _lib():
    if "pointwise" not in _LIB:
        from mvtb_tpu_torch.ops import _build

        lib = _build.load("pointwise")
        p, ll, u32, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32, ctypes.c_float
        lib.mvtb_sap.argtypes = [p, p, ll, u32, f, p, p, p]
        lib.mvtb_sap.restype = ctypes.c_int
        lib.mvtb_polar.argtypes = [p, p, p, p, ll, p]
        lib.mvtb_polar.restype = ctypes.c_int
        lib.mvtb_pointwise_error_string.argtypes = [ctypes.c_int]
        lib.mvtb_pointwise_error_string.restype = ctypes.c_char_p
        _LIB["pointwise"] = lib
    return _LIB["pointwise"]


# --------------------------------------------------------------------------
# Philox4x32-10 in torch integer ops (the plain version's stream)
# --------------------------------------------------------------------------

def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of ``m * x`` for uint32 values held in
    int64, from 16-bit halves so that no int64 product overflows."""
    mh, ml = m >> 16, m & 0xFFFF
    xh, xl = x >> 16, x & 0xFFFF
    t1 = xl * mh + xh * ml
    mid = xl * ml + ((t1 & 0xFFFF) << 16)
    return (xh * mh + (t1 >> 16) + (mid >> 32)) & _MASK, mid & _MASK


def philox4x32(counter: torch.Tensor, key: Sequence[int]) -> torch.Tensor:
    """Philox4x32-10 of int64 ``counter`` words (..., 4) under a two-word
    ``key``; returns the (..., 4) output words, each in [0, 2^32)."""
    c0, c1, c2, c3 = (counter & _MASK).unbind(-1)
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    for _ in range(PHILOX_ROUNDS):
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + PHILOX_W[0]) & _MASK, (k1 + PHILOX_W[1]) & _MASK
    return torch.stack((c0, c1, c2, c3), dim=-1)


def sap_uniform(n: int, seed: int, device) -> torch.Tensor:
    """The sap kernel's uniform field for ``n`` elements, float32 in
    [0, 1): ``(word >> 8) * 2^-24`` of the Philox stream."""
    groups = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(groups)
    counter = torch.stack((groups & _MASK, groups >> 32, zero, zero), dim=-1)
    words = philox4x32(counter, (seed, 0)).reshape(-1)[:n]
    return (words >> 8).to(torch.float32) * 2.0 ** -24


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def salt_and_pepper_plain(x: torch.Tensor, p, seed: int) -> torch.Tensor:
    """The sap kernel in plain PyTorch: the same Philox field and the same
    select (:func:`~.corruptions.sap_select`) in float32."""
    if x.numel() == 0:
        return x.clone()
    u = sap_uniform(x.numel(), seed, x.device).reshape(x.shape)
    p = torch.tensor(float(p), dtype=torch.float32, device=x.device)
    return sap_select(x, u, p, x.min() / 2, x.max() / 2)


def polar_roundtrip_plain(re: torch.Tensor, im: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The polar kernel in plain PyTorch, in the JAX kernel's order."""
    r = torch.sqrt(re * re + im * im)
    mag = torch.exp(torch.log(r + 1e-10))
    pos = r > 0
    safe = torch.where(pos, r, 1.0)
    return (mag * torch.where(pos, re / safe, 1.0),
            mag * torch.where(pos, im / safe, 0.0))


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

def _check(kernel: str, name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.dtype != torch.float32:
        raise NotImplementedError(f"{kernel}: float32 only, {name} is {t.dtype}")
    if tuple(t.shape) != tuple(like.shape) or t.device != like.device:
        raise ValueError(f"{kernel}: {name} is {tuple(t.shape)} on {t.device}, "
                         f"expected {tuple(like.shape)} on {like.device}")


def _device_of(kernel: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: no kernel for {t.device}")
    return t.device.type


def _launch(kernel: str, fn, *args, dev) -> None:
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = _lib().mvtb_pointwise_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} ({err})")
    count(f"launch.{kernel}")


def salt_and_pepper_pallas(x: torch.Tensor, p, seed) -> torch.Tensor:
    """Salt & pepper with the uniform field made in the kernel (semantics of
    FO:465-482): pepper ``min(x)/2`` where ``u <= p/2``, salt ``max(x)/2``
    where ``p/2 < u <= p``, extrema over the whole tensor. ``seed`` is an
    int32 (its low 32 bits key the stream); vary it per call for fresh
    noise. ``p`` and ``seed`` may be numbers or 0-d tensors: as tensors they
    stay inputs of an exported program, as JAX's traced seed does.
    Counterpart of the JAX function of the same name; a thin call of the
    custom op ``mvtb::sap`` (:mod:`._ops`)."""
    _check("sap", "x", x, x)
    _device_of("sap", x)
    from mvtb_tpu_torch.ops import _ops

    return _ops.sap(x, torch.as_tensor(p, dtype=torch.float32),
                    torch.as_tensor(seed, dtype=torch.int64))


def sap_launch(x: torch.Tensor, p: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """The sap kernel's launch on a CUDA tensor (the CUDA implementation of
    ``mvtb::sap``); ``p`` and ``seed`` are read on the host (a 0-d tensor on
    the card costs one synchronisation)."""
    if not x.is_contiguous():
        raise ValueError("sap: x must be contiguous")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    mn, mx = torch.aminmax(x)
    _launch("sap", _lib().mvtb_sap, x.data_ptr(), out.data_ptr(), x.numel(),
            int(seed) & _MASK, float(p), mn.data_ptr(), mx.data_ptr(), dev=x.device)
    return out


def polar_roundtrip_pallas(re: torch.Tensor, im: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-volume polar decompose and recombine in one pass:
    ``exp(log(|k| + 1e-10)) * (re/|k|, im/|k|)``, ``(mag, 0)`` where
    ``|k| = 0``. Counterpart of the JAX function of the same name; a thin
    call of the custom op ``mvtb::polar`` (:mod:`._ops`)."""
    _check("polar", "re", re, re)
    _check("polar", "im", im, re)
    _device_of("polar", re)
    from mvtb_tpu_torch.ops import _ops

    return _ops.polar(re, im)


def polar_launch(re: torch.Tensor, im: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The polar kernel's launch on CUDA tensors (the CUDA implementation of
    ``mvtb::polar``)."""
    if not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError("polar: re and im must be contiguous")
    ore, oim = torch.empty_like(re), torch.empty_like(im)
    if re.numel() == 0:
        return ore, oim
    _launch("polar", _lib().mvtb_polar, re.data_ptr(), im.data_ptr(), ore.data_ptr(),
            oim.data_ptr(), re.numel(), dev=re.device)
    return ore, oim


# --------------------------------------------------------------------------
# The magnitude-edit tail (benchmarks.py:config6 of the JAX package)
# --------------------------------------------------------------------------

EDIT_STRATEGIES = ("torch_chain", "polar_kernel", "scatter")


def magnitude_edit(k: torch.Tensor, idx, log_intensity: float,
                   strategy: str) -> torch.Tensor:
    """Set ``log|k|`` to ``log_intensity`` at the points ``idx`` (an
    advanced index into ``k``) and keep the phase everywhere, as the spike
    stage does, by one of three strategies:

    * ``"torch_chain"``: the reference's whole-volume chain,
      ``from_polar(exp(log(|k| + 1e-10)), angle(k))`` with the point write
      in log space;
    * ``"polar_kernel"``: :func:`polar_roundtrip_pallas` over the whole
      volume, then the points written;
    * ``"scatter"``: only the written points, ``k`` copied elsewhere.

    They agree up to the whole-volume round trip's rounding.
    """
    if strategy == "torch_chain":
        log_abs = torch.log(torch.abs(k) + 1e-10)
        log_abs[idx] = log_intensity
        return from_polar(torch.exp(log_abs), torch.angle(k))
    if strategy == "polar_kernel":
        ore, oim = polar_roundtrip_pallas(k.real.contiguous(), k.imag.contiguous())
        out = torch.complex(ore, oim)
    elif strategy == "scatter":
        out = k.clone()
    else:
        raise ValueError(f"unknown magnitude-edit strategy {strategy!r}")
    phase = torch.angle(k[idx])
    out[idx] = from_polar(torch.exp(torch.full_like(phase, log_intensity)), phase)
    return out
