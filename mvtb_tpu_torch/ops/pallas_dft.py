"""The matmul-DFT axis kernels and the n-D transforms of the ``dft_pallas``
backend (counterpart of mvtb_tpu/ops/pallas_dft.py).

Three kernel bodies, each in two orientations (``csrc/axis_dft.cu``):

* ``r2c``: ``re = x.cos``, ``im = x.sin``;
* ``c2c``: Gauss's 3-product complex DFT, ``k1 = (re+im).cos``,
  ``re' = k1 - im.(cos+sin)``, ``im' = k1 + re.(sin-cos)``;
* ``c2r``: ``out = re.cos - im.sin``.

:func:`lane_call` contracts the LAST axis of a flattened ``(M, n_in)`` view
(``out = view @ mat``); :func:`sub_call` contracts the middle axis of a free
``(A, n_in, B)`` view (``out[a] = mat.T @ view[a]``), so no axis is ever
transposed in memory. Every matrix is ``(n_in, n_out)``; the full DFT
matrices are symmetric, so the sublane form is the JAX kernel's
``mat @ tile``.

On a CUDA tensor a wrapper launches the kernel (or raises) and adds one to
``launches[body]``; on a CPU tensor it runs :func:`plain`, the same function
in plain PyTorch (``torch.matmul`` over the same views), and counts nothing.

Precision: ``"highest"`` contracts float32 operands with float32
accumulation. That is more accurate than JAX's ``HIGH`` (an in-kernel
bf16x3 split), which ``stylize_kspace`` uses for this backend, so the
port runs ``"highest"`` there.
``"default"`` rounds every operand (the ``re+im`` sum included) to bfloat16
and accumulates in float32, as the TPU kernel's single-pass dots.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from mvtb_tpu_torch.ops import dft as _dft

BODIES = {"r2c": 0, "c2c": 1, "c2r": 2}
# (data inputs, matrices, outputs) of each body
ARITY = {"r2c": (1, 2, 2), "c2c": (2, 3, 2), "c2r": (2, 2, 1)}
# Kernel launches per body, counted by the wrappers on CUDA tensors only.
launches = {"r2c": 0, "c2c": 0, "c2r": 0}

_LIB = {}


def _lib():
    if "axis_dft" not in _LIB:
        from mvtb_tpu_torch.ops import _build

        lib = _build.load("axis_dft")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mvtb_axis_dft.argtypes = [i, i, i] + [p] * 7 + [ll] * 4 + [p]
        lib.mvtb_axis_dft.restype = i
        lib.mvtb_axis_dft_error_string.argtypes = [i]
        lib.mvtb_axis_dft_error_string.restype = ctypes.c_char_p
        _LIB["axis_dft"] = lib
    return _LIB["axis_dft"]


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def plain(body: str, lane: bool, ins: Sequence[torch.Tensor],
          mats: Sequence[torch.Tensor], precision: str = "highest"
          ) -> Tuple[torch.Tensor, ...]:
    """The kernel body ``body`` in plain PyTorch, on the (M, n_in) view
    (``lane``) or the (A, n_in, B) view, in the same precision tier."""
    fast = _dft.is_fast(precision)
    rnd = _dft.bf16_round if fast else (lambda t: t)
    mats = [rnd(m) for m in mats]

    def mm(x, m):
        return torch.matmul(rnd(x), m) if lane else torch.matmul(m.T, rnd(x))

    if body == "r2c":
        (x,), (cos, sin) = ins, mats
        return mm(x, cos), mm(x, sin)
    if body == "c2c":
        (re, im), (cos, cps, smc) = ins, mats
        k1 = mm(re + im, cos)
        return k1 - mm(im, cps), k1 + mm(re, smc)
    if body == "c2r":
        (re, im), (cos, sin) = ins, mats
        return (mm(re, cos) - mm(im, sin),)
    raise ValueError(f"unknown kernel body {body!r}")


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

def _check(name, t, shape, device):
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected float32 {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _call(body: str, lane: bool, ins, mats, precision: str):
    if body not in BODIES:
        raise ValueError(f"unknown kernel body {body!r}")
    n_ins, n_mats, n_outs = ARITY[body]
    if len(ins) != n_ins or len(mats) != n_mats:
        raise ValueError(f"{body} takes {n_ins} inputs and {n_mats} matrices")
    fast = _dft.is_fast(precision)
    dev = ins[0].device
    if dev.type == "cpu":
        return plain(body, lane, ins, mats, precision)
    if dev.type != "cuda":
        raise ValueError(f"axis_dft {body}: no kernel for {dev}")
    view = tuple(ins[0].shape)
    if len(view) != (2 if lane else 3):
        raise ValueError(f"axis_dft {body}: bad view {view}")
    n_in = view[-1] if lane else view[1]
    n_out = mats[0].shape[-1]
    for i, t in enumerate(ins):
        _check(f"input {i}", t, view, dev)
    for i, m in enumerate(mats):
        _check(f"matrix {i}", m, (n_in, n_out), dev)
    if lane:
        batch, length, out_view = 1, view[0], (view[0], n_out)
    else:
        batch, length, out_view = view[0], view[2], (view[0], n_out, view[2])
    outs = tuple(torch.empty(out_view, dtype=torch.float32, device=dev)
                 for _ in range(n_outs))
    if any(n == 0 for n in out_view) or n_in == 0:
        return outs
    ptr = [t.data_ptr() for t in ins] + [None] * (2 - n_ins)
    mptr = [m.data_ptr() for m in mats] + [None] * (3 - n_mats)
    optr = [o.data_ptr() for o in outs] + [None] * (2 - n_outs)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mvtb_axis_dft(BODIES[body], int(lane), int(fast), *ptr,
                                *mptr, *optr, batch, n_in, n_out, length,
                                stream)
    if err != 0:
        msg = lib.mvtb_axis_dft_error_string(err).decode()
        raise RuntimeError(f"axis_dft {body} kernel launch failed: {msg} ({err})")
    launches[body] += 1
    return outs


def lane_call(body: str, ins: Sequence[torch.Tensor],
              mats: Sequence[torch.Tensor], precision: str = "highest"
              ) -> Tuple[torch.Tensor, ...]:
    """Run kernel ``body`` over contiguous ``(M, n_in)`` float32 views,
    ``out = view @ mat`` with (n_in, n_out) matrices; returns (M, n_out)
    outputs (counterpart of ``_lane_call``)."""
    return _call(body, True, tuple(ins), tuple(mats), precision)


def sub_call(body: str, ins: Sequence[torch.Tensor],
             mats: Sequence[torch.Tensor], precision: str = "highest"
             ) -> Tuple[torch.Tensor, ...]:
    """Run kernel ``body`` over contiguous ``(A, n_in, B)`` float32 views,
    ``out[a] = mat.T @ view[a]`` with (n_in, n_out) matrices; returns
    (A, n_out, B) outputs (counterpart of ``_sub_call``)."""
    return _call(body, False, tuple(ins), tuple(mats), precision)


def _run(body: str, axis: int, arrs, mats, precision: str):
    """Run ``body`` over ``axis`` of same-shape arrays through the free
    lane or sublane view, and reshape the outputs back."""
    shape = tuple(arrs[0].shape)
    n_in, n_out = mats[0].shape
    pre = 1
    for n in shape[:axis]:
        pre *= n
    out_shape = shape[:axis] + (n_out,) + shape[axis + 1:]
    arrs = [a.contiguous() for a in arrs]
    if axis == len(shape) - 1:
        outs = lane_call(body, [a.reshape(pre, n_in) for a in arrs], mats,
                         precision)
    else:
        post = 1
        for n in shape[axis + 1:]:
            post *= n
        outs = sub_call(body, [a.reshape(pre, n_in, post) for a in arrs],
                        mats, precision)
    return tuple(o.reshape(out_shape) for o in outs)


def _axis_dft(re: torch.Tensor, im: Optional[torch.Tensor], axis: int,
              inverse: bool, precision: str):
    """One full-spectrum axis transform, kernel-backed (the twin of
    ``dft._axis_dft``)."""
    n = re.shape[axis]
    if im is None:
        return _run("r2c", axis, (re,), _dft.device_mats("full", n, inverse, re.device),
                    precision)
    return _run("c2c", axis, (re, im),
                _dft.device_mats("gauss", n, inverse, re.device), precision)


def _last_axis(x: torch.Tensor, axes: Sequence[int], name: str):
    axes = [a % x.ndim for a in axes]
    if axes[-1] != x.ndim - 1:
        raise ValueError(f"{name} needs the half axis last")
    return axes


def rdft_nd_pair(x: torch.Tensor, axes: Sequence[int],
                 precision: str = "highest"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`rdft_nd` as an (re, im) float32 pair."""
    axes = _last_axis(x, axes, "rdft_nd")
    x = x.to(torch.float32)
    re, im = _run("r2c", x.ndim - 1, (x,),
                  _dft.device_mats("half", x.shape[-1], False, x.device), precision)
    for axis in axes[:-1]:
        re, im = _axis_dft(re, im, axis, False, precision)
    return re, im


def irdft_nd_real_pair(re: torch.Tensor, im: torch.Tensor, s: Sequence[int],
                       axes: Sequence[int], precision: str = "highest"
                       ) -> torch.Tensor:
    """:func:`irdft_nd_real` on an (re, im) float32 pair."""
    axes = _last_axis(re, axes, "irdft_nd_real")
    for axis in axes[:-1]:
        re, im = _axis_dft(re, im, axis, True, precision)
    (out,) = _run("c2r", re.ndim - 1, (re, im),
                  _dft.device_mats("half_inv", int(s[-1]), True, re.device),
                  precision)
    return out


def rdft_nd(x: torch.Tensor, axes: Sequence[int],
            precision: str = "highest") -> torch.Tensor:
    """The ``rfftn(x, axes=axes)`` contract, kernel-backed. The half axis
    must be the array's last axis: lane r2c against the (n, n//2+1) half
    matrix, then c2c over the other axes."""
    return torch.complex(*rdft_nd_pair(x, axes, precision))


def irdft_nd_real(x: torch.Tensor, s: Sequence[int], axes: Sequence[int],
                  precision: str = "highest") -> torch.Tensor:
    """The ``irfftn(x, s=s, axes=axes)`` contract, kernel-backed (half axis
    last): c2c over the other axes, then lane c2r against the (n//2+1, n)
    completion matrix."""
    re, im = _dft._parts(x)
    if im is None:
        im = torch.zeros_like(re)
    return irdft_nd_real_pair(re, im, s, axes, precision)


def dft_nd(x: torch.Tensor, axes: Sequence[int],
           precision: str = "highest") -> torch.Tensor:
    """The ``fftn(x, axes=axes)`` contract, kernel-backed."""
    re, im = _dft._parts(x)
    for axis in [a % x.ndim for a in axes]:
        re, im = _axis_dft(re, im, axis, False, precision)
    return torch.complex(re, im)


def idft_nd(x: torch.Tensor, axes: Sequence[int],
            precision: str = "highest") -> torch.Tensor:
    """The ``ifftn(x, axes=axes)`` contract, kernel-backed."""
    re, im = _dft._parts(x)
    for axis in [a % x.ndim for a in axes]:
        re, im = _axis_dft(re, im, axis, True, precision)
    return torch.complex(re, im)


def idft_nd_real(x: torch.Tensor, axes: Sequence[int],
                 precision: str = "highest") -> torch.Tensor:
    """Real part of the inverse n-D DFT, kernel-backed: the last axis runs
    the c2r body, so its imaginary output is never computed."""
    axes = [a % x.ndim for a in axes]
    re, im = _dft._parts(x)
    for axis in axes[:-1]:
        re, im = _axis_dft(re, im, axis, True, precision)
    if im is None:
        im = torch.zeros_like(re)
    (out,) = _run("c2r", axes[-1], (re, im),
                  _dft.device_mats("full", re.shape[axes[-1]], True, re.device),
                  precision)
    return out
