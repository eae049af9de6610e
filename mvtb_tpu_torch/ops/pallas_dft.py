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

Precision tiers (:data:`TIERS`), those of the TPU kernels' ``_fast``:

* ``"highest"`` (JAX ``HIGHEST``, ``"f32"``): float32 operands, float32
  accumulation; the default of the public transforms;
* ``"high"`` (JAX ``HIGH``, ``"3x"``): bf16x3, every operand split into
  bf16 ``hi, lo`` (:func:`.dft.split_bf16`, bit for bit the JAX
  ``_split_bf16``) and each product summed as ``hi.hi + (hi.lo + lo.hi)``
  in float32, the ``re+im`` sum of c2c formed in float32 before its split;
  the tier ``stylize_kspace`` runs ``dft_pallas`` at, as the JAX package does;
* ``"default"`` (JAX ``DEFAULT``, ``"1x"``): every operand rounded to bf16
  once, float32 accumulation.

The wrappers call the custom op ``mvtb::axis_dft`` (:mod:`._ops`), which
``torch.export`` traces. On a CUDA tensor it launches the kernel
(:func:`launch`) or raises, and adds one to the process's counters
(``utils/profiling.py``) ``launch.axis_dft.<body>`` and
``launch.axis_dft.<body>.<route>.<precision>``; on a CPU tensor it runs
:func:`plain`, the same function in plain PyTorch
(``torch.matmul`` over the same views, on the tier's bf16 parts as float32
values, whose products are exact), and counts nothing. Routes: every body at
``"high"`` and ``"default"`` runs the tensor-core body (``"wgmma"``), whose
matrices the host lays out once per matrix set (:func:`pack_mats`); the
``"highest"`` tier runs the float32 CUDA-core body (``"simt"``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from mvtb_tpu_torch.ops import dft as _dft
from mvtb_tpu_torch.utils.profiling import count

BODIES = {"r2c": 0, "c2c": 1, "c2r": 2}
# (data inputs, matrices, outputs) of each body
ARITY = {"r2c": (1, 2, 2), "c2c": (2, 3, 2), "c2r": (2, 2, 1)}
TIERS = ("highest", "high", "default")
# bf16 parts of a tensor-core operand
_PARTS = {"default": 1, "high": 2}

# Tensor-core tiles of csrc/axis_dft.cu: output columns of one wgmma chunk
# and the depth of one stage.
_CHUNK, _DEPTH = 80, 16

_LIB = {}


def _lib():
    if "axis_dft" not in _LIB:
        from mvtb_tpu_torch.ops import _build

        lib = _build.load("axis_dft")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mvtb_axis_dft.argtypes = [i, i] + [p] * 7 + [ll] * 4 + [p]
        lib.mvtb_axis_dft.restype = i
        lib.mvtb_axis_dft_tc.argtypes = [i, i, i, i] + [p] * 5 + [ll] * 4 + [p]
        lib.mvtb_axis_dft_tc.restype = i
        lib.mvtb_axis_dft_error_string.argtypes = [i]
        lib.mvtb_axis_dft_error_string.restype = ctypes.c_char_p
        _LIB["axis_dft"] = lib
    return _LIB["axis_dft"]


def check_tier(precision: str) -> str:
    """``precision`` if it is one of :data:`TIERS`, else ValueError."""
    if precision not in TIERS:
        raise ValueError(f"precision must be one of {TIERS}, got {precision!r}")
    return precision


def route(body: str, precision: str) -> str:
    """The kernel body that serves ``body`` at ``precision`` on the card:
    the tensor cores at ``"high"`` and ``"default"``, CUDA cores at
    ``"highest"``, for every body."""
    return "simt" if check_tier(precision) == "highest" else "wgmma"


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def _tier_values(t: torch.Tensor, precision: str) -> Tuple[torch.Tensor, ...]:
    """An operand as its tier sees it, as float32 values: ``(t,)``,
    ``(bf16(t),)`` or the bf16x3 ``(hi, lo)``."""
    if precision == "highest":
        return (t,)
    return tuple(p.to(torch.float32) for p in _dft.tier_parts(t, precision == "default"))


def plain(body: str, lane: bool, ins: Sequence[torch.Tensor],
          mats: Sequence[torch.Tensor], precision: str = "highest"
          ) -> Tuple[torch.Tensor, ...]:
    """The kernel body ``body`` in plain PyTorch, on the (M, n_in) view
    (``lane``) or the (A, n_in, B) view, in the same precision tier."""
    check_tier(precision)
    mats = [_tier_values(m, precision) for m in mats]

    def dot(x, m):
        return torch.matmul(x, m) if lane else torch.matmul(m.T, x)

    def mm(x, m):
        xs = _tier_values(x, precision)
        if len(xs) == 1:
            return dot(xs[0], m[0])
        (xh, xl), (mh, ml) = xs, m
        return dot(xh, mh) + (dot(xh, ml) + dot(xl, mh))

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
# The tensor-core body's matrices
# --------------------------------------------------------------------------

def mat_layout(body: str, n_out: int) -> Tuple[int, int, int]:
    """(terms, chunks, rows) of the tensor-core body's matrix operand:
    c2c contracts three Gauss matrices, each in chunks of 80 output
    columns; r2c one matrix ``[cos | sin]`` of ``2 n_out`` columns, two
    chunks at a time where it is wider than one; c2r two, ``cos`` (against
    ``re``) and ``-sin`` (against ``im``), of ``n_out`` columns summed into
    the same chunks, two at a time where ``n_out`` is wider than one."""
    if body == "c2c":
        return 3, 1, n_out
    if body == "r2c":
        return 1, (1 if 2 * n_out <= _CHUNK else 2), 2 * n_out
    if body == "c2r":
        return 2, (1 if n_out <= _CHUNK else 2), n_out
    raise ValueError(f"no tensor-core body for {body!r}")


def pack_mats(body: str, mats: Sequence[torch.Tensor], precision: str
              ) -> torch.Tensor:
    """The tensor-core body's matrices, pre-lowered for the tier and laid
    out as its wgmma descriptors read them, packed flat in bf16 on the
    matrices' device. Each term's (n_in, n_out) matrix (r2c: ``[cos|sin]``;
    c2r: ``cos`` and ``-sin``, the sign exact in both bf16 splits) is
    transposed to (rows, n_in), split into its tier's bf16 parts and
    zero-padded to (Rp, Kp): Rp a multiple of the group of ``80 * chunks``
    output columns, Kp of 16. Order: [group][16-deep step][term][part], each
    a K-major grid of 8 x 8 core matrices ([group rows / 8][2][8][8]), so
    one stage of one group is one contiguous block."""
    terms, nch, rows = mat_layout(body, mats[0].shape[1])
    if check_tier(precision) == "highest":
        raise ValueError("the tensor-core body has no float32 tier")
    parts = _PARTS[precision]
    n_in = mats[0].shape[0]
    group = _CHUNK * nch
    Rp = -(-rows // group) * group
    Kp = -(-n_in // _DEPTH) * _DEPTH
    full = torch.zeros((terms, parts, Rp, Kp), dtype=torch.bfloat16,
                       device=mats[0].device)
    if body == "r2c":
        cols = [torch.cat(tuple(mats), 1)]
    elif body == "c2r":
        cols = [mats[0], -mats[1]]
    else:
        cols = list(mats)
    for t, m in enumerate(cols):
        for p, part in enumerate(_dft.tier_parts(m, parts == 1)):
            full[t, p, :rows, :n_in] = part.T
    tiles = full.view(terms, parts, Rp // group, group // 8, 8, Kp // _DEPTH, 2, 8)
    return tiles.permute(2, 5, 0, 1, 3, 6, 4, 7).contiguous().view(-1)


# Packed matrices of the matrix sets the wrappers saw, keyed by the
# matrices' identity and version (an in-place change packs anew); the entry
# keeps the matrices alive, so an id cannot be reused while it is cached.
_PACKED: dict = {}
_PACKED_MAX = 64


def _packed(body: str, mats: Sequence[torch.Tensor], precision: str) -> torch.Tensor:
    key = (body, precision) + tuple((id(m), m._version) for m in mats)
    hit = _PACKED.get(key)
    if hit is None:
        if len(_PACKED) >= _PACKED_MAX:
            _PACKED.pop(next(iter(_PACKED)))
        hit = _PACKED[key] = (tuple(mats), pack_mats(body, mats, precision))
    return hit[1]


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
    """Validate a call and hand it to the custom op ``mvtb::axis_dft``
    (:mod:`._ops`): a CPU tensor runs :func:`plain`, a CUDA tensor
    :func:`launch`, any other device raises."""
    if body not in BODIES:
        raise ValueError(f"unknown kernel body {body!r}")
    n_ins, n_mats, _ = ARITY[body]
    if len(ins) != n_ins or len(mats) != n_mats:
        raise ValueError(f"{body} takes {n_ins} inputs and {n_mats} matrices")
    check_tier(precision)
    dev = ins[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"axis_dft {body}: no kernel for {dev}")
    from mvtb_tpu_torch.ops import _ops

    return tuple(_ops.axis_dft(body, lane, list(ins), list(mats), precision))


def out_view(body: str, lane: bool, view: Sequence[int], n_out: int):
    """(number of outputs, output view) of kernel ``body`` on an input view."""
    if lane:
        return ARITY[body][2], (view[0], n_out)
    return ARITY[body][2], (view[0], n_out, view[2])


def launch(body: str, lane: bool, ins, mats, precision: str):
    """The kernel launch behind :func:`lane_call` / :func:`sub_call` on CUDA
    tensors (the CUDA implementation of ``mvtb::axis_dft``): checks every
    argument, packs the tensor-core body's matrices (cached by the
    matrices' identity, so an exported program's lifted constants pack
    once), allocates the outputs, launches on the current stream and counts
    the launch by body and by (body, route, tier)."""
    n_ins, n_mats, _ = ARITY[body]
    path = route(body, precision)
    dev = ins[0].device
    view = tuple(ins[0].shape)
    if len(view) != (2 if lane else 3):
        raise ValueError(f"axis_dft {body}: bad view {view}")
    n_in = view[-1] if lane else view[1]
    n_out = mats[0].shape[-1]
    for i, t in enumerate(ins):
        _check(f"input {i}", t, view, dev)
    for i, m in enumerate(mats):
        _check(f"matrix {i}", m, (n_in, n_out), dev)
    batch, length = (1, view[0]) if lane else (view[0], view[2])
    n_outs, shape = out_view(body, lane, view, n_out)
    outs = tuple(torch.empty(shape, dtype=torch.float32, device=dev)
                 for _ in range(n_outs))
    if any(n == 0 for n in shape) or n_in == 0:
        return outs
    ptr = [t.data_ptr() for t in ins] + [None] * (2 - n_ins)
    optr = [o.data_ptr() for o in outs] + [None] * (2 - n_outs)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if path == "wgmma":
            packed = _packed(body, mats, precision)
            _, nch, _ = mat_layout(body, n_out)
            cols = length if lane else batch * length
            err = lib.mvtb_axis_dft_tc(BODIES[body], int(lane), _PARTS[precision],
                                       nch, *ptr, packed.data_ptr(), *optr,
                                       cols, n_in, n_out, 1 if lane else length,
                                       stream)
        else:
            mptr = [m.data_ptr() for m in mats] + [None] * (3 - n_mats)
            err = lib.mvtb_axis_dft(BODIES[body], int(lane), *ptr, *mptr, *optr,
                                    batch, n_in, n_out, length, stream)
    if err != 0:
        msg = lib.mvtb_axis_dft_error_string(err).decode()
        raise RuntimeError(f"axis_dft {body} kernel launch failed: {msg} ({err})")
    count(f"launch.axis_dft.{body}")
    count(f"launch.axis_dft.{body}.{path}.{precision}")
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
