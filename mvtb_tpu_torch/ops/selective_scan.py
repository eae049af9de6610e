"""Mamba's selective scan (Gu and Dao, arXiv:2312.00752), as SegMamba's
layers run it, forward and backward: a kernel of the port with no TPU
counterpart (``csrc/selective_scan.cu``), its plain PyTorch version, and
the autograd function over both.

Per batch row and channel, with ``dt = softplus(delta + delta_bias)``::

    h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t      (h_{-1} = 0, N states)
    out_t = (C_t . h_t + D u_t) * silu(z_t)

``u``, ``delta`` and ``z`` are ``(batch, d, L)`` (each row contiguous; ``z``
may be a channel slice of a larger tensor), ``B`` and ``C`` are ``(batch,
L, N)``, ``A`` ``(d, N)``, ``D`` and ``delta_bias`` ``(d,)``. The states are
float32 (float64 for float64 inputs) whatever the inputs' type; ``out``
and the gradients of ``u``, ``delta``, ``z``, ``B`` and ``C`` take their
inputs' types, those of ``A``, ``D`` and ``delta_bias`` float32.

Both versions cut the sequence into chunks of ``CHUNK`` positions and hand
the backward the state at each chunk's start, ``(batch, K, d, N)`` with
``K = ceil(L / CHUNK)``: nothing of ``batch * d * L * N`` is kept. The
plain version (:func:`scan_fwd_plain`, :func:`scan_bwd_plain`) is the
recurrence itself, a position at a time inside a chunk and the state
carried from one chunk to the next, with no truncation and no division by
a decay; its backward recomputes a chunk's states from its start and runs
the adjoint recurrence right to left. The kernel computes the chunks in
parallel and joins them by a carry pass (see its source).

:func:`selective_scan` is a :class:`torch.autograd.Function` over the two
custom ops ``mvtb::selective_scan_fwd`` and ``mvtb::selective_scan_bwd``
(:mod:`._ops`). On a CUDA tensor each launches its kernels or raises, and
counts ``launch.selective_scan.fwd`` / ``.bwd`` (``utils/profiling.py``);
on a CPU tensor it runs the plain version and counts nothing. The kernel
takes bfloat16 or float32 inputs and ``N = 16``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from mvtb_tpu_torch.utils.profiling import count

CHUNK = 32        # positions a chunk (the kernel's LC)
KERNEL_STATES = 16
KERNEL_GROUP = 32  # channels a warp: dB and dC come back summed per group
KERNEL_TYPES = {torch.float32: 0, torch.bfloat16: 1}

_LIB = {}


def _lib():
    if "selective_scan" not in _LIB:
        from mvtb_tpu_torch.ops import _build

        lib = _build.load("selective_scan")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        common = [i, p, p, p, p, p, p, p, p, ll, ll, ll, ll, ll, ll, i, i, i, i]
        lib.mvtb_selective_scan_fwd.argtypes = common + [p] * 4
        lib.mvtb_selective_scan_fwd.restype = i
        lib.mvtb_selective_scan_bwd.argtypes = common + [p] * 13
        lib.mvtb_selective_scan_bwd.restype = i
        lib.mvtb_selective_scan_error_string.argtypes = [i]
        lib.mvtb_selective_scan_error_string.restype = ctypes.c_char_p
        _LIB["selective_scan"] = lib
    return _LIB["selective_scan"]


def chunks(L: int) -> int:
    return -(-L // CHUNK)


def state_dtype(dtype: torch.dtype) -> torch.dtype:
    """The states' type: float32, or float64 for float64 inputs."""
    return torch.promote_types(dtype, torch.float32)


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def _plain_inputs(u, delta, z, B, C, A, D, delta_bias):
    f = state_dtype(u.dtype)
    dt_in = delta.to(f) + delta_bias.to(f)[:, None]
    return (f, u.to(f), dt_in, F.softplus(dt_in), z.to(f), B.to(f), C.to(f), A.to(f),
            D.to(f))


def _chunk_states(a: torch.Tensor, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """States after each position of a chunk: ``a`` and ``x`` ``(b, d, n,
    N)`` (decays and inputs), ``h`` the state before it; returns ``(b, d,
    n + 1, N)``, the first row ``h``."""
    H = h.new_empty(a.shape[:2] + (a.shape[2] + 1, a.shape[3]))
    H[:, :, 0] = h
    for j in range(a.shape[2]):
        H[:, :, j + 1] = a[:, :, j] * H[:, :, j] + x[:, :, j]
    return H


def scan_fwd_plain(u, delta, z, B, C, A, D, delta_bias) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, hstart)``: the gated output in ``u``'s type and the state at
    each chunk's start, ``(batch, K, d, N)``."""
    dtype = u.dtype
    f, u, _, dt, z, B, C, A, D = _plain_inputs(u, delta, z, B, C, A, D, delta_bias)
    b, d, L = u.shape
    K = chunks(L)
    hstart = u.new_empty(b, K, d, A.shape[1])
    y = torch.empty_like(u)
    h = u.new_zeros(b, d, A.shape[1])
    for k in range(K):
        t0, t1 = k * CHUNK, min(L, (k + 1) * CHUNK)
        hstart[:, k] = h
        a = torch.exp(dt[:, :, t0:t1, None] * A[:, None])
        x = (dt * u)[:, :, t0:t1, None] * B[:, None, t0:t1]
        H = _chunk_states(a, x, h)
        y[:, :, t0:t1] = (H[:, :, 1:] * C[:, None, t0:t1]).sum(-1)
        h = H[:, :, -1]
    out = (y + D[:, None] * u) * F.silu(z)
    return out.to(dtype), hstart


def scan_bwd_plain(u, delta, z, B, C, A, D, delta_bias, hstart, dout):
    """The gradients ``(du, ddelta, dz, dB, dC, dA, dD, ddelta_bias)`` of
    :func:`scan_fwd_plain`'s output against ``dout``: per chunk, right to
    left, its states recomputed from ``hstart``, then the adjoint
    ``lam_t = g_t C_t + exp(dt_{t+1} A) lam_{t+1}`` (``g = dout * silu(z)``)
    a position at a time, carried into the chunk before."""
    types = (u.dtype, delta.dtype, z.dtype, B.dtype, C.dtype)
    f, u, dt_in, dt, z, B, C, A, D = _plain_inputs(u, delta, z, B, C, A, D, delta_bias)
    b, d, L = u.shape
    zs = torch.sigmoid(z)
    dy = dout.to(f)
    g = dy * z * zs
    dtu = dt * u
    du, ddt, y = torch.empty_like(u), torch.empty_like(u), torch.empty_like(u)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dA = torch.zeros_like(A)
    mu = u.new_zeros(b, d, A.shape[1])
    for k in reversed(range(chunks(L))):
        t0, t1 = k * CHUNK, min(L, (k + 1) * CHUNK)
        a = torch.exp(dt[:, :, t0:t1, None] * A[:, None])
        x = dtu[:, :, t0:t1, None] * B[:, None, t0:t1]
        H = _chunk_states(a, x, hstart[:, k].to(f))
        lam = torch.empty_like(a)
        for j in reversed(range(t1 - t0)):
            lam[:, :, j] = g[:, :, t0 + j, None] * C[:, None, t0 + j] + mu
            mu = a[:, :, j] * lam[:, :, j]
        Hn, Hp = H[:, :, 1:], H[:, :, :-1]
        y[:, :, t0:t1] = (Hn * C[:, None, t0:t1]).sum(-1)
        dC[:, t0:t1] = (g[:, :, t0:t1, None] * Hn).sum(1)
        dB[:, t0:t1] = (lam * dtu[:, :, t0:t1, None]).sum(1)
        sB = (lam * B[:, None, t0:t1]).sum(-1)
        w = lam * a * Hp
        du[:, :, t0:t1] = sB * dt[:, :, t0:t1]
        ddt[:, :, t0:t1] = sB * u[:, :, t0:t1] + (w * A[:, None]).sum(-1)
        dA += (w * dt[:, :, t0:t1, None]).sum((0, 2))
    du = du + g * D[:, None]
    ddelta = ddt * torch.sigmoid(dt_in)
    dz = dy * (y + D[:, None] * u) * zs * (1 + z * (1 - zs))
    grads = (du, ddelta, dz, dB, dC)
    p = state_dtype(A.dtype)
    return (*(t.to(ty) for t, ty in zip(grads, types)), dA.to(p),
            (g * u).sum((0, 2)).to(p), ddelta.sum((0, 2)).to(p))


# --------------------------------------------------------------------------
# The kernel's launch
# --------------------------------------------------------------------------

def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` with unit stride along its last axis (a copy only if needed)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on 16 bytes (a copy only if needed)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(u, delta, z, B, C, A, D, delta_bias) -> None:
    if u.dtype not in KERNEL_TYPES:
        raise NotImplementedError(f"selective_scan: the kernel takes bfloat16 or float32, "
                                  f"got {u.dtype}")
    b, d, L = u.shape
    N = A.shape[-1]
    if N != KERNEL_STATES:
        raise NotImplementedError(f"selective_scan: the kernel has {KERNEL_STATES} states, "
                                  f"got {N}")
    for name, t, shape in (("delta", delta, (b, d, L)), ("z", z, (b, d, L)),
                           ("B", B, (b, L, N)), ("C", C, (b, L, N))):
        if tuple(t.shape) != shape or t.dtype != u.dtype or t.device != u.device:
            raise ValueError(f"selective_scan: {name} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, expected {shape} {u.dtype} on {u.device}")
    for name, t, shape in (("A", A, (d, N)), ("D", D, (d,)), ("delta_bias", delta_bias, (d,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != u.device:
            raise ValueError(f"selective_scan: {name} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, expected {shape} float32 on {u.device}")


def _launch(fn, *args, dev) -> None:
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = _lib().mvtb_selective_scan_error_string(err).decode()
        raise RuntimeError(f"selective_scan launch failed: {msg} ({err})")


def _common(u, delta, z, B, C, A, D, delta_bias):
    """The arguments both entry points share, and the tensors they point
    into (kept alive by the caller)."""
    _check(u, delta, z, B, C, A, D, delta_bias)
    u, delta, z = _rows(u), _rows(delta), _rows(z)
    B, C = _aligned(B), _aligned(C)
    A, D, delta_bias = A.contiguous(), D.contiguous(), delta_bias.contiguous()
    b, d, L = u.shape
    strides = [u.stride(0), u.stride(1), delta.stride(0), delta.stride(1),
               z.stride(0), z.stride(1)]
    vec = int(L % 4 == 0 and all(s % 4 == 0 for s in strides)
              and all(t.data_ptr() % 16 == 0 for t in (u, delta, z)))
    args = [KERNEL_TYPES[u.dtype], u.data_ptr(), delta.data_ptr(), z.data_ptr(), B.data_ptr(),
            C.data_ptr(), A.data_ptr(), D.data_ptr(), delta_bias.data_ptr(), *strides,
            b, d, L, vec]
    return args, (u, delta, z, B, C, A, D, delta_bias)


def fwd_launch(u, delta, z, B, C, A, D, delta_bias) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward's launches on CUDA tensors (the CUDA implementation of
    ``mvtb::selective_scan_fwd``)."""
    args, keep = _common(u, delta, z, B, C, A, D, delta_bias)
    b, d, L = u.shape
    K = chunks(L)
    out = torch.empty((b, d, L), dtype=u.dtype, device=u.device)
    state = torch.empty((b, K, d, KERNEL_STATES), dtype=torch.float32, device=u.device)
    dsum = torch.empty((b, K, d), dtype=torch.float32, device=u.device)
    if out.data_ptr() % 16:
        raise RuntimeError("selective_scan: an output does not start on 16 bytes")
    _launch(_lib().mvtb_selective_scan_fwd, *args, out.data_ptr(), state.data_ptr(),
            dsum.data_ptr(), dev=u.device)
    del keep
    count("launch.selective_scan.fwd")
    return out, state


def bwd_launch(u, delta, z, B, C, A, D, delta_bias, hstart, dout):
    """The backward's launches on CUDA tensors (the CUDA implementation of
    ``mvtb::selective_scan_bwd``)."""
    args, keep = _common(u, delta, z, B, C, A, D, delta_bias)
    b, d, L = u.shape
    K, N = chunks(L), KERNEL_STATES
    dev, f32 = u.device, torch.float32
    if tuple(hstart.shape) != (b, K, d, N) or hstart.dtype != f32:
        raise ValueError(f"selective_scan: hstart is {tuple(hstart.shape)} {hstart.dtype}, "
                         f"expected {(b, K, d, N)} float32")
    hstart, dout = hstart.contiguous(), dout.to(u.dtype).contiguous()
    state = torch.empty((b, K, d, N), dtype=f32, device=dev)
    dsum = torch.empty((b, K, d), dtype=f32, device=dev)
    du, ddelta, dz = (torch.empty((b, d, L), dtype=u.dtype, device=dev) for _ in range(3))
    groups = -(-d // KERNEL_GROUP)
    dBp, dCp = (torch.empty((b, groups, L, N), dtype=f32, device=dev) for _ in range(2))
    dAp = torch.empty((b, K, d, N), dtype=f32, device=dev)
    dDp, dbp = (torch.empty((b, K, d), dtype=f32, device=dev) for _ in range(2))
    if any(t.data_ptr() % 16 for t in (dout, du, ddelta, dz)):
        raise RuntimeError("selective_scan: a gradient does not start on 16 bytes")
    _launch(_lib().mvtb_selective_scan_bwd, *args, dout.data_ptr(), hstart.data_ptr(),
            state.data_ptr(), dsum.data_ptr(), du.data_ptr(), ddelta.data_ptr(), dz.data_ptr(),
            dBp.data_ptr(), dCp.data_ptr(), dAp.data_ptr(), dDp.data_ptr(), dbp.data_ptr(),
            dev=dev)
    del keep
    count("launch.selective_scan.bwd")
    return (du, ddelta, dz, dBp.sum(1).to(B.dtype), dCp.sum(1).to(C.dtype), dAp.sum((0, 1)),
            dDp.sum((0, 1)), dbp.sum((0, 1)))


# --------------------------------------------------------------------------
# The function
# --------------------------------------------------------------------------

class _SelectiveScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, delta, z, B, C, A, D, delta_bias):
        from mvtb_tpu_torch.ops import _ops

        out, hstart = _ops.selective_scan_fwd(u, delta, z, B, C, A, D, delta_bias)
        ctx.save_for_backward(u, delta, z, B, C, A, D, delta_bias, hstart)
        return out

    @staticmethod
    def backward(ctx, dout):
        from mvtb_tpu_torch.ops import _ops

        return tuple(_ops.selective_scan_bwd(*ctx.saved_tensors, dout.contiguous()))


def selective_scan(u: torch.Tensor, delta: torch.Tensor, z: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                   delta_bias: torch.Tensor) -> torch.Tensor:
    """``(C . h + D u) * silu(z)`` of the selective scan (module docstring),
    differentiable in every argument. On a CUDA tensor the kernel runs (or
    the call raises); on a CPU tensor the plain version."""
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"selective_scan: no kernel for {u.device}")
    return _SelectiveScan.apply(u, delta, z, B, C, A, D, delta_bias)
