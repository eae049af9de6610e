"""The port's hand-written kernels as PyTorch custom operators.

Each kernel entry point is one ``torch.library.custom_op`` in the ``mvtb``
namespace, with three implementations:

* CUDA: the ctypes launch of the kernel (``launch`` in its module: the
  argument checks, the allocation of the outputs and any scratch, the
  launch on the current stream) and its count in the process's counters
  (``utils/profiling.py``: ``launch.fused_plane``, ``launch.sap``,
  ``launch.polar``, ``launch.axis_dft.<body>``,
  ``launch.axis_dft.<body>.<route>.<precision>`` and
  ``launch.selective_scan.fwd`` / ``.bwd``), so a run of an exported
  program counts its launches as an eager run does;
* CPU: the kernel's plain PyTorch version, which the wrapper has always
  taken for a CPU tensor;
* fake (``register_fake``): fresh outputs of the right shapes and types,
  computed from the input shapes alone, so ``torch.export`` traces a call
  with a symbolic batch size.

Every op returns new tensors and mutates no argument. The wrappers
(``fused_plane.plane_stylize_half``, ``pallas_dft.lane_call`` /
``sub_call``, ``pallas_kernels.salt_and_pepper_pallas`` /
``polar_roundtrip_pallas``) keep their signatures and are thin calls of
these ops; ``selective_scan.selective_scan`` is an autograd function over
the scan's forward and backward ops. A program exported with one of them needs this module imported
before ``torch.export.load``; importing it imports no model.

The kernels' own constants are made inside the CUDA implementations on the
device they run on: the plane kernel's packed matrices
(``fused_plane._kernel_mats``) and the axis kernel's packed tensor-core
matrices (``pallas_dft._packed``, cached by the identity of the matrices it
is given; in an exported program those matrices are lifted constants, so
they pack once).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import Tensor
from torch.library import custom_op

from mvtb_tpu_torch.ops import fused_plane as _fp
from mvtb_tpu_torch.ops import pallas_dft as _pd
from mvtb_tpu_torch.ops import pallas_kernels as _pk
from mvtb_tpu_torch.ops import selective_scan as _ss


@custom_op("mvtb::fused_plane", mutates_args=(), device_types="cpu")
def fused_plane(k_re: Tensor, k_im: Tensor, spatial: List[int], flags: List[bool],
                wparams: Tensor, locs: Tensor, vals: Tensor, gates: Tensor,
                conjs: Tensor, scales: Tensor, fast: bool) -> Tuple[Tensor, Tensor]:
    """The fused plane stack (:func:`.fused_plane.plane_stylize_half`)."""
    return _fp.plane_stylize_half_plain(k_re, k_im, spatial, flags, wparams, locs,
                                        vals, gates, conjs, scales, fast)


@fused_plane.register_kernel("cuda")
def _(k_re, k_im, spatial, flags, wparams, locs, vals, gates, conjs, scales, fast):
    return _fp.launch(k_re, k_im, spatial, flags, wparams, locs, vals, gates, conjs,
                      scales, fast)


@fused_plane.register_fake
def _(k_re, k_im, spatial, flags, wparams, locs, vals, gates, conjs, scales, fast):
    return torch.empty_like(k_re), torch.empty_like(k_im)


@custom_op("mvtb::axis_dft", mutates_args=(), device_types="cpu")
def axis_dft(body: str, lane: bool, ins: List[Tensor], mats: List[Tensor],
             precision: str) -> List[Tensor]:
    """One matmul-DFT axis kernel body over a lane ``(M, n_in)`` or sublane
    ``(A, n_in, B)`` view (:func:`.pallas_dft.lane_call` / ``sub_call``)."""
    return list(_pd.plain(body, lane, ins, mats, precision))


@axis_dft.register_kernel("cuda")
def _(body, lane, ins, mats, precision):
    return list(_pd.launch(body, lane, ins, mats, precision))


@axis_dft.register_fake
def _(body, lane, ins, mats, precision):
    n_outs, shape = _pd.out_view(body, lane, ins[0].shape, mats[0].shape[-1])
    return [ins[0].new_empty(shape) for _ in range(n_outs)]


@custom_op("mvtb::sap", mutates_args=(), device_types="cpu")
def sap(x: Tensor, p: Tensor, seed: Tensor) -> Tensor:
    """Salt & pepper with the in-kernel Philox field
    (:func:`.pallas_kernels.salt_and_pepper_pallas`); ``p`` and ``seed``
    are 0-d tensors."""
    return _pk.salt_and_pepper_plain(x, float(p), int(seed))


@sap.register_kernel("cuda")
def _(x, p, seed):
    return _pk.sap_launch(x, p, seed)


@sap.register_fake
def _(x, p, seed):
    return torch.empty_like(x)


@custom_op("mvtb::polar", mutates_args=(), device_types="cpu")
def polar(re: Tensor, im: Tensor) -> Tuple[Tensor, Tensor]:
    """The whole-volume polar round trip
    (:func:`.pallas_kernels.polar_roundtrip_pallas`)."""
    return _pk.polar_roundtrip_plain(re, im)


@polar.register_kernel("cuda")
def _(re, im):
    return _pk.polar_launch(re, im)


@polar.register_fake
def _(re, im):
    return torch.empty_like(re), torch.empty_like(im)


@custom_op("mvtb::selective_scan_fwd", mutates_args=(), device_types="cpu")
def selective_scan_fwd(u: Tensor, delta: Tensor, z: Tensor, B: Tensor, C: Tensor, A: Tensor,
                       D: Tensor, delta_bias: Tensor) -> Tuple[Tensor, Tensor]:
    """The selective scan's gated output and its chunk start states
    (:mod:`.selective_scan`)."""
    return _ss.scan_fwd_plain(u, delta, z, B, C, A, D, delta_bias)


@selective_scan_fwd.register_kernel("cuda")
def _(u, delta, z, B, C, A, D, delta_bias):
    return _ss.fwd_launch(u, delta, z, B, C, A, D, delta_bias)


@selective_scan_fwd.register_fake
def _(u, delta, z, B, C, A, D, delta_bias):
    b, d, L = u.shape
    return (u.new_empty((b, d, L)),
            u.new_empty((b, _ss.chunks(L), d, A.shape[-1]), dtype=_ss.state_dtype(u.dtype)))


@custom_op("mvtb::selective_scan_bwd", mutates_args=(), device_types="cpu")
def selective_scan_bwd(u: Tensor, delta: Tensor, z: Tensor, B: Tensor, C: Tensor, A: Tensor,
                       D: Tensor, delta_bias: Tensor, hstart: Tensor,
                       dout: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor,
                                              Tensor, Tensor]:
    """The selective scan's gradients ``(du, ddelta, dz, dB, dC, dA, dD,
    ddelta_bias)`` (:mod:`.selective_scan`)."""
    return _ss.scan_bwd_plain(u, delta, z, B, C, A, D, delta_bias, hstart, dout)


@selective_scan_bwd.register_kernel("cuda")
def _(u, delta, z, B, C, A, D, delta_bias, hstart, dout):
    return _ss.bwd_launch(u, delta, z, B, C, A, D, delta_bias, hstart, dout)


@selective_scan_bwd.register_fake
def _(u, delta, z, B, C, A, D, delta_bias, hstart, dout):
    p = _ss.state_dtype(A.dtype)
    return (torch.empty_like(u), torch.empty_like(delta), z.new_empty(z.shape),
            torch.empty_like(B), torch.empty_like(C), A.new_empty(A.shape, dtype=p),
            D.new_empty(D.shape, dtype=p), delta_bias.new_empty(delta_bias.shape, dtype=p))
