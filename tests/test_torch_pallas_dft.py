"""The port's matmul-DFT axis transforms (mvtb_tpu_torch/ops/pallas_dft.py
and ops/dft.py) against the JAX package's.

The JAX Pallas kernels run as the JAX tests run them on the CPU, in
interpret mode; the port runs its plain PyTorch versions on CPU tensors.
Inputs are drawn with numpy and handed to both.

Tolerances, relative to the output's max:

* 1e-5 for the port's ``"highest"`` against JAX ``HIGHEST`` (float32 on both
  sides, summed in another order);
* 1e-5 for the port's ``"high"`` against JAX ``HIGH``: bf16x3 on both sides,
  the same split (bit for bit) and the same ``hi.hi + (hi.lo + lo.hi)``
  products, summed in another float32 order; measured at most 1.9e-6 for
  the n-D transforms and 5.3e-8 for one kernel body. (The port's float32
  ``"highest"`` differs from JAX ``HIGH`` by up to 1.4e-5: the bf16x3 split
  is that error.)
* 2e-2 for ``"default"``: both sides round every operand to bf16 and
  accumulate in float32 in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from functools import partial

from mvtb_tpu.ops import dft as jdft
from mvtb_tpu.ops import pallas_dft as jpdft
from mvtb_tpu_torch.ops import dft as tdft
from mvtb_tpu_torch.ops import pallas_dft as tpdft
from mvtb_tpu_torch.utils import profiling

P = jax.lax.Precision
# port tier -> (JAX precision, tolerance)
TIERS = {"highest": ("highest", P.HIGHEST, 1e-5),
         "high": ("high", P.HIGH, 1e-5),
         "default": ("default", P.DEFAULT, 2e-2)}
KERNELS = {"r2c": jpdft._r2c_kernel, "c2c": jpdft._c2c_kernel,
           "c2r": jpdft._c2r_kernel}
CPU = torch.device("cpu")


def rel_err(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max()) / float(np.abs(ref).max())


def _mats(body, lane):
    """(n_in, n_out) matrices of one body: the half matrices on the lane
    (as ``rdft_nd`` / ``irdft_nd_real`` use them), the full symmetric ones
    on the sublane."""
    if body == "r2c":
        return tdft.device_mats("half", 13, False, CPU) if lane else \
            tdft.device_mats("full", 7, False, CPU)
    if body == "c2r":
        return tdft.device_mats("half_inv", 12, True, CPU) if lane else \
            tdft.device_mats("full", 7, True, CPU)
    return tdft.device_mats("gauss", 13 if lane else 7, True, CPU)


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("lane", [True, False], ids=["lane", "sublane"])
@pytest.mark.parametrize("body", ["r2c", "c2c", "c2r"])
def test_axis_body_matches_jax_kernel(body, lane, tier):
    precision, jprec, tol = TIERS[tier]
    mats = _mats(body, lane)
    n_in, n_out = mats[0].shape
    n_data, _, n_outs = tpdft.ARITY[body]
    view = (37, n_in) if lane else (3, n_in, 11)
    rng = np.random.RandomState(len(body) + 2 * lane)
    ins = [rng.randn(*view).astype(np.float32) for _ in range(n_data)]
    kern = partial(KERNELS[body], jpdft._fast(jprec), trans=not lane)
    jmats = [jnp.asarray(m.numpy()) for m in mats]
    jins = [jnp.asarray(a) for a in ins]
    if lane:
        ref = jpdft._lane_call(kern, n_in, n_out, jins, jmats, n_outs, True)
        got = tpdft.lane_call(body, [torch.from_numpy(a) for a in ins], mats,
                              precision)
    else:
        ref = jpdft._sub_call(kern, 1, n_in, n_out, jins, jmats, n_outs, True)
        got = tpdft.sub_call(body, [torch.from_numpy(a) for a in ins], mats,
                             precision)
    assert len(got) == len(ref) == n_outs
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        assert rel_err(g.numpy(), r) < tol, (body, lane, tier)


def _nd_input(fn, seed):
    rng = np.random.RandomState(seed)
    if fn in ("rdft_nd",):
        return rng.randn(2, 7, 6, 5).astype(np.float32), (1, 2, 3)
    if fn == "irdft_nd_real":
        x = rng.randn(2, 7, 6, 6).astype(np.float32)
        return np.fft.rfftn(x, axes=(1, 2, 3)).astype(np.complex64), (1, 2, 3)
    z = (rng.randn(2, 7, 6, 4) + 1j * rng.randn(2, 7, 6, 4)).astype(np.complex64)
    return z, (0, 2, 3) if seed % 2 else (1, 2)


def _nd_call(mod, fn, x, axes, precision, **kw):
    if fn == "irdft_nd_real":
        return getattr(mod, fn)(x, (7, 6, 6), axes, precision, **kw)
    return getattr(mod, fn)(x, axes, precision, **kw)


ND = ["rdft_nd", "irdft_nd_real", "dft_nd", "idft_nd", "idft_nd_real"]


@pytest.mark.parametrize("fn", ND)
def test_nd_transforms_match_jax_pallas(fn):
    x, axes = _nd_input(fn, 1)
    ref = _nd_call(jpdft, fn, jnp.asarray(x), axes, P.HIGHEST, interpret=True)
    got = _nd_call(tpdft, fn, torch.from_numpy(x), axes, "highest")
    assert tuple(got.shape) == ref.shape
    assert rel_err(got.numpy(), ref) < 1e-5, fn
    if fn in ("dft_nd", "idft_nd", "idft_nd_real"):  # real input too
        xr = np.ascontiguousarray(x.real)
        ref = _nd_call(jpdft, fn, jnp.asarray(xr), axes, P.HIGHEST, interpret=True)
        got = _nd_call(tpdft, fn, torch.from_numpy(xr), axes, "highest")
        assert rel_err(got.numpy(), ref) < 1e-5, fn


@pytest.mark.parametrize("fn", ND)
def test_nd_transforms_high_match_jax_high(fn):
    """The path's tier: bf16x3 on both sides, real and complex inputs."""
    for seed in (1, 2):
        x, axes = _nd_input(fn, seed)
        inputs = [x] + ([np.ascontiguousarray(x.real)] if np.iscomplexobj(x)
                        and fn != "irdft_nd_real" else [])
        for xi in inputs:
            ref = _nd_call(jpdft, fn, jnp.asarray(xi), axes, P.HIGH, interpret=True)
            got = _nd_call(tpdft, fn, torch.from_numpy(xi), axes, "high")
            assert tuple(got.shape) == ref.shape
            assert rel_err(got.numpy(), ref) < 1e-5, (fn, seed)


@pytest.mark.parametrize("shape", [(2, 16, 16, 11), (2, 4, 24, 20, 14)])
def test_pair_round_trip_high_matches_jax_high(shape):
    """``rdft_nd_pair`` and ``irdft_nd_real_pair`` at ``"high"``, the pair
    ``stylize_kspace`` runs, against JAX's ``rdft_nd`` / ``irdft_nd_real``
    at ``HIGH``; the port's ``"highest"`` is measurably further away."""
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    axes = tuple(range(1, len(shape)))
    ref = np.asarray(jpdft.rdft_nd(jnp.asarray(x), axes, P.HIGH, interpret=True))
    back = jpdft.irdft_nd_real(jnp.asarray(ref), shape[1:], axes, P.HIGH,
                               interpret=True)
    re, im = tpdft.rdft_nd_pair(torch.from_numpy(x), axes, "high")
    assert rel_err(torch.complex(re, im).numpy(), ref) < 1e-5
    spec = [torch.from_numpy(np.ascontiguousarray(p)) for p in (ref.real, ref.imag)]
    got = tpdft.irdft_nd_real_pair(*spec, shape[1:], axes, "high")
    assert rel_err(got.numpy(), back) < 1e-5
    f32 = tpdft.irdft_nd_real_pair(*spec, shape[1:], axes, "highest")
    assert rel_err(f32.numpy(), back) > rel_err(got.numpy(), back)


@pytest.mark.parametrize("tier", ["highest", "default"])
@pytest.mark.parametrize("fn", ND)
def test_matmul_dft_matches_jax(fn, tier):
    precision, jprec, tol = TIERS[tier]
    x, axes = _nd_input(fn, 2)
    ref = _nd_call(jdft, fn, jnp.asarray(x), axes, jprec)
    got = _nd_call(tdft, fn, torch.from_numpy(x), axes, precision)
    assert tuple(got.shape) == ref.shape and got.dtype in (torch.float32, torch.complex64)
    assert rel_err(got.numpy(), ref) < tol, (fn, tier)


def test_nd_transforms_match_numpy_fft():
    rng = np.random.RandomState(3)
    x = rng.randn(3, 8, 5, 6).astype(np.float32)
    k = tpdft.rdft_nd(torch.from_numpy(x), (1, 2, 3))
    assert rel_err(k.numpy(), np.fft.rfftn(x, axes=(1, 2, 3))) < 1e-5
    back = tpdft.irdft_nd_real(k, (8, 5, 6), (1, 2, 3))
    assert rel_err(back.numpy(), x) < 1e-5
    with pytest.raises(ValueError, match="half axis last"):
        tpdft.rdft_nd(torch.from_numpy(x), (1, 3, 2))


def test_use_matmul_dft_matches_jax():
    for spatial in [(240, 240, 155), (16, 12, 10), (64, 8192, 8), (4096,)]:
        assert tdft.use_matmul_dft(spatial) == jdft.use_matmul_dft(spatial)


def test_matrices_are_the_jax_matrices():
    for n in (5, 12, 155):
        for inverse in (False, True):
            for a, b in zip(tdft._dft_matrix_np(n, inverse),
                            jdft._dft_matrix_np(n, inverse)):
                assert np.array_equal(a, b)
            for a, b in zip(tdft._gauss_dft_matrices_np(n, inverse),
                            jdft._gauss_dft_matrices_np(n, inverse)):
                assert np.array_equal(a, b)


@pytest.mark.parametrize("body", ["r2c", "c2c", "c2r"])
def test_wrapper_takes_plain_only_for_cpu_tensors(body):
    mats = _mats(body, True)
    n_in = mats[0].shape[0]
    ins = [torch.randn(9, n_in) for _ in range(tpdft.ARITY[body][0])]
    before = profiling.counters.copy()
    for precision in tpdft.TIERS:
        got = tpdft.lane_call(body, ins, mats, precision)
        ref = tpdft.plain(body, True, ins, mats, precision)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert profiling.counters == before  # no kernel ran: no counter moved
    meta = [t.to("meta") for t in ins]
    with pytest.raises(ValueError, match="no kernel"):
        tpdft.lane_call(body, meta, mats)
    with pytest.raises(ValueError, match="precision"):
        tpdft.lane_call(body, ins, mats, "bf16")
