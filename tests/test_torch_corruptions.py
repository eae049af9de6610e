"""The port's corruption library (mvtb_tpu_torch/ops/fourier.py, masks.py,
corruptions.py) against the JAX package's, on the same numpy inputs.

Tolerances:

* masks are built by the same numpy code (float64 for the Gibbs distance),
  or by the same float32 torch/jnp arithmetic for a tensor parameter: they
  must be bit-identical;
* ``salt_and_pepper(u=...)`` is a select on the same field: bit-exact;
* every op with an FFT round trip: 1e-5 of the output's max (float32 on
  both sides, PyTorch's and XLA's CPU FFTs sum in another order);
* the gradient of a loss through ``soft_gibbs_mask`` in alpha: 1e-5
  relative, for the same reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtb_tpu import ops as jops
from mvtb_tpu_torch import ops as tops
from mvtb_tpu_torch.ops import corruptions, fourier, masks

SHAPE_3D = (2, 24, 20, 15)  # (C,H,W,D), odd depth exercises shift conventions
SHAPE_2D = (3, 32, 17)
TOL = 1e-5


def _rand(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def assert_rel(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max())
    assert float(np.abs(got - ref).max()) <= tol * scale


def both(fn_name, x, *args, **kw):
    """The JAX op and the port's op of the same name on ``x``."""
    ref = getattr(jops, fn_name)(jnp.asarray(x), *args, **kw)
    got = getattr(tops, fn_name)(torch.from_numpy(x), *args, **kw)
    return got, ref


# ---------------------------------------------------------------- masks ----

@pytest.mark.parametrize("r", [2.0, 5.5, 9.0, 100.0])
@pytest.mark.parametrize("inside_off", [False, True])
def test_disk_mask_bit_identical(r, inside_off):
    got = masks.disk_mask(SHAPE_3D[1:], r, inside_off)
    ref = np.asarray(jops.disk_mask(SHAPE_3D[1:], r, inside_off))
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    # a tensor radius builds the same grid in float32, as a traced one does
    traced = jax.jit(lambda rr: jops.disk_mask(SHAPE_3D[1:], rr, inside_off))(jnp.float32(r))
    tensor = masks.disk_mask(SHAPE_3D[1:], torch.tensor(r), inside_off)
    np.testing.assert_array_equal(tensor.numpy(), np.asarray(traced))


@pytest.mark.parametrize("alpha", [0.0, 0.1, 0.37, 0.5, 0.99, 1.0])
def test_gibbs_mask_bit_identical(alpha):
    got = masks.gibbs_mask((24, 20, 15), alpha)
    ref = np.asarray(jops.gibbs_mask((24, 20, 15), alpha))
    assert got.dtype == ref.dtype == np.bool_
    np.testing.assert_array_equal(got, ref)
    traced = jax.jit(lambda a: jops.gibbs_mask((24, 20, 15), a))(jnp.float32(alpha))
    tensor = masks.gibbs_mask((24, 20, 15), torch.tensor(alpha))
    np.testing.assert_array_equal(tensor.numpy(), np.asarray(traced))


def test_gibbs_mask_2d_bit_identical():
    np.testing.assert_array_equal(masks.gibbs_mask((240, 240), 0.42),
                                  np.asarray(jops.gibbs_mask((240, 240), 0.42)))


@pytest.mark.parametrize("alpha", [0.3, 0.8])
def test_layer_masks_match(alpha):
    ref = np.asarray(jops.reference_gibbs_layer_mask((16, 16, 8), alpha))
    got = masks.reference_gibbs_layer_mask((16, 16, 8), alpha, device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref)
    assert set(np.unique(got.numpy()).tolist()) <= {0.0, 1.0}
    ref = np.asarray(jops.soft_gibbs_mask((16, 16, 8), alpha, tau=2.0))
    got = masks.soft_gibbs_mask((16, 16, 8), torch.tensor(alpha), tau=2.0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)


def test_soft_gibbs_mask_gradient_matches_jax():
    x = _rand((1, 16, 16, 8))

    def jloss(alpha):
        k = jops.fft_shifted(jnp.asarray(x), 3)
        m = jops.soft_gibbs_mask(x.shape[1:], alpha)
        return jnp.sum(jops.ifft_shifted_real(k * m.astype(jnp.complex64), 3) ** 2)

    ref = float(jax.grad(jloss)(jnp.float32(0.5)))
    alpha = torch.tensor(0.5, requires_grad=True)
    k = fourier.fft_shifted(torch.from_numpy(x), 3)
    m = masks.soft_gibbs_mask(x.shape[1:], alpha)
    torch.sum(fourier.ifft_shifted_real(k * m.to(torch.complex64), 3) ** 2).backward()
    assert np.isfinite(ref) and abs(ref) > 0
    assert abs(float(alpha.grad) - ref) <= TOL * abs(ref)


def test_sample_ellipsoid_draws_as_jax():
    a, b = np.random.RandomState(0), np.random.RandomState(0)
    shell = masks.ellipsoid_shell_mask((24, 20, 15), 10, 8, 5)
    for _ in range(10):
        c = masks.sample_ellipsoid((24, 20, 15), 10, 8, 5, a)
        assert c == jops.sample_ellipsoid((24, 20, 15), 10, 8, 5, b)
        assert shell[c]


# ------------------------------------------------------------- fourier ----

def test_fourier_matches_and_round_trips():
    x = _rand(SHAPE_3D)
    k = fourier.fft_shifted(torch.from_numpy(x), 3)
    assert k.dtype == torch.complex64
    assert_rel(k, jops.fft_shifted(jnp.asarray(x), 3))
    back = fourier.ifft_shifted_real(k, 3)
    assert back.dtype == torch.float32
    assert_rel(back, x)
    assert_rel(fourier.ifft_shifted(k, 3), jops.ifft_shifted(jops.fft_shifted(jnp.asarray(x), 3), 3))


# ---------------------------------------------------------------- ops ----

@pytest.mark.parametrize("r,inside_off", [(5.0, False), (5.0, True), (9.5, False)])
def test_fourier_disk_filter_matches(r, inside_off):
    assert_rel(*both("fourier_disk_filter", _rand(SHAPE_3D), r, 3, inside_off))


@pytest.mark.parametrize("alpha", [0.0, 0.3, 0.7, 1.0])
def test_gibbs_noise_matches(alpha):
    assert_rel(*both("gibbs_noise", _rand(SHAPE_3D), alpha))


def test_gibbs_noise_alpha0_is_identity():
    x = _rand(SHAPE_3D)
    assert_rel(tops.gibbs_noise(torch.from_numpy(x), 0.0), x)


def test_gibbs_noise_2d():
    assert_rel(*both("gibbs_noise", _rand(SHAPE_2D), 0.4))


def test_kspace_spike_channel_specific():
    locs = [(0, 3, 4, 5), (1, 10, 2, 7)]
    assert_rel(*both("kspace_spike", _rand(SHAPE_3D), locs, [12.0, 13.5]))


def test_kspace_spike_broadcast_per_channel_vector():
    vals = [np.array([13.0, 14.0], np.float32)]
    assert_rel(*both("kspace_spike", _rand(SHAPE_3D), [(10, 2, 7)], vals))
    with pytest.raises(ValueError, match="length"):
        tops.kspace_spike(torch.from_numpy(_rand(SHAPE_3D)), [(1, 2)], [1.0])


def test_default_spike_intensity_stats():
    got, ref = both("default_spike_intensity_stats", _rand(SHAPE_3D))
    assert tuple(got.shape) == (2,)
    assert_rel(got, ref)


def test_plane_wave_matches():
    assert_rel(*both("plane_wave", _rand(SHAPE_3D), (5, 6, 7), 14.0))
    x = torch.from_numpy(_rand(SHAPE_3D))
    assert torch.equal(tops.plane_wave(x, torch.tensor([5, 6, 7]), 14.0),
                       tops.plane_wave(x, (5, 6, 7), 14.0))


def test_plane_wave_keeps_log_zero():
    # a constant volume has one nonzero k point: log|k| is -inf everywhere
    # else, exp(-inf) is 0, and the written point stays the only change
    x = np.full(SHAPE_3D, 0.5, np.float32)
    got, ref = both("plane_wave", x, (5, 6, 7), 3.0)
    assert bool(torch.isfinite(got).all())
    assert_rel(got, ref)


@pytest.mark.parametrize("alpha", [0.0, 0.25, 0.5, 1.0])
def test_wrap_artifact_matches(alpha):
    assert_rel(*both("wrap_artifact", _rand(SHAPE_3D), alpha))


def test_wrap_alpha1_is_identity():
    x = _rand(SHAPE_3D)
    assert_rel(tops.wrap_artifact(torch.from_numpy(x), 1.0), x)


@pytest.mark.parametrize("p", [0.0, 0.1, 0.35])
def test_salt_and_pepper_bit_exact(p):
    x = _rand(SHAPE_3D)
    u = np.random.RandomState(1).rand(*SHAPE_3D).astype(np.float32)
    ref = np.asarray(jops.salt_and_pepper(jnp.asarray(x), p, u=jnp.asarray(u)))
    got = tops.salt_and_pepper(torch.from_numpy(x), p, u=torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_salt_and_pepper_p0_is_identity_and_needs_a_field():
    x = torch.from_numpy(_rand(SHAPE_3D))
    out = tops.salt_and_pepper(x, 0.0, torch.Generator().manual_seed(0))
    assert torch.equal(out, x)
    with pytest.raises(ValueError, match="generator"):
        tops.salt_and_pepper(x, 0.1)


@pytest.mark.parametrize("p", [0.0, 0.2, 0.9])
def test_rand_zero_fill_matches(p):
    x = _rand(SHAPE_3D)
    u = np.random.RandomState(2).rand(*SHAPE_3D).astype(np.float32)
    ref = jops.rand_zero_fill(jnp.asarray(x), p, u=jnp.asarray(u))
    assert_rel(tops.rand_zero_fill(torch.from_numpy(x), p, u=torch.from_numpy(u)), ref)


@pytest.mark.parametrize("channel_wise", [True, False])
def test_kspace_spike_random(channel_wise):
    x = torch.from_numpy(_rand(SHAPE_3D))
    g = torch.Generator().manual_seed(3)
    out = tops.kspace_spike_random(x, g, (12.0, 13.0), channel_wise=channel_wise)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert not torch.allclose(out, x)
    again = tops.kspace_spike_random(x, torch.Generator().manual_seed(3), (12.0, 13.0),
                                     channel_wise=channel_wise)
    assert torch.equal(out, again)
    with pytest.raises(ValueError, match="C, \\*spatial"):
        tops.kspace_spike_random(x[None], g, (12.0, 13.0), n_dims=3)


def test_sap_select_is_the_one_select():
    x = torch.from_numpy(_rand((64,)))
    u = torch.linspace(0, 1, 64)
    p = torch.tensor(0.5)
    out = corruptions.sap_select(x, u, p, x.min() / 2, x.max() / 2)
    assert torch.equal(out[u <= 0.25], (x.min() / 2).expand(int((u <= 0.25).sum())))
    assert torch.equal(out[u > 0.5], x[u > 0.5])
