"""The port's FID (mvtb_tpu_torch/eval/fid.py) against the JAX package's.

The Frechet distance is the same numpy formula on both sides (held to 1e-9
relative); the feature nets are held to 1e-5 of their max, the JAX weights
handed to the port (the port draws its default weights from a
``torch.Generator``, which cannot replay flax's threefry init).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mvtb_tpu.eval import fid as jfid
from mvtb_tpu.models.dcgan import Discriminator as JD
from mvtb_tpu_torch.eval import fid as tfid
from mvtb_tpu_torch.models import (Discriminator, Generator, dcgan_params_from_flax,
                                   fid_encoder_weights_from_flax)

from test_torch_gan_models import flax_variables, nchw, rel
from test_torch_gan_models import one_torch_thread  # noqa: F401  (autouse)


def test_frechet_distance_equals_jax():
    rng = np.random.RandomState(0)
    for d in (1, 5, 32):
        a = rng.randn(200, d) * rng.uniform(0.5, 2, d) + rng.randn(d)
        b = rng.randn(150, d) @ (np.eye(d) + 0.1 * rng.randn(d, d))
        ref = jfid.fid_score(a, b)
        got = tfid.fid_score(a, b)
        assert abs(got - ref) <= 1e-9 * abs(ref), d
        mu, cov = tfid.feature_statistics(a)
        jmu, jcov = jfid.feature_statistics(a)
        assert np.array_equal(mu, jmu) and np.array_equal(cov, jcov)
        assert abs(tfid.frechet_distance(mu, cov, mu, cov)) < 1e-8


def test_frozen_encoder_with_jax_weights_matches():
    enc = jfid.FrozenFeatureEncoder(nc=1, seed=0)
    x = np.tanh(np.random.RandomState(1).randn(4, 128, 128, 1)).astype(np.float32)
    ref = np.asarray(enc(jnp.asarray(x)))
    weights = fid_encoder_weights_from_flax(jax.device_get(enc._params))
    port = tfid.FrozenFeatureEncoder(nc=1, weights=weights, device="cpu")
    got = port(nchw(x))
    assert got.shape == (4, 256)
    assert rel(got.numpy(), ref) < 1e-5


def test_frozen_encoder_is_a_function_of_its_seed():
    x = torch.randn(2, 1, 64, 64, generator=torch.Generator().manual_seed(0))
    a = tfid.FrozenFeatureEncoder(nc=1, seed=0, device="cpu")
    b = tfid.FrozenFeatureEncoder(nc=1, seed=0, device="cpu")
    c = tfid.FrozenFeatureEncoder(nc=1, seed=1, device="cpu")
    assert torch.equal(a(x), b(x)) and not torch.equal(a(x), c(x))
    # flax Conv's lecun-normal: variance 1/fan_in, truncated at 2 deviations
    w = a.weights[-1]
    fan_in = w.shape[1] * 16
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.05
    assert float(w.abs().max()) <= 2.0 / np.sqrt(fan_in) / 0.87962566103423978 + 1e-6


def test_discriminator_features_match_jax():
    nf = 16
    x = np.tanh(np.random.RandomState(2).randn(4, 128, 128, 1)).astype(np.float32)
    jd = JD(nc=1, ndf=nf)
    dv = flax_variables(jd, jnp.asarray(x), 0, train=False)
    ref = np.asarray(jfid.discriminator_features(jd.apply, dv, jnp.asarray(x)))
    d = Discriminator(1, nf, device="cpu")
    d.load_state_dict(dcgan_params_from_flax(dv["params"], dv["batch_stats"]))
    got = tfid.discriminator_features(d, nchw(x))
    assert got.shape == (4, nf * 16) and d.training  # mode restored
    assert rel(got.numpy(), ref) < 1e-5


def test_dcgan_fid_end_to_end():
    g = Generator(100, 16, 1, device="cpu", generator=torch.Generator().manual_seed(0))
    d = Discriminator(1, 16, device="cpu", generator=torch.Generator().manual_seed(1))
    reals = [np.tanh(np.random.RandomState(s).randn(4, 1, 128, 128)).astype(np.float32)
             for s in range(3)]

    def score(**kw):
        return tfid.dcgan_fid(g, d, reals, generator=torch.Generator().manual_seed(777),
                              **kw)

    a, b = score(), score()
    assert abs(a - b) <= 1e-6 * a and np.isfinite(a) and a > 0  # CPU threads sum in any order
    assert g.training  # eval mode only inside
    assert np.isfinite(score(features="discriminator"))
    assert np.isfinite(score(n_fake=6))
