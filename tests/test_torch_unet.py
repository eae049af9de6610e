"""The port's 3D ResUNet (mvtb_tpu_torch/models) against the JAX package's,
with weights converted from the flax tree.

The JAX side runs its default (slab-lowered) convolutions; the port runs
plain conv3d with flax's SAME padding. Tolerance: 1e-4 of the output's max
(float32 convolutions summed in another order, through several
normalisations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtb_tpu.models.unet3d import UNet as JUNet
from mvtb_tpu_torch.models import UNet, unet_params_from_flax
from mvtb_tpu_torch.models.unet3d import ConvTranspose, _same_pads


def converted(jmodel, x_cl, seed=0, **kw):
    """Init the flax model, perturb every leaf so biases and slopes are not
    at their init values, and build the port's model with those weights."""
    variables = jax.jit(jmodel.init)(jax.random.key(seed), jnp.asarray(x_cl))
    leaves, tree = jax.tree.flatten(variables["params"])
    rng = np.random.RandomState(seed)
    leaves = [np.asarray(v) + np.float32(0.05) * np.asarray(
        rng.randn(*np.shape(v)), np.float32) for v in leaves]
    params = jax.tree.unflatten(tree, leaves)
    model = UNet(x_cl.shape[-1], jmodel.out_channels, jmodel.channels,
                 jmodel.strides, jmodel.num_res_units, device="cpu", **kw)
    model.load_state_dict(unet_params_from_flax(jax.device_get(params)),
                          strict=True)
    return model, params


def forward_both(jmodel, x_cf, seed=0):
    x_cl = np.moveaxis(x_cf, 1, -1)
    model, params = converted(jmodel, x_cl, seed)
    ref = np.moveaxis(np.asarray(jax.jit(jmodel.apply)(
        {"params": params}, jnp.asarray(x_cl))), -1, 1)
    with torch.no_grad():
        got = model(torch.from_numpy(x_cf)).numpy()
    return got, ref


def rel_err(got, ref):
    return float(np.abs(got - ref).max()) / float(np.abs(ref).max())


def test_full_width_unet_matches_flax():
    x = np.random.RandomState(1).randn(1, 4, 16, 16, 16).astype(np.float32)
    got, ref = forward_both(JUNet(out_channels=3), x)
    assert got.shape == ref.shape == (1, 3, 16, 16, 16)
    assert rel_err(got, ref) < 1e-4


def test_narrow_three_level_unet_matches_flax():
    x = np.random.RandomState(2).randn(2, 1, 48, 48, 16).astype(np.float32)
    jm = JUNet(out_channels=2, channels=(4, 8, 16), strides=(2, 2))
    got, ref = forward_both(jm, x, seed=3)
    assert rel_err(got, ref) < 1e-4


def test_parameter_count_is_the_reference_anchor():
    m = UNet(4, 3, device="cpu")
    assert sum(p.numel() for p in m.parameters()) == 4_810_074
    jm = JUNet(out_channels=3)
    v = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, 16, 16, 16, 4)))
    assert sum(x.size for x in jax.tree.leaves(v)) == 4_810_074


def test_converted_names_cover_the_module():
    jm = JUNet(out_channels=3, channels=(4, 8, 16), strides=(2, 2))
    v = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((1, 16, 16, 8, 4)))
    sd = unet_params_from_flax(jax.device_get(v["params"]))
    m = UNet(4, 3, (4, 8, 16), (2, 2), device="cpu")
    assert set(sd) == set(m.state_dict())
    for k, t in sd.items():
        assert t.shape == m.state_dict()[k].shape, k
    assert sd["ConvNormAct_0.PReLU_0.weight"].shape == (1,)


@pytest.mark.parametrize("n,k,s,pads", [
    (16, 3, 2, (0, 1)), (15, 3, 2, (1, 1)), (16, 3, 1, (1, 1)), (16, 1, 1, (0, 0))])
def test_same_padding_rule(n, k, s, pads):
    assert _same_pads(n, k, s) == pads


def test_transposed_conv_matches_flax():
    import flax.linen as nn

    x = np.random.RandomState(4).randn(2, 5, 6, 4, 3).astype(np.float32)
    ct = nn.ConvTranspose(7, (3, 3, 3), (2, 2, 2), padding="SAME")
    v = ct.init(jax.random.key(1), jnp.asarray(x))
    ref = np.moveaxis(np.asarray(ct.apply(v, jnp.asarray(x))), -1, 1)
    m = ConvTranspose(3, 7, 3, 2, device="cpu")
    kern = np.asarray(v["params"]["kernel"])
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(
            np.flip(kern, (0, 1, 2)).transpose(3, 4, 0, 1, 2).copy()))
        m.bias.copy_(torch.from_numpy(np.array(v["params"]["bias"])))
        got = m(torch.from_numpy(np.moveaxis(x, -1, 1).copy())).numpy()
    assert got.shape == ref.shape == (2, 7, 10, 12, 8)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_unet_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        UNet(4, 3)
