"""The port's stylization layers and models (mvtb_tpu_torch/models/layers.py)
against the JAX package's (mvtb_tpu/models/layers.py): the Gibbs layer's
soft and hard masks and its alpha gradient (the clip's halved gradient at
the bounds included), the spike layer with JAX's locations replayed, the
flax-tree converter, the whole models, and the hard mask at alpha = 0,
which hands the UNet an all-zero volume."""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtb_tpu.models import layers as jl
from mvtb_tpu.train.losses import dice_loss as jdice
from mvtb_tpu_torch.models import (Gibbs_UNet, GibbsNoiseLayer, GibbsUNet, SpikeLayer,
                                   Spikes_UNet, SpikesUNet, learnable_params_from_flax,
                                   spike_layer, unet_params_from_flax)
from mvtb_tpu_torch.ops.corruptions import kspace_spike
from mvtb_tpu_torch.train.losses import dice_loss
from test_torch_train_seg import _norm_fed_biases
from test_torch_gan_models import one_torch_thread  # noqa: F401  (autouse)

SHAPE = (2, 2, 16, 16, 12)
# a UNet of two levels, 1 -> 1, over 16^3
WIDTHS = dict(out_channels=1, channels=(4, 8), strides=(2,), num_res_units=1)
VOL = (2, 1, 16, 16, 16)
# forward outputs, port against JAX, relative to the output's max: both are
# float32 FFTs of the same masked spectrum (measured <= 2.8e-7)
FWD_TOL = 1e-5
# d(loss)/d(parameter) relative to JAX's: float32 sums of the same terms in
# another order (measured <= 1.3e-6)
GRAD_TOL = 1e-4
# whole-model gradients, the largest difference over the largest gradient
MODEL_GRAD_TOL = 1e-4


def _data(seed=0, shape=SHAPE):
    rng = np.random.RandomState(seed)
    return rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)


class _RngProbe(fnn.Module):
    """Returns what ``make_rng("corruption")`` gives a module at its place."""

    @fnn.compact
    def __call__(self):
        return self.make_rng("corruption")


class _AtPath(fnn.Module):
    layer: str

    @fnn.compact
    def __call__(self):
        return _RngProbe(name=self.layer)()


def jax_spike_locations(key, shape, layer=None):
    """The locations JAX's ``SpikeLayer`` draws for a batch of ``shape``
    (B, C, *spatial) when the model is applied with ``rngs={"corruption":
    key}``: flax derives the layer's key from ``key`` and the layer's place
    (the top level, or the submodule named ``layer``); then one key a
    sample, its location key split per axis (``kspace_spike_random``,
    ``channel_wise=False``)."""
    probe = _RngProbe() if layer is None else _AtPath(layer)
    layer_key = probe.apply({}, rngs={"corruption": key})
    nd = len(shape) - 2
    rows = []
    for k in jax.random.split(layer_key, shape[0]):
        k_loc, _ = jax.random.split(k)
        loc_keys = jax.random.split(k_loc, nd)
        rows.append([int(jax.random.randint(loc_keys[d], (), 0, shape[2 + d]))
                     for d in range(nd)])
    return torch.tensor(rows, dtype=torch.int64)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
@pytest.mark.parametrize("alpha", [0.0, 0.35, 1.0])
def test_gibbs_layer_matches_jax(hard, alpha):
    x, w = _data()
    jm = jl.GibbsNoiseLayer(hard=hard)

    def jloss(a):
        return jnp.sum(jm.apply({"params": {"alpha": a}}, jnp.asarray(x)) * w)

    a0 = jnp.array([alpha], jnp.float32)
    jy = np.asarray(jm.apply({"params": {"alpha": a0}}, jnp.asarray(x)))
    jg = float(jax.grad(jloss)(a0)[0])
    layer = GibbsNoiseLayer(alpha, hard=hard, device="cpu")
    y = layer(torch.from_numpy(x))
    if hard and alpha == 0.0:
        # nothing is kept: dist / (0 * max) is inf, or NaN at a center point
        assert not jy.any() and not y.detach().numpy().any()
    else:
        assert _rel(y.detach().numpy(), jy) <= FWD_TOL
    loss = (y * torch.from_numpy(w)).sum()
    if hard:
        # the hard mask has no gradient in alpha: zero in JAX, no graph here
        assert jg == 0.0 and not loss.requires_grad
        return
    loss.backward()
    g = float(layer.alpha.grad[0])
    assert abs(g - jg) <= GRAD_TOL * abs(jg), (g, jg)


def test_clip_halves_the_gradient_at_the_bounds():
    """``jnp.clip`` gives half the gradient where alpha sits on a bound;
    so does the port's clip (``torch.clamp`` would give all of it)."""
    x, w = _data(1)
    for alpha in (0.0, 1.0):
        jm = jl.GibbsNoiseLayer()
        jfull = jax.grad(lambda a: jnp.sum(jm.apply({"params": {"alpha": a}},
                                                    jnp.asarray(x)) * w))
        # the unclipped layer's gradient at the same point, from both sides
        inside = jnp.array([alpha + (1e-5 if alpha == 0.0 else -1e-5)], jnp.float32)
        layer = GibbsNoiseLayer(alpha, device="cpu")
        (layer(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
        at_bound = float(layer.alpha.grad[0])
        assert abs(at_bound - float(jfull(jnp.array([alpha], jnp.float32))[0])) \
            <= GRAD_TOL * abs(at_bound)
        near = float(jfull(inside)[0])
        # half of the slope just inside the bound (the slope moves by well
        # under 1% over 1e-5 of alpha)
        assert abs(at_bound - near / 2) <= 1e-2 * abs(near / 2), (alpha, at_bound, near)
    a = torch.tensor(1.0, requires_grad=True)
    zero = torch.zeros(())
    (3 * torch.minimum(torch.maximum(a, zero), zero + 1)).backward()
    assert float(a.grad) == float(jax.grad(lambda v: 3 * jnp.clip(v, 0.0, 1.0))(1.0)) == 1.5


@pytest.mark.parametrize("learnable", [True, False])
def test_spike_layer_matches_jax_with_its_locations(learnable):
    x, w = _data(2)
    key = jax.random.key(7)
    jm = jl.SpikeLayer(intensity=11.0, learnable=learnable)
    params = {"intensity": jnp.array([11.0], jnp.float32)} if learnable else {}

    def jloss(p):
        return jnp.sum(jm.apply({"params": p}, jnp.asarray(x),
                                rngs={"corruption": key}) * w)

    jy = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x),
                                      rngs={"corruption": key}))
    layer = SpikeLayer(11.0, learnable=learnable, device="cpu")
    locs = jax_spike_locations(key, x.shape)
    y = layer(torch.from_numpy(x), locs)
    assert _rel(y.detach().numpy(), jy) <= FWD_TOL
    if learnable:
        (y * torch.from_numpy(w)).sum().backward()
        jg = float(jax.jit(jax.grad(jloss))(params)["intensity"][0])
        g = float(layer.intensity.grad[0])
        assert abs(g - jg) <= GRAD_TOL * abs(jg), (g, jg)
    else:
        assert not list(layer.parameters())


def test_spike_layer_draws_one_location_a_sample():
    layer = SpikeLayer(9.0, device="cpu")
    x = torch.from_numpy(_data(3, (3, 2, 8, 6, 4))[0])
    locs = layer.sample_locations(x, torch.Generator().manual_seed(0))
    assert locs.shape == (3, 3) and locs.dtype == torch.int64
    assert (locs >= 0).all() and (locs < torch.tensor([8, 6, 4])).all()
    # the same generator state gives the same spikes, and each sample is the
    # fixed-location op's spike at its location, over every channel
    y = layer(x, generator=torch.Generator().manual_seed(0)).detach()
    assert torch.equal(y, layer(x, locs).detach())
    for b in range(3):
        want = kspace_spike(x[b], [tuple(int(v) for v in locs[b])], [9.0])
        assert _rel(y[b].numpy(), want.numpy()) <= FWD_TOL


def flax_learnable_params(module, shape, seed, styl=None):
    """Random params of a flax ``GibbsUNet`` / ``SpikesUNet``, made with
    numpy: the tree's structure from ``jax.eval_shape`` of ``init`` (nothing
    is compiled), conv kernels N(0, 1/fan_in), biases N(0, 0.01^2), PReLU
    slopes 0.25, the stylization parameter ``styl``."""
    rng = np.random.RandomState(seed)
    keys = {"params": jax.random.key(0), "corruption": jax.random.key(1)}
    shapes = jax.eval_shape(module.init, keys, jnp.zeros(shape, jnp.float32))["params"]

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "negative_slope":
            v = np.full(shape, 0.25)
        elif name in ("alpha", "intensity"):
            v = np.full(shape, styl)
        else:
            v = 0.01 * rng.randn(*shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def _flax_model(kind, hard=False):
    jm = (jl.GibbsUNet(alpha_init=0.35, hard=hard, **WIDTHS) if kind == "gibbs"
          else jl.SpikesUNet(intensity=11.0, **WIDTHS))
    return jm, flax_learnable_params(jm, VOL, 3, 0.35 if kind == "gibbs" else 11.0)


def _port_model(kind, hard=False):
    if kind == "gibbs":
        return GibbsUNet(0.35, hard=hard, **WIDTHS, device="cpu")
    return SpikesUNet(11.0, **WIDTHS, device="cpu")


@pytest.mark.parametrize("kind", ["gibbs", "spikes"])
def test_converter_keys_and_values(kind):
    _, params = _flax_model(kind)
    sd = learnable_params_from_flax(params)
    model = _port_model(kind)
    assert sd.keys() == model.state_dict().keys()
    model.load_state_dict(sd)
    leaf = ("gibbs", "alpha") if kind == "gibbs" else ("spike", "intensity")
    want = np.asarray(params[leaf[0]][leaf[1]], np.float32)
    assert sd[".".join(leaf)].shape == (1,)
    assert np.array_equal(sd[".".join(leaf)].numpy(), want)
    for k, v in unet_params_from_flax(params["unet"]).items():
        assert torch.equal(sd[f"unet.{k}"], v), k
    assert Gibbs_UNet is GibbsUNet and Spikes_UNet is SpikesUNet and spike_layer is SpikeLayer


def _model_grads(kind, hard, image, label, key=None):
    """Loss and gradients of one model, JAX and port, from the same
    weights (and spike draws)."""
    jm, params = _flax_model(kind, hard)
    rngs = {"corruption": key if key is not None else jax.random.key(0)}

    def jloss(p):
        logits = jm.apply({"params": p}, jnp.asarray(image), rngs=rngs)
        return jdice(jnp.moveaxis(logits, 1, -1), jnp.moveaxis(jnp.asarray(label), 1, -1))

    jl_, jg = jax.jit(jax.value_and_grad(jloss))(params)
    model = _port_model(kind, hard)
    model.load_state_dict(learnable_params_from_flax(params))
    locs = (jax_spike_locations(rngs["corruption"], image.shape, "spike")
            if kind == "spikes" else None)
    loss = dice_loss(model(torch.from_numpy(image), locs), torch.from_numpy(label))
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    return float(jl_), learnable_params_from_flax(jax.device_get(jg)), float(loss), grads


def _grad_err(grads, ref):
    gmax = max(float(v.abs().max()) for v in ref.values())
    err = max(float((grads[k] - ref[k]).abs().max()) for k in ref)
    return err / gmax, gmax


@pytest.mark.parametrize("kind,hard", [("gibbs", False), ("gibbs", True), ("spikes", False)],
                         ids=["gibbs_soft", "gibbs_hard", "spikes"])
def test_model_loss_and_gradients_match_jax(kind, hard):
    rng = np.random.RandomState(5)
    image = rng.randn(*VOL).astype(np.float32)
    label = (rng.rand(*VOL) < 0.4).astype(np.float32)
    jloss, ref, loss, grads = _model_grads(kind, hard, image, label, jax.random.key(9))
    # measured <= 6e-8
    assert abs(loss - jloss) <= 1e-6
    err, _ = _grad_err(grads, ref)
    assert err <= MODEL_GRAD_TOL, err
    if hard:
        assert float(grads["gibbs.alpha"].abs().max()) == 0.0


@pytest.mark.parametrize("biases", ["zero", "random"])
def test_hard_mask_at_alpha_zero_keeps_gradients_finite(biases):
    """At alpha = 0 the hard mask keeps no k-space point, so the UNet sees
    an all-zero volume: its first convolutions give constant maps, which
    every instance norm of the first level maps to 0, scaling the gradient
    by rsqrt(eps) ~ 316. The gradients stay finite on both sides.

    With zero conv biases (flax's init, the weights a run starts from) the
    maps are exactly 0 on both sides, and every gradient is within 1e-4 of
    the largest against JAX (measured 7.2e-7), except the conv biases that
    feed an instance norm: their exact gradient is 0, and both sides give
    rounding noise scaled by rsqrt(eps) (measured 7.9e-5 of the largest
    gradient in JAX, 1.1e-4 in the port, of no common sign), each held to
    1e-3 of the largest. With nonzero biases the maps are constant but not 0: the
    port's norm (``torch.var_mean``) gives exactly 0 there, flax's
    ``GroupNorm`` rounding noise, which the next norm scales up again, so the two packages' gradients then part by the JAX
    side's noise (measured 7.6e-4 of the largest); that case checks
    finiteness and the port's exact zeros."""
    jm, params = _flax_model("gibbs", hard=True)
    zero_bias = lambda path, v: (np.zeros_like(v) if path[-1].key == "bias"  # noqa: E731
                                 else v)
    if biases == "zero":
        params = jax.tree_util.tree_map_with_path(zero_bias, params)
    params = {**params, "gibbs": {"alpha": np.zeros((1,), np.float32)}}
    rng = np.random.RandomState(6)
    image = rng.randn(*VOL).astype(np.float32)
    label = (rng.rand(*VOL) < 0.4).astype(np.float32)

    def jloss(p):
        logits = jm.apply({"params": p}, jnp.asarray(image))
        return jdice(jnp.moveaxis(logits, 1, -1), jnp.moveaxis(jnp.asarray(label), 1, -1))

    jl_, jg = jax.jit(jax.value_and_grad(jloss))(params)
    jg = learnable_params_from_flax(jax.device_get(jg))
    model = GibbsUNet(0.0, hard=True, **WIDTHS, device="cpu")
    model.load_state_dict(learnable_params_from_flax(params))
    x = torch.from_numpy(image)
    assert not model.gibbs(x).any()
    first = model.unet.ResidualUnit_0.ConvNormAct_0
    assert not first(model.gibbs(x)).any()  # the first norm's output: exactly 0
    loss = dice_loss(model(x), torch.from_numpy(label))
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert all(np.isfinite(v.numpy()).all() for v in jg.values())
    # measured 0.0 (zero biases) and 2.4e-6 (random)
    assert abs(float(loss) - float(jl_)) <= 1e-5
    if biases == "random":
        return
    zero = _norm_fed_biases(model)
    assert zero <= set(grads)
    err, gmax = _grad_err({k: v for k, v in grads.items() if k not in zero},
                          {k: v for k, v in jg.items() if k not in zero})
    assert gmax > 0 and err <= MODEL_GRAD_TOL, (err, gmax)
    for k in zero:
        assert float(grads[k].abs().max()) <= 1e-3 * gmax, k
        assert float(jg[k].abs().max()) <= 1e-3 * gmax, k
