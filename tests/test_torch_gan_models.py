"""The port's GAN networks (mvtb_tpu_torch/models/dcgan.py, resunet_gan.py)
against the JAX package's flax modules, with weights converted by
mvtb_tpu_torch/models/convert.py.

The architectures are hard-wired to 128x128 slices, so the nets run at
128x128 and are kept cheap by their width (DCGAN ngf = ndf = 16, ReconGAN
nf = 4), never by a smaller spatial size. Inputs come from numpy seeds;
NHWC arrays are moved to NCHW for the port.

Tolerances: outputs within 1e-4 of their max and gradients within 1e-4 of
the largest gradient of the model (float32 convolutions summed in other
orders); the BatchNorm running averages within 1e-5 of their max.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtb_tpu.models.dcgan import Discriminator as JD
from mvtb_tpu.models.dcgan import Generator as JG
from mvtb_tpu.models.resunet_gan import ResUnetDiscriminator as JRD
from mvtb_tpu.models.resunet_gan import ResUnetGenerator as JRG
from mvtb_tpu_torch.models import (Discriminator, Generator, ResUnetDiscriminator,
                                   ResUnetGenerator, dcgan_params_from_flax,
                                   resunet_gan_params_from_flax)
from mvtb_tpu_torch.models.dcgan import frozen_batch_stats

B, NZ, NF = 4, 100, 16


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process: the suite runs six worker
    processes on the machine's cores, and torch's default of one thread a
    core made these tests' many small ops wait on each other's threads
    (the GAN runner file took twenty times its time alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flax_variables(module, x, seed, **kw):
    """Random variables of a flax module, made with numpy: the tree's
    structure from ``jax.eval_shape`` of ``init`` (nothing is compiled), each
    leaf drawn as the module's initializer would shape it (conv kernels
    N(0, 1/fan_in), biases N(0, 0.01^2), PReLU slopes 0.25, BatchNorm scales
    N(1, 0.02^2), batch statistics at their init)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(partial(module.init, **kw), jax.random.key(0), x)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "negative_slope":
            v = np.full(shape, 0.25)
        elif name == "scale":
            v = 1.0 + 0.02 * rng.randn(*shape)
        elif name == "var":
            v = np.ones(shape)
        elif name == "mean":
            v = np.zeros(shape)
        else:
            v = 0.01 * rng.randn(*shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.array(a), -1, 1)))


def rel(got, ref, scale=None):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max()) if scale is None else scale
    return float(np.abs(np.asarray(got) - ref).max()) / (scale + 1e-30)


def grads_close(tgrads, jgrads_sd, tol=1e-4):
    scale = max(float(v.abs().max()) for v in jgrads_sd.values())
    assert set(tgrads) == set(jgrads_sd)
    for name, g in tgrads.items():
        assert rel(g.numpy(), jgrads_sd[name].numpy(), scale) < tol, name


def _torch_grads(model, x, w):
    model.zero_grad(set_to_none=True)
    out = model(x)
    (out * w).sum().backward()
    return out, {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def test_dcgan_pair_matches_flax_in_training_mode():
    """G and D in training mode: outputs, the gradients of a fixed linear
    functional of the output, and the running averages after the forward."""
    rng = np.random.RandomState(0)
    z = rng.randn(B, 1, 1, NZ).astype(np.float32)
    jg, jd = JG(nz=NZ, ngf=NF, nc=1), JD(nc=1, ndf=NF)
    gv = flax_variables(jg, jnp.zeros((B, 1, 1, NZ)), 0, train=False)
    dv = flax_variables(jd, jnp.zeros((B, 128, 128, 1)), 1, train=False)
    g = Generator(NZ, NF, 1, device="cpu")
    d = Discriminator(1, NF, device="cpu")
    g.load_state_dict(dcgan_params_from_flax(gv["params"], gv["batch_stats"]))
    d.load_state_dict(dcgan_params_from_flax(dv["params"], dv["batch_stats"]))

    for jm, jv, tm, x in ((jg, gv, g, z), (jd, dv, d, None)):
        if x is None:  # D sees G's slices
            x = np.asarray(jg.apply(gv, jnp.asarray(z), train=False))
        w = rng.randn(*jm.apply(jv, jnp.asarray(x), train=False).shape).astype(np.float32)

        def loss(params, jm=jm, jv=jv, x=x, w=w):
            out, mut = jm.apply({"params": params, "batch_stats": jv["batch_stats"]},
                                jnp.asarray(x), train=True, mutable=["batch_stats"])
            return jnp.sum(out * w), (out, mut["batch_stats"])

        (_, (ref, stats)), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jv["params"])
        out, tgrads = _torch_grads(tm, nchw(x), nchw(w))
        assert rel(out.detach().numpy(), np.moveaxis(np.asarray(ref), -1, 1)) < 1e-4
        grads_close(tgrads, dcgan_params_from_flax(jax.device_get(jgrads)))
        want = dcgan_params_from_flax({}, jax.device_get(stats))
        for name, buf in tm.named_buffers():
            assert rel(buf.numpy(), want[name].numpy()) < 1e-5, name


def test_dcgan_eval_mode_reads_the_running_averages():
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (B, 128, 128, 1)).astype(np.float32)
    jd = JD(nc=1, ndf=NF)
    dv = flax_variables(jd, jnp.asarray(x), 2, train=False)
    # running averages away from their init, as after training
    stats = jax.tree.map(lambda a: a + 0.3 * jnp.abs(jnp.asarray(rng.randn(*a.shape),
                                                                 a.dtype)),
                         dv["batch_stats"])
    d = Discriminator(1, NF, device="cpu")
    d.load_state_dict(dcgan_params_from_flax(dv["params"], stats))
    d.eval()
    ref = jd.apply({"params": dv["params"], "batch_stats": stats}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = d(nchw(x))
    assert rel(got.numpy(), np.moveaxis(np.asarray(ref), -1, 1)) < 1e-4


def test_batch_norm_keeps_flax_running_rule():
    """0.9 old + 0.1 batch with the biased variance (not BatchNorm2d's
    unbiased one), and no update inside frozen_batch_stats."""
    d = Discriminator(1, NF, device="cpu")
    x = torch.randn(B, 1, 128, 128, generator=torch.Generator().manual_seed(0))
    with frozen_batch_stats(d):
        d(x)
    assert torch.equal(d.bn0.running_var, torch.ones_like(d.bn0.running_var))
    seen = []
    d.Conv_1.register_forward_hook(lambda m, i, o: seen.append(o))
    d(x)
    h = seen[-1]
    var = h.var(dim=(0, 2, 3), correction=0)
    torch.testing.assert_close(d.bn0.running_var, 0.9 + 0.1 * var, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(d.bn0.running_mean, 0.1 * h.mean(dim=(0, 2, 3)),
                               rtol=1e-5, atol=1e-6)


def test_resunet_pair_matches_flax():
    """The ReconGAN pair at the test width (gan_nf = 16: nf = 2): outputs in
    float32 within 1e-4 of the max; gradients in float64 (JAX under
    ``enable_x64``, the port's modules in double) within 1e-6 of the
    largest. The gradients of these deep instance-norm stacks are
    ill-conditioned in float32: two correct float32 computations part by
    far more than float32 rounding, so the structure is held in float64."""
    nf = 2
    rng = np.random.RandomState(3)
    C = 2
    x = rng.uniform(-1, 1, (2, 128, 128, C)).astype(np.float32)
    jg = JRG(in_chans=C, nf=nf, global_residual=True)
    jd = JRD(nf=nf)
    g = ResUnetGenerator(C, nf, global_residual=True, device="cpu")
    d = ResUnetDiscriminator(C, nf, device="cpu")
    for i, (jm, tm) in enumerate(((jg, g), (jd, d))):
        params = flax_variables(jm, jnp.asarray(x), i)["params"]
        tm.load_state_dict(resunet_gan_params_from_flax(jax.device_get(params)))
        ref = jm.apply({"params": params}, jnp.asarray(x))
        with torch.no_grad():
            out = tm(nchw(x))
        assert rel(out.numpy(), np.moveaxis(np.asarray(ref), -1, 1)) < 1e-4
        w = rng.randn(*ref.shape).astype(np.float64)
        with jax.enable_x64(True):
            p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
            jgrads = jax.jit(jax.grad(lambda p, jm=jm, w=w: jnp.sum(
                jm.apply({"params": p}, jnp.asarray(x, jnp.float64)) * w)))(p64)
            want = resunet_gan_params_from_flax(jax.tree.map(np.asarray, jgrads))
        tm64 = tm.double()
        _, tgrads = _torch_grads(tm64, nchw(x).double(), nchw(w))
        scale = max(float(v.abs().max()) for v in want.values())
        for name, gr in tgrads.items():
            assert rel(gr.numpy(), want[name].numpy(), scale) < 1e-6, name
    # without the global residual, the same weights give the output less x
    g = g.float()
    g2 = ResUnetGenerator(C, nf, global_residual=False, device="cpu")
    g2.load_state_dict(g.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(g2(nchw(x)), g(nchw(x)) - nchw(x), rtol=0, atol=1e-6)


def test_instance_norm_of_a_constant_map_has_finite_gradients():
    """A Gibbs compress whose mask keeps nothing (alpha above ~0.994) hands G
    an all-zero slice, and every map after it is constant. With the biases a
    first update leaves (here N(0, 1e-6)), G's gradient stays finite, as
    flax's does; ``torch.var_mean``'s backward gave NaN there and stopped a
    gibbs_gan run on the card. (With every bias exactly 0, as at init, the
    gradient through such a slice overflows float32 in the port; the JAX
    package's reaches ~5e30 on flax's init: ROADMAP.md section 3.)"""
    x = torch.zeros(2, 1, 128, 128)
    x[1] = torch.randn(1, 128, 128, generator=torch.Generator().manual_seed(0))
    g = ResUnetGenerator(1, 16, global_residual=False, device="cpu",
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for name, p in g.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 1e-6, generator=torch.Generator().manual_seed(2))
    g(x).sum().backward()
    assert all(bool(torch.isfinite(p.grad).all()) for p in g.parameters())


def test_shapes_at_registry_width():
    """The registry's DCGAN (ngf = ndf = 128) builds 92 M parameters and maps
    128x128 slices to one logit; the ReconGAN pair keeps the slice's shape."""
    g, d = Generator(100, 128, 1, device="cpu"), Discriminator(1, 128, device="cpu")
    n = sum(p.numel() for m in (g, d) for p in m.parameters())
    assert 90e6 < n < 95e6, n
    rg, rd = ResUnetGenerator(2, 2, device="cpu"), ResUnetDiscriminator(2, 2, device="cpu")
    x = torch.zeros(1, 2, 128, 128)
    assert rg(x).shape == x.shape and rd(x).shape == (1, 1, 1, 1)
