"""The port's GAN training steps (mvtb_tpu_torch/train/gan.py) against the
JAX package's jitted steps, on the same weights, batches and draws.

Both sides step with SGD (lr 1e-3) that records each gradient (JAX: an
optax transform whose state is the gradient; the port: a ``torch.optim``
optimizer that does the same), so the gradients are read exactly and G's
gradient meets the same updated D on both sides. Adam is checked on its
own, both optimizers handed the same gradients: a parameter after one
Adam step would hide the update in the parameter's rounding, and Adam's
first step turns a near-zero gradient of either sign into a full step.

Nets at 128x128 (their hard-wired size) and gan_nf = 16 widths: DCGAN
ngf = ndf = 16, ReconGAN nf = 2. Tolerances: losses within 1e-5 of their
value (of 1 for D's probabilities), gradients within 1e-4 of the model's
largest (5e-3 for the ReconGAN nets: see RECON_GRAD_TOL), BatchNorm running
averages within 1e-5 of their max. Adam's
updates: within 1e-6 of the largest against Adam computed in float64, and
within 1e-5 against optax, whose float32 arithmetic weighs the second
moment by float32(1 - 0.999) = 0.001 but divides it by the bias correction
1 - float32(0.999) = 0.00099998713, 1.3e-5 apart: 6.4e-6 in the update,
at every step until 0.999^t is small.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mvtb_tpu.models.dcgan import Discriminator as JD
from mvtb_tpu.models.dcgan import Generator as JG
from mvtb_tpu.models.resunet_gan import ResUnetDiscriminator as JRD
from mvtb_tpu.models.resunet_gan import ResUnetGenerator as JRG
from mvtb_tpu.ops import fused as jfused
from mvtb_tpu.train import gan as jgan
from mvtb_tpu_torch.models import (Discriminator, Generator, ResUnetDiscriminator,
                                   ResUnetGenerator, dcgan_params_from_flax,
                                   resunet_gan_params_from_flax)
from mvtb_tpu_torch.train import gan as tgan

from test_torch_fused_plane import jax_stage_draws
from test_torch_gan_models import flax_variables, grads_close, nchw, rel
from test_torch_gan_models import one_torch_thread  # noqa: F401  (autouse)

B = 2


LR = 1e-3


def recording_sgd():
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(lambda g: -LR * g, grads), grads))


class RecordingSGD(torch.optim.Optimizer):
    """SGD(LR) that keeps each parameter's last gradient in its state."""

    def __init__(self, params):
        super().__init__(params, {})

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["grad"] = p.grad.clone()
                p.sub_(LR * p.grad)


def _jax_state(module, variables):
    return jgan.GANState.create(apply_fn=module.apply, params=variables["params"],
                                batch_stats=variables.get("batch_stats", {}),
                                tx=recording_sgd())


def _port_state(model, state_dict):
    model.load_state_dict(state_dict)
    model.train()
    return tgan.GANState(model=model, optimizer=RecordingSGD(model.parameters()))


def _recorded(state):
    return {n: state.optimizer.state[p]["grad"] for n, p in state.model.named_parameters()}


def test_dcgan_step_matches_jax():
    rng = np.random.RandomState(0)
    nz, nf = 100, 16
    jg, jd = JG(nz=nz, ngf=nf, nc=1), JD(nc=1, ndf=nf)
    gv = flax_variables(jg, jnp.zeros((B, 1, 1, nz)), 0, train=False)
    dv = flax_variables(jd, jnp.zeros((B, 128, 128, 1)), 1, train=False)
    real = rng.uniform(-1, 1, (B, 128, 128, 1)).astype(np.float32)
    z = rng.randn(B, 1, 1, nz).astype(np.float32)

    g = _port_state(Generator(nz, nf, 1, device="cpu"),
                    dcgan_params_from_flax(gv["params"], gv["batch_stats"]))
    d = _port_state(Discriminator(1, nf, device="cpu"),
                    dcgan_params_from_flax(dv["params"], dv["batch_stats"]))
    js_g, js_d, jm = jgan.dcgan_step(_jax_state(jg, gv), _jax_state(jd, dv),
                                     jnp.asarray(real), jnp.asarray(z), real_label=0.9)
    m = tgan.dcgan_step(g, d, nchw(real), nchw(z), real_label=0.9)
    for k in ("d_loss", "g_loss", "D_x", "D_G_z1", "D_G_z2"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * max(1.0, abs(float(jm[k]))), k
    for state, js in ((g, js_g), (d, js_d)):
        grads_close(_recorded(state), dcgan_params_from_flax(jax.device_get(js.opt_state)))
        want = dcgan_params_from_flax({}, jax.device_get(js.batch_stats))
        for name, buf in state.model.named_buffers():
            assert rel(buf.numpy(), want[name].numpy()) < 1e-5, name
    assert g.step == d.step == 1


# The ReconGAN nets' float32 gradients are ill-conditioned (deep
# instance-norm stacks): JAX's own float32 gradient sits up to 6.1e-3 of
# the largest off its float64 one, and tests/test_torch_gan_models.py holds
# the port to JAX in float64 to 1e-6. The step's float32 gradients are held
# to 5e-3 of the largest (measured up to 2.5e-3 here).
RECON_GRAD_TOL = 5e-3

# (kind, in_channels): the registry's three ReconGAN kinds
RECON = {"recon_gan": 2, "recon_gan_freq": 2, "gibbs_gan": 1}


def _jax_recon_draws(key, kind, shape):
    """The three compress draws the JAX step makes from ``key``, in the
    port's form."""
    B_, C, H, W = shape
    out = []
    for k in jax.random.split(key, 3):
        if kind == "gibbs_gan":
            out.append(jax_stage_draws(k, jfused.StylizeConfig(n_dims=2, gibbs_alpha=(0.0, 1.0)),
                                       shape))
        else:
            out.append(torch.from_numpy(np.stack([
                np.asarray(jax.random.uniform(kk, (C, H, W), jnp.float32))
                for kk in jax.random.split(k, B_)])))
    return out


@pytest.mark.parametrize("kind", sorted(RECON))
def test_recon_gan_step_matches_jax(kind):
    C, nf = RECON[kind], 2
    rng = np.random.RandomState(1)
    real = np.tanh(rng.randn(B, 128, 128, C)).astype(np.float32)
    jg = JRG(in_chans=C, nf=nf, global_residual=kind != "gibbs_gan")
    jd = JRD(nf=nf)
    gv = flax_variables(jg, jnp.asarray(real), 2)
    dv = flax_variables(jd, jnp.asarray(real), 3)
    kw = dict(zf_p=0.2, alpha=15.0 if kind != "recon_gan" else 1.0,
              gamma=0.1 if kind != "recon_gan" else 10.0,
              freq_domain=kind != "recon_gan",
              compress_kind="gibbs" if kind == "gibbs_gan" else "zf",
              pre_corrupt_real=kind == "gibbs_gan", real_label=1.0)
    key = jax.random.key(4)
    js_g, js_d, jm = jgan.recon_gan_step(_jax_state(jg, gv), _jax_state(jd, dv),
                                         jnp.asarray(real), key, **kw)
    g = _port_state(ResUnetGenerator(C, nf, global_residual=kind != "gibbs_gan", device="cpu"),
                    resunet_gan_params_from_flax(gv["params"]))
    d = _port_state(ResUnetDiscriminator(C, nf, device="cpu"),
                    resunet_gan_params_from_flax(dv["params"]))
    draws = _jax_recon_draws(key, kind, (B, C, 128, 128))
    m = tgan.recon_gan_step(g, d, nchw(real), draws, **kw)
    for k in ("d_loss", "g_loss", "adv"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), (kind, k)
    for state, js in ((g, js_g), (d, js_d)):
        grads_close(_recorded(state), resunet_gan_params_from_flax(jax.device_get(js.opt_state)),
                    tol=RECON_GRAD_TOL)


def test_sample_recon_draws_shapes():
    gen = torch.Generator().manual_seed(0)
    zf = tgan.sample_recon_draws("zf", (2, 2, 16, 16), gen, "cpu")
    assert [tuple(u.shape) for u in zf] == [(2, 2, 16, 16)] * 3
    gibbs = tgan.sample_recon_draws("gibbs", (2, 1, 16, 16), gen, "cpu")
    assert all(d.gibbs_alpha.shape == (2,) and bool(d.gibbs_gate.all()) for d in gibbs)
    with pytest.raises(ValueError, match="compress_kind"):
        tgan.sample_recon_draws("blur", (2, 1, 16, 16), gen, "cpu")


def test_adam_is_optax_adam():
    """The port's Adam against Adam in float64 and against optax adam, over
    three steps on the same gradients (near-zero ones included). Adam's
    update does not depend on the parameters, so the torch side starts from
    zeros and reads its updates off the parameters without their
    rounding."""
    rng = np.random.RandomState(5)
    lr, b1, b2, eps = 2e-4, 0.5, 0.999, 1e-8
    params = {"a": rng.randn(64).astype(np.float32), "b": rng.randn(8, 8).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 10.0 ** rng.uniform(-9, 0, v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    tx = optax.adam(lr, b1=b1, b2=b2)
    state = tx.init(params)
    tp = {k: torch.zeros(v.shape, requires_grad=True) for k, v in params.items()}
    opt = tgan.gan_optimizer(tp.values(), lr=lr, beta1=b1)
    mu = {k: np.zeros(v.shape) for k, v in params.items()}
    nu = {k: np.zeros(v.shape) for k, v in params.items()}
    for t, g in enumerate(grads, start=1):
        upd, state = tx.update(g, state, params)
        before = {k: v.detach().clone() for k, v in tp.items()}
        for k, v in tp.items():
            v.grad = torch.from_numpy(g[k])
        opt.step()
        scale = max(float(np.abs(u).max()) for u in upd.values())
        for k in tp:
            g64 = g[k].astype(np.float64)
            mu[k] = b1 * mu[k] + (1 - b1) * g64
            nu[k] = b2 * nu[k] + (1 - b2) * g64 ** 2
            exact = -lr * (mu[k] / (1 - b1 ** t)) / (np.sqrt(nu[k] / (1 - b2 ** t)) + eps)
            got = (tp[k].detach() - before[k]).numpy()
            assert np.abs(got - exact).max() <= 1e-6 * scale, (k, t)
            assert np.abs(got - np.asarray(upd[k])).max() <= 1e-5 * scale, (k, t)
