"""The port's segmentation training step (mvtb_tpu_torch/train) against the
JAX package's: the Dice loss, the reference optimizer, one train step's
gradients, and the bfloat16 forward.

The JAX state comes from ``create_seg_state``; its parameters, gradients
and optimizer moments reach the port through ``models/convert.py``. Stage
draws are replayed through ``jax_stage_draws``, from the key the JAX step
hands its image stylization (the first half of ``jax.random.split``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mvtb_tpu.models.unet3d import UNet as JUNet
from mvtb_tpu.ops import fused as jfused
from mvtb_tpu.train import losses as jlosses
from mvtb_tpu.train import seg as jseg
from mvtb_tpu_torch.models import UNet, unet_params_from_flax
from mvtb_tpu_torch.models.unet3d import ConvNormAct
from mvtb_tpu_torch.ops import fused as tfused
from mvtb_tpu_torch.train import losses as tlosses
from mvtb_tpu_torch.train import seg as tseg
from test_torch_fused_plane import jax_stage_draws, rel_err

CHANNELS, STRIDES = (4, 8, 16), (2, 2)
B, C, SPATIAL = 2, 4, (16, 16, 8)
# the bench stack scaled to a 16x16x8 volume
STACK = dict(disk_r=(3.0, 6.0), plane_axes=(6.0, 5.0, 3.0), plane_intensity=12.0,
             spike=True, spike_range=(10.0, 11.0), wrap_alpha=0.5, sap_p=0.05)


def batch(seed):
    rng = np.random.RandomState(seed)
    image = rng.randn(B, C, *SPATIAL).astype(np.float32)
    label = (rng.rand(B, 3, *SPATIAL) < 0.4).astype(np.float32)
    return image, label


def flat_moments(tree):
    return unet_params_from_flax(jax.device_get(tree))


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(squared_pred=False),
                                dict(include_background=False)])
def test_dice_loss_and_gradient_match_jax(kw):
    rng = np.random.RandomState(0)
    logits = (rng.randn(2, 3, 6, 5, 4) * 2).astype(np.float32)
    targets = (rng.rand(2, 3, 6, 5, 4) < 0.3).astype(np.float32)
    to_cl = lambda a: jnp.asarray(np.moveaxis(a, 1, -1))
    ref, ref_g = jax.value_and_grad(
        lambda l: jlosses.dice_loss(l, to_cl(targets), **kw))(to_cl(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = tlosses.dice_loss(lt, torch.from_numpy(targets), **kw)
    got.backward()
    assert abs(float(got.detach()) - float(ref)) < 1e-6
    g_ref = np.moveaxis(np.asarray(ref_g), -1, 1)
    assert np.abs(lt.grad.numpy() - g_ref).max() < 1e-6 * max(1.0, np.abs(g_ref).max())


def test_bce_and_mse_match_jax():
    rng = np.random.RandomState(1)
    a = (rng.randn(3, 7) * 3).astype(np.float32)
    b = (rng.rand(3, 7) < 0.5).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert abs(float(tlosses.bce_with_logits(ta, tb))
               - float(jlosses.bce_with_logits(jnp.asarray(a), jnp.asarray(b)))) < 1e-6
    assert abs(float(tlosses.mse(ta, tb))
               - float(jlosses.mse(jnp.asarray(a), jnp.asarray(b)))) < 1e-6


# --------------------------------------------------------------------------
# the reference optimizer
# --------------------------------------------------------------------------

def _optimizer_run(make_opt, steps=6):
    """Feed optax's chain and a torch optimizer the same numpy gradients,
    whose size shrinks after step 1; return both final states."""
    rng = np.random.RandomState(3)
    p0 = {"a": rng.randn(5, 4).astype(np.float32),
          "b": rng.randn(7).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * (1.0 if t == 0 else 0.05)).astype(np.float32)
              for k, v in p0.items()} for t in range(steps)]
    tx = jseg.reference_optimizer()
    jp = jax.tree.map(jnp.asarray, p0)
    js = tx.init(jp)
    for g in grads:
        upd, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = make_opt(list(tp.values()))
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    return jp, js[1][0], tp, opt


def _max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_reference_optimizer_matches_optax_amsgrad():
    jp, ams, tp, opt = _optimizer_run(tseg.reference_optimizer)
    for k, p in tp.items():
        st = opt.state[p]
        assert st["count"] == int(ams.count) == 6
        assert _max_rel(p.detach().numpy(), jp[k]) < 1e-6, k
        assert _max_rel(st["mu"].numpy(), ams.mu[k]) < 1e-6, k
        assert _max_rel(st["nu"].numpy(), ams.nu[k]) < 1e-6, k
        assert _max_rel(st["nu_max"].numpy(), ams.nu_max[k]) < 1e-6, k


def test_torch_adam_amsgrad_is_not_the_reference():
    # torch keeps the max of the raw second moment and corrects it after;
    # optax takes the max of the corrected moment, so they part at step 2
    jp, _, tp, _ = _optimizer_run(
        lambda ps: torch.optim.Adam(ps, lr=1e-4, weight_decay=1e-5, amsgrad=True))
    p0 = _optimizer_run(tseg.reference_optimizer, steps=0)[0]
    moved = max(_max_rel(tp[k].detach().numpy() - p0[k], jp[k] - p0[k]) for k in tp)
    assert moved > 1e-2


def test_step_two_denominator_example():
    # a gradient of 1, then 0: at step 2 optax's denominator is sqrt(1.0)
    # (1 - 0.999 rounds in float32, hence rel 1e-4), torch's about 0.707
    p, q = torch.nn.Parameter(torch.zeros(1)), torch.nn.Parameter(torch.zeros(1))
    ours = tseg.ReferenceAmsgrad([p], lr=1.0, weight_decay=0.0)
    adam = torch.optim.Adam([q], lr=1.0, amsgrad=True)
    for g in (1.0, 0.0):
        p.grad, q.grad = torch.tensor([g]), torch.tensor([g])
        ours.step()
        adam.step()
    assert float(ours.state[p]["nu_max"].sqrt()) == pytest.approx(1.0, rel=1e-4)
    torch_denom = (adam.state[q]["max_exp_avg_sq"] / (1 - 0.999 ** 2)).sqrt()
    assert float(torch_denom) == pytest.approx(0.7073, rel=1e-3)


def test_reference_optimizer_keeps_each_parameters_count():
    # a parameter without a gradient is skipped, so counts part; each
    # parameter then steps exactly as it would in an optimizer of its own
    # over its own updates (its bias corrections follow its own count)
    rng = np.random.RandomState(5)
    p0 = {"a": rng.randn(6).astype(np.float32), "b": rng.randn(3, 2).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(4)]
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = tseg.reference_optimizer(list(tp.values()))
    for t, g in enumerate(grads):
        for k, p in tp.items():
            p.grad = None if (k == "b" and t == 0) else torch.from_numpy(g[k].copy())
        opt.step()
    for k, used in (("a", grads), ("b", grads[1:])):
        alone = torch.nn.Parameter(torch.from_numpy(p0[k].copy()))
        own = tseg.reference_optimizer([alone])
        for g in used:
            alone.grad = torch.from_numpy(g[k].copy())
            own.step()
        assert opt.state[tp[k]]["count"] == own.state[alone]["count"] == len(used)
        assert torch.equal(tp[k], alone), k
        for m in ("mu", "nu", "nu_max"):
            assert torch.equal(opt.state[tp[k]][m], own.state[alone][m]), (k, m)


# --------------------------------------------------------------------------
# one train step
# --------------------------------------------------------------------------

def recording_sgd():
    """optax SGD(1.0) whose state is the last gradient, read exactly (a
    parameter difference would add the parameter's rounding)."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.negative, grads), grads))


def _jax_step(backend, seed=0):
    jm = JUNet(out_channels=3, channels=CHANNELS, strides=STRIDES)
    state = jseg.create_seg_state(jax.random.key(seed), jm, (B,) + SPATIAL + (C,),
                                  tx=recording_sgd())
    p0 = jax.device_get(state.params)
    image, label = batch(seed)
    key = jax.random.key(seed + 5)
    cfg = jfused.StylizeConfig(**STACK, fft_backend=backend)
    state2, loss = jseg.seg_train_step(state, jnp.asarray(image), jnp.asarray(label),
                                       key, cfg)
    k_img, _ = jax.random.split(key)
    draws = jax_stage_draws(k_img, cfg, image.shape)
    return p0, flat_moments(state2.opt_state), float(loss), draws, (image, label)


def _port_step(state_dict, draws, image, label, backend, remat=False):
    """One port step with SGD(1.0) from ``state_dict``; returns the model,
    the loss and the gradients."""
    model = UNet(C, 3, CHANNELS, STRIDES, device="cpu")
    model.load_state_dict(state_dict)
    state = tseg.create_seg_state(model, torch.optim.SGD(model.parameters(), lr=1.0),
                                  device="cpu")
    loss = tseg.seg_train_step(state, torch.from_numpy(image), torch.from_numpy(label),
                               tfused.StylizeConfig(**STACK, fft_backend=backend),
                               remat=remat, draws=draws, device="cpu")
    assert state.step == 1
    return model, float(loss), {k: p.grad.clone() for k, p in model.named_parameters()}


def _norm_fed_biases(model):
    """Conv biases that feed an instance norm: the norm subtracts their
    mean, so their exact gradient is 0 and both sides give rounding noise."""
    return {f"{name}.{conv}.bias" for name, m in model.named_modules()
            if isinstance(m, ConvNormAct) and not m.conv_only
            for conv in ("Conv_0", "ConvTranspose_0") if hasattr(m, conv)}


@pytest.mark.parametrize("backend", ["dft", "dft_pallas"])
def test_train_step_gradients_match_jax(backend):
    p0, g_ref, jloss, draws, (image, label) = _jax_step(backend)
    model, loss, grads = _port_step(unet_params_from_flax(p0), draws, image, label,
                                    backend)
    assert abs(loss - jloss) < 1e-5
    zero = _norm_fed_biases(model)
    gmax = max(float(v.abs().max()) for v in g_ref.values())
    assert zero and set(grads) == set(g_ref)
    for k, g in grads.items():
        r = g_ref[k].numpy()
        if k in zero:
            assert float(g.abs().max()) < 1e-6 * gmax and np.abs(r).max() < 1e-6 * gmax, k
        else:
            assert rel_err(g.numpy(), r) < 1e-4, k
    # SGD(1.0): the step moved each parameter by its negated gradient
    for k, p in model.named_parameters():
        assert torch.allclose(p.detach(), torch.from_numpy(
            unet_params_from_flax(p0)[k].numpy()) - grads[k], rtol=0, atol=1e-6)


def test_remat_gives_the_same_step():
    torch.manual_seed(1)
    p0 = UNet(C, 3, CHANNELS, STRIDES, device="cpu").state_dict()
    image, label = batch(1)
    draws = tfused.sample_draws(tfused.StylizeConfig(**STACK), SPATIAL, B, C,
                                generator=torch.Generator().manual_seed(1), device="cpu")
    _, loss_a, ga = _port_step(p0, draws, image, label, "dft")
    _, loss_b, gb = _port_step(p0, draws, image, label, "dft", remat=True)
    assert loss_a == loss_b
    for k in ga:
        assert torch.allclose(ga[k], gb[k], rtol=1e-6, atol=1e-12), k


def test_augment_label_uses_its_own_draws():
    image, label = batch(2)
    model = UNet(C, 3, CHANNELS, STRIDES, device="cpu")
    cfg = tfused.StylizeConfig(disk_r=3.0, fft_backend="dft")
    d = tfused.sample_draws(cfg, SPATIAL, B, 3, device="cpu")
    seen = []
    real = tseg.stylize_batch

    def spy(x, cfg, draws=None, **kw):
        seen.append(draws)
        return real(x, cfg, draws=draws, **kw)

    tseg.stylize_batch = spy
    try:
        state = tseg.create_seg_state(model, device="cpu")
        tseg.seg_train_step(state, torch.from_numpy(image), torch.from_numpy(label),
                            cfg, augment_label=True,
                            draws=tfused.sample_draws(cfg, SPATIAL, B, C, device="cpu"),
                            label_draws=d, device="cpu")
    finally:
        tseg.stylize_batch = real
    assert len(seen) == 2 and seen[1] is d
    assert isinstance(state.optimizer, tseg.ReferenceAmsgrad)


def test_reference_optimizer_moments_match_jax_over_steps():
    """Three steps of the narrow UNet with the reference optimizer on both
    sides, no stylization: optax's mu, nu and nu_max, converted, against
    the port's, at 1e-4 of each tensor's max as the gradients; the
    norm-fed biases (exact gradient 0, so their moments are rounding noise)
    at 1e-4 of the largest moment."""
    jm = JUNet(out_channels=3, channels=CHANNELS, strides=STRIDES)
    state = jseg.create_seg_state(jax.random.key(4), jm, (B,) + SPATIAL + (C,))
    model = UNet(C, 3, CHANNELS, STRIDES, device="cpu")
    model.load_state_dict(unet_params_from_flax(jax.device_get(state.params)))
    ts = tseg.create_seg_state(model, device="cpu")
    for t in range(3):
        image, label = batch(10 + t)
        state, _ = jseg.seg_train_step(state, jnp.asarray(image), jnp.asarray(label),
                                       jax.random.key(t))
        tseg.seg_train_step(ts, torch.from_numpy(image), torch.from_numpy(label),
                            device="cpu")
    ams = state.opt_state[1][0]
    zero = _norm_fed_biases(model)
    for name in ("mu", "nu", "nu_max"):
        ref = flat_moments(getattr(ams, name))
        scale = max(float(v.abs().max()) for v in ref.values())
        for k, p in model.named_parameters():
            got, r = ts.optimizer.state[p][name], ref[k]
            if k in zero:
                assert float((got - r).abs().max()) < 1e-4 * scale, (name, k)
            else:
                assert rel_err(got.numpy(), r.numpy()) < 1e-4, (name, k)


def test_train_segmentation_host_loop():
    model = UNet(C, 3, CHANNELS, STRIDES, device="cpu")
    state = tseg.create_seg_state(model, device="cpu")
    before = [p.detach().clone() for p in model.parameters()]
    data = iter([tuple(torch.from_numpy(a) for a in batch(s)) for s in range(3)])
    logged = []
    losses = tseg.train_segmentation(
        state, data, 3, tfused.StylizeConfig(**STACK, fft_backend="dft_pallas"),
        generator=torch.Generator().manual_seed(0), log_every=2,
        log_fn=logged.append, device="cpu")
    assert len(losses) == 3 and all(np.isfinite(losses)) and state.step == 3
    assert len(logged) == 1 and logged[0].startswith("step 2/3")
    assert any(not torch.equal(a, b) for a, b in zip(before, model.parameters()))


# --------------------------------------------------------------------------
# bfloat16 compute
# --------------------------------------------------------------------------

def test_bf16_forward_matches_jax():
    """The JAX UNet with ``dtype=bfloat16`` against the port's, same float32
    weights. Tolerance 3e-2 of the output's max: every conv, norm and
    activation rounds to bf16 (2^-8 relative) on both sides, and the
    convolutions accumulate in another order, so a value can land one bf16
    step apart and carry that through the next layers."""
    x = np.random.RandomState(7).randn(1, C, 16, 16, 16).astype(np.float32)
    x_cl = jnp.asarray(np.moveaxis(x, 1, -1))
    jm = JUNet(out_channels=3, channels=CHANNELS, strides=STRIDES, dtype=jnp.bfloat16)
    params = jax.jit(jm.init)(jax.random.key(8), x_cl)["params"]
    ref = np.moveaxis(np.asarray(jax.jit(jm.apply)({"params": params}, x_cl)
                                 .astype(jnp.float32)), -1, 1)
    model = UNet(C, 3, CHANNELS, STRIDES, device="cpu", dtype=torch.bfloat16)
    model.load_state_dict(unet_params_from_flax(jax.device_get(params)))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    assert rel_err(got.float().numpy(), ref) < 3e-2
