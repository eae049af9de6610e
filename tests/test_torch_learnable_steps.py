"""The port's learnable-stylization steps (mvtb_tpu_torch/train/learnable.py)
against the JAX package's (mvtb_tpu/train/learnable.py): three steps of
each from the same weights, batches and spike draws, comparing the losses,
the stylization parameter's trajectory and the parameters. The cases: the
joint gradient step; ``train_alpha=False``, whose zeroed alpha gradient
still decays under the reference optimizer; the finite-difference step on
the hard Gibbs mask and on the spike layer (h = 0.05, lr = 0.1); a frozen
UNet under amsgrad and SGD; and a transferred UNet."""

import functools

import jax
import numpy as np
import pytest
import torch

from mvtb_tpu.models import layers as jl
from mvtb_tpu.train import learnable as jlearn
from mvtb_tpu_torch.models import GibbsUNet, SpikesUNet, learnable_params_from_flax
from mvtb_tpu_torch.models import unet_params_from_flax
from mvtb_tpu_torch.train import learnable as tlearn
from test_torch_learnable_layers import VOL, WIDTHS, flax_learnable_params, jax_spike_locations
from test_torch_train_seg import _norm_fed_biases
from test_torch_gan_models import one_torch_thread  # noqa: F401  (autouse)

K = 3
LR, WD = 1e-4, 1e-5
FD_H, FD_LR = 0.05, 0.1
SGD_LR = 5e-4
# Losses, port against JAX: float32 sums in another order inside the UNet
# and the Dice reduction (measured <= 7.8e-7 on losses near 0.4).
LOSS_TOL = 2e-6
# The stylization parameter after each step, absolute, relative above 1 (an
# intensity of 11 has an ulp of 9.5e-7). A joint step moves it by about lr
# (amsgrad); an FD step by fd_lr * (l(a + h) - l(a)) / h, whose loss
# difference carries both losses' rounding (measured 0.0 for the joint
# steps, <= 5.4e-7 for FD on Gibbs, one ulp for FD on spikes).
ALPHA_TOL = 1e-6
# Parameters after K steps, absolute: amsgrad moves each by about lr a step
# whatever the gradient's size, so a gradient difference of ~1e-6 relative
# moves it by far less (measured <= 9.6e-7, the spike intensity's ulp). The
# conv biases that feed an instance norm have exact gradient 0: both sides
# step on rounding noise, which amsgrad normalises to up to lr a step
# (measured <= 2.6e-4 after 3 steps of lr 1e-4).
PARAM_TOL = 5e-6

# each case: the model, the step, and create_learnable_state's options
CASES = {
    "grad": dict(),
    "fixed_alpha": dict(train_alpha=False),
    "fd_gibbs_hard": dict(fd=True, hard=True, alpha0=0.5),
    "fd_spikes": dict(fd=True, kind="spikes"),
    "frozen_adam": dict(freeze_unet=True),
    "frozen_sgd": dict(freeze_unet=True, unet_optimizer="sgd"),
    "frozen_sgd_fixed_alpha": dict(freeze_unet=True, unet_optimizer="sgd", train_alpha=False),
    "transfer": dict(transfer="plain"),
    "transfer_prefixed": dict(transfer="prefixed"),
}


class _FixedInit:
    """A flax model whose ``init`` returns the given params (nothing to
    compile), for JAX's ``create_learnable_state``."""

    def __init__(self, module, params):
        self.apply = module.apply
        self._params = params

    def init(self, rngs, x):
        return {"params": self._params}


def _data():
    rng = np.random.RandomState(11)
    images = rng.randn(K, *VOL).astype(np.float32)
    labels = (rng.rand(K, *VOL) < 0.4).astype(np.float32)
    return images, labels


@functools.lru_cache(maxsize=None)
def _run_case(case):
    c = CASES[case]
    kind, hard, fd = c.get("kind", "gibbs"), c.get("hard", False), c.get("fd", False)
    styl0 = c.get("alpha0", 0.7) if kind == "gibbs" else 11.0
    jm = (jl.GibbsUNet(alpha_init=styl0, hard=hard, **WIDTHS) if kind == "gibbs"
          else jl.SpikesUNet(intensity=styl0, **WIDTHS))
    params = flax_learnable_params(jm, VOL, 21, styl0)
    opts = dict(freeze_unet=c.get("freeze_unet", False),
                unet_optimizer=c.get("unet_optimizer", "adam"))
    lr = SGD_LR if opts["unet_optimizer"] == "sgd" else LR
    transfer = None
    if "transfer" in c:
        transfer = flax_learnable_params(jm, VOL, 22, styl0)["unet"]
    jtransfer = {"unet": transfer} if c.get("transfer") == "prefixed" else transfer
    jstate = jlearn.create_learnable_state(
        jax.random.key(0), _FixedInit(jm, params), VOL, transfer_params=jtransfer,
        lr=lr, weight_decay=WD, **opts)
    p0 = learnable_params_from_flax(jax.device_get(jstate.params))

    model = (GibbsUNet(styl0, hard=hard, **WIDTHS, device="cpu") if kind == "gibbs"
             else SpikesUNet(styl0, **WIDTHS, device="cpu"))
    model.load_state_dict(learnable_params_from_flax(params))
    ttransfer = None
    if transfer is not None:
        ttransfer = unet_params_from_flax(transfer)
        if c["transfer"] == "prefixed":
            ttransfer = {f"unet.{k}": v for k, v in ttransfer.items()}
    tstate = tlearn.create_learnable_state(model, transfer_params=ttransfer, lr=lr,
                                           weight_decay=WD, device="cpu", **opts)
    t0 = {k: v.detach().clone() for k, v in model.state_dict().items()}

    images, labels = _data()
    ref, port = {"loss": [], "alpha": []}, {"loss": [], "alpha": []}
    for i in range(K):
        key = jax.random.key(100 + i)
        locs = jax_spike_locations(key, VOL, "spike") if kind == "spikes" else None
        img, lbl = images[i], labels[i]
        if fd:
            jstate, jloss, jalpha = jlearn.fd_train_step(jstate, img, lbl, key, h=FD_H, lr=FD_LR)
            loss, alpha = tlearn.fd_train_step(tstate, torch.from_numpy(img),
                                               torch.from_numpy(lbl), locs, h=FD_H, lr=FD_LR,
                                               device="cpu")
        else:
            ta = c.get("train_alpha", True)
            jstate, jloss, jalpha = jlearn.learnable_train_step(jstate, img, lbl, key,
                                                                train_alpha=ta)
            loss, alpha = tlearn.learnable_train_step(tstate, torch.from_numpy(img),
                                                      torch.from_numpy(lbl), locs,
                                                      train_alpha=ta, device="cpu")
        ref["loss"].append(float(jloss))
        ref["alpha"].append(float(jalpha))
        port["loss"].append(float(loss))
        port["alpha"].append(float(alpha))
    ref["params"] = learnable_params_from_flax(jax.device_get(jstate.params))
    port["params"] = {k: v.detach() for k, v in model.state_dict().items()}
    return {"ref": ref, "port": port, "p0": p0, "t0": t0, "model": model, "state": tstate,
            "transfer": ttransfer, "styl0": styl0, "lr": lr}


FROZEN = [c for c in CASES if CASES[c].get("freeze_unet")]
TRANSFER = [c for c in CASES if "transfer" in CASES[c]]


@pytest.mark.parametrize("name", list(CASES))
def test_steps_match_jax(name):
    r = _run_case(name)
    ref, port = r["ref"], r["port"]
    # the same start: the converted weights, and a transfer applied alike
    assert r["p0"].keys() == r["t0"].keys()
    for k in r["p0"]:
        assert torch.equal(r["p0"][k], r["t0"][k]), k
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=0, atol=LOSS_TOL)
    np.testing.assert_allclose(port["alpha"], ref["alpha"], rtol=ALPHA_TOL, atol=ALPHA_TOL)
    assert r["state"].step == K
    zero = _norm_fed_biases(r["model"])
    for k, p in port["params"].items():
        diff = float((p - ref["params"][k]).abs().max())
        if k in zero:
            assert diff <= K * r["lr"] * 2.01, (k, diff)
        else:
            assert diff <= PARAM_TOL, (k, diff)


@pytest.mark.parametrize("name", list(CASES))
def test_the_trajectory_is_the_parameter_after_each_step(name):
    r = _run_case(name)
    styl = "gibbs.alpha" if "gibbs.alpha" in r["port"]["params"] else "spike.intensity"
    assert r["port"]["alpha"][-1] == float(r["port"]["params"][styl][0])
    c = CASES[name]
    traj = np.asarray([r["styl0"]] + r["ref"]["alpha"], np.float32)
    if not c.get("fd") and c.get("train_alpha", True) is False:
        if c.get("unet_optimizer") == "sgd":
            # a zero gradient and no decay: SGD leaves it where it was
            assert np.all(traj == np.float32(r["styl0"]))
        else:
            # the zeroed gradient still decays: amsgrad normalises the
            # coupled L2 term 1e-5 * alpha to a step of about lr
            steps = -np.diff(traj)
            assert np.all(steps > 0.9 * LR) and np.all(steps < 1.1 * LR), steps
    else:
        assert np.all(np.diff(traj) != 0)


@pytest.mark.parametrize("name", FROZEN)
def test_frozen_unet_never_moves(name):
    r = _run_case(name)
    for k, p in r["port"]["params"].items():
        if k.startswith("unet."):
            assert torch.equal(p, r["t0"][k]), k
            assert torch.equal(r["ref"]["params"][k], r["p0"][k]), k
    # only the stylization parameter reaches the optimizer
    opt_params = [p for g in r["state"].optimizer.param_groups for p in g["params"]]
    assert len(opt_params) == 1 and opt_params[0] is tlearn.styl_param(r["model"])
    assert not any(p.requires_grad for p in r["model"].unet.parameters())


@pytest.mark.parametrize("name", TRANSFER)
def test_transfer_loads_the_unet(name):
    r = _run_case(name)
    for k, v in r["transfer"].items():
        assert torch.equal(r["t0"][k if k.startswith("unet.") else f"unet.{k}"], v), k


@pytest.mark.parametrize("unet_optimizer", ["sgd", "adam"])
def test_fd_step_at_the_top_bound(unet_optimizer):
    """At alpha = 1 under SGD the backprop update leaves alpha at 1, alpha +
    h clips back to 1, so both FD losses are equal and delta is 0: alpha
    stays 1. Under the reference optimizer the decay first moves alpha just
    below 1, which drops the corner points of the hard mask: delta is then
    not 0."""
    model = GibbsUNet(1.0, hard=True, **WIDTHS, device="cpu")
    state = tlearn.create_learnable_state(model, unet_optimizer=unet_optimizer,
                                          device="cpu")
    images, labels = _data()
    calls = []
    real = tlearn.dice_loss

    def spy(logits, label):
        loss = real(logits, label)
        calls.append(float(loss))
        return loss

    tlearn.dice_loss = spy
    try:
        loss, alpha = tlearn.fd_train_step(state, torch.from_numpy(images[0]),
                                           torch.from_numpy(labels[0]), device="cpu")
    finally:
        tlearn.dice_loss = real
    assert len(calls) == 3 and float(loss) == calls[0]
    if unet_optimizer == "sgd":
        assert calls[1] == calls[2] and float(alpha) == 1.0
    else:
        assert calls[1] != calls[2] and float(alpha) != 1.0
