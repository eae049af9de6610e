"""The port's experiment runner (mvtb_tpu_torch/experiments/runner.py), the
segmentation family, against the JAX package's ``run``: chunked and per-step
training from the same initial parameters (the port's state builder is
patched to load JAX's), kill and resume, and the files a run writes."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from mvtb_tpu.experiments import registry as jreg
from mvtb_tpu.experiments import runner as jrunner
from mvtb_tpu.models.unet3d import UNet as JUNet
from mvtb_tpu.train import seg as jseg
from mvtb_tpu_torch.experiments import registry as treg
from mvtb_tpu_torch.experiments import runner as trunner
from mvtb_tpu_torch.models import unet_params_from_flax
from mvtb_tpu_torch.ops.fused import StylizeConfig

TINY = dict(spatial=(16, 16, 8), channels=(4, 8), strides=(2,), num_res_units=1,
            batch_size=2, val_interval=2, epochs=4, data_kind="smooth",
            model_dtype="float32")
RUN = dict(epochs=4, steps_per_epoch=3, seed=0, verbose=False, val_batches=2)
# Per-epoch mean loss and Dice, port against JAX, same weights and batches,
# float32: the losses differ by float32 summation order inside the UNet and
# the optimizer (measured <= 1.2e-7 chunked, <= 9.9e-8 per step); a hard Dice
# moves only where a logit sits at the threshold (measured 0.0)
LOSS_TOL = 1e-5
DICE_TOL = 1e-4


def _jax_init_params(cfg):
    jm = JUNet(out_channels=cfg.out_channels, channels=cfg.channels,
               strides=cfg.strides, num_res_units=cfg.num_res_units)
    state = jseg.create_seg_state(jax.random.key(RUN["seed"]), jm,
                                  (1,) + cfg.spatial + (cfg.in_channels,))
    return unet_params_from_flax(jax.device_get(state.params))


@pytest.fixture
def from_jax_init(monkeypatch):
    """Make the port's runs start from the JAX runs' initial parameters."""
    params = _jax_init_params(jreg.ExperimentConfig(name="init", **TINY))
    real = trunner._seg_state

    def seg_state(cfg, seed, dev, *arch):
        state = real(cfg, seed, dev, *arch)
        state.model.load_state_dict(params)
        return state

    monkeypatch.setattr(trunner, "_seg_state", seg_state)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    cfg = jreg.ExperimentConfig(name="tiny", **TINY)
    out = {}
    for chunked in (True, False):
        w = str(tmp_path_factory.mktemp(f"jax_{chunked}"))
        out[chunked] = (jrunner.run(cfg, workdir=w, chunked=chunked, pool=6, **RUN), w)
    return out


def _compare(port, ref):
    hp, hr = port["history"], ref["history"]
    assert hp["epochs"] == hr["epochs"] == [2, 4]
    np.testing.assert_allclose(hp["loss"], hr["loss"], rtol=0, atol=LOSS_TOL)
    for dp, dr in zip(hp["dice"], hr["dice"]):
        np.testing.assert_allclose(dp["per_class"], dr["per_class"], rtol=0, atol=DICE_TOL)
        assert abs(dp["mean"] - dr["mean"]) <= DICE_TOL
    assert abs(port["best_dice"] - ref["best_dice"]) <= DICE_TOL


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "per_step"])
def test_run_matches_jax(jax_runs, from_jax_init, tmp_path, chunked):
    ref, jw = jax_runs[chunked]
    cfg = treg.ExperimentConfig(name="tiny", **TINY)
    w = str(tmp_path / "w")
    port = trunner.run(cfg, workdir=w, chunked=chunked, pool=6, device="cpu", **RUN)
    _compare(port, ref)
    # the files of the run, with JAX's keys
    for name in ("history.json", "tiny_result.json") if chunked else ("tiny_result.json",):
        with open(os.path.join(w, name)) as f, open(os.path.join(jw, name)) as g:
            assert json.load(f).keys() == json.load(g).keys(), name
    assert os.path.isdir(os.path.join(w, "ckpt"))
    # the JAX runner's PNGs (matplotlib is importable here)
    pngs = lambda d: sorted(f for f in os.listdir(d) if f.endswith(".png"))  # noqa: E731
    assert pngs(w) == pngs(jw) and pngs(w)


def test_pool_arrays_match_jax():
    for kw in ({}, {"select_channel": (3, 0), "in_channels": 1, "out_channels": 1},
               {"multimodal_channels": (0, 1, 2), "in_channels": 1, "out_channels": 1}):
        args = {**TINY, **kw}
        ti, tl = trunner._pool_arrays(treg.ExperimentConfig(name="p", **args), 3, 5, "cpu")
        ji, jl = jrunner._pool_arrays(jreg.ExperimentConfig(name="p", **args), 3, 5)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def _disk_cfg(name):
    sty = StylizeConfig(disk_r=4.0, disk_prob=1.0)
    return treg.ExperimentConfig(name=name, train_stylize=sty, val_stylize=sty, **TINY)


def test_kill_and_resume_replays_the_uninterrupted_run(tmp_path):
    kw = dict(chunked=True, pool=6, device="cpu", **{**RUN, "epochs": 4})
    full = trunner.run(_disk_cfg("r"), workdir=str(tmp_path / "full"), **kw)
    w = str(tmp_path / "resume")
    part = trunner.run(_disk_cfg("r"), workdir=w, **{**kw, "epochs": 2})
    resumed = trunner.run(_disk_cfg("r"), workdir=w, resume=True, **kw)
    assert part["resumed_from"] == 0 and resumed["resumed_from"] == 2
    assert resumed["timing"]["restore_s"] is not None
    h_full, h_res = full["history"], resumed["history"]
    assert h_res["epochs"] == h_full["epochs"] == [2, 4]
    # the prefix is the killed run's, and the tail replays the uninterrupted
    # run bit for bit: same pool rows (RandomState replay), same per-epoch
    # generators, restored state bit-exact (stronger than the JAX package's
    # < 0.15 on the loss)
    assert h_res["loss"][:2] == part["history"]["loss"]
    assert h_res["loss"] == h_full["loss"]
    assert h_res["dice"] == h_full["dice"]
    for p, q in zip(full["state"].model.parameters(), resumed["state"].model.parameters()):
        assert torch.equal(p, q)
    with open(os.path.join(w, "history.json")) as f:
        assert json.load(f) == h_res
    assert sorted(os.listdir(os.path.join(w, "ckpt"))) == ["2.json", "2.pt", "4.json", "4.pt"]


def test_resume_without_checkpoint_starts_fresh(tmp_path):
    res = trunner.run(_disk_cfg("f"), workdir=str(tmp_path / "w"), chunked=True,
                      pool=4, resume=True, device="cpu", **{**RUN, "epochs": 2,
                                                            "steps_per_epoch": 2})
    assert res["resumed_from"] == 0 and len(res["history"]["loss"]) == 2
    assert res["timing"]["restore_s"] is None


def test_resume_truncates_history_and_refuses_undeclared_keys(tmp_path):
    w = str(tmp_path / "w")
    kw = dict(chunked=True, pool=4, device="cpu", **{**RUN, "steps_per_epoch": 2})
    trunner.run(_disk_cfg("k"), workdir=w, **{**kw, "epochs": 2})
    path = os.path.join(w, "history.json")
    with open(path) as f:
        hist = json.load(f)
    # a crash between the history flush and the checkpoint save: history
    # runs past the checkpoint, and is cut back to it on resume
    hist["loss"] += [9.0, 9.0]
    hist["dice"].append({"mean": 9.0, "per_class": [9.0] * 3})
    hist["epochs"].append(4)
    with open(path, "w") as f:
        json.dump(hist, f)
    res = trunner.run(_disk_cfg("k"), workdir=w, resume=True, **{**kw, "epochs": 3})
    assert res["resumed_from"] == 2
    assert res["history"]["epochs"] == [2] and len(res["history"]["loss"]) == 3
    assert 9.0 not in res["history"]["loss"]
    hist["lr"] = [1e-4]
    with open(path, "w") as f:
        json.dump(hist, f)
    with pytest.raises(KeyError, match="lr"):
        trunner.run(_disk_cfg("k"), workdir=w, resume=True, **{**kw, "epochs": 3})


def test_restore_chunked_truncates_each_declared_cadence():
    class Ckpt:
        latest_step = 2

        def restore(self, template):
            return template

    hist = {"loss": [1, 2, 3], "trajectory": [1, 2, 3, 4, 5, 6], "dice": ["a", "b"],
            "epochs": [2, 4]}
    _, start, out = trunner._restore_chunked(
        Ckpt(), "state", hist, None, True, lambda *_: None, "n", 2,
        per_epoch_keys=("loss",), per_step_keys=("trajectory",), per_val_keys=("dice",))
    assert start == 2
    assert out == {"loss": [1, 2], "trajectory": [1, 2, 3, 4], "dice": ["a"], "epochs": [2]}


def test_epoch_generators_depend_on_base_and_epoch_only():
    draw = lambda b, e: torch.rand(4, generator=trunner.epoch_generator(b, e, "cpu"))
    assert torch.equal(draw(0, 3), draw(0, 3))
    assert not torch.equal(draw(0, 3), draw(0, 4))
    assert not torch.equal(draw(0, 3), draw(2, 3))


def test_other_kinds_and_domain_runs_name_their_roadmap_item(monkeypatch):
    """The learnable kinds (tests/test_torch_learnable_runner.py), the GAN
    kinds (tests/test_torch_gan_runner.py) and the domain protocol
    (tests/test_torch_domain.py) are ported: without a card a learnable
    entry and the domain protocol reach the device check instead of raising
    NotImplementedError."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trunner.run("gibbs0p7_layer_GD")
    with pytest.raises(RuntimeError, match="CUDA"):
        trunner.run_domain_experiment("baseline_domain")
    with pytest.raises(ValueError, match="unknown experiment kind"):
        trunner.run(dataclasses.replace(treg.get("baseline"), kind="other"), device="cpu")


def test_run_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trunner.run(treg.ExperimentConfig(name="c", **TINY), epochs=1, steps_per_epoch=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        trunner.epoch_generator(0, 0)
