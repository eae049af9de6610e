"""The hospital-domain protocol of the port
(mvtb_tpu_torch/experiments/runner.py:run_domain_experiment) against the
JAX package's, end to end: same initial weights (the port's state builder
is patched to load JAX's), same hospitals, a deterministic stylization;
the in-distribution branch, the files written and the CLI."""

import dataclasses
import json
import os
import pickle

import jax
import numpy as np
import pytest

from mvtb_tpu.experiments import registry as jreg
from mvtb_tpu.experiments import runner as jrunner
from mvtb_tpu.models.unet3d import UNet as JUNet
from mvtb_tpu.ops.fused import StylizeConfig as JStylizeConfig
from mvtb_tpu.train import seg as jseg
from mvtb_tpu_torch.experiments import __main__ as tmain
from mvtb_tpu_torch.experiments import registry as treg
from mvtb_tpu_torch.experiments import runner as trunner
from mvtb_tpu_torch.models import unet_params_from_flax
from mvtb_tpu_torch.ops.fused import StylizeConfig

# 1 -> 1 channels, 32^3 (every axis >= 32), float32, disk-only stylize
# (prob 1: no random draw), 4 volumes a hospital, 1 epoch x 2 steps
TINY = dict(in_channels=1, out_channels=1, spatial=(32, 32, 32), channels=(4, 8, 16),
            strides=(2, 2), num_res_units=1, model_dtype="float32", epochs=1)
STYLE = dict(disk_r=6.0, disk_prob=1.0)
RUN = dict(epochs=1, steps_per_epoch=2, seed=0, n_per_hospital=4, verbose=False)
# Per-step losses, port against JAX, same weights and batches, float32: they
# differ by float32 summation order in the UNet and the optimizer (measured
# <= 2.4e-7 over 2 and 4 steps); a hard Dice moves only where a logit sits
# at the threshold (measured 0.0); the gap is their difference
LOSS_TOL = 1e-5
DICE_TOL = 1e-4


def _configs(name, **extra):
    jc = jreg.ExperimentConfig(name=name, train_stylize=JStylizeConfig(**STYLE),
                               val_stylize=JStylizeConfig(**STYLE), **TINY, **extra)
    tc = treg.ExperimentConfig(name=name, train_stylize=StylizeConfig(**STYLE),
                               val_stylize=StylizeConfig(**STYLE), **TINY, **extra)
    return jc, tc


@pytest.fixture(scope="module")
def jax_params():
    jc, _ = _configs("init")
    jm = JUNet(out_channels=jc.out_channels, channels=jc.channels, strides=jc.strides,
               num_res_units=jc.num_res_units)
    state = jseg.create_seg_state(jax.random.key(RUN["seed"]), jm,
                                  (1,) + jc.spatial + (jc.in_channels,))
    return unet_params_from_flax(jax.device_get(state.params))


@pytest.fixture
def from_jax_init(monkeypatch, jax_params):
    """The port's domain runs start from the JAX runs' initial weights."""
    real = trunner._seg_state

    def seg_state(cfg, seed, dev):
        state = real(cfg, seed, dev)
        state.model.load_state_dict(jax_params)
        return state

    monkeypatch.setattr(trunner, "_seg_state", seg_state)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = {}
    for in_dist in (False, True):
        jc, _ = _configs("tiny_domain", in_dist_val=in_dist)
        w = str(tmp_path_factory.mktemp(f"jax_{in_dist}"))
        out[in_dist] = (jrunner.run_domain_experiment(jc, workdir=w, **RUN), w)
    return out


@pytest.mark.parametrize("in_dist", [False, True], ids=["holdout", "in_dist_val"])
def test_domain_run_matches_jax(jax_runs, from_jax_init, tmp_path, in_dist):
    ref, jw = jax_runs[in_dist]
    _, tc = _configs("tiny_domain", in_dist_val=in_dist)
    w = str(tmp_path / "w")
    port = trunner.run_domain_experiment(tc, workdir=w, device="cpu", **RUN)
    assert set(port) == set(ref) == {"losses", "eval_dict", "gap", "state"}
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=0, atol=LOSS_TOL)
    assert len(port["losses"]) == RUN["steps_per_epoch"]
    hospitals = ["hospital_A", "hospital_B", "hospital_C"] + ([] if in_dist else ["holdout"])
    assert list(port["eval_dict"]) == list(ref["eval_dict"]) == hospitals
    for k in hospitals:
        assert abs(port["eval_dict"][k] - float(ref["eval_dict"][k])) <= DICE_TOL, k
    assert set(port["gap"]) == set(ref["gap"])
    for k, v in port["gap"].items():
        if in_dist and k != "in_dist_mean":
            assert np.isnan(v) and np.isnan(ref["gap"][k]), k
        else:
            assert abs(v - ref["gap"][k]) <= 2 * DICE_TOL, k
    assert port["state"].step == RUN["steps_per_epoch"]
    # the files, with the JAX package's names and keys
    assert sorted(os.listdir(w)) == sorted(os.listdir(jw)) == [
        "tiny_domain_domain.json", "tiny_domain_domain.pickle", "tiny_domain_gap.json"]
    with open(os.path.join(w, "tiny_domain_domain.json")) as f, \
            open(os.path.join(jw, "tiny_domain_domain.json")) as g:
        rec, jrec = json.load(f), json.load(g)
    assert rec.keys() == jrec.keys()
    assert rec["eval_dict"].keys() == jrec["eval_dict"].keys()
    assert {k: v for k, v in rec.items() if k != "eval_dict"} == \
        {k: v for k, v in jrec.items() if k != "eval_dict"}
    with open(os.path.join(w, "tiny_domain_domain.pickle"), "rb") as f:
        assert pickle.load(f) == rec
    with open(os.path.join(w, "tiny_domain_gap.json")) as f:
        gap = json.load(f)
    assert gap.keys() == port["gap"].keys()


def test_domain_run_is_deterministic_and_trains(tmp_path):
    _, tc = _configs("det")
    a = trunner.run_domain_experiment(tc, device="cpu", **RUN)
    b = trunner.run_domain_experiment(tc, device="cpu", **RUN)
    assert a["losses"] == b["losses"] and a["eval_dict"] == b["eval_dict"]
    assert all(np.isfinite(a["losses"]))
    # without a val stylize the loaders are scored as they are
    plain = trunner.run_domain_experiment(dataclasses.replace(tc, val_stylize=None),
                                          device="cpu", **RUN)
    assert plain["losses"] == a["losses"]
    assert plain["eval_dict"] != a["eval_dict"]


def test_cli_domain_passes_its_arguments_and_runs_once(monkeypatch, capsys, tmp_path):
    calls = {"domain": [], "run": 0}

    def fake_domain(target, **kw):
        calls["domain"].append((target, kw))
        return {"losses": [0.5], "eval_dict": {}, "state": None,
                "gap": {"in_dist_mean": 0.5, "holdout": 0.25, "gap": 0.25,
                        "normalized_gap": 0.5}}

    def fake_run(*a, **kw):
        calls["run"] += 1
        return {}

    monkeypatch.setattr(trunner, "run_domain_experiment", fake_domain)
    monkeypatch.setattr(trunner, "run", fake_run)
    import mvtb_tpu_torch.experiments as texp

    monkeypatch.setattr(texp, "run_domain_experiment", fake_domain)
    monkeypatch.setattr(texp, "run", fake_run)
    w = str(tmp_path / "w")
    assert tmain.main(["domain", "gibbs15_domain", "--epochs", "3", "--steps", "5",
                       "--seed", "7", "--workdir", w, "--quiet", "--device", "cpu"]) == 0
    assert calls["run"] == 0
    assert calls["domain"] == [("gibbs15_domain", dict(
        epochs=3, steps_per_epoch=5, seed=7, workdir=w, verbose=False, device="cpu"))]
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == {"gap": {"in_dist_mean": 0.5, "holdout": 0.25,
                                            "gap": 0.25, "normalized_gap": 0.5}}


def test_cli_domain_runs_a_config_end_to_end(monkeypatch, capsys, tmp_path):
    _, tc = _configs("gibbs15_domain")
    monkeypatch.setitem(treg.REGISTRY, "gibbs15_domain", tc)
    w = tmp_path / "w"
    assert tmain.main(["domain", "gibbs15_domain", "--epochs", "1", "--steps", "1",
                       "--workdir", str(w), "--quiet", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert set(summary) == {"gap"}
    assert sorted(os.listdir(w)) == ["gibbs15_domain_domain.json",
                                     "gibbs15_domain_domain.pickle", "gibbs15_domain_gap.json"]
    # one run: the domain experiment's files only, no segmentation run's
    assert not os.path.exists(w / "gibbs15_domain_result.json")
