"""The port's learnable-stylization runs (mvtb_tpu_torch/experiments/runner.py)
against the JAX package's ``run``: a narrowed finite-difference Gibbs entry
chunked and per step from JAX's initial weights, the files a run writes,
kill and resume, the CLI, and one step of every learnable registry entry,
narrowed."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from mvtb_tpu.experiments import registry as jreg
from mvtb_tpu.experiments import runner as jrunner
from mvtb_tpu.models import layers as jl
from mvtb_tpu.train import learnable as jlearn
from mvtb_tpu_torch.eval import plots
from mvtb_tpu_torch.experiments import __main__ as tmain
from mvtb_tpu_torch.experiments import registry as treg
from mvtb_tpu_torch.experiments import runner as trunner
from mvtb_tpu_torch.models import learnable_params_from_flax
from test_torch_gan_models import one_torch_thread  # noqa: F401  (autouse)

NAME = "gibbs0p7_layer_GD"
# a UNet of two levels over 16^3, batch 2; the hard mask and FD step of the
# entry as registered (alpha 0.7, h = 0.01, lr = 0.02)
NARROW = dict(spatial=(16, 16, 16), channels=(4, 8), strides=(2,), num_res_units=1,
              batch_size=2, data_kind="smooth", val_interval=1)
RUN = dict(epochs=2, steps_per_epoch=3, seed=0, verbose=False)
# Per-epoch (chunked) and per-step losses, port against JAX, same weights
# and batches, float32: the losses differ by float32 summation order
# inside the UNet and the Dice reduction (measured <= 6.0e-8).
LOSS_TOL = 2e-6
# The alpha trajectory, absolute: each FD step moves alpha by
# 0.02 * (l(a + h) - l(a)) / 0.01, whose loss difference carries both
# losses' rounding (measured <= 2.4e-7, a few ulps of 0.7).
ALPHA_TOL = 1e-6

LEARNABLE = [n for n in jreg.names() if jreg.get(n).kind in trunner.LEARNABLE_KINDS]


def _narrow(reg, name=NAME):
    return dataclasses.replace(reg.get(name), **NARROW)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    cfg = _narrow(jreg)
    out = {}
    for chunked in (True, False):
        w = str(tmp_path_factory.mktemp(f"jax_{chunked}"))
        out[chunked] = (jrunner.run(cfg, workdir=w, chunked=chunked, pool=6, **RUN), w)
    return out


@pytest.fixture
def from_jax_init(monkeypatch):
    """Make the port's runs start from the JAX runs' initial parameters
    (``create_learnable_state`` from ``key(seed)``, as the JAX runner
    builds them)."""
    cfg = _narrow(jreg)
    jm = jl.GibbsUNet(alpha_init=cfg.alpha0, hard=cfg.fd_mode, out_channels=cfg.out_channels,
                      channels=cfg.channels, strides=cfg.strides,
                      num_res_units=cfg.num_res_units)
    state = jlearn.create_learnable_state(jax.random.key(RUN["seed"]), jm,
                                          (cfg.batch_size, cfg.in_channels) + cfg.spatial)
    params = learnable_params_from_flax(jax.device_get(state.params))
    real = trunner._learnable_state

    def learnable_state(cfg, seed, dev, transfer_params=None):
        state = real(cfg, seed, dev, transfer_params)
        state.model.load_state_dict(params)
        return state

    monkeypatch.setattr(trunner, "_learnable_state", learnable_state)


def _files(d):
    return sorted(f for f in os.listdir(d) if f.endswith((".png", ".txt")))


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "per_step"])
def test_run_matches_jax(jax_runs, from_jax_init, tmp_path, chunked):
    ref, jw = jax_runs[chunked]
    w = str(tmp_path / "w")
    port = trunner.run(_narrow(treg), workdir=w, chunked=chunked, pool=6, device="cpu", **RUN)
    n = RUN["epochs"] * RUN["steps_per_epoch"]
    assert len(port["trajectory"]) == len(ref["trajectory"]) == n
    assert len(port["losses"]) == len(ref["losses"]) == (RUN["epochs"] if chunked else n)
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=0, atol=LOSS_TOL)
    np.testing.assert_allclose(port["trajectory"], ref["trajectory"], rtol=0, atol=ALPHA_TOL)
    # the files of the run, with JAX's names and keys
    names = (["history.json"] if chunked else []) + [f"{NAME}_result.json"]
    for name in names:
        with open(os.path.join(w, name)) as f, open(os.path.join(jw, name)) as g:
            assert json.load(f).keys() == json.load(g).keys(), name
    assert _files(w) == _files(jw) == [f"gibbs_trajectory_{NAME}.txt", f"trajectory_{NAME}.png"]
    np.testing.assert_allclose(np.loadtxt(os.path.join(w, f"gibbs_trajectory_{NAME}.txt")),
                               port["trajectory"], rtol=0, atol=0)
    if chunked:
        assert port["history"]["epochs"] == ref["history"]["epochs"] == [1, 2]
        # a checkpoint every val_interval epoch
        assert sorted(os.listdir(os.path.join(w, "ckpt"))) == ["1.json", "1.pt", "2.json",
                                                              "2.pt"]


def _spikes(name="spikes11_layer_GD"):
    return _narrow(treg, name)


def test_kill_and_resume_replays_the_uninterrupted_run(tmp_path):
    """A spike run (draws from the per-epoch generators) killed after 2 of 4
    epochs and resumed: the prefix is the killed run's, and the rest
    replays the uninterrupted run bit for bit."""
    kw = dict(chunked=True, pool=6, device="cpu", steps_per_epoch=2, seed=1, verbose=False)
    full = trunner.run(_spikes(), workdir=str(tmp_path / "full"), epochs=4, **kw)
    w = str(tmp_path / "resume")
    part = trunner.run(_spikes(), workdir=w, epochs=2, **kw)
    resumed = trunner.run(_spikes(), workdir=w, epochs=4, resume=True, **kw)
    assert part["resumed_from"] == 0 and resumed["resumed_from"] == 2
    assert resumed["timing"]["restore_s"] is not None
    assert resumed["trajectory"][:4] == part["trajectory"]
    assert resumed["trajectory"] == full["trajectory"]
    assert resumed["losses"] == full["losses"]
    assert resumed["history"]["epochs"] == [1, 2, 3, 4]
    for p, q in zip(full["state"].model.parameters(), resumed["state"].model.parameters()):
        assert p.equal(q)
    with open(os.path.join(w, "history.json")) as f:
        assert json.load(f) == resumed["history"]
    assert len(np.loadtxt(os.path.join(w, "gibbs_trajectory_spikes11_layer_GD.txt"))) == 8


def test_without_matplotlib_the_trajectory_text_is_still_written(tmp_path, monkeypatch):
    monkeypatch.setattr(plots, "available", lambda: False)
    logged = []
    monkeypatch.setattr("builtins.print", lambda *a, **k: logged.append(" ".join(map(str, a))))
    trunner.run(_spikes(), workdir=str(tmp_path), epochs=1, steps_per_epoch=1, device="cpu")
    assert _files(str(tmp_path)) == ["gibbs_trajectory_spikes11_layer_GD.txt"]
    assert sum("PNGs skipped" in line for line in logged) == 1


@pytest.mark.parametrize("extra", [[], ["--chunked", "--pool", "4"]], ids=["per_step", "chunked"])
def test_cli_runs_a_learnable_entry(monkeypatch, capsys, tmp_path, extra):
    monkeypatch.setitem(treg.REGISTRY, NAME, _narrow(treg))
    argv = ["run", NAME, "--device", "cpu", "--epochs", "1", "--steps", "2", "--quiet",
            "--workdir", str(tmp_path / "w")] + extra
    assert tmain.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and set(json.loads(lines[0])) == {"wall_time_s"}
    with open(tmp_path / "w" / f"{NAME}_result.json") as f:
        assert len(json.load(f)["trajectory"]) == 2
    if extra:  # and it resumes from what it saved
        assert tmain.main(argv + ["--resume", "--epochs", "2"]) == 0
        with open(tmp_path / "w" / "history.json") as f:
            assert json.load(f)["epochs"] == [1, 2]


def test_every_learnable_entry_is_listed():
    assert len(LEARNABLE) == 34
    kinds = [jreg.get(n).kind for n in LEARNABLE]
    assert kinds.count("learnable_gibbs") == 29 and kinds.count("learnable_spikes") == 5


@pytest.mark.parametrize("name", LEARNABLE)
def test_every_learnable_entry_runs(name):
    """One step of each learnable entry, narrowed (its kind, mask, step,
    optimizer, frozen UNet and fixed alpha as registered)."""
    cfg = _narrow(treg, name)
    res = trunner.run(cfg, epochs=1, steps_per_epoch=1, device="cpu", verbose=False)
    assert len(res["trajectory"]) == 1 and np.isfinite(res["trajectory"][0])
    assert np.isfinite(res["losses"][0])
    styl = (res["state"].model.gibbs.alpha if cfg.kind == "learnable_gibbs"
            else res["state"].model.spike.intensity)
    assert res["trajectory"][0] == float(styl[0])


def test_per_step_run_transfers_a_unet_from_a_checkpoint_dir(tmp_path):
    """A per-step run whose ``transfer_from`` is a checkpoint directory
    warm-starts its UNet from it, as the JAX runner does (a registry name
    transfers nothing); with the UNet frozen it ends where it started."""
    import torch

    from mvtb_tpu_torch.models import UNet
    from mvtb_tpu_torch.train import CheckpointManager, create_seg_state

    torch.manual_seed(3)
    src = create_seg_state(UNet(1, 1, device="cpu"), device="cpu")
    CheckpointManager(str(tmp_path / "ck")).save(1, src)
    cfg = dataclasses.replace(treg.get("gibbs0p7_layer_frozen"), spatial=(16, 16, 16),
                              data_kind="smooth", transfer_from=str(tmp_path / "ck"))
    res = trunner.run(cfg, epochs=1, steps_per_epoch=1, device="cpu", verbose=False)
    want, got = src.model.state_dict(), res["state"].model.unet.state_dict()
    assert want.keys() == got.keys() and all(torch.equal(want[k], got[k]) for k in want)
    # a registry name is not a directory: nothing is transferred
    plain = trunner.run(dataclasses.replace(cfg, transfer_from="baseline_domain"), epochs=1,
                        steps_per_epoch=1, device="cpu", verbose=False)
    first = next(iter(want))
    assert not torch.equal(plain["state"].model.unet.state_dict()[first], want[first])
