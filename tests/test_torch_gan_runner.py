"""The port's runner on the GAN family (mvtb_tpu_torch/experiments/runner.py
and the CLI), on the CPU.

The slice data is held to the JAX package's bit for bit; the runs are held
to their contract (curve lengths, checkpoints, FID cadence, exact resume).
The nets keep their hard-wired 128x128 and run at ``gan_nf=16`` (DCGAN
ngf = ndf = 16, ReconGAN nf = 2).
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from mvtb_tpu.experiments import runner as jrunner
from mvtb_tpu.experiments.registry import get as jget
from mvtb_tpu_torch.experiments import __main__ as tmain
from mvtb_tpu_torch.experiments import registry as treg
from mvtb_tpu_torch.experiments import runner as trunner
from mvtb_tpu_torch.train import CheckpointManager

from test_torch_gan_models import one_torch_thread  # noqa: F401  (autouse)

KINDS = ("dcgan", "recon_gan", "recon_gan_freq", "gibbs_gan")


def small(name, **kw):
    return dataclasses.replace(treg.get(name), gan_nf=16, **kw)


def test_slices_and_fid_reals_equal_jax():
    cfg = treg.get("recon_gan")
    ref, got = jrunner._slices_iter(jget("recon_gan"), 3, 5), trunner._slices_iter(cfg, 3, 5)
    for _ in range(2):
        a, b = next(ref), next(got)
        assert b.shape == (5, 2, 128, 128) and b.dtype == np.float32
        assert np.array_equal(np.moveaxis(a, -1, 1), b)
    for a, b in zip(jrunner._fid_reals(jget("dcgan"), 1), trunner._fid_reals(treg.get("dcgan"), 1)):
        assert np.array_equal(np.moveaxis(a, -1, 1), b)


@pytest.mark.parametrize("kind", KINDS)
def test_chunked_runs_every_kind(kind, tmp_path):
    res = trunner.run(small(kind), epochs=2, steps_per_epoch=2, chunked=True,
                      device="cpu", workdir=str(tmp_path), ckpt_every=1, verbose=False)
    h = res["history"]
    keys = trunner.DCGAN_CURVES if kind == "dcgan" else trunner.RECON_CURVES
    assert all(len(h[k]) == 4 and all(math.isfinite(v) for v in h[k]) for k in keys)
    assert h["epochs"] == [1, 2]
    assert CheckpointManager(str(tmp_path / "ckpt")).all_steps() == [1, 2]
    assert len(res["timing"]["chunk_s"]) == 2 and len(res["timing"]["save_s"]) == 2
    saved = json.load(open(tmp_path / f"{kind}_result.json"))
    if kind == "dcgan":
        assert h["fid_epochs"] == [1, 2] and len(h["fid"]) == 2
        assert math.isfinite(res["fid"]) and saved["fid"] == res["fid"]
        assert h["fid"][-1] == res["fid"]  # the same reals and fakes
    else:
        assert "fid" not in res and "fid" not in h
    assert json.load(open(tmp_path / "history.json")) == h


@pytest.mark.parametrize("kind", KINDS)
def test_per_step_runs_every_kind(kind):
    res = trunner.run(small(kind), epochs=2, steps_per_epoch=2, device="cpu", verbose=False)
    h = res["history"]
    assert len(h["g_loss"]) == len(h["d_loss"]) == 4
    assert all(math.isfinite(v) for v in h["g_loss"] + h["d_loss"])
    assert ("fid" in res) == (kind == "dcgan")
    assert res["g_state"].step == res["d_state"].step == 4


def test_mitigated_profile_runs_with_smoothing():
    cfg = treg.mitigated(small("recon_gan"))
    assert cfg.name == "recon_gan_mitigated" and cfg.gan_real_label == 0.9
    res = trunner.run(cfg, epochs=1, steps_per_epoch=2, device="cpu", verbose=False)
    base = trunner.run(small("recon_gan"), epochs=1, steps_per_epoch=2, device="cpu",
                       verbose=False)
    # the same data, weights and draws: only D's real target differs
    assert res["history"]["d_loss"][0] != base["history"]["d_loss"][0]
    same = trunner.run(dataclasses.replace(cfg, gan_real_label=1.0), epochs=1,
                       steps_per_epoch=2, device="cpu", verbose=False)
    assert same["history"] == base["history"]


def test_chunked_resume_replays_the_uninterrupted_run(tmp_path):
    cfg = small("dcgan")
    kw = dict(steps_per_epoch=2, chunked=True, device="cpu", ckpt_every=1, verbose=False)
    full = trunner.run(cfg, epochs=3, workdir=str(tmp_path / "full"), **kw)
    part = trunner.run(cfg, epochs=1, workdir=str(tmp_path / "part"), **kw)
    resumed = trunner.run(cfg, epochs=3, workdir=str(tmp_path / "part"), resume=True, **kw)
    assert resumed["resumed_from"] == 1 and resumed["timing"]["restore_s"] is not None
    h, hf = resumed["history"], full["history"]
    assert h["g_loss"][:2] == part["history"]["g_loss"]
    assert h["epochs"] == hf["epochs"] == [1, 2, 3] and h["fid_epochs"] == [1, 2, 3]
    for k in trunner.DCGAN_CURVES + ("fid",):
        np.testing.assert_allclose(h[k], hf[k], rtol=1e-5, atol=1e-6, err_msg=k)
    for p, q in zip(full["g_state"].model.state_dict().values(),
                    resumed["g_state"].model.state_dict().values()):
        torch.testing.assert_close(p, q, rtol=1e-4, atol=1e-6)


def test_restore_truncates_fid_to_the_checkpoint(tmp_path):
    """A crash after the history flush of an epoch that saved no checkpoint:
    resume truncates every curve, the FID curve by its epochs."""
    cfg = small("dcgan")
    kw = dict(steps_per_epoch=1, chunked=True, device="cpu", verbose=False,
              workdir=str(tmp_path))
    trunner.run(cfg, epochs=3, ckpt_every=2, **kw)  # checkpoint at 2, history to 3
    res = trunner.run(cfg, epochs=2, ckpt_every=2, resume=True, **kw)
    h = res["history"]
    assert res["resumed_from"] == 2 and h["epochs"] == [1, 2]
    assert h["fid_epochs"] == [2] and len(h["fid"]) == 1 and len(h["g_loss"]) == 2


def test_cli_runs_a_gan_config_mitigated(monkeypatch, capsys, tmp_path):
    monkeypatch.setitem(treg.REGISTRY, "dcgan", small("dcgan"))
    assert tmain.main(["run", "dcgan", "--mitigated", "--chunked", "--epochs", "2",
                       "--steps", "1", "--ckpt-every", "2", "--device", "cpu", "--quiet",
                       "--workdir", str(tmp_path)]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(summary) == {"wall_time_s"}
    saved = json.load(open(tmp_path / "dcgan_mitigated_result.json"))
    assert len(saved["history"]["fid"]) == 1 and math.isfinite(saved["fid"])
    assert CheckpointManager(str(tmp_path / "ckpt")).all_steps() == [2]


def test_gan_runs_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trunner.run(small("dcgan"), epochs=1, steps_per_epoch=1)
