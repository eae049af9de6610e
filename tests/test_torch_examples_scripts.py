"""The study scripts of the port beyond the two headline studies
(mvtb_tpu_torch/examples/): each end to end on the CPU at a tiny size,
writing its JAX twin's keys; the recovery probe, the mask gallery and the
rotation toy held against their JAX twins on the same inputs; every
script's default device is the card. The two trajectory scripts are checked
for their output and that both modes move their parameter: their steps were
held against the JAX package's in tests/test_torch_learnable_steps.py."""

import importlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtb_tpu.models.resunet_gan import ResUnetGenerator as JRG
from mvtb_tpu.ops import fused as jfused
from mvtb_tpu_torch.examples import (brats_rehearsal, dcgan_fid_report, evaluation_sweep,
                                     fourier_disk_masks, full_scale_run, fullvol_probe,
                                     learnable_trajectory, recon_gan_recovery,
                                     rotate_gradient, spikes_fd_vs_grad)
from mvtb_tpu_torch.experiments.registry import ExperimentConfig, get
from mvtb_tpu_torch.models import ResUnetGenerator, resunet_gan_params_from_flax
from mvtb_tpu_torch.ops import fused
from mvtb_tpu_torch.ops.fused import StylizeConfig

from test_torch_examples_robustness import load_jax_example
from test_torch_fused_plane import jax_stage_draws
from test_torch_gan_models import flax_variables
from test_torch_gan_models import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(unet=dict(channels=(4, 8), strides=(2,), num_res_units=1), model_dtype="float32")
QUIET = dict(log=lambda *_: None)
# the mask gallery's panels: float32 FFTs in another library, of the max
PANEL_TOL = 1e-5
# the rotation toy's loss and gradient, float32
ROTATE_TOL = 1e-6
# PSNR of the same arrays: float32 means and a log10 in another library
PSNR_TOL = 1e-6
# PSNR of a converted G's output on the same corrupted batch: the nets'
# float32 convolutions and instance norms sum in another order
PROBE_TOL = 1e-4
STUDIES = ["robustness_gain", "cross_corruption_matrix", "holdout_hospital", "fullvol_probe",
           "full_scale_run", "brats_rehearsal", "evaluation_sweep", "stylized_gibbs12p5",
           "recon_gan_recovery", "dcgan_fid_report", "learnable_trajectory",
           "spikes_fd_vs_grad", "fourier_disk_masks", "rotate_gradient"]


def _finite(x) -> bool:
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_finite(v) for v in x)
    return not isinstance(x, float) or math.isfinite(x)


def _read(path) -> dict:
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("name", STUDIES)
def test_every_study_defaults_to_the_card(name, monkeypatch, tmp_path):
    """``run()`` on its defaults raises without a card before it writes
    anything; each module runs as ``python -m`` (a ``main``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"mvtb_tpu_torch.examples.{name}")
    args = (str(tmp_path / "data"),) if name == "brats_rehearsal" else ()
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.run(*args)
    assert callable(mod.main) and "__main__" in (ROOT / mod.__file__).read_text()
    assert not os.listdir(tmp_path)


# -- the full-volume probe ----------------------------------------------------

def test_fullvol_probe_end_to_end(tmp_path):
    out = fullvol_probe.run(spatial=(16, 16, 16), batch=2, outdir=str(tmp_path), device="cpu",
                            timed=2, **TINY, **QUIET)
    written = _read(tmp_path / "fullvol.json")
    assert set(written) == {"batch", "requested_spatial", "attempts"}
    (att,) = written["attempts"]
    assert {"spatial", "ok", "ms_per_step", "vol_per_s", "chunked_ms_per_step", "loss",
            "wall_s"} <= set(att) and att["ok"] and math.isfinite(att["loss"])
    assert att["peak_gb"] is None  # no device memory to read on the CPU
    assert out == written | {"requested_spatial": (16, 16, 16),
                             "attempts": [att | {"spatial": (16, 16, 16)}]}


def test_fullvol_probe_records_the_memory_boundary(tmp_path, monkeypatch):
    """Running out of memory is the result: D is halved down to 64; any
    other error is raised."""
    seen = []

    def oom(spatial, *a):
        seen.append(spatial)
        raise torch.OutOfMemoryError("out of memory")

    monkeypatch.setattr(fullvol_probe, "probe", oom)
    out = fullvol_probe.run(outdir=str(tmp_path), device="cpu", **QUIET)
    assert seen == [(240, 240, 160), (240, 240, 80), (240, 240, 40)]
    assert [a["ok"] for a in out["attempts"]] == [False] * 3

    def broken(*a):
        raise ValueError("not a memory fault")

    monkeypatch.setattr(fullvol_probe, "probe", broken)
    with pytest.raises(ValueError):
        fullvol_probe.run(outdir=str(tmp_path), device="cpu", **QUIET)


# -- the resume drill -----------------------------------------------------------

def _drill_config():
    return ExperimentConfig(name="tiny_drill", spatial=(16, 16, 16), channels=(4, 8),
                            strides=(2,), num_res_units=1, batch_size=2, val_interval=2,
                            data_kind="smooth", model_dtype="float32",
                            train_stylize=StylizeConfig(disk_r=4.0, disk_prob=1.0))


def test_full_scale_run_stops_and_resumes_into_continuous_curves(tmp_path):
    cfg = _drill_config()
    run = dict(steps_per_epoch=2, pool=4, val_batches=1, device="cpu", verbose=False)
    full = full_scale_run.run(cfg, epochs=4, out_dir=str(tmp_path / "full"), **run)
    part = full_scale_run.run(cfg, epochs=2, out_dir=str(tmp_path / "resumed"), **run)
    resumed = full_scale_run.run(cfg, epochs=4, out_dir=str(tmp_path / "resumed"),
                                 resume=True, **run)
    assert set(resumed) == {"config", "epochs", "steps_per_epoch", "batch_size",
                            "total_steps", "best_dice", "final_loss", "events"}
    assert [e["kind"] for e in resumed["events"]] == ["start", "resume"]
    assert resumed["events"][1]["from_epoch"] == 2 and part["total_steps"] == 4
    h_full = _read(tmp_path / "full" / "history.json")
    h_res = _read(tmp_path / "resumed" / "history.json")
    assert h_res["epochs"] == h_full["epochs"] == [2, 4]
    # the resume replays the uninterrupted run (exact on the CPU)
    assert h_res["loss"] == h_full["loss"] and len(h_res["loss"]) == 4
    assert resumed["final_loss"] == full["final_loss"]
    assert _read(tmp_path / "resumed" / "summary.json") == resumed


def test_full_scale_run_cli(tmp_path, monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(full_scale_run, "run", lambda *a: calls.append(a) or {"ok": 1})
    full_scale_run.main(["--epochs", "3", "--resume", "--out_dir", str(tmp_path),
                         "--device", "cpu"])
    assert calls == [("gibbs12p5", 3, 194, 48, 12, str(tmp_path), True, 0, "cpu")]
    assert json.loads(capsys.readouterr().out) == {"ok": 1}


# -- the rehearsal, the sweep, the reference-style script ---------------------

def test_brats_rehearsal_end_to_end(tmp_path):
    summary = brats_rehearsal.run(str(tmp_path / "data"), out_dir=str(tmp_path / "out"),
                                  steps=4, chunk=2, roi=(16, 16, 16), gibbs_radii=(6.0, 4.0, 3.0),
                                  n_volumes=10, raw_size=(24, 24, 20), device="cpu",
                                  **TINY, **QUIET)
    assert set(summary) == {"root_dir", "steps", "final_loss", "eval", "tables", "plot",
                            "checkpoint", "wall_s"}
    assert set(summary["eval"]) == {"baseline_data", "gibbs6_data", "gibbs4_data",
                                    "gibbs3_data"}
    assert all(len(v) == 4 and _finite(v) for v in summary["eval"].values())
    assert _read(summary["tables"])["instance_name"] == "rehearsal_model"
    assert os.path.exists(os.path.join(summary["checkpoint"], "4.pt"))
    assert math.isfinite(summary["final_loss"])
    assert _read(tmp_path / "out" / "summary.json") == summary
    args = brats_rehearsal.parse_args(["--root_dir", "r", "--roi", "32", "32", "16",
                                       "--device", "cpu"])
    assert args.roi == [32, 32, 16] and args.out_dir == "runs_torch/brats_rehearsal"


def test_evaluation_sweep_end_to_end(tmp_path):
    dicts = evaluation_sweep.run(epochs=1, workdir=str(tmp_path), spatial=(16, 16, 16),
                                 steps_per_epoch=2, device="cpu", verbose=False)
    sets = ["clean", "gibbs0.3", "gibbs0.6", "wrap0.5", "sap0.15"]
    assert list(dicts) == ["baseline", "gibbs12.5"]
    for name, d in dicts.items():
        assert list(d) == sets and all(len(v) == 4 and _finite(list(v)) for v in d.values())
        assert list(_read(tmp_path / f"{name}_model.json")["eval_dict"]) == sets


def test_stylized_gibbs12p5_runs_as_a_module(tmp_path):
    """In a process of its own: the shims put bare module names on the path."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", MAX_EPOCHS="2",
               STEPS_PER_EPOCH="1", WORKDIR=str(tmp_path / "w"))
    res = subprocess.run([sys.executable, "-m", "mvtb_tpu_torch.examples.stylized_gibbs12p5",
                          "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "train completed, best_metric:" in res.stdout
    assert "saved new best metric model" in res.stdout
    assert sorted(os.listdir(tmp_path / "w" / "ckpt")) == ["2.json", "2.pt"]


# -- the GAN studies --------------------------------------------------------------

@pytest.fixture(scope="module")
def jrecon():
    return load_jax_example("recon_gan_recovery")


def test_slice_pool_is_the_jax_script_s(jrecon):
    ref = jrecon.slice_pool(np.random.RandomState(3), 11, 32)
    got = recon_gan_recovery.slice_pool(np.random.RandomState(3), 11, 32)
    np.testing.assert_array_equal(got, np.moveaxis(ref, -1, 1))


def test_psnr_matches_jax(jrecon):
    rng = np.random.RandomState(4)
    x, ref = rng.uniform(-1, 1, (2, 5, 16, 16, 1)).astype(np.float32)
    x[1] = ref[1]  # an identical image: the 1e-12 floor
    got = recon_gan_recovery.psnr(torch.from_numpy(x), torch.from_numpy(ref))
    want = jrecon.psnr(jnp.asarray(x), jnp.asarray(ref))
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= PSNR_TOL * abs(float(w))


@pytest.mark.parametrize("variant", ["image", "gibbs"])
def test_recovery_probe_matches_jax(jrecon, variant):
    """The probe's two PSNRs for a converted G (the JAX script's G at
    nf = 4) on the probe's (target, corrupted) pair, handed across."""
    kw = recon_gan_recovery.VARIANT_KW[variant]
    val = torch.from_numpy(recon_gan_recovery.slice_pool(np.random.RandomState(1000), 2, 128))
    target, corrupted = recon_gan_recovery.probe_batch(val, kw, seed=0)
    jg = JRG(in_chans=1, nf=4, global_residual=variant != "gibbs")
    gv = flax_variables(jg, jnp.zeros((2, 128, 128, 1)), 6)
    g = ResUnetGenerator(1, 4, global_residual=variant != "gibbs", device="cpu")
    g.load_state_dict(resunet_gan_params_from_flax(jax.device_get(gv["params"])))
    p_in, p_out, _ = recon_gan_recovery.probe(g, target, corrupted)
    to_nhwc = lambda t: jnp.asarray(t.movedim(1, -1).numpy())  # noqa: E731
    want_in = jrecon.psnr(to_nhwc(corrupted), to_nhwc(target))
    want_out = jrecon.psnr(jg.apply(gv, to_nhwc(corrupted)), to_nhwc(target))
    for got, want, tol in ((p_in, want_in, PSNR_TOL), (p_out, want_out, PROBE_TOL)):
        for a, b in zip(got, want):
            assert abs(float(a) - float(b)) <= tol * abs(float(b))
    assert float(p_out[1]) != float(p_in[1])


def test_recon_gan_recovery_end_to_end(tmp_path):
    res = recon_gan_recovery.run(steps=2, batch=2, chunk=1, pool=4, val_batch=2, nf=4,
                                 outdir=str(tmp_path), device="cpu", **QUIET)
    written = _read(tmp_path / "recovery.json")
    assert written == res and list(res) == ["image", "freq", "gibbs"]
    for r in res.values():
        assert set(r) == {"steps", "batch", "size", "g_lr", "d_lr", "real_label",
                          "psnr_corrupted_input", "psnr_recovered", "psnr_gain_db",
                          "psnr_gain_agg_db", "history", "wall_s"}
        assert [h["step"] for h in r["history"]] == [1, 2] and _finite(r)
        # the probe is paired: the same corrupted input after every chunk
        assert r["history"][0]["psnr_in"] == r["history"][1]["psnr_in"]


def test_dcgan_fid_report_end_to_end(tmp_path):
    out = dcgan_fid_report.run(rounds=2, steps=1, outdir=str(tmp_path), nf=4, device="cpu",
                               **QUIET)
    assert _read(tmp_path / "fid_curve.json") == out
    assert set(out) == {"config", "steps_per_round", "curve"}
    assert [c["step"] for c in out["curve"]] == [1, 2]
    assert all(set(c) == {"step", "fid", "g_loss", "d_loss"} and _finite(c)
               for c in out["curve"])


# -- the trajectory studies (their steps: tests/test_torch_learnable_steps.py) --

def test_learnable_trajectory_moves_alpha_in_both_modes(tmp_path):
    res = learnable_trajectory.run(spatial=(16, 16, 16), steps=3, batch=2,
                                   outdir=str(tmp_path), device="cpu", **QUIET)
    written = _read(tmp_path / "learnable_trajectories.json")
    assert set(written) == {"alpha0", "steps", "spatial", "fd", "grad"}
    for mode in ("fd", "grad"):
        assert set(written[mode]) == {"losses", "final_alpha", "wall_s"}
        traj = np.loadtxt(tmp_path / f"gibbs_trajectory_{mode}.txt")
        assert traj.shape == (3,) and np.all(np.isfinite(traj))
        assert abs(traj[-1] - 0.7) > 1e-6 and len(set(traj.tolist())) == 3
        assert res[mode]["final_alpha"] == written[mode]["final_alpha"] == pytest.approx(traj[-1])


def test_spikes_fd_vs_grad_moves_the_intensity_in_both_modes(tmp_path):
    import dataclasses

    cfg = dataclasses.replace(get("spikes11_layer_GD"), spatial=(16, 16, 16), channels=(4, 8),
                              strides=(2,), num_res_units=1, model_dtype="float32",
                              data_kind="smooth")
    out = spikes_fd_vs_grad.run(epochs=1, steps=3, outdir=str(tmp_path), config=cfg, pool=4,
                                device="cpu", **QUIET)
    assert _read(tmp_path / "comparison.json") == out
    assert set(out) == {"epochs", "steps_per_epoch", "fd_h", "fd_lr", "results"}
    assert (out["fd_h"], out["fd_lr"]) == (0.05, 0.1)
    for mode in ("fd", "grad"):
        r = out["results"][mode]
        assert set(r) == {"start", "end", "delta", "per_1k_steps", "final_loss",
                          "trajectory_every_50"}
        assert r["delta"] != 0.0 and _finite(r)
    assert out["results"]["fd"]["delta"] != out["results"]["grad"]["delta"]


# -- the mask gallery and the rotation toy -------------------------------------

@pytest.fixture(scope="module")
def gallery():
    return fourier_disk_masks.panels(device="cpu")


@pytest.mark.parametrize("index", range(len(fourier_disk_masks.cases())))
def test_gallery_panel_matches_jax(gallery, index):
    """Each panel against the JAX package's ``stylize_batch`` of the same
    slice; the spike's location and value come from the JAX draws, handed
    across (the port's own panel draws from its generator)."""
    title, cfg = fourier_disk_masks.cases()[index]
    x2d = fourier_disk_masks.slice2d()
    if cfg is None:
        np.testing.assert_array_equal(gallery[index][1], x2d)
        return
    key = jax.random.key(0)
    jcfg = jfused.StylizeConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    ref = np.asarray(jfused.stylize_batch(jnp.asarray(x2d)[None, None], key, jcfg))[0, 0]
    got = gallery[index][1]
    if cfg.spike:
        draws = jax_stage_draws(key, jcfg, (1, 1) + x2d.shape)
        got = fused.stylize_batch(torch.from_numpy(x2d)[None, None], cfg, draws=draws,
                                  device="cpu")[0, 0].numpy()
    assert gallery[index][0] == title
    assert np.abs(got - ref).max() <= PANEL_TOL * np.abs(ref).max()


def test_gallery_writes_its_figure(tmp_path):
    out = fourier_disk_masks.run(outdir=str(tmp_path), device="cpu", **QUIET)
    assert len(out["panels"]) == len(fourier_disk_masks.cases())
    pytest.importorskip("matplotlib")
    assert out["path"] == str(tmp_path / "fourier_disk_masks.png")
    assert os.path.getsize(out["path"]) > 0


@pytest.fixture(scope="module")
def jrotate():
    return load_jax_example("rotate_gradient")


@pytest.mark.parametrize("theta", [0.3, 1.0, -2.5])
def test_rotate_value_and_grad_match_jax(jrotate, theta):
    v, target = jnp.array([1.0, 0.0]), jnp.array([0.0, 1.0])
    want = jax.value_and_grad(lambda t: jnp.sum((jrotate.rotate(t, v) - target) ** 2))(
        jnp.float32(theta))
    got = rotate_gradient.value_and_grad(torch.tensor(theta), torch.tensor([1.0, 0.0]),
                                         torch.tensor([0.0, 1.0]))
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= ROTATE_TOL


def test_rotate_gradient_descends_to_a_quarter_turn():
    out = rotate_gradient.run(device="cpu", **QUIET)
    assert len(out["losses"]) == 30 and out["losses"][-1] < out["losses"][0]
    assert abs(out["final_theta"] - math.pi / 2) < 0.05
