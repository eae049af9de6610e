"""The port's plots (mvtb_tpu_torch/eval/plots.py) and the PNGs the runner
writes with them, on the CPU (where matplotlib is installed): the files of
the JAX runner, their absence with one logged line where matplotlib cannot
be imported, and no matplotlib import until a plot is drawn."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mvtb_tpu_torch.eval import plots
from mvtb_tpu_torch.experiments import registry as treg
from mvtb_tpu_torch.experiments import runner as trunner

from test_torch_gan_models import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(spatial=(16, 16, 8), channels=(4, 8), strides=(2,), num_res_units=1,
            batch_size=2, val_interval=1, data_kind="smooth", model_dtype="float32")
PNG = b"\x89PNG\r\n\x1a\n"


def _pngs(w):
    return sorted(f for f in os.listdir(w) if f.endswith(".png"))


def _is_png(path):
    with open(path, "rb") as f:
        return f.read(8) == PNG


def test_every_plot_writes_a_png(tmp_path):
    history = {"loss": [0.9, 0.7, 0.6], "dice": [{"mean": 0.2, "per_class": [0.1, 0.2, 0.3]},
                                                {"mean": 0.4, "per_class": [0.3, 0.4, 0.5]}],
               "epochs": [2, 3]}
    paths = [
        plots.save_learning_curves(history, str(tmp_path / "a.png"), title="t"),
        plots.save_per_class_curves(history, str(tmp_path / "b.png")),
        plots.plot_model_performance({"m1": {"clean": [0.5, 0.4, 0.3, 0.2], "gibbs": 0.3},
                                      "m2": {"clean": 0.6}}, str(tmp_path / "c.png")),
        plots.save_image_grid(np.random.RandomState(0).rand(5, 8, 8, 1), str(tmp_path / "d.png"),
                              nrow=2),
        plots.save_alpha_trajectory([0.7, 0.68, 0.65], str(tmp_path / "e.png")),
    ]
    assert all(_is_png(p) for p in paths)
    # a 1-label run's per-class panel has one entry
    one = {"loss": [1.0], "dice": [{"mean": 0.5, "per_class": [0.5]}]}
    assert _is_png(plots.save_per_class_curves(one, str(tmp_path / "f.png")))


@pytest.mark.parametrize("chunked", [False, True], ids=["per_step", "chunked"])
def test_segmentation_runs_write_the_curves(tmp_path, chunked):
    cfg = treg.ExperimentConfig(name="tiny", **TINY)
    w = str(tmp_path / "w")
    trunner.run(cfg, epochs=2, steps_per_epoch=1, val_batches=1, chunked=chunked, pool=4,
                workdir=w, device="cpu", verbose=False)
    assert _pngs(w) == ["meanValScore_per_label_tiny.png", "trainLoss_and_meanValScore_tiny.png"]
    assert all(_is_png(os.path.join(w, f)) for f in _pngs(w))


@pytest.mark.parametrize("kind,chunked", [("dcgan", False), ("dcgan", True),
                                          ("recon_gan", False), ("recon_gan", True)])
def test_gan_runs_write_the_sample_grid(tmp_path, kind, chunked):
    cfg = dataclasses.replace(treg.get(kind), gan_nf=16, batch_size=2)
    w = str(tmp_path / "w")
    trunner.run(cfg, epochs=1, steps_per_epoch=1, chunked=chunked, workdir=w, device="cpu",
                verbose=False)
    assert _pngs(w) == [f"samples_{kind}.png"]
    assert _is_png(os.path.join(w, f"samples_{kind}.png"))


def test_runs_skip_the_pngs_without_matplotlib(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(plots, "available", lambda: False)
    cfg = treg.ExperimentConfig(name="tiny", **TINY)
    w = str(tmp_path / "w")
    trunner.run(cfg, epochs=1, steps_per_epoch=1, val_batches=1, workdir=w, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert [line for line in out if "PNG" in line] == [
        "[tiny] matplotlib is not importable: PNGs skipped"]
    assert _pngs(w) == []
    assert sorted(os.listdir(w)) == ["ckpt", "tiny_result.json"]


def test_importing_the_port_loads_no_matplotlib():
    code = ("import sys, mvtb_tpu_torch.eval.plots, mvtb_tpu_torch.experiments.runner\n"
            "sys.exit(1 if 'matplotlib' in sys.modules else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    assert subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          timeout=120).returncode == 0
    assert plots.available()
