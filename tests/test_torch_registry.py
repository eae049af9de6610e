"""The port's registry and CLI (mvtb_tpu_torch/experiments) against the
JAX package's: every config field by field, the profiles, the ``list``
output, and a tiny ``run`` through the CLI."""

import inspect
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mvtb_tpu.experiments import __main__ as jmain
from mvtb_tpu.experiments import registry as jreg
from mvtb_tpu_torch.experiments import __main__ as tmain
from mvtb_tpu_torch.experiments import registry as treg
from mvtb_tpu_torch.ops import fused, fused_plane

ROOT = Path(__file__).resolve().parent.parent
NAMES = jreg.names()


def test_names_match_jax():
    assert treg.names() == NAMES and len(NAMES) >= 90


@pytest.mark.parametrize("profile", ["as_is", "fast_science", "mitigated"])
def test_every_config_matches_jax(profile):
    for name in NAMES:
        jc, tc = jreg.get(name), treg.get(name)
        if profile != "as_is":
            jc, tc = getattr(jreg, profile)(jc), getattr(treg, profile)(tc)
        assert isinstance(tc, treg.ExperimentConfig)
        for sty in (tc.train_stylize, tc.val_stylize):
            assert sty is None or isinstance(sty, fused.StylizeConfig)
        # StylizeConfigs compare through asdict too; the two classes have
        # the same fields
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), name


def test_segmentation_stylizations_run_on_the_ported_paths():
    """No segmentation config, nor its fast profile, reaches a stylization
    path that raises NotImplementedError: every path is ported now (the
    fused module raises it nowhere), and each config resolves to a backend
    and draws its parameters."""
    checked = 0
    for name in NAMES:
        cfg = treg.get(name)
        if cfg.kind != "segmentation":
            continue
        for c in (cfg, treg.fast_science(cfg)):
            for sty in (c.train_stylize, c.val_stylize):
                if sty is None:
                    continue
                for dev in ("cpu", "cuda"):
                    backend = fused._resolve_backend(sty.fft_backend, c.spatial, dev)
                    assert backend != "hybrid"
                    assert backend in fused.BACKENDS
                    if backend in ("plane", "plane_fast"):
                        fused_plane.plane_kernel_eligible(sty, c.spatial)
                assert sty.n_dims == 3
                fused.sample_draws(sty, c.spatial, 1, 1, device="cpu")
                checked += 1
    assert checked > 100
    assert "NotImplementedError" not in inspect.getsource(fused)


def test_other_kinds_are_named_in_the_runner():
    """Every registry kind is run (segmentation, the GAN kinds) or queued
    under its ROADMAP item (the learnable kinds)."""
    from mvtb_tpu_torch.experiments import runner

    kinds = {treg.get(n).kind for n in NAMES} - {"segmentation"}
    assert kinds == set(runner._TODO_KINDS) | set(runner.GAN_KINDS)
    assert not set(runner._TODO_KINDS) & set(runner.GAN_KINDS)
    for kind in runner._TODO_KINDS:
        assert "ROADMAP.md section 1, item" in runner._TODO_KINDS[kind]


def test_cli_list_matches_jax(capsys):
    assert jmain.main(["list"]) == 0
    ref = capsys.readouterr().out
    assert tmain.main(["list"]) == 0
    assert capsys.readouterr().out == ref and len(ref.splitlines()) == len(NAMES)


@pytest.fixture
def tiny_gibbs(monkeypatch):
    cfg = dataclasses.replace(
        treg.get("gibbs12p5"), spatial=(16, 16, 8), channels=(4, 8), strides=(2,),
        num_res_units=1, data_kind="smooth", model_dtype="float32", val_interval=1,
        train_stylize=fused.StylizeConfig(disk_r=4.0, disk_prob=1.0),
        val_stylize=fused.StylizeConfig(disk_r=4.0, disk_prob=1.0))
    monkeypatch.setitem(treg.REGISTRY, "gibbs12p5", cfg)


@pytest.mark.parametrize("extra", [[], ["--chunked", "--pool", "4"]], ids=["per_step", "chunked"])
def test_cli_run_prints_one_summary_line(tiny_gibbs, capsys, tmp_path, extra):
    argv = ["run", "gibbs12p5", "--device", "cpu", "--epochs", "1", "--steps", "1",
            "--val-batches", "1", "--quiet", "--workdir", str(tmp_path / "w")] + extra
    assert tmain.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    summary = json.loads(lines[0])
    assert set(summary) == {"best_dice", "wall_time_s"}
    assert os.path.isfile(tmp_path / "w" / "gibbs12p5_result.json")
    if extra:  # and it resumes from what it saved
        assert tmain.main(argv + ["--resume", "--epochs", "2"]) == 0
        with open(tmp_path / "w" / "history.json") as f:
            assert json.load(f)["epochs"] == [1, 2]


def test_cli_unported_commands_name_their_roadmap_item(monkeypatch):
    """``domain`` is ported (tests/test_torch_domain.py): without a card it
    reaches the device check; ``--mitigated`` (ported) is refused, as by
    the JAX CLI, off a GAN config and off ``run``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmain.main(["domain", "baseline_domain"])
    for argv in (["run", "baseline", "--mitigated", "--device", "cpu"],
                 ["domain", "baseline_domain", "--mitigated", "--device", "cpu"]):
        with pytest.raises(SystemExit):
            tmain.main(argv)


def test_new_modules_import_no_jax():
    code = ("import sys, mvtb_tpu_torch.experiments, mvtb_tpu_torch.experiments.__main__, "
            "mvtb_tpu_torch.data, mvtb_tpu_torch.train.chunked, "
            "mvtb_tpu_torch.train.checkpoint\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'mvtb_tpu', 'matplotlib')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
