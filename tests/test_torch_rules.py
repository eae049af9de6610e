"""Rules the port keeps: it imports no JAX and nothing of the JAX package,
its entry points default to the card and raise without one, and its kernel
wrapper raises instead of falling back."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import mvtb_tpu_torch
from mvtb_tpu_torch import resolve_device
from mvtb_tpu_torch.models import UNet
from mvtb_tpu_torch.ops import _build, fused, fused_plane, pallas_dft
from mvtb_tpu_torch.train import (create_seg_state, seg_eval_step, seg_train_step,
                                  train_segmentation)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "mvtb_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax)\b"
    r"|^\s*(import|from)\s+mvtb_tpu(\.|\s|$)"
    r"|\bmvtb_tpu\.", re.M)


def test_import_leaves_jax_out():
    code = ("import sys, mvtb_tpu_torch, mvtb_tpu_torch.ops, "
            "mvtb_tpu_torch.ops.fused_plane, mvtb_tpu_torch.ops._build, "
            "mvtb_tpu_torch.ops.pallas_dft, mvtb_tpu_torch.train.losses, "
            "mvtb_tpu_torch.models, mvtb_tpu_torch.eval, mvtb_tpu_torch.train, "
            "chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'mvtb_tpu')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_source_names_no_jax(path):
    assert not FORBIDDEN.search(path.read_text()), path


def test_scan_catches_a_jax_import():
    for line in ("import jax", "from flax import linen", "import mvtb_tpu",
                 "from mvtb_tpu.ops import fused", "x = mvtb_tpu.ops"):
        assert FORBIDDEN.search(line), line
    for line in ("import mvtb_tpu_torch", "from mvtb_tpu_torch.ops import dft",
                 "# counterpart of mvtb_tpu/ops/fused.py"):
        assert not FORBIDDEN.search(line), line


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card(no_card):
    cfg = fused.StylizeConfig(disk_r=3.0, fft_backend="plane")
    x = torch.zeros(1, 1, 8, 6, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        fused.stylize_batch(x, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        fused.sample_draws(cfg, (8, 6, 4), 1, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        UNet(1, 1, (2, 4), (2,))
    model = UNet(1, 1, (2, 4), (2,), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        seg_eval_step(model, x, x)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_seg_state(model)
    state = create_seg_state(model, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        seg_train_step(state, x, x)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_segmentation(state, iter([(x, x)]), 1)
    pallas_cfg = fused.StylizeConfig(disk_r=3.0, fft_backend="dft_pallas")
    with pytest.raises(RuntimeError, match="CUDA"):
        fused.stylize_batch(x, pallas_cfg)
    assert state.step == 0
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_build_raises_without_a_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(fused_plane, "_LIB", {})
    monkeypatch.setattr(pallas_dft, "_LIB", {})
    for name in _build.SOURCES:
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.load(name)
    with pytest.raises(RuntimeError, match="nvcc"):
        fused_plane._lib()
    with pytest.raises(RuntimeError, match="nvcc"):
        pallas_dft._lib()
    assert not (tmp_path / "build").exists()


def test_build_names_the_hopper_target():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.SOURCES == {"fused_plane": "fused_plane.cu",
                              "axis_dft": "axis_dft.cu"}
    for name, src in _build.SOURCES.items():
        assert (_build.CSRC / src).is_file()
        assert _build.lib_path(name).parent == _build.BUILD_DIR


def test_wrapper_takes_plain_only_for_cpu_tensors():
    cfg = fused.StylizeConfig(disk_r=3.0, fft_backend="plane")
    cpu = torch.device("cpu")
    draws = fused.sample_draws(cfg, (8, 6, 4), 2, 1, device=cpu)
    flags, *params = fused_plane.plane_params(cfg, (8, 6, 4), draws, 2, 1, cpu)
    k = torch.randn(2, 5, 6, 4)
    before = fused_plane.plane_stylize_half.launches
    got = fused_plane.plane_stylize_half(k, k, (8, 6, 4), flags, *params)
    ref = fused_plane.plane_stylize_half_plain(k, k, (8, 6, 4), flags, *params)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert fused_plane.plane_stylize_half.launches == before  # no kernel ran
    meta = k.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_plane.plane_stylize_half(meta, meta, (8, 6, 4), flags, *params)


def test_chip_smoke_fails_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env["PYTHONPATH"] = ""
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=alone, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert mvtb_tpu_torch.__version__
