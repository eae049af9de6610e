"""The robustness-gain study script of the port
(mvtb_tpu_torch/examples/robustness_gain.py) against its JAX twin
(examples/robustness_gain.py): the disk low-pass with a radius handed in as
a tensor, the wrap evaluation, the pools and the Dice table of converted
weights on the same inputs; then the script end to end on the CPU at a
tiny size, every family, and through its environment knobs."""

import importlib.util
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtb_tpu.models.unet3d import UNet as JUNet
from mvtb_tpu.ops import fused as jfused
from mvtb_tpu.train import seg as jseg
from mvtb_tpu_torch.examples import _common
from mvtb_tpu_torch.examples import robustness_gain as rg
from mvtb_tpu_torch.models import UNet, unet_params_from_flax
from mvtb_tpu_torch.ops import fused

from test_torch_gan_models import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
# a volume whose k-space holds both radii's disks, every axis a multiple of 16
SPATIAL = (32, 32, 16)
TINY = dict(unet=dict(channels=(4, 8), strides=(2,), num_res_units=1), model_dtype="float32")
# the corruptions: float32 FFTs in another library, relative to the max
CORRUPT_TOL = 1e-5
# hard Dice of converted weights: moves only where a logit sits at the
# threshold (the hospital-Dice bound of the domain protocol)
DICE_TOL = 1e-3
# examples/robustness_gain.py:316-322 and :277-313
OUT_KEYS = {"spatial", "steps", "batch", "family", "disk_r", "plane_i", "wrap_alpha", "sap_p",
            "pool", "val_pool", "fast", "fft_backend", "seed", "table", "effect", "histories"}
EFFECT_KEYS = {"baseline_clean", "baseline_on_corrupted", "stylized_on_corrupted",
               "baseline_degradation", "robustness_gain", "effect_reproduced",
               "reference_shape"}


def load_jax_example(name: str):
    """The JAX script as a module of its own name (its knobs are module
    globals, read when called)."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jrg():
    mod = load_jax_example("robustness_gain")
    mod.SPATIAL, mod.BATCH, mod.SEED = SPATIAL, 2, 0
    return mod


@pytest.fixture(scope="module")
def batch():
    return np.random.RandomState(3).randn(2, 4, *SPATIAL).astype(np.float32)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("grid", [None, SPATIAL[:-1] + (SPATIAL[-1] // 2 + 1,)],
                         ids=["full", "half"])
@pytest.mark.parametrize("shift", [(0.0, 0.0, 0.0), (0.5, -0.5, 0.5)])
def test_raw_dist_sq_is_the_jax_package_s(grid, shift):
    got = fused._raw_dist_sq(SPATIAL, shift, grid, device="cpu")
    ref = np.asarray(jfused._raw_dist_sq(SPATIAL, shift, grid))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("r", [9.0, 12.5])
def test_disk_lowpass_matches_jax(jrg, batch, r):
    ref = np.asarray(jrg._corrupt_disk(jnp.asarray(batch), jnp.float32(r)))
    got = rg.corrupt_disk(torch.from_numpy(batch), torch.tensor(r))
    assert rel(got, ref) <= CORRUPT_TOL
    assert rel(ref, batch) > 1e-2  # the radius removed something


@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_wrap_eval_matches_jax(jrg, batch, alpha):
    ref = np.asarray(jrg._corrupt_wrap(jnp.asarray(batch), jnp.float32(alpha)))
    got = rg.corrupt_wrap(torch.from_numpy(batch), torch.tensor(alpha))
    assert rel(got, ref) <= CORRUPT_TOL


def test_sap_eval_from_the_same_field_matches_jax(jrg, batch):
    """The S&P eval with the JAX script's uniform field handed across."""
    key = jax.random.key(5)
    ref = np.asarray(jrg._corrupt_sap(jnp.asarray(batch), jnp.float32(0.35), key))
    u = np.array(jax.random.uniform(key, batch.shape, jnp.float32))
    got = rg.corrupt_sap(torch.from_numpy(batch), 0.35, torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_pool_is_the_jax_script_s(jrg):
    ref_i, ref_l = jrg._make_pool(4, 2)
    got_i, got_l = rg.make_pool(4, 2, SPATIAL)
    np.testing.assert_array_equal(got_i, ref_i)
    np.testing.assert_array_equal(got_l, ref_l)


@pytest.fixture(scope="module")
def converted(jrg):
    """A narrow float32 UNet's JAX state and the port's model with its
    weights, and a validation pool from the script's generator."""
    jm = JUNet(out_channels=3, channels=(4, 8), strides=(2,), num_res_units=1)
    state = jseg.create_seg_state(jax.random.key(0), jm, (1,) + SPATIAL + (4,))
    model = UNet(4, 3, (4, 8), (2,), 1, device="cpu")
    model.load_state_dict(unet_params_from_flax(jax.device_get(state.params)))
    va_i, va_l = rg.make_pool(9999, 4, SPATIAL)
    return state, model.eval(), va_i, va_l


@pytest.mark.parametrize("name,corrupt", [("clean", None), ("gibbs9.0", 9.0),
                                          ("wrap0.5", ("wrap", 0.5))])
def test_evaluate_table_matches_jax(jrg, converted, name, corrupt):
    """The Dice table's cells for the same weights and pool. The S&P sets
    draw their fields from another RNG stream and are left out (the
    corruption itself is held above with the field handed across)."""
    state, model, va_i, va_l = converted
    ref = jrg._evaluate(state, jnp.asarray(va_i), jnp.asarray(va_l), corrupt)
    got = rg.evaluate(model, *_common.on(torch.device("cpu"), va_i, va_l), corrupt, batch=2,
                      seed=0, device="cpu")
    assert abs(got["mean"] - ref["mean"]) <= DICE_TOL
    np.testing.assert_allclose(got["per_class"], ref["per_class"], rtol=0, atol=DICE_TOL)


def _finite(x) -> bool:
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_finite(v) for v in x)
    return not isinstance(x, float) or math.isfinite(x)


@pytest.mark.parametrize("family,extra", [
    ("disk", dict(fast=True, eval_radii=(6.0, 12.5))),
    ("disk", dict(fft_backend="dft_pallas", eval_radii=(12.5,))),
    ("planes", dict(plane_i=14.0, eval_intensities=(14.0,), shell=(5.0, 5.0, 3.0))),
    ("wrap", dict(eval_alphas=(0.0, 0.5))),
    ("sap", dict(eval_ps=(0.35,))),
    ("combo", dict(shell=(5.0, 5.0, 3.0))),
], ids=["disk_fast", "disk_dft_pallas", "planes", "wrap", "sap", "combo"])
def test_study_end_to_end(tmp_path, family, extra):
    out = rg.run(spatial=(16, 16, 16), steps=4, chunk=2, batch=2, pool=4, val_pool=3,
                 family=family, outdir=str(tmp_path), device="cpu", log=lambda *_: None,
                 **TINY, **extra)
    suffix = "" if family == "disk" else f"_{family}"
    with open(tmp_path / f"robustness_gain{suffix}.json") as f:
        written = json.load(f)
    assert set(written) == OUT_KEYS
    assert set(written["effect"]) == EFFECT_KEYS
    assert set(written["table"]) == set(out["models"]) and len(out["models"]) == 2
    assert _finite(written)
    assert [h["step"] for h in written["histories"]["baseline"]] == [2, 4]
    assert written["effect"]["reference_shape"] == rg.REFERENCE_SHAPE[family]
    for model in out["models"].values():
        assert all(torch.isfinite(p).all() for p in model.parameters())
    if extra.get("fast"):
        assert written["batch"] == 2 and written["fft_backend"] == "plane_fast"


def test_main_reads_the_jax_script_s_knobs(tmp_path, monkeypatch):
    """``FAST=1`` and the other variables mean what they mean to the JAX
    script: batch 16 and ``plane_fast`` unless BATCH is set; the full-width
    bf16 UNet (every axis >= 32 on the CPU)."""
    env = {"SPATIAL": "32,32,32", "STEPS": "1", "POOL": "2", "VAL_POOL": "2",
           "EVAL_RADII": "12.5", "FAST": "1", "OUTDIR": str(tmp_path)}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("BATCH", raising=False)
    out = rg.main(["--device", "cpu"])
    assert out["batch"] == 16 and out["fft_backend"] == "plane_fast" and out["fast"]
    assert out["spatial"] == (32, 32, 32) and out["steps"] == 1
    assert set(out["table"]["baseline"]) == {"clean", "gibbs12.5"}
    assert (tmp_path / "robustness_gain.json").is_file()
    assert next(out["models"]["baseline"].parameters()).dtype == torch.float32
    assert out["models"]["baseline"].dtype == torch.bfloat16


def test_default_output_is_not_under_reports():
    assert _common.outdir("robustness_gain") == "runs_torch/robustness_gain"
