"""The cross-corruption matrix and hold-out-hospital study scripts of the
port (mvtb_tpu_torch/examples/cross_corruption_matrix.py,
holdout_hospital.py) against their JAX twins (examples/
cross_corruption_matrix.py, holdout_hospital.py): matrix cells and
generalization gaps of converted weights on the same inputs, the hospital
pools bit for bit; then both scripts end to end on the CPU at a tiny
size."""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtb_tpu.data.tcga import generalization_gap as jgap
from mvtb_tpu.eval.dice import dice_scores, threshold_predictions
from mvtb_tpu.models import GibbsUNet as JGibbsUNet
from mvtb_tpu.models.unet3d import UNet as JUNet
from mvtb_tpu.ops import fused as jfused
from mvtb_tpu.train import learnable as jlearn
from mvtb_tpu.train import seg as jseg
from mvtb_tpu_torch.data.tcga import generalization_gap
from mvtb_tpu_torch.examples import _common
from mvtb_tpu_torch.examples import cross_corruption_matrix as cm
from mvtb_tpu_torch.examples import holdout_hospital as hh
from mvtb_tpu_torch.models import (GibbsUNet, UNet, learnable_params_from_flax,
                                   unet_params_from_flax)

from test_torch_examples_robustness import load_jax_example
from test_torch_gan_models import one_torch_thread  # noqa: F401  (autouse)

SPATIAL = (32, 32, 16)
NARROW = dict(channels=(4, 8), strides=(2,), num_res_units=1)
TINY = dict(unet=NARROW, model_dtype="float32")
CPU = torch.device("cpu")
# hard Dice of converted weights, the hospital-Dice bound of the domain
# protocol: a cell moves only where a logit sits at the threshold
DICE_TOL = 1e-3
# the matrix's eval sets whose stylize draws nothing (prob 1, fixed
# parameters); the plane-wave and S&P sets draw from another RNG stream in
# each package and are left out
DETERMINISTIC = ("clean", "gibbs12p5", "gibbs20", "wrap0p5", "wrap0")
# examples/cross_corruption_matrix.py:189-191, holdout_hospital.py:194-197
MATRIX_KEYS = {"spatial", "steps", "batch", "pool", "val_pool", "seed", "fast", "table",
               "diagonal_summary", "histories"}
HOLDOUT_KEYS = {"spatial", "steps", "batch", "n_per_hospital", "disk_r", "seed", "results",
                "effect", "histories", "wall_s"}


def _finite(x) -> bool:
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_finite(v) for v in x)
    return not isinstance(x, float) or math.isfinite(x)


def _jax_cell(score, va_i, va_l, sty, batch=2, seed=0):
    """The JAX script's cell loop: per batch a split of ``key(seed + 4242)``
    for the stylize, ``score(img, lbl)`` -> (B, C) Dice."""
    metrics, key = jseg.EpochMetrics(), jax.random.key(seed + 4242)
    for i in range(0, va_i.shape[0], batch):
        img = jnp.asarray(va_i[i:i + batch])
        if sty is not None:
            key, sub = jax.random.split(key)
            img = jfused.stylize_batch(img, sub, jfused.StylizeConfig(**dataclasses.asdict(sty)))
        metrics.update(np.asarray(score(img, jnp.asarray(va_l[i:i + batch]))))
    return metrics.result()


@pytest.fixture(scope="module")
def matrix_models():
    """The JAX scorers and the port's models with the same weights: a
    narrow UNet and a narrow GibbsUNet (alpha 0.7, 4 -> 3)."""
    jm = JUNet(out_channels=3, **NARROW)
    state = jseg.create_seg_state(jax.random.key(0), jm, (1,) + SPATIAL + (4,))
    unet = UNet(4, 3, **NARROW, device="cpu")
    unet.load_state_dict(unet_params_from_flax(jax.device_get(state.params)))

    jg = JGibbsUNet(alpha_init=0.7, out_channels=3, **NARROW)
    lstate = jlearn.create_learnable_state(jax.random.key(1), jg, (1, 4) + SPATIAL)
    gibbs = GibbsUNet(0.7, out_channels=3, in_channels=4, **NARROW, device="cpu")
    gibbs.load_state_dict(learnable_params_from_flax(jax.device_get(lstate.params)))

    def learn_score(img, lbl):
        logits = lstate.apply_fn({"params": lstate.params}, img)
        return dice_scores(threshold_predictions(jnp.moveaxis(logits, 1, -1)),
                           jnp.moveaxis(lbl, 1, -1))

    return {"seg": (lambda img, lbl: jseg.seg_eval_step(state, img, lbl), unet.eval()),
            "learnable": (learn_score, gibbs.eval())}


@pytest.fixture(scope="module")
def val_pool():
    return _common.textured_pool(9999, 4, SPATIAL)


@pytest.mark.parametrize("row", ["seg", "learnable"])
@pytest.mark.parametrize("cell", DETERMINISTIC)
def test_matrix_cell_matches_jax(matrix_models, val_pool, row, cell):
    score, model = matrix_models[row]
    sty = cm.grids()[1][cell]
    ref = _jax_cell(score, *val_pool, sty)
    got = cm.evaluate(model, *_common.on(CPU, *val_pool), sty, batch=2, seed=0, device=CPU)
    assert abs(got["mean"] - ref["mean"]) <= DICE_TOL
    np.testing.assert_allclose(got["per_class"], ref["per_class"], rtol=0, atol=DICE_TOL)


def test_matrix_study_end_to_end(tmp_path):
    out = cm.run(spatial=(16, 16, 16), steps=2, chunk=2, batch=2, pool=4, val_pool=3,
                 fast=True, outdir=str(tmp_path), device="cpu", shell=(5.0, 5.0, 3.0),
                 log=lambda *_: None, **TINY)
    with open(tmp_path / "matrix.json") as f:
        written = json.load(f)
    assert set(written) == MATRIX_KEYS
    train_grid, eval_grid = cm.grids(True)
    assert list(written["table"]) == [*train_grid, "learnable_gd"]
    assert all(list(row) == list(eval_grid) for row in written["table"].values())
    # a column is summarised where a model was trained on it
    assert set(written["diagonal_summary"]) == {"gibbs12p5", "planes14", "sap0p15", "wrap0p5"}
    assert _finite(written)
    tail = written["histories"]["learnable_gd"]
    assert len(tail["alpha_trajectory_tail"]) == 2 and tail["alpha_final"] != 0.7
    md = (tmp_path / "matrix.md").read_text().splitlines()
    assert len(md) == 4 + len(written["table"])
    assert all(c.fft_backend == "plane_fast" for c in train_grid.values() if c is not None)
    assert set(out["models"]) == set(written["table"])


@pytest.fixture(scope="module")
def jhh():
    mod = load_jax_example("holdout_hospital")
    mod.SPATIAL, mod.N_PER_HOSPITAL, mod.EVAL_BATCH, mod.SEED = SPATIAL, 4, 2, 0
    return mod


@pytest.fixture(scope="module")
def hospital_pools(jhh):
    return jhh._make_pools()


def test_hospital_pools_are_bit_equal(hospital_pools):
    (ref_i, ref_l), ref_val = hospital_pools
    (got_i, got_l), got_val = hh.make_pools(0, 4, SPATIAL, eval_batch=2)
    np.testing.assert_array_equal(got_i, ref_i)
    np.testing.assert_array_equal(got_l, ref_l)
    assert list(got_val) == list(ref_val) == hh.HOSPITALS + ["holdout"]
    for k in ref_val:
        for got, ref in zip(got_val[k], ref_val[k]):
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("arm", ["baseline", "gibbs"])
def test_generalization_gap_matches_jax(jhh, hospital_pools, arm):
    """Each hospital's Dice and the gap for converted weights, each model
    under its own val pipeline (the disk mask for the stylized arm)."""
    _, val_sets = hospital_pools
    jm = JUNet(out_channels=1, **NARROW)
    state = jseg.create_seg_state(jax.random.key(2), jm, (1,) + SPATIAL + (1,))
    model = UNet(1, 1, **NARROW, device="cpu")
    model.load_state_dict(unet_params_from_flax(jax.device_get(state.params)))
    _, train_sty, _ = hh.arms(12.5)[arm]
    jcfg = None if train_sty is None else jfused.StylizeConfig(**dataclasses.asdict(train_sty))
    ref = {h: float(jhh._evaluate(state, vi, vl, cfg=jcfg)) for h, (vi, vl) in val_sets.items()}
    got = {h: hh.evaluate(model.eval(), vi, vl, 2, train_sty, CPU)
           for h, (vi, vl) in val_sets.items()}
    for h in ref:
        assert abs(got[h] - ref[h]) <= DICE_TOL, h
    ref_gap, got_gap = jgap(ref), generalization_gap(got)
    assert got_gap.keys() == ref_gap.keys()
    for k in ref_gap:
        assert abs(got_gap[k] - ref_gap[k]) <= DICE_TOL, k


def test_holdout_study_end_to_end(tmp_path):
    families = ["baseline", "gibbs", "spikes", "sap", "gibbs_aug"]
    out = hh.run(spatial=(16, 16, 16), steps=2, chunk=2, batch=2, eval_batch=2,
                 n_per_hospital=4, families=families, outdir=str(tmp_path), device="cpu",
                 log=lambda *_: None, **TINY)
    with open(tmp_path / "holdout_hospital.json") as f:
        written = json.load(f)
    assert set(written) == HOLDOUT_KEYS
    names = [hh.arms(12.5)[f][0] for f in families]
    assert list(written["results"]) == names
    for r in written["results"].values():
        assert set(r) == {"eval_dict", "clean_eval", "gap"}
        assert list(r["eval_dict"]) == hh.HOSPITALS + ["holdout"]
    # the arms scored clean report their clean Dice as their protocol Dice
    assert written["results"]["baseline"]["eval_dict"] == written["results"]["baseline"]["clean_eval"]
    assert {"baseline_gap", "stylized_gap", "gap_shrunk"} <= set(written["effect"])
    assert _finite(written)
    assert set(out["models"]) == set(names)
