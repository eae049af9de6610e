"""The whole corrupted-validation slice: the JAX package's ``seg_eval_step``
against the port's (mvtb_tpu_torch/train/seg.py), on a narrow UNet with
converted weights, the plane stack and replayed draws.

Logits agree within 3e-5 of their max (float32 convolutions and DFTs in
another order; both plane paths split their dots into bf16x3 the same way;
4.3e-6 measured). Hard Dice is a step function of the logits, so it must be
equal wherever no logit lies within that bound of the threshold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtb_tpu.models.unet3d import UNet as JUNet
from mvtb_tpu.ops import fused as jfused
from mvtb_tpu.train import seg as jseg
from mvtb_tpu_torch.models import UNet, unet_params_from_flax
from mvtb_tpu_torch.ops import fused as tfused
from mvtb_tpu_torch.train import seg as tseg
from test_torch_fused_plane import jax_stage_draws

LOGIT_TOL = 3e-5
STACK = dict(disk_r=(3.0, 6.0), plane_axes=(6.0, 5.0, 3.0), plane_intensity=12.0,
             spike=True, spike_range=(10.0, 11.0), wrap_alpha=0.5, sap_p=0.05)


def _models(in_ch, shape_cl, seed=0):
    jm = JUNet(out_channels=3, channels=(4, 8, 16), strides=(2, 2))
    state = jseg.create_seg_state(jax.random.key(seed), jm, shape_cl)
    tm = UNet(in_ch, 3, (4, 8, 16), (2, 2), device="cpu")
    tm.load_state_dict(unet_params_from_flax(jax.device_get(state.params)))
    return state, tm


def test_seg_eval_step_matches_jax():
    backend = "plane"
    B, C, spatial = 2, 4, (16, 16, 8)
    rng = np.random.RandomState(0)
    image = rng.randn(B, C, *spatial).astype(np.float32)
    label = (rng.rand(B, 3, *spatial) < 0.4).astype(np.float32)
    key = jax.random.key(11)
    jcfg = jfused.StylizeConfig(**STACK, fft_backend=backend)
    tcfg = tfused.StylizeConfig(**STACK, fft_backend=backend)
    state, tm = _models(C, (B,) + spatial + (C,))

    dice_ref = np.asarray(jseg.seg_eval_step(
        state, jnp.asarray(image), jnp.asarray(label), key, jcfg))
    styled = jfused.stylize_batch(jnp.asarray(image), key, jcfg)
    logits_ref = np.moveaxis(np.asarray(state.apply_fn(
        {"params": state.params}, jnp.moveaxis(styled, 1, -1))), -1, 1)

    dice, logits = tseg.seg_eval_step(
        tm, torch.from_numpy(image), torch.from_numpy(label), tcfg,
        draws=jax_stage_draws(key, jcfg, image.shape), device="cpu",
        return_logits=True)
    logits = logits.numpy()
    assert dice.shape == (B, 3) and logits.shape == (B, 3) + spatial
    scale = float(np.abs(logits_ref).max())
    assert float(np.abs(logits - logits_ref).max()) < LOGIT_TOL * scale

    near = (np.abs(logits_ref) < LOGIT_TOL * scale).any(axis=(2, 3, 4))
    assert not near.all()
    np.testing.assert_allclose(dice.numpy()[~near], dice_ref[~near], rtol=1e-6)


def test_seg_eval_step_without_stylize_is_plain_forward():
    B, C, spatial = 1, 4, (16, 16, 8)
    rng = np.random.RandomState(1)
    image = rng.randn(B, C, *spatial).astype(np.float32)
    label = np.zeros((B, 3) + spatial, np.float32)
    label[:, 0, :8] = 1
    state, tm = _models(C, (B,) + spatial + (C,), seed=2)
    dice_ref = np.asarray(jseg.seg_eval_step(state, jnp.asarray(image),
                                             jnp.asarray(label)))
    dice = tseg.seg_eval_step(tm, torch.from_numpy(image),
                              torch.from_numpy(label), device="cpu").numpy()
    # all-empty label channels whose prediction is empty too are NaN on
    # both sides
    np.testing.assert_array_equal(np.isnan(dice), np.isnan(dice_ref))
    np.testing.assert_allclose(dice[~np.isnan(dice)], dice_ref[~np.isnan(dice_ref)],
                               rtol=1e-6)


def test_epoch_metrics_match_jax():
    rng = np.random.RandomState(3)
    batches = [rng.rand(2, 3) for _ in range(3)]
    batches[1][0, 1] = np.nan
    batches[2][1, :] = np.nan  # a sample with no defined class
    ref, got = jseg.EpochMetrics(), tseg.EpochMetrics()
    with np.errstate(invalid="ignore"):
        for b in batches:
            ref.update(b)
            got.update(torch.from_numpy(b))
    # the same float64 scores on both sides: equal results
    ref_r, got_r = ref.result(), got.result()
    assert got_r["mean"] == ref_r["mean"]
    assert got_r["per_class"] == ref_r["per_class"]
