"""Sliding-window inference of the port (mvtb_tpu_torch/eval/sliding_window.py)
against the JAX package's (mvtb_tpu/eval/sliding_window.py): the same
numpy volume and the same UNet weights (converted from the flax tree), over
the blend modes, overlaps, tile batches (divisor chunks and a padded last
chunk), batch sizes, a volume smaller than the ROI and both ``low_memory``
values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtb_tpu.eval import sliding_window as jsw
from mvtb_tpu.models import UNet as JUNet
from mvtb_tpu_torch.eval import sliding_window as tsw
from mvtb_tpu_torch.models import UNet, unet_params_from_flax

ROI = (8, 8, 8)
# float32 logits, port against JAX: the same tiles through the same weights
# and the same blend order; they differ by the convolutions' float32
# summation order (measured <= 4.3e-6 over B, mode, overlap and tile batch)
TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    jm = JUNet(out_channels=2, channels=(4, 8), strides=(2,), num_res_units=1)
    v = jm.init(jax.random.key(0), jnp.zeros((1,) + ROI + (1,)))
    tm = UNet(1, 2, (4, 8), (2,), 1, device="cpu").eval()
    tm.load_state_dict(unet_params_from_flax(jax.device_get(v["params"])))
    return jm.apply, v["params"], tm


def _volume(B, spatial, seed):
    return np.random.RandomState(seed).randn(B, 1, *spatial).astype(np.float32)


def _both(models, x, **kw):
    apply_fn, params, tm = models
    ref = np.asarray(jsw.sliding_window_inference(jnp.asarray(x), ROI, apply_fn, params, **kw))
    got = tsw.sliding_window_inference(x, ROI, tm, device="cpu", **kw)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    return got.numpy(), ref


@pytest.mark.parametrize("mode", ["constant", "gaussian"])
@pytest.mark.parametrize("overlap", [0.25, 0.5])
def test_blend_matches_jax(models, mode, overlap):
    got, ref = _both(models, _volume(2, (20, 14, 10), 1), mode=mode, overlap=overlap)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("tile_batch", [1, 3, 8, 64])
@pytest.mark.parametrize("B", [1, 2])
def test_tile_batches_match_jax(models, tile_batch, B):
    x = _volume(B, (20, 14, 10), 2)
    got, ref = _both(models, x, mode="gaussian", tile_batch=tile_batch)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    # a schedule choice only: every tile batch gives the per-tile result
    one, _ = _both(models, x, mode="gaussian", tile_batch=1)
    np.testing.assert_allclose(got, one, rtol=0, atol=TOL)


def test_chunking_rule():
    # largest divisor of T*B up to tile_batch, else a padded chunk when the
    # divisor underfills tile_batch by more than half
    assert tsw._chunking(27, 8) == (8, 4)  # divisor 3 underfills: padded
    assert tsw._chunking(27, 9) == (9, 3)
    assert tsw._chunking(54, 8) == (6, 9)
    assert tsw._chunking(13, 8) == (8, 2)
    assert tsw._chunking(12, 64) == (12, 1)
    assert tsw._chunking(7, 1) == (1, 7)


def test_volume_smaller_than_roi_on_one_axis(models):
    got, ref = _both(models, _volume(2, (20, 14, 5), 3), overlap=0.25)
    assert got.shape == (2, 2, 20, 14, 5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("low_memory", [True, False])
def test_low_memory_matches_jax(models, low_memory):
    x = _volume(2, (20, 14, 10), 4)
    got, ref = _both(models, x, mode="gaussian", tile_batch=3, low_memory=low_memory)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    other, _ = _both(models, x, mode="gaussian", tile_batch=3, low_memory=not low_memory)
    np.testing.assert_array_equal(got, other)


def test_identity_model_averages_back_to_the_input():
    """With the identity as the model, constant blending of overlapping
    tiles gives the input back (the JAX package's test_eval_extras case)."""
    x = _volume(1, (12, 12, 12), 5)
    out = tsw.sliding_window_inference(x, ROI, torch.nn.Identity(), overlap=0.5, device="cpu")
    np.testing.assert_allclose(out.numpy(), x, rtol=0, atol=1e-5)
    ref = jsw.sliding_window_inference(jnp.asarray(x), ROI, lambda v, t: t, {}, overlap=0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_grid_and_importance_are_the_jax_package_s():
    for size, roi, ov in [(240, 128, 0.25), (155, 64, 0.25), (20, 8, 0.5), (5, 8, 0.25)]:
        assert tsw._grid_positions(size, roi, ov) == jsw._grid_positions(size, roi, ov)
    assert tsw._grid_positions(240, 128, 0.25) == (0, 96, 112)
    np.testing.assert_array_equal(tsw._gaussian_importance((8, 6, 4)),
                                  jsw._gaussian_importance((8, 6, 4)))


def test_make_sliding_window_fn_binds_the_tiling(models):
    *_, tm = models
    x = _volume(1, (20, 14, 10), 6)
    fn = tsw.make_sliding_window_fn(ROI, tm, overlap=0.5, mode="gaussian", tile_batch=3,
                                    device="cpu")
    assert torch.equal(fn(x), tsw.sliding_window_inference(
        x, ROI, tm, overlap=0.5, mode="gaussian", tile_batch=3, device="cpu"))
    with pytest.raises(TypeError, match="tile_batch"):
        tsw.sliding_window_inference(x, ROI, tm, tile_batch=2.5, device="cpu")
