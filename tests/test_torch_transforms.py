"""The port's MONAI-style transforms (mvtb_tpu_torch/transforms) against the
JAX package's: the cases of tests/test_transforms.py, each run on both.

A transform that draws is seeded the same on both sides: equal
``np.random.RandomState`` streams give equal draws, so the outputs agree
within 1e-5 of their max (float32 FFT round trips summed in another order)
and the draws themselves exactly. The port runs with ``device="cpu"``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtb_tpu import ops as jops
from mvtb_tpu import transforms as J
from mvtb_tpu_torch import ops as tops
from mvtb_tpu_torch import transforms as T

SHAPE = (2, 16, 14, 11)
CPU = dict(device="cpu")


def _data(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "image": rng.randn(*SHAPE).astype(np.float32),
        "label": (rng.rand(*SHAPE) > 0.7).astype(np.float32),
    }


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_rel(got, ref, tol=1e-5):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= tol * max(float(np.abs(ref).max()), 1e-30)


# ----------------------------------------------------------------- basic ----

def test_select_channeld_int_and_tuple():
    d = _data()
    out = T.SelectChanneld(["image", "label"], 1)(d)
    assert out["image"].shape == (1,) + SHAPE[1:]
    np.testing.assert_array_equal(out["image"], J.SelectChanneld(["image", "label"], 1)(d)["image"])
    out2 = T.SelectChanneld(["image", "label"], (0, 1))(_data())
    np.testing.assert_array_equal(_np(out2["label"][0]), _data()["label"][1])
    t = torch.from_numpy(_data()["image"])
    assert torch.equal(T.SelectChanneld(["image"], 1)({"image": t})["image"], t[1][None])
    with pytest.raises(AssertionError):
        T.SelectChanneld(["image", "label"], (0, 5))(_data())


def test_brats_multichannel_labels():
    lbl = np.array([[[0, 1], [2, 3]]], dtype=np.float32)[..., None]
    got = T.ConvertToMultiChannelBasedOnBratsClassesd(keys="label")({"label": lbl})["label"]
    ref = J.ConvertToMultiChannelBasedOnBratsClassesd(keys="label")({"label": lbl})["label"]
    assert got.shape == (3,) + lbl.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[1, 0, :, :, 0], [[0, 1], [1, 1]])
    from_tensor = T.ConvertToMultiChannelBasedOnBratsClassesd(keys="label")(
        {"label": torch.from_numpy(lbl)})["label"]
    np.testing.assert_array_equal(from_tensor, ref)


def test_whole_tumor_tcga():
    lbl = np.array([[0.0, 1.0], [2.0, 0.0]])
    got = T.WholeTumorTCGA(keys="label")({"label": lbl})["label"]
    assert got.shape == (1, 2, 2)
    np.testing.assert_array_equal(got, J.WholeTumorTCGA(keys="label")({"label": lbl})["label"])


# ------------------------------------------------------------ rand gates ----

def test_prob_zero_is_identity():
    d = _data()
    out = T.RandFourierDiskMaskd(keys="image", r=5.0, prob=0.0, **CPU)(d)
    np.testing.assert_array_equal(_np(out["image"]), d["image"])


def test_rand_fourier_disk_prob1_matches_jax():
    d = _data()
    got = T.RandFourierDiskMaskd(keys="image", r=5.0, inside_off=False, prob=1.0, **CPU)(d)
    ref = J.RandFourierDiskMaskd(keys="image", r=5.0, inside_off=False, prob=1.0)(d)
    assert isinstance(got["image"], torch.Tensor)
    assert_rel(got["image"], ref["image"])
    assert_rel(got["image"], tops.fourier_disk_filter(torch.from_numpy(d["image"]), 5.0, 3))


def test_rand_fourier_disk_list_radius_sampled_once():
    t = T.RandFourierDiskMaskd(keys="image", r=[5.0, 10.0], prob=1.0, **CPU)
    j = J.RandFourierDiskMaskd(keys="image", r=[5.0, 10.0], prob=1.0)
    t.set_random_state(0)
    j.set_random_state(0)
    assert_rel(t(_data())["image"], j(_data())["image"])
    r1 = t.r
    t(_data())
    assert isinstance(r1, float) and t.r == r1 == j.r  # reference quirk: fixed after 1st draw
    assert 5.0 <= r1 <= 10.0


def test_rand_gibbs_seeded_reproduction():
    t1 = T.RandGibbsNoise(prob=1.0, alpha=(0.2, 0.8), **CPU).set_random_state(42)
    t2 = T.RandGibbsNoise(prob=1.0, alpha=(0.2, 0.8), **CPU).set_random_state(42)
    j = J.RandGibbsNoise(prob=1.0, alpha=(0.2, 0.8)).set_random_state(42)
    x = _data()["image"]
    o1, o2, oj = t1(x), t2(x), j(x)
    assert t1.sampled_alpha == t2.sampled_alpha == j.sampled_alpha
    assert torch.equal(o1, o2)
    assert_rel(o1, oj)


def test_rand_gibbs_matches_np_randomstate_stream():
    # The reference draws R.rand() (gate) then R.uniform(a, b).
    t = T.RandGibbsNoise(prob=1.0, alpha=(0.0, 1.0), **CPU).set_random_state(7)
    t(_data()["image"])
    ref = np.random.RandomState(7)
    ref.rand()
    assert t.sampled_alpha == ref.uniform(0.0, 1.0)


def test_rand_gibbsd_shares_alpha_across_keys():
    d = _data()
    t = T.RandGibbsNoised(keys=["image", "label"], prob=1.0, alpha=(0.3, 0.3), **CPU)
    j = J.RandGibbsNoised(keys=["image", "label"], prob=1.0, alpha=(0.3, 0.3))
    out, ref = t(d), j(d)
    assert t.sampled_alpha == j.sampled_alpha
    for key in ("image", "label"):
        assert_rel(out[key], ref[key])
        assert_rel(out[key], tops.gibbs_noise(torch.from_numpy(d[key]), t.sampled_alpha))


def test_gibbs_as_tensor_output_false_returns_numpy():
    out = T.GibbsNoise(0.5, as_tensor_output=False, **CPU)(_data()["image"])
    assert isinstance(out, np.ndarray)
    assert_rel(out, J.GibbsNoise(0.5, as_tensor_output=False)(_data()["image"]))
    out = T.GibbsNoise(0.5, **CPU)(_data()["image"])
    assert isinstance(out, torch.Tensor) and out.device == torch.device("cpu")


# -------------------------------------------------------------- spikes ----

def test_kspace_spike_noise_signature_checks():
    with pytest.raises(AssertionError):
        T.KSpaceSpikeNoise(loc=(1, 2, 3), k_intensity=[1.0, 2.0], **CPU)
    with pytest.raises(AssertionError):
        T.KSpaceSpikeNoise(loc=[(1, 2, 3), (2, 3, 4)], k_intensity=1.0, **CPU)
    with pytest.raises(AssertionError):
        t = T.KSpaceSpikeNoise(loc=(50, 2, 3), k_intensity=1.0, **CPU)
        t(_data()["image"])
    x = _data()["image"]
    for loc, k in [((3, 4, 5), None), ((1, 3, 4, 5), None), ((3, 4, 5), 11.0)]:
        assert_rel(T.KSpaceSpikeNoise(loc, k, **CPU)(x), J.KSpaceSpikeNoise(loc, k)(x))


def test_rand_spike_randomize_stream_matches_reference_order():
    x = _data()["image"]
    t = T.RandKSpaceSpikeNoise(prob=1.0, intensity_range=(12.0, 13.0),
                               channel_wise=True, **CPU)
    j = J.RandKSpaceSpikeNoise(prob=1.0, intensity_range=(12.0, 13.0), channel_wise=True)
    t.set_random_state(3)
    j.set_random_state(3)
    out, ref = t(x), j(x)
    expected = np.random.RandomState(3)
    expected_locs, expected_ints = [], []
    for i in range(x.shape[0]):
        assert expected.rand() < 1.0
        expected_locs.append((i,) + tuple(expected.randint(0, k) for k in x.shape[1:]))
        expected_ints.append(expected.uniform(12.0, 13.0))
    assert t.sampled_locs == j.sampled_locs == expected_locs
    assert t.sampled_k_intensity == j.sampled_k_intensity == expected_ints
    assert_rel(out, ref)


def test_rand_spike_not_channel_wise_shares_loc():
    x = _data()["image"]
    t = T.RandKSpaceSpikeNoise(prob=1.0, intensity_range=(12.0, 13.0),
                               channel_wise=False, **CPU)
    j = J.RandKSpaceSpikeNoise(prob=1.0, intensity_range=(12.0, 13.0), channel_wise=False)
    t.set_random_state(1)
    j.set_random_state(1)
    assert_rel(t(x), j(x))
    spatial = {loc[1:] for loc in t.sampled_locs}
    assert len(spatial) == 1 and len(t.sampled_locs) == x.shape[0]
    assert t.sampled_locs == j.sampled_locs


def test_rand_spiked_common_sampling_same_spikes_for_image_and_label():
    d = _data()
    kw = dict(keys=["image", "label"], global_prob=1.0, prob=1.0,
              intensity_ranges={"image": (12, 13), "label": (12, 13)},
              channel_wise=True, common_sampling=True, common_seed=42)
    t, j = T.RandKSpaceSpikeNoised(**kw, **CPU), J.RandKSpaceSpikeNoised(**kw)
    out, ref = t(d), j(d)
    assert t.transforms["image"].sampled_locs == t.transforms["label"].sampled_locs
    assert t.transforms["image"].sampled_k_intensity == \
        t.transforms["label"].sampled_k_intensity
    assert t.transforms["image"].sampled_locs == j.transforms["image"].sampled_locs
    for key in ("image", "label"):
        assert_rel(out[key], ref[key])


def test_rand_spike_default_range_uses_data_stats():
    x = _data()["image"]
    t = T.RandKSpaceSpikeNoise(prob=1.0, intensity_range=None, channel_wise=True, **CPU)
    j = J.RandKSpaceSpikeNoise(prob=1.0, intensity_range=None, channel_wise=True)
    t.set_random_state(0)
    j.set_random_state(0)
    out, ref = t(x), j(x)
    stats = tops.default_spike_intensity_stats(torch.from_numpy(x)).numpy()
    for loc, val in zip(t.sampled_locs, t.sampled_k_intensity):
        c = loc[0]
        assert stats[c] * 0.95 <= val <= stats[c] * 1.1
    assert t.sampled_locs == j.sampled_locs
    # the range comes from a float32 mean of log|k|, summed in another order
    np.testing.assert_allclose(t.sampled_k_intensity, j.sampled_k_intensity, rtol=1e-5)
    assert_rel(out, ref)


# ------------------------------------------------------ plane waves etc. ----

def test_plane_waves_ellipsoid_matches_jax():
    d = _data()
    t = T.RandPlaneWaves_ellipsoid("image", a=6, b=5, c=4, intensity_value=12.0,
                                   prob=1.0, **CPU)
    j = J.RandPlaneWaves_ellipsoid("image", a=6, b=5, c=4, intensity_value=12.0, prob=1.0)
    t.set_random_state(0)
    j.set_random_state(0)
    out, ref = t(d), j(d)
    assert t.idx == j.idx
    assert_rel(out["image"], ref["image"])
    assert_rel(out["image"], jops.plane_wave(jnp.asarray(d["image"]), t.idx, 12.0, 3))
    assert tops.ellipsoid_shell_mask(SHAPE[1:], 6, 5, 4)[t.idx]


def test_salt_and_pepper_dict_fraction():
    d = _data()
    t = T.SaltAndPepper(p=0.5, keys="image", prob=1.0, **CPU)
    j = J.SaltAndPepper(p=0.5, keys="image", prob=1.0)
    t.set_random_state(0)
    j.set_random_state(0)
    out, ref = _np(t(d)["image"]), np.asarray(j(d)["image"])
    changed = np.mean(out != d["image"])
    assert 0.4 < changed < 0.6
    np.testing.assert_array_equal(out, ref)  # the same field and select


def test_wrap_artifactd_matches_op():
    d = _data()
    out = T.WrapArtifactd(keys="image", alpha=0.25, **CPU)(d)
    assert_rel(out["image"], J.WrapArtifactd(keys="image", alpha=0.25)(d)["image"])
    assert_rel(out["image"], tops.wrap_artifact(torch.from_numpy(d["image"]), 0.25, 3))


def test_segmentation_slicesd():
    rng = np.random.RandomState(0)
    img = rng.randn(1, 8, 9, 64).astype(np.float32)
    lbl = np.zeros((1, 8, 9, 64), np.float32)
    lbl[0, :, :, :] = 1.0  # label present everywhere -> any c works
    got = T.SegmentationSlicesd(keys=["image", "label"], seed=0)({"image": img, "label": lbl})
    ref = J.SegmentationSlicesd(keys=["image", "label"], seed=0)({"image": img, "label": lbl})
    assert got["image"].shape == (3, 9, 8) and got["label"].shape == (3, 9, 8)
    for key in ("image", "label"):
        np.testing.assert_array_equal(got[key], ref[key])
    m = T.MultimodalSlicesd(["image", "label"], img_chan_indices=(0, 1), seed=3)
    mj = J.MultimodalSlicesd(["image", "label"], img_chan_indices=(0, 1), seed=3)
    d = _data()
    np.testing.assert_array_equal(m(d)["image"], mj(d)["image"])


def test_recompose_append_and_add():
    base = T.ReCompose([T.SelectChanneld(["image"], 0)])
    base.append(T.WrapArtifactd(keys="image", alpha=0.5, **CPU))
    assert len(base) == 2
    extended = base + T.SaltAndPepper(p=0.1, keys="image", **CPU)
    assert len(extended) == 3 and len(base) == 2
    out = base(_data())
    assert out["image"].shape == (1,) + SHAPE[1:]
    ref = J.ReCompose([J.SelectChanneld(["image"], 0),
                       J.WrapArtifactd(keys="image", alpha=0.5)])(_data())
    assert_rel(out["image"], ref["image"])


def test_randzf_p0_identity():
    x = _data()["image"]
    out = T.RandZF(0.0, **CPU)(x)
    np.testing.assert_allclose(_np(out), x, atol=1e-5)
    t, j = T.RandZF(0.3, **CPU).set_random_state(5), J.RandZF(0.3).set_random_state(5)
    assert_rel(t(x), j(x))


def test_compose_pipeline_matches_jax():
    """The verify recipe's dict stack, seeded through Compose on both sides.
    Compose seeds its members only: the spike transform's per-key
    transforms are seeded by ``common_sampling``."""
    def stack(M, **kw):
        return M.Compose([
            M.RandFourierDiskMaskd(keys="image", r=4.5, prob=1.0, **kw),
            M.RandGibbsNoised(keys="image", prob=1.0, alpha=(0.1, 0.4), **kw),
            M.RandKSpaceSpikeNoised(keys="image", prob=1.0, common_sampling=True,
                                    common_seed=7, **kw),
            M.WrapArtifactd(keys="image", alpha=0.5, **kw),
            M.RandPlaneWaves_ellipsoid("image", 6, 5, 4, 12.0, prob=1.0, **kw),
            M.SaltAndPepper(p=0.05, keys="image", prob=1.0, **kw),
        ]).set_random_state(0)

    d = _data()
    got, ref = stack(T, **CPU)(d)["image"], stack(J)(d)["image"]
    assert isinstance(got, torch.Tensor) and bool(torch.isfinite(got).all())
    assert_rel(got, ref)
