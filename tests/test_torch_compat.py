"""The port's reference-script shims (mvtb_tpu_torch/compat) against the JAX
package's (mvtb_tpu/compat), and its utilities (mvtb_tpu_torch/utils).

Mirrors tests/test_compat.py. The port's shims are imported by package
path: test files share worker processes, and tests/test_monai_shim.py puts
the JAX shims' directory on ``sys.path`` at import, so a bare
``filters_and_operators`` here could be the JAX one. The bare names run in
a subprocess. The port's k-space transforms take ``device="cpu"`` here:
their default is the card.
"""

import logging
import os
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtb_tpu.compat import filters_and_operators as jfo
from mvtb_tpu.compat import stylization_layers as jsl
from mvtb_tpu_torch.compat import filters_and_operators as fo
from mvtb_tpu_torch.compat import stylization_layers as sl

ROOT = Path(__file__).resolve().parent.parent


def test_reference_script_imports_and_constructors():
    """The reference scripts' bare imports and constructor calls
    (``baseline.py:65-66``), through ``install()`` in a process of its own;
    nothing of JAX loads."""
    code = """
import sys
import numpy as np
from mvtb_tpu_torch import compat
compat.install()
from filters_and_operators import (RandFourierDiskMaskd, RandGibbsNoised,
    RandKSpaceSpikeNoised, SaltAndPepper, WrapArtifactd, SelectChanneld,
    ConvertToMultiChannelBasedOnBratsClassesd, WholeTumorTCGA, RandPlaneWaves_ellipsoid)
from stylization_layers import Gibbs_UNet, Spikes_UNet, GibbsNoiseLayer
from utils import ReCompose, model_evaluation, BratsValIterDataset
import filters_and_operators, stylization_layers, utils
for m in (filters_and_operators, stylization_layers, utils):
    assert "mvtb_tpu_torch/compat" in m.__file__.replace("\\\\", "/"), m.__file__
ts = [RandFourierDiskMaskd(keys='image', r=12.5, inside_off=False, prob=1., device='cpu'),
      RandPlaneWaves_ellipsoid('image', 5, 5, 3, intensity_value=14, prob=1, device='cpu'),
      SaltAndPepper(0.15, 'image', device='cpu'),
      WrapArtifactd("image", 0.5, device='cpu'),
      RandGibbsNoised("image", 1.0, device='cpu'),
      RandKSpaceSpikeNoised("image", prob=0.5, intensity_ranges={"image": (13, 15)},
                            channel_wise=True, device='cpu')]
data = {"image": np.random.RandomState(0).randn(2, 16, 16, 8).astype(np.float32),
        "label": np.random.RandomState(1).rand(2, 16, 16, 8).astype(np.float32)}
for t in ts:
    assert tuple(t(dict(data))["image"].shape) == data["image"].shape
assert tuple(SelectChanneld(["image", "label"], (1, 0))(dict(data))["image"].shape) == (1, 16, 16, 8)
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'mvtb_tpu')]
print(bad); sys.exit(1 if bad else 0)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_reexported_transforms_match_the_jax_shim():
    """The deterministic constructor calls of the scripts, by package path,
    give the JAX shim's arrays (the random ones are held by the transform
    tests)."""
    data = {"image": np.random.RandomState(0).randn(2, 16, 16, 8).astype(np.float32),
            "label": np.random.RandomState(1).rand(2, 16, 16, 8).astype(np.float32)}
    got = fo.WrapArtifactd("image", 0.5, device="cpu")(dict(data))["image"]
    want = jfo.WrapArtifactd("image", 0.5)(dict(data))["image"]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    got = fo.SelectChanneld(["image", "label"], (1, 0))(dict(data))
    want = jfo.SelectChanneld(["image", "label"], (1, 0))(dict(data))
    for k in ("image", "label"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


def test_compat_disk_mask_and_ellipsoid_objects():
    k = torch.ones((2, 8, 8))
    m = fo.disk_mask(k, r=3, dim=2, inside_off=True)
    out = m.apply(k)
    assert out.shape == k.shape
    assert float(out[0, 4, 4]) == 0.0  # center masked off
    want = jfo.disk_mask(jnp.ones((2, 8, 8)), r=3, dim=2, inside_off=True).apply(jnp.ones((2, 8, 8)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        m.apply(torch.ones((2, 8, 6)))

    e, je = fo.ellipsoid(4, 4, 3), jfo.ellipsoid(4, 4, 3)
    k3 = np.ones((1, 12, 12, 8))
    mask = e.binary_mask_3d(k3)
    assert mask.shape == k3.shape
    np.testing.assert_array_equal(mask, je.binary_mask_3d(k3))
    e.set_random_state(3)
    je.set_random_state(3)
    coord = e.sample_ellipsoid(k3)
    assert len(coord) == 3 and tuple(coord) == tuple(je.sample_ellipsoid(k3))

    x = np.random.RandomState(2).randn(2, 8, 6).astype(np.float32)
    k2 = fo.Fourier.shift_fourier(x, 2)
    np.testing.assert_allclose(k2.numpy(), np.asarray(jfo.Fourier.shift_fourier(x, 2)),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(fo.Fourier.inv_shift_fourier(k2, 2).numpy(), x, atol=1e-5)


def test_set_determinism_and_steptimer():
    from mvtb_tpu_torch.utils import StepTimer, set_determinism

    gen = set_determinism(0, device="cpu")
    a, ta, ga = np.random.rand(3), torch.rand(3), torch.rand(3, generator=gen)
    gen = set_determinism(0, device="cpu")
    np.testing.assert_array_equal(a, np.random.rand(3))
    assert torch.equal(ta, torch.rand(3)) and torch.equal(ga, torch.rand(3, generator=gen))

    t = StepTimer(warmup=1, device="cpu")
    for _ in range(3):
        with t:
            time.sleep(0.01)
    s = t.summary(items_per_step=2)
    assert s["steps"] == 3 and s["items_per_sec"] > 0


def test_compat_show_functions_run():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from mvtb_tpu_torch.compat import utils as cu

    assert cu.WL_to_LH(10, 5) == (0, 10)
    cu.show(torch.rand(8, 8), k_space=False)
    cu.show_slice_and_fourier(np.random.rand(16, 16))
    plt.close("all")
    with pytest.raises(ValueError):
        cu.show_slice_and_fourier(np.random.rand(2, 16, 16))


def test_show_functions_skip_without_matplotlib(monkeypatch, caplog):
    from mvtb_tpu_torch.compat import utils as cu

    monkeypatch.setattr(cu._plots, "available", lambda: False)
    with caplog.at_level(logging.WARNING, logger=cu.__name__):
        cu.show(np.random.rand(8, 8))
        cu.show_slice_and_fourier(np.random.rand(16, 16))
    assert sum("display skipped" in r.message for r in caplog.records) == 2


def test_gibbs_layer_facade_matches_the_jax_shim():
    """The Gibbs facade's forward is the JAX shim's (the reference's hard
    mask over every axis past dim 0); ``alpha`` is a plain tensor that the
    scripts reassign, outside ``parameters()``."""
    x = np.random.RandomState(4).randn(2, 1, 16, 16, 8).astype(np.float32)
    layer = sl.GibbsNoiseLayer(0.7)
    assert not isinstance(layer.alpha, torch.nn.Parameter) and layer.alpha.requires_grad
    assert list(layer.parameters()) == []
    for alpha in (0.7, 0.35):
        layer.alpha = torch.tensor([alpha], requires_grad=True)
        got = layer(torch.from_numpy(x))
        want = np.asarray(jsl.GibbsNoiseLayer(alpha)(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert sl.GibbsNoiseLayer(1.7).alpha.detach().item() == 1.0
    # the module's moves carry alpha along (on the card: ``.to(device)``)
    layer.to(torch.float64)
    assert layer.alpha.dtype == torch.float64 and layer.alpha.requires_grad
    assert list(layer.parameters()) == []


def test_gibbs_unet_facade_honours_alpha_and_keeps_it_out_of_parameters():
    model = sl.Gibbs_UNet(0.6, device="cpu")
    assert model.gibbs.alpha.detach().item() == pytest.approx(0.6)
    assert all(p is not model.gibbs.alpha for p in model.parameters())
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(p.numel() for p in model.ResUnet.parameters())
    spikes = sl.Spikes_UNet(12, device="cpu")
    assert float(spikes.spike.intensity) == 12.0
    x = torch.from_numpy(np.random.RandomState(5).randn(1, 1, 16, 16, 16).astype(np.float32))
    with torch.no_grad():
        assert spikes(x).shape == x.shape and model(x).shape == x.shape
