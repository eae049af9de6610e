"""The sliding window's importance map and blend normalizer, built on the
volume's device (mvtb_tpu_torch/eval/sliding_window.py:_blend_weights),
against the host build in float32 numpy that the port ran before, kept here
as ``numpy_blend_weights``: bit-equal maps and normalizers over both blend
modes, two overlaps, the eval cell's grid, a volume smaller than the ROI
and a 2-D ROI; bit-equal blended logits; and, on the card, no upload of
the volume's size.

These tests import no JAX, so the ``cuda`` cases run where the port runs:

    python -m pytest -q tests/test_torch_sw_grid.py
"""

import math

import numpy as np
import pytest
import torch

from mvtb_tpu_torch.eval import sliding_window as sw
from mvtb_tpu_torch.models import UNet
from mvtb_tpu_torch.utils import profiling

CPU = torch.device("cpu")

# (volume, roi): the eval cell's grid (27 tiles), a volume smaller than the
# roi on its middle axis (padded up to it), and a 2-D roi
GRIDS = [((240, 240, 155), (128, 128, 64)),
         ((20, 6, 10), (8, 8, 8)),
         ((40, 30), (16, 16))]


def numpy_importance(roi, sigma_scale=0.125):
    """The Gaussian map as the host build made it, factor by factor."""
    out = np.ones(tuple(roi), np.float32)
    for axis, n in enumerate(roi):
        center = (n - 1) / 2.0
        sigma = max(n * sigma_scale, 1e-3)
        g = np.exp(-0.5 * ((np.arange(n) - center) / sigma) ** 2).astype(np.float32)
        g = np.maximum(g, g.max() * 1e-3)
        shape = [1] * len(roi)
        shape[axis] = n
        out = out * g.reshape(shape)
    return out


def numpy_blend_weights(padded, roi, overlap, mode):
    """``(positions, importance, norm)`` as the host build made them: float32
    numpy, the map added into zeros at every position in grid order."""
    positions = [()]
    for d in range(len(roi)):
        positions = [p + (s,) for p in positions
                     for s in sw._grid_positions(padded[d], roi[d], overlap)]
    importance = numpy_importance(roi) if mode == "gaussian" else np.ones(roi, np.float32)
    norm = np.zeros(padded, np.float32)
    for pos in positions:
        norm[tuple(slice(s, s + r) for s, r in zip(pos, roi))] += importance
    return positions, importance, norm


def _padded(spatial, roi):
    return tuple(max(s, r) for s, r in zip(spatial, roi))


@pytest.mark.parametrize("spatial,roi", GRIDS)
@pytest.mark.parametrize("overlap", [0.25, 0.5])
@pytest.mark.parametrize("mode", ["constant", "gaussian"])
def test_blend_weights_bit_equal_to_the_numpy_build(spatial, roi, overlap, mode):
    padded = _padded(spatial, roi)
    positions, importance, norm = sw._blend_weights(padded, roi, overlap, mode, CPU)
    want_positions, want_importance, want_norm = numpy_blend_weights(padded, roi, overlap, mode)
    assert positions == want_positions
    assert importance.dtype == norm.dtype == torch.float32
    assert np.array_equal(importance.numpy(), want_importance)
    assert np.array_equal(norm.numpy(), want_norm)
    # the map the module still exports is the same numpy array
    if mode == "gaussian":
        assert np.array_equal(sw._gaussian_importance(roi), want_importance)


def test_the_eval_cells_grid_overlaps_unevenly():
    """27 tiles whose overlaps differ, so the normalizer is no constant."""
    positions, _, norm = sw._blend_weights((240, 240, 155), (128, 128, 64), 0.25,
                                           "constant", CPU)
    assert len(positions) == 27
    # per axis 1-3 tiles cover a voxel (240: starts 0, 96, 112; 155: 0, 48, 91)
    assert torch.unique(norm).tolist() == [1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 9.0, 12.0, 18.0]


def _host_built(monkeypatch):
    """Patch the module to build on the host and move the arrays over, as
    the port did before."""
    def build(padded, roi, overlap, mode, dev):
        positions, importance, norm = numpy_blend_weights(padded, roi, overlap, mode)
        return (positions, profiling.to_device(torch.from_numpy(importance), dev),
                profiling.to_device(torch.from_numpy(norm), dev))

    monkeypatch.setattr(sw, "_blend_weights", build)


@pytest.mark.parametrize("overlap", [0.25, 0.5])
@pytest.mark.parametrize("mode", ["constant", "gaussian"])
def test_logits_bit_equal_to_the_host_built_blend(monkeypatch, mode, overlap):
    torch.manual_seed(0)
    model = UNet(1, 2, (4, 8), (2,), 1, device=CPU).eval()
    x = np.random.RandomState(3).randn(2, 1, 20, 6, 10).astype(np.float32)
    kw = dict(overlap=overlap, mode=mode, tile_batch=3, device=CPU)
    got = sw.sliding_window_inference(x, (8, 8, 8), model, **kw)
    _host_built(monkeypatch)
    want = sw.sliding_window_inference(x, (8, 8, 8), model, **kw)
    assert got.shape == want.shape == (2, 2, 20, 6, 10)
    assert np.array_equal(got.numpy(), want.numpy())


@pytest.fixture
def cuda_device():
    """The card, or a skip: what crosses from the host is counted only
    between host and card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the counters count moves between host and card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["constant", "gaussian"])
def test_on_the_card_no_upload_of_the_volumes_size(cuda_device, mode):
    """A card-resident volume through the eval cell's grid: the map and the
    normalizer cross nothing in constant mode and the three 1-D factors in
    Gaussian mode, and are bit-equal to the CPU build."""
    roi, spatial = (128, 128, 64), (240, 240, 155)
    torch.manual_seed(0)
    model = UNet(1, 2, (4, 8), (2,), 1, device=cuda_device).eval()
    image = torch.randn((1, 1) + spatial, device=cuda_device)
    before = profiling.counters.copy()
    out = sw.sliding_window_inference(image, roi, model, mode=mode, device=cuda_device)
    torch.cuda.synchronize(cuda_device)
    moved = (profiling.counters - before)["copy.h2d_bytes"]
    assert out.is_cuda and out.shape == (1, 2) + spatial
    assert moved == (4 * sum(roi) if mode == "gaussian" else 0)
    assert moved <= 4 * sum(roi) < 4 * math.prod(roi)

    _, card_importance, card_norm = sw._blend_weights(spatial, roi, 0.25, mode, cuda_device)
    _, importance, norm = sw._blend_weights(spatial, roi, 0.25, mode, CPU)
    assert torch.equal(card_importance.cpu(), importance)
    assert torch.equal(card_norm.cpu(), norm)
