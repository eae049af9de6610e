"""Page-locked host copies (mvtb_tpu_torch/utils/profiling.py:to_host, as
data/pipeline.py:StylizedLoader uses it): a host tensor passes as it is and
counts nothing; on the CPU the loader yields what it always did; from the
card the copy lands in page-locked memory, bit-equal to ``t.cpu()``, is
counted as such both ways, and outlives later batches while it is kept.

The card's cases:
    python -m pytest -q tests/test_torch_pinned_copies.py -m cuda
"""

import numpy as np
import pytest
import torch

import mvtb_tpu_torch.ops.fused as fused
from mvtb_tpu_torch.data.pipeline import StylizedLoader
from mvtb_tpu_torch.eval.harness import ModelEvaluation
from mvtb_tpu_torch.models import UNet
from mvtb_tpu_torch.ops.fused import StylizeConfig, stylize_batch
from mvtb_tpu_torch.utils import profiling

C, SPATIAL, ROI = 4, (20, 14, 10), (8, 8, 8)
COPY_COUNTERS = ("copy.h2d_bytes", "copy.d2h_bytes",
                 "copy.h2d_pinned_bytes", "copy.d2h_pinned_bytes")


def _volumes(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"image": rng.randn(1, C, *SPATIAL).astype(np.float32),
             "label": (rng.rand(1, 3, *SPATIAL) < 0.4).astype(np.float32),
             "name": f"v{i}"} for i in range(n)]


@pytest.mark.parametrize("t", [torch.ones(3, 5), torch.arange(24).reshape(2, 3, 4).mT,
                               torch.zeros(2, 2, dtype=torch.bfloat16),
                               torch.ones(4, dtype=torch.bool)],
                         ids=["float32", "strided_int64", "bfloat16", "bool"])
def test_to_host_of_a_host_tensor_is_that_tensor_and_counts_nothing(t):
    before = profiling.counters.copy()
    assert profiling.to_host(t) is t
    assert not t.is_pinned()
    assert profiling.counters == before


@pytest.mark.parametrize("name", COPY_COUNTERS)
def test_copy_counters_are_in_the_docstring_list(name):
    assert f"``{name}``" in profiling.__doc__


@pytest.mark.parametrize("backend", ["plane", "plane_fast"])
def test_stylized_loader_on_the_cpu_yields_what_it_always_did(backend):
    """Channel-first numpy equal to the stylize's own output, draws taken in
    turn from one generator seeded at the pass's start, other keys kept."""
    sty = StylizeConfig(disk_r=3.0, disk_prob=1.0, fft_backend=backend)
    batches = _volumes(2)
    before = profiling.counters.copy()
    got = list(StylizedLoader(batches, sty, seed=5, device="cpu"))
    assert profiling.counters == before  # nothing crossed to a card
    gen = torch.Generator().manual_seed(5)
    for out, batch in zip(got, batches):
        want = stylize_batch(torch.from_numpy(batch["image"]), sty, generator=gen,
                             device="cpu").numpy()
        assert isinstance(out["image"], np.ndarray) and out["image"].dtype == np.float32
        assert out["image"].shape == (1, C, *SPATIAL)
        np.testing.assert_array_equal(out["image"], want)
        assert out["label"] is batch["label"] and out["name"] == batch["name"]


@pytest.fixture
def cuda_device():
    """The card, or a skip: page-locked memory and host-card copies need one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: page-locked copies are copies from the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8])
def test_to_host_from_the_card_is_page_locked_and_bit_equal(cuda_device, dtype):
    t = (torch.randn(3, 17, 5, device=cuda_device) * 50).to(dtype).transpose(0, 2)
    before = profiling.counters.copy()
    host = profiling.to_host(t)
    got = profiling.counters - before
    assert host.device.type == "cpu" and host.is_pinned()
    assert host.dtype == dtype and host.shape == t.shape
    assert torch.equal(host, t.cpu())
    assert got["copy.d2h_bytes"] == got["copy.d2h_pinned_bytes"] == t.numel() * t.element_size()


@pytest.mark.cuda
def test_stylized_loader_yields_page_locked_numpy_equal_to_the_pageable_copy(
        cuda_device, monkeypatch):
    """Each yielded image views page-locked memory and equals the ``t.cpu()``
    copy of the card tensor the stylize returned; every byte it moved back
    is counted as page-locked."""
    sty = StylizeConfig(disk_r=3.0, disk_prob=1.0, fft_backend="plane_fast")
    stylized = []

    def recording(*args, **kwargs):
        out = stylize_batch(*args, **kwargs)
        stylized.append(out)
        return out

    monkeypatch.setattr(fused, "stylize_batch", recording)
    batches = _volumes(2)
    before = profiling.counters.copy()
    got = list(StylizedLoader(batches, sty, seed=0, device=cuda_device))
    counted = profiling.counters - before
    assert len(stylized) == 2
    for out, card in zip(got, stylized):
        assert card.is_cuda
        assert torch.from_numpy(out["image"]).is_pinned()
        np.testing.assert_array_equal(out["image"], card.cpu().numpy())
    nbytes = sum(b["image"].nbytes for b in batches)
    assert counted["copy.d2h_bytes"] == counted["copy.d2h_pinned_bytes"] == nbytes


@pytest.mark.cuda
def test_harness_moves_the_stylized_image_from_page_locked_memory(cuda_device):
    """One stylized volume: the harness's move of the loader's image is the
    one page-locked HtoD; the stylize's input, the label and the sliding
    window's importance map and normalizer come from pageable numpy."""
    torch.manual_seed(0)
    model = UNet(C, 3, (4, 8), (2,), 1, device=cuda_device).eval()
    ev = ModelEvaluation(model, out_channels=3, roi_size=ROI, device=cuda_device)
    batch = _volumes(1)
    image, label = batch[0]["image"].nbytes, batch[0]["label"].nbytes
    grid = 4 * (int(np.prod(ROI)) + int(np.prod(SPATIAL)))
    sty = StylizeConfig(disk_r=3.0, disk_prob=1.0, fft_backend="plane_fast")
    before = profiling.counters.copy()
    ev.dataset_eval_multi(StylizedLoader(batch, sty, seed=0, device=cuda_device))
    got = profiling.counters - before
    assert got["copy.h2d_bytes"] == 2 * image + label + grid
    assert got["copy.h2d_pinned_bytes"] == image
    assert got["copy.d2h_bytes"] == got["copy.d2h_pinned_bytes"] == image


@pytest.mark.cuda
def test_a_kept_batch_stays_valid_after_later_batches(cuda_device):
    """The numpy array holds its page-locked tensor, so the caching host
    allocator hands later batches other blocks while it is kept."""
    sty = StylizeConfig(disk_r=3.0, disk_prob=1.0, fft_backend="plane_fast")
    it = iter(StylizedLoader(_volumes(4), sty, seed=0, device=cuda_device))
    kept = next(it)["image"]
    want = kept.copy()
    later = [b["image"] for b in it]
    del it
    for b in later:
        assert not np.shares_memory(b, kept)
    later.clear()
    for _ in range(3):  # freed blocks go back to the allocator and are handed out again
        profiling.to_host(torch.full((1, C, *SPATIAL), 7.0, device=cuda_device))
    assert torch.from_numpy(kept).is_pinned()
    np.testing.assert_array_equal(kept, want)
