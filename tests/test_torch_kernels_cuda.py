"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests import no JAX, so they run where the port runs:

    python -m pytest -q tests/test_torch_kernels_cuda.py

Without a CUDA device they skip (a CUDA kernel has no CPU mode). Inputs
are drawn through the port's own path; tolerances are relative to the
output's max: 1e-5 for ``plane`` (float32 on both sides, another summation
order) and 2e-2 for ``plane_fast`` (bf16 operands on both sides; an
intermediate may round to the neighbouring bf16 value).
"""

import pytest
import torch

from mvtb_tpu_torch.ops import dft, fused, fused_plane

CASES = [
    dict(disk_r=6.0),
    dict(disk_r=6.0, disk_inside_off=True),
    dict(gibbs_alpha=0.4),
    dict(wrap_alpha=0.25),
    dict(gibbs_alpha=0.3, disk_r=7.0, wrap_alpha=0.75),
    dict(spike=True, spike_range=(10.0, 11.0)),
    dict(spike=True, spike_range=(10.0, 11.0), spike_channel_wise=False),
    dict(plane_axes=(6.0, 5.0, 4.0), plane_intensity=9.0),
    dict(disk_r=12.5, plane_axes=(6.0, 5.0, 4.0), plane_intensity=9.0),
    dict(disk_r=6.0, wrap_alpha=0.5, spike=True, spike_range=(9.0, 10.0),
         plane_axes=(6.0, 5.0, 4.0), plane_intensity=8.0),
    dict(gibbs_alpha=(0.2, 0.5), disk_r=(5.0, 8.0), wrap_alpha=(0.3, 0.8),
         spike=True, spike_range=(9.0, 10.0)),
]
TOL = {"plane": 1e-5, "plane_fast": 2e-2}


@pytest.fixture
def cuda_device():
    """The card, or a skip: CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["plane", "plane_fast"])
@pytest.mark.parametrize("shape", [(2, 16, 70, 66), (3, 15, 13, 11), (1, 2, 130, 3)])
def test_plane_kernel_matches_plain(backend, shape, cuda_device):
    N, H, W, D = shape
    fast = backend == "plane_fast"
    for i, kw in enumerate(CASES):
        cfg = fused.StylizeConfig(**kw, fft_backend=backend)
        g = torch.Generator(device=cuda_device).manual_seed(i)
        draws = fused.sample_draws(cfg, (H, W, D), N, 1, generator=g,
                                   device=cuda_device)
        flags, *params = fused_plane.plane_params(cfg, (H, W, D), draws, N, 1,
                                                  cuda_device)
        x = torch.randn(N, H, W, D, generator=g, device=cuda_device)
        k_re, k_im = dft.half_dft_axis(x, 1)
        before = fused_plane.plane_stylize_half.launches
        got = fused_plane.plane_stylize_half(k_re, k_im, (H, W, D), flags,
                                             *params, fast=fast)
        assert fused_plane.plane_stylize_half.launches == before + 1
        ref = fused_plane.plane_stylize_half_plain(k_re, k_im, (H, W, D), flags,
                                                   *params, fast=fast)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert rel_err(a, b) <= TOL[backend], (kw, backend, shape)


@pytest.mark.cuda
def test_plane_kernel_rejects_bad_input(cuda_device):
    cfg = fused.StylizeConfig(disk_r=3.0, fft_backend="plane")
    draws = fused.sample_draws(cfg, (8, 6, 4), 2, 1, device=cuda_device)
    flags, *params = fused_plane.plane_params(cfg, (8, 6, 4), draws, 2, 1,
                                              cuda_device)
    k = torch.zeros(2, 5, 4, 6, device=cuda_device)  # W and D swapped
    with pytest.raises(ValueError):
        fused_plane.plane_stylize_half(k, k, (8, 6, 4), flags, *params)
    k = torch.zeros(2, 5, 6, 4, device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError):
        fused_plane.plane_stylize_half(k, k, (8, 6, 4), flags, *params)
