"""The selective-scan kernel (``csrc/selective_scan.cu``) against its plain
PyTorch version on the card, forward and backward, at every SegMamba
stage's shape at batch 2 (channels 96, 192, 384, 768 over 262,144, 32,768,
4,096 and 512 positions) in bfloat16, and at ragged shapes in float32.
These tests import no JAX, so they run where the port runs:

    python -m pytest -q --noconftest tests/test_torch_selective_scan_cuda.py

Without a CUDA device they skip (a CUDA kernel has no CPU mode).

Tolerances, against the largest magnitude of each output: 1e-2 in
bfloat16 (both sides round the same float32 result to bfloat16, and the
kernel's exp2 and summation order move some elements to the neighbouring
bfloat16 value, 2^-8 of that element); 1e-4 in float32 (another
summation order and the SFU's exp2, over up to 262,144 positions). The
scan's own memory beyond its inputs and outputs, forward and backward, is
held under 1 GB at the first stage's shape.
"""

import math

import pytest
import torch

from mvtb_tpu_torch.ops import selective_scan as ss
from mvtb_tpu_torch.utils import profiling

STAGES = [(96, 262144), (192, 32768), (384, 4096), (768, 512)]
NAMES = ("du", "ddelta", "dz", "dB", "dC", "dA", "dD", "ddelta_bias")


@pytest.fixture
def cuda_device():
    """The card, or a skip: CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def inputs(b, d, L, dtype, dev, seed=0):
    """Mamba's initialisation for ``A``, ``D`` and the bias (``A = -(1..16)``,
    ``D = 1``, ``softplus(bias)`` in ``[1e-3, 0.1]``), ``z`` a channel slice
    of a ``(b, 2d, L)`` tensor as the model hands it."""
    g = torch.Generator(device=dev).manual_seed(seed)
    N = ss.KERNEL_STATES
    u = torch.randn(b, d, L, generator=g, device=dev).to(dtype)
    delta = (0.1 * torch.randn(b, d, L, generator=g, device=dev)).to(dtype)
    z = torch.randn(b, 2 * d, L, generator=g, device=dev).to(dtype)[:, d:]
    B, C = (torch.randn(b, L, N, generator=g, device=dev).to(dtype) for _ in range(2))
    A = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).repeat(d, 1)
    D = torch.ones(d, device=dev)
    dt = torch.exp(torch.rand(d, generator=g, device=dev) * (math.log(0.1) - math.log(1e-3))
                   + math.log(1e-3))
    bias = dt + torch.log(-torch.expm1(-dt))
    return u, delta, z, B, C, A, D, bias


def rel(got, want):
    return float((got.float() - want.float()).abs().amax()
                 / want.float().abs().amax().clamp_min(1e-30))


def launches():
    return {k: v for k, v in profiling.counters.items() if k.startswith("launch.selective_scan")}


def check(args, dout, tol):
    before = launches()
    out, hstart = ss.fwd_launch(*args)
    want, want_h = ss.scan_fwd_plain(*args)
    assert out.dtype == args[0].dtype and hstart.shape == want_h.shape
    assert rel(out, want) < tol, rel(out, want)
    assert rel(hstart, want_h) < tol
    got = ss.bwd_launch(*args, hstart, dout)
    ref = ss.scan_bwd_plain(*args, want_h, dout)
    for name, g, r in zip(NAMES, got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        assert rel(g, r) < tol, (name, rel(g, r))
    moved = {k: v - before.get(k, 0) for k, v in launches().items()}
    assert moved == {"launch.selective_scan.fwd": 1, "launch.selective_scan.bwd": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("d,L", STAGES, ids=[f"d{d}_L{L}" for d, L in STAGES])
def test_kernel_matches_plain_at_each_stage_bf16(cuda_device, d, L):
    args = inputs(2, d, L, torch.bfloat16, cuda_device)
    dout = torch.randn(2, d, L, device=cuda_device).to(torch.bfloat16)
    check(args, dout, 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,L", [(1, 40, 1000), (3, 33, 67), (2, 64, 31), (1, 5, 1)])
def test_kernel_matches_plain_at_ragged_shapes_f32(cuda_device, b, d, L):
    """Channels past a warp, a ragged last chunk, rows that do not start on
    16 bytes (no vector loads), a single position."""
    args = inputs(b, d, L, torch.float32, cuda_device, seed=b + d + L)
    dout = torch.randn(b, d, L, device=cuda_device)
    check(args, dout, 1e-4)


@pytest.mark.cuda
def test_autograd_function_runs_the_kernel(cuda_device):
    """``selective_scan`` on CUDA tensors: the kernel's forward and backward
    through autograd, one launch of each."""
    u, delta, z, B, C, A, D, bias = inputs(2, 96, 4096, torch.bfloat16, cuda_device)
    leaves = [t.detach().requires_grad_() for t in (u, delta, B, C, A, D, bias)]
    xz = torch.randn(2, 192, 4096, device=cuda_device).to(torch.bfloat16).requires_grad_()
    before = launches()
    u_, delta_, B_, C_, A_, D_, bias_ = leaves
    out = ss.selective_scan(u_, delta_, xz[:, 96:], B_, C_, A_, D_, bias_)
    out.float().square().sum().backward()
    moved = {k: v - before.get(k, 0) for k, v in launches().items()}
    assert moved == {"launch.selective_scan.fwd": 1, "launch.selective_scan.bwd": 1}
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in leaves)
    assert xz.grad[:, :96].abs().max() == 0 and xz.grad[:, 96:].abs().max() > 0


@pytest.mark.cuda
def test_scan_memory_beyond_inputs_and_outputs_under_1gb(cuda_device):
    """At stage 1, b2: what a scan allocates beyond what it is given and
    what it returns (the chunk start states included), forward and
    backward."""
    d, L = STAGES[0]
    args = inputs(2, d, L, torch.bfloat16, cuda_device)
    dout = torch.randn(2, d, L, device=cuda_device).to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, hstart = ss.fwd_launch(*args)
    torch.cuda.synchronize()
    returned = out.nbytes
    fwd_extra = torch.cuda.max_memory_allocated() - base - returned
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    grads = ss.bwd_launch(*args, hstart, dout)
    torch.cuda.synchronize()
    bwd_extra = torch.cuda.max_memory_allocated() - base - sum(g.nbytes for g in grads)
    print(f"scan memory at stage 1, b2: forward {fwd_extra / 1e6:.1f} MB (chunk start "
          f"states {hstart.nbytes / 1e6:.1f} MB), backward {bwd_extra / 1e6:.1f} MB")
    assert fwd_extra < 1e9 and bwd_extra < 1e9
    assert hstart.nbytes * 8 < 2 * d * L * ss.KERNEL_STATES * 4  # no B*d*L*N tensor kept
