"""The UNet's channels-last (NDHWC) path (``models/unet3d.py``) against its
channels-first one.

On the CPU in float64: each module on a channels-last input gives the
channels-first call's outputs and gradients (another summation order:
within 1e-12 of the largest) and a channels-last output. Conv biases that
feed an instance norm have exact gradient 0, so gradients are held to the
module's largest, not to each tensor's own. The same holds for a UNet split
2 and 4 ways over a ``model`` axis of gloo ranks (``parallel/tp.py``, whose
gathers hand the next layer an NCDHW tensor), and for the channels-last
forward exported with a symbolic batch (``serve.py``).

Marked ``cuda``: one bf16 forward and backward of the reference widths at
2x4x128x128x64 on both paths with the same weights, within 6e-2 of the
largest logit and of the largest gradient (the limit of the benchmark's
bf16 UNet forward against float32, ``logit_gap``; each path lies within it
of float32, another cuDNN summation order on each side), with cuDNN's
layout conversions on the NDHWC path under a tenth of the NCDHW path's and
no CUDA-core direct data gradient; and a bf16 UNet exported on the card
with a symbolic batch, reloaded and served against its eager forward.
This file imports no JAX, so on the card it runs as

    python -m pytest -q --noconftest -m cuda tests/test_torch_unet_ndhwc.py
"""

import types

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from mvtb_tpu_torch.models import UNet
from mvtb_tpu_torch.models.unet3d import (Conv, ConvNormAct, ConvTranspose, ResidualUnit,
                                          _engages, _ndhwc)
from mvtb_tpu_torch.serve import ServingBundle, module_fn
from mvtb_tpu_torch.utils import profiling
from torch_dist_worker import World

F64 = torch.float64
NDHWC = torch.channels_last_3d
CUDA_TOL = 6e-2
# cuDNN's layout conversions (bf16 and float32, either way) and its direct
# data gradient on CUDA cores. Some conversions stay on the NDHWC path:
# those inside the engines cuDNN picks for a few layers on either path (a
# float32 NCHW engine for the backward of the 64 -> 16 transposed
# convolution; the generic ``implicit_convolveNd_sgemm`` for the forward
# of the layers of 3 output channels, which are not padded). So the NDHWC step's
# conversions are held to a tenth of the NCDHW step's, where each
# convolution converts its operands, and the direct data gradient to none.
LAYOUT_KERNELS = ("nchwToNhwcKernel", "nhwcToNchwKernel")
DIRECT_DGRAD = "dgrad2d_grouped_direct"
LAYOUT_SHARE = 0.1

MODULES = {
    "conv_s1_k3": lambda cin, cout: Conv(cin, cout, 3, 1, "cpu", F64),
    "conv_s2_k3": lambda cin, cout: Conv(cin, cout, 3, 2, "cpu", F64),
    "conv_s1_k1": lambda cin, cout: Conv(cin, cout, 1, 1, "cpu", F64),
    "conv_transpose": lambda cin, cout: ConvTranspose(cin, cout, 3, 2, "cpu", F64),
    "conv_norm_act": lambda cin, cout: ConvNormAct(cin, cout, 2, device="cpu", dtype=F64),
    "conv_norm_act_transposed": lambda cin, cout: ConvNormAct(
        cin, cout, 2, transposed=True, device="cpu", dtype=F64),
    "conv_only": lambda cin, cout: ConvNormAct(cin, cout, 1, conv_only=True, device="cpu",
                                               dtype=F64),
    "residual_strided": lambda cin, cout: ResidualUnit(cin, cout, 2, device="cpu", dtype=F64),
    "residual_identity": lambda cin, cout: ResidualUnit(cin, cin, 1, subunits=1,
                                                        last_conv_only=True, device="cpu",
                                                        dtype=F64),
}


def perturbed(module, seed):
    """Biases and slopes off their init values, so their gradients count."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    return module


def out_and_grads(module, x, r):
    """The output and the gradients of ``sum(out * r)``."""
    y = module(x)
    grads = torch.autograd.grad((y * r).sum(), list(module.parameters()))
    return y.detach(), dict(zip([n for n, _ in module.named_parameters()], grads))


def within(got, ref, scale):
    return float((got - ref).abs().max()) <= 1e-12 * scale


@pytest.mark.parametrize("spatial", [(6, 5, 4), (5, 5, 5)], ids=["mixed_pads", "odd"])
@pytest.mark.parametrize("cin,cout", [(4, 3), (3, 16), (16, 8)])
@pytest.mark.parametrize("kind", sorted(MODULES))
def test_module_channels_last_matches_channels_first(kind, cin, cout, spatial):
    module = perturbed(MODULES[kind](cin, cout), seed=cin * 100 + cout)
    g = torch.Generator().manual_seed(7)
    x = torch.randn((2, cin) + spatial, generator=g, dtype=F64)
    with torch.no_grad():
        r = torch.randn(module(x).shape, generator=g, dtype=F64)
    ref, ref_g = out_and_grads(module, x, r)
    xl = x.contiguous(memory_format=NDHWC)
    assert _ndhwc(xl)
    got, got_g = out_and_grads(module, xl, r)
    assert _ndhwc(got) and got.shape == ref.shape
    assert within(got, ref, float(ref.abs().max()))
    gmax = max(float(v.abs().max()) for v in ref_g.values())
    for name, v in ref_g.items():
        assert got_g[name].shape == v.shape
        assert within(got_g[name], v, gmax), name


@pytest.mark.parametrize("spatial,pads", [((6, 4, 8), (0, 1)), ((5, 7, 3), (1, 1))])
def test_stride_two_pads_follow_flax_channels_last(spatial, pads):
    """SAME on a stride-2, kernel-3 conv pads an even axis (0, 1) and an odd
    one (1, 1), channels-last as channels-first; symmetric pads would shift
    the even axis's windows by one."""
    conv = perturbed(Conv(8, 8, 3, 2, "cpu", F64), seed=3)
    x = torch.randn((1, 8) + spatial, dtype=F64).contiguous(memory_format=NDHWC)
    with torch.no_grad():
        got = conv(x)
        b = conv.bias.to(F64).view(-1, 1, 1, 1)
        want = F.conv3d(F.pad(x, pads * 3), conv.weight.to(F64), stride=2) + b
        sym = F.conv3d(x, conv.weight.to(F64), stride=2, padding=1) + b
    assert _ndhwc(got) and got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    assert torch.allclose(got, sym) == (pads == (1, 1))


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32, F64])
def test_engage_rule(device, dtype):
    """Channels-last only for a CUDA input at a 16-bit compute type (the
    device as a stand-in tensor's ``is_cuda``: the rule reads nothing else)."""
    x = types.SimpleNamespace(is_cuda=device == "cuda")
    want = device == "cuda" and dtype in (torch.bfloat16, torch.float16)
    assert _engages(x, dtype) is want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_forward_stays_channels_first(dtype):
    model = UNet(4, 3, (8, 16), (2,), num_res_units=1, device="cpu", dtype=dtype)
    before = profiling.counters.copy()
    with torch.no_grad():
        y = model(torch.randn(1, 4, 8, 8, 8))
    assert y.is_contiguous() and y.shape == (1, 3, 8, 8, 8)
    diff = profiling.counters - before
    assert diff["unet.convs"] > 0
    assert diff["unet.convs_ndhwc"] == 0


def test_unet_counters_and_exit():
    """One channels-last forward of a small 4 -> 3 UNet (16, 32, 64): every
    convolution channels-last, the 3- and 4-channel ones too; NCDHW logits
    equal to the channels-first forward's, and a gradient of the same
    parameters."""
    model = perturbed(UNet(4, 3, (16, 32, 64), (2, 2), device="cpu", dtype=F64), seed=11)
    x = torch.randn(2, 4, 16, 16, 8, dtype=F64)
    ref = model._run(model._plan, x)
    before = profiling.counters.copy()
    got = model._forward_ndhwc(x)
    diff = profiling.counters - before
    assert diff["unet.convs"] == diff["unet.convs_ndhwc"] == 13
    assert got.is_contiguous() and got.shape == ref.shape == (2, 3, 16, 16, 8)
    assert float((got - ref).detach().abs().max()) <= 1e-12 * float(ref.detach().abs().max())
    r = torch.randn(ref.shape, dtype=F64)
    params = list(model.parameters())
    g_ref = torch.autograd.grad((ref * r).sum(), params)
    g_got = torch.autograd.grad((got * r).sum(), params)
    gmax = max(float(v.abs().max()) for v in g_ref)
    assert all(float((a - b).abs().max()) <= 1e-12 * gmax for a, b in zip(g_got, g_ref))


def test_unet_input_gradient_through_the_entry():
    """The entry's layout copy passes the input's gradient back (the
    learnable stylization layers train through it)."""
    model = perturbed(UNet(3, 2, (8, 16), (2,), num_res_units=1, device="cpu", dtype=F64),
                      seed=5)
    x = torch.randn(1, 3, 8, 8, 8, dtype=F64, requires_grad=True)
    (g_ref,) = torch.autograd.grad(model._run(model._plan, x).square().sum(), x)
    (g_got,) = torch.autograd.grad(model._forward_ndhwc(x).square().sum(), x)
    assert g_got.shape == x.shape
    assert float((g_got - g_ref).abs().max()) <= 1e-12 * float(g_ref.abs().max())


def test_parameters_and_state_dict_unchanged():
    """The channels-last forward leaves every parameter's name, shape,
    dtype and NCDHW layout as it was, and its gradients match them."""
    model = UNet(4, 3, device="cpu", dtype=F64)
    shapes = {k: (v.shape, v.dtype, v.stride()) for k, v in model.state_dict().items()}
    assert sum(p.numel() for p in model.parameters()) == 4_810_074
    model._forward_ndhwc(torch.randn(1, 4, 32, 32, 32, dtype=F64)).sum().backward()
    assert {k: (v.shape, v.dtype, v.stride()) for k, v in model.state_dict().items()} == shapes
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.shape == p.shape, name
        assert p.dtype == torch.float32 and p.is_contiguous(), name


TP_CHANNELS, TP_STRIDES = (16, 32, 64), (2, 2)


@pytest.fixture(scope="module")
def tp_worlds(tmp_path_factory):
    """A 4 -> 3 UNet (16, 32, 64) split 2 and 4 ways on ``model`` (8 and 4
    of the first convs' 16 output channels a rank), each rank running
    the channels-last forward and backward; and the unsplit model's
    channels-first logits and gradients."""
    tmp = tmp_path_factory.mktemp("tp_ndhwc")
    model = perturbed(UNet(4, 3, TP_CHANNELS, TP_STRIDES, device="cpu", dtype=F64), seed=17)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 4, 16, 16, 8, generator=g, dtype=F64)
    r = torch.randn(2, 3, 16, 16, 8, generator=g, dtype=F64)
    data = {"channels": TP_CHANNELS, "strides": TP_STRIDES, "state": model.state_dict(),
            "x": x, "r": r}
    started = {n: World("tp_ndhwc_world", n, data, tmp / str(n)) for n in (2, 4)}
    xg = x.clone().requires_grad_(True)
    ref = model._run(model._plan, xg)
    (ref * r).sum().backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    return {"logits": ref.detach(), "x_grad": xg.grad, "grads": grads,
            **{n: w.results() for n, w in started.items()}}


@pytest.mark.parametrize("ways,rank", [(2, 0), (2, 1), (4, 0), (4, 1), (4, 2), (4, 3)])
def test_tensor_parallel_channels_last_matches_unsplit(tp_worlds, ways, rank):
    """Each rank's logits, input gradient and gathered parameter gradients
    equal the unsplit channels-first model's, whatever count of output
    channels a rank keeps."""
    res = tp_worlds[ways][rank]
    per_rank = {shape[dim] for shape, dim in res["split"].values()}
    assert min(per_rank) == 16 // ways  # the first convs' share of 16 channels
    ref = tp_worlds["logits"]
    assert res["logits"].shape == ref.shape and res["logits"].is_contiguous()
    assert within(res["logits"], ref, float(ref.abs().max()))
    assert within(res["x_grad"], tp_worlds["x_grad"], float(tp_worlds["x_grad"].abs().max()))
    gmax = max(float(v.abs().max()) for v in tp_worlds["grads"].values())
    assert res["grads"].keys() == tp_worlds["grads"].keys()
    for name, v in tp_worlds["grads"].items():
        assert res["grads"][name].shape == v.shape, name
        assert within(res["grads"][name], v, gmax), name


class ChannelsLast(nn.Module):
    """A UNet whose forward is the channels-last one on any device."""

    def __init__(self, unet: UNet):
        super().__init__()
        self.unet = unet

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.unet._forward_ndhwc(x)


def test_channels_last_forward_exports_with_a_symbolic_batch(tmp_path):
    """``torch.export`` traces the layout checks and the entry and exit
    copies with a symbolic batch; the reloaded program serves batches it was
    not traced at as the eager forward."""
    model = ChannelsLast(perturbed(UNet(4, 3, (8, 16), (2,), num_res_units=1, device="cpu",
                                        dtype=F64), seed=9))
    params = dict(model.state_dict())
    ServingBundle.save(str(tmp_path), module_fn(model), params,
                       (torch.randn(1, 4, 8, 8, 8, dtype=F64),), batch_polymorphic=True)
    served = ServingBundle.load(str(tmp_path), device="cpu")
    for b in (1, 3):
        x = torch.randn(b, 4, 8, 8, 8, dtype=F64)
        with torch.no_grad():
            want = model.unet._run(model.unet._plan, x)
        got = served(x)
        assert got.shape == want.shape and got.is_contiguous()
        assert within(got, want, float(want.abs().max()))


@pytest.fixture
def cuda_device():
    """The card, or a skip: cuDNN's channels-last kernels run only there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: cuDNN's tensor-core path runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_bf16_channels_last_step(cuda_device):
    torch.manual_seed(0)
    model = UNet(4, 3, device=cuda_device, dtype=torch.bfloat16)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(2, 4, 128, 128, 64, generator=g, device=cuda_device)
    r = torch.randn(2, 3, 128, 128, 64, generator=g, device=cuda_device)
    params = list(model.parameters())

    def step(forward):
        y = forward(x)
        grads = torch.autograd.grad((y.float() * r).sum(), params)
        return y.float().detach(), grads

    def profiled(forward):
        """``step(forward)`` and its kernels' device time by name."""
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            out = step(forward)
            torch.cuda.synchronize()
        times = {e.key: e.device_time_total for e in prof.key_averages()
                 if e.device_type.name == "CUDA"}
        return out, times

    def layout_us(times):
        return sum(v for k, v in times.items() if any(s in k for s in LAYOUT_KERNELS))

    channels_first = lambda t: model._run(model._plan, t)  # noqa: E731
    step(channels_first)  # warm-up: cuDNN's heuristics and the allocator
    step(model)
    (ref, g_ref), ref_times = profiled(channels_first)
    before = profiling.counters.copy()
    (got, g_got), times = profiled(model)
    diff = profiling.counters - before
    assert diff["unet.convs"] == diff["unet.convs_ndhwc"] == 23
    assert any("conv" in k.lower() or "gemm" in k.lower() for k in times), times
    assert not [k for k in times if DIRECT_DGRAD in k], times
    assert layout_us(ref_times) > 0, ref_times
    assert layout_us(times) <= LAYOUT_SHARE * layout_us(ref_times), (
        layout_us(times), layout_us(ref_times))
    assert got.shape == ref.shape and got.is_contiguous()
    logit_gap = float((got - ref).abs().max()) / float(ref.abs().max())
    assert logit_gap <= CUDA_TOL, logit_gap
    gmax = max(float(v.abs().max()) for v in g_ref)
    grad_gap = max(float((a - b).abs().max()) for a, b in zip(g_got, g_ref)) / gmax
    assert grad_gap <= CUDA_TOL, grad_gap


@pytest.mark.cuda
def test_card_bf16_unet_exports_and_serves(cuda_device, tmp_path):
    """A bf16 UNet exported on the card (its forward channels-last inside)
    with a symbolic batch, reloaded and served at batches of 1 and 3 against
    its eager forward."""
    torch.manual_seed(0)
    model = UNet(4, 3, device=cuda_device, dtype=torch.bfloat16)
    example = torch.randn(2, 4, 32, 32, 16, device=cuda_device)
    ServingBundle.save(str(tmp_path), module_fn(model), dict(model.state_dict()), (example,),
                       batch_polymorphic=True)
    served = ServingBundle.load(str(tmp_path), device=cuda_device)
    for b in (1, 3):
        x = torch.randn(b, 4, 32, 32, 16, device=cuda_device)
        with torch.no_grad():
            want = model(x).float()
        got = served(x)
        assert got.dtype == torch.bfloat16 and got.shape == want.shape and got.is_contiguous()
        gap = float((got.float() - want).abs().max()) / float(want.abs().max())
        assert gap <= CUDA_TOL, gap
