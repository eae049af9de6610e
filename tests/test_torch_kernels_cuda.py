"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests import no JAX, so they run where the port runs:

    python -m pytest -q tests/test_torch_kernels_cuda.py

Without a CUDA device they skip (a CUDA kernel has no CPU mode). Inputs
are drawn through the port's own path; tolerances are relative to the
output's max (for the plane kernel, the max over its real and imaginary
halves): 5e-5 for ``plane`` (bf16x3 on both sides, the kernel's
products on the tensor cores: the same products summed in another float32
order, after which a split's lo may round to a neighbouring bf16 value on
some elements, a step of 2^-17 of that element; the kernel's error against
a complex128 ``torch.fft`` version is also held to at most 3x the plain
version's), 1e-5 for the axis kernels' ``highest`` tier (float32 on both
sides, another summation order), 5e-5 for their ``high`` tier (bf16x3 on
both sides, the plane bound and reason; every body on the tensor cores,
also held to 3x the plain version's error against complex128), and 2e-2 for
``plane_fast`` and ``default`` (bf16 operands on both sides; an
intermediate may round to the neighbouring bf16 value). The plane shapes
include the eval slice's (8, 240, 240, 160), the bench's (16, 240, 240,
155) and a plane wider than one kernel tile (520 x 300). The salt & pepper
kernel must be bit-equal to its plain version (the same Philox words and
the same float32 select); the polar kernel within 1e-6 elementwise
relative (``logf``/``expf`` of the CUDA math library on both sides, within
an ulp of each other). The axis kernels are also held on the complex path's
full-spectrum r2c and c2r (n = 128 and 240, two or three 80-column chunks)
and on the 2D views of the GAN family's 128x128 slices.
"""

import pytest
import torch

from mvtb_tpu_torch.ops import dft, fused, fused_plane, pallas_dft, pallas_kernels
from mvtb_tpu_torch.utils import profiling

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
TOL = {"plane": 5e-5, "plane_fast": 2e-2}
EXACT_RATIO = 3.0


def launch_counts() -> dict:
    """A snapshot of the process's kernel-launch counters."""
    return {k: v for k, v in profiling.counters.items() if k.startswith("launch.")}


def launched_since(before: dict) -> dict:
    """The ``launch.*`` counters that moved since the snapshot ``before``,
    each with the launches it counted since."""
    moved = {k: v - before.get(k, 0) for k, v in launch_counts().items()}
    return {k: n for k, n in moved.items() if n}


def axis_launches(moved: dict) -> dict:
    """Launches of each axis-kernel body in ``launched_since``'s reading."""
    return {b: moved.get(f"launch.axis_dft.{b}", 0) for b in pallas_dft.BODIES}


@pytest.fixture
def cuda_device():
    """The card, or a skip: CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max())


def complex_rel_err(got, ref):
    """Largest error of (re, im) over the largest |component| of ``ref``."""
    scale = max(float(b.abs().max()) for b in ref)
    return max(float((a - b).abs().max()) for a, b in zip(got, ref)) / scale


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["plane", "plane_fast"])
@pytest.mark.parametrize("shape", [(2, 16, 70, 66), (3, 15, 13, 11), (1, 2, 130, 3),
                                   (8, 240, 240, 160), (16, 240, 240, 155),
                                   (2, 8, 520, 300)])
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
        before = launch_counts()
        got = fused_plane.plane_stylize_half(k_re, k_im, (H, W, D), flags,
                                             *params, fast=fast)
        assert launched_since(before) == {"launch.fused_plane": 1}
        ref = fused_plane.plane_stylize_half_plain(k_re, k_im, (H, W, D), flags,
                                                   *params, fast=fast)
        torch.cuda.synchronize()
        # relative to the complex output's max: at H = 2 the imaginary half
        # is zero but for rounding, and its own max is that rounding
        assert complex_rel_err(got, ref) <= TOL[backend], (kw, backend, shape)
        exact = fused_plane.plane_stylize_half_exact(k_re, k_im, (H, W, D), flags, *params)
        kernel_err = complex_rel_err([a.double() for a in got], exact)
        plain_err = complex_rel_err([a.double() for a in ref], exact)
        assert kernel_err <= EXACT_RATIO * plain_err, (kw, backend, shape)


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
    before = launch_counts()
    k = torch.zeros(2, 5, 4, 6, device=cuda_device).transpose(2, 3)  # not contiguous
    with pytest.raises(ValueError):
        fused_plane.plane_stylize_half(k, k, (8, 6, 4), flags, *params)
    k = torch.zeros(2, 4, 6, 4, device=cuda_device)  # half axis of H = 6, not 8
    with pytest.raises(ValueError):
        fused_plane.plane_stylize_half(k, k, (8, 6, 4), flags, *params)
    k = torch.zeros(2, 5, 6, 4, device=cuda_device)
    with pytest.raises(ValueError):  # parameters on another device
        fused_plane.plane_stylize_half(k, k, (8, 6, 4), flags, *[p.cpu() for p in params])
    assert launch_counts() == before


AXIS_TOL = {"highest": 1e-5, "high": 5e-5, "default": 2e-2}
# (lane view (M, n), sublane view (A, n, B)): odd, even, and the ragged
# extents of the train and bench shapes
AXIS_VIEWS = [((7, 13), (3, 7, 11)), ((130, 64), (5, 128, 33)),
              ((75, 155), (2, 240, 78))]


def _axis_case(body, lane, view, g, dev):
    n = view[-1] if lane else view[1]
    if body == "r2c":
        mats = dft.device_mats("half" if lane else "full", n, False, dev)
    elif body == "c2r":
        n = view[-1] if lane else view[1]
        mats = (dft.device_mats("half_inv", 2 * (n - 1) + 1, True, dev) if lane
                else dft.device_mats("full", n, True, dev))
    else:
        mats = dft.device_mats("gauss", n, False, dev)
    n_in = pallas_dft.ARITY[body][0]
    ins = [torch.randn(view, generator=g, device=dev) for _ in range(n_in)]
    return ins, mats


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("lane", [True, False], ids=["lane", "sublane"])
@pytest.mark.parametrize("body", ["r2c", "c2c", "c2r"])
def test_axis_kernel_matches_plain(body, lane, precision, cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    call = pallas_dft.lane_call if lane else pallas_dft.sub_call
    route = pallas_dft.route(body, precision)
    for views in AXIS_VIEWS:
        view = views[0] if lane else views[1]
        ins, mats = _axis_case(body, lane, view, g, cuda_device)
        before = launch_counts()
        got = call(body, ins, mats, precision)
        assert launched_since(before) == {f"launch.axis_dft.{body}": 1,
                                          f"launch.axis_dft.{body}.{route}.{precision}": 1}
        ref = pallas_dft.plain(body, lane, ins, mats, precision)
        torch.cuda.synchronize()
        assert len(got) == len(ref) == pallas_dft.ARITY[body][2]
        for a, b in zip(got, ref):
            assert a.shape == b.shape
            assert rel_err(a, b) <= AXIS_TOL[precision], (body, lane, view)


def _exact(body, lane, ins, inverse, n):
    """complex128 torch.fft of an r2c (half matrix on the lane, full on the
    sublane) or c2c call, as (re, im); of a c2r call as (out,): ``irfft`` to
    n points on the lane (half matrix), the real part of ``ifft`` on the
    sublane (full matrix)."""
    dim = -1 if lane else 1
    if body == "r2c":
        x = ins[0].double()
        k = torch.fft.rfft(x, dim=dim) if lane else torch.fft.fft(x, dim=dim)
        return k.real, k.imag
    z = torch.complex(ins[0].double(), ins[1].double())
    if body == "c2r":
        return (torch.fft.irfft(z, n=n, dim=dim) if lane else torch.fft.ifft(z, dim=dim).real,)
    k = (torch.fft.ifft if inverse else torch.fft.fft)(z, dim=dim)
    return k.real, k.imag


@pytest.mark.cuda
@pytest.mark.parametrize("lane", [True, False], ids=["lane", "sublane"])
@pytest.mark.parametrize("body", ["r2c", "c2c", "c2r"])
def test_tensor_core_body_is_as_accurate_as_plain(body, lane, cuda_device):
    """At ``high`` the tensor-core kernel's error against complex128 is at
    most EXACT_RATIO times the plain version's, at the train and bench
    views' extents (c2r on the lane: the half bins of D = 64 and 155)."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    call = pallas_dft.lane_call if lane else pallas_dft.sub_call
    if body == "c2r" and lane:
        views = [((4096, 33), 64), ((2048, 78), 155)]
    elif lane:
        views = [((4096, 64), 64), ((2048, 155), 155)]
    else:
        views = [((8, 128, 4224), 128), ((64, 240, 78), 240)]
    for view, n in views:
        ins, mats = _axis_case(body, lane, view, g, cuda_device)
        if body == "c2c":
            mats = dft.device_mats("gauss", n, True, cuda_device)
        elif body == "c2r" and lane:
            mats = dft.device_mats("half_inv", n, True, cuda_device)
        got = call(body, ins, mats, "high")
        ref = pallas_dft.plain(body, lane, ins, mats, "high")
        exact = _exact(body, lane, ins, body != "r2c", n)
        torch.cuda.synchronize()
        assert complex_rel_err(got, exact) <= EXACT_RATIO * complex_rel_err(ref, exact), view


@pytest.mark.cuda
def test_axis_transforms_match_torch_fft(cuda_device):
    x = torch.randn(2, 12, 10, 9, device=cuda_device)
    k = pallas_dft.rdft_nd(x, (1, 2, 3))
    assert rel_err(k, torch.fft.rfftn(x, dim=(1, 2, 3))) < 1e-5
    back = pallas_dft.irdft_nd_real(k, x.shape[1:], (1, 2, 3))
    assert rel_err(back, x) < 1e-5
    z = torch.complex(x, x.flip(0))
    assert rel_err(pallas_dft.dft_nd(z, (0, 2)), torch.fft.fftn(z, dim=(0, 2))) < 1e-5
    assert rel_err(pallas_dft.idft_nd(z, (1, 3)), torch.fft.ifftn(z, dim=(1, 3))) < 1e-5
    assert rel_err(pallas_dft.idft_nd_real(z, (1, 2)),
                   torch.fft.ifftn(z, dim=(1, 2)).real) < 1e-5


@pytest.mark.cuda
def test_axis_kernel_rejects_bad_input(cuda_device):
    mats = dft.device_mats("gauss", 8, False, cuda_device)
    x = torch.zeros(4, 8, device=cuda_device)
    with pytest.raises(ValueError):
        pallas_dft.lane_call("c2c", [x, x.double()], mats)
    with pytest.raises(ValueError):
        pallas_dft.lane_call("c2c", [x, x[:, :4]], mats)
    with pytest.raises(ValueError):
        pallas_dft.lane_call("c2c", [x.t(), x.t()], mats)
    with pytest.raises(ValueError):
        pallas_dft.sub_call("c2c", [x, x], mats)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["dft_pallas", "dft", "xla"])
def test_general_stylize_on_the_card_matches_cpu(backend, cuda_device):
    # the same draws on both devices; on the card dft_pallas runs the axis
    # kernels (1 r2c, 4 c2c, 1 c2r per call), on the CPU their plain versions
    kw = dict(disk_r=(3.0, 6.0), plane_axes=(6.0, 5.0, 4.0), plane_intensity=12.0,
              spike=True, spike_range=(10.0, 11.0), wrap_alpha=0.5,
              gibbs_alpha=0.3, sap_p=0.05)
    cfg = fused.StylizeConfig(**kw, fft_backend=backend)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 3, 20, 18, 15, generator=g)
    draws = fused.sample_draws(cfg, (20, 18, 15), 2, 3, generator=g, device="cpu")
    before = launch_counts()
    got = fused.stylize_batch(x, cfg, draws=draws, device=cuda_device)
    torch.cuda.synchronize()
    ref = fused.stylize_batch(x, cfg, draws=draws, device="cpu")
    if backend == "dft_pallas":  # every launch at high, r2c and c2c on the tensor cores
        moved = launched_since(before)
        assert axis_launches(moved) == {"r2c": 1, "c2c": 4, "c2r": 1}
        assert {b: moved.get(f"launch.axis_dft.{b}.{pallas_dft.route(b, 'high')}.high", 0)
                for b in pallas_dft.BODIES} == {"r2c": 1, "c2c": 4, "c2r": 1}
    # dft_pallas: bf16x3 on both sides, the axis kernels' high bound
    tol = AXIS_TOL["high"] if backend == "dft_pallas" else 1e-5
    assert rel_err(got.cpu(), ref) <= tol


# the full-spectrum matrices of the complex path (r2c from a real first
# axis, c2r into the last), wider than one 80-column chunk at n = 128 and
# 240, and the 2D views of a 4x1x128x128 batch
FULL_LAYOUTS = [("r2c", False, (4, 128, 128), "full", 128),
                ("r2c", False, (8, 240, 240), "full", 240),
                ("r2c", True, (512, 128), "full", 128),
                ("c2r", True, (512, 128), "full", 128),
                ("c2r", True, (1920, 240), "full", 240),
                ("c2r", False, (4, 128, 128), "full", 128),
                ("r2c", True, (512, 128), "half", 128),
                ("c2c", False, (4, 128, 65), "gauss", 128),
                ("c2r", True, (512, 65), "half_inv", 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("body,lane,view,kind,n", FULL_LAYOUTS,
                         ids=lambda v: str(v).replace(" ", ""))
def test_full_spectrum_and_2d_layouts_match_plain(body, lane, view, kind, n, cuda_device):
    """At ``high``: against the plain version (AXIS_TOL) and against
    complex128 (at most EXACT_RATIO x the plain version's error)."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    ins = [torch.randn(view, generator=g, device=cuda_device)
           for _ in range(pallas_dft.ARITY[body][0])]
    inverse = body == "c2r"
    mats = dft.device_mats(kind, n, inverse, cuda_device)
    call = pallas_dft.lane_call if lane else pallas_dft.sub_call
    got = call(body, ins, mats, "high")
    ref = pallas_dft.plain(body, lane, ins, mats, "high")
    dim = -1 if lane else 1
    if body == "r2c":
        k = (torch.fft.rfft if kind == "half" else torch.fft.fft)(ins[0].double(), dim=dim)
        exact = (k.real, k.imag)
    else:
        z = torch.complex(ins[0].double(), ins[1].double())
        if body == "c2c":
            k = torch.fft.fft(z, dim=dim)
            exact = (k.real, k.imag)
        else:
            exact = (torch.fft.irfft(z, n=n, dim=dim) if kind == "half_inv"
                     else torch.fft.ifft(z, dim=dim).real,)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert rel_err(a, b) <= AXIS_TOL["high"], (body, view)
    assert complex_rel_err(got, exact) <= EXACT_RATIO * complex_rel_err(ref, exact)


@pytest.mark.cuda
@pytest.mark.parametrize("complex_path", [False, True], ids=["half", "complex"])
@pytest.mark.parametrize("backend", ["dft_pallas", "dft", "xla", "hybrid"])
def test_2d_and_complex_stylize_on_the_card_matches_cpu(backend, complex_path, cuda_device,
                                                        monkeypatch):
    """The GAN family's 2D stack (zero-fill, the data-dependent spike range)
    and a 3D zero-fill stack on the card against the CPU; on the complex
    path dft_pallas launches the full-spectrum r2c and c2r."""
    if complex_path:
        monkeypatch.setattr(fused, "_rfft_eligible", lambda cfg, spatial: False)
    g = torch.Generator().manual_seed(5)
    for kw, shape in ((dict(n_dims=2, gibbs_alpha=(0.0, 1.0), disk_r=(10.0, 30.0),
                            wrap_alpha=0.5, spike=True, zf_p=0.2, sap_p=0.05),
                       (4, 1, 128, 128)),
                      (dict(disk_r=(3.0, 6.0), zf_p=0.3, spike=True, plane_axes=(6.0, 5.0, 4.0),
                            plane_intensity=12.0), (2, 2, 20, 18, 15))):
        cfg = fused.StylizeConfig(**kw, fft_backend=backend)
        x = torch.randn(shape, generator=g)
        draws = fused.sample_draws(cfg, shape[2:], shape[0], shape[1], generator=g,
                                   device="cpu")
        before = launch_counts()
        got = fused.stylize_batch(x, cfg, draws=draws, device=cuda_device)
        torch.cuda.synchronize()
        ref = fused.stylize_batch(x, cfg, draws=draws, device="cpu")
        if backend == "dft_pallas":
            nd = len(shape) - 2
            assert axis_launches(launched_since(before)) == \
                {"r2c": 1, "c2c": 2 * (nd - 1), "c2r": 1}
        tol = AXIS_TOL["high"] if backend == "dft_pallas" else 1e-5
        assert rel_err(got.cpu(), ref) <= tol, (kw, backend)


# the pointwise kernels: counts that are and are not multiples of 4, and an
# offset view (not 16-byte aligned) that takes the scalar path
POINTWISE_SHAPES = [(3, 7, 13, 11), (1001,), (2, 64, 64, 31)]


def _elementwise_rel(a, b):
    d = (a - b).abs()
    return float(torch.where(d == 0, torch.zeros_like(d), d / b.abs().clamp_min(1e-38)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", POINTWISE_SHAPES)
def test_sap_kernel_bit_equal_to_plain(shape, cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda_device)
    for view in (x, x.reshape(-1)[1:]):
        for p in (0.0, 0.05, 0.4):
            before = launch_counts()
            got = pallas_kernels.salt_and_pepper_pallas(view, p, 123)
            assert launched_since(before) == {"launch.sap": 1}
            ref = pallas_kernels.salt_and_pepper_plain(view, p, 123)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (shape, p)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", POINTWISE_SHAPES)
def test_polar_kernel_matches_plain(shape, cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    re = torch.randn(shape, generator=g, device=cuda_device) * 100
    im = torch.randn(shape, generator=g, device=cuda_device) * 100
    re.view(-1)[:4] = torch.tensor([0.0, -0.0, 1e-40, 1e-30])
    im.view(-1)[:4] = torch.tensor([0.0, 0.0, 1e-40, 0.0])
    for a, b in ((re, im), (re.reshape(-1)[1:], im.reshape(-1)[1:])):
        before = launch_counts()
        got = pallas_kernels.polar_roundtrip_pallas(a, b)
        assert launched_since(before) == {"launch.polar": 1}
        ref = pallas_kernels.polar_roundtrip_plain(a, b)
        torch.cuda.synchronize()
        for o, r in zip(got, ref):
            assert _elementwise_rel(o, r) <= 1e-6, shape


@pytest.mark.cuda
def test_pointwise_kernels_reject_bad_input(cuda_device):
    x = torch.zeros(4, 8, device=cuda_device)
    with pytest.raises(NotImplementedError):
        pallas_kernels.salt_and_pepper_pallas(x.double(), 0.1, 1)
    with pytest.raises(ValueError):
        pallas_kernels.salt_and_pepper_pallas(x.t(), 0.1, 1)
    with pytest.raises(NotImplementedError):
        pallas_kernels.polar_roundtrip_pallas(x.half(), x.half())
    with pytest.raises(ValueError):
        pallas_kernels.polar_roundtrip_pallas(x, x[:, :4])
    with pytest.raises(ValueError):
        pallas_kernels.polar_roundtrip_pallas(x.t(), x.t())
    with pytest.raises(ValueError):
        pallas_kernels.polar_roundtrip_pallas(x, x.cpu())
