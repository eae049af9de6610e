"""The port's general half-spectrum stylize path (mvtb_tpu_torch/ops/fused.py
on the ``dft``, ``dft_fast``, ``dft_pallas`` and ``xla`` backends) against
the JAX package's ``stylize_batch`` with the same backend.

The JAX side runs as its own tests run it on the CPU (``dft_pallas`` picks
Pallas interpret mode itself); the port runs on CPU tensors, so the axis
kernels take their plain versions. The JAX draws are replayed into the port
through ``jax_stage_draws``.

Tolerances, relative to the output's max: 1e-4, where float32 matmuls or
FFTs sum in another order; 5e-5 for ``dft_pallas``, which runs bf16x3
(``"high"``) on both sides with the same split, so only the order of
float32 sums differs: measured at most 1.97e-5 over these cases (a
point write on a masked spectrum amplifies the last bits), where the
port's float32 against JAX's bf16x3 needed 1e-4; 3e-2 for ``dft_fast``,
where both sides round every operand to bf16 and a spectrum value may
round to the neighbouring bf16 value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtb_tpu.ops import fused as jfused
from mvtb_tpu_torch.ops import dft as tdft
from mvtb_tpu_torch.ops import fused as tfused
from test_torch_fused_plane import FLAG_CASES, jax_stage_draws, rel_err

SHAPES = [(2, 2, 8, 6, 5), (2, 3, 7, 6, 4)]
# the shell of the plane-wave stage, scaled to the small shapes
SMALL_AXES = (3.0, 2.5, 2.0)
# bench.py's five-stage stack, scaled to the small shapes
BENCH_STACK_SMALL = dict(disk_r=(2.0, 4.0), plane_axes=SMALL_AXES,
                         plane_intensity=14.0, spike=True,
                         spike_range=(12.0, 13.0), wrap_alpha=0.5, sap_p=0.05)
CASES = ([dict(kw, plane_axes=SMALL_AXES) if "plane_axes" in kw else kw
          for kw in FLAG_CASES]
         + [dict(sap_p=(0.1, 0.4), sap_prob=0.7), BENCH_STACK_SMALL])
TOL = {"dft": 1e-4, "dft_fast": 3e-2, "dft_pallas": 5e-5, "xla": 1e-4}


def both(kw, backend, shape, seed):
    """The JAX and the port's ``stylize_batch`` on the same input and draws."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    key = jax.random.key(seed)
    jcfg = jfused.StylizeConfig(**kw, fft_backend=backend)
    tcfg = tfused.StylizeConfig(**kw, fft_backend=backend)
    ref = np.asarray(jfused.stylize_batch(jnp.asarray(x), key, jcfg))
    got = tfused.stylize_batch(torch.from_numpy(x), tcfg,
                               draws=jax_stage_draws(key, jcfg, shape),
                               device="cpu")
    return got, ref


@pytest.mark.parametrize("backend", list(TOL))
@pytest.mark.parametrize("case", range(len(CASES)))
def test_general_path_matches_jax(case, backend):
    shape = SHAPES[case % 2]
    got, ref = both(CASES[case], backend, shape, seed=case)
    assert tuple(got.shape) == shape and got.dtype == torch.float32
    assert np.isfinite(got.numpy()).all()
    assert rel_err(got.numpy(), ref) < TOL[backend], (CASES[case], backend)


def test_gated_stages_match_jax():
    kw = dict(gibbs_alpha=(0.2, 0.5), gibbs_prob=0.5, disk_r=(2.0, 4.0),
              disk_prob=0.5, wrap_alpha=0.4, wrap_prob=0.5, spike=True,
              spike_range=(9.0, 10.0), spike_prob=0.6, plane_axes=SMALL_AXES,
              plane_intensity=8.0, plane_prob=0.5, sap_p=(0.1, 0.4))
    got, ref = both(kw, "dft", (4, 2, 8, 6, 5), seed=11)
    assert rel_err(got.numpy(), ref) < 1e-4


# keys whose one shared spike location falls on the plane wave's point:
# a mirrored point (last index outside the stored half) and a point on the
# self-mirrored last-axis bin 0
COLLISIONS = [(329, (1, 2, 8, 6, 5)), (15, (1, 2, 7, 6, 4))]


@pytest.mark.parametrize("backend", ["dft", "dft_pallas"])
@pytest.mark.parametrize("seed,shape", COLLISIONS)
def test_spike_and_plane_collide_as_in_jax(seed, shape, backend):
    # the plane wave reads what the spike wrote at the same point
    kw = dict(spike=True, spike_range=(9.0, 10.0), spike_channel_wise=False,
              plane_axes=SMALL_AXES, plane_intensity=8.0)
    draws = jax_stage_draws(jax.random.key(seed), jfused.StylizeConfig(**kw), shape)
    assert torch.equal(draws.spike_shifted[0, 0].long(), draws.plane_shifted[0].long())
    got, ref = both(kw, backend, shape, seed)
    assert rel_err(got.numpy(), ref) < 1e-4


def test_dft_pallas_runs_the_axis_transforms_at_high(monkeypatch):
    """The JAX package runs ``dft_pallas`` at ``Precision.HIGH``; so does
    the port, in both directions."""
    from mvtb_tpu_torch.ops import pallas_dft as tpdft

    seen = []
    for name in ("rdft_nd_pair", "irdft_nd_real_pair"):
        fn = getattr(tpdft, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            seen.append((_name, a[-1] if isinstance(a[-1], str) else kw.get("precision")))
            return _fn(*a, **kw)

        monkeypatch.setattr(tpdft, name, spy)
    x = torch.from_numpy(np.random.RandomState(7).randn(2, 2, 8, 6, 5)
                         .astype(np.float32))
    cfg = tfused.StylizeConfig(**BENCH_STACK_SMALL, fft_backend="dft_pallas")
    draws = tfused.sample_draws(cfg, (8, 6, 5), 2, 2,
                                generator=torch.Generator().manual_seed(4),
                                device="cpu")
    tfused.stylize_batch(x, cfg, draws=draws, device="cpu")
    assert seen == [("rdft_nd_pair", "high"), ("irdft_nd_real_pair", "high")]


def test_complex_path_raises(monkeypatch):
    """The seam the JAX package patches to drive its complex path drives the
    port's too, which no longer raises: the complex path agrees with the
    half-spectrum one (the JAX tests' 2e-5 of the scale)."""
    x = torch.from_numpy(np.random.RandomState(8).randn(2, 2, 8, 6, 5)
                         .astype(np.float32))
    cfg = tfused.StylizeConfig(disk_r=3.0, wrap_alpha=0.5, fft_backend="dft")
    draws = tfused.sample_draws(cfg, (8, 6, 5), 2, 2,
                                generator=torch.Generator().manual_seed(9), device="cpu")
    half = tfused.stylize_batch(x, cfg, draws=draws, device="cpu")
    monkeypatch.setattr(tfused, "_rfft_eligible", lambda cfg, spatial: False)
    full = tfused.stylize_batch(x, cfg, draws=draws, device="cpu")
    assert float((full - half).abs().max()) < 2e-5 * float(x.abs().max())


def test_auto_resolves_as_jax(monkeypatch):
    for spatial in [(16, 12, 10), (8, 6, 5)]:
        assert jfused._resolve_backend("auto", spatial) == "xla"
        assert tfused._resolve_backend("auto", spatial, "cpu") == "xla"
        assert tfused._resolve_backend("auto", spatial, "cuda") == "dft"
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    for spatial in [(16, 12, 10), (16, 12, 4097)]:
        assert (jfused._resolve_backend("auto", spatial)
                == tfused._resolve_backend("auto", spatial, "cuda"))
    assert tfused._resolve_backend("auto", (16, 12, 4097), "cuda") == "xla"
    with pytest.raises(ValueError, match="fft_backend"):
        tfused._resolve_backend("fftw", (8, 6, 5), "cpu")


def test_auto_on_cpu_is_xla():
    kw = CASES[9]
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 2, 8, 6, 5)
                         .astype(np.float32))
    draws = tfused.sample_draws(tfused.StylizeConfig(**kw), (8, 6, 5), 2, 2,
                                generator=torch.Generator().manual_seed(0),
                                device="cpu")
    outs = [tfused.stylize_batch(x, tfused.StylizeConfig(**kw, fft_backend=b),
                                 draws=draws, device="cpu")
            for b in ("auto", "xla")]
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("plane,general", [("plane", "dft"),
                                           ("plane_fast", "dft_fast")])
def test_plane_ineligible_config_runs_the_general_path(plane, general, monkeypatch):
    kw = dict(disk_r=3.0, wrap_alpha=0.5, spike=True, spike_range=(9.0, 10.0),
              sap_p=0.1)
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 2, 16, 12, 10)
                         .astype(np.float32))
    draws = tfused.sample_draws(tfused.StylizeConfig(**kw), (16, 12, 10), 2, 2,
                                generator=torch.Generator().manual_seed(1),
                                device="cpu")
    # an axis above the matmul-DFT bound makes the config plane-ineligible
    monkeypatch.setattr(tdft, "MATMUL_DFT_MAX_N", 12)
    outs = [tfused.stylize_batch(x, tfused.StylizeConfig(**kw, fft_backend=b),
                                 draws=draws, device="cpu")
            for b in (plane, general)]
    assert torch.equal(outs[0], outs[1])
    # S&P alone has no k-space stage, so no plane work either
    sap = tfused.StylizeConfig(sap_p=0.2, fft_backend=plane)
    d = tfused.sample_draws(sap, (16, 12, 10), 2, 2,
                            generator=torch.Generator().manual_seed(2), device="cpu")
    assert torch.equal(
        tfused.stylize_batch(x, sap, draws=d, device="cpu"),
        tfused.stylize_batch(x, tfused.StylizeConfig(sap_p=0.2, fft_backend=general),
                             draws=d, device="cpu"))


def test_general_path_is_batched_over_samples():
    # one batched call equals B calls of one sample each
    kw = BENCH_STACK_SMALL
    cfg = tfused.StylizeConfig(**kw, fft_backend="dft_pallas")
    x = torch.from_numpy(np.random.RandomState(6).randn(3, 2, 8, 6, 5)
                         .astype(np.float32))
    draws = tfused.sample_draws(cfg, (8, 6, 5), 3, 2,
                                generator=torch.Generator().manual_seed(3),
                                device="cpu")
    batch = tfused.stylize_batch(x, cfg, draws=draws, device="cpu")
    for b in range(3):
        one = tfused.StageDraws(**{
            name: None if v is None else v[b:b + 1]
            for name, v in vars(draws).items()})
        single = tfused.stylize_kspace(x[b], cfg, draws=one, device="cpu")
        assert rel_err(single.numpy(), batch[b].numpy()) < 1e-6
