"""The rest of the port's fused stylization (mvtb_tpu_torch/ops/fused.py and
the hybrid transforms of mvtb_tpu_torch/ops/dft.py) against the JAX package.

Covered here: ``n_dims=2``, the zero-fill stage on the half spectrum and on
the complex path, the data-dependent spike range, the complex full-spectrum
path (both packages' ``_rfft_eligible`` seams patched to False) and the
``hybrid`` backend. The JAX draws are replayed through
``test_torch_fused_plane.jax_stage_draws``; JAX's ``dft_pallas`` runs in
Pallas interpret mode.

Tolerances (relative to the output's max): 1e-4 on ``xla``, ``dft`` and
``hybrid`` (float32 transforms summed in other orders, through a spike whose
value depends on a float32 log-mean), 5e-5 on ``dft_pallas`` (both sides
bf16x3, the products exact, their sums in other orders; the same bound the
plane kernel's tiers are held to). The realified zero-fill weight is held
bit for bit. The complex and half-spectrum paths agree within 2e-5 of the
scale, the JAX package's own bound (tests/test_fused.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtb_tpu.ops import dft as jdft
from mvtb_tpu.ops import fused as jfused
from mvtb_tpu_torch.ops import dft as tdft
from mvtb_tpu_torch.ops import fused as tfused

from test_torch_fused_plane import jax_stage_draws, rel_err

TOL = {"xla": 1e-4, "dft": 1e-4, "hybrid": 1e-4, "dft_pallas": 5e-5}

STACK_2D = dict(gibbs_alpha=(0.0, 1.0), disk_r=(3.0, 6.0), wrap_alpha=(0.3, 0.8),
                spike=True, spike_range=(9.0, 10.0), zf_p=0.2, sap_p=0.05)
CASES = [
    # (config, shape): 2D, zero-fill, the data-dependent range, their mixes
    (STACK_2D, (2, 2, 16, 12)),
    (dict(STACK_2D, spike_range=None, spike_channel_wise=False), (2, 2, 15, 11)),
    (dict(n_dims=3, zf_p=0.3, zf_prob=0.5, disk_r=5.0), (2, 2, 12, 10, 8)),
    (dict(n_dims=3, zf_p=0.2, spike=True, plane_axes=(4.0, 3.0, 3.0),
          plane_intensity=8.0, wrap_alpha=0.5), (2, 2, 12, 10, 9)),
    (dict(n_dims=3, spike=True, gibbs_alpha=0.3, wrap_alpha=0.5), (2, 2, 12, 10, 8)),
    (dict(n_dims=3, spike=True, spike_channel_wise=False, disk_r=4.0,
          plane_axes=(4.0, 3.0, 3.0), plane_intensity=9.0), (2, 2, 11, 9, 8)),
]


def _both(kw, backend):
    kw = dict(kw)
    kw.setdefault("n_dims", 2)
    return (jfused.StylizeConfig(**kw, fft_backend=backend),
            tfused.StylizeConfig(**kw, fft_backend=backend))


def _run_both(kw, shape, backend, seed):
    jcfg, tcfg = _both(kw, backend)
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    key = jax.random.key(seed)
    # stylize_batch is the vmap of stylize_kspace over split keys; run
    # eagerly, op by op, the JAX side compiles each primitive once for every
    # config and backend of this file instead of one program per config
    ref = np.stack([np.asarray(jfused.stylize_kspace(jnp.asarray(x[b]), k, jcfg))
                    for b, k in enumerate(jax.random.split(key, shape[0]))])
    got = tfused.stylize_batch(torch.from_numpy(x), tcfg,
                               draws=jax_stage_draws(key, jcfg, shape), device="cpu")
    assert got.shape == shape and got.dtype == torch.float32
    return got.numpy(), ref


def _force_complex(monkeypatch):
    """Both packages onto the complex path, through their seams."""
    monkeypatch.setattr(jfused, "_rfft_eligible", lambda cfg, spatial: False)
    monkeypatch.setattr(tfused, "_rfft_eligible", lambda cfg, spatial: False)


@pytest.fixture(params=[False, True], ids=["half", "complex"])
def path(request, monkeypatch):
    """Both packages on the half spectrum, or both on the complex path."""
    if request.param:
        _force_complex(monkeypatch)
    return request.param


# (case, backend, complex path): every case on both paths and on at least
# two backends, every backend on both paths. JAX's dft_pallas runs in
# interpret mode, seconds a call on the CPU: it is held on the 2D stack
# (both paths), the data-dependent 2D stack and the 3D zero-fill stack with
# both point writes on the complex path, where r2c and c2r run their
# full-spectrum matrices.
RUNS = ([(0, b, False) for b in ("xla", "dft", "hybrid", "dft_pallas")]
        + [(0, "hybrid", True), (0, "dft_pallas", True),
           (1, "dft", False), (1, "dft_pallas", False), (1, "xla", True),
           (2, "hybrid", False), (2, "dft", True),
           (3, "dft", False), (3, "dft_pallas", True),
           (4, "hybrid", False), (4, "xla", True),
           (5, "dft", False), (5, "hybrid", True)])


@pytest.mark.parametrize("case,backend,complex_path", RUNS)
def test_stylize_matches_jax(case, backend, complex_path, monkeypatch):
    if complex_path:
        _force_complex(monkeypatch)
    kw, shape = CASES[case]
    got, ref = _run_both(kw, shape, backend, seed=case)
    assert rel_err(got, ref) < TOL[backend], (kw, backend, complex_path)


@pytest.mark.parametrize("shape", [(2, 3, 8, 6), (2, 3, 7, 5), (2, 2, 6, 5, 4), (1, 2, 5, 6, 7)])
def test_zero_fill_weight_is_bit_equal(shape, path, monkeypatch):
    """JAX's realified zero-fill weight, read off its spectrum by standing in
    all-ones transforms, against the port's on the same fields."""
    spatial = shape[2:]
    kw = dict(n_dims=len(spatial), zf_p=0.4)
    jcfg = jfused.StylizeConfig(**kw, fft_backend="xla")
    seen = []

    def fwd(x, axes):
        grid = (spatial[:-1] + (spatial[-1] // 2 + 1,)) if not path else spatial
        return jnp.ones(x.shape[:1] + grid, jnp.complex64)

    def inv(k, *a, **kw_):
        seen.append(np.asarray(k.real))
        return jnp.zeros(k.shape[:1] + spatial, jnp.float32)

    monkeypatch.setattr(jnp.fft, "rfftn", fwd)
    monkeypatch.setattr(jnp.fft, "fftn", fwd)
    monkeypatch.setattr(jnp.fft, "irfftn", inv)
    monkeypatch.setattr(jnp.fft, "ifftn", lambda k, axes: inv(k))
    key = jax.random.key(3)
    draws = jax_stage_draws(key, jcfg, shape)
    for b, k in enumerate(jax.random.split(key, shape[0])):
        jfused.stylize_kspace(jnp.zeros(shape[1:], jnp.float32), k, jcfg)
        got = tfused.zero_fill_weight(draws.zf_u[b], draws.zf_u2[b] if not path else None,
                                      0.4, spatial)
        assert np.array_equal(got.numpy(), seen[-1])
        assert draws.zf_gate[b]


# tests/test_fused.py's configs (its empty (2.5, 2.5, 1.5) shell makes the
# JAX draw pick an arbitrary point), on its shapes and in 2D
AGREE = [dict(spike=True, spike_range=(2.0, 3.0)),
         dict(spike=True, spike_channel_wise=False),  # the data-dependent range
         dict(plane_axes=(2.0, 2.0, 1.5), plane_intensity=3.0),
         dict(disk_r=(2.0, 3.0), plane_axes=(2.5, 2.5, 1.5), plane_intensity=3.0,
              spike=True, spike_range=(2.0, 2.5), wrap_alpha=0.5, sap_p=0.05),
         dict(spike=True, spike_range=(2.0, 3.0), spike_prob=0.5,
              plane_axes=(2.0, 2.0, 1.5), plane_prob=0.5)]


# in 2D the empty shell's arbitrary point lands on spikes
@pytest.mark.parametrize("kw,shape", [(kw, shape) for shape in [(2, 4, 4, 4), (2, 6, 5, 7), (3, 6, 7)]
                                      for kw in AGREE if len(shape) == 4 or kw is not AGREE[3]])
def test_complex_path_agrees_with_half_spectrum(kw, shape, monkeypatch):
    """tests/test_fused.py's integrated check, on the port: point writes and
    weights through the half spectrum and through the complex path, on
    small grids that hit the self-mirrored bins, for 8 keys' draws. (A
    spike and a plane wave on the same point of a channel part the two paths
    in the JAX package too: the half spectrum's plane reads the spike's
    realified write.)"""
    kw = dict(kw, n_dims=len(shape) - 1)
    cfg = tfused.StylizeConfig(**kw, fft_backend="xla")
    jcfg = jfused.StylizeConfig(**kw)
    x = torch.from_numpy(np.random.RandomState(3).randn(*shape).astype(np.float32))
    for i in range(8):
        draws = jax_stage_draws(jax.random.key(i), jcfg, (1,) + shape)
        a = tfused.stylize_kspace(x, cfg, draws=draws, device="cpu")
        monkeypatch.setattr(tfused, "_rfft_eligible", lambda cfg, spatial: False)
        b = tfused.stylize_kspace(x, cfg, draws=draws, device="cpu")
        monkeypatch.undo()
        scale = max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= 2e-5 * scale, (kw, i)


def test_data_dependent_range_is_per_channel_log_mean(path):
    """With u = 0 the spike's log-magnitude is 0.95 x its channel's mean of
    log(|k| + 1e-10): the output equals a float64 numpy write of that
    magnitude, phase kept, followed by the real part of the inverse."""
    shape = (1, 2, 8, 7, 6)
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    cfg = tfused.StylizeConfig(spike=True, fft_backend="xla")
    d = tfused.sample_draws(cfg, shape[2:], 1, 2, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    d.spike_u = torch.zeros_like(d.spike_u)
    out = tfused.stylize_batch(torch.from_numpy(x), cfg, draws=d, device="cpu")
    for c in range(2):
        k = np.fft.fftn(x[0, c].astype(np.float64))
        mean = np.log(np.abs(k) + 1e-10).mean()
        raw = tuple((int(s) - n // 2) % n for s, n in zip(d.spike_shifted[0, c], shape[2:]))
        k[raw] = np.exp(0.95 * mean) * np.exp(1j * np.angle(k[raw]))
        want = np.fft.ifftn(k).real
        assert rel_err(out[0, c].numpy(), want) < 1e-5


def test_plane_wave_in_2d_uses_the_ellipse():
    """In 2D the JAX shell builder keeps the first two semi-axes (an
    ellipse), and so does the port; a shell with no grid point is refused."""
    kw = dict(n_dims=2, plane_axes=(3.0, 2.0, 9.0), plane_intensity=5.0)
    got, ref = _run_both(kw, (2, 2, 10, 9), "xla", seed=4)
    assert rel_err(got, ref) < TOL["xla"]
    cfg = tfused.StylizeConfig(**kw)
    d = tfused.sample_draws(cfg, (10, 9), 4, 1, device="cpu")
    assert d.plane_shifted.shape == (4, 2)
    with pytest.raises(ValueError, match="shell"):
        tfused.sample_draws(tfused.StylizeConfig(plane_axes=(2.5, 2.5, 1.5)), (6, 5, 7),
                            1, 1, device="cpu")


@pytest.mark.parametrize("shape,axes", [((3, 14, 13), (1, 2)), ((2, 12, 7, 10), (1, 2, 3)),
                                        ((2, 9, 14, 11), (1, 2, 3)), ((4, 8, 6), (1, 2))])
def test_hybrid_transforms_match_jax(shape, axes):
    """Each hybrid transform against the JAX package's on smooth and
    non-smooth axes (1e-5 of the max: float32 transforms, other orders)."""
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    tx = torch.from_numpy(x)
    k = np.array(jdft.hybrid_rdft_nd(jnp.asarray(x), axes))
    assert rel_err(tdft.hybrid_rdft_nd(tx, axes).numpy(), k) < 1e-5
    inv = jdft.hybrid_irdft_nd_real(jnp.asarray(k), shape[-len(axes):], axes)
    got = tdft.hybrid_irdft_nd_real(torch.from_numpy(k.copy()), shape[-len(axes):], axes)
    assert rel_err(got.numpy(), inv) < 1e-5
    kc = np.array(jdft.hybrid_dft_nd(jnp.asarray(x), axes))
    assert rel_err(tdft.hybrid_dft_nd(tx, axes).numpy(), kc) < 1e-5
    got = tdft.hybrid_idft_nd_real(torch.from_numpy(kc), axes)
    assert rel_err(got.numpy(), jdft.hybrid_idft_nd_real(jnp.asarray(kc), axes)) < 1e-5
    assert rel_err(got.numpy(), x) < 1e-5


def test_sampled_zero_fill_fields_follow_the_stored_grid(monkeypatch):
    cfg = tfused.StylizeConfig(n_dims=2, zf_p=0.2, zf_prob=0.5)
    d = tfused.sample_draws(cfg, (8, 7), 3, 2, generator=torch.Generator().manual_seed(1),
                            device="cpu")
    assert d.zf_u.shape == d.zf_u2.shape == (3, 2, 8, 4) and d.zf_gate.shape == (3,)
    monkeypatch.setattr(tfused, "_rfft_eligible", lambda cfg, spatial: False)
    d = tfused.sample_draws(cfg, (8, 7), 3, 2, generator=torch.Generator().manual_seed(1),
                            device="cpu")
    assert d.zf_u.shape == (3, 2, 8, 7) and d.zf_u2 is None
