"""The port's fused plane path (mvtb_tpu_torch/ops/fused_plane.py) against
the JAX package's plane kernel.

The JAX kernel runs as the JAX tests run it on the CPU (Pallas interpret
mode); the port runs its plain PyTorch version on the CPU. Both get the
same half spectra and the same parameters; for the whole stack the port
gets the JAX draws replayed through :func:`jax_stage_draws`.

Tolerances (relative to the output's max): 2e-5 for ``plane``, where both
sides split every operand into bf16 (hi, lo) the same way and sum hi.hi +
hi.lo + lo.hi in float32, exact products summed in another order (2.9e-6
measured over these cases); 2e-2 for ``plane_fast``, where both round every
operand to bf16 but accumulate in another order, so an intermediate may
round to the next bf16 value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtb_tpu.ops import fused as jfused
from mvtb_tpu.ops import fused_plane as jplane
from mvtb_tpu.ops.masks import ellipsoid_shell_mask
from mvtb_tpu_torch.ops import fused as tfused
from mvtb_tpu_torch.ops import fused_plane as tplane

# tests/test_fused_plane.py's eligible stage combinations
FLAG_CASES = [
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
TOL = {"plane": 2e-5, "plane_fast": 2e-2}


def jax_stage_draws(key, cfg, shape) -> tfused.StageDraws:
    """Replay the JAX package's ``stylize_batch`` draws (``stage_keys`` of
    each sample's split key) into the port's draw struct, for any number of
    spatial axes: the zero-fill fields on the grid the JAX path stores
    (``jfused._rfft_eligible``, which a test may patch), the spike's
    uniform and the S&P field too."""
    B, C = shape[:2]
    spatial = tuple(shape[2:])
    nd = len(spatial)
    f32 = jnp.float32
    use_rfft = jfused._rfft_eligible(cfg, spatial)
    grid = (spatial[:-1] + (spatial[-1] // 2 + 1,)) if use_rfft else spatial
    rows = []
    for k in jax.random.split(key, B):
        ks = jfused.stage_keys(k, cfg)
        d = {}
        for name, spec, prob in (("gibbs", cfg.gibbs_alpha, cfg.gibbs_prob),
                                 ("disk", cfg.disk_r, cfg.disk_prob),
                                 ("wrap", cfg.wrap_alpha, cfg.wrap_prob)):
            if spec is not None:
                pkey = {"gibbs": "gibbs_alpha", "disk": "disk_r",
                        "wrap": "wrap_alpha"}[name]
                d[pkey] = jfused._sample(ks[pkey], spec, f32)
                d[name + "_gate"] = jfused._gate(ks[name + "_gate"], prob)
        if cfg.zf_p is not None:
            d["zf_u"] = jax.random.uniform(ks["zf_u"], (C,) + grid, f32)
            if use_rfft:
                d["zf_u2"] = jax.random.uniform(
                    jax.random.fold_in(ks["zf_u"], 1), (C,) + grid, f32)
            d["zf_gate"] = jfused._gate(ks["zf_gate"], cfg.zf_prob)
        if cfg.spike:
            loc_keys = jax.random.split(ks["spike_loc"], nd)
            if cfg.spike_channel_wise:
                sh = jnp.stack([jax.random.randint(loc_keys[a], (C,), 0, spatial[a])
                                for a in range(nd)], -1)
                u = jax.random.uniform(ks["spike_val"], (C,), f32)
                g = jax.random.bernoulli(ks["spike_gate"], cfg.spike_prob, (C,))
            else:
                sh = jnp.stack([jax.random.randint(loc_keys[a], (), 0, spatial[a])
                                for a in range(nd)])
                sh = jnp.broadcast_to(sh, (C, nd))
                u = jnp.broadcast_to(jax.random.uniform(ks["spike_val"], (), f32), (C,))
                g = jnp.full((C,), jfused._gate(ks["spike_gate"], cfg.spike_prob))
            d["spike_shifted"], d["spike_u"], d["spike_gates"] = sh, u, g
        if cfg.plane_axes is not None:
            shell = jnp.asarray(ellipsoid_shell_mask(spatial, *cfg.plane_axes).ravel())
            flat = jax.random.categorical(ks["plane_loc"],
                                          jnp.where(shell, 0.0, -jnp.inf))
            d["plane_shifted"] = jnp.stack(jnp.unravel_index(flat, spatial))
            d["plane_gate"] = jfused._gate(ks["plane_gate"], cfg.plane_prob)
        if cfg.sap_p is not None:
            d["sap_p"] = jfused._sample(ks["sap_p"], cfg.sap_p, f32)
            d["sap_gate"] = jfused._gate(ks["sap_gate"], cfg.sap_prob)
            d["sap_u"] = jax.random.uniform(ks["sap_u"], (C,) + spatial, f32)
        rows.append(d)
    return tfused.StageDraws(**{
        name: torch.from_numpy(np.stack([np.asarray(r[name]) for r in rows]))
        for name in rows[0]})


def rel_err(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max()) / (float(np.abs(ref).max()) + 1e-12)


def _cfgs(kw, backend):
    return (jfused.StylizeConfig(**kw, fft_backend=backend),
            tfused.StylizeConfig(**kw, fft_backend=backend))


def _half_case(kw, backend, shape, seed=0):
    """Identical inputs for both half-spectrum functions: random half
    spectra and the port's parameters from replayed JAX draws."""
    B, C, H, W, D = shape
    jcfg, tcfg = _cfgs(kw, backend)
    draws = jax_stage_draws(jax.random.key(seed), jcfg, shape)
    flags, *params = tplane.plane_params(tcfg, (H, W, D), draws, B, C,
                                         torch.device("cpu"))
    rng = np.random.RandomState(seed)
    k = rng.randn(2, B * C, H // 2 + 1, W, D).astype(np.float32) * 10
    return flags, params, k


@pytest.mark.parametrize("backend", ["plane", "plane_fast"])
@pytest.mark.parametrize("case", range(len(FLAG_CASES) + 1))
def test_plane_half_plain_matches_jax_kernel(case, backend):
    if case < len(FLAG_CASES):
        kw, shape = FLAG_CASES[case], (1, 2, 16, 12, 10)
    else:  # odd H (and odd W, D): no self-mirrored Nyquist bin
        kw, shape = dict(disk_r=5.0, wrap_alpha=0.5, gibbs_alpha=0.3,
                         spike=True, spike_range=(9.0, 10.0)), (1, 2, 15, 11, 9)
    spatial = shape[2:]
    flags, params, k = _half_case(kw, backend, shape, seed=case)
    precision = (jax.lax.Precision.DEFAULT if backend == "plane_fast"
                 else jax.lax.Precision.HIGH)
    jparams = [jnp.asarray(p.numpy()) for p in params]
    if params[1].shape[0] == 0:  # no point stage: the JAX kernel takes S=1 dummies
        jparams[1:] = [jnp.zeros((1,) + p.shape[1:], p.dtype) for p in jparams[1:]]
    ref = jplane.plane_stylize_half(
        jnp.asarray(k[0]), jnp.asarray(k[1]), spatial, flags, *jparams,
        precision, True)
    got = tplane.plane_stylize_half_plain(
        torch.from_numpy(k[0]), torch.from_numpy(k[1]), spatial, flags,
        *params, fast=backend == "plane_fast")
    for g, r in zip(got, ref):
        assert rel_err(g.numpy(), r) < TOL[backend], (kw, backend)


@pytest.mark.parametrize("kw", [
    FLAG_CASES[9],
    dict(gibbs_alpha=(0.2, 0.5), gibbs_prob=0.5, disk_r=(5.0, 8.0),
         disk_prob=0.5, wrap_alpha=0.4, wrap_prob=0.5, spike=True,
         spike_range=(9.0, 10.0), spike_prob=0.6, sap_p=(0.1, 0.4)),
    dict(disk_r=6.0, plane_axes=(6.0, 5.0, 4.0), plane_intensity=8.0,
         spike=True, spike_range=(9.0, 10.0), spike_channel_wise=False,
         sap_p=0.4, sap_prob=0.7),
])
def test_stylize_batch_matches_jax_with_replayed_draws(kw):
    shape = (3, 2, 16, 12, 10)
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    key = jax.random.key(7)
    jcfg, tcfg = _cfgs(kw, "plane")
    ref = jfused.stylize_batch(jnp.asarray(x), key, jcfg)
    got = tfused.stylize_batch(torch.from_numpy(x), tcfg,
                               draws=jax_stage_draws(key, jcfg, shape),
                               device="cpu")
    assert got.shape == shape and got.dtype == torch.float32
    assert rel_err(got.numpy(), ref) < 1e-4, kw


def test_stylize_kspace_is_batch_of_one():
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 16, 12, 10)
                         .astype(np.float32))
    cfg = tfused.StylizeConfig(disk_r=6.0, wrap_alpha=0.5, fft_backend="plane")
    draws = tfused.sample_draws(cfg, (16, 12, 10), 1, 2, device="cpu")
    one = tfused.stylize_kspace(x, cfg, draws=draws, device="cpu")
    batch = tfused.stylize_batch(x[None], cfg, draws=draws, device="cpu")[0]
    assert torch.equal(one, batch)


def test_sampled_draws_are_reproducible_and_in_range():
    cfg = tfused.StylizeConfig(
        gibbs_alpha=(0.2, 0.5), disk_r=(5.0, 8.0), wrap_alpha=0.5,
        spike=True, spike_range=(9.0, 10.0), plane_axes=(6.0, 5.0, 4.0),
        sap_p=0.1, fft_backend="plane")
    spatial = (16, 12, 10)
    a = tfused.sample_draws(cfg, spatial, 4, 3,
                            generator=torch.Generator().manual_seed(5), device="cpu")
    b = tfused.sample_draws(cfg, spatial, 4, 3,
                            generator=torch.Generator().manual_seed(5), device="cpu")
    assert torch.equal(a.sap_u, b.sap_u) and torch.equal(a.spike_shifted, b.spike_shifted)
    assert ((a.gibbs_alpha >= 0.2) & (a.gibbs_alpha <= 0.5)).all()
    vals = tfused.spike_log_values(cfg, a)
    assert ((a.spike_u >= 0.0) & (a.spike_u < 1.0)).all()
    assert ((vals >= 9.0) & (vals <= 10.0)).all()
    assert a.spike_shifted.shape == (4, 3, 3)
    for axis, n in enumerate(spatial):
        assert ((a.spike_shifted[..., axis] >= 0) & (a.spike_shifted[..., axis] < n)).all()
    shell = ellipsoid_shell_mask(spatial, 6.0, 5.0, 4.0)
    for loc in a.plane_shifted.numpy():
        assert shell[tuple(loc)]


@pytest.mark.parametrize("kw,spatial,expect", [
    (dict(disk_r=6.0), (16, 12, 10), True),
    (dict(disk_r=6.0), (240, 240, 155), True),
    (dict(disk_r=6.0, zf_p=0.3), (16, 12, 10), False),
    (dict(spike=True), (16, 12, 10), False),
    (dict(spike=True, spike_range=(1.0, 2.0)), (16, 12, 10), True),
    (dict(sap_p=0.1), (16, 12, 10), False),
    (dict(n_dims=2, disk_r=4.0), (16, 12), False),
    (dict(disk_r=6.0), (64, 8192, 8), False),
])
def test_eligibility_matches_jax(kw, spatial, expect):
    jcfg, tcfg = _cfgs(kw, "plane")
    assert jplane.plane_kernel_eligible(jcfg, spatial) == expect
    assert tplane.plane_kernel_eligible(tcfg, spatial) == expect


def test_eligibility_has_no_vmem_bound():
    # 512x512 planes overflow the TPU kernel's VMEM budget; the Hopper
    # kernel streams its plane through device memory and takes them
    cfg = dict(disk_r=6.0)
    assert not jplane.plane_kernel_eligible(jfused.StylizeConfig(**cfg), (64, 512, 512))
    assert tplane.plane_kernel_eligible(tfused.StylizeConfig(**cfg), (64, 512, 512))


@pytest.mark.parametrize("kw", [
    dict(disk_r=6.0, fft_backend="hybrid"),
    dict(disk_r=6.0, zf_p=0.3, fft_backend="dft"),
    dict(disk_r=6.0, zf_p=0.3, fft_backend="plane"),
    dict(spike=True, fft_backend="plane_fast"),
    dict(spike=True, fft_backend="dft_pallas"),
    dict(n_dims=2, disk_r=4.0, fft_backend="dft"),
])
def test_unported_paths_raise(kw):
    """The configs the port once rejected (hybrid, zero-fill, the
    data-dependent spike range, 2D) raise no more: each matches the JAX
    package on replayed draws (plane-ineligible ones take the general path,
    as in the JAX package)."""
    cfg = tfused.StylizeConfig(**kw)
    jcfg = jfused.StylizeConfig(**kw)
    shape = (2, 2) + (16, 12, 10)[:cfg.n_dims]
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    key = jax.random.key(11)
    ref = jfused.stylize_batch(jnp.asarray(x), key, jcfg)
    got = tfused.stylize_batch(torch.from_numpy(x), cfg,
                               draws=jax_stage_draws(key, jcfg, shape), device="cpu")
    tol = 2e-2 if cfg.fft_backend == "plane_fast" else 1e-4
    assert rel_err(got.numpy(), ref) < tol, kw
