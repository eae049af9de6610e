"""The precision tiers of the port's plane path (mvtb_tpu_torch/ops/fused_plane.py)
against the JAX package's, and the host side of the tensor-core kernel.

``plane`` is bf16x3 on both sides: every operand splits into bf16 (hi, lo)
with the JAX package's ``_split_bf16`` and each product is hi.hi + hi.lo +
lo.hi, exact in float32, so the two differ only in the order of float32
sums. Measured on the CPU: at most 2.9e-6 of the output's max over the
stage combinations of ``tests/test_torch_fused_plane.py`` (1e-4 was the
bound while the port contracted in float32), and 1.2e-6 of the logits'
max for the eval step below; the bounds are 2e-5 and 3e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtb_tpu.ops import fused as jfused
from mvtb_tpu.ops import fused_plane as jplane
from mvtb_tpu.ops.pallas_dft import _split_bf16
from mvtb_tpu.train import seg as jseg
from mvtb_tpu_torch.ops import _build
from mvtb_tpu_torch.ops import dft as tdft
from mvtb_tpu_torch.ops import fused as tfused
from mvtb_tpu_torch.ops import fused_plane as tplane
from mvtb_tpu_torch.train import seg as tseg
from test_torch_fused_plane import FLAG_CASES, _half_case, jax_stage_draws, rel_err
from test_torch_seg_eval import LOGIT_TOL, _models

PLANE_TOL = 2e-5


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


def test_split_is_bit_equal_to_jax():
    rng = np.random.RandomState(0)
    x = np.concatenate([
        rng.randn(4096).astype(np.float32) * 10.0 ** rng.randint(-30, 30, 4096),
        np.array([0.0, -0.0, 1e-40, -1e-40, 1e-45, 1.1754942e-38, 5e-39,
                  3e38, -3e38, 1e30, 65504.0, 1.5, -2.0, 0.25, 3.0,
                  1.0 + 2.0 ** -8, 1.0 + 2.0 ** -9, 1.0 + 2.0 ** -16], np.float32),
        # values whose lo is 0: exactly representable in bf16
        (rng.randint(-128, 128, 64) * 2.0 ** rng.randint(-20, 20, 64)).astype(np.float32),
    ]).astype(np.float32)
    hi, lo = tplane.split_bf16(torch.from_numpy(x))
    jhi, jlo = _split_bf16(jnp.asarray(x))
    assert hi.dtype == lo.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(hi.view(torch.int16).numpy()),
                                  _bits(jax.lax.bitcast_convert_type(jhi, jnp.uint16)))
    np.testing.assert_array_equal(_bits(lo.view(torch.int16).numpy()),
                                  _bits(jax.lax.bitcast_convert_type(jlo, jnp.uint16)))
    assert (lo.float().numpy()[-64:] == 0).all()
    # -0.0 keeps its sign in hi; lo of a signed zero is +0 (0 - 0)
    assert _bits(hi.view(torch.int16).numpy())[4097] == 0x8000


@pytest.mark.parametrize("case", range(len(FLAG_CASES)))
def test_plane_plain_is_bf16x3_like_the_jax_kernel(case):
    """Another shape than test_torch_fused_plane's (odd D, even H and W)."""
    kw, shape = FLAG_CASES[case], (1, 2, 12, 14, 9)
    spatial = shape[2:]
    flags, params, k = _half_case(kw, "plane", shape, seed=100 + case)
    jparams = [jnp.asarray(p.numpy()) for p in params]
    if params[1].shape[0] == 0:  # no point stage: the JAX kernel takes S=1 dummies
        jparams[1:] = [jnp.zeros((1,) + p.shape[1:], p.dtype) for p in jparams[1:]]
    ref = jplane.plane_stylize_half(jnp.asarray(k[0]), jnp.asarray(k[1]), spatial,
                                    flags, *jparams, jax.lax.Precision.HIGH, True)
    got = tplane.plane_stylize_half_plain(torch.from_numpy(k[0]), torch.from_numpy(k[1]),
                                          spatial, flags, *params, fast=False)
    for g, r in zip(got, ref):
        assert rel_err(g.numpy(), r) < PLANE_TOL, kw


@pytest.mark.parametrize("case", range(len(FLAG_CASES)))
def test_exact_reference_is_the_jax_kernel_in_float32(case):
    """plane_stylize_half_exact, the complex128 yardstick chip_smoke.py holds
    the kernel's accuracy to, computes the JAX plane kernel's function: it
    agrees with that kernel at Precision.HIGHEST (float32 dots) within 2e-6
    of the output's max (7.4e-7 measured)."""
    kw, shape = FLAG_CASES[case], (1, 2, 12, 14, 9)
    flags, params, k = _half_case(kw, "plane", shape, seed=200 + case)
    jparams = [jnp.asarray(p.numpy()) for p in params]
    if params[1].shape[0] == 0:
        jparams[1:] = [jnp.zeros((1,) + p.shape[1:], p.dtype) for p in jparams[1:]]
    ref = jplane.plane_stylize_half(jnp.asarray(k[0]), jnp.asarray(k[1]), shape[2:], flags,
                                    *jparams, jax.lax.Precision.HIGHEST, True)
    exact = tplane.plane_stylize_half_exact(torch.from_numpy(k[0]), torch.from_numpy(k[1]),
                                            shape[2:], flags, *params)
    assert all(e.dtype == torch.float64 for e in exact)
    scale = max(float(e.abs().max()) for e in exact)
    err = max(float(np.abs(np.asarray(r, np.float64) - e.numpy()).max())
              for r, e in zip(ref, exact))
    assert err < 2e-6 * scale, kw


def test_plane_plain_is_not_the_float32_contraction(monkeypatch):
    """bf16x3 leaves lo.lo out: close to a float32 contraction, not equal."""
    kw, shape = FLAG_CASES[4], (1, 2, 16, 12, 10)
    flags, params, k = _half_case(kw, "plane", shape, seed=3)
    args = (torch.from_numpy(k[0]), torch.from_numpy(k[1]), shape[2:], flags, *params)
    got = tplane.plane_stylize_half_plain(*args, fast=False)
    tplane._plane_mats.cache_clear()
    try:  # every operand kept in float32: the float32 contraction
        monkeypatch.setattr(tplane, "_tier_values", lambda t, fast: (t,))
        f32 = tplane.plane_stylize_half_plain(*args, fast=True)
    finally:
        monkeypatch.undo()
        tplane._plane_mats.cache_clear()
    for g, f in zip(got, f32):
        assert 0 < rel_err(g.numpy(), f.numpy()) < PLANE_TOL


def test_seg_eval_step_on_plane_matches_jax_with_gibbs():
    B, C, spatial = 1, 4, (16, 12, 16)
    stack = dict(gibbs_alpha=(0.2, 0.5), disk_r=(3.0, 6.0), wrap_alpha=0.5,
                 spike=True, spike_range=(10.0, 11.0), plane_axes=(6.0, 5.0, 4.0),
                 plane_intensity=12.0, sap_p=0.05)
    rng = np.random.RandomState(5)
    image = rng.randn(B, C, *spatial).astype(np.float32)
    label = (rng.rand(B, 3, *spatial) < 0.4).astype(np.float32)
    key = jax.random.key(13)
    jcfg = jfused.StylizeConfig(**stack, fft_backend="plane")
    tcfg = tfused.StylizeConfig(**stack, fft_backend="plane")
    state, tm = _models(C, (B,) + spatial + (C,), seed=3)
    styled = jfused.stylize_batch(jnp.asarray(image), key, jcfg)
    logits_ref = np.moveaxis(np.asarray(state.apply_fn(
        {"params": state.params}, jnp.moveaxis(styled, 1, -1))), -1, 1)
    _, logits = tseg.seg_eval_step(
        tm, torch.from_numpy(image), torch.from_numpy(label), tcfg,
        draws=jax_stage_draws(key, jcfg, image.shape), device="cpu",
        return_logits=True)
    assert rel_err(logits.numpy(), logits_ref) < LOGIT_TOL


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("W,D", [(13, 11), (24, 161), (70, 66)])
def test_kernel_mats_layout(W, D, fast):
    """Element (r, k) of each pre-lowered matrix sits where the kernel's
    wgmma descriptors read it: chunk k // 16, core matrix (r // 8, k % 16 // 8),
    row r % 8, column k % 8; padding is zero."""
    flat = tplane._kernel_mats(W, D, fast, torch.device("cpu"))
    assert flat.dtype == torch.bfloat16
    off = 0
    for (n, inverse), rows in zip(tplane._sections(W, D), (128, 160, 128, 160)):
        Rp, Kp = -(-n // rows) * rows, -(-n // 16) * 16
        cos, smc, cps = tdft._gauss_dft_matrices_np(n, inverse)
        for m in (cos, cps, smc):
            t = torch.from_numpy(m)
            parts = (t.to(torch.bfloat16),) if fast else tplane.split_bf16(t)
            for part in parts:
                block = flat[off:off + Rp * Kp].view(Kp // 16, Rp // 8, 2, 8, 8)
                off += Rp * Kp
                r = torch.arange(Rp).view(-1, 1)
                k = torch.arange(Kp).view(1, -1)
                got = block[k // 16, r // 8, (k % 16) // 8, r % 8, k % 8]
                want = torch.zeros((Rp, Kp), dtype=torch.bfloat16)
                want[:n, :n] = part
                assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert off == flat.numel()


def test_plain_matrices_are_the_tier_parts():
    hi_lo = tplane._plane_mats(12, 10, False, torch.device("cpu"))
    one = tplane._plane_mats(12, 10, True, torch.device("cpu"))
    cos = torch.from_numpy(tdft._gauss_dft_matrices_np(10, False)[0])
    hi, lo = hi_lo[1][0]
    assert torch.equal(hi + lo, hi.double().add(lo.double()).float())
    assert float((hi + lo - cos).abs().max()) <= 2.0 ** -16
    assert torch.equal(one[1][0][0], cos.to(torch.bfloat16).float())


def test_edited_header_changes_the_library_name(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build.lib_path(name) for name in _build.SOURCES}
    header = csrc / "gauss_wgmma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.lib_path(name) for name in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.lib_path("fused_plane") != after["fused_plane"]
    assert _build.lib_path("fused_plane").parent == _build.BUILD_DIR
