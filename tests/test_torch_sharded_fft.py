"""The port's H-split k-space stylization (mvtb_tpu_torch/parallel/
sharded_fft.py) over 2 gloo ranks against the JAX package's
``stylize_kspace_sharded`` (a 2-device mesh) and the port's one-device
``stylize_kspace`` on the same draws, case for case with
tests/test_sharded_fft.py and at its tolerances.

Draws replay JAX's through ``jax_stage_draws`` with B = 1: a volume's key
is the one ``split(key, 1)`` gives, which is the key the JAX function
consumes. One world of ranks runs every case (``torch_dist_worker``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtb_tpu.ops.fused import StylizeConfig
from mvtb_tpu.parallel import make_mesh
from mvtb_tpu.parallel.sharded_fft import stylize_kspace_sharded
from test_torch_fused_plane import jax_stage_draws
from torch_dist_worker import World

SHAPE = (2, 16, 24, 10)  # (C, H, W, D), as the JAX test's
WORLD = 2

CONFIGS = [
    StylizeConfig(disk_r=5.0),
    StylizeConfig(gibbs_alpha=0.4),
    StylizeConfig(wrap_alpha=0.25),
    StylizeConfig(disk_r=6.0, wrap_alpha=0.5),
    StylizeConfig(gibbs_alpha=0.3, disk_r=7.0, wrap_alpha=0.75),
    StylizeConfig(spike=True, spike_range=(11.0, 11.0), spike_channel_wise=False),
    StylizeConfig(spike=True, spike_range=(10.0, 12.0), spike_channel_wise=True),
    StylizeConfig(plane_axes=(6.0, 8.0, 4.0), plane_intensity=10.0),
    StylizeConfig(disk_r=6.0, wrap_alpha=0.5, spike=True, spike_range=(11.0, 11.0),
                  spike_channel_wise=False, plane_axes=(6.0, 8.0, 4.0), plane_intensity=10.0),
    StylizeConfig(spike=True),  # data-dependent range (all-reduced sums)
    StylizeConfig(zf_p=0.3),
    StylizeConfig(sap_p=0.15),
    StylizeConfig(disk_r=6.0, zf_p=0.25, sap_p=0.1),
    # zero-fill then point writes: the written point reads the zero-filled
    # spectrum, so this holds only if the expanded pair weight is pointwise
    StylizeConfig(zf_p=0.3, spike=True, spike_range=(10.0, 12.0)),
    StylizeConfig(zf_p=0.3, plane_axes=(6.0, 8.0, 4.0), plane_intensity=10.0),
]
BACKEND_CFG = dict(disk_r=6.0, wrap_alpha=0.5, plane_axes=(6.0, 8.0, 4.0),
                   plane_intensity=10.0)


def _x(seed=0):
    return np.random.RandomState(seed).randn(*SHAPE).astype(np.float32)


def _case(cfg, seed, key_seed):
    """The port's inputs and JAX's sharded result for one case."""
    kb = jax.random.key(key_seed)
    x = _x(seed)
    draws = jax_stage_draws(kb, cfg, (1,) + SHAPE)
    return ({"cfg": dataclasses.asdict(cfg), "x": x,
             "draws": {k: v.numpy() for k, v in vars(draws).items() if v is not None}},
            jax.random.split(kb, 1)[0])


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cases, keys = {}, {}
    for i, cfg in enumerate(CONFIGS):
        cases[f"cfg{i}"], keys[f"cfg{i}"] = _case(cfg, 0, 0)
    for b in ("dft", "hybrid"):
        cases[b], keys[b] = _case(StylizeConfig(**BACKEND_CFG, fft_backend=b), 4, 2)
    cases["sap"], keys["sap"] = _case(StylizeConfig(sap_p=0.4), 0, 1)
    cases["zf_full"], keys["zf_full"] = _case(StylizeConfig(zf_p=1.0), 0, 0)
    bad = {"h_blocks": ((1, 15, 16, 8), {"disk_r": 3.0}),
           "w": ((1, 16, 15, 8), {"disk_r": 3.0}),
           "rank": ((16, 16, 8), {"disk_r": 3.0}),
           "2d": ((1, 16, 16, 8), {"disk_r": 3.0, "n_dims": 2})}
    world = World("sharded_fft_world", WORLD, {"cases": cases, "bad": bad},
                  tmp_path_factory.mktemp("sharded_fft"))
    mesh = make_mesh(n_data=WORLD, n_model=1, devices=jax.devices()[:WORLD])
    jax_out = {}
    for name, case in cases.items():
        cfg = StylizeConfig(**case["cfg"])
        jax_out[name] = np.asarray(stylize_kspace_sharded(jnp.asarray(case["x"]), keys[name],
                                                          cfg, mesh))
    return {"ranks": world.results(), "jax": jax_out, "cases": cases}


def _gathered(results, name):
    return torch.cat([r[name]["block"] for r in results["ranks"]], dim=1).numpy()


def _check(results, name, tol):
    got = _gathered(results, name)
    for want in (results["jax"][name], results["ranks"][0][name]["one"].numpy()):
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("i", range(len(CONFIGS)), ids=[f"cfg{i}" for i in range(len(CONFIGS))])
def test_sharded_matches_single_chip(results, i):
    _check(results, f"cfg{i}", 1e-4)
    # each rank holds its H block
    for r in results["ranks"]:
        assert r[f"cfg{i}"]["block"].shape == (SHAPE[0], SHAPE[1] // WORLD) + SHAPE[2:]


@pytest.mark.parametrize("backend", ["dft", "hybrid"])
def test_sharded_matmul_backends_match_single_chip(results, backend):
    _check(results, backend, 2e-4)


def test_sharded_sap_distribution(results):
    out, xx = _gathered(results, "sap"), results["cases"]["sap"]["x"]
    changed = (out != xx).mean()
    assert 0.3 < changed < 0.5
    lo, hi = xx.min() / 2, xx.max() / 2
    assert np.isclose(out, lo).any() and np.isclose(out, hi).any()
    _check(results, "sap", 1e-4)


def test_sharded_zero_fill_full(results):
    assert float(np.abs(_gathered(results, "zf_full")).max()) < 1e-4


@pytest.mark.parametrize("name", ["h_blocks", "w", "rank", "2d"])
def test_sharded_shape_validation(results, name):
    for r in results["ranks"]:
        assert r["errors"][name], name
