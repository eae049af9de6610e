"""The port's spatially split train step (mvtb_tpu_torch/parallel/spatial.py)
over 2 gloo ranks: the image and label split over H, the UNet replicated,
halo exchanges before the convolutions. Against JAX's one-device step on
the same flax weights (tests/test_parallel.py's spatial case: loss within
1e-6, parameters within atol 2e-4) and the port's own one-device step.

The second case reaches a level whose global H does not divide the ranks
(28 -> 14 -> 7): that level runs on the gathered tensor and is split again
on the way up.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtb_tpu.data.synthetic import make_volume
from mvtb_tpu.models import UNet as JUNet
from mvtb_tpu.train import create_seg_state, seg_train_step
from mvtb_tpu_torch.models import UNet, unet_params_from_flax
from test_torch_train_seg import _norm_fed_biases
from torch_dist_worker import World

CASES = {"even": ((32, 32, 8), (4, 8), (2,)),
         "gathered_level": ((28, 16, 8), (4, 8, 16), (2, 2))}


def _jax_case(spatial, channels, strides):
    model = JUNet(out_channels=3, channels=channels, strides=strides, num_res_units=1)
    state = create_seg_state(jax.random.key(0), model, (1, 16, 16, 8, 4))
    p0 = {k: v.numpy() for k, v in unet_params_from_flax(jax.device_get(state.params)).items()}
    image, label = make_volume(np.random.RandomState(0), 4, spatial)
    return state, {"channels": channels, "strides": strides, "state": p0,
                   "image": image[None], "label": label[None]}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    states, cases = {}, {}
    for name, args in CASES.items():
        states[name], cases[name] = _jax_case(*args)
    world = World("spatial_world", 2, {"cases": cases}, tmp_path_factory.mktemp("spatial"))
    ref = {}
    for name, case in cases.items():
        state, loss = seg_train_step(states[name], jnp.asarray(case["image"]),
                                     jnp.asarray(case["label"]), jax.random.key(7))
        ref[name] = (float(loss), unet_params_from_flax(jax.device_get(state.params)))
    return {"ranks": world.results(), "jax": ref}


@pytest.mark.parametrize("name", list(CASES))
def test_spatially_sharded_step_matches_jax(results, name):
    jloss, jparams = results["jax"][name]
    for r in results["ranks"]:
        assert abs(r[name]["loss"] - jloss) < 1e-6
        for k, v in jparams.items():
            np.testing.assert_allclose(r[name]["params"][k].numpy(), v.numpy(), atol=2e-4,
                                       err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_spatially_sharded_gradients_match_the_ports_own(results, name):
    """Against the port's one-device step on the same weights: loss within
    1e-6, each gradient within 1e-5 of its largest value; conv biases
    feeding an instance norm (exact gradient 0, rounding noise on both
    sides) within 1e-5 of the largest gradient of the net."""
    zero = _norm_fed_biases(UNet(4, 3, *CASES[name][1:], num_res_units=1, device="cpu"))
    for r in results["ranks"]:
        res = r[name]
        assert abs(res["split_loss"] - res["one_loss"]) < 1e-6
        got, ref = res["split_grads"], res["one_grads"]
        assert set(got) == set(ref) and zero <= set(ref)
        gmax = max(float(v.abs().max()) for v in ref.values())
        for k, v in ref.items():
            scale = gmax if k in zero else float(v.abs().max())
            assert float((got[k] - v).abs().max()) <= 1e-5 * scale, k


def test_ranks_agree(results):
    r0, r1 = results["ranks"]
    for name in CASES:
        assert r0[name]["loss"] == r1[name]["loss"]
        for k, v in r0[name]["params"].items():
            assert torch.equal(v, r1[name]["params"][k]), (name, k)


def test_halo_exchange_and_its_adjoint(results):
    for r in results["ranks"]:
        h = r["halo"]
        assert torch.equal(h["y"], h["ref"])
        torch.testing.assert_close(h["grad"], h["ref_grad"], rtol=0, atol=1e-12)
        assert r["halo_too_wide"] and "exceeds" in r["halo_too_wide"]
