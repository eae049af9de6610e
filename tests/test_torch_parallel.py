"""The port's mesh, data-parallel and tensor-parallel steps
(mvtb_tpu_torch/parallel) against the JAX package's one-device steps, case
for case with tests/test_parallel.py, over gloo ranks on the CPU.

Each world of processes is started once for the file (``torch_dist_worker``
runs every case of a world and imports no JAX); the JAX references are
computed once here. Flax weights reach the ranks through
``unet_params_from_flax``, JAX draws through ``jax_stage_draws``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtb_tpu.data.synthetic import make_volume
from mvtb_tpu.models import UNet as JUNet
from mvtb_tpu.ops.fused import StylizeConfig as JStylizeConfig
from mvtb_tpu.train import create_seg_state, seg_train_step
from mvtb_tpu_torch.models import UNet, unet_params_from_flax
from test_torch_fused_plane import jax_stage_draws
from test_torch_train_seg import _norm_fed_biases
from torch_dist_worker import World

STYLIZE = dict(disk_r=4.0, sap_p=0.1)
LR = 1e-4  # the reference optimizer's


def _batch(batch, spatial=(16, 16, 8)):
    rng = np.random.RandomState(0)
    imgs, lbls = zip(*[make_volume(rng, 4, spatial) for _ in range(batch)])
    return np.stack(imgs), np.stack(lbls)


def _jax_state(channels, strides):
    """JAX's ``create_seg_state(key(0))`` (the reference optimizer) and its
    weights as a port state dict."""
    model = JUNet(out_channels=3, channels=channels, strides=strides, num_res_units=1)
    state = create_seg_state(jax.random.key(0), model, (1, 16, 16, 8, 4))
    p0 = {k: v.numpy() for k, v in unet_params_from_flax(jax.device_get(state.params)).items()}
    return state, p0


def _jax_step(state, image, label, key, cfg=None):
    """JAX's one-device step: the stepped weights and the loss."""
    state, loss = seg_train_step(state, jnp.asarray(image), jnp.asarray(label), key, cfg)
    return unet_params_from_flax(jax.device_get(state.params)), float(loss)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Start every world, compute the JAX steps while they run, then wait."""
    tmp = tmp_path_factory.mktemp("parallel")
    image, label = _batch(8)
    timage, tlabel = _batch(4)
    cfg = JStylizeConfig(**STYLIZE)
    skey = jax.random.key(2)
    draws = jax_stage_draws(jax.random.split(skey)[0], cfg, image.shape)
    state, p0 = _jax_state((4, 8), (2,))
    tstate, tp0 = _jax_state((4, 8, 16), (2, 2))
    started = {
        "dp": World("dp_world", 2, {
            "channels": (4, 8), "strides": (2,), "state": p0, "image": image, "label": label,
            "stylize": STYLIZE, "draws": {k: v.numpy() for k, v in vars(draws).items()
                                          if v is not None}}, tmp),
        "tp": World("tp_world", 4, {"channels": (4, 8, 16), "strides": (2, 2), "state": tp0,
                                    "image": timage, "label": tlabel}, tmp),
        "mesh4": World("mesh_world", 4, {}, tmp),
        "mesh1": World("mesh_world", 1, {}, tmp / "one", init="none")}
    out = dict(image=image, label=label)
    out["ref"], out["loss"] = _jax_step(state, image, label, jax.random.key(1))
    state, _ = _jax_state((4, 8), (2,))
    out["sref"], out["sloss"] = _jax_step(state, image, label, skey, cfg)
    out["tref"], out["tloss"] = _jax_step(tstate, timage, tlabel, jax.random.key(5))
    out.update({k: w.results() for k, w in started.items()})
    return out


def _close(got, ref, atol, rtol, zero=frozenset()):
    """Every parameter within (atol, rtol); the ``zero`` ones (conv biases
    feeding an instance norm: exact gradient 0, so the reference optimizer's
    first step, lr * g / (|g| + eps), moves them by rounding noise of either
    sign on each side) within the optimizer's step bound, 2 * lr apart."""
    assert set(got) == set(ref)
    for k in ref:
        if k in zero:
            assert float((got[k] - ref[k]).abs().max()) <= 2 * LR * (1 + 1e-3), k
            continue
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), atol=atol, rtol=rtol,
                                   err_msg=k)


def _zero(channels, strides):
    return _norm_fed_biases(UNet(4, 3, channels, strides, num_res_units=1, device="cpu"))


def test_mesh_construction(worlds):
    for r, res in enumerate(worlds["mesh4"]):
        assert res["default"] == {"data": 4, "model": 1}
        assert res["dm"] == {"data": 2, "model": 2}
        assert res["dm_ranks"] == (r // 2, r % 2)  # model ranks adjacent
        assert res["too_big"] and "needs 16" in res["too_big"]


def test_world_of_one_is_a_one_by_one_mesh(worlds):
    (res,) = worlds["mesh1"]
    assert res["default"] == {"data": 1, "model": 1}
    assert res["rows"].shape == (2, 3)


def test_batch_sharding_spec(worlds):
    for r, res in enumerate(worlds["mesh4"]):
        assert res["spec"][0] == "data"
        assert all(s is None for s in res["spec"][1:])
        x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
        assert torch.equal(res["rows"], torch.from_numpy(x[2 * r:2 * r + 2]))
        a, b = res["rows_pair"]
        assert torch.equal(a, res["rows"]) and torch.equal(b, res["rows"][:, :1])
        assert res["cols"].shape == (2, 3)


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_step_matches_single_device(worlds, rank):
    res = worlds["dp"][rank]
    assert abs(res["loss"] - worlds["loss"]) < 1e-5
    _close(res["params"], worlds["ref"], atol=1e-5, rtol=1e-4, zero=_zero((4, 8), (2,)))


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_step_with_stylization(worlds, rank):
    """The stylize draws are the global batch's, cut to each rank's rows."""
    res = worlds["dp"][rank]
    assert np.isfinite(res["styl_loss"])
    assert abs(res["styl_loss"] - worlds["sloss"]) < 1e-5
    _close(res["styl_params"], worlds["sref"], atol=1e-5, rtol=1e-4,
           zero=_zero((4, 8), (2,)))


def test_replicate_copies_rank_zeros_values(worlds):
    r0, r1 = worlds["dp"]
    for k, v in r0["replica"].items():
        assert torch.equal(v, r1["replica"][k]), k
    assert r0["original_kept"] and r1["original_kept"]
    assert r0["replica_opt_bound"] and r1["replica_opt_bound"]
    assert torch.equal(r1["replicated_tensor"], torch.zeros(3))


def test_device_prefetch_sends_each_rank_its_rows(worlds):
    image, label = worlds["image"], worlds["label"]
    for r, res in enumerate(worlds["dp"]):
        assert len(res["prefetch"]) == 2
        for i, (a, b) in zip((0, 4), res["prefetch"]):
            rows = slice(i + 2 * r, i + 2 * r + 2)
            assert torch.equal(a, torch.from_numpy(image[rows]))
            assert torch.equal(b, torch.from_numpy(label[rows]))
        assert torch.equal(res["prefetch_replicated"][0], torch.from_numpy(label[:1]))


@pytest.mark.parametrize("rank", [0, 1])
def test_dcgan_step_data_parallel_matches_full_batch(worlds, rank):
    """BatchNorm statistics over the global batch: the 2-rank step equals
    the one-process step over the whole batch: losses within 1e-5, each
    gradient and running statistic within 1e-4 of its largest value."""
    res = worlds["dp"][rank]
    one, dp = res["gan_one"], res["gan_dp"]
    for k in one:
        assert abs(one[k] - dp[k]) < 1e-5, k
    for part in ("grads", "stats"):
        got, ref = res[f"gan_dp_{part}"], res[f"gan_one_{part}"]
        assert set(got) == set(ref) and len(ref) > 10
        for k in ref:
            scale = float(ref[k].abs().max())
            assert float((got[k] - ref[k]).abs().max()) <= 1e-4 * scale, (part, k)


@pytest.mark.parametrize("kind", ["gibbs", "spikes"])
def test_learnable_step_data_parallel_matches_full_batch(worlds, kind):
    for res in worlds["dp"]:
        (l1, a1), (l2, a2) = res[f"{kind}_one"], res[f"{kind}_dp"]
        assert abs(l1 - l2) < 1e-5
        assert abs(a1 - a2) < 1e-6
        _close(res[f"{kind}_dp_params"], res[f"{kind}_one_params"], atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_tensor_parallel_matches_single_device(worlds, rank):
    """(data=2, model=2): convolutions split on their output channels, the
    batch on data; the step equals JAX's one-device step."""
    res = worlds["tp"][rank]
    assert abs(res["loss"] - worlds["tloss"]) < 1e-5
    _close(res["params"], worlds["tref"], atol=2e-5, rtol=1e-4,
           zero=_zero((4, 8, 16), (2, 2)))


def test_tensor_parallel_splits_conv_and_transposed_conv_outputs(worlds):
    split = worlds["tp"][0]["split"]
    kinds = {kind for kind, _, _ in split.values()}
    assert kinds == {"Conv", "ConvTranspose"}
    for name, (kind, dim, shape) in split.items():
        if name.endswith(".weight"):
            assert dim == (1 if kind == "ConvTranspose" else 0), name
        ref = worlds["tref"][name].shape
        assert shape[dim] * 2 == ref[dim], name
    assert worlds["tp"][0]["prelu_spec"] == ()
    assert worlds["tp"][0]["ct_spec"] == (None, "model", None, None, None)
    for res in worlds["tp"]:
        assert res["moments_sliced"] and all(res["moments_sliced"])
