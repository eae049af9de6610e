"""The evaluation harness of the port (mvtb_tpu_torch/eval/harness.py)
against the JAX package's (mvtb_tpu/eval/harness.py): single and multi Dice
in the reference's order from the same weights and batches (direct and
through the sliding window), the saved record, ``load_dict``, the
transform sweep and the checkpoint restore."""

import json
import pickle

import jax
import numpy as np
import pytest
import torch

from mvtb_tpu.eval.harness import ModelEvaluation as JModelEvaluation
from mvtb_tpu.eval.harness import TransformSweep as JTransformSweep
from mvtb_tpu.models import UNet as JUNet
from mvtb_tpu_torch.eval.harness import ModelEvaluation, TransformSweep
from mvtb_tpu_torch.models import GibbsUNet, SpikesUNet, UNet, unet_params_from_flax
from mvtb_tpu_torch.train import CheckpointManager, create_learnable_state, create_seg_state
from mvtb_tpu_torch.transforms import RandFourierDiskMaskd

SPATIAL = (16, 16, 16)
# Dice from float32 logits that differ by summation order only: a hard Dice
# moves only where a logit sits at the threshold (measured 0.0)
DICE_TOL = 1e-6


def _models(out_channels, in_channels=4, seed=0):
    jm = JUNet(out_channels=out_channels, channels=(4, 8), strides=(2,), num_res_units=1)
    v = jm.init(jax.random.key(seed), np.zeros((1,) + SPATIAL + (in_channels,), np.float32))
    tm = UNet(in_channels, out_channels, (4, 8), (2,), 1, device="cpu")
    tm.load_state_dict(unet_params_from_flax(jax.device_get(v["params"])))
    return (jm.apply, v["params"]), tm


def _batches(n_batches, B, in_channels, out_channels, seed, spatial=SPATIAL):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        image = rng.randn(B, in_channels, *spatial).astype(np.float32)
        label = (rng.rand(B, out_channels, *spatial) < 0.4).astype(np.float32)
        label[0, -1] = 0.0  # an empty channel: NaN Dice where nothing is predicted
        out.append({"image": image, "label": label})
    return out


@pytest.mark.parametrize("roi", [None, (8, 8, 8)], ids=["direct", "sliding_window"])
def test_multi_dice_in_reference_order(roi):
    (apply_fn, params), tm = _models(3)
    data = _batches(3, 2, 4, 3, seed=1)
    ref = JModelEvaluation(apply_fn, params, out_channels=3, roi_size=roi)
    got = ModelEvaluation(tm, out_channels=3, roi_size=roi, device="cpu")
    r, g = ref.dataset_eval_multi(data), got.dataset_eval_multi(data)
    assert len(g) == 4 and all(isinstance(v, float) for v in g)
    np.testing.assert_allclose(g, np.asarray(r, np.float64), rtol=0, atol=DICE_TOL)
    # (mean, ET, TC, WT) from channels TC=0, WT=1, ET=2
    per = [ModelEvaluation(_Channel(tm, c), out_channels=1, roi_size=roi,
                           device="cpu").dataset_eval_single(
        [{"image": b["image"], "label": b["label"][:, c:c + 1]} for b in data])
        for c in range(3)]
    np.testing.assert_allclose(g[1:], [per[2], per[0], per[1]], rtol=0, atol=1e-12)


class _Channel(torch.nn.Module):
    """One output channel of a model."""

    def __init__(self, model, c):
        super().__init__()
        self.model, self.c = model, c

    def forward(self, x):
        return self.model(x)[:, self.c:self.c + 1]


def test_single_dice_matches_jax():
    (apply_fn, params), tm = _models(1, in_channels=1, seed=2)
    data = _batches(3, 2, 1, 1, seed=3)
    ref = JModelEvaluation(apply_fn, params, out_channels=1)
    got = ModelEvaluation(tm, out_channels=1, device="cpu")
    g = got.dataset_eval_single(data)
    assert isinstance(g, float)
    assert abs(g - float(ref.dataset_eval_single(data))) <= DICE_TOL


def test_add_eval_save_and_load_dict(tmp_path):
    (apply_fn, params), tm = _models(3, seed=4)
    data = {"clean": _batches(1, 2, 4, 3, seed=5), "other": _batches(2, 1, 4, 3, seed=6)}
    ref = JModelEvaluation(apply_fn, params, instance_name="m", out_channels=3)
    got = ModelEvaluation(tm, instance_name="m", out_channels=3, device="cpu")
    for ev in (ref, got):
        ev.add_eval(data_dict=data)
        ev.add_eval("again", data["clean"])
    jpath = ref.save(str(tmp_path / "jax"))
    path = got.save(str(tmp_path / "port"))
    assert path == str(tmp_path / "port.json")
    with open(path) as f, open(jpath) as g:
        rec, jrec = json.load(f), json.load(g)
    assert rec.keys() == jrec.keys() == {"instance_name", "in_channels", "out_channels",
                                         "eval_dict"}
    assert list(rec["eval_dict"]) == list(jrec["eval_dict"]) == ["clean", "other", "again"]
    for k, v in rec["eval_dict"].items():
        np.testing.assert_allclose(v, jrec["eval_dict"][k], rtol=0, atol=DICE_TOL)
    with open(tmp_path / "port.pickle", "rb") as f:
        pick = pickle.load(f)
    assert pick == rec
    assert all(type(x) is float for v in pick["eval_dict"].values() for x in v)
    for name in ("port.json", "port.pickle"):
        ev = ModelEvaluation(instance_name=None, device="cpu")
        ev.load_dict(str(tmp_path / name))
        assert ev.instance_name == "m"
        assert dict(ev.eval_dict) == rec["eval_dict"]


def test_transform_sweep_names_and_short_last_batch():
    rng = np.random.RandomState(7)
    samples = [{"image": rng.randn(1, 8, 8, 8).astype(np.float32),
                "label": (rng.rand(1, 8, 8, 8) < 0.5).astype(np.float32)} for _ in range(5)]
    transforms = {"clean": None,
                  "disk": RandFourierDiskMaskd("image", r=2.0, prob=1.0, device="cpu")}
    sweep = TransformSweep(samples, transforms, batch_size=2)
    jsweep = JTransformSweep(samples, {"clean": None}, batch_size=2)
    assert [name for name, _ in sweep] == ["clean", "disk"]
    for name, loader in sweep:
        batches = list(loader)
        assert [b["image"].shape[0] for b in batches] == [2, 2, 1]
        assert all(isinstance(b["image"], np.ndarray) and isinstance(b["label"], np.ndarray)
                   for b in batches)
    for b, jb in zip(sweep["clean"], jsweep["clean"]):
        np.testing.assert_array_equal(b["image"], jb["image"])
    disk = np.concatenate([b["image"] for b in sweep["disk"]])
    assert not np.allclose(disk, np.stack([s["image"] for s in samples]))


def test_from_checkpoint_round_trips_a_port_checkpoint(tmp_path):
    torch.manual_seed(0)
    state = create_seg_state(UNet(4, 3, device="cpu"), device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(5, state)
    mgr.close()
    ev = ModelEvaluation.from_checkpoint(str(tmp_path / "ck"), instance_name="r", device="cpu")
    assert ev.instance_name == "r" and ev.out_channels == 3 and ev.in_channels == 4
    want = state.model.state_dict()
    got = ev.model.state_dict()
    assert want.keys() == got.keys()
    assert all(torch.equal(want[k], got[k]) for k in want)


@pytest.mark.parametrize("flag", ["gibbs_unet", "spikes_unet"])
def test_stylization_unets_name_their_roadmap_item(tmp_path, flag):
    """``from_checkpoint`` restores a learnable run's full-width
    ``GibbsUNet`` / ``SpikesUNet`` (1 -> 1), whatever its optimizer (the
    spike run's here froze its UNet, so its optimizer holds one parameter),
    and its forward runs the stylization layer, the spike draws from a
    generator seeded 0 at every call."""
    torch.manual_seed(1)
    if flag == "gibbs_unet":
        model = GibbsUNet(0.63, device="cpu")
        state = create_learnable_state(model, device="cpu")
    else:
        model = SpikesUNet(12.5, device="cpu")
        state = create_learnable_state(model, freeze_unet=True, unet_optimizer="sgd",
                                       device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(3, state)
    ev = ModelEvaluation.from_checkpoint(str(tmp_path / "ck"), instance_name="s",
                                         in_channels=1, out_channels=1, device="cpu",
                                         **{flag: True})
    assert ev.in_channels == 1 and ev.out_channels == 1
    restored = ev.model if flag == "gibbs_unet" else ev.model.model
    assert type(restored) is type(model) and not restored.training
    want, got = model.state_dict(), restored.state_dict()
    assert want.keys() == got.keys() and all(torch.equal(want[k], got[k]) for k in want)
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 1, *SPATIAL).astype(np.float32))
    with torch.no_grad():
        out = ev.model(x)
        if flag == "gibbs_unet":
            assert torch.equal(out, model(x))
        else:
            assert torch.equal(out, model(x, generator=torch.Generator().manual_seed(0)))
            assert torch.equal(out, ev.model(x))  # the same draws at every call
            assert not torch.equal(out, restored.unet(x))  # the spike layer ran
