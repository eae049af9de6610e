"""The port's MONAI-name shim (mvtb_tpu_torch/compat/monai) runs the
reference's pipelines, evaluation and training loops verbatim; mirrors
tests/test_monai_shim.py.

The reference's code shapes (``baseline.py:116-189,232-310``,
``gibbs0p7_layer_domain_GD.py``, ``baseline_domain.py``) are inlined as in
the JAX tests, with the roi and shape constants scaled down, against the
port's shim imported by package path (this worker may hold the JAX shim as
the bare ``monai``: tests/test_monai_shim.py installs it at import). The
bare name is checked in a subprocess. Two changes to the scripts' lines:
the UNet takes ``device=torch.device("cpu")``, since the port's default is
the card; and the JAX shim's gradient-bridge tests become real autograd,
held against the JAX shim's bridged loop from the same flax weights
(losses within 1e-4 over 3 Adam steps, float32 on the CPU).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mvtb_tpu_torch.compat.monai.apps import DecathlonDataset
from mvtb_tpu_torch.compat.monai.data import CacheDataset, DataLoader, partition_dataset
from mvtb_tpu_torch.compat.monai.losses import DiceLoss
from mvtb_tpu_torch.compat.monai.metrics import DiceMetric
from mvtb_tpu_torch.compat.monai.networks.nets import UNet
from mvtb_tpu_torch.compat.monai.transforms import (
    Activations,
    AsChannelFirstd,
    AsDiscrete,
    CenterSpatialCropd,
    Compose,
    LoadImaged,
    MapTransform,
    NormalizeIntensityd,
    Orientationd,
    Spacingd,
    ToTensord,
)
from mvtb_tpu_torch.compat.monai.utils import set_determinism
from mvtb_tpu_torch.data.synthetic import build_decathlon_tree

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("decathlon")
    # an affine at the target pixdim: Spacingd keeps the 32x32x16 shape
    build_decathlon_tree(str(root), n=5, spatial=(32, 32, 16), kind="smooth",
                         affine=np.diag([1.5, 1.5, 2.0, 1.0]))
    return str(root)


class ConvertToMultiChannelBasedOnBratsClassesd(MapTransform):
    """``baseline.py:87-113``'s semantics."""

    def __call__(self, data):
        d = dict(data)
        for key in self.keys:
            result = [np.logical_or(d[key] == 2, d[key] == 3),
                      np.logical_or(np.logical_or(d[key] == 2, d[key] == 3),
                                    d[key] == 1),
                      d[key] == 2]
            d[key] = np.stack(result, axis=0).astype(np.float32)
        return d


def _val_transform():
    # the reference's val pipeline (baseline.py:139-156) at test scale
    return Compose([
        LoadImaged(keys=["image", "label"]),
        AsChannelFirstd(keys="image"),
        ConvertToMultiChannelBasedOnBratsClassesd(keys="label"),
        Spacingd(keys=["image", "label"], pixdim=(1.5, 1.5, 2.0),
                 mode=("bilinear", "nearest")),
        Orientationd(keys=["image", "label"], axcodes="RAS"),
        CenterSpatialCropd(keys=["image", "label"], roi_size=[32, 32, 16]),
        NormalizeIntensityd(keys="image", nonzero=True, channel_wise=True),
        ToTensord(keys=["image", "label"]),
    ])


def test_shim_importable_as_top_level_monai():
    """``install()`` then ``import monai`` gives the port's shim, with no JAX."""
    code = ("import sys\n"
            "from mvtb_tpu_torch import compat\n"
            "compat.install()\n"
            "import monai\n"
            "from monai.networks.nets import UNet\n"
            "from monai.losses import DiceLoss\n"
            "assert 'mvtb_tpu_torch/compat' in monai.__file__.replace('\\\\', '/')\n"
            "assert sys.modules['monai'].transforms is not None\n"
            "import mvtb_tpu_torch.models.unet3d as u\n"
            "assert issubclass(UNet, u.UNet)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'mvtb_tpu')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_pipeline_and_dataset(root_dir):
    set_determinism(seed=0)
    val_ds = DecathlonDataset(root_dir=root_dir, task="Task01_BrainTumour",
                              transform=_val_transform(),
                              section="validation", download=False,
                              num_workers=4, cache_num=50)
    assert len(val_ds) == 1  # 20% of 5
    sample = val_ds[0]
    assert isinstance(sample["image"], torch.Tensor) and sample["image"].device == CPU
    assert sample["image"].shape == (4, 32, 32, 16)
    assert sample["label"].shape == (3, 32, 32, 16)
    # label channels are the BraTS one-hot: TC subset of WT
    assert torch.all(sample["label"][0] <= sample["label"][1])
    # cached deterministic prefix: second access identical
    assert torch.equal(sample["image"], val_ds[0]["image"])
    # the JAX shim's pipeline over the same files gives the same arrays
    from mvtb_tpu.compat.monai import apps as japps
    from mvtb_tpu.compat.monai import transforms as jt

    jval = japps.DecathlonDataset(root_dir=root_dir, task="Task01_BrainTumour", transform=jt.Compose([
        jt.LoadImaged(keys=["image", "label"]), jt.AsChannelFirstd(keys="image"),
        ConvertToMultiChannelBasedOnBratsClassesd(keys="label"),
        jt.Spacingd(keys=["image", "label"], pixdim=(1.5, 1.5, 2.0), mode=("bilinear", "nearest")),
        jt.Orientationd(keys=["image", "label"], axcodes="RAS"),
        jt.CenterSpatialCropd(keys=["image", "label"], roi_size=[32, 32, 16]),
        jt.NormalizeIntensityd(keys="image", nonzero=True, channel_wise=True),
        jt.ToTensord(keys=["image", "label"])]), section="validation")
    for k in ("image", "label"):
        np.testing.assert_allclose(sample[k].numpy(), np.asarray(jval[0][k]), rtol=1e-6,
                                   atol=1e-6)


def test_eval_half_runs_verbatim(root_dir):
    set_determinism(seed=0)
    train_ds = DecathlonDataset(root_dir=root_dir, task="Task01_BrainTumour",
                                transform=_val_transform(),
                                section="training", download=False,
                                cache_num=100)
    # the reference's deterministic split + loader (baseline.py:186-189)
    val_ds, test_ds = torch.utils.data.random_split(
        train_ds, [2, 2], torch.Generator().manual_seed(0))
    val_loader = DataLoader(val_ds, batch_size=2, shuffle=False,
                            num_workers=4)

    device = torch.device("cpu")
    model = UNet(dimensions=3, in_channels=4, out_channels=3,
                 channels=(4, 4, 4, 4, 4), strides=(2, 2, 2, 2),
                 num_res_units=1, device=device).to(device)
    n_params = sum(p.numel() for p in model.parameters() if p.requires_grad)
    assert n_params > 0

    model.eval()
    dice_metric = DiceMetric(include_background=True, reduction="mean")
    post_trans = Compose([Activations(sigmoid=True),
                          AsDiscrete(threshold_values=True)])
    metric_sum = 0.0
    metric_count = 0
    with torch.no_grad():
        for val_data in val_loader:
            val_inputs, val_labels = (val_data["image"].to(device),
                                      val_data["label"].to(device))
            val_outputs = model(val_inputs)
            assert val_outputs.shape == val_labels.shape
            val_outputs = post_trans(val_outputs)
            assert set(torch.unique(val_outputs).tolist()) <= {0.0, 1.0}
            value, not_nans = dice_metric(y_pred=val_outputs, y=val_labels)
            not_nans = not_nans.item()
            metric_count += not_nans
            metric_sum += value.item() * not_nans
            # per-class slices run too (baseline.py:283-301)
            value_tc, nn_tc = dice_metric(y_pred=val_outputs[:, 0:1],
                                          y=val_labels[:, 0:1])
            assert 0.0 <= value_tc.item() <= 1.0 or np.isnan(value_tc.item())
    assert metric_count > 0
    metric = metric_sum / metric_count
    assert 0.0 <= metric <= 1.0


def test_state_dict_roundtrip_changes_forward():
    model = UNet(dimensions=3, in_channels=2, out_channels=1,
                 channels=(4, 4), strides=(2,), num_res_units=1, device=CPU)
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 2, 16, 16, 16).astype(np.float32))
    with torch.no_grad():
        y0 = model(x)
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict({k: torch.zeros_like(v) for k, v in sd.items()})
        assert torch.allclose(model(x), torch.zeros(()))
        model.load_state_dict(sd)
        torch.testing.assert_close(model(x), y0, rtol=1e-6, atol=0)
    assert all("/" not in k for k in sd)  # the port's own names


def test_dice_loss_matches_framework_and_backward_is_autograd():
    """The loss is the JAX package's ``dice_loss``; its ``backward`` is
    autograd, and its gradient is ``jax.grad`` of the same loss."""
    import jax
    import jax.numpy as jnp

    from mvtb_tpu.train.losses import dice_loss

    rng = np.random.RandomState(0)
    logits = rng.randn(2, 3, 8, 8, 4).astype(np.float32)
    target = (rng.rand(2, 3, 8, 8, 4) > 0.5).astype(np.float32)
    loss_function = DiceLoss(to_onehot_y=False, sigmoid=True,
                             squared_pred=True)
    x = torch.from_numpy(logits).requires_grad_()
    loss = loss_function(x, torch.from_numpy(target))

    def jloss(v):
        return dice_loss(jnp.moveaxis(v, 1, -1), jnp.moveaxis(jnp.asarray(target), 1, -1),
                         sigmoid=True, squared_pred=True)

    want, grad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    assert abs(loss.item() - float(want)) < 1e-6
    loss.backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad), rtol=1e-4, atol=1e-7)
    with pytest.raises(NotImplementedError):
        DiceLoss(softmax=True)


def test_partition_dataset_matches_monai_ratios():
    from mvtb_tpu.compat.monai.data import partition_dataset as jpartition

    data = list(range(10))
    parts = partition_dataset(data, ratios=[0.9, 0.1], shuffle=True, seed=42)
    assert len(parts) == 2
    assert len(parts[0]) == 9 and len(parts[1]) == 1
    assert sorted(parts[0] + parts[1]) == data
    # seeded shuffle is reproducible, and the JAX shim's
    assert parts == partition_dataset(data, ratios=[0.9, 0.1], shuffle=True, seed=42)
    assert parts == jpartition(data, ratios=[0.9, 0.1], shuffle=True, seed=42)


def test_cache_dataset_caches_prefix_but_rerolls_random_suffix():
    """MONAI CacheDataset semantics: the deterministic prefix runs once and
    is cached; the random suffix re-rolls per access on a deep copy."""
    from mvtb_tpu_torch.transforms.base import Randomizable

    calls = {"prefix": 0}

    class CountingDouble(MapTransform):
        def __call__(self, d):
            calls["prefix"] += 1
            d = dict(d)
            for k in self.key_iterator(d):
                d[k] = np.asarray(d[k]) * 2.0
            return d

    class RandShift(MapTransform, Randomizable):
        def __call__(self, d):
            d = dict(d)
            off = self.R.rand()
            for k in self.key_iterator(d):
                d[k] = np.asarray(d[k]) + off
            return d

    data = [{"image": np.ones((2, 2), np.float32)} for _ in range(3)]
    ds = CacheDataset(data, Compose([CountingDouble(keys="image"),
                                     RandShift(keys="image")]), cache_num=3)
    a = ds[0]["image"]
    b = ds[0]["image"]
    assert calls["prefix"] == 1  # prefix ran once, cached
    assert (a >= 2.0).all() and (b >= 2.0).all()
    assert not np.allclose(a, b)  # random suffix re-rolled


def test_add_channeld_and_numpy_pad_mode_names_exist():
    from mvtb_tpu_torch.compat.monai.transforms import AddChanneld
    from mvtb_tpu_torch.compat.monai.utils import NumpyPadMode

    d = AddChanneld(keys="label")({"label": np.zeros((4, 4, 2))})
    assert d["label"].shape == (1, 4, 4, 2)
    assert str(NumpyPadMode.CONSTANT) == "constant"


def _train_batch(root_dir):
    set_determinism(seed=0)
    ds = DecathlonDataset(root_dir=root_dir, task="Task01_BrainTumour",
                          transform=_val_transform(), section="training", cache_num=100)
    return next(iter(DataLoader(ds, batch_size=2, shuffle=True, num_workers=4)))


def test_training_half_matches_the_jax_shims_bridged_loop(root_dir):
    """The reference's training loop (``baseline.py:232-248``: zero_grad,
    forward, DiceLoss, backward, step) with real autograd, from the JAX
    shim UNet's flax weights (loaded through its flax-keyed state_dict):
    over 3 Adam steps on one batch, the losses equal the JAX shim's
    gradient-bridged loop within 1e-4, and they fall."""
    from mvtb_tpu.compat.monai.losses import DiceLoss as JDiceLoss
    from mvtb_tpu.compat.monai.networks.nets import UNet as JUNet

    batch = _train_batch(root_dir)
    kw = dict(dimensions=3, in_channels=4, out_channels=3, channels=(4, 8), strides=(2,),
              num_res_units=1)

    def loop(model, loss_function, to_inputs):
        # reference: Adam(model.parameters(), 1e-4, weight_decay=1e-5,
        # amsgrad=True) (baseline.py:209-213); lr scaled up with the shapes
        optimizer = torch.optim.Adam(model.parameters(), 1e-2, weight_decay=1e-5,
                                     amsgrad=True)
        losses = []
        for _ in range(3):
            inputs, labels = to_inputs(batch["image"]), to_inputs(batch["label"])
            optimizer.zero_grad()
            outputs = model(inputs)
            loss = loss_function(outputs, labels)
            loss.backward()
            optimizer.step()
            losses.append(loss.item())
        return losses

    jmodel = JUNet(**kw)
    model = UNet(**kw, device=CPU)
    model.load_state_dict(jmodel.state_dict())
    loss_function = DiceLoss(to_onehot_y=False, sigmoid=True, squared_pred=True)
    got = loop(model.to(CPU), loss_function, lambda t: t.to(CPU))
    want = loop(jmodel, JDiceLoss(to_onehot_y=False, sigmoid=True, squared_pred=True),
                lambda t: t.numpy())
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert got[-1] < got[0]


def test_gd_family_runs_verbatim(tmp_path):
    """The learnable-layer (GD) script family, line-shaped on
    ``gibbs0p7_layer_domain_GD.py:192-298,307-346,383-386``: a user-defined
    ``Gibbs_UNet(nn.Module)`` of the shim's ``GibbsNoiseLayer`` and UNet;
    Adam on ``model.parameters()`` by autograd; ``@torch.no_grad()``
    finite-difference updates that read ``model.gibbs.alpha.clone()`` and
    assign ``model.gibbs.alpha``; validation Dice and
    ``torch.save(model.state_dict())``. Shapes, h and lr scaled for the
    test."""
    import torch.nn as nn

    from mvtb_tpu_torch.compat.stylization_layers import GibbsNoiseLayer

    set_determinism(seed=0)

    class Gibbs_UNet(nn.Module):
        """ResUnet with Gibbs layer (gibbs0p7_layer_domain_GD.py:192-212)"""

        def __init__(self, alpha=None):
            super().__init__()
            self.gibbs = GibbsNoiseLayer(alpha)
            self.ResUnet = UNet(
                dimensions=3,
                in_channels=1,
                out_channels=1,
                channels=(4, 8),
                strides=(2,),
                num_res_units=1,
                device=CPU,
            )

        def forward(self, img):
            img = self.gibbs(img)
            img = self.ResUnet(img)
            return img

    device = torch.device("cpu")
    alpha = 0.7
    model = Gibbs_UNet(alpha).to(device)
    assert model.gibbs.alpha.detach().item() == pytest.approx(0.7)

    loss_function = DiceLoss(to_onehot_y=False, sigmoid=True,
                             squared_pred=True)
    optimizer = torch.optim.Adam(
        model.parameters(), 1e-2, weight_decay=1e-5, amsgrad=True)
    n_params = sum(p.numel() for p in model.parameters() if p.requires_grad)
    assert n_params == sum(p.numel() for p in model.ResUnet.parameters())

    # h and lr scaled up with the 16^3 volume, so the hard mask's radius
    # step h * dist_max crosses k-voxels
    @torch.no_grad()
    def Gibbs_GD(inputs, labels, model, h=0.1, learning_rate=0.2):
        """Function to update Gibbs layer via finite different SG"""
        old_alpha = model.gibbs.alpha.clone()
        outputs_0 = model(inputs)
        loss_0 = loss_function(outputs_0, labels)
        model.gibbs.alpha = old_alpha + h
        outputs_h = model(inputs)
        loss_h = loss_function(outputs_h, labels)
        delta = (loss_h - loss_0) / h
        model.gibbs.alpha = old_alpha - learning_rate * delta
        return loss_0.item(), model.gibbs.alpha.item()

    rng = np.random.RandomState(0)
    batches = [
        {"image": rng.randn(2, 1, 16, 16, 16).astype(np.float32),
         "label": (rng.rand(2, 1, 16, 16, 16) > 0.6).astype(np.float32)}
        for _ in range(2)
    ]

    epoch_loss_values, metric_values, gibbs_values = [], [], []
    best_metric, best_metric_epoch = -1, -1
    for epoch in range(2):
        model.train()
        epoch_loss = 0
        step = 0
        for batch_data in batches:
            gibbs_values.append(model.gibbs.alpha.detach().item())
            step += 1
            inputs, labels = (
                torch.as_tensor(batch_data["image"]).to(device),
                torch.as_tensor(batch_data["label"]).to(device),
            )
            optimizer.zero_grad()
            outputs = model(inputs)
            loss = loss_function(outputs, labels)
            loss.backward()
            optimizer.step()
            epoch_loss += loss.item()
            gibbs_loss, gibbs_alpha = Gibbs_GD(inputs, labels, model)
            gibbs_values.append(gibbs_alpha)
        epoch_loss /= step
        epoch_loss_values.append(epoch_loss)

        model.eval()
        with torch.no_grad():
            dice_metric = DiceMetric(include_background=True,
                                     reduction="mean")
            post_trans = Compose([Activations(sigmoid=True),
                                  AsDiscrete(threshold_values=True)])
            metric_sum = 0.0
            metric_count = 0
            for val_data in batches:
                val_inputs, val_labels = (
                    torch.as_tensor(val_data["image"]).to(device),
                    torch.as_tensor(val_data["label"]).to(device),
                )
                val_outputs = post_trans(model(val_inputs))
                value, not_nans = dice_metric(y_pred=val_outputs,
                                              y=val_labels)
                not_nans = not_nans.item()
                metric_count += not_nans
                metric_sum += value.item() * not_nans
            metric = metric_sum / metric_count
            metric_values.append(metric)
            if metric > best_metric:
                best_metric = metric
                best_metric_epoch = epoch + 1
                torch.save(model.state_dict(),
                           os.path.join(tmp_path, "gd_best.pth"))

    assert all(np.isfinite(epoch_loss_values))
    assert epoch_loss_values[-1] <= epoch_loss_values[0]
    assert best_metric_epoch >= 1 and 0.0 <= best_metric <= 1.0
    # the FD routine moved alpha
    assert len(set(np.round(gibbs_values, 6))) >= 2
    np.savetxt(os.path.join(tmp_path, "gibbs_trajectory_test.txt"),
               np.array(gibbs_values))

    torch.save(model.state_dict(), os.path.join(tmp_path, "gd_final.pth"))
    fresh = Gibbs_UNet(model.gibbs.alpha.detach().item())
    # bare torch.load, as the reference's load paths call it
    fresh.load_state_dict(torch.load(os.path.join(tmp_path, "gd_final.pth")))
    x = torch.as_tensor(batches[0]["image"])
    with torch.no_grad():
        torch.testing.assert_close(fresh(x), model(x), rtol=2e-4, atol=1e-5)


def test_domain_template_runs_verbatim(tmp_path):
    """The T2 (institutional-distribution) template, line-shaped on
    ``baseline_domain.py:86-320``: ReCompose pipelines, per-modality JSON
    manifest -> ``partition_dataset`` -> 4x ``CacheDataset`` ->
    ``ConcatDataset`` -> DataLoader, ``WholeTumorTCGA`` labels,
    UNet(1 -> 1) + DiceLoss + Adam by autograd, validation Dice, the best
    checkpoint, ``np.savetxt`` curves. Shapes and lr scaled for the test."""
    import json

    from torch.utils.data import ConcatDataset

    from mvtb_tpu_torch.compat.filters_and_operators import WholeTumorTCGA
    from mvtb_tpu_torch.compat.monai.transforms import (AddChanneld, RandFlipd,
                                                        RandScaleIntensityd,
                                                        RandShiftIntensityd, RandSpatialCropd)
    from mvtb_tpu_torch.compat.utils import ReCompose
    from mvtb_tpu_torch.data.synthetic import build_tcga_tree

    set_determinism(seed=0)
    root_dir = str(tmp_path)
    build_tcga_tree(root_dir, n_per_modality=3, spatial=(24, 24, 12),
                    affine=np.diag([1.5, 1.5, 2.0, 1.0]))

    JOB_NAME = "baseline_model_sourceDist_4mods_WT"
    working_dir = os.path.join(root_dir, JOB_NAME)
    try:
        os.mkdir(working_dir)
    except Exception:
        JOB_NAME = JOB_NAME + "_2"
        working_dir = os.path.join(root_dir, JOB_NAME)
        os.mkdir(working_dir)

    train_transform = ReCompose([
        LoadImaged(keys=["image", "label"]),
        AddChanneld(keys="image"),
        WholeTumorTCGA(keys="label"),
        Spacingd(keys=["image", "label"], pixdim=(1.5, 1.5, 2.0),
                 mode=("bilinear", "nearest")),
        Orientationd(keys=["image", "label"], axcodes="RAS"),
        RandSpatialCropd(keys=["image", "label"], roi_size=[16, 16, 8],
                         random_size=False),
        RandFlipd(keys=["image", "label"], prob=0.5, spatial_axis=0),
        NormalizeIntensityd(keys="image", nonzero=True, channel_wise=True),
        RandScaleIntensityd("image", factors=0.1, prob=0.5),
        RandShiftIntensityd("image", offsets=0.1, prob=0.5),
        ToTensord(keys=["image", "label"]),
    ])
    val_transform = ReCompose([
        LoadImaged(keys=["image", "label"]),
        AddChanneld(keys="image"),
        WholeTumorTCGA(keys="label"),
        Spacingd(keys=["image", "label"], pixdim=(1.5, 1.5, 2.0),
                 mode=("bilinear", "nearest")),
        Orientationd(keys=["image", "label"], axcodes="RAS"),
        CenterSpatialCropd(keys=["image", "label"], roi_size=[16, 16, 8]),
        NormalizeIntensityd(keys="image", nonzero=True, channel_wise=True),
        ToTensord(keys=["image", "label"]),
    ])

    with open(os.path.join(root_dir, "train_sequence_by_modality.json")) as f:
        data_seqs_4mods = json.load(f)

    train_seq_flair, val_seq_flair = partition_dataset(
        data_seqs_4mods["FLAIR"], [0.9, 0.1], shuffle=True, seed=0)
    train_seq_t1, val_seq_t1 = partition_dataset(
        data_seqs_4mods["T1"], [0.9, 0.1], shuffle=True, seed=0)
    train_seq_t1gd, val_seq_t1gd = partition_dataset(
        data_seqs_4mods["T1Gd"], [0.9, 0.1], shuffle=True, seed=0)
    train_seq_t2, val_seq_t2 = partition_dataset(
        data_seqs_4mods["T2"], [0.9, 0.1], shuffle=True, seed=0)

    CACHE_NUM = 100
    train_ds = ConcatDataset([CacheDataset(s, train_transform, cache_num=CACHE_NUM)
                              for s in (train_seq_flair, train_seq_t1, train_seq_t1gd,
                                        train_seq_t2)])
    val_ds = ConcatDataset([CacheDataset(s, val_transform, cache_num=50)
                            for s in (val_seq_flair, val_seq_t1, val_seq_t1gd, val_seq_t2)])
    assert len(train_ds) == 8 and len(val_ds) == 4  # 2+1 split per modality

    train_loader = DataLoader(train_ds, batch_size=2, shuffle=True,
                              num_workers=4)
    val_loader = DataLoader(val_ds, batch_size=2, shuffle=False,
                            num_workers=4)

    device = torch.device("cpu")
    model = UNet(dimensions=3, in_channels=1, out_channels=1,
                 channels=(4, 8), strides=(2,), num_res_units=1, device=device).to(device)
    loss_function = DiceLoss(to_onehot_y=False, sigmoid=True,
                             squared_pred=True)
    optimizer = torch.optim.Adam(model.parameters(), 1e-2,
                                 weight_decay=1e-5, amsgrad=True)

    max_epochs = 2
    val_interval = 1
    best_metric, best_metric_epoch = -1, -1
    epoch_loss_values, metric_values = [], []
    for epoch in range(max_epochs):
        model.train()
        epoch_loss = 0
        step = 0
        for batch_data in train_loader:
            step += 1
            inputs, labels = (batch_data["image"].to(device),
                              batch_data["label"].to(device))
            assert inputs.shape[1:] == (1, 16, 16, 8)
            assert set(torch.unique(labels).tolist()) <= {0.0, 1.0}
            optimizer.zero_grad()
            outputs = model(inputs)
            loss = loss_function(outputs, labels)
            loss.backward()
            optimizer.step()
            epoch_loss += loss.item()
        epoch_loss /= step
        epoch_loss_values.append(epoch_loss)

        if (epoch + 1) % val_interval == 0:
            model.eval()
            with torch.no_grad():
                dice_metric = DiceMetric(include_background=True,
                                         reduction="mean")
                post_trans = Compose([Activations(sigmoid=True),
                                      AsDiscrete(threshold_values=True)])
                metric_sum, metric_count = 0.0, 0
                for val_data in val_loader:
                    val_inputs, val_labels = (val_data["image"].to(device),
                                              val_data["label"].to(device))
                    val_outputs = post_trans(model(val_inputs))
                    value, not_nans = dice_metric(y_pred=val_outputs,
                                                  y=val_labels)
                    not_nans = not_nans.item()
                    metric_count += not_nans
                    metric_sum += value.item() * not_nans
                metric = metric_sum / metric_count
                metric_values.append(metric)
                if metric > best_metric:
                    best_metric = metric
                    best_metric_epoch = epoch + 1
                    torch.save(model.state_dict(),
                               os.path.join(working_dir, JOB_NAME + ".pth"))

    np.savetxt(os.path.join(working_dir, f"epoch_loss_values_{JOB_NAME}.txt"),
               np.array(epoch_loss_values))
    np.savetxt(os.path.join(working_dir, f"metric_values_{JOB_NAME}.txt"),
               np.array(metric_values))

    assert epoch_loss_values[-1] <= epoch_loss_values[0]
    assert best_metric_epoch >= 1 and 0.0 <= best_metric <= 1.0
    assert os.path.exists(os.path.join(working_dir, JOB_NAME + ".pth"))
    loaded = np.loadtxt(os.path.join(working_dir, f"epoch_loss_values_{JOB_NAME}.txt"))
    np.testing.assert_allclose(loaded, epoch_loss_values)


def test_spike_layer_facade_composes():
    """The spikes GD family's shape (``spikes11_layer_domain_GD.py:191-224``):
    ``spike_layer`` composes under nn.Module, ``intensity`` is a tensor the
    FD routine reassigns, a fresh RandKSpaceSpikeNoise per forward."""
    import torch.nn as nn

    from mvtb_tpu_torch.compat.stylization_layers import spike_layer

    layer = spike_layer(11.0)
    assert isinstance(layer, nn.Module) and list(layer.parameters()) == []
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 1, 8, 8, 8).astype(np.float32))
    y0 = layer(x)
    assert y0.shape == x.shape and bool(torch.isfinite(y0).all())
    old = layer.intensity.clone()
    layer.intensity = old + 2.0
    assert layer.intensity.item() == pytest.approx(13.0)
    assert layer(x).shape == x.shape


def test_autograd_mechanics():
    """``backward`` fills ``.grad`` on the model's parameters and
    accumulates as autograd does; a manual SGD step changes the next
    forward."""
    model = UNet(dimensions=3, in_channels=2, out_channels=1,
                 channels=(4, 4), strides=(2,), num_res_units=1, device=CPU)
    params = list(model.parameters())
    assert all(p.grad is None for p in params)

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 2, 16, 16, 16).astype(np.float32))
    y = torch.from_numpy((rng.rand(1, 1, 16, 16, 16) > 0.5).astype(np.float32))
    loss_function = DiceLoss(sigmoid=True, squared_pred=True)

    with torch.no_grad():
        out0 = model(x)
    loss_function(model(x), y).backward()
    assert all(p.grad is not None for p in params)
    assert any(float(p.grad.abs().sum()) > 0 for p in params)
    g0 = [p.grad.clone() for p in params]
    loss_function(model(x), y).backward()
    for p, g in zip(params, g0):
        torch.testing.assert_close(p.grad, 2 * g, rtol=1e-5, atol=1e-8)

    with torch.no_grad():
        for p in params:
            p -= 0.1 * p.grad
        assert not torch.allclose(out0, model(x))


def test_jax_shim_state_dict_loads_into_the_port_shim():
    """A checkpoint of the JAX shim's UNet (flax-keyed names) loads into the
    port's shim, directly and inside a composing module, and gives the same
    forward."""
    import torch.nn as nn

    from mvtb_tpu.compat.monai.networks.nets import UNet as JUNet

    kw = dict(dimensions=3, in_channels=2, out_channels=1, channels=(4, 8), strides=(2,),
              num_res_units=1)
    jmodel = JUNet(**kw)
    sd = jmodel.state_dict()
    assert any("/" in k for k in sd)
    model = UNet(**kw, device=CPU)
    model.load_state_dict(sd)
    x = np.random.RandomState(1).randn(2, 2, 16, 16, 8).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jmodel(x)), atol=1e-5)

    class Holder(nn.Module):
        def __init__(self):
            super().__init__()
            self.ResUnet = UNet(**kw, device=CPU)

    holder = Holder()
    holder.load_state_dict({f"ResUnet.{k}": v for k, v in sd.items()})
    with torch.no_grad():
        torch.testing.assert_close(holder.ResUnet(torch.from_numpy(x)), got, rtol=0, atol=0)
