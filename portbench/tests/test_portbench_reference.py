"""The plain reference against the program's CPU path at a tiny size, and
the inputs made from the seed."""

import numpy as np
import pytest
import torch

from portbench import compare, inputs
from portbench.reference import sliding_window as ref_sw
from portbench.reference import train as ref_train
from portbench.reference.dice import hard_dice
from portbench.reference.stylize import disk_lowpass
from portbench.reference.unet import UNet, param_shapes

MODEL = dict(in_channels=4, out_channels=3, channels=[16, 32, 64, 128, 256],
             strides=[2, 2, 2, 2], num_res_units=2)
SPATIAL = (32, 32, 16)


def program_unet(weights):
    from mvtb_tpu_torch.models import UNet as PortUNet

    m = PortUNet(4, 3, device="cpu", dtype=torch.float32)
    m.load_state_dict(weights)
    return m


@pytest.fixture(scope="module")
def data():
    weights = inputs.make_weights(11, param_shapes(MODEL), "cpu")
    images, labels = inputs.textured_pool(11, 4, 4, SPATIAL, "cpu")
    return weights, images, labels


def test_weights_load_into_both_models(data):
    weights = data[0]
    program_unet(weights)
    ref = UNet(4, 3)
    ref.load_state_dict(weights)
    assert sum(w.numel() for w in weights.values()) == 4810074


@pytest.mark.parametrize("backend", ["auto", "dft", "plane"])
@pytest.mark.parametrize("r", [9.0, 12.5, 25.0])
def test_stylized_batch_matches(data, backend, r):
    from mvtb_tpu_torch.ops.fused import StylizeConfig, stylize_batch

    _, images, _ = data
    cfg = StylizeConfig(disk_r=r, disk_prob=1.0, fft_backend=backend)
    got = stylize_batch(images[:2], cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert compare.rel_max_gap(got, disk_lowpass(images[:2], r)) < 1e-5


def test_train_step_matches(data):
    from mvtb_tpu_torch.ops.fused import StylizeConfig
    from mvtb_tpu_torch.train.seg import create_seg_state, reference_optimizer, seg_train_step

    weights, images, labels = data
    model = program_unet(weights)
    state = create_seg_state(model, reference_optimizer(model.parameters(), 1e-4, 1e-5),
                             device="cpu")
    cfg = StylizeConfig(disk_r=12.5, disk_prob=1.0)
    losses = [float(seg_train_step(state, images[2 * s:2 * s + 2], labels[2 * s:2 * s + 2],
                                   cfg, device="cpu")) for s in range(2)]
    batches = [(images[2 * s:2 * s + 2], labels[2 * s:2 * s + 2]) for s in range(2)]
    ref_losses, first, params = ref_train.train_steps(MODEL, weights, batches, 12.5, 1e-4,
                                                      1e-5, "cpu", block=1)
    assert np.allclose(losses, ref_losses, rtol=0, atol=1e-5)
    norms = {k: float(g.norm()) for k, g in first.items()}
    median = float(np.median(list(norms.values())))
    for k, p in model.named_parameters():
        if norms[k] < compare.STILL_LEAF * median:
            continue  # a bias under a normalisation moves by round-off alone
        # Adam moves each element by about lr whatever its gradient's size, so
        # elements with a gradient near eps may differ: compare whole leaves
        moved = (params[k] - weights[k]).norm()
        assert (p.detach() - params[k]).norm() <= 1e-2 * moved, k


def test_sliding_window_logits_and_dice_match(data):
    from mvtb_tpu_torch.eval.harness import ModelEvaluation
    from mvtb_tpu_torch.eval.sliding_window import sliding_window_inference

    weights, images, labels = data
    model = program_unet(weights).eval()
    ref = UNet(4, 3)
    ref.load_state_dict(weights)
    vol = torch.cat([images[:1], images[1:2, :, :, :, :8]], dim=-1)[:, :, :, :, :20]
    lab = torch.cat([labels[:1], labels[1:2, :, :, :, :8]], dim=-1)[:, :, :, :, :20]
    vol = torch.cat([vol, vol[:, :, :8]], dim=2)  # (1, 4, 40, 32, 20): a 2 x 1 x 2 grid
    lab = torch.cat([lab, lab[:, :, :8]], dim=2)
    roi = (32, 32, 16)
    got = sliding_window_inference(vol, roi, model, device="cpu")
    with torch.no_grad():
        want, tiles = ref_sw.infer(vol, roi, ref, 0.25)
    assert tiles.shape[0] == 4
    assert compare.rel_max_gap(got, want) < 1e-5
    ev = ModelEvaluation(model, roi_size=roi, device="cpu")
    dice = ev.dataset_eval_multi([{"image": vol.numpy(), "label": lab.numpy()}])
    assert compare.dice_gap(dice, hard_dice(want, lab)) < 1e-6


def test_same_seed_same_pool_other_seed_other_pool():
    a = inputs.textured_pool(2 ** 31 + 5, 2, 4, (16, 16, 8), "cpu")
    b = inputs.textured_pool(2 ** 31 + 5, 2, 4, (16, 16, 8), "cpu")
    c = inputs.textured_pool(2 ** 31 + 6, 2, 4, (16, 16, 8), "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])


def test_pool_layout():
    images, labels = inputs.textured_pool(3, 3, 4, (32, 32, 16), "cpu")
    assert images.shape == (3, 4, 32, 32, 16) and labels.shape == (3, 3, 32, 32, 16)
    tc, wt, et = labels[:, 0], labels[:, 1], labels[:, 2]
    assert bool((et <= tc).all()) and bool((tc <= wt).all()) and float(wt.sum()) > 0
    assert torch.allclose(images.mean(dim=(2, 3, 4)), torch.zeros(3, 4), atol=1e-5)
    assert torch.allclose(images.std(dim=(2, 3, 4), correction=0), torch.ones(3, 4), atol=1e-4)


def test_weights_same_seed():
    shapes = param_shapes(MODEL)
    a, b = inputs.make_weights(9, shapes, "cpu"), inputs.make_weights(9, shapes, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["ResidualUnit_1.ConvNormAct_0.Conv_0.weight"]
    assert float(w.std()) == pytest.approx(1 / np.sqrt(16 * 27), rel=0.05)


@pytest.mark.cuda
def test_pool_on_the_card_repeats():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = inputs.textured_pool(2 ** 32 + 1, 4, 4, (128, 128, 64), "cuda")
    b = inputs.textured_pool(2 ** 32 + 1, 4, 4, (128, 128, 64), "cuda")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
