"""The yardstick's arithmetic: UNet operations against torch's own flop
counter, the sliding-window grid, and the plane kernel's work by hand."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops, roofline
from portbench.reference import sliding_window as ref_sw
from portbench.reference.unet import UNet

FULL = dict(in_channels=4, out_channels=3, channels=[16, 32, 64, 128, 256],
            strides=[2, 2, 2, 2], num_res_units=2)


def counted(model_cfg, shape, backward):
    m = UNet(model_cfg["in_channels"], model_cfg["out_channels"], model_cfg["channels"],
             model_cfg["strides"], model_cfg["num_res_units"])
    x = torch.randn(shape)
    with FlopCounterMode(display=False) as fc:
        y = m(x)
        if backward:
            y.sum().backward()
    return fc.get_total_flops()


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("model_cfg,shape", [
    (FULL, (2, 4, 32, 32, 16)),
    (dict(FULL, channels=[8, 16, 32], strides=[2, 2], num_res_units=1), (1, 4, 16, 24, 8)),
])
def test_unet_flops_match_flop_counter(model_cfg, shape, backward):
    want = counted(model_cfg, shape, backward)
    got = flops.unet_flops(model_cfg, shape[2:], batch=shape[0], backward=backward)
    assert got == want


def test_unet_flops_at_the_cells_crop():
    assert flops.unet_flops(FULL, (128, 128, 64)) / 1e9 == pytest.approx(13.32, abs=0.005)
    assert flops.unet_flops(FULL, (128, 128, 64), backward=True) / 1e9 == pytest.approx(
        39.06, abs=0.005)


@pytest.mark.parametrize("spatial,roi,want", [
    ((240, 240, 155), (128, 128, 64), 27),
    ((128, 128, 64), (128, 128, 64), 1),
    ((100, 100, 50), (128, 128, 64), 1),
    ((200, 128, 64), (128, 128, 64), 2),
])
def test_sliding_window_tiles(spatial, roi, want):
    assert flops.sliding_window_tiles(spatial, roi, 0.25) == want
    if all(n >= r for n, r in zip(spatial, roi)):
        assert len(ref_sw.tile_origins(spatial, roi, 0.25)) == want


def test_sliding_window_tiles_match_the_program_grid():
    from mvtb_tpu_torch.eval.sliding_window import _grid_positions

    spatial, roi = (240, 240, 155), (128, 128, 64)
    assert math.prod(len(_grid_positions(n, r, 0.25)) for n, r in zip(spatial, roi)) == 27


def test_plane_work_by_hand():
    # N=2 volumes, H=8 -> 5 half planes each, W=4, D=2: 10 planes of 8 points
    ops, nbytes = roofline.plane_work((2, 8, 4, 2))
    per_plane_fft = 5 * 8 * 3  # 5 n log2 n, n = 8
    assert ops == 10 * 2 * per_plane_fft
    assert nbytes == 4 * 10 * 8 * 4 + 2 * 5 * 4  # re, im in and out; 5 params a row
    ops_w, nbytes_w = roofline.plane_work((2, 8, 4, 2), point_writes=1)
    assert ops_w == ops and nbytes_w == nbytes + 2 * 28


def test_plane_roofline_is_bound_by_bytes_at_the_training_shape():
    t, by = roofline.least_seconds(*roofline.plane_work((64, 128, 128, 64)))
    assert by == "bytes"
    assert t == pytest.approx(4 * 4 * 64 * 65 * 128 * 64 / 3.35e12 + 4 * 5 * 64 / 3.35e12)


def test_stylize_flops():
    assert roofline.stylize_flops((4, 4, 8, 8, 4)) == 16 * 2 * 5 * 256 * 8
