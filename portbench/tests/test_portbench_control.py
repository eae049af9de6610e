"""The control of each cell, the plain reference computed one precision
below the configuration's and put in the program's place, must fail at
least one of the numbers the cell compares; so must each planted fault of
a training cell (a step that averages over half of its batch). At a
test's size on the CPU, and at the cell's own size on the card."""

import pytest
import torch

from portbench import harness
from portbench.calibrate import upper_readings

SMALL = {
    "train.gibbs12p5_fast.b16": {"batch": 2, "pool": 6, "spatial": [32, 32, 16],
                                 "chunk_steps": 3},
    "eval.gibbs12p5_fast.fullvol": {"pool": 2, "spatial": [64, 64, 32], "roi": [32, 32, 16],
                                    "levels": [None, 4.0, 6.0]},
    "stylize.gibbs12p5_fast.fullvol": {"pool": 4, "batch": 2, "spatial": [32, 32, 16],
                                       "check_batches": 2},
}


def failed(ctx, gaps):
    return [k for k, lim in ctx.wl["limits"].items() if not gaps[k] <= lim]


def check(cell, device, seed, overrides=None):
    ctx = harness.Run(harness.HERE.parent, cell, seed, 1.0, False, device, 0.0,
                      {"workload": overrides or {}})
    readings = upper_readings(ctx)
    for side, gaps in readings.items():
        assert failed(ctx, gaps), (side, gaps, ctx.wl["limits"])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails_at_a_small_size(cell):
    check(cell, "cpu", 2 ** 31 + 17, SMALL[cell])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3300000011, 3300000012, 3300000013])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails_at_the_cells_size(cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    check(cell, "cuda", seed)
