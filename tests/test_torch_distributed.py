"""Multi-process start-up of the port (mvtb_tpu_torch/parallel/distributed.py),
mirroring tests/test_distributed.py: two processes started only through
``MVTB_COORDINATOR`` / ``MVTB_NUM_PROCESSES`` / ``MVTB_PROCESS_ID`` run a
data-parallel step, each loading its own rows, and both see the loss one
process computes over the whole batch."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mvtb_tpu_torch.data.synthetic import make_volume
from mvtb_tpu_torch.models import UNet
from mvtb_tpu_torch.parallel import initialize, process_local_indices
from mvtb_tpu_torch.train import create_seg_state, seg_train_step
from torch_dist_worker import World

GLOBAL_BATCH = 8


def _batch():
    rng = np.random.RandomState(0)  # the same stream everywhere; the rows differ
    vols = [make_volume(rng, 4, (16, 16, 8)) for _ in range(GLOBAL_BATCH)]
    return np.stack([v[0] for v in vols]), np.stack([v[1] for v in vols])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    image, label = _batch()
    return World("env_world", 2, {"image": image, "label": label},
                 tmp_path_factory.mktemp("distributed"), init="env").results()


def test_two_process_cluster_train_step(ranks):
    image, label = _batch()
    torch.manual_seed(0)
    model = UNet(4, 3, (4, 8), (2,), num_res_units=1, device="cpu")
    one = float(seg_train_step(create_seg_state(model, device="cpu"), torch.from_numpy(image),
                               torch.from_numpy(label), device="cpu"))
    assert ranks[0]["loss"] == ranks[1]["loss"]
    assert np.isfinite(ranks[0]["loss"])
    assert abs(ranks[0]["loss"] - one) < 1e-6


def test_processes_load_their_own_rows(ranks):
    for r, res in enumerate(ranks):
        assert res["world"] == 2 and res["backend"] == "gloo"
        assert res["mesh"] == {"data": 2, "model": 1}
        assert res["rows"] == (4 * r, 4 * r + 4)
        assert res["local"] == (4, 4, 16, 16, 8)


@pytest.mark.parametrize("index, count, rows", [(0, 2, (0, 4)), (1, 2, (4, 8)),
                                                (3, 4, (6, 8)), (0, 1, (0, 8))])
def test_process_local_indices(index, count, rows):
    assert process_local_indices(8, index, count) == rows


def test_process_local_indices_needs_an_even_split():
    with pytest.raises(ValueError, match="must divide"):
        process_local_indices(7, 0, 2)


def test_without_a_group_one_process_loads_everything():
    assert not dist.is_initialized()
    assert process_local_indices(8) == (0, 8)


def test_initialize_is_a_no_op_below_two_processes(monkeypatch):
    monkeypatch.delenv("MVTB_NUM_PROCESSES", raising=False)
    monkeypatch.setenv("MVTB_COORDINATOR", "127.0.0.1:1")
    initialize(device="cpu")
    initialize(num_processes=1, device="cpu")
    assert not dist.is_initialized()
