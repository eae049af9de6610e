"""The port's CheckpointManager (mvtb_tpu_torch/train/checkpoint.py): a
full SegState round trip, bit for bit, and orbax's retention and
``best_step`` (the JAX package's CheckpointManager) for the same save and
metric sequences."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtb_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from mvtb_tpu_torch.models import UNet
from mvtb_tpu_torch.train import CheckpointManager, create_seg_state, seg_train_step

SPATIAL = (16, 16, 8)


def _state(seed):
    torch.manual_seed(seed)
    model = UNet(4, 3, (4, 8), (2,), 1, device="cpu")
    return create_seg_state(model, device="cpu")


def _batch(seed):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(2, 4, *SPATIAL).astype(np.float32)),
            torch.from_numpy((rng.rand(2, 3, *SPATIAL) < 0.4).astype(np.float32)))


def test_seg_state_round_trip_is_bit_exact(tmp_path):
    state = _state(0)
    for s in range(2):
        seg_train_step(state, *_batch(s), device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(2, state, {"mean_dice": 0.5})
    # plain torch.load with weights_only=True reads the file
    payload = torch.load(tmp_path / "ckpt" / "2.pt", weights_only=True)
    assert set(payload) == {"model", "optimizer", "step"}

    restored = CheckpointManager(str(tmp_path / "ckpt")).restore(_state(1))
    assert restored.step == state.step == 2
    for (name, p), q in zip(state.model.named_parameters(), restored.model.parameters()):
        assert torch.equal(p, q), name
        a, b = state.optimizer.state[p], restored.optimizer.state[q]
        assert type(b["count"]) is int and b["count"] == a["count"] == 2
        for m in ("mu", "nu", "nu_max"):
            assert b[m].dtype == torch.float32 and torch.equal(a[m], b[m]), (m, name)

    # one more step from each is the same step
    batch = _batch(7)
    loss_a = seg_train_step(state, *batch, device="cpu")
    loss_b = seg_train_step(restored, *batch, device="cpu")
    assert torch.equal(loss_a, loss_b)
    for p, q in zip(state.model.parameters(), restored.model.parameters()):
        assert torch.equal(p, q)
        assert torch.equal(state.optimizer.state[p]["nu_max"], restored.optimizer.state[q]["nu_max"])


METRICS = [0.3, 0.5, 0.1, 0.5, 0.9, 0.2, 0.4]


@pytest.mark.parametrize("best_metric,best_mode", [(None, "max"), ("mean_dice", "max"),
                                                   ("mean_dice", "min")])
@pytest.mark.parametrize("max_to_keep", [1, 2, 3])
def test_retention_and_best_step_match_orbax(tmp_path, best_metric, best_mode, max_to_keep):
    jm = JaxCheckpointManager(str(tmp_path / "jax"), max_to_keep=max_to_keep,
                              best_metric=best_metric, best_mode=best_mode)
    tm = CheckpointManager(str(tmp_path / "torch"), max_to_keep=max_to_keep,
                           best_metric=best_metric, best_mode=best_mode)
    state = _state(0)
    tree = {"a": jnp.zeros(3)}
    for i, v in enumerate(METRICS):
        step = 2 * (i + 1)
        jm.save(step, tree, metrics={"mean_dice": v})
        jm.wait()
        assert tm.save(step, state, metrics={"mean_dice": v})
        assert tm.all_steps() == list(jm._mgr.all_steps()), (step, v)
        assert tm.best_step == jm.best_step and tm.latest_step == jm.latest_step
    # a step at or below the latest kept one is not saved, as orbax skips it
    assert not jm._mgr.should_save(jm.latest_step)
    assert not tm.save(tm.latest_step, state, metrics={"mean_dice": 1.0})
    jm.close()
    # a manager opened on the directory picks up steps and metrics
    again = CheckpointManager(str(tmp_path / "torch"), max_to_keep=max_to_keep,
                              best_metric=best_metric, best_mode=best_mode)
    assert again.all_steps() == tm.all_steps() and again.best_step == tm.best_step
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == sorted(
        f"{s}.{ext}" for s in tm.all_steps() for ext in ("json", "pt"))


def test_restore_with_nothing_saved_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "empty"))
    assert mgr.latest_step is None and mgr.best_step is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state(0))
    mgr.save(3, _state(0))
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state(0), step=5)


def test_best_metric_must_be_in_the_metrics(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "c"), best_metric="mean_dice")
    with pytest.raises(KeyError, match="mean_dice"):
        mgr.save(1, _state(0), metrics={"loss": 0.1})
    assert mgr.all_steps() == []
    with pytest.raises(ValueError, match="best_mode"):
        CheckpointManager(str(tmp_path / "d"), best_mode="median")
