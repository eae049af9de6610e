"""The port's utilities (mvtb_tpu_torch/utils) against the JAX package's
(mvtb_tpu/utils): the profiler trace, the step timer's summary and the
determinism helper."""

import json
import random

import numpy as np
import pytest
import torch

from mvtb_tpu.utils import StepTimer as JStepTimer
from mvtb_tpu_torch import utils


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with utils.trace(str(logdir), device="cpu"):
        torch.randn(64, 64) @ torch.randn(64, 64)
    with open(logdir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_step_timer_summary_keys_match_jax():
    t, jt = utils.StepTimer(warmup=1, device="cpu"), JStepTimer(warmup=1)
    for timer in (t, jt):
        for _ in range(3):
            with timer:
                torch.ones(8).sum()
    s = t.summary(items_per_step=4)
    assert set(s) == set(jt.summary(items_per_step=4))
    assert s["steps"] == 3 and s["min_s"] <= s["mean_s"]
    assert s["items_per_sec"] == pytest.approx(4 / s["mean_s"])
    assert s["compile_s"] == pytest.approx(t.times[0] - s["mean_s"])
    one = utils.StepTimer(warmup=1, device="cpu")
    with one:
        pass
    assert one.summary()["compile_s"] == 0.0 and one.summary()["steps"] == 1


def test_set_determinism_reproduces_every_stream():
    def draw(gen):
        return (random.random(), np.random.rand(2).tolist(), torch.rand(2).tolist(),
                torch.rand(2, generator=gen).tolist())

    first = draw(utils.set_determinism(7, device="cpu"))
    again = draw(utils.set_determinism(7, device="cpu"))
    other = draw(utils.set_determinism(8, device="cpu"))
    assert first == again and first != other


def test_utils_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: utils.set_determinism(0), lambda: utils.StepTimer(),
                 lambda: utils.trace("unused").__enter__()):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
