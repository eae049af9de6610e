"""Full-state checkpoints over ``torch.save`` (counterpart of
mvtb_tpu/train/checkpoint.py, which wraps orbax).

A checkpoint holds the whole train state: a
:class:`~mvtb_tpu_torch.train.seg.SegState` (or a GAN's
:class:`~mvtb_tpu_torch.train.gan.GANState`), or a dict of them (the GAN
runs' joint ``{"g": ..., "d": ...}``). For each, the model's ``state_dict``
(BatchNorm running averages included), the optimizer's (for
:class:`~mvtb_tpu_torch.train.seg.ReferenceAmsgrad`, each parameter's
``count``, ``mu``, ``nu`` and ``nu_max``) and the step count, so a run can
resume where it stopped. Files hold tensors, numbers, strings, lists and
dicts only, and load with ``torch.load(..., weights_only=True)``.

Layout under ``directory``: ``{step}.pt`` (the state) and ``{step}.json``
(the metrics passed to :meth:`CheckpointManager.save`). Each file is
written to a temporary name and moved into place with ``os.replace``, the
metrics first, so a crash leaves either a whole checkpoint or none. A step
is a checkpoint when its ``.pt`` exists.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Mapping, Optional

import torch

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _payload(state: Any) -> dict:
    if isinstance(state, Mapping):
        return {name: _payload(s) for name, s in state.items()}
    return {"model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step)}


def _load(state: Any, payload: dict) -> None:
    if isinstance(state, Mapping):
        for name, s in state.items():
            _load(s, payload[name])
        return
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = payload["step"]


def _replace_atomically(path: str, write) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class CheckpointManager:
    """Saves and restores the full train state, with orbax's retention.

    Without ``best_metric`` the newest ``max_to_keep`` checkpoints are
    kept. With it, the best ``max_to_keep`` by ``metrics[best_metric]``
    (the largest for ``best_mode="max"``, the smallest for ``"min"``; ties
    go to the newer step), and a checkpoint saved without that metric is
    always kept, as orbax's ``BestN`` does. ``max_to_keep=None`` keeps
    every checkpoint. A manager opened on an existing directory picks up
    its checkpoints and their metrics.

    Saves are synchronous, so :meth:`wait` and :meth:`close` have nothing
    to wait for; they are kept for the JAX package's call sites.
    """

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3,
                 best_metric: Optional[str] = None, best_mode: str = "max"):
        if best_mode not in ("max", "min"):
            raise ValueError(f"best_mode must be 'max' or 'min', got {best_mode!r}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_metric = best_metric
        self.best_mode = best_mode
        self._metrics: Dict[int, Optional[dict]] = {}
        for name in os.listdir(self.directory):
            m = _STEP_FILE.match(name)
            if m:
                step = int(m.group(1))
                meta = self._path(step, "json")
                if os.path.exists(meta):
                    with open(meta) as f:
                        self._metrics[step] = json.load(f)
                else:
                    self._metrics[step] = None

    def _path(self, step: int, ext: str) -> str:
        return os.path.join(self.directory, f"{step}.{ext}")

    def save(self, step: int, state: Any, metrics: Optional[dict] = None) -> bool:
        """Write ``state`` (a train state or a dict of them) as checkpoint ``step``, then drop
        the checkpoints retention no longer keeps. As orbax, a step at or
        below the latest one is not saved, and False is returned."""
        step = int(step)
        latest = self.latest_step
        if latest is not None and step <= latest:
            return False
        metrics = dict(metrics or {})
        if self.best_metric is not None and self.best_metric not in metrics:
            raise KeyError(f"metrics lack the best metric {self.best_metric!r}")

        def write_metrics(tmp):
            with open(tmp, "w") as f:
                json.dump(metrics, f)

        payload = _payload(state)
        _replace_atomically(self._path(step, "json"), write_metrics)
        _replace_atomically(self._path(step, "pt"), lambda tmp: torch.save(payload, tmp))
        self._metrics[step] = metrics
        for old in self._steps_to_remove():
            os.remove(self._path(old, "pt"))
            if os.path.exists(self._path(old, "json")):
                os.remove(self._path(old, "json"))
            del self._metrics[old]
        return True

    def _by_metric(self) -> List[int]:
        """Steps that carry the best metric, worst first (orbax's order:
        a stable sort by the metric, reversed for ``"min"``)."""
        with_metric = [s for s in sorted(self._metrics) if self._metrics[s] is not None]
        return sorted(with_metric, key=lambda s: self._metrics[s][self.best_metric],
                      reverse=self.best_mode == "min")

    def _steps_to_remove(self) -> List[int]:
        steps = sorted(self._metrics)
        n = self.max_to_keep
        if n is None or len(steps) <= n:
            return []
        if self.best_metric is None or n == 0:
            return steps[:len(steps) - n]
        keep = set(self._by_metric()[-n:])
        keep |= {s for s in steps if self._metrics[s] is None}
        return [s for s in steps if s not in keep]

    def _read(self, step: Optional[int]) -> dict:
        """The payload of checkpoint ``step`` (the latest by default), on
        the host: ``load_state_dict`` copies it onto the parameters'
        devices, and torch.optim keeps Adam's step counts on the host."""
        step = self.latest_step if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoint to restore in {self.directory}")
        path = self._path(step, "pt")
        if step not in self._metrics or not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint for step {step} in {self.directory}")
        return torch.load(path, map_location="cpu", weights_only=True)

    def restore(self, state: Any, step: Optional[int] = None) -> Any:
        """Load checkpoint ``step`` (the latest by default) into ``state``
        in place: model parameters, optimizer state and step count, on the
        devices the model already lives on. Returns ``state``."""
        _load(state, self._read(step))
        return state

    def restore_model(self, model: torch.nn.Module, step: Optional[int] = None
                      ) -> torch.nn.Module:
        """Load only the model parameters of checkpoint ``step`` (the latest
        by default) of a single train state into ``model``, whatever
        optimizer the run trained with (what an evaluation needs). Returns
        ``model``."""
        model.load_state_dict(self._read(step)["model"])
        return model

    def all_steps(self) -> List[int]:
        return sorted(self._metrics)

    @property
    def latest_step(self) -> Optional[int]:
        return max(self._metrics, default=None)

    @property
    def best_step(self) -> Optional[int]:
        """The step with the best metric, or the latest step when no
        ``best_metric`` is set."""
        if self.best_metric is None:
            return self.latest_step
        ranked = self._by_metric()
        return ranked[-1] if ranked else None

    def wait(self) -> None:
        pass

    def close(self) -> None:
        pass
