"""Minimal MONAI-compatible transform base classes (the port's own copy of
mvtb_tpu/transforms/base.py; nothing here depends on a framework).

The reference builds on MONAI 0.4/0.5's ``Transform`` / ``MapTransform`` /
``Randomizable`` / ``RandomizableTransform`` / ``Compose``. MONAI is not a
dependency here, so this module provides behaviorally-equivalent bases: the
same constructor signatures, the same ``np.random.RandomState`` sampling
semantics (``R.rand() < prob`` gates, ``R.uniform``/``R.randint`` parameter
draws in the same call order), and a ``Compose`` that threads dicts through
the pipeline — so experiment specs written against the reference API rerun
unchanged (SURVEY.md section 1, L2 interface).
"""

from __future__ import annotations

from typing import Any, Callable, Hashable, List, Mapping, Optional, Sequence, Union

import numpy as np

KeysCollection = Union[Hashable, Sequence[Hashable]]


def ensure_tuple(vals) -> tuple:
    """Wrap non-sequences into a 1-tuple; pass sequences through as tuples."""
    if isinstance(vals, (list, tuple)):
        return tuple(vals)
    if isinstance(vals, np.ndarray):
        return tuple(vals.tolist()) if vals.ndim > 0 else (vals.item(),)
    return (vals,)


class Transform:
    """Base callable transform."""

    def __call__(self, data: Any) -> Any:  # pragma: no cover - interface
        raise NotImplementedError


class Randomizable:
    """Carrier of a ``np.random.RandomState`` named ``R`` (MONAI semantics)."""

    R: np.random.RandomState = np.random.RandomState()

    def set_random_state(self, seed: Optional[int] = None,
                         state: Optional[np.random.RandomState] = None) -> "Randomizable":
        if seed is not None:
            self.R = np.random.RandomState(int(seed) % (2 ** 32))
        elif state is not None:
            if not isinstance(state, np.random.RandomState):
                raise TypeError("state must be a np.random.RandomState")
            self.R = state
        else:
            self.R = np.random.RandomState()
        return self

    def randomize(self, data: Any) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class RandomizableTransform(Randomizable, Transform):
    """Probability-gated transform: ``randomize`` draws ``R.rand() < prob``."""

    def __init__(self, prob: float = 1.0, do_transform: bool = True):
        self.prob = min(max(prob, 0.0), 1.0)
        self._do_transform = do_transform

    def randomize(self, data: Any = None) -> None:
        self._do_transform = self.R.rand() < self.prob


class MapTransform(Transform):
    """Dict-based transform over a fixed key set."""

    def __init__(self, keys: KeysCollection, allow_missing_keys: bool = False):
        self.keys = ensure_tuple(keys)
        self.allow_missing_keys = allow_missing_keys
        if not self.keys:
            raise ValueError("keys must be non-empty")

    def key_iterator(self, data: Mapping, *extra_iterables):
        """Yield keys present in ``data`` (zipped with extras when given)."""
        extras = extra_iterables or [[None] * len(self.keys)]
        for key, *rest in zip(self.keys, *extras):
            if key in data:
                yield (key,) + tuple(rest) if extra_iterables else key
            elif not self.allow_missing_keys:
                raise KeyError(f"Key '{key}' missing and allow_missing_keys is False.")

    def __call__(self, data):  # pragma: no cover - interface
        raise NotImplementedError


class Compose(Randomizable, Transform):
    """Sequential pipeline; propagates random state to members."""

    def __init__(self, transforms: Optional[Union[Sequence[Callable], Callable]] = None):
        if transforms is None:
            transforms = []
        self.transforms = ensure_tuple(transforms)

    def set_random_state(self, seed=None, state=None):
        super().set_random_state(seed=seed, state=state)
        for t in self.transforms:
            if isinstance(t, Randomizable):
                t.set_random_state(seed=self.R.randint(2 ** 31))
        return self

    def randomize(self, data=None):
        for t in self.transforms:
            if isinstance(t, Randomizable):
                t.randomize(data)

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data

    def __len__(self):
        return len(self.transforms)


class ReCompose(Compose):
    """``Compose`` + ``append``/``__add__`` to extend a frozen pipeline.

    Mirrors ``source_code/utils.py:132-156``; used to bolt a corruption onto a
    shared preprocessing pipeline per evaluation dataset.
    """

    def append(self, transform: Optional[Callable] = None) -> None:
        if transform is not None:
            self.transforms = tuple(list(self.transforms) + [transform])

    def __add__(self, transforms: Union[Callable, List[Callable]]) -> "ReCompose":
        extra = transforms if isinstance(transforms, list) else [transforms]
        return ReCompose(list(self.transforms) + extra)
