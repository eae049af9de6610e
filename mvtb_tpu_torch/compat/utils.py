"""Import-path shim: ``utils`` for the reference scripts and notebooks
(counterpart of mvtb_tpu/compat/utils.py).

Maps the reference's ``source_code/utils.py`` surface (``ReCompose``, the
display helpers, the evaluation harness) to the port. The display
functions draw with matplotlib; where it does not import they log one line
and draw nothing, as the runner's plots do.
"""

from __future__ import annotations

import logging
from typing import Tuple, Union

import numpy as np
import torch

from mvtb_tpu_torch.data.brats_sweep import BratsValIterDataset  # noqa: F401
from mvtb_tpu_torch.eval import plots as _plots
from mvtb_tpu_torch.eval.harness import ModelEvaluation as model_evaluation  # noqa: F401
from mvtb_tpu_torch.eval.harness import TransformSweep  # noqa: F401
from mvtb_tpu_torch.transforms import ReCompose  # noqa: F401

log = logging.getLogger(__name__)


def _numpy(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def _pyplot():
    """matplotlib's pyplot, or None (logged) where matplotlib does not
    import."""
    if not _plots.available():
        log.warning("matplotlib is not installed: display skipped")
        return None
    import matplotlib.pyplot as plt

    return plt


def WL_to_LH(window: float, level: float) -> Tuple[float, float]:
    """Window/level to low/high display bounds (``utils.py:69-73``)."""
    return level - window / 2, level + window / 2


def show(img, k_space: bool = True) -> None:
    """Display an image, or a k-space log-magnitude (``utils.py:52-66``)."""
    plt = _pyplot()
    if plt is None:
        return
    img = _numpy(img).copy()
    if k_space:
        img = np.log(np.abs(img))
    lo, hi = img.min(), img.max()
    img = (img - lo) / (hi - lo + 1e-5)
    if img.ndim == 3:
        plt.imshow(np.moveaxis(img, 0, -1))
    elif img.ndim == 2:
        plt.imshow(img)


def show_slice_and_fourier(img_2d, level: Union[int, float, None] = None,
                           window: Union[int, float, None] = None,
                           level_f: Union[int, float, None] = None,
                           window_f: Union[int, float, None] = None,
                           title: str = None) -> None:
    """Side-by-side image and log-|FFT| display (``utils.py:76-127``)."""
    img = _numpy(img_2d)
    if img.ndim != 2:
        raise ValueError("Input tensor must have 2 dims")
    plt = _pyplot()
    if plt is None:
        return
    if window is None:
        window = img.max() - img.min()
    if level is None:
        level = window / 2 + img.min()
    low, high = WL_to_LH(window, level)

    plt.figure(figsize=(15, 6))
    plt.suptitle(title or "Image slice and k-space slice")
    plt.subplot(1, 2, 1)
    plt.imshow(img, cmap="gray", vmin=low, vmax=high,
               interpolation="bilinear", origin="lower")
    plt.colorbar()

    k = np.fft.fftshift(np.fft.fft2(img), axes=(-2, -1))
    k = np.log(np.abs(k))
    if np.isneginf(k.min()):
        k[np.isneginf(k)] = 0
    if window_f is None:
        window_f = k.max() - k.min()
    if level_f is None:
        level_f = window_f / 2 + k.min()
    low_f, high_f = WL_to_LH(window_f, level_f)
    plt.subplot(1, 2, 2)
    plt.imshow(k, cmap="gray", vmin=low_f, vmax=high_f,
               interpolation="bilinear", origin="lower")
    plt.colorbar()
    plt.show()
