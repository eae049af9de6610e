"""Learning-curve and evaluation plots (counterpart of
mvtb_tpu/eval/plots.py; the reference saves these per run:
``baseline.py:338-374`` loss/Dice curves, per-class Dice panels, and the
results notebooks' model-performance bars).

Host code only. Each function imports matplotlib when it is called, so
importing this module needs no matplotlib; the runner calls them only when
``matplotlib`` can be imported (:func:`available`)."""

from __future__ import annotations

import importlib.util
from typing import Dict, List, Optional, Sequence


def available() -> bool:
    """True when matplotlib can be imported here."""
    return importlib.util.find_spec("matplotlib") is not None


def save_learning_curves(history: Dict, path: str, val_interval: int = 2,
                         title: str = "") -> str:
    """Loss + mean-Dice curves side by side (``baseline.py:338-352``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(12, 6))
    fig.suptitle(title)
    axes[0].set_title("Epoch average Loss")
    axes[0].plot(range(1, len(history["loss"]) + 1), history["loss"], color="red")
    axes[0].set_xlabel("epoch")
    dice = [d["mean"] for d in history.get("dice", [])]
    epochs = history.get("epochs") or [val_interval * (i + 1) for i in range(len(dice))]
    axes[1].set_title("Val mean Dice")
    axes[1].plot(epochs, dice, color="green")
    axes[1].set_xlabel("epoch")
    fig.savefig(path)
    plt.close(fig)
    return path


def save_per_class_curves(history: Dict, path: str,
                          class_names: Sequence[str] = ("TC", "WT", "ET"),
                          title: str = "") -> str:
    """Per-class Dice panels (``baseline.py:354-374``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    dice = history.get("dice", [])
    # honor the model's actual class count (1-channel FLAIR configs have a
    # single per_class entry, not the BraTS (TC, WT, ET) triple)
    n_avail = min(len(d["per_class"]) for d in dice) if dice else 0
    names = list(class_names)[:n_avail] if n_avail < len(class_names) \
        else list(class_names)
    if n_avail == 1 and len(class_names) == 3:
        names = ["label"]
    n = max(len(names), 1)
    fig, axes = plt.subplots(1, n, figsize=(6 * n, 6), squeeze=False)
    axes = axes[0]
    fig.suptitle(title)
    epochs = history.get("epochs") or list(range(1, len(dice) + 1))
    for i, name in enumerate(names):
        vals = [d["per_class"][i] for d in dice]
        axes[i].set_title(f"Val mean Dice {name}")
        axes[i].plot(epochs, vals)
        axes[i].set_xlabel("epoch")
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_model_performance(eval_dicts: Dict[str, Dict], path: str,
                           metric_index: Optional[int] = 0,
                           title: str = "Dice across corruption levels") -> str:
    """Grouped bars: one group per dataset, one bar per model — the
    ``plot_model_performance`` helper of the comparison notebooks
    (``20_results/80_common_evaluations``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    datasets: List[str] = sorted({d for ev in eval_dicts.values() for d in ev})
    models = list(eval_dicts)
    width = 0.8 / max(len(models), 1)
    fig, ax = plt.subplots(figsize=(max(8, 1.5 * len(datasets)), 6))
    xs = np.arange(len(datasets))
    for mi, model in enumerate(models):
        vals = []
        for ds in datasets:
            v = eval_dicts[model].get(ds)
            if isinstance(v, (list, tuple)):
                v = v[metric_index or 0]
            vals.append(float(v) if v is not None else np.nan)
        ax.bar(xs + mi * width, vals, width, label=model)
    ax.set_xticks(xs + width * (len(models) - 1) / 2)
    ax.set_xticklabels(datasets, rotation=30, ha="right")
    ax.set_ylabel("Dice")
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def save_image_grid(images, path: str, nrow: int = 8, title: str = "",
                    normalize: bool = True) -> str:
    """Tile a batch of channel-last (B, H, W, C) images into one PNG — the
    reference's ``vutils.make_grid`` fixed-noise snapshots
    (``dcgan.py:148-151``, ``reconGan_freq.py:162-171``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    arr = np.asarray(images, dtype=np.float32)
    if arr.ndim == 3:
        arr = arr[..., None]
    b, h, w, c = arr.shape
    if normalize:
        lo, hi = arr.min(), arr.max()
        arr = (arr - lo) / (hi - lo + 1e-8)
    rows = -(-b // nrow)
    grid = np.zeros((rows * (h + 2), min(b, nrow) * (w + 2), c), np.float32)
    for i in range(b):
        r, col = divmod(i, nrow)
        grid[r * (h + 2):r * (h + 2) + h, col * (w + 2):col * (w + 2) + w] = arr[i]
    fig, ax = plt.subplots(figsize=(min(b, nrow) * 1.5, rows * 1.5))
    ax.imshow(grid[..., 0] if c == 1 else grid, cmap="gray" if c == 1 else None)
    ax.set_axis_off()
    ax.set_title(title)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path


def save_alpha_trajectory(trajectory: Sequence[float], path: str,
                          title: str = "Gibbs alpha trajectory") -> str:
    """Stylization-parameter trajectory plot (the GD experiments log these
    to ``gibbs_trajectory_*.txt``; ``gibbs0p7_layer_domain_GD.py:386``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(list(trajectory))
    ax.set_xlabel("step")
    ax.set_ylabel("alpha")
    ax.set_title(title)
    fig.savefig(path)
    plt.close(fig)
    return path
