"""What the study scripts share: their knobs from the environment, the
full-width UNet they train, pools on the device, host clocks that wait for
the card, and best-effort plots."""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.data.synthetic import make_textured_volume
from mvtb_tpu_torch.models import UNet
from mvtb_tpu_torch.train.seg import SegState, create_seg_state, reference_optimizer

# the model every JAX script builds as ``UNet(out_channels=...)``
FULL_UNET = {"channels": (16, 32, 64, 128, 256), "strides": (2, 2, 2, 2),
             "num_res_units": 2}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def ints(text: str) -> Tuple[int, ...]:
    return tuple(int(v) for v in text.split(","))


def floats(text: str) -> list:
    return [float(v) for v in text.split(",") if v]


def words(text: str) -> list:
    return [v for v in text.split(",") if v]


def flag(text: str) -> bool:
    return text == "1"


def env_params(knobs: Dict[str, Tuple[str, Callable]], environ=None) -> dict:
    """``knobs`` maps an environment variable to ``(run's keyword, parser)``;
    returns the keywords of the variables that are set."""
    environ = os.environ if environ is None else environ
    return {param: parse(environ[name]) for name, (param, parse) in knobs.items()
            if name in environ}


def env_main(run: Callable, knobs: Dict[str, Tuple[str, Callable]], argv=None,
             description: str = ""):
    """``main`` of an environment-driven script: ``run`` with the knobs that
    are set, on ``--device`` (the card unless ``--device cpu``)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    return run(device=args.device, **env_params(knobs))


def outdir(name: str) -> str:
    """Where a script writes by default: ``runs_torch/<name>``, never the
    JAX package's ``reports/``."""
    return os.path.join("runs_torch", name)


def seg_state(in_channels: int, out_channels: int, seed: int, device: DeviceLike = None,
              model_dtype: str = "bfloat16", unet: Optional[dict] = None,
              lr: float = 1e-4, weight_decay: float = 1e-5) -> SegState:
    """A UNet initialised from ``seed`` (the caller's generators stay as
    they were) with the reference optimizer: the full width unless ``unet``
    overrides some of ``channels``, ``strides``, ``num_res_units``."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(seed)
        model = UNet(in_channels, out_channels, **{**FULL_UNET, **(unet or {})},
                     device=dev, dtype=DTYPES[model_dtype])
    return create_seg_state(model, reference_optimizer(model.parameters(), lr, weight_decay),
                            device=dev)


def textured_pool(seed: int, n: int, spatial, channels: int = 4,
                  classes: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` textured volumes from ``RandomState(seed)``, stacked
    channel-first: the JAX scripts' pools, element for element."""
    rng = np.random.RandomState(seed)
    vols = [make_textured_volume(rng, channels, tuple(spatial), classes) for _ in range(n)]
    return np.stack([v[0] for v in vols]), np.stack([v[1] for v in vols])


def on(dev: torch.device, *arrays: np.ndarray):
    """numpy arrays as tensors on ``dev``."""
    out = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)
    return out if len(out) > 1 else out[0]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def clock(dev: torch.device) -> float:
    """The host clock once the card has finished what was issued."""
    sync(dev)
    return time.perf_counter()


class ChunkClock:
    """A ``train_chunked`` log that notes the host clock at each chunk's
    line (written right after the chunk's loss is read, so the card is done)
    and forwards the line."""

    def __init__(self, log: Callable[[str], None]):
        self.log = log
        self.marks = [time.perf_counter()]

    def __call__(self, line: str) -> None:
        self.marks.append(time.perf_counter())
        self.log(line)

    def rates(self, batch: int, history: list) -> dict:
        """Seconds, and train vol/s over all chunks and over those after the
        first (which pays first-use costs: kernel builds, cuDNN's choices);
        ``history`` is ``train_chunked``'s, one ``{"step"}`` a chunk."""
        spans = np.diff(self.marks)
        steps = [h["step"] for h in history]
        out = {"train_s": float(spans.sum()),
               "vol_per_s": batch * steps[-1] / float(spans.sum())}
        if len(spans) > 1:
            out["vol_per_s_after_first_chunk"] = (
                batch * (steps[-1] - steps[0]) / float(spans[1:].sum()))
        return out


def kernel_launches() -> dict:
    """The hand-written kernels' launches on the card since the process
    started, read from the process's ``launch.*`` counters
    (``utils/profiling.py``); two readings apart give the launches between
    them."""
    from mvtb_tpu_torch.ops.pallas_dft import BODIES
    from mvtb_tpu_torch.utils.profiling import counters

    return {"fused_plane": counters["launch.fused_plane"],
            **{f"axis_dft_{b}": counters[f"launch.axis_dft.{b}"] for b in BODIES},
            "sap": counters["launch.sap"], "polar": counters["launch.polar"]}


def best_effort_plot(draw: Callable, log: Callable[[str], None] = print):
    """Run ``draw()``. Plots are best-effort, as in the JAX scripts: where
    matplotlib is missing (the card's machine has none) or the host is
    headless, one line is logged instead."""
    try:
        return draw()
    except Exception as e:  # noqa: BLE001 - plots are best-effort on a headless host
        log(f"plotting skipped: {e}")
        return None
