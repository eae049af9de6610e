"""Training SegMamba in chunks, as ``train_chunked_arch`` trains SwinUNETR: a
pool of volumes on the card, K-step chunks of ``train/chunked.py:
make_chunk_fn`` (K ``seg_train_step`` calls: stylize -> model forward and
backward -> Dice loss -> amsgrad), one loss read a chunk, one client,
closed loop; the reference follows the first chunk's K steps.

The loops are ``train_chunked_arch``'s, run from a copy of that module of
this driver's own (loaded by file, so the harness's copy is untouched),
with this kind's model table and weight draw in place of its own: the
port's ``segmamba`` model, the plain reference
``portbench/reference/segmamba.py`` and ``portbench/flops_segmamba.py``;
and a draw that keeps Mamba's published initialisation, which a draw of
every matrix as ``N(0, 1/fan_in)`` and everything else 0 would not (it
would set ``D = 0`` and ``A_log = 0``, and leave the causal convolution's
3-D weights 0).

The port's model module is imported before anything else is done, so a
program without it fails at once.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Tuple

import torch

import mvtb_tpu_torch.models.segmamba  # noqa: F401  (the model this kind measures)
from portbench import flops_segmamba, inputs
from portbench.harness import load_file
from portbench.reference import segmamba as ref_segmamba

# model.kind -> (the port's name for it in build_seg_model, its plain reference,
# its operations per volume)
MODELS = {"SegMamba": ("segmamba", ref_segmamba, flops_segmamba.segmamba_flops)}
DT_RANGE = (1e-3, 1e-1)
DT_FLOOR = 1e-4
A_LOG = ("A_log", "A_b_log", "A_s_log")
D_SKIP = ("D", "D_b", "D_s")


def make_weights(seed: int, shapes: Dict[str, Tuple[int, ...]], device) -> Dict[str, torch.Tensor]:
    """float32 parameters in one draw: the weight of every convolution,
    linear layer and causal ``conv1d`` normal with standard deviation
    1/sqrt(fan in) (a transposed convolution's fan in is its input channels
    times its kernel), except each ``dt_proj.weight``, uniform in ``+-
    R^-1/2``; Mamba's ``A_log = log(1..N)`` on every channel, ``D = 1`` and
    ``dt_proj.bias = softplus^-1(dt)`` with ``dt`` log-uniform in ``[1e-3,
    1e-1]`` floored at 1e-4; LayerNorm scales 1; every other bias 0."""
    g = inputs.generator(seed, device, 2)
    normal = {k: s for k, s in shapes.items()
              if k.endswith("weight") and len(s) in (2, 3, 5) and ".dt_proj" not in k}
    flat = torch.randn(sum(math.prod(s) for s in normal.values()), generator=g, device=device)
    out, i = {}, 0
    for k, s in shapes.items():
        leaf = k.rsplit(".", 1)[-1]
        if k in normal:
            n = math.prod(s)
            fan_in = s[0] if "transp_conv" in k else s[1]
            out[k] = flat[i:i + n].view(s) / math.sqrt(fan_in * math.prod(s[2:]))
            i += n
        elif ".dt_proj" in k and leaf == "weight":
            bound = s[1] ** -0.5
            out[k] = (2 * torch.rand(s, generator=g, device=device) - 1) * bound
        elif ".dt_proj" in k and leaf == "bias":
            lo, hi = (math.log(v) for v in DT_RANGE)
            dt = torch.exp(torch.rand(s, generator=g, device=device) * (hi - lo) + lo)
            dt = dt.clamp_min(DT_FLOOR)
            out[k] = dt + torch.log(-torch.expm1(-dt))
        elif leaf in A_LOG:
            out[k] = torch.log(torch.arange(1, s[1] + 1, dtype=torch.float32,
                                            device=device)).expand(s).clone()
        elif leaf in D_SKIP:
            out[k] = torch.ones(s, device=device)
        elif k.endswith("norm.weight"):
            out[k] = torch.ones(s, device=device)
        else:
            out[k] = torch.zeros(s, device=device)
    return out


_arch = load_file(Path(__file__).with_name("train_chunked_arch.py"),
                  "portbench_driver_train_chunked_arch_for_segmamba")
_arch.MODELS = MODELS
_arch.make_weights = make_weights

make_inputs = _arch.make_inputs
reference_first_steps = _arch.reference_first_steps
upper_readings = _arch.upper_readings
run = _arch.run
