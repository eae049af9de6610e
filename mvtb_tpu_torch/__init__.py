"""PyTorch/CUDA port of mvtb_tpu for NVIDIA Hopper (H100).

The JAX package ``mvtb_tpu`` stays the reference; this package mirrors its
layout (``ops/``, ``transforms/``, ``models/``, ``eval/``, ``train/``,
``data/``, ``experiments/``) so each module's counterpart is easy to find.
It imports ``torch`` and numpy only.

Entry points take ``device=None``, which means ``"cuda"``: with no card
they raise instead of running on the CPU. Pass ``device="cpu"`` explicitly
to run the plain PyTorch versions of the kernels on the CPU.

Ported so far: corrupted-validation inference (``train.seg.seg_eval_step``
on the fused plane kernel, ``csrc/fused_plane.cu``), segmentation training
(``train.seg.train_segmentation`` on the axis-DFT kernels,
``csrc/axis_dft.cu``), the per-volume corruption path (``ops``'
corruption ops, ``transforms``, and the salt & pepper and polar kernels,
``csrc/pointwise.cu``) and the experiment runner's segmentation family
(``experiments``: the registry, ``run`` and the CLI ``python -m
mvtb_tpu_torch.experiments``, over ``train.chunked``,
``train.checkpoint`` and ``data``).
"""

from mvtb_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
__version__ = "0.1.0"
