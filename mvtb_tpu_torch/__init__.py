"""PyTorch/CUDA port of mvtb_tpu for NVIDIA Hopper (H100).

The JAX package ``mvtb_tpu`` stays the reference; this package mirrors its
layout (``ops/``, ``models/``, ``eval/``, ``train/``) so each module's
counterpart is easy to find. It imports ``torch`` and numpy only.

Entry points take ``device=None``, which means ``"cuda"``: with no card
they raise instead of running on the CPU. Pass ``device="cpu"`` explicitly
to run the plain PyTorch versions of the kernels on the CPU.

Ported so far: corrupted-validation inference — ``ops.fused.stylize_batch``
on the fused plane kernel (``csrc/fused_plane.cu``), ``models.unet3d.UNet``,
``eval.dice`` and ``train.seg.seg_eval_step``.
"""

from mvtb_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
__version__ = "0.1.0"
