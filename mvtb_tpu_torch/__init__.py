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
``csrc/pointwise.cu``), the fused stylization in full (2D and 3D, zero-fill,
the complex path, ``hybrid``), the experiment runner's segmentation and GAN
families (``experiments``: the registry, ``run`` and the CLI ``python -m
mvtb_tpu_torch.experiments``, over ``train.chunked``, ``train.checkpoint``,
``train.gan`` and ``eval.fid``) and the hospital-domain protocol
(``experiments.run_domain_experiment``, with ``eval``'s harness, sliding
window and plots, and ``data``'s NIfTI, preprocessing, loaders and
hospitals over the host's C++ reader and resampler in ``native``),
learnable stylization (``models.layers``' Gibbs and spike layers,
``train.learnable``'s joint and finite-difference steps, and the runner's
learnable kinds), parallelism (``parallel``: the ``(data, model)``
process mesh, multi-process start-up, data- and tensor-parallel train
steps, the H-split k-space stylization and the H-split UNet step with
halo exchanges), serving (``serve``: ``torch.export`` programs and weight
bundles, every hand-written kernel a custom op of ``ops._ops``), the
reference-script shims (``compat``: ``filters_and_operators``,
``stylization_layers``, ``utils`` and ``monai``), ``utils`` (profiler
traces, step timing, determinism) and the study scripts (``examples``: the
JAX package's ``examples/`` scripts, ``python -m
mvtb_tpu_torch.examples.<name>``). Every module of the JAX package has a
counterpart here; ``utils.enable_compilation_cache`` (XLA's cache) and the
JAX shim's numpy ``ArrayTensor`` have none.
"""

from mvtb_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
__version__ = "0.1.0"
