#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mvtb_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

from the root of a checkout. It needs one CUDA card and the CUDA toolkit
(``nvcc``); it exits non-zero, printing no result, without them. Phases, in
order, each fatal on failure:

1. environment: ``nvidia-smi`` name and power limit, torch and CUDA
   versions, the float32 precision flags as set here (TF32 off everywhere,
   so the plain versions are float32-exact references);
2. build: every kernel of the port compiled from ``mvtb_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel), with each kernel's ptxas lines;
3. kernel phase: the fused plane kernel (tensor cores: bf16x3 for
   ``plane``, bf16 for ``plane_fast``) against its plain PyTorch version,
   which computes the same products with float32 ``torch.matmul``, on the
   card, both precision tiers, at (N, H, W, D) = (8, 240, 240, 160),
   (16, 240, 240, 155), (3, 15, 13, 11) and (2, 8, 520, 300) (a plane wider
   than one kernel tile, which takes two scratch buffers), for every stage
   combination of the JAX package's plane tests; relative-of-max error at
   most 5e-5 (``plane``: both sides bf16x3, whose split resolves 2^-17 of an
   element) and 2e-2 (``plane_fast``). Then every matmul-DFT axis kernel
   (r2c, c2c, c2r; lane and sublane; ``highest``, ``high`` and ``default``)
   against its plain version at the views of the train shape (8, 128, 128,
   64), the bench shape (16, 240, 240, 155) and an odd (3, 7, 13, 11), at
   most 1e-5 (``highest``: float32 CUDA cores), 5e-5 (``high``: bf16x3, on
   the tensor cores) and 2e-2 (``default``, tensor cores); at ``high`` each
   kernel's error against a complex128 ``torch.fft`` version (``irfft`` for
   c2r on the half matrix, the real part of ``ifft`` on the full one) at
   most 3x the plain version's, at the train and bench views;
4. slice phase (corrupted-validation inference): a small end-to-end
   reference (``seg_eval_step`` on the card against the same step on the
   CPU, same weights and draws, logits within 1e-4 of their max), then
   ``seg_eval_step`` with the full-width 4,810,074-parameter UNet on a
   2x4x240x240x160 batch under the bench stack (``fft_backend="plane"``);
   it must launch the plane kernel, never call the plain version on a CUDA
   tensor, and give finite logits and a (2, 3) Dice;
5. train phase (segmentation training on ``fft_backend="dft_pallas"``, whose
   axis kernels run at ``high``): the stylized input at 1x4x32^3 on the card
   against the CPU's, the ``highest`` round trip ``rdft_nd_pair`` ->
   ``irdft_nd_real_pair`` on the card against the CPU's, then one
   float32 ``seg_train_step`` with SGD(1.0) on the card against the same
   step on the CPU (given the card's stylized input), repeated 3 times with cuDNN's default algorithm choice
   and 3 times with ``cudnn.deterministic`` (the spread of each printed;
   the deterministic gradients within 1e-4 of the largest one),
   then ``train_segmentation`` for 6 steps at B=2, 4x128x128x64 with the
   full-width UNet in bfloat16, ``reference_optimizer`` and the bench stack;
   it must launch r2c, c2c and c2r 1, 4 and 1 times per step, all at
   ``high`` on the tensor-core body, never call a plain
   version on a CUDA tensor, give a finite loss at every step and change
   the parameters;
6. runner phase (the experiment runner's segmentation family, the
   registry's ``gibbs12p5`` at full width: UNet 16..256 in bf16,
   4x128x128x64 textured volumes; cut in depth to 4 epochs of 8 steps over
   a pool of 8, 2 held-out batches, 1 for the fast profile): the plane
   kernel against its plain version at the fast profile's training shape
   (64, 128, 128, 64) within 2e-2; ``run(chunked=True)`` on the default
   profile (``dft``, batch 2: no hand-written kernel, finite losses and
   Dice, the checkpoints of epochs 2 and 4 kept) and with ``fast=True``
   (``plane_fast``, batch 16: one plane-kernel launch per train step and
   per held-out batch, none of another kernel, no plain version on the
   card); a run killed after 2 epochs and resumed to 4 against an
   uninterrupted one, both with deterministic cuDNN (equal prefix, the
   tail's difference reported and held under the JAX package's 0.15); the
   CLI in a subprocess (one summary JSON line); over one chunk of each
   profile, the host reads that ``torch.cuda.set_sync_debug_mode`` reports
   (its control, the loss read after the chunk, must be reported), the
   host's issue time against the wall time, and from a ``torch.profiler``
   trace the device's busy time, idle share and top kernels; pool
   seconds, train vol/s (chunks alone and with validation), ms per step,
   validation, checkpoint save and restore ms;
7. pointwise kernel phase: the salt & pepper and polar kernels against
   their plain versions at a 4x240x240x155 volume, (3, 7, 13, 11) and 1001
   elements (also through an offset, unaligned view): sap bit-equal at
   p = 0, 0.05 and 0.4, polar within 1e-6 elementwise relative on spectra
   holding 0, -0.0 and denormals; at full size and p = 0.05 the changed,
   pepper and salt shares within 6 sigma, the levels exactly min/2 and
   max/2, the seed dependence, and at p = 0 the changed count equal to the
   count of u == 0;
8. corruption phase (the per-volume corruption path): the dict pipeline
   (disk r=12.5, Gibbs, spikes, wrap 0.5, plane wave on the (55, 55, 30)
   shell, S&P 0.05) on the card against the CPU at 4x32x32x16 (within 1e-4
   of the max), then at 4x240x240x155 on the card, followed by
   ``salt_and_pepper_pallas`` on the same volume and the JAX package's
   ``benchmarks.py:config6`` magnitude-edit tail on its spectrum in three
   strategies (within 1e-5 of the max of each other); one launch of each
   pointwise kernel, none of another kernel, no plain version on the card;
9. fused-rest phase (the rest of the fused stylization): on
   ``dft_pallas``, the 2D stack (Gibbs alpha in [0, 1], disk, wrap, spikes,
   zero-fill p = 0.2, S&P) at 4x1x128x128 on the half spectrum and on the
   complex path (the ``_rfft_eligible`` seam patched), and the 3D stack
   with zero-fill, the data-dependent spike range and the plane wave on the
   complex path at 2x4x128x128x64: each against the same call on the plain
   versions (5e-5 of the max) and against complex128 transforms (at most 3x
   the plain version's error), the launches checked by body, route and tier
   (the full-spectrum r2c and c2r on the complex path); each of those axis
   layouts alone (n = 128, and the full matrices at n = 240), against its
   plain version and complex128, timed beside its bound and its
   ``torch.fft`` call; ``hybrid`` against ``xla`` at 128x128x64 and
   240x240x155 (1e-5 of the max); the 2D stack on ``dft``, card against
   CPU (1e-5 of the max);
10. GAN phase (the GAN family through ``run()`` at the registry's widths:
   128x128 slices, batch 4, DCGAN ngf = ndf = 128, about 92 M parameters,
   ReconGAN nf = 16): ``dcgan`` chunked for 4 epochs of 8 steps with its
   FID and checkpoints every 2 epochs; a run killed after 2 epochs and
   resumed to 4 against an uninterrupted one, with deterministic cuDNN
   (equal prefix, the tail and the FID curve equal); ``recon_gan``,
   ``recon_gan_freq`` and ``gibbs_gan`` chunked for 2 epochs of 8 steps;
   one per-step ``dcgan`` epoch; the CLI with ``--mitigated``; one
   ``dcgan_step`` and one ``recon_gan_step`` (gibbs), card against CPU from
   the same weights and draws, in float64 (gradients within 1e-4 of the
   largest; the float32 spreads reported: these gradients are
   ill-conditioned in float32); no
   hand-written kernel launched (the stylize runs ``auto`` -> ``dft``); per
   kind ms per step, steps/s, FID, checkpoint save and restore ms, and over
   single chunks the host reads, the device's idle share and top kernels;
11. domain phase (the hospital-domain protocol, ``run_domain_experiment``,
   at the registry's full width: 1 -> 1, UNet 16..256, bf16, 128x128x64, 8
   volumes a hospital; cut in depth to 2 epochs of 8 steps):
   ``gibbs15_domain`` as registered (``auto`` -> ``dft``: no hand-written
   launch), ``fast_science(gibbs35_spikes10_sap0p08_domain)`` (one
   ``plane_fast`` launch per train step and per ``StylizedLoader`` batch,
   counted from the loaders) and that entry on ``dft_pallas`` (r2c, c2c, c2r
   1, 4, 1 per stylize, all at ``high``): finite losses, Dice and gap, the
   written files, ms per step, evaluation seconds per hospital, pool
   seconds; card against CPU from the same weights in float32 (disk r = 15
   on ``plane``; each hospital's Dice within 1e-3, one stylized batch within
   5e-5 of the max); sliding-window inference at 240x240x155 (ROI
   128x128x64, overlap 0.25, 27 tiles; ms and volumes/s at B = 1 constant
   and gaussian, B = 2, B = 1 per tile; in float32 ``tile_batch`` 1 against
   8 within 1e-5 of the max and ``low_memory`` both ways equal); the NIfTI
   path: a 10-volume 4x240x240x155 Decathlon tree (written by a second
   process meanwhile), one gzipped volume through the native and the Python
   reader (equal arrays), read and resample ms, and the corruption sweep
   (``BratsValIterDataset``, two corruptions) through ``ModelEvaluation``
   with a full-width 4 -> 3 UNet and the sliding window; whether the native
   library built;
12. learnable phase (learnable stylization through ``run()`` at the
   registry's widths: 1 -> 1, UNet 16..256 in float32, batch 2,
   128x128x64; cut in depth to 3 epochs of 8 steps over a pool of 8): one
   step each of the soft Gibbs layer and the spike layer through
   ``learnable_train_step``, of the hard mask through ``fd_train_step``, and
   of the hard mask at alpha = 0 (an all-zero volume), card against CPU at
   1x1x32^3 with a UNet (8, 16, 32) and deterministic cuDNN (in float64
   the gradients within 1e-4 of the largest and the stylization parameter
   after the step within 1e-6, the float32 spreads reported; at alpha = 0
   in float32, finite, and held with zero conv biases); ``gibbs0p7_layer_grad``,
   ``gibbs0p7_layer_GD`` and ``spikes11_layer_GD`` chunked (finite
   trajectories, no hand-written kernel: the layers run ``torch.fft``, ms a
   step and steps/s); ``gibbs0p7_layer_GD`` killed and resumed against an
   uninterrupted run with deterministic cuDNN (equal prefix and
   trajectory); a per-step ``gibbs0p7_layer_fixed`` epoch; over single
   chunks the host reads (none inside a chunk, the runner's one read after
   it), the device's idle share and top kernels, and the joint step's ms
   with TF32 on (cuDNN's float32 default) and with the autotuner;
   ``ModelEvaluation.from_checkpoint`` with ``gibbs_unet`` and
   ``spikes_unet`` on the runs' checkpoints (a finite Dice);
13. parallel phase (the ``(data, model)`` mesh and the sharded paths;
   the card machine holds one GPU, and NCCL takes one rank a device): the
   data-parallel ``seg_train_step`` on an NCCL world of one at the train
   phase's batch (the full-width UNet in float32, the bench stack on
   ``dft_pallas``, SGD(1.0), deterministic cuDNN) bit-equal to the plain
   step over 2 steps, launching r2c, c2c and c2r 1, 4 and 1 times a step at
   ``high``; ms a step of both, in turns, and the gradient all-reduce's ms.
   Then two gloo ranks sharing the card, in subprocesses (``chip_smoke.py
   --parallel-rank ...``) whose exit codes are fatal: gloo's point-to-point
   send on a CUDA tensor tried in a pair of its own (recorded, not held:
   it fails, so the port's exchanges use collectives), all_reduce (sum,
   min, max), all_gather, all_to_all_single and broadcast on CUDA tensors
   checked, the H-split stylize of a 4x240x240x155 volume under the bench
   stack against ``stylize_kspace`` on the backend the split path resolves
   to (within 1e-4 of the max, no hand-written launch), the JAX package's
   full-volume case (the H-split disk r = 12.5 stylize feeding the H-split
   train step of the full-width UNet at 240x240x160, SGD(1.0)) against the
   one-rank step (loss within 1e-4 relative, gradients within 1e-3 of
   their norm), and a (data 1 x model 2) tensor-parallel step at the train
   phase's batch against the one-rank step (the same bounds); the 2-rank
   times are correctness runs on one shared card, not scaling numbers;
14. serve phase (``mvtb_tpu_torch.serve``: ``torch.export`` programs whose
   kernels run as the custom ops of ``ops/_ops.py``): the served eval
   program ``UNet(stylize_batch(x))`` on ``plane`` at 2x4x240x240x160 with
   the full-width UNet in float32, saved as a batch-polymorphic
   ``ServingBundle`` (weights as inputs) and loaded in a process that
   imports only ``mvtb_tpu_torch.serve`` (no model module may load there),
   served at B = 2 and 1 and with other weights, each within 1e-5 of the
   max of the eager call, one plane launch a served call (counted inside
   the op), the program file smaller than the weights; ``stylize_batch`` on
   ``dft_pallas`` at the bench shape exported on the card (bit-equality
   with eager reported, held to 5e-5 of the max; r2c, c2c, c2r launched 1,
   4, 1 times a call at ``high`` on the tensor-core body); S&P and the
   polar round trip in one program exported on the CPU and moved to the
   card by ``load_fn`` at 4x240x240x155 (S&P bit-equal to its plain
   version, its seed a program input; polar within 1e-6 elementwise; one
   launch each); ``export_sharded_fn`` of the data-sharded UNet forward on
   an NCCL world of one against the plain forward; export, save and load
   seconds, program and weight bytes, served against eager ms (CUDA events,
   median of 5); what the custom-op wrapping costs: the train step and
   ``stylize_batch`` on ``dft_pallas`` with the axis kernels reached through
   the op against the direct launch, in turns, and the host's time per
   small axis call;
15. compat phase, in a process of its own: ``compat.install()`` and the
   reference's ``baseline.py`` training loop verbatim through the bare
   ``monai`` names (``UNet(dimensions=3, ...)`` 16..256 on ``cuda:0``,
   ``DiceLoss(...).backward()``, Adam with amsgrad), 3 steps on a 2-volume
   4x128x128x64 batch from the shim's pipeline over a NIfTI tree, TF32 off
   and deterministic cuDNN; the first step's loss and gradients against the
   same loop on the CPU (within 1e-4 of the max); the ``Gibbs_UNet``
   facade's finite-difference alpha update on the card (alpha moves and is
   not a parameter);
16. timing with CUDA events: the plane kernel, its plain version and
   ``torch.fft`` (fft2 + ifft2 over the same planes: the transform part
   only) at the slice and bench shapes, with the bound at the bf16
   tensor-core rate (3x the FLOP for bf16x3), the achieved rate and the
   share of the bound; each axis kernel at every tier, its plain version,
   the bound at the tier's rate and the share of it, and the ``torch.fft``
   call of the same transform at every view of the train and bench shapes;
   ``stylize_batch`` ms and vol/s on both paths; the eval step's ms and the train step's ms (host clock around steps
   ending in ``torch.cuda.synchronize()``); each pointwise kernel, its
   plain version, the composite torch version and the extrema pass at the
   full volume; the pipeline's ms per volume (host clock) and each
   magnitude-edit strategy's ms.

The last lines are the card's ``nvidia-smi`` line, one ``{"kernels": ...}``
JSON object and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense: HBM bytes/s, float32 CUDA-core and bf16
# tensor-core FLOP/s.
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

# The stage combinations of tests/test_fused_plane.py (JAX package).
FLAG_CASES = [
    dict(disk_r=6.0),
    dict(disk_r=6.0, disk_inside_off=True),
    dict(gibbs_alpha=0.4),
    dict(wrap_alpha=0.25),
    dict(gibbs_alpha=0.3, disk_r=7.0, wrap_alpha=0.75),
    dict(spike=True, spike_range=(10.0, 11.0)),
    dict(spike=True, spike_range=(10.0, 11.0), spike_channel_wise=False),
    dict(plane_axes=(6.0, 5.0, 4.0), plane_intensity=9.0),
    dict(disk_r=12.5, plane_axes=(6.0, 5.0, 4.0), plane_intensity=9.0),
    dict(disk_r=6.0, wrap_alpha=0.5, spike=True, spike_range=(9.0, 10.0),
         plane_axes=(6.0, 5.0, 4.0), plane_intensity=8.0),
    dict(gibbs_alpha=(0.2, 0.5), disk_r=(5.0, 8.0), wrap_alpha=(0.3, 0.8),
         spike=True, spike_range=(9.0, 10.0)),
]
# bench.py's five-stage stack
BENCH_STACK = dict(disk_r=(10.0, 25.0), plane_axes=(55.0, 55.0, 30.0),
                   plane_intensity=14.0, spike=True, spike_range=(12.0, 13.0),
                   wrap_alpha=0.5, sap_p=0.05)
# the same stages scaled to a 32^3 volume
SMALL_STACK = dict(disk_r=(3.0, 6.0), plane_axes=(6.0, 5.0, 4.0),
                   plane_intensity=12.0, spike=True, spike_range=(10.0, 11.0),
                   wrap_alpha=0.5, sap_p=0.05)
# Kernel vs plain, relative to the output's max. Both sides of a tier
# compute the same products but sum them in another float32 order; in
# bf16x3 a split's lo then rounds to a neighbouring bf16 value on some
# elements, a step of 2^-17 of that element, ~8e-6 of the output's max on a
# dominant element (a point write): 5e-5 allows a few such steps. In bf16 a
# whole operand may round to a neighbouring bf16 value (2^-8).
TOL = {"plane": 5e-5, "plane_fast": 2e-2}
KERNEL_SHAPES = [(8, 240, 240, 160), (16, 240, 240, 155), (3, 15, 13, 11), (2, 8, 520, 300)]
# bf16 tensor-core products per Gauss product: bf16x3 (hi.hi + hi.lo + lo.hi)
# for ``plane``, one for ``plane_fast``
TIER_PRODUCTS = {"plane": 3, "plane_fast": 1}
TIER_PEAK = {"plane": "bf16x3 tensor core", "plane_fast": "bf16 tensor core"}
GRAD_REPEATS = 3
# kernel vs a complex128 torch.fft version, at most this multiple of the
# plain version's error (both tiers)
EXACT_RATIO = 3.0
SLICE_SHAPE = (2, 4, 240, 240, 160)
BENCH_SHAPE = (4, 4, 240, 240, 155)
# the registry's default training batch (mvtb_tpu/experiments/registry.py)
TRAIN_SHAPE = (2, 4, 128, 128, 64)
TRAIN_STEPS = 6
# Axis kernel vs plain, relative to the output's max: float32 on both sides
# (another summation order); bf16x3 on both sides, the plane kernel's bound
# and reason (two bf16x3 sums in other float32 orders differ by up to 1.70e-5
# of the max: a split's lo moves to a neighbouring bf16 value); bf16
# operands on both sides.
AXIS_TOL = {"highest": 1e-5, "high": 5e-5, "default": 2e-2}
# card vs CPU of the dft_pallas stylized input at 1x4x32^3, relative to its
# max: the bf16x3 tier on both sides, summed in other float32 orders, so the
# axis kernels' bf16x3 bound (measured 1.355e-5 on an H100; the float32 tier
# held 1e-5 and still does, in the round trip below)
STYLIZE_TOL = AXIS_TOL["high"]
# the tier the dft_pallas path runs, as the JAX package does (Precision.HIGH)
PATH_TIER = "high"
# bf16 tensor-core products per product of the body, per tier (None: float32
# on CUDA cores)
AXIS_PRODUCTS = {"highest": None, "high": 3, "default": 1}
# (N, H, W, D) volumes whose axis-kernel views are checked: B*C of the train
# and bench batches, and an odd one
AXIS_SHAPES = {"train": (8, 128, 128, 64), "bench": (16, 240, 240, 155),
               "odd": (3, 7, 13, 11)}
# kernel launches of one dft_pallas stylize call
LAUNCHES_PER_STEP = {"r2c": 1, "c2c": 4, "c2r": 1}
# the TPU kernel each axis body replaces
AXIS_REPLACES = {"r2c": "mvtb_tpu/ops/pallas_dft.py:116",
                 "c2c": "mvtb_tpu/ops/pallas_dft.py:101",
                 "c2r": "mvtb_tpu/ops/pallas_dft.py:127"}
# the runner phase: the registry's T1 training template at full width, cut
# in depth only (epochs, steps, pool, held-out batches; the fast profile's
# held-out batches hold 16 volumes)
RUNNER_NAME = "gibbs12p5"
RUNNER_EPOCHS, RUNNER_STEPS, RUNNER_POOL = 4, 8, 8
RUNNER_VAL_BATCHES = {"default": 2, "fast": 1}
# the pointwise kernels: one BraTS volume (4 modalities x 240x240x155, also
# the magnitude-edit tail's k-space), an odd shape, and a count that is not a
# multiple of 4 (also checked through an offset view, not 16-byte aligned)
POINTWISE_SHAPES = {"volume": (4, 240, 240, 155), "odd": (3, 7, 13, 11), "ragged": (1001,)}
SAP_P = (0.0, 0.05, 0.4)
POLAR_TOL = 1e-6  # elementwise relative
POINTWISE_REPLACES = {"sap": "mvtb_tpu/ops/pallas_kernels.py:39",
                      "polar": "mvtb_tpu/ops/pallas_kernels.py:53"}
# operations per element counted for the bound, all at the float32
# CUDA-core rate: sap = 10 Philox rounds of 10 integer operations per 4
# elements + the select; polar = the 12 operations of its formula
POINTWISE_OPS = {"sap": 25 + 5, "polar": 12}
POINTWISE_BYTES = {"sap": 8, "polar": 16}
# the per-volume corruption path: one dict volume at full size, and the
# card-vs-CPU reference size
PIPELINE_SHAPE = (4, 240, 240, 155)
PIPELINE_SMALL = (4, 32, 32, 16)
# the magnitude-edit tail of the JAX package's benchmarks.py:config6
EDIT_LOG_INTENSITY = 14.0
EDIT_TOL = 1e-5
# the rest of the fused stylization: the 2D stack of the GAN family's slices
# (Gibbs alpha in [0, 1], disk, wrap, spikes, zero-fill, S&P) and a 3D stack
# with zero-fill, the data-dependent spike range and the plane wave
REST_2D_SHAPE = (4, 1, 128, 128)
REST_3D_SHAPE = (2, 4, 128, 128, 64)
REST_2D_STACK = dict(n_dims=2, gibbs_alpha=(0.0, 1.0), disk_r=(10.0, 30.0),
                     wrap_alpha=(0.3, 0.8), spike=True, spike_range=(9.0, 10.0),
                     zf_p=0.2, sap_p=0.05)
REST_3D_STACK = dict(disk_r=(10.0, 25.0), spike=True, plane_axes=(55.0, 55.0, 30.0),
                     plane_intensity=14.0, wrap_alpha=0.5, zf_p=0.2)
# hybrid vs torch.fft: float32 transforms on both sides, relative to the max
HYBRID_SHAPES = [(1, 4, 128, 128, 64), (1, 4, 240, 240, 155)]
HYBRID_TOL = 1e-5
# card vs CPU of the 2D stack on "dft" (float32 matmuls, TF32 off)
CARD_CPU_TOL = 1e-5
# the GAN phase: the registry's widths (128x128 slices, batch 4, DCGAN
# ngf = ndf = 128, ReconGAN nf = 16), cut in depth only
GAN_KINDS = ("dcgan", "recon_gan", "recon_gan_freq", "gibbs_gan")
GAN_EPOCHS = {"dcgan": 4, "recon_gan": 2, "recon_gan_freq": 2, "gibbs_gan": 2}
GAN_STEPS, GAN_CKPT_EVERY, GAN_POOL = 8, 2, 256
# card vs CPU of one GAN step in float64, gradients relative to the largest
GAN_GRAD_TOL = 1e-4
# the domain phase: the registry's *_domain entries at full width (1 -> 1,
# UNet 16..256, 2 residual units, bf16, batch 2, 128x128x64, 8 volumes a
# hospital), cut in depth only, to 2 epochs of 8 steps
DOMAIN_EPOCHS, DOMAIN_STEPS, DOMAIN_N = 2, 8, 8
DOMAIN_AUTO, DOMAIN_KERNEL = "gibbs15_domain", "gibbs35_spikes10_sap0p08_domain"
# card against CPU: each hospital's hard Dice from the same weights in
# float32 under the disk r = 15 (prob 1) on "plane" (card: the kernel, at
# most 5e-5 of the max from the CPU's plain version); a Dice moves only
# where a logit sits at the threshold, one voxel of a ~50k-voxel tumor
# moving it by ~2e-5
DOMAIN_DICE_TOL = 1e-3
# sliding window at TCGA scale (benchmarks.py config10): 27 tiles a volume
SW_VOLUME, SW_ROI, SW_OVERLAP, SW_TOL = (240, 240, 155), (128, 128, 64), 0.25, 1e-5
SW_CASES = (("b1_const", 1, "constant", 8), ("b1_gauss", 1, "gaussian", 8),
            ("b2_const", 2, "constant", 8), ("b1_const_pertile", 1, "constant", 1))
# the learnable phase: the registry's learnable entries at full width (1 -> 1,
# UNet 16..256, 2 residual units, float32 as the JAX models build it, batch 2,
# 128x128x64), cut in depth only, to 3 epochs of 8 steps over a pool of 8
LEARN_RUNS = ("gibbs0p7_layer_grad", "gibbs0p7_layer_GD", "spikes11_layer_GD")
LEARN_FIXED = "gibbs0p7_layer_fixed"
LEARN_EPOCHS, LEARN_STEPS, LEARN_POOL = 3, 8, 8
LEARN_RESUME_STEPS, LEARN_FIXED_STEPS, LEARN_PROBE_STEPS = 4, 4, 3
# card against CPU, one step at 1x1x32^3 with a UNet (8, 16, 32) in float64:
# the gradients relative to the largest, the stylization parameter after the
# step absolute (amsgrad's first step is +-lr whatever the gradient's size;
# an FD step moves it by 0.02 * (l(a + h) - l(a)) / 0.01)
LEARN_SMALL = dict(channels=(8, 16, 32), strides=(2, 2), num_res_units=2)
LEARN_SMALL_SHAPE = (1, 1, 32, 32, 32)
LEARN_GRAD_TOL, LEARN_STYL_TOL = 1e-4, 1e-6
# the NIfTI path: MONAI's split keeps int(0.2 n) = 2 validation volumes and
# the sweep's half split 1; "smooth" volumes (the textured generator takes
# ~12 s a 4x240x240x155 volume on one host core)
NIFTI_N, NIFTI_SPATIAL = 10, (240, 240, 155)
NIFTI_TREE = (
    "import sys, time\n"
    "from mvtb_tpu_torch.data import build_decathlon_tree, read_nifti, write_nifti\n"
    "t = time.perf_counter()\n"
    "task = build_decathlon_tree(sys.argv[1], n={n}, channels=4, spatial={sp}, kind='smooth',\n"
    "                            gzip_files=False)\n"
    "tree_s = time.perf_counter() - t\n"
    "img, aff = read_nifti(task + '/imagesTr/synth_000.nii', prefer_native=False)\n"
    "write_nifti(task + '/gz_check.nii.gz', img[..., 0], aff)\n"
    "print(tree_s, time.perf_counter() - t - tree_s)\n")


def out(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def _entry(mangled: str) -> str:
    """A kernel's entry name, a template's arguments decoded from the
    mangled name (``axis_tc_kernel<2,1,2,2>``)."""
    t = re.search(r"\d([a-z_]+)I((?:L[a-z]\d+E)+)E", mangled)
    if t is None:
        return mangled
    return f"{t.group(1)}<{','.join(re.findall(r'L[a-z](\d+)E', t.group(2)))}>"


def ptxas_lines(name: str, log: str) -> list:
    """ptxas's registers, spills and register warnings of every kernel in a
    build log, each line led by the kernel's entry name."""
    rows, entry = [], "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = _entry(m.group(1))
        elif "registers" in line or "spill" in line:
            w = re.search(r" in function '(\S+)'", line)
            msg = line.split(":", 1)[-1].strip()
            if w:
                msg = msg.replace(w.group(0), "")
            rows.append(f"ptxas {name} {_entry(w.group(1)) if w else entry}: {msg}")
    return rows


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def cuda_ms(fn, iters: int, warmup: int = 1, host: bool = False):
    """Mean device ms per call over ``iters`` back-to-back calls; with
    ``host``, also the host's ms per call to issue them (where it reaches
    the device time, the calls were host-bound and the device time is an
    upper bound of the kernel's)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    return (ms, host_ms) if host else ms


def graph_ms(fn, iters: int, replays: int = 3) -> float:
    """Mean device ms per call of ``iters`` calls captured in one CUDA graph
    and replayed: the device time alone, without the host's time to issue
    each call (which ``cuda_ms`` includes where the calls are host-bound)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def plane_case(cfg, shape, dev, seed):
    """Kernel inputs for one (N, H, W, D) shape: the half spectrum of a
    random volume and parameters drawn through the port's own path."""
    from mvtb_tpu_torch.ops import dft, fused, fused_plane

    N, H, W, D = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    draws = fused.sample_draws(cfg, (H, W, D), N, 1, generator=g, device=dev)
    flags, *params = fused_plane.plane_params(cfg, (H, W, D), draws, N, 1, dev)
    x = torch.randn(N, H, W, D, generator=g, device=dev)
    k_re, k_im = dft.half_dft_axis(x, 1)
    return (k_re, k_im, (H, W, D), flags, *params)


def plane_bound(shape, backend):
    """(flops, bytes, bound ms, bound_by) of one plane-kernel call: the four
    Gauss contractions (12*W*D*(W+D) flops a plane) times the tier's
    tensor-core products at the bf16 rate; each input, matrix and output
    byte once (the matrices as the tier reads them, 2 bytes a bf16 part)."""
    N, H, W, D = shape
    Hh = H // 2 + 1
    flops = 12.0 * W * D * (W + D) * N * Hh * TIER_PRODUCTS[backend]
    parts = 2 if backend == "plane" else 1
    nbytes = 4.0 * 4 * N * Hh * W * D + 2.0 * parts * (6 * W * W + 6 * D * D) + 4.0 * 9 * N
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BPS
    return flops, nbytes, max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def kernel_phase(dev) -> dict:
    from mvtb_tpu_torch.ops import fused, fused_plane

    worst = {}
    for shape in KERNEL_SHAPES:
        for backend in ("plane", "plane_fast"):
            fast = backend == "plane_fast"
            for i, kw in enumerate(FLAG_CASES):
                cfg = fused.StylizeConfig(**kw, fft_backend=backend)
                args = plane_case(cfg, shape, dev, seed=i)
                got = fused_plane.plane_stylize_half(*args, fast=fast)
                ref = fused_plane.plane_stylize_half_plain(*args, fast=fast)
                torch.cuda.synchronize()
                err = max(rel_err(a, b) for a, b in zip(got, ref))
                check(all(bool(torch.isfinite(a).all()) for a in got),
                      f"non-finite kernel output {shape} {backend} {kw}")
                check(err <= TOL[backend],
                      f"kernel vs plain {shape} {backend} {kw}: {err:.3e} > {TOL[backend]}")
                key = f"{backend} {shape}"
                worst[key] = max(worst.get(key, 0.0), err)
    return worst


def slice_phase(dev) -> dict:
    from mvtb_tpu_torch.models import UNet
    from mvtb_tpu_torch.ops import fused, fused_plane
    from mvtb_tpu_torch.train import seg_eval_step

    torch.manual_seed(0)
    model = UNet(4, 3, device=dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == 4_810_074, f"UNet has {n_params} parameters")

    # small end-to-end reference: the same step on the CPU (plain versions)
    cpu_model = UNet(4, 3, device="cpu").eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    small = fused.StylizeConfig(**SMALL_STACK, fft_backend="plane")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 4, 32, 32, 32, generator=g)
    lab = (torch.rand(1, 3, 32, 32, 32, generator=g) < 0.3).float()
    draws = fused.sample_draws(small, (32, 32, 32), 1, 4, generator=g, device="cpu")
    d_cpu, lo_cpu = seg_eval_step(cpu_model, x, lab, small, draws=draws,
                                  device="cpu", return_logits=True)
    d_gpu, lo_gpu = seg_eval_step(model, x, lab, small, draws=draws,
                                  device=dev, return_logits=True)
    small_err = rel_err(lo_gpu.cpu(), lo_cpu)
    check(small_err <= 1e-4, f"card vs CPU logits at 1x4x32^3: {small_err:.3e}")

    # the main path
    cfg = fused.StylizeConfig(**BENCH_STACK, fft_backend="plane")
    g = torch.Generator(device=dev).manual_seed(2)
    image = torch.randn(SLICE_SHAPE, generator=g, device=dev)
    label = (torch.rand((2, 3) + SLICE_SHAPE[2:], generator=g, device=dev) < 0.3).float()
    plain = fused_plane.plane_stylize_half_plain
    plain_on_card = []

    def watched_plain(k_re, *a, **kw):
        if k_re.is_cuda:
            plain_on_card.append(tuple(k_re.shape))
        return plain(k_re, *a, **kw)

    fused_plane.plane_stylize_half_plain = watched_plain
    try:
        fused_plane.plane_stylize_half.launches = 0
        dice, logits = seg_eval_step(model, image, label, cfg, generator=g,
                                     device=dev, return_logits=True)
        torch.cuda.synchronize()
        launches = fused_plane.plane_stylize_half.launches
    finally:
        fused_plane.plane_stylize_half_plain = plain
    check(launches > 0, "the main path never launched the plane kernel")
    check(not plain_on_card, f"plain version ran on the card: {plain_on_card}")
    check(tuple(dice.shape) == (2, 3), f"dice shape {tuple(dice.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    check(tuple(logits.shape) == (2, 3) + SLICE_SHAPE[2:], "logits shape")

    step_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seg_eval_step(model, image, label, cfg, generator=g, device=dev)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    # the step's two halves on their own, device time
    with torch.no_grad():
        stylize_ms = cuda_ms(lambda: fused.stylize_batch(
            image, cfg, generator=g, device=dev), 3)
        unet_ms = cuda_ms(lambda: model(image), 3)
    return {"unet_params": n_params, "small_ref_logits_rel_err": small_err,
            "stylize_batch_ms": stylize_ms, "unet_forward_ms": unet_ms,
            "launches": launches, "dice": dice.cpu().tolist(),
            "eval_step_ms": [s * 1e3 for s in step_s],
            "eval_step_ms_median": statistics.median(step_s) * 1e3}


def timing_phase(dev) -> dict:
    from mvtb_tpu_torch.ops import fused, fused_plane

    res = {}
    for name, (B, C, H, W, D) in (("slice", SLICE_SHAPE), ("bench", BENCH_SHAPE)):
        shape = (B * C, H, W, D)
        for backend in ("plane", "plane_fast"):
            fast = backend == "plane_fast"
            flops, nbytes, bound_ms, bound_by = plane_bound(shape, backend)
            cfg = fused.StylizeConfig(**BENCH_STACK, fft_backend=backend)
            args = plane_case(cfg, shape, dev, seed=3)
            got = fused_plane.plane_stylize_half(*args, fast=fast)
            ref = fused_plane.plane_stylize_half_plain(*args, fast=fast)
            torch.cuda.synchronize()
            abs_err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
            rel = max(rel_err(a, b) for a, b in zip(got, ref))
            exact = fused_plane.plane_stylize_half_exact(*args)
            kernel_f64 = max(rel_err(a.double(), b) for a, b in zip(got, exact))
            plain_f64 = max(rel_err(a.double(), b) for a, b in zip(ref, exact))
            # the kernel is as accurate as the plain version of its tier
            check(kernel_f64 <= EXACT_RATIO * plain_f64,
                  f"{backend} {name}: kernel vs float64 {kernel_f64:.3e}, "
                  f"plain vs float64 {plain_f64:.3e}")
            del got, ref, exact
            kc = torch.complex(args[0], args[1])
            ms = cuda_ms(lambda: fused_plane.plane_stylize_half(*args, fast=fast), 10)
            res[f"{backend} {name}"] = {
                "shape": list(shape), "ms": ms,
                "plain_ms": cuda_ms(lambda: fused_plane.plane_stylize_half_plain(*args, fast=fast), 5),
                "library_ms_fft2_ifft2_transform_only": cuda_ms(
                    lambda: torch.fft.ifft2(torch.fft.fft2(kc)), 10),
                "gflop": flops / 1e9, "gbytes": nbytes / 1e9,
                "bound_ms": bound_ms, "bound_by": bound_by, "bound_peak": TIER_PEAK[backend],
                # tensor-core flops of the tier (3 products a Gauss product for bf16x3)
                "achieved_tflops": flops / ms / 1e9, "share_of_bound": bound_ms / ms,
                "max_abs_err": abs_err, "max_rel_err": rel,
                "kernel_vs_float64_rel_err": kernel_f64, "plain_vs_float64_rel_err": plain_f64}
            del kc, args
        torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(BENCH_SHAPE, generator=g, device=dev)
    for backend in ("plane", "plane_fast", "dft_pallas"):
        cfg = fused.StylizeConfig(**BENCH_STACK, fft_backend=backend)
        ms = cuda_ms(lambda: fused.stylize_batch(x, cfg, generator=g, device=dev), 5)
        res[f"stylize_batch {backend} bench"] = {"ms": ms, "vol_per_s": BENCH_SHAPE[0] / ms * 1e3}
    return res


def axis_views(shape):
    """Every axis-kernel launch of one ``dft_pallas`` stylize call on a
    (N, H, W, D) volume (``on_path`` True, in the order the path makes
    them), and one view of each orientation that only ``dft_nd``,
    ``idft_nd`` or ``idft_nd_real`` use. Each entry: (on_path, label, body,
    lane, view, matrix kind, n, inverse)."""
    N, H, W, D = shape
    h = D // 2 + 1
    M = N * H * W
    path = [("r2c lane D", "r2c", True, (M, D), "half", D, False),
            ("c2c sub H fwd", "c2c", False, (N, H, W * h), "gauss", H, False),
            ("c2c sub W fwd", "c2c", False, (N * H, W, h), "gauss", W, False),
            ("c2c sub H inv", "c2c", False, (N, H, W * h), "gauss", H, True),
            ("c2c sub W inv", "c2c", False, (N * H, W, h), "gauss", W, True),
            ("c2r lane D", "c2r", True, (M, h), "half_inv", D, True)]
    other = [("r2c sub W", "r2c", False, (N * H, W, D), "full", W, False),
             ("c2c lane D", "c2c", True, (M, D), "gauss", D, False),
             ("c2r sub W", "c2r", False, (N * H, W, h), "full", W, True)]
    return [(True,) + v for v in path] + [(False,) + v for v in other]


def axis_case(body, view, kind, n, inverse, dev, seed):
    from mvtb_tpu_torch.ops import dft, pallas_dft

    g = torch.Generator(device=dev).manual_seed(seed)
    mats = dft.device_mats(kind, n, inverse, dev)
    ins = [torch.randn(view, generator=g, device=dev)
           for _ in range(pallas_dft.ARITY[body][0])]
    return ins, mats


def axis_bound(body, lane, view, mats, precision):
    """(flops, bytes, bound ms, bound_by) of one axis-kernel call: each
    input and matrix read once, each output written once; 2 operations per
    multiply-add over every product of the body, at the float32 CUDA-core
    rate for ``highest``, else at the bf16 tensor-core rate with three bf16
    products a product for bf16x3 (``high``)."""
    from mvtb_tpu_torch.ops import pallas_dft

    n_data, n_mats, n_outs = pallas_dft.ARITY[body]
    n_in, n_out = mats[0].shape
    rows = view[0] if lane else view[0] * view[2]
    flops = 2.0 * n_mats * rows * n_in * n_out
    nbytes = 4.0 * (n_data * rows * n_in + n_mats * n_in * n_out + n_outs * rows * n_out)
    products = AXIS_PRODUCTS[precision]
    if products is None:
        t_ops = flops / F32_FLOPS
    else:
        flops *= products
        t_ops = flops / BF16_FLOPS
    t_bytes = nbytes / HBM_BPS
    return flops, nbytes, max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def axis_library(body, lane, ins, n, inverse):
    """The one ``torch.fft`` call that computes the same transform as an
    axis-kernel call on the path (timed as a yardstick, never used by the
    port), or None."""
    if body == "r2c" and lane:
        return lambda: torch.fft.rfft(ins[0], dim=-1)
    if body == "c2r" and lane:
        z = torch.complex(ins[0], ins[1])
        return lambda: torch.fft.irfft(z, n=n, dim=-1)
    if body == "c2c" and not lane:
        z = torch.complex(ins[0], ins[1])
        fn = torch.fft.ifft if inverse else torch.fft.fft
        return lambda: fn(z, dim=1)
    return None


def axis_exact(body, lane, ins, kind, n, inverse):
    """The complex128 ``torch.fft`` version of an axis-kernel call, as
    float64 tensors: r2c (re, im) by ``rfft`` on the lane's half matrix,
    else ``fft``; c2c (re, im) by ``fft`` (``ifft`` for an inverse); c2r
    (out,) by ``irfft`` to n points on the half matrix, else the real part
    of ``ifft``; each along the transform axis."""
    dim = -1 if lane else 1
    if body == "r2c":
        x = ins[0].double()
        k = torch.fft.rfft(x, dim=dim) if kind == "half" else torch.fft.fft(x, dim=dim)
        return k.real, k.imag
    z = torch.complex(ins[0].double(), ins[1].double())
    if body == "c2r":
        if kind == "half_inv":
            return (torch.fft.irfft(z, n=n, dim=dim),)
        return (torch.fft.ifft(z, dim=dim).real,)
    k = (torch.fft.ifft if inverse else torch.fft.fft)(z, dim=dim)
    return k.real, k.imag


def complex_rel_err(got, ref) -> float:
    """Largest error of the outputs (re, im, or c2r's one) over the
    largest |component| of ``ref``."""
    scale = max(float(b.abs().max()) for b in ref)
    return max(float((a.double() - b).abs().max()) for a, b in zip(got, ref)) / scale


def axis_kernel_phase(dev) -> dict:
    """Every axis kernel against its plain version at every view and tier;
    at the path's tier, every kernel against complex128 at the train and
    bench views (the kernel's error at most EXACT_RATIO times the plain
    version's)."""
    from mvtb_tpu_torch.ops import pallas_dft

    worst, exact = {}, {}
    for name, shape in AXIS_SHAPES.items():
        for i, (_, label, body, lane, view, kind, n, inverse) in enumerate(axis_views(shape)):
            ins, mats = axis_case(body, view, kind, n, inverse, dev, seed=i)
            call = pallas_dft.lane_call if lane else pallas_dft.sub_call
            for precision, tol in AXIS_TOL.items():
                got = call(body, ins, mats, precision)
                ref = pallas_dft.plain(body, lane, ins, mats, precision)
                torch.cuda.synchronize()
                check(all(bool(torch.isfinite(a).all()) for a in got),
                      f"non-finite axis kernel output {name} {label} {precision}")
                err = max(rel_err(a, b) for a, b in zip(got, ref))
                check(err <= tol, f"axis kernel vs plain {name} {label} {precision}: "
                                  f"{err:.3e} > {tol}")
                key = f"{body} {'lane' if lane else 'sublane'} {precision} {name}"
                worst[key] = max(worst.get(key, 0.0), err)
                if precision == PATH_TIER and name != "odd":
                    yard = axis_exact(body, lane, ins, kind, n, inverse)
                    k_err, p_err = complex_rel_err(got, yard), complex_rel_err(ref, yard)
                    check(k_err <= EXACT_RATIO * p_err,
                          f"{name} {label} {precision}: kernel vs complex128 {k_err:.3e}, "
                          f"plain vs complex128 {p_err:.3e}")
                    exact[f"{name} {label}"] = {"kernel": k_err, "plain": p_err}
                    del yard
                del got, ref
            del ins
        torch.cuda.empty_cache()
    return {"max_rel_err": worst, f"vs_complex128_{PATH_TIER}": exact}


def axis_timing(dev) -> dict:
    """Kernel and plain ms with the bound of every path view of the train
    and bench shapes at every tier; the library call and the abs error
    beside each, the library timed once a view."""
    from mvtb_tpu_torch.ops import pallas_dft

    res = {}
    for name in ("train", "bench"):
        for i, (on_path, label, body, lane, view, kind, n, inverse) in enumerate(
                axis_views(AXIS_SHAPES[name])):
            if not on_path:
                continue
            ins, mats = axis_case(body, view, kind, n, inverse, dev, seed=100 + i)
            call = pallas_dft.lane_call if lane else pallas_dft.sub_call
            lib = axis_library(body, lane, ins, n, inverse)
            lib_ms = cuda_ms(lib, 10) if lib is not None else None
            for precision in AXIS_TOL:
                got = call(body, ins, mats, precision)
                ref = pallas_dft.plain(body, lane, ins, mats, precision)
                torch.cuda.synchronize()
                abs_err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
                del got, ref
                flops, nbytes, bound_ms, bound_by = axis_bound(body, lane, view, mats, precision)
                ms, host_ms = cuda_ms(lambda: call(body, ins, mats, precision), 10, host=True)
                res[f"{name} {label} {precision}"] = {
                    "body": body, "view": list(view), "precision": precision,
                    "route": pallas_dft.route(body, precision), "ms": ms, "host_ms": host_ms,
                    "graph_ms": graph_ms(lambda: call(body, ins, mats, precision), 10),
                    "plain_ms": cuda_ms(lambda: pallas_dft.plain(body, lane, ins, mats, precision), 5),
                    "gflop": flops / 1e9, "gbytes": nbytes / 1e9,
                    "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / ms,
                    "bytes_bound_ms": nbytes / HBM_BPS * 1e3,
                    "max_abs_err": abs_err, "library_ms": lib_ms}
            del ins
        torch.cuda.empty_cache()
    return res


def _norm_fed_biases(model):
    """Conv biases that feed an instance norm: the norm subtracts their
    mean, so their exact gradient is 0 and both devices give rounding noise."""
    from mvtb_tpu_torch.models.unet3d import ConvNormAct

    return {f"{name}.{conv}.bias" for name, m in model.named_modules()
            if isinstance(m, ConvNormAct) and not m.conv_only
            for conv in ("Conv_0", "ConvTranspose_0") if hasattr(m, conv)}


def train_phase(dev) -> dict:
    from mvtb_tpu_torch.models import UNet
    from mvtb_tpu_torch.ops import fused, fused_plane, pallas_dft
    from mvtb_tpu_torch.train import (create_seg_state, dice_loss, reference_optimizer,
                                      seg_train_step, train_segmentation)

    # (a) small reference: one float32 SGD(1.0) step, card against CPU
    torch.manual_seed(5)
    model = UNet(4, 3, device=dev)
    cpu_model = UNet(4, 3, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    small = fused.StylizeConfig(**SMALL_STACK, fft_backend="dft_pallas")
    g = torch.Generator().manual_seed(6)
    x = torch.randn(1, 4, 32, 32, 32, generator=g)
    lab = (torch.rand(1, 3, 32, 32, 32, generator=g) < 0.3).float()
    draws = fused.sample_draws(small, (32, 32, 32), 1, 4, generator=g, device="cpu")
    start = {k: v.clone() for k, v in model.state_dict().items()}

    # the stylized input alone, card against CPU, both at the path's bf16x3
    # tier: the axis kernels have no atomics, so the same stylize twice on the
    # card is bit-equal
    styled_cpu = fused.stylize_batch(x, small, draws=draws, device="cpu")
    styled = [fused.stylize_batch(x, small, draws=draws, device=dev) for _ in range(2)]
    check(torch.equal(*styled), "the dft_pallas stylize differs between two card runs")
    stylize_err = rel_err(styled[0].cpu(), styled_cpu)
    check(stylize_err <= STYLIZE_TOL,
          f"card vs CPU stylized input at 1x4x32^3: {stylize_err:.3e} > {STYLIZE_TOL}")
    # the float32 tier keeps the float32 bound: rdft -> irdft round trip
    xd = x.to(dev)
    axes = (2, 3, 4)
    back = pallas_dft.irdft_nd_real_pair(*pallas_dft.rdft_nd_pair(xd, axes, "highest"),
                                         x.shape[2:], axes, "highest")
    back_cpu = pallas_dft.irdft_nd_real_pair(*pallas_dft.rdft_nd_pair(x, axes, "highest"),
                                             x.shape[2:], axes, "highest")
    round_trip_err = rel_err(back.cpu(), back_cpu)
    check(round_trip_err <= 1e-5,
          f"card vs CPU highest rdft -> irdft at 1x4x32^3: {round_trip_err:.3e}")
    del xd, back, back_cpu

    def step_grads(m, d, image=x, cfg=small):
        m.load_state_dict(start)
        st = create_seg_state(m, torch.optim.SGD(m.parameters(), lr=1.0), device=d)
        loss = float(seg_train_step(st, image, lab, cfg, draws=draws, device=d))
        return loss, {k: p.grad.detach().cpu() for k, p in m.named_parameters()}

    # The card runs the whole step, its stylize on the axis kernels; the CPU
    # runs the step on the card's stylized input (bit-equal to what the card's
    # step computes). The two stylizes differ by the bf16x3 tier's summation
    # order (stylize_err above, held to STYLIZE_TOL), which the UNet's
    # gradient amplifies about fifty-fold; the step itself is held here.
    loss_cpu, g_cpu = step_grads(cpu_model, "cpu", styled[0].cpu(), None)
    gmax = max(float(v.abs().max()) for v in g_cpu.values())
    # the same step GRAD_REPEATS times on the card with cuDNN's default
    # algorithm choice, then with deterministic algorithms: the spread of
    # each says whether the card's own runs differ, and by how much
    runs = {}
    for mode in ("default", "deterministic"):
        torch.backends.cudnn.deterministic = mode == "deterministic"
        torch.backends.cudnn.benchmark = False
        try:
            runs[mode] = [step_grads(model, dev) for _ in range(GRAD_REPEATS)]
        finally:
            torch.backends.cudnn.deterministic = False

    def over_max(a, b):  # largest difference over the largest CPU gradient
        return max(float((a[k] - b[k]).abs().max()) for k in b) / gmax

    grad_err = {m: [over_max(g, g_cpu) for _, g in r] for m, r in runs.items()}
    spread = {m: max(over_max(g, r[0][1]) for _, g in r[1:]) for m, r in runs.items()}
    loss_card, g_card = runs["deterministic"][0]
    zero = _norm_fed_biases(model)
    rows, zero_max = [], 0.0  # (error / own max, error / largest gradient, name)
    for k, ref in g_cpu.items():
        err = float((g_card[k] - ref).abs().max())
        rows.append((err / max(float(ref.abs().max()), 1e-30), err / gmax, k))
        if k in zero:
            zero_max = max(zero_max, float(g_card[k].abs().max()) / gmax)
    worst_own = sorted((r for r in rows if r[2] not in zero), reverse=True)[:3]
    # Held to the largest gradient, not to each tensor's own max: a tensor
    # whose whole gradient is small can differ by a large share of its own
    # max. Held with deterministic cuDNN algorithms, whose card runs agree
    # with each other (``card_vs_card_spread_over_max``); the default
    # choice's runs differ from each other and are reported, not held.
    check(max(grad_err["deterministic"]) <= 1e-4,
          f"card vs CPU train-step gradients at 1x4x32^3 (deterministic cuDNN): "
          f"{grad_err['deterministic']}")
    check(zero_max <= 1e-6, f"norm-fed bias gradients not ~0 on the card: {zero_max:.3e}")
    check(abs(loss_card - loss_cpu) <= 1e-5,
          f"train-step losses card {loss_card} cpu {loss_cpu}")
    small_ref = {"stylized_input_rel_err": stylize_err,
                 "highest_round_trip_rel_err": round_trip_err,
                 "grad_err_over_max": grad_err,
                 "card_vs_card_spread_over_max": spread,
                 "worst_tensors_err_over_own_max": worst_own,
                 "norm_fed_bias_grad_over_max": zero_max,
                 "losses": {"cpu": loss_cpu,
                            **{m: [v for v, _ in r] for m, r in runs.items()}}}
    del runs, g_card, g_cpu
    del model, cpu_model

    # (b) the main path: the registry's default training run, bf16 UNet
    torch.manual_seed(7)
    model = UNet(4, 3, device=dev, dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == 4_810_074, f"UNet has {n_params} parameters")
    state = create_seg_state(model, reference_optimizer(model.parameters()), device=dev)
    cfg = fused.StylizeConfig(**BENCH_STACK, fft_backend="dft_pallas")
    g = torch.Generator(device=dev).manual_seed(8)
    B, C = TRAIN_SHAPE[:2]
    batches = [(torch.randn(TRAIN_SHAPE, generator=g, device=dev),
                (torch.rand((B, 3) + TRAIN_SHAPE[2:], generator=g, device=dev) < 0.3).float())
               for _ in range(TRAIN_STEPS)]
    before = [p.detach().clone() for p in model.parameters()]
    stamps = []

    def timed_batches():
        for b in batches:  # each step bracketed by a synchronize
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            yield b

    plain = pallas_dft.plain
    plain_on_card = []

    def watched_plain(body, lane, ins, *a, **kw):
        if ins[0].is_cuda:
            plain_on_card.append((body, tuple(ins[0].shape)))
        return plain(body, lane, ins, *a, **kw)

    pallas_dft.plain = watched_plain
    torch.cuda.reset_peak_memory_stats()
    try:
        for k in pallas_dft.launches:
            pallas_dft.launches[k] = 0
        pallas_dft.tier_launches.clear()
        fused_plane.plane_stylize_half.launches = 0
        losses = train_segmentation(state, timed_batches(), TRAIN_STEPS, cfg,
                                    generator=g, device=dev)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        launches = dict(pallas_dft.launches)
        tier_launches = dict(pallas_dft.tier_launches)
        plane_launches = fused_plane.plane_stylize_half.launches
    finally:
        pallas_dft.plain = plain
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for body, per_step in LAUNCHES_PER_STEP.items():
        check(launches[body] == per_step * TRAIN_STEPS,
              f"{body} launched {launches[body]} times in {TRAIN_STEPS} steps, "
              f"expected {per_step * TRAIN_STEPS}")
        key = (body, pallas_dft.route(body, PATH_TIER), PATH_TIER)
        check(tier_launches.get(key, 0) == launches[body],
              f"{body}: {tier_launches} launches by route and tier, expected all {key}")
    check(all(pallas_dft.route(b, PATH_TIER) == "wgmma" for b in LAUNCHES_PER_STEP),
          "an axis kernel does not run the tensor-core body on the path")
    check(plane_launches == 0, "the train path launched the plane kernel")
    check(not plain_on_card, f"plain version ran on the card: {plain_on_card}")
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(v) for v in losses),
          f"losses {losses}")
    changed = sum(not torch.equal(a, b) for a, b in zip(before, model.parameters()))
    check(changed > 0, "the train steps left every parameter unchanged")
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    del before

    # the step's parts on their own, device time
    image, label = batches[0]
    with torch.no_grad():
        stylize_ms = cuda_ms(lambda: fused.stylize_batch(image, cfg, generator=g, device=dev), 5)

    def fwd_bwd():
        state.optimizer.zero_grad(set_to_none=True)
        dice_loss(model(image), label).backward()

    fwd_bwd_ms = cuda_ms(fwd_bwd, 3)
    opt_ms = cuda_ms(state.optimizer.step, 5)
    return {"small_ref": small_ref,
            "unet_params": n_params, "losses": losses, "launches": launches,
            "launches_by_route_and_tier": {" ".join(k): v for k, v in tier_launches.items()},
            "params_changed": changed, "step_ms": step_ms,
            "step_ms_median_last5": statistics.median(step_ms[1:]),
            "stylize_batch_ms": stylize_ms, "unet_fwd_bwd_ms": fwd_bwd_ms,
            "optimizer_step_ms": opt_ms, "peak_memory_gb": peak_gb}


def _zero_launch_counts():
    from mvtb_tpu_torch.ops import fused_plane, pallas_dft, pallas_kernels

    fused_plane.plane_stylize_half.launches = 0
    for counts in (pallas_dft.launches, pallas_kernels.launches):
        for k in counts:
            counts[k] = 0


def _launch_counts() -> dict:
    from mvtb_tpu_torch.ops import fused_plane, pallas_dft, pallas_kernels

    return {"fused_plane": fused_plane.plane_stylize_half.launches,
            **{f"axis_dft_{k}": v for k, v in pallas_dft.launches.items()},
            **pallas_kernels.launches}


def _runner_rates(res: dict, batch: int, steps: int) -> dict:
    """Train vol/s of one chunked run from its host timing (each chunk
    ends in the loss's host read): over all chunks, over the chunks after
    the first (which pays first-use costs), and over all chunks and
    validations."""
    t = res["timing"]
    chunk, val = t["chunk_s"], t["val_s"]
    return {"pool_s": t["pool_s"], "chunk_ms": [c * 1e3 for c in chunk],
            "val_ms": [v * 1e3 for v in val], "save_ms": [v * 1e3 for v in t["save_s"]],
            "restore_ms": None if t["restore_s"] is None else t["restore_s"] * 1e3,
            "ms_per_step_after_first": statistics.median(chunk[1:]) / steps * 1e3,
            "vol_s_chunks": batch * steps * len(chunk) / sum(chunk),
            "vol_s_chunks_after_first": batch * steps * (len(chunk) - 1) / sum(chunk[1:]),
            "vol_s_with_val": batch * steps * len(chunk) / (sum(chunk) + sum(val))}


def chunk_probe(tag: str, one_chunk, steps: int) -> dict:
    """Over single chunks (``one_chunk(epoch)`` returns the tensor the
    runner reads after it), outside the counted runs: the host reads that
    ``set_sync_debug_mode`` reports (a read of the result after the chunk is
    the detector's control), the host's time to issue a chunk against its
    wall time, and the device's busy time, idle share and top kernels from
    a ``torch.profiler`` trace."""
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    one_chunk(0)  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            result = one_chunk(1)
            n_chunk = len(caught)
            result.cpu()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message).splitlines()[0] for w in caught if "synchroniz" in str(w.message)]
    in_chunk = len([w for w in caught[:n_chunk] if "synchroniz" in str(w.message)])
    check(len(syncs) > in_chunk,
          f"{tag}: set_sync_debug_mode did not report the result's read: {syncs}")
    t0 = time.perf_counter()
    result = one_chunk(2)
    issue_s = time.perf_counter() - t0
    result.cpu()
    wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one_chunk(3).cpu()
    # device work only: a user annotation's range (the optimizer step's
    # record_function) also lands on the device and would count twice
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"host_reads_per_chunk": in_chunk, "steps": steps, "kinds": sorted(set(syncs))[:5],
            "chunk_issue_ms": issue_s * 1e3, "chunk_wall_ms": wall_s * 1e3,
            "device_busy_ms": busy_ms or None,
            "device_idle_share": (1 - busy_ms / (wall_s * 1e3)) if busy_ms else None,
            "top_kernels_ms": [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                               for e in top]}


def runner_phase(dev) -> dict:
    """The experiment runner's segmentation family at the registry's full
    width (UNet 16..256, 2 residual units, bf16; 128x128x64 textured
    volumes), cut in depth only: RUNNER_EPOCHS epochs of RUNNER_STEPS steps
    over a pool of RUNNER_POOL volumes.

    (a) ``run(gibbs12p5, chunked=True)`` on the default profile (``auto``
    -> ``dft``, batch 2): finite losses and Dice, no hand-written kernel,
    the newest checkpoints kept; (b) the same with ``fast=True``
    (``plane_fast``, batch 16): the plane kernel launched once per train
    step and per validation batch, never its plain version on the card,
    and the kernel held to its plain version at the training shape;
    (c) a run killed after 2 epochs and resumed to 4, against an
    uninterrupted run, both with deterministic cuDNN: equal prefix, the
    tail difference reported; (d) the CLI in a subprocess prints one
    summary line; (e) the host reads that ``set_sync_debug_mode`` reports
    over one chunk of each profile."""
    import tempfile

    from mvtb_tpu_torch.experiments import registry, runner
    from mvtb_tpu_torch.ops import fused, fused_plane
    from mvtb_tpu_torch.train import CheckpointManager, make_chunk_fn

    base = registry.get(RUNNER_NAME)
    fast = registry.fast_science(base)
    res = {"config": RUNNER_NAME, "shape": [base.in_channels, *base.spatial],
           "epochs": RUNNER_EPOCHS, "steps_per_epoch": RUNNER_STEPS, "pool": RUNNER_POOL,
           "val_batches": RUNNER_VAL_BATCHES}

    # the plane kernel at the fast profile's training shape, before the path
    B, C = fast.batch_size, fast.in_channels
    shape = (B * C,) + base.spatial
    args = plane_case(fast.train_stylize, shape, dev, seed=50)
    got = fused_plane.plane_stylize_half(*args, fast=True)
    ref = fused_plane.plane_stylize_half_plain(*args, fast=True)
    torch.cuda.synchronize()
    err = max(rel_err(a, b) for a, b in zip(got, ref))
    check(all(bool(torch.isfinite(a).all()) for a in got), "non-finite plane kernel output")
    check(err <= TOL["plane_fast"],
          f"plane_fast kernel vs plain at {shape}: {err:.3e} > {TOL['plane_fast']}")
    flops, nbytes, bound_ms, bound_by = plane_bound(shape, "plane_fast")
    kc = torch.complex(args[0], args[1])
    res["plane_fast_kernel"] = {
        "shape": list(shape), "max_rel_err": err,
        "max_abs_err": max(float((a - b).abs().max()) for a, b in zip(got, ref)),
        "ms": cuda_ms(lambda: fused_plane.plane_stylize_half(*args, fast=True), 10),
        "plain_ms": cuda_ms(lambda: fused_plane.plane_stylize_half_plain(*args, fast=True), 5),
        "library_ms_fft2_ifft2_transform_only": cuda_ms(
            lambda: torch.fft.ifft2(torch.fft.fft2(kc)), 10),
        "bound_ms": bound_ms, "bound_by": bound_by}
    del got, ref, args, kc

    plain = fused_plane.plane_stylize_half_plain
    plain_on_card = []

    def watched_plain(k_re, *a, **kw):
        if k_re.is_cuda:
            plain_on_card.append(tuple(k_re.shape))
        return plain(k_re, *a, **kw)

    def drive(tmp, tag, **kw):
        """One run on the path, its launches counted from zero."""
        _zero_launch_counts()
        out = runner.run(RUNNER_NAME, chunked=True, epochs=kw.pop("epochs", RUNNER_EPOCHS),
                         steps_per_epoch=RUNNER_STEPS, pool=RUNNER_POOL,
                         workdir=f"{tmp}/{tag}", verbose=False, device=dev, **kw)
        torch.cuda.synchronize()
        out["launches"] = _launch_counts()
        h = out["history"]
        check(all(math.isfinite(v) for v in h["loss"]), f"{tag}: losses {h['loss']}")
        check(all(math.isfinite(v) for d in h["dice"] for v in [d["mean"], *d["per_class"]]),
              f"{tag}: Dice {h['dice']}")
        return out

    fused_plane.plane_stylize_half_plain = watched_plain
    with tempfile.TemporaryDirectory() as tmp:
        try:
            # (a) the default profile
            a = drive(tmp, "default", val_batches=RUNNER_VAL_BATCHES["default"])
            check(not any(a["launches"].values()),
                  f"the default profile launched a hand-written kernel: {a['launches']}")
            check(a["history"]["epochs"] == list(range(2, RUNNER_EPOCHS + 1, 2)),
                  f"validation epochs {a['history']['epochs']}")
            kept = CheckpointManager(f"{tmp}/default/ckpt").all_steps()
            check(kept == a["history"]["epochs"], f"checkpoints kept {kept}")
            res["default"] = {"losses": a["history"]["loss"], "dice": a["history"]["dice"],
                              "launches": a["launches"], "checkpoints": kept,
                              **_runner_rates(a, base.batch_size, RUNNER_STEPS)}

            # (b) the fast profile: the plane kernel on every stylize
            b = drive(tmp, "fast", fast=True, val_batches=RUNNER_VAL_BATCHES["fast"])
            want = (RUNNER_EPOCHS * RUNNER_STEPS
                    + len(b["history"]["epochs"]) * RUNNER_VAL_BATCHES["fast"])
            check(b["launches"]["fused_plane"] == want,
                  f"fast profile: {b['launches']} launches, expected {want} of the plane kernel")
            check(sum(b["launches"].values()) == want, f"other kernels launched: {b['launches']}")
            res["fast"] = {"losses": b["history"]["loss"], "dice": b["history"]["dice"],
                           "launches": b["launches"],
                           **_runner_rates(b, fast.batch_size, RUNNER_STEPS)}
        finally:
            fused_plane.plane_stylize_half_plain = plain
        check(not plain_on_card, f"plain version ran on the card: {plain_on_card}")

        # (c) kill after 2 epochs and resume to RUNNER_EPOCHS, deterministic cuDNN
        torch.backends.cudnn.deterministic = True
        try:
            val = RUNNER_VAL_BATCHES["default"]
            full = drive(tmp, "uninterrupted", val_batches=val)
            part = drive(tmp, "resumed", val_batches=val, epochs=2)
            resumed = drive(tmp, "resumed", val_batches=val, resume=True)
        finally:
            torch.backends.cudnn.deterministic = False
        h_full, h_res = full["history"], resumed["history"]
        check(resumed["resumed_from"] == 2, f"resumed from {resumed['resumed_from']}")
        check(h_res["loss"][:2] == part["history"]["loss"], "the resumed prefix changed")
        check(h_res["epochs"] == h_full["epochs"], f"epochs {h_res['epochs']}")
        tail = max(abs(x - y) for x, y in zip(h_res["loss"][2:], h_full["loss"][2:]))
        dice_tail = max(abs(x - y) for d, e in zip(h_res["dice"], h_full["dice"])
                        for x, y in zip(d["per_class"], e["per_class"]))
        param_tail = max(float((p - q).detach().abs().max()) for p, q in zip(
            full["state"].model.parameters(), resumed["state"].model.parameters()))
        # the JAX package's bound on its own resumed tail; the port's is
        # expected to be exact (reported)
        check(tail < 0.15, f"resumed tail loss differs by {tail}")
        res["resume"] = {"prefix_equal": True,
                         "prefix_vs_uninterrupted": max(abs(x - y) for x, y in zip(
                             h_res["loss"][:2], h_full["loss"][:2])),
                         "tail_loss_max_abs_diff": tail, "tail_dice_max_abs_diff": dice_tail,
                         "param_max_abs_diff": param_tail,
                         "restore_ms": resumed["timing"]["restore_s"] * 1e3,
                         "save_ms": [v * 1e3 for v in full["timing"]["save_s"]]}
        del full, part, resumed

        # (d) the CLI, as a user runs it
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "mvtb_tpu_torch.experiments", "run", RUNNER_NAME,
             "--chunked", "--epochs", "2", "--steps", "4", "--pool", str(RUNNER_POOL),
             "--val-batches", str(RUNNER_VAL_BATCHES["default"]), "--quiet",
             "--workdir", f"{tmp}/cli"],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        lines = proc.stdout.splitlines()
        check(len(lines) == 1, f"CLI printed {lines}")
        summary = json.loads(lines[0])
        check(set(summary) == {"best_dice", "wall_time_s"} and math.isfinite(summary["best_dice"]),
              f"CLI summary {summary}")
        res["cli"] = {"summary": summary, "seconds": time.perf_counter() - t0}

    # (e) the host reads, issue and wall time and device busy time over one
    # chunk of each profile
    reads = {}
    for tag, cfg in (("default", base), ("fast", fast)):
        state = runner._seg_state(cfg, 0, dev)
        pool_i, pool_l = runner._pool_arrays(cfg, 0, RUNNER_POOL, dev)
        idxs = torch.randint(0, RUNNER_POOL, (RUNNER_STEPS, cfg.batch_size), device=dev)
        chunk_fn = make_chunk_fn(cfg.train_stylize, dev)

        def one_chunk(epoch):
            return chunk_fn(state, runner.epoch_generator(0, epoch, dev), pool_i, pool_l,
                            idxs)[2]

        reads[tag] = chunk_probe(tag, one_chunk, RUNNER_STEPS)
        del state, pool_i, pool_l
    res["sync_debug"] = reads
    torch.cuda.empty_cache()
    return res


def elementwise_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| / |b| over the elements that differ."""
    d = (a - b).abs()
    return float(torch.where(d == 0, torch.zeros_like(d), d / b.abs().clamp_min(1e-38)).max())


def polar_inputs(shape, dev, seed):
    """(re, im) of a random volume's spectrum with exact 0, -0.0 and
    denormal entries written over its first elements."""
    g = torch.Generator(device=dev).manual_seed(seed)
    k = torch.fft.fftn(torch.randn(shape, generator=g, device=dev))
    re, im = k.real.contiguous(), k.imag.contiguous()
    re.view(-1)[:8] = torch.tensor([0.0, -0.0, 1e-40, 1e-30, -0.0, 1e-39, 3.0, 0.0])
    im.view(-1)[:8] = torch.tensor([0.0, 0.0, 1e-40, 0.0, -0.0, -1e-39, -0.0, -2.0])
    return re, im


def sap_statistics(x: torch.Tensor, out: torch.Tensor, p: float) -> dict:
    """Changed, pepper and salt shares of one S&P output, each held within
    6 sigma of its probability; the levels are exactly min/2 and max/2 and
    every other voxel is the input's."""
    n = x.numel()
    lo, hi = x.min() / 2, x.max() / 2
    changed = out != x
    pepper, salt = int((changed & (out == lo)).sum()), int((changed & (out == hi)).sum())
    n_changed = int(changed.sum())
    check(pepper + salt == n_changed, "a changed voxel is neither min/2 nor max/2")
    check(torch.equal(out[~changed], x[~changed]), "an unchanged voxel differs")
    res = {"changed": n_changed / n, "pepper": pepper / n, "salt": salt / n}
    for key, prob in (("changed", p), ("pepper", p / 2), ("salt", p / 2)):
        sigma = math.sqrt(prob * (1 - prob) / n)
        check(abs(res[key] - prob) <= 6 * sigma,
              f"S&P {key} share {res[key]:.6f}, expected {prob} within 6 sigma ({sigma:.2e})")
        res[f"{key}_sigma"] = sigma
    return res


def pointwise_kernel_phase(dev) -> dict:
    """Both pointwise kernels against their plain versions: sap bit-equal
    at every p, polar within POLAR_TOL elementwise; at full size the S&P
    statistics, the p = 0 rule and the seed dependence."""
    from mvtb_tpu_torch.ops import pallas_kernels as pk

    res = {}
    for name, shape in POINTWISE_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(20)
        x = torch.randn(shape, generator=g, device=dev)
        views = {"": x, " offset": x.reshape(-1)[1:]} if name == "ragged" else {"": x}
        for tag, v in views.items():
            for p in SAP_P:
                got = pk.salt_and_pepper_pallas(v, p, 1234)
                ref = pk.salt_and_pepper_plain(v, p, 1234)
                torch.cuda.synchronize()
                check(torch.equal(got, ref), f"sap kernel vs plain {name}{tag} p={p}: not bit-equal")
            re, im = polar_inputs(v.shape, dev, seed=21)
            got = pk.polar_roundtrip_pallas(re, im)
            ref = pk.polar_roundtrip_plain(re, im)
            torch.cuda.synchronize()
            err = max(elementwise_rel(a, b) for a, b in zip(got, ref))
            check(all(bool(torch.isfinite(a).all()) for a in got), f"non-finite polar output {name}")
            check(err <= POLAR_TOL, f"polar kernel vs plain {name}{tag}: {err:.3e} > {POLAR_TOL}")
            res[f"polar {name}{tag} max_rel_err"] = err
            res[f"polar {name}{tag} max_abs_err"] = max(float((a - b).abs().max())
                                                      for a, b in zip(got, ref))
            del got, ref, re, im

    x = torch.randn(POINTWISE_SHAPES["volume"], generator=torch.Generator(
        device=dev).manual_seed(22), device=dev)
    out = pk.salt_and_pepper_pallas(x, 0.05, 99)
    res["sap volume p=0.05"] = sap_statistics(x, out, 0.05)
    check(torch.equal(out, pk.salt_and_pepper_pallas(x, 0.05, 99)), "same seed, other output")
    check(not torch.equal(out, pk.salt_and_pepper_pallas(x, 0.05, 100)), "other seed, same output")
    zero = pk.salt_and_pepper_pallas(x, 0.0, 99)
    n_u0 = int((pk.sap_uniform(x.numel(), 99, dev) == 0).sum())
    check(int((zero != x).sum()) == n_u0,
          f"p=0 changed {int((zero != x).sum())} voxels, u == 0 at {n_u0}")
    res["sap volume p=0 changed"] = n_u0
    return res


def corruption_pipeline(shape, dev, seed: int):
    """The verify skill's reference recipe widened to the whole dict stack,
    every transform applied (prob=1), seeded through Compose. The plane
    wave's ellipsoid (55, 55, 30) is scaled with the volume; the spike
    transform's per-key draws are seeded by ``common_sampling``."""
    from mvtb_tpu_torch import transforms as T

    H, W, D = shape[1:]
    axes = (55.0 * H / 240, 55.0 * W / 240, 30.0 * D / 155)
    return T.Compose([
        T.RandFourierDiskMaskd(keys="image", r=12.5, prob=1.0, device=dev),
        T.RandGibbsNoised(keys="image", prob=1.0, alpha=(0.2, 0.5), device=dev),
        T.RandKSpaceSpikeNoised(keys="image", prob=1.0, common_sampling=True,
                                common_seed=seed + 1, device=dev),
        T.WrapArtifactd(keys="image", alpha=0.5, device=dev),
        T.RandPlaneWaves_ellipsoid("image", *axes, intensity_value=14.0, prob=1.0,
                                   device=dev),
        T.SaltAndPepper(p=0.05, keys="image", prob=1.0, device=dev),
    ]).set_random_state(seed)


def edit_index(C: int, dev):
    """config6's written points: one per channel at (3, 5, 7)."""
    return (torch.arange(C, device=dev), torch.full((C,), 3, device=dev),
            torch.full((C,), 5, device=dev), torch.full((C,), 7, device=dev))


def corruption_phase(dev) -> dict:
    """The slice's main path: the per-volume dict pipeline at full size, the
    S&P kernel through its entry point on the same volume, and the three
    magnitude-edit strategies on its spectrum (the second through the polar
    kernel). Counts are set to 0 just before and read just after."""
    from mvtb_tpu_torch.ops import fused_plane, pallas_dft, pallas_kernels as pk

    # small end-to-end reference: the same pipeline and seed on the CPU
    g = torch.Generator().manual_seed(30)
    small = torch.randn(PIPELINE_SMALL, generator=g)
    ref = corruption_pipeline(PIPELINE_SMALL, "cpu", 3)({"image": small})["image"]
    got = corruption_pipeline(PIPELINE_SMALL, dev, 3)({"image": small})["image"]
    small_err = rel_err(got.cpu(), ref)
    check(got.is_cuda, "the pipeline's output left the card")
    check(small_err <= 1e-4, f"card vs CPU pipeline at {PIPELINE_SMALL}: {small_err:.3e}")

    # the main path
    g = torch.Generator(device=dev).manual_seed(31)
    image = torch.randn(PIPELINE_SHAPE, generator=g, device=dev)
    pipe = corruption_pipeline(PIPELINE_SHAPE, dev, 4)
    idx = edit_index(PIPELINE_SHAPE[0], dev)
    plains = {n: getattr(pk, n) for n in ("salt_and_pepper_plain", "polar_roundtrip_plain")}
    plain_on_card = []

    def watched(n):
        def call(t, *a, **kw):
            if t.is_cuda:
                plain_on_card.append((n, tuple(t.shape)))
            return plains[n](t, *a, **kw)
        return call

    for n in plains:
        setattr(pk, n, watched(n))
    try:
        for k in pk.launches:
            pk.launches[k] = 0
        for k in pallas_dft.launches:
            pallas_dft.launches[k] = 0
        fused_plane.plane_stylize_half.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        styled = pipe({"image": image})["image"]
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        sap = pk.salt_and_pepper_pallas(image, 0.05, 7)
        k = torch.fft.fftn(image, dim=(-3, -2, -1))
        tails = {s: pk.magnitude_edit(k, idx, EDIT_LOG_INTENSITY, s)
                 for s in pk.EDIT_STRATEGIES}
        torch.cuda.synchronize()
        launches = dict(pk.launches)
        other = dict(pallas_dft.launches, plane=fused_plane.plane_stylize_half.launches)
    finally:
        for n, fn in plains.items():
            setattr(pk, n, fn)
    check(launches == {"sap": 1, "polar": 1}, f"pointwise launches {launches}, expected 1 each")
    check(not any(other.values()), f"the corruption path launched other kernels: {other}")
    check(not plain_on_card, f"plain version ran on the card: {plain_on_card}")
    check(styled.is_cuda and tuple(styled.shape) == PIPELINE_SHAPE, "pipeline output shape")
    check(bool(torch.isfinite(styled).all()), "non-finite pipeline output")
    check(not torch.equal(styled, image), "the pipeline left the volume unchanged")
    sap_stats = sap_statistics(image, sap, 0.05)
    ref_tail = tails["torch_chain"]
    scale = float(ref_tail.abs().max())
    tail_err = {s: float((t - ref_tail).abs().max()) / scale for s, t in tails.items()}
    check(max(tail_err.values()) <= EDIT_TOL, f"magnitude-edit strategies disagree: {tail_err}")
    check(all(bool(torch.isfinite(torch.view_as_real(t)).all()) for t in tails.values()),
          "non-finite magnitude-edit output")
    del styled, sap, tails, ref_tail

    pipe_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe({"image": image})
        torch.cuda.synchronize()
        pipe_s.append(time.perf_counter() - t0)
    # where a pipeline call's time goes: each transform alone, host clock
    stage_ms, d = {}, {"image": image}
    for t in pipe.transforms:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = t(d)
        torch.cuda.synchronize()
        stage_ms[type(t).__name__] = (time.perf_counter() - t0) * 1e3
    del d
    edit_ms = {s: cuda_ms(lambda s=s: pk.magnitude_edit(k, idx, EDIT_LOG_INTENSITY, s), 5)
               for s in pk.EDIT_STRATEGIES}
    return {"small_ref_rel_err": small_err, "launches": launches,
            "sap_entry_point": sap_stats, "edit_rel_err_vs_torch_chain": tail_err,
            "pipeline_first_ms": first_s * 1e3,
            "pipeline_ms_per_volume": [s * 1e3 for s in pipe_s],
            "pipeline_ms_per_volume_median": statistics.median(pipe_s) * 1e3,
            "pipeline_stage_ms": stage_ms,
            "edit_ms": edit_ms}


def pointwise_bound(name: str, n: int):
    flops = float(POINTWISE_OPS[name] * n)
    nbytes = float(POINTWISE_BYTES[name] * n)
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BPS
    return flops, nbytes, max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def pointwise_timing(dev) -> dict:
    """Kernel (wrapper, extrema pass included for sap), plain and composite
    PyTorch ms at the full volume, with the bound. No single PyTorch call
    computes either function, so their ``library_ms`` is null; the
    composite torch version is timed instead (``torch.rand`` + the select;
    ``torch.polar`` of ``exp(log(|k| + 1e-10))`` and ``angle(k)``)."""
    from mvtb_tpu_torch.ops import corruptions, pallas_kernels as pk

    shape = POINTWISE_SHAPES["volume"]
    g = torch.Generator(device=dev).manual_seed(40)
    x = torch.randn(shape, generator=g, device=dev)
    n = x.numel()
    p = torch.tensor(0.05, device=dev)

    def library_sap():
        mn, mx = torch.aminmax(x)
        return corruptions.sap_select(x, torch.rand(shape, generator=g, device=dev), p,
                                      mn / 2, mx / 2)

    res = {}
    flops, nbytes, bound_ms, bound_by = pointwise_bound("sap", n)
    res["sap"] = {"shape": list(shape), "max_abs_err": float(
        (pk.salt_and_pepper_pallas(x, 0.05, 5) - pk.salt_and_pepper_plain(x, 0.05, 5)).abs().max()),
        "ms": cuda_ms(lambda: pk.salt_and_pepper_pallas(x, 0.05, 5), 20),
        "extrema_pass_ms": cuda_ms(lambda: torch.aminmax(x), 20),
        "plain_ms": cuda_ms(lambda: pk.salt_and_pepper_plain(x, 0.05, 5), 3),
        "composite_torch_ms": cuda_ms(library_sap, 10),
        "composite_torch": "torch.rand + aminmax + select",
        "gflop": flops / 1e9, "gbytes": nbytes / 1e9, "bound_ms": bound_ms, "bound_by": bound_by}
    re, im = polar_inputs(shape, dev, seed=41)
    kc = torch.complex(re, im)
    got, ref = pk.polar_roundtrip_pallas(re, im), pk.polar_roundtrip_plain(re, im)
    flops, nbytes, bound_ms, bound_by = pointwise_bound("polar", n)
    res["polar"] = {"shape": list(shape),
                    "max_abs_err": max(float((a - b).abs().max()) for a, b in zip(got, ref)),
                    "max_rel_err": max(elementwise_rel(a, b) for a, b in zip(got, ref)),
                    "ms": cuda_ms(lambda: pk.polar_roundtrip_pallas(re, im), 20),
                    "plain_ms": cuda_ms(lambda: pk.polar_roundtrip_plain(re, im), 10),
                    "composite_torch_ms": cuda_ms(lambda: torch.polar(
                        torch.exp(torch.log(torch.abs(kc) + 1e-10)), torch.angle(kc)), 10),
                    "composite_torch": "torch.polar(exp(log(abs + 1e-10)), angle)",
                    "gflop": flops / 1e9, "gbytes": nbytes / 1e9, "bound_ms": bound_ms,
                    "bound_by": bound_by}
    return res


# --------------------------------------------------------------------------
# The rest of the fused stylization: 2D, zero-fill, the data-dependent spike
# range, the complex path, hybrid
# --------------------------------------------------------------------------

class axis_calls:
    """Context: every axis-kernel call is logged as (body, orientation,
    view, matrix shape, tier); with ``plain=True`` a call on the card runs
    the plain version instead, launching and counting nothing."""

    def __init__(self, plain: bool = False):
        self.plain, self.log = plain, []

    def __enter__(self):
        from mvtb_tpu_torch.ops import pallas_dft

        self._real = pallas_dft._call

        def call(body, lane, ins, mats, precision):
            self.log.append((body, "lane" if lane else "sub", tuple(ins[0].shape),
                             tuple(mats[0].shape), precision))
            if self.plain:
                return pallas_dft.plain(body, lane, ins, mats, precision)
            return self._real(body, lane, ins, mats, precision)

        pallas_dft._call = call
        return self

    def __exit__(self, *exc):
        from mvtb_tpu_torch.ops import pallas_dft

        pallas_dft._call = self._real


class float64_transforms:
    """Context: the general stylize path's transforms in complex128
    ``torch.fft`` (the exact yardstick; the stages keep their arithmetic)."""

    def __enter__(self):
        from mvtb_tpu_torch.ops import fused

        self._saved = fused._forward, fused._inverse

        def forward(x, backend, nd, use_rfft):
            f = torch.fft.rfftn if use_rfft else torch.fft.fftn
            k = f(x.double(), dim=tuple(range(2, 2 + nd)))
            return k.real.contiguous(), k.imag.contiguous()

        def inverse(re, im, spatial, backend, use_rfft):
            k = torch.complex(re.double(), im.double())
            dims = tuple(range(2, 2 + len(spatial)))
            if use_rfft:
                return torch.fft.irfftn(k, s=spatial, dim=dims)
            return torch.fft.ifftn(k, dim=dims).real

        fused._forward, fused._inverse = forward, inverse
        return self

    def __exit__(self, *exc):
        from mvtb_tpu_torch.ops import fused

        fused._forward, fused._inverse = self._saved


class complex_path:
    """Context: the stylize's ``_rfft_eligible`` seam patched to False."""

    def __enter__(self):
        from mvtb_tpu_torch.ops import fused

        self._saved = fused._rfft_eligible
        fused._rfft_eligible = lambda cfg, spatial: False
        return self

    def __exit__(self, *exc):
        from mvtb_tpu_torch.ops import fused

        fused._rfft_eligible = self._saved


def _full_matrix(body: str, mat_shape) -> bool:
    """An r2c or c2r launch on a full-spectrum (n x n) matrix, not a half one."""
    return body in ("r2c", "c2r") and mat_shape[0] == mat_shape[1]


def rest_axis_row(body, lane, view, kind, n, inverse, dev, seed) -> dict:
    """One axis-kernel layout of this slice's paths at ``high``: the kernel
    against its plain version (AXIS_TOL) and against complex128 (at most
    EXACT_RATIO x the plain version's error), its time beside the plain
    version's, its bound and the one torch.fft call of the same transform."""
    from mvtb_tpu_torch.ops import pallas_dft

    ins, mats = axis_case(body, view, kind, n, inverse, dev, seed)
    call = pallas_dft.lane_call if lane else pallas_dft.sub_call
    got = call(body, ins, mats, PATH_TIER)
    ref = pallas_dft.plain(body, lane, ins, mats, PATH_TIER)
    torch.cuda.synchronize()
    err = max(rel_err(a, b) for a, b in zip(got, ref))
    label = f"{body} {'lane' if lane else 'sub'} {kind} {list(view)}"
    check(err <= AXIS_TOL[PATH_TIER], f"axis kernel vs plain {label}: {err:.3e}")
    yard = axis_exact(body, lane, ins, kind, n, inverse)
    k_err, p_err = complex_rel_err(got, yard), complex_rel_err(ref, yard)
    check(k_err <= EXACT_RATIO * p_err,
          f"{label}: kernel vs complex128 {k_err:.3e}, plain {p_err:.3e}")
    dim = -1 if lane else 1
    z = torch.complex(ins[0], ins[1]) if len(ins) == 2 else ins[0]
    lib = {("r2c", "half"): lambda: torch.fft.rfft(z, dim=dim),
           ("r2c", "full"): lambda: torch.fft.fft(z, dim=dim),
           ("c2c", "gauss"): lambda: (torch.fft.ifft if inverse else torch.fft.fft)(z, dim=dim),
           ("c2r", "half_inv"): lambda: torch.fft.irfft(z, n=n, dim=dim),
           ("c2r", "full"): lambda: torch.fft.ifft(z, dim=dim).real}[(body, kind)]
    _, _, bound_ms, bound_by = axis_bound(body, lane, view, mats, PATH_TIER)
    row = {"layout": label, "max_rel_err": err,
           "max_abs_err": max(float((a - b).abs().max()) for a, b in zip(got, ref)),
           "vs_complex128": {"kernel": k_err, "plain": p_err},
           "chunks": pallas_dft.mat_layout(body, mats[0].shape[1])[1],
           "ms": cuda_ms(lambda: call(body, ins, mats, PATH_TIER), 10),
           "plain_ms": cuda_ms(lambda: pallas_dft.plain(body, lane, ins, mats, PATH_TIER), 5),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": cuda_ms(lib, 10)}
    del ins, got, ref, yard
    return row


def fused_rest_phase(dev) -> dict:
    """The rest of the fused stylization on the card.

    (a) the 2D stack at 4x1x128x128 (half spectrum), the same stack on the
    complex path, and the 3D zero-fill stack with the data-dependent spike
    range and the plane wave on the complex path at 2x4x128x128x64, each on
    ``dft_pallas``: against the same call on the plain versions (AXIS_TOL at
    ``high``) and against complex128 transforms (at most EXACT_RATIO x the
    plain version's error), the launches checked by body, route and tier,
    the full-spectrum r2c and c2r among them; then every layout of those
    paths alone, timed. (b) ``hybrid`` against ``xla`` at 128x128x64 and at
    the non-smooth 240x240x155. (c) the 2D stack on ``dft``, card against
    CPU."""
    from mvtb_tpu_torch.ops import fused, pallas_dft

    res = {"stylize": {}}
    cases = [("2d half", REST_2D_STACK, REST_2D_SHAPE, False),
             ("2d complex", REST_2D_STACK, REST_2D_SHAPE, True),
             ("3d complex zf data-dependent", REST_3D_STACK, REST_3D_SHAPE, True)]
    for i, (name, stack, shape, cplx) in enumerate(cases):
        g = torch.Generator().manual_seed(60 + i)
        x = torch.randn(shape, generator=g).to(dev)
        cfg = fused.StylizeConfig(**stack, fft_backend="dft_pallas")
        with contextlib.ExitStack() as ctx:
            if cplx:
                ctx.enter_context(complex_path())
            draws = fused.sample_draws(cfg, shape[2:], shape[0], shape[1], generator=g,
                                       device="cpu")
            _zero_launch_counts()
            pallas_dft.tier_launches.clear()
            with axis_calls() as kc:
                got = fused.stylize_batch(x, cfg, draws=draws, device=dev)
            torch.cuda.synchronize()
            launches = dict(pallas_dft.launches)
            tiers = {" ".join(k): v for k, v in pallas_dft.tier_launches.items()}
            with axis_calls(plain=True):
                ref = fused.stylize_batch(x, cfg, draws=draws, device=dev)
            with float64_transforms():
                exact = fused.stylize_batch(x, cfg, draws=draws, device=dev)
            ms = cuda_ms(lambda: fused.stylize_batch(x, cfg, draws=draws, device=dev), 5)
        nd = len(shape) - 2
        expect = {"r2c": 1, "c2c": 2 * (nd - 1), "c2r": 1}
        check(launches == expect, f"{name}: launches {launches}, expected {expect}")
        check(set(tiers) == {f"{b} wgmma {PATH_TIER}" for b in expect},
              f"{name}: launches by route and tier {tiers}")
        full = sorted({b for b, _, _, m, _ in kc.log if _full_matrix(b, m)})
        check(full == (["c2r", "r2c"] if cplx else []), f"{name}: full-spectrum launches {full}")
        check(bool(torch.isfinite(got).all()) and got.shape == x.shape, f"{name}: output")
        err = rel_err(got, ref)
        check(err <= AXIS_TOL[PATH_TIER], f"{name}: kernels vs plain {err:.3e}")
        k_err, p_err = rel_err(got, exact), rel_err(ref, exact)
        check(k_err <= EXACT_RATIO * p_err,
              f"{name}: kernels vs complex128 {k_err:.3e}, plain {p_err:.3e}")
        res["stylize"][name] = {
            "shape": list(shape), "launches": launches, "by_route_tier": tiers,
            "layouts": sorted({f"{b} {o} {list(v)} mat {list(m)}" for b, o, v, m, _ in kc.log}),
            "kernels_vs_plain": err, "vs_complex128": {"kernels": k_err, "plain": p_err},
            "ms": ms}
        del x, got, ref, exact

    # every layout of those paths, alone: 2D half (r2c lane W, c2c sub H,
    # c2r lane W), the complex path's full r2c (first axis) and c2r (last
    # axis, two 80-column chunks at n = 128), and its lane c2c
    B, C, H, W = REST_2D_SHAPE
    n3 = REST_3D_SHAPE[0] * REST_3D_SHAPE[1]
    _, _, H3, W3, D3 = REST_3D_SHAPE
    layouts = [("r2c", True, (B * C * H, W), "half", W, False),
               ("c2c", False, (B * C, H, W // 2 + 1), "gauss", H, False),
               ("c2r", True, (B * C * H, W // 2 + 1), "half_inv", W, True),
               ("r2c", False, (B * C, H, W), "full", H, False),
               ("c2c", True, (B * C * H, W), "gauss", W, False),
               ("c2r", True, (B * C * H, W), "full", W, True),
               ("r2c", False, (n3, H3, W3 * D3), "full", H3, False),
               ("c2r", True, (n3 * H3 * W3, D3), "full", D3, True),
               ("r2c", False, (8, 240, 240), "full", 240, False),
               ("c2r", True, (8 * 240, 240), "full", 240, True)]
    res["layouts"] = [rest_axis_row(*lay, dev, seed=70 + i) for i, lay in enumerate(layouts)]
    torch.cuda.empty_cache()

    # (b) hybrid against torch.fft
    res["hybrid"] = {}
    for i, shape in enumerate(HYBRID_SHAPES):
        g = torch.Generator().manual_seed(80 + i)
        x = torch.randn(shape, generator=g).to(dev)
        draws = fused.sample_draws(fused.StylizeConfig(**REST_3D_STACK), shape[2:], shape[0],
                                   shape[1], generator=g, device="cpu")
        outs = {b: fused.stylize_batch(x, fused.StylizeConfig(**REST_3D_STACK, fft_backend=b),
                                       draws=draws, device=dev) for b in ("hybrid", "xla")}
        err = rel_err(outs["hybrid"], outs["xla"])
        check(err <= HYBRID_TOL, f"hybrid vs xla at {shape}: {err:.3e}")
        res["hybrid"][str(list(shape))] = {
            "rel_err": err, **{f"{b}_ms": cuda_ms(lambda b=b: fused.stylize_batch(
                x, fused.StylizeConfig(**REST_3D_STACK, fft_backend=b), draws=draws,
                device=dev), 3) for b in ("hybrid", "xla")}}
        del x, outs
    torch.cuda.empty_cache()

    # (c) card against CPU, the 2D stack on dft
    g = torch.Generator().manual_seed(90)
    x = torch.randn(REST_2D_SHAPE, generator=g)
    cfg = fused.StylizeConfig(**REST_2D_STACK, fft_backend="dft")
    draws = fused.sample_draws(cfg, x.shape[2:], x.shape[0], x.shape[1], generator=g,
                               device="cpu")
    err = rel_err(fused.stylize_batch(x, cfg, draws=draws, device=dev).cpu(),
                  fused.stylize_batch(x, cfg, draws=draws, device="cpu"))
    check(err <= CARD_CPU_TOL, f"2D stack card vs CPU on dft: {err:.3e}")
    res["card_vs_cpu_2d_dft"] = err
    return res


# --------------------------------------------------------------------------
# The GAN family
# --------------------------------------------------------------------------

class RecordingSGD(torch.optim.Optimizer):
    """SGD (lr 1e-3) that keeps each parameter's last gradient, for reading
    the gradients of a GAN step exactly."""

    def __init__(self, params):
        super().__init__(params, {})

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["grad"] = p.grad.clone()
                p.sub_(1e-3 * p.grad)


def _gan_step_card_vs_cpu(kind: str, dev) -> dict:
    """One training step at the registry's width on the card and on the CPU,
    from the same weights and draws, in float64 (deterministic cuDNN): the
    largest gradient difference over the largest gradient, per net, held to
    GAN_GRAD_TOL. In float32 these nets' gradients are ill-conditioned
    (two float32 runs part by parts in 1e2 of the largest; both spreads
    against the CPU's float64 step are reported), so the step's arithmetic
    is held in float64. The Gibbs compress is the stylize, held card
    against CPU in the fused-rest phase: here the CPU's compressed batches
    are handed to the card's step, so both steps see the same inputs."""
    from mvtb_tpu_torch.experiments import registry, runner
    from mvtb_tpu_torch.train import gan

    cfg = registry.get(kind)
    cpu = torch.device("cpu")
    real = torch.from_numpy(next(runner._slices_iter(cfg, 5, cfg.batch_size)))
    gen = torch.Generator().manual_seed(6)
    z = torch.randn((cfg.batch_size, cfg.nz, 1, 1), generator=gen)
    kw = runner._recon_kwargs(cfg) if kind != "dcgan" else {}
    draws = (gan.sample_recon_draws(kw["compress_kind"], real.shape, gen, cpu)
             if kind != "dcgan" else None)
    compressed = []
    real_compress = gan.compress

    def step(d, dtype, replay):
        g_state, d_state = runner._gan_states(cfg, 3, d)
        nets = [gan.GANState(st.model.to(dtype), RecordingSGD(st.model.parameters()))
                for st in (g_state, d_state)]
        if kind == "dcgan":
            m = gan.dcgan_step(*nets, real.to(d, dtype), z.to(d, dtype))
        else:
            def compress(batch, draw, *a, **k):
                if replay:
                    return compressed.pop(0).to(d, dtype)
                out = real_compress(batch, draw, *a, **k).to(dtype)
                compressed.append(out)
                return out

            gan.compress = compress
            try:
                m = gan.recon_gan_step(*nets, real.to(d, dtype),
                                       [dr.to(d) for dr in draws], **kw)
            finally:
                gan.compress = real_compress
        grads = [[st.optimizer.state[p]["grad"].double().cpu() for p in st.model.parameters()]
                 for st in nets]
        return {k: float(v) for k, v in m.items()}, grads

    def spread(a, b):
        return [max(float((x - y).abs().max()) for x, y in zip(ga, gb))
                / max(float(y.abs().max()) for y in gb) for ga, gb in zip(a, b)]

    ref_m, ref = step(cpu, torch.float64, False)
    # the card's float64 step sees the CPU's compressed batches
    card_m, card = step(dev, torch.float64, True)
    out = {"losses": {"cpu_float64": ref_m, "card_float64": card_m}}
    for net, err in zip(("g", "d"), spread(card, ref)):
        check(err <= GAN_GRAD_TOL, f"{kind} step card vs CPU (float64), {net} gradients: {err:.3e}")
        out[f"{net}_grad_err_over_max"] = err
    for where, d in (("cpu", cpu), ("card", dev)):
        compressed.clear()
        _, g32 = step(d, torch.float32, False)
        out[f"{where}_float32_vs_cpu_float64_over_max"] = spread(g32, ref)
    return out


def _gan_run_summary(res: dict, batch: int) -> dict:
    t = res["timing"]
    after = t["chunk_s"][1:]
    steps = len(res["history"]["g_loss"]) // len(t["chunk_s"])
    ms = statistics.median(after) / steps * 1e3 if after else None
    return {"chunk_ms": [c * 1e3 for c in t["chunk_s"]],
            "ms_per_step_after_first": ms,
            "steps_per_s_after_first": steps * len(after) / sum(after) if after else None,
            "slices_per_s_after_first": batch * steps * len(after) / sum(after) if after else None,
            "pool_s": t["pool_s"], "fid_ms": [f * 1e3 for f in t["fid_s"]],
            "fid": res["history"].get("fid"), "save_ms": [v * 1e3 for v in t["save_s"]],
            "restore_ms": None if t["restore_s"] is None else t["restore_s"] * 1e3,
            "launches": res["launches"]}


def gan_phase(dev) -> dict:
    """The GAN family through ``run()`` at the registry's widths (128x128
    slices, batch 4, DCGAN ngf = ndf = 128, ReconGAN nf = 16), cut in depth:
    (a) ``dcgan`` chunked for 4 epochs of 8 steps with its FID and
    checkpoints every 2 epochs; then a run killed after 2 epochs and
    resumed to 4 against an uninterrupted one, both with deterministic
    cuDNN: equal prefix, the tail equal; (b) ``recon_gan``,
    ``recon_gan_freq``, ``gibbs_gan`` chunked for 2 epochs of 8 steps; (c)
    one per-step ``dcgan`` epoch; (d) the CLI with ``--mitigated`` in a
    subprocess; (e) one ``dcgan_step`` and one ``recon_gan_step`` (gibbs),
    card against CPU; (f) per kind, over single chunks, the host reads, the
    device's idle share and top kernels. No run launches a hand-written
    kernel: the GAN family's stylize runs ``auto`` -> ``dft``
    (``torch.matmul``), as the JAX package's runs ``dft`` on the TPU."""
    import tempfile

    from mvtb_tpu_torch.experiments import registry, runner
    from mvtb_tpu_torch.train import CheckpointManager, chunked

    res = {"widths": {k: registry.get(k).gan_nf for k in GAN_KINDS}}

    def drive(tmp, tag, kind, **kw):
        _zero_launch_counts()
        out = runner.run(kind, steps_per_epoch=GAN_STEPS, workdir=f"{tmp}/{tag}",
                         verbose=False, device=dev, **kw)
        torch.cuda.synchronize()
        out["launches"] = _launch_counts()
        check(not any(out["launches"].values()),
              f"{tag}: a hand-written kernel was launched: {out['launches']}")
        h = out["history"]
        check(all(math.isfinite(v) for k in h if k not in ("epochs", "fid_epochs")
                  for v in h[k]), f"{tag}: history {h}")
        return out

    with tempfile.TemporaryDirectory() as tmp:
        # (a) dcgan, chunked, default cuDNN
        a = drive(tmp, "dcgan", "dcgan", chunked=True, epochs=GAN_EPOCHS["dcgan"],
                  ckpt_every=GAN_CKPT_EVERY)
        want = list(range(GAN_CKPT_EVERY, GAN_EPOCHS["dcgan"] + 1, GAN_CKPT_EVERY))
        check(a["history"]["fid_epochs"] == want and math.isfinite(a["fid"]),
              f"dcgan FID curve {a['history'].get('fid_epochs')} {a.get('fid')}")
        check(CheckpointManager(f"{tmp}/dcgan/ckpt").all_steps() == want, "dcgan checkpoints")
        res["dcgan"] = {"final_fid": a["fid"],
                        **_gan_run_summary(a, registry.get("dcgan").batch_size)}
        del a
        shutil.rmtree(f"{tmp}/dcgan")

        # kill and resume, deterministic cuDNN
        torch.backends.cudnn.deterministic = True
        try:
            kw = dict(chunked=True, ckpt_every=GAN_CKPT_EVERY)
            full = drive(tmp, "full", "dcgan", epochs=GAN_EPOCHS["dcgan"], **kw)
            shutil.rmtree(f"{tmp}/full")
            part = drive(tmp, "part", "dcgan", epochs=GAN_CKPT_EVERY, **kw)
            resumed = drive(tmp, "part", "dcgan", epochs=GAN_EPOCHS["dcgan"], resume=True, **kw)
        finally:
            torch.backends.cudnn.deterministic = False
        h, hf = resumed["history"], full["history"]
        n = GAN_CKPT_EVERY * GAN_STEPS
        check(resumed["resumed_from"] == GAN_CKPT_EVERY, f"resumed from {resumed['resumed_from']}")
        check(h["g_loss"][:n] == part["history"]["g_loss"], "the resumed prefix changed")
        tail = max(abs(x - y) for k in chunked.DCGAN_CURVES
                   for x, y in zip(h[k][n:], hf[k][n:]))
        fid_tail = max(abs(x - y) for x, y in zip(h["fid"], hf["fid"]))
        check(tail == 0.0 and fid_tail == 0.0,
              f"the resumed tail differs from the uninterrupted run: {tail}, FID {fid_tail}")
        res["dcgan_resume"] = {"prefix_equal": True, "tail_max_abs_diff": tail,
                               "fid_max_abs_diff": fid_tail,
                               "restore_ms": resumed["timing"]["restore_s"] * 1e3,
                               "save_ms": [v * 1e3 for v in full["timing"]["save_s"]]}
        del full, part, resumed
        shutil.rmtree(f"{tmp}/part")

        # (b) the ReconGAN kinds, chunked
        for kind in GAN_KINDS[1:]:
            r = drive(tmp, kind, kind, chunked=True, epochs=GAN_EPOCHS[kind],
                      ckpt_every=GAN_CKPT_EVERY)
            check(len(r["history"]["g_loss"]) == GAN_EPOCHS[kind] * GAN_STEPS, f"{kind} curves")
            res[kind] = _gan_run_summary(r, registry.get(kind).batch_size)
            del r

        # (c) one per-step dcgan epoch
        t0 = time.perf_counter()
        r = drive(tmp, "dcgan_step", "dcgan", epochs=1)
        res["dcgan_per_step"] = {"seconds": time.perf_counter() - t0, "fid": r["fid"],
                                 "losses": r["history"]["g_loss"], "launches": r["launches"]}
        del r

        # (d) the CLI, as a user runs it
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "mvtb_tpu_torch.experiments", "run", "dcgan",
             "--mitigated", "--chunked", "--epochs", "1", "--steps", "4", "--quiet",
             "--workdir", f"{tmp}/cli"],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        lines = proc.stdout.splitlines()
        check(len(lines) == 1 and set(json.loads(lines[0])) == {"wall_time_s"},
              f"CLI printed {lines}")
        with open(f"{tmp}/cli/dcgan_mitigated_result.json") as f:
            cli_fid = json.load(f)["fid"]
        check(math.isfinite(cli_fid), f"CLI FID {cli_fid}")
        res["cli"] = {"summary": json.loads(lines[0]), "fid": cli_fid,
                      "seconds": time.perf_counter() - t0}

    # (e) one step of each step function, card against CPU
    torch.backends.cudnn.deterministic = True
    try:
        res["card_vs_cpu"] = {k: _gan_step_card_vs_cpu(k, dev) for k in ("dcgan", "gibbs_gan")}
    finally:
        torch.backends.cudnn.deterministic = False

    # (f) over single chunks of each kind
    probes = {}
    for kind in GAN_KINDS:
        cfg = registry.get(kind)
        g_state, d_state = runner._gan_states(cfg, 0, dev)
        pool = torch.from_numpy(next(runner._slices_iter(cfg, 0, GAN_POOL))).to(dev)
        idxs = torch.randint(0, GAN_POOL, (GAN_STEPS, cfg.batch_size), device=dev)
        if kind == "dcgan":
            chunk_fn = chunked.make_dcgan_chunk_fn(cfg.nz, device=dev)
        else:
            chunk_fn = chunked.make_recon_gan_chunk_fn(**runner._recon_kwargs(cfg), device=dev)

        def one_chunk(epoch, chunk_fn=chunk_fn, g_state=g_state, d_state=d_state, pool=pool,
                      idxs=idxs):
            return chunk_fn(g_state, d_state, runner.epoch_generator(1, epoch, dev), pool,
                            idxs)[3]

        probes[kind] = chunk_probe(kind, one_chunk, GAN_STEPS)
        del g_state, d_state, pool
        torch.cuda.empty_cache()
    res["chunk_probe"] = probes
    return res


def _domain_run(tag: str, cfg, tmp: str, dev) -> tuple:
    """One ``run_domain_experiment`` on the card, its launches counted from
    zero; the host's time to build the hospitals (``domain_loaders``), each
    train step (host clock around the step, synchronised) and each
    hospital's evaluation are read through wrappers of the runner's
    names. Returns (result, record, train steps, evaluation batches)."""
    from mvtb_tpu_torch.experiments import runner
    from mvtb_tpu_torch.ops import fused_plane, pallas_dft

    seen, timing = {}, {"step_ms": [], "eval_s": {}}
    real = (runner.domain_loaders, runner.seg_train_step, runner.ModelEvaluation,
            fused_plane.plane_stylize_half_plain, pallas_dft.plain)
    plain_on_card = []

    def loaders(**kw):
        t = time.perf_counter()
        seen["train"], seen["val"] = real[0](**kw)
        timing["pool_s"] = time.perf_counter() - t
        return seen["train"], seen["val"]

    def step(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = real[1](*a, **kw)
        torch.cuda.synchronize()
        timing["step_ms"].append((time.perf_counter() - t) * 1e3)
        return loss

    class TimedEvaluation(real[2]):
        def add_eval(self, name=None, test_loader=None, data_dict=None):
            t = time.perf_counter()  # ends in the Dice's host reads
            super().add_eval(name, test_loader, data_dict)
            timing["eval_s"][name] = time.perf_counter() - t

    def watched_plane(k_re, *a, **kw):
        if k_re.is_cuda:
            plain_on_card.append(("fused_plane", tuple(k_re.shape)))
        return real[3](k_re, *a, **kw)

    def watched_axis(body, lane, ins, *a, **kw):
        if ins[0].is_cuda:
            plain_on_card.append((body, tuple(ins[0].shape)))
        return real[4](body, lane, ins, *a, **kw)

    (runner.domain_loaders, runner.seg_train_step, runner.ModelEvaluation,
     fused_plane.plane_stylize_half_plain, pallas_dft.plain) = (
        loaders, step, TimedEvaluation, watched_plane, watched_axis)
    _zero_launch_counts()
    pallas_dft.tier_launches.clear()
    t0 = time.perf_counter()
    try:
        res = runner.run_domain_experiment(
            cfg, epochs=DOMAIN_EPOCHS, steps_per_epoch=DOMAIN_STEPS, n_per_hospital=DOMAIN_N,
            workdir=f"{tmp}/{tag}", verbose=False, device=dev)
        torch.cuda.synchronize()
    finally:
        (runner.domain_loaders, runner.seg_train_step, runner.ModelEvaluation,
         fused_plane.plane_stylize_half_plain, pallas_dft.plain) = real
    wall_s = time.perf_counter() - t0
    launches, tiers = _launch_counts(), dict(pallas_dft.tier_launches)
    check(not plain_on_card, f"{tag}: plain version ran on the card: {plain_on_card}")
    steps = DOMAIN_EPOCHS * min(DOMAIN_STEPS, len(seen["train"]))
    batches = sum(len(v) for v in seen["val"].values())
    check(len(res["losses"]) == steps and all(math.isfinite(v) for v in res["losses"]),
          f"{tag}: losses {res['losses']}")
    check(list(res["eval_dict"]) == ["hospital_A", "hospital_B", "hospital_C", "holdout"]
          and all(math.isfinite(v) for v in res["eval_dict"].values()),
          f"{tag}: Dice {res['eval_dict']}")
    # (the normalized gap is NaN where the in-distribution mean is 0)
    check(all(math.isfinite(res["gap"][k]) for k in ("in_dist_mean", "holdout", "gap")),
          f"{tag}: gap {res['gap']}")
    files = sorted(os.listdir(f"{tmp}/{tag}"))
    check(files == sorted(f"{cfg.name}{x}" for x in ("_domain.json", "_domain.pickle",
                                                      "_gap.json")), f"{tag}: files {files}")
    record = {"config": cfg.name, "batch": cfg.batch_size, "train_steps": steps,
              "eval_batches": batches, "losses": res["losses"], "eval_dict": res["eval_dict"],
              "gap": res["gap"], "launches": launches,
              "launches_by_route_and_tier": {" ".join(k): v for k, v in tiers.items()},
              "pool_s": timing["pool_s"], "step_ms": timing["step_ms"],
              "ms_per_step_after_first": statistics.median(timing["step_ms"][1:]),
              "eval_s": timing["eval_s"], "wall_s": wall_s}
    return res, record, steps, batches


def domain_phase(dev) -> dict:
    """The hospital-domain protocol (``run_domain_experiment``) and the
    evaluation it rests on, at the registry's full width (1 -> 1, UNet
    16..256, bf16, 128x128x64, 8 volumes a hospital), cut in depth to 2
    epochs of 8 steps.

    (a) Three domain runs: ``gibbs15_domain`` as registered (``auto`` ->
    ``dft``: no hand-written launch), ``fast_science(gibbs35_spikes10_
    sap0p08_domain)`` (disk, plane write and S&P on ``plane_fast``, batch
    16: one plane-kernel launch per train step and per ``StylizedLoader``
    batch, counted from the loaders) and the same entry with both stylizes
    on ``dft_pallas`` (r2c, c2c, c2r 1, 4, 1 per stylize, all at
    ``high``); each with finite losses, Dice and gap, its files, ms per
    step, evaluation seconds per hospital and pool seconds. (b) Card
    against CPU: one evaluation of the 4 hospitals from the first run's
    weights in float32 under the disk r = 15 on ``plane`` (CPU: its plain
    version), Dice within 1e-3, and one ``StylizedLoader`` batch within the
    tier's 5e-5. (c) Sliding window at TCGA scale (240x240x155, ROI
    128x128x64, overlap 0.25, 27 tiles, full-width 1 -> 1 UNet in bf16):
    ms and volumes/s for B = 1 constant and gaussian, B = 2, B = 1 per
    tile; in float32, ``tile_batch`` 1 against 8 within 1e-5 of the max
    and ``low_memory`` both ways equal. (d) The NIfTI path: a 10-volume
    4x240x240x155 Decathlon tree (uncompressed, written by a second process
    while (a)-(c) run), one gzipped volume read by the native and the
    Python reader (equal arrays), the read and resample ms, and
    ``BratsValIterDataset`` with two named corruptions through
    ``ModelEvaluation(roi_size=(128, 128, 64))`` and a full-width 4 -> 3
    UNet."""
    import dataclasses
    import tempfile

    import numpy as np

    from mvtb_tpu_torch import native
    from mvtb_tpu_torch.data import (BratsValIterDataset, DecathlonDataset, StylizedLoader,
                                     domain_loaders, read_nifti)
    from mvtb_tpu_torch.data.preprocess import resample_to_spacing
    from mvtb_tpu_torch.eval import ModelEvaluation, sliding_window_inference
    from mvtb_tpu_torch.eval.sliding_window import _grid_positions
    from mvtb_tpu_torch.experiments import registry
    from mvtb_tpu_torch.models import UNet
    from mvtb_tpu_torch.ops import fused, fused_plane, pallas_dft
    from mvtb_tpu_torch.transforms import RandFourierDiskMaskd, SaltAndPepper

    res = {"epochs": DOMAIN_EPOCHS, "steps_per_epoch": DOMAIN_STEPS,
           "n_per_hospital": DOMAIN_N, "native_available": native.available()}
    tmp = tempfile.mkdtemp(prefix="mvtb_domain_")
    tree = subprocess.Popen(
        [sys.executable, "-c", NIFTI_TREE.format(n=NIFTI_N, sp=NIFTI_SPATIAL), f"{tmp}/tree"],
        cwd=REPO, stdout=subprocess.PIPE, text=True)
    try:
        # (a) the three domain runs
        auto = registry.get(DOMAIN_AUTO)
        kernel = registry.get(DOMAIN_KERNEL)
        fast = registry.fast_science(kernel)
        check(fused_plane.plane_kernel_eligible(fast.train_stylize, fast.spatial),
              f"{fast.name}: the plane kernel does not implement its stylize")
        on_pallas = {s: dataclasses.replace(getattr(kernel, s), fft_backend="dft_pallas")
                     for s in ("train_stylize", "val_stylize")}
        pallas = dataclasses.replace(kernel, name=kernel.name + "_dft_pallas", **on_pallas)
        runs = {}
        first, runs["auto"], _, _ = _domain_run("auto", auto, tmp, dev)
        check(not any(runs["auto"]["launches"].values()),
              f"auto: a hand-written kernel launched: {runs['auto']['launches']}")
        _, runs["plane_fast"], steps, batches = _domain_run("plane_fast", fast, tmp, dev)
        launches = runs["plane_fast"]["launches"]
        check(launches["fused_plane"] == steps + batches == sum(launches.values()),
              f"plane_fast: {launches}, expected {steps} + {batches} plane launches only")
        _, runs["dft_pallas"], steps, batches = _domain_run("dft_pallas", pallas, tmp, dev)
        launches, tiers = runs["dft_pallas"]["launches"], runs["dft_pallas"][
            "launches_by_route_and_tier"]
        for body, per_call in LAUNCHES_PER_STEP.items():
            want = per_call * (steps + batches)
            key = " ".join((body, pallas_dft.route(body, PATH_TIER), PATH_TIER))
            check(launches[f"axis_dft_{body}"] == want == tiers.get(key, 0),
                  f"dft_pallas: {body} {launches} {tiers}, expected {want} at {key}")
        check(sum(launches.values()) == sum(tiers.values()),
              f"dft_pallas: other kernels launched: {launches}")
        res["runs"] = runs

        # (b) card against CPU from the first run's weights, float32
        weights = {k: v.detach().float().cpu() for k, v in first["state"].model.state_dict().items()}
        del first
        sty = fused.StylizeConfig(disk_r=15.0, disk_prob=1.0, fft_backend="plane")
        _, val = domain_loaders(batch_size=auto.batch_size, n_per_hospital=DOMAIN_N, seed=0,
                                spatial=auto.spatial)
        scores, seconds = {}, {}
        for key, side in (("card", dev), ("cpu", torch.device("cpu"))):
            model = UNet(auto.in_channels, auto.out_channels, auto.channels, auto.strides,
                         auto.num_res_units, device=side).eval()
            model.load_state_dict(weights)
            ev = ModelEvaluation(model, out_channels=1, device=side)
            _zero_launch_counts()
            t = time.perf_counter()
            for name, loader in val.items():
                ev.add_eval(name, StylizedLoader(loader, sty, 0, device=side))
            seconds[key] = time.perf_counter() - t
            scores[key] = dict(ev.eval_dict)
            if key == "card":
                check(fused_plane.plane_stylize_half.launches == sum(len(v) for v in val.values()),
                      f"card evaluation: {fused_plane.plane_stylize_half.launches} plane launches")
        dice_diff = max(abs(scores["card"][k] - scores["cpu"][k]) for k in scores["cpu"])
        check(dice_diff <= DOMAIN_DICE_TOL,
              f"card vs CPU Dice {scores}: {dice_diff:.3e} > {DOMAIN_DICE_TOL}")
        card_b, cpu_b = (next(iter(StylizedLoader(val["holdout"], sty, 0, device=side)))["image"]
                         for side in (dev, "cpu"))
        batch_err = rel_err(torch.from_numpy(card_b), torch.from_numpy(cpu_b))
        check(batch_err <= TOL["plane"],
              f"StylizedLoader card vs CPU {batch_err:.3e} > {TOL['plane']}")
        res["card_vs_cpu"] = {"dice": scores, "max_abs_dice_diff": dice_diff,
                              "tolerance": DOMAIN_DICE_TOL, "eval_s": seconds,
                              "stylized_batch_max_rel_err": batch_err,
                              "stylized_batch_tolerance": TOL["plane"]}

        # (c) sliding window at TCGA scale
        tiles = math.prod(len(_grid_positions(n, r, SW_OVERLAP)) for n, r in zip(SW_VOLUME, SW_ROI))
        check(tiles == 27, f"{tiles} tiles")
        torch.manual_seed(3)
        bf16 = UNet(1, 1, device=dev, dtype=torch.bfloat16).eval()
        f32 = UNet(1, 1, device=dev).eval()
        f32.load_state_dict(bf16.state_dict())
        g = torch.Generator(device=dev).manual_seed(5)
        x = torch.randn((2, 1) + SW_VOLUME, generator=g, device=dev)
        sw = {"tiles": tiles, "roi": list(SW_ROI), "overlap": SW_OVERLAP}
        for tag, B, mode, tb in SW_CASES:
            def call():
                return sliding_window_inference(x[:B], SW_ROI, bf16, overlap=SW_OVERLAP,
                                                mode=mode, tile_batch=tb, device=dev)
            y = call()
            check(tuple(y.shape) == (B, 1) + SW_VOLUME and bool(torch.isfinite(y).all()),
                  f"sliding window {tag}: {tuple(y.shape)}")
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                call()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            ms = statistics.median(times)
            sw[tag] = {"ms": ms, "vol_s": B * 1e3 / ms, "B": B, "mode": mode, "tile_batch": tb}
        one, eight = (sliding_window_inference(x[:1], SW_ROI, f32, overlap=SW_OVERLAP,
                                               mode="gaussian", tile_batch=tb, device=dev)
                      for tb in (1, 8))
        sw["f32_tile_batch_1_vs_8_max_rel_err"] = rel_err(eight, one)
        check(sw["f32_tile_batch_1_vs_8_max_rel_err"] <= SW_TOL,
              f"sliding window tile_batch 1 vs 8: {sw['f32_tile_batch_1_vs_8_max_rel_err']:.3e}")
        # one schedule either way: equal under deterministic cuDNN (its
        # default algorithms may differ between two calls of one schedule)
        torch.backends.cudnn.deterministic = True
        try:
            lo, hi = (sliding_window_inference(x, SW_ROI, f32, overlap=SW_OVERLAP, tile_batch=3,
                                               low_memory=lm, device=dev) for lm in (True, False))
        finally:
            torch.backends.cudnn.deterministic = False
        check(torch.equal(lo, hi), "sliding window: low_memory True and False differ")
        sw["f32_low_memory_equal"] = True
        res["sliding_window"] = sw
        del x, one, eight, lo, hi, bf16, f32, y
        torch.cuda.empty_cache()

        # (d) the NIfTI path
        t = time.perf_counter()
        stdout, _ = tree.communicate(timeout=600)
        check(tree.returncode == 0, f"the tree's process exited {tree.returncode}")
        tree_s, gz_write_s = (float(v) for v in stdout.split())
        root = f"{tmp}/tree"
        task = f"{root}/Task01_BrainTumour"
        nifti = {"tree_s": tree_s, "tree_wait_s": time.perf_counter() - t,
                 "gz_write_s": gz_write_s, "native_available": native.available()}
        gz = f"{task}/gz_check.nii.gz"
        t = time.perf_counter()
        nat, _ = read_nifti(gz)
        nifti["gz_read_native_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        py, _ = read_nifti(gz, prefer_native=False)
        nifti["gz_read_python_ms"] = (time.perf_counter() - t) * 1e3
        check(nat.shape == NIFTI_SPATIAL and np.array_equal(nat, py),
              "gzipped volume: the native and Python readers differ")
        entry = DecathlonDataset(root, section="validation").entries[0]
        t = time.perf_counter()
        img, aff = read_nifti(f"{task}/{entry['image']}")
        nifti["read_ms_per_volume"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        resampled, _ = resample_to_spacing(np.ascontiguousarray(np.moveaxis(img, -1, 0)), aff,
                                           (1.5, 1.5, 2.0))
        nifti["resample_ms_per_volume"] = (time.perf_counter() - t) * 1e3
        nifti["resampled_shape"] = list(resampled.shape)
        del img, resampled, nat, py
        sweep = BratsValIterDataset(root, transforms={
            "gibbs12p5": RandFourierDiskMaskd("image", r=12.5, prob=1.0, device=dev),
            "sap0p05": SaltAndPepper(0.05, "image", device=dev)}, return_loader=True)
        torch.manual_seed(4)
        ev = ModelEvaluation(UNet(4, 3, device=dev).eval(), instance_name="nifti_sweep",
                             roi_size=SW_ROI, device=dev)
        nifti["eval_s"] = {}
        for name, loader in sweep:
            check(len(loader) == 1, f"{name}: {len(loader)} batches, expected the half split's 1")
            t = time.perf_counter()
            ev.add_eval(name, loader)
            nifti["eval_s"][name] = time.perf_counter() - t
        table = {k: list(v) for k, v in ev.eval_dict.items()}
        check(list(table) == ["gibbs12p5", "sap0p05"]
              and all(len(v) == 4 and all(math.isfinite(x) for x in v) for v in table.values()),
              f"the sweep's Dice table {table}")
        nifti["dice_mean_et_tc_wt"] = table
        res["nifti"] = nifti
    finally:
        if tree.poll() is None:
            tree.kill()
            tree.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return res


def _float64(model):
    """``model`` computing in float64: its parameters and every module's
    compute type."""
    for m in model.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    return model.double()


def _learnable_card_vs_cpu(dev) -> dict:
    """One step of each learnable step function at 1x1x32^3 (UNet (8, 16,
    32)), card against CPU from the same weights, batch and spike draws,
    deterministic cuDNN: the soft Gibbs layer and the spike layer through
    ``learnable_train_step``, the hard mask through ``fd_train_step`` (alpha
    0.5: its radii at a and a + h fall between grid distances), held in
    float64, as the GAN steps are: in float32 a rounding difference can move
    an activation across a PReLU kink, where the gradient jumps; their
    float32 spreads are reported. Then
    the hard mask at alpha = 0 in float32, whose all-zero volume makes every
    first-level norm map constant: with zero conv biases the maps are
    exactly 0 on both devices and the gradients are held (less the conv
    biases that feed a norm, whose exact gradient 0 becomes rounding noise
    scaled by rsqrt(eps), reported); with nonzero biases each device's
    gradients follow its own rounding of the constant maps: finite,
    reported."""
    from mvtb_tpu_torch.models import GibbsUNet, SpikeLayer, SpikesUNet
    from mvtb_tpu_torch.train import (create_learnable_state, fd_train_step,
                                      learnable_train_step)

    g = torch.Generator().manual_seed(8)
    x = torch.randn(LEARN_SMALL_SHAPE, generator=g)
    lab = (torch.rand(LEARN_SMALL_SHAPE, generator=g) < 0.3).float()
    spike_locs = SpikeLayer.sample_locations(x, g)

    def one(kind, hard, step, styl0, dtype, biases=False):
        def make(d):
            if kind == "gibbs":
                return GibbsUNet(styl0, hard=hard, **LEARN_SMALL, device=d)
            return SpikesUNet(styl0, **LEARN_SMALL, device=d)

        torch.manual_seed(9)
        cpu_model = make("cpu")
        if biases:
            with torch.no_grad():
                for k, p in cpu_model.named_parameters():
                    if k.endswith(".bias"):
                        p.normal_(0.0, 0.01)
        card_model = make(dev)
        card_model.load_state_dict(cpu_model.state_dict())
        if dtype == torch.float64:
            cpu_model, card_model = _float64(cpu_model), _float64(card_model)
        locs = spike_locs if kind == "spikes" else None

        def run(model, d):
            st = create_learnable_state(model, device=d)
            args = (x.to(dtype), lab.to(dtype), None if locs is None else locs.to(d))
            if step == "fd":
                loss, styl = fd_train_step(st, *args, device=d)
            else:
                loss, styl = learnable_train_step(st, *args, device=d)
            grads = {k: (p.grad.detach().cpu() if p.grad is not None
                         else torch.zeros(p.shape, dtype=p.dtype))
                     for k, p in model.named_parameters()}
            return float(loss), float(styl), grads

        torch.backends.cudnn.deterministic = True
        try:
            loss_card, styl_card, g_card = run(card_model, dev)
        finally:
            torch.backends.cudnn.deterministic = False
        loss_cpu, styl_cpu, g_cpu = run(cpu_model, "cpu")
        check(all(torch.isfinite(v).all() for v in g_card.values()),
              f"learnable {kind} {step} {dtype}: a gradient on the card is not finite")
        zero = _norm_fed_biases(card_model) if styl0 == 0.0 else set()
        gmax = max(float(v.abs().max()) for k, v in g_cpu.items() if k not in zero)
        err = max(float((g_card[k] - v).abs().max()) for k, v in g_cpu.items()
                  if k not in zero) / gmax
        row = {"grad_err_over_max": err, "styl_abs_err": abs(styl_card - styl_cpu),
               "styl": {"card": styl_card, "cpu": styl_cpu},
               "loss": {"card": loss_card, "cpu": loss_cpu}, "grad_max": gmax}
        if zero:
            row["norm_fed_bias_grad_over_max"] = {
                "card": max(float(g_card[k].abs().max()) for k in zero) / gmax,
                "cpu": max(float(g_cpu[k].abs().max()) for k in zero) / gmax}
        return row

    out_ = {"tolerance": {"grad_over_max": LEARN_GRAD_TOL, "styl_abs": LEARN_STYL_TOL}}
    for name, case in (("gibbs_soft_grad", ("gibbs", False, "grad", 0.7)),
                       ("spikes_grad", ("spikes", False, "grad", 11.0)),
                       ("gibbs_hard_fd", ("gibbs", True, "fd", 0.5))):
        row = one(*case, torch.float64)
        check(row["grad_err_over_max"] <= LEARN_GRAD_TOL and
              row["styl_abs_err"] <= LEARN_STYL_TOL and
              abs(row["loss"]["card"] - row["loss"]["cpu"]) <= 1e-6,
              f"learnable {name}: card vs CPU in float64: {row}")
        f32 = one(*case, torch.float32)
        row["float32"] = {k: f32[k] for k in ("grad_err_over_max", "styl_abs_err", "loss")}
        out_[name] = row
    row = one("gibbs", True, "grad", 0.0, torch.float32)
    check(row["grad_err_over_max"] <= LEARN_GRAD_TOL and row["styl_abs_err"] == 0.0,
          f"learnable hard mask at alpha 0, zero biases: card vs CPU {row}")
    out_["gibbs_hard_alpha0_zero_biases"] = row
    out_["gibbs_hard_alpha0_random_biases"] = one("gibbs", True, "grad", 0.0, torch.float32,
                                                  biases=True)
    return out_


def learnable_phase(dev) -> dict:
    """Learnable stylization through ``run()`` at the registry's widths (1 ->
    1, UNet 16..256, float32, batch 2, 128x128x64), cut in depth: (a) one
    step of each step function, card against CPU; (b) ``gibbs0p7_layer_grad``
    (soft mask, joint gradients), ``gibbs0p7_layer_GD`` (hard mask, the
    finite-difference step: two more forwards a step) and
    ``spikes11_layer_GD`` chunked for 3 epochs of 8 steps over a pool of 8,
    a checkpoint every epoch: finite trajectories and losses, no
    hand-written kernel launched (the layers are ``torch.fft``, as the JAX
    layers are ``jnp.fft``), ms a step and steps/s over the chunks after the
    first; (c) ``gibbs0p7_layer_GD`` killed after 1 of 2 epochs and resumed,
    against an uninterrupted run, deterministic cuDNN: the prefix and the
    trajectory equal; (d) a few per-step steps of ``gibbs0p7_layer_fixed``;
    (e) over single chunks of each kind, the host reads, the device's idle
    share and top kernels, and for the joint step the ms a step with TF32
    on (cuDNN's float32 default) and with the autotuner; (f)
    ``ModelEvaluation.from_checkpoint`` with ``gibbs_unet`` and
    ``spikes_unet`` on the runs' checkpoints, scoring one batch."""
    import tempfile

    from mvtb_tpu_torch.eval import ModelEvaluation
    from mvtb_tpu_torch.experiments import registry, runner
    from mvtb_tpu_torch.train import chunked

    cfg0 = registry.get(LEARN_RUNS[0])
    res = {"widths": {"channels": cfg0.channels, "num_res_units": cfg0.num_res_units,
                      "batch": cfg0.batch_size, "spatial": cfg0.spatial}}
    t0 = time.perf_counter()
    res["card_vs_cpu"] = _learnable_card_vs_cpu(dev)
    res["card_vs_cpu"]["seconds"] = time.perf_counter() - t0

    def drive(tmp, tag, name, **kw):
        _zero_launch_counts()
        r = runner.run(name, workdir=f"{tmp}/{tag}", verbose=False, device=dev, **kw)
        torch.cuda.synchronize()
        r["launches"] = _launch_counts()
        check(not any(r["launches"].values()),
              f"{tag}: a hand-written kernel was launched: {r['launches']}")
        check(all(math.isfinite(v) for v in r["trajectory"] + r["losses"]),
              f"{tag}: trajectory {r['trajectory']} losses {r['losses']}")
        return r

    with tempfile.TemporaryDirectory() as tmp:
        # (b) the three chunked runs
        for name in LEARN_RUNS:
            r = drive(tmp, name, name, chunked=True, epochs=LEARN_EPOCHS,
                      steps_per_epoch=LEARN_STEPS, pool=LEARN_POOL, ckpt_every=1)
            check(len(r["trajectory"]) == LEARN_EPOCHS * LEARN_STEPS, f"{name} trajectory")
            t = r["timing"]
            after = t["chunk_s"][1:]
            res[name] = {"ms_per_step_after_first": statistics.median(after) / LEARN_STEPS * 1e3,
                         "steps_per_s_after_first": LEARN_STEPS * len(after) / sum(after),
                         "chunk_ms": [c * 1e3 for c in t["chunk_s"]], "pool_s": t["pool_s"],
                         "save_ms": [v * 1e3 for v in t["save_s"]],
                         "parameters": sum(p.numel() for p in r["state"].model.parameters()),
                         "trajectory_first_last": [r["trajectory"][0], r["trajectory"][-1]],
                         "losses": r["losses"], "launches": r["launches"]}
            del r

        # (c) kill and resume, deterministic cuDNN
        torch.backends.cudnn.deterministic = True
        try:
            kw = dict(chunked=True, steps_per_epoch=LEARN_RESUME_STEPS, pool=LEARN_POOL,
                      ckpt_every=1)
            full = drive(tmp, "full", LEARN_RUNS[1], epochs=2, **kw)
            part = drive(tmp, "part", LEARN_RUNS[1], epochs=1, **kw)
            resumed = drive(tmp, "part", LEARN_RUNS[1], epochs=2, resume=True, **kw)
        finally:
            torch.backends.cudnn.deterministic = False
        check(resumed["resumed_from"] == 1, f"resumed from {resumed['resumed_from']}")
        check(resumed["trajectory"][:LEARN_RESUME_STEPS] == part["trajectory"],
              "the resumed prefix changed")
        check(resumed["trajectory"] == full["trajectory"] and
              resumed["losses"] == full["losses"],
              f"the resumed run differs from the uninterrupted one: "
              f"{resumed['trajectory']} {full['trajectory']}")
        res["resume"] = {"prefix_equal": True, "trajectory_equal": True,
                         "restore_ms": resumed["timing"]["restore_s"] * 1e3}
        del full, part, resumed

        # (d) per step
        t0 = time.perf_counter()
        r = drive(tmp, "fixed", LEARN_FIXED, epochs=1, steps_per_epoch=LEARN_FIXED_STEPS)
        res[LEARN_FIXED] = {"seconds": time.perf_counter() - t0, "trajectory": r["trajectory"],
                            "losses": r["losses"]}
        del r

        # (f) the harness on the runs' checkpoints
        cfg = registry.get(LEARN_RUNS[0])
        img, lbl = next(runner._data_iter(cfg, 5, cfg.batch_size))
        harness = {}
        for flag, name in (("gibbs_unet", LEARN_RUNS[0]), ("spikes_unet", LEARN_RUNS[2])):
            t0 = time.perf_counter()
            ev = ModelEvaluation.from_checkpoint(f"{tmp}/{name}/ckpt", instance_name=name,
                                                 in_channels=1, out_channels=1, device=dev,
                                                 **{flag: True})
            ev.add_eval("batch", [{"image": img, "label": lbl}])
            dice = float(ev.eval_dict["batch"])
            check(math.isfinite(dice), f"from_checkpoint({flag}): Dice {dice}")
            harness[flag] = {"dice": dice, "seconds": time.perf_counter() - t0}
            del ev
        res["harness"] = harness

    # (e) over single chunks of each kind: reads, idle share, top kernels
    probes = {}
    for name in LEARN_RUNS:
        cfg = registry.get(name)
        state = runner._learnable_state(cfg, 0, dev)
        pool_i, pool_l = runner._pool_arrays(cfg, 0, LEARN_POOL, dev)
        idxs = torch.randint(0, LEARN_POOL, (LEARN_PROBE_STEPS, cfg.batch_size), device=dev)
        chunk_fn = chunked.make_learnable_chunk_fn(cfg.fd_mode, cfg.train_alpha, cfg.fd_h,
                                                   cfg.fd_lr, device=dev)

        def one_chunk(epoch, chunk_fn=chunk_fn, state=state, pool_i=pool_i, pool_l=pool_l,
                      idxs=idxs):
            _, _, loss, traj = chunk_fn(state, runner.epoch_generator(1, epoch, dev), pool_i,
                                        pool_l, idxs)
            return torch.cat([loss.reshape(1), traj])  # what the runner reads

        p = chunk_probe(name, one_chunk, LEARN_PROBE_STEPS)
        # the chunk itself reads nothing; the runner's one read of its loss
        # and trajectory is the chunk's only host read
        check(p["host_reads_per_chunk"] == 0, f"{name}: host reads inside a chunk: {p}")
        p["host_reads_per_chunk_with_the_result"] = p["host_reads_per_chunk"] + 1
        probes[name] = p
        if name == LEARN_RUNS[0]:
            # (g) the same chunk under cuDNN settings a user may run: its
            # float32 default (TF32), and the autotuner (TF32 off)
            timed = {}
            for tag, tf32, bench in (("tf32", True, False), ("benchmark", False, True)):
                torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark = tf32, bench
                try:
                    one_chunk(4).cpu()  # warm (and, with the autotuner, tune)
                    t0 = time.perf_counter()
                    one_chunk(5).cpu()
                    timed[tag] = (time.perf_counter() - t0) / LEARN_PROBE_STEPS * 1e3
                finally:
                    torch.backends.cudnn.allow_tf32 = False
                    torch.backends.cudnn.benchmark = False
            res["grad_ms_per_step_by_cudnn_setting"] = timed
        del state, pool_i, pool_l
        torch.cuda.empty_cache()
    res["chunk_probe"] = probes
    return res


# ---------------------------------------------------------------------------
# parallel phase
# ---------------------------------------------------------------------------

# the data-parallel step at world 1 (NCCL): the train phase's batch and
# stack, the full-width UNet in float32, SGD(1.0); equality steps, launch
# steps and timed steps (in turns, plain then data-parallel)
DP_EQUAL_STEPS, DP_LAUNCH_STEPS, DP_TIMED_ROUNDS, DP_TIMED_STEPS = 2, 3, 2, 3
# the 2-rank checks (gloo, both ranks on the one card): the bench volume
# for the H-split stylize, the JAX package's full-volume spatial step
# (``__graft_entry__.py:170-235``: 240x240x160, UNet 16..256, the disk
# r = 12.5 stylize, SGD(1.0)) and a tensor-parallel step at the train
# phase's batch
PAR_WORLD = 2
PAR_STYLIZE_SHAPE = BENCH_SHAPE[1:]
PAR_STYLIZE_TOL = 1e-4  # of the max, tests/test_sharded_fft.py's bound
PAR_FULL_VOLUME = (240, 240, 160)
PAR_LOSS_TOL, PAR_GRAD_TOL = 1e-4, 1e-3  # __graft_entry__.py:222, :234
PAR_TIMEOUT = 900
# the collectives gloo is asked to carry on CUDA tensors; send / recv is
# probed in a pair of its own (gloo fails it on CUDA tensors, so the halo
# exchange and the trades use all_gather, all_reduce and all_to_all)
PAR_COLLECTIVES = ("all_reduce_sum", "all_reduce_min", "all_reduce_max", "all_gather",
                   "all_to_all_single", "broadcast")


def _dp_world1(dev) -> dict:
    """The data-parallel ``seg_train_step`` on an NCCL world of one against
    the plain step: bit-equal (an all-reduce over one rank is the
    identity), the axis kernels launched 1, 4, 1 times a step at ``high``."""
    import torch.distributed as dist

    from mvtb_tpu_torch.models import UNet
    from mvtb_tpu_torch.ops import fused, pallas_dft
    from mvtb_tpu_torch.parallel import dp, make_mesh, replicate
    from mvtb_tpu_torch.train import create_seg_state, seg_train_step

    check(not dist.is_initialized(), "a process group is already running")
    mesh = make_mesh(device=dev)
    try:
        check(dist.get_backend() == "nccl" and mesh.shape == {"data": 1, "model": 1},
              f"world-1 mesh {dist.get_backend()} {mesh.shape}")
        torch.manual_seed(11)
        model = UNet(4, 3, device=dev)
        cfg = fused.StylizeConfig(**BENCH_STACK, fft_backend="dft_pallas")
        g = torch.Generator(device=dev).manual_seed(12)
        B = TRAIN_SHAPE[0]
        batches = [(torch.randn(TRAIN_SHAPE, generator=g, device=dev),
                    (torch.rand((B, 3) + TRAIN_SHAPE[2:], generator=g, device=dev) < 0.3).float(),
                    fused.sample_draws(cfg, TRAIN_SHAPE[2:], B, TRAIN_SHAPE[1], generator=g,
                                       device=dev))
                   for _ in range(DP_EQUAL_STEPS)]

        def state_of(lr):
            m = replicate(mesh, model)
            return create_seg_state(m, torch.optim.SGD(m.parameters(), lr=lr), device=dev)

        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        try:
            plain, par = state_of(1.0), state_of(1.0)
            losses = []
            for image, label, draws in batches:
                a = seg_train_step(plain, image, label, cfg, draws=draws, device=dev)
                b = seg_train_step(par, image, label, cfg, draws=draws, device=dev, mesh=mesh)
                losses.append((float(a), float(b)))
                check(torch.equal(a, b), f"world-1 data-parallel loss {float(b)} != {float(a)}")
            for (k, p), q in zip(plain.model.named_parameters(), par.model.parameters()):
                check(torch.equal(p, q), f"world-1 data-parallel step differs at {k}")
            # launches of the data-parallel path alone
            _zero_launch_counts()
            pallas_dft.tier_launches.clear()
            for _ in range(DP_LAUNCH_STEPS):
                seg_train_step(par, *batches[0][:2], cfg, generator=g, device=dev, mesh=mesh)
            torch.cuda.synchronize()
            launches = _launch_counts()
            tiers = dict(pallas_dft.tier_launches)
            for body, per_step in LAUNCHES_PER_STEP.items():
                n = launches[f"axis_dft_{body}"]
                check(n == per_step * DP_LAUNCH_STEPS,
                      f"data-parallel path: {body} launched {n} times in {DP_LAUNCH_STEPS} steps")
                key = (body, pallas_dft.route(body, PATH_TIER), PATH_TIER)
                check(tiers.get(key, 0) == n, f"data-parallel path: {body} {tiers}")
            check(not any(v for k, v in launches.items() if not k.startswith("axis_dft")),
                  f"data-parallel path launched another kernel: {launches}")
            # ms a step, in turns; the gradient all-reduce alone
            timed = {"plain": state_of(1e-3), "data_parallel": state_of(1e-3)}
            ms = {k: [] for k in timed}
            for _ in range(DP_TIMED_ROUNDS):
                for tag, st in timed.items():
                    for _ in range(DP_TIMED_STEPS):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        seg_train_step(st, *batches[0][:2], cfg, generator=g, device=dev,
                                       mesh=mesh if tag == "data_parallel" else None)
                        torch.cuda.synchronize()
                        ms[tag].append((time.perf_counter() - t0) * 1e3)
            params = list(timed["data_parallel"].model.parameters())
            allreduce_ms = cuda_ms(lambda: dp.mean_gradients(params, mesh), 10)
        finally:
            torch.backends.cudnn.deterministic = False
    finally:
        dist.destroy_process_group()
    return {"backend": "nccl", "world": 1, "losses_plain_vs_dp": losses,
            "bit_equal_steps": DP_EQUAL_STEPS, "launches": launches,
            "launches_by_route_and_tier": {" ".join(k): v for k, v in tiers.items()},
            "launch_steps": DP_LAUNCH_STEPS,
            "ms_per_step": {k: v for k, v in ms.items()},
            "ms_per_step_median": {k: statistics.median(v[1:]) for k, v in ms.items()},
            "grad_allreduce_ms": allreduce_ms,
            "grad_allreduce_mb": sum(p.numel() for p in params) * 4 / 1e6}


def _par_rank_setup(rank: int, world: int, store: str):
    """A 2-rank worker: gloo on the one card, TF32 off, deterministic cuDNN."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dist.init_process_group("gloo", init_method=store, world_size=world, rank=rank)
    return torch.device("cuda", 0)


def _probe(dev, rank: int, world: int) -> dict:
    """Each collective of PAR_COLLECTIVES on a CUDA tensor, checked."""
    import torch.distributed as dist

    base = torch.arange(2 * world, dtype=torch.float32, device=dev)
    x = base + 100 * rank
    ranks = torch.arange(world, dtype=torch.float32, device=dev)
    got = {}
    t = x.clone()
    dist.all_reduce(t)
    got["all_reduce_sum"] = torch.equal(t, base * world + 100 * ranks.sum())
    for name, op, want in (("all_reduce_min", dist.ReduceOp.MIN, base),
                           ("all_reduce_max", dist.ReduceOp.MAX, base + 100 * (world - 1))):
        t = x.clone()
        dist.all_reduce(t, op=op)
        got[name] = torch.equal(t, want)
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x)
    got["all_gather"] = all(torch.equal(p, base + 100 * j) for j, p in enumerate(parts))
    t = torch.empty_like(x)
    dist.all_to_all_single(t, x)
    got["all_to_all_single"] = torch.equal(
        t, torch.cat([base[2 * rank:2 * rank + 2] + 100 * j for j in range(world)]))
    t = x.clone()
    dist.broadcast(t, src=0)
    got["broadcast"] = torch.equal(t, base)
    return got


def _par_stylize(dev, rank: int, world: int, mesh) -> dict:
    """The H-split stylize of a BraTS-size volume under the bench stack
    against ``stylize_kspace`` on the backend the split path resolves to."""
    import dataclasses

    import torch.distributed as dist

    from mvtb_tpu_torch.ops import fused
    from mvtb_tpu_torch.parallel.sharded_fft import shard_backend, stylize_kspace_sharded

    C, H, W, D = PAR_STYLIZE_SHAPE
    h = H // world
    g = torch.Generator().manual_seed(21)  # the same volume and draws on every rank
    x = torch.randn(PAR_STYLIZE_SHAPE, generator=g).to(dev)
    cfg = fused.StylizeConfig(**BENCH_STACK, fft_backend="dft_pallas")
    draws = fused.sample_draws(cfg, (H, W, D), 1, C, generator=g, device="cpu").to(dev)
    block = x[:, rank * h:(rank + 1) * h].contiguous()
    _zero_launch_counts()
    ms = []
    for _ in range(3):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = stylize_kspace_sharded(block, cfg, mesh, draws=draws)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = _launch_counts()
    check(not any(launches.values()), f"the H-split stylize launched a kernel: {launches}")
    parts = [torch.empty_like(got) for _ in range(world)]
    dist.all_gather(parts, got.contiguous())
    res = {"shape": PAR_STYLIZE_SHAPE, "launches": launches, "ms": ms,
           "ms_median": statistics.median(ms)}
    if rank == 0:
        backend = shard_backend(cfg, (H, W, D), dev)
        one = dataclasses.replace(cfg, fft_backend=backend)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = fused.stylize_kspace(x, one, draws=draws, device=dev)
        torch.cuda.synchronize()
        res["one_device_ms"] = (time.perf_counter() - t0) * 1e3
        err = rel_err(torch.cat(parts, dim=1), want)
        check(err <= PAR_STYLIZE_TOL,
              f"H-split stylize vs stylize_kspace ({backend}): {err:.3e} > {PAR_STYLIZE_TOL}")
        res.update(backend=backend, rel_err=err)
    return res


def _grad_rel(after: dict, ref_after: dict, start: dict) -> float:
    """|g - g_ref| / |g_ref| over the whole tree, the gradients read as the
    SGD(1.0) steps' parameter changes (``__graft_entry__.py:222-234``)."""
    sq_diff = sq_ref = 0.0
    for k, p0 in start.items():
        ga, gb = after[k].double() - p0.double(), ref_after[k].double() - p0.double()
        sq_diff += float(((ga - gb) ** 2).sum())
        sq_ref += float((gb ** 2).sum())
    return (sq_diff / max(sq_ref, 1e-30)) ** 0.5


def _par_spatial(dev, rank: int, world: int, mesh) -> dict:
    """The JAX package's full-volume case: the H-split stylize (disk r =
    12.5) feeding the H-split train step of the full-width UNet, against
    the one-rank step on the same stylized volume."""
    import numpy as np
    import torch.distributed as dist

    from mvtb_tpu_torch.data.synthetic import make_volume
    from mvtb_tpu_torch.models import UNet
    from mvtb_tpu_torch.ops import fused
    from mvtb_tpu_torch.parallel import replicate
    from mvtb_tpu_torch.parallel.sharded_fft import stylize_kspace_sharded
    from mvtb_tpu_torch.parallel.spatial import spatial_train_step
    from mvtb_tpu_torch.train import create_seg_state, seg_train_step

    H = PAR_FULL_VOLUME[0]
    h = H // world
    image, label = make_volume(np.random.RandomState(5), 4, PAR_FULL_VOLUME)
    rows = slice(rank * h, (rank + 1) * h)
    cfg = fused.StylizeConfig(disk_r=12.5, disk_prob=1.0)
    draws = fused.sample_draws(cfg, PAR_FULL_VOLUME, 1, 4,
                               generator=torch.Generator().manual_seed(8), device="cpu")
    styled = stylize_kspace_sharded(torch.from_numpy(image[:, rows]).to(dev), cfg, mesh,
                                    draws=draws)
    lbl = torch.from_numpy(label[:, rows]).to(dev)
    torch.manual_seed(9)
    model = UNet(4, 3, device=dev)
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    state = replicate(mesh, create_seg_state(model, torch.optim.SGD(model.parameters(), lr=1.0),
                                             device=dev))
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = float(spatial_train_step(state, styled[None], lbl[None], mesh, device=dev))
    torch.cuda.synchronize()
    res = {"volume": PAR_FULL_VOLUME, "loss": loss,
           "step_ms": (time.perf_counter() - t0) * 1e3,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    parts = [torch.empty_like(styled) for _ in range(world)]
    dist.all_gather(parts, styled.contiguous())
    after = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    del state
    if rank == 0:
        ref = UNet(4, 3, device=dev)
        ref.load_state_dict(start)
        rstate = create_seg_state(ref, torch.optim.SGD(ref.parameters(), lr=1.0), device=dev)
        full = torch.cat(parts, dim=1)[None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref_loss = float(seg_train_step(rstate, full, torch.from_numpy(label)[None].to(dev),
                                        device=dev))
        torch.cuda.synchronize()
        res["one_rank_step_ms"] = (time.perf_counter() - t0) * 1e3
        loss_rel = abs(loss - ref_loss) / max(abs(ref_loss), 1e-9)
        grad_rel = _grad_rel(after, dict(ref.named_parameters()), start)
        check(loss_rel <= PAR_LOSS_TOL, f"H-split step loss {loss} vs {ref_loss}")
        check(grad_rel <= PAR_GRAD_TOL, f"H-split step gradients: {grad_rel:.3e}")
        res.update(one_rank_loss=ref_loss, loss_rel_err=loss_rel, grad_rel_err=grad_rel)
    dist.barrier()
    return res


def _par_tp(dev, rank: int, world: int) -> dict:
    """A (data 1 x model 2) tensor-parallel step of the full-width UNet at
    the train phase's batch against the one-rank step."""
    import torch.distributed as dist

    from mvtb_tpu_torch.models import UNet
    from mvtb_tpu_torch.parallel import gather_params_tp, make_mesh, replicate, shard_state_tp
    from mvtb_tpu_torch.train import create_seg_state, seg_train_step

    mesh = make_mesh(n_data=1, n_model=world, device=dev)
    g = torch.Generator().manual_seed(31)
    B = TRAIN_SHAPE[0]
    image = torch.randn(TRAIN_SHAPE, generator=g).to(dev)
    label = (torch.rand((B, 3) + TRAIN_SHAPE[2:], generator=g) < 0.3).float().to(dev)
    torch.manual_seed(32)
    model = UNet(4, 3, device=dev)
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    def sgd_state():
        m = replicate(mesh, model)
        return create_seg_state(m, torch.optim.SGD(m.parameters(), lr=1.0), device=dev)

    one = sgd_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_loss = float(seg_train_step(one, image, label, device=dev))
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    ref_after = {k: p.detach().clone() for k, p in one.model.named_parameters()}
    del one
    tp = shard_state_tp(mesh, sgd_state())
    split = sum(len(getattr(m, "tp_split", {})) for m in tp.model.modules())
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = float(seg_train_step(tp, image, label, device=dev, mesh=mesh))
    torch.cuda.synchronize()
    tp_ms = (time.perf_counter() - t0) * 1e3
    after = gather_params_tp(mesh, tp.model)
    loss_rel = abs(loss - ref_loss) / max(abs(ref_loss), 1e-9)
    grad_rel = _grad_rel(after, ref_after, start)
    check(split > 0, "no parameter was split over the model axis")
    check(loss_rel <= PAR_LOSS_TOL, f"tensor-parallel loss {loss} vs {ref_loss}")
    check(grad_rel <= PAR_GRAD_TOL, f"tensor-parallel gradients: {grad_rel:.3e}")
    return {"mesh": mesh.shape, "split_params": split, "loss": loss, "one_rank_loss": ref_loss,
            "loss_rel_err": loss_rel, "grad_rel_err": grad_rel, "step_ms": tp_ms,
            "one_rank_step_ms": one_ms}


def parallel_rank(job: str, rank: int, world: int, store: str, out_path: str) -> int:
    """One rank of the parallel phase's 2-rank runs (``chip_smoke.py
    --parallel-rank job rank world store out``): ``checks`` probes the
    collectives and runs the 2-rank checks, each fatal; ``send_recv`` tries
    gloo's point-to-point send on a CUDA tensor."""
    import torch.distributed as dist

    dev = _par_rank_setup(rank, world, store)
    try:
        if job == "send_recv":
            x = torch.full((4,), float(rank), device=dev)
            if rank == 0:
                dist.send(x, 1)
            else:
                dist.recv(x, 0)
            res = {"send_recv": float(x[0]) == 0.0}
        else:
            from mvtb_tpu_torch.parallel import make_mesh

            res = {"collectives": _probe(dev, rank, world)}
            check(all(res["collectives"].values()), f"gloo on CUDA: {res['collectives']}")
            mesh = make_mesh(device=dev)
            res["stylize"] = _par_stylize(dev, rank, world, mesh)
            res["spatial"] = _par_spatial(dev, rank, world, mesh)
            res["tensor_parallel"] = _par_tp(dev, rank, world)
        torch.save(res, out_path)
    finally:
        dist.destroy_process_group()
    return 0


def _run_ranks(job: str, tmp: str, fatal: bool, timeout: float = PAR_TIMEOUT) -> tuple:
    """Start ``PAR_WORLD`` ranks of ``job`` (this script, ``--parallel-rank``)
    on a file store; returns (exit codes, outputs, results)."""
    store = f"file://{tmp}/{job}.store"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parallel-rank", job, str(r),
         str(PAR_WORLD), store, f"{tmp}/{job}.{r}.pt"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO)
        for r in range(PAR_WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if fatal:
        for r, (c, log) in enumerate(zip(codes, logs)):
            check(c == 0, f"parallel {job} rank {r} exited {c}:\n{log[-4000:]}")
    results = [torch.load(f"{tmp}/{job}.{r}.pt", weights_only=False) if c == 0 else None
               for r, c in enumerate(codes)]
    return codes, logs, results


def parallel_phase(dev) -> dict:
    """(a) the data-parallel ``seg_train_step`` on an NCCL world of one (the
    card holds one GPU, and NCCL takes one rank a device); (b) two gloo
    ranks sharing the card, in subprocesses whose exit codes are fatal: the
    collectives probed on CUDA tensors, then the H-split stylize, the
    full-volume H-split train step and a tensor-parallel step, each against
    its one-rank counterpart. The 2-rank times are correctness runs on one
    shared card, not scaling numbers."""
    import tempfile

    res = {"dp_world1": _dp_world1(dev)}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        codes, logs, _ = _run_ranks("send_recv", tmp, fatal=False, timeout=120)
        res["gloo_cuda_send_recv"] = {"exit_codes": codes, "ok": codes == [0] * PAR_WORLD,
                                      "error": next((l.strip().splitlines()[-1] for l in logs
                                                     if "Error" in l), None)}
        _, _, ranks = _run_ranks("checks", tmp, fatal=True)
        res["two_rank_seconds"] = time.perf_counter() - t0
    res["gloo_cuda_collectives"] = ranks[0]["collectives"]
    res["two_rank"] = {k: ranks[0][k] for k in ("stylize", "spatial", "tensor_parallel")}
    res["two_rank"]["rank1_ms"] = {"stylize": ranks[1]["stylize"]["ms_median"],
                                   "spatial_step": ranks[1]["spatial"]["step_ms"],
                                   "tensor_parallel_step": ranks[1]["tensor_parallel"]["step_ms"]}
    check(ranks[0]["spatial"]["loss"] == ranks[1]["spatial"]["loss"],
          "the H-split step's ranks report different losses")
    return res


# --------------------------------------------------------------------------
# serving: torch.export programs with the kernels as custom ops
# --------------------------------------------------------------------------

SERVE_TOL = 1e-5  # served program against its eager call, of the max
SERVE_TIMED = 5  # CUDA-event calls per median
SERVE_SHARDED_SHAPE = (2, 4, 128, 128, 64)
OP_TURNS, OP_STEPS = 2, 4  # op vs direct launch: rounds in turns, steps a round
DISPATCH_CALLS = 200


def _serve_subprocess(bundle: str, io_dir: str) -> dict:
    """Load the bundle in a process that imports only ``mvtb_tpu_torch.serve``
    (no model class) and serve the saved inputs; its results come back
    through ``io_dir``."""
    code = f"""
import json, statistics, sys, time, torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
t0 = time.perf_counter()
from mvtb_tpu_torch.serve import ServingBundle
from mvtb_tpu_torch.ops import fused_plane
serve = ServingBundle.load({bundle!r})
torch.cuda.synchronize()
load_s = time.perf_counter() - t0
inp = torch.load({io_dir!r} + "/inputs.pt", map_location="cuda", weights_only=False)
outs, launches = {{}}, {{}}
with torch.no_grad():
    for name in ("b2", "b1"):
        fused_plane.plane_stylize_half.launches = 0
        outs[name] = serve(*inp[name])
        torch.cuda.synchronize()
        launches[name] = fused_plane.plane_stylize_half.launches
    swapped = ServingBundle.load({bundle!r}, params=inp["params2"])
    outs["b2_params2"] = swapped(*inp["b2"])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ms = []
    for _ in range({SERVE_TIMED}):
        start.record()
        serve(*inp["b2"])
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
torch.save({{k: v.cpu() for k, v in outs.items()}}, {io_dir!r} + "/outputs.pt")
bad = [m for m in sys.modules if m.startswith("mvtb_tpu_torch.models")
       or m.split(".")[0] in ("jax", "flax", "mvtb_tpu")]
print(json.dumps({{"load_s": load_s, "launches": launches, "served_ms": ms,
                  "served_ms_median": statistics.median(ms), "models_imported": bad}}))
sys.exit(1 if bad else 0)
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    check(res.returncode == 0, f"the bundle's serving process failed:\n{res.stdout}\n{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def _served_eval(dev, tmp: str) -> dict:
    """The served eval program: ``UNet(stylize_batch(x))`` on ``plane`` at the
    slice shape, a batch-polymorphic bundle loaded in a process without
    model code, served at B = 2 and 1, and with other weights."""
    from mvtb_tpu_torch.models import UNet
    from mvtb_tpu_torch.ops import fused
    from mvtb_tpu_torch.serve import ServingBundle

    torch.manual_seed(40)
    model = UNet(4, 3, device=dev).eval()
    model2 = UNet(4, 3, device=dev).eval()
    cfg = fused.StylizeConfig(**BENCH_STACK, fft_backend="plane")

    def eval_fn(params, x, draws):
        styled = fused.stylize_batch(x, cfg, draws, device=x.device)
        return torch.func.functional_call(model, params, (styled,))

    params, params2 = dict(model.state_dict()), dict(model2.state_dict())
    g = torch.Generator(device=dev).manual_seed(41)
    B, C = SLICE_SHAPE[:2]
    x = torch.randn(SLICE_SHAPE, generator=g, device=dev)
    draws = fused.sample_draws(cfg, SLICE_SHAPE[2:], B, C, generator=g, device=dev)
    x1 = torch.randn((1,) + SLICE_SHAPE[1:], generator=g, device=dev)
    draws1 = fused.sample_draws(cfg, SLICE_SHAPE[2:], 1, C, generator=g, device=dev)
    bundle = os.path.join(tmp, "bundle")
    t0 = time.perf_counter()
    ServingBundle.save(bundle, eval_fn, params, (x, draws), batch_polymorphic=True,
                       extra_meta={"task": "corrupted-validation inference"})
    save_s = time.perf_counter() - t0
    torch.save({"b2": (x, draws), "b1": (x1, draws1), "params2": params2},
               os.path.join(tmp, "inputs.pt"))
    sub = _serve_subprocess(bundle, tmp)
    served = torch.load(os.path.join(tmp, "outputs.pt"), weights_only=True)
    errs = {}
    with torch.no_grad():
        for name, (xi, di), p in (("b2", (x, draws), params), ("b1", (x1, draws1), params),
                                  ("b2_params2", (x, draws), params2)):
            eager = eval_fn(p, xi, di)
            errs[name] = rel_err(served[name].to(dev), eager)
            check(tuple(served[name].shape) == tuple(eager.shape), f"served {name} shape")
            check(errs[name] <= SERVE_TOL, f"served eval {name} vs eager: {errs[name]:.3e}")
            del eager
        eager_ms = [cuda_ms(lambda: eval_fn(params, x, draws), 1, warmup=0)
                    for _ in range(SERVE_TIMED)]
    check(sub["launches"] == {"b2": 1, "b1": 1},
          f"the served eval program launched the plane kernel {sub['launches']} times a call")
    check(not torch.equal(served["b2"], served["b2_params2"]), "swapped params, same output")
    meta = ServingBundle.meta(bundle)
    check(meta["batch_polymorphic"] and meta["export_device"] == "cuda",
          f"meta {dict(meta, params=len(meta['params']))}")
    sizes = {name: os.path.getsize(os.path.join(bundle, f)) for name, f in
             (("program_bytes", ServingBundle.PROGRAM), ("params_bytes", ServingBundle.PARAMS))}
    check(sizes["program_bytes"] < sizes["params_bytes"],
          f"the program file holds more than the weights: {sizes}")
    return {"export_s": meta["export_s"], "save_s": save_s - meta["export_s"], **sub,
            "rel_err_vs_eager": errs, "eager_ms": eager_ms,
            "eager_ms_median": statistics.median(eager_ms), **sizes,
            "inputs": meta["inputs"]}


def _served_stylize(dev) -> dict:
    """``stylize_batch`` on ``dft_pallas`` at the bench shape, exported on the
    card and served: r2c, c2c, c2r launched 1, 4, 1 times a call at ``high``
    on the tensor-core body."""
    from mvtb_tpu_torch.ops import fused, pallas_dft
    from mvtb_tpu_torch.serve import export_fn, load_fn

    cfg = fused.StylizeConfig(**BENCH_STACK, fft_backend="dft_pallas")
    g = torch.Generator(device=dev).manual_seed(42)
    B, C = BENCH_SHAPE[:2]
    x = torch.randn(BENCH_SHAPE, generator=g, device=dev)
    draws = fused.sample_draws(cfg, BENCH_SHAPE[2:], B, C, generator=g, device=dev)

    def styl(img, d):
        return fused.stylize_batch(img, cfg, d, device=img.device)

    t0 = time.perf_counter()
    served = load_fn(export_fn(styl, (x, draws)), device=dev)
    export_load_s = time.perf_counter() - t0
    with torch.no_grad():
        _zero_launch_counts()
        pallas_dft.tier_launches.clear()
        out = served(x, draws)
        torch.cuda.synchronize()
        launches, tiers = _launch_counts(), dict(pallas_dft.tier_launches)
        eager = styl(x, draws)
        err = rel_err(out, eager)
        served_ms = cuda_ms(lambda: served(x, draws), SERVE_TIMED)
        eager_ms = cuda_ms(lambda: styl(x, draws), SERVE_TIMED)
    check(err <= STYLIZE_TOL, f"served stylize vs eager: {err:.3e} > {STYLIZE_TOL}")
    for body, n in LAUNCHES_PER_STEP.items():
        check(launches[f"axis_dft_{body}"] == n, f"served stylize: {body} {launches}")
        key = (body, "wgmma", PATH_TIER)
        check(tiers.get(key, 0) == n, f"served stylize: {body} {tiers}")
    check(not any(v for k, v in launches.items() if not k.startswith("axis_dft")),
          f"served stylize launched another kernel: {launches}")
    return {"bit_equal_to_eager": bool(torch.equal(out, eager)), "rel_err_vs_eager": err,
            "launches": launches,
            "launches_by_route_and_tier": {" ".join(k): v for k, v in tiers.items()},
            "export_and_load_s": export_load_s, "served_ms": served_ms, "eager_ms": eager_ms}


def _served_pointwise(dev) -> dict:
    """S&P and the polar round trip in one program, exported on the CPU and
    moved to the card by ``load_fn``: S&P bit-equal to its plain version,
    polar within POLAR_TOL elementwise, one launch of each a call."""
    from mvtb_tpu_torch.ops import pallas_kernels as pk
    from mvtb_tpu_torch.serve import export_fn, load_fn

    def fn(x, p, seed, re, im):
        return (pk.salt_and_pepper_pallas(x, p, seed),) + pk.polar_roundtrip_pallas(re, im)

    shape = POINTWISE_SHAPES["volume"]
    cpu_args = (torch.zeros(shape), torch.tensor(0.05), torch.tensor(7),
                torch.zeros(shape), torch.zeros(shape))
    served = load_fn(export_fn(fn, cpu_args), device=dev)
    g = torch.Generator(device=dev).manual_seed(43)
    x = torch.randn(shape, generator=g, device=dev)
    re, im = polar_inputs(shape, dev, seed=44)
    p, seed = torch.tensor(0.05, device=dev), torch.tensor(1234, device=dev)
    _zero_launch_counts()
    out = served(x, p, seed, re, im)
    torch.cuda.synchronize()
    launches = _launch_counts()
    sap_equal = torch.equal(out[0], pk.salt_and_pepper_plain(x, 0.05, 1234))
    polar_err = max(elementwise_rel(a, b) for a, b in
                    zip(out[1:], pk.polar_roundtrip_plain(re, im)))
    check(sap_equal, "served S&P vs plain: not bit-equal")
    check(polar_err <= POLAR_TOL, f"served polar vs plain: {polar_err:.3e}")
    check(launches["sap"] == 1 and launches["polar"] == 1
          and not any(v for k, v in launches.items() if k not in ("sap", "polar")),
          f"served S&P + polar launches {launches}")
    reseeded = served(x, p, seed + 1, re, im)[0]
    check(not torch.equal(reseeded, out[0]), "the served S&P ignores its seed input")
    return {"export_device": "cpu", "sap_bit_equal": sap_equal, "polar_max_rel_err": polar_err,
            "launches": launches}


def _served_sharded(dev) -> dict:
    """``export_sharded_fn`` on an NCCL world of one: the per-rank program of
    the data-sharded UNet forward against the plain forward."""
    import torch.distributed as dist

    from mvtb_tpu_torch.models import UNet
    from mvtb_tpu_torch.parallel import batch_sharding, make_mesh
    from mvtb_tpu_torch.serve import export_sharded_fn, load_fn, module_fn

    check(not dist.is_initialized(), "a process group is already running")
    mesh = make_mesh(device=dev)
    try:
        torch.manual_seed(45)
        model = UNet(4, 3, device=dev).eval()
        params = dict(model.state_dict())
        x = torch.randn(SERVE_SHARDED_SHAPE, generator=torch.Generator(device=dev).manual_seed(46),
                        device=dev)
        rows = batch_sharding(mesh, 5)
        served = load_fn(export_sharded_fn(module_fn(model), (params, x), mesh=mesh,
                                           in_shardings=(None, rows)), device=dev)
        with torch.no_grad():
            local = rows.local(x)
            err = rel_err(served(params, local), model(local))
        check(err <= SERVE_TOL, f"sharded served forward vs plain: {err:.3e}")
        return {"backend": dist.get_backend(), "mesh": served.mesh_shape,
                "rel_err_vs_plain": err}
    finally:
        dist.destroy_process_group()


def _op_overhead(dev) -> dict:
    """What the custom-op wrapping costs: the train step and ``stylize_batch``
    on ``dft_pallas`` with the axis kernels reached through ``mvtb::axis_dft``
    against the same launches called directly (the wrappers before the ops),
    in turns; and the host's time per call of one small axis kernel."""
    from mvtb_tpu_torch.models import UNet
    from mvtb_tpu_torch.ops import _ops, fused, pallas_dft
    from mvtb_tpu_torch.train import create_seg_state, reference_optimizer, seg_train_step

    op = _ops.axis_dft

    def direct(body, lane, ins, mats, precision):
        return list(pallas_dft.launch(body, lane, ins, mats, precision))

    torch.manual_seed(47)
    model = UNet(4, 3, device=dev, dtype=torch.bfloat16)
    state = create_seg_state(model, reference_optimizer(model.parameters()), device=dev)
    cfg = fused.StylizeConfig(**BENCH_STACK, fft_backend="dft_pallas")
    g = torch.Generator(device=dev).manual_seed(48)
    B = TRAIN_SHAPE[0]
    image = torch.randn(TRAIN_SHAPE, generator=g, device=dev)
    label = (torch.rand((B, 3) + TRAIN_SHAPE[2:], generator=g, device=dev) < 0.3).float()
    bench = torch.randn(BENCH_SHAPE, generator=g, device=dev)
    small = [torch.randn(64, 16, device=dev)]
    small_mats = pallas_dft._dft.device_mats("half", 16, False, dev)
    res = {k: {"custom_op": [], "direct": []} for k in
           ("train_step_ms", "stylize_batch_ms", "host_us_per_small_axis_call")}
    try:
        for _ in range(OP_TURNS):
            for mode in ("custom_op", "direct", "direct", "custom_op"):
                _ops.axis_dft = op if mode == "custom_op" else direct
                for _ in range(OP_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    seg_train_step(state, image, label, cfg, generator=g, device=dev)
                    torch.cuda.synchronize()
                    res["train_step_ms"][mode].append((time.perf_counter() - t0) * 1e3)
                with torch.no_grad():
                    res["stylize_batch_ms"][mode].append(cuda_ms(
                        lambda: fused.stylize_batch(bench, cfg, generator=g, device=dev), 3))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(DISPATCH_CALLS):
                    pallas_dft.lane_call("r2c", small, small_mats, PATH_TIER)
                res["host_us_per_small_axis_call"][mode].append(
                    (time.perf_counter() - t0) * 1e6 / DISPATCH_CALLS)
                torch.cuda.synchronize()
    finally:
        _ops.axis_dft = op
    return {k: {**v, **{f"{m}_median": statistics.median(v[m]) for m in v}}
            for k, v in res.items()}


def serve_phase(dev) -> dict:
    import tempfile

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        res["eval_program"] = _served_eval(dev, tmp)
    res["stylize_program"] = _served_stylize(dev)
    res["pointwise_program"] = _served_pointwise(dev)
    res["sharded_world1"] = _served_sharded(dev)
    res["custom_op_overhead"] = _op_overhead(dev)
    return res


# --------------------------------------------------------------------------
# compat: the reference's scripts through the port's shims
# --------------------------------------------------------------------------

COMPAT_SHAPE = (128, 128, 64)
COMPAT_STEPS = 3
COMPAT_TOL = 1e-4  # card against CPU, first step: loss and gradients, of the max


def compat_phase(dev) -> dict:
    """In a process of its own (the bare ``monai`` stays out of this one):
    the reference's ``baseline.py`` training loop verbatim through
    ``compat.install()``, 3 Adam steps on the card on a 2-volume batch from
    the shim's pipeline, its first step against the same loop on the CPU;
    and the ``Gibbs_UNet`` facade's finite-difference alpha update."""
    import tempfile

    code = f"""
import json, sys, time, numpy as np, torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.deterministic = True
from mvtb_tpu_torch import compat
compat.install()
from monai.apps import DecathlonDataset
from monai.data import DataLoader
from monai.losses import DiceLoss
from monai.networks.nets import UNet
from monai.transforms import (AsChannelFirstd, CenterSpatialCropd, Compose, LoadImaged,
    MapTransform, NormalizeIntensityd, Orientationd, Spacingd, ToTensord)
from monai.utils import set_determinism
from stylization_layers import Gibbs_UNet
from mvtb_tpu_torch.data.synthetic import build_decathlon_tree

class ConvertToMultiChannelBasedOnBratsClassesd(MapTransform):
    def __call__(self, data):
        d = dict(data)
        for key in self.keys:
            result = [np.logical_or(d[key] == 2, d[key] == 3),
                      np.logical_or(np.logical_or(d[key] == 2, d[key] == 3), d[key] == 1),
                      d[key] == 2]
            d[key] = np.stack(result, axis=0).astype(np.float32)
        return d

root = sys.argv[1]
t0 = time.perf_counter()
build_decathlon_tree(root, n=2, spatial={COMPAT_SHAPE}, kind="smooth",
                     affine=np.diag([1.5, 1.5, 2.0, 1.0]))
set_determinism(seed=0)
transform = Compose([
    LoadImaged(keys=["image", "label"]), AsChannelFirstd(keys="image"),
    ConvertToMultiChannelBasedOnBratsClassesd(keys="label"),
    Spacingd(keys=["image", "label"], pixdim=(1.5, 1.5, 2.0), mode=("bilinear", "nearest")),
    Orientationd(keys=["image", "label"], axcodes="RAS"),
    CenterSpatialCropd(keys=["image", "label"], roi_size={list(COMPAT_SHAPE)}),
    NormalizeIntensityd(keys="image", nonzero=True, channel_wise=True),
    ToTensord(keys=["image", "label"])])
train_ds = DecathlonDataset(root_dir=root, task="Task01_BrainTumour", transform=transform,
                            section="training", download=False, cache_num=100)
train_loader = DataLoader(train_ds, batch_size=2, shuffle=True, num_workers=4)
batch_data = next(iter(train_loader))
data_s = time.perf_counter() - t0

def run(device, start=None, steps={COMPAT_STEPS}):
    model = UNet(dimensions=3, in_channels=4, out_channels=3, channels=(16, 32, 64, 128, 256),
                 strides=(2, 2, 2, 2), num_res_units=2, device=device).to(device)
    if start is not None:
        model.load_state_dict(start)
    init = {{k: v.detach().cpu().clone() for k, v in model.state_dict().items()}}
    loss_function = DiceLoss(to_onehot_y=False, sigmoid=True, squared_pred=True)
    optimizer = torch.optim.Adam(model.parameters(), 1e-4, weight_decay=1e-5, amsgrad=True)
    losses, grads, ms = [], None, []
    for step in range(steps):
        t0 = time.perf_counter()
        inputs, labels = (batch_data["image"].to(device), batch_data["label"].to(device))
        optimizer.zero_grad()
        outputs = model(inputs)
        loss = loss_function(outputs, labels)
        loss.backward()
        optimizer.step()
        losses.append(loss.item())
        ms.append((time.perf_counter() - t0) * 1e3)
        if grads is None:
            grads = {{k: p.grad.detach().cpu().clone() for k, p in model.named_parameters()}}
    return init, losses, grads, ms, sum(p.numel() for p in model.parameters())

init, losses, grads, ms, n_params = run(torch.device("cuda:0"))
t0 = time.perf_counter()
_, cpu_losses, cpu_grads, _, _ = run(torch.device("cpu"), start=init, steps=1)
cpu_s = time.perf_counter() - t0
gmax = max(float(v.abs().max()) for v in cpu_grads.values())
grad_err = max(float((grads[k] - v).abs().max()) for k, v in cpu_grads.items()) / gmax

# the Gibbs_UNet facade's finite-difference alpha update on the card
device = torch.device("cuda:0")
model = Gibbs_UNet(0.7).to(device)
loss_function = DiceLoss(to_onehot_y=False, sigmoid=True, squared_pred=True)
inputs = batch_data["image"][:1, :1].to(device)
labels = batch_data["label"][:1, 1:2].to(device)

@torch.no_grad()
def Gibbs_GD(inputs, labels, model, h=0.05, learning_rate=0.2):
    old_alpha = model.gibbs.alpha.clone()
    loss_0 = loss_function(model(inputs), labels)
    model.gibbs.alpha = old_alpha + h
    loss_h = loss_function(model(inputs), labels)
    delta = (loss_h - loss_0) / h
    model.gibbs.alpha = old_alpha - learning_rate * delta
    return loss_0.item(), model.gibbs.alpha.item()

gd_loss, alpha = Gibbs_GD(inputs, labels, model)
print(json.dumps({{"unet_params": n_params, "losses": losses, "step_ms": ms,
                  "cpu_first_loss": cpu_losses[0], "first_loss_diff": abs(losses[0] - cpu_losses[0]),
                  "first_step_grad_err_over_max": grad_err, "cpu_step_s": cpu_s,
                  "data_s": data_s, "gibbs_fd": {{"loss": gd_loss, "alpha_before": 0.7,
                  "alpha_after": alpha, "alpha_in_parameters": any(
                      p is model.gibbs.alpha for p in model.parameters())}},
                  "monai_file": sys.modules["monai"].__file__}}))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run([sys.executable, "-c", code, tmp], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=900)
    check(res.returncode == 0, f"the compat process failed:\n{res.stdout}\n{res.stderr}")
    out = json.loads(res.stdout.strip().splitlines()[-1])
    check("mvtb_tpu_torch/compat" in out["monai_file"], f"monai is {out['monai_file']}")
    check(out["unet_params"] == 4_810_074, f"UNet has {out['unet_params']} parameters")
    check(all(math.isfinite(v) for v in out["losses"]), f"losses {out['losses']}")
    check(out["first_loss_diff"] <= COMPAT_TOL * max(1.0, abs(out["cpu_first_loss"])),
          f"card vs CPU first loss: {out['losses'][0]} vs {out['cpu_first_loss']}")
    check(out["first_step_grad_err_over_max"] <= COMPAT_TOL,
          f"card vs CPU first-step gradients: {out['first_step_grad_err_over_max']:.3e}")
    fd = out["gibbs_fd"]
    check(fd["alpha_after"] != fd["alpha_before"] and not fd["alpha_in_parameters"],
          f"Gibbs_UNet finite-difference update {fd}")
    return out


def kernels_line(sl, tr, rn, tm, ax, cp, pt, fr, dm, pl, sv) -> list:
    """The ``{"kernels": [...]}`` entries: the plane kernel from the eval
    path, the runner's fast profile, the domain runs' and the served eval
    program's (timed at the eval slice), each axis kernel from the train
    path, the fused-rest paths, the domain run on ``dft_pallas``, the
    data-parallel step and the served stylize (timed at the train shape),
    the pointwise kernels from the corruption path and the served S&P +
    polar program."""
    main_t = tm["plane slice"]
    domain = dm["runs"]
    served = sv["eval_program"]["launches"]
    by_path = {"eval_slice": sl["launches"],
               "runner_fast": rn["fast"]["launches"]["fused_plane"],
               "domain_plane_fast": domain["plane_fast"]["launches"]["fused_plane"],
               "served_eval": sum(served.values())}
    kernels = [{
        "name": "fused_plane", "route": "cuda",
        "source": "mvtb_tpu_torch/csrc/fused_plane.cu",
        "replaces": "mvtb_tpu/ops/fused_plane.py:218",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": main_t["max_abs_err"],
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms_fft2_ifft2_transform_only"]}]
    # the axis kernels per train step: the sum over the body's launches of
    # one stylize call at the train shape, in the tier the path runs
    rest = {body: sum(c["launches"][body] for c in fr["stylize"].values())
            for body in LAUNCHES_PER_STEP}
    for body in LAUNCHES_PER_STEP:
        rows = [r for k, r in ax.items()
                if k.startswith("train ") and r["body"] == body and r["precision"] == PATH_TIER]
        check(len(rows) == LAUNCHES_PER_STEP[body], f"{body}: {len(rows)} timed views")
        worst_row = max(rows, key=lambda r: r["bound_ms"])
        on_domain = domain["dft_pallas"]["launches"][f"axis_dft_{body}"]
        on_dp = pl["dp_world1"]["launches"][f"axis_dft_{body}"]
        on_served = sv["stylize_program"]["launches"][f"axis_dft_{body}"]
        kernels.append({
            "name": f"axis_dft_{body}", "route": "cuda",
            "source": "mvtb_tpu_torch/csrc/axis_dft.cu",
            "replaces": AXIS_REPLACES[body],
            "launches": tr["launches"][body] + rest[body] + on_domain + on_dp + on_served,
            "launches_by_path": {"train": tr["launches"][body], "fused_rest": rest[body],
                                 "domain_dft_pallas": on_domain, "parallel_dp": on_dp,
                                 "served_stylize": on_served},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows), "bound_by": worst_row["bound_by"],
            "library_ms": sum(r["library_ms"] for r in rows)})
    # the pointwise kernels from the corruption path, timed at its volume
    for name in ("sap", "polar"):
        t = pt[name]
        on_served = sv["pointwise_program"]["launches"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": "mvtb_tpu_torch/csrc/pointwise.cu",
            "replaces": POINTWISE_REPLACES[name],
            "launches": cp["launches"][name] + on_served,
            "launches_by_path": {"corruption": cp["launches"][name],
                                 "served_pointwise": on_served},
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})  # no single PyTorch call: see composite_torch_ms
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run", file=sys.stderr)
        return 2
    from mvtb_tpu_torch.ops import _build

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = smi_line()
    out({"env": {"nvidia_smi": smi, "torch": torch.__version__,
                 "cuda": torch.version.cuda, "python": sys.version.split()[0],
                 "device_count": torch.cuda.device_count(),
                 "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                 "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                 "float32_matmul_precision": torch.get_float32_matmul_precision()}})

    t0 = time.perf_counter()
    built = _build.build()
    out({"build_s": time.perf_counter() - t0, "per_kernel_s": built})
    for name in _build.SOURCES:
        log = (_build.BUILD_DIR / f"{name}.log")
        if log.is_file():
            for line in ptxas_lines(name, log.read_text()):
                out(line)

    t0 = time.perf_counter()
    worst = kernel_phase(dev)
    out({"kernel_phase_max_rel_err": worst, "tolerance": TOL,
         "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    axis_worst = axis_kernel_phase(dev)
    out({"axis_kernel_phase": axis_worst, "tolerance": AXIS_TOL,
         "exact_ratio": EXACT_RATIO, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    sl = slice_phase(dev)
    sl["seconds"] = time.perf_counter() - t0
    out({"slice_phase": sl})

    t0 = time.perf_counter()
    tr = train_phase(dev)
    tr["seconds"] = time.perf_counter() - t0
    out({"train_phase": tr})

    t0 = time.perf_counter()
    rn = runner_phase(dev)
    rn["seconds"] = time.perf_counter() - t0
    out({"runner_phase": rn, "card": smi})

    t0 = time.perf_counter()
    pw = pointwise_kernel_phase(dev)
    out({"pointwise_kernel_phase": pw, "polar_tolerance": POLAR_TOL,
         "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    cp = corruption_phase(dev)
    cp["seconds"] = time.perf_counter() - t0
    out({"corruption_phase": cp, "card": smi})

    t0 = time.perf_counter()
    fr = fused_rest_phase(dev)
    fr["seconds"] = time.perf_counter() - t0
    out({"fused_rest_phase": fr, "card": smi})
    t0 = time.perf_counter()
    gp = gan_phase(dev)
    gp["seconds"] = time.perf_counter() - t0
    out({"gan_phase": gp, "card": smi})
    t0 = time.perf_counter()
    dm = domain_phase(dev)
    dm["seconds"] = time.perf_counter() - t0
    out({"domain_phase": dm, "card": smi})
    t0 = time.perf_counter()
    lp = learnable_phase(dev)
    lp["seconds"] = time.perf_counter() - t0
    out({"learnable_phase": lp, "card": smi})

    t0 = time.perf_counter()
    pl = parallel_phase(dev)
    pl["seconds"] = time.perf_counter() - t0
    out({"parallel_phase": pl, "card": smi})
    t0 = time.perf_counter()
    sv = serve_phase(dev)
    sv["seconds"] = time.perf_counter() - t0
    out({"serve_phase": sv, "card": smi})
    t0 = time.perf_counter()
    cm = compat_phase(dev)
    cm["seconds"] = time.perf_counter() - t0
    out({"compat_phase": cm, "card": smi})

    t0 = time.perf_counter()
    tm = timing_phase(dev)
    out({"timing": tm, "card": smi, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    ax = axis_timing(dev)
    out({"axis_timing": ax, "card": smi, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    pt = pointwise_timing(dev)
    out({"pointwise_timing": pt, "card": smi, "seconds": time.perf_counter() - t0})

    kernels = kernels_line(sl, tr, rn, tm, ax, cp, pt, fr, dm, pl, sv)
    out(smi_line())
    out({"kernels": kernels})
    out({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        job, rank, world, store, out_path = sys.argv[2:7]
        sys.exit(parallel_rank(job, int(rank), int(world), store, out_path))
    sys.exit(main())
