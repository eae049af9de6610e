"""Chunked training over a device-resident pool (counterpart of
mvtb_tpu/train/chunked.py): K steps per call with one host read.

The JAX package runs a chunk as one jitted ``fori_loop``. Here a chunk is a
host loop of K :func:`~mvtb_tpu_torch.train.seg.seg_train_step` calls whose
batches are taken on the device (``index_select`` of pool rows), whose
losses are summed on the device, and whose mean comes back as a device
scalar: the caller reads it once a chunk, and nothing in the loop waits
for the card. Capturing the chunk in a CUDA graph is ROADMAP.md section 4
item 5's host-dispatch step.

The GAN chunk functions (:func:`make_dcgan_chunk_fn`,
:func:`make_recon_gan_chunk_fn`) run K steps of
:mod:`~mvtb_tpu_torch.train.gan` the same way and stack the per-step curves
on the device, so a chunk costs one host read too, and
:func:`make_learnable_chunk_fn` runs K learnable-stylization steps of
:mod:`~mvtb_tpu_torch.train.learnable` with the per-step trajectory of the
stylization parameter stacked on the device.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.ops.fused import StageDraws, StylizeConfig
from mvtb_tpu_torch.train.seg import SegState, seg_train_step
from mvtb_tpu_torch.utils.profiling import span

# row order of the stacked per-step curves the GAN chunk functions return
DCGAN_CURVES = ("g_loss", "d_loss", "D_x", "D_G_z1", "D_G_z2")
RECON_CURVES = ("g_loss", "d_loss", "adv")


def make_chunk_fn(stylize: Optional[StylizeConfig],
                  device: DeviceLike = None) -> Callable:
    """Build the K-steps-per-call training function.

    Returns ``chunk_fn(state, generator, pool_images, pool_labels, idxs,
    draws=None) -> (state, generator, mean_loss)``. ``idxs`` is a (K, B)
    integer tensor of pool rows per step, on the pools' device; the state
    is updated in place and returned, as is ``generator``, from which each
    step's stylization draws follow one another. ``draws``, a list of K
    :class:`~mvtb_tpu_torch.ops.fused.StageDraws`, fixes every step's
    draws instead. ``mean_loss`` is the float32 mean of the K losses, a
    device scalar (the reference logs the per-epoch mean loss).
    ``device=None`` means ``"cuda"``; the state and pools live there.
    """
    dev = resolve_device(device)

    def chunk_fn(state: SegState, generator: Optional[torch.Generator],
                 pool_i: torch.Tensor, pool_l: torch.Tensor, idxs: torch.Tensor,
                 draws: Optional[Sequence[StageDraws]] = None):
        n = idxs.shape[0]
        if draws is not None and len(draws) != n:
            raise ValueError(f"{len(draws)} draws for a chunk of {n} steps")
        with span("mvtb.chunk"):
            total = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(n):
                img = pool_i.index_select(0, idxs[i])
                lbl = pool_l.index_select(0, idxs[i])
                loss = seg_train_step(state, img, lbl, stylize,
                                      draws=None if draws is None else draws[i],
                                      generator=generator, device=dev)
                total += loss.float()
            return state, generator, total / n

    return chunk_fn


def make_learnable_chunk_fn(fd_mode: bool, train_alpha: bool = True,
                            fd_h: float = 0.01, fd_lr: float = 0.02,
                            device: DeviceLike = None) -> Callable:
    """K learnable-stylization steps per call over a pool on the device:
    :func:`~mvtb_tpu_torch.train.learnable.fd_train_step` (``fd_h``,
    ``fd_lr``) with ``fd_mode``, else
    :func:`~mvtb_tpu_torch.train.learnable.learnable_train_step`
    (``train_alpha``).

    Returns ``chunk_fn(state, generator, pool_i, pool_l, idxs) -> (state,
    generator, mean_loss, trajectory)``: step ``i`` trains on the pool rows
    ``idxs[i]`` (``index_select``), its spike locations drawn from
    ``generator``; ``mean_loss`` is the
    float32 mean of the K losses and ``trajectory`` the (K,) float32
    stylization parameter after each step (the reference logs it every
    step), both device tensors, so the caller reads once a chunk.
    """
    from mvtb_tpu_torch.train.learnable import fd_train_step, learnable_train_step

    dev = resolve_device(device)

    def chunk_fn(state: SegState, generator: Optional[torch.Generator],
                 pool_i: torch.Tensor, pool_l: torch.Tensor, idxs: torch.Tensor):
        n = idxs.shape[0]
        total = torch.zeros((), dtype=torch.float32, device=dev)
        trajectory = []
        for i in range(n):
            img = pool_i.index_select(0, idxs[i])
            lbl = pool_l.index_select(0, idxs[i])
            if fd_mode:
                loss, alpha = fd_train_step(state, img, lbl, generator=generator,
                                            h=fd_h, lr=fd_lr, device=dev)
            else:
                loss, alpha = learnable_train_step(state, img, lbl, generator=generator,
                                                   train_alpha=train_alpha, device=dev)
            total += loss.float()
            trajectory.append(alpha.float())
        return state, generator, total / n, torch.stack(trajectory)

    return chunk_fn


def make_dcgan_chunk_fn(nz: int, real_label: float = 1.0,
                        device: DeviceLike = None) -> Callable:
    """K DCGAN iterations per call over a slice pool on the device.

    Returns ``chunk_fn(g_state, d_state, generator, pool, idxs) -> (g_state,
    d_state, generator, curves)``: step ``i`` trains on the pool rows
    ``idxs[i]`` (``index_select``) with ``z ~ N(0, 1)`` drawn from
    ``generator``; ``curves`` is one (5, K) float32 device tensor of the
    per-step ``DCGAN_CURVES``, the five numbers the reference prints
    (``50_reconstruction/dcgan.py:140-148``), read once a chunk.
    """
    from mvtb_tpu_torch.train.gan import dcgan_step

    dev = resolve_device(device)

    def chunk_fn(g_state, d_state, generator: Optional[torch.Generator],
                 pool: torch.Tensor, idxs: torch.Tensor):
        rows = []
        for i in range(idxs.shape[0]):
            real = pool.index_select(0, idxs[i])
            z = torch.randn((real.shape[0], nz, 1, 1), generator=generator, device=dev)
            m = dcgan_step(g_state, d_state, real, z, real_label=real_label)
            rows.append(torch.stack([m[k].float() for k in DCGAN_CURVES]))
        return g_state, d_state, generator, torch.stack(rows, dim=1)

    return chunk_fn


def make_recon_gan_chunk_fn(zf_p: float, alpha: float, gamma: float,
                            freq_domain: bool, compress_kind: str,
                            pre_corrupt_real: bool, real_label: float = 1.0,
                            device: DeviceLike = None) -> Callable:
    """K ReconGAN / Gibbs-GAN iterations per call, as
    :func:`make_dcgan_chunk_fn`: each step's three compress draws come from
    ``generator`` (:func:`~mvtb_tpu_torch.train.gan.sample_recon_draws`),
    and ``curves`` is one (3, K) device tensor of ``RECON_CURVES``."""
    from mvtb_tpu_torch.train.gan import recon_gan_step, sample_recon_draws

    dev = resolve_device(device)

    def chunk_fn(g_state, d_state, generator: Optional[torch.Generator],
                 pool: torch.Tensor, idxs: torch.Tensor):
        rows = []
        for i in range(idxs.shape[0]):
            real = pool.index_select(0, idxs[i])
            draws = sample_recon_draws(compress_kind, real.shape, generator, dev)
            m = recon_gan_step(g_state, d_state, real, draws, zf_p=zf_p, alpha=alpha,
                               gamma=gamma, freq_domain=freq_domain,
                               compress_kind=compress_kind,
                               pre_corrupt_real=pre_corrupt_real, real_label=real_label)
            rows.append(torch.stack([m[k].float() for k in RECON_CURVES]))
        return g_state, d_state, generator, torch.stack(rows, dim=1)

    return chunk_fn


def train_chunked(state: SegState, pool_images: torch.Tensor,
                  pool_labels: torch.Tensor, *, steps: int, batch_size: int,
                  generator: Optional[torch.Generator] = None,
                  stylize: Optional[StylizeConfig] = None, chunk: int = 100,
                  sample_rng: Optional[np.random.RandomState] = None,
                  log: Callable[[str], None] = print, name: str = "train",
                  device: DeviceLike = None) -> Tuple[SegState, List[dict]]:
    """Drive :func:`make_chunk_fn` to ``steps`` steps; returns (state, loss
    history: one ``{"step", "loss"}`` record per chunk). Pool rows are drawn
    with ``sample_rng.randint`` (``RandomState(0)`` by default), as in the
    JAX package."""
    dev = resolve_device(device)
    chunk_fn = make_chunk_fn(stylize, dev)
    rng = sample_rng or np.random.RandomState(0)
    losses = []
    done = 0
    t0 = time.time()
    while done < steps:
        n = min(chunk, steps - done)
        idxs = torch.from_numpy(rng.randint(0, pool_images.shape[0],
                                            (n, batch_size))).to(dev)
        state, generator, loss = chunk_fn(state, generator, pool_images,
                                          pool_labels, idxs)
        done += n
        val = float(loss)  # the one host read of the chunk
        losses.append({"step": done, "loss": val})
        log(f"[{name}] step {done}/{steps} loss {val:.4f} "
            f"({time.time() - t0:.0f}s)")
    return state, losses
