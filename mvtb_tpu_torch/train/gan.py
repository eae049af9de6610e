"""GAN training steps: DCGAN synthesis and ReconGAN reconstruction
(counterpart of mvtb_tpu/train/gan.py).

Loss and optimizer parity with the reference loops:

* DCGAN (``50_reconstruction/dcgan.py:83-153``): D minimises
  ``bce(D(x), real_label) + bce(D(G(z)), 0)``, G minimises
  ``bce(D(G(z)), 1)`` against the updated D; Adam(2e-4, beta1=0.5).
* ReconGAN, image domain (``reconGan/reconGan.py:120-141``): G's loss is
  ``adv + alpha * mse(down, G(down)) + gamma * mse(G(compress(real)), real)``
  with the undersampled input from a k-space zero-fill (p = 0.2).
* ReconGAN, frequency domain (``reconGan_freq.py:120-150``):
  ``adv + alpha * mse(real, fake) + gamma * (mse(Re k) + mse(Im k))`` with
  ``torch.fft.fftn`` over (H, W) inside the loss (the JAX package's
  ``jnp.fft``, outside any kernel).
* Gibbs GAN (``351_adversarial_gibbs/gibbs_gan.py:50,94-106``): compress is
  a 2D Gibbs stylization with alpha ~ U[0, 1], and the real batch is
  compressed too.

Tensors are NCHW. ``torch.optim.Adam(lr, betas=(beta1, 0.999), eps=1e-8)``
is optax ``adam``'s arithmetic. Random numbers are explicit: ``dcgan_step``
takes its ``z``, ``recon_gan_step`` its three compress draws
(:func:`sample_recon_draws`, the JAX step's k0, k1, k2).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.models.dcgan import BatchNorm, frozen_batch_stats
from mvtb_tpu_torch.ops.corruptions import rand_zero_fill
from mvtb_tpu_torch.ops.fused import StageDraws, StylizeConfig, sample_draws, stylize_batch
from mvtb_tpu_torch.parallel import dp
from mvtb_tpu_torch.parallel.collectives import all_reduce_sum
from mvtb_tpu_torch.train.losses import bce_with_logits, mse

# one compress draw: the zero-fill's uniform field, or the Gibbs stylization's
CompressDraw = Union[torch.Tensor, StageDraws]


@dataclasses.dataclass
class GANState:
    """One network of a GAN and its optimizer (JAX: ``GANState``, whose
    ``batch_stats`` are the module's BatchNorm buffers here). ``step``
    counts the optimizer's updates."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def gan_optimizer(params, lr: float = 2e-4, beta1: float = 0.5) -> torch.optim.Adam:
    """optax ``adam(lr, b1=beta1, b2=0.999)``: eps 1e-8 outside the square
    root, bias-corrected moments."""
    return torch.optim.Adam(params, lr=lr, betas=(beta1, 0.999), eps=1e-8)


def create_gan_state(model: torch.nn.Module, lr: float = 2e-4,
                     beta1: float = 0.5) -> GANState:
    """The model in training mode with its Adam."""
    model.train()
    return GANState(model=model, optimizer=gan_optimizer(model.parameters(), lr, beta1))


def _apply_grads(state: GANState, loss: torch.Tensor, mesh=None) -> None:
    params = [p for p in state.model.parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, params)
    for p, g in zip(params, grads):
        p.grad = g
    if mesh is not None:
        dp.mean_gradients(params, mesh)
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.step += 1


@contextlib.contextmanager
def _global_batch_stats(mesh, *modules: torch.nn.Module):
    """Under a mesh, every :class:`~mvtb_tpu_torch.models.dcgan.BatchNorm`
    of ``modules`` takes its statistics over the global batch (sums
    all-reduced over ``data``, with gradients), as GSPMD computes them for
    the JAX step."""
    norms = [m for mod in modules for m in mod.modules() if isinstance(m, BatchNorm)]
    if mesh is not None:
        group = mesh.group("data")
        for m in norms:
            m.batch_sum = lambda t: all_reduce_sum(t, group)
    try:
        yield
    finally:
        for m in norms:
            m.batch_sum = None


def dcgan_step(g: GANState, d: GANState, real: torch.Tensor, z: torch.Tensor,
               real_label: float = 1.0, mesh=None) -> Dict[str, torch.Tensor]:
    """One DCGAN iteration, D then G, updating both states in place.

    ``real``: (B, nc, H, W) in [-1, 1]; ``z``: (B, nz, 1, 1) ~ N(0, 1).
    ``real_label < 1`` is one-sided label smoothing on D's real targets.
    Returns the device scalars ``d_loss``, ``g_loss``, ``D_x``, ``D_G_z1``,
    ``D_G_z2``.

    The JAX step's batch-statistics bookkeeping: G's first forward (the fake
    D trains on) keeps no running averages, and G's loss forward updates
    them from the old ones. Both forwards see the same parameters and z, so
    one forward that updates them once is the same step; its output, cut
    from the graph, is D's fake, and its graph carries G's loss. D's running
    averages are updated by the real batch, then the fake one; D's forward
    inside G's loss, with D's updated parameters, updates none.

    ``mesh`` makes the step data-parallel: ``real`` and ``z`` are this
    rank's rows of the global batch, every BatchNorm takes the global
    batch's statistics, the gradients are averaged over ``data`` and the
    returned values are global means, so the step equals the one-process
    step over the whole batch.
    """
    with _global_batch_stats(mesh, g.model, d.model):
        fake = g.model(z)

        out_real = d.model(real)
        out_fake1 = d.model(fake.detach())
        d_loss = (bce_with_logits(out_real, torch.full_like(out_real, real_label))
                  + bce_with_logits(out_fake1, torch.zeros_like(out_fake1)))
        _apply_grads(d, d_loss, mesh)

        with frozen_batch_stats(d.model):
            out_fake2 = d.model(fake)
        g_loss = bce_with_logits(out_fake2, torch.ones_like(out_fake2))
        _apply_grads(g, g_loss, mesh)

    out = {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
           "D_x": torch.sigmoid(out_real.detach()).mean(),
           "D_G_z1": torch.sigmoid(out_fake1.detach()).mean(),
           "D_G_z2": torch.sigmoid(out_fake2.detach()).mean()}
    if mesh is None:
        return out
    return {k: dp.global_mean(v, mesh) for k, v in out.items()}


def gibbs_compress_config(n_dims: int = 2) -> StylizeConfig:
    """The Gibbs GAN's compress: ``RandGibbsNoise(1.0)``, alpha ~ U[0, 1]."""
    return StylizeConfig(n_dims=n_dims, gibbs_alpha=(0.0, 1.0))


def sample_recon_draws(compress_kind: str, shape, generator: Optional[torch.Generator] = None,
                       device: DeviceLike = None) -> Tuple[CompressDraw, ...]:
    """The three compress draws of one :func:`recon_gan_step` on an NCHW
    batch of ``shape`` (the JAX step's k0, k1, k2: pre-corruption of the
    real batch, the undersampled input, the image-domain cycle): for
    ``"zf"`` a uniform field of ``shape`` each, for ``"gibbs"`` the 2D
    stylization's :class:`StageDraws`."""
    dev = resolve_device(device)
    B, C = shape[:2]
    if compress_kind == "zf":
        return tuple(torch.rand(tuple(shape), generator=generator, device=dev)
                     for _ in range(3))
    if compress_kind == "gibbs":
        cfg = gibbs_compress_config(len(shape) - 2)
        return tuple(sample_draws(cfg, shape[2:], B, C, generator=generator, device=dev)
                     for _ in range(3))
    raise ValueError(f"unknown compress_kind {compress_kind!r}")


def compress(batch: torch.Tensor, draw: CompressDraw, compress_kind: str,
             zf_p: float = 0.2) -> torch.Tensor:
    """Undersample an NCHW batch: a k-space zero-fill over each sample's
    (C, H, W) with the uniform field ``draw``, or the 2D Gibbs stylization
    with its draws (``fft_backend="auto"``: the matmul DFT on the card)."""
    if compress_kind == "zf":
        return rand_zero_fill(batch, zf_p, u=draw, n_dims=batch.ndim - 2)
    if compress_kind == "gibbs":
        return stylize_batch(batch, gibbs_compress_config(batch.ndim - 2), draws=draw,
                             device=batch.device)
    raise ValueError(f"unknown compress_kind {compress_kind!r}")


def recon_gan_step(g: GANState, d: GANState, real: torch.Tensor,
                   draws: Sequence[CompressDraw], zf_p: float = 0.2,
                   alpha: float = 1.0, gamma: float = 10.0,
                   freq_domain: bool = False, compress_kind: str = "zf",
                   pre_corrupt_real: bool = False,
                   real_label: float = 1.0) -> Dict[str, torch.Tensor]:
    """One ReconGAN iteration (instance-norm nets, no running statistics),
    D then G, updating both states in place.

    ``real``: (B, C, H, W) slices; ``draws``: the three compress draws of
    :func:`sample_recon_draws`. ``freq_domain=False`` is the image-domain
    cyclic loss (alpha=1, gamma=10), True the frequency-consistency loss
    (the reference runs alpha=15, gamma=0.1). Returns the device scalars
    ``d_loss``, ``g_loss``, ``adv``.

    G's forward on the undersampled batch is run once: cut from the graph it
    is D's fake, and its graph carries G's loss (the JAX step runs it twice
    with the same parameters and input).
    """
    k0, k1, k2 = draws
    with torch.no_grad():
        if pre_corrupt_real:
            real = compress(real, k0, compress_kind, zf_p)
        downsampled = compress(real, k1, compress_kind, zf_p)

    fake = g.model(downsampled)
    out_real = d.model(real)
    out_fake = d.model(fake.detach())
    d_loss = (bce_with_logits(out_real, torch.full_like(out_real, real_label))
              + bce_with_logits(out_fake, torch.zeros_like(out_fake)))
    _apply_grads(d, d_loss)

    out = d.model(fake)
    adv = bce_with_logits(out, torch.ones_like(out))
    if freq_domain:
        rk = torch.fft.fftn(real, dim=(-2, -1))
        fk = torch.fft.fftn(fake, dim=(-2, -1))
        freq_consistency = mse(rk.real, fk.real) + mse(rk.imag, fk.imag)
        cyclic = alpha * mse(real, fake) + gamma * freq_consistency
    else:
        with torch.no_grad():
            real_down = compress(real, k2, compress_kind, zf_p)
        cyclic = (alpha * mse(downsampled, fake)
                  + gamma * mse(g.model(real_down), real))
    g_loss = adv + cyclic
    _apply_grads(g, g_loss)
    return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(), "adv": adv.detach()}
