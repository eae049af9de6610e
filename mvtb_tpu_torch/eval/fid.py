"""FID-style evaluation for the GAN family (counterpart of
mvtb_tpu/eval/fid.py).

:func:`frechet_distance` is the exact classic formula on numpy statistics
and takes features from any extractor. With no pretrained Inception,
features come from a frozen fixed-seed conv encoder
(:class:`FrozenFeatureEncoder`: random-projection features whose space never
moves, so scores compare across runs and checkpoints). The discriminator's
penultimate conv is an explicit opt-in only (``features="discriminator"``):
its feature space trains with the generator.

The JAX encoder's weights come from flax's threefry init, which torch cannot
replay; the port draws its own from a ``torch.Generator`` with the same
seed and the same distribution (flax ``Conv``'s lecun-normal). So the port's
FID compares across the port's runs, and is not numerically equal to a JAX
run's. Pass the JAX weights through ``weights=`` to reproduce a JAX number
(:func:`~mvtb_tpu_torch.models.convert.fid_encoder_weights_from_flax`).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.models.resunet_gan import lecun_normal_
from mvtb_tpu_torch.models.unet3d import _same_pads


def frechet_distance(mu1: np.ndarray, cov1: np.ndarray,
                     mu2: np.ndarray, cov2: np.ndarray) -> float:
    """||mu1-mu2||^2 + tr(C1 + C2 - 2 (C1 C2)^{1/2}): the Frechet (W2)
    distance between Gaussians. The cross term sums the square roots of the
    eigenvalues of C1 @ C2 (their real parts, negatives clipped to 0)."""
    diff = float(np.sum((mu1 - mu2) ** 2))
    eigs = np.linalg.eigvals(cov1 @ cov2)
    tr_sqrt = float(np.sum(np.sqrt(np.clip(np.real(eigs), 0.0, None))))
    return diff + float(np.trace(cov1) + np.trace(cov2)) - 2.0 * tr_sqrt


def feature_statistics(features: np.ndarray):
    """(mean, covariance) of an (N, D) feature matrix, in float64."""
    f = np.asarray(features, np.float64)
    mu = f.mean(axis=0)
    cov = np.cov(f, rowvar=False)
    return mu, np.atleast_2d(cov)


def fid_score(real_features: np.ndarray, fake_features: np.ndarray) -> float:
    """Frechet distance between two feature sets (each (N, D))."""
    mu_r, cov_r = feature_statistics(real_features)
    mu_f, cov_f = feature_statistics(fake_features)
    return frechet_distance(mu_r, cov_r, mu_f, cov_f)


class FrozenFeatureEncoder:
    """A training-invariant feature net: four 4x4 stride-2 ``SAME`` convs
    without bias, each followed by LeakyReLU(0.2), then a mean over space to
    a ``features[-1]``-dim vector. The weights are a function of ``seed``
    alone (lecun-normal from ``torch.Generator().manual_seed(seed)``) unless
    ``weights`` (a list of (cout, cin, 4, 4) tensors) gives them."""

    def __init__(self, nc: int = 1, seed: int = 0,
                 features: Tuple[int, ...] = (32, 64, 128, 256),
                 weights: Optional[Sequence[torch.Tensor]] = None,
                 device: DeviceLike = None):
        dev = resolve_device(device)
        self.nc, self.seed = nc, seed
        if weights is None:
            g = torch.Generator().manual_seed(seed)
            weights, c = [], nc
            for f in features:
                weights.append(lecun_normal_(torch.empty(f, c, 4, 4), c * 16, g))
                c = f
        self.weights = [torch.as_tensor(w, dtype=torch.float32).to(dev) for w in weights]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(B, nc, H, W) images -> (B, features[-1]) features."""
        with torch.no_grad():
            x = x.to(self.weights[0].device, torch.float32)
            for w in self.weights:
                pads = []
                for n in reversed(x.shape[2:]):
                    pads += _same_pads(n, 4, 2)
                x = F.leaky_relu(F.conv2d(F.pad(x, pads), w, stride=2), 0.2)
            return x.mean(dim=(2, 3))


def discriminator_features(d: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The DCGAN discriminator's penultimate conv output (``Conv_4``, before
    its BatchNorm), pooled over space to (B, D), with D in eval mode (its
    running averages); read through a forward hook."""
    seen = []
    handle = d.Conv_4.register_forward_hook(lambda m, i, o: seen.append(o))
    was_training = d.training
    d.eval()
    try:
        with torch.no_grad():
            d(x)
    finally:
        handle.remove()
        d.train(was_training)
    return seen[0].mean(dim=(2, 3))


def dcgan_fid(g: torch.nn.Module, d: Optional[torch.nn.Module] = None,
              real_batches: Sequence = (), generator: Optional[torch.Generator] = None,
              nz: int = 100, n_fake: Optional[int] = None,
              encoder: Optional[Callable] = None, features: str = "frozen") -> float:
    """End-to-end FID of a DCGAN generator.

    ``real_batches`` are (B, nc, H, W) arrays or tensors. Fakes come from G
    in eval mode (its running averages) on ``z ~ N(0, 1)`` drawn from
    ``generator`` (on G's device), batch by batch at the real batch size.
    Features come from a :class:`FrozenFeatureEncoder` with seed 0 by
    default; ``features="discriminator"`` (with ``d``) uses D's penultimate
    conv, for single-run diagnostics only."""
    dev = next(g.parameters()).device
    real_batches = [torch.as_tensor(np.asarray(b) if not torch.is_tensor(b) else b)
                    for b in real_batches]
    nc = int(real_batches[0].shape[1])
    if encoder is None:
        if features == "discriminator":
            if d is None:
                raise ValueError("features='discriminator' needs d")
            encoder = lambda x: discriminator_features(d, x)  # noqa: E731
        else:
            encoder = FrozenFeatureEncoder(nc=nc, device=dev)

    real_feats = [encoder(b.to(dev)) for b in real_batches]
    n_real = sum(int(b.shape[0]) for b in real_batches)
    n_fake = n_real if n_fake is None else n_fake
    bs = int(real_batches[0].shape[0])
    fake_feats, made = [], 0
    was_training = g.training
    g.eval()
    try:
        with torch.no_grad():
            while made < n_fake:
                z = torch.randn((bs, nz, 1, 1), generator=generator, device=dev)
                fake_feats.append(encoder(g(z)))
                made += bs
    finally:
        g.train(was_training)
    real = torch.cat(real_feats).cpu().numpy()
    fake = torch.cat(fake_feats).cpu().numpy()[:n_fake]
    return fid_score(real, fake)
