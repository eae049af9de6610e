"""ReconGAN recovery experiment: does the reconstruction GAN recover? (the
port of ``examples/recon_gan_recovery.py``).

Trains the residual-UNet GAN to invert a k-space corruption on structured
synthetic slices and measures whether the generator's output is closer to
the clean image than its corrupted input (PSNR gain), for the reference's
three variants:

* ``image`` -- the image-domain cyclic loss (``reconGan/reconGan.py``: adv +
  1*MSE(zf(x), G) + 10*MSE(G(zf(x)), x)), zero-fill p = 0.2;
* ``freq`` -- the frequency-consistency loss (``reconGan_freq.py``: adv +
  15*MSE(x, G) + 0.1*(MSE(Re k) + MSE(Im k))), zero-fill p = 0.2;
* ``gibbs`` -- the adversarial-Gibbs GAN (``351_adversarial_gibbs/
  gibbs_gan.py``: compress = RandGibbsNoise(alpha ~ U[0, 1]), the "real"
  batch pre-corrupted, the frequency loss).

The slice pool lives on the card and training runs in chunks of
``make_recon_gan_chunk_fn`` (one host read a chunk). After each chunk a
PSNR probe runs G on a fixed held-out batch under a fixed corruption (draws
from a generator seeded ``seed + 7`` every time), so input and recovered
PSNR are paired. The nets are hard-wired to 128x128 slices.

Run on the card: ``python -m mvtb_tpu_torch.examples.recon_gan_recovery``.
Env knobs as the JAX script's: VARIANTS (comma list of image, freq, gibbs),
STEPS, BATCH, CHUNK, POOL, VAL_BATCH, SIZE, OUTDIR, SEED, G_LR, D_LR,
REAL_LABEL, GAMMA. Writes ``<OUTDIR>/recovery.json`` (default OUTDIR
``runs_torch/recon_gan``) with the JAX script's keys, and a target /
corrupted / recovered grid per variant where matplotlib imports.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.examples import _common as C

KNOBS = {"VARIANTS": ("variants", C.words), "STEPS": ("steps", int),
         "BATCH": ("batch", int), "CHUNK": ("chunk", int), "POOL": ("pool", int),
         "VAL_BATCH": ("val_batch", int), "SIZE": ("size", int), "OUTDIR": ("outdir", str),
         "SEED": ("seed", int), "G_LR": ("g_lr", float), "D_LR": ("d_lr", float),
         "REAL_LABEL": ("real_label", float), "GAMMA": ("gamma", float)}

VARIANT_KW = {
    # alpha/gamma follow the reference loops (train/gan.py docstring)
    "image": dict(zf_p=0.2, alpha=1.0, gamma=10.0, freq_domain=False,
                  compress_kind="zf", pre_corrupt_real=False),
    "freq": dict(zf_p=0.2, alpha=15.0, gamma=0.1, freq_domain=True,
                 compress_kind="zf", pre_corrupt_real=False),
    # gibbs_gan.py:33-35,131-147: the adversarial-Gibbs GAN uses the
    # frequency consistency loss (alpha=15, gamma=0.1), like reconGan_freq
    "gibbs": dict(zf_p=0.2, alpha=15.0, gamma=0.1, freq_domain=True,
                  compress_kind="gibbs", pre_corrupt_real=True),
}


def slice_pool(rng: np.random.RandomState, n: int, size: int) -> np.ndarray:
    """(n, 1, size, size) structured slices in [-1, 1], NCHW: the JAX
    script's channel-last pool, element for element, with the channel axis
    moved to 1. The smooth anatomical generator, not the textured one:
    k-space restoration has something to recover only where the image is
    redundant, as real MRI slices are."""
    from mvtb_tpu_torch.data.synthetic import make_volume

    out, depth = [], 8
    while len(out) < n:
        img, _ = make_volume(rng, channels=1, spatial=(size, size, depth))
        for z in range(depth):
            out.append(np.tanh(img[0, :, :, z])[None])
            if len(out) == n:
                break
    return np.stack(out).astype(np.float32)


def corrupt_batch(batch: torch.Tensor, draw, kw: dict) -> torch.Tensor:
    """The corruption the training step applies, on an NCHW batch, from one
    compress draw of ``sample_recon_draws``."""
    from mvtb_tpu_torch.train.gan import compress

    return compress(batch, draw, kw["compress_kind"], kw["zf_p"])


def psnr(x: torch.Tensor, ref: torch.Tensor, data_range: float = 2.0):
    """(mean per-image PSNR, aggregate PSNR of the mean MSE). The aggregate
    is the robust one when the corruption's severity varies per sample (the
    Gibbs variant's near-identity draws give ~150 dB images)."""
    axes = tuple(range(1, x.ndim))
    m = torch.mean((x - ref) ** 2, dim=axes)
    per_image = torch.mean(10.0 * torch.log10(data_range ** 2 / torch.clamp(m, min=1e-12)))
    aggregate = 10.0 * torch.log10(data_range ** 2 / torch.clamp(torch.mean(m), min=1e-12))
    return per_image, aggregate


@torch.no_grad()
def probe(g: torch.nn.Module, target: torch.Tensor, corrupted: torch.Tensor):
    """``(psnr(corrupted, target), psnr(G(corrupted), target), recovered)``."""
    recovered = g(corrupted)
    return psnr(corrupted, target), psnr(recovered, target), recovered


def probe_batch(val: torch.Tensor, kw: dict, seed: int):
    """The fixed ``(target, corrupted)`` pair of every probe: the Gibbs
    variant's target is the pre-corrupted batch, as its training pairs it."""
    from mvtb_tpu_torch.train.gan import sample_recon_draws

    g = torch.Generator(device=val.device).manual_seed(seed + 7)
    k0, k1, _ = sample_recon_draws(kw["compress_kind"], val.shape, g, val.device)
    target = corrupt_batch(val, k0, kw) if kw["pre_corrupt_real"] else val
    return target, corrupt_batch(target, k1, kw)


def run(variants: Sequence[str] = ("image", "freq", "gibbs"), steps: int = 2000,
        batch: int = 8, chunk: int = 100, pool: int = 256, val_batch: int = 16,
        size: int = 128, outdir: Optional[str] = None, seed: int = 0, g_lr: float = 1e-4,
        d_lr: Optional[float] = None, real_label: float = 1.0, gamma: Optional[float] = None,
        nf: int = 16, device: DeviceLike = None, log=print) -> dict:
    """Train and probe each variant; writes and returns ``recovery.json``'s
    contents. ``d_lr`` defaults to ``g_lr``; ``gamma`` overrides the cyclic
    gamma; ``nf`` is the nets' base width (the reference's 16)."""
    from mvtb_tpu_torch.experiments.runner import epoch_generator
    from mvtb_tpu_torch.models.resunet_gan import ResUnetDiscriminator, ResUnetGenerator
    from mvtb_tpu_torch.train.chunked import make_recon_gan_chunk_fn
    from mvtb_tpu_torch.train.gan import create_gan_state

    dev = resolve_device(device)
    d_lr = g_lr if d_lr is None else d_lr
    outdir = outdir or C.outdir("recon_gan")
    os.makedirs(outdir, exist_ok=True)
    pool_t = C.on(dev, slice_pool(np.random.RandomState(seed), pool, size))
    val = C.on(dev, slice_pool(np.random.RandomState(seed + 1000), val_batch, size))
    log(f"pool {tuple(pool_t.shape)}, val {tuple(val.shape)}")
    cpu = torch.device("cpu")
    results = {}
    for variant in variants:
        kw = dict(VARIANT_KW[variant])
        if gamma is not None:
            kw["gamma"] = float(gamma)
        t0 = time.perf_counter()
        # reconGan's G carries the global residual; the gibbs clone does not
        gen = ResUnetGenerator(1, nf, global_residual=variant != "gibbs", device=cpu,
                               generator=epoch_generator(seed, 0, cpu)).to(dev)
        disc = ResUnetDiscriminator(1, nf, device=cpu,
                                    generator=epoch_generator(seed, 1, cpu)).to(dev)
        g_state, d_state = create_gan_state(gen, g_lr), create_gan_state(disc, d_lr)
        chunk_fn = make_recon_gan_chunk_fn(real_label=real_label, device=dev, **kw)
        draws = epoch_generator(seed, 2, dev)
        target, corrupted = probe_batch(val, kw, seed)
        srng = np.random.RandomState(seed + 1)
        history, done = [], 0
        while done < steps:
            n = min(chunk, steps - done)
            idxs = torch.from_numpy(srng.randint(0, pool_t.shape[0], (n, batch))).to(dev)
            g_state, d_state, draws, curves = chunk_fn(g_state, d_state, draws, pool_t, idxs)
            done += n
            p_in, p_out, recovered = probe(g_state.model, target, corrupted)
            rec = {"step": done, "g_loss": float(curves[0, -1]),
                   "psnr_in": float(p_in[0]), "psnr_out": float(p_out[0]),
                   "psnr_in_agg": float(p_in[1]), "psnr_out_agg": float(p_out[1])}
            history.append(rec)
            log(f"[{variant}] step {done}/{steps} g_loss {rec['g_loss']:.3f} PSNR in "
                f"{rec['psnr_in']:.2f} -> out {rec['psnr_out']:.2f} (agg "
                f"{rec['psnr_in_agg']:.2f} -> {rec['psnr_out_agg']:.2f}) "
                f"({time.perf_counter() - t0:.0f}s)")
        final = history[-1]
        results[variant] = {
            "steps": steps, "batch": batch, "size": size, "g_lr": g_lr, "d_lr": d_lr,
            "real_label": real_label, "psnr_corrupted_input": final["psnr_in"],
            "psnr_recovered": final["psnr_out"],
            "psnr_gain_db": final["psnr_out"] - final["psnr_in"],
            "psnr_gain_agg_db": final["psnr_out_agg"] - final["psnr_in_agg"],
            "history": history, "wall_s": round(time.perf_counter() - t0, 1)}
        k = 4
        tiles = torch.cat([target[:k], corrupted[:k], recovered[:k]]).movedim(1, -1)

        def plot():
            from mvtb_tpu_torch.eval.plots import save_image_grid

            save_image_grid(tiles.cpu().numpy(), os.path.join(outdir, f"grid_{variant}.png"),
                            nrow=k, title=f"{variant}: target / corrupted / recovered")

        C.best_effort_plot(plot, log)
        with open(os.path.join(outdir, "recovery.json"), "w") as f:
            json.dump(results, f, indent=2)
    for v, r in results.items():
        log(f"{v}: PSNR {r['psnr_corrupted_input']:.2f} -> {r['psnr_recovered']:.2f} dB "
            f"(gain {r['psnr_gain_db']:+.2f})")
    return results


def main(argv=None) -> dict:
    return C.env_main(run, KNOBS, argv, __doc__.splitlines()[0])


if __name__ == "__main__":
    main()
