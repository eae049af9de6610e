"""Config-driven experiment runner (counterpart of
mvtb_tpu/experiments/runner.py): the segmentation, learnable-stylization
and GAN families and the hospital-domain protocol.

:func:`run` executes a registry entry end to end, the replacement for the
reference's per-script training loops: the segmentation kind (the T1
template ``baseline.py:232-318`` and its clones) with validation every
``val_interval`` epochs over a fixed held-out set, the learnable kinds
(``learnable_gibbs``, ``learnable_spikes``; ``350_stylized_layers/``) with
their stylization parameter's trajectory, and the GAN kinds (``dcgan``,
``recon_gan``, ``recon_gan_freq``, ``gibbs_gan``; ``50_reconstruction/``,
``351_adversarial_gibbs/``) with a frozen-encoder FID for DCGAN. Each runs
per step, or chunked over a pool that lives on the card, with full-state
checkpoints and resume. Data comes from :mod:`mvtb_tpu_torch.data.synthetic`.
:func:`run_domain_experiment` runs the TCGA institutional-distribution
protocol: train on three synthetic hospitals, score each and a held-out
fourth, report the generalization gap.

With a ``workdir``, runs write the JAX runner's PNGs (learning and
per-class curves, alpha trajectories, GAN sample grids) when matplotlib can
be imported, and log one line saying they were skipped when it cannot.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.data.prefetch import device_prefetch
from mvtb_tpu_torch.data.pipeline import StylizedLoader
from mvtb_tpu_torch.data.synthetic import cached_batches, make_volume
from mvtb_tpu_torch.data.tcga import domain_loaders, generalization_gap
from mvtb_tpu_torch.eval import plots
from mvtb_tpu_torch.eval.harness import ModelEvaluation
from mvtb_tpu_torch.experiments.registry import ExperimentConfig, fast_science
from mvtb_tpu_torch.experiments.registry import get as get_config
from mvtb_tpu_torch.models import build_seg_model, seg_run_config, seg_widths
from mvtb_tpu_torch.train.checkpoint import CheckpointManager
from mvtb_tpu_torch.train.chunked import (DCGAN_CURVES, RECON_CURVES, make_chunk_fn,
                                          make_dcgan_chunk_fn, make_recon_gan_chunk_fn)
from mvtb_tpu_torch.train.seg import (EpochMetrics, SegState, create_seg_state,
                                      reference_optimizer, seg_eval_step,
                                      seg_train_step)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

GAN_KINDS = ("dcgan", "recon_gan", "recon_gan_freq", "gibbs_gan")
LEARNABLE_KINDS = ("learnable_gibbs", "learnable_spikes")

# the keys of {name}_result.json, as the JAX package writes them
_RESULT_KEYS = ("history", "best_dice", "trajectory", "losses", "wall_time_s", "fid")


def _data_iter(cfg: ExperimentConfig, seed: int, batch_size: int,
               pool: int = 24):
    """Yield channel-first numpy (image, label) batches honoring
    ``select_channel`` and the multimodal draw.

    Batches come from a pre-generated in-memory pool (the CacheDataset
    pattern) so the host keeps up with the step rate.
    """
    kind = cfg.data_kind
    if cfg.multimodal_channels is not None:
        # MultimodalSlicesd semantics (baseline_3modalities.py:73-101): one
        # modality channel drawn uniformly per sample, fixed label channel.
        rng = np.random.RandomState(seed + 77)
        base = cached_batches(seed, batch_size, pool=pool, channels=4,
                              spatial=cfg.spatial, n_classes=3, kind=kind)
        choices = np.asarray(cfg.multimodal_channels)
        for img, lbl in base:
            cs = rng.choice(choices, size=img.shape[0])
            picked = np.stack([img[b, c] for b, c in enumerate(cs)])[:, None]
            yield picked, lbl[:, cfg.multimodal_label:cfg.multimodal_label + 1]
    elif cfg.select_channel is not None:
        img_c, lbl_c = cfg.select_channel
        base = cached_batches(seed, batch_size, pool=pool, channels=4,
                              spatial=cfg.spatial, n_classes=3, kind=kind)
        for img, lbl in base:
            yield img[:, img_c:img_c + 1], lbl[:, lbl_c:lbl_c + 1]
    else:
        yield from cached_batches(seed, batch_size, pool=pool,
                                  channels=cfg.in_channels,
                                  spatial=cfg.spatial,
                                  n_classes=cfg.out_channels, kind=kind)


def _pool_arrays(cfg: ExperimentConfig, seed: int, pool: int,
                 device: DeviceLike = None):
    """(images, labels) pools of ``pool`` samples on ``device``, honoring
    the config's channel semantics, for chunked training."""
    dev = resolve_device(device)
    it = _data_iter(cfg, seed, batch_size=1, pool=pool)
    imgs, lbls = [], []
    for _ in range(pool):
        i, l = next(it)
        imgs.append(np.asarray(i[0], np.float32))
        lbls.append(np.asarray(l[0], np.float32))
    return (torch.from_numpy(np.stack(imgs)).to(dev),
            torch.from_numpy(np.stack(lbls)).to(dev))


def _slices_iter(cfg: ExperimentConfig, seed: int, batch_size: int):
    """NCHW numpy batches of 2D slices in [-1, 1] for the GAN experiments:
    the JAX package's channel-last batches, element for element, with the
    channel axis moved to 1."""
    rng = np.random.RandomState(seed)
    h, w = cfg.spatial[:2]
    while True:
        out = []
        for _ in range(batch_size):
            img, _ = make_volume(rng, cfg.in_channels, (h, w, 4))
            sl = img[:, :, :, rng.randint(0, 4)]
            out.append(np.tanh(sl))  # squash into [-1, 1] like Tanh-generated data
        yield np.stack(out).astype(np.float32)


def _fid_reals(cfg: ExperimentConfig, seed: int):
    """The fixed held-out real batches of every FID of a run (the curve's
    and the final one)."""
    data_it = _slices_iter(cfg, seed + 999, cfg.batch_size)
    return [next(data_it) for _ in range(4)]


def epoch_generator(base: int, epoch: int, device: DeviceLike = None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``(base, epoch)``
    alone: ``numpy.random.SeedSequence((base, epoch))``'s first 64-bit
    word. The counterpart of the JAX runner's ``fold_in(key(base), epoch)``:
    epoch ``e`` draws the same numbers whether the run started at epoch 0
    or resumed, so a resumed run replays an uninterrupted one exactly."""
    word = np.random.SeedSequence((base, epoch)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=resolve_device(device)).manual_seed(int(word))


def _seg_state(cfg: ExperimentConfig, seed: int, dev: torch.device,
               arch: str = "unet") -> SegState:
    """The run's segmentation model (:func:`~mvtb_tpu_torch.models.
    build_seg_model`: the config's UNet, or ``arch`` at its published
    widths), initialised from ``seed`` (PyTorch's generators are forked, so
    the caller's stay as they were), and the reference optimizer."""
    widths = seg_widths(cfg, arch)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(seed)
        model = build_seg_model(arch, cfg.in_channels, cfg.out_channels, device=dev,
                                dtype=_DTYPES[cfg.model_dtype], **widths)
    return create_seg_state(
        model, reference_optimizer(model.parameters(), cfg.lr, cfg.weight_decay),
        device=dev)


def _evaluate(model: torch.nn.Module, val_i: torch.Tensor, val_l: torch.Tensor,
              stylize, generator: torch.Generator, dev: torch.device) -> dict:
    """Mean and per-class Dice over the (V, B, ...) validation batches, with
    one host read for the whole set."""
    scores = torch.stack([
        seg_eval_step(model, val_i[b], val_l[b], stylize, generator=generator,
                      device=dev).float()
        for b in range(val_i.shape[0])]).cpu().numpy()
    metrics = EpochMetrics()
    for s in scores:
        metrics.update(s)
    return metrics.result()


def _plots_available(cfg: ExperimentConfig, log) -> bool:
    """Whether the PNGs can be written here; logs one line when not."""
    if plots.available():
        return True
    log(f"[{cfg.name}] matplotlib is not importable: PNGs skipped")
    return False


def _save_curves(cfg: ExperimentConfig, history: dict, workdir: str, log) -> None:
    """The JAX runner's learning-curve PNGs of a segmentation run."""
    if not _plots_available(cfg, log):
        return
    plots.save_learning_curves(history, os.path.join(
        workdir, f"trainLoss_and_meanValScore_{cfg.name}.png"),
        cfg.val_interval, title=cfg.name)
    if history["dice"]:
        plots.save_per_class_curves(history, os.path.join(
            workdir, f"meanValScore_per_label_{cfg.name}.png"), title=cfg.name)


@torch.no_grad()
def _save_samples(cfg: ExperimentConfig, g_state, real: torch.Tensor,
                  workdir: str, log, dev: torch.device) -> None:
    """The JAX runner's ``samples_{name}.png``: DCGAN samples from 16 z
    drawn from a generator seeded 123 (its ``key(123)``) with G in eval
    mode, or the ReconGAN generator's reconstructions of ``real``."""
    if not _plots_available(cfg, log):
        return
    g = g_state.model
    if cfg.kind == "dcgan":
        z = torch.randn((16, cfg.nz, 1, 1),
                        generator=torch.Generator(device=dev).manual_seed(123), device=dev)
        was_training = g.training
        g.eval()
        try:
            fake, title = g(z), f"{cfg.name} samples"
        finally:
            g.train(was_training)
    else:
        fake, title = g(real)[:, :1], f"{cfg.name} reconstructions"
    plots.save_image_grid(np.moveaxis(fake.float().cpu().numpy(), 1, -1), os.path.join(
        workdir, f"samples_{cfg.name}.png"), nrow=4, title=title)


def _run_segmentation(cfg: ExperimentConfig, steps_per_epoch: int, epochs: int,
                      seed: int, workdir: Optional[str], log, dev: torch.device,
                      val_batches: int = 12, arch: str = "unet") -> Dict:
    """Per-step training: batches from the host pool, prefetched to the
    card; a checkpoint at each validation that improves the best mean Dice.
    The losses of an epoch are summed on the card and read once."""
    state = _seg_state(cfg, seed, dev, arch)
    ckpt = None
    if workdir:
        ckpt = CheckpointManager(os.path.join(workdir, "ckpt"),
                                 best_metric="mean_dice", best_mode="max")

    train_it = device_prefetch(_data_iter(cfg, seed, cfg.batch_size), size=2,
                               device=dev)
    # fixed held-out set: one disjoint-seed pool, `val_batches` batches drawn
    # once (the reference evaluates a fixed 48-volume split every interval)
    val_it = _data_iter(cfg, seed + 1000, cfg.batch_size,
                        pool=max(24, val_batches * cfg.batch_size))
    val_set = [next(val_it) for _ in range(val_batches)]
    val_i = torch.from_numpy(np.stack([i for i, _ in val_set])).to(dev)
    val_l = torch.from_numpy(np.stack([l for _, l in val_set])).to(dev)

    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    history = {"loss": [], "dice": [], "epochs": []}
    best = -1.0
    for epoch in range(epochs):
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(steps_per_epoch):
            img, lbl = next(train_it)
            total += seg_train_step(state, img, lbl, cfg.train_stylize,
                                    generator=generator, device=dev).float()
        history["loss"].append(float(total / steps_per_epoch))

        if (epoch + 1) % cfg.val_interval == 0:
            result = _evaluate(state.model, val_i, val_l, cfg.val_stylize,
                               generator, dev)
            history["dice"].append(result)
            history["epochs"].append(epoch + 1)
            log(f"[{cfg.name}] epoch {epoch + 1}/{epochs} "
                f"loss {history['loss'][-1]:.4f} dice {result['mean']:.4f}")
            if result["mean"] > best:
                best = result["mean"]
                if ckpt is not None:
                    ckpt.save(epoch + 1, state,
                              metrics={"mean_dice": result["mean"]})
    if ckpt is not None:
        ckpt.wait()
        ckpt.close()
    if workdir:
        _save_curves(cfg, history, workdir, log)
    return {"history": history, "best_dice": best, "state": state}


def _run_segmentation_chunked(cfg: ExperimentConfig, steps_per_epoch: int,
                              epochs: int, seed: int, workdir: Optional[str],
                              log, dev: torch.device, val_batches: int = 12,
                              pool: int = 48, resume: bool = False,
                              arch: str = "unet") -> Dict:
    """Reference-scale segmentation training, one chunk (one host read) per
    epoch over pools on the card.

    Validation runs every ``val_interval`` epochs over the fixed val pool,
    with one host read; a full-state checkpoint follows each validation
    (the newest 3 kept), then ``history.json``. ``resume=True`` continues
    from the latest checkpoint with continuous curves. The result's
    ``timing`` holds host seconds: ``pool_s``, ``restore_s`` (None on a
    fresh start), and per epoch or validation ``chunk_s`` (the chunk and
    its read), ``val_s`` and ``save_s``.
    """
    state = _seg_state(cfg, seed, dev, arch)

    t = time.perf_counter()
    pool_i, pool_l = _pool_arrays(cfg, seed, pool, dev)
    val_i, val_l = _pool_arrays(cfg, seed + 1000, val_batches * cfg.batch_size, dev)
    val_i = val_i.reshape((val_batches, cfg.batch_size) + val_i.shape[1:])
    val_l = val_l.reshape((val_batches, cfg.batch_size) + val_l.shape[1:])
    timing = {"pool_s": time.perf_counter() - t, "restore_s": None,
              "chunk_s": [], "val_s": [], "save_s": []}
    log(f"[{cfg.name}] pools ready: train {tuple(pool_i.shape)}, val "
        f"{tuple(val_i.shape)} ({timing['pool_s']:.0f}s)")

    chunk_fn = make_chunk_fn(cfg.train_stylize, dev)
    ckpt = None
    hist_path = os.path.join(workdir, "history.json") if workdir else None
    if workdir:
        # latest-k retention: resume needs the newest full state; the best
        # epoch is recorded in the history instead
        ckpt = CheckpointManager(os.path.join(workdir, "ckpt"), max_to_keep=3)
    t = time.perf_counter()
    state, start_epoch, history = _restore_chunked(
        ckpt, state, {"loss": [], "dice": [], "epochs": []}, hist_path, resume,
        log, cfg.name, steps_per_epoch, per_epoch_keys=("loss",),
        per_val_keys=("dice",))
    if start_epoch:
        timing["restore_s"] = time.perf_counter() - t

    rng = np.random.RandomState(seed + 7)
    # replay the sampling stream up to the resume point so a resumed run
    # draws the same batches the uninterrupted run would have
    for _ in range(start_epoch):
        rng.randint(0, pool, (steps_per_epoch, cfg.batch_size))

    best = max((d["mean"] for d in history["dice"]), default=-1.0)
    t0 = time.perf_counter()
    for epoch in range(start_epoch, epochs):
        t = time.perf_counter()
        idxs = torch.from_numpy(rng.randint(0, pool, (steps_per_epoch, cfg.batch_size)))
        state, _, loss = chunk_fn(state, epoch_generator(seed, epoch, dev),
                                  pool_i, pool_l, idxs.to(dev))
        history["loss"].append(float(loss))  # the epoch's one host read
        timing["chunk_s"].append(time.perf_counter() - t)

        if (epoch + 1) % cfg.val_interval == 0:
            t = time.perf_counter()
            result = _evaluate(state.model, val_i, val_l, cfg.val_stylize,
                               epoch_generator(seed + 2, epoch, dev), dev)
            timing["val_s"].append(time.perf_counter() - t)
            history["dice"].append(result)
            history["epochs"].append(epoch + 1)
            vol_s = (cfg.batch_size * steps_per_epoch * (epoch + 1 - start_epoch)
                     / max(time.perf_counter() - t0, 1e-9))
            log(f"[{cfg.name}] epoch {epoch + 1}/{epochs} "
                f"loss {history['loss'][-1]:.4f} dice {result['mean']:.4f} "
                f"({vol_s:.1f} train vol/s incl. val)")
            best = max(best, result["mean"])
            if ckpt is not None:
                t = time.perf_counter()
                ckpt.save(epoch + 1, state, metrics={"mean_dice": result["mean"]})
                timing["save_s"].append(time.perf_counter() - t)
            if hist_path:
                with open(hist_path, "w") as f:
                    json.dump(history, f)
    if ckpt is not None:
        ckpt.wait()
        ckpt.close()
    if workdir:
        _save_curves(cfg, history, workdir, log)
    return {"history": history, "best_dice": best, "state": state,
            "resumed_from": start_epoch, "timing": timing}


def _restore_chunked(ckpt, template, history, hist_path, resume, log, name,
                     steps_per_epoch: int, per_epoch_keys: tuple = (),
                     per_step_keys: tuple = (), per_val_keys: tuple = ()):
    """Shared resume logic for the chunked runners: restore the latest full
    state, load the history and truncate it to the restored epoch (a crash
    can land between the history flush and the checkpoint save); returns
    (state, start_epoch, history).

    Every history key must be declared: ``"epochs"`` (the validation
    epochs, or every epoch in a GAN run), ``"fid"`` with its
    ``"fid_epochs"``, a per-epoch key, a per-step key, or a per-validation
    key (one entry per element of ``"epochs"``, as the segmentation
    runner's ``"dice"``). Any other key raises ``KeyError``: a guessed
    truncation would silently corrupt it on resume.
    """
    start_epoch = 0
    state = template
    if resume and ckpt is not None and ckpt.latest_step is not None:
        state = ckpt.restore(template)
        start_epoch = int(ckpt.latest_step)
        if hist_path and os.path.exists(hist_path):
            with open(hist_path) as f:
                history = json.load(f)
        val_keep = [i for i, e in enumerate(history.get("epochs", []))
                    if e <= start_epoch]
        fid_keep = [i for i, e in enumerate(history.get("fid_epochs", []))
                    if e <= start_epoch]
        for k, v in history.items():
            if k in ("epochs", "fid_epochs"):
                history[k] = [e for e in v if e <= start_epoch]
            elif k == "fid":
                history[k] = [v[i] for i in fid_keep]
            elif k in per_val_keys:
                history[k] = [v[i] for i in val_keep]
            elif k in per_epoch_keys:
                history[k] = v[:start_epoch]
            elif k in per_step_keys:
                history[k] = v[:start_epoch * steps_per_epoch]
            else:
                raise KeyError(
                    f"history key {k!r} not declared per-epoch, per-step or "
                    "per-validation; a guessed truncation would silently "
                    "corrupt it on resume")
        log(f"[{name}] resumed from epoch {start_epoch}")
    return state, start_epoch, history


def _learnable_state(cfg: ExperimentConfig, seed: int, dev: torch.device,
                     transfer_params=None) -> SegState:
    """The run's ``GibbsUNet`` (``alpha0``, the hard mask in ``fd_mode``) or
    ``SpikesUNet`` (``spike_intensity``, learnable) at the config's widths,
    its UNet in float32 as the JAX runner builds it, initialised from
    ``seed`` (generators forked), and its optimizer
    (:func:`~mvtb_tpu_torch.train.learnable.create_learnable_state`)."""
    from mvtb_tpu_torch.models.layers import GibbsUNet, SpikesUNet
    from mvtb_tpu_torch.train.learnable import create_learnable_state

    widths = dict(out_channels=cfg.out_channels, channels=cfg.channels,
                  strides=cfg.strides, num_res_units=cfg.num_res_units,
                  in_channels=cfg.in_channels, device=dev)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(seed)
        if cfg.kind == "learnable_gibbs":
            model = GibbsUNet(alpha_init=cfg.alpha0, hard=cfg.fd_mode, **widths)
        else:
            model = SpikesUNet(intensity=cfg.spike_intensity, learnable=True, **widths)
    return create_learnable_state(model, freeze_unet=cfg.freeze_unet,
                                  unet_optimizer=cfg.unet_optimizer,
                                  transfer_params=transfer_params, lr=cfg.lr,
                                  weight_decay=cfg.weight_decay, device=dev)


def _save_trajectory(cfg: ExperimentConfig, trajectory, workdir: str, log) -> None:
    """``gibbs_trajectory_{name}.txt`` and, where matplotlib imports,
    ``trajectory_{name}.png``, as the JAX runner writes them."""
    np.savetxt(os.path.join(workdir, f"gibbs_trajectory_{cfg.name}.txt"),
               np.asarray(trajectory))
    if _plots_available(cfg, log):
        plots.save_alpha_trajectory(trajectory, os.path.join(
            workdir, f"trajectory_{cfg.name}.png"), title=cfg.name)


def _run_learnable(cfg: ExperimentConfig, steps_per_epoch: int, epochs: int, seed: int,
                   workdir: Optional[str], log, dev: torch.device) -> Dict:
    """Per-step learnable-stylization training on prefetched host batches;
    the spike draws from one generator seeded ``seed + 1``; the losses and
    the trajectory of an epoch read once. The UNet is warm-started from
    ``cfg.transfer_from`` only when that is a checkpoint directory on disk
    (the registry's values name runs, which document the lineage only)."""
    from mvtb_tpu_torch.train.learnable import fd_train_step, learnable_train_step

    transfer_params = None
    if cfg.transfer_from and os.path.isdir(cfg.transfer_from):
        transfer_params = ModelEvaluation.from_checkpoint(
            cfg.transfer_from, in_channels=cfg.in_channels, out_channels=cfg.out_channels,
            device=dev).model.state_dict()
    state = _learnable_state(cfg, seed, dev, transfer_params)
    train_it = device_prefetch(_data_iter(cfg, seed, cfg.batch_size), size=2, device=dev)
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    trajectory, losses = [], []
    for epoch in range(epochs):
        rows = []
        for _ in range(steps_per_epoch):
            img, lbl = next(train_it)
            if cfg.fd_mode:
                row = fd_train_step(state, img, lbl, generator=generator, h=cfg.fd_h,
                                    lr=cfg.fd_lr, device=dev)
            else:
                row = learnable_train_step(state, img, lbl, generator=generator,
                                           train_alpha=cfg.train_alpha, device=dev)
            rows.append(torch.stack(row).float())
        epoch_losses, epoch_alphas = torch.stack(rows, dim=1).cpu().tolist()  # one read
        losses += epoch_losses
        trajectory += epoch_alphas
        log(f"[{cfg.name}] epoch {epoch + 1}/{epochs} "
            f"loss {losses[-1]:.4f} alpha {trajectory[-1]:.4f}")
    if workdir:
        _save_trajectory(cfg, trajectory, workdir, log)
    return {"trajectory": trajectory, "losses": losses, "state": state}


def _run_learnable_chunked(cfg: ExperimentConfig, steps_per_epoch: int, epochs: int,
                           seed: int, workdir: Optional[str], log, dev: torch.device,
                           pool: int = 24, resume: bool = False,
                           ckpt_every: Optional[int] = None) -> Dict:
    """Reference-scale learnable-stylization training, one chunk (one host
    read: the mean loss and the trajectory together) per epoch over a pool
    on the card, with full-state checkpoints every ``ckpt_every`` epochs
    (default ``val_interval``; the newest 3 kept), the history written
    every epoch, and resume with continuous loss and trajectory curves.
    As in the JAX runner, no UNet is transferred here. The result's
    ``timing`` holds host seconds: ``pool_s``, ``restore_s`` (None on a
    fresh start), and per epoch or cadence ``chunk_s`` (the chunk and its
    read) and ``save_s``."""
    from mvtb_tpu_torch.train.chunked import make_learnable_chunk_fn

    state = _learnable_state(cfg, seed, dev)
    t = time.perf_counter()
    pool_i, pool_l = _pool_arrays(cfg, seed, pool, dev)
    timing = {"pool_s": time.perf_counter() - t, "restore_s": None,
              "chunk_s": [], "save_s": []}
    chunk_fn = make_learnable_chunk_fn(cfg.fd_mode, train_alpha=cfg.train_alpha,
                                       fd_h=cfg.fd_h, fd_lr=cfg.fd_lr, device=dev)

    ckpt = None
    hist_path = os.path.join(workdir, "history.json") if workdir else None
    if workdir:
        ckpt = CheckpointManager(os.path.join(workdir, "ckpt"), max_to_keep=3)
    t = time.perf_counter()
    state, start_epoch, history = _restore_chunked(
        ckpt, state, {"loss": [], "trajectory": [], "epochs": []}, hist_path, resume,
        log, cfg.name, steps_per_epoch, per_epoch_keys=("loss",),
        per_step_keys=("trajectory",))
    if start_epoch:
        timing["restore_s"] = time.perf_counter() - t

    rng = np.random.RandomState(seed + 7)
    for _ in range(start_epoch):
        rng.randint(0, pool, (steps_per_epoch, cfg.batch_size))
    every = ckpt_every or cfg.val_interval
    t0 = time.perf_counter()
    for epoch in range(start_epoch, epochs):
        t = time.perf_counter()
        idxs = torch.from_numpy(rng.randint(0, pool, (steps_per_epoch, cfg.batch_size)))
        state, _, loss, traj = chunk_fn(state, epoch_generator(seed + 1, epoch, dev),
                                        pool_i, pool_l, idxs.to(dev))
        row = torch.cat([loss.reshape(1), traj]).cpu().tolist()  # the epoch's one host read
        timing["chunk_s"].append(time.perf_counter() - t)
        history["loss"].append(row[0])
        history["trajectory"] += row[1:]
        history["epochs"].append(epoch + 1)
        log(f"[{cfg.name}] epoch {epoch + 1}/{epochs} "
            f"loss {row[0]:.4f} alpha {row[-1]:.4f} "
            f"({(epoch + 1 - start_epoch) * steps_per_epoch / max(time.perf_counter() - t0, 1e-9):.1f} step/s)")
        if ckpt is not None and (epoch + 1) % every == 0:
            t = time.perf_counter()
            ckpt.save(epoch + 1, state)
            timing["save_s"].append(time.perf_counter() - t)
        if hist_path:
            with open(hist_path, "w") as f:
                json.dump(history, f)
    if ckpt is not None:
        ckpt.wait()
        ckpt.close()
    if workdir:
        _save_trajectory(cfg, history["trajectory"], workdir, log)
    return {"trajectory": history["trajectory"], "losses": history["loss"],
            "history": history, "state": state, "resumed_from": start_epoch,
            "timing": timing}


def _gan_states(cfg: ExperimentConfig, seed: int, dev: torch.device):
    """The run's (G, D) :class:`~mvtb_tpu_torch.train.gan.GANState` pair:
    the DCGAN pair for ``dcgan``, else the ReconGAN pair (width
    ``gan_nf // 8``, G's global residual except for ``gibbs_gan``). G's
    weights come from ``epoch_generator(seed, 0)``, D's from ``(seed, 1)``,
    drawn on the host, so they do not depend on the device."""
    from mvtb_tpu_torch.models import (Discriminator, Generator,
                                       ResUnetDiscriminator, ResUnetGenerator)
    from mvtb_tpu_torch.train.gan import create_gan_state

    cpu = torch.device("cpu")
    gg, gd = epoch_generator(seed, 0, cpu), epoch_generator(seed, 1, cpu)
    if cfg.kind == "dcgan":
        g = Generator(cfg.nz, cfg.gan_nf, cfg.in_channels, device=cpu, generator=gg)
        d = Discriminator(cfg.in_channels, cfg.gan_nf, device=cpu, generator=gd)
    else:
        nf = max(cfg.gan_nf // 8, 2)
        g = ResUnetGenerator(cfg.in_channels, nf, global_residual=cfg.kind != "gibbs_gan",
                             device=cpu, generator=gg)
        d = ResUnetDiscriminator(cfg.in_channels, nf, device=cpu, generator=gd)
    d_lr = cfg.gan_lr if cfg.gan_d_lr is None else cfg.gan_d_lr
    return (create_gan_state(g.to(dev), cfg.gan_lr, cfg.gan_beta1),
            create_gan_state(d.to(dev), d_lr, cfg.gan_beta1))


def _recon_kwargs(cfg: ExperimentConfig) -> dict:
    """The ReconGAN step's statics for a GAN kind other than ``dcgan``."""
    return dict(zf_p=cfg.zf_p, alpha=cfg.cyclic_alpha, gamma=cfg.cyclic_gamma,
                freq_domain=cfg.kind in ("recon_gan_freq", "gibbs_gan"),
                compress_kind="gibbs" if cfg.kind == "gibbs_gan" else "zf",
                pre_corrupt_real=cfg.kind == "gibbs_gan", real_label=cfg.gan_real_label)


def _final_fid(cfg: ExperimentConfig, g_state, d_state, fid_reals, dev) -> float:
    """The DCGAN's frozen-encoder FID against the run's held-out reals, its
    fakes from a generator seeded 777 (the JAX runner's ``key(777)``)."""
    from mvtb_tpu_torch.eval.fid import dcgan_fid

    return dcgan_fid(g_state.model, d_state.model, fid_reals,
                     generator=torch.Generator(device=dev).manual_seed(777), nz=cfg.nz)


def _run_gan(cfg: ExperimentConfig, steps_per_epoch: int, epochs: int, seed: int,
             workdir: Optional[str], log, dev: torch.device) -> Dict:
    """Per-step GAN training on host batches of ``_slices_iter``; the
    losses of an epoch are read once. DCGAN ends with its FID; with a
    ``workdir`` the run ends with its sample grid (a ReconGAN's of the
    next host batch)."""
    from mvtb_tpu_torch.train.gan import dcgan_step, recon_gan_step, sample_recon_draws

    g_state, d_state = _gan_states(cfg, seed, dev)
    data_it = _slices_iter(cfg, seed, cfg.batch_size)
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    history = {"g_loss": [], "d_loss": []}
    for epoch in range(epochs):
        rows = []
        for _ in range(steps_per_epoch):
            real = torch.from_numpy(next(data_it)).to(dev)
            if cfg.kind == "dcgan":
                z = torch.randn((real.shape[0], cfg.nz, 1, 1), generator=generator,
                                device=dev)
                m = dcgan_step(g_state, d_state, real, z, real_label=cfg.gan_real_label)
            else:
                kw = _recon_kwargs(cfg)
                draws = sample_recon_draws(kw["compress_kind"], real.shape, generator, dev)
                m = recon_gan_step(g_state, d_state, real, draws, **kw)
            rows.append(torch.stack([m["g_loss"], m["d_loss"]]).float())
        g_l, d_l = torch.stack(rows, dim=1).cpu().tolist()  # the epoch's one host read
        history["g_loss"] += g_l
        history["d_loss"] += d_l
        log(f"[{cfg.name}] epoch {epoch + 1}/{epochs} "
            f"G {history['g_loss'][-1]:.3f} D {history['d_loss'][-1]:.3f}")
    result = {"history": history, "g_state": g_state, "d_state": d_state}
    if cfg.kind == "dcgan":
        result["fid"] = _final_fid(cfg, g_state, d_state, _fid_reals(cfg, seed), dev)
        log(f"[{cfg.name}] frozen-encoder FID {result['fid']:.2f}")
    if workdir:
        real = None if cfg.kind == "dcgan" else torch.from_numpy(next(data_it)).to(dev)
        _save_samples(cfg, g_state, real, workdir, log, dev)
    return result


def _run_gan_chunked(cfg: ExperimentConfig, steps_per_epoch: int, epochs: int,
                     seed: int, workdir: Optional[str], log, dev: torch.device,
                     pool: int = 256, resume: bool = False,
                     ckpt_every: Optional[int] = None) -> Dict:
    """Reference-scale GAN training, one chunk (one host read) per epoch
    over a slice pool on the card, with joint ``{"g", "d"}`` checkpoints
    (the newest 3 kept) and resume.

    Every ``ckpt_every`` epochs (default ``max(val_interval, 5)``) a DCGAN
    run scores its FID (the curve ``history["fid"]`` at
    ``history["fid_epochs"]``), then the checkpoint is saved; the history
    is written every epoch. The result's ``timing`` holds host seconds:
    ``pool_s``, ``restore_s`` (None on a fresh start), and per epoch or
    cadence ``chunk_s`` (the chunk and its read), ``fid_s`` and ``save_s``.
    """
    t = time.perf_counter()
    pool_arr = torch.from_numpy(next(_slices_iter(cfg, seed, pool))).to(dev)
    timing = {"pool_s": time.perf_counter() - t, "restore_s": None,
              "chunk_s": [], "fid_s": [], "save_s": []}
    g_state, d_state = _gan_states(cfg, seed, dev)
    if cfg.kind == "dcgan":
        chunk_fn = make_dcgan_chunk_fn(cfg.nz, real_label=cfg.gan_real_label, device=dev)
        curve_keys = DCGAN_CURVES
    else:
        chunk_fn = make_recon_gan_chunk_fn(**_recon_kwargs(cfg), device=dev)
        curve_keys = RECON_CURVES

    ckpt = None
    hist_path = os.path.join(workdir, "history.json") if workdir else None
    if workdir:
        ckpt = CheckpointManager(os.path.join(workdir, "ckpt"), max_to_keep=3)
    history = {k: [] for k in curve_keys}
    history["epochs"] = []
    t = time.perf_counter()
    states, start_epoch, history = _restore_chunked(
        ckpt, {"g": g_state, "d": d_state}, history, hist_path, resume, log,
        cfg.name, steps_per_epoch, per_step_keys=tuple(curve_keys))
    g_state, d_state = states["g"], states["d"]
    if start_epoch:
        timing["restore_s"] = time.perf_counter() - t

    rng = np.random.RandomState(seed + 7)
    for _ in range(start_epoch):
        rng.randint(0, pool, (steps_per_epoch, cfg.batch_size))
    fid_reals = None  # made at the first FID, then reused
    every = ckpt_every or max(cfg.val_interval, 5)
    t0 = time.perf_counter()
    for epoch in range(start_epoch, epochs):
        t = time.perf_counter()
        idxs = torch.from_numpy(rng.randint(0, pool, (steps_per_epoch, cfg.batch_size)))
        g_state, d_state, _, curves = chunk_fn(
            g_state, d_state, epoch_generator(seed + 1, epoch, dev), pool_arr, idxs.to(dev))
        curves = curves.cpu().tolist()  # the epoch's one host read
        timing["chunk_s"].append(time.perf_counter() - t)
        for k, row in zip(curve_keys, curves):
            history[k] += row
        history["epochs"].append(epoch + 1)
        log(f"[{cfg.name}] epoch {epoch + 1}/{epochs} "
            f"G {history['g_loss'][-1]:.3f} D {history['d_loss'][-1]:.3f} "
            f"({(epoch + 1 - start_epoch) * steps_per_epoch / max(time.perf_counter() - t0, 1e-9):.1f} step/s)")
        if (epoch + 1) % every == 0:
            if cfg.kind == "dcgan":
                t = time.perf_counter()
                if fid_reals is None:
                    fid_reals = _fid_reals(cfg, seed)
                fid_now = _final_fid(cfg, g_state, d_state, fid_reals, dev)
                timing["fid_s"].append(time.perf_counter() - t)
                history.setdefault("fid", []).append(fid_now)
                history.setdefault("fid_epochs", []).append(epoch + 1)
                log(f"[{cfg.name}] epoch {epoch + 1} FID {fid_now:.2f}")
            if ckpt is not None:
                t = time.perf_counter()
                ckpt.save(epoch + 1, {"g": g_state, "d": d_state})
                timing["save_s"].append(time.perf_counter() - t)
        if hist_path:
            with open(hist_path, "w") as f:
                json.dump(history, f)
    if ckpt is not None:
        ckpt.wait()
        ckpt.close()

    result = {"history": history, "g_state": g_state, "d_state": d_state,
              "resumed_from": start_epoch, "timing": timing}
    if cfg.kind == "dcgan":
        if fid_reals is None:
            fid_reals = _fid_reals(cfg, seed)
        result["fid"] = _final_fid(cfg, g_state, d_state, fid_reals, dev)
        log(f"[{cfg.name}] frozen-encoder FID {result['fid']:.2f}")
    if workdir:
        _save_samples(cfg, g_state, pool_arr[:cfg.batch_size], workdir, log, dev)
    return result


def run_domain_experiment(config: Union[str, ExperimentConfig], *,
                          epochs: Optional[int] = None,
                          steps_per_epoch: int = 8, seed: int = 0,
                          n_per_hospital: int = 8,
                          workdir: Optional[str] = None,
                          verbose: bool = True, device: DeviceLike = None) -> Dict:
    """Hold-out-hospital experiment: train on 3 domains, evaluate per domain
    and on the held-out fourth, report the generalization gap (the TCGA
    institutional-distribution protocol, ``baseline_domain.py`` +
    ``TCGA_hospital_distribution_test.ipynb``), step for step as the JAX
    package's.

    The data is :func:`~mvtb_tpu_torch.data.tcga.domain_loaders` at the
    config's spatial size and batch size (``n_per_hospital`` volumes a
    hospital, seeds ``seed + i``; the holdout at ``seed + 99``). The UNet
    comes from ``seed``; each epoch runs up to ``steps_per_epoch`` steps of
    :func:`~mvtb_tpu_torch.train.seg.seg_train_step` over the shuffled
    train loader, the stylization draws from one generator seeded
    ``seed + 1``, the losses read once an epoch. The model is then scored by
    :class:`~mvtb_tpu_torch.eval.harness.ModelEvaluation` on each
    hospital's validation split and the holdout, under ``val_stylize``
    when the config has one (:class:`~mvtb_tpu_torch.data.pipeline.
    StylizedLoader` seeded ``seed``), or on the held-in hospitals only for
    an ``in_dist_val`` config (the gap is then NaN).

    Returns ``{"losses", "eval_dict", "gap", "state"}``. At ``workdir`` it
    writes ``{name}_domain.json`` / ``.pickle`` (the evaluation record)
    and ``{name}_gap.json``. ``device=None`` means ``"cuda"`` and raises
    without a card.
    """
    cfg = get_config(config) if isinstance(config, str) else config
    dev = resolve_device(device)
    epochs = cfg.epochs if epochs is None else epochs
    log = print if verbose else (lambda *_: None)

    train_loader, val_loaders = domain_loaders(
        batch_size=cfg.batch_size, n_per_hospital=n_per_hospital, seed=seed,
        spatial=cfg.spatial)
    state = _seg_state(cfg, seed, dev)

    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    losses = []
    for epoch in range(epochs):
        epoch_losses = []
        for batch in train_loader:
            epoch_losses.append(seg_train_step(
                state, torch.from_numpy(batch["image"]), torch.from_numpy(batch["label"]),
                cfg.train_stylize, generator=generator, device=dev))
            if len(epoch_losses) >= steps_per_epoch:
                break
        losses += torch.stack(epoch_losses).float().cpu().tolist()  # one read an epoch
        log(f"[{cfg.name}|domain] epoch {epoch + 1}/{epochs} "
            f"loss {losses[-1]:.4f}")

    ev = ModelEvaluation(state.model, out_channels=1, instance_name=cfg.name, device=dev)
    if cfg.in_dist_val:
        # the …_GD_inDist protocol: validate on the training hospitals only
        val_loaders = {k: v for k, v in val_loaders.items() if k != "holdout"}
    if cfg.val_stylize is not None:
        # the reference's domain val_transform includes the stylization
        # (gibbs15_domain.py:120-136), so each model is scored under its own
        # filtering
        val_loaders = {k: StylizedLoader(v, cfg.val_stylize, seed, device=dev)
                       for k, v in val_loaders.items()}
    for name, loader in val_loaders.items():
        ev.add_eval(name, loader)
    if cfg.in_dist_val:
        in_vals = [float(v) for v in ev.eval_dict.values()]
        mean = float(np.mean(in_vals)) if in_vals else float("nan")
        gap = {"in_dist_mean": mean, "holdout": float("nan"),
               "gap": float("nan"), "normalized_gap": float("nan")}
    else:
        gap = generalization_gap({k: float(v) for k, v in ev.eval_dict.items()})
    log(f"[{cfg.name}|domain] in-dist {gap['in_dist_mean']:.4f} "
        f"holdout {gap['holdout']:.4f} gap {gap['gap']:.4f}")

    result = {"losses": losses, "eval_dict": dict(ev.eval_dict), "gap": gap,
              "state": state}
    if workdir:
        os.makedirs(workdir, exist_ok=True)
        ev.save(os.path.join(workdir, f"{cfg.name}_domain"))
        with open(os.path.join(workdir, f"{cfg.name}_gap.json"), "w") as f:
            json.dump(gap, f, indent=2)
    return result


def run(config: Union[str, ExperimentConfig], *, epochs: Optional[int] = None,
        steps_per_epoch: int = 8, seed: int = 0,
        workdir: Optional[str] = None, verbose: bool = True,
        val_batches: int = 12, chunked: bool = False, resume: bool = False,
        pool: int = 48, fast: bool = False, device: DeviceLike = None,
        ckpt_every: Optional[int] = None, arch: str = "unet") -> Dict:
    """Run one segmentation, learnable-stylization or GAN experiment end to
    end; returns the history and the final state(s): a segmentation run's
    best mean Dice and ``state``, a learnable run's per-step ``trajectory``
    of its stylization parameter, ``losses`` (per epoch when chunked, per
    step otherwise) and ``state``, a GAN run's ``g_state`` and ``d_state``
    (and a DCGAN's ``fid``); chunked runs also ``resumed_from`` and
    ``timing``.

    ``epochs`` overrides the config (the registry holds the reference's
    full training lengths). ``val_batches`` sizes the fixed held-out set.
    ``chunked=True`` runs one chunk (one host read) per epoch over a
    ``pool``-sample pool on the card; ``resume=True`` continues a chunked
    run from the latest checkpoint in ``workdir``. A chunked learnable run
    takes a pool of at most 24 samples and checkpoints every ``ckpt_every``
    epochs (default ``val_interval``). A chunked GAN run takes a
    pool of at least 256 slices, and checkpoints (and, for DCGAN, scores
    its FID) every ``ckpt_every`` epochs (default ``max(val_interval,
    5)``). ``fast=True`` applies
    :func:`~mvtb_tpu_torch.experiments.registry.fast_science` (batch 16,
    ``plane_fast``). ``device=None`` means ``"cuda"`` and raises without a
    card. ``arch`` names the segmentation model (``SEG_ARCHS``): ``"unet"``,
    the config's, or ``"swin_unetr"`` / ``"segmamba"``, that model at its
    published widths trained on its published crop (128^3) at most 4 / 2
    crops a step (``models.seg_run_config``), the run's name gaining
    ``_<arch>``; the other kinds train their own models.

    At ``workdir`` the run writes ``ckpt/`` (``{epoch}.pt`` and its
    metrics), ``history.json`` (chunked runs) and ``{name}_result.json``,
    as the JAX package does, a learnable run its
    ``gibbs_trajectory_{name}.txt``, and its PNGs (learning and per-class
    curves, the trajectory, or the GAN sample grid) when matplotlib can be
    imported; otherwise it logs one line saying they were skipped.

    Random numbers: the sampling of pool rows is the JAX package's
    (``RandomState(seed + 7)`` in chunked runs, replayed up to a resume
    point); the stylization draws of epoch ``e`` come from
    :func:`epoch_generator` ``(seed, e)`` in training and ``(seed + 2, e)``
    in validation, and in per-step runs from one generator seeded
    ``seed + 1``. The model is initialised from ``seed``. A learnable
    run's spike draws come from :func:`epoch_generator` ``(seed + 1, e)``
    (chunked) or one generator seeded ``seed + 1`` (per step). A GAN run's pool
    rows are drawn the same way; its z and compress draws of epoch ``e``
    come from :func:`epoch_generator` ``(seed + 1, e)`` (chunked) or one
    generator seeded ``seed + 1`` (per step).

    Float32 compute: the library sets no global PyTorch flag. With
    ``model_dtype="float32"`` on the card, cuDNN runs the convolutions at
    its default, TF32 (as PyTorch 1.8, the reference's, already did on
    cards that have it; the JAX package's float32 convolutions run at XLA's
    default precision on the TPU). Set
    ``torch.backends.cudnn.conv.fp32_precision = "ieee"`` (older releases:
    ``torch.backends.cudnn.allow_tf32 = False``) for full float32.
    """
    cfg = get_config(config) if isinstance(config, str) else config
    if fast:
        cfg = fast_science(cfg)
    if cfg.kind not in ("segmentation",) + LEARNABLE_KINDS + GAN_KINDS:
        raise ValueError(f"unknown experiment kind {cfg.kind}")
    cfg = seg_run_config(cfg, arch)
    dev = resolve_device(device)
    epochs = cfg.epochs if epochs is None else epochs
    log = print if verbose else (lambda *_: None)
    if workdir:
        os.makedirs(workdir, exist_ok=True)

    t0 = time.time()
    if cfg.kind in GAN_KINDS and chunked:
        result = _run_gan_chunked(cfg, steps_per_epoch, epochs, seed, workdir, log, dev,
                                  pool=max(pool, 256), resume=resume,
                                  ckpt_every=ckpt_every)
    elif cfg.kind in GAN_KINDS:
        result = _run_gan(cfg, steps_per_epoch, epochs, seed, workdir, log, dev)
    elif cfg.kind in LEARNABLE_KINDS and chunked:
        result = _run_learnable_chunked(cfg, steps_per_epoch, epochs, seed, workdir, log,
                                        dev, pool=min(pool, 24), resume=resume,
                                        ckpt_every=ckpt_every)
    elif cfg.kind in LEARNABLE_KINDS:
        result = _run_learnable(cfg, steps_per_epoch, epochs, seed, workdir, log, dev)
    elif chunked:
        result = _run_segmentation_chunked(cfg, steps_per_epoch, epochs, seed,
                                           workdir, log, dev,
                                           val_batches=val_batches, pool=pool,
                                           resume=resume, arch=arch)
    else:
        result = _run_segmentation(cfg, steps_per_epoch, epochs, seed, workdir,
                                   log, dev, val_batches=val_batches, arch=arch)
    result["wall_time_s"] = time.time() - t0

    if workdir:
        serializable = {k: v for k, v in result.items() if k in _RESULT_KEYS}
        with open(os.path.join(workdir, f"{cfg.name}_result.json"), "w") as f:
            json.dump(serializable, f, indent=2)
    return result
