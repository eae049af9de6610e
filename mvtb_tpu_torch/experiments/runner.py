"""Config-driven experiment runner (counterpart of
mvtb_tpu/experiments/runner.py): the segmentation family.

:func:`run` executes a registry entry of kind ``segmentation`` end to end,
the replacement for the reference's per-script training loops (the T1
template ``baseline.py:232-318`` and its clones): per-step training with
prefetched batches, or chunked training over a pool that lives on the
card; validation every ``val_interval`` epochs over a fixed held-out set;
full-state checkpoints; resume. Data comes from
:mod:`mvtb_tpu_torch.data.synthetic`.

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
item: the learnable-stylization kinds (section 1, item 6), the GAN kinds
(item 7) and :func:`run_domain_experiment` (item 5, with the data loaders
of item 4 and the evaluation harness of item 3).
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
from mvtb_tpu_torch.data.synthetic import cached_batches
from mvtb_tpu_torch.experiments.registry import ExperimentConfig, fast_science
from mvtb_tpu_torch.experiments.registry import get as get_config
from mvtb_tpu_torch.models import UNet
from mvtb_tpu_torch.train.checkpoint import CheckpointManager
from mvtb_tpu_torch.train.chunked import make_chunk_fn
from mvtb_tpu_torch.train.seg import (EpochMetrics, SegState, create_seg_state,
                                      reference_optimizer, seg_eval_step,
                                      seg_train_step)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# where the experiment kinds the runner does not run yet are queued
_TODO_KINDS = {
    "learnable_gibbs": "ROADMAP.md section 1, item 6 (learnable stylization)",
    "learnable_spikes": "ROADMAP.md section 1, item 6 (learnable stylization)",
    "dcgan": "ROADMAP.md section 1, item 7 (GANs)",
    "recon_gan": "ROADMAP.md section 1, item 7 (GANs)",
    "recon_gan_freq": "ROADMAP.md section 1, item 7 (GANs)",
    "gibbs_gan": "ROADMAP.md section 1, item 7 (GANs)",
}

# the keys of {name}_result.json, as the JAX package writes them for a
# segmentation run
_RESULT_KEYS = ("history", "best_dice", "wall_time_s")


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


def epoch_generator(base: int, epoch: int, device: DeviceLike = None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``(base, epoch)``
    alone: ``numpy.random.SeedSequence((base, epoch))``'s first 64-bit
    word. The counterpart of the JAX runner's ``fold_in(key(base), epoch)``:
    epoch ``e`` draws the same numbers whether the run started at epoch 0
    or resumed, so a resumed run replays an uninterrupted one exactly."""
    word = np.random.SeedSequence((base, epoch)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=resolve_device(device)).manual_seed(int(word))


def _seg_state(cfg: ExperimentConfig, seed: int, dev: torch.device) -> SegState:
    """The run's UNet, initialised from ``seed`` (PyTorch's generators are
    forked, so the caller's stay as they were), and the reference
    optimizer."""
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(seed)
        model = UNet(cfg.in_channels, cfg.out_channels, cfg.channels, cfg.strides,
                     cfg.num_res_units, device=dev, dtype=_DTYPES[cfg.model_dtype])
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


def _run_segmentation(cfg: ExperimentConfig, steps_per_epoch: int, epochs: int,
                      seed: int, workdir: Optional[str], log, dev: torch.device,
                      val_batches: int = 12) -> Dict:
    """Per-step training: batches from the host pool, prefetched to the
    card; a checkpoint at each validation that improves the best mean Dice.
    The losses of an epoch are summed on the card and read once."""
    state = _seg_state(cfg, seed, dev)
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
    return {"history": history, "best_dice": best, "state": state}


def _run_segmentation_chunked(cfg: ExperimentConfig, steps_per_epoch: int,
                              epochs: int, seed: int, workdir: Optional[str],
                              log, dev: torch.device, val_batches: int = 12,
                              pool: int = 48, resume: bool = False) -> Dict:
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
    state = _seg_state(cfg, seed, dev)

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
    epochs), a per-epoch key, a per-step key, or a per-validation key (one
    entry per element of ``"epochs"``, as the segmentation runner's
    ``"dice"``). Any other key raises ``KeyError``: a guessed truncation
    would silently corrupt it on resume.
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
        for k, v in history.items():
            if k == "epochs":
                history[k] = [e for e in v if e <= start_epoch]
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


def run_domain_experiment(config: Union[str, ExperimentConfig], **kwargs) -> Dict:
    """Not ported yet: the hospital-domain protocol needs the data loaders
    and the evaluation harness."""
    raise NotImplementedError(
        "run_domain_experiment: ROADMAP.md section 1, item 5 (with the data "
        "loaders of item 4 and the evaluation harness of item 3)")


def run(config: Union[str, ExperimentConfig], *, epochs: Optional[int] = None,
        steps_per_epoch: int = 8, seed: int = 0,
        workdir: Optional[str] = None, verbose: bool = True,
        val_batches: int = 12, chunked: bool = False, resume: bool = False,
        pool: int = 48, fast: bool = False, device: DeviceLike = None) -> Dict:
    """Run one segmentation experiment end to end; returns the history, the
    best mean Dice and the final state (chunked runs also ``resumed_from``
    and ``timing``).

    ``epochs`` overrides the config (the registry holds the reference's
    full training lengths). ``val_batches`` sizes the fixed held-out set.
    ``chunked=True`` runs one chunk (one host read) per epoch over a
    ``pool``-sample pool on the card; ``resume=True`` continues a chunked
    run from the latest checkpoint in ``workdir``. ``fast=True`` applies
    :func:`~mvtb_tpu_torch.experiments.registry.fast_science` (batch 16,
    ``plane_fast``). ``device=None`` means ``"cuda"`` and raises without a
    card.

    At ``workdir`` the run writes ``ckpt/`` (``{epoch}.pt`` and its
    metrics), ``history.json`` (chunked runs) and ``{name}_result.json``,
    as the JAX package does. The two learning-curve PNGs come with
    ``eval/plots.py`` (ROADMAP.md section 1, item 3): nothing on this path
    imports matplotlib.

    Random numbers: the sampling of pool rows is the JAX package's
    (``RandomState(seed + 7)`` in chunked runs, replayed up to a resume
    point); the stylization draws of epoch ``e`` come from
    :func:`epoch_generator` ``(seed, e)`` in training and ``(seed + 2, e)``
    in validation, and in per-step runs from one generator seeded
    ``seed + 1``. The model is initialised from ``seed``.

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
    if cfg.kind in _TODO_KINDS:
        raise NotImplementedError(f"experiment kind {cfg.kind!r}: {_TODO_KINDS[cfg.kind]}")
    if cfg.kind != "segmentation":
        raise ValueError(f"unknown experiment kind {cfg.kind}")
    dev = resolve_device(device)
    epochs = cfg.epochs if epochs is None else epochs
    log = print if verbose else (lambda *_: None)
    if workdir:
        os.makedirs(workdir, exist_ok=True)

    t0 = time.time()
    if chunked:
        result = _run_segmentation_chunked(cfg, steps_per_epoch, epochs, seed,
                                           workdir, log, dev,
                                           val_batches=val_batches, pool=pool,
                                           resume=resume)
    else:
        result = _run_segmentation(cfg, steps_per_epoch, epochs, seed, workdir,
                                   log, dev, val_batches=val_batches)
    result["wall_time_s"] = time.time() - t0

    if workdir:
        serializable = {k: v for k, v in result.items() if k in _RESULT_KEYS}
        with open(os.path.join(workdir, f"{cfg.name}_result.json"), "w") as f:
            json.dump(serializable, f, indent=2)
    return result
