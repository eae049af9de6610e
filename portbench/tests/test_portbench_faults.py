"""Runs of each cell's kind at a test's size on the CPU, with the timed
path broken underneath: each fault the cell can have must turn ``correct``
false, and the sound run must stay true."""

import pytest
import torch

from portbench import harness

F32 = {"precision": {"model": "float32", "parameters": "float32", "stylize": "float32",
                     "peak": "float32"}}
TRAIN = {"batch": 2, "pool": 6, "spatial": [32, 32, 16], "chunk_steps": 2, "trace_chunks": 1}
EVAL = {"pool": 3, "spatial": [48, 40, 24], "roi": [32, 32, 16], "check_within": 4,
        "check_volumes": 3, "trace_volumes": 1, "levels": [None, 3.0, 4.0]}
# at these sizes a disk of radius 12.5 keeps nearly the whole spectrum, so
# the stylize cell's runs here use radius 4
STYLIZE = {"pool": 4, "batch": 2, "spatial": [24, 20, 16], "check_within": 4,
           "check_batches": 2, "sync_every": 2}


def run(cell, workload, config=None, seed=3, seconds=0.3):
    return harness.run_cell(cell, seed, seconds, False, device="cpu",
                            overrides={"workload": workload, "config": config or {}})


def patch_step(monkeypatch, fault):
    import mvtb_tpu_torch.train.chunked as chunked
    from mvtb_tpu_torch.ops.fused import stylize_batch
    from mvtb_tpu_torch.train.losses import dice_loss

    step = chunked.seg_train_step

    def broken(state, image, label, stylize_cfg=None, **kw):
        if fault == "unchanged":  # the loss, and no update
            with torch.no_grad():
                x = stylize_batch(image, stylize_cfg, device="cpu")
                return dice_loss(state.model(x), label)
        if fault == "half_batch":
            h = image.shape[0] // 2
            return step(state, image[:h], label[:h], stylize_cfg, **kw)
        return step(state, image, label, stylize_cfg, **kw) + 0.02  # the loss altered

    monkeypatch.setattr(chunked, "seg_train_step", broken)


def patch_chunk(monkeypatch):
    """A chunk whose every step trains on the rows of its first."""
    import mvtb_tpu_torch.train.chunked as chunked

    make = chunked.make_chunk_fn

    def broken_make(*args, **kwargs):
        chunk_fn = make(*args, **kwargs)

        def broken(state, gen, pool_i, pool_l, idxs, **kw):
            return chunk_fn(state, gen, pool_i, pool_l, idxs[:1].expand_as(idxs), **kw)

        return broken

    monkeypatch.setattr(chunked, "make_chunk_fn", broken_make)


@pytest.mark.parametrize("backend", ["auto", "plane"])
@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch", "loss_altered",
                                   "rows_reused"])
def test_train_faults(monkeypatch, backend, fault):
    if fault == "rows_reused":
        patch_chunk(monkeypatch)
    elif fault:
        patch_step(monkeypatch, fault)
    r = run("train.gibbs12p5_fast.b16", TRAIN, dict(F32, stylize={
        "disk_r": 12.5, "disk_prob": 1.0, "fft_backend": backend}))
    assert r["correct"] is (fault is None), r["checks"]


def patch_stylize(monkeypatch, fault):
    import mvtb_tpu_torch.ops.fused as fused

    real = fused.stylize_batch

    def broken(x, cfg, **kw):
        if fault == "unchanged":
            return x
        out = real(x, cfg, **kw)
        if fault == "half_batch":  # the second half of the batch left unstylized
            out = torch.cat([out[:x.shape[0] // 2], x[x.shape[0] // 2:].to(out)])
        elif fault == "altered":  # the first volume at another radius
            out = out.clone()
            out[:1] = real(x[:1], type(cfg)(**{**cfg.__dict__, "disk_r": 2.0}), **kw)
        return out

    monkeypatch.setattr(fused, "stylize_batch", broken)


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch", "altered"])
def test_stylize_faults(monkeypatch, fault):
    if fault:
        patch_stylize(monkeypatch, fault)
    r = run("stylize.gibbs12p5_fast.fullvol", STYLIZE, dict(F32, stylize={
        "disk_r": 4.0, "disk_prob": 1.0, "fft_backend": "plane"}))
    assert r["correct"] is (fault is None), r["checks"]


def patch_harness(monkeypatch, fault):
    import mvtb_tpu_torch.eval.harness as harness_mod

    if fault == "blend":  # the tiles blended with Gaussian weights
        real = harness_mod.sliding_window_inference

        def gaussian(*args, **kwargs):
            return real(*args, **{**kwargs, "mode": "gaussian"})

        monkeypatch.setattr(harness_mod, "sliding_window_inference", gaussian)
    else:  # the Dice thresholded above one half
        real = harness_mod.threshold_predictions
        monkeypatch.setattr(harness_mod, "threshold_predictions",
                            lambda logits: real(logits, 0.6))


@pytest.mark.parametrize("fault", [None, "unchanged", "altered", "logits_altered", "blend",
                                   "dice_threshold"])
def test_eval_faults(monkeypatch, fault):
    if fault in ("blend", "dice_threshold"):
        patch_harness(monkeypatch, fault)
    elif fault == "logits_altered":  # the first tile of each forward shifted
        from mvtb_tpu_torch.models import unet3d

        real = unet3d.UNet.forward

        def shifted(self, x):
            out = real(self, x).clone()
            out[0] += 0.5 * out[0].abs().amax()
            return out

        monkeypatch.setattr(unet3d.UNet, "forward", shifted)
    elif fault:
        patch_stylize(monkeypatch, fault)
    r = run("eval.gibbs12p5_fast.fullvol", EVAL, dict(F32, stylize={
        "disk_r": 12.5, "disk_prob": 1.0, "fft_backend": "plane"}), seconds=4.0)
    assert r["correct"] is (fault is None), r["checks"]
