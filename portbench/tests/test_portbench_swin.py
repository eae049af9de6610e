"""The SwinUNETR cell's yardstick and files: its operations against torch's
own flop counter on the plain reference, the attention's work and the
window fill in closed form at the cell's crop, each new reader on a
hand-made trace, the cell through the harness at a test's size, a
program without the model failing at once, and the control failing the
cell's limits (at a test's size on the CPU; at the cell's size on the
card, marked ``cuda``)."""

import math
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops_swin, harness, roofline, swin_work
from portbench.reference import swin_unetr as ref

ROOT = Path(__file__).resolve().parents[2]
FOLDER = ROOT / "portbench"
CELL = "train.swin_unetr_gibbs12p5.b4"
FULL = dict(in_channels=4, out_channels=3, feature_size=48, depths=[2, 2, 2, 2],
            num_heads=[3, 6, 12, 24], window_size=7)
SMALL_MODEL = dict(FULL, kind="SwinUNETR", feature_size=12)
SMALL = {"workload": {"batch": 2, "pool": 4, "spatial": [32, 32, 32], "chunk_steps": 2},
         "config": {"model": SMALL_MODEL}}
# a sound run at a test's size is judged in float32, on the float32 plane
# path: the limits are the cell's, set for bf16 at 128^3
F32 = {"workload": SMALL["workload"],
       "config": {"model": SMALL_MODEL,
                  "precision": {"model": "float32", "parameters": "float32",
                                "stylize": "float32", "peak": "float32"},
                  "stylize": {"disk_r": 12.5, "disk_prob": 1.0, "fft_backend": "plane"}}}


def counted(model_cfg, shape, backward):
    m = ref.build(model_cfg)
    x = torch.randn(shape)
    with FlopCounterMode(display=False) as fc:
        y = m(x)
        if backward:
            y.sum().backward()
    return fc.get_total_flops()


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("model_cfg,shape", [
    (dict(FULL, feature_size=12), (1, 4, 32, 32, 32)),
    (dict(FULL, feature_size=6, depths=[2, 1, 1, 2], num_heads=[1, 2, 2, 3]), (1, 4, 32, 64, 32)),
])
def test_swin_unetr_flops_match_flop_counter(model_cfg, shape, backward):
    want = counted(model_cfg, shape, backward)
    assert flops_swin.swin_unetr_flops(model_cfg, shape[2:], batch=shape[0],
                                       backward=backward) == want


def test_swin_unetr_flops_at_the_cells_crop():
    assert flops_swin.swin_unetr_flops(FULL, (128,) * 3) == 1543286973696
    assert flops_swin.swin_unetr_flops(FULL, (128,) * 3, backward=True) == 4606507036416
    # the Swin encoder's linear layers and attention products: 9% of the forward
    swin = sum(f for f, _ in flops_swin.swin_products(FULL, (128,) * 3))
    assert swin / flops_swin.swin_unetr_flops(FULL, (128,) * 3) == pytest.approx(0.0881, abs=1e-4)


def test_window_fill_and_attention_work_at_the_cells_crop():
    bs = swin_work.blocks(FULL, (128,) * 3)
    assert [(b["real"], b["padded"], b["windows"], b["shifted"]) for b in bs[::2]] == [
        (64 ** 3, 70 ** 3, 1000, False), (32 ** 3, 35 ** 3, 125, False),
        (16 ** 3, 21 ** 3, 27, False), (8 ** 3, 14 ** 3, 8, False)]
    assert all(b["shifted"] for b in bs[1::2])
    assert swin_work.window_fill(FULL, (128,) * 3) == pytest.approx(100 * 299520 / 397880)
    assert round(swin_work.window_fill(FULL, (128,) * 3), 2) == 75.28
    ops, nbytes = swin_work.attn_work(FULL, (128,) * 3, 4)[1]  # stage 1's shifted block
    assert ops == 4 * 4 * 70 ** 3 * 343 * 48
    assert nbytes == 2 * (4 * 4 * 70 ** 3 * 48 + 3 * 343 ** 2 + 1000 * 343 ** 2)
    t, by = roofline.least_seconds(ops, nbytes)
    assert by == "bytes" and t == pytest.approx(nbytes / roofline.HBM_BYTES_PER_S)
    assert swin_work.attn_least_seconds(FULL, (128,) * 3, 4) == pytest.approx(
        sum(roofline.least_seconds(o, b)[0] for o, b in swin_work.attn_work(FULL, (128,) * 3, 4)))


def reader(name):
    return harness.load_file(harness.reader_path(FOLDER, name), "m_" + name.replace(".", "_"))


def host(name, ts, dur):
    return {"name": name, "ts": float(ts), "dur": float(dur)}


def dev(name, ts, dur, ops=()):
    return {"name": name, "cat": "kernel", "ts": float(ts), "dur": float(dur), "ops": list(ops)}


def record(trace, model=FULL, spatial=(128, 128, 128), batch=4):
    return {"workload": {"spatial": list(spatial), "batch": batch}, "config": {"model": model},
            "window_s": None, "counters": {}, "spans": defaultdict(list), "trace": trace}


def swin_trace():
    """Two steps; each forward: a layout kernel of 100 us, an attention
    kernel of 400 us and another kernel of 500 us inside the encoder, and
    a backward attention kernel outside every span."""
    h, d = [], []
    for t0 in (0, 10000):
        h += [host("mvtb.step", t0, 9000), host("mvtb.swin.encoder", t0 + 100, 3000),
              host("mvtb.swin.window", t0 + 200, 100), host("mvtb.swin.attn", t0 + 400, 500)]
        d += [dev("copy", t0 + 200, 100, ("aten::copy_", "mvtb.swin.window",
                                          "mvtb.swin.encoder", "mvtb.step")),
              dev("fmha_fwd", t0 + 400, 400, ("aten::sdpa", "mvtb.swin.attn",
                                              "mvtb.swin.encoder", "mvtb.step")),
              dev("gemm", t0 + 1000, 500, ("aten::mm", "mvtb.swin.encoder", "mvtb.step")),
              dev("fmha_bwd", t0 + 5000, 900, ("autograd::engine",))]
    return {"window": [0.0, 20000.0], "host": h, "device": d}


def test_span_readers_on_a_hand_made_trace():
    rec = record(swin_trace())
    for name, ms in (("swin_attn_device_ms_per_step.train_swin", 0.4),
                     ("swin_layout_device_ms_per_step.train_swin", 0.1),
                     ("swin_encoder_device_ms_per_step.train_swin", 1.0)):
        assert reader(name).read(rec) == pytest.approx(ms), name
    least = swin_work.attn_least_seconds(FULL, (128,) * 3, 4)
    share = reader("swin_attn_roofline.train_swin").read(rec)
    assert share == pytest.approx(100 * least * 2 / 800e-6)


@pytest.mark.parametrize("name", ["swin_attn_device_ms_per_step.train_swin",
                                  "swin_layout_device_ms_per_step.train_swin",
                                  "swin_encoder_device_ms_per_step.train_swin",
                                  "swin_attn_roofline.train_swin"])
def test_span_readers_find_nothing_without_the_spans(name):
    bare = {"window": [0.0, 1.0], "host": [host("mvtb.step", 0, 1)], "device": []}
    assert reader(name).read(record(bare)) is None
    assert reader(name).read(record(None)) is None


def test_window_fill_reader(monkeypatch):
    from mvtb_tpu_torch.utils import profiling

    r = reader("swin_window_fill.train_swin")
    monkeypatch.setattr(profiling, "counters", {})
    assert r.read(record(None)) is None
    monkeypatch.setattr(profiling, "counters",
                        {"swin.tokens": 299520, "swin.window_tokens": 397880})
    assert r.read(record(None)) == pytest.approx(75.2789785)


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_through_the_harness_at_a_tests_size(trace):
    r = harness.run_cell(CELL, 2 ** 31 + 23, 0.2, trace, device="cpu", overrides=F32)
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0, r["checks"]
    if not trace:
        assert set(r["metrics"]) == {"setup_s", "train_vol_per_s"}
    else:  # a CPU trace holds no device records: the span readers find nothing
        assert {"mfu.train_swin", "swin_window_fill.train_swin"} <= set(r["metrics"])
        assert r["metrics"]["swin_window_fill.train_swin"]["value"] == pytest.approx(
            swin_work.window_fill(SMALL_MODEL, (32, 32, 32)))


@pytest.mark.parametrize("fault", ["half_batch", "loss_altered"])
def test_a_faulty_step_is_not_correct(monkeypatch, fault):
    import mvtb_tpu_torch.train.chunked as chunked

    step = chunked.seg_train_step

    def broken(state, image, label, stylize_cfg=None, **kw):
        if fault == "half_batch":
            h = image.shape[0] // 2
            return step(state, image[:h], label[:h], stylize_cfg, **kw)
        return step(state, image, label, stylize_cfg, **kw) + 0.02

    monkeypatch.setattr(chunked, "seg_train_step", broken)
    r = harness.run_cell(CELL, 2 ** 31 + 23, 0.2, False, device="cpu", overrides=F32)
    assert not r["correct"], r["checks"]


def test_a_program_without_the_model_fails_at_once():
    code = ("import sys; sys.modules['mvtb_tpu_torch.models.swin_unetr'] = None\n"
            "from pathlib import Path\nfrom portbench import harness\n"
            "harness.load_file(Path('portbench/drivers/train_chunked_arch.py'), 'd')")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0 and "mvtb_tpu_torch.models.swin_unetr" in res.stderr


def failed(ctx, gaps):
    return [k for k, lim in ctx.wl["limits"].items() if not gaps[k] <= lim]


def check_control(device, seed, overrides=None):
    drv = harness.load_file(FOLDER / "drivers" / "train_chunked_arch.py", "d_swin")
    ctx = harness.Run(ROOT, CELL, seed, 1.0, False, device, 0.0, overrides)
    for side, gaps in drv.upper_readings(ctx).items():
        assert failed(ctx, gaps), (side, gaps, ctx.wl["limits"])


def test_control_fails_at_a_small_size():
    check_control("cpu", 2 ** 31 + 17, SMALL)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3300000021, 3300000022])
def test_control_fails_at_the_cells_size(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    check_control("cuda", seed)


def test_weights_follow_the_stated_draw():
    drv = harness.load_file(FOLDER / "drivers" / "train_chunked_arch.py", "d_swin_w")
    shapes = ref.param_shapes(dict(FULL, feature_size=12))
    w = drv.make_weights(5, shapes, "cpu")
    assert list(w) == list(shapes) and all(tuple(w[k].shape) == s for k, s in shapes.items())
    assert torch.equal(w["swinViT.layers1.0.blocks.0.norm1.weight"], torch.ones(12))
    assert not w["swinViT.layers1.0.blocks.0.attn.qkv.bias"].any()
    std = w["decoder1.conv_block.conv1.conv.weight"].std()
    assert float(std) == pytest.approx(1 / math.sqrt(24 * 27), rel=0.05)
    assert float(w["swinViT.layers1.0.blocks.0.attn.relative_position_bias_table"].std()) == \
        pytest.approx(0.02, rel=0.1)
    assert torch.equal(drv.make_weights(5, shapes, "cpu")["out.conv.conv.weight"],
                       w["out.conv.conv.weight"])
