"""The SegMamba cell's yardstick and files: the scan's work against a hand
count, the model's operations against torch's own flop counter on the
plain reference plus the scan's count, each new reader on a hand-made
trace (and nothing where its spans or kernels are absent), the driver's
weight draw, the cell through the harness at a test's size, a faulty step
failing it, a program without the model failing at once, and the control
failing the cell's limits (at a test's size on the CPU; at the cell's size
on the card, marked ``cuda``)."""

import math
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops_segmamba, harness, roofline, scan_work
from portbench.reference import segmamba as ref

ROOT = Path(__file__).resolve().parents[2]
FOLDER = ROOT / "portbench"
CELL = "train.segmamba_gibbs12p5.b2"
FULL = dict(in_channels=4, out_channels=3, feature_size=[48, 96, 192, 384],
            depths=[2, 2, 2, 2], hidden_size=768, d_state=16, d_conv=4, expand=2,
            num_slices=[64, 32, 16, 8])
SMALL_MODEL = dict(FULL, kind="SegMamba", feature_size=[8, 16, 32, 64], hidden_size=32,
                   num_slices=[16, 8, 4, 2])
SMALL = {"workload": {"batch": 2, "pool": 4, "spatial": [32, 32, 32], "chunk_steps": 2},
         "config": {"model": SMALL_MODEL}}
# a sound run at a test's size is judged in float32, on the float32 plane
# path: the limits are the cell's, set for bf16 at 128^3
F32 = {"workload": SMALL["workload"],
       "config": {"model": SMALL_MODEL,
                  "precision": {"model": "float32", "parameters": "float32",
                                "stylize": "float32", "peak": "float32"},
                  "stylize": {"disk_r": 12.5, "disk_prob": 1.0, "fft_backend": "plane"}}}


def test_scan_work_against_a_hand_count():
    """One scan, batch 2, d 6, L 10, N 4, in bfloat16: 2*6*10 = 120 rows and
    2*10*4 = 80 sequence values; 7 operations an update, 11 a row."""
    ops, nbytes = scan_work.scan_work(6, 10, 4, 2)
    assert ops == 7 * 120 * 4 + 11 * 120
    assert nbytes == 2 * (4 * 120 + 2 * 80) + 4 * (6 * 4 + 2 * 6)
    bops, bbytes = scan_work.scan_work(6, 10, 4, 2, backward=True)
    assert bops == 2 * ops
    assert bbytes == 2 * (7 * 120 + 4 * 80) + 2 * 4 * (6 * 4 + 2 * 6)
    calls = scan_work.scans(FULL, (128,) * 3)
    assert [(c["d"], c["L"]) for c in calls[::6]] == [(96, 64 ** 3), (192, 32 ** 3),
                                                      (384, 16 ** 3), (768, 8 ** 3)]
    assert len(calls) == 24
    least = scan_work.step_least_seconds(FULL, (128,) * 3, 2)
    want = sum(roofline.least_seconds(*w)[0] for w in scan_work.step_work(FULL, (128,) * 3, 2))
    assert least == pytest.approx(want)
    assert all(roofline.least_seconds(*w)[1] == "bytes"
               for w in scan_work.step_work(FULL, (128,) * 3, 2))
    assert 2.5e-3 < least < 3.5e-3


def conv1d_overcount(m, backward):
    """torch's flop counter counts a grouped convolution's weight gradient
    as if it were not grouped, ``groups`` times over: the causal depthwise
    conv1d's by a factor of ``d``. What it counts beyond the true count."""
    if not backward:
        return 0.0
    extra = 0.0
    for c, depth, grid in zip(m["feature_size"], m["depths"],
                              scan_work.stage_grids(m, (16, 16, 16))):
        d, L = m["expand"] * c, math.prod(grid)
        extra += depth * 3 * 2.0 * (L + m["d_conv"] - 1) * d * m["d_conv"] * (d - 1)
    return extra


@pytest.mark.parametrize("backward", [False, True])
def test_flops_match_flop_counter_plus_the_scans(backward):
    m = dict(FULL, feature_size=[8, 16, 32, 64], depths=[2, 1, 1, 2], hidden_size=32,
             num_slices=[8, 4, 2, 1])
    r = ref.build(m)
    x = torch.randn(2, 4, 16, 16, 16)
    with FlopCounterMode(display=False) as fc:
        y = r(x)
        if backward:
            y.sum().backward()
    counted = fc.get_total_flops() - 2 * conv1d_overcount(m, backward)
    want = counted + 2 * scan_work.scan_flops(m, (16, 16, 16), backward)
    assert flops_segmamba.segmamba_flops(m, (16, 16, 16), batch=2, backward=backward) == want


def test_flop_counter_overcounts_a_grouped_weight_gradient():
    x = torch.randn(2, 16, 100, requires_grad=True)
    w = torch.randn(16, 1, 4, requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        F.conv1d(x, w, padding=3, groups=16)[..., :100].sum().backward()
    fwd = 2 * 2 * 16 * 103 * 4
    assert fc.get_total_flops() == fwd + fwd + 16 * fwd


def test_flops_at_the_cells_crop():
    fwd = flops_segmamba.segmamba_flops(FULL, (128,) * 3)
    both = flops_segmamba.segmamba_flops(FULL, (128,) * 3, backward=True)
    assert fwd == pytest.approx(2.9618e12, rel=1e-4)
    assert both == pytest.approx(8.8284e12, rel=1e-4)
    convs = sum(2.0 * a * b * k ** 3 * v for a, b, k, v, _ in
                flops_segmamba.convs(FULL, (128,) * 3))
    assert convs / fwd == pytest.approx(0.98, abs=0.01)


def reader(name):
    return harness.load_file(harness.reader_path(FOLDER, name), "m_" + name.replace(".", "_"))


def host(name, ts, dur):
    return {"name": name, "ts": float(ts), "dur": float(dur)}


def dev(name, ts, dur, ops=()):
    return {"name": name, "cat": "kernel", "ts": float(ts), "dur": float(dur), "ops": list(ops)}


def record(trace, batch=2):
    return {"workload": {"spatial": [128, 128, 128], "batch": batch},
            "config": {"model": FULL, "precision": {"model": "bfloat16"}},
            "window_s": None, "counters": {}, "spans": defaultdict(list), "trace": trace}


def mamba_trace():
    """Two steps; each forward: a layout copy of 100 us, a scan forward of
    300 us and a GEMM of 500 us inside the encoder; each backward a scan
    backward of 700 us outside every span."""
    h, d = [], []
    for t0 in (0, 10000):
        h += [host("mvtb.step", t0, 9000), host("mvtb.mamba.encoder", t0 + 100, 3000),
              host("mvtb.mamba.layout", t0 + 200, 100), host("mvtb.mamba.scan", t0 + 400, 500)]
        d += [dev("copy", t0 + 200, 100, ("aten::copy_", "mvtb.mamba.layout",
                                          "mvtb.mamba.encoder", "mvtb.step")),
              dev("void (anonymous namespace)::selective_scan_fwd_kernel<__nv_bfloat16, true>",
                  t0 + 400, 300, ("mvtb::selective_scan_fwd", "mvtb.mamba.scan",
                                  "mvtb.mamba.encoder", "mvtb.step")),
              dev("gemm", t0 + 1000, 500, ("aten::mm", "mvtb.mamba.encoder", "mvtb.step")),
              dev("void (anonymous namespace)::selective_scan_bwd_kernel<__nv_bfloat16>",
                  t0 + 5000, 700, ("autograd::engine",))]
    return {"window": [0.0, 20000.0], "host": h, "device": d}


def test_readers_on_a_hand_made_trace():
    rec = record(mamba_trace())
    for name, ms in (("scan_device_ms_per_step.train_segmamba", 1.0),
                     ("mamba_layout_device_ms_per_step.train_segmamba", 0.1),
                     ("mamba_encoder_device_ms_per_step.train_segmamba", 0.9)):
        assert reader(name).read(rec) == pytest.approx(ms), name
    least = scan_work.step_least_seconds(FULL, (128,) * 3, 2)
    share = reader("scan_roofline.train_segmamba").read(rec)
    assert share == pytest.approx(100 * least * 2 / 2000e-6)


@pytest.mark.parametrize("name", ["scan_device_ms_per_step.train_segmamba",
                                  "mamba_layout_device_ms_per_step.train_segmamba",
                                  "mamba_encoder_device_ms_per_step.train_segmamba",
                                  "scan_roofline.train_segmamba"])
def test_readers_find_nothing_without_their_spans_or_kernels(name):
    bare = {"window": [0.0, 1.0], "host": [host("mvtb.step", 0, 1)],
            "device": [dev("gemm", 0, 1, ("aten::mm", "mvtb.step"))]}
    assert reader(name).read(record(bare)) is None
    assert reader(name).read(record(None)) is None


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_through_the_harness_at_a_tests_size(trace):
    r = harness.run_cell(CELL, 2 ** 33 + 5, 0.2, trace, device="cpu", overrides=F32)
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0, r["checks"]
    if not trace:
        assert set(r["metrics"]) == {"setup_s", "train_vol_per_s"}
    else:  # a CPU trace holds no device records: the trace readers find nothing
        assert set(r["metrics"]) == {"mfu.train_segmamba", "host_issue_ms_per_step.train"}


def test_a_faulty_step_is_not_correct(monkeypatch):
    import mvtb_tpu_torch.train.chunked as chunked

    step = chunked.seg_train_step

    def broken(state, image, label, stylize_cfg=None, **kw):
        return step(state, image, label, stylize_cfg, **kw) + 0.02

    monkeypatch.setattr(chunked, "seg_train_step", broken)
    r = harness.run_cell(CELL, 2 ** 33 + 5, 0.2, False, device="cpu", overrides=F32)
    assert not r["correct"], r["checks"]


def test_a_program_without_the_model_fails_at_once():
    code = ("import sys; sys.modules['mvtb_tpu_torch.models.segmamba'] = None\n"
            "from pathlib import Path\nfrom portbench import harness\n"
            "harness.load_file(Path('portbench/drivers/train_chunked_segmamba.py'), 'd')")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0 and "mvtb_tpu_torch.models.segmamba" in res.stderr


def failed(ctx, gaps):
    return [k for k, lim in ctx.wl["limits"].items() if not gaps[k] <= lim]


def check_control(device, seed, overrides=None):
    drv = harness.load_file(FOLDER / "drivers" / "train_chunked_segmamba.py", "d_mamba")
    ctx = harness.Run(ROOT, CELL, seed, 1.0, False, device, 0.0, overrides)
    gaps = drv.upper_readings(ctx)["control"]
    assert failed(ctx, gaps), (gaps, ctx.wl["limits"])


def test_control_fails_at_a_small_size():
    check_control("cpu", 2 ** 33 + 7, SMALL)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3300000031])
def test_control_fails_at_the_cells_size(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    check_control("cuda", seed)


def test_weights_keep_mambas_initialisation():
    drv = harness.load_file(FOLDER / "drivers" / "train_chunked_segmamba.py", "d_mamba_w")
    shapes = ref.param_shapes(dict(FULL, feature_size=[8, 16, 32, 64], hidden_size=32))
    w = drv.make_weights(5, shapes, "cpu")
    assert list(w) == list(shapes) and all(tuple(w[k].shape) == s for k, s in shapes.items())
    m = "vit.stages.0.0.mamba."
    for o in ("", "_b", "_s"):
        a_log = w[m + ("A_log" if o == "" else f"A{o}_log")]
        assert torch.allclose(a_log, torch.log(torch.arange(1.0, 17.0)).expand(16, 16))
        assert torch.equal(w[m + f"D{o}"], torch.ones(16))
        dt = F.softplus(w[m + f"dt_proj{o}.bias"])
        assert float(dt.min()) >= 1e-4 * (1 - 1e-5) and float(dt.max()) <= 0.1 * (1 + 1e-5)
        assert float(w[m + f"dt_proj{o}.weight"].abs().max()) <= 1.0  # R = 1 here
        assert float(w[m + f"conv1d{o}.weight"].abs().max()) > 0
    assert torch.equal(w["vit.stages.0.0.norm.weight"], torch.ones(8))
    assert not w["vit.gscs.0.proj.conv.bias"].any()
    std = w["decoder2.conv_block.conv1.conv.weight"].std()
    assert float(std) == pytest.approx(1 / math.sqrt(16 * 27), rel=0.05)
    assert torch.equal(drv.make_weights(5, shapes, "cpu")["out.conv.conv.weight"],
                       w["out.conv.conv.weight"])
