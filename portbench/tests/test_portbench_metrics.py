"""Each per-layer reader on a hand-made record, and the trace's reading of
a hand-made chrome trace."""

from collections import defaultdict
from pathlib import Path

import pytest

from portbench import harness, roofline, trace

FOLDER = Path(__file__).resolve().parents[1]


def reader(name):
    """The reader ``run_cell`` loads for the metric ``name``."""
    return harness.load_file(harness.reader_path(FOLDER, name), "m_" + name.replace(".", "_"))


def record(**kw):
    rec = {"workload": {}, "config": {"precision": {"model": "bfloat16", "stylize": "bfloat16",
                                                    "peak": "bfloat16"}},
           "window_s": None, "counters": {}, "spans": defaultdict(list), "trace": None}
    rec.update(kw)
    return rec


def dev(name, ts, dur, ops=(), cat="kernel"):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "ops": list(ops)}


@pytest.mark.parametrize("kind", ["train", "eval", "stylize"])
def test_idle_share_takes_the_union_of_overlapping_kernels(kind):
    tr = {"window": [0.0, 100.0], "host": [],
          "device": [dev("a", 10, 20), dev("b", 20, 20), dev("c", 50, 10, cat="gpu_memcpy"),
                     dev("d", 95, 20)]}
    # busy 10-40, 50-60, 95-100: 45 of 100
    assert reader(f"device_idle_share.{kind}").read(record(trace=tr)) == pytest.approx(55.0)
    assert reader(f"device_idle_share.{kind}").read(record()) is None


def test_conv_device_time_per_step():
    tr = {"window": [0, 1000], "host": [], "steps": 2, "device": [
        dev("implicit_gemm", 0, 300, ["aten::cudnn_convolution", "aten::_convolution",
                                      "aten::convolution", "aten::conv3d"]),
        dev("wgrad", 300, 100, ["aten::convolution_backward"]),
        dev("nchwToNhwc", 400, 50, ["aten::convolution_backward"]),
        dev("elementwise", 450, 70, ["aten::add"]),
        dev("orphan", 520, 10)]}
    assert reader("conv_device_ms_per_step.train").read(record(trace=tr)) == pytest.approx(0.225)
    tr["device"] = tr["device"][3:]
    assert reader("conv_device_ms_per_step.train").read(record(trace=tr)) is None


def test_host_issue_per_step():
    rec = record()
    rec["spans"]["chunk_issue"] = [[0.08, 8], [0.10, 8]]
    assert reader("host_issue_ms_per_step.train").read(rec) == pytest.approx(11.25)
    assert reader("host_issue_ms_per_step.train").read(record()) is None


def test_loader_per_volume():
    rec = record()
    rec["spans"]["loader_next"] = [0.004, 0.006]
    assert reader("loader_ms_per_volume.eval").read(rec) == pytest.approx(5.0)
    assert reader("loader_ms_per_volume.eval").read(record()) is None


@pytest.mark.parametrize("name", ["mfu.train", "mfu.eval"])
def test_mfu(name):
    rec = record(window_s=2.0, counters={"volumes": 100, "flops_per_volume": 39.06e9,
                                         "peak": "bfloat16"})
    assert reader(name).read(rec) == pytest.approx(100 * 100 * 39.06e9 / 2.0 / 989e12)
    assert reader(name).read(record(window_s=2.0, counters={})) is None


def test_mfu_divides_by_the_peak_the_driver_names():
    rec = record(window_s=1.0, counters={"volumes": 10, "flops_per_volume": 1e9,
                                         "peak": "float32"})
    assert reader("mfu.stylize").read(rec) == pytest.approx(100 * 10e9 / 67e12)


def test_a_metric_without_a_file_of_its_own_is_read_by_its_base_name(tmp_path):
    (tmp_path / "metrics").mkdir()
    for name in ("mfu.py", "mfu.train.py"):
        (tmp_path / "metrics" / name).write_text("")
    assert harness.reader_path(tmp_path, "mfu.train").name == "mfu.train.py"
    assert harness.reader_path(tmp_path, "mfu.serve").name == "mfu.py"
    assert harness.reader_path(tmp_path, "mfu").name == "mfu.py"


@pytest.mark.parametrize("kind", ["train", "eval", "stylize"])
def test_plane_roofline(kind):
    shape = [64, 128, 128, 64]
    least = roofline.plane_least_seconds(shape)
    tr = {"window": [0, 1e6], "host": [], "device": [
        dev("void fused_plane_kernel<1>(Params)", 0, 1e6 * least * 4),
        dev("void fused_plane_kernel<1>(Params)", 0, 1e6 * least * 6),
        dev("other", 0, 5000)]}
    rec = record(trace=tr, counters={"plane_shape": shape})
    assert reader(f"plane_roofline.{kind}").read(rec) == pytest.approx(20.0)
    assert reader(f"plane_roofline.{kind}").read(record(trace=tr)) is None
    tr["device"] = tr["device"][2:]
    assert reader(f"plane_roofline.{kind}").read(rec) is None


def chrome_events():
    """A window on thread 1 with a conv (two kernels) and an add, and a
    backward op on thread 2, as the profiler exports them."""
    X = "X"
    return [
        {"ph": X, "cat": "user_annotation", "name": trace.WINDOW, "pid": 1, "tid": 1,
         "ts": 100, "dur": 1000},
        {"ph": X, "cat": "cpu_op", "name": "aten::conv3d", "pid": 1, "tid": 1, "ts": 110, "dur": 50},
        {"ph": X, "cat": "cpu_op", "name": "aten::convolution", "pid": 1, "tid": 1, "ts": 111,
         "dur": 48},
        {"ph": X, "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
         "ts": 120, "dur": 5, "args": {"correlation": 7}},
        {"ph": X, "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
         "ts": 130, "dur": 5, "args": {"correlation": 8}},
        {"ph": X, "cat": "cpu_op", "name": "aten::add", "pid": 1, "tid": 1, "ts": 200, "dur": 20},
        {"ph": X, "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
         "ts": 205, "dur": 5, "args": {"correlation": 9}},
        {"ph": X, "cat": "cpu_op", "name": "aten::convolution_backward", "pid": 1, "tid": 2,
         "ts": 300, "dur": 40},
        {"ph": X, "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 2,
         "ts": 310, "dur": 5, "args": {"correlation": 10}},
        {"ph": X, "cat": "kernel", "name": "conv_a", "pid": 0, "tid": 7, "ts": 400, "dur": 100,
         "args": {"correlation": 7}},
        {"ph": X, "cat": "kernel", "name": "conv_b", "pid": 0, "tid": 7, "ts": 450, "dur": 100,
         "args": {"correlation": 8}},
        {"ph": X, "cat": "kernel", "name": "add", "pid": 0, "tid": 7, "ts": 600, "dur": 50,
         "args": {"correlation": 9}},
        {"ph": X, "cat": "kernel", "name": "wgrad", "pid": 0, "tid": 7, "ts": 700, "dur": 100,
         "args": {"correlation": 10}},
        {"ph": X, "cat": "kernel", "name": "outside", "pid": 0, "tid": 7, "ts": 5000, "dur": 10,
         "args": {"correlation": 11}},
    ]


def test_trace_normalise_attributes_kernels_to_their_operators():
    tr = trace.normalise(chrome_events())
    assert tr["window"] == [100.0, 1100.0]
    by = {e["name"]: e["ops"] for e in tr["device"]}
    assert set(by) == {"conv_a", "conv_b", "add", "wgrad"}
    assert by["conv_a"] == ["aten::convolution", "aten::conv3d", trace.WINDOW]
    assert by["add"] == ["aten::add", trace.WINDOW]
    assert by["wgrad"] == ["aten::convolution_backward"]
    # busy 400-550, 600-650, 700-800: 300 of 1000 us
    assert trace.busy_seconds(tr) == pytest.approx(300e-6)
    assert trace.window_seconds(tr) == pytest.approx(1000e-6)
    tr["steps"] = 1
    assert reader("conv_device_ms_per_step.train").read(record(trace=tr)) == pytest.approx(0.3)


def test_breakdown_names_ops_and_gaps():
    tr = trace.normalise(chrome_events())
    b = trace.breakdown(tr)
    assert b["device_ops"][0][0] in ("conv_a", "conv_b", "wgrad")
    assert sum(v for _, v in b["device_ops"]) == pytest.approx(350e-6)
    assert sum(v for _, v in b["idle_gaps"]) == pytest.approx(700e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
