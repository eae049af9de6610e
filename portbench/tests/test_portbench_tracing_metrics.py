"""The readers of the port's own spans and counters (``portbench/spans.py``
and the metrics that use it) on hand-made normalised traces and counter
snapshots: each gives its known answer, and None where the program has no
such span or counter."""

from collections import Counter, defaultdict
from pathlib import Path

import pytest

from portbench import harness, spans

FOLDER = Path(__file__).resolve().parents[1]


def reader(name):
    return harness.load_file(harness.reader_path(FOLDER, name), "m_" + name.replace(".", "_"))


def record(trace=None):
    return {"workload": {}, "config": {}, "window_s": None, "counters": {},
            "spans": defaultdict(list), "trace": trace}


def host(name, ts, dur):
    return {"name": name, "ts": float(ts), "dur": float(dur)}


def dev(name, ts, dur, ops=(), cat="kernel"):
    return {"name": name, "cat": cat, "ts": float(ts), "dur": float(dur), "ops": list(ops)}


def eval_trace():
    """Two volumes and the loop's last, empty next(); times in us."""
    h = []
    for t0 in (0, 1000):
        h += [host("mvtb.eval.volume", t0, 900), host("mvtb.stylize_batch", t0 + 10, 90),
              host("mvtb.loader.to_host", t0 + 100, 200),
              host("mvtb.eval.to_device", t0 + 300, 100), host("mvtb.sw", t0 + 400, 400),
              host("mvtb.sw.grid", t0 + 400, 50), host("mvtb.sw.forward", t0 + 450, 300),
              host("mvtb.sw.blend", t0 + 750, 50), host("mvtb.eval.dice", t0 + 800, 100),
              host("aten::copy_", t0 + 100, 200)]
    h.append(host("mvtb.eval.volume", 1950, 5))
    return {"window": [0.0, 2000.0], "host": h, "device": [dev("k", 450, 300)]}


def test_eval_span_readers():
    tr = eval_trace()
    assert spans.volumes(tr) == 2 and spans.count(tr, "mvtb.eval.volume") == 3
    # (200 + 100) us of copies a volume, 50 us of grid
    assert reader("round_trip_ms_per_volume.eval").read(record(tr)) == pytest.approx(0.3)
    assert reader("sw_grid_ms_per_volume.eval").read(record(tr)) == pytest.approx(0.05)


def test_idle_split_by_innermost_span():
    tr = eval_trace()
    idle = spans.idle_by_span(tr)
    # the device runs 450-750 us; the rest of the 2 ms window idles
    assert sum(idle.values()) == pytest.approx(1.7e-3)
    assert idle["mvtb.loader.to_host"] == pytest.approx(400e-6)
    assert idle["mvtb.sw.grid"] == pytest.approx(100e-6)
    assert idle["mvtb.sw.forward"] == pytest.approx(300e-6)  # the second volume's forward
    assert idle["mvtb.stylize_batch"] == pytest.approx(180e-6)
    assert idle["mvtb.eval.volume"] == pytest.approx(2 * 10e-6 + 5e-6)
    assert idle[None] == pytest.approx(100e-6 + 50e-6 + 45e-6)  # between the volumes
    assert [s[2] for s in spans.segments(tr)[:3]] == [
        "mvtb.eval.volume", "mvtb.stylize_batch", "mvtb.loader.to_host"]


def test_optimizer_launches_per_step():
    h = [host("mvtb.chunk", 0, 1000)]
    d = []
    for s in range(2):
        t0 = 10 + 400 * s
        h += [host("mvtb.step", t0, 390), host("mvtb.step.optimizer", t0 + 300, 80)]
        d += [dev("conv", t0 + 100, 50, ["aten::convolution", "mvtb.step", "mvtb.chunk"])]
        d += [dev("mul", t0 + 310 + i, 1, ["aten::mul", "mvtb.step.optimizer", "mvtb.step"])
              for i in range(17)]
        d.append(dev("memset", t0 + 350, 1, ["mvtb.step.optimizer"], cat="gpu_memset"))
    tr = {"window": [0.0, 1000.0], "host": h, "device": d}
    assert reader("optimizer_launches_per_step.train").read(record(tr)) == pytest.approx(17.0)


def test_h_dft_device_ms_per_batch():
    h, d = [], []
    for b in range(4):
        t0 = 1000 * b
        h += [host("mvtb.stylize_batch", t0, 900), host("mvtb.stylize.h_dft", t0, 100),
              host("mvtb.stylize.h_dft", t0 + 500, 100)]
        d += [dev("sgemm", t0 + 50, 400, ["aten::mm", "mvtb.stylize.h_dft"]),
              dev("sgemm", t0 + 550, 350, ["aten::mm", "mvtb.stylize.h_dft"]),
              dev("fused_plane_kernel", t0 + 460, 80, ["mvtb::fused_plane"])]
    tr = {"window": [0.0, 4000.0], "host": h, "device": d}
    assert reader("h_dft_device_ms_per_batch.stylize").read(record(tr)) == pytest.approx(0.75)


@pytest.mark.parametrize("name", ["round_trip_ms_per_volume.eval", "sw_grid_ms_per_volume.eval",
                                  "optimizer_launches_per_step.train",
                                  "h_dft_device_ms_per_batch.stylize"])
def test_span_readers_read_nothing_without_spans(name):
    bare = {"window": [0.0, 100.0], "host": [host("aten::mm", 0, 50)],
            "device": [dev("sgemm", 0, 50, ["aten::mm"])]}
    assert reader(name).read(record(bare)) is None
    assert reader(name).read(record()) is None


def test_counter_readers(monkeypatch):
    from mvtb_tpu_torch.utils import profiling

    # five stylized volumes and a clean one of the eval cell
    img, lbl, grid = 142_848_000, 107_136_000, 39_906_304
    c = Counter({"copy.h2d_bytes": 6 * (img + lbl + grid) + 5 * img, "copy.d2h_bytes": 5 * img,
                 "eval.volumes": 6, "sw.tiles": 6 * 27, "sw.tile_slots": 6 * 32})
    monkeypatch.setattr(profiling, "counters", c)
    mb = reader("host_device_mb_per_volume.eval").read(record())
    assert mb == pytest.approx(1e-6 * (img + lbl + grid + 10 * img / 6))
    assert 526 < mb < 530
    assert reader("sw_tile_fill.eval").read(record()) == pytest.approx(84.375)
    monkeypatch.setattr(profiling, "counters", Counter())
    for name in ("host_device_mb_per_volume.eval", "sw_tile_fill.eval"):
        assert reader(name).read(record()) is None
    monkeypatch.delattr(profiling, "counters")  # a port without counters
    assert spans.program_counters() == {}
    for name in ("host_device_mb_per_volume.eval", "sw_tile_fill.eval"):
        assert reader(name).read(record()) is None
