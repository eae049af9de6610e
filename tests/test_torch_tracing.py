"""The port's spans and counters (mvtb_tpu_torch/utils/profiling.py): the
shared no-op without a profiler; the span tree of the train, eval and
stylize paths under a CPU profile, read back through the benchmark's trace
reader (portbench/trace.py); results unchanged with the profiler on; the
sliding window's tile counters; byte counters that count only moves between
host and card; and an export under a profiler that holds no profiler op.

The byte counters' exact reading on the card:
    python -m pytest -q tests/test_torch_tracing.py -m cuda
"""

import copy
import io
import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from mvtb_tpu_torch.data.pipeline import StylizedLoader
from mvtb_tpu_torch.eval import sliding_window as sw
from mvtb_tpu_torch.eval.harness import ModelEvaluation
from mvtb_tpu_torch.models import UNet
from mvtb_tpu_torch.ops.fused import StylizeConfig, sample_draws, stylize_batch
from mvtb_tpu_torch.serve import export_fn
from mvtb_tpu_torch.train.chunked import make_chunk_fn
from mvtb_tpu_torch.train.seg import create_seg_state
from mvtb_tpu_torch.utils import profiling
from portbench import spans
from portbench import trace as ptrace

CPU = torch.device("cpu")
STY = StylizeConfig(disk_r=3.0, disk_prob=1.0, fft_backend="plane")
C, SPATIAL, ROI = 4, (20, 14, 10), (8, 8, 8)


def traced(work, tmp_path):
    """``work()`` under a CPU profile: (its result, the normalised trace)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(ptrace.WINDOW):
            out = work()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return out, ptrace.normalise(json.loads(path.read_text())["traceEvents"])


def tree(tr) -> set:
    """{(span, its innermost enclosing span or None)} of the ``mvtb.``
    spans of a normalised trace."""
    sp = sorted((e for e in tr["host"] if e["name"].startswith("mvtb.")),
                key=lambda e: (e["ts"], -e["dur"]))
    edges = set()
    for i, e in enumerate(sp):
        parent = None  # sorted by start, the last enclosing span is innermost
        for p in sp[:i]:
            if p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"]:
                parent = p["name"]
        edges.add((e["name"], parent))
    return edges


def _model():
    torch.manual_seed(0)
    return UNet(C, 3, (4, 8), (2,), 1, device="cpu")


def _volumes(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"image": rng.randn(1, C, *SPATIAL).astype(np.float32),
             "label": (rng.rand(1, 3, *SPATIAL) < 0.4).astype(np.float32)} for _ in range(n)]


def _train(model):
    rng = np.random.RandomState(1)
    pool_i = torch.from_numpy(rng.randn(4, C, 16, 16, 8).astype(np.float32))
    pool_l = torch.from_numpy((rng.rand(4, 3, 16, 16, 8) < 0.4).astype(np.float32))
    state = create_seg_state(copy.deepcopy(model), device="cpu")
    _, _, loss = make_chunk_fn(STY, device="cpu")(
        state, torch.Generator().manual_seed(3), pool_i, pool_l, torch.tensor([[0, 1], [2, 3]]))
    return [loss] + [p.detach().clone() for p in state.model.parameters()]


def _eval(model):
    ev = ModelEvaluation(model.eval(), out_channels=3, roi_size=ROI, device="cpu")
    return [torch.tensor(ev.dataset_eval_multi(StylizedLoader(_volumes(2), STY, seed=0,
                                                              device="cpu")))]


def _stylize(model):
    x = torch.from_numpy(_volumes(1)[0]["image"]).repeat(2, 1, 1, 1, 1)
    return [stylize_batch(x, STY, generator=torch.Generator().manual_seed(4), device="cpu")]


PATHS = {
    "train": (_train, {("mvtb.chunk", None), ("mvtb.step", "mvtb.chunk"),
                       ("mvtb.step.stylize", "mvtb.step"),
                       ("mvtb.stylize_batch", "mvtb.step.stylize"),
                       ("mvtb.stylize.h_dft", "mvtb.stylize_batch"),
                       ("mvtb.step.optimizer", "mvtb.step")},
              {"mvtb.chunk": 1, "mvtb.step": 2, "mvtb.stylize.h_dft": 4}),
    "eval": (_eval, {("mvtb.eval.volume", None), ("mvtb.stylize_batch", "mvtb.eval.volume"),
                     ("mvtb.stylize.h_dft", "mvtb.stylize_batch"),
                     ("mvtb.loader.to_host", "mvtb.eval.volume"),
                     ("mvtb.eval.to_device", "mvtb.eval.volume"),
                     ("mvtb.sw", "mvtb.eval.volume"), ("mvtb.sw.grid", "mvtb.sw"),
                     ("mvtb.sw.forward", "mvtb.sw"), ("mvtb.sw.blend", "mvtb.sw"),
                     ("mvtb.eval.dice", "mvtb.eval.volume")},
             # the loop's last next() finds the loader empty in a volume span of its own
             {"mvtb.eval.volume": 3, "mvtb.eval.dice": 2, "mvtb.sw": 2}),
    "stylize": (_stylize, {("mvtb.stylize_batch", None),
                           ("mvtb.stylize.h_dft", "mvtb.stylize_batch")},
                {"mvtb.stylize_batch": 1, "mvtb.stylize.h_dft": 2}),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_span_tree_under_a_profiler_and_results_unchanged(path, tmp_path):
    work, edges, counts = PATHS[path]
    model = _model()
    plain = work(copy.deepcopy(model))
    got, tr = traced(lambda: work(copy.deepcopy(model)), tmp_path)
    assert tree(tr) == edges
    for name, n in counts.items():
        assert spans.count(tr, name) == n, name
    if path == "eval":
        assert spans.volumes(tr) == 2
    assert len(got) == len(plain)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


def test_span_is_one_shared_no_op_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError("record_function called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("mvtb.a"), profiling.span("mvtb.b")
    assert a is b
    with a:
        pass


def test_sliding_window_counts_needed_tiles_and_forwarded_slots():
    """The eval cell's grid: 240x240x155 at roi 128x128x64, overlap 0.25,
    tile batch 8 is 3 x 3 x 3 = 27 tiles in 4 forwards of 8."""
    assert [len(sw._grid_positions(n, r, 0.25)) for n, r in zip((240, 240, 155),
                                                                  (128, 128, 64))] == [3, 3, 3]
    assert sw._chunking(27, 8) == (8, 4)
    before = profiling.counters.copy()
    out = sw.sliding_window_inference(torch.ones(1, 1, 240, 240, 155), (128, 128, 64),
                                      lambda t: t, overlap=0.25, tile_batch=8, device="cpu")
    got = profiling.counters - before
    assert got["sw.tiles"] == 27 and got["sw.tile_slots"] == 32
    assert got["copy.h2d_bytes"] == got["copy.d2h_bytes"] == 0  # on the CPU nothing crosses
    assert torch.equal(out, torch.ones(1, 1, 240, 240, 155))


def test_moves_within_the_host_count_no_bytes():
    t = torch.ones(3, 5)
    before = profiling.counters.copy()
    assert profiling.to_device(t, "cpu") is t
    assert profiling.to_host(t) is t
    assert profiling.to_device(t, "meta").device.type == "meta"  # not the card
    assert profiling.counters == before


def test_study_launch_record_reads_the_launch_counters(monkeypatch):
    """The study scripts' launch record (``examples/_common.kernel_launches``)
    keeps its keys and reads the ``launch.*`` counters that the custom ops'
    CUDA implementations add to; two readings apart give the launches
    between them, the route-and-tier counters aside."""
    from mvtb_tpu_torch.examples._common import kernel_launches

    monkeypatch.setattr(profiling, "counters", Counter({"launch.fused_plane": 3}))
    before = kernel_launches()
    assert before == {"fused_plane": 3, "axis_dft_r2c": 0, "axis_dft_c2c": 0,
                      "axis_dft_c2r": 0, "sap": 0, "polar": 0}
    for name in ("launch.fused_plane", "launch.axis_dft.c2c", "launch.axis_dft.c2c.wgmma.high",
                 "launch.axis_dft.c2c", "launch.axis_dft.c2c.wgmma.high", "launch.polar"):
        profiling.count(name)
    after = kernel_launches()
    assert {k: after[k] - before[k] for k in after} == {
        "fused_plane": 1, "axis_dft_r2c": 0, "axis_dft_c2c": 2, "axis_dft_c2r": 0,
        "sap": 0, "polar": 1}


def test_export_under_a_profiler_holds_no_profiler_op():
    draws = sample_draws(STY, SPATIAL, 2, C, generator=torch.Generator().manual_seed(0),
                         device=CPU)
    x = torch.randn(2, C, *SPATIAL)

    def styl(img, d):
        return stylize_batch(img, STY, d, device=img.device)

    with profile(activities=[ProfilerActivity.CPU]):
        blob = export_fn(styl, (x, draws))
    ep = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]


@pytest.fixture
def cuda_device():
    """The card, or a skip: host-card copies need one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the counters count moves between host and card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_byte_counters_read_the_bytes_a_volume_moves(cuda_device):
    """A clean volume moves its image and label to the card (the sliding
    window builds its importance map and normalizer there and moves
    nothing); a stylized one also moves the image to the card and back for
    the stylize."""
    torch.manual_seed(0)
    model = UNet(C, 3, (4, 8), (2,), 1, device=cuda_device).eval()
    ev = ModelEvaluation(model, out_channels=3, roi_size=ROI, device=cuda_device)
    batch = _volumes(1)
    image, label = batch[0]["image"].nbytes, batch[0]["label"].nbytes
    sty = StylizeConfig(disk_r=3.0, disk_prob=1.0, fft_backend="plane_fast")
    for loader, h2d, d2h in ((batch, image + label, 0),
                             (StylizedLoader(batch, sty, seed=0, device=cuda_device),
                              2 * image + label, image)):
        before = profiling.counters.copy()
        ev.dataset_eval_multi(loader)
        got = profiling.counters - before
        assert (got["copy.h2d_bytes"], got["copy.d2h_bytes"], got["eval.volumes"]) == (h2d, d2h, 1)
