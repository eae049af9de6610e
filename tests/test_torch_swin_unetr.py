"""SwinUNETR in the port (mvtb_tpu_torch/models/swin_unetr.py): held to the
benchmark's plain reference (portbench/reference/swin_unetr.py) on seeded
random weights, logits and the gradient of every leaf under the Dice loss,
at sizes where stages pad, shift and shrink their windows; the shift mask
and the relative-bias index against a construction by brute force; the
bf16 convention; its spans and counters; and the normal paths it runs
through (``build_seg_model``, ``run --arch swin_unetr``, the chunk,
``ModelEvaluation``), with the CLI's ``domain`` refusing ``run``'s options.

The JAX package has no such model, so the reference is the plain one. On
the card (efficient attention backend, bf16):
    python -m pytest -q tests/test_torch_swin_unetr.py -m cuda
"""

import dataclasses
import itertools
import json
import statistics

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from mvtb_tpu_torch.eval.harness import ModelEvaluation
from mvtb_tpu_torch.experiments import __main__ as tmain
from mvtb_tpu_torch.experiments import registry as treg
from mvtb_tpu_torch.experiments import runner as trunner
from mvtb_tpu_torch import models as tmodels
from mvtb_tpu_torch.models import SEG_ARCHS, SwinUNETR, UNet, build_seg_model
from mvtb_tpu_torch.models import swin_unetr as sw
from mvtb_tpu_torch.ops.fused import StylizeConfig
from mvtb_tpu_torch.train.chunked import make_chunk_fn
from mvtb_tpu_torch.train.losses import dice_loss
from mvtb_tpu_torch.train.seg import create_seg_state
from mvtb_tpu_torch.utils import profiling
from portbench import spans, swin_work
from portbench import trace as ptrace
from portbench.reference import swin_unetr as ref
from portbench.reference.dice import dice_loss_terms

SMALL = dict(feature_size=12, depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24), window_size=7)
# (2, 4, 32^3): stage grids 16^3 (padded to 21, shifted), 8^3 (14, shifted),
# 4^3 and 2^3 (the window shrinks to the grid, no shift); (1, 4, 32, 32, 64):
# stage 3's window is (4, 4, 7) with a shift on its long axis alone
SHAPES = [(2, 4, 32, 32, 32), (1, 4, 32, 32, 64)]


def weights(seed=0, widths=SMALL):
    """Seeded random weights for both models: every leaf drawn, LayerNorm
    scales around 1."""
    shapes = ref.param_shapes(dict(in_channels=4, out_channels=3, **widths))
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, s in shapes.items():
        w = 0.1 * torch.randn(s, generator=g)
        if k.endswith(("norm.weight", "norm1.weight", "norm2.weight")):
            w += 1.0
        out[k] = w
    return out


def pair(dtype):
    sd = weights()
    port = SwinUNETR(4, 3, device="cpu", dtype=dtype, **SMALL)
    port.load_state_dict(sd)
    plain = ref.SwinUNETR(4, 3, **SMALL)
    plain.load_state_dict(sd)
    if dtype == torch.float64:
        port, plain = port.double(), plain.double()
    return port, plain


def grads(model, x, label):
    model.zero_grad(set_to_none=True)
    logits = model(x)
    dice_loss_terms(logits, label).mean().backward()
    return logits.detach(), {k: p.grad for k, p in model.named_parameters()}


def inputs(shape, dtype=torch.float32):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=g).to(dtype)
    label = (torch.rand((shape[0], 3) + shape[2:], generator=g) < 0.4).to(dtype)
    return x, label


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


@pytest.mark.parametrize("shape", SHAPES)
def test_port_matches_the_reference_in_float64(shape):
    """Every leaf's gradient within 1e-9 of the largest: the same
    mathematics in float64, where no LeakyReLU input lies within rounding
    of its kink (float32 below)."""
    port, plain = pair(torch.float64)
    x, label = inputs(shape, torch.float64)
    lp, gp = grads(port, x, label)
    lr, gr = grads(plain, x, label)
    assert rel(lp, lr) < 1e-12
    assert set(gp) == set(gr) and len(gr) == 151
    for k in gr:
        assert float((gp[k] - gr[k]).abs().max()) <= 1e-9 * max(float(gr[k].abs().max()), 1e-12), k


def test_port_matches_the_reference_in_float32():
    """Logits within 1e-5 of their largest (float32 rounding through 12
    blocks; windows summed in another order). Gradients: the median leaf's
    gap to the float64 reference at most 3x the float32 reference's own
    (1.1-1.7x seen). At these sizes float32 itself moves the reference's
    median leaf 1e-4 to 3e-3 from float64: instance norms over 8 to 64
    voxels, and a LeakyReLU input within rounding of 0 takes the other
    slope in one of the two programs and moves one output channel's row
    of a weight's gradient (10% of a 4^3 block's largest, seen), so single
    leaves, and the second shape, are held in float64 above."""
    port, plain = pair(torch.float32)
    _, exact = pair(torch.float64)
    x, label = inputs(SHAPES[0])
    lp, gp = grads(port, x, label)
    lr, gr = grads(plain, x, label)
    _, g64 = grads(exact, x.double(), label.double())
    assert rel(lp, lr) < 1e-5
    moving = [k for k in g64 if float(g64[k].abs().max()) > 0]
    port_gap = statistics.median(rel(gp[k].double(), g64[k]) for k in moving)
    ref_gap = statistics.median(rel(gr[k].double(), g64[k]) for k in moving)
    assert port_gap <= 3 * ref_gap


def brute_index(ws, window):
    toks = list(itertools.product(*[range(n) for n in ws]))
    out = torch.zeros(len(toks), len(toks), dtype=torch.long)
    for i, a in enumerate(toks):
        for j, b in enumerate(toks):
            d = [a[t] - b[t] + window - 1 for t in range(3)]
            out[i, j] = (d[0] * (2 * window - 1) + d[1]) * (2 * window - 1) + d[2]
    return out


def brute_mask(padded, ws, shift):
    """(windows, N, N): -100 between tokens of different regions of the
    rolled grid, a region per axis being [0, L-w), [L-w, L-s), [L-s, L)."""
    def region(x, L, w, s):
        return 0 if not s else (0 if x < L - w else 1 if x < L - s else 2)

    grid = [range(p // w) for p, w in zip(padded, ws)]
    masks = []
    for cell in itertools.product(*grid):
        toks = [tuple(c * w + o for c, w, o in zip(cell, ws, off))
                for off in itertools.product(*[range(w) for w in ws])]
        rid = [tuple(region(t[a], padded[a], ws[a], shift[a]) for a in range(3)) for t in toks]
        masks.append([[0.0 if ri == rj else -100.0 for rj in rid] for ri in rid])
    return torch.tensor(masks)


@pytest.mark.parametrize("grid", [(16, 8, 4), (8, 8, 8), (4, 4, 8), (2, 2, 4), (9, 12, 7)])
def test_shift_mask_and_bias_index_by_brute_force(grid):
    geo = sw.Geometry(grid, 7, True, "cpu", torch.float32)
    n = geo.n
    index = geo.index.view(n, -1)[:, :n]
    assert torch.equal(index, brute_index(geo.ws, 7))
    assert torch.equal(index, ref.relative_position_index(geo.ws, 7, "cpu"))
    if geo.mask is None:
        assert not any(geo.shift) and all(g <= 7 for g in grid)
        return
    want = brute_mask(geo.padded, geo.ws, geo.shift)
    assert torch.equal(geo.mask[..., :n], want)
    assert torch.equal(ref.compute_mask(geo.padded, geo.ws, geo.shift, "cpu"), want)
    # the columns past N pad each row to the backend's alignment
    assert geo.mask.shape[-1] % sw.BIAS_ALIGN == 0 and geo.index.numel() % sw.BIAS_ALIGN == 0


def test_published_widths_and_window_plan():
    with torch.device("meta"):
        m = build_seg_model("swin_unetr", device="meta")
    sd = m.state_dict()
    assert len(sd) == 151 and sum(v.numel() for v in sd.values()) == 62191941
    assert set(sd) == set(ref.param_shapes(dict(in_channels=4, out_channels=3, feature_size=48,
                                                depths=[2, 2, 2, 2], num_heads=[3, 6, 12, 24],
                                                window_size=7)))
    plans = [sw.window_plan((g,) * 3, 7) for g in (64, 32, 16, 8)]
    assert all(p == ((7, 7, 7), (3, 3, 3)) for p in plans)
    assert sw.window_plan((4, 4, 8), 7) == ((4, 4, 7), (0, 0, 3))


def test_bf16_activations_float32_parameters():
    port = SwinUNETR(4, 3, device="cpu", dtype=torch.bfloat16, **SMALL)
    seen = {}

    def hook(mod, args, out):
        seen.setdefault(type(mod).__name__, set()).add(out.dtype)

    for mod in port.modules():
        if isinstance(mod, (sw.Linear, sw.LayerNorm, sw.Conv, sw.ResBlock)):
            mod.register_forward_hook(hook)
    x, label = inputs((1,) + SHAPES[0][1:])
    out = port(x)
    assert out.dtype == torch.bfloat16
    assert seen and all(d == {torch.bfloat16} for d in seen.values()), seen
    assert all(p.dtype == torch.float32 for p in port.parameters())
    dice_loss(out, label).backward()
    assert all(p.grad.dtype == torch.float32 for p in port.parameters())


def test_counters_and_spans(tmp_path):
    port = SwinUNETR(4, 3, device="cpu", **SMALL)
    x, _ = inputs(SHAPES[1])
    before = dict(profiling.counters)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(ptrace.WINDOW):
            port(x)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    tr = ptrace.normalise(json.loads(path.read_text())["traceEvents"])
    got = {k: profiling.counters[k] - before.get(k, 0) for k in
           ("swin.tokens", "swin.window_tokens", "swin.windows")}
    model = dict(in_channels=4, out_channels=3, **SMALL)
    bs = swin_work.blocks(model, SHAPES[1][2:])
    assert got == {"swin.tokens": sum(b["real"] for b in bs),
                   "swin.window_tokens": sum(b["padded"] for b in bs),
                   "swin.windows": sum(b["windows"] for b in bs)}
    assert 100.0 * got["swin.tokens"] / got["swin.window_tokens"] == pytest.approx(
        swin_work.window_fill(model, SHAPES[1][2:]))
    assert spans.count(tr, "mvtb.swin.encoder") == 1
    assert spans.count(tr, "mvtb.swin.attn") == 8
    assert spans.count(tr, "mvtb.unetr.conv") == 11
    enc = spans.named(tr, "mvtb.swin.encoder")[0]
    for name in ("mvtb.swin.attn", "mvtb.swin.window"):
        for e in spans.named(tr, name):
            assert enc["ts"] <= e["ts"] and e["ts"] + e["dur"] <= enc["ts"] + enc["dur"]
    # the geometry is built once a grid and kind of block: a second pass misses no cache
    n_window = spans.count(tr, "mvtb.swin.window")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(ptrace.WINDOW):
            port(x)
    prof.export_chrome_trace(str(path))
    tr2 = ptrace.normalise(json.loads(path.read_text())["traceEvents"])
    assert spans.count(tr2, "mvtb.swin.window") == 16 < n_window


def test_build_seg_model_names_its_models():
    assert set(SEG_ARCHS) == {"unet", "swin_unetr", "segmamba"}
    assert isinstance(build_seg_model("unet", device="cpu", channels=(4, 8), strides=(2,),
                                      num_res_units=1), UNet)
    with pytest.raises(ValueError, match="unknown segmentation model"):
        build_seg_model("vit", device="cpu")
    with pytest.raises(ValueError, match="divisible by 32"):
        SwinUNETR(device="cpu", **SMALL)(torch.zeros(1, 4, 32, 32, 40))


def test_chunk_trains_it():
    torch.manual_seed(0)
    model = build_seg_model("swin_unetr", device="cpu", **SMALL)
    state = create_seg_state(model, device="cpu")
    before = [p.detach().clone() for p in model.parameters()]
    x, label = inputs((2, 4, 32, 32, 32))
    sty = StylizeConfig(disk_r=4.0, disk_prob=1.0)
    state, _, loss = make_chunk_fn(sty, device="cpu")(
        state, torch.Generator().manual_seed(3), x, label, torch.tensor([[0], [1]]))
    assert state.step == 2 and np.isfinite(float(loss))
    assert all(not torch.equal(a, p) for a, p in zip(before, model.parameters()))


@pytest.fixture
def tiny_gibbs(monkeypatch):
    cfg = dataclasses.replace(treg.get("gibbs12p5"), data_kind="smooth", val_interval=1,
                              model_dtype="float32",
                              train_stylize=StylizeConfig(disk_r=4.0, disk_prob=1.0),
                              val_stylize=StylizeConfig(disk_r=4.0, disk_prob=1.0))
    monkeypatch.setitem(treg.REGISTRY, "gibbs12p5", cfg)
    monkeypatch.setitem(tmodels.SEG_ARCHS, "swin_unetr",
                        tmodels.SEG_ARCHS["swin_unetr"]._replace(crop=(32, 32, 32)))
    real = trunner.build_seg_model
    built = []

    def small(arch, *a, **kw):  # the published depth and heads, a narrower feature
        kw = dict(kw, feature_size=12) if arch == "swin_unetr" else kw
        built.append(arch)
        return real(arch, *a, **kw)

    monkeypatch.setattr(trunner, "build_seg_model", small)
    return built


def test_cli_run_arch_swin_unetr_chunked(tiny_gibbs, capsys, tmp_path, monkeypatch):
    # gibbs12p5 trains 2 a step
    monkeypatch.setitem(tmodels.SEG_ARCHS, "swin_unetr",
                        tmodels.SEG_ARCHS["swin_unetr"]._replace(max_batch=1))
    seen = []
    real = trunner.make_chunk_fn

    def chunk_fn(*a, **kw):
        fn = real(*a, **kw)
        return lambda state, gen, pi, pl, idxs: (seen.append(tuple(idxs.shape)),
                                                 fn(state, gen, pi, pl, idxs))[1]

    monkeypatch.setattr(trunner, "make_chunk_fn", chunk_fn)
    w = tmp_path / "w"
    argv = ["run", "gibbs12p5", "--arch", "swin_unetr", "--chunked", "--pool", "2",
            "--device", "cpu", "--epochs", "1", "--steps", "1", "--val-batches", "1",
            "--quiet", "--workdir", str(w)]
    assert tmain.main(argv) == 0
    assert tiny_gibbs == ["swin_unetr"] and seen == [(1, 1)]  # 1 step of 1 crop
    summary = json.loads(capsys.readouterr().out)
    assert set(summary) == {"best_dice", "wall_time_s"}
    hist = json.loads((w / "gibbs12p5_swin_unetr_result.json").read_text())["history"]
    assert len(hist["loss"]) == 1 and np.isfinite(hist["loss"][0])


def test_run_arch_refuses_other_kinds_and_names():
    with pytest.raises(ValueError, match="unknown segmentation model"):
        trunner.run("gibbs12p5", arch="vit", device="cpu")
    gan = next(n for n in treg.names() if treg.get(n).kind in trunner.GAN_KINDS)
    with pytest.raises(ValueError, match="segmentation configs only"):
        trunner.run(gan, arch="swin_unetr", device="cpu")


@pytest.mark.parametrize("flags", [["--arch", "swin_unetr"], ["--fast"], ["--chunked"],
                                   ["--resume"], ["--pool", "48"], ["--val-batches", "3"],
                                   ["--ckpt-every", "2"], ["--mitigated"]])
def test_domain_refuses_each_run_option(flags, monkeypatch, capsys):
    monkeypatch.setattr(trunner, "run_domain_experiment",
                        lambda *a, **k: pytest.fail("domain ran with a run option"))
    with pytest.raises(SystemExit) as e:
        tmain.main(["domain", "gibbs15_domain", "--device", "cpu"] + flags)
    assert e.value.code == 2
    assert f"{flags[0]} is only supported with the 'run' command" in capsys.readouterr().err


def test_sliding_window_evaluation_of_a_tiny_swin_unetr():
    torch.manual_seed(0)
    model = build_seg_model("swin_unetr", device="cpu", **SMALL).eval()
    rng = np.random.RandomState(0)
    vols = [{"image": rng.randn(1, 4, 40, 36, 32).astype(np.float32),
             "label": (rng.rand(1, 3, 40, 36, 32) < 0.4).astype(np.float32)} for _ in range(2)]
    ev = ModelEvaluation(model, out_channels=3, roi_size=(32, 32, 32), device="cpu")
    before = profiling.counters["sw.tiles"]
    dice = ev.dataset_eval_multi(vols)
    assert len(dice) == 4 and all(np.isfinite(d) or np.isnan(d) for d in dice)
    assert profiling.counters["sw.tiles"] - before == 2 * 4  # a 2 x 2 x 1 grid a volume


@pytest.mark.cuda
def test_on_the_card_through_the_efficient_backend():
    """On the card, where attention takes the memory-efficient backend
    with a broadcast bias and its gradient (feature 24: head dim 8, the
    backend's least): in float32 (TF32 off) the port meets the float32
    test's criteria against the reference in float32 and float64; in bf16
    its logits stay within 3% of the float32 reference's largest (1.4% on
    the CPU at these widths: bf16 rounding through 12 blocks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench.reference.precision import full_float32

    widths = dict(SMALL, feature_size=24)
    sd = weights(widths=widths)
    x, label = (t.cuda() for t in inputs(SHAPES[0]))
    plain = ref.SwinUNETR(4, 3, **widths).cuda()
    plain.load_state_dict(sd)
    exact = ref.SwinUNETR(4, 3, **widths).cuda().double()
    exact.load_state_dict(sd)
    with full_float32():
        port = SwinUNETR(4, 3, device="cuda", **widths)
        port.load_state_dict(sd)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            lp, gp = grads(port, x, label)
        lr, gr = grads(plain, x, label)
        _, g64 = grads(exact, x.double(), label.double())
    assert any("efficient_attention" in e.key for e in prof.key_averages())
    assert rel(lp, lr) < 1e-5
    moving = [k for k in g64 if float(g64[k].abs().max()) > 0]
    port_gap = statistics.median(rel(gp[k].double(), g64[k]) for k in moving)
    ref_gap = statistics.median(rel(gr[k].double(), g64[k]) for k in moving)
    assert port_gap <= 3 * ref_gap
    low = SwinUNETR(4, 3, device="cuda", dtype=torch.bfloat16, **widths)
    low.load_state_dict(sd)
    with torch.no_grad():
        assert rel(low(x).float(), lr) < 3e-2
