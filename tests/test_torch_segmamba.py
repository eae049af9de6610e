"""SegMamba in the port (mvtb_tpu_torch/models/segmamba.py) and its selective
scan (mvtb_tpu_torch/ops/selective_scan.py), on the CPU: the model held to
the benchmark's plain reference (portbench/reference/segmamba.py) on seeded
random weights, logits, loss and the gradient of every leaf under the Dice
loss; the three orders and their inverses against index arithmetic; the
scan's plain version against a sequential float64 loop and its autograd,
states carried across chunk boundaries; the scan's custom ops under the
kernel rules (the CUDA key reaches the kernel or raises, nothing falls
back); the published widths and initialisation; the bf16 convention; the
spans and counters; and the normal paths (``build_seg_model``, ``run
--arch segmamba`` for one chunk, ``ModelEvaluation``'s sliding window).

The JAX package has no such model, so the reference is the plain one. The
kernel itself is held to the plain scan on the card:
    python -m pytest -q --noconftest tests/test_torch_selective_scan_cuda.py
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile, record_function

from mvtb_tpu_torch import models as tmodels
from mvtb_tpu_torch.eval.harness import ModelEvaluation
from mvtb_tpu_torch.experiments import __main__ as tmain
from mvtb_tpu_torch.experiments import registry as treg
from mvtb_tpu_torch.experiments import runner as trunner
from mvtb_tpu_torch.models import SegMamba, build_seg_model
from mvtb_tpu_torch.models import segmamba as sm
from mvtb_tpu_torch.ops import _build, selective_scan as ss
from mvtb_tpu_torch.ops.fused import StylizeConfig
from mvtb_tpu_torch.train.chunked import make_chunk_fn
from mvtb_tpu_torch.train.losses import dice_loss
from mvtb_tpu_torch.train.seg import create_seg_state
from mvtb_tpu_torch.utils import profiling
from portbench import scan_work, spans
from portbench import trace as ptrace
from portbench.reference import segmamba as ref
from portbench.reference.dice import dice_loss_terms

# the published depths, d_state, d_conv and expand at narrower widths; a
# 16^3 crop's stage grids are 8^3, 4^3, 2^3 and 1^3, whose first axes are
# the slice counts
SMALL = dict(feature_size=(8, 16, 32, 64), hidden_size=32, num_slices=(8, 4, 2, 1))
SHAPE = (2, 4, 16, 16, 16)
ROOT = Path(__file__).resolve().parent.parent
PUBLISHED = dict(in_channels=4, out_channels=3)


def weights(seed=0, widths=SMALL):
    """Seeded random weights for both models: every leaf drawn around the
    published initialisation (LayerNorm scales around 1, ``A_log`` around
    ``log(1..16)``, ``D`` around 1)."""
    shapes = ref.param_shapes(dict(PUBLISHED, **widths))
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, s in shapes.items():
        w = 0.2 * torch.randn(s, generator=g)
        leaf = k.rsplit(".", 1)[-1]
        if k.endswith("norm.weight") or leaf in ("D", "D_b", "D_s"):
            w += 1.0
        if leaf in ("A_log", "A_b_log", "A_s_log"):
            w = 0.5 * w + torch.log(torch.arange(1, s[1] + 1, dtype=torch.float32))
        out[k] = w
    return out


def pair(dtype):
    sd = weights()
    port = SegMamba(4, 3, device="cpu", dtype=dtype, **SMALL)
    port.load_state_dict(sd)
    plain = ref.SegMamba(4, 3, **SMALL)
    plain.load_state_dict(sd)
    if dtype == torch.float64:
        port, plain = port.double(), plain.double()
    return port, plain


def inputs(shape=SHAPE, dtype=torch.float32):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=g).to(dtype)
    label = (torch.rand((shape[0], 3) + shape[2:], generator=g) < 0.4).to(dtype)
    return x, label


def grads(model, x, label):
    model.zero_grad(set_to_none=True)
    logits = model(x)
    loss = dice_loss_terms(logits, label).mean()
    loss.backward()
    return logits.detach(), float(loss.detach()), {k: p.grad for k, p in model.named_parameters()}


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


@pytest.fixture(scope="module")
def float64_pair():
    port, plain = pair(torch.float64)
    x, label = inputs(dtype=torch.float64)
    return grads(port, x, label), grads(plain, x, label)


def test_port_matches_the_reference_in_float64(float64_pair):
    """Logits and loss within float64 rounding; every leaf's gradient within
    1e-9 of its largest. The conv biases a GSC feeds to an instance norm
    have an exact gradient of 0: they are held to 1e-12 of the median
    leaf's largest gradient instead (rounding noise on either side)."""
    (lp, loss_p, gp), (lr, loss_r, gr) = float64_pair
    assert rel(lp, lr) < 1e-12
    assert abs(loss_p - loss_r) < 1e-12
    assert set(gp) == set(gr) and len(gr) == 291
    scale = float(np.median([float(g.abs().max()) for g in gr.values()]))
    for k in gr:
        top = float(gr[k].abs().max())
        bound = 1e-9 * top if top > 1e-9 * scale else 1e-12 * scale
        assert float((gp[k] - gr[k]).abs().max()) <= bound, k


def test_port_matches_the_reference_in_float32(float64_pair):
    """float32 on both sides against the float64 reference: the port's
    logits within 1e-4 of their largest, and its median leaf's gradient gap
    at most 3x the float32 reference's own (another order of float32 sums in
    the scan, the norms and the products)."""
    port, plain = pair(torch.float32)
    x, label = inputs()
    lp, _, gp = grads(port, x, label)
    _, _, gr = grads(plain, x, label)
    (_, _, _), (l64, _, g64) = float64_pair
    assert rel(lp.double(), l64) < 1e-4
    moving = [k for k in g64 if float(g64[k].abs().max()) > 1e-12]
    port_gap = np.median([rel(gp[k].double(), g64[k]) for k in moving])
    ref_gap = np.median([rel(gr[k].double(), g64[k]) for k in moving])
    assert port_gap <= 3 * ref_gap


@pytest.mark.parametrize("L,S", [(512, 8), (64, 4), (12, 3), (1, 1)])
def test_orders_and_inverses_against_index_arithmetic(L, S):
    """``b`` takes token ``L - 1 - t`` to place ``t``; ``s`` takes token
    ``i (L / S) + j`` to place ``j S + i``; each inverse restores the
    order, in the port and in the reference alike."""
    x = torch.arange(2 * 3 * L, dtype=torch.float64).view(2, 3, L)
    tok = torch.arange(L)
    want = {"": tok, "_b": L - 1 - tok,
            "_s": torch.tensor([i * (L // S) + j for j in range(L // S) for i in range(S)])}
    for order, idx in want.items():
        for mod in (sm, ref):
            got = mod.reorder(x, order, S)
            assert torch.equal(got, x[..., idx]), (mod.__name__, order)
            assert torch.equal(mod.restore(got, order, S), x)


def naive_scan(u, delta, z, B, C, A, D, bias):
    """The recurrence a position at a time over the whole sequence; also
    returns the state before each position."""
    dt = F.softplus(delta + bias[:, None])
    h = torch.zeros(u.shape[:2] + (A.shape[1],), dtype=u.dtype)
    ys, states = [], []
    for t in range(u.shape[-1]):
        states.append(h)
        x = (dt[..., t] * u[..., t])[..., None] * B[:, None, t]
        h = torch.exp(dt[..., t, None] * A) * h + x
        ys.append((h * C[:, None, t]).sum(-1))
    return (torch.stack(ys, -1) + D[:, None] * u) * F.silu(z), torch.stack(states, 2)


def scan_args(b, d, L, N=16, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, dtype=dtype)  # noqa: E731
    xz = r(b, 2 * d, L)
    A = -torch.exp(0.5 * r(d, N)) * torch.arange(1, N + 1, dtype=dtype)
    return [r(b, d, L), 0.5 * r(b, d, L), xz, r(b, L, N), r(b, L, N), A, 1 + 0.1 * r(d),
            r(d) - 2.0]


@pytest.mark.parametrize("b,d,L", [(2, 3, 97), (1, 5, 32), (3, 2, 5)])
def test_plain_scan_against_a_sequential_float64_loop(b, d, L):
    """Forward, the chunk start states (chunks of 32: ragged, exactly one,
    shorter than one), and every gradient through the custom ops' plain
    versions, against autograd of the loop; ``z`` a channel slice."""
    u, delta, xz, B, C, A, D, bias = [t.requires_grad_() for t in scan_args(b, d, L)]
    z = xz[:, d:]
    want, states = naive_scan(u, delta, z, B, C, A, D, bias)
    got = ss.selective_scan(u, delta, z, B, C, A, D, bias)
    assert rel(got.detach(), want.detach()) < 1e-13
    _, hstart = ss.scan_fwd_plain(*(t.detach() for t in (u, delta, z, B, C, A, D, bias)))
    assert hstart.shape == (b, ss.chunks(L), d, 16)
    assert rel(hstart, states[:, :, ::ss.CHUNK].transpose(1, 2).detach()) < 1e-13
    dy = torch.randn(want.shape, generator=torch.Generator().manual_seed(2), dtype=want.dtype)
    leaves = [u, delta, xz, B, C, A, D, bias]
    for gw, gg in zip(torch.autograd.grad(want, leaves, dy), torch.autograd.grad(got, leaves, dy)):
        assert rel(gg, gw) < 1e-12


def test_plain_scan_keeps_bfloat16_types_and_float32_states():
    args = [t.to(torch.bfloat16) if i < 5 else t.float()
            for i, t in enumerate(scan_args(2, 4, 40, dtype=torch.float32))]
    args[2] = args[2][:, 4:]
    out, hstart = ss.scan_fwd_plain(*args)
    assert out.dtype == torch.bfloat16 and hstart.dtype == torch.float32
    grads_ = ss.scan_bwd_plain(*args, hstart, torch.ones_like(out))
    assert [g.dtype for g in grads_] == [torch.bfloat16] * 5 + [torch.float32] * 3
    fake = torch.ops.mvtb.selective_scan_fwd.default
    with torch._subclasses.FakeTensorMode() as mode:
        fa = [mode.from_tensor(t) for t in args]
        fo, fh = fake(*fa)
        fg = torch.ops.mvtb.selective_scan_bwd.default(*fa, fh, mode.from_tensor(out))
    assert (fo.shape, fo.dtype, fh.shape, fh.dtype) == (out.shape, out.dtype, hstart.shape,
                                                        hstart.dtype)
    assert [(t.shape, t.dtype) for t in fg] == [(t.shape, t.dtype) for t in grads_]


@pytest.mark.parametrize("op", ["selective_scan_fwd", "selective_scan_bwd"])
def test_scan_ops_on_the_card_reach_the_kernel_or_raise(op, monkeypatch, tmp_path):
    """The CUDA implementation of each op is the kernel's launch: dispatched
    to the CUDA key here (no card, no compiler) it reaches the library and
    raises; it never runs the plain version, and no counter moves."""
    from mvtb_tpu_torch.ops import _ops  # noqa: F401  (registers the ops)

    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(ss, "_LIB", {})
    assert torch._C._dispatch_has_kernel_for_dispatch_key(f"mvtb::{op}", "CUDA")
    args = [t.float() for t in scan_args(1, 4, 40, dtype=torch.float32)]
    args[2] = args[2][:, 4:]
    if op == "selective_scan_bwd":
        out, hstart = ss.scan_fwd_plain(*args)
        args += [hstart, out]
    counts = dict(profiling.counters)
    with pytest.raises(RuntimeError, match="nvcc"):
        getattr(torch.ops.mvtb, op).default.redispatch(
            torch._C.DispatchKeySet(torch._C.DispatchKey.CUDA), *args)
    assert dict(profiling.counters) == counts
    assert not (tmp_path / "build").exists()
    assert _build.SOURCES["selective_scan"] == "selective_scan.cu"


def test_importing_the_model_builds_and_loads_no_kernel():
    code = ("import sys, mvtb_tpu_torch.models, mvtb_tpu_torch.ops._ops\n"
            "from mvtb_tpu_torch.ops import _build, selective_scan\n"
            "sys.exit(1 if _build._LOADED or selective_scan._LIB else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert res.returncode == 0, res.stderr


def test_scan_wrapper_never_runs_plain_off_the_cpu():
    args = [t.float().to("meta") for t in scan_args(1, 2, 8, dtype=torch.float32)]
    with pytest.raises(ValueError, match="no kernel"):
        ss.selective_scan(*args[:2], args[2][:, 2:], *args[3:])


def test_published_widths_and_initialisation():
    """291 tensors and 67,416,147 parameters, named as the reference names
    them; Mamba's initialisation: ``A_log = log(1..16)``, ``D = 1``,
    ``softplus(dt_proj.bias)`` in ``[1e-4, 0.1]``."""
    with torch.device("meta"):
        m = build_seg_model("segmamba", device="meta")
    sd = m.state_dict()
    assert len(sd) == 291 and sum(v.numel() for v in sd.values()) == 67416147
    assert {k: tuple(v.shape) for k, v in sd.items()} == ref.param_shapes(PUBLISHED)
    mamba = m.vit.stages[0][0].mamba
    assert (mamba.d, mamba.R, mamba.N, mamba.slices) == (96, 3, 16, 64)
    assert [s[0].mamba.slices for s in m.vit.stages] == [64, 32, 16, 8]
    small = sm.TriMamba(48, num_slices=4, device="cpu")
    for o in sm.ORDERS:
        a_log = getattr(small, "A_log" if o == "" else f"A{o}_log")
        assert torch.allclose(a_log, torch.log(torch.arange(1.0, 17.0)).expand(96, 16))
        assert torch.equal(getattr(small, f"D{o}"), torch.ones(96))
        dt = F.softplus(getattr(small, f"dt_proj{o}").bias.detach())
        assert float(dt.min()) >= 1e-4 * (1 - 1e-5) and float(dt.max()) <= 0.1 * (1 + 1e-5)


def test_shapes_it_refuses():
    port = SegMamba(4, 3, device="cpu", **SMALL)
    with pytest.raises(ValueError, match="divisible by 16"):
        port(torch.zeros(1, 4, 16, 16, 24))
    with pytest.raises(ValueError, match="slices"):
        SegMamba(4, 3, device="cpu", **dict(SMALL, num_slices=(3, 4, 2, 1)))(torch.zeros(SHAPE))


def test_bf16_activations_float32_parameters():
    port = SegMamba(4, 3, device="cpu", dtype=torch.bfloat16, **SMALL)
    seen = {}

    def hook(mod, args, out):
        seen.setdefault(type(mod).__name__, set()).add(out.dtype)

    for mod in port.modules():
        if isinstance(mod, (sm.Conv, sm.LayerNorm, sm.GSC, sm.MambaLayer, sm.TriMamba)):
            mod.register_forward_hook(hook)
    x, label = inputs((1,) + SHAPE[1:])
    out = port(x)
    assert out.dtype == torch.bfloat16
    assert seen and all(d == {torch.bfloat16} for d in seen.values()), seen
    assert all(p.dtype == torch.float32 for p in port.parameters())
    dice_loss(out, label).backward()
    assert all(p.grad.dtype == torch.float32 for p in port.parameters())


def test_counters_and_spans(tmp_path):
    """A forward counts 24 scans (8 layers, 3 orders), every Mamba layer's
    tokens and the scans' positions; the spans nest inside the encoder's."""
    port = SegMamba(4, 3, device="cpu", **SMALL)
    x, _ = inputs()
    before = dict(profiling.counters)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(ptrace.WINDOW):
            with torch.no_grad():
                port(x)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    tr = ptrace.normalise(json.loads(path.read_text())["traceEvents"])
    got = {k: profiling.counters[k] - before.get(k, 0)
           for k in ("mamba.tokens", "mamba.scans", "mamba.scan_positions")}
    model = dict(PUBLISHED, depths=(2, 2, 2, 2), d_state=16, d_conv=4, expand=2, **SMALL)
    calls = scan_work.scans(model, SHAPE[2:])
    assert len(calls) == 24
    assert got == {"mamba.tokens": 2 * sum(c["L"] for c in calls) // 3, "mamba.scans": 24,
                   "mamba.scan_positions": 2 * sum(c["L"] for c in calls)}
    assert spans.count(tr, "mvtb.mamba.encoder") == 1
    assert spans.count(tr, "mvtb.mamba.scan") == 24
    assert spans.count(tr, "mvtb.mamba.gsc") == 4
    assert spans.count(tr, "mvtb.mamba.layout") == 8 + 2 * 24
    assert spans.count(tr, "mvtb.unetr.conv") == 11
    enc = spans.named(tr, "mvtb.mamba.encoder")[0]
    for name in ("mvtb.mamba.scan", "mvtb.mamba.layout", "mvtb.mamba.gsc"):
        for e in spans.named(tr, name):
            assert enc["ts"] <= e["ts"] and e["ts"] + e["dur"] <= enc["ts"] + enc["dur"]


def test_arch_registry_holds_the_published_shape():
    assert isinstance(build_seg_model("segmamba", device="cpu", **SMALL), SegMamba)
    cfg = treg.get("gibbs12p5")
    run_cfg = tmodels.seg_run_config(cfg, "segmamba")
    assert (run_cfg.name, run_cfg.spatial) == ("gibbs12p5_segmamba", (128, 128, 128))
    assert run_cfg.batch_size == min(cfg.batch_size, 2)
    assert tmodels.seg_widths(cfg, "segmamba") == {}
    assert tmodels.seg_run_config(cfg, "unet") is cfg
    assert tmodels.seg_widths(cfg, "unet") == dict(channels=cfg.channels, strides=cfg.strides,
                                                   num_res_units=cfg.num_res_units)
    assert [f.name for f in dataclasses.fields(run_cfg)] == [f.name for f in
                                                            dataclasses.fields(cfg)]


def test_cli_run_arch_segmamba_chunked(capsys, tmp_path, monkeypatch):
    """``run --arch segmamba`` trains one chunk of one step through the
    runner's chunked path (a 16^3 crop and narrower widths, as the
    published model's 128^3 step does not fit a CPU test)."""
    cfg = dataclasses.replace(treg.get("gibbs12p5"), data_kind="smooth", val_interval=1,
                              model_dtype="float32",
                              train_stylize=StylizeConfig(disk_r=4.0, disk_prob=1.0),
                              val_stylize=StylizeConfig(disk_r=4.0, disk_prob=1.0))
    monkeypatch.setitem(treg.REGISTRY, "gibbs12p5", cfg)
    monkeypatch.setitem(tmodels.SEG_ARCHS, "segmamba",
                        tmodels.SEG_ARCHS["segmamba"]._replace(crop=(16, 16, 16), max_batch=1))
    real, built, seen = trunner.build_seg_model, [], []

    def small(arch, *a, **kw):
        built.append(arch)
        return real(arch, *a, **dict(kw, **SMALL))

    chunk_real = trunner.make_chunk_fn

    def chunk_fn(*a, **kw):
        fn = chunk_real(*a, **kw)
        return lambda state, gen, pi, pl, idxs: (seen.append(tuple(idxs.shape)),
                                                 fn(state, gen, pi, pl, idxs))[1]

    monkeypatch.setattr(trunner, "build_seg_model", small)
    monkeypatch.setattr(trunner, "make_chunk_fn", chunk_fn)
    w = tmp_path / "w"
    argv = ["run", "gibbs12p5", "--arch", "segmamba", "--chunked", "--pool", "2",
            "--device", "cpu", "--epochs", "1", "--steps", "1", "--val-batches", "1",
            "--quiet", "--workdir", str(w)]
    assert tmain.main(argv) == 0
    assert built == ["segmamba"] and seen == [(1, 1)]
    summary = json.loads(capsys.readouterr().out)
    assert set(summary) == {"best_dice", "wall_time_s"}
    hist = json.loads((w / "gibbs12p5_segmamba_result.json").read_text())["history"]
    assert len(hist["loss"]) == 1 and np.isfinite(hist["loss"][0])


def test_chunk_trains_it():
    torch.manual_seed(0)
    model = build_seg_model("segmamba", device="cpu", **SMALL)
    state = create_seg_state(model, device="cpu")
    before = [p.detach().clone() for p in model.parameters()]
    x, label = inputs()
    sty = StylizeConfig(disk_r=4.0, disk_prob=1.0)
    state, _, loss = make_chunk_fn(sty, device="cpu")(
        state, torch.Generator().manual_seed(3), x, label, torch.tensor([[0], [1]]))
    assert state.step == 2 and math.isfinite(float(loss))
    moved = [not torch.equal(a, p) for a, p in zip(before, model.parameters())]
    assert sum(moved) >= 0.9 * len(moved)


def test_sliding_window_evaluation_of_a_tiny_segmamba():
    """``ModelEvaluation``'s sliding window takes it unchanged: 16^3 tiles
    over a 24 x 20 x 16 volume, a 2 x 2 x 1 grid."""
    torch.manual_seed(0)
    model = build_seg_model("segmamba", device="cpu", **SMALL).eval()
    rng = np.random.RandomState(0)
    vols = [{"image": rng.randn(1, 4, 24, 20, 16).astype(np.float32),
             "label": (rng.rand(1, 3, 24, 20, 16) < 0.4).astype(np.float32)} for _ in range(2)]
    ev = ModelEvaluation(model, out_channels=3, roi_size=(16, 16, 16), device="cpu")
    before = profiling.counters["sw.tiles"]
    dice = ev.dataset_eval_multi(vols)
    assert len(dice) == 4 and all(np.isfinite(d) or np.isnan(d) for d in dice)
    assert profiling.counters["sw.tiles"] - before == 2 * 4
