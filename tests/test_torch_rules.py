"""Rules the port keeps: it imports no JAX and nothing of the JAX package,
its entry points default to the card and raise without one, and its kernel
wrapper raises instead of falling back."""

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import mvtb_tpu_torch
from mvtb_tpu_torch import resolve_device
from mvtb_tpu_torch.models import UNet
from mvtb_tpu_torch import transforms as T
from mvtb_tpu_torch.ops import _build, fused, fused_plane, masks, pallas_dft, pallas_kernels
from mvtb_tpu_torch.train import (create_seg_state, seg_eval_step, seg_train_step,
                                  train_segmentation)
from mvtb_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "mvtb_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                               ROOT / "plane_profile.py"]
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax)\b"
    r"|^\s*(import|from)\s+mvtb_tpu(\.|\s|$)"
    r"|\bmvtb_tpu\.", re.M)


def test_import_leaves_jax_out():
    code = ("import sys, mvtb_tpu_torch, mvtb_tpu_torch.ops, "
            "mvtb_tpu_torch.ops.fused_plane, mvtb_tpu_torch.ops._build, "
            "mvtb_tpu_torch.ops.pallas_dft, mvtb_tpu_torch.train.losses, "
            "mvtb_tpu_torch.models, mvtb_tpu_torch.eval, mvtb_tpu_torch.train, "
            "mvtb_tpu_torch.ops.fourier, mvtb_tpu_torch.ops.masks, "
            "mvtb_tpu_torch.ops.corruptions, mvtb_tpu_torch.ops.pallas_kernels, "
            "mvtb_tpu_torch.transforms, mvtb_tpu_torch.transforms.base, "
            "mvtb_tpu_torch.transforms.array, mvtb_tpu_torch.transforms.dictionary, "
            "mvtb_tpu_torch.models.dcgan, mvtb_tpu_torch.models.resunet_gan, "
            "mvtb_tpu_torch.eval.fid, mvtb_tpu_torch.train.gan, "
            "mvtb_tpu_torch.train.chunked, mvtb_tpu_torch.experiments.runner, "
            "mvtb_tpu_torch.experiments.manifest, mvtb_tpu_torch.eval.harness, "
            "mvtb_tpu_torch.eval.sliding_window, mvtb_tpu_torch.eval.plots, "
            "mvtb_tpu_torch.data, mvtb_tpu_torch.native, mvtb_tpu_torch.models.layers, "
            "mvtb_tpu_torch.train.learnable, mvtb_tpu_torch.parallel, "
            "mvtb_tpu_torch.parallel.sharded_fft, mvtb_tpu_torch.parallel.spatial, "
            "mvtb_tpu_torch.parallel.dp, mvtb_tpu_torch.parallel.collectives, "
            "mvtb_tpu_torch.serve, mvtb_tpu_torch.ops._ops, mvtb_tpu_torch.utils, "
            "mvtb_tpu_torch.utils.profiling, mvtb_tpu_torch.compat, "
            "mvtb_tpu_torch.compat.filters_and_operators, "
            "mvtb_tpu_torch.compat.stylization_layers, mvtb_tpu_torch.compat.utils, "
            "mvtb_tpu_torch.compat.monai, mvtb_tpu_torch.compat.monai.networks.nets, "
            "mvtb_tpu_torch.examples, mvtb_tpu_torch.examples._common, "
            + "".join(f"mvtb_tpu_torch.examples.{p.stem}, " for p in sorted(
                (ROOT / "mvtb_tpu_torch" / "examples").glob("[!_]*.py")))
            + "chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'mvtb_tpu')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_source_names_no_jax(path):
    assert not FORBIDDEN.search(path.read_text()), path


def test_scan_catches_a_jax_import():
    for line in ("import jax", "from flax import linen", "import mvtb_tpu",
                 "from mvtb_tpu.ops import fused", "x = mvtb_tpu.ops"):
        assert FORBIDDEN.search(line), line
    for line in ("import mvtb_tpu_torch", "from mvtb_tpu_torch.ops import dft",
                 "# counterpart of mvtb_tpu/ops/fused.py"):
        assert not FORBIDDEN.search(line), line


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def launch_counts() -> dict:
    """A snapshot of the process's kernel-launch counters."""
    return {k: v for k, v in profiling.counters.items() if k.startswith("launch.")}


def test_entry_points_default_to_the_card(no_card):
    cfg = fused.StylizeConfig(disk_r=3.0, fft_backend="plane")
    x = torch.zeros(1, 1, 8, 6, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        fused.stylize_batch(x, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        fused.sample_draws(cfg, (8, 6, 4), 1, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        UNet(1, 1, (2, 4), (2,))
    model = UNet(1, 1, (2, 4), (2,), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        seg_eval_step(model, x, x)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_seg_state(model)
    state = create_seg_state(model, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        seg_train_step(state, x, x)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_segmentation(state, iter([(x, x)]), 1)
    pallas_cfg = fused.StylizeConfig(disk_r=3.0, fft_backend="dft_pallas")
    with pytest.raises(RuntimeError, match="CUDA"):
        fused.stylize_batch(x, pallas_cfg)
    assert state.step == 0
    assert resolve_device("cpu") == torch.device("cpu")
    # the GAN family
    from mvtb_tpu_torch.eval.fid import FrozenFeatureEncoder
    from mvtb_tpu_torch.models import (Discriminator, Generator, ResUnetDiscriminator,
                                       ResUnetGenerator)
    from mvtb_tpu_torch.train.gan import sample_recon_draws
    for make in (lambda: Generator(8, 2, 1), lambda: Discriminator(1, 2),
                 lambda: ResUnetGenerator(1, 2), lambda: ResUnetDiscriminator(1, 2),
                 lambda: FrozenFeatureEncoder(1), lambda: sample_recon_draws("zf", (1, 1, 8, 8))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    # the domain protocol and the evaluation it rests on
    from mvtb_tpu_torch.data import Loader, StylizedLoader
    from mvtb_tpu_torch.eval import ModelEvaluation, sliding_window_inference
    from mvtb_tpu_torch.experiments import run_domain_experiment
    loader = Loader([{"image": x[0].numpy(), "label": x[0].numpy()}])
    for make in (lambda: run_domain_experiment("baseline_domain"),
                 lambda: ModelEvaluation(model),
                 lambda: ModelEvaluation.from_checkpoint("no-such-dir"),
                 lambda: sliding_window_inference(x, (4, 4, 4), model),
                 lambda: StylizedLoader(loader, cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    # learnable stylization
    from mvtb_tpu_torch.models import GibbsNoiseLayer, GibbsUNet, SpikeLayer, SpikesUNet
    from mvtb_tpu_torch.train import (create_learnable_state, fd_train_step,
                                      learnable_train_step, make_learnable_chunk_fn)
    tiny = dict(channels=(2, 4), strides=(2,), num_res_units=1)
    lstate = create_learnable_state(GibbsUNet(**tiny, device="cpu"), device="cpu")
    for make in (lambda: GibbsUNet(**tiny), lambda: SpikesUNet(**tiny),
                 lambda: GibbsNoiseLayer(0.5), lambda: SpikeLayer(),
                 lambda: create_learnable_state(GibbsUNet(**tiny, device="cpu")),
                 lambda: make_learnable_chunk_fn(True), lambda: make_learnable_chunk_fn(False),
                 lambda: learnable_train_step(lstate, x, x), lambda: fd_train_step(lstate, x, x)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert lstate.step == 0


def test_serving_utils_and_compat_default_to_the_card(no_card, tmp_path):
    """Loading a served program, seeding, and the monai shim's UNet take the
    card unless told otherwise, and raise without one."""
    from mvtb_tpu_torch import serve, utils
    from mvtb_tpu_torch.compat.monai.networks.nets import UNet as ShimUNet
    from mvtb_tpu_torch.compat.stylization_layers import Gibbs_UNet

    x = torch.zeros(1, 1, 8, 8, 4)
    model = UNet(1, 1, (2, 4), (2,), device="cpu")
    blob = serve.export_fn(serve.module_fn(model), (dict(model.state_dict()), x))
    serve.ServingBundle.save(str(tmp_path), serve.module_fn(model), model.state_dict(), (x,))
    for make in (lambda: serve.ServingBundle.load(str(tmp_path)),
                 lambda: serve.load_fn(blob), lambda: utils.set_determinism(0),
                 lambda: utils.StepTimer(), lambda: ShimUNet(dimensions=3),
                 lambda: Gibbs_UNet(0.5)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert serve.ServingBundle.load(str(tmp_path), device="cpu")(x).shape == x.shape


@pytest.mark.parametrize("op", ["fused_plane", "axis_dft", "sap", "polar"])
def test_custom_op_on_the_card_reaches_its_kernel_or_raises(op, monkeypatch, tmp_path):
    """Each custom op's CUDA implementation is the kernel launch: dispatched
    to the CUDA key here (no card, no compiler) it reaches the kernel's
    library and raises; it never runs the plain version, and no ``launch.*``
    counter moves."""
    from mvtb_tpu_torch.ops import _ops  # noqa: F401  (registers the ops)

    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    for mod in (fused_plane, pallas_dft, pallas_kernels):
        monkeypatch.setattr(mod, "_LIB", {})
    assert torch._C._dispatch_has_kernel_for_dispatch_key(f"mvtb::{op}", "CUDA")
    cfg = fused.StylizeConfig(disk_r=3.0, fft_backend="plane")
    draws = fused.sample_draws(cfg, (8, 6, 4), 2, 1, device="cpu")
    flags, *params = fused_plane.plane_params(cfg, (8, 6, 4), draws, 2, 1, torch.device("cpu"))
    k = torch.randn(2, 5, 6, 4)
    mats = list(pallas_dft._dft.device_mats("gauss", 6, False, torch.device("cpu")))
    args = {"fused_plane": (k, k, [8, 6, 4], list(flags), *params, False),
            "axis_dft": ("c2c", False, [k.reshape(10, 6, 4)] * 2, mats, "high"),
            "sap": (k, torch.tensor(0.1), torch.tensor(3)),
            "polar": (k, k)}[op]
    counts = launch_counts()
    overload = getattr(torch.ops.mvtb, op).default
    with pytest.raises(RuntimeError, match="nvcc"):
        overload.redispatch(torch._C.DispatchKeySet(torch._C.DispatchKey.CUDA), *args)
    assert launch_counts() == counts
    assert not (tmp_path / "build").exists()


def test_process_group_entry_points_default_to_the_card(no_card, monkeypatch):
    """``device=None`` is the card for the parallel entry points too: with
    no card they raise rather than start a gloo group."""
    import torch.distributed as dist
    from mvtb_tpu_torch.parallel import distributed_mesh, initialize, make_mesh

    monkeypatch.setenv("MVTB_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("MVTB_NUM_PROCESSES", "2")
    monkeypatch.setenv("MVTB_PROCESS_ID", "1")
    for call in (initialize, make_mesh, distributed_mesh):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not dist.is_initialized()


@pytest.mark.parametrize("make", [
    lambda: T.GibbsNoise(0.5),
    lambda: T.RandGibbsNoise(prob=1.0),
    lambda: T.KSpaceSpikeNoise((1, 2, 3)),
    lambda: T.RandKSpaceSpikeNoise(prob=1.0),
    lambda: T.WrapArtifact(0.5),
    lambda: T.RandZF(0.1),
    lambda: T.RandFourierDiskMaskd("image", r=3.0),
    lambda: T.RandPlaneWaves_ellipsoid("image"),
    lambda: T.SaltAndPepper(0.1),
    lambda: T.WrapArtifactd("image"),
    lambda: T.RandGibbsNoised("image"),
    lambda: T.RandKSpaceSpikeNoised("image"),
    lambda: masks.soft_gibbs_mask((4, 4, 4), 0.5),
    lambda: masks.reference_gibbs_layer_mask((4, 4, 4), 0.5),
])
def test_transforms_default_to_the_card(no_card, make):
    with pytest.raises(RuntimeError, match="CUDA"):
        make()


def test_pointwise_wrappers_never_run_plain_off_the_cpu():
    """Without a card there is no CUDA tensor to hand a wrapper: a tensor
    on any device but the CPU (``meta`` here) raises instead of reaching
    the plain version, and the kernel library raises without a compiler."""
    x = torch.zeros(2, 3, 4, device="meta")
    counts = launch_counts()
    for call in (lambda: pallas_kernels.salt_and_pepper_pallas(x, 0.1, 1),
                 lambda: pallas_kernels.polar_roundtrip_pallas(x, x)):
        with pytest.raises(ValueError, match="no kernel"):
            call()
    assert launch_counts() == counts


def test_kernel_build_raises_without_a_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(fused_plane, "_LIB", {})
    monkeypatch.setattr(pallas_dft, "_LIB", {})
    monkeypatch.setattr(pallas_kernels, "_LIB", {})
    for name in _build.SOURCES:
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.load(name)
    with pytest.raises(RuntimeError, match="nvcc"):
        fused_plane._lib()
    with pytest.raises(RuntimeError, match="nvcc"):
        pallas_dft._lib()
    with pytest.raises(RuntimeError, match="nvcc"):
        pallas_kernels._lib()
    assert not (tmp_path / "build").exists()


def test_build_names_the_hopper_target():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.SOURCES == {"fused_plane": "fused_plane.cu",
                              "axis_dft": "axis_dft.cu",
                              "pointwise": "pointwise.cu",
                              "selective_scan": "selective_scan.cu"}
    for name, src in _build.SOURCES.items():
        assert (_build.CSRC / src).is_file()
        assert _build.lib_path(name).parent == _build.BUILD_DIR


def test_wrapper_takes_plain_only_for_cpu_tensors():
    cfg = fused.StylizeConfig(disk_r=3.0, fft_backend="plane")
    cpu = torch.device("cpu")
    draws = fused.sample_draws(cfg, (8, 6, 4), 2, 1, device=cpu)
    flags, *params = fused_plane.plane_params(cfg, (8, 6, 4), draws, 2, 1, cpu)
    k = torch.randn(2, 5, 6, 4)
    before = launch_counts()
    got = fused_plane.plane_stylize_half(k, k, (8, 6, 4), flags, *params)
    ref = fused_plane.plane_stylize_half_plain(k, k, (8, 6, 4), flags, *params)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert launch_counts() == before  # no kernel ran
    meta = k.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_plane.plane_stylize_half(meta, meta, (8, 6, 4), flags, *params)
    # the pointwise kernels' wrappers: plain on CPU tensors, nothing counted
    assert torch.equal(pallas_kernels.salt_and_pepper_pallas(k, 0.2, 5),
                       pallas_kernels.salt_and_pepper_plain(k, 0.2, 5))
    assert all(torch.equal(a, b) for a, b in zip(
        pallas_kernels.polar_roundtrip_pallas(k, k), pallas_kernels.polar_roundtrip_plain(k, k)))
    assert launch_counts() == before
    # the axis kernels' n-D transforms (every path of dft_pallas, the complex
    # one too): plain on CPU tensors, no kernel and no fallback elsewhere
    x = torch.randn(2, 6, 5)
    for fn in (pallas_dft.dft_nd, pallas_dft.idft_nd_real):
        torch.testing.assert_close(fn(x, (1, 2), "high"), fn(x, (1, 2), "high"))
        with pytest.raises(ValueError, match="no kernel"):
            fn(x.to("meta"), (1, 2), "high")
    assert launch_counts() == before


def test_chip_smoke_fails_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env["PYTHONPATH"] = ""
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=alone, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert mvtb_tpu_torch.__version__


def test_chip_smoke_names_each_kernel_in_its_ptxas_lines():
    # ptxas prints a kernel's registers after its entry line, and its
    # register warnings before it, naming the entry inside the warning
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    tc = "_ZN44_GLOBAL__N__e4_11_axis_dft_cu_51ee5cc52tc14axis_tc_kernelILi2ELb1ELi2ELi2EEEvNS0_6TcArgsE"
    log = (f"ptxas warning : (C7517) warpgroup.wait is injected in around line 9 by compiler "
           f"to allow use of registers defined by GMMA in function '{tc}'\n"
           f"ptxas info    : Compiling entry function '{tc}' for 'sm_90a'\n"
           f"ptxas info    : Function properties for {tc}\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 228 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function "
           "'_ZN44_GLOBAL__N__e4_11_axis_dft_cu_51ee5cc515axis_dft_kernelILi2ELb0EEEvNS_4ArgsE'"
           " for 'sm_90a'\n"
           "ptxas info    : Used 77 registers, used 1 barriers, 17408 bytes smem\n"
           "ptxas info    : Compiling entry function 'sap_kernel' for 'sm_90a'\n"
           "ptxas info    : Used 30 registers\n")
    assert chip_smoke.ptxas_lines("axis_dft", log) == [
        "ptxas axis_dft axis_tc_kernel<2,1,2,2>: (C7517) warpgroup.wait is injected in around "
        "line 9 by compiler to allow use of registers defined by GMMA",
        "ptxas axis_dft axis_tc_kernel<2,1,2,2>: 0 bytes stack frame, 0 bytes spill stores, "
        "0 bytes spill loads",
        "ptxas axis_dft axis_tc_kernel<2,1,2,2>: Used 228 registers, used 1 barriers",
        "ptxas axis_dft axis_dft_kernel<2,0>: Used 77 registers, used 1 barriers, 17408 bytes smem",
        "ptxas axis_dft sap_kernel: Used 30 registers"]


def test_plane_profile_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(ROOT / "plane_profile.py")], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 2
    assert "no CUDA device" in res.stderr


def _assigned_names(path: Path) -> list:
    """Every name a file binds at module level, and every attribute any of
    its statements assigns."""
    tree = ast.parse(path.read_text())
    names = [t.id for node in tree.body if isinstance(node, (ast.Assign, ast.AnnAssign))
             for t in (node.targets if isinstance(node, ast.Assign) else [node.target])
             if isinstance(t, ast.Name)]
    names += [t.attr for node in ast.walk(tree) if isinstance(node, (ast.Assign, ast.AugAssign))
              for t in (node.targets if isinstance(node, ast.Assign) else [node.target])
              if isinstance(t, ast.Attribute)]
    return names


def _defined_functions(path: Path) -> list:
    return [n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))]


@pytest.mark.parametrize("rule", ["launches_in_profiling_counters", "chip_smoke_times_nothing"])
def test_measurement_lives_in_one_place(rule):
    """The port counts its kernel launches only in ``profiling.counters``
    (no module keeps a launch counter of its own, as a global or as a
    function's attribute), and ``chip_smoke.py`` checks without timing:
    the benchmark (``portbench/``) and ``plane_profile.py`` measure."""
    if rule == "launches_in_profiling_counters":
        own = {f"{p.relative_to(ROOT)}: {n}" for p in PORT_FILES for n in _assigned_names(p)
               if re.fullmatch(r"(tier_)?launches", n)}
        assert not own, own
    else:
        timing = [n for n in _defined_functions(ROOT / "chip_smoke.py")
                  if re.fullmatch(r".*_bound|.*_timing|graph_ms|cuda_ms|_op_overhead|"
                                  r"kernels_line|_runner_rates|axis_library", n)]
        assert not timing, timing
        assert "cuda_ms" in _defined_functions(ROOT / "plane_profile.py")
