"""The port's serving artifacts (mvtb_tpu_torch/serve.py and the custom ops
of mvtb_tpu_torch/ops/_ops.py) against the JAX package's (mvtb_tpu/serve.py).

Each test of tests/test_serve.py has a counterpart here, on the CPU: the
port's programs run the kernels' plain versions there (the card's launches
are held by chip_smoke.py). The JAX references are computed once per module
from the same numpy inputs; weights come from the flax tree through
models/convert.py, and the stylize draws are the JAX package's, replayed by
tests/test_torch_fused_plane.py:jax_stage_draws.

Tolerances: a served program against the eager call it was exported from,
within 1e-5 (the JAX tests' bound: the same operators, possibly fused in
another order); the served UNet against JAX's served UNet, ``atol=1e-5``
as tests/test_torch_unet.py holds the two forwards; the served stylize
against JAX's served stylize (``torch.fft`` / XLA's FFT, float32) within
1e-5 of the max, and on the kernels' backends (``plane``, ``dft_pallas``:
bf16x3 products) within 5e-5 of the max, chip_smoke.py's bound for a
bf16x3 stylize.
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtb_tpu import serve as jserve
from mvtb_tpu.models import UNet as JUNet
from mvtb_tpu.ops import fused as jfused
from mvtb_tpu_torch.models import UNet, unet_params_from_flax
from mvtb_tpu_torch.ops import fused_plane, pallas_dft, pallas_kernels
from mvtb_tpu_torch.ops.fused import StylizeConfig, sample_draws, stylize_batch
from mvtb_tpu_torch.serve import (ServingBundle, default_platforms, export_fn, load_fn,
                                  module_fn)
from test_torch_fused_plane import jax_stage_draws
from test_torch_rules import launch_counts
from torch_dist_worker import World

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
STYLE = dict(gibbs_alpha=(0.2, 0.6), sap_p=0.05, spike=True, spike_range=(9.0, 10.0))


def ncdhw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max()) / (float(np.abs(ref).max()) + 1e-30)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def unet():
    """tests/test_serve.py's tiny UNet: the flax weights (two draws) converted
    to the port, and the JAX package's served output at batch 1."""
    jm = JUNet(out_channels=3, channels=(4, 8), strides=(2,), num_res_units=1)
    x = np.random.RandomState(3).randn(1, 16, 16, 8, 4).astype(np.float32)
    p1, p2 = (jax.jit(jm.init)(jax.random.key(k), jnp.asarray(x)) for k in (0, 1))
    served = jserve.load_fn(jserve.export_fn(lambda p, img: jm.apply(p, img), (p1, x)))
    model = UNet(4, 3, (4, 8), (2,), num_res_units=1, device="cpu")
    model.load_state_dict(unet_params_from_flax(jax.device_get(p1["params"])))
    return SimpleNamespace(
        model=model, x=ncdhw(x), jax_out=ncdhw(served(p1, jnp.asarray(x))),
        params=dict(model.state_dict()),
        params2=unet_params_from_flax(jax.device_get(p2["params"])),
        jax_out2=ncdhw(jm.apply(p2, jnp.asarray(x))))


def _eager(model, params, x):
    with torch.no_grad():
        return torch.func.functional_call(model, params, (x,))


def test_export_fn_roundtrip_exact(unet):
    blob = export_fn(module_fn(unet.model), (unet.params, unet.x))
    assert isinstance(blob, bytes) and len(blob) > 0
    served = load_fn(blob, device="cpu")
    out = served(unet.params, unet.x)
    torch.testing.assert_close(out, _eager(unet.model, unet.params, unet.x),
                               rtol=1e-5, atol=1e-5)
    # the served port program against the JAX package's served program
    np.testing.assert_allclose(out.numpy(), unet.jax_out.numpy(), atol=1e-5)


def test_exported_program_validates_input_shapes(unet):
    served = load_fn(export_fn(module_fn(unet.model), (unet.params, unet.x)), device="cpu")
    with pytest.raises(Exception):
        served(unet.params, torch.zeros(1, 4, 8, 8, 8))


@pytest.fixture(scope="module")
def stylize_case():
    """tests/test_serve.py's stylize config and input; the JAX package's
    served stylize (``jax.export`` with key data) and its draws, replayed."""
    cfg = jfused.StylizeConfig(**STYLE)
    x = np.random.RandomState(0).randn(2, 2, 16, 16, 8).astype(np.float32)
    kd = jax.random.key_data(jax.random.key(7))

    def styl(img, key_data):
        return jfused.stylize_batch(img, jax.random.wrap_key_data(key_data), cfg)

    served = jserve.load_fn(jserve.export_fn(styl, (x, kd)))
    ref = np.asarray(served(jnp.asarray(x), kd))
    draws = jax_stage_draws(jax.random.wrap_key_data(kd), cfg, x.shape)
    return SimpleNamespace(x=torch.from_numpy(x), draws=draws, jax_out=ref)


def _styl(backend):
    cfg = StylizeConfig(**STYLE, fft_backend=backend)

    def styl(img, draws):
        return stylize_batch(img, cfg, draws, device=img.device)

    return styl


@pytest.mark.parametrize("backend,tol", [("xla", 1e-5), ("plane", 5e-5), ("dft_pallas", 5e-5)])
def test_stylize_exports_with_draws_arg(stylize_case, backend, tol):
    """A stylize exports as ``fn(x, draws)``: the draws are tensor inputs
    (JAX's key data), so the served program replays JAX's draws. On the
    kernels' backends the program holds the custom op."""
    styl = _styl(backend)
    blob = export_fn(styl, (stylize_case.x, stylize_case.draws))
    served = load_fn(blob, device="cpu")
    out = served(stylize_case.x, stylize_case.draws)
    torch.testing.assert_close(out, styl(stylize_case.x, stylize_case.draws),
                               rtol=1e-5, atol=1e-5)
    assert rel(out, stylize_case.jax_out) < tol
    ops = _op_names(blob)
    assert ops == {"plane": {"fused_plane"}, "dft_pallas": {"axis_dft"}, "xla": set()}[backend]


def _op_names(blob: bytes) -> set:
    import io

    ep = torch.export.load(io.BytesIO(blob))
    return {n.target.name().split("::")[1].split(".")[0] for n in ep.graph.nodes
            if n.op == "call_function" and hasattr(n.target, "name")
            and n.target.name().startswith("mvtb::")}


def test_serving_bundle_roundtrip_without_model_code(unet, tmp_path):
    path = tmp_path / "bundle"
    ServingBundle.save(str(path), module_fn(unet.model), unet.params, (unet.x,),
                       extra_meta={"task": "segmentation"})
    for name in (ServingBundle.PROGRAM, ServingBundle.PARAMS, ServingBundle.META):
        assert (path / name).exists()
    meta = ServingBundle.meta(str(path))
    assert meta["task"] == "segmentation"
    assert meta["inputs"][0]["shape"] == [1, 4, 16, 16, 8]
    torch.save(unet.x, tmp_path / "x.pt")
    # load() in a process that imports serve alone: no model class loads
    code = (
        "import sys, torch\n"
        "from mvtb_tpu_torch.serve import ServingBundle\n"
        f"serve = ServingBundle.load({str(path)!r}, device='cpu')\n"
        f"torch.save(serve(torch.load({str(tmp_path / 'x.pt')!r})), "
        f"{str(tmp_path / 'out.pt')!r})\n"
        "bad = [m for m in sys.modules if m.startswith('mvtb_tpu_torch.models') "
        "or m.split('.')[0] in ('jax', 'flax', 'mvtb_tpu')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    out = torch.load(tmp_path / "out.pt")
    torch.testing.assert_close(out, _eager(unet.model, unet.params, unet.x),
                               rtol=1e-5, atol=1e-5)


def test_serving_bundle_param_hot_swap(unet, tmp_path):
    path = str(tmp_path / "bundle")
    ServingBundle.save(path, module_fn(unet.model), unet.params, (unet.x,))
    served = ServingBundle.load(path, params=unet.params2, device="cpu")
    out = served(unet.x)
    torch.testing.assert_close(out, _eager(unet.model, unet.params2, unet.x),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), unet.jax_out2.numpy(), atol=1e-5)
    assert not torch.equal(out, ServingBundle.load(path, device="cpu")(unet.x))


def test_meta_json_is_valid(unet, tmp_path):
    path = str(tmp_path / "bundle")
    ServingBundle.save(path, module_fn(unet.model), unet.params, (unet.x,))
    with open(os.path.join(path, ServingBundle.META)) as f:
        meta = json.load(f)
    assert "cpu" in meta["platforms"] and list(default_platforms()) == meta["platforms"]
    assert meta["export_device"] == "cpu" and meta["torch"] == torch.__version__
    assert meta["batch_polymorphic"] is False
    assert meta["inputs"] == [{"shape": [1, 4, 16, 16, 8], "dtype": "float32"}]
    assert meta["params"] == list(unet.params)


def test_batch_polymorphic_bundle_serves_any_batch(unet, tmp_path):
    """One program serves batch sizes it was never traced at (the example's
    batch of 1 is traced at 2: torch.export fixes a size-1 dim)."""
    path = str(tmp_path / "bundle")
    ServingBundle.save(path, module_fn(unet.model), unet.params, (unet.x,),
                       batch_polymorphic=True)
    assert ServingBundle.meta(path)["batch_polymorphic"] is True
    served = ServingBundle.load(path, device="cpu")
    for b in (1, 3):
        xb = torch.from_numpy(np.random.RandomState(b).randn(b, 4, 16, 16, 8)
                              .astype(np.float32))
        torch.testing.assert_close(served(xb), _eager(unet.model, unet.params, xb),
                                   rtol=1e-5, atol=1e-5)


def test_batch_polymorphic_skips_non_batched_inputs(tmp_path):
    """Side inputs keep concrete shapes: the symbolic batch applies only to
    tensors that share the first input's leading size. The draws do, every
    field of them; a (2,) side input beside a batch of 3 does not."""
    cfg = StylizeConfig(gibbs_alpha=(0.2, 0.6), sap_p=0.05, fft_backend="plane")

    def styl(params, img, draws, gain):
        del params
        return stylize_batch(img, cfg, draws, device=img.device) * gain[0] + gain[1]

    def case(b, seed):
        x = torch.from_numpy(np.random.RandomState(seed).randn(b, 2, 16, 16, 8)
                             .astype(np.float32))
        return x, sample_draws(cfg, (16, 16, 8), b, 2, torch.Generator().manual_seed(seed),
                               device="cpu")

    gain = torch.tensor([2.0, 0.5])
    path = str(tmp_path / "bundle")
    ServingBundle.save(path, styl, {}, case(3, 1) + (gain,), batch_polymorphic=True)
    meta = ServingBundle.meta(path)
    assert meta["inputs"][1]["type"] == "StageDraws"
    assert meta["inputs"][2] == {"shape": [2], "dtype": "float32"}
    served = ServingBundle.load(path, params={}, device="cpu")
    for b in (1, 4):
        x, d = case(b, b)
        torch.testing.assert_close(served(x, d, gain), styl({}, x, d, gain),
                                   rtol=1e-5, atol=1e-5)
    with pytest.raises(Exception):
        served(x, d, torch.ones(4))


@pytest.fixture(scope="module")
def sharded_world(tmp_path_factory):
    """Two gloo ranks serving the tiny UNet split over ``data``, a dense
    layer (tests/test_serve.py's ``Tiny``) and the UNet split over
    ``model``, each exported per rank with export_sharded_fn and reloaded."""
    rng = np.random.RandomState(0)
    torch.manual_seed(0)
    model = UNet(4, 3, (4, 8), (2,), num_res_units=1, device="cpu")
    data = {"state": {k: v.numpy() for k, v in model.state_dict().items()},
            "x": rng.randn(4, 4, 16, 16, 8).astype(np.float32),
            "w": rng.randn(5, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32),
            "xd": rng.randn(8, 4, 5).astype(np.float32)}
    ranks = World("serve_world", 2, data, tmp_path_factory.mktemp("serve")).results()
    with torch.no_grad():
        ref = model(torch.from_numpy(data["x"]))
    dense = torch.from_numpy(data["xd"]) @ torch.from_numpy(data["w"]) + torch.from_numpy(data["b"])
    return SimpleNamespace(ranks=ranks, unet_ref=ref, dense_ref=dense)


def test_sharded_export_serves_on_the_mesh(sharded_world):
    """A data-parallel forward exports per rank at its shard's shape; each
    rank serves its rows and the gathered output is the global forward."""
    for r in sharded_world.ranks:
        assert r["unet_mesh"] == {"data": 2, "model": 1}
        assert r["unet_local_shape"] == (2, 3, 16, 16, 8)
        torch.testing.assert_close(r["unet"], sharded_world.unet_ref, rtol=1e-5, atol=1e-5)


def test_export_sharded_fn_roundtrip_on_mesh(sharded_world):
    """The dense layer round-trips on the (2, 1) mesh; the UNet split over
    ``model`` (its collectives traced as functional c10d collectives)
    round-trips on the (1, 2) mesh and equals the unsplit forward."""
    for r in sharded_world.ranks:
        torch.testing.assert_close(r["dense"], sharded_world.dense_ref, rtol=1e-6, atol=1e-6)
        assert r["tp_mesh"] == {"data": 1, "model": 2}
        torch.testing.assert_close(r["tp"], sharded_world.unet_ref, rtol=1e-5, atol=1e-5)


def test_cpu_exported_program_moves_with_load(stylize_case):
    """``load_fn`` moves a program to the device it is asked for: on the CPU
    it equals the eager call; moved to ``meta`` (the only other device
    here) every lifted constant follows and the custom op runs its fake
    implementation, so shapes come out right."""
    styl = _styl("dft_pallas")
    blob = export_fn(styl, (stylize_case.x, stylize_case.draws))
    torch.testing.assert_close(load_fn(blob, device="cpu")(stylize_case.x, stylize_case.draws),
                               styl(stylize_case.x, stylize_case.draws), rtol=1e-5, atol=1e-5)
    moved = load_fn(blob, device="meta")
    assert all(t.device.type == "meta" for t in moved.buffers())
    out = moved(stylize_case.x.to("meta"), stylize_case.draws.to("meta"))
    assert out.device.type == "meta" and out.shape == stylize_case.x.shape


def _op_case(name):
    """(fn, example args, the same args at another batch size, dynamic dims)
    of one custom op's wrapper, batch on dim 0."""
    g = torch.Generator().manual_seed(5)
    b = torch.export.Dim("b")
    if name == "fused_plane":
        cfg = StylizeConfig(disk_r=3.0, spike=True, spike_range=(9.0, 10.0),
                            fft_backend="plane")
        spatial = (8, 6, 4)

        def args(n):
            draws = sample_draws(cfg, spatial, n, 1, torch.Generator().manual_seed(n),
                                 device="cpu")
            flags, *params = fused_plane.plane_params(cfg, spatial, draws, n, 1, CPU)
            k = torch.randn(n, 5, 6, 4, generator=g)
            return (k, k * 0.5) + tuple(params)

        def fn(k_re, k_im, wparams, locs, vals, gates, conjs, scales):
            flags = fused_plane.plane_params(cfg, spatial, sample_draws(
                cfg, spatial, 1, 1, device="cpu"), 1, 1, CPU)[0]
            return fused_plane.plane_stylize_half(k_re, k_im, spatial, flags, wparams, locs,
                                                  vals, gates, conjs, scales)

        dims = ({0: b}, {0: b}, {0: b}, {1: b}, {1: b}, {1: b}, {1: b}, {1: b})
        return fn, args(2), args(3), dims
    if name == "axis_dft":
        def fn(x):
            re, im = pallas_dft.rdft_nd_pair(x, (1, 2, 3), "high")
            return pallas_dft.irdft_nd_real_pair(re, im, x.shape[1:], (1, 2, 3), "high")

        def args(n):
            return (torch.randn(n, 6, 5, 4, generator=g),)

        return fn, args(2), args(3), ({0: b},)
    if name == "sap":
        def args(n):
            return (torch.randn(n, 7, 5, generator=g), torch.tensor(0.3), torch.tensor(n))

        return (pallas_kernels.salt_and_pepper_pallas, args(2), args(3),
                ({0: b}, None, None))

    def args(n):
        return (torch.randn(n, 7, 5, generator=g), torch.randn(n, 7, 5, generator=g))

    return pallas_kernels.polar_roundtrip_pallas, args(2), args(3), ({0: b}, {0: b})


OP_NAMES = ("fused_plane", "axis_dft", "sap", "polar")


@pytest.mark.parametrize("name", OP_NAMES)
def test_custom_op_exports_on_the_cpu(name):
    """Each kernel's wrapper exports as its custom op and the program serves
    another batch size with the plain version's values; nothing counts a
    launch on the CPU. S&P's ``p`` and ``seed`` stay program inputs."""
    fn, ex, other, dims = _op_case(name)
    before = launch_counts()
    blob = export_fn(fn, ex, dynamic_shapes=dims)
    assert _op_names(blob) == {name}
    served = load_fn(blob, device="cpu")
    got, want = served(*other), fn(*other)
    for a, w in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
        torch.testing.assert_close(a, w, rtol=1e-6, atol=1e-6)
    if name == "sap":
        reseeded = served(other[0], other[1], other[2] + 1)
        assert torch.equal(reseeded, fn(other[0], other[1], other[2] + 1))
        assert not torch.equal(reseeded, got)
    assert launch_counts() == before


@pytest.mark.parametrize("name", OP_NAMES)
def test_fake_impls_keep_the_batch_symbolic(name):
    """Each op's fake implementation computes its outputs' shapes from its
    inputs' alone: in the exported graph the op's outputs lead with the
    symbolic batch, not a number."""
    import io

    fn, ex, _, dims = _op_case(name)
    ep = torch.export.load(io.BytesIO(export_fn(fn, ex, dynamic_shapes=dims)))
    nodes = [n for n in ep.graph.nodes if n.op == "call_function"
             and getattr(n.target, "name", lambda: "")().startswith(f"mvtb::{name}")]
    assert nodes
    for node in nodes:
        for val in torch.utils._pytree.tree_leaves(node.meta["val"]):
            assert isinstance(val.shape[0], torch.SymInt), (name, val.shape)
