"""Rank processes of the port's multi-process tests, and the launcher the
test files share. Imports no JAX: the parent computes the JAX references
and hands the ranks numpy inputs through a ``torch.save`` file.

``World(job, world, data, tmp)`` starts ``world`` processes of this
script on gloo (a ``file://`` store in ``tmp``, so concurrent test files
never meet), each running ``JOBS[job](rank, world, data)``, and returns the
ranks' results in rank order. ``init="env"`` starts the group only through
``MVTB_COORDINATOR`` / ``MVTB_NUM_PROCESSES`` / ``MVTB_PROCESS_ID``
(``parallel.distributed.initialize``); ``init="none"`` starts none, so the
job's ``make_mesh`` starts a world of one itself.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent
JOBS = {}


def job(fn):
    JOBS[fn.__name__] = fn
    return fn


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    """``world`` rank processes of job ``name``, started on construction;
    :meth:`results` waits for them (so a test can compute its references
    meanwhile) and returns each rank's result, raising with a rank's output
    if it failed."""

    def __init__(self, name: str, world: int, data, tmp: Path, init: str = "file",
                 timeout: float = 240.0):
        tmp.mkdir(parents=True, exist_ok=True)
        self.name, self.world, self.tmp, self.timeout = name, world, tmp, timeout
        inp = tmp / f"{name}.in.pt"
        torch.save(data, inp)
        port = free_port()
        self.procs = []
        for rank in range(world):
            env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
            if init == "env":
                env.update(MVTB_COORDINATOR=f"127.0.0.1:{port}",
                           MVTB_NUM_PROCESSES=str(world), MVTB_PROCESS_ID=str(rank))
            how = f"file://{tmp / (name + '.store')}" if init == "file" else init
            self.procs.append(subprocess.Popen(
                [sys.executable, __file__, name, str(rank), str(world), how, str(inp),
                 str(tmp / f"{name}.out")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    def results(self):
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=self.timeout)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, (p, log) in enumerate(zip(self.procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"{self.name} rank {rank} exited {p.returncode}:\n{log}")
        self.logs = logs
        return [torch.load(f"{self.tmp / self.name}.out.{r}", weights_only=False)
                for r in range(self.world)]


def run_world(name: str, world: int, data, tmp: Path, init: str = "file"):
    return World(name, world, data, tmp, init).results()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a)).clone()


def _full_params(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


class Recording(torch.optim.Optimizer):
    """An optimizer that keeps the gradients it is handed and moves nothing."""

    def __init__(self, params):
        super().__init__(params, {})

    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["grad"] = p.grad.clone()


def _grads(model, optimizer) -> dict:
    return {k: optimizer.state[p]["grad"] for k, p in model.named_parameters()}


# --------------------------------------------------------------------------
# mesh and placement
# --------------------------------------------------------------------------

@job
def mesh_world(rank, world, data):
    from mvtb_tpu_torch.parallel import NamedSharding, batch_sharding, make_mesh, shard_batch

    out = {"default": make_mesh(device="cpu").shape}
    if world >= 4:
        m = make_mesh(n_data=world // 2, n_model=2, device="cpu")
        out["dm"] = m.shape
        out["dm_ranks"] = (m.rank("data"), m.rank("model"))
        try:
            make_mesh(n_data=2 * world, n_model=2, device="cpu")
            out["too_big"] = None
        except ValueError as e:
            out["too_big"] = str(e)
    mesh = make_mesh(device="cpu")
    sh = batch_sharding(mesh, ndim=5)
    out["spec"] = sh.spec
    x = np.arange(world * 2 * 3, dtype=np.float32).reshape(world * 2, 3)
    out["rows"] = shard_batch(mesh, x)
    out["rows_pair"] = shard_batch(mesh, x, x[:, :1])
    out["cols"] = NamedSharding(mesh, (None, "data")).local(np.zeros((2, world * 3)))
    return out


# --------------------------------------------------------------------------
# data parallelism
# --------------------------------------------------------------------------

def _seg_state(data, key="state", optimizer=None):
    from mvtb_tpu_torch.models import UNet
    from mvtb_tpu_torch.train import create_seg_state

    model = UNet(4, 3, data["channels"], data["strides"], num_res_units=1, device="cpu")
    model.load_state_dict({k: _t(v) for k, v in data[key].items()})
    opt = None if optimizer is None else optimizer(model.parameters())
    return create_seg_state(model, opt, device="cpu")


@job
def dp_world(rank, world, data):
    from mvtb_tpu_torch.data.prefetch import device_prefetch
    from mvtb_tpu_torch.ops.fused import StageDraws, StylizeConfig
    from mvtb_tpu_torch.parallel import (batch_sharding, make_mesh, replicate, replicated,
                                         shard_batch)
    from mvtb_tpu_torch.train import seg_train_step

    mesh = make_mesh(device="cpu")
    out = {}
    image, label = shard_batch(mesh, data["image"], data["label"])
    state = replicate(mesh, _seg_state(data))
    out["loss"] = float(seg_train_step(state, image, label, device="cpu", mesh=mesh))
    out["params"] = _full_params(state.model)

    state = replicate(mesh, _seg_state(data))
    draws = StageDraws(**{k: _t(v) for k, v in data["draws"].items()})
    cfg = StylizeConfig(**data["stylize"])
    out["styl_loss"] = float(seg_train_step(state, image, label, cfg, draws=draws,
                                            device="cpu", mesh=mesh))
    out["styl_params"] = _full_params(state.model)

    # replicate: rank 0's values everywhere, copies rather than aliases
    torch.manual_seed(100 + rank)
    own = _seg_state(data)
    with torch.no_grad():
        for p in own.model.parameters():
            p.add_(torch.randn_like(p))
    before = _full_params(own.model)
    rep = replicate(mesh, own)
    out["replica"] = _full_params(rep.model)
    seg_train_step(rep, image, label, device="cpu", mesh=mesh)
    out["original_kept"] = all(torch.equal(before[k], v)
                               for k, v in _full_params(own.model).items())
    out["replica_opt_bound"] = all(p in rep.optimizer.state for p in rep.model.parameters())
    out["replicated_tensor"] = replicate(mesh, torch.full((3,), float(rank)))

    # device_prefetch with a batch sharding: each leaf is this rank's rows
    batches = [(data["image"][i:i + 2 * world], {"l": data["label"][i:i + 2 * world]})
               for i in (0, 2 * world)]
    got = list(device_prefetch(iter(batches), size=2, device="cpu",
                               sharding=batch_sharding(mesh, 5)))
    out["prefetch"] = [(a, b["l"]) for a, b in got]
    out["prefetch_replicated"] = list(device_prefetch(iter([data["label"][:1]]), device="cpu",
                                                      sharding=replicated(mesh)))
    out.update(_dcgan(mesh, rank, world, data))
    out.update(_learnable(mesh, rank, world, data))
    return out


def _dcgan(mesh, rank, world, data):
    """One DCGAN step over the whole batch in one process, and the same
    step split over the ranks. The optimizers record the gradients they
    are handed (Adam's first step, lr * sign(g), would turn rounding noise
    on a near-zero gradient into a full step)."""
    from mvtb_tpu_torch.models import Discriminator, Generator
    from mvtb_tpu_torch.parallel import replicate
    from mvtb_tpu_torch.parallel.dp import data_rows
    from mvtb_tpu_torch.train import GANState, dcgan_step

    def create_gan_state(model):
        model.train()
        return GANState(model, Recording(model.parameters()))

    gen = torch.Generator().manual_seed(11)
    g0 = Generator(16, 4, 1, device="cpu", generator=gen)
    d0 = Discriminator(1, 4, device="cpu", generator=gen)
    real = torch.rand(4, 1, 128, 128, generator=gen) * 2 - 1
    z = torch.randn(4, 16, 1, 1, generator=gen)
    out = {}
    for tag, m in (("one", None), ("dp", mesh)):
        g, d = create_gan_state(replicate(mesh, g0)), create_gan_state(replicate(mesh, d0))
        rows = slice(None) if m is None else data_rows(mesh, 4 // world)
        res = dcgan_step(g, d, real[rows], z[rows], mesh=m)
        out[f"gan_{tag}"] = {k: float(v) for k, v in res.items()}
        out[f"gan_{tag}_grads"] = {f"{net}.{k}": v for net, st in (("g", g), ("d", d))
                                   for k, v in _grads(st.model, st.optimizer).items()}
        out[f"gan_{tag}_stats"] = {
            f"{net}.{k}": v.clone()
            for net, st in (("g", g), ("d", d)) for k, v in st.model.named_buffers()}
    return out


def _learnable(mesh, rank, world, data):
    """One joint learnable step (Gibbs and spike layers) over the whole batch
    in one process, and split over the ranks."""
    from mvtb_tpu_torch.models import GibbsUNet, SpikesUNet
    from mvtb_tpu_torch.parallel import replicate
    from mvtb_tpu_torch.parallel.dp import data_rows
    from mvtb_tpu_torch.train import create_learnable_state, learnable_train_step

    tiny = dict(out_channels=3, channels=(4, 8), strides=(2,), num_res_units=1,
                in_channels=4, device="cpu")
    image, label = _t(data["image"]), _t(data["label"])
    out = {}
    for kind, make in (("gibbs", lambda: GibbsUNet(alpha_init=0.7, **tiny)),
                       ("spikes", lambda: SpikesUNet(intensity=11.0, **tiny))):
        torch.manual_seed(21)
        base = make()
        for tag, m in (("one", None), ("dp", mesh)):
            state = create_learnable_state(replicate(mesh, base), device="cpu")
            rows = slice(None) if m is None else data_rows(mesh, image.shape[0] // world)
            loss, alpha = learnable_train_step(
                state, image[rows], label[rows], generator=torch.Generator().manual_seed(5),
                device="cpu", mesh=m)
            out[f"{kind}_{tag}"] = (float(loss), float(alpha))
            out[f"{kind}_{tag}_params"] = _full_params(state.model)
    return out


# --------------------------------------------------------------------------
# tensor parallelism
# --------------------------------------------------------------------------

@job
def tp_world(rank, world, data):
    from mvtb_tpu_torch.parallel import (gather_params_tp, make_mesh, replicate, shard_batch,
                                         shard_state_tp, tp_param_sharding)
    from mvtb_tpu_torch.train import seg_train_step

    mesh = make_mesh(n_data=world // 2, n_model=2, device="cpu")
    state = shard_state_tp(mesh, replicate(mesh, _seg_state(data)))
    split = {}
    for name, module in state.model.named_modules():
        for pname, dim in getattr(module, "tp_split", {}).items():
            split[f"{name}.{pname}"] = (type(module).__name__, dim,
                                        tuple(getattr(module, pname).shape))
    image, label = shard_batch(mesh, data["image"], data["label"])
    loss = float(seg_train_step(state, image, label, device="cpu", mesh=mesh))
    prelu = state.model.ResidualUnit_0.ConvNormAct_0.PReLU_0.weight

    # moments that exist when the state is split get the parameters' blocks
    moved = replicate(mesh, _seg_state(data))
    seg_train_step(moved, image, label, device="cpu")
    full = {n: {k: v.clone() for k, v in moved.optimizer.state[p].items()
                if isinstance(v, torch.Tensor)} for n, p in moved.model.named_parameters()}
    shard_state_tp(mesh, moved)
    m = mesh.rank("model")
    sliced = []
    for name, module in moved.model.named_modules():
        for pname, dim in getattr(module, "tp_split", {}).items():
            p = getattr(module, pname)
            for k, v in moved.optimizer.state[p].items():
                if isinstance(v, torch.Tensor):
                    ref = full[f"{name}.{pname}"][k]
                    per = ref.shape[dim] // 2
                    sliced.append(torch.equal(v, ref.narrow(dim, m * per, per)))
    return {"loss": loss, "split": split, "params": gather_params_tp(mesh, state.model),
            "prelu_spec": tp_param_sharding(mesh, prelu).spec,
            "ct_spec": tp_param_sharding(mesh, torch.zeros(8, 4, 3, 3, 3), out_dim=1).spec,
            "moments_sliced": sliced}


@job
def tp_ndhwc_world(rank, world, data):
    """A float64 UNet split ``world`` ways on ``model``, through its
    channels-last forward and backward: the logits, the input's gradient,
    every parameter's full gradient (the split ones gathered) and each split
    parameter's (shape, dim)."""
    from mvtb_tpu_torch.models import UNet
    from mvtb_tpu_torch.parallel import make_mesh, shard_params_tp

    mesh = make_mesh(n_data=1, n_model=world, device="cpu")
    model = UNet(4, 3, data["channels"], data["strides"], device="cpu", dtype=torch.float64)
    model.load_state_dict(data["state"])
    shard_params_tp(mesh, model)
    x = data["x"].clone().requires_grad_(True)
    y = model._forward_ndhwc(x)
    (y * data["r"]).sum().backward()
    grads, split = {}, {}
    for mname, module in model.named_modules():
        dims = getattr(module, "tp_split", {})
        for pname, p in module.named_parameters(recurse=False):
            g, key = p.grad.contiguous(), f"{mname}.{pname}"
            if pname in dims:
                split[key] = (tuple(p.shape), dims[pname])
                parts = [torch.empty_like(g) for _ in range(world)]
                dist.all_gather(parts, g, group=mesh.group("model"))
                g = torch.cat(parts, dim=dims[pname])
            grads[key] = g
    return {"logits": y.detach(), "x_grad": x.grad, "grads": grads, "split": split}


# --------------------------------------------------------------------------
# the H-split k-space stylization
# --------------------------------------------------------------------------

def _stage_draws(d):
    from mvtb_tpu_torch.ops.fused import StageDraws

    return StageDraws(**{k: _t(v) for k, v in d.items()})


@job
def sharded_fft_world(rank, world, data):
    """Each case's H block from ``stylize_kspace_sharded``, and (rank 0) the
    one-device ``stylize_kspace`` of the whole volume on the same draws."""
    from mvtb_tpu_torch.ops.fused import StylizeConfig, stylize_kspace
    from mvtb_tpu_torch.parallel import make_mesh
    from mvtb_tpu_torch.parallel.sharded_fft import stylize_kspace_sharded

    mesh = make_mesh(device="cpu")
    out = {}
    for name, case in data["cases"].items():
        cfg, x = StylizeConfig(**case["cfg"]), _t(case["x"])
        draws = _stage_draws(case["draws"])
        h = x.shape[1] // world
        out[name] = {"block": stylize_kspace_sharded(x[:, rank * h:(rank + 1) * h], cfg, mesh,
                                                     draws=draws)}
        if rank == 0:
            out[name]["one"] = stylize_kspace(x, cfg, draws=draws, device="cpu")
    errors = {}
    for name, (shape, cfg) in data["bad"].items():
        x = torch.zeros(shape)
        h = -(-shape[1] // world) if len(shape) == 4 else 1
        block = x[:, rank * h:(rank + 1) * h] if len(shape) == 4 else x
        try:
            stylize_kspace_sharded(block, StylizeConfig(**cfg), mesh)
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    return out


# --------------------------------------------------------------------------
# the H-split UNet step
# --------------------------------------------------------------------------

@job
def spatial_world(rank, world, data):
    """Each case's spatially split step and the one-device step from the
    same weights (the reference optimizer), and the halo exchange against
    slicing of the whole tensor."""
    from mvtb_tpu_torch.parallel import make_mesh, replicate
    from mvtb_tpu_torch.parallel.collectives import halo_exchange
    from mvtb_tpu_torch.parallel.spatial import spatial_train_step
    from mvtb_tpu_torch.train import seg_train_step

    mesh = make_mesh(device="cpu")
    out = {}
    for name, case in data["cases"].items():
        image, label = _t(case["image"]), _t(case["label"])
        h = image.shape[2] // world
        rows = slice(rank * h, (rank + 1) * h)
        state = replicate(mesh, _seg_state(case))
        loss = float(spatial_train_step(state, image[:, :, rows], label[:, :, rows], mesh,
                                        device="cpu"))
        out[name] = {"loss": loss, "params": _full_params(state.model)}
        # the gradients of both steps
        for tag, step in (("split", lambda st: spatial_train_step(
                st, image[:, :, rows], label[:, :, rows], mesh, device="cpu")),
                          ("one", lambda st: seg_train_step(st, image, label, device="cpu"))):
            st = _seg_state(case, optimizer=Recording)
            out[name][f"{tag}_loss"] = float(step(st))
            out[name][f"{tag}_grads"] = _grads(st.model, st.optimizer)

    # the halo exchange: rows of the neighbours (zeros past the ends), and
    # its backward: the adjoint of that gather, summed on each block
    full = torch.arange(2 * 3 * 4 * world, dtype=torch.float64).view(2, 3, 4 * world)
    cot = torch.randn(2, 3, 4 * world + 3 * world, generator=torch.Generator().manual_seed(0),
                      dtype=torch.float64)
    lo, hi = 1, 2

    def windows(t):  # every block with its halo, from the whole tensor
        padded = torch.nn.functional.pad(t, (lo, hi))
        return [padded[..., 4 * j:4 * j + 4 + lo + hi] for j in range(world)]

    whole = full.clone().requires_grad_(True)
    ref = windows(whole)
    torch.autograd.backward(ref, [cot[..., 7 * j:7 * j + 7] for j in range(world)])
    x = full[..., 4 * rank:4 * rank + 4].clone().requires_grad_(True)
    y = halo_exchange(x, 2, lo, hi, mesh.group("data"))
    y.backward(cot[..., 7 * rank:7 * rank + 7])
    out["halo"] = {"y": y.detach(), "ref": ref[rank].detach(), "grad": x.grad,
                   "ref_grad": whole.grad[..., 4 * rank:4 * rank + 4]}
    try:
        halo_exchange(x.detach(), 2, 5, 0, mesh.group("data"))
        out["halo_too_wide"] = None
    except ValueError as e:
        out["halo_too_wide"] = str(e)
    return out


# --------------------------------------------------------------------------
# sharded serving
# --------------------------------------------------------------------------

@job
def serve_world(rank, world, data):
    """Per-rank programs from ``export_sharded_fn``, reloaded and served:
    the UNet over ``data``, a dense layer over ``data``, and the UNet split
    over ``model``; each output gathered over the ranks."""
    from mvtb_tpu_torch.models import UNet
    from mvtb_tpu_torch.parallel import batch_sharding, make_mesh, replicate, shard_params_tp
    from mvtb_tpu_torch.serve import export_sharded_fn, load_fn, module_fn

    def gathered(t):
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)

    mesh = make_mesh(device="cpu")
    rows = batch_sharding(mesh, 5)
    model = UNet(4, 3, (4, 8), (2,), num_res_units=1, device="cpu")
    model.load_state_dict({k: _t(v) for k, v in data["state"].items()})
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    served = load_fn(export_sharded_fn(module_fn(model), (params, _t(data["x"])), mesh=mesh,
                                       in_shardings=(None, rows)), device="cpu")
    local = rows.local(_t(data["x"]))
    with torch.no_grad():
        out = served(params, local)
    res = {"unet": gathered(out), "unet_mesh": served.mesh_shape,
           "unet_local_shape": tuple(out.shape)}

    dense = {"kernel": _t(data["w"]), "bias": _t(data["b"])}
    xrows = batch_sharding(mesh, 3)
    served = load_fn(export_sharded_fn(lambda p, v: v @ p["kernel"] + p["bias"],
                                       (dense, _t(data["xd"])), mesh=mesh,
                                       in_shardings=(None, xrows)), device="cpu")
    res["dense"] = gathered(served(dense, xrows.local(_t(data["xd"]))))

    tp_mesh = make_mesh(n_data=1, n_model=world, device="cpu")
    tp_model = shard_params_tp(tp_mesh, replicate(tp_mesh, model))
    tp_params = {k: v.detach().clone() for k, v in tp_model.state_dict().items()}
    served = load_fn(export_sharded_fn(module_fn(tp_model), (tp_params, _t(data["x"])),
                                       mesh=tp_mesh, in_shardings=(None, None)), device="cpu")
    with torch.no_grad():
        res["tp"] = served(tp_params, _t(data["x"]))
    res["tp_mesh"] = served.mesh_shape
    return res


# --------------------------------------------------------------------------
# multi-process start-up
# --------------------------------------------------------------------------

@job
def env_world(rank, world, data):
    """A data-parallel step in a group started only from ``MVTB_*``: each
    process loads its rows of the global batch."""
    from mvtb_tpu_torch.models import UNet
    from mvtb_tpu_torch.parallel import (distributed_mesh, global_batch, initialize,
                                         process_local_indices, replicate)
    from mvtb_tpu_torch.train import create_seg_state, seg_train_step

    initialize(device="cpu")  # a second call is a no-op
    mesh = distributed_mesh(device="cpu")
    lo, hi = process_local_indices(len(data["image"]))
    image, label = global_batch(mesh, data["image"][lo:hi]), global_batch(mesh, data["label"][lo:hi])
    torch.manual_seed(0)
    model = UNet(4, 3, (4, 8), (2,), num_res_units=1, device="cpu")
    state = replicate(mesh, create_seg_state(model, device="cpu"))
    loss = float(seg_train_step(state, image, label, device="cpu", mesh=mesh))
    return {"loss": loss, "world": dist.get_world_size(), "backend": dist.get_backend(),
            "mesh": mesh.shape, "rows": (lo, hi), "local": tuple(image.shape)}


def main(argv) -> int:
    name, rank, world, init, inp, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    if init == "env":
        from mvtb_tpu_torch.parallel import initialize
        initialize(device="cpu")
    elif init != "none":
        dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    try:
        res = JOBS[name](rank, world, torch.load(inp, weights_only=False))
        torch.save(res, f"{out}.{rank}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
