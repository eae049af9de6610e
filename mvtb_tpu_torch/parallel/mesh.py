"""The ``(data, model)`` process mesh and its placement rules (counterpart of
mvtb_tpu/parallel/mesh.py).

JAX runs one program over many devices and places arrays on them with a
``NamedSharding``; PyTorch runs one process per device. So a mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` over the process group's
ranks, and a sharding is a rule that tells a process which block of a
global array it holds: :meth:`NamedSharding.local` cuts that block. The
JAX tests' virtual devices in one process become processes.

The ``"model"`` axis is the inner one, so model ranks are adjacent (rank
``d * n_model + m``), as in JAX. A process group must be initialized first
(:func:`~.distributed.initialize`, or the caller's own
``init_process_group``); with none, :func:`make_mesh` starts a world of one
on an in-process store, so a single process gets a ``(1, 1)`` mesh. The
backend follows the device: NCCL on the card, gloo only for
``device="cpu"``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from mvtb_tpu_torch._device import DeviceLike, resolve_device

AXES = ("data", "model")


def backend_for(device: torch.device) -> str:
    """The process-group backend of a device: NCCL on the card, gloo on the
    CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def process_device(device: DeviceLike = None) -> torch.device:
    """This process's device: ``None`` means the card (raising without
    one); a bare ``"cuda"`` means the current CUDA device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` mesh of processes, each holding ``device``.

    ``shape`` maps an axis name to its size, as JAX's ``Mesh.shape``;
    :meth:`group`, :meth:`rank` and :meth:`size` give this process's
    sub-group along an axis, its place in it, and its size."""

    device_mesh: DeviceMesh
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {name: self.device_mesh.size(i) for i, name in enumerate(AXES)}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def rank(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device: DeviceLike = None) -> Mesh:
    """Build a ``(data, model)`` mesh over the process group's ranks.

    ``n_data=None`` puts every rank (over ``n_model``) on the data axis.
    Raises ``ValueError`` when ``n_data * n_model`` exceeds the world size.
    ``device=None`` means the card; without a process group a world of one
    is started with the device's backend."""
    dev = process_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend_for(dev), store=dist.HashStore(),
                                world_size=1, rank=0)
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    need = n_data * n_model
    if need < 1 or need > world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {need} processes, "
                         f"have {world}")
    grid = torch.arange(need).view(n_data, n_model)
    return Mesh(DeviceMesh(dev.type, grid, mesh_dim_names=AXES), dev)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Placement of an array over a mesh: ``spec[i]`` names the mesh axis
    that splits dim ``i`` into equal blocks, or is None (replicated), as
    JAX's ``PartitionSpec``."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()

    def local(self, array) -> torch.Tensor:
        """This process's block of the global ``array`` (a numpy array or
        tensor), on the mesh's device. A split dim must divide its axis."""
        return self.block(array).to(self.mesh.device)

    def block(self, array) -> torch.Tensor:
        """This process's block of ``array``, where the array lies."""
        t = array if isinstance(array, torch.Tensor) else torch.as_tensor(np.asarray(array))
        for dim, axis in enumerate(self.spec):
            if axis is None:
                continue
            n, r = self.mesh.size(axis), self.mesh.rank(axis)
            if t.shape[dim] % n:
                raise ValueError(f"dim {dim} of size {t.shape[dim]} does not "
                                 f"divide the {axis!r} axis of size {n}")
            per = t.shape[dim] // n
            t = t.narrow(dim, r * per, per)
        return t.contiguous()


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def batch_sharding(mesh: Mesh, ndim: int = 1) -> NamedSharding:
    """Split the leading (batch) axis over ``data``; the rest replicated."""
    return NamedSharding(mesh, ("data",) + (None,) * (ndim - 1))


def shard_batch(mesh: Mesh, *arrays):
    """This process's rows of each global host array, on its device."""
    out = tuple(batch_sharding(mesh, np.ndim(a)).local(a) for a in arrays)
    return out if len(out) > 1 else out[0]


def _tensors(obj: Any) -> Iterator[torch.Tensor]:
    """Every tensor of a module (parameters, buffers), an optimizer (its
    state), a dataclass, or a nested dict, list or tuple of them."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, torch.nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()
    elif isinstance(obj, torch.optim.Optimizer):
        for group in obj.param_groups:
            for p in group["params"]:
                yield from _tensors(obj.state.get(p, {}))
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


@torch.no_grad()
def replicate(mesh: Mesh, obj: Any) -> Any:
    """A copy of ``obj`` (a module, a tensor, a train state, or a nested
    container of them) whose every tensor holds rank 0's values on every
    process, on the mesh's device.

    The copy is a ``deepcopy``, so a state's optimizer keeps pointing at its
    own model's parameters, and nothing aliases ``obj``: a step that updates
    the replica in place leaves the original as it was (the JAX function
    copies for the same reason, its steps donate their state)."""
    out = copy.deepcopy(obj)
    seen = set()
    for t in _tensors(out):
        if id(t) in seen:
            continue
        seen.add(id(t))
        if t.device != mesh.device:
            t.data = t.data.to(mesh.device)
        dist.broadcast(t.data, src=0)
    return out
