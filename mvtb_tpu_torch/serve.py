"""Ahead-of-time serving artifacts: ``torch.export`` programs and weight
bundles (counterpart of mvtb_tpu/serve.py).

The JAX package serializes a jitted function to StableHLO with
``jax.export``. The port's counterpart is ``torch.export``: a traced
program of ATen and custom operators that reloads and runs **without the
model's Python code**. Every hand-written kernel is a custom operator
(:mod:`mvtb_tpu_torch.ops._ops`), so a program that stylizes on ``plane``
or ``dft_pallas``, or runs salt & pepper and the polar round trip, keeps
its kernels: on the card it launches them, on the CPU it runs their plain
versions. Loading imports this module and ``ops._ops`` (which registers
the operators) and no model class.

Two layers, as in the JAX package:

* :func:`export_fn` / :func:`load_fn`: a function round trip, example
  arguments in (tensors, dicts, lists, :class:`~.ops.fused.StageDraws`),
  bytes out. The loaded program checks its inputs' shapes against the
  exported signature.
* :class:`ServingBundle`: a directory with ``program.pt2`` (the exported
  ``fn(params, *inputs)``), ``params.pt`` (the weights) and
  ``meta.json``. The weights are **inputs** of the program, not lifted
  constants, so the program file holds none and ``load(..., params=)``
  swaps them without a new export.

Devices. An artifact is valid for the device types of
:func:`default_platforms`. Constants captured while tracing (the DFT
matrices of ``ops.dft.device_mats``) are lifted on the export device;
:func:`load_fn` moves the program to the device it is asked for with
``torch.export.passes.move_to_device_pass``, so a program exported on the
CPU runs on the card and one exported on the card runs on the card or the
CPU. The kernels' own packed matrices are built inside the custom
operators, on the device they run on. ``device=None`` means the card, and
loading raises without one.

``torch.export`` has no counterpart of XLA's multi-platform lowering and
needs none: one program serves both device types.
"""

from __future__ import annotations

import io
import json
import os
import time
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.utils._pytree as pytree
from torch.export.passes import move_to_device_pass

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.ops import _ops  # noqa: F401  (registers the mvtb operators)

__all__ = ["ServingBundle", "default_platforms", "export_fn", "export_sharded_fn",
           "load_fn", "module_fn"]

_MESH_FILE = "mvtb_mesh.json"


def default_platforms() -> Sequence[str]:
    """Device types an artifact runs on: the CPU (plain versions of the
    kernels) and the card (the kernels), whichever device it was exported
    on."""
    return ("cpu", "cuda")


class _Fn(torch.nn.Module):
    """``fn`` as a module for ``torch.export``. ``fn`` is kept out of the
    module's attributes, so a module it closes over lends no parameter or
    buffer to the program: the weights come in as arguments."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.__dict__["_fn"] = fn

    def forward(self, *args):
        return self._fn(*args)


def module_fn(model: torch.nn.Module) -> Callable:
    """``fn(params, *inputs) = model(*inputs)`` with ``params`` (a flat
    ``{name: tensor}`` of the model's state, as ``state_dict`` gives it) in
    place of the model's own tensors, through ``torch.func.functional_call``:
    the ``fn`` a :class:`ServingBundle` exports for a model."""

    def fn(params: Dict[str, torch.Tensor], *inputs):
        return torch.func.functional_call(model, params, inputs)

    return fn


def _export(fn: Callable, example_args: tuple, dynamic_shapes=None):
    module = _Fn(fn)
    if isinstance(dynamic_shapes, torch.export.ShapesCollection):
        dynamic_shapes = dynamic_shapes.dynamic_shapes(module, tuple(example_args))
    elif dynamic_shapes is not None:  # one entry per argument of forward(*args)
        dynamic_shapes = (tuple(dynamic_shapes),)
    with torch.no_grad():
        return torch.export.export(module, tuple(example_args),
                                   dynamic_shapes=dynamic_shapes, strict=False)


def _save(ep, extra: Optional[dict] = None) -> bytes:
    # the example inputs would be saved beside the program (a full-size
    # batch and its draws); only their shapes and types matter, and those
    # are in the program's signature
    ep.example_inputs = None
    buf = io.BytesIO()
    files = {name: json.dumps(v) for name, v in (extra or {}).items()}
    torch.export.save(ep, buf, extra_files=files)
    return buf.getvalue()


def export_fn(fn: Callable, example_args: tuple, *, dynamic_shapes=None) -> bytes:
    """Serialize ``fn`` traced at ``example_args``' shapes and types.

    ``dynamic_shapes`` is ``torch.export``'s: a tuple with one entry per
    argument (None, or ``{dim: torch.export.Dim(...)}`` for a tensor), or a
    ``torch.export.ShapesCollection`` keyed by the example tensors; a
    symbolic dim serves any size (the counterpart of JAX's
    ``polymorphic_shapes``). The returned bytes are a self-contained
    ``torch.export`` archive."""
    return _save(_export(fn, example_args, dynamic_shapes))


def load_fn(blob: bytes, *, device: DeviceLike = None) -> Callable:
    """Inverse of :func:`export_fn` and :func:`export_sharded_fn`: bytes ->
    callable on ``device`` (None: the card). The callable checks its inputs
    against the exported signature and raises on a shape it was not
    exported for. A sharded artifact also checks that the process group
    has as many ranks as its mesh, and carries ``mesh_shape``."""
    dev = resolve_device(device)
    files = {_MESH_FILE: ""}
    ep = torch.export.load(io.BytesIO(blob), extra_files=files)
    ep = move_to_device_pass(ep, dev)
    call = ep.module()
    if files[_MESH_FILE]:
        import torch.distributed as dist

        mesh_shape = json.loads(files[_MESH_FILE])
        need = 1
        for n in mesh_shape.values():
            need *= n
        have = dist.get_world_size() if dist.is_initialized() else 1
        if have != need:
            raise RuntimeError(f"the program was exported for a mesh {mesh_shape} of "
                               f"{need} ranks; this process group has {have}")
        call.mesh_shape = mesh_shape
    return call


def export_sharded_fn(fn: Callable, example_args: tuple, *, mesh,
                      in_shardings: Sequence[Any]) -> bytes:
    """Serialize this rank's program of a sharded ``fn`` on ``mesh``.

    ``example_args`` are global values; ``in_shardings`` holds one
    :class:`~.parallel.mesh.NamedSharding` (or None: as given) per
    argument, applied to every tensor in it. The program is traced at this
    rank's blocks (``NamedSharding.block``), so every rank exports and
    serves its own shard; the artifact records the mesh shape, and
    :func:`load_fn` checks it against the process group.

    A forward split over ``model`` (a model after
    ``parallel.shard_params_tp``, its weights passed as this rank's blocks
    with a None sharding) exports too: ``torch.export`` records the
    collectives of ``parallel/collectives.py`` as functional c10d
    collectives bound to the mesh's process groups by name, so a process
    loads the program after building the same mesh."""
    if len(in_shardings) != len(example_args):
        raise ValueError("in_shardings needs one entry per argument")

    def block(sharding, arg):
        if sharding is None:
            return arg
        return pytree.tree_map_only(torch.Tensor, sharding.block, arg)

    local = tuple(block(s, a) for s, a in zip(in_shardings, example_args))
    return _save(_export(fn, local), {_MESH_FILE: mesh.shape})


def _batch_polymorphic(example_inputs: tuple):
    """``(inputs, dims)``: a symbolic ``b`` on the leading dim of every input
    tensor that shares the first input's leading size (the rest keep
    concrete shapes). ``torch.export`` fixes a dim whose example size is 1,
    so an example batch of 1 is traced at 2, each batched tensor repeated:
    only shapes and types enter the program."""
    lead = example_inputs[0].shape[0]

    def batched(t):
        return isinstance(t, torch.Tensor) and t.ndim >= 1 and t.shape[0] == lead

    if lead == 1:
        example_inputs = pytree.tree_map(
            lambda t: torch.cat([t, t]) if batched(t) else t, example_inputs)
        lead = 2
    b = torch.export.Dim("b")
    dims = torch.export.ShapesCollection()
    for t in pytree.tree_leaves(example_inputs):
        if batched(t):
            dims[t] = {0: b}
    return example_inputs, dims


def _describe(x) -> dict:
    if isinstance(x, torch.Tensor):
        return {"shape": list(x.shape), "dtype": str(x.dtype).replace("torch.", "")}
    leaves, _ = pytree.tree_flatten_with_path(x)
    return {"type": type(x).__name__,
            "leaves": {pytree.keystr(p): _describe(v) for p, v in leaves
                       if isinstance(v, torch.Tensor)}}


class ServingBundle:
    """Directory artifact: exported program + weights + metadata.

    ``save`` exports ``fn(params, *inputs)`` (``params`` a flat ``{name:
    tensor}``; :func:`module_fn` makes ``fn`` for a model) and writes::

        <path>/program.pt2   the torch.export archive
        <path>/params.pt     the weights (torch.save of the flat dict)
        <path>/meta.json     input shapes and types, the weights' names,
                             batch_polymorphic, device types, torch
                             version, the export's seconds, extras

    ``load`` needs no model code and returns ``serve(*inputs)``; the
    weights hot-swap with ``load(..., params=)``.
    """

    PROGRAM = "program.pt2"
    PARAMS = "params.pt"
    META = "meta.json"

    @classmethod
    def save(cls, path: str, fn: Callable, params: Dict[str, torch.Tensor],
             example_inputs: tuple, *, batch_polymorphic: bool = False,
             extra_meta: Optional[dict] = None) -> None:
        """``batch_polymorphic=True`` makes the leading dim of every input
        tensor that shares the first input's leading size one symbolic
        ``b`` (a :class:`~.ops.fused.StageDraws` of the batch included):
        one program serves any batch size. Side inputs with other leading
        sizes keep concrete shapes, as in the JAX package."""
        os.makedirs(path, exist_ok=True)
        params = dict(params)
        traced, dims = tuple(example_inputs), None
        if batch_polymorphic:
            traced, dims = _batch_polymorphic(traced)
        t0 = time.perf_counter()
        blob = export_fn(fn, (params,) + traced, dynamic_shapes=dims)
        export_s = time.perf_counter() - t0
        with open(os.path.join(path, cls.PROGRAM), "wb") as f:
            f.write(blob)
        torch.save({k: v.detach().cpu() for k, v in params.items()},
                   os.path.join(path, cls.PARAMS))
        first = pytree.tree_leaves(example_inputs)[0]
        meta = {
            "platforms": list(default_platforms()),
            "export_device": first.device.type,
            "batch_polymorphic": bool(batch_polymorphic),
            "inputs": [_describe(x) for x in example_inputs],
            "params": list(params),
            "torch": torch.__version__,
            "export_s": export_s,
            **(extra_meta or {}),
        }
        with open(os.path.join(path, cls.META), "w") as f:
            json.dump(meta, f, indent=1)

    @classmethod
    def load(cls, path: str, *, params: Optional[Dict[str, torch.Tensor]] = None,
             device: DeviceLike = None) -> Callable:
        """Return ``serve(*inputs)`` on ``device`` (None: the card). Pass
        ``params`` to serve other weights of the same architecture."""
        dev = resolve_device(device)
        with open(os.path.join(path, cls.PROGRAM), "rb") as f:
            call = load_fn(f.read(), device=dev)
        if params is None:
            params = torch.load(os.path.join(path, cls.PARAMS), map_location=dev,
                                weights_only=True)
        # the program's signature holds the weights' names in their order
        params = {k: params[k].to(dev) for k in cls.meta(path)["params"]}

        def serve(*inputs):
            return call(params, *inputs)

        serve.params = params  # type: ignore[attr-defined]
        return serve

    @classmethod
    def meta(cls, path: str) -> dict:
        with open(os.path.join(path, cls.META)) as f:
            return json.load(f)
