"""Tensor (model) parallelism: convolutions split on their output channels
over the mesh's ``model`` axis (counterpart of mvtb_tpu/parallel/tp.py).

In JAX this is a placement rule only: GSPMD partitions every convolution
of the jitted step and inserts the collectives itself. The port does both
halves. :func:`shard_params_tp` keeps this rank's output channels of each
convolution whose count divides the axis, and hooks the convolution so that
its input enters through :func:`~.collectives.copy_to_group` (the input's
gradient, partial per rank, is summed over ``model``) and its output leaves
through :func:`~.collectives.gather_from_group` (the full channels
gathered; the gradient's own block taken). Everything between two split
convolutions is then the same computation on every model rank.

Output channels sit at dim 0 of a ``Conv`` weight ``(Cout, Cin, k, k, k)``
but at dim 1 of a ``ConvTranspose`` weight ``(Cin, Cout, k, k, k)``; flax
keeps them on the trailing axis of both.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.distributed as dist

from mvtb_tpu_torch.models.unet3d import Conv, ConvTranspose
from mvtb_tpu_torch.parallel.collectives import copy_to_group, gather_from_group
from mvtb_tpu_torch.parallel.mesh import Mesh, NamedSharding, replicated


def tp_param_sharding(mesh: Mesh, param: torch.Tensor, axis_name: str = "model",
                      out_dim: int = 0) -> NamedSharding:
    """Placement of one parameter: its output-channel dim ``out_dim`` split
    over ``axis_name`` when it divides evenly; replicated otherwise (PReLU
    slopes, scalars, channel counts that do not divide)."""
    n = mesh.size(axis_name)
    if n > 1 and param.ndim > out_dim and param.shape[out_dim] % n == 0 \
            and param.shape[out_dim] >= n:
        spec = [None] * param.ndim
        spec[out_dim] = axis_name
        return NamedSharding(mesh, tuple(spec))
    return replicated(mesh)


def _out_dims(module: torch.nn.Module) -> Dict[str, int]:
    return {"weight": 1 if isinstance(module, ConvTranspose) else 0, "bias": 0}


def _enter(group, module, args):
    return (copy_to_group(args[0], group),) + tuple(args[1:])


def _leave(group, module, args, out):
    return gather_from_group(out, 1, group)


@torch.no_grad()
def shard_params_tp(mesh: Mesh, model: torch.nn.Module,
                    axis_name: str = "model") -> torch.nn.Module:
    """Split ``model``'s convolutions over ``axis_name`` in place: each
    split parameter keeps this rank's block (the same ``Parameter`` object,
    so an optimizer built on it stays valid), and ``module.tp_split`` maps
    its name to the split dim. Returns ``model``."""
    group = mesh.group(axis_name)
    for module in model.modules():
        if not isinstance(module, (Conv, ConvTranspose)) or hasattr(module, "tp_split"):
            continue
        split = {}
        for name, out_dim in _out_dims(module).items():
            p = getattr(module, name)
            sharding = tp_param_sharding(mesh, p, axis_name, out_dim)
            if sharding.spec:
                p.data = sharding.local(p.data)
                split[name] = out_dim
        if split:
            module.tp_split = split
            module.register_forward_pre_hook(functools.partial(_enter, group))
            module.register_forward_hook(functools.partial(_leave, group))
    return model


@torch.no_grad()
def shard_state_tp(mesh: Mesh, state, axis_name: str = "model"):
    """Tensor-split a train state in place: the model as
    :func:`shard_params_tp`, and each optimizer moment of a split parameter
    cut to the same block. Returns ``state``."""
    full = {id(p): p.shape for p in state.model.parameters()}
    shard_params_tp(mesh, state.model, axis_name)
    n = mesh.size(axis_name)
    for module in state.model.modules():
        for name, dim in getattr(module, "tp_split", {}).items():
            p = getattr(module, name)
            for key, v in state.optimizer.state.get(p, {}).items():
                if isinstance(v, torch.Tensor) and v.shape == full[id(p)]:
                    per = v.shape[dim] // n
                    state.optimizer.state[p][key] = v.narrow(
                        dim, mesh.rank(axis_name) * per, per).clone()
    return state


@torch.no_grad()
def gather_params_tp(mesh: Mesh, model: torch.nn.Module,
                     axis_name: str = "model") -> Dict[str, torch.Tensor]:
    """The full parameters of a split model, as a ``state_dict``-style map
    (the split ones gathered over ``axis_name``)."""
    group = mesh.group(axis_name)
    out = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for mname, module in model.named_modules():
        for name, dim in getattr(module, "tp_split", {}).items():
            p = getattr(module, name).detach().contiguous()
            parts = [torch.empty_like(p) for _ in range(mesh.size(axis_name))]
            dist.all_gather(parts, p, group=group)
            out[f"{mname}.{name}" if mname else name] = torch.cat(parts, dim=dim)
    return out
