"""Data parallelism for the train steps: the pieces the steps share.

JAX gets data parallelism by running a step under ``jax.set_mesh`` with
batch-sharded inputs; GSPMD then sums the gradients itself. The port's
steps take ``mesh=`` instead (``train/seg.py:seg_train_step``,
``train/gan.py:dcgan_step``, ``train/learnable.py:learnable_train_step``)
and call these: each rank holds its rows of the global batch, the random
draws are the global batch's (the same on every rank) cut to its rows, the
gradients are averaged over ``data`` before the optimizer, and the
reported loss is the global mean. With equal shards the mean of the
per-rank means is the global mean, so a step over N ranks is the
one-device step over the whole batch.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist

from mvtb_tpu_torch.parallel.mesh import Mesh


def data_rows(mesh: Mesh, n_local: int) -> slice:
    """This rank's rows of the global batch (``n_local`` rows a rank)."""
    r = mesh.rank("data")
    return slice(r * n_local, (r + 1) * n_local)


def global_batch_size(mesh: Mesh, n_local: int) -> int:
    return n_local * mesh.size("data")


@torch.no_grad()
def all_reduce_gradients(params: Iterable[torch.nn.Parameter], group,
                         divisor: int = 1) -> None:
    """Sum every parameter's ``.grad`` over ``group`` (then divide by
    ``divisor``), in place: one all-reduce of the gradients laid end to
    end. A group of one runs it too; it is the identity there."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    if divisor != 1:
        flat.div_(divisor)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def mean_gradients(params: Iterable[torch.nn.Parameter], mesh: Mesh) -> None:
    """Average the gradients over the ``data`` axis (the steps' ``mesh=``)."""
    all_reduce_gradients(params, mesh.group("data"), mesh.size("data"))


@torch.no_grad()
def global_mean(value: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean over the ``data`` axis of a per-rank mean (detached)."""
    out = value.detach().clone()
    dist.all_reduce(out, group=mesh.group("data"))
    return out / mesh.size("data")
