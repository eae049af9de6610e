"""Multi-process start-up and per-process data (counterpart of
mvtb_tpu/parallel/distributed.py).

Every process calls :func:`initialize` with the coordinator's address and
its rank (or the ``MVTB_COORDINATOR`` / ``MVTB_NUM_PROCESSES`` /
``MVTB_PROCESS_ID`` environment variables), which starts the
``torch.distributed`` process group. Each process then loads only its own
rows of every global batch (:func:`process_local_indices`) and holds them
as its data shard (:func:`global_batch`): no process materialises the full
batch. A process holds one device, so a process is a rank of the mesh.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from mvtb_tpu_torch._device import DeviceLike
from mvtb_tpu_torch.parallel.mesh import Mesh, backend_for, make_mesh, process_device


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: DeviceLike = None) -> None:
    """Start the process group (idempotent; arguments fall back to the
    ``MVTB_*`` environment variables).

    ``coordinator_address`` is ``host:port`` of rank 0, reached as
    ``tcp://host:port``. With fewer than 2 processes this is a no-op, so a
    single-process entry point can call it unconditionally. ``device=None``
    means the card and raises without one; the backend is NCCL there and
    gloo only for ``device="cpu"``. On the card each process takes device
    ``process_id`` modulo the visible count."""
    dev = process_device(device)
    coordinator_address = coordinator_address or os.environ.get("MVTB_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("MVTB_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("MVTB_PROCESS_ID", "0"))
    if num_processes < 2 or coordinator_address is None or dist.is_initialized():
        return
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend_for(dev),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def process_local_indices(global_batch_size: int,
                          process_index: Optional[int] = None,
                          process_count: Optional[int] = None) -> Tuple[int, int]:
    """``[start, stop)`` of the global batch this process loads. The batch
    must divide the process count."""
    started = dist.is_initialized()
    pi = (dist.get_rank() if started else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if started else 1) if process_count is None else process_count
    if global_batch_size % pc:
        raise ValueError(f"global batch {global_batch_size} must divide "
                         f"process count {pc}")
    per = global_batch_size // pc
    return pi * per, (pi + 1) * per


def global_batch(mesh: Mesh, local_batch, axis_name: str = "data") -> torch.Tensor:
    """This process's rows (from :func:`process_local_indices`) as its shard
    of the global batch over ``axis_name``: a tensor on the mesh's device.
    The steps that take a mesh read it as the global batch split over
    ``data``."""
    del axis_name  # a process holds exactly its rows: nothing to place
    t = local_batch if isinstance(local_batch, torch.Tensor) else torch.as_tensor(local_batch)
    return t.contiguous().to(mesh.device)


def distributed_mesh(n_model: int = 1, device: DeviceLike = None) -> Mesh:
    """The ``(data, model)`` mesh over every process, data-major."""
    return make_mesh(None, n_model, device)
