"""Process mesh, multi-process start-up and the sharded paths (counterpart of
mvtb_tpu/parallel).

* :mod:`.mesh`: the ``(data, model)`` mesh over the process group and its
  placement rules; :mod:`.distributed`: start-up from ``MVTB_*`` and
  per-process data.
* :mod:`.dp`: what the train steps' ``mesh=`` argument runs (data
  parallelism); :mod:`.tp`: convolutions split over ``model``.
* :mod:`.sharded_fft`: the k-space stylization of one volume split over H;
  :mod:`.spatial`: the UNet train step on a volume split over H, with halo
  exchanges. Both are imported as submodules, as in the JAX package.
"""

from mvtb_tpu_torch.parallel.distributed import (distributed_mesh, global_batch,
                                                 initialize, process_local_indices)
from mvtb_tpu_torch.parallel.mesh import (Mesh, NamedSharding, batch_sharding, make_mesh,
                                          replicate, replicated, shard_batch)
from mvtb_tpu_torch.parallel.tp import (gather_params_tp, shard_params_tp, shard_state_tp,
                                        tp_param_sharding)

__all__ = ["Mesh", "NamedSharding", "batch_sharding", "distributed_mesh",
           "gather_params_tp", "global_batch", "initialize", "make_mesh",
           "process_local_indices", "replicate", "replicated", "shard_batch",
           "shard_params_tp", "shard_state_tp", "tp_param_sharding"]
