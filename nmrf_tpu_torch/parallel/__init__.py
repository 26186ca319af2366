"""Multi-process parallelism of the port (``nmrf_tpu/parallel``): the
(data, spatial) process grid, the H-sharded forward and the spatial
collectives over ``torch.distributed``, and the evaluation step and the
host-to-device prefetch of the training loop."""

from .mesh import (Mesh, device_prefetch, make_eval_step, make_mesh,
                   make_sharded_forward, shard_batch, spatial_sharded_apply,
                   sum_gradients)
from .spatial import spawn

__all__ = ["Mesh", "device_prefetch", "make_eval_step", "make_mesh",
           "make_sharded_forward", "shard_batch", "spatial_sharded_apply",
           "spawn", "sum_gradients"]
