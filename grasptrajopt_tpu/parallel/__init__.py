"""Multi-device runtime: meshes, sharded batch solving, distributed init.

The reference is a single-process, single-thread program (SURVEY.md §2.3).
This subsystem is its from-scratch scale-out story: independent
(scene x grasp-set x seed) problems are a batch axis sharded over a
`jax.sharding.Mesh`; XLA collectives (psum/all_gather, NCCL on the GPU)
reduce metrics and gather results; `jax.distributed` extends the same
program to several processes.
"""

from grasptrajopt_tpu.parallel.mesh import (
    data_mesh,
    distributed_init,
    shard_batch,
)
from grasptrajopt_tpu.parallel.sharded import (
    make_sharded_solver,
    sharded_metric_reduce,
)
from grasptrajopt_tpu.parallel.streaming import PlanStream, stream_map

__all__ = [
    "data_mesh",
    "distributed_init",
    "shard_batch",
    "make_sharded_solver",
    "sharded_metric_reduce",
    "PlanStream",
    "stream_map",
]
