"""Mesh construction and batch sharding helpers."""

from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def distributed_init(coordinator: Optional[str] = None, num_processes: Optional[int] = None, process_id: Optional[int] = None) -> None:
    """Join a multi-process runtime; a no-op for one process.

    Nothing is auto-detected: a multi-process run passes the coordinator
    address (e.g. ``localhost:<port>``), the process count and this
    process's id explicitly. This is the counterpart of the reference's
    absent NCCL/MPI layer (SURVEY.md §2.3).
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator, num_processes, process_id)


def data_mesh(n_devices: Optional[int] = None, axis_name: str = "dp") -> Mesh:
    """A 1-D data mesh over the first n (default: all) local devices."""
    devices = jax.devices()
    n = n_devices or len(devices)
    return jax.make_mesh((n,), (axis_name,), devices=devices[:n])


def shard_batch(tree, mesh: Mesh, axis_name: str = "dp"):
    """Place a pytree of batched arrays with the leading axis sharded over
    the mesh's data axis (host->device transfer happens once, sharded)."""
    sharding = NamedSharding(mesh, P(axis_name))

    def put(x):
        return jax.device_put(x, sharding)

    return jax.tree_util.tree_map(put, tree)


def replicate(tree, mesh: Mesh):
    """Place a pytree fully replicated over the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), tree)
