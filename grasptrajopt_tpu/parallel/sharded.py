"""Sharded batch solving: one device program, batch axis over the mesh.

Pattern: a per-problem solve function (from opt/ or planning/) is vmapped
into a per-shard batch solve, then `jax.shard_map`-ped over the data axis.
Per-shard results stay device-resident; global metrics (mean cost,
convergence counts) are reduced with `psum` — the framework's
equivalent of the reference's absent collective layer (SURVEY.md §2.3).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


def make_sharded_solver(solve_one: Callable, mesh: Mesh, axis_name: str = "dp"):
    """Lift `solve_one(*args) -> pytree` to a mesh-sharded batch solver.

    All arguments must be batched on their leading axis (global batch B,
    divisible by the mesh size). Returns a jitted function producing
    sharded outputs plus a replicated metrics dict {mean_cost}.
    """
    batched = jax.vmap(solve_one)

    def shard_fn(*args):
        out = batched(*args)
        # psum-based global mean cost: out[1] is the per-problem cost by the
        # (Q, cost, aux) convention of the solvers
        cost = out[1]
        total = jax.lax.psum(jnp.sum(cost), axis_name)
        count = jax.lax.psum(cost.shape[0], axis_name)
        return out, {"mean_cost": total / count}

    mapped = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=P(axis_name),
        out_specs=(P(axis_name), P()),
        check_vma=False,
    )
    return jax.jit(mapped)


def sharded_metric_reduce(values, mesh: Mesh, axis_name: str = "dp"):
    """Global mean of a sharded (B,) metric array via psum."""

    def reduce_fn(v):
        total = jax.lax.psum(jnp.sum(v), axis_name)
        count = jax.lax.psum(v.shape[0], axis_name)
        return total / count

    return jax.jit(
        jax.shard_map(reduce_fn, mesh=mesh, in_specs=P(axis_name), out_specs=P(), check_vma=False)
    )(values)
