"""Micro-benchmarks of the trajectory solver's per-iteration components on
the GPU: FK, packed field gathers, residual pass, Jacobian pass,
block-tridiagonal solve. Needs the robot assets under GTO_DATA_DIR.
Component timings mis-attribute cost; confirm with a trace of the real
program (tools/trace_report.py)."""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

import jax
import jax.numpy as jnp

from grasptrajopt_tpu.ops import block_tridiag_solve
from grasptrajopt_tpu.planning.gto_models import GTORobotModel
from grasptrajopt_tpu.planning.utils import load_robot_config


def timeit(name, fn, *args, reps=5):
    out = fn(*args)
    jax.tree_util.tree_map(lambda x: x.block_until_ready() if hasattr(x, "block_until_ready") else x, out)
    best = 1e9
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.tree_util.tree_map(lambda x: x.block_until_ready() if hasattr(x, "block_until_ready") else x, out)
        best = min(best, time.perf_counter() - t0)
    print(f"{name:40s} {best*1e3:9.2f} ms")
    return best


def main():
    from grasptrajopt_tpu.utils.device import enable_compile_cache, require_gpu

    require_gpu()
    enable_compile_cache()
    B = int(os.environ.get("MB_BATCH", "32"))
    T = 50
    data_dir = os.environ.get("GTO_DATA_DIR", "/root/reference/data")
    cfg = load_robot_config("panda", data_dir)
    robot = GTORobotModel(
        model_dir=os.path.join(data_dir, "robots", "panda"),
        urdf_filename=os.path.join(data_dir, "robots/panda/panda.urdf"),
        time_derivs=[0, 1],
        param_joints=cfg["param_joints"],
        collision_link_names=cfg["collision_link_names"],
    )
    grid = robot.setup_workspace_field(cfg["arm_len"], cfg["arm_height"])
    n_opt = robot.num_opt_joints
    P = robot.num_surface_points
    print(f"device={jax.devices()[0]}  B={B} T={T} P={P} n={n_opt} field={grid.size}")

    rng = np.random.default_rng(0)
    Q = jnp.asarray(rng.uniform(-0.5, 0.5, size=(B, T, robot.ndof)), jnp.float32)
    field = jnp.asarray(rng.random(grid.size), jnp.float32)
    packed = grid.pack(field)
    packed2 = jnp.concatenate([packed, packed], axis=0)

    # 1. batched FK of all frames
    timeit("fk_all (B,T) frames", jax.jit(lambda q: robot.fk_all(q)), Q)

    # 2. surface points
    surf = jax.jit(lambda q: robot.fk_surface_points(q))
    pts = surf(Q)
    timeit("fk_surface_points (B,T,P,3)", surf, Q)

    # 3. packed gather lookup over all points
    look = jax.jit(lambda pp: grid.lookup_packed(packed2, pp))
    timeit("packed trilinear lookup", look, pts)

    # 4. residual-like pass: FK + lookup + sumsq
    def residual_pass(q):
        p = robot.fk_surface_points(q)
        v = grid.lookup_packed(packed2, p)
        return jnp.sum(v * v, axis=(-1, -2))

    timeit("residual pass (FK+lookup+reduce)", jax.jit(residual_pass), Q)

    # 5. per-step jacobian pass (jacfwd over n_opt)
    q_param = jnp.zeros((B, robot.num_param_joints), jnp.float32)

    def step_res(q_opt, qp):
        qf = robot.assemble_q(q_opt, qp)
        p = robot.fk_surface_points(qf)
        return grid.lookup_packed(packed2, p)

    def jac_pass(Qopt, qp):
        def one(q_opt, qpp):
            def f(qq):
                r = step_res(qq, qpp)
                return r, r

            J, r = jax.jacfwd(f, has_aux=True)(q_opt)
            return r, J

        return jax.vmap(jax.vmap(one, in_axes=(0, None)))(Qopt, qp)

    Qopt = Q[..., jnp.asarray(robot.optimized_joint_indexes)]
    timeit("jacobian pass (jacfwd per step)", jax.jit(jac_pass), Qopt, q_param[:, 0:2])

    # 6. block tridiagonal solve
    D = jnp.tile(jnp.eye(n_opt, dtype=jnp.float32)[None, None] * 5.0, (B, T - 2, 1, 1))
    L = jnp.tile(-jnp.eye(n_opt, dtype=jnp.float32)[None, None], (B, T - 3, 1, 1))
    rhs = jnp.asarray(rng.normal(size=(B, T - 2, n_opt)), jnp.float32)
    timeit("block tridiag solve", jax.jit(jax.vmap(block_tridiag_solve)), D, L, rhs)


if __name__ == "__main__":
    main()
