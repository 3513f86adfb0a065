"""IKSolver: point-matching inverse kinematics with obstacle avoidance.

Parity with /root/reference/gto/ik_solver.py: the T=1 NLP whose cost is the
sum-squared distance between the gripper's surface points at fk(q) and the
same points placed at the goal pose (:50-54), plus 10x the summed SDF cost
of all body surface points (:57-69, a *linear* value term), subject to
joint limits (:72). The reference solves each grasp candidate with a fresh
Ipopt call (max_iter=50, :75) in a Python loop (~50-100 per object,
pybullet_gto_planning.py:251); here one jit-compiled projected-LM program
solves the WHOLE grasp set as a vmapped batch.

Variants: like the reference's ik_solver_quaternion.py / ik_solver_rpy.py,
`cost='quaternion'` replaces point matching with position +
quaternion-alignment (1 - <q, q*>^2) costs, and `cost='rpy'` with
position + RPY costs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from grasptrajopt_tpu.fields.voxel_grid import VoxelGrid
from grasptrajopt_tpu.opt.lm import LMConfig, make_box_lm_solver
from grasptrajopt_tpu.spatial import invt, r2quat, r2rpy, transform_points
from grasptrajopt_tpu.spatial.quaternion import qangle_deg


class IKSolver:
    def __init__(
        self,
        robot,
        link_ee: str,
        link_gripper: str,
        collision_avoidance: bool = True,
        cost: str = "point",
        interp: str = "trilinear",
        iterations: int = 50,
        num_seeds: int = 8,
    ):
        self.num_seeds = num_seeds
        self.robot = robot
        self.link_ee = link_ee
        self.link_gripper = link_gripper
        self.collision_avoidance = collision_avoidance
        self.cost = cost
        self.interp = interp
        self.iterations = iterations
        self.robot_name = robot.get_name()
        self.gripper_points = jnp.asarray(
            robot.surface_pc_map[link_gripper].points, robot.dtype
        )
        self._solve_one = None
        self._grid: Optional[VoxelGrid] = None

    # -- problem construction -------------------------------------------------

    def setup_optimization(self, grid: Optional[VoxelGrid] = None) -> None:
        """Build (jit) the batched IK program for a field geometry.

        `grid` defaults to the robot's current field (robot.setup_*_field).
        """
        robot = self.robot
        grid = grid or getattr(robot, "grid", None)
        if self.collision_avoidance:
            assert grid is not None, "collision avoidance needs a voxel field"
        self._grid = grid
        dtype = robot.dtype

        ee_frame = robot.frame_of(self.link_ee)
        grip_frame = robot.frame_of(self.link_gripper)
        gpts = self.gripper_points

        def residual(q_opt, params):
            q_full = robot.assemble_q(q_opt, params["q_param"])
            comps = robot.fk_components(q_full)
            T_ee = robot.frame_matrix(comps, ee_frame)
            T_grip = robot.frame_matrix(comps, grip_frame)
            # gripper frame relative to ee frame (constant for fixed wrists,
            # but kept exact: gto/ik_solver.py:26)
            gripper_tf = invt(T_ee) @ T_grip
            tf = T_ee @ gripper_tf
            tf_goal = params["tf_goal"] @ gripper_tf
            if self.cost == "point":
                pts = transform_points(tf, gpts)
                pts_goal = transform_points(tf_goal, gpts)
                return (pts - pts_goal).reshape(-1)
            if self.cost == "quaternion":
                # parity: gto/ik_solver_quaternion.py — position + 1-<q,q*>^2
                qa = r2quat(tf[:3, :3])
                qb = r2quat(params["tf_goal"][:3, :3])
                rot = 1.0 - jnp.sum(qa * qb) ** 2
                return jnp.concatenate(
                    [tf[:3, 3] - params["tf_goal"][:3, 3], jnp.sqrt(jnp.maximum(rot, 1e-12))[None]]
                )
            if self.cost == "rpy":
                return jnp.concatenate(
                    [
                        tf[:3, 3] - params["tf_goal"][:3, 3],
                        r2rpy(tf[:3, :3]) - r2rpy(params["tf_goal"][:3, :3]),
                    ]
                )
            raise ValueError(f"unknown IK cost '{self.cost}'")

        value_fn = None
        if self.collision_avoidance:
            g = grid

            def value_fn(q_opt, params):
                q_full = robot.assemble_q(q_opt, params["q_param"])
                x, y, z = robot.surface_points_soa(
                    robot.fk_components(q_full), params["base_position"]
                )
                if self.interp == "trilinear" and "packed_obstacle" in params:
                    from grasptrajopt_tpu.ops.interp import (
                        field_lookup_trilinear_packed_soa,
                    )

                    vals = field_lookup_trilinear_packed_soa(
                        params["packed_obstacle"], x, y, z,
                        jnp.asarray(g.origin, dtype), g.shape, g.resolution,
                    )
                else:
                    pts = jnp.stack([x, y, z], axis=-1)
                    vals = g.lookup(params["sdf_cost_obstacle"], pts, self.interp)
                return 10.0 * jnp.sum(vals)

        solver = make_box_lm_solver(
            residual, value_fn=value_fn, config=LMConfig(iterations=self.iterations)
        )
        lo = jnp.asarray(robot.lower_optimized_joint_limits, dtype)
        hi = jnp.asarray(robot.upper_optimized_joint_limits, dtype)
        lo_s = jnp.clip(lo, -3.2, 3.2)  # finite sampling range for multi-start
        hi_s = jnp.clip(hi, -3.2, 3.2)

        def _with_packed(params):
            if self.collision_avoidance and self.interp == "trilinear":
                params = dict(params)
                params["packed_obstacle"] = grid.pack(params["sdf_cost_obstacle"])
            return params

        def run(q0_opt, params):
            return solver(q0_opt, lo, hi, _with_packed(params))

        def run_multistart(q0_opt, params, key):
            """Batched multi-start: the given seed plus random restarts within
            the (clipped) joint limits; best-cost solution wins. Ipopt-free
            robustness the batched way — restarts are a vmap axis, not a loop."""
            n = q0_opt.shape[0]
            extra = lo_s + jax.random.uniform(
                key, (self.num_seeds - 1, n), dtype=dtype
            ) * (hi_s - lo_s)
            seeds = jnp.concatenate([q0_opt[None], extra], axis=0)
            packed = _with_packed(params)
            xs, cs, _ = jax.vmap(lambda s: solver(s, lo, hi, packed))(seeds)
            best = jnp.argmin(cs)
            return xs[best], cs[best], {"seed": best}

        self._solve_one = jax.jit(run)
        self._solve_multi = jax.jit(run_multistart)
        self._solve_batch = jax.jit(jax.vmap(run, in_axes=(0, 0)))
        self._solve_batch_multi = jax.jit(jax.vmap(run_multistart, in_axes=(0, 0, 0)))
        self._residual = residual

    # -- solve API ------------------------------------------------------------

    def _params(self, RT, sdf_cost_obstacle, base_position, q_param):
        dtype = self.robot.dtype
        p = {"tf_goal": jnp.asarray(RT, dtype), "q_param": jnp.asarray(q_param, dtype)}
        if self.collision_avoidance:
            p["sdf_cost_obstacle"] = jnp.asarray(sdf_cost_obstacle, dtype)
            p["base_position"] = jnp.asarray(base_position, dtype)
        return p

    def solve_ik(
        self,
        q_0,
        RT,
        sdf_cost_obstacle=None,
        base_position=(0, 0, 0),
        verbose: bool = True,
        multistart: bool = False,
        seed: int = 0,
    ):
        """Single-goal IK. Returns (q (ndof,), err_pos, err_rot_deg, cost)
        with the reference's error metrics (gto/ik_solver.py:93-110).
        With multistart=True, `num_seeds` random restarts run as one vmapped
        batch and the lowest-cost solution is returned."""
        if self._solve_one is None:
            self.setup_optimization()
        robot = self.robot
        q_0 = jnp.asarray(q_0, robot.dtype).reshape(-1)
        q_param = robot.extract_parameter_dimensions(q_0[:, None])[:, 0]
        params = self._params(RT, sdf_cost_obstacle, base_position, q_param)
        q_opt0 = robot.extract_optimized_dimensions(q_0[:, None])[:, 0]
        if multistart:
            q_opt, cost, _ = self._solve_multi(q_opt0, params, jax.random.PRNGKey(seed))
        else:
            q_opt, cost, _ = self._solve_one(q_opt0, params)
        q = robot.assemble_q(q_opt, q_param)

        T = robot.get_global_link_transform(self.link_ee, q)
        RT = jnp.asarray(RT, robot.dtype)
        err_pos = float(jnp.linalg.norm(RT[:3, 3] - T[:3, 3]))
        err_rot = float(qangle_deg(r2quat(RT[:3, :3]), r2quat(T[:3, :3])))
        if self.collision_avoidance:
            col_cost, _ = robot.compute_plan_cost(
                np.asarray(q).reshape(-1, 1), params["sdf_cost_obstacle"], base_position
            )
        else:
            col_cost = 0.0
        if verbose:
            print("IK solution:", np.asarray(q))
            print("position error", err_pos)
            print("rotation error in degree", err_rot)
            print("collision cost", col_cost)
        return np.asarray(q).flatten(), err_pos, err_rot, col_cost

    def solve_ik_batch(
        self,
        q_0,
        RTs,
        sdf_cost_obstacle=None,
        base_position=(0, 0, 0),
        multistart: bool = False,
        seed: int = 0,
    ):
        """Batched IK over a grasp set: one device program for all goals.

        q_0: (ndof,) shared seed (or (B, ndof)); RTs: (B, 4, 4).
        Returns (q (B, ndof), err_pos (B,), err_rot_deg (B,), col_cost (B,)).
        This replaces the reference's per-grasp Ipopt loop
        (pybullet_gto_planning.py:251-278).
        """
        if self._solve_one is None:
            self.setup_optimization()
        robot = self.robot
        dtype = robot.dtype
        RTs = jnp.asarray(RTs, dtype)
        B = RTs.shape[0]
        q_0 = jnp.asarray(q_0, dtype)
        if q_0.ndim == 1:
            q_0 = jnp.broadcast_to(q_0, (B,) + q_0.shape)
        q_param = jax.vmap(lambda qq: robot.extract_parameter_dimensions(qq[:, None])[:, 0])(q_0)
        q_opt0 = jax.vmap(lambda qq: robot.extract_optimized_dimensions(qq[:, None])[:, 0])(q_0)

        params = {
            "tf_goal": RTs,
            "q_param": q_param,
        }
        if self.collision_avoidance:
            params["sdf_cost_obstacle"] = jnp.broadcast_to(
                jnp.asarray(sdf_cost_obstacle, dtype), (B,) + jnp.asarray(sdf_cost_obstacle).shape
            )
            params["base_position"] = jnp.broadcast_to(
                jnp.asarray(base_position, dtype), (B, 3)
            )

        if multistart:
            keys = jax.random.split(jax.random.PRNGKey(seed), B)
            q_opt, costs, _ = self._solve_batch_multi(q_opt0, params, keys)
        else:
            q_opt, costs, _ = self._solve_batch(q_opt0, params)
        q = jax.vmap(robot.assemble_q)(q_opt, q_param)

        T = robot.get_global_link_transform(self.link_ee, q)
        err_pos = jnp.linalg.norm(RTs[:, :3, 3] - T[:, :3, 3], axis=-1)
        err_rot = qangle_deg(r2quat(RTs[:, :3, :3]), r2quat(T[:, :3, :3]))

        if self.collision_avoidance:
            pts = robot.fk_surface_points(q, base_position=jnp.asarray(base_position, dtype))
            vals = self._grid.lookup_nearest(jnp.asarray(sdf_cost_obstacle, dtype), pts)
            col_cost = jnp.sum(vals, axis=-1)
        else:
            col_cost = jnp.zeros(B, dtype)
        return np.asarray(q), np.asarray(err_pos), np.asarray(err_rot), np.asarray(col_cost)

    def solve_fk(self, q):
        return np.asarray(self.robot.get_global_link_transform(self.link_ee, jnp.asarray(q, self.robot.dtype).reshape(-1)))
