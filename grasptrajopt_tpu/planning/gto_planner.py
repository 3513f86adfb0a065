"""GTOPlanner: goal-set grasp trajectory optimization.

Parity with /root/reference/gto/gto_planner.py:
  - T=50 steps over Tmax=10 s (:25-28), dt = Tmax/(T-1)
  - constraints: initial config + zero initial velocity (:59-65), Euler
    integration (:68-72), joint limits (:138) — all eliminated structurally
    here (see opt/trajectory.py)
  - goal-set point-match cost with min over candidate grasps (:84-105),
    standoff phase at step T-10 with a -0.1 m offset pose (:22, :98-102)
  - obstacle cost 10 * (sumsqr(sdf_all[standoff phase]) +
    sumsqr(sdf_obstacle[final phase])) over all body surface points at all
    steps (:107-131) — the final approach may touch the target, so it uses
    the target-free field
  - velocity regularizer 0.01 * sumsqr(dQ) (:133-135)
  - warm-start ranking of IK candidates by (plan cost, travel distance)
    lexicographically, cubic-interpolated seed (:185-219; np.lexsort :212)

Device redesign: the reference REBUILDS the symbolic NLP and re-invokes Ipopt
for every plan call (:146, :187 — SURVEY call stack 3.1's hot spot). Here
`setup_optimization` jit-compiles one solver per (goal capacity, standoff)
signature, goal sets are padded to that capacity with a validity mask, and
`plan_goalset_batch` vmaps whole batches of scenes/grasp-sets in one
device program.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp

from grasptrajopt_tpu.fields.voxel_grid import VoxelGrid
from grasptrajopt_tpu.opt.trajectory import TrajectoryConfig, make_trajectory_solver
from grasptrajopt_tpu.planning.utils import interpolate_waypoints_jnp
from grasptrajopt_tpu.spatial import invt, transform_points


class PlannerSolvers(NamedTuple):
    """Jitted solve programs for one (goal capacity, standoff) signature.

    solve_one: single problem. solve_batch: vmapped batch, every param
    batched (incl. per-problem field tables). solve_batch_shared: scene
    params shared across the batch (one table). solve_batch_stacked:
    per-problem fields STACKED into one flat (B*2S, 8) shared table +
    per-problem `field_base` row offsets — per-problem scenes riding the
    shared-gather code path (one flat gather instead of a batched one)."""

    solve_one: callable
    solve_batch: callable
    solve_batch_shared: callable
    solve_batch_stacked: callable


class GTOPlanner:
    def __init__(
        self,
        robot,
        link_ee: str,
        link_gripper: str,
        collision_avoidance: bool = True,
        standoff_distance: float = -0.1,
        standoff_offset: int = -10,
        interp: str = "trilinear",
        iterations: int = 50,
        obstacle_mode: str = "field",
        sdf_epsilon: float = 0.02,
        field_dtype=None,
        lm_alphas=None,
        single_pass: bool = False,
        field_term: bool = True,
        cyclic_reduction: bool = False,
        goal_weight: float = 1.0,
        obstacle_weight: float = 10.0,
        T: int = 50,
        Tmax: float = 10.0,
        coarse_iterations: int = 0,
        coarse_stride: int = 2,
        final_trust: bool = False,
        rank_t_stride: int = 1,
        rank_p_stride: int = 1,
        goal_coherence: float = 0.0,
    ):
        # T/Tmax: trajectory horizon (reference fixes T=50 over 10 s,
        # gto_planner.py:25-28). The horizon is an array axis here, so long
        # horizons are a parameter, not a rebuild; pair large T with
        # cyclic_reduction=True for the parallel-in-time KKT solve
        # (log2(T) levels instead of a 2T-step scan — SURVEY §5's
        # long-context analog).
        # goal_weight scales the terminal point-match residual rows (final +
        # standoff). 1.0 = reference parity (gto_planner.py:84-105 implicit
        # unit weight). At deep standoffs (-0.2) the velocity regularizer of
        # the longer final approach trades against the goal term and the
        # converged solution sits at ~5 deg rotation error (PERF.md
        # standoff investigation); goal_weight ~4 shifts that equilibrium
        # without touching the collision or smoothness semantics.
        self.goal_weight = float(goal_weight)
        # obstacle_weight scales the shaped SDF-cost residual rows. 10.0 =
        # reference parity (gto_planner.py:131 weights the summed obstacle
        # cost by 10). The pipeline's exact-geometry escalation re-solves
        # replay-colliding plans at a higher weight to buy thin-object
        # clearance the parity weight trades away against smoothness.
        self.obstacle_weight = float(obstacle_weight)
        # cyclic_reduction: parallel-in-time KKT solve
        # (opt/trajectory.py TrajectoryConfig.cyclic_reduction)
        self.cyclic_reduction = cyclic_reduction
        # field_term: evaluate the trilinear-field obstacle cost as a
        # WHOLE-TRAJECTORY term with closed-form spatial gradients
        # (ops.interp.field_lookup_packed_soa_grad) instead of rows inside
        # the per-step jacfwd residual. Numerically identical; the gather
        # then rides packed_rows_gather, whose vmap rule keeps PER-PROBLEM
        # field tables on the sequential-small-gather path (ROADMAP S6).
        self.field_term = field_term
        # single_pass: one fused residual/jac pass per LM iteration
        # (opt/trajectory.py TrajectoryConfig.single_pass)
        self.single_pass = single_pass
        # coarse_iterations > 0: multigrid-in-fidelity schedule — the first
        # k LM iterations evaluate the obstacle field term on every
        # coarse_stride-th surface point (the i.i.d. area-weighted samples
        # subsample uniformly), the remaining iterations at full fidelity.
        # The field gather is the dominant per-iteration cost and scales
        # with the point count, so the coarse phase runs ~stride-x cheaper
        # per iteration while the fine phase pins the converged equilibrium
        # at reference fidelity (requires single_pass; field mode only).
        self.coarse_iterations = int(coarse_iterations)
        self.coarse_stride = int(coarse_stride)
        # final_trust: skip the post-scan evaluation of the budget's final
        # KKT trial point and return it unevaluated — saves one full
        # field-gather pass per solve (opt/trajectory.py
        # TrajectoryConfig.final_trust; single_pass only; default change
        # gated on closed-loop validation)
        self.final_trust = bool(final_trust)
        # rank_{t,p}_stride: warm-start RANKING fidelity — score each IK
        # candidate's interpolated seed trajectory on every rank_t-th step
        # x every rank_p-th surface point (SoA FK path) instead of the full
        # (T, P) replay. The full ranking dominated the IK phase on the
        # first accelerator (tools/probe_ik_phase.py); (2,2) keeps 15/16
        # identical seed picks with ~4e-4 full-metric cost excess on the
        # near-tie. Ranking only picks the SEED — the solver
        # still optimizes the true objective — so this is a fidelity knob
        # of a heuristic, not of the solution. Field mode only; default 1
        # (exact) for the closed-loop pipeline.
        self.rank_t_stride = int(rank_t_stride)
        self.rank_p_stride = int(rank_p_stride)
        # goal_coherence > 1: bias the per-iteration active-goal selection
        # toward the goal the ranked warm start was seeded from (passed as
        # the optional params["goal_seed"] index). The selection switches
        # away from the seeded goal only when another goal's point-match
        # cost is goal_coherence x lower. At large synthetic goal
        # capacities (32-yaw families) the unbiased argmin can select a
        # member far from EVERY IK warm start, which a small iteration
        # budget then cannot reach (PERF.md round-5 "not
        # budget-bound" diagnosis). 0 (default) = reference parity: plain
        # masked argmin of the point-match cost (optas.mmin reduction).
        self.goal_coherence = float(goal_coherence)
        # trial-step scales per LM iteration; each candidate costs a full
        # residual pass (None = TrajectoryConfig default)
        self.lm_alphas = lm_alphas
        # field_dtype=jnp.bfloat16 stores the packed corner tables in bf16
        # (half the gather traffic of the dominant op; < 0.4% cost error)
        self.field_dtype = field_dtype
        # obstacle_mode 'field': reference-parity voxel cost fields with
        #   packed trilinear gathers.
        # obstacle_mode 'points': gather-free — the eps-band cost is shaped
        #   from the exact signed distance to downsampled scene point sets
        #   (ops.signed_distance_to_set: exact min-distance + normal sign).
        self.obstacle_mode = obstacle_mode
        self.sdf_epsilon = sdf_epsilon
        self.T = int(T)
        self.Tmax = float(Tmax)
        self.dt = self.Tmax / (self.T - 1)
        self.standoff_distance = standoff_distance
        self.standoff_offset = standoff_offset
        self.collision_avoidance = collision_avoidance
        self.interp = interp
        self.iterations = iterations

        self.robot = robot
        self.robot_name = robot.get_name()
        self.link_ee = link_ee
        self.link_gripper = link_gripper
        self.gripper_points = jnp.asarray(
            robot.surface_pc_map[link_gripper].points, robot.dtype
        )
        self._solvers: Dict[tuple, callable] = {}

    # -- solver construction --------------------------------------------------

    def _standoff_pose(self, axis: str) -> jnp.ndarray:
        pose = np.eye(4, dtype=np.float32)
        pose[{"x": 0, "y": 1, "z": 2}[axis], 3] = self.standoff_distance
        return jnp.asarray(pose, self.robot.dtype)

    def setup_optimization(
        self,
        goal_size: int = 1,
        use_standoff: bool = False,
        axis_standoff: str = "x",
        grid: Optional[VoxelGrid] = None,
    ):
        """Build (and cache) the jitted solve program for a goal capacity."""
        key = (
            goal_size, use_standoff, axis_standoff, grid or self.robot.grid,
            self.goal_weight, self.obstacle_weight, self.goal_coherence,
        )
        if key in self._solvers:
            return self._solvers[key]

        robot = self.robot
        g = grid or robot.grid
        dtype = robot.dtype
        T = self.T
        t_standoff = T + self.standoff_offset
        ee_frame = robot.frame_of(self.link_ee)
        grip_frame = robot.frame_of(self.link_gripper)
        gpts = self.gripper_points
        pose_standoff = self._standoff_pose(axis_standoff)
        sqrt10 = jnp.asarray(np.sqrt(self.obstacle_weight), dtype)
        sqrt_gw = jnp.asarray(np.sqrt(self.goal_weight), dtype)

        def goal_diffs_from(T_ee, T_grip, tf_goal_one):
            """Point differences (cur - goal-placed) for final and standoff."""
            gripper_tf = invt(T_ee) @ T_grip
            pts_cur = transform_points(T_grip, gpts)
            d_final = pts_cur - transform_points(tf_goal_one @ gripper_tf, gpts)
            if use_standoff:
                d_stand = pts_cur - transform_points(
                    tf_goal_one @ pose_standoff @ gripper_tf, gpts
                )
            else:
                d_stand = jnp.zeros_like(d_final)
            return d_final, d_stand

        def goal_diffs(q_full, tf_goal_one):
            frames = robot.fk_all(q_full)
            return goal_diffs_from(frames[ee_frame], frames[grip_frame], tf_goal_one)

        P_total = robot.num_surface_points
        phase_col = (jnp.arange(T) < t_standoff)[:, None]  # (T, 1) standoff?

        def _obstacle_sd_dir(Q_opt, params):
            """Whole-trajectory signed distances + spatial gradients in ONE
            kernel launch per point set (the launch-count fix: under the
            per-step vmap this was T x B separate Pallas invocations).

            Phase semantics of gto_planner.py:117-131: during the standoff
            phase (t < T-10) the target's surface counts as obstacle too
            (union of both sets); the final approach ignores the target.
            """
            from grasptrajopt_tpu.ops.nn import signed_distance_with_dir

            q_param_b = jnp.broadcast_to(params["q_param"], (T,) + params["q_param"].shape)
            Qf = jax.vmap(robot.assemble_q)(Q_opt, q_param_b)
            comps = robot.fk_components(Qf)
            x, y, z = robot.surface_points_soa(comps, params["base_position"])
            pts = jnp.stack([x, y, z], axis=-1).reshape(T * P_total, 3)
            sd_o, dir_o = signed_distance_with_dir(
                pts, params["scene_points"], params["scene_normals"]
            )
            sd_t, dir_t = signed_distance_with_dir(
                pts, params["target_points"], params["target_normals"]
            )
            sd_o = sd_o.reshape(T, P_total)
            sd_t = sd_t.reshape(T, P_total)
            dir_o = dir_o.reshape(T, P_total, 3)
            dir_t = dir_t.reshape(T, P_total, 3)
            take_t = jnp.logical_and(phase_col, jnp.abs(sd_t) < jnp.abs(sd_o))
            sd = jnp.where(take_t, sd_t, sd_o)
            dirs = jnp.where(take_t[..., None], dir_t, dir_o)
            return sd, dirs

        def obstacle_term_value(Q_opt, step_aux, params):
            from grasptrajopt_tpu.fields.depth_point_cloud import sdf_cost_shaping

            sd, _ = _obstacle_sd_dir(Q_opt, params)
            return sqrt10 * sdf_cost_shaping(sd, epsilon=self.sdf_epsilon)

        def obstacle_term_value_jac(Q_opt, step_aux, params):
            from grasptrajopt_tpu.fields.depth_point_cloud import (
                sdf_cost_shaping,
                sdf_cost_shaping_deriv,
            )

            sd, dirs = _obstacle_sd_dir(Q_opt, params)
            r = sqrt10 * sdf_cost_shaping(sd, epsilon=self.sdf_epsilon)
            drdsd = sqrt10 * sdf_cost_shaping_deriv(sd, epsilon=self.sdf_epsilon)

            # per-step point Jacobians via component FK — no kernel inside
            def pts_of(q_opt):
                q_full = robot.assemble_q(q_opt, params["q_param"])
                x, y, z = robot.surface_points_soa(
                    robot.fk_components(q_full), params["base_position"]
                )
                return jnp.stack([x, y, z], axis=-1)  # (P, 3)

            J_pts = jax.vmap(jax.jacfwd(pts_of))(Q_opt)  # (T, P, 3, n)
            J = jnp.einsum("tp,tpc,tpcn->tpn", drdsd, dirs, J_pts)
            return r, J

        use_field_term = (
            self.collision_avoidance
            and self.obstacle_mode == "field"
            and self.interp == "trilinear"
            and self.field_term
        )
        phase_row = (jnp.arange(T) >= t_standoff).astype(jnp.int32)[:, None]  # (T,1)

        def _field_vals_grads(params, x, y, z):
            """(val, gx, gy, gz) of the phase-selected stacked field at SoA
            points (T, P) — one row gather per query via the batch-aware
            packed_rows_gather."""
            from grasptrajopt_tpu.ops.interp import field_lookup_packed_soa_grad

            return field_lookup_packed_soa_grad(
                params["packed_fields"], x, y, z,
                jnp.asarray(g.origin, dtype), g.shape, g.resolution,
                row_offset=phase_row * g.size + params.get("field_base", 0),
            )

        def make_field_term(stride: int = 1):
            """(value, value_jac) field-term pair at a surface-point stride
            (stride > 1 = the coarse-fidelity phase's subsampled term)."""

            def field_term_value(Q_opt, step_aux, params):
                q_param_b = jnp.broadcast_to(params["q_param"], (T,) + params["q_param"].shape)
                Qf = jax.vmap(robot.assemble_q)(Q_opt, q_param_b)
                x, y, z = robot.surface_points_soa(
                    robot.fk_components(Qf), params["base_position"], stride=stride
                )  # (T, P) each
                val, _, _, _ = _field_vals_grads(params, x, y, z)
                return sqrt10 * val  # (T, P)

            def field_term_value_jac(Q_opt, step_aux, params):
                # ONE shared FK trace yields surface points AND their joint
                # Jacobians (jacfwd has_aux, as in opt/trajectory.py step_lin);
                # the field's spatial gradient is closed-form from the same
                # gathered corner rows as the value.
                def one(q_opt):
                    def f(qq):
                        q_full = robot.assemble_q(qq, params["q_param"])
                        xx, yy, zz = robot.surface_points_soa(
                            robot.fk_components(q_full), params["base_position"],
                            stride=stride,
                        )
                        out = jnp.stack([xx, yy, zz], axis=-1)  # (P, 3)
                        return out, out

                    J, p = jax.jacfwd(f, has_aux=True)(q_opt)  # (P,3,n), (P,3)
                    return p, J

                pts, J_pts = jax.vmap(one)(Q_opt)  # (T,P,3), (T,P,3,n)
                val, gx, gy, gz = _field_vals_grads(
                    params, pts[..., 0], pts[..., 1], pts[..., 2]
                )
                r = sqrt10 * val  # (T, P)
                grad = jnp.stack([gx, gy, gz], axis=-1)  # (T, P, 3)
                J = sqrt10 * jnp.einsum("tpc,tpcn->tpn", grad, J_pts)
                return r, J

            return field_term_value, field_term_value_jac

        field_term_value, field_term_value_jac = make_field_term()

        def step_residual(q_opt, t, goal_idx, params):
            # component-form FK once per step: layout-clean scalars feed the
            # obstacle term (SoA) AND the two goal-frame matrices
            q_full = robot.assemble_q(q_opt, params["q_param"])
            comps = robot.fk_components(q_full)
            parts = []
            if use_field_term:
                pass  # obstacle handled by the whole-trajectory field term
            elif self.collision_avoidance and self.obstacle_mode == "field":
                x, y, z = robot.surface_points_soa(comps, params["base_position"])
                # standoff phase (t < T-10) uses the full field; the final
                # approach uses the target-free field (gto_planner.py:117-131)
                if self.interp == "trilinear":
                    # both packed fields live in ONE stacked (2S, 8) table
                    # (built once per solve in `run`); the per-step field
                    # choice is a row offset, so each point costs exactly
                    # one contiguous 8-float gather. In the stacked-batch
                    # path `field_base` additionally selects this problem's
                    # slab of the batch-wide table.
                    from grasptrajopt_tpu.ops.interp import (
                        field_lookup_trilinear_packed_soa,
                    )

                    phase = (t >= t_standoff).astype(jnp.int32)
                    vals = field_lookup_trilinear_packed_soa(
                        params["packed_fields"], x, y, z,
                        jnp.asarray(g.origin, dtype), g.shape, g.resolution,
                        row_offset=phase * g.size + params.get("field_base", 0),
                    )
                else:
                    pts = jnp.stack([x, y, z], axis=-1)
                    v_all = g.lookup(params["sdf_cost_all"], pts, self.interp)
                    v_obs = g.lookup(params["sdf_cost_obstacle"], pts, self.interp)
                    vals = jnp.where(t < t_standoff, v_all, v_obs)
                parts.append(sqrt10 * vals)

            tf_goal_one = params["tf_goal"][goal_idx]
            d_final, d_stand = goal_diffs_from(
                robot.frame_matrix(comps, ee_frame),
                robot.frame_matrix(comps, grip_frame),
                tf_goal_one,
            )
            is_final = (t == T - 1).astype(dtype)
            is_stand = (t == t_standoff).astype(dtype) if use_standoff else jnp.asarray(0.0, dtype)
            parts.append(
                (sqrt_gw * (is_final * d_final + is_stand * d_stand)).reshape(-1)
            )
            return jnp.concatenate(parts)

        def pre_iteration(Q_opt, params):
            """Active-goal selection: argmin over the goal set of the
            point-match cost at the current trajectory (the reference's
            optas.mmin reduction, gto_planner.py:91-105)."""
            qf = robot.assemble_q(Q_opt[T - 1], params["q_param"])
            qs = robot.assemble_q(Q_opt[t_standoff], params["q_param"])

            def goal_cost(tf_goal_one):
                d_final, _ = goal_diffs(qf, tf_goal_one)
                c = jnp.sum(d_final * d_final)
                if use_standoff:
                    _, d_stand = goal_diffs(qs, tf_goal_one)
                    c = c + jnp.sum(d_stand * d_stand)
                return c

            costs = jax.vmap(goal_cost)(params["tf_goal"])
            costs = jnp.where(params["goal_mask"], costs, jnp.inf)
            if self.goal_coherence > 0.0 and "goal_seed" in params:
                # coherence bias: stay with the warm start's goal unless
                # another is goal_coherence x cheaper (see __init__)
                idx = jnp.arange(costs.shape[0])
                costs = jnp.where(
                    idx == params["goal_seed"],
                    costs / jnp.asarray(self.goal_coherence, dtype),
                    costs,
                )
            return jnp.argmin(costs)

        cfg_kwargs = {}
        if self.lm_alphas is not None:
            cfg_kwargs["alphas"] = tuple(self.lm_alphas)
        cfg = TrajectoryConfig(
            T=T,
            n_fixed=2,
            smooth_weight=0.01 / self.dt**2,
            iterations=self.iterations,
            single_pass=self.single_pass,
            cyclic_reduction=self.cyclic_reduction,
            final_trust=self.final_trust and self.single_pass,
            **cfg_kwargs,
        )
        traj_term = None
        if self.collision_avoidance and self.obstacle_mode == "points":
            traj_term = (obstacle_term_value, obstacle_term_value_jac)
        elif use_field_term:
            traj_term = (field_term_value, field_term_value_jac)
        coarse = None
        if self.coarse_iterations:
            if not (use_field_term and self.single_pass):
                raise NotImplementedError(
                    "coarse_iterations requires single_pass=True and the "
                    "trilinear field obstacle term"
                )
            # goal rows (step_residual) stay full fidelity; only the
            # obstacle field term coarsens
            coarse = (
                self.coarse_iterations,
                None,
                make_field_term(self.coarse_stride),
            )
        solver = make_trajectory_solver(
            step_residual, cfg, pre_iteration=pre_iteration, traj_term=traj_term,
            coarse=coarse,
        )

        lo = jnp.asarray(robot.lower_optimized_joint_limits, dtype)
        hi = jnp.asarray(robot.upper_optimized_joint_limits, dtype)

        def run(qc_opt, X0, params):
            if (
                self.collision_avoidance
                and self.obstacle_mode == "field"
                and self.interp == "trilinear"
                and "packed_fields" not in params
            ):
                params = dict(params)
                params["packed_fields"] = jnp.concatenate(
                    [
                        g.pack(params["sdf_cost_all"], dtype=self.field_dtype),
                        g.pack(params["sdf_cost_obstacle"], dtype=self.field_dtype),
                    ],
                    axis=0,
                )
            return solver(qc_opt, X0, lo, hi, params)

        solve_one = jax.jit(run)
        solve_batch = jax.jit(jax.vmap(run))

        def run_shared(qc_opt, X0, params_per, params_shared):
            """Batch variant with scene data SHARED across the batch
            (realistic deployment: many grasp sets per scene). The obstacle
            field / scene point set stays unbatched, so a single packed
            table serves every problem — far friendlier to on-chip caching
            than per-problem 4.6 MB gather tables."""
            return run(qc_opt, X0, {**params_per, **params_shared})

        solve_batch_shared = jax.jit(jax.vmap(run_shared, in_axes=(0, 0, 0, None)))
        # stacked per-problem fields: same code path as shared, but
        # params_per carries "field_base" (b * 2S) and params_shared the
        # concatenated (B*2S, 8) table — see pack_stacked_fields
        solve_batch_stacked = solve_batch_shared
        self._solvers[key] = PlannerSolvers(
            solve_one, solve_batch, solve_batch_shared, solve_batch_stacked
        )
        return self._solvers[key]

    def pack_stacked_fields(self, sdf_cost_all_b, sdf_cost_obstacle_b):
        """Pack B per-problem field pairs into ONE flat (B*2S, 8) corner
        table + the (B,) per-problem base row offsets.

        Feed the result to `solve_batch_stacked`:
            tables, base = planner.pack_stacked_fields(all_b, obs_b)
            solvers.solve_batch_stacked(qc_opt, X0,
                {**params_per, "field_base": base}, {"packed_fields": tables})
        """
        g = self.robot.grid
        dtype = self.field_dtype

        def pack_pair(fa, fo):
            return jnp.concatenate(
                [g.pack(fa, dtype=dtype), g.pack(fo, dtype=dtype)], axis=0
            )

        tables = jax.vmap(pack_pair)(
            jnp.asarray(sdf_cost_all_b), jnp.asarray(sdf_cost_obstacle_b)
        )  # (B, 2S, 8)
        B = tables.shape[0]
        base = jnp.arange(B, dtype=jnp.int32) * (2 * g.size)
        return tables.reshape(B * 2 * g.size, 8), base

    # -- warm starts ----------------------------------------------------------

    def _seed_trajectories(self, qc, q_solutions):
        """Interpolate each IK candidate (ndof, k) into a (k, T, ndof) seed
        bundle, param joints pinned at qc — the one home for the seeding
        semantics shared by the warm-start ranking and the per-goal rescue."""
        robot = self.robot
        dtype = robot.dtype
        qc = jnp.asarray(qc, dtype)
        q_solutions = jnp.asarray(q_solutions, dtype)  # (ndof, k)
        param_idx = jnp.asarray(robot.parameter_joint_indexes, dtype=int)

        def seed_for(q_sol):
            data = interpolate_waypoints_jnp(qc, q_sol, self.T)  # (T, ndof)
            if robot.num_param_joints:
                data = data.at[:, param_idx].set(qc[param_idx])
            return data

        return jax.vmap(seed_for)(q_solutions.T)

    def dq_of(self, Q):
        """Finite-difference joint velocities (ndof, T-1) of an (ndof, T)
        plan; param joints stay zero (plan_goalset's dQ convention)."""
        dQ = np.zeros((self.robot.ndof, Q.shape[1] - 1))
        opt_idx = self.robot.optimized_joint_indexes
        dQ[opt_idx, :] = (Q[opt_idx, 1:] - Q[opt_idx, :-1]) / self.dt
        return dQ

    def rank_seed_scores(
        self, seeds, sdf_cost_obstacle, base_position, scene_obstacle=None
    ):
        """(costs, dists) of a (k, T, ndof) seed bundle — the warm-start
        ranking metric (gto_planner.py:196-219): summed obstacle cost of the
        replayed seed, and start-to-end travel as the tie break. Traceable;
        the one home for the ranking semantics (bench_e2e ranks through this
        same helper so the measured path is the shipped path)."""
        robot = self.robot
        dtype = robot.dtype
        seeds = jnp.asarray(seeds, dtype)

        # ranking fidelity strides (see __init__): field mode scores a
        # (rank_t, rank_p)-strided subset of the (T, P) replay points. The
        # step subsample is anchored at the END of the trajectory (steps
        # T-1, T-1-s, ...) so the terminal grasp pose — typically the
        # deepest point in clutter and the step most likely to separate
        # candidates — is always scored.
        strided = (
            self.obstacle_mode != "points"
            and (self.rank_t_stride > 1 or self.rank_p_stride > 1)
        )
        if strided:
            sub = seeds[:, :: -self.rank_t_stride][:, ::-1]
            comps = robot.fk_components(sub)
            x, y, z = robot.surface_points_soa(
                comps, jnp.asarray(base_position, dtype),
                stride=self.rank_p_stride,
            )
            pts = jnp.stack([x, y, z], axis=-1)
        else:
            pts = robot.fk_surface_points(
                seeds, base_position=jnp.asarray(base_position, dtype)
            )
        if self.obstacle_mode == "points":
            from grasptrajopt_tpu.fields.depth_point_cloud import sdf_cost_shaping
            from grasptrajopt_tpu.ops.nn import signed_distance_with_dir

            sd, _ = signed_distance_with_dir(
                pts,
                jnp.asarray(scene_obstacle.points, dtype),
                jnp.asarray(scene_obstacle.normals, dtype),
            )
            vals = sdf_cost_shaping(sd, epsilon=self.sdf_epsilon)
        else:
            vals = robot.grid.lookup_nearest(jnp.asarray(sdf_cost_obstacle, dtype), pts)
        costs = jnp.sum(vals, axis=(1, 2))  # (k,)
        dists = jnp.linalg.norm(seeds[:, 0] - seeds[:, -1], axis=-1)
        return costs, dists

    @staticmethod
    def rank_pick(costs, dists):
        """Index of the lexicographic (cost, dist) winner: among min-cost
        seeds, the one with the smallest travel."""
        min_cost = jnp.min(costs)
        return jnp.argmin(jnp.where(costs == min_cost, dists, jnp.inf))

    def _rank_warm_starts(
        self, qc, q_solutions, sdf_cost_obstacle, base_position, scene_obstacle=None
    ):
        """Interpolate each IK candidate into a seed trajectory and rank by
        (plan cost, distance) lexicographically (gto_planner.py:196-219).
        Returns (best seed (T, ndof), costs (k,), dists (k,))."""
        seeds = self._seed_trajectories(qc, q_solutions)  # (k, T, ndof)
        costs, dists = self.rank_seed_scores(
            seeds, sdf_cost_obstacle, base_position, scene_obstacle
        )
        best = self.rank_pick(costs, dists)
        self._last_rank_pick = best  # seed/goal index of the returned seed
        return seeds[best], costs, dists

    # -- public API -----------------------------------------------------------

    def plan(
        self,
        qc,
        RT,
        sdf_cost_obstacle,
        base_position,
        q_solution=None,
        use_standoff: bool = True,
        axis_standoff: str = "x",
    ):
        """Single-goal plan (parity: gto_planner.py:145-182).

        Returns (Q (ndof, T), dQ (ndof, T-1), cost)."""
        RTs = np.asarray(RT)[None]
        q_solutions = None if q_solution is None else np.asarray(q_solution).reshape(-1, 1)
        # parity: the reference's plan() never sets the sdf_cost_all
        # parameter, which therefore stays zero in the NLP — only the final
        # phase sees the obstacle field (gto_planner.py:164-173)
        zeros_all = np.zeros_like(np.asarray(sdf_cost_obstacle))
        return self.plan_goalset(
            qc,
            RTs,
            zeros_all,
            sdf_cost_obstacle,
            base_position,
            q_solutions=q_solutions,
            use_standoff=use_standoff,
            axis_standoff=axis_standoff,
        )

    def plan_goalset(
        self,
        qc,
        RTs,
        sdf_cost_all,
        sdf_cost_obstacle,
        base_position,
        q_solutions=None,
        use_standoff: bool = True,
        axis_standoff: str = "x",
        interpolate: bool = True,
        goal_capacity: Optional[int] = None,
        scene_obstacle=None,
        scene_target=None,
    ):
        """Goal-set plan (parity: gto_planner.py:185-245).

        qc: (ndof,); RTs: (n, 4, 4) candidate grasp poses (of link_ee);
        sdf fields: flat (field_size,) cost arrays on the robot's grid;
        q_solutions: optional (ndof, k) IK warm-start candidates.
        `goal_capacity` pads the goal set to a static size so repeated calls
        with different n reuse one compiled program.
        Returns (Q (ndof, T), dQ (ndof, T-1), cost (1,))."""
        robot = self.robot
        dtype = robot.dtype
        qc = jnp.asarray(qc, dtype).reshape(-1)
        RTs = np.asarray(RTs)
        n = RTs.shape[0]
        cap = goal_capacity or n
        assert n <= cap

        tf_goal = np.tile(np.eye(4, dtype=np.float32)[None], (cap, 1, 1))
        tf_goal[:n] = RTs
        goal_mask = np.zeros(cap, dtype=bool)
        goal_mask[:n] = True

        solve_one = self.setup_optimization(cap, use_standoff, axis_standoff).solve_one

        # Warm start (gto_planner.py:193-219)
        if q_solutions is None:
            Q0_full = jnp.tile(qc[None, :], (self.T, 1))
        elif interpolate:
            Q0_full, _, _ = self._rank_warm_starts(
                qc, q_solutions, sdf_cost_obstacle, base_position, scene_obstacle
            )
        else:
            best_seed, _, _ = self._rank_warm_starts(
                qc, q_solutions, sdf_cost_obstacle, base_position, scene_obstacle
            )
            Q0_full = jnp.tile(qc[None, :], (self.T, 1))
            Q0_full = Q0_full.at[self.T + self.standoff_offset :].set(best_seed[-1])

        q_param = robot.extract_parameter_dimensions(qc[:, None])[:, 0]
        qc_opt = robot.extract_optimized_dimensions(qc[:, None])[:, 0]
        X0 = robot.extract_optimized_dimensions(jnp.asarray(Q0_full, dtype).T).T[2:]

        params = {
            "q_param": q_param,
            "tf_goal": jnp.asarray(tf_goal, dtype),
            "goal_mask": jnp.asarray(goal_mask),
            "base_position": jnp.asarray(base_position, dtype),
        }
        if (
            self.goal_coherence > 0.0
            and q_solutions is not None
            and np.asarray(q_solutions).shape[1] == n
        ):
            # candidate columns are goal-aligned (the pipeline's layout):
            # the ranked warm start's index IS the goal it interpolates to
            params["goal_seed"] = jnp.asarray(self._last_rank_pick, jnp.int32)
        if self.obstacle_mode == "points":
            assert scene_obstacle is not None and scene_target is not None, (
                "obstacle_mode='points' needs scene_obstacle/scene_target "
                "ScenePointSets (fields.scene_points)"
            )
            params["scene_points"] = jnp.asarray(scene_obstacle.points, dtype)
            params["scene_normals"] = jnp.asarray(scene_obstacle.normals, dtype)
            params["target_points"] = jnp.asarray(scene_target.points, dtype)
            params["target_normals"] = jnp.asarray(scene_target.normals, dtype)
        else:
            params["sdf_cost_all"] = jnp.asarray(sdf_cost_all, dtype)
            params["sdf_cost_obstacle"] = jnp.asarray(sdf_cost_obstacle, dtype)

        Q_opt, cost, aux = solve_one(qc_opt, X0, params)
        Q_full = jax.vmap(lambda col: robot.assemble_q(col, q_param))(Q_opt)  # (T, ndof)
        Q = np.asarray(Q_full).T  # (ndof, T)
        return Q, self.dq_of(Q), np.asarray(cost).reshape(1)

    def plan_pergoal_batch(
        self,
        qc,
        RTs,
        sdf_cost_all,
        sdf_cost_obstacle,
        base_position,
        q_solutions,
        use_standoff: bool = True,
        axis_standoff: str = "x",
        goal_capacity: Optional[int] = None,
        scene_obstacle=None,
        scene_target=None,
    ):
        """One INDEPENDENT single-goal solve per candidate grasp, batched in
        one device program (the rescue path — no reference equivalent: the
        reference cannot afford n extra Ipopt solves per object, but a
        vmapped batch of n LM solves costs barely more than one).

        Problem b optimizes toward goal b alone (one-hot goal mask on the
        shared goal-set program) and warm-starts from ITS OWN IK candidate,
        so a bad soft-min compromise in `plan_goalset` cannot drag every
        candidate into the same local minimum. Callers score the n plans
        with planning.evaluate.score_plan and pick the best gated one.

        qc (ndof,); RTs (n, 4, 4); q_solutions (ndof, n) — one IK solution
        per goal, aligned with RTs rows.
        Returns (Q (n, ndof, T), cost (n,))."""
        robot = self.robot
        dtype = robot.dtype
        qc = jnp.asarray(qc, dtype).reshape(-1)
        RTs = np.asarray(RTs)
        q_solutions = np.asarray(q_solutions)
        n = RTs.shape[0]
        assert q_solutions.shape[1] == n, "one IK candidate per goal required"
        cap = goal_capacity or n
        assert n <= cap

        tf_goal = np.tile(np.eye(4, dtype=np.float32)[None], (cap, 1, 1))
        tf_goal[:n] = RTs
        # problem b targets goal bidx[b]; padding problems re-solve the last
        # real goal, n-1 (their plans are sliced away before returning)
        bidx = np.minimum(np.arange(cap), n - 1)
        goal_mask = np.zeros((cap, cap), dtype=bool)
        goal_mask[np.arange(cap), bidx] = True

        solvers = self.setup_optimization(cap, use_standoff, axis_standoff)

        seeds = self._seed_trajectories(qc, q_solutions[:, bidx])  # (cap, T, ndof)

        q_param = robot.extract_parameter_dimensions(qc[:, None])[:, 0]
        qc_opt = robot.extract_optimized_dimensions(qc[:, None])[:, 0]
        ext_o = jax.vmap(
            lambda Qf: robot.extract_optimized_dimensions(Qf.T).T[2:]
        )
        X0 = ext_o(seeds)  # (cap, T-2, n_opt)
        qc_opt_b = jnp.broadcast_to(qc_opt, (cap, qc_opt.shape[0]))

        params_shared = {
            "q_param": q_param,
            "tf_goal": jnp.asarray(tf_goal, dtype),
            "base_position": jnp.asarray(base_position, dtype),
        }
        if self.obstacle_mode == "points":
            assert scene_obstacle is not None and scene_target is not None
            params_shared["scene_points"] = jnp.asarray(scene_obstacle.points, dtype)
            params_shared["scene_normals"] = jnp.asarray(scene_obstacle.normals, dtype)
            params_shared["target_points"] = jnp.asarray(scene_target.points, dtype)
            params_shared["target_normals"] = jnp.asarray(scene_target.normals, dtype)
        else:
            params_shared["sdf_cost_all"] = jnp.asarray(sdf_cost_all, dtype)
            params_shared["sdf_cost_obstacle"] = jnp.asarray(sdf_cost_obstacle, dtype)
        params_per = {"goal_mask": jnp.asarray(goal_mask)}

        Q_opt, cost, _ = solvers.solve_batch_shared(
            qc_opt_b, X0, params_per, params_shared
        )  # (cap, T, n_opt), (cap,)
        assemble_traj = jax.vmap(jax.vmap(robot.assemble_q, in_axes=(0, None)), in_axes=(0, None))
        Q_full = assemble_traj(Q_opt, q_param)  # (cap, T, ndof)
        Q = np.asarray(Q_full).transpose(0, 2, 1)[:n]  # (n, ndof, T)
        return Q, np.asarray(cost)[:n]

    def plan_goalset_batch(
        self,
        qc,
        tf_goal,
        goal_mask,
        sdf_cost_all,
        sdf_cost_obstacle,
        base_position,
        Q0_full,
        use_standoff: bool = True,
        axis_standoff: str = "x",
    ):
        """Fully-batched goal-set planning: B independent problems in one
        device program (the throughput path; no reference equivalent —
        the reference plans one scene at a time).

        Shapes: qc (B, ndof); tf_goal (B, cap, 4, 4); goal_mask (B, cap);
        fields (B, field_size); base_position (B, 3); Q0_full (B, T, ndof).
        Returns (Q (B, T, ndof), cost (B,)).
        """
        robot = self.robot
        cap = tf_goal.shape[1]
        solve_batch = self.setup_optimization(cap, use_standoff, axis_standoff).solve_batch

        ext_p = jax.vmap(lambda qq: robot.extract_parameter_dimensions(qq[:, None])[:, 0])
        ext_o = jax.vmap(lambda qq: robot.extract_optimized_dimensions(qq[:, None])[:, 0])
        q_param = ext_p(qc)
        qc_opt = ext_o(qc)
        X0 = jax.vmap(ext_o)(Q0_full[:, 2:])

        params = {
            "q_param": q_param,
            "tf_goal": tf_goal,
            "goal_mask": goal_mask,
            "base_position": base_position,
            "sdf_cost_all": sdf_cost_all,
            "sdf_cost_obstacle": sdf_cost_obstacle,
        }
        Q_opt, cost, _ = solve_batch(qc_opt, X0, params)
        Q_full = jax.vmap(jax.vmap(robot.assemble_q))(
            Q_opt, jnp.broadcast_to(q_param[:, None, :], (qc.shape[0], self.T, q_param.shape[1]))
        )
        return Q_full, cost
