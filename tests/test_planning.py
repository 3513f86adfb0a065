"""Planning-layer tests: GTORobotModel surface points, IK, trajectory
planning — validated on the reference's own __main__ scenarios
(gto/ik_solver.py:133-216, gto/gto_planner.py:263-322)."""

import numpy as np
import pytest

import jax.numpy as jnp

from grasptrajopt_tpu.planning import BasePlanner, GTOPlanner, GTORobotModel, IKSolver
from grasptrajopt_tpu.planning.utils import interpolate_waypoints, load_robot_config

# The fixed Panda test grasp from the reference mains (gto_planner.py:282-285)
PANDA_RT = np.array(
    [
        [-0.61162336, 0.79089652, 0.01998741, 0.46388378],
        [0.7883297, 0.6071185, 0.09971584, -0.15167381],
        [0.06673018, 0.07674521, -0.99481508, 0.22877409],
        [0.0, 0.0, 0.0, 1.0],
    ]
)
PANDA_DEFAULT = np.array([0.0, -1.285, 0, -2.356, 0.0, 1.571, 0.785, 0.0, 0.0])


@pytest.fixture(scope="module")
def panda(data_dir):
    cfg = load_robot_config("panda", data_dir)
    robot = GTORobotModel(
        model_dir=f"{data_dir}/robots/panda",
        urdf_filename=f"{data_dir}/robots/panda/panda.urdf",
        time_derivs=[0, 1],
        param_joints=cfg["param_joints"],
        collision_link_names=cfg["collision_link_names"],
        dtype=jnp.float64,
    )
    robot.setup_workspace_field(arm_len=cfg["arm_len"], arm_height=cfg["arm_height"])
    return robot, cfg


class TestGTORobotModel:
    def test_surface_points(self, panda):
        robot, cfg = panda
        assert len(robot.surface_pc_map) == len(cfg["collision_link_names"])
        assert robot.num_surface_points == 100 * len(cfg["collision_link_names"])
        pts = robot.fk_surface_points(jnp.asarray(PANDA_DEFAULT, jnp.float64))
        assert pts.shape == (robot.num_surface_points, 3)
        # all body points within a plausible robot bounding sphere
        assert float(jnp.linalg.norm(pts, axis=-1).max()) < 1.6

    def test_field_matches_reference_shape(self, panda):
        robot, _ = panda
        assert robot.field_shape == (36, 56, 36)
        assert robot.field_size == 36 * 56 * 36

    def test_compute_plan_cost_zero_field(self, panda):
        robot, _ = panda
        plan = np.tile(PANDA_DEFAULT[:, None], (1, 5))
        cost, dist = robot.compute_plan_cost(plan, np.zeros(robot.field_size), [0, 0, 0])
        assert cost == 0.0
        assert dist == 0.0

    def test_batched_surface_points(self, panda):
        robot, _ = panda
        Q = jnp.asarray(np.tile(PANDA_DEFAULT, (4, 3, 1)), jnp.float64)
        pts = robot.fk_surface_points(Q)
        assert pts.shape == (4, 3, robot.num_surface_points, 3)

    def test_soa_surface_points_match_aos(self, panda):
        robot, _ = panda
        rng = np.random.default_rng(5)
        Q = jnp.asarray(rng.uniform(-0.5, 0.5, size=(2, 3, robot.ndof)), jnp.float64)
        base = jnp.asarray([0.1, -0.2, 0.05], jnp.float64)
        pts = np.asarray(robot.fk_surface_points(Q, base_position=base))
        x, y, z = robot.surface_points_soa(robot.fk_components(Q), base)
        np.testing.assert_allclose(np.asarray(x), pts[..., 0], atol=1e-10)
        np.testing.assert_allclose(np.asarray(y), pts[..., 1], atol=1e-10)
        np.testing.assert_allclose(np.asarray(z), pts[..., 2], atol=1e-10)


class TestIKSolver:
    def test_reference_main_scenario(self, panda):
        """Reach the fixed grasp with position error < 1 cm and rotation
        error < 5 deg, seeded from the current configuration (the driver's
        convention, pybullet_gto_planning.py:249)."""
        robot, cfg = panda
        ik = IKSolver(robot, cfg["link_ee"], cfg["link_gripper"])
        ik.setup_optimization()
        q, err_pos, err_rot, cost = ik.solve_ik(
            PANDA_DEFAULT, PANDA_RT, np.zeros(robot.field_size), [0, 0, 0], verbose=False
        )
        assert err_pos < 0.01, f"position error {err_pos}"
        assert err_rot < 5.0, f"rotation error {err_rot}"
        lo, hi = robot.lower_actuated_joint_limits, robot.upper_actuated_joint_limits
        assert (q >= lo - 1e-9).all() and (q <= hi + 1e-9).all()

    def test_multistart_escapes_local_minimum(self, panda):
        """From the all-zeros seed plain LM lands in a flipped local minimum;
        vmapped multi-start must recover the grasp."""
        robot, cfg = panda
        ik = IKSolver(robot, cfg["link_ee"], cfg["link_gripper"])
        ik.setup_optimization()
        q0 = np.zeros(robot.ndof)
        q, err_pos, err_rot, cost = ik.solve_ik(
            q0, PANDA_RT, np.zeros(robot.field_size), [0, 0, 0],
            verbose=False, multistart=True,
        )
        assert err_pos < 0.01, f"position error {err_pos}"
        assert err_rot < 5.0, f"rotation error {err_rot}"

    def test_batched_ik(self, panda):
        robot, cfg = panda
        ik = IKSolver(robot, cfg["link_ee"], cfg["link_gripper"])
        ik.setup_optimization()
        # three goals: the reference grasp plus two small z-offsets
        RTs = np.tile(PANDA_RT[None], (3, 1, 1))
        RTs[1, 2, 3] += 0.03
        RTs[2, 2, 3] -= 0.03
        q, err_pos, err_rot, cost = ik.solve_ik_batch(
            PANDA_DEFAULT, RTs, np.zeros(robot.field_size), [0, 0, 0]
        )
        assert q.shape == (3, robot.ndof)
        assert (err_pos < 0.01).all(), err_pos
        assert (err_rot < 5.0).all(), err_rot

    def test_param_joints_fixed(self, panda):
        robot, cfg = panda
        ik = IKSolver(robot, cfg["link_ee"], cfg["link_gripper"])
        ik.setup_optimization()
        q0 = np.zeros(robot.ndof)
        q0[7:9] = 0.04  # finger params must pass through untouched
        q, *_ = ik.solve_ik(q0, PANDA_RT, np.zeros(robot.field_size), [0, 0, 0], verbose=False)
        np.testing.assert_allclose(q[7:9], 0.04, atol=0)


class TestGTOPlanner:
    @pytest.mark.slow
    def test_reference_main_scenario(self, panda):
        """gto_planner.py __main__: IK then plan with standoff, no obstacles.
        The plan must start at qc (two pinned steps), respect limits, and
        end with the gripper at the goal."""
        robot, cfg = panda
        ik = IKSolver(robot, cfg["link_ee"], cfg["link_gripper"])
        ik.setup_optimization()
        qc = PANDA_DEFAULT.copy()
        sdf_zero = np.zeros(robot.field_size)
        q_sol, err_pos, err_rot, _ = ik.solve_ik(qc, PANDA_RT, sdf_zero, [0, 0, 0], verbose=False)
        assert err_pos < 0.01

        planner = GTOPlanner(robot, cfg["link_ee"], cfg["link_gripper"])
        Q, dQ, cost = planner.plan(
            qc, PANDA_RT, sdf_zero, [0, 0, 0], q_sol,
            use_standoff=True, axis_standoff=cfg["axis_standoff"],
        )
        assert Q.shape == (robot.ndof, 50)
        assert dQ.shape == (robot.ndof, 49)

        # starts at qc, first two steps pinned (zero initial velocity)
        np.testing.assert_allclose(Q[:, 0], qc, atol=1e-9)
        np.testing.assert_allclose(Q[:, 1], qc, atol=1e-9)
        # param joints stay at qc
        np.testing.assert_allclose(Q[7:9, :], np.tile(qc[7:9, None], (1, 50)), atol=1e-9)
        # joint limits
        lo, hi = robot.lower_actuated_joint_limits, robot.upper_actuated_joint_limits
        assert (Q >= lo[:, None] - 1e-6).all() and (Q <= hi[:, None] + 1e-6).all()

        # final gripper pose reaches the goal
        T_end = np.asarray(
            robot.get_global_link_transform(cfg["link_gripper"], jnp.asarray(Q[:, -1]))
        )
        err_end = np.linalg.norm(T_end[:3, 3] - PANDA_RT[:3, 3])
        assert err_end < 0.02, f"final gripper position error {err_end}"

        # standoff step hovers ~0.1 m behind the goal along its z-axis
        T_stand = np.asarray(
            robot.get_global_link_transform(cfg["link_gripper"], jnp.asarray(Q[:, 40]))
        )
        offset_world = PANDA_RT[:3, :3] @ np.array([0, 0, -0.1])
        err_stand = np.linalg.norm(T_stand[:3, 3] - (PANDA_RT[:3, 3] + offset_world))
        assert err_stand < 0.03, f"standoff position error {err_stand}"

    @pytest.mark.slow
    def test_goalset_picks_reachable_goal(self, panda):
        robot, cfg = panda
        ik = IKSolver(robot, cfg["link_ee"], cfg["link_gripper"])
        ik.setup_optimization()
        qc = PANDA_DEFAULT.copy()
        sdf_zero = np.zeros(robot.field_size)
        q_sol, *_ = ik.solve_ik(qc, PANDA_RT, sdf_zero, [0, 0, 0], verbose=False)

        # goal 0 is far away / implausible; goal 1 is the reference grasp
        RT_far = PANDA_RT.copy()
        RT_far[:3, 3] = [2.5, 2.5, 2.5]
        RTs = np.stack([RT_far, PANDA_RT])

        planner = GTOPlanner(robot, cfg["link_ee"], cfg["link_gripper"])
        Q, dQ, cost = planner.plan_goalset(
            qc, RTs, sdf_zero, sdf_zero, [0, 0, 0],
            q_solutions=q_sol.reshape(-1, 1),
            use_standoff=True, axis_standoff=cfg["axis_standoff"],
        )
        T_end = np.asarray(
            robot.get_global_link_transform(cfg["link_gripper"], jnp.asarray(Q[:, -1]))
        )
        err = np.linalg.norm(T_end[:3, 3] - PANDA_RT[:3, 3])
        assert err < 0.02, f"picked wrong goal? err={err}"

    @pytest.mark.slow
    def test_long_horizon_T100_cyclic_reduction(self, panda):
        """The horizon is a parameter, not a rebuild: T=100 over 10 s with
        the parallel-in-time cyclic-reduction KKT solve reaches the goal
        (SURVEY §5 long-context analog; reference hardcodes T=50)."""
        robot, cfg = panda
        ik = IKSolver(robot, cfg["link_ee"], cfg["link_gripper"])
        ik.setup_optimization()
        qc = PANDA_DEFAULT.copy()
        sdf_zero = np.zeros(robot.field_size)
        q_sol, *_ = ik.solve_ik(qc, PANDA_RT, sdf_zero, [0, 0, 0], verbose=False)

        planner = GTOPlanner(
            robot, cfg["link_ee"], cfg["link_gripper"], T=100,
            iterations=30, single_pass=True, cyclic_reduction=True,
        )
        Q, dQ, cost = planner.plan(
            qc, PANDA_RT, sdf_zero, [0, 0, 0], q_sol,
            use_standoff=True, axis_standoff=cfg["axis_standoff"],
        )
        assert Q.shape == (robot.ndof, 100)
        assert dQ.shape == (robot.ndof, 99)
        np.testing.assert_allclose(Q[:, 0], qc, atol=1e-9)
        T_end = np.asarray(
            robot.get_global_link_transform(cfg["link_gripper"], jnp.asarray(Q[:, -1]))
        )
        err_end = np.linalg.norm(T_end[:3, 3] - PANDA_RT[:3, 3])
        assert err_end < 0.02, f"T=100 final gripper position error {err_end}"

    @pytest.mark.slow
    def test_goal_weight_tightens_deep_standoff(self, panda):
        """goal_weight > 1 must shift the deep-standoff (-0.2) equilibrium:
        the terminal rotation error at goal_weight=4 comes out below the
        parity-default solution's (PERF.md standoff investigation)."""
        from grasptrajopt_tpu.spatial import r2quat
        from grasptrajopt_tpu.spatial.quaternion import qangle_deg

        robot, cfg = panda
        ik = IKSolver(robot, cfg["link_ee"], cfg["link_gripper"])
        ik.setup_optimization()
        qc = PANDA_DEFAULT.copy()
        sdf_zero = np.zeros(robot.field_size)
        q_sol, *_ = ik.solve_ik(qc, PANDA_RT, sdf_zero, [0, 0, 0], verbose=False)

        def rot_err(goal_weight):
            planner = GTOPlanner(
                robot, cfg["link_ee"], cfg["link_gripper"],
                standoff_distance=-0.2, iterations=30, single_pass=True,
                goal_weight=goal_weight,
            )
            Q, _, _ = planner.plan(
                qc, PANDA_RT, sdf_zero, [0, 0, 0], q_sol,
                use_standoff=True, axis_standoff=cfg["axis_standoff"],
            )
            T_end = np.asarray(
                robot.get_global_link_transform(cfg["link_ee"], jnp.asarray(Q[:, -1]))
            )
            return float(
                qangle_deg(
                    r2quat(jnp.asarray(PANDA_RT[None, :3, :3], robot.dtype)),
                    r2quat(jnp.asarray(T_end[None, :3, :3], robot.dtype)),
                )[0]
            )

        e1, e4 = rot_err(1.0), rot_err(4.0)
        assert e4 < e1, (e1, e4)
        assert e4 < 5.0, f"weighted terminal rotation error {e4}"


class TestFieldTermEquivalence:
    @pytest.mark.slow
    def test_traj_term_matches_step_residual_path(self, panda):
        """The whole-trajectory field term (closed-form gradients through
        packed_rows_gather) must reproduce the per-step jacfwd path on a
        problem where the obstacle cost is ACTIVE (slab field under the
        grasp approach)."""
        robot, cfg = panda
        qc = PANDA_DEFAULT.copy()

        # eps-band cost of a table slab below the grasp
        pts = robot.grid.grid_points().astype(np.float64)
        d = pts[:, 2] - 0.12  # slab top at z=0.12
        eps = 0.02
        cost = np.zeros(len(pts))
        cost[d <= 0] = -d[d <= 0] + eps / 2
        band = (d > 0) & (d < eps)
        cost[band] = np.square(d[band] - eps) / (2 * eps)
        field = cost.astype(np.float64)

        ik = IKSolver(robot, cfg["link_ee"], cfg["link_gripper"])
        ik.setup_optimization()
        q_sol, *_ = ik.solve_ik(qc, PANDA_RT, np.zeros_like(field), [0, 0, 0], verbose=False)

        results = {}
        for mode in (True, False):
            planner = GTOPlanner(
                robot, cfg["link_ee"], cfg["link_gripper"], field_term=mode
            )
            Q, dQ, c = planner.plan_goalset(
                qc, PANDA_RT[None], field, field, [0, 0, 0],
                q_solutions=q_sol.reshape(-1, 1),
                use_standoff=True, axis_standoff=cfg["axis_standoff"],
            )
            results[mode] = (np.asarray(Q), float(np.asarray(c).reshape(-1)[0]))

        Q_term, c_term = results[True]
        Q_step, c_step = results[False]
        np.testing.assert_allclose(c_term, c_step, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(Q_term, Q_step, atol=1e-5)

    @pytest.mark.slow
    def test_coarse_phase_preserves_quality(self, panda):
        """Multigrid-in-fidelity schedule (coarse_iterations > 0: early LM
        iterations evaluate the obstacle term on a strided point subset)
        must still reach the goal and stay out of the slab obstacle —
        the fine phase pins the converged equilibrium."""
        robot, cfg = panda
        qc = PANDA_DEFAULT.copy()

        # table slab in front of the robot (z <= 0.10 AND x >= 0.30): the
        # base at the origin stays clear of it
        pts = robot.grid.grid_points().astype(np.float64)
        d = np.maximum(pts[:, 2] - 0.10, 0.30 - pts[:, 0])
        eps = 0.02
        cost = np.zeros(len(pts))
        cost[d <= 0] = -d[d <= 0] + eps / 2
        band = (d > 0) & (d < eps)
        cost[band] = np.square(d[band] - eps) / (2 * eps)
        field = cost.astype(np.float64)

        ik = IKSolver(robot, cfg["link_ee"], cfg["link_gripper"])
        ik.setup_optimization()
        q_sol, *_ = ik.solve_ik(qc, PANDA_RT, np.zeros_like(field), [0, 0, 0], verbose=False)

        planner = GTOPlanner(
            robot, cfg["link_ee"], cfg["link_gripper"],
            iterations=12, single_pass=True,
            coarse_iterations=6, coarse_stride=2,
        )
        Q, dQ, c = planner.plan_goalset(
            qc, PANDA_RT[None], field, field, [0, 0, 0],
            q_solutions=q_sol.reshape(-1, 1),
            use_standoff=True, axis_standoff=cfg["axis_standoff"],
        )
        Q = np.asarray(Q)
        T_end = np.asarray(
            robot.get_global_link_transform(cfg["link_gripper"], jnp.asarray(Q[:, -1]))
        )
        err = np.linalg.norm(T_end[:3, 3] - PANDA_RT[:3, 3])
        assert err < 0.02, f"coarse-phase final gripper position error {err}"
        # no surface point enters the slab (full-fidelity check)
        world = np.asarray(robot.fk_surface_points(jnp.asarray(Q.T)))  # (T,P,3)
        in_slab = (world[..., 2] < 0.10 - 1e-3) & (world[..., 0] > 0.30 + 1e-3)
        assert in_slab.mean() < 1e-3, f"slab penetration fraction {in_slab.mean()}"

    def test_rank_stride_agrees_with_full(self, panda):
        """The strided warm-start ranking (rank_t_stride / rank_p_stride —
        obstacle score on a subset of the (T, P) replay points) must pick
        the same seed as the full ranking when the candidates are clearly
        separated: one IK candidate reaching clear of a slab obstacle, one
        whose seed trajectory sweeps through it."""
        robot, cfg = panda
        qc = PANDA_DEFAULT.copy()
        pts = robot.grid.grid_points().astype(np.float64)
        d = np.maximum(pts[:, 2] - 0.10, 0.30 - pts[:, 0])
        eps = 0.02
        cost = np.zeros(len(pts))
        cost[d <= 0] = -d[d <= 0] + eps / 2
        band = (d > 0) & (d < eps)
        cost[band] = np.square(d[band] - eps) / (2 * eps)
        field = cost.astype(np.float64)

        ik = IKSolver(robot, cfg["link_ee"], cfg["link_gripper"])
        ik.setup_optimization()
        q_good, *_ = ik.solve_ik(
            qc, PANDA_RT, np.zeros_like(field), [0, 0, 0], verbose=False
        )
        RT_slab = PANDA_RT.copy()
        RT_slab[:3, 3] = [0.55, 0.0, 0.05]  # inside the slab region
        q_bad, *_ = ik.solve_ik(
            qc, RT_slab, np.zeros_like(field), [0, 0, 0], verbose=False
        )
        q_solutions = np.stack([q_bad, q_good], axis=1)  # (ndof, 2)

        def best_of(planner):
            best, costs, _ = planner._rank_warm_starts(
                qc, q_solutions, field, [0, 0, 0]
            )
            return np.asarray(best), np.asarray(costs)

        kw = dict(iterations=4, single_pass=True)
        best_full, costs_full = best_of(
            GTOPlanner(robot, cfg["link_ee"], cfg["link_gripper"], **kw)
        )
        assert costs_full[1] < costs_full[0], "clear seed must outrank slab seed"
        for ts, ps in [(2, 2), (4, 4)]:
            best_s, costs_s = best_of(
                GTOPlanner(
                    robot, cfg["link_ee"], cfg["link_gripper"],
                    rank_t_stride=ts, rank_p_stride=ps, **kw,
                )
            )
            assert costs_s[1] < costs_s[0]
            np.testing.assert_allclose(best_s, best_full)

    def test_goal_coherence_keeps_seeded_goal(self, panda):
        """goal_coherence > 0 biases the per-iteration active-goal selection
        toward params['goal_seed'] (switch only when another goal is that
        factor cheaper). With a warm start interpolated to goal 1 but
        goal_seed=0 at a strong coherence factor, the solve must converge
        toward goal 0; the parity planner (coherence 0, plain argmin —
        reference optas.mmin semantics) converges to the seed's goal 1."""
        import jax

        robot, cfg = panda
        qc = PANDA_DEFAULT.copy()
        field = np.zeros(robot.field_size)
        RT0 = PANDA_RT.copy()
        RT1 = PANDA_RT.copy()
        RT1[:3, 3] += [0.0, 0.25, 0.05]

        ik = IKSolver(robot, cfg["link_ee"], cfg["link_gripper"])
        ik.setup_optimization()
        q1, *_ = ik.solve_ik(qc, RT1, field, [0, 0, 0], verbose=False)

        def solve(coherence):
            planner = GTOPlanner(
                robot, cfg["link_ee"], cfg["link_gripper"],
                iterations=8, single_pass=True, goal_coherence=coherence,
            )
            solvers = planner.setup_optimization(
                2, use_standoff=True, axis_standoff=cfg["axis_standoff"]
            )
            seed = planner._seed_trajectories(qc, q1.reshape(-1, 1))[0]
            qc_j = jnp.asarray(qc, robot.dtype)
            q_param = robot.extract_parameter_dimensions(qc_j[:, None])[:, 0]
            qc_opt = robot.extract_optimized_dimensions(qc_j[:, None])[:, 0]
            X0 = robot.extract_optimized_dimensions(seed.T).T[2:]
            params = {
                "q_param": q_param,
                "tf_goal": jnp.asarray(np.stack([RT0, RT1]), robot.dtype),
                "goal_mask": jnp.ones(2, bool),
                "base_position": jnp.zeros(3, robot.dtype),
                "sdf_cost_all": jnp.asarray(field, robot.dtype),
                "sdf_cost_obstacle": jnp.asarray(field, robot.dtype),
            }
            if coherence > 0:
                params["goal_seed"] = jnp.asarray(0, jnp.int32)
            Q_opt, _, _ = solvers.solve_one(qc_opt, X0, params)
            Qf = jax.vmap(lambda col: robot.assemble_q(col, q_param))(Q_opt)
            T_end = np.asarray(
                robot.get_global_link_transform(cfg["link_ee"], jnp.asarray(Qf[-1]))
            )
            d0 = np.linalg.norm(T_end[:3, 3] - RT0[:3, 3])
            d1 = np.linalg.norm(T_end[:3, 3] - RT1[:3, 3])
            return d0, d1

        d0_c, d1_c = solve(coherence=200.0)
        assert d0_c < d1_c, f"coherent solve should land near goal 0 ({d0_c} vs {d1_c})"
        assert d0_c < 0.05, f"coherent solve should reach goal 0 ({d0_c})"
        d0_p, d1_p = solve(coherence=0.0)
        assert d1_p < d0_p, f"parity solve should stay at the seed's goal 1 ({d1_p} vs {d0_p})"
        assert d1_p < 0.05, f"parity solve should reach goal 1 ({d1_p})"

    @pytest.mark.slow
    def test_final_trust_preserves_quality(self, panda):
        """final_trust=True returns the budget's final KKT trial point
        UNEVALUATED (no post-scan residual pass). The returned plan must
        still reach the goal and stay out of the slab obstacle."""
        robot, cfg = panda
        qc = PANDA_DEFAULT.copy()
        pts = robot.grid.grid_points().astype(np.float64)
        d = np.maximum(pts[:, 2] - 0.10, 0.30 - pts[:, 0])
        eps = 0.02
        cost = np.zeros(len(pts))
        cost[d <= 0] = -d[d <= 0] + eps / 2
        band = (d > 0) & (d < eps)
        cost[band] = np.square(d[band] - eps) / (2 * eps)
        field = cost.astype(np.float64)

        ik = IKSolver(robot, cfg["link_ee"], cfg["link_gripper"])
        ik.setup_optimization()
        q_sol, *_ = ik.solve_ik(qc, PANDA_RT, np.zeros_like(field), [0, 0, 0], verbose=False)

        planner = GTOPlanner(
            robot, cfg["link_ee"], cfg["link_gripper"],
            iterations=4, single_pass=True,
            coarse_iterations=2, coarse_stride=2,
            final_trust=True,
        )
        Q, dQ, c = planner.plan_goalset(
            qc, PANDA_RT[None], field, field, [0, 0, 0],
            q_solutions=q_sol.reshape(-1, 1),
            use_standoff=True, axis_standoff=cfg["axis_standoff"],
        )
        Q = np.asarray(Q)
        T_end = np.asarray(
            robot.get_global_link_transform(cfg["link_gripper"], jnp.asarray(Q[:, -1]))
        )
        err = np.linalg.norm(T_end[:3, 3] - PANDA_RT[:3, 3])
        assert err < 0.02, f"final-trust final gripper position error {err}"
        world = np.asarray(robot.fk_surface_points(jnp.asarray(Q.T)))  # (T,P,3)
        in_slab = (world[..., 2] < 0.10 - 1e-3) & (world[..., 0] > 0.30 + 1e-3)
        assert in_slab.mean() < 1e-3, f"slab penetration fraction {in_slab.mean()}"


class TestFetchPlanner:
    """End-to-end IK + trajectory planning on Fetch: 15 DoF with 8
    parameter joints — the reference's hardest bookkeeping case
    (SURVEY.md §7 hard part 6)."""

    FETCH_RT = np.array(
        [
            [-0.05241979, -0.45344928, -0.88973933, 0.41363978],
            [-0.27383122, -0.8502871, 0.44947574, 0.12551154],
            [-0.96034825, 0.26719978, -0.07959669, 0.97476065],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )

    @pytest.mark.slow
    def test_fetch_ik_and_plan(self, data_dir):
        from grasptrajopt_tpu.planning.utils import default_pose

        cfg = load_robot_config("fetch", data_dir)
        robot = GTORobotModel(
            model_dir=f"{data_dir}/robots/fetch",
            urdf_filename=f"{data_dir}/robots/fetch/fetch.urdf",
            time_derivs=[0, 1],
            param_joints=cfg["param_joints"],
            collision_link_names=cfg["collision_link_names"],
            points_per_link=50,
            dtype=jnp.float64,
        )
        robot.setup_workspace_field(arm_len=cfg["arm_len"], arm_height=cfg["arm_height"])
        assert robot.num_param_joints == 8 and robot.num_opt_joints == 7

        qc = np.asarray(cfg["default_pose"], dtype=np.float64)
        ik = IKSolver(robot, cfg["link_ee"], cfg["link_gripper"])
        ik.setup_optimization()
        # the tucked default pose traps single-seed descent in a 26-degree
        # local minimum; the vmapped multi-start finds the exact solution
        q_sol, err_pos, err_rot, _ = ik.solve_ik(
            qc, self.FETCH_RT, np.zeros(robot.field_size), [0, 0, 0],
            verbose=False, multistart=True,
        )
        assert err_pos < 0.01, err_pos
        assert err_rot < 5.0, err_rot
        # all 8 parameter joints (torso, head, wheels, fingers, bellows) pinned
        np.testing.assert_allclose(
            q_sol[robot.parameter_joint_indexes], qc[robot.parameter_joint_indexes], atol=0
        )

        planner = GTOPlanner(robot, cfg["link_ee"], cfg["link_gripper"], iterations=40)
        Q, dQ, cost = planner.plan(
            qc, self.FETCH_RT, np.zeros(robot.field_size), [0, 0, 0], q_sol,
            use_standoff=True, axis_standoff=cfg["axis_standoff"],
        )
        assert Q.shape == (15, 50)
        np.testing.assert_allclose(Q[:, 0], qc, atol=1e-9)
        np.testing.assert_allclose(
            Q[robot.parameter_joint_indexes],
            np.tile(qc[robot.parameter_joint_indexes, None], (1, 50)),
            atol=1e-9,
        )
        # the goal pose targets link_ee (wrist_roll_link); unlike the Panda,
        # Fetch's gripper_link sits ~0.17 m beyond it
        T_end = np.asarray(
            robot.get_global_link_transform(cfg["link_ee"], jnp.asarray(Q[:, -1]))
        )
        err_end = np.linalg.norm(T_end[:3, 3] - self.FETCH_RT[:3, 3])
        assert err_end < 0.03, f"final ee position error {err_end}"


class TestBasePlanner:
    def test_base_moves_toward_out_of_reach_goal(self, panda):
        """A goal translated 1.5 m along +x is unreachable from a fixed base;
        the planner must move the base toward it (parity scenario:
        base_planner.py:230-289, which perturbs the grasp and solves)."""
        robot, cfg = panda
        # the reference gives Ipopt max_iter=100 here (base_planner.py:92)
        planner = BasePlanner(robot, cfg["link_ee"], cfg["link_gripper"], iterations=100)
        planner.setup_optimization(goal_size=1)
        RT = PANDA_RT.copy()
        RT[0, 3] += 1.5
        Q, y, err_pos, err_rot, col = planner.plan_goalset(
            PANDA_DEFAULT, RT[None], verbose=False
        )
        assert Q.shape == (robot.ndof, 1)
        # y is "old base in new base" (base_planner.py:53 comment): a base
        # moving +x toward the goal gives a negative y[0]
        assert y[0] < -0.5, f"base did not move: {y}"
        assert err_pos[0] < 0.05, f"err_pos {err_pos}"
        assert err_rot[0] < 10.0, f"err_rot {err_rot}"


class TestInterpolation:
    def test_two_waypoint_cubic_matches_scipy(self):
        from scipy.interpolate import CubicSpline

        qc = np.array([0.0, 1.0, -2.0])
        qs = np.array([1.0, -1.0, 0.5])
        n = 50
        got = interpolate_waypoints(np.stack([qc, qs]), n, 3, mode="cubic")
        t = np.linspace(0, 1, n + 2)
        for i in range(3):
            f = CubicSpline([0, 1], [qc[i], qs[i]], bc_type="clamped")
            np.testing.assert_allclose(got[:, i], f(t[1:-1]), atol=1e-12)
