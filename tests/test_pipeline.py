"""End-to-end integration tests: obstacle-avoiding trajectory optimization
and the full perception->screen->plan pipeline."""

import numpy as np
import pytest

import jax.numpy as jnp

from grasptrajopt_tpu.planning import GTOPlanner, GTORobotModel, IKSolver
from grasptrajopt_tpu.planning.pipeline import GraspPipeline
from grasptrajopt_tpu.planning.utils import load_robot_config

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


def make_fence_field(robot, hole_center=None, hole_radius=0.12):
    """Obstacle cost field: a vertical fence at x in [0.28, 0.34] spanning
    y in [-0.5, 0.5], z in [0, 0.45]; optional spherical hole around the
    target (the reference's target-free obstacle-field trick)."""
    pts = robot.grid.grid_points().astype(np.float64)
    in_fence = (
        (pts[:, 0] > 0.28) & (pts[:, 0] < 0.34)
        & (np.abs(pts[:, 1]) < 0.5)
        & (pts[:, 2] > 0.0) & (pts[:, 2] < 0.45)
    )
    field = np.zeros(robot.field_size)
    field[in_fence] = 0.05
    if hole_center is not None:
        dist = np.linalg.norm(pts - np.asarray(hole_center), axis=1)
        field[dist < hole_radius] = 0.0
    return field


class TestObstacleAvoidance:
    @pytest.mark.slow
    def test_plan_avoids_fence(self, panda):
        """The optimized plan must sweep over/around a fence between the
        start pose and the grasp, unlike the straight interpolated seed."""
        robot, cfg = panda
        ik = IKSolver(robot, cfg["link_ee"], cfg["link_gripper"])
        ik.setup_optimization()
        qc = PANDA_DEFAULT.copy()

        sdf_all = make_fence_field(robot)  # standoff phase: full fence
        sdf_obstacle = make_fence_field(robot, hole_center=PANDA_RT[:3, 3])

        q_sol, err_pos, err_rot, _ = ik.solve_ik(
            qc, PANDA_RT, np.zeros(robot.field_size), [0, 0, 0], verbose=False
        )
        assert err_pos < 0.01

        planner = GTOPlanner(robot, cfg["link_ee"], cfg["link_gripper"], iterations=75)
        plan, dQ, cost = planner.plan_goalset(
            qc, PANDA_RT[None], sdf_all, sdf_obstacle, [0, 0, 0],
            q_solutions=q_sol.reshape(-1, 1),
            use_standoff=True, axis_standoff=cfg["axis_standoff"],
        )

        # seed trajectory cost (the straight cubic interpolation)
        from grasptrajopt_tpu.planning.utils import interpolate_waypoints

        seed = interpolate_waypoints(np.stack([qc, q_sol]), 50, robot.ndof).T
        seed_cost, _ = robot.compute_plan_cost(seed, sdf_all, [0, 0, 0])
        plan_cost, _ = robot.compute_plan_cost(plan, sdf_all, [0, 0, 0])
        assert seed_cost > 1.0, f"test setup: seed should collide, cost {seed_cost}"
        assert plan_cost < 0.25 * seed_cost, (
            f"plan does not avoid the fence: {plan_cost} vs seed {seed_cost}"
        )

        # still reaches the goal
        T_end = np.asarray(
            robot.get_global_link_transform(cfg["link_gripper"], jnp.asarray(plan[:, -1]))
        )
        err_end = np.linalg.norm(T_end[:3, 3] - PANDA_RT[:3, 3])
        assert err_end < 0.03, f"final position error {err_end}"


class TestPointsObstacleMode:
    def test_signed_distance_gradients(self):
        """custom_jvp of signed_distance_to_set vs finite differences."""
        import jax

        from grasptrajopt_tpu.ops.nn import signed_distance_to_set

        rng = np.random.default_rng(0)
        ref = jnp.asarray(rng.normal(size=(50, 3)))
        normals = ref / jnp.linalg.norm(ref, axis=1, keepdims=True)  # sphere-ish
        p = jnp.asarray([[0.4, 0.1, -0.2], [1.5, 1.5, 1.5]])

        def f(pp):
            return jnp.sum(signed_distance_to_set(pp, ref, normals))

        g = np.asarray(jax.grad(f)(p))
        eps = 1e-6
        for i in range(2):
            for k in range(3):
                dp = np.zeros((2, 3))
                dp[i, k] = eps
                fd = (f(p + dp) - f(p - dp)) / (2 * eps)
                np.testing.assert_allclose(g[i, k], np.asarray(fd), atol=1e-4)

    def test_lateral_footprint_sign_guard(self):
        """The normal-dot sign only claims 'inside' within the surface
        sample's lateral footprint: a point below the tabletop PLANE but
        far to the side of the table is OUTSIDE (positive sd). Regression
        for the round-2 points-mode quality collapse (the robot base under
        an infinite tangent plane)."""
        from grasptrajopt_tpu.ops.nn import signed_distance_with_dir

        xs, ys = np.meshgrid(np.arange(0.2, 0.9, 0.02), np.arange(-0.6, 0.6, 0.02))
        sheet = jnp.asarray(
            np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, 0.15)], axis=1)
        )
        nrm = jnp.asarray(np.tile([0.0, 0.0, 1.0], (sheet.shape[0], 1)))
        q = jnp.asarray(
            [
                [0.5, 0.0, 0.10],  # directly under the sheet: inside
                [0.0, 0.0, 0.05],  # below the plane but 0.2 m to the side: outside
                [0.5, 0.0, 0.20],  # above: outside
            ]
        )
        sd, dirs = signed_distance_with_dir(q, sheet, nrm)
        assert float(sd[0]) < 0 and abs(float(sd[0]) + 0.05) < 0.01
        assert float(sd[1]) > 0.1
        assert abs(float(sd[2]) - 0.05) < 0.01
        # gradient of the inside point pushes up (+z), the outside lateral
        # point pushes away from the sheet edge
        assert float(dirs[0, 2]) > 0.9
        assert float(dirs[1, 0]) < -0.5

    @pytest.mark.slow
    def test_plan_avoids_fence_points_mode(self, panda):
        """Same fence scenario as field mode, but with the gather-free
        direct-distance obstacle term."""
        from grasptrajopt_tpu.fields.scene_points import ScenePointSet, downsample_scene

        robot, cfg = panda
        ik = IKSolver(robot, cfg["link_ee"], cfg["link_gripper"])
        ik.setup_optimization()
        qc = PANDA_DEFAULT.copy()
        q_sol, err_pos, _, _ = ik.solve_ik(
            qc, PANDA_RT, np.zeros(robot.field_size), [0, 0, 0], verbose=False
        )
        assert err_pos < 0.01

        # fence as a thin shell: front face (normals toward the robot),
        # back face, and top strip — signed distance is then positive on
        # BOTH sides and above, negative only inside the slab
        ys, zs = np.meshgrid(np.arange(-0.5, 0.5, 0.02), np.arange(0.0, 0.45, 0.02))
        front = np.stack([np.full(ys.size, 0.28), ys.ravel(), zs.ravel()], axis=1)
        back = np.stack([np.full(ys.size, 0.34), ys.ravel(), zs.ravel()], axis=1)
        ys2, xs2 = np.meshgrid(np.arange(-0.5, 0.5, 0.02), np.arange(0.28, 0.35, 0.02))
        top = np.stack([xs2.ravel(), ys2.ravel(), np.full(ys2.size, 0.45)], axis=1)
        fence_pts = np.concatenate([front, back, top])
        fence_nrm = np.concatenate(
            [
                np.tile([-1.0, 0.0, 0.0], (front.shape[0], 1)),
                np.tile([1.0, 0.0, 0.0], (back.shape[0], 1)),
                np.tile([0.0, 0.0, 1.0], (top.shape[0], 1)),
            ]
        )
        scene = downsample_scene(fence_pts, fence_nrm, capacity=4096, resolution=0.02)
        target = ScenePointSet(
            np.full((64, 3), 1.0e6), np.tile([0.0, 0.0, 1.0], (64, 1)), 0
        )

        planner = GTOPlanner(
            robot, cfg["link_ee"], cfg["link_gripper"], iterations=75,
            obstacle_mode="points",
        )
        plan, dQ, cost = planner.plan_goalset(
            qc, PANDA_RT[None], None, None, [0, 0, 0],
            q_solutions=q_sol.reshape(-1, 1),
            use_standoff=True, axis_standoff=cfg["axis_standoff"],
            scene_obstacle=scene, scene_target=target,
        )

        # the fence-crossing seed collides; the plan must not
        from grasptrajopt_tpu.planning.utils import interpolate_waypoints

        sdf_all = make_fence_field(robot)
        seed = interpolate_waypoints(np.stack([qc, q_sol]), 50, robot.ndof).T
        seed_cost, _ = robot.compute_plan_cost(seed, sdf_all, [0, 0, 0])
        plan_cost, _ = robot.compute_plan_cost(plan, sdf_all, [0, 0, 0])
        assert seed_cost > 1.0
        # the eps-band cost permits grazing within epsilon of the shell, so
        # judge by the direct metric: worst signed distance stays inside the
        # band and the voxel-metric cost drops substantially vs the seed
        assert plan_cost < 0.5 * seed_cost, (plan_cost, seed_cost)
        from grasptrajopt_tpu.ops.nn import signed_distance_to_set

        p_all = robot.fk_surface_points(jnp.asarray(plan.T, jnp.float64))
        sd = signed_distance_to_set(
            p_all, jnp.asarray(scene.points), jnp.asarray(scene.normals)
        )
        assert float(sd.min()) > -0.015, f"penetration {float(sd.min())}"

        T_end = np.asarray(
            robot.get_global_link_transform(cfg["link_gripper"], jnp.asarray(plan[:, -1]))
        )
        assert np.linalg.norm(T_end[:3, 3] - PANDA_RT[:3, 3]) < 0.03


class TestGraspPipeline:
    @pytest.mark.slow
    def test_full_pipeline_synthetic_camera(self, panda, data_dir):
        """Smoke the whole pipeline with a synthetic overhead depth camera:
        a flat floor plane plus grasp candidates around the fixed grasp."""
        robot, cfg = panda
        gripper = GTORobotModel(
            model_dir=f"{data_dir}/robots/panda",
            urdf_filename=f"{data_dir}/robots/panda/panda_gripper.urdf",
            dtype=jnp.float64,
        )
        pipeline = GraspPipeline(
            robot, gripper, cfg["link_ee"], cfg["link_gripper"],
            axis_standoff=cfg["axis_standoff"],
            gripper_open_offsets=cfg["gripper_open_offsets"],
            goal_capacity=4,
        )

        # overhead camera 1.4 m above the workspace looking straight down
        H = W = 64
        K = np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]])
        cam_pose = np.eye(4)
        cam_pose[:3, 3] = [0.45, 0.0, 1.4]
        cam_pose[:3, :3] = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]])  # z down
        depth = np.full((H, W), 1.4, dtype=np.float32)  # floor at z=0
        target_mask = np.zeros((H, W), dtype=bool)
        target_mask[28:36, 28:36] = True

        RTs = np.tile(PANDA_RT[None], (3, 1, 1))
        RTs[1, 2, 3] += 0.03
        RTs[2, 1, 3] += 0.03

        result = pipeline.plan_object(
            PANDA_DEFAULT, depth, K, cam_pose, target_mask, RTs
        )
        assert result.stage == "ok", result
        assert result.plan.shape == (robot.ndof, 50)
        assert result.n_ik_found >= 1
        T_end = np.asarray(
            robot.get_global_link_transform(cfg["link_gripper"], jnp.asarray(result.plan[:, -1]))
        )
        errs = np.linalg.norm(RTs[:, :3, 3] - T_end[:3, 3], axis=1)
        assert errs.min() < 0.03, f"goal errors {errs}"

    def test_coarse_knobs_reach_planner(self, panda, data_dir):
        """The benchmarked solver flavor (single-pass LM, coarse phase with
        a stride) must be expressible through the pipeline so closed-loop
        evaluation validates exactly the benchmarked configuration."""
        robot, cfg = panda
        gripper = GTORobotModel(
            model_dir=f"{data_dir}/robots/panda",
            urdf_filename=f"{data_dir}/robots/panda/panda_gripper.urdf",
            dtype=jnp.float64,
        )
        pipeline = GraspPipeline(
            robot, gripper, cfg["link_ee"], cfg["link_gripper"],
            planner_iterations=4, planner_single_pass=True,
            planner_coarse_iterations=2, planner_coarse_stride=4,
        )
        assert pipeline.planner.iterations == 4
        assert pipeline.planner.single_pass
        assert pipeline.planner.coarse_iterations == 2
        assert pipeline.planner.coarse_stride == 4

    @pytest.mark.slow
    def test_rescue_branch_recovers_bad_goalset_plan(self, panda, data_dir):
        """Drive plan_object's rescue path end-to-end: force the goal-set
        solve to return a useless constant plan and assert the batched
        per-goal rescue replaces it with a plan that reaches a goal."""
        robot, cfg = panda
        gripper = GTORobotModel(
            model_dir=f"{data_dir}/robots/panda",
            urdf_filename=f"{data_dir}/robots/panda/panda_gripper.urdf",
            dtype=jnp.float64,
        )
        pipeline = GraspPipeline(
            robot, gripper, cfg["link_ee"], cfg["link_gripper"],
            axis_standoff=cfg["axis_standoff"],
            gripper_open_offsets=cfg["gripper_open_offsets"],
            goal_capacity=4,
        )
        H = W = 64
        K = np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]])
        cam_pose = np.eye(4)
        cam_pose[:3, 3] = [0.45, 0.0, 1.4]
        cam_pose[:3, :3] = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]])
        depth = np.full((H, W), 1.4, dtype=np.float32)
        target_mask = np.zeros((H, W), dtype=bool)
        target_mask[28:36, 28:36] = True
        RTs = np.tile(PANDA_RT[None], (3, 1, 1))
        RTs[1, 2, 3] += 0.03
        RTs[2, 1, 3] += 0.03

        def bad_goalset(*args, **kwargs):
            Q = np.tile(PANDA_DEFAULT[:, None], (1, 50))
            return Q, np.zeros((robot.ndof, 49)), np.array([1e6])

        pipeline.planner.plan_goalset = bad_goalset
        result = pipeline.plan_object(
            PANDA_DEFAULT, depth, K, cam_pose, target_mask, RTs
        )
        assert result.stage == "ok"
        assert result.rescued, "rescue should replace the constant plan"
        T_end = np.asarray(
            robot.get_global_link_transform(cfg["link_ee"], jnp.asarray(result.plan[:, -1]))
        )
        errs = np.linalg.norm(RTs[:, :3, 3] - T_end[:3, 3], axis=1)
        assert errs.min() < 0.02, f"rescued plan goal errors {errs}"
        # dQ of the rescued plan follows the planner's convention
        np.testing.assert_allclose(
            result.dQ, pipeline.planner.dq_of(result.plan), atol=1e-12
        )

    @pytest.mark.slow
    def test_truncate_before_collision(self, panda, data_dir):
        """The safe-decline fallback: a plan that sweeps the arm through a
        wall must come back held at its last collision-free step, and the
        held plan must replay clean under the scorer's own criterion."""
        import numpy as np

        from grasptrajopt_tpu.fields import DepthPointCloud
        from grasptrajopt_tpu.planning.evaluate import check_plan_collision

        robot, cfg = panda
        gripper = GTORobotModel(
            model_dir=f"{data_dir}/robots/panda",
            urdf_filename=f"{data_dir}/robots/panda/panda_gripper.urdf",
            dtype=jnp.float64,
        )
        pipeline = GraspPipeline(
            robot, gripper, cfg["link_ee"], cfg["link_gripper"],
            axis_standoff=cfg["axis_standoff"],
            gripper_open_offsets=cfg["gripper_open_offsets"],
        )
        # camera above, wall plane at z=1 in camera frame -> world z.
        # Build a depth wall IN FRONT of the reaching arm: camera at the
        # robot side looking +z(world x?) — simplest: camera at origin
        # looking along +z with the wall at 0.55 m, robot base at origin;
        # a straight-line reach through x=0.55 crosses it.
        H = W = 96
        K = np.array([[60.0, 0, 48], [0, 60.0, 48], [0, 0, 1]])
        depth = np.full((H, W), 0.55, np.float64)
        pose = np.array([  # camera frame z -> world x
            [0.0, 0.0, 1.0, 0.0],
            [0.0, 1.0, 0.0, 0.0],
            [-1.0, 0.0, 0.0, 0.8],
            [0, 0, 0, 1.0],
        ])
        dpc = DepthPointCloud(depth, K, pose, threshold=1.5)
        qc = np.asarray(cfg["default_pose"])
        ndof = len(qc)
        T = 12
        # sweep joint 1 forward so the arm reaches through the wall plane
        plan = np.tile(qc[:, None], (1, T))
        plan[1] = np.linspace(qc[1], 1.5, T)
        plan[3] = np.linspace(qc[3], -0.4, T)
        assert check_plan_collision(robot, plan, dpc, (0, 0, 0))[0]
        trunc = pipeline._truncate_before_collision(plan, dpc, (0, 0, 0))
        assert trunc is not None
        collided, _ = check_plan_collision(robot, trunc, dpc, (0, 0, 0))
        assert not collided
        # the held tail is constant at the last clean step
        diffs = np.abs(np.diff(trunc, axis=1)).sum(axis=0)
        assert diffs[-1] == 0.0

    def test_escalation_branch_fixes_replay_collision(self, panda, data_dir):
        """The exact-geometry escalation tier: force BOTH the goal-set solve
        and the field-mode per-goal rescue to return a plan that collides
        with the floor in replay; the points-mode escalation (exact signed
        distances at boosted obstacle weight) must replace it with a
        collision-free reaching plan."""
        from grasptrajopt_tpu.planning.evaluate import score_plan

        robot, cfg = panda
        gripper = GTORobotModel(
            model_dir=f"{data_dir}/robots/panda",
            urdf_filename=f"{data_dir}/robots/panda/panda_gripper.urdf",
            dtype=jnp.float64,
        )
        pipeline = GraspPipeline(
            robot, gripper, cfg["link_ee"], cfg["link_gripper"],
            axis_standoff=cfg["axis_standoff"],
            gripper_open_offsets=cfg["gripper_open_offsets"],
            goal_capacity=4,
            planner_iterations=30,
            escalate_points_capacity=2048,
            escalate_target_capacity=128,
        )
        H = W = 64
        K = np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]])
        cam_pose = np.eye(4)
        cam_pose[:3, 3] = [0.45, 0.0, 1.4]
        cam_pose[:3, :3] = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]])
        depth = np.full((H, W), 1.4, dtype=np.float32)
        target_mask = np.zeros((H, W), dtype=bool)
        target_mask[28:36, 28:36] = True
        RTs = np.tile(PANDA_RT[None], (3, 1, 1))
        RTs[1, 2, 3] += 0.03
        RTs[2, 1, 3] += 0.03

        # a configuration whose GRIPPER digs into the floor plane: IK to
        # the test grasp pushed down to z = 0.04, putting the fingertip
        # surface points a few cm below the observed floor — a genuine
        # plan-induced penetration (the scorer's baseline-contact
        # exclusion ignores resting contacts like the fixed base sitting
        # exactly on the floor plane, so a merely low-swinging arm no
        # longer counts as colliding)
        RT_low = PANDA_RT.copy()
        RT_low[2, 3] = 0.04
        q_low, low_pos, _, _ = pipeline.ik_solver.solve_ik_batch(
            np.tile(PANDA_DEFAULT, (4, 1)),
            np.tile(RT_low[None], (4, 1, 1)),
            multistart=True,
        )
        assert float(np.min(low_pos)) < 0.01, "test setup: low IK must reach"
        q_dip = np.asarray(q_low[int(np.argmin(low_pos))])
        bad_plan = np.tile(q_dip[:, None], (1, 50))
        bad_plan[:, 0] = PANDA_DEFAULT

        def bad_goalset(*args, **kwargs):
            return bad_plan.copy(), np.zeros((robot.ndof, 49)), np.array([1e6])

        def bad_pergoal(qc, RTs_in, *args, **kwargs):
            n = np.asarray(RTs_in).shape[0]
            return (
                np.tile(bad_plan[None], (n, 1, 1)),
                np.full(n, 1e6),
            )

        pipeline.planner.plan_goalset = bad_goalset
        pipeline.planner.plan_pergoal_batch = bad_pergoal
        result = pipeline.plan_object(
            PANDA_DEFAULT, depth, K, cam_pose, target_mask, RTs
        )
        assert result.stage == "ok"
        assert result.escalated, "escalation tier should replace the colliding plan"

        # self-validate the setup: the forced plan really does collide
        depth_pc, depth_pc_obstacle, _, _ = pipeline.build_fields(
            depth, K, cam_pose, target_mask
        )
        s_bad = score_plan(
            robot, cfg["link_ee"], bad_plan, RTs, depth_pc_obstacle, [0, 0, 0]
        )
        assert s_bad["collision"], "test setup: forced plan must collide in replay"

        s = score_plan(
            robot, cfg["link_ee"], result.plan, RTs, depth_pc_obstacle, [0, 0, 0]
        )
        assert not s["collision"], f"escalated plan still collides: {s}"
        assert s["reached"], f"escalated plan misses the goal: {s}"

    @pytest.mark.slow
    def test_pergoal_rescue_batch(self, panda):
        """The rescue path: every per-goal solve must reach ITS OWN goal
        (one-hot masks on the shared goal-set program, per-candidate warm
        starts) — three distinct grasp poses, three independent plans."""
        robot, cfg = panda
        ik = IKSolver(robot, cfg["link_ee"], cfg["link_gripper"])
        ik.setup_optimization(robot.grid)

        RTs = np.tile(PANDA_RT[None], (3, 1, 1))
        RTs[1, :3, 3] += [0.0, 0.06, 0.0]
        RTs[2, :3, 3] += [-0.05, 0.0, 0.06]
        zeros = np.zeros(robot.field_size)
        q_sols = []
        for i in range(3):
            q_sol, err_pos, err_rot, _ = ik.solve_ik(
                PANDA_DEFAULT, RTs[i], zeros, np.zeros(3), multistart=True
            )
            assert err_pos < 0.01 and err_rot < 5.0, (i, err_pos, err_rot)
            q_sols.append(np.asarray(q_sol))
        q_solutions = np.stack(q_sols, axis=1)  # (ndof, 3)

        planner = GTOPlanner(
            robot, cfg["link_ee"], cfg["link_gripper"], iterations=25,
            single_pass=True,
        )
        Q, cost = planner.plan_pergoal_batch(
            PANDA_DEFAULT, RTs, zeros, zeros, np.zeros(3), q_solutions,
            axis_standoff=cfg["axis_standoff"], goal_capacity=4,
        )
        assert Q.shape == (3, robot.ndof, 50)
        assert np.isfinite(cost).all()
        for i in range(3):
            T_end = np.asarray(
                robot.get_global_link_transform(cfg["link_ee"], jnp.asarray(Q[i, :, -1]))
            )
            err = np.linalg.norm(RTs[i, :3, 3] - T_end[:3, 3])
            assert err < 0.02, f"goal {i} err {err}"


class TestSyntheticPipeline:
    """plan_object with no assets: the in-repo synthetic arm and its
    gripper (grasptrajopt_tpu/testing.py) on a rendered tabletop scene."""

    def test_plan_object_reaches_plan_stage(self):
        from grasptrajopt_tpu.envs.synthetic import SyntheticSceneEnv
        from grasptrajopt_tpu.testing import (
            SYNTH_DEFAULT_POSE,
            SYNTH_GRIPPER_OPEN,
            SYNTH_LINK_EE,
            SYNTH_LINK_GRIPPER,
            make_synthetic_gripper,
            make_synthetic_gto_robot,
        )

        robot = make_synthetic_gto_robot(points_per_link=10)
        gripper = make_synthetic_gripper(points_per_link=20)
        pts, _ = gripper.compute_fk_surface_points(np.asarray(SYNTH_GRIPPER_OPEN))
        assert pts.shape == (60, 3)
        env = SyntheticSceneEnv(scene_type="tabletop", n_objects=1, width=64, height=64)
        meta = env.setup_scene(10)
        env.reset_scene()
        name = meta["nearest_first"].split(",")[0]
        depth, ids, cam_pose, K = env.get_observation()
        pipeline = GraspPipeline(
            robot, gripper, SYNTH_LINK_EE, SYNTH_LINK_GRIPPER,
            axis_standoff="z", gripper_open_offsets=SYNTH_GRIPPER_OPEN,
            goal_capacity=16, grid=robot.grid, ik_capacity=16,
            planner_iterations=3, planner_single_pass=True,
            planner_coarse_iterations=2, planner_final_trust=True,
            ik_iterations=24, rescue=False, escalate=False,
        )
        res = pipeline.plan_object(
            SYNTH_DEFAULT_POSE, depth, K, cam_pose, ids == env._placed(name).uid,
            env.grasps_world(name), base_position=env.base_position,
        )
        assert res.stage == "ok", res
        assert res.plan.shape == (robot.ndof, 50) and np.isfinite(res.plan).all()
        assert res.n_ik_found >= 1
