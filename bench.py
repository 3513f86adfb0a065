"""Benchmark: collision-aware grasp-trajectory solves per second on a GPU.

Measures the flagship path — batched goal-set trajectory optimization
(GTOPlanner core program: 50-step horizon, goal-set point matching with
standoff, trilinear SDF obstacle cost over all body surface points, box
limits, projected-LM iterations at a per-robot validated budget: panda 3
with final_trust, fetch 6, coarse-fidelity first half) — and reports
throughput against the
reference's CPU pipeline, PLUS plan-quality gates: the timed plans are
checked for goal reach (final end-effector pose within the reference's IK
acceptance gates, pybullet_gto_planning.py:262) and collision (> 5 body
points inside the analytic table slab at any step — the replay criterion
of pybullet_evaluate_plans.py:219-237, computable exactly here because the
bench obstacle is analytic).

Baseline (BASELINE.md): the reference's mean planning time per object is
10.25 s on the Panda tabletop split => 0.0976 plans/s. Its solves are
Ipopt with max_iter=100 on the same problem shape (T=50, ~1.2k surface
points, 1e5+ voxel field).

Knobs (env): BENCH_BATCH, BENCH_GOALS, BENCH_ITERS, BENCH_PPL, BENCH_REPS,
BENCH_ROBOT (panda|fetch), BENCH_MODE (field|points), BENCH_SHARED,
BENCH_STANDOFF (-0.1 tabletop / -0.2 shelf knob), BENCH_MESH (N>1: shard
the batch over an N-device mesh via parallel/sharded — per-problem-fields
mode), BENCH_QUALITY (0 to skip the quality pass), BENCH_1PASS (0: classic
two-pass LM iterations), BENCH_WARM (0: cold constant-pose warm start
instead of the reference-style IK warm start), BENCH_STACKED (per-problem
fields packed into one flat table riding the shared-gather path),
BENCH_INFLIGHT / BENCH_PIPE_REPS (steady-state pipelining depth / length —
the headline value is sustained throughput with async dispatch overlapping
host dispatch and device execution; single-batch latency stays in detail),
BENCH_T (horizon) / BENCH_CR (cyclic-reduction KKT for long horizons),
BENCH_GOALW (terminal goal-row weight; ~4 for deep standoffs),
BENCH_COARSE / BENCH_COARSE_STRIDE (coarse-fidelity obstacle phase;
0 restores the plain full-fidelity schedule), BENCH_TRUST (final_trust:
return the budget's final KKT trial point unevaluated; default 1 on
panda, 0 elsewhere), BENCH_E2E (0 skips the end-to-end perception->plan
pipeline block, bench_e2e.py), BENCH_E2E_FETCH (0 skips the fetch e2e
row), BENCH_COHERENCE (goal-coherence bias toward the warm start's goal;
0 = reference-parity argmin), BENCH_ATTRIBUTION (0 skips the profiled
device-time attribution block), BENCH_PROFILE=<dir> (keep a device trace
of one step for tools/trace_report.py).

Runs on the GPU; it refuses any other backend unless JAX_PLATFORMS=cpu
was asked for explicitly (a small logic check, never device numbers).
Failures propagate: a phase that raises fails the run.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"quality", "attribution", "e2e", "e2e_fetch"}.
"""

import json
import os
import sys
import time

import numpy as np

BASELINE_PLANS_PER_S = 1.0 / 10.25  # Panda tabletop GTO mean planning time

# analytic table slab (world frame): the bench scene's obstacle
SLAB_X = (0.2, 0.9)
SLAB_Y = (-0.6, 0.6)
SLAB_Z = (0.10, 0.15)


def slab_signed_distance(pts: np.ndarray) -> np.ndarray:
    """Exact signed distance to the axis-aligned table slab (negative
    inside) — standard box SDF."""
    center = np.array([np.mean(SLAB_X), np.mean(SLAB_Y), np.mean(SLAB_Z)])
    half = np.array([
        (SLAB_X[1] - SLAB_X[0]) / 2,
        (SLAB_Y[1] - SLAB_Y[0]) / 2,
        (SLAB_Z[1] - SLAB_Z[0]) / 2,
    ])
    d = np.abs(pts - center) - half
    outside = np.linalg.norm(np.maximum(d, 0.0), axis=-1)
    inside = np.minimum(np.max(d, axis=-1), 0.0)
    return outside + inside


def make_cost_field(grid, epsilon: float = 0.02) -> np.ndarray:
    """The reference's eps-band shaped obstacle cost of the analytic slab
    (depth_point_cloud.py:65-91 semantics on exact distances)."""
    d = slab_signed_distance(grid.grid_points().astype(np.float64))
    cost = np.zeros_like(d)
    inside = d <= 0
    band = (d > 0) & (d < epsilon)
    cost[inside] = -d[inside] + epsilon / 2
    cost[band] = np.square(d[band] - epsilon) / (2 * epsilon)
    return cost.astype(np.float32)


def make_goal_sets(RT_base: np.ndarray, batch: int, cap: int, rng) -> np.ndarray:
    """Diverse reachable goal sets: per problem a position offset over the
    table and a base yaw; per goal slot an additional yaw about world z
    (grasp symmetry family) plus small positional jitter."""
    RT = RT_base.copy()
    RT[2, 3] += 0.08  # fingertips clear the slab top by > the eps band
    tf_goal = np.tile(RT, (batch, cap, 1, 1)).astype(np.float32)
    d_pos = np.stack(
        [
            rng.uniform(-0.08, 0.08, size=(batch,)),
            rng.uniform(-0.15, 0.15, size=(batch,)),
            rng.uniform(0.0, 0.08, size=(batch,)),
        ],
        axis=-1,
    )
    base_yaw = rng.uniform(-np.pi, np.pi, size=(batch,))
    for b in range(batch):
        for g in range(cap):
            yaw = base_yaw[b] + g * (2 * np.pi / cap)
            c, s = np.cos(yaw), np.sin(yaw)
            Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            tf_goal[b, g, :3, :3] = Rz @ tf_goal[b, g, :3, :3]
            tf_goal[b, g, :3, 3] += d_pos[b] + rng.normal(scale=0.005, size=3)
    return tf_goal


def main():
    # Configuration via env for experimentation; defaults sized for one chip.
    batch = int(os.environ.get("BENCH_BATCH", "32"))
    goal_capacity = int(os.environ.get("BENCH_GOALS", "8"))
    robot_name = os.environ.get("BENCH_ROBOT", "panda")
    # Per-robot LM iteration budget — the lowest validated green on the
    # bench quality gates for THAT robot (PERF.md round-3/4/5 sweeps):
    #   panda: 3 (gates green with error stats identical to budgets 4-50;
    #     closed-loop at exactly this flavor — 3 iters, coarse 2+1,
    #     single-pass, final_trust — tabletop 50/50, shelf 23/25 with the
    #     budget-independent thin-object failure set, results/synthetic_r4)
    #   fetch: 6 (at 4 the 15-DoF reach gate slips to 0.938 — two of 32
    #     plans miss the 5-degree rotation gate; 6 keeps reached 1.0)
    # The reference runs Ipopt with up to 100 interior-point iterations on
    # the same warm-start scheme.
    default_iters = {"fetch": 6}.get(robot_name, 3)
    iterations = int(os.environ.get("BENCH_ITERS", str(default_iters)))
    points_per_link = int(os.environ.get("BENCH_PPL", "100"))
    reps = int(os.environ.get("BENCH_REPS", "2"))
    obstacle_mode = os.environ.get("BENCH_MODE", "field")  # field | points
    standoff_distance = float(os.environ.get("BENCH_STANDOFF", "-0.1"))
    mesh_devices = int(os.environ.get("BENCH_MESH", "0"))
    with_quality = os.environ.get("BENCH_QUALITY", "1") == "1"
    # default: the scene (cost fields / point sets) is shared across the
    # batch — the reference's own deployment shape (one observed scene,
    # many objects/goal-sets/seeds, pybullet_gto_planning.py:151-164);
    # BENCH_SHARED=0 gives every problem its own scene
    shared_scene = os.environ.get("BENCH_SHARED", "1") == "1"
    scene_capacity = int(os.environ.get("BENCH_SCENE_PTS", "2048"))
    data_dir = os.environ.get("GTO_DATA_DIR", "/root/reference/data")
    if mesh_devices:
        shared_scene = False  # mesh mode shards every argument leaf

    import jax
    import jax.numpy as jnp

    from grasptrajopt_tpu.utils.device import enable_compile_cache, require_gpu

    require_gpu(allow_requested_cpu=True)
    enable_compile_cache()
    device = jax.devices()[0]

    from grasptrajopt_tpu.planning.gto_planner import GTOPlanner
    from grasptrajopt_tpu.planning.gto_models import GTORobotModel

    use_reference_robot = os.path.isdir(os.path.join(data_dir, "robots", robot_name))
    if use_reference_robot:
        from grasptrajopt_tpu.planning.utils import load_robot_config

        cfg = load_robot_config(robot_name, data_dir)
        # config paths are "data/..." relative to the tree that CONTAINS data/
        urdf_rel = cfg["urdf_robot_path"].split("data/", 1)[-1]
        robot = GTORobotModel(
            model_dir=os.path.join(data_dir, "robots", cfg["robot_name"]),
            urdf_filename=os.path.join(data_dir, urdf_rel),
            time_derivs=[0, 1],
            param_joints=cfg["param_joints"],
            collision_link_names=cfg["collision_link_names"],
            points_per_link=points_per_link,
            dtype=jnp.float32,
        )
        robot.setup_workspace_field(arm_len=cfg["arm_len"], arm_height=cfg["arm_height"])
        link_ee, link_gripper = cfg["link_ee"], cfg["link_gripper"]
        axis_standoff = cfg["axis_standoff"]
        qc = np.asarray(cfg["default_pose"], np.float32)
        # representative grasp (the reference mains' fixed test grasp)
        RT = np.array(
            [
                [-0.61162336, 0.79089652, 0.01998741, 0.46388378],
                [0.7883297, 0.6071185, 0.09971584, -0.15167381],
                [0.06673018, 0.07674521, -0.99481508, 0.22877409],
                [0.0, 0.0, 0.0, 1.0],
            ],
            dtype=np.float32,
        )
        if robot_name == "fetch":
            # fetch's workspace sits 1.1 m up (torso); lift the test grasp
            # to tabletop height in front of the robot
            RT[:2, 3] = [0.55, 0.0]
            RT[2, 3] = 0.85
    else:
        from grasptrajopt_tpu.testing import (
            SYNTH_DEFAULT_POSE,
            SYNTH_LINK_EE,
            SYNTH_LINK_GRIPPER,
            make_synthetic_goal,
            make_synthetic_gto_robot,
        )

        robot = make_synthetic_gto_robot(points_per_link=points_per_link)
        link_ee, link_gripper = SYNTH_LINK_EE, SYNTH_LINK_GRIPPER
        axis_standoff = "z"
        qc = SYNTH_DEFAULT_POSE.astype(np.float32)
        RT = make_synthetic_goal(0).astype(np.float32)

    field_dtype = jnp.bfloat16 if os.environ.get("BENCH_BF16", "0") == "1" else None
    lm_alphas = None
    if os.environ.get("BENCH_ALPHAS"):
        lm_alphas = tuple(float(a) for a in os.environ["BENCH_ALPHAS"].split(","))
    # delayed-gratification LM: one residual/jac pass per iteration (same
    # quality at the same iteration budget, one pass fewer per iteration;
    # PERF.md, carried findings) — BENCH_1PASS=0 for the classic two-pass
    # iteration
    single_pass = os.environ.get("BENCH_1PASS", "1") == "1"
    stacked = os.environ.get("BENCH_STACKED", "0") == "1"
    if stacked:
        shared_scene = False  # stacked measures the per-problem-field path
    # BENCH_CR=1: parallel-in-time cyclic-reduction KKT solve
    cyclic_reduction = os.environ.get("BENCH_CR", "0") == "1"
    # BENCH_GOALW: terminal goal-row weight (1.0 = reference parity; ~4
    # counters the deep-standoff rotation equilibrium, PERF.md)
    goal_weight = float(os.environ.get("BENCH_GOALW", "1.0"))
    # BENCH_T: trajectory horizon (50 = reference parity; long horizons
    # pair with BENCH_CR=1 for the parallel-in-time KKT solve)
    horizon = int(os.environ.get("BENCH_T", "50"))
    # BENCH_COARSE: first k LM iterations evaluate the obstacle term on a
    # BENCH_COARSE_STRIDE-subsampled surface point set (multigrid-in-
    # fidelity; the fine phase pins the equilibrium at reference fidelity).
    # Default: half the iteration budget (2+2 at the panda default, 3+3 at
    # fetch's 6) — validated like the budget itself: every even-split
    # schedule tried leaves the bench error stats identical to the plain
    # schedule (PERF.md rounds 3-4), closed-loop tabletop 50/50 with
    # 0 collisions running single-pass + coarse inside the pipeline.
    # BENCH_COARSE=0 restores the plain full-fidelity schedule. The
    # default is capped at 3: only splits up to 3+3 have been validated,
    # and a BENCH_ITERS=50 parity run should not silently become 25+25.
    # Round-up division gives the VALIDATED splits at every per-robot
    # default: 3 -> 2+1, 4 -> 2+2, 6 -> 3+3 (closed-loop sweeps in
    # results/synthetic_r{3,4}).
    coarse_iterations = int(
        os.environ.get("BENCH_COARSE", str(min(3, (iterations + 1) // 2)))
    )
    coarse_stride = int(os.environ.get("BENCH_COARSE_STRIDE", "2"))
    # BENCH_TRUST=1: return the budget's final KKT trial point unevaluated
    # (skips the post-scan residual pass — one full field-gather pass per
    # solve; TrajectoryConfig.final_trust). Default ON for panda: the
    # exact shipped flavor (3 iters, coarse 2+1, single-pass, trust) is
    # closed-loop validated on both scene types (results/synthetic_r4).
    # Fetch stays opt-in (trust failed its shelf sweep, PERF.md).
    # The DEFAULT is also dropped when the config drifts from the
    # validated flavor — points mode, or an explicit BENCH_ITERS override
    # (a BENCH_ITERS=50 parity run keeps the evaluated finish) — mirroring
    # the coarse-knob guards; BENCH_TRUST=1 always wins.
    default_trust = (
        "1"
        if (
            robot_name == "panda"
            and obstacle_mode == "field"
            and "BENCH_ITERS" not in os.environ
        )
        else "0"
    )
    final_trust = os.environ.get("BENCH_TRUST", default_trust) == "1"
    if not single_pass or obstacle_mode != "field":
        # the coarse phase is defined for the single-pass LM field path
        # only; the classic two-pass and points-mode configs run the plain
        # schedule rather than erroring under the default BENCH_COARSE
        coarse_iterations = 0
    if not single_pass:
        # final_trust is a single-pass LM feature; the two-pass config
        # runs the plain evaluated finish under the default BENCH_TRUST
        final_trust = False
    # BENCH_COHERENCE: goal-coherence bias of the per-iteration active-goal
    # selection toward the IK warm start's goal (GTOPlanner goal_coherence;
    # switch goals only when another is this factor cheaper). Targets the
    # synthetic 32-yaw goal families whose unbiased argmin can select a
    # member far from every warm start (PERF.md round-5 fetch
    # capacity); 0 = reference-parity plain argmin.
    goal_coherence = float(os.environ.get("BENCH_COHERENCE", "0"))
    planner = GTOPlanner(
        robot, link_ee, link_gripper, iterations=iterations, obstacle_mode=obstacle_mode,
        field_dtype=field_dtype, lm_alphas=lm_alphas, standoff_distance=standoff_distance,
        single_pass=single_pass, cyclic_reduction=cyclic_reduction,
        goal_weight=goal_weight, T=horizon,
        coarse_iterations=coarse_iterations, coarse_stride=coarse_stride,
        final_trust=final_trust, goal_coherence=goal_coherence,
    )
    solvers = planner.setup_optimization(
        goal_size=goal_capacity, use_standoff=True, axis_standoff=axis_standoff
    )
    solve_one = solvers.solve_one
    solve_batch = solvers.solve_batch
    solve_batch_shared = solvers.solve_batch_shared

    # Problem batch: diverse goal sets over the tabletop (per-problem
    # offsets + per-goal yaw family), eps-band shaped table-slab fields.
    rng = np.random.default_rng(0)
    if use_reference_robot:
        tf_goal = make_goal_sets(RT, batch, goal_capacity, rng)
    else:
        tf_goal = np.tile(RT, (batch, goal_capacity, 1, 1)).astype(np.float32)
        tf_goal[..., :3, 3] += rng.normal(
            scale=0.02, size=(batch, goal_capacity, 3)
        ).astype(np.float32)
    goal_mask = np.ones((batch, goal_capacity), dtype=bool)

    grid = robot.grid
    field = make_cost_field(grid)
    fields = np.tile(field, (batch, 1))

    opt_idx = robot.optimized_joint_indexes
    par_idx = robot.parameter_joint_indexes
    qc_opt = np.tile(qc[opt_idx], (batch, 1))
    q_param = np.tile(qc[par_idx], (batch, 1)) if par_idx else np.zeros((batch, 0), np.float32)
    X0 = np.tile(qc_opt[:, None, :], (1, planner.T - 2, 1))

    if os.environ.get("BENCH_WARM", "1") == "1":
        # IK warm starts, exactly the reference pipeline's structure (ranked
        # IK seeds -> interpolated trajectory, pybullet_gto_planning.py:242-295;
        # its reported planning_time likewise excludes ik_time). Without them
        # a few cold-started basins pass through the slab — with them the
        # quality gates hold at 0 collisions (PERF.md).
        from grasptrajopt_tpu.planning.ik_solver import IKSolver
        from grasptrajopt_tpu.planning.utils import interpolate_waypoints_jnp

        ik = IKSolver(robot, link_ee, link_gripper, collision_avoidance=False)
        qsol, ik_pos, ik_rot, _ = ik.solve_ik_batch(
            np.tile(qc, (batch * goal_capacity, 1)), tf_goal.reshape(-1, 4, 4)
        )
        # multistart RESCUE of the warm start, per problem, only where the
        # single-seed screen failed every goal: ~1/32 of the synthetic
        # fetch-32 goal families leaves a bad local minimum as the warm
        # start (goals-32 reach stuck at 0.969 at every budget while a
        # 16-seed IK reaches all 32 problems), but blanket multistart is
        # WORSE (0.844: far-from-rest IK configurations make bad seed
        # sweeps) — PERF.md round-6 fetch diagnosis. Untimed phase.
        err1 = (ik_pos + 2e-3 * ik_rot).reshape(batch, goal_capacity)
        hard = np.asarray(
            (ik_pos.reshape(batch, goal_capacity) > 0.01).all(axis=1)
        )
        if hard.any():
            qsol_m, pos_m, rot_m, _ = ik.solve_ik_batch(
                np.tile(qc, (batch * goal_capacity, 1)),
                tf_goal.reshape(-1, 4, 4), multistart=True,
            )
            err_m = (pos_m + 2e-3 * rot_m).reshape(batch, goal_capacity)
            sel = hard[:, None]
            err1 = np.where(sel, np.asarray(err_m), np.asarray(err1))
            qsol = np.where(
                np.repeat(hard, goal_capacity)[:, None],
                np.asarray(qsol_m), np.asarray(qsol),
            )
        err = err1
        warm_goal = np.argmin(err, axis=1)
        q_best = qsol.reshape(batch, goal_capacity, -1)[
            np.arange(batch), warm_goal
        ]
        X0 = np.asarray(
            jax.vmap(
                lambda qb: interpolate_waypoints_jnp(
                    jnp.asarray(qc), qb, planner.T - 2
                )
            )(jnp.asarray(q_best, np.float32))
        )[..., opt_idx]

    params = {
        "q_param": jnp.asarray(q_param),
        "tf_goal": jnp.asarray(tf_goal),
        "goal_mask": jnp.asarray(goal_mask),
        "base_position": jnp.zeros((batch, 3), jnp.float32),
    }
    if goal_coherence > 0 and os.environ.get("BENCH_WARM", "1") == "1":
        params["goal_seed"] = jnp.asarray(warm_goal, jnp.int32)
    scene_params = {}
    if obstacle_mode == "points":
        # the table slab top as a surface point set (upward normals)
        from grasptrajopt_tpu.fields.scene_points import downsample_scene

        xs, ys = np.meshgrid(
            np.arange(SLAB_X[0], SLAB_X[1], 0.01), np.arange(SLAB_Y[0], SLAB_Y[1], 0.01)
        )
        table_pts = np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, SLAB_Z[1])], axis=1)
        table_nrm = np.tile([0.0, 0.0, 1.0], (table_pts.shape[0], 1))
        # voxel size must scale with the point budget or the downsample
        # silently truncates coverage (BENCH_SCENE_PTS=512 at 0.02 m kept
        # only a corner of the slab and quality collapsed): the slab needs
        # area/res^2 <= capacity. The reference itself quantizes scene
        # geometry to 0.05 m (gto_models.py:45), so coarse is faithful.
        slab_area = (SLAB_X[1] - SLAB_X[0]) * (SLAB_Y[1] - SLAB_Y[0])
        scene_res = max(0.02, 1.05 * float(np.sqrt(slab_area / scene_capacity)))
        scene = downsample_scene(
            table_pts, table_nrm, capacity=scene_capacity, resolution=scene_res
        )
        target = downsample_scene(
            table_pts[:64] + [0, 0, 0.05], table_nrm[:64], capacity=256, resolution=0.02
        )
        scene_params = {
            "scene_points": jnp.asarray(scene.points, jnp.float32),
            "scene_normals": jnp.asarray(scene.normals, jnp.float32),
            "target_points": jnp.asarray(target.points, jnp.float32),
            "target_normals": jnp.asarray(target.normals, jnp.float32),
        }
    else:
        # Pack the corner-row gather tables ONCE per scene, outside the
        # timed step: the reference likewise builds its SDF cost field in
        # the perception phase ("checking_time"), never inside
        # planning_time (pybullet_gto_planning.py:181-203 vs :287-295).
        # The stacked path measures in-step packing by design.
        pack_pair = jax.jit(
            lambda fa, fo: jnp.concatenate(
                [
                    robot.grid.pack(fa, dtype=field_dtype),
                    robot.grid.pack(fo, dtype=field_dtype),
                ],
                axis=0,
            )
        )
        field_j = jnp.asarray(field)
        scene_params = {"packed_fields": pack_pair(field_j, field_j)}
    if not shared_scene and not (stacked and obstacle_mode == "field"):
        params.update(
            {k: jnp.broadcast_to(v, (batch,) + v.shape) for k, v in scene_params.items()}
        )
    qc_opt = jnp.asarray(qc_opt)
    X0 = jnp.asarray(X0)

    mesh_info = None
    if mesh_devices:
        from jax.sharding import Mesh

        from grasptrajopt_tpu.parallel.sharded import make_sharded_solver

        devices = jax.devices()[:mesh_devices]
        assert len(devices) == mesh_devices, (
            f"BENCH_MESH={mesh_devices} but only {len(devices)} devices"
        )
        assert batch % mesh_devices == 0, "batch must divide the mesh"
        mesh = Mesh(np.array(devices), ("dp",))
        sharded = make_sharded_solver(solve_one, mesh)
        mesh_info = f"{mesh_devices}x{devices[0].platform}"

        def step():
            (Q, cost, aux), metrics = sharded(qc_opt, X0, params)
            return Q, cost, aux

    elif shared_scene:

        def step():
            return solve_batch_shared(qc_opt, X0, params, scene_params)

    elif stacked and obstacle_mode == "field":
        # per-problem fields through the shared-gather path: one flat
        # (B*2S, 8) table + per-problem row bases, packed inside the step
        fields_all_b = jnp.broadcast_to(jnp.asarray(field), (batch, field.size))
        fields_obs_b = fields_all_b

        @jax.jit
        def step_stacked(fa, fo, qc_opt_, X0_, params_):
            tables, base = planner.pack_stacked_fields(fa, fo)
            return solvers.solve_batch_stacked(
                qc_opt_, X0_, {**params_, "field_base": base},
                {"packed_fields": tables},
            )

        def step():
            return step_stacked(fields_all_b, fields_obs_b, qc_opt, X0, params)

    else:

        def step():
            return solve_batch(qc_opt, X0, params)

    # Warmup / compile
    t0 = time.time()
    Q, cost, _ = step()
    Q.block_until_ready()
    compile_s = time.time() - t0

    times = []
    for _ in range(reps):
        t0 = time.time()
        Q, cost, _ = step()
        Q.block_until_ready()
        times.append(time.time() - t0)
    best = min(times)

    # Steady-state throughput: issue several steps back-to-back with a
    # bounded number outstanding (parallel/streaming.py). Async dispatch
    # overlaps host dispatch with device execution — the sustained rate of
    # a saturated card, which is the deployment shape (the latency of ONE
    # batch is reported separately as step_s). The depth is not tuned for
    # the card yet (ROADMAP S8).
    from grasptrajopt_tpu.parallel import stream_map

    inflight = int(os.environ.get("BENCH_INFLIGHT", "4"))
    pipe_reps = int(os.environ.get("BENCH_PIPE_REPS", str(max(reps, 5))))
    t0 = time.time()
    for _ in stream_map(lambda: step(), [()] * pipe_reps, inflight=inflight):
        pass
    pipe_total = time.time() - t0
    plans_per_s = pipe_reps * batch / pipe_total

    if os.environ.get("BENCH_PROFILE"):
        # device trace of one step (histogram with tools/trace_report.py)
        import jax.profiler

        jax.profiler.start_trace(os.environ["BENCH_PROFILE"])
        Q, cost, _ = step()
        Q.block_until_ready()
        jax.profiler.stop_trace()

    # attribution block: device busy share, % device time per op family
    # from a profiled step, and the achieved bytes/s of the obstacle-term
    # row gather against the card's HBM peak. Default on for GPU runs
    # (BENCH_ATTRIBUTION=0 to skip; one extra step outside the timed
    # region).
    attribution = None
    if (
        os.environ.get("BENCH_ATTRIBUTION", "1") == "1"
        and device.platform == "gpu"
        and not mesh_devices
    ):
        from grasptrajopt_tpu.utils.attribution import profile_step

        # analytic gather workload of ONE step: one packed corner-row
        # gather (8 floats) per (problem, step, surface point) per LM
        # iteration — coarse iterations at the stride subsample, plus
        # the final evaluated pass unless final_trust skips it
        # (opt/trajectory.py delayed-gratification structure)
        P = robot.num_surface_points
        p_coarse = -(-P // coarse_stride)
        full_passes = (iterations - coarse_iterations) + (0 if final_trust else 1)
        rows = batch * planner.T * (coarse_iterations * p_coarse + full_passes * P)
        itemsize = 2 if field_dtype is not None else 4
        attribution = profile_step(
            step, device.device_kind, gather_bytes=rows * 8 * itemsize
        )

    quality = None
    if with_quality and use_reference_robot:
        # -- plan-quality gates (outside the timed region) --------------------
        from grasptrajopt_tpu.spatial import r2quat
        from grasptrajopt_tpu.spatial.quaternion import qangle_deg

        q_param_b = jnp.broadcast_to(
            jnp.asarray(q_param)[:, None, :], (batch, planner.T, q_param.shape[1])
        )
        Q_full = jax.jit(jax.vmap(jax.vmap(robot.assemble_q)))(Q, q_param_b)
        T_end = robot.get_global_link_transform(link_ee, Q_full[:, -1])  # (B, 4, 4)
        d = np.linalg.norm(
            np.asarray(tf_goal)[:, :, :3, 3] - np.asarray(T_end)[:, None, :3, 3], axis=-1
        )  # (B, cap)
        qg = r2quat(jnp.asarray(tf_goal)[..., :3, :3])
        qe = r2quat(jnp.asarray(T_end)[:, None, :3, :3])
        rot = np.asarray(qangle_deg(qg, jnp.broadcast_to(qe, qg.shape)))  # (B, cap)
        reached = ((d < 0.01) & (rot < 5.0)).any(axis=1)
        best_goal = np.argmin(d + rot * 2e-3, axis=1)
        err_pos = d[np.arange(batch), best_goal]
        err_rot = rot[np.arange(batch), best_goal]

        pts = np.asarray(
            jax.jit(robot.fk_surface_points)(Q_full)
        )  # (B, T, P, 3)
        inside = (
            (pts[..., 0] > SLAB_X[0]) & (pts[..., 0] < SLAB_X[1])
            & (pts[..., 1] > SLAB_Y[0]) & (pts[..., 1] < SLAB_Y[1])
            & (pts[..., 2] > SLAB_Z[0]) & (pts[..., 2] < SLAB_Z[1])
        )
        counts = inside.sum(axis=-1)  # (B, T)
        collision = (counts > 5).any(axis=-1)
        quality = {
            "reached_frac": round(float(reached.mean()), 3),
            "collision_frac": round(float(collision.mean()), 3),
            "err_pos_median": round(float(np.median(err_pos)), 4),
            "err_pos_p90": round(float(np.quantile(err_pos, 0.9)), 4),
            "err_rot_median_deg": round(float(np.median(err_rot)), 2),
            "max_inside_points": int(counts.max()),
        }

    result = {
        "metric": "grasp_trajectory_solves_per_s",
        "value": round(plans_per_s, 3),
        "unit": "plans/s per device",
        "vs_baseline": round(plans_per_s / BASELINE_PLANS_PER_S, 1),
        "device": {
            "platform": device.platform,
            "kind": device.device_kind,
            "count": len(jax.devices()),
        },
    }
    if quality is not None:
        result["quality"] = quality
    if attribution is not None:
        result["attribution"] = attribution

    # end-to-end perception -> IK -> plan pipeline block (bench_e2e.py):
    # objects/s with per-phase device times vs the reference's 12.84 s/object
    # (0.60 check + 1.99 IK + 10.25 plan, BASELINE.md). BENCH_E2E=0 skips.
    if (
        os.environ.get("BENCH_E2E", "1") == "1"
        and use_reference_robot
        and robot_name == "panda"
        and not mesh_devices
    ):
        from bench_e2e import run_e2e

        result["e2e"] = run_e2e()
        # fetch e2e row: param joints, 15 DoF, and the rescue tier
        # exercised at fetch's own validated flavor (6 iters coarse 3+3,
        # evaluated finish). BENCH_E2E_FETCH=0 skips.
        if os.environ.get("BENCH_E2E_FETCH", "1") == "1":
            result["e2e_fetch"] = run_e2e("fetch")
    print(json.dumps(result))
    print(
        json.dumps(
            {
                "detail": {
                    "robot": robot.name,
                    "obstacle_mode": obstacle_mode,
                    "shared_scene": shared_scene,
                    "stacked": stacked,
                    "mesh": mesh_info,
                    "batch": batch,
                    "goal_capacity": goal_capacity,
                    "iterations": iterations,
                    "coarse": [coarse_iterations, coarse_stride] if coarse_iterations else None,
                    "final_trust": final_trust,
                    "standoff": standoff_distance,
                    "surface_points": robot.num_surface_points,
                    "field_size": robot.field_size,
                    "compile_s": round(compile_s, 1),
                    "step_s": round(best, 4),
                    "latency_plans_per_s": round(batch / best, 1),
                    "pipeline": {"reps": pipe_reps, "inflight": inflight},
                    "device": str(jax.devices()[0]),
                }
            }
        ),
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
