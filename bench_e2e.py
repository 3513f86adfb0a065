"""End-to-end perception -> plan pipeline benchmark on a GPU.

Measures the FULL per-object pipeline the reference drivers run on CPU
(/root/reference/examples/pybullet_gto_planning.py:175-295):

  phase 1 "checking": depth image -> two SDF cost fields on the workspace
      grid (scene + target-free obstacle; brute-force min-distance +
      eps-band shaping, the KD-tree replacement) + the batched gripper
      collision pre-filter over the grasp set      [reference: 0.60 s/obj]
  phase 2 "ik": the whole grasp set as one vmapped multistart
      projected-LM batch + warm-start trajectory construction
                                                   [reference: 1.99 s/obj]
  phase 3 "plan": goal-set trajectory optimization with per-problem
      stacked fields at the deployment goal capacity (32)
                                                   [reference: 10.25 s/obj]

All three phases are single jit-compiled device programs over a batch of
objects drawn from the synthetic SceneReplica-style tabletop scenes
(envs/synthetic.py) — real depth observations from the z-buffer renderer,
per-object observations captured scene-sequentially exactly like the
closed-loop eval. The reference runs each phase per object on CPU
(Ipopt per grasp for IK, one Ipopt NLP for the plan).

Gates (untimed): goal reach within the reference's IK acceptance gates
(pybullet_gto_planning.py:262) and replay collision against the EXACT
obstacle depth cloud (> 5 body points at sdf < 0 on any step, baseline
contacts excluded — pybullet_evaluate_plans.py:219-237 semantics).

Run standalone (`python bench_e2e.py`) or via bench.py (BENCH_E2E=1,
the default — the e2e block lands in the bench result JSON).
"""

import json
import os
import time

import numpy as np

# reference per-object wall times (BASELINE.md, panda tabletop split)
REF_CHECK_S = 0.60
REF_IK_S = 1.99
REF_PLAN_S = 10.25
REF_TOTAL_S = REF_CHECK_S + REF_IK_S + REF_PLAN_S


def run_e2e(robot_name: str = None):
    robot_name = robot_name or os.environ.get("BENCH_E2E_ROBOT", "panda")
    batch = int(os.environ.get("BENCH_E2E_BATCH", "16"))
    goal_capacity = int(os.environ.get("BENCH_E2E_GOALS", "32"))
    reps = int(os.environ.get("BENCH_E2E_REPS", "3"))
    # plan-phase flavor follows each robot's validated bench default
    # (closed-loop sweeps in results/synthetic_r4): panda 3 iterations
    # coarse 2+1 single-pass final_trust; fetch 6 coarse 3+3 with the
    # evaluated finish (trust failed its shelf sweep — PERF.md, carried
    # findings).
    # Round-up coarse division gives the validated splits
    # 3 -> 2+1 / 4 -> 2+2 / 6 -> 3+3.
    iterations = int(
        os.environ.get("BENCH_E2E_ITERS", "3" if robot_name == "panda" else "6")
    )
    # IK screen budget: for panda, 24 LM iterations keeps the per-goal
    # found rate within 0.02 of the 50-iteration reference-parity budget
    # (0.844 vs 0.863, tools/probe_ik_phase.py); misses are exactly what
    # the plan gate + rescue tier absorb. 16 iterations broke the plan-gate
    # reach (0.812). The 15-DoF fetch screen is harder (found 0.627 at 24
    # iters -> plan-gate reach 0.875) and keeps the full 50 (PERF.md,
    # carried findings).
    ik_iterations = int(
        os.environ.get("BENCH_E2E_IK_ITERS", "24" if robot_name == "panda" else "50")
    )
    ik_seeds = int(os.environ.get("BENCH_E2E_SEEDS", "8"))
    # warm-start ranking fidelity: score seed trajectories on every
    # rank_t-th step x every rank_p-th surface point (SoA FK path). The
    # full ranking scores every (T, P) replay point of every candidate;
    # (2,2) keeps 15/16 identical seed picks (the one difference a
    # near-tie, full-metric cost excess 4e-4); ranking is a heuristic
    # seed CHOICE, the solver still optimizes the true objective.
    # (4,4) ships: identical seed picks on the probe set, and the e2e run
    # holds every gate at strict reach 1.0 (PERF.md, carried findings).
    rank_t = int(os.environ.get("BENCH_E2E_RANK_T", "4"))
    rank_p = int(os.environ.get("BENCH_E2E_RANK_P", "4"))
    coarse_iterations = int(
        os.environ.get("BENCH_E2E_COARSE", str(min(3, (iterations + 1) // 2)))
    )
    final_trust = (
        os.environ.get("BENCH_E2E_TRUST", "1" if robot_name == "panda" else "0")
        == "1"
    )
    width = height = int(os.environ.get("BENCH_E2E_RES", "160"))
    data_dir = os.environ.get("GTO_DATA_DIR", "/root/reference/data")
    depth_threshold = 1.5
    field_epsilon = 0.02

    import jax
    import jax.numpy as jnp

    from grasptrajopt_tpu.envs.synthetic import SyntheticSceneEnv
    from grasptrajopt_tpu.fields import DepthPointCloud
    from grasptrajopt_tpu.fields.depth_point_cloud import (
        build_two_cost_fields,
        sdf_cost_shaping,
        signed_distance_to_cloud,
    )
    from grasptrajopt_tpu.planning.gto_models import GTORobotModel
    from grasptrajopt_tpu.planning.gto_planner import GTOPlanner
    from grasptrajopt_tpu.planning.ik_solver import IKSolver
    from grasptrajopt_tpu.planning.utils import (
        interpolate_waypoints_jnp,
        load_robot_config,
    )
    from grasptrajopt_tpu.spatial import r2quat, transform_points
    from grasptrajopt_tpu.spatial.quaternion import qangle_deg

    # -- models (host, one-time; the reference builds these once too) ---------
    cfg = load_robot_config(robot_name, data_dir)
    urdf_rel = cfg["urdf_robot_path"].split("data/", 1)[-1]
    grip_rel = cfg["urdf_gripper_path"].split("data/", 1)[-1]
    robot = GTORobotModel(
        model_dir=os.path.join(data_dir, "robots", cfg["robot_name"]),
        urdf_filename=os.path.join(data_dir, urdf_rel),
        time_derivs=[0, 1],
        param_joints=cfg["param_joints"],
        collision_link_names=cfg["collision_link_names"],
        dtype=jnp.float32,
    )
    robot.setup_workspace_field(arm_len=cfg["arm_len"], arm_height=cfg["arm_height"])
    gripper = GTORobotModel(
        model_dir=os.path.join(data_dir, "robots", cfg["robot_name"]),
        urdf_filename=os.path.join(data_dir, grip_rel),
        dtype=jnp.float32,
    )
    grid = robot.grid
    link_ee, link_gripper = cfg["link_ee"], cfg["link_gripper"]
    axis_standoff = cfg["axis_standoff"]
    qc = np.asarray(cfg["default_pose"], np.float32)

    # -- scene observations (host, untimed: this is the CAMERA, not the
    #    framework; the reference gets its depth images from pybullet) -------
    env = SyntheticSceneEnv(
        robot_name=cfg["robot_name"], scene_type="tabletop", n_objects=5,
        width=width, height=height, depth_threshold=depth_threshold,
    )
    base_position = np.asarray(env.base_position, np.float32)
    depths, masks, poses, grasp_sets, names = [], [], [], [], []
    K = None
    for scene_id in (10, 36, 48, 65):
        if len(depths) >= batch:
            break
        meta = env.setup_scene(scene_id)
        env.reset_scene()
        for name in meta["nearest_first"].split(","):
            uid = env._placed(name).uid
            depth, ids, cam_pose, K = env.get_observation()
            depths.append(np.asarray(depth, np.float32))
            masks.append(np.asarray(ids == uid))
            poses.append(np.asarray(cam_pose, np.float32))
            grasp_sets.append(
                np.asarray(env.grasps_world(name, capacity=goal_capacity), np.float32)
            )
            names.append(f"{scene_id}/{name}")
            env.remove_object(name)
            if len(depths) >= batch:
                break
    while len(depths) < batch:  # pad by repeating (static batch shape)
        depths.append(depths[0]); masks.append(masks[0]); poses.append(poses[0])
        grasp_sets.append(grasp_sets[0]); names.append(names[0] + "(pad)")
    depth_b = jnp.asarray(np.stack(depths))            # (B, H, W)
    mask_b = jnp.asarray(np.stack(masks))              # (B, H, W) bool
    pose_b = jnp.asarray(np.stack(poses))              # (B, 4, 4)
    K_j = jnp.asarray(np.asarray(K, np.float32))
    tf_goal_world = np.stack(grasp_sets)               # (B, cap, 4, 4)
    tf_goal = tf_goal_world.copy()
    tf_goal[..., :3, 3] -= base_position               # robot-base frame
    tf_goal = jnp.asarray(tf_goal)

    # -- solver programs ------------------------------------------------------
    # goal-coherence bias (GTOPlanner goal_coherence): pin the plan phase's
    # per-iteration goal selection to the ranked warm start's goal unless
    # another goal is this factor cheaper; 0 = parity plain argmin
    coherence = float(os.environ.get("BENCH_E2E_COHERENCE", "0"))
    planner = GTOPlanner(
        robot, link_ee, link_gripper,
        iterations=iterations, single_pass=True,
        coarse_iterations=coarse_iterations,
        final_trust=final_trust,
        standoff_distance=-0.1,
        rank_t_stride=rank_t, rank_p_stride=rank_p,
        goal_coherence=coherence,
    )
    solvers = planner.setup_optimization(
        goal_size=goal_capacity, use_standoff=True, axis_standoff=axis_standoff
    )
    ik = IKSolver(
        robot, link_ee, link_gripper, collision_avoidance=False,
        iterations=ik_iterations, num_seeds=ik_seeds,
    )
    ik.setup_optimization(grid)
    # rescue tier capacity: the K worst-reaching objects get their FULL
    # goal set re-solved as independent single-goal problems in one batch
    # (the pipeline's batched per-goal rescue, planning/pipeline.py:327-377,
    # with a static budget instead of the host's data-dependent trigger)
    # panda k=1: the exact-field strict reach is 1.0 before rescue (the
    # exact-distance fix), so one slot covers the measured worst case
    # (k=2 remains the conservative knob). fetch keeps k=2 — its gates
    # need both slots (PERF.md, carried findings).
    rescue_k = int(
        os.environ.get("BENCH_E2E_RESCUE", "1" if robot_name == "panda" else "2")
    )
    solvers1 = (
        planner.setup_optimization(
            goal_size=1, use_standoff=True, axis_standoff=axis_standoff
        )
        if rescue_k
        else None
    )

    opt_idx = robot.optimized_joint_indexes
    par_idx = robot.parameter_joint_indexes
    qc_j = jnp.asarray(qc)
    qc_opt = jnp.tile(qc_j[jnp.asarray(opt_idx)], (batch, 1))
    q_param = (
        jnp.tile(qc_j[jnp.asarray(par_idx)], (batch, 1))
        if par_idx else jnp.zeros((batch, 0), jnp.float32)
    )
    grid_pts = jnp.asarray(grid.grid_points(), jnp.float32)
    gpts_local, _ = gripper.compute_fk_surface_points(
        np.asarray(cfg["gripper_open_offsets"])
    )
    gpts_local = jnp.asarray(gpts_local, jnp.float32)
    RT_filter_off = jnp.asarray(
        robot.get_standoff_pose(-0.01, axis_standoff), jnp.float32
    )

    # -- phase 1: fields + grasp collision pre-filter -------------------------
    # BENCH_E2E_DEDUP: on-device voxel dedup of the obstacle cloud before
    # the dense field build (ops.voxel_dedup; the CPU shelf path's
    # field_downsample accuracy bar). Default 1 cm; 0 = full-cloud build.
    # The fused builder also replaces the scene field's second full-cloud
    # pass with min(d_obstacle, d_target-points) — together this cuts the
    # field build's distance pairs ~3.7x at res 160 (and ~10x at 320).
    dedup_voxel = float(os.environ.get("BENCH_E2E_DEDUP", "0.01"))
    cap_obs = int(os.environ.get("BENCH_E2E_DEDUP_CAP", "12288"))
    cap_tgt = 2048

    def fields_one(depth, mask, cam_pose, RT_grasps_world):
        """One object: two shaped cost fields on the workspace grid (packed
        corner-row tables) + the gripper-point collision filter — the
        reference's entire "checking" phase (driver :175-240) as one
        device program."""
        d_obs_img = jnp.where(mask, depth_threshold, depth)
        if dedup_voxel > 0:
            f_all, f_obs, obs_pts, obs_mask = build_two_cost_fields(
                depth, K_j, cam_pose, mask, grid_pts,
                threshold=depth_threshold, epsilon=field_epsilon,
                dedup_voxel=dedup_voxel,
                capacity_obstacle=cap_obs, capacity_target=cap_tgt,
            )
            sdf_fn = lambda q: signed_distance_to_cloud(
                q, obs_pts, obs_mask, d_obs_img, K_j, cam_pose
            )
        else:
            dpc_all = DepthPointCloud(
                depth, K_j, cam_pose, threshold=depth_threshold
            )
            dpc_obs = DepthPointCloud(
                d_obs_img, K_j, cam_pose, mask, threshold=depth_threshold
            )
            f_all = sdf_cost_shaping(dpc_all.get_sdf(grid_pts), field_epsilon)
            f_obs = sdf_cost_shaping(dpc_obs.get_sdf(grid_pts), field_epsilon)
            sdf_fn = dpc_obs.get_sdf
        packed = jnp.concatenate([grid.pack(f_all), grid.pack(f_obs)], axis=0)
        # grasp pre-filter: gripper surface points at every standoff pose
        # vs the obstacle cloud (driver :202-240)
        gp = transform_points(RT_grasps_world @ RT_filter_off, gpts_local)
        sdf_g = sdf_fn(gp.reshape(-1, 3)).reshape(gp.shape[:2])
        keep = (sdf_g < 0).mean(axis=1) <= 0.01
        return packed, keep, f_obs

    @jax.jit
    def phase_fields(depth_b, mask_b, pose_b, tf_world_b):
        packed_b, keep_b, f_obs_b = jax.vmap(fields_one)(
            depth_b, mask_b, pose_b, tf_world_b
        )
        S2 = packed_b.shape[1]
        tables = packed_b.reshape(batch * S2, 8)
        base = jnp.arange(batch, dtype=jnp.int32) * S2
        return tables, base, keep_b, f_obs_b

    # -- phase 2: multistart IK screen + ranked warm-start construction -------
    base_j = jnp.asarray(base_position)

    def rank_seeds_one(q_sols, found_o, f_obs):
        """Warm-start ranking through the PLANNER's own helpers
        (GTOPlanner.rank_seed_scores / rank_pick with the planner's
        rank_t/rank_p strides — the measured ranking is byte-for-byte the
        shipped pipeline path): interpolate every found IK candidate into a
        seed trajectory and pick lexicographically by (obstacle cost of the
        replayed seed, travel). Candidates the IK screen missed rank inf."""
        seeds = planner._seed_trajectories(qc_j, q_sols.T)  # (cap, T, ndof)
        costs, dists = planner.rank_seed_scores(seeds, f_obs, base_j)
        costs = jnp.where(found_o, costs, jnp.inf)
        best = planner.rank_pick(costs, dists)
        return seeds[best], best  # (T, ndof), goal index of the seed

    @jax.jit
    def phase_ik(tf_goal_b, keys, f_obs_b):
        N = batch * goal_capacity
        RT_flat = tf_goal_b.reshape(N, 4, 4)
        params = {
            "tf_goal": RT_flat,
            "q_param": jnp.repeat(q_param, goal_capacity, axis=0),
        }
        q0_opt = jnp.repeat(qc_opt, goal_capacity, axis=0)
        q_opt_s, _, _ = ik._solve_batch_multi(q0_opt, params, keys)
        q_full = jax.vmap(robot.assemble_q)(
            q_opt_s, params["q_param"]
        )  # (N, ndof)
        T_ee = robot.get_global_link_transform(link_ee, q_full)
        err_pos = jnp.linalg.norm(RT_flat[:, :3, 3] - T_ee[:, :3, 3], axis=-1)
        err_rot = qangle_deg(
            r2quat(RT_flat[:, :3, :3]), r2quat(T_ee[:, :3, :3])
        )
        err_pos = err_pos.reshape(batch, goal_capacity)
        err_rot = err_rot.reshape(batch, goal_capacity)
        found = (err_pos < 0.01) & (err_rot < 5.0)
        q_sols = q_full.reshape(batch, goal_capacity, -1)
        Q0, seed_goal = jax.vmap(rank_seeds_one)(
            q_sols, found, f_obs_b
        )  # (B, T, ndof), (B,)
        X0 = Q0[:, 2:, :][..., jnp.asarray(opt_idx)]
        return X0, found, err_pos, err_rot, q_sols, seed_goal

    # -- phase 3: goal-set plan over per-problem stacked fields ---------------
    @jax.jit
    def phase_plan(X0, tables, base, goal_mask, seed_goal):
        params = {
            "q_param": q_param,
            "tf_goal": tf_goal,
            "goal_mask": goal_mask,
            # goals are base-frame; the WORLD-frame field lookups shift FK
            # points by the robot's base position (plan_goalset parity)
            "base_position": jnp.broadcast_to(
                jnp.asarray(base_position), (batch, 3)
            ),
            "field_base": base,
        }
        if coherence > 0:
            params["goal_seed"] = seed_goal
        return solvers.solve_batch_stacked(
            qc_opt, X0, params, {"packed_fields": tables}
        )

    # -- phase 4: bounded batched per-goal rescue -----------------------------
    def _reach_err(Q, tf_goal_b, gm):
        """Per-object best gated reach error of a goal-set plan batch."""
        q_param_T = jnp.broadcast_to(
            q_param[:, None, :], (batch, planner.T, q_param.shape[1])
        )
        Q_full = jax.vmap(jax.vmap(robot.assemble_q))(Q, q_param_T)
        T_end = robot.get_global_link_transform(link_ee, Q_full[:, -1])
        d = jnp.linalg.norm(
            tf_goal_b[..., :3, 3] - T_end[:, None, :3, 3], axis=-1
        )
        rot = qangle_deg(
            r2quat(tf_goal_b[..., :3, :3]),
            jnp.broadcast_to(
                r2quat(T_end[:, None, :3, :3]), (batch, goal_capacity, 4)
            ),
        )
        return jnp.min(jnp.where(gm, d + 2e-3 * rot, jnp.inf), axis=1)

    @jax.jit
    def phase_rescue(Q, tables, base, gm, q_sols):
        """Re-solve the K worst-reaching objects' ENTIRE goal sets as
        independent single-goal problems in one vmapped batch and keep the
        best per-goal plan when it beats the goal-set plan (pipeline
        rescue parity with a static object budget; selection is by gated
        reach error — the post-hoc gates still check collisions)."""
        err0 = _reach_err(Q, tf_goal, gm)  # (B,)
        worst = jnp.argsort(-err0)[:rescue_k]  # (K,)
        K, cap = rescue_k, goal_capacity
        tfk = tf_goal[worst].reshape(K * cap, 1, 4, 4)
        q_sols_k = q_sols[worst].reshape(K * cap, -1)
        X0k = jax.vmap(
            lambda q_sol: interpolate_waypoints_jnp(qc_j, q_sol, planner.T)
        )(q_sols_k)[:, 2:, :][..., jnp.asarray(opt_idx)]
        q_param_k = jnp.repeat(q_param[worst], cap, axis=0)
        params = {
            "q_param": q_param_k,
            "tf_goal": tfk,
            "goal_mask": jnp.ones((K * cap, 1), bool),
            "base_position": jnp.broadcast_to(
                jnp.asarray(base_position), (K * cap, 3)
            ),
            "field_base": jnp.repeat(base[worst], cap),
        }
        qc_opt_k = jnp.repeat(qc_opt[worst], cap, axis=0)
        Qr, _, _ = solvers1.solve_batch_stacked(
            qc_opt_k, X0k, params, {"packed_fields": tables}
        )  # (K*cap, T, n_opt)
        # score each per-goal plan against ITS OWN goal
        q_param_T = jnp.broadcast_to(
            q_param_k[:, None, :], (K * cap, planner.T, q_param.shape[1])
        )
        Qr_full = jax.vmap(jax.vmap(robot.assemble_q))(Qr, q_param_T)
        T_endr = robot.get_global_link_transform(link_ee, Qr_full[:, -1])
        dr = jnp.linalg.norm(tfk[:, 0, :3, 3] - T_endr[:, :3, 3], axis=-1)
        rotr = qangle_deg(r2quat(tfk[:, 0, :3, :3]), r2quat(T_endr[:, :3, :3]))
        errr = jnp.where(
            gm[worst].reshape(K * cap), dr + 2e-3 * rotr, jnp.inf
        ).reshape(K, cap)
        bestg = jnp.argmin(errr, axis=1)  # (K,)
        err_new = errr[jnp.arange(K), bestg]
        better = err_new < err0[worst]
        Q_repl = Qr.reshape(K, cap, planner.T, -1)[jnp.arange(K), bestg]
        Q_new = Q.at[worst].set(
            jnp.where(better[:, None, None], Q_repl, Q[worst])
        )
        return Q_new, worst, better

    keys = jax.random.split(jax.random.PRNGKey(0), batch * goal_capacity)
    tf_world_j = jnp.asarray(tf_goal_world)

    def run_once():
        t0 = time.time()
        tables, base, keep, f_obs_b = phase_fields(
            depth_b, mask_b, pose_b, tf_world_j
        )
        keep.block_until_ready()
        t1 = time.time()
        X0, found, err_pos, err_rot, q_sols, seed_goal = phase_ik(
            tf_goal, keys, f_obs_b
        )
        X0.block_until_ready()
        t2 = time.time()
        # goal slots must survive BOTH the collision pre-filter and the IK
        # screen (pipeline parity); objects with no survivor keep all slots
        # (the pipeline would report a failure stage — the bench still plans)
        gm = keep & found
        gm = jnp.where(gm.any(axis=1, keepdims=True), gm, True)
        Q, cost, _ = phase_plan(X0, tables, base, gm, seed_goal)
        Q.block_until_ready()
        t3 = time.time()
        if rescue_k:
            Q, worst, rescued = phase_rescue(Q, tables, base, gm, q_sols)
            Q.block_until_ready()
        else:
            rescued = jnp.zeros((0,), bool)
        t4 = time.time()
        return (t1 - t0, t2 - t1, t3 - t2, t4 - t3), (Q, gm, keep, found, rescued)

    t0 = time.time()
    _, out = run_once()  # compile + warmup
    compile_s = time.time() - t0
    best = None
    for _ in range(reps):
        ts, out = run_once()
        if best is None or sum(ts) < sum(best):
            best = ts
    t_fields, t_ik, t_plan, t_rescue = best
    total = t_fields + t_ik + t_plan + t_rescue
    objects_per_s = batch / total

    # -- gates (untimed): reach + exact-cloud replay collision ---------------
    Q, gm, keep, found, rescued = out
    q_param_T = jnp.broadcast_to(
        q_param[:, None, :], (batch, planner.T, q_param.shape[1])
    )
    Q_full = jax.jit(jax.vmap(jax.vmap(robot.assemble_q)))(Q, q_param_T)
    T_end = robot.get_global_link_transform(link_ee, Q_full[:, -1])
    d = np.linalg.norm(
        np.asarray(tf_goal)[:, :, :3, 3] - np.asarray(T_end)[:, None, :3, 3],
        axis=-1,
    )
    rot = np.asarray(
        qangle_deg(
            r2quat(tf_goal[..., :3, :3]),
            jnp.broadcast_to(
                r2quat(T_end[:, None, :3, :3]), (batch, goal_capacity, 4)
            ),
        )
    )
    gm_np = np.asarray(gm)
    # strict: the IK acceptance gates (pybullet_gto_planning.py:262);
    # plan: the plan acceptance tolerances the closed-loop replay scores
    # with (score_plan / rescue gates, 2 cm / 10 deg) — misses of the
    # strict gate are exactly what the pipeline's rescue tier re-solves
    reached = ((d < 0.01) & (rot < 5.0) & gm_np).any(axis=1)
    reached_plan = ((d < 0.02) & (rot < 10.0) & gm_np).any(axis=1)
    # best-goal errors (bench-main convention) for magnitude diagnostics
    best_goal = np.argmin(np.where(gm_np, d + rot * 2e-3, np.inf), axis=1)
    err_pos_best = d[np.arange(batch), best_goal]
    err_rot_best = rot[np.arange(batch), best_goal]
    pts_b = np.asarray(
        jax.jit(robot.fk_surface_points)(
            Q_full, base_position=jnp.asarray(base_position)
        )
    )  # (B, T, P, 3)
    collisions = []
    for b in range(batch):
        d_obs = np.array(depths[b], copy=True)
        d_obs[masks[b]] = depth_threshold
        dpc_obs = DepthPointCloud(
            d_obs, K, poses[b], masks[b], threshold=depth_threshold
        )
        sdf = np.asarray(
            dpc_obs.get_sdf(jnp.asarray(pts_b[b].reshape(-1, 3)), host=False)
        ).reshape(planner.T, -1)
        inside = sdf < 0
        counts = (inside & ~inside[0]).sum(axis=1)
        collisions.append(bool((counts > 5).any()))

    return {
        "objects_per_s": round(objects_per_s, 2),
        "sec_per_object": round(total / batch, 4),
        "vs_ref_sec_per_object": REF_TOTAL_S,
        "speedup": round(REF_TOTAL_S * objects_per_s, 1),
        "phase_ms_per_object": {
            "fields": round(1e3 * t_fields / batch, 2),
            "ik": round(1e3 * t_ik / batch, 2),
            "plan": round(1e3 * t_plan / batch, 2),
            "rescue": round(1e3 * t_rescue / batch, 2),
        },
        "rescue": {
            "k": rescue_k,
            "applied": int(np.asarray(rescued).sum()) if rescue_k else 0,
        },
        "ref_phase_s_per_object": {
            "fields": REF_CHECK_S, "ik": REF_IK_S, "plan": REF_PLAN_S,
        },
        "batch": batch,
        "goal_capacity": goal_capacity,
        "iterations": [iterations, coarse_iterations],
        "final_trust": final_trust,
        "ik_iterations": ik_iterations,
        "ik_seeds": ik_seeds,
        "rank_stride": [rank_t, rank_p],
        "dedup": [dedup_voxel, cap_obs],
        "depth_res": [height, width],
        "field_size": int(robot.field_size),
        "compile_s": round(compile_s, 1),
        "gates": {
            "reached_frac_ik_gates": round(float(np.mean(reached)), 3),
            "reached_frac_plan_gates": round(float(np.mean(reached_plan)), 3),
            "collision_frac": round(float(np.mean(collisions)), 3),
            "err_pos_median": round(float(np.median(err_pos_best)), 4),
            "err_pos_p90": round(float(np.quantile(err_pos_best, 0.9)), 4),
            "err_rot_median_deg": round(float(np.median(err_rot_best)), 2),
            "err_rot_p90_deg": round(float(np.quantile(err_rot_best, 0.9)), 2),
            "mean_grasps_kept": round(float(np.asarray(keep).mean(axis=1).mean()), 3),
            "mean_ik_found": round(float(np.asarray(found).mean(axis=1).mean()), 3),
        },
    }


if __name__ == "__main__":
    from grasptrajopt_tpu.utils.device import enable_compile_cache, require_gpu

    require_gpu(allow_requested_cpu=True)
    enable_compile_cache()
    print(json.dumps({"e2e": run_e2e()}))
