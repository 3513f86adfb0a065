"""Attribute and optimize the e2e IK phase (bench_e2e.py phase 2).

Two sub-costs inside the single phase_ik program:

  (a) the multistart projected-LM screen: B*cap = 512 problems x
      num_seeds=8 x 50 LM iterations of the point-matching residual
      (ik_solver.py run_multistart)
  (b) the pipeline-parity warm-start ranking: EVERY found candidate is
      interpolated to a T=50 seed trajectory and scored by obstacle
      field lookups over all P=1200 surface points — 16*32*50*1200 =
      30.7M nearest lookups + the same count of FK point transforms

On the accelerator the planner was first written for, (b) dominated.
This probe times both standalone plus the candidate cuts:

  solve variants: iterations {50, 24, 16} x seeds {8, 4} (subset)
      with IK-gate found fractions on real synthetic grasp sets
  rank variants: AoS full (production), SoA full (layout), SoA with
      T-stride 4 + point-stride 4 (16x fewer queries), with
      best-seed agreement vs the full ranking as the quality proxy

Run on the GPU (one process, needs the robot assets under GTO_DATA_DIR):
`python tools/probe_ik_phase.py`.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp

    from grasptrajopt_tpu.utils.device import enable_compile_cache, require_gpu

    require_gpu()
    enable_compile_cache()

    from grasptrajopt_tpu.envs.synthetic import SyntheticSceneEnv
    from grasptrajopt_tpu.fields import DepthPointCloud
    from grasptrajopt_tpu.fields.depth_point_cloud import sdf_cost_shaping
    from grasptrajopt_tpu.planning.gto_models import GTORobotModel
    from grasptrajopt_tpu.planning.ik_solver import IKSolver
    from grasptrajopt_tpu.planning.utils import (
        interpolate_waypoints_jnp,
        load_robot_config,
    )
    from grasptrajopt_tpu.spatial import r2quat
    from grasptrajopt_tpu.spatial.quaternion import qangle_deg

    batch = int(os.environ.get("PROBE_BATCH", "16"))
    cap = int(os.environ.get("PROBE_CAP", "32"))
    T = 50
    reps = int(os.environ.get("PROBE_REPS", "3"))
    data_dir = os.environ.get("GTO_DATA_DIR", "/root/reference/data")
    depth_threshold = 1.5
    field_epsilon = 0.02

    def log(*a):
        print(*a, flush=True)

    cfg = load_robot_config("panda", data_dir)
    urdf_rel = cfg["urdf_robot_path"].split("data/", 1)[-1]
    robot = GTORobotModel(
        model_dir=os.path.join(data_dir, "robots", "panda"),
        urdf_filename=os.path.join(data_dir, urdf_rel),
        time_derivs=[0, 1],
        param_joints=cfg["param_joints"],
        collision_link_names=cfg["collision_link_names"],
        dtype=jnp.float32,
    )
    robot.setup_workspace_field(arm_len=cfg["arm_len"], arm_height=cfg["arm_height"])
    grid = robot.grid
    link_ee, link_gripper = cfg["link_ee"], cfg["link_gripper"]
    qc = np.asarray(cfg["default_pose"], np.float32)

    # -- observations + HOST-side obstacle fields (untimed setup) ------------
    env = SyntheticSceneEnv(
        robot_name="panda", scene_type="tabletop", n_objects=5,
        width=160, height=160, depth_threshold=depth_threshold,
    )
    base_position = np.asarray(env.base_position, np.float32)
    grid_pts = np.asarray(grid.grid_points(), np.float32)
    f_obs_list, grasp_sets = [], []
    K = None
    for scene_id in (10, 36, 48, 65):
        if len(grasp_sets) >= batch:
            break
        meta = env.setup_scene(scene_id)
        env.reset_scene()
        for name in meta["nearest_first"].split(","):
            uid = env._placed(name).uid
            depth, ids, cam_pose, K = env.get_observation()
            mask = np.asarray(ids == uid)
            d_obs = np.array(np.asarray(depth), copy=True)
            d_obs[mask] = depth_threshold
            dpc_obs = DepthPointCloud(
                d_obs, K, cam_pose, mask, threshold=depth_threshold
            )
            sdf = np.asarray(dpc_obs.get_sdf(jnp.asarray(grid_pts), host=True))
            f_obs_list.append(np.asarray(sdf_cost_shaping(sdf, field_epsilon)))
            grasp_sets.append(
                np.asarray(env.grasps_world(name, capacity=cap), np.float32)
            )
            env.remove_object(name)
            if len(grasp_sets) >= batch:
                break
    f_obs_b = jnp.asarray(np.stack(f_obs_list))          # (B, S)
    tf_goal = np.stack(grasp_sets)                       # (B, cap, 4, 4)
    tf_goal[..., :3, 3] -= base_position
    tf_goal = jnp.asarray(tf_goal)
    log(f"setup done: {batch} objects, field {f_obs_b.shape}")

    opt_idx = robot.optimized_joint_indexes
    par_idx = robot.parameter_joint_indexes
    qc_j = jnp.asarray(qc)
    qc_opt = jnp.tile(qc_j[jnp.asarray(opt_idx)], (batch, 1))
    q_param = (
        jnp.tile(qc_j[jnp.asarray(par_idx)], (batch, 1))
        if par_idx else jnp.zeros((batch, 0), jnp.float32)
    )
    base_j = jnp.asarray(base_position)
    N = batch * cap
    RT_flat = tf_goal.reshape(N, 4, 4)
    params = {
        "tf_goal": RT_flat,
        "q_param": jnp.repeat(q_param, cap, axis=0),
    }
    q0_opt = jnp.repeat(qc_opt, cap, axis=0)
    keys = jax.random.split(jax.random.PRNGKey(0), N)

    def timeit(name, fn, *args):
        t0 = time.time()
        out = jax.block_until_ready(fn(*args))
        compile_s = time.time() - t0
        best = np.inf
        for _ in range(reps):
            t0 = time.time()
            out = jax.block_until_ready(fn(*args))
            best = min(best, time.time() - t0)
        log(f"{name}: {1e3*best:.1f} ms total, {1e3*best/batch:.2f} ms/object "
            f"(compile {compile_s:.0f}s)")
        return out, best

    results = {}

    # -- solve variants ------------------------------------------------------
    def found_frac(q_opt_s):
        q_full = jax.jit(jax.vmap(robot.assemble_q))(q_opt_s, params["q_param"])
        T_ee = robot.get_global_link_transform(link_ee, q_full)
        err_pos = np.asarray(
            jnp.linalg.norm(RT_flat[:, :3, 3] - T_ee[:, :3, 3], axis=-1))
        err_rot = np.asarray(qangle_deg(
            r2quat(RT_flat[:, :3, :3]), r2quat(T_ee[:, :3, :3])))
        found = (err_pos < 0.01) & (err_rot < 5.0)
        return found, float(found.mean())

    found_ref = None
    for iters, seeds in [(50, 8), (24, 8), (16, 8), (16, 4)]:
        ik = IKSolver(robot, link_ee, link_gripper,
                      collision_avoidance=False, iterations=iters,
                      num_seeds=seeds)
        ik.setup_optimization(grid)
        out, t = timeit(f"solve iters={iters} seeds={seeds}",
                        lambda q, p, k, ik=ik: ik._solve_batch_multi(q, p, k),
                        q0_opt, params, keys)
        found, frac = found_frac(out[0])
        log(f"  found (1cm/5deg): {frac:.3f}")
        results[f"solve_i{iters}_s{seeds}"] = {
            "ms_per_object": round(1e3 * t / batch, 2), "found": round(frac, 3)}
        if iters == 50 and seeds == 8:
            found_ref = found
            q_sols_ref = jax.jit(jax.vmap(robot.assemble_q))(
                out[0], params["q_param"]).reshape(batch, cap, -1)

    found_b = jnp.asarray(found_ref.reshape(batch, cap))

    # -- rank variants (fixed solve output so ranking quality is isolated) ---
    def rank_aos(q_sols, found_o, f_obs):
        seeds = jax.vmap(
            lambda q_sol: interpolate_waypoints_jnp(qc_j, q_sol, T)
        )(q_sols)
        pts = robot.fk_surface_points(seeds, base_position=base_j)
        vals = grid.lookup_nearest(f_obs, pts)
        costs = jnp.sum(vals, axis=(1, 2))
        costs = jnp.where(found_o, costs, jnp.inf)
        dists = jnp.linalg.norm(seeds[:, 0] - seeds[:, -1], axis=-1)
        min_cost = jnp.min(costs)
        best = jnp.argmin(jnp.where(costs == min_cost, dists, jnp.inf))
        return best, costs

    def rank_soa(q_sols, found_o, f_obs, t_stride=1, p_stride=1):
        seeds = jax.vmap(
            lambda q_sol: interpolate_waypoints_jnp(qc_j, q_sol, T)
        )(q_sols)
        sub = seeds[:, ::t_stride] if t_stride > 1 else seeds
        comps = robot.fk_components(sub)
        x, y, z = robot.surface_points_soa(comps, base_j, stride=p_stride)
        pts = jnp.stack([x, y, z], axis=-1)
        vals = grid.lookup_nearest(f_obs, pts)
        costs = jnp.sum(vals, axis=(1, 2))
        costs = jnp.where(found_o, costs, jnp.inf)
        dists = jnp.linalg.norm(seeds[:, 0] - seeds[:, -1], axis=-1)
        min_cost = jnp.min(costs)
        best = jnp.argmin(jnp.where(costs == min_cost, dists, jnp.inf))
        return best, costs

    variants = [
        ("rank_aos_full", jax.jit(jax.vmap(rank_aos))),
        ("rank_soa_full", jax.jit(jax.vmap(
            lambda q, f, fo: rank_soa(q, f, fo, 1, 1)))),
        ("rank_soa_t4p4", jax.jit(jax.vmap(
            lambda q, f, fo: rank_soa(q, f, fo, 4, 4)))),
        ("rank_soa_t2p2", jax.jit(jax.vmap(
            lambda q, f, fo: rank_soa(q, f, fo, 2, 2)))),
    ]
    best_ref = cost_ref = None
    for name, fn in variants:
        out, t = timeit(name, fn, q_sols_ref, found_b, f_obs_b)
        best_idx = np.asarray(out[0])
        costs = np.asarray(out[1])
        entry = {"ms_per_object": round(1e3 * t / batch, 2)}
        if best_ref is None:
            best_ref, cost_ref = best_idx, costs
        else:
            agree = float((best_idx == best_ref).mean())
            # full-metric cost of the variant's chosen seed vs the true best
            chosen = cost_ref[np.arange(batch), best_idx]
            true = cost_ref[np.arange(batch), best_ref]
            entry["agree"] = round(agree, 3)
            entry["cost_excess_mean"] = round(float(np.mean(chosen - true)), 4)
            log(f"  agreement {agree:.3f}, chosen-seed full-cost excess "
                f"mean {np.mean(chosen - true):.4f}")
        results[name] = entry

    log(json.dumps(results))


if __name__ == "__main__":
    main()
