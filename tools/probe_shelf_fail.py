"""Root-cause probe for the two budget-independent panda-shelf failures
scene 10 / 004_sugar_box (trial 2 of the
'random' ordering) and scene 65 / 009_gelatin_box (trial 3). Both reach
the goal to <1 mm but the best plan still collides in replay (16 / 7
inside points) after BOTH the per-goal rescue and the exact-geometry
escalation tier.

Reproduces the exact failing trial (same env state: preceding objects
removed), dumps per-goal replay scores for the goal-set plan, the rescue
batch, and the escalation batch, then scores candidate fixes:

  PROBE_FIX=base       shipped flavor, diagnostics only
  PROBE_FIX=weight     escalation obstacle weight 40 -> 120
  PROBE_FIX=fine       escalation point resolution 0.02 -> 0.012 with
                       capacity 8192 (finer exact geometry)
  PROBE_FIX=grid       main field grid 0.025 -> 0.015 (finer voxel field,
                       the 'below-Nyquist thin object' hypothesis)
  PROBE_FIX=eps        field_epsilon 0.03 (wider cost band)
  PROBE_FIX=views2     two fused camera views (planner fields AND replay
                       scorer): carves the under-board occlusion band the
                       single head camera marks 'inside'

Usage:
  JAX_PLATFORMS=cpu PROBE_FIX=base \
      python tools/probe_shelf_fail.py [scene_id target_name]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples"))

import numpy as np
import jax.numpy as jnp

from grasptrajopt_tpu.envs.synthetic import SyntheticSceneEnv
from grasptrajopt_tpu.fields import DepthPointCloud
from grasptrajopt_tpu.planning.pipeline import GraspPipeline
from grasptrajopt_tpu.planning.evaluate import score_plan, score_plans_pergoal
from synthetic_eval import SCENE_KNOBS, build_models
from grasptrajopt_tpu.planning.utils import get_data_dir

FIX = os.environ.get("PROBE_FIX", "base")
SCENE = int(sys.argv[1]) if len(sys.argv) > 2 else 10
TARGET = sys.argv[2] if len(sys.argv) > 2 else "004_sugar_box"


def main():
    data_dir = get_data_dir()
    knobs = SCENE_KNOBS["shelf"]
    grid_res = knobs.get("grid_resolution", 0.05)
    if FIX == "grid":
        grid_res = 0.015
    robot, gripper, cfg = build_models("panda", data_dir, grid_resolution=grid_res)
    field_epsilon = knobs.get("field_epsilon", 0.02)
    if FIX == "eps":
        field_epsilon = 0.03

    pipe_kw = dict(
        axis_standoff=cfg["axis_standoff"],
        gripper_open_offsets=cfg["gripper_open_offsets"],
        standoff_distance=knobs["standoff_distance"],
        goal_capacity=32, grid=robot.grid, ik_capacity=32,
        # the shipped panda flavor: 3 iterations, coarse 2+1, single-pass,
        # final_trust (results/synthetic_r4)
        planner_iterations=3, planner_single_pass=True,
        planner_coarse_iterations=2, planner_coarse_stride=2,
        planner_final_trust=True,
        goal_weight=knobs.get("goal_weight", {}).get("panda", 1.0),
        interpolate=knobs.get("interpolate", True),
        field_epsilon=field_epsilon,
        field_downsample=knobs.get("field_downsample"),
    )
    if FIX == "weight":
        pipe_kw["escalate_obstacle_weight"] = 120.0
    if FIX == "fine":
        pipe_kw["escalate_resolution"] = 0.012
        pipe_kw["escalate_points_capacity"] = 8192
    pipeline = GraspPipeline(robot, gripper, cfg["link_ee"], cfg["link_gripper"], **pipe_kw)

    env = SyntheticSceneEnv(
        robot_name="panda", scene_type="shelf", n_objects=5,
        width=160, height=160, depth_threshold=cfg.get("depth_threshold", 1.5),
    )
    meta = env.setup_scene(SCENE)
    env.reset_scene()
    order = meta["random"].split(",")
    print(f"scene {SCENE} order: {order}; target {TARGET}; fix={FIX}")
    for name in order:
        if name == TARGET:
            break
        env.remove_object(name)

    views = 2 if FIX == "views2" else knobs.get("views", 1)
    cam_poses = env.camera_poses(views)
    uid = env._placed(TARGET).uid
    depths, masks = [], []
    for cp in cam_poses:
        d, m, _, K = env.get_observation(cp)
        depths.append(d)
        masks.append(m == uid)
    RTs = env.grasps_world(TARGET, capacity=32)
    base_position = env.base_position
    qc = np.asarray(cfg["default_pose"])

    # --- instrumented pipeline run (mirrors plan_object's stages) ----------
    t0 = time.time()
    depth_in = depths if views > 1 else depths[0]
    pose_in = cam_poses if views > 1 else cam_poses[0]
    mask_in = masks if views > 1 else masks[0]
    _, dpc_obs, sdf_all, sdf_obs = pipeline.build_fields(depth_in, K, pose_in, mask_in)
    keep = pipeline.filter_grasps(RTs, dpc_obs)
    RT_base = np.asarray(RTs)[keep].copy()
    RT_base[:, :3, 3] -= np.asarray(base_position)
    q_sols, found = pipeline.screen_ik(qc, RT_base, sdf_obs, base_position)
    RT_ok = RT_base[found]
    q_solutions = q_sols[found].T
    print(f"grasps: {len(keep)} kept {int(keep.sum())} ik {int(found.sum())}  ({time.time()-t0:.0f}s)")

    cap = max(32, RT_ok.shape[0])

    def describe(tag, Q_all):
        scores = score_plans_pergoal(
            robot, cfg["link_ee"], Q_all, RT_ok, dpc_obs, base_position,
            pos_tol=pipeline.rescue_pos_tol, rot_tol_deg=pipeline.rescue_rot_tol_deg,
        )
        n_reach = sum(s["reached"] for s in scores)
        n_clean = sum(not s["collision"] for s in scores)
        n_good = sum(s["reward"] for s in scores)
        best = max(range(len(scores)), key=lambda i: (
            scores[i]["reward"], int(not scores[i]["collision"]),
            int(scores[i]["reached"]), -scores[i]["err_pos"]))
        mi = [s.get("max_inside_points", -1) for s in scores]
        print(f"[{tag}] reach {n_reach}/{len(scores)} clean {n_clean} reward {n_good} "
              f"min_inside {min(mi)} best#{best}: {scores[best]}")
        return scores

    t0 = time.time()
    plan, dQ, cost = pipeline.planner.plan_goalset(
        qc, RT_ok, sdf_all, sdf_obs, base_position, q_solutions,
        use_standoff=True, axis_standoff=pipeline.axis_standoff,
        interpolate=pipeline.interpolate, goal_capacity=cap,
    )
    s0 = score_plan(robot, cfg["link_ee"], plan, RT_ok, dpc_obs, base_position,
                    pos_tol=pipeline.rescue_pos_tol, rot_tol_deg=pipeline.rescue_rot_tol_deg)
    print(f"[goalset] {s0}  ({time.time()-t0:.0f}s)")

    t0 = time.time()
    Q_all, cost_all = pipeline.planner.plan_pergoal_batch(
        qc, RT_ok, sdf_all, sdf_obs, base_position, q_solutions,
        use_standoff=True, axis_standoff=pipeline.axis_standoff,
        goal_capacity=cap,
    )
    describe(f"rescue {time.time()-t0:.0f}s", Q_all)

    t0 = time.time()
    Q_e, cost_e = pipeline._plan_pergoal_exact(
        qc, RT_ok, base_position, q_solutions, cap,
        depth_in, K, pose_in, mask_in,
    )
    describe(f"escalate {time.time()-t0:.0f}s", Q_e)


if __name__ == "__main__":
    main()
