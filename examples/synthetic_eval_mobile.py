"""Closed-loop MOBILE-manipulation evaluation on synthetic scenes — the
pybullet-free counterpart of the reference's mobile driver
(/root/reference/examples/pybullet_gto_planning_mobile.py).

Phases, in parity order:
  1. Observe from afar (base parked away from the furniture), build the
     2-D occupancy grid in the base frame (:157-162).
  2. Sample 2 candidate grasps per object and run BasePlanner until the
     solved base pose is occupancy-collision-free (:186-202).
  3. "Drive": the kinematic env teleports the base to the solved pose
     (the reference closes the loop over differential-drive wheels,
     :215-244 — pure simulator mechanics, not planning behavior).
  4. Per-object loop identical to the fixed-base evaluation but with every
     quantity expressed in the NEW base frame and base_position = 0
     (:246-430); results record the chosen base pose 'RT_base_new' (:247).

Scoring matches examples/synthetic_eval.py: goal-reach via the IK gates
and step-wise collision (pybullet_evaluate_plans.py:219-237).

Run on CPU:
  JAX_PLATFORMS=cpu python examples/synthetic_eval_mobile.py
"""

import argparse
import datetime
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

import jax

jax.config.update("jax_enable_x64", True)

from grasptrajopt_tpu.envs.camera import rotZ
from grasptrajopt_tpu.envs.render import look_at_pose
from grasptrajopt_tpu.envs.synthetic import SyntheticSceneEnv
from grasptrajopt_tpu.fields import DepthPointCloud
from grasptrajopt_tpu.planning import BasePlanner
from grasptrajopt_tpu.planning.evaluate import score_plan
from grasptrajopt_tpu.planning.pipeline import GraspPipeline
from grasptrajopt_tpu.planning.utils import get_data_dir
from grasptrajopt_tpu.utils.results import aggregate_results

from synthetic_eval import SCENE_KNOBS, build_models  # noqa: E402


def make_args():
    p = argparse.ArgumentParser(description="synthetic mobile closed-loop evaluation")
    p.add_argument("-r", "--robot", default="fetch", choices=["fetch"])
    p.add_argument("-t", "--scene_type", default="tabletop", choices=["tabletop", "shelf"])
    p.add_argument("--scene_ids", default="10,36")
    p.add_argument("--n_objects", type=int, default=5)
    p.add_argument("--width", type=int, default=160)
    p.add_argument("--height", type=int, default=160)
    p.add_argument("--goal_capacity", type=int, default=32)
    p.add_argument("--iterations", type=int, default=50)
    p.add_argument("--single_pass", action="store_true",
                   help="delayed-gratification LM (the bench default flavor)")
    p.add_argument("--coarse", type=int, default=0,
                   help="coarse-fidelity obstacle iterations (requires --single_pass)")
    p.add_argument("--coarse_stride", type=int, default=2,
                   help="surface-point stride of the coarse phase")
    p.add_argument("--start_pose", default="-0.8,0.3,-0.3", help="x,y,yaw parked base")
    p.add_argument("--outdir", default="results")
    p.add_argument("--data_dir", default=None)
    return p.parse_args()


def base_pose_matrix(x: float, y: float, yaw: float) -> np.ndarray:
    RT = rotZ(yaw)
    RT[0, 3] = x
    RT[1, 3] = y
    return RT


def head_camera_pose(RT_base: np.ndarray, target_world) -> np.ndarray:
    """World camera pose of a head-height camera on the mobile base looking
    at a world target (look_at parity: pybullet_api.py:364-383)."""
    eye = RT_base[:3, 3] + RT_base[:3, :3] @ np.array([0.12, 0.0, 1.05])
    return look_at_pose(eye, np.asarray(target_world, np.float64))


def plan_base_placement(env, robot, base_planner, RT_base, meta, order, rng,
                        base_effort_weight=0.01, num=2, max_tries=10):
    """Phase 1+2: occupancy grid from afar, BasePlanner until collision-free.
    Returns (RT_base_new, y). Parity: pybullet_gto_planning_mobile.py:109-160."""
    if env.scene_type == "tabletop":
        target = env.TABLE_POS + [0.0, 0.0, env.TABLE_HEIGHT]
    else:
        target = env.SHELF_POS
    cam_pose_w = head_camera_pose(RT_base, target)
    depth, mask, cam_pose_w, K = env.get_observation(cam_pose_w)
    cam_pose_b = np.linalg.inv(RT_base) @ cam_pose_w
    depth_pc = DepthPointCloud(depth, K, cam_pose_b, threshold=np.inf)
    robot.setup_occupancy_grid(np.asarray(depth_pc.points))

    # candidate grasps per object, base frame, grasps below the object
    # center dropped (driver :166-184)
    RTs = {}
    for name in order:
        RT_w = env.grasps_world(name)
        RT_b = np.linalg.inv(RT_base)[None] @ RT_w
        obj_z_b = (np.linalg.inv(RT_base) @ env._placed(name).pose)[2, 3]
        keep = RT_b[:, 2, 3] >= obj_z_b
        RTs[name] = RT_b[keep] if keep.any() else RT_b

    base_planner.setup_optimization(num * len(order), base_effort_weight)
    y = None
    for _ in range(max_tries):
        RTs_all = np.concatenate(
            [RTs[o][rng.choice(RTs[o].shape[0], num)] for o in order]
        )
        qc = np.asarray(env_default_pose(robot))
        _, y, err_pos, err_rot, col_cost = base_planner.plan_goalset(
            qc, RTs_all, verbose=False
        )
        if col_cost == 0:
            break
    # y = old base in the new base frame; invert for the base motion
    RT_delta = base_pose_matrix(y[0], y[1], y[2])
    return RT_base @ np.linalg.inv(RT_delta), y


def env_default_pose(robot):
    from grasptrajopt_tpu.planning.utils import default_pose

    return default_pose(robot)


def main():
    args = make_args()
    data_dir = args.data_dir or get_data_dir()
    robot, gripper, cfg = build_models(args.robot, data_dir)
    base_planner = BasePlanner(robot, cfg["link_ee"], cfg["link_gripper"])
    knobs = SCENE_KNOBS[args.scene_type]
    scene_ids = [int(s) for s in args.scene_ids.split(",")]
    x0, y0, yaw0 = (float(v) for v in args.start_pose.split(","))

    env = SyntheticSceneEnv(
        robot_name=args.robot, scene_type=args.scene_type,
        n_objects=args.n_objects, width=args.width, height=args.height,
        depth_threshold=cfg.get("depth_threshold", 1.5),
    )
    pipeline = GraspPipeline(
        robot, gripper, cfg["link_ee"], cfg["link_gripper"],
        axis_standoff=cfg["axis_standoff"],
        gripper_open_offsets=cfg["gripper_open_offsets"],
        standoff_distance=knobs["standoff_distance"],
        goal_capacity=args.goal_capacity, grid=robot.grid,
        ik_capacity=args.goal_capacity, planner_iterations=args.iterations,
        planner_single_pass=args.single_pass,
        planner_coarse_iterations=args.coarse,
        planner_coarse_stride=args.coarse_stride,
        goal_weight=knobs.get("goal_weight", {}).get(args.robot, 1.0),
        interpolate=knobs.get("interpolate", True),
    )
    qc = np.asarray(cfg["default_pose"])

    t0 = time.time()
    results = {}
    for scene_id in scene_ids:
        meta = env.setup_scene(scene_id)
        rng = np.random.default_rng(scene_id)
        scene_rec = {}
        for ordering in knobs["orderings"]:
            env.reset_scene()
            order = meta[ordering].split(",")

            RT_base0 = base_pose_matrix(x0, y0, yaw0)
            RT_base_new, y = plan_base_placement(
                env, robot, base_planner, RT_base0, meta, order, rng
            )
            print(
                f"scene {scene_id} [{ordering}] base: "
                f"({RT_base_new[0, 3]:.2f}, {RT_base_new[1, 3]:.2f}, "
                f"yaw {np.arctan2(RT_base_new[1, 0], RT_base_new[0, 0]):.2f})",
                flush=True,
            )
            order_rec = {"RT_base_new": RT_base_new.tolist()}
            RT_base_inv = np.linalg.inv(RT_base_new)

            for name in order:
                obj_pos_w = env._placed(name).pose[:3, 3]
                cam_pose_w = head_camera_pose(RT_base_new, obj_pos_w)
                depth, mask, _, K = env.get_observation(cam_pose_w)
                cam_pose_b = RT_base_inv @ cam_pose_w
                target_mask = mask == env._placed(name).uid
                RTs_b = RT_base_inv[None] @ env.grasps_world(name, capacity=args.goal_capacity)
                res = pipeline.plan_object(
                    qc, depth, K, cam_pose_b, target_mask, RTs_b, np.zeros(3)
                )
                rec = {
                    "reward": 0,
                    "checking_time": res.checking_time,
                    "ik_time": res.ik_time,
                    "planning_time": res.planning_time,
                    "stage": res.stage,
                    "num_grasps": res.n_grasps,
                    "num_collision_free": res.n_collision_free,
                    "num_ik": res.n_ik_found,
                    "rescued": res.rescued,
                    "escalated": res.escalated,
                }
                if res.plan is not None:
                    depth_obs = np.array(depth, copy=True)
                    depth_obs[target_mask] = pipeline.depth_threshold
                    dpc_obs = DepthPointCloud(
                        depth_obs, K, cam_pose_b, target_mask,
                        threshold=pipeline.depth_threshold,
                    )
                    s = score_plan(
                        robot, cfg["link_ee"], res.plan, RTs_b, dpc_obs, np.zeros(3)
                    )
                    rec.update(s)
                    rec["plan"] = res.plan.tolist()
                order_rec[name] = rec
                env.remove_object(name)
                print(
                    f"scene {scene_id} [{ordering}] {name}: stage={res.stage} "
                    f"reward={rec.get('reward', 0)} "
                    f"err_pos={rec.get('err_pos', float('nan')):.3f} "
                    f"collision={rec.get('collision', '-')} "
                    f"t={res.checking_time + res.ik_time + res.planning_time:.1f}s",
                    flush=True,
                )
            scene_rec[ordering] = order_rec
        results[str(scene_id)] = scene_rec
    elapsed = time.time() - t0

    os.makedirs(args.outdir, exist_ok=True)
    stamp = datetime.datetime.now().strftime("%y-%m-%d_T%H%M%S")
    out = os.path.join(
        args.outdir,
        f"GTO_synthetic_mobile_{args.robot}_{args.scene_type}_{stamp}.json",
    )
    with open(out, "w") as f:
        json.dump(results, f)

    agg = aggregate_results(results)
    collisions = sum(
        int(bool(rec.get("collision", False)))
        for orderings in results.values()
        for obj in orderings.values()
        for rec in obj.values()
        if isinstance(rec, dict)
    )
    print(json.dumps({
        "trials": agg["trials"],
        "success": agg["success"],
        "success_rate": round(agg["success_rate"], 3),
        "collisions": collisions,
        "mean_checking_time": round(agg["mean_checking_time"] or 0, 2),
        "mean_ik_time": round(agg["mean_ik_time"] or 0, 2),
        "mean_planning_time": round(agg["mean_planning_time"] or 0, 2),
        "elapsed_s": round(elapsed, 1),
        "results_file": out,
    }))


if __name__ == "__main__":
    main()
