"""SceneReplica fixed-base grasp-planning driver (this framework's edition).

Pipeline parity with /root/reference/examples/pybullet_gto_planning.py:
per scene x ordering x object: observation -> two SDF cost fields (with and
without the target object) -> grasp-set collision pre-filter (gripper
surface points vs obstacle SDF, reject if >1% points inside, :202-240) ->
IK screen (accept if pos err < 0.01 m, rot err < 5 deg, collision cost
under threshold, :242-278) -> goal-set trajectory optimization (:287-295)
-> execute, close gripper, lift/retreat, reward, JSON dump (:297-338).
Scene-type knobs at :91-109.

Device redesign inside the same flow: the grasp collision pre-filter is ONE
batched device call (all grasps at once), the IK screen is ONE vmapped
solve over the whole grasp set, and the SDF cost fields are built on
device — the three phases the reference spends 0.5-2.5 s each on.

Requires pybullet + the external SceneReplica dataset.
"""

import argparse
import datetime
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

import jax.numpy as jnp

from grasptrajopt_tpu.envs import HAS_PYBULLET
from grasptrajopt_tpu.envs.camera import pose_from_position_quaternion
from grasptrajopt_tpu.envs.grasps import load_grasps
from grasptrajopt_tpu.fields import DepthPointCloud
from grasptrajopt_tpu.ops import min_sqdist
from grasptrajopt_tpu.planning import GTOPlanner, GTORobotModel, IKSolver
from grasptrajopt_tpu.planning.utils import get_data_dir, load_robot_config
from grasptrajopt_tpu.spatial import transform_points

SCENE_KNOBS = {
    "tabletop": dict(
        standoff_distance=-0.1, standoff_offset=-10, ik_collision_avoidance=False,
        ik_collision_threshold=5, interpolate=True, orderings=["nearest_first", "random"],
    ),
    "shelf": dict(
        standoff_distance=-0.2, standoff_offset=-10, ik_collision_avoidance=False,
        ik_collision_threshold=0.001, interpolate=False, orderings=["random"],
    ),
}


def make_args():
    parser = argparse.ArgumentParser(description="SceneReplica GTO planning")
    parser.add_argument("-r", "--robot", default="panda")
    parser.add_argument("-d", "--data_dir", default=None, help="SceneReplica dataset root")
    parser.add_argument("-s", "--scene_id", type=int, default=-1)
    parser.add_argument("-t", "--scene_type", default="tabletop")
    parser.add_argument("--assets_dir", default=None, help="robot/object asset tree")
    parser.add_argument("--goal_capacity", type=int, default=64)
    parser.add_argument(
        "--resume", default=None,
        help="partial result JSON to resume from (finished scenes are skipped)",
    )
    return parser.parse_args()


def filter_grasps_by_collision(gripper_model, gripper_open, RT_offs, depth_pc_obstacle):
    """Batched grasp collision pre-filter (parity: driver :202-240).

    Gripper surface points are computed once in the gripper base frame, then
    transformed by every grasp standoff pose in one op; a single SDF query
    covers all grasps.
    """
    pts_local, _ = gripper_model.compute_fk_surface_points(np.asarray(gripper_open))
    pts = transform_points(jnp.asarray(RT_offs, jnp.float32), jnp.asarray(pts_local, jnp.float32))
    n, P, _ = pts.shape
    sdf = np.asarray(depth_pc_obstacle.get_sdf(pts.reshape(-1, 3))).reshape(n, P)
    ratios = (sdf < 0).mean(axis=1)
    return ratios <= 0.01, ratios


def main():
    # parse first so `--help` works without the engine installed
    args = make_args()
    if not HAS_PYBULLET:
        print("this driver needs pybullet (pip install pybullet)")
        sys.exit(1)

    from grasptrajopt_tpu.envs.scene_replica import SceneReplicaEnv
    robot_name = args.robot
    scene_type = args.scene_type
    knobs = SCENE_KNOBS[scene_type]
    assets_dir = args.assets_dir or get_data_dir()
    data_dir = args.data_dir or assets_dir
    offset = -0.01  # standoff used for grasp collision checking (:109)

    cfg = load_robot_config(robot_name, assets_dir)
    urdf_rel = cfg["urdf_robot_path"].split("data/", 1)[-1]
    gripper_rel = cfg["urdf_gripper_path"].split("data/", 1)[-1]
    model_dir = os.path.join(assets_dir, "robots", cfg["robot_name"])

    robot = GTORobotModel(
        model_dir,
        urdf_filename=os.path.join(assets_dir, urdf_rel),
        time_derivs=[0, 1],
        param_joints=cfg["param_joints"],
        collision_link_names=cfg["collision_link_names"],
    )
    gripper_model = GTORobotModel(model_dir, urdf_filename=os.path.join(assets_dir, gripper_rel))

    env = SceneReplicaEnv(
        os.path.join(assets_dir, urdf_rel), data_dir, assets_dir, robot_name, scene_type
    )

    planner = GTOPlanner(
        robot, cfg["link_ee"], cfg["link_gripper"],
        standoff_distance=knobs["standoff_distance"],
        standoff_offset=knobs["standoff_offset"],
    )
    ik_solver = IKSolver(
        robot, cfg["link_ee"], cfg["link_gripper"],
        collision_avoidance=knobs["ik_collision_avoidance"],
    )

    total_success = 0
    count = 0
    results_scene = {}
    # checkpoint/resume at scene granularity: partial results are flushed
    # after every scene and can be reloaded with --resume (the reference
    # only writes at the very end, pybullet_gto_planning.py:330-338)
    os.makedirs("results", exist_ok=True)
    stamp = "{:%y-%m-%d_T%H%M%S}".format(datetime.datetime.now())
    out = os.path.join("results", f"GTO_scenereplica_{robot_name}_{scene_type}_{stamp}.json")
    if args.resume and os.path.exists(args.resume):
        with open(args.resume) as f:
            results_scene = json.load(f)
        print(f"resuming: {len(results_scene)} scenes already done")

    all_scene_ids = env.all_scene_ids if args.scene_id == -1 else [args.scene_id]
    for scene_id in all_scene_ids:
        if f"{scene_id}" in results_scene:
            continue
        print(f"===== Scene {scene_id} =====")
        meta = env.setup_scene(scene_id)

        results_ordering = {}
        for ordering in knobs["orderings"]:
            object_order = meta[ordering][0].split(",")
            results = {}
            set_objects = set(object_order)
            for object_name in object_order:
                count += 1
                env.reset_scene(set_objects)

                # perception: two SDF fields on the scene-bounds grid
                rgba, depth, mask, cam_pose, K = env.get_observation()
                idx = env.object_uids[env.object_names.index(object_name)]
                target_mask = mask == idx
                depth_pc = DepthPointCloud(depth, K, cam_pose, threshold=cfg["depth_threshold"])
                robot.setup_points_field(depth_pc.points)
                grid = robot.grid
                sdf_cost_all = np.asarray(depth_pc.build_cost_field(grid))

                depth_obstacle = np.array(depth, copy=True)
                depth_obstacle[target_mask] = cfg["depth_threshold"]
                depth_pc_obstacle = DepthPointCloud(
                    depth_obstacle, K, cam_pose, target_mask, threshold=cfg["depth_threshold"]
                )
                sdf_cost_obstacle = np.asarray(depth_pc_obstacle.build_cost_field(grid))
                # field geometry changed -> rebuild solver caches
                ik_solver.setup_optimization(grid)

                # grasp set -> world, batched collision pre-filter
                RT_grasps = load_grasps(data_dir, robot_name, object_name)
                pos, orn = env.get_object_pose(object_name)
                RT_obj = pose_from_position_quaternion(pos, [orn[3], orn[0], orn[1], orn[2]])
                start = time.time()
                RT_grasps_world = np.einsum("ij,njk->nik", RT_obj, RT_grasps)
                RT_offs = RT_grasps_world @ robot.get_standoff_pose(offset, cfg["axis_standoff"])
                keep, ratios = filter_grasps_by_collision(
                    gripper_model, cfg["gripper_open_offsets"], RT_offs, depth_pc_obstacle
                )
                RT_grasps_world = RT_grasps_world[keep]
                checking_time = time.time() - start
                print(f"{keep.size} grasps, {keep.sum()} collision-free ({checking_time:.2f}s)")
                if RT_grasps_world.shape[0] == 0:
                    set_objects.remove(object_name)
                    results[object_name] = {
                        "reward": 0, "plan": None, "checking_time": checking_time,
                        "ik_time": None, "planning_time": None,
                    }
                    continue

                # batched IK screen over the whole grasp set
                start = time.time()
                RT_grasps_base = RT_grasps_world.copy()
                RT_grasps_base[:, :3, 3] -= env.base_position
                if scene_type == "shelf":
                    RT_ik = RT_grasps_base @ robot.get_standoff_pose(
                        knobs["standoff_distance"], cfg["axis_standoff"]
                    )
                else:
                    RT_ik = RT_grasps_base
                q0 = np.array(env.robot.q())
                q_sols, err_pos, err_rot, col_cost = ik_solver.solve_ik_batch(
                    q0, RT_ik, sdf_cost_obstacle, env.base_position, multistart=True
                )
                found = (err_pos < 0.01) & (err_rot < 5) & (col_cost < knobs["ik_collision_threshold"])
                ik_time = time.time() - start
                print(f"IK: {found.sum()}/{found.size} found ({ik_time:.2f}s)")
                RT_grasps_base = RT_grasps_base[found]
                q_solutions = q_sols[found].T
                if RT_grasps_base.shape[0] == 0:
                    set_objects.remove(object_name)
                    results[object_name] = {
                        "reward": 0, "plan": None, "checking_time": checking_time,
                        "ik_time": ik_time, "planning_time": None,
                    }
                    continue

                # goal-set trajectory optimization
                qc = np.array(env.robot.q())
                start = time.time()
                cap = max(args.goal_capacity, RT_grasps_base.shape[0])
                plan, dQ, cost = planner.plan_goalset(
                    qc, RT_grasps_base, sdf_cost_all, sdf_cost_obstacle,
                    env.base_position, q_solutions,
                    use_standoff=True, axis_standoff=cfg["axis_standoff"],
                    interpolate=knobs["interpolate"], goal_capacity=cap,
                )
                planning_time = time.time() - start
                print(f"planning time {planning_time:.2f}s cost {cost}")

                # execute
                env.execute_plan(plan)
                env.robot.close_gripper()
                env.record_gripper_position()
                time.sleep(1.0)
                if scene_type == "tabletop":
                    env.retract(cfg["retract_distance"])
                else:
                    plan_standoff = plan[:, np.arange(knobs["standoff_offset"] - 10, -1)]
                    plan_reverse = plan_standoff[:, ::-1].copy()
                    plan_reverse[cfg["finger_index"], :] = 0
                    env.robot.execute_plan(plan_reverse)
                reward = env.compute_reward(object_name)
                env.reset_objects(object_name)
                env.robot.retract()
                set_objects.remove(object_name)
                total_success += reward
                print(f"scene {scene_id} {ordering} {object_name}: reward {reward} "
                      f"(total {total_success}/{count})")
                results[object_name] = {
                    "reward": reward, "plan": plan.tolist(), "checking_time": checking_time,
                    "ik_time": ik_time, "planning_time": planning_time,
                }
            results_ordering[ordering] = results
        results_scene[f"{scene_id}"] = results_ordering
        with open(out, "w") as f:  # flush checkpoint after every scene
            json.dump(results_scene, f)

    print("total success", total_success)
    with open(out, "w") as f:
        json.dump(results_scene, f)
    print("wrote", out)


if __name__ == "__main__":
    main()
