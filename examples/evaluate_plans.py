"""Replay recorded plans in PyBullet and re-check collisions + success.

Parity with /root/reference/examples/pybullet_evaluate_plans.py: re-renders
depth per object with the target masked to 2.0 m (:199), rebuilds the
obstacle point cloud, FKs every plan step's body surface points, and flags
collision when >5 points have sdf < 0 (:219-237). Aggregation (:248-269)
is shared with the pure scorer in grasptrajopt_tpu.utils.results, which
also works without a simulator.

Device redesign: the 50-step x ~1.2k-point collision recheck is one batched
device call per object instead of a Python loop over steps.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

import jax.numpy as jnp

from grasptrajopt_tpu.envs import HAS_PYBULLET
from grasptrajopt_tpu.fields import DepthPointCloud
from grasptrajopt_tpu.planning import GTORobotModel
from grasptrajopt_tpu.planning.utils import get_data_dir, load_robot_config
from grasptrajopt_tpu.utils import aggregate_results, load_results


def make_args():
    parser = argparse.ArgumentParser(description="Evaluate recorded plans")
    parser.add_argument("-r", "--robot", default="panda")
    parser.add_argument("-d", "--data_dir", default=None)
    parser.add_argument("-s", "--scene_id", type=int, default=-1)
    parser.add_argument("-t", "--scene_type", default="tabletop")
    parser.add_argument("-f", "--file", required=True)
    parser.add_argument("--mobile", action="store_true")
    parser.add_argument("--assets_dir", default=None)
    return parser.parse_args()


def check_plan_collision(robot, plan, depth_pc, base_position):
    """True if any plan step puts >5 body points inside the scene
    (parity: :219-237), evaluated for all steps in one batch."""
    Q = jnp.asarray(np.asarray(plan).T, robot.dtype)  # (T, ndof)
    pts = robot.fk_surface_points(Q, base_position=jnp.asarray(base_position, robot.dtype))
    T, P, _ = pts.shape
    sdf = np.asarray(depth_pc.get_sdf(pts.reshape(-1, 3))).reshape(T, P)
    return bool(((sdf < 0).sum(axis=1) > 5).any())


def main():
    args = make_args()
    agg_only = not HAS_PYBULLET
    assets_dir = args.assets_dir or get_data_dir()
    data_dir = args.data_dir or assets_dir

    results_scene = load_results(args.file)
    if agg_only:
        print("pybullet not available: reporting recorded-success aggregation only")
        agg = aggregate_results(results_scene)
        print(agg)
        return

    import pybullet as p

    from grasptrajopt_tpu.envs.scene_replica import SceneReplicaEnv

    robot_name = args.robot
    scene_type = args.scene_type
    orderings = ["nearest_first", "random"] if scene_type == "tabletop" else ["random"]
    cfg = load_robot_config(robot_name, assets_dir)
    urdf_rel = cfg["urdf_robot_path"].split("data/", 1)[-1]
    robot = GTORobotModel(
        os.path.join(assets_dir, "robots", cfg["robot_name"]),
        urdf_filename=os.path.join(assets_dir, urdf_rel),
        time_derivs=[0, 1],
        param_joints=cfg["param_joints"],
        collision_link_names=cfg["collision_link_names"],
    )
    env = SceneReplicaEnv(
        os.path.join(assets_dir, urdf_rel), data_dir, assets_dir, robot_name,
        scene_type, mobile=args.mobile,
    )
    base_mass = p.getDynamicsInfo(env.robot._id, -1)[0]

    total_collision = 0
    collision_by_object = {}
    all_scene_ids = env.all_scene_ids if args.scene_id == -1 else [args.scene_id]
    for scene_id in all_scene_ids:
        meta = env.setup_scene(scene_id)
        results_ordering = results_scene[f"{scene_id}"]
        for ordering in orderings:
            object_order = meta[ordering][0].split(",")
            results = results_ordering[ordering]
            if args.mobile:
                RT_base_new = np.array(results["RT_base_new"]).reshape(4, 4)
                from grasptrajopt_tpu.spatial import r2quat

                q = np.asarray(r2quat(jnp.asarray(RT_base_new[:3, :3])))
                env.set_robot_pose(RT_base_new[:3, 3], q.tolist())
                p.changeDynamics(env.robot._id, -1, mass=0)
            set_objects = set(object_order)
            for object_name in object_order:
                rec = results[object_name]
                env.reset_scene(set_objects)
                rgba, depth, mask, cam_pose, K = env.get_observation()
                idx = env.object_uids[env.object_names.index(object_name)]
                target_mask = mask == idx
                depth = np.array(depth, copy=True)
                depth[target_mask] = 2.0
                if args.mobile:
                    depth[mask == 1] = 2.0
                    pos, orn = env.get_robot_pose()
                    from grasptrajopt_tpu.envs.camera import pose_from_position_quaternion

                    RT_base = pose_from_position_quaternion(pos, [orn[3], orn[0], orn[1], orn[2]])
                    cam_pose = np.linalg.inv(RT_base) @ cam_pose
                depth_pc = DepthPointCloud(
                    depth, K, cam_pose, target_mask, threshold=cfg["depth_threshold"]
                )
                in_collision = False
                if rec["plan"] is not None:
                    base = [0, 0, 0] if args.mobile else env.base_position
                    in_collision = check_plan_collision(robot, rec["plan"], depth_pc, base)
                total_collision += int(in_collision)
                collision_by_object[object_name] = (
                    collision_by_object.get(object_name, 0) + int(in_collision)
                )
                print(f"{object_name}: success {rec['reward']}, collision {int(in_collision)}")
                set_objects.remove(object_name)
                env.reset_objects(object_name)
            if args.mobile:
                p.changeDynamics(env.robot._id, -1, mass=base_mass)

    agg = aggregate_results(results_scene)
    agg["total_collision"] = total_collision
    agg["collision_by_object"] = collision_by_object
    print(agg)


if __name__ == "__main__":
    main()
