"""Closed-loop evaluation on synthetic SceneReplica-style scenes — no
pybullet, no external dataset.

This is the framework's self-contained integration benchmark: procedurally
generated tabletop/shelf scenes (envs/synthetic.py), depth observations
from the software z-buffer renderer, the full GraspPipeline per object
(fields -> grasp filter -> IK screen -> goal-set plan), then kinematic
replay scoring with the reference's own criteria: goal reach within the IK
gates and step-wise collision (> 5 body points with sdf < 0 => collision,
/root/reference/examples/pybullet_evaluate_plans.py:219-237).

Writes the reference's result-JSON schema
(pybullet_gto_planning.py:323-338) so utils/results.py aggregates it
exactly like the IROS'24 files.

Run on CPU (float64):
  JAX_PLATFORMS=cpu python examples/synthetic_eval.py
or simply `make eval`. On a GPU, `--device gpu` runs the same float32
device programs bench.py times.
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

import jax.numpy as jnp

from grasptrajopt_tpu.envs.synthetic import SyntheticSceneEnv
from grasptrajopt_tpu.fields import DepthPointCloud, FusedDepthPointCloud
from grasptrajopt_tpu.planning import GTORobotModel
from grasptrajopt_tpu.planning.evaluate import score_plan
from grasptrajopt_tpu.planning.pipeline import GraspPipeline
from grasptrajopt_tpu.planning.utils import get_data_dir, load_robot_config
from grasptrajopt_tpu.utils.results import aggregate_results

# scene-type knobs (parity: pybullet_gto_planning.py:91-109; goal_weight
# counters the deep-standoff rotation equilibrium at -0.2 — PERF.md).
# The weighting is panda-specific: it lifted panda shelf 0.60 -> 0.68 but
# cost fetch one trial (0.88 -> 0.84, sugar-box near-miss), so fetch keeps
# the parity weight.
SCENE_KNOBS = {
    "tabletop": dict(
        standoff_distance=-0.1, orderings=["nearest_first", "random"],
        goal_weight={}, interpolate=True,
        grid_resolution=0.05, field_epsilon=0.02,
    ),
    # interpolate=False mirrors the reference's shelf warm start
    # (pybullet_gto_planning.py:102-103: interpolated seeds sweep through
    # the shelf; the constant-qc seed with the IK tail does not).
    # grid_resolution 0.025: the parity 5 cm grid undersamples the 2 cm
    # cost band and cannot represent thin-object clearance in the tight
    # shelf (potted_meat_can / gelatin_box replay collisions); the finer
    # grid is a fidelity knob the CPU reference cannot afford.
    # views=2: head camera + the env's "peek" vantage, fused for the
    # planner fields AND the replay scorer. A single head-height view
    # leaves an occlusion band under the upper shelf board that the
    # visibility sign test marks 'inside' — which both blocked the true
    # free corridor during planning and charged plans for free-space
    # "collisions" during scoring (the round-6 root cause of the two
    # budget-independent shelf failures; PERF.md, point-in-geometry
    # replay classification in tools/probe_shelf_fail.py).
    # plan_views=1: the planner's cost fields stay single-view
    # (conservative — the head camera's occlusion band under the upper
    # board is a safety buffer; planning flush against the freed corridor
    # overshot INTO the board, round-6 potted_meat_can); the filter and
    # the replay scorer fuse both views.
    "shelf": dict(
        standoff_distance=-0.2, orderings=["random"],
        goal_weight={"panda": 4.0}, interpolate=False,
        grid_resolution=0.025, field_epsilon=0.02, field_downsample=0.01,
        views=2, plan_views=1,
    ),
}


def make_args():
    p = argparse.ArgumentParser(description="synthetic closed-loop evaluation")
    p.add_argument("-r", "--robot", default="panda", choices=["panda", "fetch"])
    p.add_argument("-t", "--scene_type", default="tabletop", choices=["tabletop", "shelf"])
    p.add_argument("--scene_ids", default="10,36,48,65,77")
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
    p.add_argument("--final_trust", action="store_true",
                   help="return the final KKT trial unevaluated (skips the "
                        "post-scan residual pass; requires --single_pass)")
    p.add_argument("--resume", default=None,
                   help="path to a (partial) result JSON from an interrupted "
                        "run; completed objects are skipped and new results "
                        "are checkpointed into the SAME file. The solver "
                        "flavor flags must match the original run.")
    p.add_argument("--device", default="cpu", choices=["cpu", "gpu"],
                   help="gpu: run the pipeline's device programs on the GPU "
                        "(f32, one process per card) so quality is measured "
                        "on the same jitted artifacts bench.py times; cpu "
                        "(default): x64 host run")
    p.add_argument("--outdir", default="results")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--grid_resolution", type=float, default=None,
                   help="override the scene-type knob (m/voxel)")
    p.add_argument("--field_epsilon", type=float, default=None,
                   help="override the scene-type cost-band knob (m)")
    p.add_argument("--views", type=int, default=None,
                   help="number of fused camera views (default: scene knob)")
    return p.parse_args()


def build_models(robot_name: str, data_dir: str, grid_resolution: float = 0.05,
                 dtype=None):
    dtype = dtype if dtype is not None else jnp.float64
    cfg = load_robot_config(robot_name, data_dir)
    urdf_rel = cfg["urdf_robot_path"].split("data/", 1)[-1]
    grip_rel = cfg["urdf_gripper_path"].split("data/", 1)[-1]
    robot = GTORobotModel(
        model_dir=os.path.join(data_dir, "robots", cfg["robot_name"]),
        urdf_filename=os.path.join(data_dir, urdf_rel),
        time_derivs=[0, 1],
        param_joints=cfg["param_joints"],
        collision_link_names=cfg["collision_link_names"],
        grid_resolution=grid_resolution,
        dtype=dtype,
    )
    robot.setup_workspace_field(arm_len=cfg["arm_len"], arm_height=cfg["arm_height"])
    gripper = GTORobotModel(
        model_dir=os.path.join(data_dir, "robots", cfg["robot_name"]),
        urdf_filename=os.path.join(data_dir, grip_rel),
        dtype=dtype,
    )
    return robot, gripper, cfg


def evaluate_scenes(
    robot,
    gripper,
    cfg,
    scene_type: str = "tabletop",
    scene_ids=(10,),
    n_objects: int = 5,
    width: int = 160,
    height: int = 160,
    goal_capacity: int = 32,
    iterations: int = 50,
    single_pass: bool = False,
    coarse_iterations: int = 0,
    coarse_stride: int = 2,
    final_trust: bool = False,
    orderings=None,
    verbose: bool = True,
    field_epsilon: float = None,
    views: int = None,
    checkpoint_path: str = None,
    prior: dict = None,
):
    """Run the full pipeline over synthetic scenes; returns the result dict
    in the reference schema plus collision statistics.

    The caller owns the grid resolution (build the robot's workspace field
    at SCENE_KNOBS[scene_type]['grid_resolution']); field_epsilon defaults
    to the scene-type knob.

    checkpoint_path: when set, the (partial) result dict is re-dumped to
    this JSON after EVERY object — long sweeps survive interruption at
    object granularity (the reference driver checkpoints per scene;
    pybullet_gto_planning.py --resume).

    prior: a (partial) result dict from an interrupted run with the same
    flavor flags; objects already recorded there are skipped (the env
    still removes them so later objects see the same scene state — the
    env's only RNG is the scene_id-seeded setup)."""
    knobs = SCENE_KNOBS[scene_type]
    orderings = orderings or knobs["orderings"]
    if field_epsilon is None:
        field_epsilon = knobs.get("field_epsilon", 0.02)
    if views is None:
        views = knobs.get("views", 1)
    env = SyntheticSceneEnv(
        robot_name=cfg["robot_name"], scene_type=scene_type,
        n_objects=n_objects, width=width, height=height,
        depth_threshold=cfg.get("depth_threshold", 1.5),
    )
    pipeline = GraspPipeline(
        robot, gripper, cfg["link_ee"], cfg["link_gripper"],
        axis_standoff=cfg["axis_standoff"],
        gripper_open_offsets=cfg["gripper_open_offsets"],
        standoff_distance=knobs["standoff_distance"],
        goal_capacity=goal_capacity, grid=robot.grid,
        ik_capacity=goal_capacity, planner_iterations=iterations,
        planner_single_pass=single_pass,
        planner_coarse_iterations=coarse_iterations,
        planner_coarse_stride=coarse_stride,
        planner_final_trust=final_trust,
        goal_weight=knobs.get("goal_weight", {}).get(cfg["robot_name"], 1.0),
        interpolate=knobs.get("interpolate", True),
        field_epsilon=field_epsilon,
        field_downsample=knobs.get("field_downsample"),
        plan_views=knobs.get("plan_views"),
    )
    qc = np.asarray(cfg["default_pose"])
    base_position = env.base_position

    results = {}
    for scene_id in scene_ids:
        meta = env.setup_scene(scene_id)
        scene_rec = {}
        for ordering in orderings:
            env.reset_scene()
            order_rec = {}
            for name in meta[ordering].split(","):
                prev = (
                    (prior or {}).get(str(scene_id), {}).get(ordering, {}).get(name)
                )
                if prev is not None and "reward" in prev:
                    order_rec[name] = prev
                    env.remove_object(name)
                    if verbose:
                        print(
                            f"scene {scene_id} [{ordering}] {name}: resumed "
                            f"(reward={prev.get('reward', 0)})",
                            flush=True,
                        )
                    continue
                cam_poses = env.camera_poses(views)
                uid = env._placed(name).uid
                depths, masks = [], []
                for cp in cam_poses:
                    d, m, _, K = env.get_observation(cp)
                    depths.append(d)
                    masks.append(m == uid)
                depth, cam_pose, target_mask = depths[0], cam_poses[0], masks[0]
                RTs = env.grasps_world(name, capacity=goal_capacity)
                res = pipeline.plan_object(
                    qc,
                    depths if views > 1 else depth,
                    K,
                    cam_poses if views > 1 else cam_pose,
                    masks if views > 1 else target_mask,
                    RTs,
                    base_position,
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
                    obs_views = []
                    for d, cp, m in zip(depths, cam_poses, masks):
                        d_obs = np.array(d, copy=True)
                        d_obs[m] = pipeline.depth_threshold
                        obs_views.append(DepthPointCloud(
                            d_obs, K, cp, m, threshold=pipeline.depth_threshold,
                        ))
                    dpc_obs = (
                        obs_views[0] if len(obs_views) == 1
                        else FusedDepthPointCloud(obs_views)
                    )
                    RT_base = RTs.copy()
                    RT_base[:, :3, 3] -= base_position
                    s = score_plan(
                        robot, cfg["link_ee"], res.plan, RT_base, dpc_obs, base_position
                    )
                    rec.update(s)
                    rec["plan"] = res.plan.tolist()
                order_rec[name] = rec
                if checkpoint_path is not None:
                    snapshot = dict(results)
                    snapshot[str(scene_id)] = {**scene_rec, ordering: order_rec}
                    # atomic: never leave a truncated checkpoint behind
                    with open(checkpoint_path + ".tmp", "w") as f:
                        json.dump(snapshot, f)
                    os.replace(checkpoint_path + ".tmp", checkpoint_path)
                env.remove_object(name)
                if verbose:
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
    return results


def main():
    args = make_args()
    data_dir = args.data_dir or get_data_dir()
    knobs = SCENE_KNOBS[args.scene_type]
    grid_resolution = (
        args.grid_resolution
        if args.grid_resolution is not None
        else knobs.get("grid_resolution", 0.05)
    )
    dtype = jnp.float64
    if args.device == "gpu":
        # run the same f32 programs bench.py times, with the persistent
        # compile cache
        from grasptrajopt_tpu.utils.device import enable_compile_cache, require_gpu

        require_gpu()
        jax.config.update("jax_enable_x64", False)
        enable_compile_cache()
        dtype = jnp.float32
    robot, gripper, cfg = build_models(
        args.robot, data_dir, grid_resolution=grid_resolution, dtype=dtype
    )
    scene_ids = [int(s) for s in args.scene_ids.split(",")]

    os.makedirs(args.outdir, exist_ok=True)
    prior = None
    if args.resume:
        with open(args.resume) as f:
            prior = json.load(f)
        out = args.resume
        n_prior = sum(
            len(objs) for ords in prior.values() for objs in ords.values()
        )
        print(f"resuming {args.resume}: {n_prior} objects already recorded",
              flush=True)
    else:
        stamp = datetime.datetime.now().strftime("%y-%m-%d_T%H%M%S")
        views_n = args.views or SCENE_KNOBS[args.scene_type].get("views", 1)
        tag = f"_mv{views_n}" if views_n > 1 else ""
        out = os.path.join(
            args.outdir,
            f"GTO_synthetic_{args.robot}_{args.scene_type}{tag}_{stamp}.json",
        )

    t0 = time.time()
    results = evaluate_scenes(
        robot, gripper, cfg,
        scene_type=args.scene_type, scene_ids=scene_ids,
        n_objects=args.n_objects, width=args.width, height=args.height,
        goal_capacity=args.goal_capacity, iterations=args.iterations,
        single_pass=args.single_pass, coarse_iterations=args.coarse,
        coarse_stride=args.coarse_stride, final_trust=args.final_trust,
        field_epsilon=args.field_epsilon, views=args.views,
        checkpoint_path=out,
        prior=prior,
    )
    elapsed = time.time() - t0

    with open(out + ".tmp", "w") as f:
        json.dump(results, f)
    os.replace(out + ".tmp", out)

    agg = aggregate_results(results)
    collisions = sum(
        int(bool(rec.get("collision", False)))
        for orderings in results.values()
        for obj in orderings.values()
        for rec in obj.values()
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
