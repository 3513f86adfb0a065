"""Plan replay evaluation: collision checking and goal-reach scoring.

Library form of the reference's evaluation driver semantics
(/root/reference/examples/pybullet_evaluate_plans.py:219-237): every step
of a recorded plan is FK'd to body surface points and checked against the
obstacle-only depth point cloud; a step with more than `threshold_points`
points at sdf < 0 is a collision. Goal reach follows the driver's IK
acceptance gates (pybullet_gto_planning.py:262).

Device redesign: the whole T-step replay is ONE batched FK + ONE fused
min-distance query instead of the reference's per-step KD-tree loops.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from grasptrajopt_tpu.spatial import r2quat
from grasptrajopt_tpu.spatial.quaternion import qangle_deg


def check_plan_collision(
    robot,
    plan: np.ndarray,
    depth_pc_obstacle,
    base_position=(0.0, 0.0, 0.0),
    threshold_points: int = 5,
) -> Tuple[bool, np.ndarray]:
    """Replay a (ndof, T) plan against the obstacle depth cloud.

    Returns (collision, per-step inside-point counts). Collision when any
    step has more than `threshold_points` surface points with sdf < 0
    (parity: pybullet_evaluate_plans.py:219-237), EXCLUDING baseline
    contacts — points already inside at step 0, the robot's current
    configuration. Those are pre-existing resting contacts (e.g. the
    fixed base sitting exactly on the observed support plane), not
    plan-induced penetration; a criterion counting them marks EVERY plan
    of that robot colliding. The reference never meets this case because
    its evaluation re-renders depth WITH the robot in view
    (pybullet_evaluate_plans.py:196), so the support surface under the
    robot's own footprint is occluded from the cloud; the exclusion is
    parity-preserving on reference-like observations while making the
    criterion robust to synthetic ones without robot self-occlusion.
    """
    plan = np.asarray(plan)
    Q = jnp.asarray(plan.T, robot.dtype)  # (T, ndof)
    pts = robot.fk_surface_points(
        Q, base_position=jnp.asarray(np.asarray(base_position), robot.dtype)
    )  # (T, P, 3)
    T, P = pts.shape[0], pts.shape[1]
    sdf = depth_pc_obstacle.get_sdf(pts.reshape(-1, 3)).reshape(T, P)
    inside = np.asarray(sdf) < 0  # (T, P)
    counts = np.asarray((inside & ~inside[0]).sum(axis=1))
    return bool((counts > threshold_points).any()), counts


def goalset_reach_errors(
    robot, link_ee: str, q_final, RT_goals: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-goal final end-effector pose errors over the grasp set.

    Returns (err_pos (n,) [m], err_rot (n,) [deg]) — the reference's error
    metrics (gto/ik_solver.py:93-97). Goal sets contain symmetric grasps
    (flip pairs sharing a position), so success tests must gate on ANY goal
    satisfying both tolerances, not the min-position one."""
    q_final = jnp.asarray(np.asarray(q_final), robot.dtype).reshape(-1)
    T_ee = np.asarray(robot.get_global_link_transform(link_ee, q_final))
    RT_goals = np.asarray(RT_goals)
    d = np.linalg.norm(RT_goals[:, :3, 3] - T_ee[:3, 3], axis=1)
    q_goals = r2quat(jnp.asarray(RT_goals[:, :3, :3], robot.dtype))
    q_ee = r2quat(jnp.asarray(np.broadcast_to(T_ee[:3, :3], (len(d), 3, 3)), robot.dtype))
    rot = np.asarray(qangle_deg(q_goals, q_ee))
    return d, rot


def score_plans_pergoal(
    robot,
    link_ee: str,
    plans: np.ndarray,
    RT_goals: np.ndarray,
    depth_pc_obstacle,
    base_position=(0.0, 0.0, 0.0),
    pos_tol: float = 0.02,
    rot_tol_deg: float = 10.0,
    threshold_points: int = 5,
) -> list:
    """Score n plans, each against ITS OWN goal, in ONE batched replay.

    plans (n, ndof, T); RT_goals (n, 4, 4) aligned with plans. The whole
    bundle is FK'd and SDF-queried in a single device program (vs n
    sequential score_plan round-trips) — the rescue path's scorer.
    Returns a list of n dicts with the score_plan fields."""
    plans = np.asarray(plans)
    RT_goals = np.asarray(RT_goals)
    n, ndof, T = plans.shape
    Q_all = jnp.asarray(plans.transpose(0, 2, 1).reshape(n * T, ndof), robot.dtype)
    pts = robot.fk_surface_points(
        Q_all, base_position=jnp.asarray(np.asarray(base_position), robot.dtype)
    )  # (n*T, P, 3)
    P = pts.shape[1]
    sdf = np.asarray(depth_pc_obstacle.get_sdf(pts.reshape(-1, 3))).reshape(n, T, P)
    inside = sdf < 0  # (n, T, P)
    # baseline-contact exclusion per plan (see check_plan_collision)
    counts = (inside & ~inside[:, :1, :]).sum(axis=2)  # (n, T)
    collisions = (counts > threshold_points).any(axis=1)

    finals = jnp.asarray(plans[:, :, -1], robot.dtype)  # (n, ndof)
    T_ee = np.asarray(
        jax.vmap(lambda q: robot.get_global_link_transform(link_ee, q))(finals)
    )  # (n, 4, 4)
    d = np.linalg.norm(RT_goals[:, :3, 3] - T_ee[:, :3, 3], axis=1)
    q_goals = r2quat(jnp.asarray(RT_goals[:, :3, :3], robot.dtype))
    q_ee = r2quat(jnp.asarray(T_ee[:, :3, :3], robot.dtype))
    rot = np.asarray(qangle_deg(q_goals, q_ee))

    out = []
    for i in range(n):
        reached = bool((d[i] < pos_tol) and (rot[i] < rot_tol_deg))
        collision = bool(collisions[i])
        out.append({
            "err_pos": float(d[i]),
            "err_rot": float(rot[i]),
            "reached": reached,
            "collision": collision,
            "max_inside_points": int(counts[i].max()),
            "reward": int(reached and not collision),
        })
    return out


def score_plan(
    robot,
    link_ee: str,
    plan: np.ndarray,
    RT_goals: np.ndarray,
    depth_pc_obstacle,
    base_position=(0.0, 0.0, 0.0),
    pos_tol: float = 0.02,
    rot_tol_deg: float = 10.0,
    threshold_points: int = 5,
) -> dict:
    """Full kinematic scoring of one plan: goal reach + collision replay.

    reward = reached AND collision-free — the synthetic stand-in for the
    reference's physical grasp reward (pybullet_scenereplica.py:574-589)."""
    # the planner's goal frame includes the base offset: goals are given in
    # the base frame by the drivers; callers pass base-frame goals here
    d, rot = goalset_reach_errors(robot, link_ee, plan[:, -1], RT_goals)
    within = (d < pos_tol) & (rot < rot_tol_deg)
    reached = bool(within.any())
    # report the errors of the goal actually reached: best combined score
    # restricted to goals meeting both tolerances when any does, so the
    # recorded (err_pos, err_rot) pair is always consistent with `reached`
    score = d + rot * 2e-3
    if reached:
        score = np.where(within, score, np.inf)
    best = int(np.argmin(score))
    err_pos, err_rot = float(d[best]), float(rot[best])
    collision, counts = check_plan_collision(
        robot, plan, depth_pc_obstacle, base_position, threshold_points
    )
    return {
        "err_pos": err_pos,
        "err_rot": err_rot,
        "reached": bool(reached),
        "collision": bool(collision),
        "max_inside_points": int(counts.max()),
        "reward": int(reached and not collision),
    }
