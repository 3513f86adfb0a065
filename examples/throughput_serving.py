"""Serving-style throughput demo: a stream of planning requests drives one
jitted goal-set solver with a bounded number of batches in flight.

The reference plans one object at a time, synchronously
(/root/reference/examples/pybullet_gto_planning.py:151-164). Deployed as a
service, the same work is a request stream: this demo microbatches
requests, keeps `--inflight` device calls outstanding
(grasptrajopt_tpu.parallel.PlanStream), and reports sustained plans/s —
per-call host dispatch overlaps device execution instead of adding to
it.

Self-contained (synthetic 7-DoF arm, no assets):
    python examples/throughput_serving.py --batches 8 --batch 16
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=16, help="problems per request batch")
    p.add_argument("--batches", type=int, default=8, help="request batches to stream")
    p.add_argument("--inflight", type=int, default=4)
    p.add_argument("--iterations", type=int, default=10)
    p.add_argument("--goals", type=int, default=4)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from grasptrajopt_tpu.parallel import PlanStream
    from grasptrajopt_tpu.planning.gto_planner import GTOPlanner
    from grasptrajopt_tpu.testing import (
        SYNTH_DEFAULT_POSE,
        SYNTH_LINK_EE,
        SYNTH_LINK_GRIPPER,
        make_synthetic_goal,
        make_synthetic_gto_robot,
        make_synthetic_scene_field,
    )

    robot = make_synthetic_gto_robot(points_per_link=32)
    planner = GTOPlanner(
        robot, SYNTH_LINK_EE, SYNTH_LINK_GRIPPER, iterations=args.iterations
    )
    solvers = planner.setup_optimization(
        goal_size=args.goals, use_standoff=True, axis_standoff="z"
    )

    field = make_synthetic_scene_field(robot)
    qc = SYNTH_DEFAULT_POSE.astype(np.float32)

    def make_request(seed: int):
        rng = np.random.default_rng(seed)
        tf_goal = np.stack(
            [
                np.stack(
                    [make_synthetic_goal(seed * args.goals + g) for g in range(args.goals)]
                )
                for _ in range(args.batch)
            ]
        ).astype(np.float32)
        tf_goal[..., :3, 3] += rng.normal(scale=0.02, size=tf_goal[..., :3, 3].shape)
        qc_opt = np.tile(qc[:7], (args.batch, 1))
        X0 = np.tile(qc_opt[:, None, :], (1, planner.T - 2, 1))
        params = {
            "q_param": np.tile(qc[7:], (args.batch, 1)),
            "tf_goal": tf_goal,
            "goal_mask": np.ones((args.batch, args.goals), bool),
            "base_position": np.zeros((args.batch, 3), np.float32),
            "sdf_cost_all": np.tile(field, (args.batch, 1)),
            "sdf_cost_obstacle": np.tile(field, (args.batch, 1)),
        }
        return (
            jnp.asarray(qc_opt),
            jnp.asarray(X0),
            jax.tree.map(jnp.asarray, params),
        )

    requests = [make_request(s) for s in range(args.batches)]

    # warm up / compile
    out = solvers.solve_batch(*requests[0])
    jax.block_until_ready(out)

    # synchronous baseline
    t0 = time.time()
    for r in requests:
        jax.block_until_ready(solvers.solve_batch(*r))
    t_sync = time.time() - t0

    # pipelined stream
    stream = PlanStream(solvers.solve_batch, inflight=args.inflight)
    done = 0
    t0 = time.time()
    for r in requests:
        done += len(stream.submit(*r))
    for _ in stream.drain():
        done += 1
    t_stream = time.time() - t0
    assert done == args.batches

    n = args.batches * args.batch
    print(
        f"synchronous: {n / t_sync:7.1f} plans/s   "
        f"pipelined (inflight={args.inflight}): {n / t_stream:7.1f} plans/s   "
        f"({t_sync / t_stream:.2f}x)"
    )


if __name__ == "__main__":
    main()
