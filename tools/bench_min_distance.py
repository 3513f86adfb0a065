"""Time the min-distance paths on the GPU at the benchmark's shapes.

  - field-build op: 16 clouds x (12,288 obstacle + 2,048 target) points vs
    the 95,760-cell workspace grid — the Triton kernel (`min_d2_pallas`,
    a few tile shapes) against the plain chunked XLA reduction
    (`min_d2_plain`, a few chunk sizes);
  - the whole fields phase: `build_two_cost_fields` vmapped over 16
    rendered 160x160 objects, kernel vs plain;
  - points-mode nearest path: 32 x 50 x 1,000 queries vs a 2,048-point
    scene (`signed_distance_with_dir`, and its min/argmin/gather core at a
    few chunk sizes).

Usage (on a machine with a GPU, from the repository root):
    python tools/bench_min_distance.py [--reps N] [--out FILE]
Prints one JSON object (times in ms: best and median of --reps calls after
a compiling warm-up) preceded by the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CLOUDS, N_OBS, N_TGT = 16, 12288, 2048  # field-build shape
OBJECTS, RES = 16, 160  # fields phase
PROBLEMS, QUERIES, K_SCENE = 32, 50 * 1000, 2048  # points-mode shape


def timed(fn, *args, reps: int):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, {"best_ms": 1e3 * min(ts), "median_ms": 1e3 * float(np.median(ts)),
                 "first_call_s": first}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import chip_smoke
    from grasptrajopt_tpu.fields import depth_point_cloud
    from grasptrajopt_tpu.ops import nn
    from grasptrajopt_tpu.testing import make_synthetic_gto_robot
    from grasptrajopt_tpu.utils.device import enable_compile_cache, require_gpu

    require_gpu()
    enable_compile_cache()
    for line in chip_smoke.card_info():
        print(f"card: {line}", flush=True)
    result = {"device_kind": jax.devices()[0].device_kind, "card": chip_smoke.card_info()}
    reps = args.reps
    grid = np.asarray(make_synthetic_gto_robot().grid.grid_points(), np.float32)
    rng = np.random.default_rng(0)
    obs, obs_mask, tgt, tgt_mask = chip_smoke._field_clouds(rng, CLOUDS, N_OBS, N_TGT)
    q = jnp.asarray(grid)
    data = [jnp.asarray(a) for a in (obs, obs_mask, tgt, tgt_mask)]

    def both(op):
        fn = jax.vmap(op, in_axes=(None, 0, 0))
        return jax.jit(lambda q, o, om, t, tm: (fn(q, o, om), fn(q, t, tm)))

    ref, t = timed(both(lambda q, r, m: nn.min_d2_plain(q, r, m)), q, *data, reps=reps)
    op = {"plain_chunk1024": t}
    for chunk in (256, 4096):
        _, op[f"plain_chunk{chunk}"] = timed(
            both(lambda q, r, m, c=chunk: nn.min_d2_plain(q, r, m, chunk=c)), q, *data, reps=reps)
    for tm, tn, nw in ((64, 64, 4), (128, 64, 4), (64, 128, 4), (32, 128, 4),
                       (128, 128, 8), (256, 64, 8)):
        out, t = timed(both(lambda q, r, m, tm=tm, tn=tn, nw=nw: nn.min_d2_pallas(
            q, r, m, tm=tm, tn=tn, num_warps=nw)), q, *data, reps=reps)
        t["max_abs_d2_vs_plain"] = max(chip_smoke.max_abs(a, b) for a, b in zip(out, ref))
        op[f"kernel_tm{tm}_tn{tn}_w{nw}"] = t
    pairs = CLOUDS * grid.shape[0] * (N_OBS + N_TGT)
    result["field_op"] = {"pairs": pairs, "times": op}
    print(json.dumps({"field_op": result["field_op"]}), flush=True)

    depth_b, mask_b, pose_b, K, _ = chip_smoke.render_objects(OBJECTS, RES)

    def fields_phase():
        def one(depth, mask, pose):
            f_all, f_obs, _, _ = depth_point_cloud.build_two_cost_fields(
                depth, K, pose, mask, grid, threshold=1.5, epsilon=0.02,
                dedup_voxel=0.01, capacity_obstacle=12288, capacity_target=2048)
            return f_all, f_obs

        return jax.jit(jax.vmap(one))

    f_kernel, t_kernel = timed(fields_phase(), depth_b, mask_b, pose_b, reps=reps)
    depth_point_cloud.min_sqdist_d2 = nn.min_d2_plain  # plain path, same program
    try:
        f_plain, t_plain = timed(fields_phase(), depth_b, mask_b, pose_b, reps=reps)
    finally:
        depth_point_cloud.min_sqdist_d2 = nn.min_sqdist_d2
    result["fields_phase"] = {
        "objects": OBJECTS, "res": RES, "kernel": t_kernel, "plain": t_plain,
        "max_abs_field_diff": max(chip_smoke.max_abs(a, b) for a, b in zip(f_kernel, f_plain)),
    }
    print(json.dumps({"fields_phase": result["fields_phase"]}), flush=True)

    scene, normals = chip_smoke._scene_with_normals(rng, K_SCENE)
    pts = jnp.asarray(rng.uniform([0.1, -0.6, 0.2], [1.0, 0.6, 0.8],
                                  size=(PROBLEMS, QUERIES, 3)).astype(np.float32))
    scene, normals = jnp.asarray(scene), jnp.asarray(normals)
    pm = {}
    _, pm["signed_distance_with_dir"] = timed(
        jax.jit(jax.vmap(nn.signed_distance_with_dir, in_axes=(0, None, None))),
        pts, scene, normals, reps=reps)
    for chunk in (256, 1024, 4096):
        _, pm[f"nearest_chunk{chunk}"] = timed(
            jax.jit(jax.vmap(lambda p, r, n, c=chunk: nn._nearest_impl(p, r, n, chunk=c),
                             in_axes=(0, None, None))), pts, scene, normals, reps=reps)
    result["points_mode"] = {"pairs": PROBLEMS * QUERIES * K_SCENE, "times": pm}
    print(json.dumps({"points_mode": result["points_mode"]}), flush=True)

    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
