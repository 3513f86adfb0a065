"""grasptrajopt_tpu — a batched, accelerator-first grasp trajectory-optimization
framework (JAX/XLA/Pallas; runs on an NVIDIA GPU, tests on the CPU).

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
IRVLUTD/GraspTrajOpt (arXiv 2403.05466): planning collision-free joint-space
trajectories that end in a grasp, with robots represented as link-surface
point clouds and scenes as signed-distance cost fields on voxel grids.

Architecture (accelerator-first, not a port):
  - problems are *data* (pytrees of parameters), not symbolic graphs: one
    jit-compiled solver program serves every problem instance
  - trajectories are arrays with a time axis; dynamics equality constraints
    are eliminated structurally (q[:, 0:2] pinned, velocities by finite
    difference), so the only remaining constraints are box limits handled by
    projection
  - the Gauss-Newton KKT system is block-tridiagonal in time and solved with
    a batched block Thomas factorization under `vmap`
  - scene SDF cost fields are built on-device with a brute-force
    min-distance reduction (a Pallas/Triton kernel on the GPU) replacing
    the reference's sklearn KD-tree,
    and queried with *differentiable* trilinear interpolation (improving on
    the reference's zero-gradient floor-indexed lookup,
    cf. /root/reference/gto/sdf_callback.py)
  - batches of (scene x grasp-set x seed) problems scale over a
    `jax.sharding.Mesh` via shard_map; XLA hands the collectives to NCCL.

Subpackages:
  spatial    SO(3)/SE(3)/quaternion ops               (ref: optas/spatialmath.py)
  models     URDF parsing, kinematic pytrees, FK      (ref: optas/models.py)
  ops        Pallas kernels + structured linear algebra
  fields     depth point clouds, SDF/occupancy fields (ref: mesh_to_sdf/)
  opt        problem spec + batched GN/LM, AL-SQP, QP (ref: optas/{builder,optimization,solver}.py)
  planning   IK, trajectory, base-pose planners       (ref: gto/)
  parallel   meshes, sharding, multi-host runtime
  envs       PyBullet SceneReplica harness (import-gated)
  viz        host-side visualization
  utils      configs, profiling, interpolation
"""

__version__ = "0.1.0"

from grasptrajopt_tpu import spatial  # noqa: F401
