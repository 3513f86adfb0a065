"""On-device compute kernels: structured linear algebra, nearest-neighbor
distance fields, differentiable grid interpolation.

These replace the reference's host-side sklearn KD-tree queries
(/root/reference/mesh_to_sdf/depth_point_cloud.py:25,57) and CasADi
floor-indexed field lookups (gto/gto_models.py:174-201) with batched
device primitives.
"""

from grasptrajopt_tpu.ops.nn import (
    min_d2_pallas,
    min_sqdist,
    min_sqdist_d2,
    min_sqdist_reference,
)
from grasptrajopt_tpu.ops.interp import (
    field_lookup_nearest,
    field_lookup_trilinear,
    points_to_offsets,
)
from grasptrajopt_tpu.ops.block_tridiag import block_tridiag_solve
from grasptrajopt_tpu.ops.dedup import voxel_dedup

__all__ = [
    "min_d2_pallas",
    "min_sqdist",
    "min_sqdist_d2",
    "min_sqdist_reference",
    "field_lookup_nearest",
    "field_lookup_trilinear",
    "points_to_offsets",
    "block_tridiag_solve",
    "voxel_dedup",
]
