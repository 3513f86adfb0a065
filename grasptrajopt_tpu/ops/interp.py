"""Voxel-field lookups: floor-indexed (reference parity) and trilinear
(differentiable upgrade).

The reference converts robot surface points to flat voxel offsets with
floor + per-axis clamp + row-major flattening (gto/gto_models.py:174-201)
and indexes the cost field with them. CasADi's floor has zero derivative,
so the reference's obstacle cost carries no gradient through position
(cf. the abandoned differentiable route at gto/sdf_callback.py). Here the
default is trilinear interpolation over the 8 surrounding grid corners,
which is exact at corners, piecewise-linear in between, and carries
useful gradients for the Gauss-Newton solver.

Fields are flat (S,) arrays over a grid defined by (origin, shape,
resolution); grid corner (i,j,k) sits at origin + (i,j,k)*resolution,
matching setup_workspace_field / setup_points_field
(gto/gto_models.py:135-171).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import custom_batching


@custom_batching.custom_vmap
def packed_rows_gather(packed, offs):
    """Row gather `packed[offs]` with a batching rule for per-problem tables.

    Under vmap with PER-PROBLEM tables the rule lowers to `lax.map` — B
    sequential gathers, each against one small table, instead of one
    batched gather over the whole (B, 2S, 8) working set (~150 MB). This
    was tuned on the accelerator the planner was first written for and is
    not yet measured on the GPU (ROADMAP S6). With a SHARED (unbatched)
    table the plain flat gather is kept.

    NOTE: no autodiff support is needed — the gathered rows are constants
    w.r.t. positions (derivatives flow through the interpolation weights),
    and callers use the closed-form gradient (`packed_lookup_soa_grad`).
    """
    return packed[offs]


@packed_rows_gather.def_vmap
def _packed_rows_gather_vmap(axis_size, in_batched, packed, offs):
    packed_b, offs_b = in_batched
    if not packed_b:
        # shared table: one flat gather over the batched offsets
        return packed[offs], offs_b
    if not offs_b:
        offs = jnp.broadcast_to(offs, (axis_size,) + offs.shape)
    rows = jax.lax.map(lambda po: po[0][po[1]], (packed, offs))
    return rows, True


def points_to_offsets(points, origin, shape: Tuple[int, int, int], resolution):
    """Flat row-major voxel offsets of (..., 3) points (floor + clamp).

    Parity: gto/gto_models.py:174-201.
    """
    points = jnp.asarray(points)
    origin = jnp.asarray(origin, dtype=points.dtype).reshape(3)
    u = (points - origin) / resolution
    idx = jnp.floor(u).astype(jnp.int32)
    hi = jnp.asarray([shape[0] - 1, shape[1] - 1, shape[2] - 1], dtype=jnp.int32)
    idx = jnp.clip(idx, 0, hi)
    return idx[..., 2] + shape[2] * (idx[..., 1] + shape[1] * idx[..., 0])


def field_lookup_nearest(field_flat, points, origin, shape, resolution):
    """Field value at the floor-indexed cell of each point (reference parity;
    zero gradient w.r.t. point position)."""
    offsets = points_to_offsets(points, origin, shape, resolution)
    return jnp.asarray(field_flat)[offsets]


def field_lookup_trilinear(field_flat, points, origin, shape, resolution):
    """Differentiable trilinear interpolation of a flat voxel field.

    points: (..., 3) -> values (...,). Outside the grid the lookup clamps to
    the boundary cell (gradient saturates to zero there, like the clamp in
    the reference's offset map).
    """
    field_flat = jnp.asarray(field_flat)
    points = jnp.asarray(points)
    origin = jnp.asarray(origin, dtype=points.dtype).reshape(3)
    u = (points - origin) / resolution
    # Base corner, clamped so that base+1 stays in range.
    hi = jnp.asarray(
        [shape[0] - 2, shape[1] - 2, shape[2] - 2], dtype=jnp.int32
    )
    base = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, hi)
    frac = jnp.clip(u - base.astype(points.dtype), 0.0, 1.0)

    sx, sy, sz = shape

    def flat(ix, iy, iz):
        return iz + sz * (iy + sy * ix)

    ix, iy, iz = base[..., 0], base[..., 1], base[..., 2]
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]

    c000 = field_flat[flat(ix, iy, iz)]
    c001 = field_flat[flat(ix, iy, iz + 1)]
    c010 = field_flat[flat(ix, iy + 1, iz)]
    c011 = field_flat[flat(ix, iy + 1, iz + 1)]
    c100 = field_flat[flat(ix + 1, iy, iz)]
    c101 = field_flat[flat(ix + 1, iy, iz + 1)]
    c110 = field_flat[flat(ix + 1, iy + 1, iz)]
    c111 = field_flat[flat(ix + 1, iy + 1, iz + 1)]

    c00 = c000 * (1 - fz) + c001 * fz
    c01 = c010 * (1 - fz) + c011 * fz
    c10 = c100 * (1 - fz) + c101 * fz
    c11 = c110 * (1 - fz) + c111 * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def pack_corners(field_flat, shape: Tuple[int, int, int]):
    """Precompute the 8 trilinear corner values per cell: (S, 8).

    One packed gather row replaces 8 scattered gathers in
    `field_lookup_trilinear` — the dominant cost of the obstacle term
    (scattered 1-float gathers are slow; one contiguous 8-float row per
    point vectorizes). Cells in the last slab along any axis replicate the
    boundary (matching the clamped base index of the unpacked lookup).
    """
    f = jnp.asarray(field_flat).reshape(shape)
    sx, sy, sz = shape

    def shifted(dx, dy, dz):
        return f[
            jnp.minimum(jnp.arange(sx) + dx, sx - 1)[:, None, None],
            jnp.minimum(jnp.arange(sy) + dy, sy - 1)[None, :, None],
            jnp.minimum(jnp.arange(sz) + dz, sz - 1)[None, None, :],
        ]

    corners = jnp.stack(
        [
            shifted(0, 0, 0), shifted(0, 0, 1), shifted(0, 1, 0), shifted(0, 1, 1),
            shifted(1, 0, 0), shifted(1, 0, 1), shifted(1, 1, 0), shifted(1, 1, 1),
        ],
        axis=-1,
    )
    return corners.reshape(-1, 8)


def field_lookup_trilinear_packed(packed, points, origin, shape, resolution, row_offset=0):
    """Trilinear lookup against a `pack_corners` table: one row gather plus
    a weight dot per point. Numerically identical to
    `field_lookup_trilinear`.

    `row_offset` (traced int ok) shifts the gathered row — stacking several
    packed fields into one (k*S, 8) table lets a per-step field *selection*
    ride the same single gather (row_offset = phase * S) instead of
    gathering every field and masking.
    """
    packed = jnp.asarray(packed)
    points = jnp.asarray(points)
    origin = jnp.asarray(origin, dtype=points.dtype).reshape(3)
    u = (points - origin) / resolution
    hi = jnp.asarray([shape[0] - 2, shape[1] - 2, shape[2] - 2], dtype=jnp.int32)
    base = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, hi)
    frac = jnp.clip(u - base.astype(points.dtype), 0.0, 1.0)

    offs = base[..., 2] + shape[2] * (base[..., 1] + shape[1] * base[..., 0]) + row_offset
    rows = packed[offs]  # (..., 8)

    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    wx = jnp.stack([1 - fx, fx], axis=-1)  # (..., 2)
    wy = jnp.stack([1 - fy, fy], axis=-1)
    wz = jnp.stack([1 - fz, fz], axis=-1)
    w = (
        wx[..., :, None, None] * wy[..., None, :, None] * wz[..., None, None, :]
    ).reshape(frac.shape[:-1] + (8,))
    return jnp.sum(rows * w, axis=-1)


def field_lookup_trilinear_packed_soa(
    packed, x, y, z, origin, shape, resolution, row_offset=0
):
    """SoA variant of the packed trilinear lookup: coordinates arrive as
    three (..., P) arrays (from component-form FK), so no (..., P, 3)
    intermediate with a padded trailing dim is ever built. Numerically
    identical to the AoS version."""
    packed = jnp.asarray(packed)
    origin = jnp.asarray(origin).reshape(3)
    ox, oy, oz = origin[0], origin[1], origin[2]
    inv = 1.0 / resolution
    ux = (x - ox) * inv
    uy = (y - oy) * inv
    uz = (z - oz) * inv
    bx = jnp.clip(jnp.floor(ux).astype(jnp.int32), 0, shape[0] - 2)
    by = jnp.clip(jnp.floor(uy).astype(jnp.int32), 0, shape[1] - 2)
    bz = jnp.clip(jnp.floor(uz).astype(jnp.int32), 0, shape[2] - 2)
    fx = jnp.clip(ux - bx, 0.0, 1.0)
    fy = jnp.clip(uy - by, 0.0, 1.0)
    fz = jnp.clip(uz - bz, 0.0, 1.0)

    offs = bz + shape[2] * (by + shape[1] * bx) + row_offset
    rows = packed[offs]  # (..., P, 8)
    if rows.dtype != x.dtype:
        rows = rows.astype(x.dtype)  # bf16 tables upcast after the gather
    w = jnp.stack(
        [
            (1 - fx) * (1 - fy) * (1 - fz), (1 - fx) * (1 - fy) * fz,
            (1 - fx) * fy * (1 - fz), (1 - fx) * fy * fz,
            fx * (1 - fy) * (1 - fz), fx * (1 - fy) * fz,
            fx * fy * (1 - fz), fx * fy * fz,
        ],
        axis=-1,
    )
    return jnp.sum(rows * w, axis=-1)


def field_lookup_packed_soa_grad(
    packed, x, y, z, origin, shape, resolution, row_offset=0
):
    """Packed trilinear lookup returning (value, d/dx, d/dy, d/dz) in
    CLOSED FORM from one row gather per query.

    The spatial gradient is the interpolation-weight derivative contracted
    with the same gathered corner rows — no autodiff pass and no second
    gather. Matches jacfwd of `field_lookup_trilinear_packed_soa`: outside
    the grid the clamped frac saturates and the gradient is zero (the
    jnp.clip derivative), at the clamp the floor() indexing contributes
    nothing (reference parity: the CasADi floor's zero derivative,
    gto/sdf_callback.py — here only the CONTINUOUS part carries gradient,
    which is the exact piecewise-trilinear derivative).

    The gather routes through `packed_rows_gather`, whose vmap rule keeps
    per-problem tables on the fast sequential-small-gather path.
    """
    packed = jnp.asarray(packed)
    origin = jnp.asarray(origin).reshape(3)
    ox, oy, oz = origin[0], origin[1], origin[2]
    inv = jnp.asarray(1.0 / resolution, x.dtype)
    ux = (x - ox) * inv
    uy = (y - oy) * inv
    uz = (z - oz) * inv
    bx = jnp.clip(jnp.floor(ux).astype(jnp.int32), 0, shape[0] - 2)
    by = jnp.clip(jnp.floor(uy).astype(jnp.int32), 0, shape[1] - 2)
    bz = jnp.clip(jnp.floor(uz).astype(jnp.int32), 0, shape[2] - 2)
    rx = ux - bx
    ry = uy - by
    rz = uz - bz
    fx = jnp.clip(rx, 0.0, 1.0)
    fy = jnp.clip(ry, 0.0, 1.0)
    fz = jnp.clip(rz, 0.0, 1.0)
    # clip derivative: 1 on [0, 1], 0 outside (matches jacfwd through clip)
    mx = ((rx >= 0.0) & (rx <= 1.0)).astype(x.dtype) * inv
    my = ((ry >= 0.0) & (ry <= 1.0)).astype(x.dtype) * inv
    mz = ((rz >= 0.0) & (rz <= 1.0)).astype(x.dtype) * inv

    offs = bz + shape[2] * (by + shape[1] * bx) + row_offset
    rows = packed_rows_gather(packed, offs)  # (..., 8)
    if rows.dtype != x.dtype:
        rows = rows.astype(x.dtype)
    # Unpack-and-combine form. A contraction form (rows · (..., 4, 8)
    # weight tensor, 8 kept as a contracted dim to dodge the gathered-row
    # transpose copy) was slower on the first accelerator: building the
    # weight cube cost more than the copy it avoids (PERF.md, carried
    # findings; not re-measured on the GPU).
    c000, c001, c010, c011, c100, c101, c110, c111 = [
        rows[..., i] for i in range(8)
    ]
    # interpolate z first, then y, then x; keep the partial reductions so
    # each axis derivative reuses them
    c00 = c000 * (1 - fz) + c001 * fz
    c01 = c010 * (1 - fz) + c011 * fz
    c10 = c100 * (1 - fz) + c101 * fz
    c11 = c110 * (1 - fz) + c111 * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    val = c0 * (1 - fx) + c1 * fx
    gx = (c1 - c0) * mx
    gy = ((c01 - c00) * (1 - fx) + (c11 - c10) * fx) * my
    dz0 = (c001 - c000) * (1 - fy) + (c011 - c010) * fy
    dz1 = (c101 - c100) * (1 - fy) + (c111 - c110) * fy
    gz = (dz0 * (1 - fx) + dz1 * fx) * mz
    return val, gx, gy, gz


def points_to_offsets_2d(points_xy, origin, shape: Tuple[int, int], resolution):
    """2-D occupancy-grid offsets. Parity: gto/gto_models.py:247-272."""
    points_xy = jnp.asarray(points_xy)
    origin = jnp.asarray(origin, dtype=points_xy.dtype).reshape(2)
    u = (points_xy - origin) / resolution
    idx = jnp.floor(u).astype(jnp.int32)
    hi = jnp.asarray([shape[0] - 1, shape[1] - 1], dtype=jnp.int32)
    idx = jnp.clip(idx, 0, hi)
    return idx[..., 1] + shape[1] * idx[..., 0]
