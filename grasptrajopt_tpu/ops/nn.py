"""Brute-force nearest-neighbor squared distances.

The SDF field build asks: for each of M grid points, the distance to the
nearest of N scene points (M ~ 1e5, N ~ 1e4). The reference does this
with a host-side sklearn KD-tree (mesh_to_sdf/depth_point_cloud.py:25,
:57-91) at hundreds of ms per field. Here it is a brute-force reduction
on the device, in the exact broadcast-subtract form
(qx - px)^2 + (qy - py)^2 + (qz - pz)^2. The matmul form
|q|^2 + |p|^2 - 2 q.p cancels catastrophically near the surface (up to
9 cm of field error at reduced matmul precision, PERF.md), and with K = 3
it gains nothing from a matrix unit anyway.

Paths:
  - `min_sqdist` / `min_d2_plain`: plain XLA — `lax.map` over query
    chunks, each chunk one fused (chunk, N) broadcast-subtract + min
    (/argmin) reduction.
  - `min_d2_pallas`: Pallas kernel through Triton for the field build
    (min only). Blocks run over query tiles; each block loops over
    reference tiles and keeps a running elementwise minimum in registers,
    so no distance block is ever written to device memory.
  - `min_sqdist_d2` picks between them with `lax.platform_dependent`: the
    kernel when compiling for CUDA, the plain path for every other
    platform (so a CPU-compiled program inside a GPU process stays plain).
  - `signed_distance_with_dir`: points-mode signed distance — plain
    min + argmin, then a gather of the nearest point and normal.

Invalid reference points are excluded from every reduction.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton


def min_sqdist_reference(query, ref, ref_mask=None):
    """Dense O(M*N) reference implementation (tests / tiny inputs)."""
    query = jnp.asarray(query)
    ref = jnp.asarray(ref)
    d2 = jnp.sum((query[:, None, :] - ref[None, :, :]) ** 2, axis=-1)
    if ref_mask is not None:
        d2 = jnp.where(ref_mask[None, :], d2, jnp.inf)
    return jnp.min(d2, axis=1), jnp.argmin(d2, axis=1)


def _bcast_d2(qc, ref):
    """(chunk, N) squared distances, exact broadcast-subtract form."""
    d2 = (qc[:, None, 0] - ref[None, :, 0]) ** 2
    d2 = d2 + (qc[:, None, 1] - ref[None, :, 1]) ** 2
    return d2 + (qc[:, None, 2] - ref[None, :, 2]) ** 2


def _chunked(fn, query, chunk):
    """Apply fn to (chunk, 3) query tiles under lax.map; returns the
    concatenated per-query outputs trimmed back to M."""
    M = query.shape[0]
    n_chunks = -(-M // chunk)
    qpad = jnp.pad(query, ((0, n_chunks * chunk - M), (0, 0)))
    outs = jax.lax.map(fn, qpad.reshape(n_chunks, chunk, 3))
    return jax.tree.map(lambda o: o.reshape((-1,) + o.shape[2:])[:M], outs)


def _min_reduce(query, ref, ref_mask, chunk: int, with_index: bool):
    """Chunked exact min (and optionally argmin) reduction, any dtype."""
    query = jnp.asarray(query)
    ref = jnp.asarray(ref, query.dtype)

    def one_chunk(qc):
        d2 = _bcast_d2(qc, ref)
        if ref_mask is not None:
            d2 = jnp.where(ref_mask[None, :], d2, jnp.inf)
        if not with_index:
            return jnp.min(d2, axis=1)
        return jnp.min(d2, axis=1), jnp.argmin(d2, axis=1).astype(jnp.int32)

    return _chunked(one_chunk, query, chunk)


@functools.partial(jax.jit, static_argnames=("chunk",))
def min_sqdist(query, ref, ref_mask=None, chunk: int = 1024):
    """Min squared distance + argmin from each query to the ref set.

    query: (M, 3); ref: (N, 3); ref_mask: optional (N,) bool — False entries
    are excluded. Returns (d2 (M,), idx (M,)) in query dtype / int32.

    Streams over M in `chunk`-sized tiles; XLA fuses each tile's
    (chunk, N) distance block into its min/argmin reduction, so peak
    memory stays O(chunk * N) even where it does not. Ties resolve to the
    lowest reference index.
    """
    return _min_reduce(query, ref, ref_mask, chunk, with_index=True)


@functools.partial(jax.jit, static_argnames=("chunk",))
def min_d2_plain(query, ref, ref_mask=None, chunk: int = 1024):
    """Min squared distance only, plain chunked XLA (any dtype): the
    reference the Triton kernel is compared and timed against, and the
    path every non-CUDA platform compiles."""
    return _min_reduce(query, ref, ref_mask, chunk, with_index=False)


def _min_d2_kernel(q_ref, r_ref, o_ref, *, tm: int, tn: int):
    """One block: `tm` queries against every reference tile.

    q_ref (3, Mp): query x/y/z rows. r_ref (4, Np): reference x/y/z rows
    plus a penalty row (0 valid, +inf invalid or padding), folded in as the
    first addend so masking costs no extra operation per pair. The running
    (tm, tn) minimum stays in registers across the reference loop and is
    reduced over its columns once at the end."""
    rows = pl.ds(pl.program_id(0) * tm, tm)
    qx = pl_triton.load(q_ref.at[0, rows])[:, None]
    qy = pl_triton.load(q_ref.at[1, rows])[:, None]
    qz = pl_triton.load(q_ref.at[2, rows])[:, None]

    def body(j, acc):
        cols = pl.ds(j * tn, tn)
        dx = qx - pl_triton.load(r_ref.at[0, cols])[None, :]
        dy = qy - pl_triton.load(r_ref.at[1, cols])[None, :]
        dz = qz - pl_triton.load(r_ref.at[2, cols])[None, :]
        d2 = pl_triton.load(r_ref.at[3, cols])[None, :] + dx * dx
        d2 = d2 + dy * dy
        d2 = d2 + dz * dz
        return jnp.minimum(acc, d2)

    acc = jax.lax.fori_loop(
        0, r_ref.shape[1] // tn, body, jnp.full((tm, tn), jnp.inf, jnp.float32)
    )
    pl_triton.store(o_ref.at[rows], jnp.min(acc, axis=1))


@functools.partial(jax.jit, static_argnames=("tm", "tn", "num_warps", "interpret"))
def min_d2_pallas(
    query, ref, ref_mask=None, tm: int = 64, tn: int = 64, num_warps: int = 4,
    interpret: bool = False,
):
    """Min squared distance from (M, 3) queries to an (N, 3) reference set,
    Pallas through Triton, float32. Pads M and N up to the (power-of-two)
    tiles; padded and masked reference points carry an +inf penalty.
    Under vmap over reference sets each set becomes its own grid axis."""
    query = jnp.asarray(query, jnp.float32)
    ref = jnp.asarray(ref, jnp.float32)
    M, N = query.shape[0], ref.shape[0]
    Mp = -(-M // tm) * tm
    Np = -(-N // tn) * tn
    qT = jnp.pad(query.T, ((0, 0), (0, Mp - M)))
    valid = jnp.ones((N,), bool) if ref_mask is None else ref_mask
    pen = jnp.pad(jnp.where(valid, 0.0, jnp.inf), (0, Np - N), constant_values=jnp.inf)
    rT = jnp.concatenate([jnp.pad(ref.T, ((0, 0), (0, Np - N))), pen[None]], axis=0)
    out = pl.pallas_call(
        functools.partial(_min_d2_kernel, tm=tm, tn=tn),
        grid=(Mp // tm,),
        out_shape=jax.ShapeDtypeStruct((Mp,), jnp.float32),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps),
        interpret=interpret,
        name="min_d2",
    )(qT, rT)
    return out[:M]


def min_sqdist_d2(query, ref, ref_mask=None):
    """Min squared distance only (no argmin) from (M, 3) queries to an
    (N, 3) reference set — the dense SDF field-build primitive. Compiled
    for CUDA it is the Triton kernel (float32, cast back to the query
    dtype); on every other platform the plain chunked XLA path."""
    query = jnp.asarray(query)
    ref = jnp.asarray(ref)
    mask = jnp.ones(ref.shape[:1], bool) if ref_mask is None else jnp.asarray(ref_mask)

    def kernel(q, r, m):
        return min_d2_pallas(q, r, m).astype(q.dtype)

    return jax.lax.platform_dependent(query, ref, mask, cuda=kernel, default=min_d2_plain)


def _nearest_impl(points, ref, normals, chunk: int = 1024):
    """(d2, nearest point, nearest normal) for (..., 3) query points against
    a padded (K, 3) set (pad rows far away, e.g. 1e6, so they never win):
    chunked min + argmin, then a gather from the small (K, 3) tables."""
    points = jnp.asarray(points)
    ref = jnp.asarray(ref, points.dtype)
    lead = points.shape[:-1]
    d2, idx = min_sqdist(points.reshape(-1, 3), ref, chunk=chunk)
    return (
        d2.reshape(lead),
        ref[idx].reshape(lead + (3,)),
        jnp.asarray(normals, points.dtype)[idx].reshape(lead + (3,)),
    )


@jax.custom_jvp
def signed_distance_to_set(points, ref, normals):
    """Signed distance to a padded point set with per-point normals.

    sign = sign((p - s*) . n*) over the nearest point s* — the reference's
    'normal' sign determination with k=1
    (mesh_to_sdf/surface_point_cloud.py:32-64) — GUARDED by a lateral
    footprint test (see signed_distance_with_dir). The forward derivative
    is the exact piecewise gradient sign * (p - s*) / |p - s*| via
    custom_jvp.
    """
    sd, _ = signed_distance_with_dir(points, ref, normals)
    return sd


def signed_distance_with_dir(points, ref, normals, lateral_margin=0.05):
    """(sd, d(sd)/dp) in one evaluation — the chain-rule building block for
    whole-trajectory obstacle terms: one nearest-point pass yields both the
    signed distances and their exact spatial gradients, which callers
    contract with their own point Jacobians instead of differentiating
    through the reduction.

    Sign: negative (inside) ONLY when the query sits behind its nearest
    sample's normal AND within `lateral_margin` of that sample's surface
    footprint. A bare normal-dot sign classifies everything behind the
    tangent PLANE as inside — e.g. the whole robot base below a tabletop's
    top-sheet sampling, nowhere near the table, which injects a large
    constant cost into the obstacle term (round-2 points-mode quality
    collapse: reached 0.19 with min sd -0.38 on truly collision-free
    trajectories). A query directly under a sampled sheet has lateral
    offset <= the sampling spacing, so margin ~= 2x the downsample
    resolution keeps genuine penetrations negative.
    """
    d2, nearest, n_star = _nearest_impl(points, ref, normals)
    diff = points - nearest
    d_n = jnp.sum(diff * n_star, axis=-1)
    lat2 = jnp.maximum(d2 - d_n * d_n, 0.0)
    inside = jnp.logical_and(d_n < 0.0, lat2 <= lateral_margin * lateral_margin)
    sign = jnp.where(inside, -1.0, 1.0)
    d = jnp.sqrt(jnp.maximum(d2, 1e-18))
    sd = sign * d
    return sd, diff / sd[..., None]


@signed_distance_to_set.defjvp
def _signed_distance_jvp(primals, tangents):
    points, ref, normals = primals
    pdot = tangents[0]
    sd, dirs = signed_distance_with_dir(points, ref, normals)
    return sd, jnp.sum(dirs * pdot, axis=-1)
