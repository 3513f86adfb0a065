"""Depth-camera scene point cloud with on-device SDF cost queries.

Behavioral parity with /root/reference/mesh_to_sdf/depth_point_cloud.py:
  - backprojection with (0 < depth < threshold) and optional target-mask
    filtering (:33-53)
  - signed distance = nearest-point distance, negative when the query is NOT
    camera-visible-outside (:57-62, is_outside :127-142)
  - the planner's obstacle shaping (:65-91):
        cost = w_inside * (-d + eps/2)            d <= 0 (inside)
               (d - eps)^2 / (2 eps)              0 < d < eps
               0                                  d >= eps

Device redesign: the point set keeps the *static* (H*W) shape with a
validity mask instead of host-side compaction, so every query is
jit-compatible; the nearest-distance reduction is the brute-force
`ops.min_sqdist_d2` instead of a KD-tree. Building a full ~1e5-cell cost
field is one fused device program. The camera matmuls pin HIGHEST
precision: a reduced-precision (TF32) product moves backprojected points
by millimetres at workspace scale.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from grasptrajopt_tpu.ops import min_sqdist_d2

_HI = jax.lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=())
def backproject_depth(depth, intrinsic_matrix, camera_pose, valid_mask):
    """Depth image (H, W) -> world points (H*W, 3) + validity (H*W,)."""
    depth = jnp.asarray(depth)
    H, W = depth.shape
    K_inv = jnp.linalg.inv(jnp.asarray(intrinsic_matrix, depth.dtype))
    x, y = jnp.meshgrid(jnp.arange(W, dtype=depth.dtype), jnp.arange(H, dtype=depth.dtype))
    ones = jnp.ones_like(x)
    pix = jnp.stack([x, y, ones], axis=-1).reshape(-1, 3)  # (H*W, 3)
    rays = jnp.matmul(pix, K_inv.T, precision=_HI)
    pts_cam = rays * depth.reshape(-1, 1)
    R = jnp.asarray(camera_pose, depth.dtype)[:3, :3]
    t = jnp.asarray(camera_pose, depth.dtype)[:3, 3]
    pts_world = jnp.matmul(pts_cam, R.T, precision=_HI) + t
    return pts_world, valid_mask.reshape(-1)


def camera_outside(depth, intrinsic_matrix, camera_pose, query_points):
    """Camera-visibility sign test (free-function form of
    DepthPointCloud.is_outside; parity: depth_point_cloud.py:127-142):
    True where the query is observed free space — in front of the measured
    surface, or outside the viewport."""
    depth = jnp.asarray(depth)
    H, W = depth.shape
    q = jnp.asarray(query_points, depth.dtype)
    T_wc = jnp.asarray(camera_pose, depth.dtype)
    R = T_wc[:3, :3]
    t = T_wc[:3, 3]
    pc = jnp.matmul(q - t, R, precision=_HI)  # camera frame (R^T from the right)
    proj = jnp.matmul(pc, jnp.asarray(intrinsic_matrix, depth.dtype).T, precision=_HI)
    z = proj[:, 2]
    safe_z = jnp.where(jnp.abs(z) > 1e-12, z, 1e-12)
    u = (proj[:, 0] / safe_z).astype(jnp.int32)
    v = (proj[:, 1] / safe_z).astype(jnp.int32)
    in_viewport = (u >= 0) & (v >= 0) & (u < W) & (v < H)
    uc = jnp.clip(u, 0, W - 1)
    vc = jnp.clip(v, 0, H - 1)
    measured = depth[vc, uc]
    return jnp.where(in_viewport, pc[:, 2] < measured, True)


def sdf_cost_shaping(distances, epsilon: float = 0.02, w_inside: float = 1.0):
    """The reference's eps-band obstacle cost (depth_point_cloud.py:65-91)."""
    inside = distances <= 0.0
    band = jnp.logical_and(distances > 0.0, distances < epsilon)
    cost_inside = w_inside * (-distances + epsilon / 2.0)
    cost_band = jnp.square(distances - epsilon) / (2.0 * epsilon)
    return jnp.where(inside, cost_inside, jnp.where(band, cost_band, 0.0))


def sdf_cost_shaping_deriv(distances, epsilon: float = 0.02, w_inside: float = 1.0):
    """d(sdf_cost_shaping)/d(distance) — for analytic Jacobian chains."""
    inside = distances <= 0.0
    band = jnp.logical_and(distances > 0.0, distances < epsilon)
    d_inside = jnp.full_like(distances, -w_inside)
    d_band = (distances - epsilon) / epsilon
    return jnp.where(inside, d_inside, jnp.where(band, d_band, 0.0))


def signed_distance_to_cloud(query_points, cloud_pts, cloud_mask, depth, K, cam_pose):
    """Signed distance of queries to a (padded) cloud, camera-visibility
    sign from the depth image — the device query primitive behind
    DepthPointCloud.get_sdf, usable with a deduplicated cloud."""
    q = jnp.asarray(query_points)
    d = jnp.sqrt(min_sqdist_d2(q, cloud_pts, ref_mask=cloud_mask))
    outside = camera_outside(depth, K, cam_pose, q)
    return jnp.where(outside, d, -d)


def build_two_cost_fields(
    depth,
    intrinsic_matrix,
    camera_pose,
    target_mask,
    grid_pts,
    threshold: float = 1.5,
    epsilon: float = 0.02,
    dedup_voxel: float = 0.01,
    capacity_obstacle: int = 12288,
    capacity_target: int = 2048,
):
    """Both planner cost fields of one observation as ONE device program
    (jit/vmap-compatible): the scene field and the target-free obstacle
    field (pybullet_gto_planning.py:175-190 builds these as two separate
    KD-tree sweeps on the host).

    Structure (PERF.md, carried findings: fields):
      - the obstacle cloud (valid & ~target) is voxel-deduplicated on
        device (ops.voxel_dedup, default 1 cm — the accuracy the CPU shelf
        path already ships via field_downsample) and min-distanced once;
      - the scene field's distances are min(d_obstacle, d_target) over the
        SMALL target point set — the second full-cloud pass the naive
        build pays disappears;
      - signs keep exact parity: obstacle sign from the target-masked
        depth image, scene sign from the raw depth image.

    Returns (f_all, f_obs, obstacle_pts, obstacle_mask); the deduped
    obstacle cloud is reused by the grasp collision pre-filter via
    signed_distance_to_cloud.
    """
    from grasptrajopt_tpu.ops import voxel_dedup

    depth = jnp.asarray(depth)
    tmask = jnp.asarray(target_mask).reshape(-1)
    valid = jnp.logical_and(depth > 0, depth < threshold).reshape(-1)
    pts, _ = backproject_depth(depth, intrinsic_matrix, camera_pose, valid)
    obs_pts, obs_mask, _ = voxel_dedup(
        pts, valid & ~tmask, dedup_voxel, capacity_obstacle
    )
    # the target set is small (a few hundred pixels); compact WITHOUT
    # dedup (nonzero, no sort — the dedup's argsort over the full pixel
    # count would cost as much as the obstacle dedup for a <3% subset).
    # Overflowing pixels beyond capacity are dropped; the target surface
    # is pixel-dense so neighbors cover them.
    tm = valid & tmask
    t_idx = jnp.nonzero(tm, size=capacity_target, fill_value=0)[0]
    tgt_pts = pts[t_idx]
    tgt_mask = jnp.arange(capacity_target) < jnp.sum(tm)
    q = jnp.asarray(grid_pts)
    d2_obs = min_sqdist_d2(q, obs_pts, ref_mask=obs_mask)
    d2_tgt = min_sqdist_d2(q, tgt_pts, ref_mask=tgt_mask)
    d_obs = jnp.sqrt(d2_obs)
    d_all = jnp.sqrt(jnp.minimum(d2_obs, d2_tgt))
    depth_obs = jnp.where(jnp.asarray(target_mask), threshold, depth)
    out_all = camera_outside(depth, intrinsic_matrix, camera_pose, q)
    out_obs = camera_outside(depth_obs, intrinsic_matrix, camera_pose, q)
    f_all = sdf_cost_shaping(jnp.where(out_all, d_all, -d_all), epsilon)
    f_obs = sdf_cost_shaping(jnp.where(out_obs, d_obs, -d_obs), epsilon)
    return f_all, f_obs, obs_pts, obs_mask


class DepthPointCloud:
    """Scene point cloud from a depth image, with SDF(-cost) queries.

    All query methods are device functions over static shapes; `points`
    exposes the compacted host array for parity with the reference API.
    """

    def __init__(
        self,
        depth,
        intrinsic_matrix,
        camera_pose,
        target_mask=None,
        threshold: float = 1.5,
        dtype=jnp.float32,
    ):
        depth = jnp.asarray(depth, dtype)
        self.depth = depth
        self.height, self.width = depth.shape
        self.intrinsic_matrix = jnp.asarray(intrinsic_matrix, dtype)
        self.camera_pose = jnp.asarray(camera_pose, dtype)
        self.threshold = threshold

        valid = jnp.logical_and(depth > 0, depth < threshold)
        if target_mask is not None:
            valid = jnp.logical_and(valid, jnp.asarray(target_mask) == 0)
        self.points_padded, self.valid = backproject_depth(
            depth, self.intrinsic_matrix, self.camera_pose, valid
        )

    @property
    def points(self) -> np.ndarray:
        """Compacted (N, 3) world points (host-side, reference parity)."""
        pts = np.asarray(self.points_padded)
        return pts[np.asarray(self.valid)]

    def get_random_surface_points(self, count: int, seed: int = 0) -> np.ndarray:
        pts = self.points
        idx = np.random.default_rng(seed).choice(pts.shape[0], count)
        return pts[idx]

    # -- device queries -------------------------------------------------------

    def is_outside(self, query_points):
        """Camera-visibility test: True where the query is observed free space.

        Parity: depth_point_cloud.py:127-142 — project to the camera; if the
        pixel is in the viewport and the query's camera-frame depth is smaller
        than the measured depth, the query is in front of the surface
        (outside); queries outside the viewport default to outside.
        """
        return camera_outside(
            self.depth, self.intrinsic_matrix, self.camera_pose, query_points
        )

    def _host_tree(self):
        """Lazy C++ KD-tree over the valid cloud (False when unavailable)."""
        if getattr(self, "_kdtree", None) is None:
            try:
                from grasptrajopt_tpu import native

                pts = self.points
                self._kdtree = (
                    native.NativeKDTree(pts)
                    if native.is_available() and len(pts)
                    else False
                )
            except Exception:
                self._kdtree = False
        return self._kdtree

    def get_sdf(self, query_points, host="auto"):
        """Signed distance of (M, 3) world points to the scene cloud.

        host='auto': eager queries on the CPU backend route through the
        C++ multithreaded KD-tree (native/geomcore.cpp) — exact same
        semantics, ~20x faster than the brute-force reduction XLA-on-CPU
        runs for the dense field builds; traced queries and accelerator
        backends keep the device path (ops.min_sqdist_d2).
        """
        is_tracer = isinstance(query_points, jax.core.Tracer)
        if host == "auto":
            host = not is_tracer and jax.default_backend() == "cpu"
        if host and not is_tracer:
            tree = self._host_tree()
            if tree is not False:
                q64 = np.asarray(query_points, np.float64)
                d, _ = tree.query(q64)
                d = d.astype(np.dtype(self.depth.dtype))
                outside = np.asarray(self.is_outside(q64))
                return np.where(outside, d, -d)
        q = jnp.asarray(query_points, self.depth.dtype)
        d2 = min_sqdist_d2(q, self.points_padded, ref_mask=self.valid)
        d = jnp.sqrt(d2)
        outside = self.is_outside(q)
        return jnp.where(outside, d, -d)

    def get_sdf_cost(self, query_points, epsilon: float = 0.02, w_inside: float = 1.0):
        """Shaped obstacle cost at query points (the planner's field values)."""
        return sdf_cost_shaping(self.get_sdf(query_points), epsilon, w_inside)

    def downsampled(self, voxel: float, capacity_step: int = 2048, dtype=jnp.float32):
        """A query-equivalent view with a voxel-deduplicated point set.

        Keeps one cloud point per `voxel`-sized cell (distance error
        <= voxel/2 in the worst case) and pads the set to a multiple of
        `capacity_step` so repeated builds across scenes reuse one compiled
        program. The depth image / camera (the sign test) are shared with
        the parent; `dtype` (default f32) sets the compute precision of the
        distance reduction — a dense field build is a pure MACs problem and
        never needs f64. Used by the fine-grid shelf field builds
        (GraspPipeline field_downsample); the default build path is
        untouched.
        """
        pts = self.points
        if voxel and voxel > 0 and pts.shape[0] > 0:
            cells = np.floor(pts / voxel).astype(np.int64)
            _, keep = np.unique(cells, axis=0, return_index=True)
            pts = pts[np.sort(keep)]
        n = max(int(pts.shape[0]), 1)
        cap = -(-n // capacity_step) * capacity_step
        padded = np.zeros((cap, 3), dtype=np.dtype(dtype))
        padded[:n] = pts[:n]
        valid = np.zeros((cap,), dtype=bool)
        valid[:n] = True

        view = object.__new__(DepthPointCloud)
        view.depth = self.depth.astype(dtype)
        view.height, view.width = self.height, self.width
        view.intrinsic_matrix = self.intrinsic_matrix.astype(dtype)
        view.camera_pose = self.camera_pose.astype(dtype)
        view.threshold = self.threshold
        view.points_padded = jnp.asarray(padded)
        view.valid = jnp.asarray(valid)
        return view

    def _sign_shell(self, dtype):
        """Camera-only copy (depth/K/pose cast to dtype) for is_outside."""
        shell = object.__new__(DepthPointCloud)
        shell.depth = self.depth.astype(dtype)
        shell.height, shell.width = self.height, self.width
        shell.intrinsic_matrix = self.intrinsic_matrix.astype(dtype)
        shell.camera_pose = self.camera_pose.astype(dtype)
        shell.threshold = self.threshold
        shell.points_padded = self.points_padded
        shell.valid = self.valid
        return shell

    def build_cost_field(self, grid, epsilon: float = 0.02, w_inside: float = 1.0):
        """Dense flat cost field over a VoxelGrid — the `sdf_cost_*` parameter
        the planners consume (pybullet_gto_planning.py:181,190)."""
        pts = jnp.asarray(grid.grid_points(), self.depth.dtype)
        return self.get_sdf_cost(pts, epsilon=epsilon, w_inside=w_inside)

    def get_sdf_in_batches(self, query_points, batch_size: int = 1_000_000):
        """Parity shim: batching is handled inside min_sqdist_d2 already."""
        return self.get_sdf(query_points)


class FusedDepthPointCloud(DepthPointCloud):
    """Multi-view fusion of depth observations (no reference equivalent —
    /root/reference/mesh_to_sdf/depth_point_cloud.py is single-view).

    Points are the union of every view's cloud; the visibility sign test is
    the union of free space: a query is OUTSIDE when ANY view observes it in
    front of its measured surface. This carves the occlusion bands a single
    camera cannot see (e.g. the underside of an upper shelf board, which a
    head-height camera marks 'inside' and thereby blocks every deep-shelf
    approach — the dominant synthetic-shelf failure mode, PERF.md).

    All query methods (get_sdf / get_sdf_cost / build_cost_field) are
    inherited — they only touch points_padded / valid / is_outside.
    """

    def __init__(self, views):
        views = list(views)
        if not views:
            raise ValueError("FusedDepthPointCloud needs at least one view")
        self.views = views
        v0 = views[0]
        # dtype carrier for inherited query methods
        self.depth = v0.depth
        self.height, self.width = v0.height, v0.width
        self.intrinsic_matrix = v0.intrinsic_matrix
        self.camera_pose = v0.camera_pose
        self.threshold = v0.threshold
        self.points_padded = jnp.concatenate([v.points_padded for v in views])
        self.valid = jnp.concatenate([v.valid for v in views])

    def is_outside(self, query_points):
        out = self.views[0].is_outside(query_points)
        for v in self.views[1:]:
            out = jnp.logical_or(out, v.is_outside(query_points))
        return out

    def downsampled(self, voxel: float, capacity_step: int = 2048, dtype=jnp.float32):
        """Fused view with a voxel-deduplicated union point set; the sign
        test keeps every view's depth image."""
        base = DepthPointCloud.downsampled(self, voxel, capacity_step, dtype)
        fused = object.__new__(FusedDepthPointCloud)
        fused.views = [v._sign_shell(dtype) for v in self.views]
        fused.depth = base.depth
        fused.height, fused.width = base.height, base.width
        fused.intrinsic_matrix = base.intrinsic_matrix
        fused.camera_pose = base.camera_pose
        fused.threshold = base.threshold
        fused.points_padded = base.points_padded
        fused.valid = base.valid
        return fused
