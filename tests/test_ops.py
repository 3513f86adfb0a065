"""Tests for on-device ops: NN distance, field interpolation, block-tridiag."""

import numpy as np
import pytest
from scipy.spatial import cKDTree

import jax
import jax.numpy as jnp

from grasptrajopt_tpu.ops import (
    block_tridiag_solve,
    field_lookup_nearest,
    field_lookup_trilinear,
    min_sqdist,
    min_sqdist_reference,
    points_to_offsets,
)
from grasptrajopt_tpu.ops.block_tridiag import block_tridiag_matvec
from grasptrajopt_tpu.ops.nn import (
    _nearest_impl,
    min_d2_pallas,
    min_d2_plain,
    min_sqdist_d2,
    signed_distance_to_set,
    signed_distance_with_dir,
)

RNG = np.random.default_rng(0)


class TestMinSqdist:
    def test_matches_kdtree(self):
        q = RNG.normal(size=(500, 3))
        r = RNG.normal(size=(700, 3))
        d2, idx = min_sqdist(jnp.asarray(q), jnp.asarray(r), chunk=128)
        tree = cKDTree(r)
        want_d, want_i = tree.query(q)
        np.testing.assert_allclose(np.sqrt(np.asarray(d2)), want_d, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(idx), want_i)

    def test_mask_excludes_points(self):
        q = np.zeros((1, 3))
        r = np.array([[0.1, 0, 0], [1.0, 0, 0]])
        mask = jnp.asarray([False, True])
        d2, idx = min_sqdist(jnp.asarray(q), jnp.asarray(r), ref_mask=mask)
        np.testing.assert_allclose(np.asarray(d2), [1.0], atol=1e-6)
        assert int(idx[0]) == 1

    def test_matches_dense_reference(self):
        q = RNG.normal(size=(37, 3))
        r = RNG.normal(size=(53, 3))
        d2a, ia = min_sqdist(jnp.asarray(q), jnp.asarray(r), chunk=16)
        d2b, ib = min_sqdist_reference(jnp.asarray(q), jnp.asarray(r))
        np.testing.assert_allclose(np.asarray(d2a), np.asarray(d2b), atol=1e-9)
        np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))

    def test_pallas_kernel_interpret_mode(self):
        """The Triton field-build kernel, interpreted on the CPU: masks,
        M and N that are not tile multiples, against cKDTree."""
        q = RNG.normal(size=(100, 3)).astype(np.float32)
        r = RNG.normal(size=(300, 3)).astype(np.float32)
        mask = RNG.uniform(size=300) > 0.2
        d2 = min_d2_pallas(jnp.asarray(q), jnp.asarray(r), jnp.asarray(mask),
                           tm=32, tn=64, interpret=True)
        assert d2.shape == (100,) and d2.dtype == jnp.float32
        want_d, _ = cKDTree(r[mask]).query(q)
        np.testing.assert_allclose(np.sqrt(np.asarray(d2)), want_d, atol=1e-6)

    def test_bcast_batched_kernel_interpret_mode(self):
        """vmap over clouds (the field-build shape: shared grid queries,
        one masked cloud per object) against the dense reference."""
        B, M, N = 3, 70, 130
        q = RNG.normal(size=(M, 3)).astype(np.float32)
        r = RNG.normal(size=(B, N, 3)).astype(np.float32)
        mask = RNG.uniform(size=(B, N)) > 0.2
        mask[:, 0] = True  # at least one valid point per cloud
        d2 = jax.vmap(
            lambda rr, mm: min_d2_pallas(jnp.asarray(q), rr, mm, tm=32, tn=32, interpret=True)
        )(jnp.asarray(r), jnp.asarray(mask))
        assert d2.shape == (B, M)
        for b in range(B):
            want, _ = min_sqdist_reference(jnp.asarray(q), jnp.asarray(r[b]), jnp.asarray(mask[b]))
            np.testing.assert_allclose(np.asarray(d2[b]), np.asarray(want), rtol=1e-6, atol=1e-7)

    @pytest.mark.parametrize("M,N,tm,tn", [(1, 1, 32, 32), (33, 65, 32, 32), (64, 64, 64, 64), (5, 200, 16, 128)])
    def test_kernel_wrapper_padding(self, M, N, tm, tn):
        """Padding in the wrapper: exact tile multiples, one past, and a
        single point; padded queries are trimmed and padded references
        never win."""
        q = RNG.uniform(-1, 1, size=(M, 3)).astype(np.float32)
        r = RNG.uniform(-1, 1, size=(N, 3)).astype(np.float32) + 5.0
        d2 = min_d2_pallas(jnp.asarray(q), jnp.asarray(r), tm=tm, tn=tn, interpret=True)
        want, _ = min_sqdist_reference(jnp.asarray(q), jnp.asarray(r))
        assert d2.shape == (M,)
        np.testing.assert_allclose(np.asarray(d2), np.asarray(want), rtol=1e-6)

    def test_kernel_all_masked_is_inf(self):
        q = RNG.normal(size=(10, 3)).astype(np.float32)
        r = RNG.normal(size=(40, 3)).astype(np.float32)
        d2 = min_d2_pallas(jnp.asarray(q), jnp.asarray(r), jnp.zeros(40, bool),
                           tm=16, tn=16, interpret=True)
        assert np.all(np.isinf(np.asarray(d2)))
        plain = min_d2_plain(jnp.asarray(q), jnp.asarray(r), jnp.zeros(40, bool))
        assert np.all(np.isinf(np.asarray(plain)))

    def test_plain_path_near_surface_is_exact(self):
        """The broadcast-subtract form keeps distances exact where the
        matmul form |q|^2 + |p|^2 - 2 q.p cancels: queries 1e-4 m from
        points at workspace coordinates (~1 m)."""
        r = RNG.uniform(0.5, 1.5, size=(256, 3)).astype(np.float32)
        offs = RNG.normal(size=(256, 3))
        offs *= 1e-4 / np.linalg.norm(offs, axis=1, keepdims=True)
        q = (r.astype(np.float64) + offs).astype(np.float32)
        d2 = min_d2_plain(jnp.asarray(q), jnp.asarray(r), chunk=64)
        want, _ = cKDTree(r.astype(np.float64)).query(q.astype(np.float64))
        np.testing.assert_allclose(np.sqrt(np.asarray(d2)), want, atol=1e-7)

    def test_platform_dependent_picks_plain_on_cpu(self):
        """min_sqdist_d2 compiled for the CPU holds no Triton call and equals
        the plain path; lowered for CUDA it holds the Triton kernel."""
        q = jnp.asarray(RNG.normal(size=(50, 3)).astype(np.float32))
        r = jnp.asarray(RNG.normal(size=(80, 3)).astype(np.float32))
        m = jnp.asarray(RNG.uniform(size=80) > 0.3)
        f = jax.jit(min_sqdist_d2)
        assert "triton" not in f.lower(q, r, m).as_text().lower()
        np.testing.assert_array_equal(np.asarray(f(q, r, m)), np.asarray(min_d2_plain(q, r, m)))
        cuda_text = f.trace(q, r, m).lower(lowering_platforms=("cuda",)).as_text()
        assert "triton" in cuda_text.lower()

    @pytest.mark.gpu
    def test_kernel_on_card_matches_plain(self, gpu_device):
        """The Triton kernel compiled for the card (no interpreter), under
        vmap over masked clouds, against the plain reduction."""
        q = jax.device_put(RNG.uniform(-1, 1, size=(5000, 3)).astype(np.float32), gpu_device)
        r = jax.device_put(RNG.uniform(-1, 1, size=(4, 3000, 3)).astype(np.float32), gpu_device)
        m = jax.device_put(RNG.uniform(size=(4, 3000)) > 0.2, gpu_device)
        got = jax.jit(jax.vmap(min_sqdist_d2, in_axes=(None, 0, 0)))(q, r, m)
        want = jax.vmap(min_d2_plain, in_axes=(None, 0, 0))(q, r, m)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)

    def test_min_sqdist_d2_dtype_follows_query(self):
        q = jnp.asarray(RNG.normal(size=(20, 3)))  # float64 under x64
        r = jnp.asarray(RNG.normal(size=(30, 3)))
        d2 = min_sqdist_d2(q, r)
        assert d2.dtype == q.dtype

    def test_voxel_dedup(self):
        import jax

        from grasptrajopt_tpu.ops import voxel_dedup

        pts = RNG.uniform(-1, 1, size=(5000, 3)).astype(np.float32)
        valid = RNG.uniform(size=5000) > 0.1
        vox = 0.05
        pd, mask, n = jax.jit(
            lambda p, v: voxel_dedup(p, v, vox, 8192)
        )(jnp.asarray(pts), jnp.asarray(valid))
        pd, mask = np.asarray(pd), np.asarray(mask)
        n = int(n)
        # unique count matches numpy's cell dedup of the valid set
        lo = pts[valid].min(axis=0)
        cells = np.floor((pts[valid] - lo) / vox).astype(np.int64)
        n_ref = len(np.unique(cells, axis=0))
        assert n == n_ref
        assert mask.sum() == min(n, 8192)
        kept = pd[mask]
        # every kept point is a real valid input point
        valid_set = {tuple(p) for p in pts[valid]}
        assert all(tuple(p) in valid_set for p in kept)
        # one per cell, and every occupied cell is represented (no overflow)
        kc = np.floor((kept - lo) / vox).astype(np.int64)
        assert len(np.unique(kc, axis=0)) == len(kept) == n_ref
        # coverage: every valid point is within a voxel diagonal of a kept one
        from scipy.spatial import cKDTree as T

        d, _ = T(kept).query(pts[valid])
        assert d.max() <= vox * np.sqrt(3) + 1e-6

    def test_voxel_dedup_overflow_drops_randomly(self):
        from grasptrajopt_tpu.ops import voxel_dedup

        pts = RNG.uniform(-1, 1, size=(4000, 3)).astype(np.float32)
        valid = np.ones(4000, bool)
        cap = 512
        pd, mask, n = voxel_dedup(jnp.asarray(pts), jnp.asarray(valid), 0.02, cap)
        assert int(n) > cap  # genuinely overflowing
        kept = np.asarray(pd)[np.asarray(mask)]
        assert len(kept) == cap
        # drops are scattered: the kept set still covers the whole cube
        # (each octant keeps a proportional share)
        oct_id = (kept > 0).astype(int) @ np.array([1, 2, 4])
        counts = np.bincount(oct_id, minlength=8)
        assert counts.min() > cap / 8 * 0.5

    def test_min_sqdist_d2_fallback_matches(self):
        from grasptrajopt_tpu.ops import min_sqdist_d2

        q = RNG.normal(size=(40, 3))
        r = RNG.normal(size=(90, 3))
        mask = RNG.uniform(size=90) > 0.3
        d2 = min_sqdist_d2(jnp.asarray(q), jnp.asarray(r), ref_mask=jnp.asarray(mask))
        want_d, _ = cKDTree(r[mask]).query(q)
        np.testing.assert_allclose(np.sqrt(np.asarray(d2)), want_d, atol=1e-9)


class TestNearestPointNormal:
    """Points-mode path: chunked min + argmin, then a gather of the nearest
    point and normal (ops.nn._nearest_impl / signed_distance_with_dir)."""

    def _scene(self, k=120):
        r = RNG.uniform(-1, 1, size=(k, 3))
        n = RNG.normal(size=(k, 3))
        return r, n / np.linalg.norm(n, axis=1, keepdims=True)

    def test_nearest_point_and_normal_match_kdtree(self):
        r, n = self._scene()
        q = RNG.uniform(-1.2, 1.2, size=(4, 25, 3))
        d2, p, nm = _nearest_impl(jnp.asarray(q), jnp.asarray(r), jnp.asarray(n), chunk=32)
        assert d2.shape == (4, 25) and p.shape == nm.shape == (4, 25, 3)
        want_d, want_i = cKDTree(r).query(q.reshape(-1, 3))
        np.testing.assert_allclose(np.sqrt(np.asarray(d2)).reshape(-1), want_d, atol=1e-9)
        np.testing.assert_array_equal(np.asarray(p).reshape(-1, 3), r[want_i])
        np.testing.assert_array_equal(np.asarray(nm).reshape(-1, 3), n[want_i])

    def test_ties_take_the_lowest_index(self):
        r = np.array([[1.0, 0, 0], [-1.0, 0, 0], [0, 1.0, 0]])
        n = np.eye(3)
        d2, p, nm = _nearest_impl(jnp.zeros((1, 3)), jnp.asarray(r), jnp.asarray(n))
        assert float(d2[0]) == 1.0
        np.testing.assert_array_equal(np.asarray(p[0]), r[0])
        np.testing.assert_array_equal(np.asarray(nm[0]), n[0])

    def test_signs_inside_and_outside_a_sheet(self):
        """A sampled sheet at z=0 with +z normals: just below it within the
        footprint is inside; below but laterally far away is outside."""
        xs, ys = np.meshgrid(np.linspace(0, 1, 11), np.linspace(0, 1, 11))
        sheet = np.c_[xs.ravel(), ys.ravel(), np.zeros(xs.size)]
        nrm = np.tile([0.0, 0.0, 1.0], (sheet.shape[0], 1))
        q = np.array([[0.5, 0.5, 0.03], [0.5, 0.5, -0.02], [1.5, 0.5, -0.02]])
        sd, dirs = signed_distance_with_dir(jnp.asarray(q), jnp.asarray(sheet), jnp.asarray(nrm))
        sd = np.asarray(sd)
        assert sd[0] > 0 and sd[1] < 0 and sd[2] > 0
        np.testing.assert_allclose(np.abs(sd[:2]), [0.03, 0.02], atol=1e-12)
        np.testing.assert_allclose(np.linalg.norm(np.asarray(dirs), axis=1), 1.0, atol=1e-9)

    def test_custom_jvp_matches_finite_differences(self):
        r, n = self._scene(60)
        q = jnp.asarray(RNG.uniform(-1, 1, size=(8, 3)))

        def f(p):
            return jnp.sum(signed_distance_to_set(p, jnp.asarray(r), jnp.asarray(n)))

        g = np.asarray(jax.jacfwd(f)(q))
        eps = 1e-6
        for i in range(q.shape[0]):
            for k in range(3):
                dq = np.zeros(q.shape)
                dq[i, k] = eps
                fd = (float(f(q + dq)) - float(f(q - dq))) / (2 * eps)
                np.testing.assert_allclose(g[i, k], fd, atol=1e-5)


class TestFieldLookup:
    def setup_method(self):
        self.shape = (8, 9, 10)
        self.origin = np.array([-0.1, -0.2, -0.3])
        self.res = 0.1
        self.field = RNG.normal(size=self.shape).astype(np.float64)
        self.flat = jnp.asarray(self.field.reshape(-1))

    def test_nearest_matches_reference_offsets(self):
        """Floor+clamp+row-major must equal gto_models.points_to_offsets_numpy."""
        pts = RNG.uniform(-0.5, 1.2, size=(200, 3))
        off = np.asarray(points_to_offsets(jnp.asarray(pts), self.origin, self.shape, self.res))
        # independent numpy re-derivation
        idx = (pts - self.origin) / self.res
        idx = np.floor(idx)
        for k in range(3):
            idx[:, k] = np.clip(idx[:, k], 0, self.shape[k] - 1)
        want = (idx[:, 2] + self.shape[2] * (idx[:, 1] + self.shape[1] * idx[:, 0])).astype(int)
        np.testing.assert_array_equal(off, want)
        vals = np.asarray(field_lookup_nearest(self.flat, jnp.asarray(pts), self.origin, self.shape, self.res))
        np.testing.assert_allclose(vals, self.field.reshape(-1)[want], atol=0)

    def test_trilinear_exact_at_corners(self):
        ii, jj, kk = np.meshgrid(range(8), range(9), range(10), indexing="ij")
        pts = self.origin + np.stack([ii, jj, kk], axis=-1).reshape(-1, 3) * self.res
        vals = np.asarray(
            field_lookup_trilinear(self.flat, jnp.asarray(pts), self.origin, self.shape, self.res)
        )
        np.testing.assert_allclose(vals, self.field.reshape(-1), atol=1e-10)

    def test_trilinear_linear_in_between(self):
        p0 = self.origin + np.array([2, 3, 4]) * self.res
        p1 = self.origin + np.array([3, 3, 4]) * self.res
        for alpha in [0.25, 0.5, 0.75]:
            p = (1 - alpha) * p0 + alpha * p1
            v = float(field_lookup_trilinear(self.flat, jnp.asarray(p[None]), self.origin, self.shape, self.res)[0])
            want = (1 - alpha) * self.field[2, 3, 4] + alpha * self.field[3, 3, 4]
            np.testing.assert_allclose(v, want, atol=1e-10)

    def test_trilinear_gradient(self):
        p = jnp.asarray(self.origin + np.array([2.3, 3.6, 4.1]) * self.res)

        def f(pt):
            return field_lookup_trilinear(self.flat, pt[None], self.origin, self.shape, self.res)[0]

        g = np.asarray(jax.grad(f)(p))
        eps = 1e-6
        for k in range(3):
            dp = np.zeros(3)
            dp[k] = eps
            fd = (f(p + dp) - f(p - dp)) / (2 * eps)
            np.testing.assert_allclose(g[k], np.asarray(fd), atol=1e-4)

    def test_packed_trilinear_matches_unpacked(self):
        from grasptrajopt_tpu.ops.interp import (
            field_lookup_trilinear_packed,
            pack_corners,
        )

        packed = pack_corners(self.flat, self.shape)
        assert packed.shape == (8 * 9 * 10, 8)
        pts = RNG.uniform(-0.5, 1.2, size=(300, 3))
        a = field_lookup_trilinear(self.flat, jnp.asarray(pts), self.origin, self.shape, self.res)
        b = field_lookup_trilinear_packed(packed, jnp.asarray(pts), self.origin, self.shape, self.res)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)

    def test_packed_soa_grad_closed_form_matches_jacfwd(self):
        """field_lookup_packed_soa_grad == (value, jacfwd) of the packed
        SoA lookup — interior AND clamped exterior points."""
        from grasptrajopt_tpu.ops.interp import (
            field_lookup_packed_soa_grad,
            field_lookup_trilinear_packed_soa,
            pack_corners,
        )

        packed = pack_corners(self.flat, self.shape)
        pts = jnp.asarray(RNG.uniform(-0.5, 1.2, size=(300, 3)))
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        val, gx, gy, gz = field_lookup_packed_soa_grad(
            packed, x, y, z, self.origin, self.shape, self.res
        )
        want = field_lookup_trilinear_packed_soa(
            packed, x, y, z, self.origin, self.shape, self.res
        )
        np.testing.assert_allclose(np.asarray(val), np.asarray(want), atol=1e-12)

        def f(px, py, pz):
            return field_lookup_trilinear_packed_soa(
                packed, px, py, pz, self.origin, self.shape, self.res
            ).sum()

        wgx, wgy, wgz = jax.grad(f, argnums=(0, 1, 2))(x, y, z)
        np.testing.assert_allclose(np.asarray(gx), np.asarray(wgx), atol=1e-9)
        np.testing.assert_allclose(np.asarray(gy), np.asarray(wgy), atol=1e-9)
        np.testing.assert_allclose(np.asarray(gz), np.asarray(wgz), atol=1e-9)

    def test_packed_rows_gather_vmap_rules(self):
        """The custom_vmap gather matches plain gathers for per-problem
        (batched) and shared (unbatched) tables."""
        from grasptrajopt_tpu.ops.interp import packed_rows_gather

        B, S = 3, 720
        tables = jnp.asarray(RNG.normal(size=(B, S, 8)))
        offs = jnp.asarray(RNG.integers(0, S, size=(B, 500)))
        # per-problem: vmap over both args -> lax.map path
        got = jax.vmap(packed_rows_gather)(tables, offs)
        want = jnp.stack([tables[b][offs[b]] for b in range(B)])
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=0)
        # shared table: vmap with in_axes=(None, 0) -> flat gather path
        got2 = jax.vmap(packed_rows_gather, in_axes=(None, 0))(tables[0], offs)
        want2 = jnp.stack([tables[0][offs[b]] for b in range(B)])
        np.testing.assert_allclose(np.asarray(got2), np.asarray(want2), atol=0)
        # unbatched call
        got3 = packed_rows_gather(tables[0], offs[0])
        np.testing.assert_allclose(np.asarray(got3), np.asarray(tables[0][offs[0]]), atol=0)

    def test_packed_trilinear_gradient_matches(self):
        import jax

        from grasptrajopt_tpu.ops.interp import (
            field_lookup_trilinear_packed,
            pack_corners,
        )

        packed = pack_corners(self.flat, self.shape)
        p = jnp.asarray(self.origin + np.array([2.3, 3.6, 4.1]) * self.res)

        def f_unpacked(pt):
            return field_lookup_trilinear(self.flat, pt[None], self.origin, self.shape, self.res)[0]

        def f_packed(pt):
            return field_lookup_trilinear_packed(packed, pt[None], self.origin, self.shape, self.res)[0]

        np.testing.assert_allclose(
            np.asarray(jax.grad(f_packed)(p)), np.asarray(jax.grad(f_unpacked)(p)), atol=1e-10
        )

    def test_clamped_outside(self):
        far = jnp.asarray([[99.0, 99.0, 99.0]])
        v = float(field_lookup_trilinear(self.flat, far, self.origin, self.shape, self.res)[0])
        np.testing.assert_allclose(v, self.field[-1, -1, -1], atol=1e-10)


class TestBlockTridiag:
    def _random_spd_system(self, T, n, seed=0):
        rng = np.random.default_rng(seed)
        lower = rng.normal(size=(T - 1, n, n)) * 0.3
        diag = np.zeros((T, n, n))
        for t in range(T):
            A = rng.normal(size=(n, n))
            diag[t] = A @ A.T + 5.0 * np.eye(n)  # diagonally dominant
        rhs = rng.normal(size=(T, n))
        return jnp.asarray(diag), jnp.asarray(lower), jnp.asarray(rhs)

    def test_solve_matches_dense(self):
        T, n = 12, 5
        diag, lower, rhs = self._random_spd_system(T, n)
        x = np.asarray(block_tridiag_solve(diag, lower, rhs))
        # dense assembly
        H = np.zeros((T * n, T * n))
        for t in range(T):
            H[t * n:(t + 1) * n, t * n:(t + 1) * n] = np.asarray(diag[t])
        for t in range(T - 1):
            H[(t + 1) * n:(t + 2) * n, t * n:(t + 1) * n] = np.asarray(lower[t])
            H[t * n:(t + 1) * n, (t + 1) * n:(t + 2) * n] = np.asarray(lower[t]).T
        want = np.linalg.solve(H, np.asarray(rhs).reshape(-1)).reshape(T, n)
        np.testing.assert_allclose(x, want, atol=1e-8)

    def test_matvec_roundtrip(self):
        T, n = 9, 4
        diag, lower, rhs = self._random_spd_system(T, n, seed=3)
        x = block_tridiag_solve(diag, lower, rhs)
        back = np.asarray(block_tridiag_matvec(diag, lower, x))
        np.testing.assert_allclose(back, np.asarray(rhs), atol=1e-8)

    def test_vmap_batch(self):
        T, n, B = 7, 3, 4
        systems = [self._random_spd_system(T, n, seed=s) for s in range(B)]
        diag = jnp.stack([s[0] for s in systems])
        lower = jnp.stack([s[1] for s in systems])
        rhs = jnp.stack([s[2] for s in systems])
        xb = jax.vmap(block_tridiag_solve)(diag, lower, rhs)
        for b in range(B):
            want = block_tridiag_solve(diag[b], lower[b], rhs[b])
            np.testing.assert_allclose(np.asarray(xb[b]), np.asarray(want), atol=1e-9)

    @pytest.mark.slow
    def test_cyclic_reduction_matches_scan(self):
        """Parallel-in-time cyclic reduction == block-Thomas at every size
        class: below/at/above the power-of-two padding, T=1, and the
        solver's own shape (T=48 free steps, n=7)."""
        from grasptrajopt_tpu.ops.block_tridiag import block_tridiag_solve_cr

        for T, n, seed in [(1, 3, 0), (2, 3, 1), (3, 4, 2), (7, 2, 3),
                           (8, 2, 4), (12, 5, 5), (48, 7, 6), (63, 4, 7)]:
            diag, lower, rhs = self._random_spd_system(T, n, seed=seed)
            want = np.asarray(block_tridiag_solve(diag, lower, rhs))
            got = np.asarray(block_tridiag_solve_cr(diag, lower, rhs))
            np.testing.assert_allclose(got, want, atol=1e-8, err_msg=f"T={T} n={n}")

    def test_cyclic_reduction_vmap(self):
        from grasptrajopt_tpu.ops.block_tridiag import block_tridiag_solve_cr

        T, n, B = 10, 4, 3
        systems = [self._random_spd_system(T, n, seed=s + 20) for s in range(B)]
        diag = jnp.stack([s[0] for s in systems])
        lower = jnp.stack([s[1] for s in systems])
        rhs = jnp.stack([s[2] for s in systems])
        xb = jax.vmap(block_tridiag_solve_cr)(diag, lower, rhs)
        want = jax.vmap(block_tridiag_solve)(diag, lower, rhs)
        np.testing.assert_allclose(np.asarray(xb), np.asarray(want), atol=1e-9)


class TestSmallChol:
    """Unrolled tiny-block Cholesky vs the LAPACK custom-call path."""

    def _spd(self, shape_prefix, n, seed=0):
        rng = np.random.default_rng(seed)
        A = rng.normal(size=shape_prefix + (n, n))
        return jnp.asarray(A @ np.swapaxes(A, -1, -2) + 3.0 * np.eye(n))

    def test_factor_matches_lapack(self):
        from grasptrajopt_tpu.ops.smallchol import cholesky_small

        for n in (1, 3, 7):
            A = self._spd((4,), n, seed=n)
            np.testing.assert_allclose(
                np.asarray(cholesky_small(A)),
                np.asarray(jnp.linalg.cholesky(A)),
                atol=1e-10,
            )

    def test_solves_match(self):
        from grasptrajopt_tpu.ops.smallchol import (
            cholesky_small,
            cholesky_solve_small,
            solve_triangular_lower_small,
            solve_triangular_upper_small,
        )

        n = 7
        A = self._spd((5,), n, seed=2)
        L = cholesky_small(A)
        rng = np.random.default_rng(3)
        b_vec = jnp.asarray(rng.normal(size=(5, n)))
        B_mat = jnp.asarray(rng.normal(size=(5, n, 4)))
        # vector and matrix right-hand sides, lower and upper
        y = solve_triangular_lower_small(L, b_vec)
        np.testing.assert_allclose(
            np.asarray(jnp.einsum("bij,bj->bi", L, y)), np.asarray(b_vec), atol=1e-9
        )
        Y = solve_triangular_upper_small(jnp.swapaxes(L, -1, -2), B_mat)
        np.testing.assert_allclose(
            np.asarray(jnp.swapaxes(L, -1, -2) @ Y), np.asarray(B_mat), atol=1e-9
        )
        X = cholesky_solve_small(L, B_mat)
        np.testing.assert_allclose(np.asarray(A @ X), np.asarray(B_mat), atol=1e-8)

    def test_grad_traces(self):
        # the solver differentiates through the KKT solve nowhere, but the
        # unrolled ops must at least be jit/vmap-safe inside scan bodies
        from grasptrajopt_tpu.ops.smallchol import cholesky_small, cholesky_solve_small

        A = self._spd((2, 3), 4, seed=5)
        b = jnp.asarray(np.random.default_rng(6).normal(size=(2, 3, 4)))
        out = jax.jit(jax.vmap(lambda a, bb: cholesky_solve_small(cholesky_small(a), bb)))(A, b)
        assert out.shape == (2, 3, 4)
