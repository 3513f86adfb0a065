"""Unrolled Cholesky + triangular substitution for tiny SPD blocks.

`jnp.linalg.cholesky` / `solve_triangular` on a (B, n, n) operand lower to
LAPACK-style XLA custom calls. Inside the block-Thomas scan of
`ops.block_tridiag` that means 3 custom calls PER TIME STEP, each paying
dispatch latency, not FLOPs (~470 calls per solve). For the n <= 16 blocks this
framework actually solves (panda 7, fetch 7, base 3), an UNROLLED
factorization is a handful of (batch,)-wide elementwise ops that XLA fuses
straight into the surrounding while-loop body — no custom-call dispatch at
all.

All functions take static n from the trailing shape and unroll Python
loops over it; they vmap/batch over any leading dims and are
dtype-polymorphic (tests run them in f64 on CPU).
"""

from __future__ import annotations

import jax.numpy as jnp

# Above this block size the O(n^2) unrolled op count stops paying for the
# saved dispatch; fall back to the custom-call path.
MAX_UNROLL_N = 16


def cholesky_small(A):
    """Lower Cholesky factor of SPD A (..., n, n), unrolled over n.

    Column-by-column Cholesky-Crout: iteration j materializes column j as
    one (..., n) vector op, so the whole factorization is n fused vector
    ops instead of one LAPACK custom call.
    """
    n = A.shape[-1]
    cols = []
    for j in range(n):
        v = A[..., :, j]
        for k in range(j):
            v = v - cols[k] * cols[k][..., j : j + 1]
        # rows above the diagonal are structural zeros of L
        d = jnp.sqrt(v[..., j : j + 1])
        col = jnp.where(jnp.arange(n) >= j, v / d, jnp.zeros_like(v))
        cols.append(col)
    return jnp.stack(cols, axis=-1)


def solve_triangular_lower_small(L, B):
    """Solve L Y = B by unrolled forward substitution.

    L: (..., n, n) lower-triangular; B: (..., n) or (..., n, m).
    """
    vec = B.ndim == L.ndim - 1
    if vec:
        B = B[..., None]
    n = L.shape[-1]
    ys = []
    for i in range(n):
        r = B[..., i, :]
        for k in range(i):
            r = r - L[..., i, k : k + 1] * ys[k]
        ys.append(r / L[..., i, i : i + 1])
    Y = jnp.stack(ys, axis=-2)
    return Y[..., 0] if vec else Y


def solve_triangular_upper_small(U, B):
    """Solve U Y = B (U upper-triangular) by unrolled back substitution."""
    vec = B.ndim == U.ndim - 1
    if vec:
        B = B[..., None]
    n = U.shape[-1]
    ys = [None] * n
    for i in range(n - 1, -1, -1):
        r = B[..., i, :]
        for k in range(i + 1, n):
            r = r - U[..., i, k : k + 1] * ys[k]
        ys[i] = r / U[..., i, i : i + 1]
    Y = jnp.stack(ys, axis=-2)
    return Y[..., 0] if vec else Y


def cholesky_solve_small(L, B):
    """Solve (L L^T) X = B given the lower factor L, fully unrolled."""
    Y = solve_triangular_lower_small(L, B)
    return solve_triangular_upper_small(jnp.swapaxes(L, -1, -2), Y)
