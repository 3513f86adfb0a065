"""Batched block-tridiagonal SPD solve (block Thomas / Cholesky recursion).

The trajectory Gauss-Newton Hessian is block-tridiagonal in time: smoothness
couples adjacent steps, every other cost term is block-diagonal (see
grasptrajopt_tpu.opt.trajectory). Solving H dx = -g therefore costs
O(T n^3) instead of O((Tn)^3); the recursion is a `lax.scan` over T with
(n, n) blocks, and the whole solve vmaps over a batch axis of problems.

This replaces the dense KKT factorizations Ipopt performs in the reference
(optas/solver.py:384 nlpsol hot loop) with a structure-exploiting on-device
solve. For very long horizons the same system admits parallel-in-time
cyclic reduction; at T=50 the sequential scan is already negligible.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from grasptrajopt_tpu.ops.smallchol import (
    MAX_UNROLL_N,
    cholesky_small,
    cholesky_solve_small,
)


def _block_linalg(n: int):
    """(cholesky, chol_solve) for (.., n, n) blocks: unrolled fused ops for
    the tiny blocks this framework solves (no LAPACK custom-call dispatch
    inside the time scan — see ops.smallchol), LAPACK path above the
    unroll threshold."""
    if n <= MAX_UNROLL_N:
        return cholesky_small, cholesky_solve_small

    def chol_solve(chol, b):
        y = jax.scipy.linalg.solve_triangular(chol, b, lower=True)
        return jax.scipy.linalg.solve_triangular(
            jnp.swapaxes(chol, -1, -2), y, lower=False
        )

    return jnp.linalg.cholesky, chol_solve


def block_tridiag_solve(diag, lower, rhs):
    """Solve H x = rhs with H SPD block-tridiagonal.

    diag:  (T, n, n)  — diagonal blocks D_t (symmetric)
    lower: (T-1, n, n) — sub-diagonal blocks L_t = H[t+1, t]
    rhs:   (T, n)

    Returns x: (T, n). Uses the block LDL^T (Schur) recursion:
        S_0 = D_0,  S_t = D_t - L_{t-1} S_{t-1}^{-1} L_{t-1}^T
    with per-block Cholesky factorizations.
    """
    T, n, _ = diag.shape
    cholesky, chol_solve = _block_linalg(n)

    # Forward sweep: factor Schur complements, reduce rhs.
    def fwd(carry, inp):
        chol_prev, y_prev = carry
        D_t, L_prev, b_t = inp
        # W = S_{t-1}^{-1} L_{t-1}^T  (n, n)
        W = chol_solve(chol_prev, jnp.swapaxes(L_prev, -1, -2))
        S_t = D_t - L_prev @ W
        chol_t = cholesky(S_t)
        y_t = b_t - L_prev @ chol_solve(chol_prev, y_prev)
        return (chol_t, y_t), (chol_t, y_t)

    chol0 = cholesky(diag[0])
    y0 = rhs[0]
    (_, _), (chols, ys) = jax.lax.scan(
        fwd, (chol0, y0), (diag[1:], lower, rhs[1:])
    )
    chols = jnp.concatenate([chol0[None], chols], axis=0)  # (T, n, n)
    ys = jnp.concatenate([y0[None], ys], axis=0)  # (T, n)

    # Backward sweep: x_{T-1} = S^{-1} y; x_t = S_t^{-1} (y_t - L_t^T x_{t+1})
    xT = chol_solve(chols[-1], ys[-1])

    def bwd(x_next, inp):
        chol_t, y_t, L_t = inp
        x_t = chol_solve(chol_t, y_t - jnp.swapaxes(L_t, -1, -2) @ x_next)
        return x_t, x_t

    _, xs_rev = jax.lax.scan(
        bwd, xT, (chols[:-1][::-1], ys[:-1][::-1], lower[::-1])
    )
    return jnp.concatenate([xs_rev[::-1], xT[None]], axis=0)


def block_tridiag_solve_cr(diag, lower, rhs):
    """Parallel-in-time block cyclic reduction solve of the same system as
    `block_tridiag_solve` (identical signature and semantics).

    The Thomas recursion above is a length-T sequential chain of tiny
    (n, n) Cholesky solves — latency-bound (2x47 tiny triangular solves
    back to back per LM iteration at T=50). Cyclic
    reduction eliminates every even-indexed block per level, so the T-step
    chain becomes ceil(log2 T) levels of BATCHED block ops: each level's
    Schur updates/solves run as one (m, n, n) Cholesky batch on device.
    This is the long-horizon scaling mechanism of SURVEY.md §5
    (sequence-parallel analog; the reference materializes its horizon
    densely, gto_planner.py:111, and has nothing comparable).

    SPD is preserved level to level (each reduced diagonal is a Schur
    complement of an SPD matrix), so plain Cholesky stays valid. The
    system is padded with decoupled identity blocks to size 2^k - 1;
    padding never mixes with real unknowns (zero couplings).
    """
    T, n, _ = diag.shape
    dtype = diag.dtype
    cholesky, chol_solve = _block_linalg(n)

    # pad to M = 2^k - 1 with identity diagonal blocks, zero couplings
    k = 1
    while (1 << k) - 1 < T:
        k += 1
    M = (1 << k) - 1
    eye = jnp.eye(n, dtype=dtype)
    D = jnp.concatenate([diag, jnp.tile(eye, (M - T, 1, 1))], axis=0)
    # L[t] couples t -> t+1; store length M with a trailing zero block
    L = jnp.zeros((M, n, n), dtype=dtype)
    L = L.at[: T - 1].set(lower)
    b = jnp.concatenate([rhs, jnp.zeros((M - T, n), dtype=dtype)], axis=0)

    def reduce(D, L, b):
        """One CR level: eliminate even 0-based indices.
        D: (m, n, n), L: (m, n, n) (L[-1] is zero), b: (m, n) with
        m = 2^j - 1. Returns the half-size system plus the elimination
        data needed for back-substitution."""
        m = D.shape[0]
        E = D[0::2]  # (p, n, n) even diagonals, p = (m+1)//2
        F = cholesky(E)
        r = chol_solve(F, b[0::2][..., None])[..., 0]  # (p, n) E^{-1} b_e

        A = L[0::2]  # A[mi] = L[2mi]   couples even 2mi   -> odd 2mi+1
        Bc = L[1::2]  # Bc[mi] = L[2mi+1] couples odd 2mi+1 -> even 2mi+2
        p = E.shape[0]
        # per even block e=2mi: X = E^{-1} A^T (right neighbor coupling),
        # Y = E^{-1} Bc_{prev}... compute what each ODD j=2mi+1 needs:
        #   left even  e=2mi:   S_l = A_j E_l^{-1} A_j^T,  uses X_l = E_l^{-1} A_j^T
        #   right even e=2mi+2: S_r = Bc_j^T E_r^{-1} Bc_j, uses Y_r = E_r^{-1} Bc_j
        X = chol_solve(F[:-1], jnp.swapaxes(A[:-1], -1, -2))  # (p-1, n, n)
        Y = chol_solve(F[1:], Bc)  # (p-1, n, n)
        D2 = (
            D[1::2]
            - A[:-1] @ X
            - jnp.swapaxes(Bc, -1, -2) @ Y
        )
        b2 = (
            b[1::2]
            - (A[:-1] @ r[:-1][..., None])[..., 0]
            - (jnp.swapaxes(Bc, -1, -2) @ r[1:][..., None])[..., 0]
        )
        # new couplings between consecutive odds j=2mi+1 -> j+2, through the
        # shared even 2mi+2: L2[mi] = -L[2mi+2] E_{mi+1}^{-1} L[2mi+1]
        L2 = jnp.zeros_like(D2)
        if D2.shape[0] > 1:
            L2 = L2.at[:-1].set(-(A[1:-1] @ Y[:-1]))
        return (D2, L2, b2), (F, A, Bc)

    def backsub(x_odd, F, A, Bc, b):
        """Recover the evens given the solved odds of this level."""
        p = F.shape[0]
        n_ = b.shape[-1]
        xo = jnp.concatenate(
            [jnp.zeros((1, n_), b.dtype), x_odd, jnp.zeros((1, n_), b.dtype)], axis=0
        )  # x_{-1}, odds, x_{m} ghosts
        # even e=2mi: b_e - L_{e-1}^T x_{e... careful: eq e couples
        # L_{e-1} x_{e-1} (odd left) + D_e x_e + L_e^T x_{e+1} (odd right)
        # left coupling block L[2mi-1] = Bc[mi-1] (ghost zero at mi=0)
        Bl = jnp.concatenate([jnp.zeros((1, n_, n_), b.dtype), Bc], axis=0)
        rhs_e = (
            b[0::2]
            - (Bl @ xo[:p][..., None])[..., 0]
            - (jnp.swapaxes(A, -1, -2) @ xo[1 : p + 1][..., None])[..., 0]
        )
        x_even = chol_solve(F, rhs_e[..., None])[..., 0]
        # interleave evens and odds
        m = 2 * p - 1
        out = jnp.zeros((m, n_), b.dtype)
        out = out.at[0::2].set(x_even)
        out = out.at[1::2].set(x_odd)
        return out

    stack = []
    Dl, Ll, bl = D, L, b
    while Dl.shape[0] > 1:
        (Dl2, Ll2, bl2), saved = reduce(Dl, Ll, bl)
        stack.append((saved, bl))
        Dl, Ll, bl = Dl2, Ll2, bl2
    x = chol_solve(cholesky(Dl), bl[..., None])[..., 0]  # (1, n)
    for (F, A, Bc), b_level in reversed(stack):
        x = backsub(x, F, A, Bc, b_level)
    return x[:T]


def block_tridiag_matvec(diag, lower, x):
    """H @ x for the same block-tridiagonal layout (tests / CG fallback)."""
    y = jnp.einsum("tij,tj->ti", diag, x)
    y = y.at[1:].add(jnp.einsum("tij,tj->ti", lower, x[:-1]))
    y = y.at[:-1].add(jnp.einsum("tji,tj->ti", lower, x[1:]))
    return y
