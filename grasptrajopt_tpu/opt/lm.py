"""Dense projected Levenberg-Marquardt with box constraints.

Solves   min_x  ||r(x, p)||^2 + v(x, p)   s.t.  lo <= x <= hi

with a Gauss-Newton Hessian from `r`, Marquardt diagonal damping adapted by
a trust-region gain ratio, and projection of the trial step onto the box
(Bertsekas-style projected Newton).

This is the IK-screen / base-pose solver: the problems the reference hands
to Ipopt with T=1 (gto/ik_solver.py:75 max_iter=50) or goal_size columns
(gto/base_planner.py:92). Dimensions are tiny (<= ~100), so a dense solve
per iteration is cheaper than any structure exploitation; thousands of
instances run under vmap.

Each iteration evaluates the residual function in two traced passes:
`jacfwd(..., has_aux=True)` yields primal + Jacobian from one shared trace
(important when residuals contain SDF field gathers), and a short vmapped
candidate ladder tests trial steps. The gradient is assembled as
J^T r + grad(v)/2 with the convention C = sum r^2 + v, g = grad C / 2,
H ~= J^T J.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from grasptrajopt_tpu.ops.smallchol import (
    MAX_UNROLL_N,
    cholesky_small,
    cholesky_solve_small,
)


class LMConfig(NamedTuple):
    iterations: int = 50
    lambda_init: float = 1e-3
    lambda_decrease: float = 0.35
    lambda_increase: float = 4.0
    lambda_min: float = 1e-9
    lambda_max: float = 1e8
    jitter: float = 1e-9
    # trial step scales, evaluated in ONE vmapped pass; more candidates =
    # better basin exploration per iteration at the cost of extra residual
    # evaluations (cheap for dense problems)
    alphas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1, 0.03)
    # matmul precision for everything traced inside the solve (see
    # opt/trajectory.py TrajectoryConfig.matmul_precision: reduced-precision
    # f32 products move finite-budget iterates; the dense problems here are
    # tiny, so "highest" costs little). None = platform default.
    matmul_precision: Optional[str] = "highest"


def make_box_lm_solver(
    residual_fn: Callable,
    value_fn: Optional[Callable] = None,
    config: LMConfig = LMConfig(),
):
    """Build a jit-able solver `solve(x0, lo, hi, params) -> (x, cost, aux)`.

    residual_fn(x, params) -> (R,) residual vector (cost contributes sum r^2)
    value_fn(x, params) -> scalar added to the cost (gradient-only term —
        e.g. the IK obstacle cost 10 * sum(sdf), gto/ik_solver.py:69, which
        is linear in field values and has no useful GN curvature)
    """
    if value_fn is not None:
        value_grad = jax.value_and_grad(value_fn)

    def cost_fn(x, params):
        r = residual_fn(x, params)
        c = jnp.sum(r * r)
        if value_fn is not None:
            c = c + value_fn(x, params)
        return c

    def solve(x0, lo, hi, params):
        x0 = jnp.clip(jnp.asarray(x0), lo, hi)
        n = x0.shape[0]
        eye = jnp.eye(n, dtype=x0.dtype)

        def body(carry, _):
            x, lam, c = carry

            def f(xx):
                r = residual_fn(xx, params)
                return r, r

            J, r = jax.jacfwd(f, has_aux=True)(x)  # J: (R, n)
            Jt = J.T
            c_now = jnp.sum(r * r)
            g = Jt @ r
            if value_fn is not None:
                v, dv = value_grad(x, params)
                c_now = c_now + v
                g = g + 0.5 * dv
            H = Jt @ Jt.T

            scale = jnp.maximum(jnp.diag(H), config.jitter)
            A = H + lam * jnp.diag(scale) + config.jitter * eye
            if n <= MAX_UNROLL_N:
                # A is SPD by construction (J^T J + positive diagonal):
                # the unrolled Cholesky solve fuses into the scan body
                # instead of dispatching a LAPACK LU custom call per
                # iteration (see ops.smallchol)
                dx = -cholesky_solve_small(cholesky_small(A), g)
            else:
                dx = -jnp.linalg.solve(A, g)

            alphas = jnp.asarray(config.alphas, x.dtype)
            cands = jnp.clip(x[None] + alphas[:, None] * dx[None], lo, hi)
            cand_costs = jax.vmap(lambda xx: cost_fn(xx, params))(cands)
            best = jnp.argmin(cand_costs)
            x_trial = cands[best]
            c_trial = cand_costs[best]
            step = x_trial - x
            pred = -2.0 * jnp.dot(g, step) - jnp.dot(step, A @ step)
            actual = c_now - c_trial

            accept = jnp.logical_and(actual > 0.0, jnp.isfinite(c_trial))
            # gain ratio only modulates HOW MUCH lambda drops: good model
            # agreement drops fast, weak agreement drops gently (a hard
            # ratio gate stalls convergence under box projection)
            ratio = actual / jnp.maximum(pred, 1e-12)
            good = jnp.logical_and(accept, ratio > 0.25)

            x_new = jnp.where(accept, x_trial, x)
            c_new = jnp.where(accept, c_trial, c_now)
            lam_new = jnp.where(
                good,
                lam * config.lambda_decrease,
                jnp.where(accept, lam * 0.7, lam * config.lambda_increase),
            )
            lam_new = jnp.clip(lam_new, config.lambda_min, config.lambda_max)
            return (x_new, lam_new, c_new), None

        init = (x0, jnp.asarray(config.lambda_init, x0.dtype), cost_fn(x0, params))
        (x, lam, c), _ = jax.lax.scan(body, init, None, length=config.iterations)
        return x, c, {"lambda": lam}

    if config.matmul_precision is None:
        return solve

    def solve_scoped(x0, lo, hi, params):
        with jax.default_matmul_precision(config.matmul_precision):
            return solve(x0, lo, hi, params)

    return solve_scoped


def solve_box_lm(residual_fn, x0, lo, hi, params, value_fn=None, config: LMConfig = LMConfig()):
    """One-shot convenience wrapper around make_box_lm_solver."""
    return make_box_lm_solver(residual_fn, value_fn, config)(x0, lo, hi, params)
