"""Block-tridiagonal projected Levenberg-Marquardt over a trajectory.

The grasp-trajectory NLP the reference builds symbolically and hands to
Ipopt (gto/gto_planner.py:42-142) is re-posed here so that ALL equality
constraints vanish structurally:

  reference decision vars:  q (n_opt, T) and dq (n_opt, T-1)
  reference constraints:    q[:,0] = qc;  dq[:,0] = 0;
                            q[:,t+1] = q[:,t] + dt dq[:,t]   (Euler,
                            optas/builder.py:420-470);  box limits on q.

  dq is fully determined by q (dq_t = (q_{t+1}-q_t)/dt), and dq_0 = 0 pins
  q_1 = q_0 = qc. So the decision variable is exactly X = q[:, 2:T], with
  the SAME feasible set: box limits become a clip, the velocity regularizer
  0.01*sum(dq^2) becomes a smoothness term with weight w = 0.01/dt^2, and
  dynamics hold by construction (zero residual, unlike a penalty method).

Per-step cost terms (obstacle SDF cost, goal point-match at specific steps)
depend on a single q_t each, so the Gauss-Newton Hessian over X is
block-diagonal (J_t^T J_t) plus the smoothness tridiagonal — solved exactly
per iteration by `ops.block_tridiag_solve` in O(T n^3). The nonsmooth
goal-set min (optas.mmin over candidate grasps, gto_planner.py:105) is
handled by freezing the active selection per iteration through a
`pre_iteration` hook, standard for minimizing a pointwise min of smooth
functions.

Performance-critical structure (the obstacle term's field gathers dominate
the iteration): each LM iteration runs exactly TWO traced residual passes —
  1. per-step `jacfwd(..., has_aux=True)`: primal residuals AND the (R, n)
     Jacobian share one trace, so gathered field rows are fetched once and
     reused by all forward tangents;
  2. one short vmapped candidate ladder for the acceptance test (gain
     ratio of actual vs GN-model predicted reduction adapts the damping).
The gradient is assembled analytically as J^T r + the closed-form
smoothness gradient — no separate autodiff pass.

Everything is one jit program with a fixed iteration budget (`lax.scan`),
vmappable over a batch of problem instances.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from grasptrajopt_tpu.ops import block_tridiag_solve
from grasptrajopt_tpu.ops.block_tridiag import (
    block_tridiag_matvec,
    block_tridiag_solve_cr,
)


class TrajectoryConfig(NamedTuple):
    T: int  # total trajectory steps (reference: 50, gto_planner.py:25)
    n_fixed: int = 2  # leading steps pinned to qc (q_0 = q_1 = qc)
    smooth_weight: float = 0.0  # w = vel_weight / dt^2
    iterations: int = 50
    lambda_init: float = 1e-3
    lambda_decrease: float = 0.35
    lambda_increase: float = 4.0
    lambda_min: float = 1e-9
    lambda_max: float = 1e8
    jitter: float = 1e-9
    # trial step scales: each candidate costs a full residual (field-gather)
    # pass. The single-candidate trust-region iteration (gain-ratio damping)
    # matches the two-candidate ladder on every convergence probe and is
    # ~20% faster end to end.
    alphas: Tuple[float, ...] = (1.0,)
    # single_pass=True fuses the acceptance test into the next iteration's
    # jacfwd pass: exactly ONE residual evaluation per iteration (the
    # classic "delayed gratification" LM restructure). The H/g of the last
    # ACCEPTED point are carried (tiny: (F, n, n) + (F, n)) so a rejected
    # trial re-solves from them with a larger lambda. Halves the dominant
    # field-gather traffic per iteration. The LAST scan iteration's freshly
    # solved trial point is kept when it improves (a single post-scan
    # residual pass evaluates it), so `iterations` buys a full `iterations`
    # evaluated LM trials on this path.
    single_pass: bool = False
    # final_trust=True (single_pass only) skips the post-scan residual
    # pass entirely: the budget's final KKT solve produced X_try from the
    # best accepted point with the adapted damping, and the solver RETURNS
    # it unevaluated (reported cost is the last accepted point's — stale
    # by half an iteration). Saves one full field-gather pass (~20% at a
    # 4-iteration budget) at the price of trusting one un-tested step;
    # gate any default change on its own closed-loop validation.
    final_trust: bool = False
    # cyclic_reduction=True solves the block-tridiagonal system with
    # parallel-in-time cyclic reduction (ops.block_tridiag_solve_cr):
    # ceil(log2 T) levels of batched block ops instead of a 2T-step scan of
    # tiny sequential Cholesky solves (latency-bound at small batches).
    cyclic_reduction: bool = False
    # matmul precision for everything traced inside the solve, the KKT
    # chain included. A reduced-precision f32 product (TF32 on the GPU,
    # which keeps ~3 decimal digits) steers the ITERATE at a finite
    # iteration budget, not just the rounding (PERF.md, carried findings:
    # precision). Every matmul in this solver is FLOP-trivial (7x7 KKT
    # blocks, n-wide J contractions), so "highest" costs little (PERF.md,
    # KKT precision). None = leave the platform default.
    matmul_precision: Optional[str] = "highest"


def make_trajectory_solver(
    step_residual_fn: Callable,
    config: TrajectoryConfig,
    pre_iteration: Optional[Callable] = None,
    traj_term: Optional[Tuple[Callable, Callable]] = None,
    coarse: Optional[Tuple[int, Optional[Callable], Optional[Tuple[Callable, Callable]]]] = None,
):
    """Build `solve(qc_opt, X0, lo, hi, params) -> (Q_opt, cost, aux)`.

    step_residual_fn(q_opt_t, t, step_aux, params) -> (R,): residuals of one
    trajectory step. `t` is a traced int32 scalar; per-step behavior must
    switch with jnp.where over t, keeping one shape for all steps.
    pre_iteration(Q_opt, params) -> step_aux: per-iteration auxiliary state
    (e.g. active-goal index), frozen during the step.

    traj_term — an optional WHOLE-TRAJECTORY residual term
    (value_fn, value_jac_fn) evaluated outside the per-step vmap:
      value_fn(Q, step_aux, params) -> (T, R2)
      value_jac_fn(Q, step_aux, params) -> ((T, R2), (T, R2, n))
    where the Jacobian at step t is w.r.t. q_t only (the per-step coupling
    assumption that keeps the GN Hessian block-tridiagonal). Use this for
    terms whose inner kernel (e.g. the Pallas min-distance obstacle term)
    must see the whole (T*P) batch in ONE launch instead of T launches
    under vmap — launch-count, not FLOPs, dominates such terms.

    coarse — optional `(k, step_residual_fn_coarse, traj_term_coarse)`:
    run the FIRST k of `config.iterations` LM iterations against the
    coarse objective (typically the same cost with the obstacle term
    evaluated on a strided subset of surface points — a multigrid-in-
    fidelity schedule), then the remaining iterations at full fidelity.
    The fine phase restarts its accepted-cost state (costs across the two
    objectives are not comparable), so the first fine iteration
    re-evaluates the coarse solution under the true objective; the damping
    state (lambda) carries over. Requires `config.single_pass`. Pass None
    for either coarse fn to reuse the full-fidelity one.

    Returns the full optimized-joint trajectory (T, n) including the pinned
    prefix, the final cost, and diagnostics.
    """
    T = config.T
    nf = config.n_fixed
    F = T - nf
    w = config.smooth_weight

    t_all = jnp.arange(T, dtype=jnp.int32)

    def assemble(X, qc_opt):
        prefix = jnp.broadcast_to(qc_opt, (nf,) + qc_opt.shape)
        return jnp.concatenate([prefix, X], axis=0)  # (T, n)

    def smooth_cost(Q):
        if w == 0.0:
            return jnp.asarray(0.0, Q.dtype)
        dq = Q[1:] - Q[:-1]
        return w * jnp.sum(dq * dq)

    def smooth_grad_X(Q):
        """d(smooth_cost)/dX / 2 (the g = grad/2 convention)."""
        # per free col t (t = nf..T-1): w * (2 Q_t - Q_{t-1} - Q_{t+1}),
        # last col: w * (Q_t - Q_{t-1})
        inner = 2.0 * Q[nf:-1] - Q[nf - 1 : -2] - Q[nf + 1 :]
        last = Q[-1] - Q[-2]
        return w * jnp.concatenate([inner, last[None]], axis=0)

    if coarse is not None:
        if not config.single_pass:
            raise NotImplementedError("coarse phase requires single_pass=True")
        k_coarse = int(coarse[0])
        step_fn_coarse = coarse[1] or step_residual_fn
        term_coarse = coarse[2] if coarse[2] is not None else traj_term
        if not 0 <= k_coarse < config.iterations:
            raise ValueError(
                f"coarse iterations {k_coarse} must be in [0, {config.iterations})"
            )
    else:
        k_coarse = 0

    def residuals_cost(X, qc_opt, step_aux, params, step_fn=step_residual_fn, term=traj_term):
        """One full residual pass: total cost only."""
        Q = assemble(X, qc_opt)
        r = jax.vmap(lambda q, t: step_fn(q, t, step_aux, params))(Q, t_all)
        c = jnp.sum(r * r) + smooth_cost(Q)
        if term is not None:
            r2 = term[0](Q, step_aux, params)
            c = c + jnp.sum(r2 * r2)
        return c

    def solve(qc_opt, X0, lo, hi, params):
        n = qc_opt.shape[0]
        dtype = qc_opt.dtype
        X0 = jnp.clip(jnp.asarray(X0, dtype), lo, hi)
        eye = jnp.eye(n, dtype=dtype)

        vel_diag = w * jnp.where(jnp.arange(F) < F - 1, 2.0, 1.0).astype(dtype)
        L_off = jnp.broadcast_to(-w * eye, (F - 1, n, n))
        kkt_solve = (
            block_tridiag_solve_cr if config.cyclic_reduction else block_tridiag_solve
        )

        def step_lin(q_t, t, step_aux, params, step_fn):
            """Primal residuals + Jacobian from ONE traced evaluation
            (jacfwd with has_aux shares the primal computation — gathered
            field rows are fetched once and reused by all tangents)."""

            def f(qq):
                r = step_fn(qq, t, step_aux, params)
                return r, r

            J, r = jax.jacfwd(f, has_aux=True)(q_t)  # J: (R, n)
            return r, J.T

        def lin_at(X, step_aux, step_fn=step_residual_fn, term=traj_term):
            """One jacfwd pass at X: cost, GN blocks H, gradient g.

            Pinned-prefix residuals contribute constant cost; residuals are
            computed for all steps but Jacobians only enter for free steps.
            Shared by the two-pass and single-pass iterations so the H/g
            assembly (including the traj_term contractions) has ONE home."""
            Q = assemble(X, qc_opt)
            r_all, J_allT = jax.vmap(
                lambda q, t: step_lin(q, t, step_aux, params, step_fn)
            )(Q, t_all)  # r: (T, R); J^T: (T, n, R)
            c = jnp.sum(r_all * r_all) + smooth_cost(Q)
            Jt = J_allT[nf:]  # (F, n, R)
            # these contractions run at config.matmul_precision (see
            # solve_scoped): reduced-precision operands steer the
            # finite-budget iterate, and they are FLOP-trivial anyway
            H = jnp.einsum("fir,fjr->fij", Jt, Jt)  # (F, n, n)
            g = jnp.einsum("fir,fr->fi", Jt, r_all[nf:]) + smooth_grad_X(Q)
            if term is not None:
                r2, J2 = term[1](Q, step_aux, params)  # (T,R2), (T,R2,n)
                c = c + jnp.sum(r2 * r2)
                H = H + jnp.einsum("fri,frj->fij", J2[nf:], J2[nf:])
                g = g + jnp.einsum("fri,fr->fi", J2[nf:], r2[nf:])
            return c, H, g

        def damped_D(H, lam):
            """LM-damped diagonal blocks (Marquardt scaling + jitter)."""
            scale = jnp.maximum(
                jax.vmap(jnp.diag)(H) + vel_diag[:, None], config.jitter
            )
            return (
                H
                + vel_diag[:, None, None] * eye
                + lam * jax.vmap(jnp.diag)(scale)
                + config.jitter * eye
            )

        def iteration(carry, _):
            X, lam, c, aux_prev = carry
            Q = assemble(X, qc_opt)
            step_aux = pre_iteration(Q, params) if pre_iteration is not None else aux_prev

            c_now, H_blocks, g = lin_at(X, step_aux)
            D = damped_D(H_blocks, lam)
            dX = -kkt_solve(D, L_off, g)

            alphas = jnp.asarray(config.alphas, dtype)
            cands = jnp.clip(X[None] + alphas[:, None, None] * dX[None], lo, hi)
            cand_costs = jax.vmap(
                lambda XX: residuals_cost(XX, qc_opt, step_aux, params)
            )(cands)
            best = jnp.argmin(cand_costs)
            X_trial = cands[best]
            c_trial = cand_costs[best]
            step = X_trial - X  # actual (projected) step
            # GN-model predicted reduction for the projected step
            Hs = block_tridiag_matvec(D, L_off, step)
            pred = -2.0 * jnp.sum(g * step) - jnp.sum(step * Hs)
            actual = c_now - c_trial

            accept = jnp.logical_and(actual > 0.0, jnp.isfinite(c_trial))
            # gain ratio modulates how fast lambda drops (no hard gate)
            ratio = actual / jnp.maximum(pred, 1e-12)
            good = jnp.logical_and(accept, ratio > 0.25)

            X_new = jnp.where(accept, X_trial, X)
            c_new = jnp.where(accept, c_trial, c_now)
            lam_new = jnp.where(
                good,
                lam * config.lambda_decrease,
                jnp.where(accept, lam * 0.7, lam * config.lambda_increase),
            )
            lam_new = jnp.clip(lam_new, config.lambda_min, config.lambda_max)
            return (X_new, lam_new, c_new, step_aux), None

        def solve_from(H, g, lam):
            return -kkt_solve(damped_D(H, lam), L_off, g)

        def make_iteration_single(step_fn, term):
            def iteration_single(carry, _):
                """Delayed-gratification LM: ONE residual/jac pass per
                iteration. The pass at the trial point doubles as its
                acceptance evaluation; on reject, re-solve from the stored
                (H, g) of the accepted point with a larger lambda.

                The c_try < c_acc test stays a true descent test on the
                pointwise-min objective even though step_aux changes between
                iterations: pre_iteration returns the argmin over the goal set
                of the only aux-dependent cost part (gto_planner.py
                pre_iteration), so every recorded cost equals
                min_aux f(X, aux) at its own point."""
                X_try, X_acc, H_acc, g_acc, c_acc, lam, aux_prev = carry
                step_aux = (
                    pre_iteration(assemble(X_try, qc_opt), params)
                    if pre_iteration is not None
                    else aux_prev
                )
                c_try, H_try, g_try = lin_at(X_try, step_aux, step_fn, term)

                accept = jnp.logical_and(c_try < c_acc, jnp.isfinite(c_try))
                pick = lambda a, b: jnp.where(accept, a, b)
                X_base = pick(X_try, X_acc)
                H_base = jax.tree.map(pick, H_try, H_acc)
                g_base = jax.tree.map(pick, g_try, g_acc)
                c_base = pick(c_try, c_acc)
                lam_new = jnp.clip(
                    jnp.where(accept, lam * config.lambda_decrease, lam * config.lambda_increase),
                    config.lambda_min,
                    config.lambda_max,
                )
                dX = solve_from(H_base, g_base, lam_new)
                X_next = jnp.clip(X_base + dX, lo, hi)
                return (X_next, X_base, H_base, g_base, c_base, lam_new, step_aux), None

            return iteration_single

        iteration_single = make_iteration_single(step_residual_fn, traj_term)

        aux0 = (
            pre_iteration(assemble(X0, qc_opt), params)
            if pre_iteration is not None
            else None
        )
        if config.single_pass:
            big = jnp.asarray(jnp.inf, dtype)
            H0 = jnp.zeros((F, n, n), dtype)
            g0 = jnp.zeros((F, n), dtype)
            init = (X0, X0, H0, g0, big, jnp.asarray(config.lambda_init, dtype), aux0)
            if k_coarse:
                # phase A on the coarse objective; restart the cost state
                # for phase B from the last coarse-ACCEPTED point (coarse
                # and fine costs are not comparable), carrying lambda
                (_, X_acc_c, _, _, _, lam_c, aux_c), _ = jax.lax.scan(
                    make_iteration_single(step_fn_coarse, term_coarse),
                    init,
                    None,
                    length=k_coarse,
                )
                init = (X_acc_c, X_acc_c, H0, g0, big, lam_c, aux_c)
            (X_try, X_acc, _, _, c_acc, lam, step_aux), _ = jax.lax.scan(
                iteration_single, init, None, length=config.iterations - k_coarse
            )
            if config.final_trust:
                # return the final trial point unevaluated (see
                # TrajectoryConfig.final_trust); cost is the last accepted
                # point's — callers comparing costs must not mix flavors
                Q = assemble(X_try, qc_opt)
                return Q, c_acc, {"lambda": lam, "step_aux": step_aux}
            # One post-scan residual pass: the budget's final KKT solve
            # produced X_try, which the scan would otherwise discard
            # unevaluated — keep it when it improves. Fresh aux at X_try
            # keeps the comparison on the pointwise-min objective (see
            # iteration_single docstring).
            if pre_iteration is not None:
                aux_try = pre_iteration(assemble(X_try, qc_opt), params)
            else:
                aux_try = step_aux
            c_try = residuals_cost(X_try, qc_opt, aux_try, params)
            take = jnp.logical_and(c_try < c_acc, jnp.isfinite(c_try))
            X_fin = jnp.where(take, X_try, X_acc)
            c_fin = jnp.where(take, c_try, c_acc)
            if pre_iteration is not None:
                step_aux = jax.tree.map(
                    lambda a, b: jnp.where(take, a, b), aux_try, step_aux
                )
            Q = assemble(X_fin, qc_opt)
            return Q, c_fin, {"lambda": lam, "step_aux": step_aux}

        c0 = residuals_cost(X0, qc_opt, aux0, params)
        init = (X0, jnp.asarray(config.lambda_init, dtype), c0, aux0)
        (X, lam, c, step_aux), _ = jax.lax.scan(
            iteration, init, None, length=config.iterations
        )
        Q = assemble(X, qc_opt)
        return Q, c, {"lambda": lam, "step_aux": step_aux}

    if config.matmul_precision is None:
        return solve

    def solve_scoped(qc_opt, X0, lo, hi, params):
        # trace-time scope: applies to every matmul/einsum traced inside
        # the solve (incl. user residual fns and traj terms)
        with jax.default_matmul_precision(config.matmul_precision):
            return solve(qc_opt, X0, lo, hi, params)

    return solve_scoped
