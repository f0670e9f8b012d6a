"""Shared host-side LM trust-region loop for sharded / streamed solvers.

The fully device-resident loop (solver/lm.py, lax.while_loop) is right for
single-program solves, but the sharded paths (dist/factor_parallel.py,
dist/schur_reduce.py, dist/schur_cm.py) and the segment-streamed Venice path
(solver/schur_large.py) drive one jitted *step* per iteration from the host —
either because checkpointing hooks live between iterations or because the
CG loop is driven from the host in bounded segments.  Round 1 gave
each of those its own hand-rolled accept/reject loop with drifting stopping
semantics; this module is the single implementation, mirroring
solver/lm.solve's semantics (reference Options fields per SURVEY.md §2.1:
max_iters, min_update_norm, min_cost, min_cost_decrease,
allow_nondecreasing_steps, max_nondecreasing_steps) field-for-field.
"""

from __future__ import annotations

from . import lm as _lm


def host_lm_loop(step, state, options: _lm.Options, on_accept=None):
    """Run the GN/LM accept-reject loop over a host-driven step.

    ``step(state, lam) -> (trial_state, chi2, cost_new, dx_norm)`` where
    ``chi2`` is the cost at the linearization point (current state) and
    ``cost_new`` the trial-state cost.  ``state`` is any pytree the caller
    threads through; ``lam`` arrives as a python float.

    ``on_accept(state, lam, n_accepted)`` is called after every accepted
    step (checkpoint hook).

    Returns ``(best_state, history, info)`` with ``history`` the accepted
    cost sequence (initial cost first) and ``info`` a dict with ``status``
    (solver.lm stop code), ``iterations``, and ``chi2`` (best cost).

    Semantics match solver/lm.solve exactly:
      * LM accepts iff cost_new < chi2 (NaN-safe: NaN comparisons are False,
        so failed factorizations are rejections, not crashes); GN always
        accepts (reference behavior).
      * best-state tracking across rejected steps.
      * stopping: update-norm (accepted steps only), min_cost, insufficient
        relative decrease (accepted steps in LM; improved steps in GN), and
        the GN nondecreasing-step budget.
    """
    lam = options.lambda_init
    best_state, best_cost = state, float("inf")
    nondec = 0
    history: list[float] = []
    status = _lm.RUNNING
    it = 0
    n_accepted = 0
    max_nondec = (
        options.max_nondecreasing_steps if options.allow_nondecreasing_steps else 1
    )
    for it in range(1, options.max_iters + 1):
        trial, chi2, cost_new, dx_norm = step(state, lam)
        chi2 = float(chi2)
        cost_new = float(cost_new)
        dx_norm = float(dx_norm)
        if not history:
            history.append(chi2)
            best_cost = chi2

        accept = (options.method == "gn") or (cost_new < chi2)
        if accept:
            state = trial
            history.append(cost_new)
            lam = max(lam * options.lambda_down, options.lambda_min)
            n_accepted += 1
            if on_accept is not None:
                on_accept(state, lam, n_accepted)
        else:
            lam = min(lam * options.lambda_up, options.lambda_max)

        improved = cost_new < best_cost
        if improved:
            best_state, best_cost = trial, cost_new
            nondec = 0
        else:
            nondec += 1

        # --- stopping logic (solver/lm.py order and conditions) ---
        if accept and dx_norm < options.min_update_norm:
            status = _lm.CONVERGED_UPDATE_NORM
            break
        if cost_new < options.min_cost:
            status = _lm.CONVERGED_MIN_COST
            break
        decrease_ok = cost_new < chi2 * options.min_cost_decrease
        if options.method == "gn":
            if improved and not decrease_ok:
                status = _lm.CONVERGED_COST_DECREASE
                break
            if nondec >= max_nondec:
                status = _lm.STOPPED_NONDECREASING
                break
        else:
            if accept and not decrease_ok:
                status = _lm.CONVERGED_COST_DECREASE
                break

    if status == _lm.RUNNING:
        status = _lm.MAX_ITERS
    return best_state, history, dict(status=status, iterations=it, chi2=best_cost)


def host_lm_loop_speculative(linearize, solve_from, state, options: _lm.Options,
                             on_accept=None):
    """Speculative-linearization variant of :func:`host_lm_loop`.

    ``host_lm_loop``'s ``step`` contract forces every iteration to pay one
    gradient linearization (at the current state) plus one cost-only pass
    (at the trial state) — and a rejected step relinearizes the SAME state
    again on the retry.  This loop instead evaluates the trial state with a
    FULL gradient linearization: on accept, that linearization is exactly
    what the next solve needs, so it is reused; on reject, the retained
    current linearization is re-solved at higher lambda with no new
    linearize at all.  Net: exactly ONE gradient linearization per
    iteration and ZERO cost-only passes (at Venice scale the cost-only
    pass is a full streaming sweep of the observation set).

    Accept/reject and stopping decisions consume the same chi2 values as
    ``host_lm_loop`` (the cost at the trial point is identical whether it
    comes from a cost-only or a gradient pass), so the iterate sequence is
    unchanged.

    ``linearize(state) -> lin`` with ``lin[0]`` the cost at ``state``
    (device scalar); the rest of ``lin`` is whatever ``solve_from`` needs.
    ``solve_from(state, lin, lam) -> (trial_state, dx_norm)``.
    """
    lam = options.lambda_init
    lin = linearize(state)
    chi2 = float(lin[0])
    history: list[float] = [chi2]
    best_state, best_cost = state, chi2
    nondec = 0
    status = _lm.RUNNING
    it = 0
    n_accepted = 0
    max_nondec = (
        options.max_nondecreasing_steps if options.allow_nondecreasing_steps else 1
    )
    for it in range(1, options.max_iters + 1):
        trial, dx_norm = solve_from(state, lin, lam)
        dx_norm = float(dx_norm)
        lin_trial = linearize(trial)
        cost_new = float(lin_trial[0])

        accept = (options.method == "gn") or (cost_new < chi2)
        if accept:
            state, lin, chi2 = trial, lin_trial, cost_new
            history.append(cost_new)
            lam = max(lam * options.lambda_down, options.lambda_min)
            n_accepted += 1
            if on_accept is not None:
                on_accept(state, lam, n_accepted)
        else:
            lam = min(lam * options.lambda_up, options.lambda_max)

        improved = cost_new < best_cost
        if improved:
            best_state, best_cost = trial, cost_new
            nondec = 0
        else:
            nondec += 1

        # --- stopping logic: identical to host_lm_loop ---
        if accept and dx_norm < options.min_update_norm:
            status = _lm.CONVERGED_UPDATE_NORM
            break
        if cost_new < options.min_cost:
            status = _lm.CONVERGED_MIN_COST
            break
        # note: on accept, chi2 has been advanced to cost_new, so compare
        # against the pre-step cost (history[-2] on accept)
        prev_chi2 = history[-2] if accept else chi2
        decrease_ok = cost_new < prev_chi2 * options.min_cost_decrease
        if options.method == "gn":
            if improved and not decrease_ok:
                status = _lm.CONVERGED_COST_DECREASE
                break
            if nondec >= max_nondec:
                status = _lm.STOPPED_NONDECREASING
                break
        else:
            if accept and not decrease_ok:
                status = _lm.CONVERGED_COST_DECREASE
                break

    if status == _lm.RUNNING:
        status = _lm.MAX_ITERS
    return best_state, history, dict(status=status, iterations=it, chi2=best_cost)


__all__ = ["host_lm_loop", "host_lm_loop_speculative"]
