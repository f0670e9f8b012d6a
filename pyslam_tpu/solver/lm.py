"""Gauss-Newton / Levenberg-Marquardt driver as a jitted state machine.

The reference iterates solve_one_iter in Python with host-side stopping logic
(pyslam/problem.py Problem.solve, SURVEY.md §3.1).  Here the *entire* solve —
linearize, assemble, damp, factorize, retract, accept/reject, stopping — runs
device-resident under one ``lax.while_loop``: zero host round-trips per
iteration (the benchmark metric is iterations/sec, BASELINE.json:2).

Options carries every knob of the reference's ``Options`` (same names &
semantics: max_iters, min_update_norm, min_cost, min_cost_decrease,
allow_nondecreasing_steps, max_nondecreasing_steps) plus the LM/linear-solver
extensions the reference lacks.

Robustness trick: an indefinite damped Hessian makes Cholesky return NaN,
cost_new becomes NaN, every comparison with NaN is False, so the step is
rejected and lambda increases — failed factorizations are handled with no
branching.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..graph.core import FactorGraph
from .assemble import assemble_dense
from .linear import cholesky_solve, damp_marquardt

# Stop codes (SolveInfo.status)
RUNNING = 0
MAX_ITERS = 1
CONVERGED_UPDATE_NORM = 2
CONVERGED_MIN_COST = 3
CONVERGED_COST_DECREASE = 4
STOPPED_NONDECREASING = 5

STATUS_NAMES = {
    MAX_ITERS: "max_iters",
    CONVERGED_UPDATE_NORM: "update_norm < min_update_norm",
    CONVERGED_MIN_COST: "cost < min_cost",
    CONVERGED_COST_DECREASE: "insufficient cost decrease",
    STOPPED_NONDECREASING: "nondecreasing steps",
}


@dataclasses.dataclass(frozen=True)
class Options:
    """Solver knobs.  The first block mirrors the reference's Options
    (pyslam/problem.py per SURVEY.md §2.1) field-for-field."""

    # --- reference-parity fields ---
    max_iters: int = 100
    min_update_norm: float = 1e-10
    min_cost: float = 1e-30
    min_cost_decrease: float = 0.99
    allow_nondecreasing_steps: bool = False
    max_nondecreasing_steps: int = 3
    # --- solver extensions beyond the reference ---
    method: str = "lm"  # 'gn' (reference) | 'lm' (damping) | 'dogleg' (trust region)
    lambda_init: float = 1e-4
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    lambda_min: float = 1e-12
    lambda_max: float = 1e8
    gn_diag_floor: float = 0.0  # tiny diagonal added in GN mode if gauge-free
    # --- dogleg trust-region knobs (method='dogleg') ---
    trust_radius_init: float = 1.0
    trust_radius_max: float = 1e6
    trust_radius_min: float = 1e-12
    # --- speculative linearization (round 4) ---
    # Evaluate each trial point with a FULL linearization instead of a
    # cost-only chi2 pass: on accept, the trial assembly IS the next
    # iteration's linearization, so the separate trial-cost sweep is never
    # paid (rejects cost the same as classic, which re-assembles at the
    # unchanged point anyway).  Same accept/reject rule; cost comparisons
    # use the assembly-path chi2 on both sides (the classic loop compares
    # graph.chi2() against the assembly chi2 — mixed summation orders).
    speculative: bool = True


class SolveInfo(NamedTuple):
    chi2: jnp.ndarray  # best cost reached
    iterations: jnp.ndarray
    status: jnp.ndarray  # stop code, see STATUS_NAMES
    cost_history: jnp.ndarray  # (max_iters + 1,), NaN-padded
    lambda_history: jnp.ndarray  # (max_iters,)
    update_norms: jnp.ndarray  # (max_iters,)
    accepted: jnp.ndarray  # (max_iters,) bool


def _select_tree(pred, a, b):
    return jax.tree_util.tree_map(lambda x, y: jnp.where(pred, x, y), a, b)


@partial(jax.jit, static_argnames=("options", "assemble_fn", "solve_fn", "matvec_fn"))
def solve(
    graph: FactorGraph,
    options: Options = Options(),
    assemble_fn=None,
    solve_fn=None,
    matvec_fn=None,
):
    """Run GN/LM/dogleg to convergence.  Returns (solved_graph, SolveInfo).

    ``assemble_fn(graph) -> (H, g, chi2)`` and ``solve_fn(H, g, lam,
    options) -> dx`` default to the dense path; the block-sparse and Schur
    paths pass their own (same contract, static closures).  ``matvec_fn(H,
    v) -> Hv`` (default dense ``H @ v``) is required only by the dogleg
    method, which evaluates the quadratic model at the composite step.
    """
    if assemble_fn is None:
        assemble_fn = assemble_dense
    if solve_fn is None:
        solve_fn = _dense_solve
    if matvec_fn is None:
        if options.method == "dogleg" and (
            assemble_fn is not assemble_dense or solve_fn is not _dense_solve
        ):
            raise ValueError(
                "method='dogleg' with a custom linear path needs matvec_fn(H, v)"
            )
        matvec_fn = lambda H, v: H @ v
    opt = options
    batches = graph.batches
    dtype = next(iter(graph.blocks.values())).values.dtype
    K = opt.max_iters

    if opt.speculative:
        # one assembly before the loop seeds the carried linearization; its
        # chi2 is the initial cost so every comparison stays on the
        # assembly summation path
        H0, g0, init_cost = assemble_fn(graph)
    else:
        init_cost = graph.chi2()
    lam0 = opt.trust_radius_init if opt.method == "dogleg" else opt.lambda_init
    state = dict(
        blocks=graph.blocks,
        best_blocks=graph.blocks,
        cost=init_cost,
        best_cost=init_cost,
        lam=jnp.asarray(lam0, dtype),
        it=jnp.zeros((), jnp.int32),
        nondec=jnp.zeros((), jnp.int32),
        status=jnp.asarray(RUNNING, jnp.int32),
        cost_hist=jnp.full((K + 1,), jnp.nan, dtype).at[0].set(init_cost),
        lam_hist=jnp.full((K,), jnp.nan, dtype),
        dx_hist=jnp.full((K,), jnp.nan, dtype),
        acc_hist=jnp.zeros((K,), bool),
    )
    if opt.speculative:
        state["H"], state["g"], state["cost_lin"] = H0, g0, init_cost

    def cond(s):
        return (s["it"] < K) & (s["status"] == RUNNING)

    def body(s):
        # named scopes mark the solver phases in jax.profiler traces
        # (SURVEY.md §5 tracing row)
        g_cur = FactorGraph(s["blocks"], batches)
        if opt.speculative:
            # linearization at the current point is carried in state: it
            # was computed when this point was the accepted trial (or by
            # the pre-loop seed), and rejects leave it untouched
            H, g, cost_lin = s["H"], s["g"], s["cost_lin"]
        else:
            with jax.named_scope("linearize_assemble"):
                H, g, cost_lin = assemble_fn(g_cur)
        with jax.named_scope("linear_solve"):
            dx = solve_fn(H, g, s["lam"], opt)
        if opt.method == "dogleg":
            # Powell's dogleg: blend the (undamped) GN step with the Cauchy
            # point inside the trust region of radius Delta (carried in
            # s['lam']).  All three cases are evaluated and selected with
            # jnp.where — no data-dependent branching under jit.  g is the
            # NEGATIVE gradient (rhs of H dx = g), so it is the descent
            # direction.
            delta = s["lam"]
            tiny = jnp.asarray(1e-30, dtype)
            gg = jnp.dot(g, g)
            gHg = jnp.dot(g, matvec_fn(H, g))
            alpha = gg / jnp.maximum(gHg, tiny)
            dx_sd = alpha * g
            n_gn = jnp.linalg.norm(dx)
            n_sd = jnp.linalg.norm(dx_sd)
            d = dx - dx_sd
            a2 = jnp.maximum(jnp.dot(d, d), tiny)
            b2 = jnp.dot(dx_sd, d)
            c2 = jnp.dot(dx_sd, dx_sd) - delta * delta
            disc = jnp.sqrt(jnp.maximum(b2 * b2 - a2 * c2, 0.0))
            beta = (-b2 + disc) / a2
            dx_interp = dx_sd + beta * d
            dx_sd_clamped = (delta / jnp.maximum(n_sd, tiny)) * dx_sd
            # NaN-safety: a singular H gives NaN dx (GN) — both n_gn
            # comparisons are then False, so the finite steepest-descent
            # branch is still reachable once Delta shrinks below ||dx_sd||.
            interior = n_gn <= delta  # full GN step fits the trust region
            dx = jnp.where(
                interior,
                dx,
                jnp.where(n_sd >= delta, dx_sd_clamped, dx_interp),
            )
        update_norm = jnp.linalg.norm(dx)
        with jax.named_scope("retract_and_cost"):
            trial_blocks = g_cur.retract_all(dx).blocks
            if opt.speculative:
                H_t, g_t, cost_new = assemble_fn(FactorGraph(trial_blocks, batches))
            else:
                cost_new = FactorGraph(trial_blocks, batches).chi2()

        if opt.method == "lm":
            accept = cost_new < cost_lin  # False on NaN -> reject
            lam = jnp.where(
                accept,
                jnp.maximum(s["lam"] * opt.lambda_down, opt.lambda_min),
                jnp.minimum(s["lam"] * opt.lambda_up, opt.lambda_max),
            )
        elif opt.method == "dogleg":
            # gain ratio rho = actual / predicted decrease of the quadratic
            # model m(dx) = cost - g.dx + 0.5 dx.H.dx
            pred = jnp.dot(g, dx) - 0.5 * jnp.dot(dx, matvec_fn(H, dx))
            rho = (cost_lin - cost_new) / jnp.maximum(pred, tiny)
            accept = (cost_new < cost_lin) & (pred > 0)  # False on NaN
            delta = s["lam"]
            grow = (rho > 0.75) & (update_norm > 0.8 * delta)
            shrink = ~accept | (rho < 0.25)
            lam = jnp.where(grow, 2.0 * delta, jnp.where(shrink, 0.25 * delta, delta))
            lam = jnp.clip(lam, opt.trust_radius_min, opt.trust_radius_max)
        else:  # 'gn': unconditional step, reference behavior
            accept = jnp.asarray(True)
            lam = s["lam"]

        blocks = _select_tree(accept, trial_blocks, s["blocks"])
        cost = jnp.where(accept, cost_new, s["cost"])

        improved = cost_new < s["best_cost"]
        best_blocks = _select_tree(improved, trial_blocks, s["best_blocks"])
        best_cost = jnp.where(improved, cost_new, s["best_cost"])
        nondec = jnp.where(improved, 0, s["nondec"] + 1)

        # --- stopping logic (reference semantics) ---
        status = s["status"]
        max_nondec = opt.max_nondecreasing_steps if opt.allow_nondecreasing_steps else 1
        decrease_ok = cost_new < s["cost"] * opt.min_cost_decrease
        status = jnp.where(
            accept & (update_norm < opt.min_update_norm),
            CONVERGED_UPDATE_NORM,
            status,
        )
        status = jnp.where(cost_new < opt.min_cost, CONVERGED_MIN_COST, status)
        if opt.method == "gn":
            # GN stops when the cost stops decreasing fast enough ...
            status = jnp.where(
                (status == RUNNING) & improved & ~decrease_ok,
                CONVERGED_COST_DECREASE,
                status,
            )
            # ... or has not improved for max_nondecreasing_steps.
            status = jnp.where(
                (status == RUNNING) & (nondec >= max_nondec),
                STOPPED_NONDECREASING,
                status,
            )
        else:
            # LM/dogleg: 'converged' when an accepted step yields a tiny
            # relative decrease; rejected steps just shrink the region and
            # continue.  Dogleg additionally requires the step to have been
            # INTERIOR (full GN step inside the radius) — a radius-limited
            # step with small decrease means the region is still growing,
            # not that the optimum is reached.
            conv = accept & ~decrease_ok
            if opt.method == "dogleg":
                conv = conv & interior
            status = jnp.where(
                (status == RUNNING) & conv,
                CONVERGED_COST_DECREASE,
                status,
            )

        it = s["it"]
        out = dict(
            blocks=blocks,
            best_blocks=best_blocks,
            cost=cost,
            best_cost=best_cost,
            lam=lam,
            it=it + 1,
            nondec=nondec,
            status=status,
            cost_hist=s["cost_hist"].at[it + 1].set(cost),
            lam_hist=s["lam_hist"].at[it].set(s["lam"]),
            dx_hist=s["dx_hist"].at[it].set(update_norm),
            acc_hist=s["acc_hist"].at[it].set(accept),
        )
        if opt.speculative:
            out["H"] = _select_tree(accept, H_t, H)
            out["g"] = _select_tree(accept, g_t, g)
            out["cost_lin"] = jnp.where(accept, cost_new, cost_lin)
        return out

    s = jax.lax.while_loop(cond, body, state)
    status = jnp.where(s["status"] == RUNNING, MAX_ITERS, s["status"])
    info = SolveInfo(
        chi2=s["best_cost"],
        iterations=s["it"],
        status=status,
        cost_history=s["cost_hist"],
        lambda_history=s["lam_hist"],
        update_norms=s["dx_hist"],
        accepted=s["acc_hist"],
    )
    return FactorGraph(s["best_blocks"], batches), info


def _dense_solve(H, g, lam, opt: Options):
    from .assemble import unit_diag_where_dead

    H = unit_diag_where_dead(H)
    if opt.method == "lm":
        H = damp_marquardt(H, lam)
    elif opt.gn_diag_floor > 0.0:
        H = H + opt.gn_diag_floor * jnp.eye(H.shape[0], dtype=H.dtype)
    return cholesky_solve(H, g)


@partial(jax.jit, static_argnames=("options",))
def solve_one_iter(graph: FactorGraph, options: Options = Options()):
    """Single GN/LM step (reference Problem.solve_one_iter parity).
    Returns (updated_graph, dx, chi2_at_linearization)."""
    H, g, chi2 = assemble_dense(graph)
    dx = _dense_solve(H, g, jnp.asarray(options.lambda_init), options)
    return graph.retract_all(dx), dx, chi2
