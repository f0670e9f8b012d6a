"""Linear solvers for the normal equations.

On-device replacements for the reference's scipy.sparse.linalg.spsolve /
splu (pyslam/problem.py, SURVEY.md §3.1 hot loop 3):

  * ``cholesky_solve``  — dense blocked Cholesky via XLA (reduced camera
    systems, small/medium graphs).
  * ``pcg_solve``       — preconditioned conjugate gradients with a caller-
    supplied matvec + preconditioner (large block-sparse systems; matvec
    implementations live in bcsr.py / schur.py).

A failed Cholesky (indefinite H) yields NaNs, which the LM loop treats as a
rejected step — no host-side branching required.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular


def cholesky_solve(H, g):
    """Solve H dx = g for SPD H via Cholesky; NaN on failure (by design)."""
    L = jnp.linalg.cholesky(H)
    y = solve_triangular(L, g, lower=True)
    return solve_triangular(L.T, y, lower=False)


def damp_marquardt(H, lam, floor=1e-12):
    """Levenberg-Marquardt damping H + lam * diag(H) (Marquardt scaling,
    which is unit-free — preferred over lam * I for mixed pose/landmark
    blocks).  The floor keeps gauge-free directions damped."""
    d = jnp.maximum(jnp.diagonal(H), floor)
    return H + lam * jnp.diag(d)


def _pcg(matvec, precond, b, x0, tol, max_iters):
    # Called inside an outer jit (the LM loop); no separate jit wrapper so
    # closure identity never triggers recompilation.
    def body(state):
        x, r, z, p, rz, it = state
        Ap = matvec(p)
        alpha = rz / jnp.vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = jnp.vdot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        return x, r, z, p, rz_new, it + 1

    def cond(state):
        _, r, _, _, _, it = state
        return (jnp.linalg.norm(r) > tol) & (it < max_iters)

    r0 = b - matvec(x0)
    z0 = precond(r0)
    state = (x0, r0, z0, z0, jnp.vdot(r0, z0), jnp.zeros((), jnp.int32))
    x, r, *_, it = jax.lax.while_loop(cond, body, state)
    return x, it


def pcg_solve(matvec, b, precond=None, x0=None, rtol=1e-6, max_iters=500):
    """Preconditioned CG: solve A x = b given only a matvec closure.

    ``matvec`` and ``precond`` must be jit-traceable closures over the
    (block-sparse) system; they are treated as static, so one compilation per
    system *structure*.
    """
    if precond is None:
        precond = lambda r: r
    if x0 is None:
        x0 = jnp.zeros_like(b)
    tol = rtol * jnp.linalg.norm(b)
    return _pcg(matvec, precond, b, x0, tol, max_iters)
