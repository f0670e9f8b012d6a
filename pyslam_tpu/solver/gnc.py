"""Graduated non-convexity (GNC) for outlier-robust solving.

The reference's robustness story stops at fixed robust kernels
(pyslam/losses.py per SURVEY.md §2.1): Huber/Cauchy/Tukey IRLS from
whatever basin the initializer lands in.  Against gross outliers (wrong
loop closures, bad data association) fixed kernels routinely lock onto the
outliers.  GNC (Yang, Antonante, Tzoumas, Carlone — RA-L 2020, PAPERS.md)
solves the truncated-least-squares / Geman-McClure objective by graduating
a surrogate from convex to the target non-convexity, alternating

  1. a WEIGHTED least-squares solve (any solver path in this package —
     weights ride the existing per-factor ``FactorBatch.weight`` field, so
     the inner solve re-uses the jitted LM loop and compiles ONCE: the
     graph structure never changes, only weight data), and
  2. a closed-form per-factor weight update from the whitened residual
     norms at the current estimate.

Device shape: the outer loop is a handful of host iterations; everything hot
(inner solves, residual evaluation) is the standard batched jitted path.

No reference counterpart — capability beyond pyslam (SURVEY.md §2.1 lists
only fixed kernels)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.core import FactorGraph
from ..losses import L2Loss
from .lm import Options


class GNCInfo(NamedTuple):
    chi2: float  # robustified (TLS/GM) cost at the solution
    outer_iters: int
    weights: list  # per robustified batch: (F,) final GNC weights in [0, 1]
    inlier_masks: list  # per robustified batch: (F,) bool, weight > 0.5
    mu_history: list


def _r2_per_factor(graph: FactorGraph, batch_ids):
    """Whitened squared residual norm per factor for the selected batches
    (one fused jitted evaluation)."""
    out = []
    for bi in batch_ids:
        fb = graph.batches[bi]
        r, _ = fb.evaluate(graph.blocks, compute_jacobians=False)
        out.append(jnp.sum(r * r, axis=-1))
    return out


def _gm_weights(r2, mu, c2):
    """Geman-McClure surrogate weights: w = (mu c2 / (r2 + mu c2))^2."""
    t = mu * c2 / (r2 + mu * c2)
    return t * t


def _tls_weights(r2, mu, c2):
    """Truncated-least-squares surrogate weights (closed form, RA-L 2020
    eq. 14): 1 below the inner threshold, 0 above the outer, the saddle
    interpolation between."""
    lo = mu / (mu + 1.0) * c2
    hi = (mu + 1.0) / mu * c2
    mid = jnp.sqrt(c2 * mu * (mu + 1.0) / jnp.maximum(r2, 1e-30)) - mu
    w = jnp.clip(mid, 0.0, 1.0)
    w = jnp.where(r2 <= lo, 1.0, w)
    return jnp.where(r2 >= hi, 0.0, w)


def solve_gnc(
    graph: FactorGraph,
    options: Options | None = None,
    *,
    robustify=None,
    surrogate: str = "tls",
    c_sq: float | None = None,
    confidence: float = 0.99,
    mu_update: float = 1.4,
    max_outer: int = 30,
    inner_iters: int = 10,
    solve_fn=None,
):
    """Outlier-robust solve by graduated non-convexity.

    robustify: batch indices to apply GNC weights to (default: every
        batch whose factors touch two variables — loop closures and
        odometry; unary priors stay trusted).
    surrogate: 'tls' (default, hard inlier/outlier classification) | 'gm'.
        Measured (tests/test_gnc.py, 200-pose manhattan, 20/~300 edges
        replaced with gross outliers): TLS recovers to ~outlier-free ATE
        and classifies 19/20 planted edges; GM — whose mu-large start is
        literally plain L2 — locks into the wrecked L2 basin at that
        contamination for every anneal rate tried (1.2/1.4/2.0) and only
        recovers at mild contamination (4/~300: exact).  TLS's mu-small
        start w ~ sqrt(c^2 mu / r^2) downweights gross outliers from the
        first outer iteration, which is what saves it.
    c_sq: squared inlier threshold on the WHITENED residual sq-norm
        ||r||^2.  Default: the `confidence` chi-square quantile for the
        batch's residual dimension — the standard Mahalanobis gate.
    solve_fn: (graph, options) -> (solved, info); defaults to solve_auto.

    Returns (solved_graph, GNCInfo).  The returned graph carries the final
    GNC weights in its batches, so chi2()/covariance on it reflect the
    inlier set.
    """
    from . import solve_auto

    opts = options if options is not None else Options()
    inner_opts = dataclasses.replace(opts, max_iters=inner_iters)
    if solve_fn is None:
        solve_fn = solve_auto
    if robustify is None:
        robustify = [i for i, fb in enumerate(graph.batches) if len(fb.slots) == 2]
    if not robustify:
        raise ValueError("no batches to robustify")

    from scipy.stats import chi2 as _chi2_dist

    base_weights = [graph.batches[bi].weight for bi in robustify]
    c2s = []
    for bi in robustify:
        fb = graph.batches[bi]
        if c_sq is not None:
            c2s.append(float(c_sq))
        else:
            r, _ = fb.evaluate(graph.blocks, compute_jacobians=False)
            c2s.append(float(_chi2_dist.ppf(confidence, r.shape[-1])))

    # GNC inner solves are weighted LEAST squares: force L2 on the
    # robustified batches (a fixed robust kernel underneath would double
    # -count the downweighting and break the surrogate guarantees).
    def _with_weights(g, ws):
        batches = list(g.batches)
        for bi, w, bw in zip(robustify, ws, base_weights):
            batches[bi] = dataclasses.replace(
                batches[bi], loss=L2Loss(), weight=w * bw
            )
        return FactorGraph(dict(g.blocks), batches)

    upd = {"tls": _tls_weights, "gm": _gm_weights}[surrogate]

    # mu init from the max residual at the initial estimate (RA-L 2020 §III):
    # GM starts deep in the convex regime (mu large), TLS starts near-convex
    # (mu small) and graduates up.
    r2s = [np.asarray(x) for x in _r2_per_factor(graph, robustify)]
    r2max = max(float(x.max()) if x.size else 1.0 for x in r2s)
    mus = []
    for c2 in c2s:
        if surrogate == "gm":
            mus.append(max(2.0 * r2max / c2, 1.0))
        else:
            mus.append(max(c2 / max(2.0 * r2max - c2, 1e-9), 1e-6))

    ws = [jnp.ones_like(jnp.asarray(x)) for x in r2s]
    mu_hist = []
    solved = graph
    outer = 0
    for outer in range(1, max_outer + 1):
        solved, _ = solve_fn(_with_weights(solved, ws), inner_opts)
        r2s = _r2_per_factor(solved, robustify)
        ws = [upd(r2, mu, c2) for r2, mu, c2 in zip(r2s, mus, c2s)]
        mu_hist.append(list(mus))
        if surrogate == "gm":
            if all(mu <= 1.0 + 1e-9 for mu in mus):
                break
            mus = [max(mu / mu_update, 1.0) for mu in mus]
        else:
            # converged when the weights are (numerically) binary
            frac = sum(
                float(jnp.abs(w - jnp.round(w)).sum()) for w in ws
            )
            if frac < 1e-3:
                break
            mus = [mu * mu_update for mu in mus]

    # final polish on the converged inlier weights
    solved_g = _with_weights(solved, ws)
    solved, _ = solve_fn(solved_g, inner_opts)
    solved = _with_weights(solved, ws)

    # robustified cost: rho_TLS = min(r2, c2)-style truncated cost / GM
    chi2 = 0.0
    r2s = [np.asarray(x) for x in _r2_per_factor(solved, robustify)]
    for bi, r2, c2, bw in zip(robustify, r2s, c2s, base_weights):
        bw = np.asarray(bw)
        if surrogate == "tls":
            chi2 += float((np.minimum(r2, c2) * bw).sum())
        else:
            chi2 += float((c2 * r2 / (r2 + c2) * bw).sum())
    for i, fb in enumerate(solved.batches):
        if i in robustify:
            continue
        r, _ = fb.evaluate(solved.blocks, compute_jacobians=False)
        chi2 += float(jnp.sum(fb.loss.loss(r) * fb.weight[:, None]))

    weights = [np.asarray(w) for w in ws]
    return solved, GNCInfo(
        chi2=chi2,
        outer_iters=outer,
        weights=weights,
        inlier_masks=[w > 0.5 for w in weights],
        mu_history=mu_hist,
    )


__all__ = ["solve_gnc", "GNCInfo"]
