"""Square-root (QR / nullspace) landmark marginalization for bundle
adjustment — the conditioning-hardened alternative to forming Hll = Jl^T Jl
(PAPERS.md: "Square Root Bundle Adjustment", arXiv 2109.02182; SURVEY.md §7
hard part #1 names the f32-conditioning concern this addresses).

Math: stack each landmark's IRLS-whitened observation rows
[sqrt(w) Jl | sqrt(w) Jc | sqrt(w) r] and apply 3 batched Householder
reflections (QR of the 3-column landmark block).  The top 3 rows give the
landmark back-substitution (R dx_l = -b_top - B_top dx_p); the remaining
rows have ZERO landmark involvement — they ARE the square root of the Schur
complement, so the reduced camera system assembled from them equals S in
exact arithmetic while never squaring Jl's condition number.

Device-first design:
  * landmarks bucketed by padded observation count (static shapes per
    bucket; padded rows are zeroed and provably inert),
  * Householder loop is 3 static unrolled reflections of batched
    (L, n, .) arrays — pure batched einsums, no per-landmark control flow,
  * LM damping enters as 3 augmented sqrt(lam * diag) rows per landmark
    BEFORE the QR (the square-root form of Marquardt damping), so the
    damped elimination is still solved by orthogonal transforms,
  * the reduced camera system is dense (C*dp, C*dp) with a Cholesky solve —
    this path targets small/medium-camera BA where conditioning, not scale,
    is the concern (solve_schur / schur_large cover the scale regimes),
  * the whole LM iteration runs inside the shared jitted trust-region loop
    (lm.solve) via its assemble_fn/solve_fn extension points.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.core import FactorGraph
from . import lm as _lm
from .assemble import linearize_batch
from .linear import cholesky_solve
from .plan_cache import ClosureCache, content_key


@dataclasses.dataclass(frozen=True)
class SqrtBAPlan:
    """Host-side static bucketing of landmarks by observation count."""

    pose_name: str
    lm_name: str
    C: int
    L: int
    dp: int
    dl: int
    m: int  # residual dim per observation
    pose_first: bool
    # per bucket: (lm_ids (Lb,), obs_idx (Lb, kpad), obs_mask (Lb, kpad))
    buckets: tuple


def build_sqrt_plan(
    graph: FactorGraph, pose_name: str = "poses", lm_name: str = "landmarks"
) -> SqrtBAPlan:
    pb, lb = graph.blocks[pose_name], graph.blocks[lm_name]
    assert lb.dof == 3, "schur_sqrt's Householder/back-sub path is 3-dof landmarks"
    binary = [fb for fb in graph.batches if fb.slots == (pose_name, lm_name)]
    assert len(binary) == 1, "schur_sqrt expects exactly one pose-landmark batch"
    fb = binary[0]
    pt_idx = np.asarray(fb.indices[1])
    L = lb.n
    order = np.argsort(pt_idx, kind="stable")
    counts = np.bincount(pt_idx, minlength=L)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])

    def pad_size(k):  # next power of two, floor 2
        p = 2
        while p < k:
            p *= 2
        return p

    by_size: dict[int, list[int]] = {}
    for l in range(L):
        if counts[l] == 0:
            continue
        by_size.setdefault(pad_size(int(counts[l])), []).append(l)

    buckets = []
    for kpad in sorted(by_size):
        lms = np.asarray(by_size[kpad], np.int32)
        Lb = len(lms)
        obs_idx = np.zeros((Lb, kpad), np.int32)
        obs_mask = np.zeros((Lb, kpad), np.float64)
        for i, l in enumerate(lms):
            k = int(counts[l])
            obs_idx[i, :k] = order[starts[l] : starts[l] + k]
            obs_mask[i, :k] = 1.0
        buckets.append((lms, obs_idx, obs_mask))

    # residual dim: evaluate nothing — read from a 1-element probe later;
    # here infer from kernel by evaluating? Use the batch's data shape via a
    # cheap host evaluation of one factor.
    r, _ = fb.evaluate(graph.blocks, compute_jacobians=False)
    m = int(r.shape[1])

    names = list(graph.blocks)
    return SqrtBAPlan(
        pose_name=pose_name,
        lm_name=lm_name,
        C=pb.n,
        L=L,
        dp=pb.dof,
        dl=lb.dof,
        m=m,
        pose_first=names.index(pose_name) < names.index(lm_name),
        buckets=tuple(
            (jnp.asarray(l), jnp.asarray(o), jnp.asarray(msk))
            for l, o, msk in buckets
        ),
    )


def _householder_eliminate(A, Bb):
    """Batched QR elimination of the 3-column landmark block.

    A (L, n, 3); Bb (L, n, q) carries the pose columns AND the residual
    column so one reflection pass transforms everything.  Returns the
    transformed (A, Bb): A[:, :3, :3] is R (upper-triangular), rows >= 3 of
    A are ~0, and Bb rows >= 3 are the square-root reduced system."""
    n = A.shape[1]
    rows = jnp.arange(n)
    for j in range(3):
        colmask = (rows >= j).astype(A.dtype)
        x = A[:, :, j] * colmask[None, :]
        norm = jnp.sqrt(jnp.sum(x * x, axis=1))
        ajj = A[:, j, j]
        alpha = -jnp.where(ajj >= 0, 1.0, -1.0) * norm
        v = x.at[:, j].add(-alpha)
        vnorm2 = jnp.sum(v * v, axis=1)
        ok = (vnorm2 > 1e-30).astype(A.dtype)
        vn = v * (ok / jnp.sqrt(jnp.where(vnorm2 > 1e-30, vnorm2, 1.0)))[:, None]
        A = A - 2.0 * vn[:, :, None] * jnp.einsum("ln,lnc->lc", vn, A)[:, None, :]
        Bb = Bb - 2.0 * vn[:, :, None] * jnp.einsum("ln,lnq->lq", vn, Bb)[:, None, :]
    return A, Bb


def _tri3_solve(R, rhs, live):
    """Back-substitute the 3x3 upper-triangular R (batched), guarded for
    dead/const landmarks (live = 0 -> dx = 0)."""
    d0 = jnp.where(jnp.abs(R[:, 0, 0]) > 1e-30, R[:, 0, 0], 1.0)
    d1 = jnp.where(jnp.abs(R[:, 1, 1]) > 1e-30, R[:, 1, 1], 1.0)
    d2 = jnp.where(jnp.abs(R[:, 2, 2]) > 1e-30, R[:, 2, 2], 1.0)
    x2 = rhs[:, 2] / d2
    x1 = (rhs[:, 1] - R[:, 1, 2] * x2) / d1
    x0 = (rhs[:, 0] - R[:, 0, 1] * x1 - R[:, 0, 2] * x2) / d0
    return jnp.stack([x0, x1, x2], axis=1) * live[:, None]


def solve_schur_sqrt(
    graph: FactorGraph,
    options: _lm.Options = _lm.Options(),
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    plan: SqrtBAPlan | None = None,
):
    """GN/LM bundle adjustment with square-root (QR) landmark elimination.
    Same semantics as solve_schur (converges to the same chi2); numerically
    preferable in f32 when Jl is ill-conditioned (low-parallax landmarks).
    Supports one pose-landmark batch plus pose-unary prior batches.
    Returns (solved_graph, SolveInfo)."""
    if plan is None:
        plan = build_sqrt_plan(graph, pose_name, lm_name)
    key = ("sqrt", content_key(plan))
    if key not in _CLOSURES:
        C, dp, dl, m = plan.C, plan.dp, plan.dl, plan.m

        def assemble_fn(g):
            """Return the raw linearization pieces as 'H' (a pytree); the
            actual elimination happens in solve_fn where lam is known."""
            pb = g.blocks[plan.pose_name]
            lb = g.blocks[plan.lm_name]
            dtype = pb.values.dtype
            chi2 = jnp.zeros((), dtype)
            pieces = {"buckets": [], "unary": []}
            for fb in g.batches:
                r, jacs, w, c2 = linearize_batch(fb, g.blocks)
                chi2 = chi2 + c2
                if fb.slots == (plan.pose_name, plan.lm_name):
                    sw = jnp.sqrt(w)
                    Jc = jacs[0] * sw[..., None]
                    Jl = jacs[1] * sw[..., None]
                    rw = sw * r
                    ci = fb.indices[0]
                    for lms, obs_idx, obs_mask in plan.buckets:
                        msk = obs_mask.astype(dtype)
                        pieces["buckets"].append(
                            dict(
                                lms=lms,
                                cams=ci[obs_idx],  # (Lb, kpad)
                                A=Jl[obs_idx] * msk[..., None, None],
                                B=Jc[obs_idx] * msk[..., None, None],
                                b=rw[obs_idx] * msk[..., None],
                                mask=msk,
                            )
                        )
                elif fb.slots == (plan.pose_name,):
                    (J,) = jacs
                    (uci,) = fb.indices
                    Hu = jax.ops.segment_sum(
                        jnp.einsum("fmi,fm,fmj->fij", J, w, J), uci, num_segments=C
                    )
                    gu = -jax.ops.segment_sum(
                        jnp.einsum("fmi,fm->fi", J, w * r), uci, num_segments=C
                    )
                    pieces["unary"].append((Hu, gu))
                else:
                    raise ValueError(f"schur_sqrt: unsupported slots {fb.slots}")
            pieces["free_p"] = (~pb.const_mask).astype(dtype)
            pieces["free_l"] = (~lb.const_mask).astype(dtype)
            return pieces, jnp.zeros(g.total_dof, dtype), chi2

        def solve_fn(pieces, g_unused, lam, opt):
            dtype = g_unused.dtype
            free_p = pieces["free_p"]
            free_l = pieces["free_l"]
            H = jnp.zeros((C, dp, C, dp), dtype)
            grad = jnp.zeros((C, dp), dtype)
            for Hu, gu in pieces["unary"]:
                H = H + jnp.einsum(
                    "ab,aij->aibj", jnp.eye(C, dtype=dtype), Hu
                ).reshape(C, dp, C, dp)
                grad = grad + gu

            eliminated = []
            for bk in pieces["buckets"]:
                Lb, kpad = bk["mask"].shape
                n = kpad * m + 3  # + square-root damping rows
                fl = free_l[bk["lms"]]
                # constant landmarks: zero their A block -> rows become pure
                # pose rows; R degenerates and _tri3_solve guards dx_l = 0
                A = (bk["A"] * fl[:, None, None, None]).reshape(Lb, kpad * m, dl)
                # pose columns arranged per obs slot + the residual column:
                # row group s only touches its own camera block, so expand
                # to the (Lb, kpad*m, kpad*dp) block-diagonal layout with a
                # static-index set
                Bcols = bk["B"].reshape(Lb, kpad * m, dp)
                slot_of_row = jnp.repeat(jnp.arange(kpad), m)
                Bfull = (
                    jnp.zeros((Lb, kpad * m, kpad, dp), dtype)
                    .at[:, jnp.arange(kpad * m), slot_of_row]
                    .set(Bcols)
                    .reshape(Lb, kpad * m, kpad * dp)
                )
                bb = bk["b"].reshape(Lb, kpad * m)
                Bb = jnp.concatenate([Bfull, bb[..., None]], axis=-1)

                # square-root Marquardt damping rows for the landmark block
                if opt.method == "lm":
                    colnorm = jnp.sqrt(jnp.sum(A * A, axis=1))  # (Lb, 3)
                    aug = jnp.sqrt(lam) * jnp.maximum(colnorm, 1e-12)
                else:
                    aug = jnp.zeros((Lb, dl), dtype)
                A_aug = jnp.concatenate(
                    [A, aug[:, :, None] * jnp.eye(dl, dtype=dtype)[None]], axis=1
                )
                Bb_aug = jnp.concatenate(
                    [Bb, jnp.zeros((Lb, dl, Bb.shape[-1]), dtype)], axis=1
                )
                A_t, Bb_t = _householder_eliminate(A_aug, Bb_aug)
                R = A_t[:, :3, :3]
                B_top = Bb_t[:, :3, :-1].reshape(Lb, 3, kpad, dp)
                b_top = Bb_t[:, :3, -1]
                B_red = Bb_t[:, 3:, :-1].reshape(Lb, n - 3, kpad, dp)
                b_red = Bb_t[:, 3:, -1]

                # reduced-system contributions (dense camera blocks)
                Mab = jnp.einsum("lnai,lnbj->labij", B_red, B_red)
                gab = -jnp.einsum("lnai,ln->lai", B_red, b_red)
                cams = bk["cams"]  # (Lb, kpad)
                ia = cams[:, :, None] * jnp.ones((1, 1, kpad), jnp.int32)
                ib = cams[:, None, :] * jnp.ones((1, kpad, 1), jnp.int32)
                # advanced-index scatter: value [l,a,b,i,j] -> H[ca, i, cb, j]
                H = H.at[ia, :, ib, :].add(Mab)
                grad = grad.at[cams].add(gab)
                eliminated.append((bk, R, B_top, b_top, fl))

            # frozen poses + pose damping on the dense reduced system
            Hm = H.reshape(C * dp, C * dp)
            fp = jnp.repeat(free_p, dp)
            Hm = Hm * fp[:, None] * fp[None, :] + jnp.diag(1.0 - fp)
            # dead pose dofs (cameras with no observations)
            Hm = Hm + jnp.diag((jnp.diagonal(Hm) == 0.0).astype(dtype))
            if opt.method == "lm":
                dd = jnp.maximum(jnp.diagonal(Hm), 1e-12)
                Hm = Hm + lam * jnp.diag(dd)
            gv = (grad * free_p[:, None]).reshape(-1)
            dx_p = cholesky_solve(Hm, gv).reshape(C, dp) * free_p[:, None]

            # landmark back-substitution per bucket
            dx_l = jnp.zeros((plan.L, dl), dtype)
            for bk, R, B_top, b_top, fl in eliminated:
                dxp_g = dx_p[bk["cams"]]  # (Lb, kpad, dp)
                rhs = -b_top - jnp.einsum("lrkd,lkd->lr", B_top, dxp_g)
                dx_l = dx_l.at[bk["lms"]].set(_tri3_solve(R, rhs, fl))

            segs = [dx_p.reshape(-1), dx_l.reshape(-1)]
            return jnp.concatenate(segs if plan.pose_first else segs[::-1])

        _CLOSURES[key] = (assemble_fn, solve_fn)
    assemble_fn, solve_fn = _CLOSURES[key]
    return _lm.solve(graph, options, assemble_fn=assemble_fn, solve_fn=solve_fn)


_CLOSURES = ClosureCache()

__all__ = ["solve_schur_sqrt", "build_sqrt_plan", "SqrtBAPlan"]
