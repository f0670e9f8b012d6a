"""Schur-complement bundle adjustment: landmark marginalization on-device.

On-device replacement for what the reference cannot do at all — its
``Problem`` sends the full (poses + landmarks) system to scipy's spsolve
(pyslam/problem.py, SURVEY.md §3.1 hot loop 3), which is infeasible beyond toy
BA.  Here the landmark block-diagonal ``Hll`` (3x3 blocks) is eliminated in
one batched pass and only the reduced camera system ``S`` is solved
(SURVEY.md §2.2 / §7 M3; BASELINE.json configs #4/#5):

    S       = Hpp - Hpl Hll^-1 Hlp
    g_red   = g_p - Hpl Hll^-1 g_l
    S dx_p  = g_red
    dx_l    = Hll^-1 (g_l - Hlp dx_p)

Two linear-solve modes, both sharing the jitted LM trust-region loop
(lm.solve):

  * ``mode='dense'``  — materialize S (6C x 6C) via one einsum over the
    observation blocks and factorize with dense Cholesky.  Right for
    C <= a few thousand cameras (config #4: 49 cams -> S is 294 x 294).
  * ``mode='pcg'``    — never materialize S: implicit Schur matvec
    (two gathers + two segment-sums + batched 3x3 solves per application)
    with the exact SCHUR_JACOBI block preconditioner.  Right for
    Venice-class problems and the multi-host path (config #5).

Everything (Hpp/Hll/W assembly, elimination, solve, back-substitution) is
inside the LM ``lax.while_loop`` — zero host round-trips per iteration.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from ..graph.core import FactorGraph
from .assemble import linearize_batch
from .linear import pcg_solve
from . import lm as _lm


def _seg(vals, idx, n):
    """Segment-sum over the leading axis."""
    return jax.ops.segment_sum(vals, idx, num_segments=n)


def _binv_apply(L, x):
    """Solve A y = x for batched SPD A given its Cholesky factors L."""
    y = solve_triangular(L, x[..., None], lower=True)[..., 0]
    return solve_triangular(jnp.swapaxes(L, -1, -2), y[..., None], lower=False)[..., 0]


def _binv(L):
    """Explicit batched inverse from Cholesky factors."""
    eye = jnp.broadcast_to(jnp.eye(L.shape[-1], dtype=L.dtype), L.shape)
    Y = solve_triangular(L, eye, lower=True)
    return solve_triangular(jnp.swapaxes(L, -1, -2), Y, lower=False)


def ba_assemble(graph: FactorGraph, pose_name: str = "poses", lm_name: str = "landmarks"):
    """Block-structured normal equations for a camera/landmark graph.

    Returns ``(parts, g, chi2)`` where ``parts`` carries the block pieces
    (Hpp (C,dp,dp), Hll (L,dl,dl), per-observation coupling W (M,dp,dl) with
    its cam/landmark index arrays, g_p, g_l) and ``g`` is the concatenated
    global gradient — the same ``assemble_fn`` contract as the dense path, so
    lm.solve drives it unchanged.

    Supported batch shapes: (pose,) unary factors -> Hpp; (landmark,) unary
    -> Hll; (pose, landmark) binary reprojection -> Hpp + Hll + W.  Multiple
    binary batches are concatenated into one observation list.
    """
    pb = graph.blocks[pose_name]
    lb = graph.blocks[lm_name]
    C, dp = pb.n, pb.dof
    L, dl = lb.n, lb.dof
    dtype = pb.values.dtype

    Hpp = jnp.zeros((C, dp, dp), dtype)
    Hll = jnp.zeros((L, dl, dl), dtype)
    g_p = jnp.zeros((C, dp), dtype)
    g_l = jnp.zeros((L, dl), dtype)
    chi2 = jnp.zeros((), dtype)
    Ws, cam_ids, pt_ids = [], [], []
    PPs, pp_is, pp_js = [], [], []  # pose-pose off-diagonal coupling

    for fb in graph.batches:
        r, jacs, w, c2 = linearize_batch(fb, graph.blocks)
        chi2 = chi2 + c2
        wr = w * r
        if fb.slots == (pose_name, lm_name):
            Jc, Jl = jacs
            ci, li = fb.indices
            Hpp = Hpp + _seg(jnp.einsum("fmi,fm,fmj->fij", Jc, w, Jc), ci, C)
            Hll = Hll + _seg(jnp.einsum("fmi,fm,fmj->fij", Jl, w, Jl), li, L)
            g_p = g_p - _seg(jnp.einsum("fmi,fm->fi", Jc, wr), ci, C)
            g_l = g_l - _seg(jnp.einsum("fmi,fm->fi", Jl, wr), li, L)
            Ws.append(jnp.einsum("fmi,fm,fmj->fij", Jc, w, Jl))
            cam_ids.append(ci)
            pt_ids.append(li)
        elif fb.slots == (pose_name,):
            (J,) = jacs
            (ci,) = fb.indices
            Hpp = Hpp + _seg(jnp.einsum("fmi,fm,fmj->fij", J, w, J), ci, C)
            g_p = g_p - _seg(jnp.einsum("fmi,fm->fi", J, wr), ci, C)
        elif fb.slots == (lm_name,):
            (J,) = jacs
            (li,) = fb.indices
            Hll = Hll + _seg(jnp.einsum("fmi,fm,fmj->fij", J, w, J), li, L)
            g_l = g_l - _seg(jnp.einsum("fmi,fm->fi", J, wr), li, L)
        elif fb.slots == (pose_name, pose_name):
            # full-SLAM graphs: odometry / loop-closure factors between
            # poses alongside the landmark observations.  Diagonal blocks
            # fold into Hpp; the off-diagonal pose-pose coupling is kept as
            # per-factor blocks applied in the S solve (dense scatter or
            # two segment-sums per implicit matvec).
            Ja, Jb = jacs
            pi, pj = fb.indices
            Hpp = Hpp + _seg(jnp.einsum("fmi,fm,fmj->fij", Ja, w, Ja), pi, C)
            Hpp = Hpp + _seg(jnp.einsum("fmi,fm,fmj->fij", Jb, w, Jb), pj, C)
            g_p = g_p - _seg(jnp.einsum("fmi,fm->fi", Ja, wr), pi, C)
            g_p = g_p - _seg(jnp.einsum("fmi,fm->fi", Jb, wr), pj, C)
            PPs.append(jnp.einsum("fmi,fm,fmj->fij", Ja, w, Jb))
            pp_is.append(pi)
            pp_js.append(pj)
        else:
            raise ValueError(
                f"Schur path: unsupported slot pattern {fb.slots}; expected "
                f"({pose_name},), ({lm_name},), ({pose_name}, {pose_name}) "
                f"or ({pose_name}, {lm_name})"
            )

    W = jnp.concatenate(Ws, axis=0) if Ws else jnp.zeros((0, dp, dl), dtype)
    cam_idx = jnp.concatenate(cam_ids) if cam_ids else jnp.zeros(0, jnp.int32)
    pt_idx = jnp.concatenate(pt_ids) if pt_ids else jnp.zeros(0, jnp.int32)
    PP = jnp.concatenate(PPs, axis=0) if PPs else jnp.zeros((0, dp, dp), dtype)
    pp_i = jnp.concatenate(pp_is) if pp_is else jnp.zeros(0, jnp.int32)
    pp_j = jnp.concatenate(pp_js) if pp_js else jnp.zeros(0, jnp.int32)

    # Constant variables: zero their blocks everywhere, unit diagonal so the
    # factorizations stay SPD and their tangent update is exactly 0
    # (reference set_parameters_constant semantics, pyslam/problem.py).
    free_p = (~pb.const_mask).astype(dtype)
    free_l = (~lb.const_mask).astype(dtype)
    eye_p = jnp.eye(dp, dtype=dtype)
    eye_l = jnp.eye(dl, dtype=dtype)
    Hpp = Hpp * free_p[:, None, None] + (1.0 - free_p)[:, None, None] * eye_p
    g_p = g_p * free_p[:, None]
    g_l = g_l * free_l[:, None]
    # Unobserved free landmarks (all-zero Hll block) also get a unit diagonal:
    # their g_l is 0, so dx_l = 0 and they are inert.
    dead_l = (jnp.einsum("nii->n", Hll) == 0.0).astype(dtype)
    live_l = free_l * (1.0 - dead_l)
    Hll = Hll * live_l[:, None, None] + (1.0 - live_l)[:, None, None] * eye_l
    W = W * free_p[cam_idx][:, None, None] * live_l[pt_idx][:, None, None]
    PP = PP * free_p[pp_i][:, None, None] * free_p[pp_j][:, None, None]

    # Global tangent layout follows the graph's (sorted) block order; record
    # it as a static flag so the solve modes concatenate dx consistently.
    names = list(graph.blocks)
    pose_first = names.index(pose_name) < names.index(lm_name)
    parts = dict(
        Hpp=Hpp, Hll=Hll, W=W, g_p=g_p, g_l=g_l, cam_idx=cam_idx, pt_idx=pt_idx,
        PP=PP, pp_i=pp_i, pp_j=pp_j,
        # array (not Python bool): parts is carried through lax.while_loop
        # state by the speculative LM loop, so every leaf must be a tracer-
        # compatible array
        pose_first=jnp.asarray(pose_first),
    )
    segs = [g_p.reshape(-1), g_l.reshape(-1)]
    g = jnp.concatenate(segs if pose_first else segs[::-1])
    return parts, g, chi2


def _concat_dx(parts, dx_p, dx_l):
    segs = [dx_p.reshape(-1), dx_l.reshape(-1)]
    return jnp.where(
        parts["pose_first"],
        jnp.concatenate(segs),
        jnp.concatenate(segs[::-1]),
    )


def _damp_blocks(H, lam, floor=1e-12):
    """Marquardt damping per diagonal block: H_ii += lam * diag(H_ii)."""
    d = jnp.maximum(jnp.einsum("nii->ni", H), floor)
    eye = jnp.eye(H.shape[-1], dtype=H.dtype)
    return H + lam * d[:, :, None] * eye[None]


def _schur_reduce(parts, lam, method):
    """Damp, factorize Hll, and form the reduced RHS.  Returns the pieces the
    solve modes share."""
    Hpp, Hll = parts["Hpp"], parts["Hll"]
    if method == "lm":
        Hpp = _damp_blocks(Hpp, lam)
        Hll = _damp_blocks(Hll, lam)
    W, ci, li = parts["W"], parts["cam_idx"], parts["pt_idx"]
    C = Hpp.shape[0]
    L_ll = jnp.linalg.cholesky(Hll)
    # reduced gradient: g_p - W Hll^-1 g_l  (per-observation gather/scatter)
    t = _binv_apply(L_ll, parts["g_l"])
    g_red = parts["g_p"] - _seg(jnp.einsum("mij,mj->mi", W, t[li]), ci, C)
    return Hpp, L_ll, W, ci, li, g_red


def _back_substitute(L_ll, W, ci, li, g_l, dx_p):
    """dx_l = Hll^-1 (g_l - W^T dx_p), per-landmark batched."""
    L = g_l.shape[0]
    t = g_l - _seg(jnp.einsum("mij,mi->mj", W, dx_p[ci]), li, L)
    return _binv_apply(L_ll, t)


def schur_solve_dense(parts, g, lam, opt: _lm.Options):
    """Materialized-S path: S built by scattering per-landmark outer products
    of the coupling blocks (one einsum per term), dense Cholesky solve."""
    Hpp, L_ll, W, ci, li, g_red = _schur_reduce(parts, lam, opt.method)
    C, dp = Hpp.shape[0], Hpp.shape[1]
    # Y_m = W_m Hll^-1_{l_m}  (M, dp, dl)
    Hll_inv = _binv(L_ll)
    Y = jnp.einsum("mij,mjk->mik", W, Hll_inv[li])
    # S = blockdiag(Hpp) - sum over landmark-sharing obs pairs Y_a W_b^T.
    # Materialize the per-landmark accumulations U_l = sum_{m in l} W_m and
    # V_l = sum_{m in l} Y_m?  No: that is wrong for pairs (needs per-pair
    # products).  Correct dense form: Hpl (C*dp, L*dl) scattered, then
    # S = Hpp_dense - Hpl (Hll^-1 blockdiag) Hpl^T via two matmuls.
    L_n, dl = Hll_inv.shape[0], Hll_inv.shape[-1]
    Hpl = jnp.zeros((C, dp, L_n, dl), Hpp.dtype)
    Hpl = Hpl.at[ci, :, li, :].add(W)
    Hpl2 = Hpl.reshape(C * dp, L_n, dl)
    Ypl = jnp.einsum("alk,lkj->alj", Hpl2, Hll_inv)  # Hpl Hll^-1
    S = -jnp.einsum("alk,blk->ab", Ypl, Hpl2)
    S = S.reshape(C, dp, C, dp)
    S = S + jnp.einsum("ab,aij->aibj", jnp.eye(C, dtype=Hpp.dtype), Hpp).reshape(
        C, dp, C, dp
    )
    # pose-pose off-diagonal coupling (full-SLAM graphs: between factors)
    PP, pp_i, pp_j = parts["PP"], parts["pp_i"], parts["pp_j"]
    if PP.shape[0]:
        S = S.at[pp_i, :, pp_j, :].add(PP)
        S = S.at[pp_j, :, pp_i, :].add(jnp.swapaxes(PP, -1, -2))
    S = S.reshape(C * dp, C * dp)
    L_s = jnp.linalg.cholesky(S)
    y = solve_triangular(L_s, g_red.reshape(-1), lower=True)
    dx_p = solve_triangular(L_s.T, y, lower=False).reshape(C, dp)
    dx_l = _back_substitute(L_ll, W, ci, li, parts["g_l"], dx_p)
    return _concat_dx(parts, dx_p, dx_l)


def schur_solve_pcg(parts, g, lam, opt: _lm.Options, rtol=1e-8, max_iters=200):
    """Implicit-S path: PCG on S without materializing it.  One S-matvec is
    two gathers + two segment-sums + a batched 3x3 triangular solve pair.
    Preconditioner: exact SCHUR_JACOBI diagonal blocks of S."""
    Hpp, L_ll, W, ci, li, g_red = _schur_reduce(parts, lam, opt.method)
    C, dp = Hpp.shape[0], Hpp.shape[1]
    Hll_inv = _binv(L_ll)

    # Exact block diagonal of S: D_c = Hpp_c - sum_{m: cam_m = c} Y_m W_m^T
    # (cross terms vanish because a camera observes a landmark at most once;
    # a duplicate observation only makes the preconditioner approximate,
    # never the solve wrong).
    Y = jnp.einsum("mij,mjk->mik", W, Hll_inv[li])
    D = Hpp - _seg(jnp.einsum("mik,mjk->mij", Y, W), ci, C)
    L_d = jnp.linalg.cholesky(D)

    PP, pp_i, pp_j = parts["PP"], parts["pp_i"], parts["pp_j"]

    def matvec(x):
        xb = x.reshape(C, dp)
        y = jnp.einsum("cij,cj->ci", Hpp, xb)
        if PP.shape[0]:  # pose-pose coupling (full-SLAM between factors)
            y = y + _seg(jnp.einsum("eij,ej->ei", PP, xb[pp_j]), pp_i, C)
            y = y + _seg(jnp.einsum("eij,ei->ej", PP, xb[pp_i]), pp_j, C)
        t = _seg(jnp.einsum("mij,mi->mj", W, xb[ci]), li, Hll_inv.shape[0])
        t = jnp.einsum("lij,lj->li", Hll_inv, t)
        y = y - _seg(jnp.einsum("mij,mj->mi", W, t[li]), ci, C)
        return y.reshape(-1)

    def precond(r):
        return _binv_apply(L_d, r.reshape(C, dp)).reshape(-1)

    dx_p, _ = pcg_solve(
        matvec, g_red.reshape(-1), precond=precond, rtol=rtol, max_iters=max_iters
    )
    dx_p = dx_p.reshape(C, dp)
    dx_l = _back_substitute(L_ll, W, ci, li, parts["g_l"], dx_p)
    return _concat_dx(parts, dx_p, dx_l)


# Closure cache: one jitted LM loop per (mode, pcg params).
_CLOSURES: dict = {}


def solve_schur(
    graph: FactorGraph,
    options: _lm.Options = _lm.Options(),
    mode: str = "dense",
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    pcg_rtol: float = 1e-8,
    pcg_max_iters: int = 200,
):
    """GN/LM bundle adjustment with Schur-complement linear solves.

    The returned dx follows the graph's canonical (sorted-name) tangent
    layout — ba_assemble records the order so both modes match it.
    """
    key = (mode, pose_name, lm_name, pcg_rtol, pcg_max_iters)
    if key not in _CLOSURES:
        assemble_fn = partial(ba_assemble, pose_name=pose_name, lm_name=lm_name)
        if mode == "dense":
            solve_fn = schur_solve_dense
        elif mode == "pcg":
            solve_fn = partial(
                schur_solve_pcg, rtol=pcg_rtol, max_iters=pcg_max_iters
            )
        else:
            raise ValueError(f"unknown Schur mode {mode!r}")
        _CLOSURES[key] = (assemble_fn, solve_fn)
    assemble_fn, solve_fn = _CLOSURES[key]
    return _lm.solve(graph, options, assemble_fn=assemble_fn, solve_fn=solve_fn)
