"""Posterior covariance — the on-device replacement for the reference's
``Problem.compute_covariance`` full-inverse (pyslam/problem.py, SURVEY.md
§3.4 "the device equivalent is covariance columns via selective solves").

Two paths:
  * ``full_covariance``      — dense (J^T W J)^-1 by Cholesky solves against
    identity columns (small/medium problems; what Problem.compute_covariance
    uses).
  * ``marginal_covariances`` — the (dof x dof) diagonal blocks of H^-1 for a
    selected set of variables, via PCG selective solves on the block-sparse
    system: cost scales with (#requested x dof) CG solves, never forming the
    inverse.  vmapped over right-hand sides so all columns converge in one
    fused while_loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.core import FactorGraph
from .assemble import assemble_dense
from .bcsr import build_ell_direct, assemble_ell, sym_block_inv
from .linear import cholesky_solve, pcg_solve


def full_covariance(graph: FactorGraph):
    """(D, D) posterior covariance over the free tangent space (constant
    parameters and dead dofs get unit rows from the masking, harmlessly)."""
    from .assemble import unit_diag_where_dead

    H, _, _ = assemble_dense(graph)
    H = unit_diag_where_dead(H)
    return cholesky_solve(H, jnp.eye(H.shape[0], dtype=H.dtype))


def _ell_col_solver(graph: FactorGraph, block_name: str, pcg_rtol, pcg_max_iters):
    """Shared selective-solve closure over the single-block ELL system:
    solve_col(col_idx) -> column of H^-1."""
    blk = graph.blocks[block_name]
    d = blk.dof
    plan = build_ell_direct(graph, block_name)
    He, _, _ = assemble_ell(graph, plan)
    nb = plan.nb
    cols = jnp.asarray(plan.cols)
    Minv = sym_block_inv(He[:, 0])

    def matvec(x):
        xg = x.reshape(nb, d)[cols]
        return jnp.einsum("rkij,rkj->ri", He, xg).reshape(-1)

    def precond(r):
        return jnp.einsum("nij,nj->ni", Minv, r.reshape(nb, d)).reshape(-1)

    D = nb * d

    def solve_col(col_idx):
        e = jnp.zeros(D, He.dtype).at[col_idx].set(1.0)
        x, _ = pcg_solve(matvec, e, precond=precond, rtol=pcg_rtol, max_iters=pcg_max_iters)
        return x

    return solve_col, nb, d


def marginal_covariances(
    graph: FactorGraph,
    block_name: str | None = None,
    indices=None,
    pcg_rtol: float = 1e-8,
    pcg_max_iters: int = 500,
):
    """(k, dof, dof) marginal covariance blocks of the selected variables.

    Solves H x = e_j for each tangent column j of each requested variable
    with block-Jacobi PCG over the ELL system — no dense Hessian, no
    inverse.  Suitable for sphere2500-scale graphs where a dense (D, D)
    inverse is not.
    """
    if block_name is None:
        (block_name,) = graph.blocks.keys()
    blk = graph.blocks[block_name]
    d = blk.dof
    if indices is None:
        indices = np.arange(blk.n)
    indices = np.asarray(indices)

    solve_col, nb, d = _ell_col_solver(graph, block_name, pcg_rtol, pcg_max_iters)
    # offset of this block in the global tangent layout
    off = graph.offsets()[block_name]

    col_ids = (off + indices[:, None] * d + np.arange(d)[None, :]).reshape(-1)
    # Chunk the vmap: each solved column is a full (nb*d,) vector, so
    # vmapping all k*d requested columns at once materializes a
    # (k*d, nb*d) intermediate — the full-inverse footprint the selective
    # design exists to avoid.  A few hundred columns per dispatch keeps the
    # peak at (chunk, D) while still batching the PCG while_loops.
    chunk = max(d, 256 - 256 % d)  # multiple of d so variables never split
    col_ids = jnp.asarray(col_ids, jnp.int32)
    if len(col_ids) <= chunk:
        X = jax.vmap(solve_col)(col_ids)  # (k*d, D)
    else:
        pieces = []
        for s in range(0, len(col_ids), chunk):
            pieces.append(jax.vmap(solve_col)(col_ids[s : s + chunk]))
        X = jnp.concatenate(pieces, axis=0)
    X = X.reshape(len(indices), d, nb, d)
    rows = jnp.asarray(indices, jnp.int32)
    out = X[jnp.arange(len(indices)), :, rows, :]  # (k, d, d)
    return 0.5 * (out + jnp.swapaxes(out, -1, -2))


def covariance_block(
    graph: FactorGraph,
    i: int,
    j: int,
    block_name: str | None = None,
    pcg_rtol: float = 1e-10,
    pcg_max_iters: int = 500,
):
    """(dof, dof) cross-covariance block of H^-1 between elements ``i`` and
    ``j`` of a single-block graph, by ``dof`` selective column solves — the
    large-graph route for ``Problem.get_covariance_block`` (never forms a
    dense (D, D))."""
    if block_name is None:
        (block_name,) = graph.blocks.keys()
    solve_col, nb, d = _ell_col_solver(graph, block_name, pcg_rtol, pcg_max_iters)
    cols = jnp.asarray(j * d + np.arange(d), jnp.int32)
    X = jax.vmap(solve_col)(cols)  # (d, D) columns of H^-1 for element j
    return jnp.swapaxes(X.reshape(d, nb, d)[:, i, :], 0, 1)  # rows i -> (d, d)


def _plan_and_factors(graph, block_name, plan, leaf_size, factors=None):
    """Shared head of the direct-covariance entry points: resolve the
    block, build/reuse the multifrontal plan, assemble, factorize (or
    reuse caller-provided factors for repeated online queries)."""
    from .sparse_chol import _factorize, build_chol_plan

    if block_name is None:
        (block_name,) = graph.blocks.keys()
    if plan is None:
        plan = build_chol_plan(graph, block_name, leaf_size=leaf_size)
    if factors is None:
        He, _, _ = assemble_ell(graph, plan.ell)
        factors = _factorize(plan, He)
    return block_name, plan, factors


def marginal_covariances_direct(
    graph: FactorGraph,
    block_name: str | None = None,
    indices=None,
    plan=None,
    leaf_size: int = 32,
    factors=None,
):
    """(k, dof, dof) marginal covariance blocks via the multifrontal sparse
    direct factorization (solver/sparse_chol.py): factor H once, then each
    tangent column of H^-1 is two level-scheduled triangular solves — EXACT
    (no PCG tolerance) and O(fill) memory.  The right choice whenever a
    CholPlan is affordable (stiff/mid-size graphs; the same regimes
    solve_auto routes to sparse_chol)."""
    from .sparse_chol import _solve_factored, selected_inverse_marginals

    block_name, plan, factors = _plan_and_factors(
        graph, block_name, plan, leaf_size, factors
    )
    d = graph.blocks[block_name].dof
    if indices is None:
        # ALL marginals: the Takahashi selected-inverse sweep gets every
        # diagonal block in ~2x the factorization cost — nb*d column
        # solves would be infeasible at 50k poses
        out = selected_inverse_marginals(plan, factors)
        return 0.5 * (out + jnp.swapaxes(out, -1, -2))
    indices = np.asarray(indices)
    off = graph.offsets()[block_name]
    D = plan.nb * d
    dtype = factors[0][0].dtype

    def solve_col(col_idx):
        e = jnp.zeros(D, dtype).at[col_idx].set(1.0)
        return _solve_factored(plan, factors, e)

    col_ids = (off + indices[:, None] * d + np.arange(d)[None, :]).reshape(-1)
    chunk = max(d, 128 - 128 % d)
    col_ids = jnp.asarray(col_ids, jnp.int32)
    pieces = []
    for s in range(0, len(col_ids), chunk):
        pieces.append(jax.vmap(solve_col)(col_ids[s : s + chunk]))
    X = jnp.concatenate(pieces, axis=0).reshape(len(indices), d, plan.nb, d)
    rows = jnp.asarray(indices, jnp.int32)
    out = X[jnp.arange(len(indices)), :, rows, :]
    return 0.5 * (out + jnp.swapaxes(out, -1, -2))


def covariance_blocks_direct(
    graph: FactorGraph,
    pairs,
    block_name: str | None = None,
    plan=None,
    leaf_size: int = 32,
    factors=None,
):
    """((k, d, d) marginals for all variables, (len(pairs), d, d) cross
    blocks) for (u, v) pairs WITHIN THE FACTORIZATION FILL — one Takahashi
    sweep, no column solves.  Original graph edges (odometry pairs) are
    always in the fill, so this covers the classic use: relative-pose
    uncertainty Sigma_ii + Sigma_jj - Sigma_ij - Sigma_ji for loop-closure
    gating.  Out-of-fill pairs raise — use covariance_block (column
    solves) for arbitrary pairs."""
    from .sparse_chol import selected_inverse_marginals

    block_name, plan, factors = _plan_and_factors(
        graph, block_name, plan, leaf_size, factors
    )
    diag, blocks = selected_inverse_marginals(plan, factors, pairs=pairs)
    return 0.5 * (diag + jnp.swapaxes(diag, -1, -2)), blocks


def _reduced_pieces(graph, pose_name, lm_name):
    """Shared head of the two S-solvers: assembled parts, eliminated-
    landmark inverse, and the aux dict the landmark-marginal identities
    consume."""
    from .schur import _binv, ba_assemble

    parts, _, _ = ba_assemble(graph, pose_name, lm_name)
    Hpp, W = parts["Hpp"], parts["W"]
    Hll_inv = _binv(jnp.linalg.cholesky(parts["Hll"]))
    aux = dict(
        C=Hpp.shape[0], dp=Hpp.shape[1], Hll_inv=Hll_inv, W=W,
        ci=parts["cam_idx"], li=parts["pt_idx"],
    )
    return parts, Hll_inv, aux


def _schur_S_solver(graph, pose_name, lm_name, pcg_rtol, pcg_max_iters):
    """Selective-solve closures over the REDUCED camera system S = Hpp -
    W Hll^-1 W^T.  By the block-inverse identity, (H^-1)_pose-pose == S^-1,
    so pose covariances come from S-solves — no dense H, the landmark side
    stays as batched 3x3 factors (SURVEY.md §3.4 build note).

    Returns (solve_col, solve_rhs, aux) where aux carries the eliminated
    pieces (Hll_inv, W, cam/pt indices) needed by the landmark-marginal
    identity.

    Full-SLAM graphs: the pose-pose between-factor coupling (parts['PP'])
    is part of S = (H/Hll) and MUST enter the matvec — dropping it returns
    covariances of a different (odometry-free) graph.  The SCHUR_JACOBI
    preconditioner stays diagonal-only (PP off-diagonals never land on a
    diagonal block for i != j; an approximate preconditioner only costs CG
    iterations, never correctness)."""
    from .schur import _binv_apply, _seg

    parts, Hll_inv, aux = _reduced_pieces(graph, pose_name, lm_name)
    Hpp, W = parts["Hpp"], parts["W"]
    ci, li = aux["ci"], aux["li"]
    C, dp = aux["C"], aux["dp"]
    Y = jnp.einsum("mij,mjk->mik", W, Hll_inv[li])
    D_blk = Hpp - _seg(jnp.einsum("mik,mjk->mij", Y, W), ci, C)
    # Self-loop (i == j) between factors would contribute to the diagonal of
    # S; fold them into the preconditioner so it stays the exact diagonal.
    PP, pp_i, pp_j = parts["PP"], parts["pp_i"], parts["pp_j"]
    if PP.shape[0]:
        selfloop = (pp_i == pp_j).astype(PP.dtype)[:, None, None]
        sym = PP + jnp.swapaxes(PP, -1, -2)
        D_blk = D_blk + _seg(selfloop * sym, pp_i, C)
    L_d = jnp.linalg.cholesky(D_blk)

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

    def solve_rhs(b):
        x, _ = pcg_solve(matvec, b, precond=precond, rtol=pcg_rtol, max_iters=pcg_max_iters)
        return x

    def solve_col(col_idx):
        return solve_rhs(jnp.zeros(C * dp, Hpp.dtype).at[col_idx].set(1.0))

    return solve_col, solve_rhs, aux


def _schur_S_solver_sparse(graph, pose_name, lm_name, leaf_size=32):
    """EXACT variant of ``_schur_S_solver``: S assembled into symmetric ELL
    (host-enumerated co-observation pairs, solver/schur_sparse.py) and
    factored ONCE by the multifrontal Cholesky; every S-solve is then two
    level-scheduled triangular solves — no PCG tolerance in the answer.
    The right choice on many-poses/few-landmarks graphs (the same regimes
    route_auto sends to 'schur_sparse')."""
    from .schur_sparse import (
        assemble_S_ell,
        build_schur_sparse_plan,
        plan_tables,
    )
    from .sparse_chol import _factorize, _solve_factored

    parts, Hll_inv, aux = _reduced_pieces(graph, pose_name, lm_name)
    C, dp = aux["C"], aux["dp"]
    plan = build_schur_sparse_plan(graph, pose_name, lm_name, leaf_size)
    He = assemble_S_ell(
        plan, plan_tables(plan), parts["Hpp"], parts["PP"], parts["W"], Hll_inv
    )
    factors = _factorize(plan.chol, He)
    # the factored S also powers the all-poses selected-inverse shortcut
    aux["chol_plan"] = plan.chol
    aux["chol_factors"] = factors

    def solve_rhs(b):
        return _solve_factored(plan.chol, factors, b)

    def solve_col(col_idx):
        return solve_rhs(jnp.zeros(C * dp, parts["Hpp"].dtype).at[col_idx].set(1.0))

    return solve_col, solve_rhs, aux


def _S_solver(graph, pose_name, lm_name, pcg_rtol, pcg_max_iters, method):
    if method == "sparse":
        return _schur_S_solver_sparse(graph, pose_name, lm_name)
    if method != "pcg":
        raise ValueError(f"unknown S-solver method {method!r} ('pcg' | 'sparse')")
    return _schur_S_solver(graph, pose_name, lm_name, pcg_rtol, pcg_max_iters)


def pose_marginal_covariances(
    graph: FactorGraph,
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    indices=None,
    pcg_rtol: float = 1e-10,
    pcg_max_iters: int = 500,
    method: str = "pcg",
):
    """(k, dp, dp) pose marginal covariances of a BA graph from the reduced
    camera system: (H^-1)_pp = S^-1, solved per tangent column with
    SCHUR_JACOBI-preconditioned PCG.  Constant (gauge-anchor) poses return
    the unit block ba_assemble's masking gives them."""
    solve_col, _, aux = _S_solver(graph, pose_name, lm_name, pcg_rtol, pcg_max_iters, method)
    C, dp = aux["C"], aux["dp"]
    if indices is None and method == "sparse":
        # ALL pose marginals: Sigma_pp = S^-1 diag blocks, via the
        # Takahashi sweep over the factored sparse S (~2x factorization
        # cost instead of C*dp column solves)
        from .sparse_chol import selected_inverse_marginals

        out = selected_inverse_marginals(aux["chol_plan"], aux["chol_factors"])
        return 0.5 * (out + jnp.swapaxes(out, -1, -2))
    if indices is None:
        indices = np.arange(C)
    indices = np.asarray(indices)
    col_ids = (indices[:, None] * dp + np.arange(dp)[None, :]).reshape(-1)
    X = jax.vmap(solve_col)(jnp.asarray(col_ids, jnp.int32))  # (k*dp, C*dp)
    X = X.reshape(len(indices), dp, C, dp)
    rows = jnp.asarray(indices, jnp.int32)
    out = X[jnp.arange(len(indices)), :, rows, :]
    return 0.5 * (out + jnp.swapaxes(out, -1, -2))


def pose_covariance_block(
    graph: FactorGraph,
    i: int,
    j: int,
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    pcg_rtol: float = 1e-10,
    pcg_max_iters: int = 500,
    method: str = "pcg",
):
    """(dp, dp) pose-pose cross-covariance block (S^-1)_ij of a BA graph."""
    solve_col, _, aux = _S_solver(graph, pose_name, lm_name, pcg_rtol, pcg_max_iters, method)
    C, dp = aux["C"], aux["dp"]
    cols = jnp.asarray(j * dp + np.arange(dp), jnp.int32)
    X = jax.vmap(solve_col)(cols)
    return jnp.swapaxes(X.reshape(dp, C, dp)[:, i, :], 0, 1)


def _landmark_B(aux, i):
    """B_i = [W Hll^-1] block-column i as a (C*dp, dl) array (nonzero only
    at the cameras observing landmark i), plus (Hll^-1)_ii."""
    C, dp = aux["C"], aux["dp"]
    Hll_inv, W = aux["Hll_inv"], aux["W"]
    ci = np.asarray(aux["ci"])
    li = np.asarray(aux["li"])
    dl = Hll_inv.shape[-1]
    sel = np.nonzero(li == int(i))[0]
    Hi = Hll_inv[int(i)]
    if len(sel) == 0:
        return None, Hi
    Wm = W[jnp.asarray(sel, jnp.int32)]  # (k_obs, dp, dl)
    Bm = jnp.einsum("mij,jk->mik", Wm, Hi)
    B = (
        jnp.zeros((C, dp, dl), W.dtype)
        .at[jnp.asarray(ci[sel], jnp.int32)]
        .add(Bm)
        .reshape(C * dp, dl)
    )
    return B, Hi


def landmark_marginal_covariances(
    graph: FactorGraph,
    indices,
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    pcg_rtol: float = 1e-10,
    pcg_max_iters: int = 500,
    method: str = "pcg",
):
    """(k, dl, dl) landmark marginal covariances of a BA graph via the
    block-inverse identity Sigma_ll,ii = (Hll^-1)_ii + B_i^T S^-1 B_i,
    where B_i = [W Hll^-1] block-column i (nonzero only at the cameras
    observing landmark i).  dl S-solves per requested landmark; no dense H."""
    _, solve_rhs, aux = _S_solver(graph, pose_name, lm_name, pcg_rtol, pcg_max_iters, method)
    out = []
    for i in indices:
        B, Hi = _landmark_B(aux, i)
        if B is None:
            out.append(Hi)  # unobserved: masked unit block from ba_assemble
            continue
        X = jax.vmap(solve_rhs, in_axes=1, out_axes=1)(B)  # (C*dp, dl)
        cov = Hi + B.T @ X
        out.append(0.5 * (cov + cov.T))
    return jnp.stack(out)


def landmark_covariance_block(
    graph: FactorGraph,
    lm_i: int,
    lm_j: int,
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    pcg_rtol: float = 1e-10,
    pcg_max_iters: int = 500,
    method: str = "pcg",
):
    """(dl, dl) landmark-landmark covariance block of H^-1 (cross blocks
    included): by the block-inverse identity,

        Sigma_ll',ij = delta_ij (Hll^-1)_i + B_i^T S^-1 B_j

    with B_k = [W Hll^-1] block-column k — one step past the marginal
    (i == j) case, sharing _landmark_B and the S-solver (reference covers
    this via its full inverse, SURVEY.md §3.4)."""
    _, solve_rhs, aux = _S_solver(graph, pose_name, lm_name, pcg_rtol, pcg_max_iters, method)
    Bi, Hi = _landmark_B(aux, lm_i)
    Bj, Hj = _landmark_B(aux, lm_j)
    delta = Hi if lm_i == lm_j else jnp.zeros((Hi.shape[-1], Hj.shape[-1]), Hi.dtype)
    if Bi is None or Bj is None:
        return delta  # an unobserved landmark is decoupled from everything
    X = jax.vmap(solve_rhs, in_axes=1, out_axes=1)(Bj)  # S^-1 B_j, (C*dp, dl)
    cov = delta + Bi.T @ X
    if lm_i == lm_j:
        cov = 0.5 * (cov + cov.T)
    return cov


def pose_landmark_covariance_block(
    graph: FactorGraph,
    pose_i: int,
    lm_j: int,
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    pcg_rtol: float = 1e-10,
    pcg_max_iters: int = 500,
    method: str = "pcg",
):
    """(dp, dl) pose-landmark cross-covariance block of H^-1: by the block
    inverse, Sigma_pl = -S^-1 [W Hll^-1], so the block is the pose-i rows
    of -S^-1 B_j — the same dl S-solves as the landmark marginal."""
    _, solve_rhs, aux = _S_solver(graph, pose_name, lm_name, pcg_rtol, pcg_max_iters, method)
    dp = aux["dp"]
    B, Hi = _landmark_B(aux, lm_j)
    if B is None:
        return jnp.zeros((dp, Hi.shape[-1]), Hi.dtype)  # unobserved: decoupled
    X = jax.vmap(solve_rhs, in_axes=1, out_axes=1)(B)  # (C*dp, dl)
    return -X[pose_i * dp : (pose_i + 1) * dp, :]


__all__ = [
    "full_covariance",
    "marginal_covariances",
    "marginal_covariances_direct",
    "covariance_block",
    "pose_marginal_covariances",
    "pose_covariance_block",
    "landmark_marginal_covariances",
    "landmark_covariance_block",
    "pose_landmark_covariance_block",
]
