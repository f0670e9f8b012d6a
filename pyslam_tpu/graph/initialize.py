"""Pose-graph initialization: spanning-tree odometry integration.

g2o files in the wild sometimes carry poor (or no) vertex estimates; LM from
a bad basin can converge to the wrong optimum (seen on M3500-class
graphs).  This module builds an initial guess by
integrating the relative-pose measurements along a breadth-first spanning
tree of the graph — the standard cheap initializer.

Host-side numpy (runs once at build time).
"""

from __future__ import annotations

from collections import deque

import numpy as np


def spanning_tree_init(
    edges_i, edges_j, T_meas, n_poses: int, root: int = 0, T_root=None
):
    """Initial poses by BFS spanning-tree integration of edge measurements.

    ``T_meas[k]`` is the usual between-factor measurement T_j_i (pose i
    expressed in pose j's frame), matching io.synth / io.g2o conventions:
    along a tree edge i->j, ``T_j = T_meas[k] @ T_i``.

    Returns (N, d+1, d+1) poses; unreachable poses get the root pose.
    """
    edges_i = np.asarray(edges_i)
    edges_j = np.asarray(edges_j)
    T_meas = np.asarray(T_meas)
    dim = T_meas.shape[-1]
    if T_root is None:
        T_root = np.eye(dim)

    # adjacency with edge ids and direction
    adj: list[list] = [[] for _ in range(n_poses)]
    for k, (i, j) in enumerate(zip(edges_i, edges_j)):
        adj[int(i)].append((int(j), k, False))
        adj[int(j)].append((int(i), k, True))

    T = np.tile(np.asarray(T_root, np.float64), (n_poses, 1, 1))
    seen = np.zeros(n_poses, bool)
    seen[root] = True
    q = deque([root])
    T_inv = {}
    while q:
        u = q.popleft()
        for v, k, reverse in adj[u]:
            if seen[v]:
                continue
            seen[v] = True
            if reverse:
                if k not in T_inv:
                    T_inv[k] = np.linalg.inv(T_meas[k])
                T[v] = T_inv[k] @ T[u]
            else:
                T[v] = T_meas[k] @ T[u]
            q.append(v)
    return T


def _project_rotations(R):
    """Nearest SO(d) projection of a batch of (N, d, d) matrices (SVD)."""
    U, _, Vt = np.linalg.svd(R)
    Rp = U @ Vt
    # fix improper rotations: flip the smallest singular direction
    neg = np.linalg.det(Rp) < 0
    if neg.any():
        U = U.copy()
        U[neg, :, -1] *= -1.0
        Rp[neg] = U[neg] @ Vt[neg]
    return Rp


def chordal_init(
    edges_i,
    edges_j,
    T_meas,
    n_poses: int,
    anchor: int = 0,
    T_anchor=None,
    dtype=None,
    pcg_rtol: float = 1e-6,
    pcg_max_iters: int = 250,
):
    """Chordal initialization (Carlone et al., ICRA 2015; the init g2o and
    SE-Sync ship): relax rotations to arbitrary d x d matrices, solve the
    LINEAR least squares  sum_k || R_j - R_meas_k R_i ||_F^2, project each
    solution to SO(d), then recover translations from the second linear
    system  sum_k || t_j - R_meas_k t_i - t_meas_k ||^2  with rotations
    fixed.  Far closer to the basin of the optimum than odometry/spanning
    -tree integration on loopy graphs, so LM needs fewer iterations.

    Device-side: both stages are FactorGraphs over euclidean blocks
    (``chordal_rot`` / ``chordal_trans`` kernels, graph/factor_defs.py)
    solved by the standard dispatch (dense Cholesky / ELL PCG / sparse
    Cholesky) — one exact GN step per stage; only the SVD projection runs
    on host.

    Returns (n_poses, d+1, d+1) float64 poses.
    """
    import jax.numpy as jnp

    from ..losses import L2Loss
    from ..solver import Options, solve_auto
    from ..solver.bcsr import solve_ell
    from .core import FactorBatch, FactorGraph, VariableBlock

    def _solve_stage(g, opts):
        # dense exact below the usual ceiling; ELL PCG above.  Deliberately
        # NOT route_auto: it sends large 3-dof euclidean blocks to the
        # multifrontal path, whose planning cost (and, on 3D topologies,
        # fill) is absurd for
        # a one-shot initializer that tolerates rtol 1e-6.
        if g.total_dof <= 12000:
            return solve_auto(g, opts)
        return solve_ell(g, opts, pcg_rtol=pcg_rtol, pcg_max_iters=pcg_max_iters)

    edges_i = np.asarray(edges_i)
    edges_j = np.asarray(edges_j)
    T_meas = np.asarray(T_meas, np.float64)
    d = T_meas.shape[-1] - 1
    R_meas = T_meas[:, :d, :d]
    t_meas = T_meas[:, :d, d]
    if T_anchor is None:
        T_anchor = np.eye(d + 1)
    if dtype is None:
        dtype = jnp.float64 if jnp.zeros(0).dtype == jnp.float64 else jnp.float32
    const = np.zeros(n_poses, bool)
    const[anchor] = True
    opts = Options(method="gn", max_iters=3, min_cost_decrease=0.999)

    # ---- stage 1: rotation relaxation (d*d-dof euclidean variables) ----
    x0 = np.tile(np.eye(d).T.reshape(-1), (n_poses, 1))
    x0[anchor] = np.asarray(T_anchor[:d, :d]).T.reshape(-1)
    g_rot = FactorGraph(
        {"rot": VariableBlock.create("euclidean", jnp.asarray(x0, dtype), const)},
        [
            FactorBatch.create(
                kind="chordal_rot",
                slots=("rot", "rot"),
                indices=(edges_i, edges_j),
                data={"R_meas": jnp.asarray(R_meas, dtype)},
                loss=L2Loss(),
            )
        ],
    )
    solved_rot, _ = solve_auto(g_rot, opts)
    X = np.asarray(solved_rot.blocks["rot"].values, np.float64).reshape(n_poses, d, d)
    R = _project_rotations(np.swapaxes(X, -1, -2))
    R[anchor] = T_anchor[:d, :d]

    # ---- stage 2: translation recovery with rotations fixed ----
    t0 = np.zeros((n_poses, d))
    t0[anchor] = T_anchor[:d, d]
    g_t = FactorGraph(
        {"t": VariableBlock.create("euclidean", jnp.asarray(t0, dtype), const)},
        [
            FactorBatch.create(
                kind="chordal_trans",
                slots=("t", "t"),
                indices=(edges_i, edges_j),
                data={
                    "R_meas": jnp.asarray(R_meas, dtype),
                    "t_meas": jnp.asarray(t_meas, dtype),
                },
                loss=L2Loss(),
            )
        ],
    )
    solved_t, _ = solve_auto(g_t, opts)
    t = np.asarray(solved_t.blocks["t"].values, np.float64)

    T = np.tile(np.eye(d + 1), (n_poses, 1, 1))
    T[:, :d, :d] = R
    T[:, :d, d] = t
    return T


__all__ = ["spanning_tree_init", "chordal_init"]
