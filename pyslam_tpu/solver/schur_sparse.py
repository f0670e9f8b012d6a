"""SPARSE_SCHUR: exact sparse direct solves of the reduced camera system.

The third Schur flavor (Ceres taxonomy: DENSE_SCHUR / ITERATIVE_SCHUR /
SPARSE_SCHUR).  After landmark elimination the reduced system

    S = Hpp + PP_couplings - W Hll^-1 W^T

is block-sparse with one off-diagonal block per pose pair that either
shares a between factor or CO-OBSERVES a landmark.  For many-poses /
few-landmarks graphs — Victoria-Park-class 2D landmark SLAM, sliding
windows, sparse-visibility BA — that camera graph is nearly as sparse as
a pose graph, so:

  * ``schur_dense`` does not fit (C*dp beyond the dense ceiling), and
  * ``schur_pcg`` is iterative (and on stiff 2D graphs PCG is known to
    stall in worse basins — the M3500 lesson),

while S factors EXACTLY through the existing multifrontal block Cholesky
(solver/sparse_chol.py) at O(fill).

Device-first split: the HOST enumerates, once per sparsity pattern, every
ordered co-observation pair (obs_a, obs_b of the same landmark) and its
flat position in the symmetric-ELL store of S (reusing build_ell_direct's
vectorized edge layout on a structure-only pose graph), plus the nested
dissection plan.  The DEVICE, per LM iteration, computes all pair blocks
W_a Hll^-1 W_b^T in one batched einsum and assembles S with a single
segment_sum — then factorizes on the device.  Unlike SCHUR_JACOBI's diagonal
(schur.py, exact only when a camera observes a landmark at most once),
the pair enumeration is exact under duplicate observations too.

Reference: the scipy spsolve of the FULL system (pyslam/problem.py,
SURVEY.md §3.1) — this path is exact like it, but eliminates landmarks
analytically first and factors only the pose system.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.core import FactorBatch, FactorGraph, VariableBlock
from ..losses import L2Loss
from . import lm as _lm
from .plan_cache import ClosureCache, content_key
from .schur import _back_substitute, _binv, _concat_dx, _schur_reduce, ba_assemble
from .sparse_chol import CholPlan, _factorize, _solve_factored, build_chol_plan


@dataclasses.dataclass
class SchurSparsePlan:
    """Host-side pair tables + multifrontal plan for the reduced system."""

    chol: CholPlan
    C: int
    dp: int
    pair_a: np.ndarray  # (P,) observation index (into ba_assemble's W)
    pair_b: np.ndarray  # (P,)
    pair_l: np.ndarray  # (P,) landmark index
    pair_pos: np.ndarray  # (P,) flat ELL position of (cam_a, cam_b)
    diag_pos: np.ndarray  # (C,) flat ELL positions of the diagonal
    pp_pos_ab: np.ndarray  # (E,) between-coupling positions
    pp_pos_ba: np.ndarray  # (E,)
    n_pairs: int
    n_edges: int  # unique off-diagonal S edges (both directions)


def _coobservation_pairs(ci: np.ndarray, li: np.ndarray, L: int):
    """All ordered pairs (a, b) of observations sharing a landmark,
    vectorized (no per-landmark Python loop)."""
    order = np.argsort(li, kind="stable")
    li_s = li[order]
    counts = np.bincount(li_s, minlength=L)
    nz = np.flatnonzero(counts)
    c = counts[nz]
    seg_start = np.concatenate([[0], np.cumsum(counts)[:-1]])[nz]
    P_l = c * c
    total = int(P_l.sum())
    # within-pair rank for every pair, segmented per landmark
    pair_seg = np.repeat(np.arange(len(nz)), P_l)
    offs = np.concatenate([[0], np.cumsum(P_l)[:-1]])
    within = np.arange(total) - offs[pair_seg]
    cs = c[pair_seg]
    a_rank = within // cs
    b_rank = within % cs
    base = seg_start[pair_seg]
    pair_a = order[base + a_rank]
    pair_b = order[base + b_rank]
    pair_lm = nz[pair_seg]
    return pair_a, pair_b, pair_lm


def coobservation_stats(graph: FactorGraph, pose_name="poses", lm_name="landmarks"):
    """Cheap host gate for route_auto: (sum of squared landmark degrees =
    pair count, upper bound on S edges) without enumerating pairs."""
    lb = graph.blocks[lm_name]
    lis = [
        np.asarray(fb.indices[1]) for fb in graph.batches
        if fb.slots == (pose_name, lm_name)
    ]
    li = np.concatenate(lis) if lis else np.zeros(0, np.int64)
    deg = np.bincount(li, minlength=max(lb.n, 1))
    return int((deg.astype(np.int64) ** 2).sum()), int(deg.max() if len(deg) else 0)


def build_schur_sparse_plan(
    graph: FactorGraph,
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    leaf_size: int = 32,
) -> SchurSparsePlan:
    pb, lb = graph.blocks[pose_name], graph.blocks[lm_name]
    C, dp, L = pb.n, pb.dof, lb.n

    # observation / between indices in ba_assemble's concatenation order
    cis, lis, ppi, ppj = [], [], [], []
    for fb in graph.batches:
        if fb.slots == (pose_name, lm_name):
            cis.append(np.asarray(fb.indices[0], np.int64))
            lis.append(np.asarray(fb.indices[1], np.int64))
        elif fb.slots == (pose_name, pose_name):
            ppi.append(np.asarray(fb.indices[0], np.int64))
            ppj.append(np.asarray(fb.indices[1], np.int64))
    ci = np.concatenate(cis) if cis else np.zeros(0, np.int64)
    li = np.concatenate(lis) if lis else np.zeros(0, np.int64)
    pp_i = np.concatenate(ppi) if ppi else np.zeros(0, np.int64)
    pp_j = np.concatenate(ppj) if ppj else np.zeros(0, np.int64)

    pair_a, pair_b, pair_lm = _coobservation_pairs(ci, li, L)

    # structure-only pose graph carrying the S sparsity: between edges +
    # co-observation edges.  build_ell_direct's maps hand back the flat
    # ELL position of every (slot_a, slot_b) index pair — exactly the
    # lookup the device assembly needs (diagonal pairs map to slot 0).
    dummy = FactorGraph(
        {
            pose_name: VariableBlock(
                pb.kind, pb.values, pb.const_mask
            )
        },
        [
            FactorBatch(
                "structure_pp", (pose_name, pose_name),
                (jnp.asarray(pp_i, jnp.int32), jnp.asarray(pp_j, jnp.int32)),
                {}, L2Loss(), jnp.ones(len(pp_i), jnp.float32),
            ),
            FactorBatch(
                "structure_coobs", (pose_name, pose_name),
                (jnp.asarray(ci[pair_a], jnp.int32), jnp.asarray(ci[pair_b], jnp.int32)),
                {}, L2Loss(), jnp.ones(len(pair_a), jnp.float32),
            ),
        ],
    )
    chol = build_chol_plan(dummy, pose_name, leaf_size=leaf_size)
    ell = chol.ell  # the SAME store the factorization gathers from

    # maps[batch] has one entry per slot pair (0,0), (0,1), (1,1); the
    # (0,1) entry carries (slot_a, slot_b, flat_pos_ab, flat_pos_ba)
    _, _, pp_ab, pp_ba = ell.maps[0][1]
    _, _, pair_ab, _ = ell.maps[1][1]
    diag_pos = np.arange(C, dtype=np.int64) * ell.K
    n_edges = int(ell.valid.sum() - C)

    return SchurSparsePlan(
        chol=chol, C=C, dp=dp,
        pair_a=pair_a, pair_b=pair_b, pair_l=pair_lm,
        pair_pos=np.asarray(pair_ab),
        diag_pos=diag_pos,
        pp_pos_ab=np.asarray(pp_ab), pp_pos_ba=np.asarray(pp_ba),
        n_pairs=len(pair_a), n_edges=n_edges,
    )


def plan_tables(plan: SchurSparsePlan):
    """The plan's index arrays as device arrays (close over them outside a
    trace — never trace numpy tables as HLO constants, CLAUDE.md)."""
    return tuple(
        jnp.asarray(t, jnp.int32)
        for t in (plan.pair_a, plan.pair_b, plan.pair_l, plan.pair_pos,
                  plan.diag_pos, plan.pp_pos_ab, plan.pp_pos_ba)
    )


def assemble_S_ell(plan: SchurSparsePlan, tables, Hpp, PP, W, Hll_inv):
    """S = Hpp + PP couplings - W Hll^-1 W^T into the symmetric-ELL store:
    one batched einsum over the co-observation pairs + one segment_sum."""
    pair_a, pair_b, pair_l, pair_pos, diag_pos, pp_ab, pp_ba = tables
    dp = Hpp.shape[1]
    nbK = plan.chol.ell.nb * plan.chol.ell.K
    Cp = jnp.einsum(
        "pij,pjk,plk->pil", W[pair_a], Hll_inv[pair_l], W[pair_b]
    )
    contrib = jnp.concatenate(
        [Hpp, PP, jnp.swapaxes(PP, -1, -2), -Cp], axis=0
    )
    pos = jnp.concatenate([diag_pos, pp_ab, pp_ba, pair_pos])
    He = jax.ops.segment_sum(contrib, pos, num_segments=nbK)
    return He.reshape(plan.chol.ell.nb, plan.chol.ell.K, dp, dp)


def schur_solve_sparse(parts, g, lam, opt: _lm.Options, plan: SchurSparsePlan,
                       tables):
    """One exact SPARSE_SCHUR linear solve (device; runs inside lm.solve's
    jitted loop)."""
    Hpp, L_ll, W, ci, li, g_red = _schur_reduce(parts, lam, opt.method)
    C, dp = Hpp.shape[0], Hpp.shape[1]
    Hll_inv = _binv(L_ll)
    He = assemble_S_ell(plan, tables, Hpp, parts["PP"], W, Hll_inv)
    # damping already applied to Hpp/Hll by _schur_reduce; factor directly
    factors = _factorize(plan.chol, He)
    dx_p = _solve_factored(plan.chol, factors, g_red.reshape(-1)).reshape(C, dp)
    dx_l = _back_substitute(L_ll, W, ci, li, parts["g_l"], dx_p)
    return _concat_dx(parts, dx_p, dx_l)


_CLOSURES = ClosureCache()
_PLANS = ClosureCache()


def solve_schur_sparse(
    graph: FactorGraph,
    options: _lm.Options = _lm.Options(),
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    plan: SchurSparsePlan | None = None,
    leaf_size: int = 32,
):
    """GN/LM with EXACT sparse direct solves of the Schur-reduced camera
    system.  Same dx as ``solve_schur(mode='dense')`` in exact arithmetic;
    O(S-fill) memory instead of (C*dp)^2.  Right for many-poses /
    few-landmarks graphs whose co-observation structure is sparse."""
    if plan is None:
        # content-keyed plan reuse: repeated solves over the same sparsity
        # (GNC outer iterations reweight factors but never move indices)
        # skip the host pair-enumeration + nested-dissection rebuild
        pkey = (
            "plan", pose_name, lm_name, leaf_size,
            tuple(content_key(i) for fb in graph.batches for i in fb.indices),
        )
        if pkey not in _PLANS:
            _PLANS[pkey] = build_schur_sparse_plan(graph, pose_name, lm_name, leaf_size)
        plan = _PLANS[pkey]
    key = (
        "schur_sparse", pose_name, lm_name,
        content_key(plan.chol.ell),
        content_key((plan.pair_a, plan.pair_b, plan.pair_l)),
    )
    if key not in _CLOSURES:
        tables = plan_tables(plan)
        assemble_fn = partial(ba_assemble, pose_name=pose_name, lm_name=lm_name)
        solve_fn = partial(schur_solve_sparse, plan=plan, tables=tables)
        _CLOSURES[key] = (assemble_fn, solve_fn)
    assemble_fn, solve_fn = _CLOSURES[key]
    return _lm.solve(graph, options, assemble_fn=assemble_fn, solve_fn=solve_fn)


__all__ = [
    "SchurSparsePlan",
    "assemble_S_ell",
    "build_schur_sparse_plan",
    "coobservation_stats",
    "plan_tables",
    "solve_schur_sparse",
]
