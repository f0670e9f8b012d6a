"""Sparse direct block Cholesky — supernodal multifrontal factorization as
batched dense products on the device.

The reference solves EVERY graph exactly through
``scipy.sparse.linalg.spsolve``/``splu`` (pyslam/problem.py, SURVEY.md §2.1
Problem row / §3.1 hot loop 3).  pyslam_tpu previously had dense Cholesky
(fits to ~12k dof) and PCG (untrustworthy on stiff graphs: M3500's PCG
stalls in a worse basin, 50k-pose spheres need rtol 1e-8 / 600 iterations) —
a stiff graph that does not fit dense had NO exact option.  This module is
that option.

Device-first design — the sparsity lives on the HOST, the FLOPs on the device:

  * Host (numpy, once per sparsity pattern): recursive BFS nested
    dissection builds a binary elimination tree — leaf interiors and
    separators are the supernodes.  A symbolic pass computes each node's
    frontal variable set (eliminated cols + boundary) and compiles three
    GATHER tables per tree level ("wave"):
      - ``tbl_orig``: frontal entry (p, q) <- flat position in the symmetric
        ELL store of H (each original block enters exactly one frontal);
      - ``tbl_l`` / ``tbl_r``: frontal entry <- position in the left/right
        child's update-matrix pool.  A binary tree means every frontal
        entry has AT MOST two child contributions, so the multifrontal
        extend-add — normally a scatter — becomes two gathers; the
        numeric hot path here contains NO scatter at all.
  * Device (jit, per LM iteration): for each wave, batched over its nodes:
    gather frontals, add child updates, one batched Cholesky of the
    eliminated block, one batched triangular solve for the boundary panel,
    one batched matmul for the Schur update.  Static shapes per wave
    (nodes padded to the wave max; pad columns carry a unit diagonal and
    are provably inert).
  * Solves are level-scheduled batched triangular solves (forward over
    waves deepest-first, backward in reverse) with small per-wave
    segment scatters on the (nb, d) rhs vector only.

Exactness: this is block Gaussian elimination in a fill-reducing order —
in exact arithmetic dx equals the dense Cholesky solution, at
O(fill) instead of O(D^2) memory.  ``tests/test_sparse_chol.py`` asserts
equality against the dense path and exact-chi2 parity on an M3500-class
stiff 2D graph where PCG stalls.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.linalg import solve_triangular

from ..graph.core import FactorGraph
from . import lm as _lm
from .bcsr import EllDirect, assemble_ell, build_ell_direct
from .plan_cache import ClosureCache, content_key


# --------------------------------------------------------------------------
# Host-side: nested dissection + symbolic factorization
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CholPlan:
    """Static multifrontal plan over a single variable block."""

    nb: int
    d: int
    K: int  # ELL slot count of the source store
    ell: EllDirect
    # per wave (deepest first), each a tuple of numpy arrays:
    #   kpad, bpad, N,
    #   cols_idx (N, kpad) int32  var ids, pad -> nb
    #   bnd_idx  (N, bpad) int32  var ids, pad -> nb
    #   col_pad  (N, kpad) f64    1.0 where pad (unit diagonal)
    #   tbl_orig (N, f, f) int32  1 + flat ELL pos, 0 = zero block
    #   tbl_l / tbl_r (N, f, f) int32  1 + flat global-pool pos, 0 = zero
    waves: tuple
    pool_total: int = 0


def _csr_from_ell(ell: EllDirect):
    """CSR (indptr, indices) of the block adjacency (no self loops)."""
    nb, K = ell.nb, ell.K
    valid = ell.valid[:, 1:] > 0
    cols = ell.cols[:, 1:]
    counts = valid.sum(axis=1).astype(np.int64)
    indptr = np.zeros(nb + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = cols[valid].astype(np.int64)
    return indptr, indices


def _neighbors_of(indptr, indices, verts):
    """Concatenated neighbor lists of ``verts`` — vectorized multi-slice
    gather (no python per-vertex loop; plans must build fast at 50k+)."""
    cnt = indptr[verts + 1] - indptr[verts]
    total = int(cnt.sum())
    if total == 0:
        return np.zeros(0, np.int64), cnt
    ends = np.cumsum(cnt)
    pos = np.repeat(indptr[verts] - (ends - cnt), cnt) + np.arange(total)
    return indices[pos], cnt


def _bfs_levels(indptr, indices, verts, start, inset):
    """BFS level of every vertex in ``verts`` (vectorized frontier sweep).
    ``inset`` is a scratch bool mask with inset[verts] True.  Unreached
    vertices (disconnected) get level -1."""
    level = np.full(len(inset), -1, np.int64)
    frontier = np.asarray(start, np.int64).reshape(-1)
    level[frontier] = 0
    cur = 0
    while len(frontier):
        nbrs, _ = _neighbors_of(indptr, indices, frontier)
        nxt = np.unique(nbrs)
        nxt = nxt[inset[nxt] & (level[nxt] < 0)]
        cur += 1
        level[nxt] = cur
        frontier = nxt
    return level


def _bisect(indptr, indices, verts, inset):
    """Split ``verts`` into (A, B, S): S ⊂ old B side, no edges A <-> B."""
    # pseudo-peripheral start: BFS twice
    lev = _bfs_levels(indptr, indices, verts, verts[0], inset)
    lv = lev[verts]
    far = verts[np.argmax(np.where(lv >= 0, lv, -1))]
    lev = _bfs_levels(indptr, indices, verts, far, inset)
    lv = lev[verts]
    # disconnected part joins the far side
    maxlev = lv.max()
    lv = np.where(lv < 0, maxlev + 1, lv)
    order = np.argsort(lv, kind="stable")
    half = len(verts) // 2
    # split at the level boundary nearest the vertex median
    t = lv[order[half]]
    if t == 0:
        t = 1
    A = verts[lv < t]
    B = verts[lv >= t]
    if len(A) == 0 or len(B) == 0:
        return None
    # separator: B-side vertices adjacent to A
    amask = np.zeros(len(inset), bool)
    amask[A] = True
    nbrs, cnt = _neighbors_of(indptr, indices, B)
    touches = np.zeros(len(B), bool)
    np.logical_or.at(touches, np.repeat(np.arange(len(B)), cnt), amask[nbrs])
    S = B[touches]
    B2 = B[~touches]
    return A, B2, S


def _components(indptr, indices, verts, inset):
    """Connected components of the induced subgraph (BFS sweeps)."""
    label = np.full(len(inset), -1, np.int64)
    comps = []
    for v in verts:
        if label[v] >= 0:
            continue
        frontier = np.array([v], np.int64)
        label[frontier] = len(comps)
        members = [frontier]
        while len(frontier):
            nbrs, _ = _neighbors_of(indptr, indices, frontier)
            nxt = np.unique(nbrs)
            nxt = nxt[inset[nxt] & (label[nxt] < 0)]
            label[nxt] = len(comps)
            members.append(nxt)
            frontier = nxt
        comps.append(np.sort(np.concatenate(members)))
    return comps


def _dissect(indptr, indices, verts, leaf_size, nodes, depth, scratch):
    """Recursive nested dissection; returns the node id.

    Disconnected subgraphs (separators fragment the graph constantly) get a
    balanced binary MERGE over their components — without this, peeling one
    component per split produces an O(#components)-deep chain and the wave
    schedule degenerates to singleton batches (measured: height 29 on a
    3500-pose manhattan graph; ~10 after)."""
    if len(verts) <= leaf_size:
        nodes.append(dict(cols=verts, children=(), depth=depth))
        return len(nodes) - 1
    scratch[:] = False
    scratch[verts] = True
    comps = _components(indptr, indices, verts, scratch)
    if len(comps) > 1:
        # greedy balanced 2-partition of components by vertex count
        sizes = np.array([len(c) for c in comps])
        order = np.argsort(-sizes, kind="stable")
        g1, g2, s1, s2 = [], [], 0, 0
        for ci in order:
            if s1 <= s2:
                g1.append(comps[ci]); s1 += sizes[ci]
            else:
                g2.append(comps[ci]); s2 += sizes[ci]
        l = _dissect(indptr, indices, np.concatenate(g1), leaf_size, nodes, depth + 1, scratch)
        r = _dissect(indptr, indices, np.concatenate(g2), leaf_size, nodes, depth + 1, scratch)
        nodes.append(dict(cols=np.zeros(0, np.int64), children=(l, r), depth=depth))
        return len(nodes) - 1
    scratch[:] = False
    scratch[verts] = True
    split = _bisect(indptr, indices, verts, scratch)
    if split is None or len(split[2]) >= max(1, len(verts) // 2):
        nodes.append(dict(cols=verts, children=(), depth=depth))
        return len(nodes) - 1
    A, B, S = split
    l = _dissect(indptr, indices, A, leaf_size, nodes, depth + 1, scratch)
    r = (
        _dissect(indptr, indices, B, leaf_size, nodes, depth + 1, scratch)
        if len(B)
        else None
    )
    nodes.append(dict(cols=S, children=tuple(c for c in (l, r) if c is not None), depth=depth))
    return len(nodes) - 1


def build_chol_plan(
    graph: FactorGraph, block_name: str | None = None, leaf_size: int = 32
) -> CholPlan:
    """Nested dissection + symbolic multifrontal factorization (host)."""
    ell = build_ell_direct(graph, block_name)
    nb, d, K = ell.nb, ell.d, ell.K
    indptr, indices = _csr_from_ell(ell)

    import sys

    nodes: list = []
    scratch = np.zeros(nb, bool)
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        root = _dissect(
            indptr, indices, np.arange(nb, dtype=np.int64), leaf_size, nodes, 0, scratch
        )
    finally:
        sys.setrecursionlimit(old_limit)

    # children may include isolated single-child chains (empty B side):
    # the symbolic pass below handles any child count 0..2.

    n_nodes = len(nodes)
    # --- postorder elimination positions -------------------------------
    post = []
    stack = [(root, False)]
    while stack:
        nid, done = stack.pop()
        if done:
            post.append(nid)
            continue
        stack.append((nid, True))
        for c in nodes[nid]["children"]:
            stack.append((c, False))
    post_index = np.zeros(n_nodes, np.int64)
    for i, nid in enumerate(post):
        post_index[nid] = i

    elim_node = np.full(nb, -1, np.int64)
    elim_pos = np.full(nb, -1, np.int64)
    counter = 0
    for nid in post:
        c = nodes[nid]["cols"]
        elim_node[c] = nid
        elim_pos[c] = counter + np.arange(len(c))
        counter += len(c)
    assert counter == nb and (elim_node >= 0).all()

    # --- boundaries bottom-up (postorder) ------------------------------
    eliminated = np.zeros(nb, bool)
    bnds: dict[int, np.ndarray] = {}
    for nid in post:
        nd = nodes[nid]
        c = nd["cols"]
        eliminated[c] = True
        cand = [bnds[ch] for ch in nd["children"]]
        if len(c):
            cand.append(np.unique(_neighbors_of(indptr, indices, c)[0]))
        cand = np.unique(np.concatenate(cand)) if cand else np.zeros(0, np.int64)
        bnd = cand[~eliminated[cand]]
        # deterministic frontal order: ascending elimination position
        bnds[nid] = bnd[np.argsort(elim_pos[bnd], kind="stable")]
    assert len(bnds[root]) == 0, "root boundary must be empty"

    # --- group nodes into waves by HEIGHT ------------------------------
    # (longest path to a leaf, not depth: a node runs as soon as its
    # children are done, so an unbalanced tree still batches wide — the
    # wave count is the tree height, not the deepest leaf chain)
    height = np.zeros(n_nodes, np.int64)
    for nid in post:  # children precede parents in postorder
        ch = nodes[nid]["children"]
        if ch:
            height[nid] = 1 + max(height[c] for c in ch)
    n_waves = int(height.max()) + 1

    # Within-wave SIZE BUCKETS: a wave's nodes vary widely in (k, b) —
    # padding every node to the wave max inflated the 50k-sphere frontal
    # gathers to GB scale (measured r3).  Nodes are sub-grouped by
    # geometrically-padded (k, b) classes; groups stay in wave order, so
    # every child group still precedes its parent's group.
    def _pad_up(x):
        if x <= 1:
            return 1
        p = 1
        while p < x:
            p = max(p + 1, int(p * 1.5))
        return p

    waves_nodes = []
    for w in range(n_waves):
        wn = [nid for nid in range(n_nodes) if height[nid] == w]
        buckets: dict = {}
        for nid in wn:
            key = (_pad_up(len(nodes[nid]["cols"])), _pad_up(len(bnds[nid])))
            buckets.setdefault(key, []).append(nid)
        for key in sorted(buckets):
            waves_nodes.append(buckets[key])
    # slot of node within its group
    slot_of = np.zeros(n_nodes, np.int64)
    wave_idx = np.zeros(n_nodes, np.int64)
    for wi, wn in enumerate(waves_nodes):
        for s, nid in enumerate(wn):
            slot_of[nid] = s
            wave_idx[nid] = wi

    # --- assign original entries to frontals ---------------------------
    # unique undirected edges + diagonals; entry enters at the elim node of
    # its earlier-eliminated endpoint.
    valid = ell.valid[:, 1:] > 0
    eu = np.repeat(np.arange(nb, dtype=np.int64), valid.sum(axis=1))
    ev = ell.cols[:, 1:][valid].astype(np.int64)
    slot_flat = (np.tile(np.arange(1, K, dtype=np.int64), (nb, 1)))[valid]
    ellpos_uv = eu * K + slot_flat  # flat pos of block (u, v)
    und = eu < ev
    E_u, E_v = eu[und], ev[und]
    pos_uv = ellpos_uv[und]
    # find pos of (v, u): build lookup from (u, v) key -> ellpos
    keys_all = eu * nb + ev
    order_all = np.argsort(keys_all, kind="stable")
    keys_sorted = keys_all[order_all]
    pos_sorted = ellpos_uv[order_all]
    loc = np.searchsorted(keys_sorted, E_v * nb + E_u)
    pos_vu = pos_sorted[loc]

    first = np.where(elim_pos[E_u] <= elim_pos[E_v], E_u, E_v)
    entry_node = elim_node[first]

    # --- per-wave padded tables ----------------------------------------
    # group edges and children by owner node once
    edge_order = np.argsort(entry_node, kind="stable")
    e_starts = np.searchsorted(entry_node[edge_order], np.arange(n_nodes + 1))

    kpad_w, bpad_w = [], []
    for wn in waves_nodes:
        kpad_w.append(max(1, max(len(nodes[n]["cols"]) for n in wn)))
        bpad_w.append(max(1, max(len(bnds[n]) for n in wn)))
    # one GLOBAL update-matrix pool: wave w writes its batched U blocks at
    # pool_base[w]; child gather tables address the pool absolutely, so
    # children may sit ANY number of waves below their parent
    pool_base = np.zeros(len(waves_nodes) + 1, np.int64)
    for wi, wn in enumerate(waves_nodes):
        pool_base[wi + 1] = pool_base[wi] + len(wn) * bpad_w[wi] * bpad_w[wi]
    pool_total = int(pool_base[-1])

    pos_of = np.full(nb, -1, np.int64)  # scratch frontal-position map
    waves_out = []
    for wi, wn in enumerate(waves_nodes):
        N = len(wn)
        kpad, bpad = kpad_w[wi], bpad_w[wi]
        f = kpad + bpad
        cols_idx = np.full((N, kpad), nb, np.int32)
        bnd_idx = np.full((N, bpad), nb, np.int32)
        col_pad = np.ones((N, kpad))
        tbl_orig = np.zeros((N, f, f), np.int32)
        tbl_l = np.zeros((N, f, f), np.int32)
        tbl_r = np.zeros((N, f, f), np.int32)
        for s, nid in enumerate(wn):
            c = nodes[nid]["cols"]
            b = bnds[nid]
            k_n, b_n = len(c), len(b)
            cols_idx[s, :k_n] = c
            bnd_idx[s, :b_n] = b
            col_pad[s, :k_n] = 0.0
            front = np.concatenate([c, b])
            pos_of[c] = np.arange(k_n)  # cols part
            pos_of[b] = kpad + np.arange(b_n)  # bnd part (after the pad gap)
            # original entries owned by this node
            ee = edge_order[e_starts[nid] : e_starts[nid + 1]]
            pu, pv = pos_of[E_u[ee]], pos_of[E_v[ee]]
            tbl_orig[s, pu, pv] = 1 + pos_uv[ee]
            tbl_orig[s, pv, pu] = 1 + pos_vu[ee]
            # diagonals of eliminated cols: ELL slot 0
            pc = pos_of[c]
            tbl_orig[s, pc, pc] = 1 + c * K
            # child updates
            for side, ch in enumerate(nodes[nid]["children"]):
                cb = bnds[ch]
                if len(cb) == 0:
                    continue
                cw = wave_idx[ch]
                cbpad = bpad_w[cw]
                base = pool_base[cw] + slot_of[ch] * cbpad * cbpad
                pp = pos_of[cb]
                grid = base + np.arange(len(cb))[:, None] * cbpad + np.arange(len(cb))[None, :]
                tbl = tbl_l if side == 0 else tbl_r
                tbl[s, pp[:, None], pp[None, :]] = 1 + grid
            pos_of[front] = -1
        waves_out.append(
            (kpad, bpad, N, cols_idx, bnd_idx, col_pad, tbl_orig, tbl_l, tbl_r)
        )

    return CholPlan(
        nb=nb, d=d, K=K, ell=ell, waves=tuple(waves_out), pool_total=pool_total
    )


# --------------------------------------------------------------------------
# Device-side: numeric factorization + solves
# --------------------------------------------------------------------------


def _device_waves(plan: CholPlan):
    """Per-wave arrays as DEVICE arrays, converted once per plan and cached
    ON the plan object (an attribute, not an id-keyed registry).

    Critical at scale: `jnp.asarray(numpy_table)` INSIDE a traced function
    embeds the table as an HLO constant — at 50k poses the gather tables
    are hundreds of MB, and the resulting constant-bloated program takes
    unboundedly long on the remote compile service.  Closed-over device
    arrays lower as executable parameters instead, keeping the HLO small."""
    cached = getattr(plan, "_dev_waves", None)
    if cached is not None:
        return cached
    dev = tuple(
        (
            kpad, bpad, N,
            jnp.asarray(cols_idx), jnp.asarray(bnd_idx), jnp.asarray(col_pad),
            jnp.asarray(tbl_orig), jnp.asarray(tbl_l), jnp.asarray(tbl_r),
        )
        for kpad, bpad, N, cols_idx, bnd_idx, col_pad, tbl_orig, tbl_l, tbl_r
        in plan.waves
    )
    object.__setattr__(plan, "_dev_waves", dev)
    return dev


def _factorize(plan: CholPlan, He):
    """Numeric multifrontal factorization of the (already damped) ELL store.
    Returns per-wave (L11, L21) factors (leaf wave first)."""
    nb, d, K = plan.nb, plan.d, plan.K
    dtype = He.dtype
    src = jnp.concatenate(
        [jnp.zeros((1, d, d), dtype), He.reshape(nb * K, d, d)], axis=0
    )
    factors = []
    # global update pool: slot 0 is the zero block; wave w writes at its
    # static pool_base offset (a dynamic-update-slice, not a scatter)
    pool = jnp.zeros((1 + plan.pool_total, d, d), dtype)
    base = 1
    for kpad, bpad, N, cols_idx, bnd_idx, col_pad, tbl_orig, tbl_l, tbl_r in _device_waves(plan):
        f = kpad + bpad
        F = src[tbl_orig]  # (N, f, f, d, d)
        F = F + pool[tbl_l]
        F = F + pool[tbl_r]
        F = jnp.transpose(F, (0, 1, 3, 2, 4)).reshape(N, f * d, f * d)
        k = kpad * d
        pad_diag = jnp.repeat(col_pad.astype(dtype), d, axis=1)  # (N, k)
        F11 = F[:, :k, :k] + jax.vmap(jnp.diag)(pad_diag)
        L11 = jnp.linalg.cholesky(F11)
        F21 = F[:, k:, :k]
        # L21 = F21 L11^{-T}  (solve L11 X^T = F21^T)
        L21 = jnp.swapaxes(
            solve_triangular(L11, jnp.swapaxes(F21, -1, -2), lower=True), -1, -2
        )
        U = F[:, k:, k:] - jnp.einsum("nik,njk->nij", L21, L21)
        factors.append((L11, L21))
        Ub = jnp.transpose(
            U.reshape(N, bpad, d, bpad, d), (0, 1, 3, 2, 4)
        ).reshape(N * bpad * bpad, d, d)
        pool = pool.at[base : base + N * bpad * bpad].set(Ub)
        base += N * bpad * bpad
    return factors


def _solve_factored(plan: CholPlan, factors, g):
    """Level-scheduled forward/backward substitution; g is (nb*d,)."""
    nb, d = plan.nb, plan.d
    dtype = g.dtype
    bvec = jnp.concatenate([g.reshape(nb, d), jnp.zeros((1, d), dtype)], axis=0)
    ys = []
    dev_waves = _device_waves(plan)
    for (kpad, bpad, N, ci, bi, *_), (L11, L21) in zip(dev_waves, factors):
        bc = bvec[ci].reshape(N, kpad * d)
        y = solve_triangular(L11, bc[..., None], lower=True)[..., 0]
        ys.append(y)
        upd = jnp.einsum("nik,nk->ni", L21, y).reshape(N * bpad, d)
        bvec = bvec.at[bi.reshape(-1)].add(-upd)
    xvec = jnp.zeros((nb + 1, d), dtype)
    for (kpad, bpad, N, ci, bi, *_), (L11, L21), y in zip(
        reversed(dev_waves), reversed(factors), reversed(ys)
    ):
        xb = xvec[bi].reshape(N, bpad * d)
        rhs = y - jnp.einsum("nki,nk->ni", L21, xb)
        xc = solve_triangular(
            jnp.swapaxes(L11, -1, -2), rhs[..., None], lower=False
        )[..., 0]
        xvec = xvec.at[ci.reshape(-1)].set(xc.reshape(N * kpad, d))
    return xvec[:nb].reshape(-1)


def locate_fill_pairs(plan: CholPlan, pairs):
    """Host: map (u, v) variable pairs to (wave, slot, p, q) positions in
    the Sigma-fronts of the selected-inverse sweep.  A pair is coverable
    iff it lies in the FILL pattern — u and v share a front at the node
    where the earlier-eliminated one is a column (original edges,
    e.g. odometry pairs, always qualify).  Raises ValueError on
    out-of-fill or out-of-range pairs.

    Cost is proportional to the QUERY, not the fill: an O(nb) owner map
    from the cols tables, then front dicts only for the (at most two)
    candidate owner nodes per pair."""
    nb = plan.nb
    owner = np.full(nb, -1, np.int64)  # var -> flat node id (wave-major)
    node_of = []  # flat node id -> (wave, slot)
    for wi, (kpad, bpad, N, cols_idx, bnd_idx, *_rest) in enumerate(plan.waves):
        for s in range(N):
            c = cols_idx[s]
            owner[c[c < nb]] = len(node_of)
            node_of.append((wi, s))

    fronts: dict[int, dict] = {}  # flat node id -> {var: front position}

    def front_of(nid):
        f = fronts.get(nid)
        if f is None:
            wi, s = node_of[nid]
            kpad, bpad, N, cols_idx, bnd_idx, *_rest = plan.waves[wi]
            f = {int(v): p for p, v in enumerate(cols_idx[s]) if v < nb}
            f.update(
                {int(v): kpad + p for p, v in enumerate(bnd_idx[s]) if v < nb}
            )
            fronts[nid] = f
        return f

    out = []
    for u, v in pairs:
        u, v = int(u), int(v)
        if not (0 <= u < nb and 0 <= v < nb):
            raise ValueError(
                f"pair ({u}, {v}) out of range for {nb} variables"
            )
        hit = None
        for first, second, swapped in ((u, v, False), (v, u, True)):
            front = front_of(int(owner[first]))
            if second in front:
                # swapped extractions read Sigma_vu = Sigma_uv^T — the
                # sweep transposes them back before returning
                wi, s = node_of[int(owner[first])]
                hit = (wi, s, front[first], front[second], swapped)
                break
        if hit is None:
            raise ValueError(
                f"pair ({u}, {v}) is outside the factorization fill; use a "
                "column solve (covariance_block) for arbitrary pairs"
            )
        out.append(hit)
    return out


def selected_inverse_marginals(plan: CholPlan, factors, pairs=None):
    """ALL (d, d) marginal covariance blocks of H^-1 in one top-down sweep
    over the multifrontal factors — the Takahashi / selected-inversion
    recursion, wave-scheduled on the device.

    Column solves cost O(nb * d * fill) total (one solve per tangent dof —
    infeasible at 50k poses); this computes every diagonal block in ~2x the
    FACTORIZATION cost.  The recursion mirrors ``_factorize`` exactly, run
    in reverse: where the factorization's extend-add GATHERS each node's
    child-update pool entries into the parent front (tbl_l/tbl_r), the
    inverse sweep SCATTERS the parent's Sigma-front entries back through
    the same tables, and each node then reads its boundary covariance
    Sigma_BB from its own (contiguous) pool slot.

    Per node, with the reduced frontal system [[F11, F12], [F21, .]] and
    U = F11^-1 F12 = L11^-T L21^T (the multifrontal Schur-complement
    property makes F11/F21 the FULLY reduced blocks):

        Sigma_CB = -U Sigma_BB
        Sigma_CC = F11^-1 + U Sigma_BB U^T

    Padding stays inert: padded eliminated cols carry a unit diagonal
    (Sigma = identity, masked out by the caller), padded boundary rows of
    L21 are zero so their U columns vanish, and unwritten pool entries are
    zero.  Root nodes have an empty boundary (Sigma_BB = 0).

    ``pairs``: optional (u, v) variable pairs WITHIN THE FILL (see
    locate_fill_pairs) — their (d, d) cross blocks Sigma_uv are read out
    of the Sigma-fronts during the same sweep; returns (diag, blocks)."""
    nb, d = plan.nb, plan.d
    dev_waves = _device_waves(plan)
    dtype = factors[0][0].dtype
    pair_req = None
    if pairs is not None:
        located = locate_fill_pairs(plan, pairs)
        pair_req = {}  # wave -> (slots, ps, qs, out_ids)
        swapped = np.zeros(len(pairs), bool)
        for out_id, (wi, s, p, q, sw) in enumerate(located):
            pair_req.setdefault(wi, []).append((s, p, q, out_id))
            swapped[out_id] = sw
        pair_out = jnp.zeros((len(pairs), d, d), dtype)
    # forward pool bases (same layout the factorization used)
    bases = [1]
    for (kpad, bpad, N, *_ ) in dev_waves:
        bases.append(bases[-1] + N * bpad * bpad)
    pool = jnp.zeros((1 + plan.pool_total, d, d), dtype)
    out = jnp.zeros((nb + 1, d, d), dtype)
    eye = None
    for wi in reversed(range(len(dev_waves))):
        (kpad, bpad, N, ci, bi, col_pad, tbl_orig, tbl_l, tbl_r) = dev_waves[wi]
        (L11, L21), base = factors[wi], bases[wi]
        f = kpad + bpad
        k, b = kpad * d, bpad * d
        # this node's Sigma_BB, scattered by its parent (zeros at roots)
        grid = (
            base
            + jnp.arange(N)[:, None, None] * (bpad * bpad)
            + jnp.arange(bpad)[None, :, None] * bpad
            + jnp.arange(bpad)[None, None, :]
        )
        Sbb = pool[grid]  # (N, bpad, bpad, d, d)
        Sbb = jnp.transpose(Sbb, (0, 1, 3, 2, 4)).reshape(N, b, b)
        # U = L11^-T L21^T  (k, b);  F11^-1 = L11^-T L11^-1
        U = solve_triangular(
            jnp.swapaxes(L11, -1, -2), jnp.swapaxes(L21, -1, -2), lower=False
        )
        if eye is None or eye.shape[-1] != k:
            eye = jnp.eye(k, dtype=dtype)
        Linv = solve_triangular(L11, jnp.broadcast_to(eye, (N, k, k)), lower=True)
        F11inv = jnp.einsum("nki,nkj->nij", Linv, Linv)
        USbb = jnp.einsum("nkb,nbc->nkc", U, Sbb)
        Scc = F11inv + jnp.einsum("nkc,nbc->nkb", USbb, U)
        Scb = -USbb
        # Sigma-front in (N, f, f, d, d) block layout
        Sf = jnp.concatenate(
            [
                jnp.concatenate([Scc, Scb], axis=2),
                jnp.concatenate([jnp.swapaxes(Scb, -1, -2), Sbb], axis=2),
            ],
            axis=1,
        )
        Sf = jnp.transpose(
            Sf.reshape(N, f, d, f, d), (0, 1, 3, 2, 4)
        )  # (N, f, f, d, d)
        # eliminated-variable marginals (padded cols index the dump slot nb)
        diag_blocks = Sf[:, jnp.arange(kpad), jnp.arange(kpad)]  # (N, kpad, d, d)
        out = out.at[ci.reshape(-1)].set(diag_blocks.reshape(N * kpad, d, d))
        if pair_req is not None and wi in pair_req:
            req = pair_req[wi]
            ss = jnp.asarray([r[0] for r in req], jnp.int32)
            ps = jnp.asarray([r[1] for r in req], jnp.int32)
            qs = jnp.asarray([r[2] for r in req], jnp.int32)
            oi = jnp.asarray([r[3] for r in req], jnp.int32)
            pair_out = pair_out.at[oi].set(Sf[ss, ps, qs])
        # hand children their Sigma_BB through the SAME tables the
        # factorization gathered their updates with (index 0 = dump slot,
        # written benignly by every non-entry)
        pool = pool.at[tbl_l.reshape(-1)].set(Sf.reshape(-1, d, d))
        pool = pool.at[tbl_r.reshape(-1)].set(Sf.reshape(-1, d, d))
    if pairs is not None:
        sw = jnp.asarray(swapped)[:, None, None]
        pair_out = jnp.where(sw, jnp.swapaxes(pair_out, -1, -2), pair_out)
        return out[:nb], pair_out
    return out[:nb]


def factor_logdet(plan: CholPlan, factors):
    """log det(H) from the multifrontal Cholesky factors: 2 * sum of the
    log-diagonals of every wave's L11, minus the padding columns' unit
    contributions (log 1 = 0, so padding is inert for free).  The
    information-theoretic primitive (entropy / D-optimality / marginal
    likelihood) at zero extra factorization cost."""
    total = jnp.zeros((), factors[0][0].dtype)
    for L11, _ in factors:
        diag = jnp.einsum("nii->ni", L11)
        total = total + 2.0 * jnp.sum(jnp.log(diag))
    return total


def sparse_chol_solve(plan: CholPlan, He, g, lam, opt: _lm.Options):
    """One exact linear solve of (He + damping) dx = g."""
    if opt.method == "lm":
        D = He[:, 0]
        diag = jnp.maximum(jnp.einsum("nii->ni", D), 1e-12)
        He = He.at[:, 0].set(
            D + lam * diag[:, :, None] * jnp.eye(plan.d, dtype=He.dtype)
        )
    factors = _factorize(plan, He)
    return _solve_factored(plan, factors, g)


_CLOSURES = ClosureCache()


def solve_sparse_chol(
    graph: FactorGraph,
    options: _lm.Options = _lm.Options(),
    plan: CholPlan | None = None,
    leaf_size: int = 32,
):
    """GN/LM with EXACT sparse direct linear solves (multifrontal block
    Cholesky).  The on-device analogue of the reference's
    spsolve-everywhere capability: same dx as the dense path, O(fill)
    memory.  Shares the jitted LM trust-region loop (lm.solve)."""
    if plan is None:
        plan = build_chol_plan(graph, leaf_size=leaf_size)
    key = ("sparse_chol", content_key(plan.ell), leaf_size)
    if key not in _CLOSURES:

        def assemble_fn(g):
            return assemble_ell(g, plan.ell)

        def solve_fn(He, g, lam, opt):
            return sparse_chol_solve(plan, He, g, lam, opt)

        _CLOSURES[key] = (assemble_fn, solve_fn)
    assemble_fn, solve_fn = _CLOSURES[key]
    return _lm.solve(graph, options, assemble_fn=assemble_fn, solve_fn=solve_fn)


__all__ = ["CholPlan", "build_chol_plan", "solve_sparse_chol", "sparse_chol_solve",
           "selected_inverse_marginals", "locate_fill_pairs", "factor_logdet"]
