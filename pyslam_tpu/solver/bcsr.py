"""Block-sparse (BCSR) normal equations + PCG for large pose graphs.

On-device replacement for scipy's sparse bmat/spsolve at sphere2500 scale
(SURVEY.md §2.2, benchmark config #3): the Hessian is stored as a flat array
of d x d blocks over the *upper* block-sparsity pattern (diagonal included),
which for a pose graph is one block per pose + one per unique edge — a few MB
of device memory.

Design:
  * The sparsity pattern is computed host-side at build time from the
    (concrete) factor index arrays and baked into the jaxpr as static
    constants — scatters lower to fast static-index code.
  * Assembly is one fused linearize + scatter-add pass per factor batch
    (same residual kernels as the dense path).
  * The solve is block-Jacobi-preconditioned CG on the damped system; one
    SpMV is two batched (nnzb, d, d) x (nnzb, d) contractions + segment-sums.
  * ``solve_bcsr`` plugs these into the generic LM loop (lm.solve), so the
    trust-region logic is shared with the dense path.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.core import FactorGraph
from .assemble import free_mask, linearize_batch
from .linear import pcg_solve
from .plan_cache import ClosureCache, content_key
from . import lm as _lm


@dataclasses.dataclass(frozen=True)
class BlockPattern:
    """Host-side static BCSR pattern for a single-block pose graph.

    rows/cols: (nnzb,) upper-triangular block coordinates (row <= col),
    lexicographically sorted, diagonal blocks first-class members.
    maps: per batch, a list of (slot_a, slot_b, pair_pos (F,), transpose (F,))
    entries steering each factor's block contribution to its pattern slot.
    """

    block_name: str
    nb: int
    d: int
    rows: np.ndarray
    cols: np.ndarray
    diag_pos: np.ndarray  # (nb,) position of each diagonal block
    maps: tuple  # per batch: tuple of (a, b, pos (F,), transpose (F,))

    @property
    def nnzb(self) -> int:
        return len(self.rows)


def build_pattern(graph: FactorGraph, block_name: str | None = None) -> BlockPattern:
    """Derive the static block-sparsity pattern from concrete factor indices."""
    if block_name is None:
        (block_name,) = graph.blocks.keys()
    blk = graph.blocks[block_name]
    nb, d = blk.n, blk.dof

    pair_set = {(i, i) for i in range(nb)}
    batch_pairs = []
    for fb in graph.batches:
        assert all(s == block_name for s in fb.slots), (
            "BCSR path supports a single variable block; use the Schur path "
            "for camera+landmark problems"
        )
        idx = [np.asarray(i) for i in fb.indices]
        slot_pairs = []
        for a in range(len(idx)):
            for b in range(a, len(idx)):
                ia, ib = idx[a], idx[b]
                r = np.minimum(ia, ib)
                c = np.maximum(ia, ib)
                pair_set.update(zip(r.tolist(), c.tolist()))
                slot_pairs.append((a, b, ia, ib))
        batch_pairs.append(slot_pairs)

    pairs = np.array(sorted(pair_set), np.int64)
    rows, cols = pairs[:, 0], pairs[:, 1]
    lookup = {(int(r), int(c)): p for p, (r, c) in enumerate(pairs)}
    diag_pos = np.array([lookup[(i, i)] for i in range(nb)], np.int32)

    maps = []
    for slot_pairs in batch_pairs:
        entries = []
        for a, b, ia, ib in slot_pairs:
            r = np.minimum(ia, ib)
            c = np.maximum(ia, ib)
            pos = np.array([lookup[(int(x), int(y))] for x, y in zip(r, c)], np.int32)
            transpose = ia > ib  # contribution lands transposed in upper store
            entries.append((a, b, pos, transpose))
        maps.append(tuple(entries))

    return BlockPattern(
        block_name, nb, d, rows.astype(np.int32), cols.astype(np.int32), diag_pos, tuple(maps)
    )


def assemble_bcsr(graph: FactorGraph, pattern: BlockPattern):
    """(H_blocks (nnzb, d, d), g (nb*d,), chi2) — fused linearize + IRLS +
    block scatter-add."""
    nb, d = pattern.nb, pattern.d
    dtype = graph.blocks[pattern.block_name].values.dtype
    H = jnp.zeros((pattern.nnzb, d, d), dtype)
    g = jnp.zeros(nb * d, dtype)
    chi2 = jnp.zeros((), dtype)

    for fb, entries in zip(graph.batches, pattern.maps):
        r, jacs, w, c2 = linearize_batch(fb, graph.blocks)
        chi2 = chi2 + c2
        wr = w * r
        for slot, idx, J in zip(fb.slots, fb.indices, jacs):
            ga = jnp.einsum("fmi,fm->fi", J, wr)
            rows = idx[:, None] * d + jnp.arange(d, dtype=jnp.int32)[None, :]
            g = g.at[rows.reshape(-1)].add(-ga.reshape(-1))
        for a, b, pos, transpose in entries:
            C = jnp.einsum("fmi,fm,fmj->fij", jacs[a], w, jacs[b])
            C = jnp.where(transpose[:, None, None], jnp.swapaxes(C, -1, -2), C)
            H = H.at[pos].add(C)

    # constant parameters: zero their rows/cols, unit diagonal on frozen dofs
    free = free_mask(graph).astype(dtype).reshape(nb, d)
    H = H * free[pattern.rows][:, :, None] * free[pattern.cols][:, None, :]
    eye = jnp.eye(d, dtype=dtype)
    H = H.at[pattern.diag_pos].add((1.0 - free)[:, :, None] * eye[None])
    g = g * free.reshape(-1)
    return H, g, chi2


def bcsr_matvec(H, pattern: BlockPattern, x):
    """y = H x with upper-block storage: one pass for the stored blocks plus
    one transposed pass for the strictly-upper blocks."""
    nb, d = pattern.nb, pattern.d
    xb = x.reshape(nb, d)
    upper = pattern.rows != pattern.cols  # static numpy mask
    y = jnp.zeros((nb, d), x.dtype)
    y = y.at[pattern.rows].add(jnp.einsum("pij,pj->pi", H, xb[pattern.cols]))
    Ht = jnp.swapaxes(H, -1, -2) * upper[:, None, None]
    y = y.at[pattern.cols].add(jnp.einsum("pij,pj->pi", Ht, xb[pattern.rows]))
    return y.reshape(-1)


def block_jacobi_inv(H, pattern: BlockPattern):
    """Inverse diagonal blocks for the preconditioner, via batched Cholesky +
    triangular solves.  (LU-based jnp.linalg.inv does not compile on this
    toolchain's remote-compile service; the blocks are SPD anyway.)"""
    from jax.scipy.linalg import solve_triangular

    D = H[pattern.diag_pos]
    L = jnp.linalg.cholesky(D)
    eye = jnp.broadcast_to(jnp.eye(pattern.d, dtype=H.dtype), D.shape)
    Y = solve_triangular(L, eye, lower=True)
    return solve_triangular(jnp.swapaxes(L, -1, -2), Y, lower=False)


def damp_blocks(H, pattern: BlockPattern, lam, floor=1e-12):
    """Marquardt damping on the diagonal blocks: H_ii += lam * diag(H_ii)."""
    D = H[pattern.diag_pos]
    diag = jnp.maximum(
        jnp.einsum("nii->ni", D), floor
    )
    return H.at[pattern.diag_pos].add(lam * jnp.einsum("ni,ij->nij", diag, jnp.eye(H.shape[-1], dtype=H.dtype)))


# --------------------------------------------------------------------------
# Symmetric ELLPACK matvec: gathers instead of scatters.  The
# upper-store two-pass matvec (bcsr_matvec) does two scatter-adds per
# application; inside PCG that is the whole cost.  Instead: expand the upper
# pattern into a per-row fixed-width (ELL) symmetric neighbor list once per
# damped system, so every CG matvec is one row gather + one batched einsum —
# no scatter at all.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EllPattern:
    """Static symmetric ELL expansion of a BlockPattern.

    For each block-row r: K slots; slot k reads stored block ``sel[r,k]``
    (transposed when ``trans[r,k]``), multiplies x[cols[r,k]].  Padding slots
    point at block 0 with weight 0."""

    nb: int
    d: int
    K: int
    cols: np.ndarray  # (nb, K) int32
    sel: np.ndarray  # (nb, K) int32 into the BCSR block store
    trans: np.ndarray  # (nb, K) bool
    valid: np.ndarray  # (nb, K) float


def build_ell(pattern: BlockPattern) -> EllPattern:
    nb = pattern.nb
    entries: list[list] = [[] for _ in range(nb)]
    for pos, (r, c) in enumerate(zip(pattern.rows, pattern.cols)):
        entries[r].append((c, pos, False))
        if r != c:
            entries[c].append((r, pos, True))
    K = max(len(e) for e in entries)
    cols = np.zeros((nb, K), np.int32)
    sel = np.zeros((nb, K), np.int32)
    trans = np.zeros((nb, K), bool)
    valid = np.zeros((nb, K), np.float64)
    for r, ent in enumerate(entries):
        for k, (c, pos, tr) in enumerate(ent):
            cols[r, k] = c
            sel[r, k] = pos
            trans[r, k] = tr
            valid[r, k] = 1.0
    return EllPattern(nb, pattern.d, K, cols, sel, trans, valid)


def ell_blocks(H, ell: EllPattern):
    """Materialize the (nb, K, d, d) symmetric neighbor blocks from the
    upper BCSR store — once per damped system, outside the CG loop."""
    Hg = H[ell.sel]  # (nb, K, d, d)
    Ht = jnp.swapaxes(Hg, -1, -2)
    tr = jnp.asarray(ell.trans)[:, :, None, None]
    v = jnp.asarray(ell.valid, H.dtype)[:, :, None, None]
    return jnp.where(tr, Ht, Hg) * v


def ell_matvec(He, ell: EllPattern, x):
    """y = H x from ELL blocks: gather + batched contraction, scatter-free."""
    xb = x.reshape(ell.nb, ell.d)
    xg = xb[ell.cols]  # (nb, K, d) gather
    return jnp.einsum("rkij,rkj->ri", He, xg).reshape(-1)


# --------------------------------------------------------------------------
# Group block-Jacobi preconditioner: instead of 6x6 per-pose diagonal blocks,
# take G consecutive poses per group and factorize the dense (G*d, G*d)
# diagonal block — this captures the odometry-chain coupling inside each
# group and cuts PCG iteration counts several-fold on trajectory-like
# graphs.  Built gather-only (static index lists into the BCSR store), with
# batched Cholesky + triangular solves: every op is plain XLA.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GroupJacobi:
    """Static layout of the group-diagonal preconditioner."""

    ng: int  # number of groups
    G: int  # poses per group
    d: int
    nb_pad: int
    sel: np.ndarray  # (ng, G, G) positions into the BCSR store (0 if none)
    trans: np.ndarray  # (ng, G, G) transpose flags
    valid: np.ndarray  # (ng, G, G) 1.0 where a stored block exists


def build_group_jacobi(pattern: BlockPattern, group_size: int = 8) -> GroupJacobi:
    nb, d, G = pattern.nb, pattern.d, group_size
    ng = -(-nb // G)
    nb_pad = ng * G
    lookup = {
        (int(r), int(c)): p for p, (r, c) in enumerate(zip(pattern.rows, pattern.cols))
    }
    sel = np.zeros((ng, G, G), np.int32)
    trans = np.zeros((ng, G, G), bool)
    valid = np.zeros((ng, G, G), np.float64)
    for g in range(ng):
        for a in range(G):
            i = g * G + a
            for b in range(G):
                j = g * G + b
                if i >= nb or j >= nb:
                    continue
                key = (min(i, j), max(i, j))
                if key in lookup:
                    sel[g, a, b] = lookup[key]
                    trans[g, a, b] = i > j
                    valid[g, a, b] = 1.0
    return GroupJacobi(ng, G, d, nb_pad, sel, trans, valid)


def group_jacobi_factor(H, gj: GroupJacobi):
    """Gather the group-diagonal dense blocks and Cholesky-factorize them.
    Call once per damped system.  Unfilled (padding) diagonal entries get a
    unit diagonal so the factorization is always SPD."""
    d, G = gj.d, gj.G
    Hg = H[gj.sel]  # (ng, G, G, d, d) gather
    Ht = jnp.swapaxes(Hg, -1, -2)
    Hg = jnp.where(jnp.asarray(gj.trans)[..., None, None], Ht, Hg)
    Hg = Hg * jnp.asarray(gj.valid, H.dtype)[..., None, None]
    # (ng, G, d, G, d) -> (ng, G*d, G*d)
    D = jnp.transpose(Hg, (0, 1, 3, 2, 4)).reshape(gj.ng, G * d, G * d)
    # identity on rows with empty diagonal (padding poses past nb)
    diag = jnp.einsum("nii->ni", D)
    D = D + jnp.einsum("ni,ij->nij", (diag == 0.0).astype(H.dtype), jnp.eye(G * d, dtype=H.dtype))
    return jnp.linalg.cholesky(D)


def group_jacobi_apply(L, gj: GroupJacobi, r):
    """M^{-1} r via batched triangular solves on the group factors."""
    from jax.scipy.linalg import solve_triangular

    nbd = gj.nb_pad * gj.d
    rp = jnp.zeros(nbd, r.dtype).at[: r.shape[0]].set(r)
    rb = rp.reshape(gj.ng, gj.G * gj.d)
    y = solve_triangular(L, rb[..., None], lower=True)
    z = solve_triangular(jnp.swapaxes(L, -1, -2), y, lower=False)[..., 0]
    return z.reshape(-1)[: r.shape[0]]


# --------------------------------------------------------------------------
# Direct-to-ELL assembly: scatter factor contributions straight into the
# symmetric (nb, K, d, d) neighbor-list layout, with the DIAGONAL block
# pinned at slot k=0 of every row.  This removes three whole passes from the
# LM iteration (separate Marquardt-damping scatter, BCSR->ELL gather, and the
# diagonal-block gather for the preconditioner): damping and the
# preconditioner read He[:, 0] as a pure slice.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EllDirect:
    """Static direct-to-ELL assembly plan (diag at slot 0)."""

    nb: int
    d: int
    K: int
    cols: np.ndarray  # (nb, K) int32, cols[:,0] == arange(nb)
    valid: np.ndarray  # (nb, K)
    # per batch: list of (slot_a, slot_b, flat_pos_ab (F,), flat_pos_ba (F,))
    # where flat positions index (nb*K); for a==b only flat_pos_ab is used
    maps: tuple


def build_ell_direct(graph: FactorGraph, block_name: str | None = None) -> EllDirect:
    """Vectorized (no per-edge Python) — Venice-scale graphs have millions
    of edges, so the plan build is pure numpy sort/searchsorted."""
    if block_name is None:
        (block_name,) = graph.blocks.keys()
    blk = graph.blocks[block_name]
    nb, d = blk.n, blk.dof

    # collect all directed off-diagonal edges across batches
    us, vs = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    batch_pairs = []
    for fb in graph.batches:
        assert all(s == block_name for s in fb.slots)
        idx = [np.asarray(i, np.int64) for i in fb.indices]
        slot_pairs = []
        for a in range(len(idx)):
            for b in range(a, len(idx)):
                ia, ib = idx[a], idx[b]
                if a != b:
                    off = ia != ib
                    us.append(ia[off])
                    vs.append(ib[off])
                    us.append(ib[off])
                    vs.append(ia[off])
                slot_pairs.append((a, b, ia, ib))
        batch_pairs.append(slot_pairs)

    u = np.concatenate(us)
    v = np.concatenate(vs)
    keys = np.unique(u * nb + v)  # sorted unique directed edges
    eu, ev = keys // nb, keys % nb
    row_counts = np.bincount(eu, minlength=nb)
    K = 1 + int(row_counts.max()) if len(keys) else 1
    row_starts = np.concatenate([[0], np.cumsum(row_counts)[:-1]])
    rank = np.arange(len(keys)) - row_starts[eu]  # rank of edge within row
    edge_slot = eu * K + 1 + rank  # flat ELL position of each unique edge

    cols = np.tile(np.arange(nb, dtype=np.int32)[:, None], (1, K))
    valid = np.zeros((nb, K), np.float64)
    valid[:, 0] = 1.0
    cols[eu, 1 + rank] = ev.astype(np.int32)
    valid[eu, 1 + rank] = 1.0

    def lookup(uu, vv):
        """Flat ELL position of (uu, vv); diagonal maps to slot 0."""
        if len(keys) == 0:  # no off-diagonal edges at all: everything is
            return np.asarray(uu) * K  # diagonal (uu == vv by construction)
        pos = np.searchsorted(keys, uu * nb + vv)
        out = edge_slot[np.minimum(pos, len(keys) - 1)]
        return np.where(uu == vv, uu * K, out)

    maps = []
    for slot_pairs in batch_pairs:
        entries = []
        for a, b, ia, ib in slot_pairs:
            if a == b:
                entries.append((a, b, ia * K, None))
            else:
                entries.append((a, b, lookup(ia, ib), lookup(ib, ia)))
        maps.append(tuple(entries))
    return EllDirect(nb, d, K, cols, valid, tuple(maps))


def ell_direct_matvec(He, cols, x):
    """y = H x on a direct-to-ELL store He (nb, K, d, d) with neighbour
    columns ``cols`` (nb, K): one row gather + one batched contraction.
    The CG loop of ``solve_ell`` and dogleg's model evaluation share it."""
    nb, _, d, _ = He.shape
    xg = x.reshape(nb, d)[cols]
    return jnp.einsum("rkij,rkj->ri", He, xg).reshape(-1)


def assemble_ell(graph: FactorGraph, plan: EllDirect):
    """(He (nb, K, d, d), g (nb*d,), chi2) straight from the factor batches."""
    nb, d, K = plan.nb, plan.d, plan.K
    dtype = next(iter(graph.blocks.values())).values.dtype
    He = jnp.zeros((nb * K, d, d), dtype)
    g = jnp.zeros(nb * d, dtype)
    chi2 = jnp.zeros((), dtype)

    for fb, entries in zip(graph.batches, plan.maps):
        r, jacs, w, c2 = linearize_batch(fb, graph.blocks)
        chi2 = chi2 + c2
        wr = w * r
        for slot, idx, J in zip(fb.slots, fb.indices, jacs):
            ga = jnp.einsum("fmi,fm->fi", J, wr)
            rows = idx[:, None] * d + jnp.arange(d, dtype=jnp.int32)[None, :]
            g = g.at[rows.reshape(-1)].add(-ga.reshape(-1))
        for a, b, pos_ab, pos_ba in entries:
            C = jnp.einsum("fmi,fm,fmj->fij", jacs[a], w, jacs[b])
            He = He.at[pos_ab].add(C)
            if pos_ba is not None:
                He = He.at[pos_ba].add(jnp.swapaxes(C, -1, -2))

    He = He.reshape(nb, K, d, d)
    # constant parameters: zero rows/cols, unit diagonal at slot 0
    free = free_mask(graph).astype(dtype).reshape(nb, d)
    He = He * free[:, None, :, None] * free[plan.cols][:, :, None, :]
    eye = jnp.eye(d, dtype=dtype)
    He = He.at[:, 0].add((1.0 - free)[:, :, None] * eye[None])
    g = g * free.reshape(-1)
    return He, g, chi2


def _inv33(A):
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d_, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g_, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g_ - d_ * i
    co11 = a * i - c * g_
    co12 = c * d_ - a * f
    co20 = d_ * h - e * g_
    co21 = b * g_ - a * h
    co22 = a * e - b * d_
    det = a * co00 + b * co10 + c * co20
    inv_det = 1.0 / det
    rows = [
        jnp.stack([co00, co01, co02], axis=-1),
        jnp.stack([co10, co11, co12], axis=-1),
        jnp.stack([co20, co21, co22], axis=-1),
    ]
    return jnp.stack(rows, axis=-2) * inv_det[..., None, None]


def sym_block_inv(D):
    """Batched closed-form inverse of small SPD blocks: adjugate for d<=3,
    blocked 3x3 Schur complement for d=6, Cholesky fallback otherwise.
    Pure vectorized arithmetic, chosen over XLA's batched
    cholesky+triangular-solve at (2500, 6, 6) scale on the accelerator the
    system was first built for; not compared on the H100."""
    d = D.shape[-1]
    if d == 1:
        return 1.0 / D
    if d == 2:
        a, b = D[..., 0, 0], D[..., 0, 1]
        c, e = D[..., 1, 0], D[..., 1, 1]
        det = a * e - b * c
        inv = jnp.stack(
            [jnp.stack([e, -b], -1), jnp.stack([-c, a], -1)], axis=-2
        )
        return inv / det[..., None, None]
    if d == 3:
        return _inv33(D)
    if d == 6:
        A = D[..., :3, :3]
        B = D[..., :3, 3:]
        Cm = D[..., 3:, 3:]
        Ai = _inv33(A)
        AiB = jnp.einsum("...ij,...jk->...ik", Ai, B)
        S = Cm - jnp.einsum("...ji,...jk->...ik", B, AiB)
        Si = _inv33(S)
        TL = Ai + jnp.einsum("...ij,...jk,...lk->...il", AiB, Si, AiB)
        TR = -jnp.einsum("...ij,...jk->...ik", AiB, Si)
        BL = jnp.swapaxes(TR, -1, -2)
        top = jnp.concatenate([TL, TR], axis=-1)
        bot = jnp.concatenate([BL, Si], axis=-1)
        return jnp.concatenate([top, bot], axis=-2)
    # generic fallback
    from jax.scipy.linalg import solve_triangular

    L = jnp.linalg.cholesky(D)
    eye = jnp.broadcast_to(jnp.eye(d, dtype=D.dtype), D.shape)
    Y = solve_triangular(L, eye, lower=True)
    return solve_triangular(jnp.swapaxes(L, -1, -2), Y, lower=False)


# --------------------------------------------------------------------------
# Component-major ELL: stores the system as d*d component vectors over a flat
# (nb*K,) slot axis: strided-slice damping, gather-only matvec of d*d flat
# multiplies.  It was written for an accelerator that pads every (d, d)
# block of the (nb, K, d, d) layout to a large memory tile; the H100 has no
# such padding.  On that accelerator the block layout still won at every
# feasible pose-graph size.  No route uses this variant; solve_ell (block
# layout) is the pose-graph default.  Not measured on the H100.
# --------------------------------------------------------------------------


def assemble_ell_cm(graph: FactorGraph, plan: EllDirect):
    """(He (d*d, nb*K), g (nb*d,), chi2) component-major assembly."""
    nb, d, K = plan.nb, plan.d, plan.K
    dtype = next(iter(graph.blocks.values())).values.dtype
    He = jnp.zeros((d * d, nb * K), dtype)
    g = jnp.zeros(nb * d, dtype)
    chi2 = jnp.zeros((), dtype)

    for fb, entries in zip(graph.batches, plan.maps):
        r, jacs, w, c2 = linearize_batch(fb, graph.blocks)
        chi2 = chi2 + c2
        wr = w * r
        for slot, idx, J in zip(fb.slots, fb.indices, jacs):
            ga = jnp.einsum("fmi,fm->fi", J, wr)
            rows = idx[:, None] * d + jnp.arange(d, dtype=jnp.int32)[None, :]
            g = g.at[rows.reshape(-1)].add(-ga.reshape(-1))
        for a, b, pos_ab, pos_ba in entries:
            Ja, Jb = jacs[a], jacs[b]
            for i in range(d):
                for j in range(d):
                    cij = jnp.sum(Ja[:, :, i] * w * Jb[:, :, j], axis=1)
                    He = He.at[i * d + j, pos_ab].add(cij)
                    if pos_ba is not None:
                        He = He.at[j * d + i, pos_ba].add(cij)

    # constant parameters: zero rows/cols + unit diagonal at slot 0
    free = free_mask(graph).astype(dtype).reshape(nb, d)  # (nb, d)
    free_col = free[plan.cols].reshape(nb * K, d)  # (nb*K, d) column-side
    for i in range(d):
        fr = jnp.repeat(free[:, i], K)  # row-side, broadcast over slots
        for j in range(d):
            He = He.at[i * d + j].multiply(fr * free_col[:, j])
    diag_pos = jnp.arange(nb) * K
    for i in range(d):
        He = He.at[i * d + i, diag_pos].add(1.0 - free[:, i])
    g = g * free.reshape(-1)
    return He, g, chi2


def solve_ell_cm(
    graph: FactorGraph,
    options: _lm.Options = _lm.Options(),
    plan: EllDirect | None = None,
    pcg_rtol: float = 1e-4,
    pcg_max_iters: int = 75,
):
    """GN/LM with component-major ELL storage (see the layout note above
    ``assemble_ell_cm``).  Shares the jitted LM loop."""
    if plan is None:
        plan = build_ell_direct(graph)
    key = ("ell_cm", content_key(plan), pcg_rtol, pcg_max_iters)
    if key not in _CLOSURES:
        nb, d, K = plan.nb, plan.d, plan.K
        cols_flat = jnp.asarray(plan.cols.reshape(-1))

        def assemble_fn(g):
            return assemble_ell_cm(g, plan)

        def solve_fn(He, g, lam, opt):
            if opt.method == "lm":
                # Marquardt damping in place: diagonal blocks live at the
                # strided slot positions r*K
                for i in range(d):
                    comp0 = He[i * d + i, ::K]
                    He = He.at[i * d + i, ::K].set(
                        comp0 + lam * jnp.maximum(comp0, 1e-12)
                    )
            # block-Jacobi from the slot-0 components
            D = He[:, ::K].reshape(d, d, nb)
            Minv = sym_block_inv(jnp.transpose(D, (2, 0, 1)))

            def matvec(x):
                xb = x.reshape(nb, d)
                y = []
                for i in range(d):
                    acc = jnp.zeros(nb * K, He.dtype)
                    for j in range(d):
                        acc = acc + He[i * d + j] * xb[:, j][cols_flat]
                    y.append(jnp.sum(acc.reshape(nb, K), axis=1))
                return jnp.stack(y, axis=1).reshape(-1)

            def precond(r):
                return jnp.einsum("nij,nj->ni", Minv, r.reshape(nb, d)).reshape(-1)

            dx, _ = pcg_solve(
                matvec, g, precond=precond, rtol=pcg_rtol, max_iters=pcg_max_iters
            )
            return dx

        _CLOSURES[key] = (assemble_fn, solve_fn)
    assemble_fn, solve_fn = _CLOSURES[key]
    return _lm.solve(graph, options, assemble_fn=assemble_fn, solve_fn=solve_fn)


def _coarse_groups(graph: FactorGraph, plan: EllDirect, coarse_size: int):
    """(group (nb,), G): BFS aggregation of poses into ~coarse_size groups
    for the two-level preconditioner (reuses the distributed partitioner)."""
    from ..dist.partitioner import partition_poses_bfs

    nb = plan.nb
    valid = plan.valid[:, 1:] > 0
    eu = np.repeat(np.arange(nb, dtype=np.int64), valid.sum(axis=1))
    ev = plan.cols[:, 1:][valid].astype(np.int64)
    und = eu < ev
    G = max(1, -(-nb // coarse_size))
    part = partition_poses_bfs(eu[und], ev[und], nb, G)
    return part.part.astype(np.int32), G


def solve_ell(
    graph: FactorGraph,
    options: _lm.Options = _lm.Options(),
    plan: EllDirect | None = None,
    pcg_rtol: float | None = None,
    pcg_max_iters: int | None = None,
    precond: str = "bj",
    coarse_size: int = 128,
):
    """GN/LM with direct-to-ELL assembly, slice-damping, closed-form
    block-Jacobi PCG — the single-device pose-graph path.  Shares the
    jitted LM trust-region loop (lm.solve).

    CG budget defaults are SIZE-ADAPTIVE: deeper CG means fewer LM
    iterations, and the required depth grows with the graph.  At
    sphere2500, rtol 3e-6 / 120 its reaches the f64 optimum; at 50k poses
    rtol 1e-8 / 600 its reaches the optimum where 1e-4 / 75 STALLED 7.4%
    above it (cost-decrease stop fires on the tiny truncated-CG steps).
    Explicit arguments override.

    ``precond``: "bj" (per-pose block-Jacobi, the default) or
    "two_level" (additive two-level Schwarz: block-Jacobi + a BFS-aggregated
    coarse-graph correction, A_c = P^T A P with piecewise-constant-per-group
    prolongation, dense-factored once per linear solve).  The coarse level
    targets the low-frequency error block-Jacobi cannot damp — the 50k-pose
    regime where plain BJ needs 600 CG iterations."""
    if plan is None:
        plan = build_ell_direct(graph)
    if pcg_rtol is None:
        pcg_rtol = 3e-6 if plan.nb <= 10_000 else 1e-8
    if pcg_max_iters is None:
        pcg_max_iters = min(1000, max(120, plan.nb // 80))
    key = ("ell_direct", content_key(plan), pcg_rtol, pcg_max_iters, precond, coarse_size)
    if key not in _CLOSURES:
        nb, d, K = plan.nb, plan.d, plan.K
        cols = jnp.asarray(plan.cols)
        if precond == "two_level":
            group_np, G = _coarse_groups(graph, plan, coarse_size)
            group = jnp.asarray(group_np)
            # flat coarse destination of every ELL block: (g_row * G + g_col)
            flat_gc = jnp.asarray(
                group_np[:, None].astype(np.int64) * G + group_np[plan.cols]
            ).reshape(-1)
        else:
            group = flat_gc = None
            G = 0

        def assemble_fn(g):
            return assemble_ell(g, plan)

        def matvec_fn(He, x):
            # H @ x on an (optionally damped) ELL store
            return ell_direct_matvec(He, cols, x)

        def solve_fn(He, g, lam, opt):
            from jax.scipy.linalg import cho_solve

            D = He[:, 0]
            if opt.method == "lm":
                diag = jnp.maximum(jnp.einsum("nii->ni", D), 1e-12)
                D = D + lam * diag[:, :, None] * jnp.eye(d, dtype=He.dtype)
                He_d = He.at[:, 0].set(D)
            else:
                He_d = He
            Minv = sym_block_inv(D)

            def matvec(x):
                return matvec_fn(He_d, x)

            if precond == "two_level":
                # A_c = P^T A P: one segment-sum of the ELL blocks per
                # linear solve (invalid ELL slots hold zero blocks -> no
                # mask needed), dense Cholesky of (G*d, G*d)
                Ac = jax.ops.segment_sum(
                    He_d.reshape(nb * K, d, d), flat_gc, num_segments=G * G
                )
                Ac = jnp.transpose(Ac.reshape(G, G, d, d), (0, 2, 1, 3)).reshape(
                    G * d, G * d
                )
                L_c = jnp.linalg.cholesky(Ac)

                def precond_fn(r):
                    rb = r.reshape(nb, d)
                    fine = jnp.einsum("nij,nj->ni", Minv, rb)
                    rc = jax.ops.segment_sum(rb, group, num_segments=G).reshape(-1)
                    xc = cho_solve((L_c, True), rc).reshape(G, d)
                    return (fine + xc[group]).reshape(-1)

            else:

                def precond_fn(r):
                    return jnp.einsum("nij,nj->ni", Minv, r.reshape(nb, d)).reshape(-1)

            dx, _ = pcg_solve(
                matvec, g, precond=precond_fn, rtol=pcg_rtol, max_iters=pcg_max_iters
            )
            return dx

        _CLOSURES[key] = (assemble_fn, solve_fn, matvec_fn)
    assemble_fn, solve_fn, matvec_fn = _CLOSURES[key]
    return _lm.solve(
        graph, options, assemble_fn=assemble_fn, solve_fn=solve_fn, matvec_fn=matvec_fn
    )


# Closure cache so repeated solves on one pattern reuse the jitted LM loop
# (lm.solve treats assemble_fn/solve_fn as static args).  Content-keyed and
# bounded per the plan_cache policy.
_CLOSURES = ClosureCache()


def solve_bcsr(
    graph: FactorGraph,
    options: _lm.Options = _lm.Options(),
    pattern: BlockPattern | None = None,
    pcg_rtol: float = 1e-8,
    pcg_max_iters: int = 250,
    spmv: str = "ell",
    precond_group: int = 1,
):
    """GN/LM with block-sparse assembly + PCG linear solves.  Shares the LM
    trust-region loop with the dense path (lm.solve).

    ``spmv='ell'`` (default) expands the damped system into symmetric ELL
    neighbor lists once per linear solve so each CG matvec is gather-only;
    ``spmv='bcsr'`` uses the two-pass scatter-add matvec on the upper store.
    ``precond_group`` > 1 uses the group block-Jacobi preconditioner over
    that many consecutive poses (1 = classic per-pose block-Jacobi).
    """
    if pattern is None:
        pattern = build_pattern(graph)
    key = ("bcsr", content_key(pattern), pcg_rtol, pcg_max_iters, spmv, precond_group)
    if key in _CLOSURES:
        assemble_fn, solve_fn = _CLOSURES[key]
        return _lm.solve(graph, options, assemble_fn=assemble_fn, solve_fn=solve_fn)

    ell = build_ell(pattern) if spmv == "ell" else None
    gj = build_group_jacobi(pattern, precond_group) if precond_group > 1 else None

    def assemble_fn(g):
        return assemble_bcsr(g, pattern)

    def solve_fn(H, g, lam, opt):
        Hd = damp_blocks(H, pattern, lam) if opt.method == "lm" else H
        nb, d = pattern.nb, pattern.d

        if spmv == "ell":
            He = ell_blocks(Hd, ell)

            def matvec(x):
                return ell_matvec(He, ell, x)

        else:

            def matvec(x):
                return bcsr_matvec(Hd, pattern, x)

        if gj is not None:
            L_g = group_jacobi_factor(Hd, gj)

            def precond(r):
                return group_jacobi_apply(L_g, gj, r)

        else:
            Minv = block_jacobi_inv(Hd, pattern)

            def precond(r):
                return jnp.einsum("nij,nj->ni", Minv, r.reshape(nb, d)).reshape(-1)

        dx, _ = pcg_solve(
            matvec, g, precond=precond, rtol=pcg_rtol, max_iters=pcg_max_iters
        )
        return dx

    _CLOSURES[key] = (assemble_fn, solve_fn)
    return _lm.solve(graph, options, assemble_fn=assemble_fn, solve_fn=solve_fn)
