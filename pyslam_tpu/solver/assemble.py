"""Normal-equation assembly: H = J^T W J, g = -J^T W r, chi2.

On-device replacement for the reference's scipy.sparse.bmat + explicit
J^T J products (pyslam/problem.py solve_one_iter, SURVEY.md §3.1 hot loops
2-3).  The robust IRLS weight (loss.weight, elementwise — reference
semantics) is fused into the same pass, so residual evaluation, reweighting,
and Hessian-block accumulation are one XLA fusion per factor kind.

This module is the dense path (reduced systems and small/medium graphs —
benchmark configs #1/#2).  The block-sparse BCSR path lives in bcsr.py.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..graph.core import FactorGraph


def linearize_batch(fb, blocks):
    """Evaluate one factor batch: residuals, Jacobians, fused IRLS weights,
    and its robustified cost contribution."""
    r, jacs = fb.evaluate(blocks, compute_jacobians=True)
    # Static-shape sanity: a kernel's per-slot Jacobian width must equal
    # the slot's manifold dof.  Without this, a mis-declared variable (e.g.
    # a raw (3, 3) pose matrix inferred as a 9-dof euclidean block where
    # the kernel expects an se2 pose) scatters 3 Jacobian columns into a
    # 9-dof block and converges to silent garbage (measured: non-rigid
    # 'pose' matrices).  Trace-time check — free at run time.
    for s, (slot, J) in enumerate(zip(fb.slots, jacs)):
        dof = blocks[slot].dof
        if J.shape[-1] != dof:
            raise ValueError(
                f"factor kind {fb.kind!r} slot {s} ({slot!r}): Jacobian "
                f"width {J.shape[-1]} != block dof {dof} (kind "
                f"{blocks[slot].kind!r}).  A Lie-group parameter passed as "
                f"a raw array is inferred 'euclidean' — wrap it in the "
                f"matching group type (SE2/SE3/Sim3/...)"
            )
    w = fb.loss.weight(r) * fb.weight[:, None]
    chi2 = jnp.sum(fb.loss.loss(r) * fb.weight[:, None])
    return r, jacs, w, chi2


def _row_indices(offset, idx, dof):
    """Global tangent indices for a slot: (F, dof)."""
    return offset + idx[:, None] * dof + jnp.arange(dof, dtype=jnp.int32)[None, :]


def free_mask(graph: FactorGraph) -> jnp.ndarray:
    """(D,) bool — False where the variable element is held constant."""
    segs = []
    for b in graph.blocks.values():
        segs.append(jnp.repeat(~b.const_mask, b.dof))
    return jnp.concatenate(segs) if segs else jnp.zeros(0, bool)


def assemble_dense(graph: FactorGraph):
    """Full dense H (D, D), g (D,), chi2 — one scatter-add pass per factor
    kind.  Constant parameters get zeroed rows/cols and a unit diagonal so
    their tangent update is exactly 0."""
    D = graph.total_dof
    offsets = graph.offsets()
    dtype = next(iter(graph.blocks.values())).values.dtype
    H = jnp.zeros((D, D), dtype)
    g = jnp.zeros(D, dtype)
    chi2 = jnp.zeros((), dtype)

    for fb in graph.batches:
        r, jacs, w, c2 = linearize_batch(fb, graph.blocks)
        chi2 = chi2 + c2
        wr = w * r
        rows_per_slot = []
        for slot, idx, J in zip(fb.slots, fb.indices, jacs):
            dof = J.shape[-1]
            rows = _row_indices(offsets[slot], idx, dof)
            rows_per_slot.append(rows)
            ga = jnp.einsum("fmi,fm->fi", J, wr)
            g = g.at[rows.reshape(-1)].add(-ga.reshape(-1))
        for a in range(len(fb.slots)):
            Ja, rows_a = jacs[a], rows_per_slot[a]
            for b in range(a, len(fb.slots)):
                Jb, rows_b = jacs[b], rows_per_slot[b]
                C = jnp.einsum("fmi,fm,fmj->fij", Ja, w, Jb)
                rr = rows_a[:, :, None]
                cc = rows_b[:, None, :]
                H = H.at[rr, cc].add(C)
                if b != a:
                    H = H.at[cc.swapaxes(-1, -2), rr.swapaxes(-1, -2)].add(
                        C.swapaxes(-1, -2)
                    )

    free = free_mask(graph).astype(dtype)
    H = H * free[:, None] * free[None, :]
    H = H + jnp.diag(1.0 - free)
    # NOTE: dead free dofs (no factor touches them) keep their zero diagonal
    # HERE — fixing them per-assembly would corrupt the factor-parallel path,
    # where shard-local assemblies are psum'd and a dof dead on one shard is
    # live globally.  Consumers that factorize a FULLY-REDUCED H apply
    # unit_diag_where_dead just before the factorization.
    g = g * free
    return H, g, chi2


def unit_diag_where_dead(H):
    """H + unit diagonal on exactly-zero diagonal entries: dead free dofs
    (e.g. an unobserved landmark) keep Cholesky/covariance defined; their
    gradient is 0 so their update stays exactly 0 — the dense-path analogue
    of ba_assemble's dead_l handling.  Apply ONLY to a fully-reduced H
    (after any cross-shard psum)."""
    return H + jnp.diag((jnp.diagonal(H) == 0.0).astype(H.dtype))


def gradient_and_chi2(graph: FactorGraph):
    """g and chi2 without forming H (used by diagnostics)."""
    D = graph.total_dof
    offsets = graph.offsets()
    dtype = next(iter(graph.blocks.values())).values.dtype
    g = jnp.zeros(D, dtype)
    chi2 = jnp.zeros((), dtype)
    for fb in graph.batches:
        r, jacs, w, c2 = linearize_batch(fb, graph.blocks)
        chi2 = chi2 + c2
        wr = w * r
        for slot, idx, J in zip(fb.slots, fb.indices, jacs):
            dof = J.shape[-1]
            rows = _row_indices(offsets[slot], idx, dof)
            ga = jnp.einsum("fmi,fm->fi", J, wr)
            g = g.at[rows.reshape(-1)].add(-ga.reshape(-1))
    g = g * free_mask(graph).astype(dtype)
    return g, chi2
