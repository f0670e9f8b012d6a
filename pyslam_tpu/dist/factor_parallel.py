"""Factor-parallel (data-parallel analogue) sharded solving.

Strategy (SURVEY.md §2.3 row 'DP'): residual blocks (factors) of one graph
are sharded across chips along the factor axis; every chip evaluates its
factors' residuals/Jacobians and local Hessian/gradient contributions, which
are summed with ``psum`` over the mesh; the (small) reduced linear solve and
manifold update run replicated.  Variable blocks are replicated — the
variable-sharded path lives in schur_reduce.py / partitioner.py.

Everything is expressed with shard_map over a Mesh, so the same code runs on
an 8-device CPU test mesh and on several GPUs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..graph.core import FactorBatch, FactorGraph
from ..solver.assemble import assemble_dense
from ..solver.linear import cholesky_solve, damp_marquardt
from ..solver import lm as _lm


def pad_batch(fb: FactorBatch, multiple: int) -> FactorBatch:
    """Pad a factor batch to a multiple of ``multiple`` with zero-weight
    (provably inert) factors."""
    n = fb.n
    pad = (-n) % multiple
    if pad == 0:
        return fb
    idx = tuple(jnp.concatenate([i, jnp.zeros(pad, i.dtype)]) for i in fb.indices)
    data = {
        k: (jnp.concatenate([v, jnp.repeat(v[:1], pad, axis=0)]) if hasattr(v, "ndim") and v.ndim >= 1 and v.shape[0] == n else v)
        for k, v in fb.data.items()
    }
    weight = jnp.concatenate([fb.weight, jnp.zeros(pad, fb.weight.dtype)])
    return FactorBatch(fb.kind, fb.slots, idx, data, fb.loss, weight)


def _batch_specs(fb: FactorBatch, axis: str):
    """PartitionSpec pytree matching a FactorBatch: factor-axis leaves
    sharded, everything else (cameras, loss params) replicated."""
    n = fb.n

    def spec_of(leaf):
        if hasattr(leaf, "ndim") and leaf.ndim >= 1 and leaf.shape[0] == n:
            return P(axis)
        return P()

    return jax.tree_util.tree_map(spec_of, fb)


def shard_graph(graph: FactorGraph, mesh: Mesh, axis: str = "f"):
    """Pad every batch to the mesh size and build the in_specs pytree."""
    n_dev = mesh.shape[axis]
    batches = [pad_batch(fb, n_dev) for fb in graph.batches]
    g = FactorGraph(graph.blocks, batches)
    block_specs = jax.tree_util.tree_map(lambda _: P(), dict(g.blocks))
    batch_specs = [_batch_specs(fb, axis) for fb in batches]
    return g, (block_specs, batch_specs)


def make_sharded_lm_step(graph: FactorGraph, mesh: Mesh, options: _lm.Options, axis: str = "f"):
    """Build (step_fn, sharded_graph): one factor-parallel LM iteration.

    step_fn(blocks, batches, lam) -> (new_blocks, chi2, cost_new, dx_norm)
    with factor shards evaluated locally and H/g/chi2 psum-reduced — the
    multi-chip 'training step' of this framework.
    """
    g, (block_specs, batch_specs) = shard_graph(graph, mesh, axis)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(block_specs, tuple(batch_specs), P()),
        out_specs=(block_specs, P(), P(), P()),
        check_vma=False,
    )
    def step(blocks, batches, lam):
        local = FactorGraph(dict(blocks), list(batches))
        H, grad, chi2 = assemble_dense(local)
        H = jax.lax.psum(H, axis)
        grad = jax.lax.psum(grad, axis)
        chi2 = jax.lax.psum(chi2, axis)
        # NOTE: assemble_dense adds the frozen-dof unit diagonal per shard, so
        # psum makes it n_dev instead of 1 — still SPD with dx=0 there.
        # Dead-dof handling happens HERE, after the psum (a dof dead on one
        # shard may be live globally).
        from ..solver.assemble import unit_diag_where_dead

        H = unit_diag_where_dead(H)
        if options.method == "lm":
            H = damp_marquardt(H, lam)
        dx = cholesky_solve(H, grad)
        new_blocks = local.retract_all(dx).blocks
        cost_new = jax.lax.psum(
            FactorGraph(dict(new_blocks), list(batches)).chi2(), axis
        )
        return dict(new_blocks), chi2, cost_new, jnp.linalg.norm(dx)

    return step, g


def solve_factor_parallel(
    graph: FactorGraph, mesh: Mesh, options: _lm.Options = _lm.Options(), axis: str = "f"
):
    """Full LM solve with factor-parallel sharded iterations: host loop over
    jitted sharded steps via the shared host_lm_loop (solver/lm.py
    semantics)."""
    from ..solver.host_loop import host_lm_loop

    step, g = make_sharded_lm_step(graph, mesh, options, axis)
    step = jax.jit(step)
    batches = tuple(g.batches)
    lam_dtype = jnp.result_type(float)

    def lm_step(blocks, lam):
        new_blocks, chi2, cost_new, dx_norm = step(
            blocks, batches, jnp.asarray(lam, lam_dtype)
        )
        return new_blocks, chi2, cost_new, dx_norm

    best_blocks, history, _info = host_lm_loop(lm_step, dict(g.blocks), options)
    final = FactorGraph(best_blocks, list(batches))
    return final, float(final.chi2()), history
