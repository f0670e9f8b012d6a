"""Observability & checkpointing (SURVEY.md §5): per-iteration JSONL solve
logs, profiling helpers, and solver-state snapshot/resume.

The reference has none of this (its only observability is TrajectoryMetrics
plots); these are the on-device equivalents mandated for the build:

  * iteration logs come post-hoc from the stacked per-iteration arrays the
    jitted LM loop already records (SolveInfo) — zero host round-trips
    during the solve;
  * profiling wraps ``jax.profiler.trace`` (Perfetto/TensorBoard);
  * checkpoints serialize the small solver-state pytree with ``np.savez``;
    resume is exact because the solve loop is a pure function of state.
"""

from __future__ import annotations

import contextlib
import json
import time

import jax
import numpy as np


# --------------------------------------------------------------------------
# Iteration logging
# --------------------------------------------------------------------------


def iteration_records(info) -> list[dict]:
    """Expand a solver SolveInfo into one dict per executed iteration."""
    n = int(info.iterations)
    cost = np.asarray(info.cost_history)
    lam = np.asarray(info.lambda_history)
    dx = np.asarray(info.update_norms)
    acc = np.asarray(info.accepted)
    recs = []
    for it in range(n):
        recs.append(
            {
                "iter": it,
                "cost_before": float(cost[it]),
                "cost_after": float(cost[it + 1]),
                "lambda": float(lam[it]),
                "update_norm": float(dx[it]),
                "accepted": bool(acc[it]),
            }
        )
    return recs


def write_iteration_log(info, path: str, extra: dict | None = None) -> None:
    """JSONL per-iteration solve log (chi2, lambda, |dx|, accepted) plus a
    final summary line."""
    with open(path, "w") as f:
        for rec in iteration_records(info):
            if extra:
                rec.update(extra)
            f.write(json.dumps(rec) + "\n")
        f.write(
            json.dumps(
                {
                    "summary": True,
                    "chi2": float(info.chi2),
                    "iterations": int(info.iterations),
                    "status": int(info.status),
                }
            )
            + "\n"
        )


# --------------------------------------------------------------------------
# Profiling
# --------------------------------------------------------------------------


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Capture a device trace viewable in Perfetto/TensorBoard."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(label: str, sink: dict | None = None):
    """Wall-clock a block (device work must be block_until_ready'd by the
    caller for accuracy)."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[label] = dt


# --------------------------------------------------------------------------
# Checkpoint / resume
# --------------------------------------------------------------------------


def save_state(path: str, pytree) -> None:
    """Snapshot any pytree of arrays (solver state, factor graph values)."""
    leaves, treedef = jax.tree_util.tree_flatten(pytree)
    np.savez(
        path,
        __treedef__=np.frombuffer(str(treedef).encode(), dtype=np.uint8),
        **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)},
    )


def load_state(path: str, like):
    """Restore a pytree saved by save_state; ``like`` supplies the treedef
    (checkpoints are value snapshots, not schema migrations)."""
    data = np.load(path)
    leaves_like, treedef = jax.tree_util.tree_flatten(like)
    leaves = [data[f"leaf_{i}"] for i in range(len(leaves_like))]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def graph_checkpoint(graph) -> dict:
    """Minimal resumable state of a FactorGraph: the variable values."""
    return {name: np.asarray(b.values) for name, b in graph.blocks.items()}


def graph_restore(graph, ckpt: dict):
    """Rebuild a FactorGraph with checkpointed variable values."""
    from .graph.core import FactorGraph, VariableBlock
    import jax.numpy as jnp

    blocks = {
        name: VariableBlock(b.kind, jnp.asarray(ckpt[name]), b.const_mask)
        for name, b in graph.blocks.items()
    }
    return FactorGraph(blocks, graph.batches)


__all__ = [
    "iteration_records",
    "write_iteration_log",
    "profile_trace",
    "timed",
    "save_state",
    "load_state",
    "graph_checkpoint",
    "graph_restore",
]
