"""Debug & validation utilities — the on-device analogue of the sanitizer
row in SURVEY.md §5: under XLA's functional model there are no data races;
the corresponding hazards are NaN/Inf propagation and shape/index bugs.

  * ``nan_debug()``      — context manager flipping ``jax_debug_nans`` (XLA
    re-runs the offending primitive un-jitted and points at it).
  * ``validate_graph``   — host-side structural lint of a FactorGraph:
    index ranges, shape agreement, weight/mask sanity, finite values.
    Returns a list of human-readable problems (empty = clean).
"""

from __future__ import annotations

import contextlib

import jax
import numpy as np


@contextlib.contextmanager
def nan_debug(enable: bool = True):
    """Enable jax_debug_nans inside the block (slow; debugging only)."""
    old = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", old)


def validate_graph(graph) -> list[str]:
    """Structural lint for a FactorGraph; returns a list of problems."""
    problems: list[str] = []
    from .graph.core import FACTOR_KERNELS, MANIFOLDS, manifold_dof

    for name, b in graph.blocks.items():
        vals = np.asarray(b.values)
        if b.kind != "euclidean" and b.kind not in MANIFOLDS:
            problems.append(f"block {name!r}: unknown manifold kind {b.kind!r}")
            continue
        if b.kind != "euclidean":
            want = MANIFOLDS[b.kind]["shape"]
            if vals.shape[1:] != want:
                problems.append(
                    f"block {name!r}: element shape {vals.shape[1:]} != {want} for {b.kind}"
                )
        if not np.isfinite(vals).all():
            problems.append(f"block {name!r}: non-finite values")
        cm = np.asarray(b.const_mask)
        if cm.shape != (vals.shape[0],) or cm.dtype != np.bool_:
            problems.append(f"block {name!r}: const_mask shape/dtype mismatch")

    for bi, fb in enumerate(graph.batches):
        tag = f"batch {bi} ({fb.kind!r})"
        if fb.kind not in FACTOR_KERNELS:
            problems.append(f"{tag}: unregistered factor kind")
        if len(fb.slots) != len(fb.indices):
            problems.append(f"{tag}: {len(fb.slots)} slots vs {len(fb.indices)} index arrays")
            continue
        n = fb.n
        for slot, idx in zip(fb.slots, fb.indices):
            if slot not in graph.blocks:
                problems.append(f"{tag}: slot {slot!r} is not a variable block")
                continue
            iv = np.asarray(idx)
            if iv.shape != (n,):
                problems.append(f"{tag}: index array for slot {slot!r} has shape {iv.shape}, want ({n},)")
            nb = graph.blocks[slot].n
            if iv.size and (iv.min() < 0 or iv.max() >= nb):
                problems.append(
                    f"{tag}: indices for slot {slot!r} out of range [0, {nb}) "
                    f"(min {iv.min()}, max {iv.max()})"
                )
        w = np.asarray(fb.weight)
        if w.shape != (n,):
            problems.append(f"{tag}: weight shape {w.shape}, want ({n},)")
        elif not np.isfinite(w).all() or (w < 0).any():
            problems.append(f"{tag}: weights must be finite and >= 0")
        for k, v in fb.data.items():
            arr_like = hasattr(v, "ndim")
            if arr_like and getattr(v, "ndim", 0) >= 1 and v.shape[0] == n:
                if not np.isfinite(np.asarray(v)).all():
                    problems.append(f"{tag}: data[{k!r}] has non-finite entries")
    return problems


def assert_graph_valid(graph) -> None:
    problems = validate_graph(graph)
    if problems:
        raise ValueError("invalid FactorGraph:\n  " + "\n  ".join(problems))


__all__ = ["nan_debug", "validate_graph", "assert_graph_valid"]
