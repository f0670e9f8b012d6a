"""Factor-graph core: variables and factors as struct-of-arrays batches.

This is the on-device replacement for the reference's per-block Python object
model (pyslam/problem.py residual-block list per SURVEY.md §3.1 hot loop 1):
heterogeneity lives in a *static* dict of typed batches, each evaluated by one
broadcast-batched kernel; there is no per-factor Python anywhere on the hot
path.

Data model
----------
* ``VariableBlock`` — N manifold elements of one kind stored contiguously
  (e.g. all SE(3) poses as one (N, 4, 4) array) with a per-element
  constant mask (reference ``set_parameters_constant``).
* ``FactorBatch``   — F factors of one kind: per-slot index arrays into the
  variable blocks, a dict of measurement arrays, a robust loss, and a
  per-factor weight (0 for padding — SURVEY.md §7 "static shapes").
* ``FactorGraph``   — ordered blocks + batches; knows the global tangent
  layout (block offsets) and provides linearize / chi2 / retract.

All three are registered pytrees whose static structure (kinds, slots, names,
shapes) lives in aux_data, so a whole GN/LM solve jit-compiles once per graph
structure.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp

from ..lie import se2, se3, sim3, so2, so3

# --------------------------------------------------------------------------
# Manifolds
# --------------------------------------------------------------------------

_EUCLIDEAN = "euclidean"


def _retract_euclidean(x, dx):
    return x + dx.reshape(x.shape)


MANIFOLDS: dict[str, dict[str, Any]] = {
    "se3": dict(dof=6, retract=lambda T, dx: se3.perturb(T, dx), shape=(4, 4)),
    "se2": dict(dof=3, retract=lambda T, dx: se2.perturb(T, dx), shape=(3, 3)),
    "so3": dict(dof=3, retract=lambda R, dx: so3.perturb(R, dx), shape=(3, 3)),
    "so2": dict(dof=1, retract=lambda R, dx: so2.perturb(R, dx[..., 0]), shape=(2, 2)),
    "sim3": dict(dof=7, retract=lambda S, dx: sim3.perturb(S, dx), shape=(4, 4)),
}


def _retract_bal_cam9(v, dx):
    """Product manifold SE(3) x R^3 for the full BAL camera (pose + [f, k1,
    k2] intrinsics), stored flat as (..., 19) = [vec(T) (16), f, k1, k2].
    Keeping pose and intrinsics in ONE 9-dof block preserves the two-block
    camera/landmark structure every Schur path assumes (solver/schur.py is
    dof-generic), instead of introducing a third block kind."""
    T = v[..., :16].reshape(v.shape[:-1] + (4, 4))
    T = se3.perturb(T, dx[..., :6])
    intr = v[..., 16:] + dx[..., 6:]
    return jnp.concatenate([T.reshape(v.shape[:-1] + (16,)), intr], axis=-1)


MANIFOLDS["bal_cam9"] = dict(dof=9, retract=_retract_bal_cam9, shape=(19,))


def manifold_dof(kind: str, element_shape) -> int:
    if kind == _EUCLIDEAN:
        size = 1
        for s in element_shape:
            size *= s
        return size
    return MANIFOLDS[kind]["dof"]


def retract(kind: str, values, dx):
    """Batched manifold update: Lie kinds use the reference's left-mult
    convention exp(dx) * T (pyslam/problem.py ``_update_params``)."""
    if kind == _EUCLIDEAN:
        return _retract_euclidean(values, dx.reshape(values.shape))
    return MANIFOLDS[kind]["retract"](values, dx)


# --------------------------------------------------------------------------
# Variable blocks
# --------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class VariableBlock:
    """N manifold elements stored contiguously.

    kind:       'se3' | 'se2' | 'so3' | 'so2' | 'euclidean'  (static)
    values:     (N, *element_shape)
    const_mask: (N,) bool — True freezes the element (zero update)
    """

    kind: str
    values: jnp.ndarray
    const_mask: jnp.ndarray

    @classmethod
    def create(cls, kind: str, values, const_mask=None):
        values = jnp.asarray(values)
        if const_mask is None:
            const_mask = jnp.zeros(values.shape[0], dtype=bool)
        return cls(kind, values, jnp.asarray(const_mask))

    @property
    def n(self) -> int:
        return self.values.shape[0]

    @property
    def dof(self) -> int:
        return manifold_dof(self.kind, self.values.shape[1:])

    def tree_flatten(self):
        return (self.values, self.const_mask), self.kind

    @classmethod
    def tree_unflatten(cls, kind, children):
        return cls(kind, *children)


# --------------------------------------------------------------------------
# Factor batches
# --------------------------------------------------------------------------

# kind -> fn(data: dict, *vals) -> (r (F, m), jacs tuple[(F, m, dof_slot)])
FACTOR_KERNELS: dict[str, Callable] = {}


def register_factor(kind: str):
    def deco(fn):
        FACTOR_KERNELS[kind] = fn
        return fn

    return deco


def register_autodiff_factor(kind: str, residual_fn: Callable, manifolds: tuple):
    """Register a factor kind whose Jacobians come from jax autodiff — the
    Ceres AutoDiffCostFunction ergonomic (the reference is 'modelled after
    Ceres', SURVEY.md §0): users add factor types by writing ONLY the
    batched residual.

    ``residual_fn(data, *vals) -> (F, m)`` evaluates the residual batch;
    ``manifolds`` names each slot's kind ('se3', 'sim3', 'euclidean', ...).
    Jacobians are taken w.r.t. the SAME left-perturbation / retraction each
    manifold's solver update uses (``retract``), so autodiff factors and
    analytic factors are interchangeable in every solver path.  The trick:
    one shared eps perturbs every row of a slot at once — each factor's
    residual depends only on its own row, so ``jacfwd`` yields exactly the
    per-factor (F, m, dof) blocks with no vmap.

    RESTRICTION: row f of the residual must depend ONLY on row f of each
    slot (the standard factor-graph contract).  A residual that couples
    rows — e.g. normalizing by a batch statistic like
    ``r / jnp.std(r)`` — silently folds every other row's derivative into
    each block under the shared-eps trick.  ``check_autodiff_factor``
    verifies the contract on concrete data; run it once in the factor's
    test.

    Cost vs analytic kernels: one extra forward trace per slot at jit time
    and jvp arithmetic at run time (typically ~2x the analytic kernel's
    linearization flops) — measure before using on a hot path; for
    prototyping and long-tail factor types it is the right trade.
    """

    def kernel(data, *vals, compute_jacobians=True):
        r = residual_fn(data, *vals)
        if not compute_jacobians:
            return r, None
        jacs = []
        for i, kind_i in enumerate(manifolds):
            dof = manifold_dof(kind_i, vals[i].shape[1:])

            def f(eps, i=i, kind_i=kind_i, dof=dof):
                vs = list(vals)
                dx = jnp.broadcast_to(eps, (vs[i].shape[0], dof))
                vs[i] = retract(kind_i, vs[i], dx)
                return residual_fn(data, *vs)

            jacs.append(jax.jacfwd(f)(jnp.zeros(dof, vals[i].dtype)))
        return r, tuple(jacs)

    FACTOR_KERNELS[kind] = kernel
    return kernel


def check_autodiff_factor(kind: str, data: dict, *vals, atol: float = 1e-6):
    """Verify an autodiff-registered factor obeys the row-independence
    contract: perturbing ONLY row 0 of each slot must change only row 0 of
    the residual.  Raises ValueError on cross-row coupling (which would
    make register_autodiff_factor's shared-eps Jacobians silently wrong).
    Call once from the factor's test with representative data."""
    import numpy as np

    kernel = FACTOR_KERNELS[kind]
    r0, _ = kernel(data, *vals, compute_jacobians=False)
    for i, v in enumerate(vals):
        eps = 1e-4 * (1.0 + jnp.arange(v[0].size, dtype=r0.dtype)).reshape(v.shape[1:])
        v_pert = v.at[0].set(v[0] + eps.astype(v.dtype))
        vs = list(vals)
        vs[i] = v_pert
        r1, _ = kernel(data, *vs, compute_jacobians=False)
        other = np.abs(np.asarray(r1[1:] - r0[1:])).max() if r0.shape[0] > 1 else 0.0
        if other > atol:
            raise ValueError(
                f"factor {kind!r} slot {i}: residual rows are coupled "
                f"(perturbing row 0 moved other rows by {other:.2e}) — "
                "register_autodiff_factor's Jacobians are invalid for it"
            )


def register_closed_kernel(kind: str, static_data: dict) -> str:
    """Register (or reuse) a kernel closing over non-factor-axis static data
    (e.g. an unbatched camera pytree) and return its registry name.

    The name is a content hash of ``static_data``, NOT id() of the caller's
    batch: jitted callers cache compiled code keyed on this string, so a
    recycled id() with different static data would silently reuse stale
    constants, and id()-keyed entries would grow the registry per solve.
    Content keying makes repeated prepares on identical data share one
    entry and makes distinct data collision-free."""
    import hashlib

    import numpy as np

    leaves, treedef = jax.tree_util.tree_flatten(static_data)
    h = hashlib.sha1(repr((kind, str(treedef))).encode())
    for leaf in leaves:
        arr = np.asarray(leaf)
        h.update(str((arr.dtype.str, arr.shape)).encode())
        h.update(arr.tobytes())
    kname = f"__closed_{kind}_{h.hexdigest()[:16]}"
    if kname not in FACTOR_KERNELS:
        base = dict(static_data)

        def kernel(data, *vals, compute_jacobians=True):
            return FACTOR_KERNELS[kind](
                {**data, **base}, *vals, compute_jacobians=compute_jacobians
            )

        FACTOR_KERNELS[kname] = kernel
    return kname


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class FactorBatch:
    """F factors of one kind over the same variable-slot pattern.

    kind:    registered kernel name                        (static)
    slots:   variable-block names, one per parameter slot  (static)
    indices: per-slot (F,) int32 arrays into the blocks
    data:    measurement arrays, each (F, ...)             (keys static)
    loss:    robust M-estimator (pytree; applied elementwise, reference
             semantics per pyslam/losses.py)
    weight:  (F,) float — 1 for live factors, 0 for padding
    """

    kind: str
    slots: tuple
    indices: tuple
    data: dict
    loss: Any
    weight: jnp.ndarray

    @classmethod
    def create(cls, kind, slots, indices, data, loss, weight=None):
        indices = tuple(jnp.asarray(i, jnp.int32) for i in indices)
        if weight is None:
            weight = jnp.ones(indices[0].shape[0], dtype=jnp.float32)
        return cls(kind, tuple(slots), indices, dict(data), loss, jnp.asarray(weight))

    @property
    def n(self) -> int:
        return self.indices[0].shape[0]

    def evaluate(self, blocks: dict, compute_jacobians: bool = True):
        """Gather slot values and run the batched residual kernel."""
        vals = [blocks[name].values[idx] for name, idx in zip(self.slots, self.indices)]
        return FACTOR_KERNELS[self.kind](self.data, *vals, compute_jacobians=compute_jacobians)

    def tree_flatten(self):
        keys = tuple(sorted(self.data))
        children = (self.indices, tuple(self.data[k] for k in keys), self.loss, self.weight)
        return children, (self.kind, self.slots, keys)

    @classmethod
    def tree_unflatten(cls, aux, children):
        kind, slots, keys = aux
        indices, data_vals, loss, weight = children
        return cls(kind, slots, indices, dict(zip(keys, data_vals)), loss, weight)


# --------------------------------------------------------------------------
# Factor graph
# --------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class FactorGraph:
    """Ordered variable blocks + factor batches, with the global tangent
    layout.  The on-device analogue of the reference's ``Problem`` state
    (param_dict + block list, pyslam/problem.py per SURVEY.md §2.1)."""

    blocks: dict  # name -> VariableBlock (SORTED name order = tangent order)
    batches: list  # FactorBatch

    def __post_init__(self):
        # Canonical sorted-by-name block order.  jit normalizes raw dict
        # pytrees to sorted key order, so any other convention silently
        # permutes the tangent layout the moment blocks ride through a
        # lax.while_loop state (as they do in solver/lm.py) — sorting at
        # construction makes the layout identical inside and outside jit.
        names = list(self.blocks)
        if names != sorted(names):
            self.blocks = {k: self.blocks[k] for k in sorted(names)}

    # ---- layout ----
    def offsets(self) -> dict:
        off, cur = {}, 0
        for name, b in self.blocks.items():
            off[name] = cur
            cur += b.n * b.dof
        return off

    @property
    def total_dof(self) -> int:
        return sum(b.n * b.dof for b in self.blocks.values())

    # ---- evaluation ----
    def chi2(self) -> jnp.ndarray:
        """Robustified total cost: sum of loss.loss over all (weighted)
        residual elements — the reference's ``eval_cost`` semantics."""
        total = 0.0
        for fb in self.batches:
            r, _ = fb.evaluate(self.blocks, compute_jacobians=False)
            total = total + jnp.sum(fb.loss.loss(r) * fb.weight[:, None])
        return total

    def retract_all(self, dx: jnp.ndarray) -> "FactorGraph":
        """Apply a global tangent update, respecting constant masks."""
        new_blocks = {}
        cur = 0
        for name, b in self.blocks.items():
            d = b.dof
            seg = dx[cur : cur + b.n * d].reshape(b.n, d)
            seg = jnp.where(b.const_mask[:, None], 0.0, seg)
            new_blocks[name] = VariableBlock(b.kind, retract(b.kind, b.values, seg), b.const_mask)
            cur += b.n * d
        return FactorGraph(new_blocks, self.batches)

    def with_values(self, blocks: dict) -> "FactorGraph":
        return FactorGraph(blocks, self.batches)

    def tree_flatten(self):
        names = tuple(self.blocks)
        return (tuple(self.blocks[n] for n in names), tuple(self.batches)), names

    @classmethod
    def tree_unflatten(cls, names, children):
        block_vals, batches = children
        return cls(dict(zip(names, block_vals)), list(batches))
