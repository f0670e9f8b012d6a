"""Ceres-style Problem API — parity with ``pyslam/problem.py``
(SURVEY.md §2.1/§3.1): ``Options``, ``Problem`` with ``add_residual_block``,
``initialize_params``, ``set_parameters_constant/variable``, ``solve``,
``solve_one_iter``, ``eval_cost``, ``compute_covariance``,
``get_covariance_block``.

On-device lowering: where the reference iterates residual blocks in Python
(hot loop 1, SURVEY.md §3.1), this builder groups blocks by factor kind into
struct-of-arrays FactorBatches, packs named parameters into contiguous
VariableBlocks per manifold, and runs the fully-jitted GN/LM core
(solver/lm.py).  The user-facing semantics (names, losses per block, constant
params, update convention) match the reference exactly.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .graph.core import FactorBatch, FactorGraph, VariableBlock
from .lie.groups import SE2, SE3, SO2, SO3, Sim3, _LieGroupBase
from .losses import L2Loss
from .residuals import DensePriorResidual as _DensePriorResidual
from .solver import lm
from .solver.assemble import assemble_dense
from .solver.linear import cholesky_solve

# Re-export the solver Options under the reference's name.
Options = lm.Options

_WRAPPERS = {"se2": SE2, "se3": SE3, "so2": SO2, "so3": SO3, "sim3": Sim3}
_KIND_OF = {SE2: "se2", SE3: "se3", SO2: "so2", SO3: "so3", Sim3: "sim3"}


def _param_kind(value):
    for cls, kind in _KIND_OF.items():
        if isinstance(value, cls):
            return kind
    return "euclidean"


@dataclasses.dataclass
class _ParamSlot:
    block: str
    index: int
    kind: str
    shape: tuple
    wrapper: type | None


class Problem:
    """Builds and solves a nonlinear least-squares problem (reference API)."""

    def __init__(self, options: Options | None = None, dtype=None):
        self.options = options or Options()
        if dtype is None:
            dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        self.dtype = dtype
        self.param_dict: dict = {}
        self.residual_blocks: list = []  # (residual, param_keys, loss)
        self.constant_param_keys: set = set()
        self.summary: lm.SolveInfo | None = None
        self._graph = None
        self._slots: dict[str, _ParamSlot] = {}

    # ------------------------------------------------------------ building
    def add_residual_block(self, residual, param_keys, loss=None):
        if isinstance(param_keys, str):
            param_keys = [param_keys]
        self.residual_blocks.append((residual, list(param_keys), loss or L2Loss()))
        self._graph = None

    def initialize_params(self, param_dict: dict):
        self.param_dict.update(param_dict)
        self._graph = None

    def set_parameters_constant(self, param_keys):
        if isinstance(param_keys, str):
            param_keys = [param_keys]
        self.constant_param_keys.update(param_keys)
        self._graph = None

    def set_parameters_variable(self, param_keys):
        if isinstance(param_keys, str):
            param_keys = [param_keys]
        self.constant_param_keys.difference_update(param_keys)
        self._graph = None

    # ------------------------------------------------------------ lowering
    def _build(self) -> FactorGraph:
        if self._graph is not None:
            return self._graph

        # 1. pack named params into per-(kind, shape) variable blocks
        groups: dict = {}
        self._slots = {}
        for name, value in self.param_dict.items():
            kind = _param_kind(value)
            arr = np.asarray(value.mat if isinstance(value, _LieGroupBase) else value)
            key = (kind, arr.shape)
            groups.setdefault(key, []).append((name, arr))
        blocks = {}
        for (kind, shape), members in groups.items():
            bname = f"{kind}_{'x'.join(map(str, shape)) or 'scalar'}"
            vals = np.stack([m[1] for m in members]).astype(self.dtype)
            const = np.array([m[0] in self.constant_param_keys for m in members])
            blocks[bname] = VariableBlock.create(kind, jnp.asarray(vals), const)
            for i, (name, _) in enumerate(members):
                wrapper = type(self.param_dict[name]) if isinstance(
                    self.param_dict[name], _LieGroupBase
                ) else None
                self._slots[name] = _ParamSlot(bname, i, kind, shape, wrapper)

        # 2. group residual blocks into factor batches
        def loss_key(loss):
            return (type(loss).__name__,) + tuple(
                (f.name, getattr(loss, f.name)) for f in dataclasses.fields(loss)
            )

        from .solver.plan_cache import content_key

        batch_groups: dict = {}
        for residual, keys, loss in self.residual_blocks:
            # early, named validation of parameter manifolds: a Lie pose
            # passed as a raw array is inferred 'euclidean' and would
            # otherwise fail deep in assembly (or, before that check
            # existed, silently corrupt the solve)
            expected = getattr(residual, "param_kinds", ())
            if expected and len(expected) == len(keys):
                for kind_e, key in zip(expected, keys):
                    got = self._slots[key].kind
                    if kind_e != got:
                        raise ValueError(
                            f"residual {type(residual).__name__} expects a "
                            f"{kind_e!r} parameter but {key!r} was "
                            f"initialized as {got!r}"
                            + (
                                " — wrap the value in the matching group "
                                "type (pyslam_tpu.SE2/SE3/Sim3)"
                                if got == "euclidean"
                                else ""
                            )
                        )
            data = residual.batch_data()
            cam = data.pop("camera", None)
            # content key (not id): identical cameras merge into one batch
            gkey = (residual.factor_kind, loss_key(loss), content_key(cam) if cam is not None else None)
            batch_groups.setdefault(gkey, dict(items=[], loss=loss, camera=cam)).setdefault(
                "kind", residual.factor_kind
            )
            batch_groups[gkey]["items"].append((data, keys))

        batches = []
        for gkey, grp in batch_groups.items():
            items = grp["items"]
            data0 = items[0][0]
            stacked = {
                k: jnp.asarray(np.stack([np.asarray(it[0][k]) for it in items]), self.dtype)
                for k in data0
            }
            if grp["camera"] is not None:
                stacked["camera"] = grp["camera"]
            n_slots = len(items[0][1])
            indices = []
            slot_names = []
            for s in range(n_slots):
                slot = [self._slots[it[1][s]] for it in items]
                slot_names.append(slot[0].block)
                indices.append(np.array([sl.index for sl in slot], np.int32))
            batches.append(
                FactorBatch.create(
                    grp["kind"], tuple(slot_names), tuple(indices), stacked, grp["loss"]
                )
            )

        self._graph = FactorGraph(blocks, batches)
        return self._graph

    def _writeback(self, graph: FactorGraph):
        for name, slot in self._slots.items():
            val = graph.blocks[slot.block].values[slot.index]
            if slot.wrapper is not None:
                self.param_dict[name] = slot.wrapper(val)
            else:
                self.param_dict[name] = val
        self._graph = graph

    # ------------------------------------------------------------ solving
    def solve(self, mesh=None) -> dict:
        """Optimize all free parameters; returns the updated param_dict
        (reference Problem.solve).  Dispatches to the structure-appropriate
        linear-algebra path (dense / block-sparse PCG / Schur / sharded) —
        the reference always pays scipy's generic spsolve.  With ``mesh``
        (a jax.sharding.Mesh) the solve also picks among the sharding
        strategies by graph shape and per-device memory (solver.route_auto);
        ``summary`` is then the cost history of the sharded host loop."""
        from .solver import solve_auto

        graph = self._build()
        solved, info = solve_auto(graph, self.options, mesh=mesh)
        self.summary = info
        self._writeback(solved)
        return self.param_dict

    def solve_one_iter(self):
        """One GN/LM step (reference Problem.solve_one_iter); returns the
        update norm."""
        graph = self._build()
        solved, dx, _ = lm.solve_one_iter(graph, self.options)
        self._writeback(solved)
        return float(jnp.linalg.norm(dx))

    def marginalize_parameters(self, param_keys):
        """Remove parameters, folding the information of every residual
        block that touches them into a dense Gaussian prior over their
        Markov blanket (graph/marginalize.py — keyframe/landmark culling
        for long-term problems; beyond-reference).

        The prior becomes an ordinary residual block, so the Problem stays
        fully rebuildable: more blocks/params can be added afterwards and
        solve/covariance work unchanged."""
        from .graph.marginalize import marginalize as _marginalize

        if isinstance(param_keys, str):
            param_keys = [param_keys]
        graph = self._build()
        targets: dict = {}
        for k in param_keys:
            slot = self._slots[k]
            targets.setdefault(slot.block, []).append(slot.index)
        g2 = _marginalize(graph, targets)

        # inverse index remap (marginalize drops rows and shifts indices)
        inv_remap = {}
        for bname, blk in graph.blocks.items():
            drop = set(targets.get(bname, []))
            new_i = 0
            for old_i in range(blk.n):
                if old_i in drop:
                    continue
                inv_remap[(bname, new_i)] = old_i
                new_i += 1
        name_of = {(s.block, s.index): n for n, s in self._slots.items()}

        priors = [fb for fb in g2.batches if fb.kind.startswith("dense_prior__")]
        removed = set(param_keys)
        # g2's dense-prior batches are the CANONICAL set: pre-existing
        # priors pass through marginalize() (possibly merged/consumed), so
        # every existing DensePriorResidual is dropped here and rebuilt
        # from g2 — keeping them too would double-count their information
        # on every disjoint marginalization.
        self.residual_blocks = [
            rb
            for rb in self.residual_blocks
            if not (set(rb[1]) & removed)
            and not isinstance(rb[0], _DensePriorResidual)
        ]
        for fb in priors:
            for f in range(fb.n):  # _build stacks same-kind priors: F >= 1
                if float(fb.weight[f]) == 0.0:
                    continue
                blanket_names = [
                    name_of[(bn, inv_remap[(bn, int(ix[f]))])]
                    for bn, ix in zip(fb.slots, fb.indices)
                ]
                kinds = tuple(self._slots[n].kind for n in blanket_names)
                data = {k: v[f] for k, v in fb.data.items()}
                self.residual_blocks.append(
                    (
                        _DensePriorResidual(fb.kind, kinds, data),
                        blanket_names,
                        L2Loss(),
                    )
                )
        for k in param_keys:
            del self.param_dict[k]
            self.constant_param_keys.discard(k)
        self._graph = None

    def eval_cost(self, param_dict: dict | None = None) -> float:
        """Robustified total cost at the current (or given) params
        (reference Problem.eval_cost)."""
        if param_dict is not None:
            saved = dict(self.param_dict)
            self.param_dict.update(param_dict)
            self._graph = None
            cost = float(self._build().chi2())
            self.param_dict = saved
            self._graph = None
            return cost
        return float(self._build().chi2())

    # ----------------------------------------------------------- covariance
    def compute_covariance(self, dense_dof_limit: int = 8192):
        """Posterior covariance = (J^T W J)^-1 over free parameters
        (reference Problem.compute_covariance — SURVEY.md §3.4).

        At or below ``dense_dof_limit`` total dof the full (D, D) matrix is
        materialized by Cholesky solves against identity columns (reference
        behavior).  Beyond it NO dense (D, D) is ever formed: covariance
        goes lazy and ``get_covariance_block`` answers per-block queries via
        selective PCG column solves (single variable block: the ELL system,
        solver/covariance.covariance_block; pose pairs of a camera+landmark
        graph: the reduced Schur system, pose_covariance_block).  Returns
        the dense matrix, or None in lazy mode."""
        graph = self._build()
        if graph.total_dof <= dense_dof_limit:
            from .solver.assemble import unit_diag_where_dead

            H, _, _ = assemble_dense(graph)
            H = unit_diag_where_dead(H)
            eye = jnp.eye(H.shape[0], dtype=H.dtype)
            self._covariance = cholesky_solve(H, eye)
        else:
            self._covariance = None
        return self._covariance

    def get_covariance_block(self, param_key_1: str, param_key_2: str):
        """Covariance block between two named parameters (reference API).
        Works in both dense and lazy modes (see compute_covariance)."""
        if not hasattr(self, "_covariance"):
            self.compute_covariance()
        graph = self._build()

        if self._covariance is None:  # lazy: selective solves, no (D, D)
            from .solver.covariance import (
                covariance_block,
                landmark_covariance_block,
                pose_covariance_block,
                pose_landmark_covariance_block,
            )

            s1, s2 = self._slots[param_key_1], self._slots[param_key_2]
            kinds = {n: b.kind for n, b in graph.blocks.items()}
            if len(graph.blocks) == 1:
                return covariance_block(graph, s1.index, s2.index)
            lie = [n for n, k in kinds.items() if k != "euclidean"]
            euc = [n for n, k in kinds.items() if k == "euclidean"]
            # same hardened BA-shape gate as route_auto: the Schur
            # covariance helpers need an actual (pose, landmark) batch —
            # 2-block graphs coupled only by other arities (e.g.
            # switchable-style factors) must fall through to the error
            if (
                len(graph.blocks) == 2
                and len(lie) == 1
                and len(euc) == 1
                and any(fb.slots == (lie[0], euc[0]) for fb in graph.batches)
            ):
                # where the solve gate says S is sparse, S-solves go through
                # the factored sparse S — exact, no PCG tolerance
                from .solver import route_auto

                m = "sparse" if route_auto(graph) == "schur_sparse" else "pcg"
                kw = dict(pose_name=lie[0], lm_name=euc[0], method=m)
                if s1.block == lie[0] and s2.block == lie[0]:
                    return pose_covariance_block(graph, s1.index, s2.index, **kw)
                if s1.block == euc[0] and s2.block == euc[0]:
                    return landmark_covariance_block(graph, s1.index, s2.index, **kw)
                if s1.block == lie[0] and s2.block == euc[0]:
                    return pose_landmark_covariance_block(
                        graph, s1.index, s2.index, **kw
                    )
                if s1.block == euc[0] and s2.block == lie[0]:
                    return pose_landmark_covariance_block(
                        graph, s2.index, s1.index, **kw
                    ).T
            raise ValueError(
                "lazy covariance supports single-block graphs and "
                "camera+landmark graphs; raise dense_dof_limit for other "
                "block structures"
            )

        offsets = graph.offsets()

        def span(name):
            slot = self._slots[name]
            dof = graph.blocks[slot.block].dof
            start = offsets[slot.block] + slot.index * dof
            return start, start + dof

        a0, a1 = span(param_key_1)
        b0, b1 = span(param_key_2)
        return self._covariance[a0:a1, b0:b1]


__all__ = ["Problem", "Options"]
