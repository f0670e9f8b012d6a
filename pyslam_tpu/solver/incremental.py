"""Incremental smoothing with bucketed static shapes — the device-side iSAM answer.

iSAM2 exists because CPU solvers must avoid refactoring the whole system
per update, so they maintain a Bayes tree incrementally.  On this hardware
the economics are different: a full batch solve of a 2k-pose graph is
milliseconds once compiled (bench.py measurements), and the expensive
resource is COMPILATION, which XLA charges per shape.  So the device-side
incremental design is not incremental factorization but SHAPE REUSE:

  * variables and factors live in padded arrays whose capacity grows
    geometrically (x1.5 buckets); padding variables are const-masked and
    padding factors carry weight 0 (both proven inert — the padding
    metamorphic tests in tests/test_solver.py);
  * every update between capacity changes re-enters the SAME jitted solve
    executable (same shapes, same factor-batch structure) warm-started
    from the previous estimate, so per-step cost is one cached dispatch;
  * compilation happens O(log N) times over a whole trajectory instead of
    once per step.

Old state can be retired with ``marginalize_oldest`` (graph/marginalize.py
dense FEJ priors), which keeps the active dof bounded like a fixed-lag
window but under the caller's control.  The reference has no incremental
story at all (batch Problem only, SURVEY.md §2.1); fixed_lag.py covers the
constant-window case — this class covers the growing-graph case.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..graph.core import FactorBatch, FactorGraph, VariableBlock
from ..losses import L2Loss
from . import lm as _lm


def _bucket(n: int, cap: int, grow: float = 1.5) -> int:
    while cap < n:
        cap = int(np.ceil(cap * grow))
    return cap


class IncrementalSmoother:
    """Growing pose-graph smoother with geometric capacity buckets.

    kind: 'se3' | 'se2' | 'sim3'.  Factors are between-factors of that
    kind plus optional unary priors; the first pose is the gauge anchor.
    ``update()`` solves the current graph warm-started from the previous
    estimate and returns (values, SolveInfo).

    Landmark SLAM (online BA / the iSAM use case): construct with
    ``obs_kind`` ('bearing_range_se2' | 'landmark_xy_se2' | 'reprojection'
    | any registered (pose, landmark) kernel with {obs, sqrt_info} data)
    and stream ``add_landmark`` / ``add_observation`` alongside poses.
    Two-block graphs solve through solve_auto's Schur routing; the same
    bucketed-capacity shape reuse applies to the landmark and observation
    stores.  ``obs_dim``/``lm_dim`` default from the kind; ``obs_extras``
    carries static per-batch data (e.g. the camera pytree for
    'reprojection').
    """

    _OBS_DEFAULTS = {
        "bearing_range_se2": (2, 2),  # (obs_dim, lm_dim)
        "landmark_xy_se2": (2, 2),
        "reprojection": (3, 3),
        "reprojection_bal": (2, 3),
    }

    def __init__(self, kind: str = "se3", options: _lm.Options | None = None,
                 init_capacity: int = 16, dtype=jnp.float64,
                 obs_kind: str | None = None, obs_dim: int | None = None,
                 lm_dim: int | None = None, obs_extras: dict | None = None):
        from ..graph.core import MANIFOLDS

        if kind not in ("se3", "se2", "sim3"):
            raise ValueError(f"unsupported kind {kind!r}")
        self.kind = kind
        self.dtype = dtype
        self.opts = options or _lm.Options(method="lm", max_iters=15)
        m = MANIFOLDS[kind]
        self._mat = m["shape"][0]
        self._dof = m["dof"]
        self.n = 0  # live poses
        self.cap = init_capacity
        eye = np.eye(self._mat)
        self._T = np.tile(eye, (self.cap, 1, 1))
        self._const = np.ones(self.cap, bool)  # padding slots frozen
        # factor storage (between factors)
        self.m = 0
        self.fcap = init_capacity
        self._fi = np.zeros(self.fcap, np.int32)
        self._fj = np.zeros(self.fcap, np.int32)
        self._T_obs = np.tile(eye, (self.fcap, 1, 1))
        self._S = np.tile(np.eye(self._dof), (self.fcap, 1, 1))
        self._w = np.zeros(self.fcap)
        # landmark + observation storage (obs_kind graphs only)
        self.obs_kind = obs_kind
        self.obs_extras = dict(obs_extras or {})
        if obs_kind is not None:
            od, ld = self._OBS_DEFAULTS.get(obs_kind, (None, None))
            self.obs_dim = obs_dim if obs_dim is not None else od
            self.lm_dim = lm_dim if lm_dim is not None else ld
            if self.obs_dim is None or self.lm_dim is None:
                raise ValueError(
                    f"obs_kind {obs_kind!r} needs explicit obs_dim/lm_dim"
                )
            self.nl = 0  # live landmarks
            self.lcap = init_capacity
            # safe padding value: keeps every registered kernel finite on
            # padded slots (0 * inf = NaN would poison chi2 — the
            # schur_reduce safe-fill lesson); unit-z for projective kernels
            self._lm_safe = np.zeros(self.lm_dim)
            self._lm_safe[-1] = 1.0
            self._L = np.tile(self._lm_safe, (self.lcap, 1))
            self._lconst = np.ones(self.lcap, bool)
            self.mo = 0  # live observations
            self.ocap = init_capacity
            self._oi = np.zeros(self.ocap, np.int32)  # pose index
            self._oj = np.zeros(self.ocap, np.int32)  # landmark index
            self._obs = np.zeros((self.ocap, self.obs_dim))
            self._obs[:, -1] = 1.0  # nonzero range/depth keeps kernels finite
            self._oS = np.tile(np.eye(self.obs_dim), (self.ocap, 1, 1))
            self._ow = np.zeros(self.ocap)
        self.compiles = 0  # fresh-executable count (structure-key changes)
        self._prior_batches: list = []  # carried marginalization priors
        self._handed_off = False  # host arrays aliased by device since last copy

    # ------------------------------------------------------------ building
    _HOST_ARRAYS = ("_T", "_const", "_fi", "_fj", "_T_obs", "_S", "_w",
                    "_L", "_lconst", "_oi", "_oj", "_obs", "_oS", "_ow")

    def _cow(self):
        """Copy-on-write ONCE per device handoff (CLAUDE.md zero-copy
        aliasing rule) — copying on every add would be O(N^2)."""
        if self._handed_off:
            for name in self._HOST_ARRAYS:
                if hasattr(self, name):
                    setattr(self, name, getattr(self, name).copy())
            self._handed_off = False

    def add_pose(self, T_init) -> int:
        if self.n == self.cap:
            new = _bucket(self.n + 1, self.cap)
            padT = np.tile(np.eye(self._mat), (new - self.cap, 1, 1))
            self._T = np.concatenate([self._T, padT])
            self._const = np.concatenate([self._const, np.ones(new - self.cap, bool)])
            self.cap = new
        i = self.n
        self._cow()
        self._T[i] = np.asarray(T_init)
        self._const[i] = i == 0  # anchor stays const
        self.n += 1
        return i

    def add_between(self, i: int, j: int, T_obs, sqrt_info):
        if self.m == self.fcap:
            new = _bucket(self.m + 1, self.fcap)
            g = new - self.fcap
            self._fi = np.concatenate([self._fi, np.zeros(g, np.int32)])
            self._fj = np.concatenate([self._fj, np.zeros(g, np.int32)])
            self._T_obs = np.concatenate(
                [self._T_obs, np.tile(np.eye(self._mat), (g, 1, 1))]
            )
            self._S = np.concatenate([self._S, np.tile(np.eye(self._dof), (g, 1, 1))])
            self._w = np.concatenate([self._w, np.zeros(g)])
            self.fcap = new
        k = self.m
        self._cow()
        self._fi[k], self._fj[k] = i, j
        self._T_obs[k] = np.asarray(T_obs)
        self._S[k] = np.asarray(sqrt_info)
        self._w[k] = 1.0
        self.m += 1

    def add_landmark(self, l_init) -> int:
        if self.obs_kind is None:
            raise ValueError("construct with obs_kind=... for landmark SLAM")
        if self.nl == self.lcap:
            new = _bucket(self.nl + 1, self.lcap)
            pad = np.tile(self._lm_safe, (new - self.lcap, 1))
            self._L = np.concatenate([self._L, pad])
            self._lconst = np.concatenate(
                [self._lconst, np.ones(new - self.lcap, bool)]
            )
            self.lcap = new
        j = self.nl
        self._cow()
        self._L[j] = np.asarray(l_init)
        self._lconst[j] = False
        self.nl += 1
        return j

    def add_observation(self, pose_i: int, lm_j: int, obs, sqrt_info):
        if self.obs_kind is None:
            raise ValueError("construct with obs_kind=... for landmark SLAM")
        if self.mo == self.ocap:
            new = _bucket(self.mo + 1, self.ocap)
            g = new - self.ocap
            # replicate row 0 into the padding (weight 0 masks it; a valid
            # row keeps any kernel finite — 0 * inf = NaN otherwise)
            self._oi = np.concatenate([self._oi, np.full(g, self._oi[0], np.int32)])
            self._oj = np.concatenate([self._oj, np.full(g, self._oj[0], np.int32)])
            self._obs = np.concatenate([self._obs, np.tile(self._obs[0], (g, 1))])
            self._oS = np.concatenate([self._oS, np.tile(self._oS[0], (g, 1, 1))])
            self._ow = np.concatenate([self._ow, np.zeros(g)])
            self.ocap = new
        k = self.mo
        self._cow()
        self._oi[k], self._oj[k] = pose_i, lm_j
        self._obs[k] = np.asarray(obs)
        self._oS[k] = np.asarray(sqrt_info)
        self._ow[k] = 1.0
        if k == 0:
            # retro-fill the initial padding with the first valid row
            self._oi[1:] = pose_i
            self._oj[1:] = lm_j
            self._obs[1:] = self._obs[0]
            self._oS[1:] = self._oS[0]
        self.mo += 1

    def _graph(self, n=None, m=None, nl=None, mo=None) -> FactorGraph:
        """Padded graph at full capacities (default) or compacted to exact
        live sizes (explicit n/m/nl/mo — the marginalization path)."""
        sl = slice(None, n)
        blocks = {
            "poses": VariableBlock(
                self.kind,
                jnp.asarray(self._T[sl], self.dtype),
                jnp.asarray(self._const[sl]),
            )
        }
        fsl = slice(None, m)
        batches = [
            FactorBatch(
                f"between_{self.kind}",
                ("poses", "poses"),
                (jnp.asarray(self._fi[fsl]), jnp.asarray(self._fj[fsl])),
                {
                    "T_obs": jnp.asarray(self._T_obs[fsl], self.dtype),
                    "sqrt_info": jnp.asarray(self._S[fsl], self.dtype),
                },
                L2Loss(),
                jnp.asarray(self._w[fsl], self.dtype),
            )
        ]
        if self.obs_kind is not None:
            lsl, osl = slice(None, nl), slice(None, mo)
            blocks["landmarks"] = VariableBlock(
                "euclidean",
                jnp.asarray(self._L[lsl], self.dtype),
                jnp.asarray(self._lconst[lsl]),
            )
            data = {
                "obs": jnp.asarray(self._obs[osl], self.dtype),
                "sqrt_info": jnp.asarray(self._oS[osl], self.dtype),
            }
            data.update(self.obs_extras)
            batches.append(
                FactorBatch(
                    self.obs_kind,
                    ("poses", "landmarks"),
                    (jnp.asarray(self._oi[osl]), jnp.asarray(self._oj[osl])),
                    data,
                    L2Loss(),
                    jnp.asarray(self._ow[osl], self.dtype),
                )
            )
        return FactorGraph(blocks, batches + self._prior_batches)

    # ------------------------------------------------------------- solving
    def update(self):
        """Solve the current graph warm-started from the last estimate.
        Same-capacity updates hit the jit cache (one dispatch); capacity
        growth triggers one fresh compile and is counted in .compiles.
        Landmark graphs dispatch through solve_auto (Schur routing)."""
        g = self._graph()
        self._handed_off = True
        # the jit cache keys on shapes + pytree structure: capacities AND
        # every carried prior batch's data shapes
        key = (
            self.cap,
            self.fcap,
            (self.lcap, self.ocap) if self.obs_kind is not None else None,
            tuple(
                (fb.kind, tuple(sorted((k, np.shape(v)) for k, v in fb.data.items())))
                for fb in self._prior_batches
            ),
        )
        if key != getattr(self, "_last_key", None):
            self.compiles += 1
            self._last_key = key
        if self.obs_kind is not None:
            # Schur routing needs every batch in the (p,), (l,), (p,p),
            # (p,l) patterns; marginalization priors over a mixed
            # pose+landmark blanket are multi-slot — those graphs take the
            # generic dense assembly (window-scale after marginalization)
            schur_ok = all(
                set(fb.slots) <= {"poses", "landmarks"} and len(fb.slots) <= 2
                and fb.slots != ("landmarks", "poses")
                for fb in self._prior_batches
            )
            if schur_ok:
                from . import solve_auto

                # schur_sparse_pair_budget=0: the sparse-Schur plan is
                # content-keyed on the observation index arrays, so routing
                # there would rebuild the plan AND recompile the LM loop on
                # EVERY update (and the weight-0 padding rows inflate the
                # pair count right after capacity growth) — exactly what
                # this class's shape-reuse design exists to avoid.  Dense-S
                # and SCHUR_JACOBI PCG closures are shape-stable.
                solved, info = solve_auto(g, self.opts, schur_sparse_pair_budget=0)
            else:
                solved, info = _lm.solve(g, self.opts)
            self._L = np.array(solved.blocks["landmarks"].values)
        else:
            solved, info = _lm.solve(g, self.opts)
        self._T = np.array(solved.blocks["poses"].values)  # host mirror copy
        self._handed_off = False  # _T/_L are fresh copies; factor arrays unchanged
        return self._T[: self.n], info

    def poses(self):
        return self._T[: self.n].copy()

    def landmarks(self):
        if self.obs_kind is None:
            raise ValueError("no landmark block (construct with obs_kind=...)")
        return self._L[: self.nl].copy()

    def pose_marginals(self):
        """(n, dof, dof) marginal covariances of the live poses at the
        current estimate — the online gating/uncertainty readout.  Pose-only
        graphs use the exact multifrontal selected inversion; landmark
        graphs use S-solves on the reduced camera system; graphs carrying
        multi-slot marginalization priors fall back to the dense inverse
        (window-scale after marginalization)."""
        import numpy as np_

        g = self._graph(
            n=self.n, m=self.m,
            nl=self.nl if self.obs_kind is not None else None,
            mo=self.mo if self.obs_kind is not None else None,
        )
        dof = self._dof
        if self.obs_kind is None and all(
            len(set(fb.slots)) == 1 for fb in self._prior_batches
        ):
            from .covariance import marginal_covariances_direct

            return np_.asarray(marginal_covariances_direct(g))
        if self.obs_kind is not None and all(
            fb.slots in (("poses",), ("poses", "poses"), ("poses", "landmarks"))
            for fb in self._prior_batches
        ):
            from .covariance import pose_marginal_covariances

            return np_.asarray(pose_marginal_covariances(g))
        from .covariance import full_covariance

        Sig = np_.asarray(full_covariance(g))
        off = g.offsets()["poses"]
        return np_.stack(
            [Sig[off + i * dof : off + (i + 1) * dof,
                 off + i * dof : off + (i + 1) * dof] for i in range(self.n)]
        )

    # -------------------------------------------------------- marginalizing
    def marginalize_oldest(self, keep_last: int):
        """Retire old poses into a dense FEJ prior (graph/marginalize.py),
        keeping the gauge anchor (pose 0) plus the newest ``keep_last``
        poses.  Note: this REINDEXES poses (1 becomes the oldest kept
        non-anchor pose) and changes the graph structure, so the next
        update compiles fresh."""
        from ..graph.marginalize import marginalize

        if self.n <= keep_last:
            return
        # compact to live sizes first (marginalize works on exact arrays)
        live = self._graph(n=self.n, m=self.m, nl=self.nl if self.obs_kind else None,
                           mo=self.mo if self.obs_kind else None)
        # the anchor must survive (marginalize refuses const targets): retire
        # poses 1 .. n-keep_last-1, keeping 0 plus the newest keep_last
        targets = list(range(1, self.n - keep_last))
        g2 = marginalize(live, {"poses": targets})
        blk = g2.blocks["poses"]
        n_new = blk.n
        self.n = n_new
        self.cap = _bucket(n_new, 16)
        eye = np.eye(self._mat)
        self._T = np.tile(eye, (self.cap, 1, 1))
        self._T[:n_new] = np.asarray(blk.values)
        self._const = np.ones(self.cap, bool)
        self._const[:n_new] = np.asarray(blk.const_mask)
        # split surviving batches back into between/observation storage +
        # carried priors (observations of retired poses were consumed into
        # the dense prior; surviving ones keep their landmark)
        self._prior_batches = []
        bi, bj, bT, bS, bw = [], [], [], [], []
        oi, oj, oo, oS, ow = [], [], [], [], []
        for fb in g2.batches:
            if fb.kind == f"between_{self.kind}":
                bi.append(np.asarray(fb.indices[0]))
                bj.append(np.asarray(fb.indices[1]))
                bT.append(np.asarray(fb.data["T_obs"]))
                bS.append(np.asarray(fb.data["sqrt_info"]))
                bw.append(np.asarray(fb.weight))
            elif self.obs_kind is not None and fb.kind == self.obs_kind:
                oi.append(np.asarray(fb.indices[0]))
                oj.append(np.asarray(fb.indices[1]))
                oo.append(np.asarray(fb.data["obs"]))
                oS.append(np.asarray(fb.data["sqrt_info"]))
                ow.append(np.asarray(fb.weight))
            else:
                self._prior_batches.append(fb)
        self.m = sum(len(x) for x in bi)
        self.fcap = _bucket(max(self.m, 1), 16)
        self._fi = np.zeros(self.fcap, np.int32)
        self._fj = np.zeros(self.fcap, np.int32)
        self._T_obs = np.tile(eye, (self.fcap, 1, 1))
        self._S = np.tile(np.eye(self._dof), (self.fcap, 1, 1))
        self._w = np.zeros(self.fcap)
        if self.m:
            self._fi[: self.m] = np.concatenate(bi)
            self._fj[: self.m] = np.concatenate(bj)
            self._T_obs[: self.m] = np.concatenate(bT)
            self._S[: self.m] = np.concatenate(bS)
            self._w[: self.m] = np.concatenate(bw)
        if self.obs_kind is not None:
            lblk = g2.blocks["landmarks"]
            self.nl = lblk.n
            self.lcap = _bucket(max(self.nl, 1), 16)
            self._L = np.tile(self._lm_safe, (self.lcap, 1))
            self._L[: self.nl] = np.asarray(lblk.values)
            self._lconst = np.ones(self.lcap, bool)
            self._lconst[: self.nl] = np.asarray(lblk.const_mask)
            self.mo = sum(len(x) for x in oi)
            self.ocap = _bucket(max(self.mo, 1), 16)
            self._oi = np.zeros(self.ocap, np.int32)
            self._oj = np.zeros(self.ocap, np.int32)
            self._obs = np.zeros((self.ocap, self.obs_dim))
            self._obs[:, -1] = 1.0
            self._oS = np.tile(np.eye(self.obs_dim), (self.ocap, 1, 1))
            self._ow = np.zeros(self.ocap)
            if self.mo:
                self._oi[: self.mo] = np.concatenate(oi)
                self._oj[: self.mo] = np.concatenate(oj)
                self._obs[: self.mo] = np.concatenate(oo)
                self._oS[: self.mo] = np.concatenate(oS)
                self._ow[: self.mo] = np.concatenate(ow)
                # safe padding: replicate the first surviving row
                self._oi[self.mo:] = self._oi[0]
                self._oj[self.mo:] = self._oj[0]
                self._obs[self.mo:] = self._obs[0]
                self._oS[self.mo:] = self._oS[0]
