"""Fixed-lag smoother: sliding-window GN with dense marginalization prior.

Online estimation the batch API can't give you: a bounded window of the
most recent poses is optimized every frame, and poses leaving the window
are MARGINALIZED (not dropped) — their information is folded into a dense
Gaussian prior on the remaining window via a Schur complement, with
first-estimate (frozen) linearization points.  The reference has no
counterpart (pyslam solves batch problems only, SURVEY.md §2.1); this is
the fixed-lag design of production smoothers (iSAM2-style fixed-lag /
OKVIS / VIO sliding windows).

Device shape
---------
* Static shapes everywhere: the window is padded to exactly ``window``
  poses and ``capacity`` factors (weight 0 = hole), so ONE compiled update
  and ONE compiled marginalization serve the entire sequence — two device
  dispatches per frame regardless of trajectory length (dispatch count,
  not flops, is what matters at this scale — CLAUDE.md VO lessons).
* The window GN step reuses the standard kernel + ``assemble_dense`` path
  (graph/factor_defs.py, solver/assemble.py): at window scale (W*dof of a
  few hundred) the dense Hessian factorization is pure dense-matrix work.
* Factor bookkeeping (slot ids, insert pointers) lives on host in numpy —
  it is O(window) per frame and shapes the device call, never rides in it.

Prior convention: cost_p(x) = 1/2 eta^T Hp eta + bp^T eta with
eta_i = log(T_i * Tlin_i^-1) the LEFT tangent offset from the frozen
linearization point — matching the left-perturbation convention of every
kernel in graph/factor_defs.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.core import FactorBatch, FactorGraph, VariableBlock
from ..lie import se2, se3, sim3
from ..losses import L2Loss
from .assemble import assemble_dense

_OPS = {"se3": se3, "se2": se2, "sim3": sim3}
_DOF = {"se3": 6, "se2": 3, "sim3": 7}
_MAT = {"se3": 4, "se2": 3, "sim3": 4}


class FixedLagSmoother:
    """Sliding-window pose smoother with dense marginalization.

    window:    number of poses kept live.
    capacity:  max factors simultaneously in the window (default 6/pose).
    kind:      'se3' | 'se2' | 'sim3' (scale-drift-aware windows).
    gn_iters:  GN iterations per ``update`` call (static; one dispatch).
    anchor_sqrt_info: the world frame is fixed by a strong unary prior on
        the first pose folded into the marginalization prior (a constant
        first pose would leave the prior rank-deficient after it leaves
        the window).
    """

    def __init__(
        self,
        window: int = 16,
        kind: str = "se3",
        capacity: int | None = None,
        gn_iters: int = 3,
        anchor_sqrt_info: float = 1e3,
        damping: float = 1e-9,
        dtype=jnp.float32,
    ):
        if kind not in _OPS:
            raise ValueError(f"kind must be one of {sorted(_OPS)}")
        self.window = int(window)
        self.kind = kind
        self.capacity = int(capacity if capacity is not None else 6 * window)
        self.gn_iters = int(gn_iters)
        self.damping = float(damping)
        self.dtype = dtype
        W, d, m = self.window, _DOF[kind], _MAT[kind]
        self._d, self._m = d, m

        # device state
        eye = np.tile(np.eye(m), (W, 1, 1))
        self.T = jnp.asarray(eye, dtype)
        self.Tlin = jnp.asarray(eye, dtype)
        self.Hp = jnp.zeros((W * d, W * d), dtype)
        self.bp = jnp.zeros(W * d, dtype)
        C = self.capacity
        self.T_obs = jnp.tile(jnp.eye(m, dtype=dtype), (C, 1, 1))
        self.sqrt_info = jnp.tile(jnp.eye(d, dtype=dtype), (C, 1, 1))
        self.fw = jnp.zeros(C, dtype)

        # host mirrors (shape the device call; never ride in it)
        self.fi = np.zeros(C, np.int32)
        self.fj = np.zeros(C, np.int32)
        self._slot_free = np.ones(C, bool)
        self.count = 0  # live poses
        self.first_id = 0  # absolute id of window slot 0
        self._anchor_si = float(anchor_sqrt_info)
        self._update_jit = None
        self._marg_jit = None

    # ------------------------------------------------------------------
    # host-side bookkeeping
    # ------------------------------------------------------------------
    @property
    def next_id(self) -> int:
        """Absolute id the next added pose will get."""
        return self.first_id + self.count

    def window_ids(self):
        return range(self.first_id, self.first_id + self.count)

    def poses(self) -> np.ndarray:
        """(count, m, m) current window estimates, oldest first."""
        return np.asarray(self.T[: self.count])

    def pose(self, abs_id: int) -> np.ndarray:
        s = abs_id - self.first_id
        if not 0 <= s < self.count:
            raise KeyError(f"pose {abs_id} not in window [{self.first_id}, {self.next_id})")
        return np.asarray(self.T[s])

    def _alloc_slot(self) -> int:
        free = np.flatnonzero(self._slot_free)
        if free.size == 0:
            raise RuntimeError(
                f"factor capacity {self.capacity} exhausted; raise `capacity`"
            )
        return int(free[0])

    def _set_pose(self, slot: int, T_new):
        self.T = self.T.at[slot].set(jnp.asarray(T_new, self.dtype))
        self.Tlin = self.Tlin.at[slot].set(jnp.asarray(T_new, self.dtype))

    # ------------------------------------------------------------------
    # graph construction API
    # ------------------------------------------------------------------
    def add_pose(self, T_init) -> int:
        """Append a pose at an explicit initial estimate; returns its
        absolute id.  Marginalizes the oldest pose first if the window is
        full.  The first pose is anchored (world frame) via the prior."""
        if self.count == self.window:
            self._marginalize_oldest()
        slot = self.count
        self._set_pose(slot, T_init)
        if self.first_id == 0 and slot == 0:
            d = self._d
            si = self._anchor_si
            self.Hp = self.Hp.at[:d, :d].set(
                jnp.eye(d, dtype=self.dtype) * (si * si)
            )
        self.count += 1
        return self.next_id - 1

    def add_odometry(self, T_meas, sqrt_info) -> int:
        """Append a pose predicted by composing the measurement onto the
        newest pose (T_new = T_meas @ T_last) and connect them with a
        between factor.  Returns the new pose's absolute id."""
        if self.count == 0:
            raise RuntimeError("add the initial pose first (add_pose)")
        last = self.next_id - 1
        T_pred = jnp.asarray(T_meas, self.dtype) @ self.T[last - self.first_id]
        new = self.add_pose(T_pred)
        self.add_factor(last, new, T_meas, sqrt_info)
        return new

    def add_factor(self, i: int, j: int, T_meas, sqrt_info):
        """Between factor (absolute pose ids, both inside the window):
        measurement T_j_i with the standard kernel convention
        T_est = T_j @ T_i^-1."""
        si, sj = i - self.first_id, j - self.first_id
        if not (0 <= si < self.count and 0 <= sj < self.count):
            raise KeyError(
                f"factor ({i},{j}) outside window [{self.first_id}, {self.next_id})"
            )
        k = self._alloc_slot()
        self._slot_free[k] = False
        # COPY-ON-WRITE, never in-place: on the CPU backend jnp.asarray
        # aliases numpy buffers zero-copy, so mutating an array a previous
        # (possibly still-pending, async) device call received corrupts
        # that call's input — measured as nondeterministic metre-scale
        # window jumps before this was found.
        fi, fj = self.fi.copy(), self.fj.copy()
        fi[k], fj[k] = si, sj
        self.fi, self.fj = fi, fj
        self.T_obs = self.T_obs.at[k].set(jnp.asarray(T_meas, self.dtype))
        self.sqrt_info = self.sqrt_info.at[k].set(jnp.asarray(sqrt_info, self.dtype))
        self.fw = self.fw.at[k].set(1.0)

    # ------------------------------------------------------------------
    # device math
    # ------------------------------------------------------------------
    def _graph(self, T, valid, fi, fj, fw, T_obs, sqrt_info):
        blocks = {
            "poses": VariableBlock(self.kind, T, ~valid)  # invalid slots frozen
        }
        batch = FactorBatch(
            kind=f"between_{self.kind}",
            slots=("poses", "poses"),
            indices=(fi, fj),
            data={"T_obs": T_obs, "sqrt_info": sqrt_info},
            loss=L2Loss(),
            weight=fw,
        )
        return FactorGraph(blocks, [batch])

    def _build_update(self):
        W, d = self.window, self._d
        iters = self.gn_iters
        lam = self.damping

        def run(T, valid, fi, fj, fw, T_obs, sqrt_info, Hp, bp, Tlin):
            ops = _OPS[self.kind]
            free = jnp.repeat(valid, d).astype(T.dtype)

            def body(_, T):
                g = self._graph(T, valid, fi, fj, fw, T_obs, sqrt_info)
                H, grad, _ = assemble_dense(g)
                eta = ops.log(T @ ops.inv(Tlin)).reshape(-1)
                grad = grad - (Hp @ eta + bp) * free
                H = H + Hp * free[:, None] * free[None, :]
                H = H + lam * jnp.eye(W * d, dtype=T.dtype)
                dx = jnp.linalg.solve(H, grad)
                dx = (dx * free).reshape(W, d)
                return ops.perturb(T, dx)

            return jax.lax.fori_loop(0, iters, body, T)

        return jax.jit(run)

    def _build_marg(self):
        W, d = self.window, self._d

        def run(T, valid, fi, fj, fw_adj, T_obs, sqrt_info, Hp, bp, Tlin):
            """Consume the prior + the factors in fw_adj (those touching
            slot 0), Schur-eliminate slot 0, shift the window down one."""
            ops = _OPS[self.kind]
            g = self._graph(T, valid, fi, fj, fw_adj, T_obs, sqrt_info)
            H_a, grad_a, _ = assemble_dense(g)
            # assemble_dense puts a unit diagonal on frozen rows — remove
            # it: the prior must stay exactly the consumed information
            free = jnp.repeat(valid, d).astype(T.dtype)
            H_a = H_a - jnp.diag(1.0 - free)
            eta = ops.log(T @ ops.inv(Tlin)).reshape(-1)
            grad = grad_a - (Hp @ eta + bp) * free
            H = H_a + Hp * free[:, None] * free[None, :]

            Cm = H[:d, :d]
            B = H[d:, :d]
            A = H[d:, d:]
            g_m, g_r = grad[:d], grad[d:]
            CmI = jnp.linalg.inv(Cm)
            Hp_r = A - B @ CmI @ B.T
            g_rp = g_r - B @ (CmI @ g_m)

            Hp_new = jnp.zeros_like(Hp).at[: (W - 1) * d, : (W - 1) * d].set(Hp_r)
            bp_new = jnp.zeros_like(bp).at[: (W - 1) * d].set(-g_rp)
            T_new = jnp.roll(T, -1, axis=0)
            return Hp_new, bp_new, T_new

        return jax.jit(run)

    # ------------------------------------------------------------------
    # the two per-frame entry points
    # ------------------------------------------------------------------
    def update(self):
        """Run the window GN (one device dispatch); returns (count, m, m)
        estimates, oldest first."""
        if self._update_jit is None:
            self._update_jit = self._build_update()
        valid = jnp.arange(self.window) < self.count
        self.T = self._update_jit(
            self.T,
            valid,
            jnp.asarray(self.fi),
            jnp.asarray(self.fj),
            self.fw,
            self.T_obs,
            self.sqrt_info,
            self.Hp,
            self.bp,
            self.Tlin,
        )
        return self.poses()

    def _marginalize_oldest(self):
        if self._marg_jit is None:
            self._marg_jit = self._build_marg()
        live = ~self._slot_free
        adj = live & ((self.fi == 0) | (self.fj == 0))
        valid = jnp.arange(self.window) < self.count
        fw_adj = self.fw * jnp.asarray(adj.astype(np.float32))
        self.Hp, self.bp, self.T = self._marg_jit(
            self.T,
            valid,
            jnp.asarray(self.fi),
            jnp.asarray(self.fj),
            fw_adj,
            self.T_obs,
            self.sqrt_info,
            self.Hp,
            self.bp,
            self.Tlin,
        )
        # relinearize the prior at the (shifted) current estimates
        self.Tlin = self.T
        # drop consumed factors; shift the rest down one slot (copy-on
        # -write — see add_factor)
        self.fw = self.fw * jnp.asarray((~adj).astype(np.float32))
        self._slot_free |= adj
        keep = ~self._slot_free
        fi, fj = self.fi.copy(), self.fj.copy()
        fi[keep] -= 1
        fj[keep] -= 1
        self.fi, self.fj = fi, fj
        self.count -= 1
        self.first_id += 1


class FixedLagLandmarkSmoother:
    """Sliding-window smoother with landmark slots (VIO / online landmark
    SLAM): a bounded window of poses plus a bounded pool of landmark slots
    is optimized every frame; poses leaving the window and landmarks
    evicted under slot pressure are MARGINALIZED into one dense Gaussian
    prior over the whole window state (first-estimate linearization of the
    consumed factors).  The reference has no counterpart (pyslam is
    batch-only, SURVEY.md §2.1); this is the OKVIS/VIO sliding-window
    design.  Complements FixedLagSmoother (pose-only windows) and
    IncrementalSmoother (unbounded growth).

    Device shape: the window state is one dense tangent vector in the
    FactorGraph's sorted block order — landmarks (L*ld dims) first, poses
    (W*d) after — so the prior (Hp, bp), the GN update, and both
    marginalizations are each ONE compiled executable for the whole
    sequence.  Landmark eviction at a runtime slot index stays a single
    executable by passing a host-built permutation that rotates the
    retired slot's dims to the front of the matrix.

    obs_kind: any registered (pose, landmark) kernel with {obs, sqrt_info}
    data — 'landmark_xy_se2', 'bearing_range_se2', 'landmark_xyz_se3',
    'reprojection' (pass the camera via ``obs_extras``).
    """

    _OBS_DEFAULTS = {
        "bearing_range_se2": (2, 2),  # (obs_dim, lm_dim)
        "landmark_xy_se2": (2, 2),
        "landmark_xyz_se3": (3, 3),
        "reprojection": (3, 3),
    }

    def __init__(
        self,
        window: int = 10,
        lm_slots: int = 64,
        obs_kind: str = "landmark_xyz_se3",
        kind: str = "se3",
        capacity: int | None = None,
        obs_capacity: int | None = None,
        gn_iters: int = 3,
        anchor_sqrt_info: float = 1e3,
        damping: float = 1e-9,
        dtype=jnp.float32,
        obs_dim: int | None = None,
        lm_dim: int | None = None,
        obs_extras: dict | None = None,
    ):
        if kind not in _OPS:
            raise ValueError(f"kind must be one of {sorted(_OPS)}")
        od, ld = self._OBS_DEFAULTS.get(obs_kind, (None, None))
        self.obs_dim = obs_dim if obs_dim is not None else od
        self.lm_dim = lm_dim if lm_dim is not None else ld
        if self.obs_dim is None or self.lm_dim is None:
            raise ValueError(f"obs_kind {obs_kind!r} needs explicit obs_dim/lm_dim")
        self.window = int(window)
        self.lm_slots = int(lm_slots)
        self.kind = kind
        self.obs_kind = obs_kind
        self.obs_extras = dict(obs_extras or {})
        self.capacity = int(capacity if capacity is not None else 4 * window)
        self.obs_capacity = int(
            obs_capacity if obs_capacity is not None else window * lm_slots
        )
        self.gn_iters = int(gn_iters)
        self.damping = float(damping)
        self.dtype = dtype
        W, d, m = self.window, _DOF[kind], _MAT[kind]
        L, ld = self.lm_slots, self.lm_dim
        self._d, self._m = d, m
        # dense tangent layout = FactorGraph sorted block order:
        # 'landmarks' < 'poses'  ->  [L*ld landmark dims | W*d pose dims]
        self._off_p = L * ld
        self._D = L * ld + W * d

        # device state
        eye = np.tile(np.eye(m), (W, 1, 1))
        self.T = jnp.asarray(eye, dtype)
        self.Tlin = jnp.asarray(eye, dtype)
        # safe padding landmark: unit last component keeps projective /
        # bearing-range kernels finite on weight-0 rows (0*inf = NaN would
        # poison the scatter-add — the schur_reduce safe-fill lesson)
        safe = np.zeros(ld)
        safe[-1] = 1.0
        self._lm_safe = safe
        self.Lm = jnp.asarray(np.tile(safe, (L, 1)), dtype)
        self.Lmlin = self.Lm
        self.Hp = jnp.zeros((self._D, self._D), dtype)
        self.bp = jnp.zeros(self._D, dtype)
        C, Co = self.capacity, self.obs_capacity
        self.T_obs = jnp.tile(jnp.eye(m, dtype=dtype), (C, 1, 1))
        self.b_sqrt = jnp.tile(jnp.eye(d, dtype=dtype), (C, 1, 1))
        self.bw = jnp.zeros(C, dtype)
        self.obs = jnp.asarray(
            np.tile(np.eye(1, self.obs_dim, self.obs_dim - 1)[0], (Co, 1)), dtype
        )
        self.o_sqrt = jnp.tile(jnp.eye(self.obs_dim, dtype=dtype), (Co, 1, 1))
        self.ow = jnp.zeros(Co, dtype)

        # host mirrors (shape the device call; never ride in it)
        self.bi = np.zeros(C, np.int32)
        self.bj = np.zeros(C, np.int32)
        self._bfree = np.ones(C, bool)
        self.oi = np.zeros(Co, np.int32)  # observing pose slot
        self.oj = np.zeros(Co, np.int32)  # observed landmark slot
        self._ofree = np.ones(Co, bool)
        self._lm_free = np.ones(L, bool)
        self._lm_id2slot: dict[int, int] = {}
        self._lm_slot2id = np.full(L, -1, np.int64)
        self._next_lm_id = 0
        self.count = 0
        self.first_id = 0
        self._anchor_si = float(anchor_sqrt_info)
        self._update_jit = None
        self._marg_jit = None
        self._retire_jit = None

    # ------------------------------------------------------------------
    # host-side bookkeeping
    # ------------------------------------------------------------------
    @property
    def next_id(self) -> int:
        return self.first_id + self.count

    def window_ids(self):
        return range(self.first_id, self.first_id + self.count)

    def landmark_ids(self):
        return sorted(self._lm_id2slot)

    def poses(self) -> np.ndarray:
        return np.asarray(self.T[: self.count])

    def pose(self, abs_id: int) -> np.ndarray:
        s = abs_id - self.first_id
        if not 0 <= s < self.count:
            raise KeyError(f"pose {abs_id} not in window [{self.first_id}, {self.next_id})")
        return np.asarray(self.T[s])

    def landmark(self, lm_id: int) -> np.ndarray:
        if lm_id not in self._lm_id2slot:
            raise KeyError(f"landmark {lm_id} not live (retired or never added)")
        return np.asarray(self.Lm[self._lm_id2slot[lm_id]])

    def landmarks(self) -> dict:
        return {i: np.asarray(self.Lm[s]) for i, s in self._lm_id2slot.items()}

    def _alloc(self, free: np.ndarray, what: str) -> int:
        idx = np.flatnonzero(free)
        if idx.size == 0:
            raise RuntimeError(f"{what} capacity exhausted; raise the limit")
        return int(idx[0])

    # ------------------------------------------------------------------
    # graph construction API
    # ------------------------------------------------------------------
    def add_pose(self, T_init) -> int:
        if self.count == self.window:
            self._marginalize_oldest()
        slot = self.count
        self.T = self.T.at[slot].set(jnp.asarray(T_init, self.dtype))
        self.Tlin = self.Tlin.at[slot].set(jnp.asarray(T_init, self.dtype))
        if self.first_id == 0 and slot == 0:
            d, o = self._d, self._off_p
            si2 = self._anchor_si ** 2
            self.Hp = self.Hp.at[o : o + d, o : o + d].set(
                jnp.eye(d, dtype=self.dtype) * si2
            )
        self.count += 1
        return self.next_id - 1

    def add_odometry(self, T_meas, sqrt_info) -> int:
        if self.count == 0:
            raise RuntimeError("add the initial pose first (add_pose)")
        last = self.next_id - 1
        T_pred = jnp.asarray(T_meas, self.dtype) @ self.T[last - self.first_id]
        new = self.add_pose(T_pred)
        self.add_factor(last, new, T_meas, sqrt_info)
        return new

    def add_factor(self, i: int, j: int, T_meas, sqrt_info):
        """Between factor on absolute pose ids (T_obs = T_j @ T_i^-1)."""
        si, sj = i - self.first_id, j - self.first_id
        if not (0 <= si < self.count and 0 <= sj < self.count):
            raise KeyError(f"factor ({i},{j}) outside window [{self.first_id}, {self.next_id})")
        k = self._alloc(self._bfree, "between-factor")
        self._bfree = self._bfree.copy()
        self._bfree[k] = False
        bi, bj = self.bi.copy(), self.bj.copy()
        bi[k], bj[k] = si, sj
        self.bi, self.bj = bi, bj
        self.T_obs = self.T_obs.at[k].set(jnp.asarray(T_meas, self.dtype))
        self.b_sqrt = self.b_sqrt.at[k].set(jnp.asarray(sqrt_info, self.dtype))
        self.bw = self.bw.at[k].set(1.0)

    def add_landmark(self, l_init) -> int:
        """Add a landmark; returns its id.  Under slot pressure the oldest
        live landmark with no remaining observations is evicted
        (marginalized) to make room."""
        if not self._lm_free.any():
            self._evict_unobserved()
        slot = self._alloc(self._lm_free, "landmark-slot")
        self._lm_free = self._lm_free.copy()
        self._lm_free[slot] = False
        lm_id = self._next_lm_id
        self._next_lm_id += 1
        self._lm_id2slot[lm_id] = slot
        self._lm_slot2id = self._lm_slot2id.copy()
        self._lm_slot2id[slot] = lm_id
        v = jnp.asarray(l_init, self.dtype)
        self.Lm = self.Lm.at[slot].set(v)
        self.Lmlin = self.Lmlin.at[slot].set(v)
        return lm_id

    def add_observation(self, pose_id: int, lm_id: int, obs, sqrt_info):
        sp = pose_id - self.first_id
        if not 0 <= sp < self.count:
            raise KeyError(f"pose {pose_id} not in window [{self.first_id}, {self.next_id})")
        if lm_id not in self._lm_id2slot:
            raise KeyError(f"landmark {lm_id} not live")
        k = self._alloc(self._ofree, "observation")
        self._ofree = self._ofree.copy()
        self._ofree[k] = False
        oi, oj = self.oi.copy(), self.oj.copy()
        oi[k], oj[k] = sp, self._lm_id2slot[lm_id]
        self.oi, self.oj = oi, oj
        self.obs = self.obs.at[k].set(jnp.asarray(obs, self.dtype))
        self.o_sqrt = self.o_sqrt.at[k].set(jnp.asarray(sqrt_info, self.dtype))
        self.ow = self.ow.at[k].set(1.0)

    # ------------------------------------------------------------------
    # device math
    # ------------------------------------------------------------------
    def _graph(self, T, Lm, pvalid, lvalid, bi, bj, bw, T_obs, b_sqrt,
               oi, oj, ow, obs, o_sqrt):
        blocks = {
            "landmarks": VariableBlock("euclidean", Lm, ~lvalid),
            "poses": VariableBlock(self.kind, T, ~pvalid),
        }
        batches = [
            FactorBatch(
                kind=f"between_{self.kind}",
                slots=("poses", "poses"),
                indices=(bi, bj),
                data={"T_obs": T_obs, "sqrt_info": b_sqrt},
                loss=L2Loss(),
                weight=bw,
            ),
            FactorBatch(
                kind=self.obs_kind,
                slots=("poses", "landmarks"),
                indices=(oi, oj),
                data={"obs": obs, "sqrt_info": o_sqrt, **self.obs_extras},
                loss=L2Loss(),
                weight=ow,
            ),
        ]
        return FactorGraph(blocks, batches)

    def _free_vec(self, pvalid, lvalid, dtype):
        d, ld = self._d, self.lm_dim
        return jnp.concatenate(
            [jnp.repeat(lvalid, ld), jnp.repeat(pvalid, d)]
        ).astype(dtype)

    def _eta(self, T, Tlin, Lm, Lmlin):
        ops = _OPS[self.kind]
        return jnp.concatenate(
            [(Lm - Lmlin).reshape(-1), ops.log(T @ ops.inv(Tlin)).reshape(-1)]
        )

    def _prior_system(self, g, Hp, bp, eta, free, exact_info=False):
        """Assembled graph system + the prior, expressed at the current
        point (grad convention: g = -J^T W r from assemble_dense).

        exact_info=True removes assemble_dense's unit diagonal on frozen
        rows — marginalization must fold exactly the consumed information,
        while the GN update keeps it so frozen dims solve to exactly 0."""
        H_a, grad_a, _ = assemble_dense(g)
        if exact_info:
            H_a = H_a - jnp.diag(1.0 - free)
        grad = grad_a - (Hp @ eta + bp) * free
        H = H_a + Hp * free[:, None] * free[None, :]
        return H, grad

    def _build_update(self):
        D, d, ld = self._D, self._d, self.lm_dim
        W, L = self.window, self.lm_slots
        iters, lam = self.gn_iters, self.damping

        def run(T, Lm, pvalid, lvalid, bi, bj, bw, T_obs, b_sqrt,
                oi, oj, ow, obs, o_sqrt, Hp, bp, Tlin, Lmlin):
            ops = _OPS[self.kind]
            free = self._free_vec(pvalid, lvalid, T.dtype)

            def body(_, carry):
                T, Lm = carry
                g = self._graph(T, Lm, pvalid, lvalid, bi, bj, bw, T_obs,
                                b_sqrt, oi, oj, ow, obs, o_sqrt)
                eta = self._eta(T, Tlin, Lm, Lmlin)
                H, grad = self._prior_system(g, Hp, bp, eta, free)
                H = H + lam * jnp.eye(D, dtype=T.dtype)
                dx = jnp.linalg.solve(H, grad) * free
                dx_l = dx[: L * ld].reshape(L, ld)
                dx_p = dx[L * ld :].reshape(W, d)
                return ops.perturb(T, dx_p), Lm + dx_l

            return jax.lax.fori_loop(0, iters, body, (T, Lm))

        return jax.jit(run)

    def _build_marg(self):
        """Schur-eliminate pose slot 0 (its dims sit at a STATIC offset),
        then shift the pose dims of the prior down one slot."""
        D, d = self._D, self._d
        o = self._off_p

        def run(T, Lm, pvalid, lvalid, bi, bj, bw_adj, T_obs, b_sqrt,
                oi, oj, ow_adj, obs, o_sqrt, Hp, bp, Tlin, Lmlin):
            g = self._graph(T, Lm, pvalid, lvalid, bi, bj, bw_adj, T_obs,
                            b_sqrt, oi, oj, ow_adj, obs, o_sqrt)
            free = self._free_vec(pvalid, lvalid, T.dtype)
            eta = self._eta(T, Tlin, Lm, Lmlin)
            H, grad = self._prior_system(g, Hp, bp, eta, free, exact_info=True)
            # rotate pose-0 dims to the front (static permutation)
            perm = jnp.concatenate([
                jnp.arange(o, o + d), jnp.arange(0, o), jnp.arange(o + d, D)
            ])
            Hm = H[perm][:, perm]
            gm = grad[perm]
            CmI = jnp.linalg.inv(Hm[:d, :d])
            B = Hm[d:, :d]
            Hp_r = Hm[d:, d:] - B @ CmI @ B.T
            g_rp = gm[d:] - B @ (CmI @ gm[:d])
            # remaining order [landmarks | poses 1..W-1] IS the new layout
            # [landmarks | poses 0..W-2]; last pose slot zeroed
            Hp_new = jnp.zeros_like(Hp).at[: D - d, : D - d].set(Hp_r)
            bp_new = jnp.zeros_like(bp).at[: D - d].set(-g_rp)
            return Hp_new, bp_new, jnp.roll(T, -1, axis=0)

        return jax.jit(run)

    def _build_retire(self):
        """Schur-eliminate one landmark slot's dims (runtime slot -> the
        permutation is a device argument, so one executable serves every
        slot) together with its remaining observations."""
        D = self._D
        ld = self.lm_dim

        def run(T, Lm, pvalid, lvalid, bi, bj, bw0, T_obs, b_sqrt,
                oi, oj, ow_adj, obs, o_sqrt, Hp, bp, Tlin, Lmlin, perm):
            g = self._graph(T, Lm, pvalid, lvalid, bi, bj, bw0, T_obs,
                            b_sqrt, oi, oj, ow_adj, obs, o_sqrt)
            free = self._free_vec(pvalid, lvalid, T.dtype)
            eta = self._eta(T, Tlin, Lm, Lmlin)
            H, grad = self._prior_system(g, Hp, bp, eta, free, exact_info=True)
            Hm = H[perm][:, perm]
            gm = grad[perm]
            CmI = jnp.linalg.inv(Hm[:ld, :ld])
            B = Hm[ld:, :ld]
            Hp_r = Hm[ld:, ld:] - B @ CmI @ B.T
            g_rp = gm[ld:] - B @ (CmI @ gm[:ld])
            inv_idx = perm[ld:]
            Hp_new = jnp.zeros_like(Hp).at[inv_idx[:, None], inv_idx[None, :]].set(Hp_r)
            bp_new = jnp.zeros_like(bp).at[inv_idx].set(-g_rp)
            return Hp_new, bp_new

        return jax.jit(run)

    # ------------------------------------------------------------------
    # per-frame entry points
    # ------------------------------------------------------------------
    def _device_args(self):
        pvalid = jnp.arange(self.window) < self.count
        lvalid = jnp.asarray(~self._lm_free)
        return (
            self.T, self.Lm, pvalid, lvalid,
            jnp.asarray(self.bi), jnp.asarray(self.bj), self.bw,
            self.T_obs, self.b_sqrt,
            jnp.asarray(self.oi), jnp.asarray(self.oj), self.ow,
            self.obs, self.o_sqrt,
        )

    def update(self):
        """One window GN solve (single device dispatch); returns the
        (count, m, m) pose estimates, oldest first."""
        if self._update_jit is None:
            self._update_jit = self._build_update()
        self.T, self.Lm = self._update_jit(
            *self._device_args(), self.Hp, self.bp, self.Tlin, self.Lmlin
        )
        return self.poses()

    def _marginalize_oldest(self):
        if self._marg_jit is None:
            self._marg_jit = self._build_marg()
        b_adj = ~self._bfree & ((self.bi == 0) | (self.bj == 0))
        o_adj = ~self._ofree & (self.oi == 0)
        args = list(self._device_args())
        args[6] = self.bw * jnp.asarray(b_adj.astype(np.float32))   # bw
        args[11] = self.ow * jnp.asarray(o_adj.astype(np.float32))  # ow
        self.Hp, self.bp, self.T = self._marg_jit(
            *args, self.Hp, self.bp, self.Tlin, self.Lmlin
        )
        # prior is expressed at the current estimates -> rebase lin points
        self.Tlin = self.T
        self.Lmlin = self.Lm
        # consume adjacent factors; shift remaining pose indices down one
        self.bw = self.bw * jnp.asarray((~b_adj).astype(np.float32))
        self.ow = self.ow * jnp.asarray((~o_adj).astype(np.float32))
        self._bfree = self._bfree | b_adj
        self._ofree = self._ofree | o_adj
        bi, bj, oi = self.bi.copy(), self.bj.copy(), self.oi.copy()
        bi[~self._bfree] -= 1
        bj[~self._bfree] -= 1
        oi[~self._ofree] -= 1
        self.bi, self.bj, self.oi = bi, bj, oi
        self.count -= 1
        self.first_id += 1

    def retire_landmark(self, lm_id: int):
        """Marginalize a landmark (and its remaining observations) into
        the prior and free its slot for reuse."""
        if lm_id not in self._lm_id2slot:
            raise KeyError(f"landmark {lm_id} not live")
        if self._retire_jit is None:
            self._retire_jit = self._build_retire()
        slot = self._lm_id2slot[lm_id]
        o_adj = ~self._ofree & (self.oj == slot)
        D, ld = self._D, self.lm_dim
        i0 = slot * ld
        perm = np.concatenate([
            np.arange(i0, i0 + ld), np.arange(0, i0), np.arange(i0 + ld, D)
        ]).astype(np.int32)
        args = list(self._device_args())
        args[6] = jnp.zeros_like(self.bw)                           # bw: none
        args[11] = self.ow * jnp.asarray(o_adj.astype(np.float32))  # ow: its obs
        self.Hp, self.bp = self._retire_jit(
            *args, self.Hp, self.bp, self.Tlin, self.Lmlin, jnp.asarray(perm)
        )
        self.Tlin = self.T
        self.Lmlin = self.Lm
        self.ow = self.ow * jnp.asarray((~o_adj).astype(np.float32))
        self._ofree = self._ofree | o_adj
        self._lm_free = self._lm_free.copy()
        self._lm_free[slot] = True
        del self._lm_id2slot[lm_id]
        self._lm_slot2id = self._lm_slot2id.copy()
        self._lm_slot2id[slot] = -1
        safe = jnp.asarray(self._lm_safe, self.dtype)
        self.Lm = self.Lm.at[slot].set(safe)
        self.Lmlin = self.Lmlin.at[slot].set(safe)

    def _evict_unobserved(self):
        """Retire the oldest live landmark with no remaining observations;
        if every slot still carries live observations, retire the oldest
        landmark outright — retire_landmark consumes its remaining
        observations into the prior (frozen linearization), the standard
        VIO treatment of features evicted while still tracked."""
        live_obs_slots = set(self.oj[~self._ofree].tolist())
        for lm_id in sorted(self._lm_id2slot):
            if self._lm_id2slot[lm_id] not in live_obs_slots:
                self.retire_landmark(lm_id)
                return
        self.retire_landmark(min(self._lm_id2slot))


__all__ = ["FixedLagSmoother", "FixedLagLandmarkSmoother"]
