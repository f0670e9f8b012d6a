"""Residual library — API parity with ``pyslam/residuals.py`` (SURVEY.md §2.1):
``QuadraticResidual``, ``PoseResidual``, ``PoseToPoseResidual``,
``ReprojectionResidual``, ``ReprojectionMotionOnlyBatchResidual``
(``PhotometricResidualSE3`` lives in pipelines/photometric.py with the dense
VO stack).

Each object holds one measurement and exposes the reference's
``evaluate(params, compute_jacobians) -> (residual, jacobians)`` — but the
math is *shared with the batched solver*: evaluate() adds a batch axis and
calls the same registered factor kernel the device solve path uses
(graph/factor_defs.py), so the object API and the struct-of-arrays path can
never drift apart.

``Problem`` (problem.py) groups same-kind residual blocks into FactorBatches;
these classes declare their kind / parameter manifolds / data layout for that
grouping.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .graph.core import FACTOR_KERNELS
from .lie.groups import SE2, SE3, Sim3, _LieGroupBase


def _as_matrix(T):
    return T.mat if isinstance(T, _LieGroupBase) else jnp.asarray(T)


def _stiffness_matrix(stiffness, dim, dtype=None):
    """Normalize scalar / vector / matrix stiffness to a (dim, dim) matrix."""
    s = jnp.asarray(stiffness, dtype=dtype)
    if s.ndim == 0:
        return s * jnp.eye(dim, dtype=s.dtype)
    if s.ndim == 1:
        return jnp.diag(s)
    return s


class _ResidualBase:
    """Shared single-measurement evaluate() via the batched kernels."""

    factor_kind: str = ""
    param_kinds: tuple = ()

    def batch_data(self) -> dict:
        """Per-factor arrays (no batch axis) for FactorBatch stacking."""
        raise NotImplementedError

    def _prepare_params(self, params):
        return [_as_matrix(p) for p in params]

    def evaluate(self, params, compute_jacobians=None):
        """Reference signature: ``compute_jacobians`` is None (residual only)
        or a list of bools per parameter (which Jacobians to return)."""
        want = compute_jacobians is not None and any(compute_jacobians)
        vals = [v[None] for v in self._prepare_params(params)]
        data = {k: (v if k == "camera" else jnp.asarray(v)[None]) for k, v in self.batch_data().items()}
        r, jacs = FACTOR_KERNELS[self.factor_kind](data, *vals, compute_jacobians=want)
        r = r[0]
        if compute_jacobians is None:
            return r
        out = [
            (jacs[i][0] if flag else None) for i, flag in enumerate(compute_jacobians)
        ]
        return r, out


class QuadraticResidual(_ResidualBase):
    """Curve-fit demo residual: r = stiffness * (a x^2 + b x + c - y)
    (reference QuadraticResidual, the README example)."""

    factor_kind = "quadratic"
    param_kinds = ("euclidean",)

    def __init__(self, x, y, stiffness):
        self.x = float(x)
        self.y = float(y)
        self.stiffness = float(stiffness)

    def batch_data(self):
        return {"x": self.x, "y": self.y, "stiffness": self.stiffness}


class PoseResidual(_ResidualBase):
    """Unary pose prior: r = stiffness * log(T_est * T_obs^-1)
    (reference PoseResidual).  Works for SE2 and SE3."""

    def __init__(self, T_obs, stiffness):
        is_sim3 = isinstance(T_obs, Sim3)
        self.T_obs = _as_matrix(T_obs)
        dim = self.T_obs.shape[-1]
        kind = "sim3" if is_sim3 else ("se2" if dim == 3 else "se3")
        self.dof = {"se2": 3, "se3": 6, "sim3": 7}[kind]
        self.factor_kind = f"prior_{kind}"
        self.param_kinds = (kind,)
        self.sqrt_info = _stiffness_matrix(stiffness, self.dof, self.T_obs.dtype)

    def batch_data(self):
        return {"T_obs": self.T_obs, "sqrt_info": self.sqrt_info}


class PoseToPoseResidual(_ResidualBase):
    """Binary odometry / loop-closure factor:
    r = stiffness * log(T_2_0 * T_1_0^-1 * T_2_1_obs^-1)
    (reference PoseToPoseResidual).  Works for SE2 and SE3."""

    def __init__(self, T_2_1_obs, stiffness):
        is_sim3 = isinstance(T_2_1_obs, Sim3)
        self.T_obs = _as_matrix(T_2_1_obs)
        dim = self.T_obs.shape[-1]
        kind = "sim3" if is_sim3 else ("se2" if dim == 3 else "se3")
        self.dof = {"se2": 3, "se3": 6, "sim3": 7}[kind]
        self.factor_kind = f"between_{kind}"
        self.param_kinds = (kind, kind)
        self.sqrt_info = _stiffness_matrix(stiffness, self.dof, self.T_obs.dtype)

    def batch_data(self):
        return {"T_obs": self.T_obs, "sqrt_info": self.sqrt_info}


class PoseToPoseSwitchableResidual(_ResidualBase):
    """Vertigo switchable loop closure for the Problem API (Suenderhauf &
    Protzel ICRA 2012; beyond-reference): parameters [T_1, T_2, s] where
    ``s`` is a (1,) euclidean switch variable the caller initializes near
    1.0 — read it back after solve; near 0 means the edge was rejected.

    r = [s * stiffness * log(T_2_0 T_1_0^-1 T_obs^-1); xi * (1 - s)].
    The batched-graph equivalent is ``build.switchable_pose_graph``
    (graph/build.py); xi tuning notes live on its docstring."""

    def __init__(self, T_2_1_obs, stiffness, xi: float = 5.0):
        self.T_obs = _as_matrix(T_2_1_obs)
        dim = self.T_obs.shape[-1]
        kind = "se2" if dim == 3 else "se3"
        self.dof = {"se2": 3, "se3": 6}[kind]
        self.factor_kind = f"between_{kind}_switch"
        self.param_kinds = (kind, kind, "euclidean")
        self.sqrt_info = _stiffness_matrix(stiffness, self.dof, self.T_obs.dtype)
        self.xi = float(xi)

    def batch_data(self):
        return {
            "T_obs": self.T_obs,
            "sqrt_info": self.sqrt_info,
            "xi": jnp.asarray(self.xi, self.T_obs.dtype),
        }


class ReprojectionResidual(_ResidualBase):
    """Stereo/RGB-D reprojection: r = stiffness * (cam.project(T * p) - obs)
    (reference ReprojectionResidual; call stack SURVEY.md §3.2).
    Parameters: [T_cam_w (SE3), pt_w (3,)]."""

    factor_kind = "reprojection"
    param_kinds = ("se3", "euclidean")

    def __init__(self, camera, obs, stiffness):
        self.camera = camera
        self.obs = jnp.asarray(obs)
        self.sqrt_info = _stiffness_matrix(stiffness, 3, self.obs.dtype)

    def batch_data(self):
        return {"camera": self.camera, "obs": self.obs, "sqrt_info": self.sqrt_info}


class LandmarkXYResidual(_ResidualBase):
    """2D relative-position landmark observation (g2o EDGE_SE2_XY):
    r = stiffness * (act(T, l) - obs) — the landmark seen in the observing
    pose's frame.  Parameters: [T (SE2), l (2,)].  Beyond-reference
    (Victoria-Park model family; kernel graph/factor_defs.py)."""

    factor_kind = "landmark_xy_se2"
    param_kinds = ("se2", "euclidean")

    def __init__(self, obs, stiffness):
        self.obs = jnp.asarray(obs)
        self.sqrt_info = _stiffness_matrix(stiffness, 2, self.obs.dtype)

    def batch_data(self):
        return {"obs": self.obs, "sqrt_info": self.sqrt_info}


class BearingRangeResidual(_ResidualBase):
    """2D bearing-range landmark observation: with p = act(T, l),
    r = stiffness * [wrap(atan2(p_y, p_x) - bearing_obs), |p| - range_obs].
    Parameters: [T (SE2), l (2,)].  ``obs`` is [bearing, range]."""

    factor_kind = "bearing_range_se2"
    param_kinds = ("se2", "euclidean")

    def __init__(self, obs, stiffness):
        self.obs = jnp.asarray(obs)
        self.sqrt_info = _stiffness_matrix(stiffness, 2, self.obs.dtype)

    def batch_data(self):
        return {"obs": self.obs, "sqrt_info": self.sqrt_info}


class ReprojectionMotionOnlyBatchResidual(_ResidualBase):
    """Motion-only BA: N fixed landmarks, optimize one camera pose
    (reference ReprojectionMotionOnlyBatchResidual).  Parameters: [T_cam_w].

    The N landmarks are folded into the residual's own data, so one residual
    block covers the whole point set (residual dim 3N) — matching the
    reference's batched semantics.
    """

    param_kinds = ("se3",)

    def __init__(self, camera, obs, pts_w, stiffness):
        self.camera = camera
        self.obs = jnp.asarray(obs)  # (N, 3)
        self.pts_w = jnp.asarray(pts_w)  # (N, 3)
        self.stiffness = stiffness

    factor_kind = "reprojection_motion_only_flat"

    def batch_data(self):
        n = self.obs.shape[0]
        s = _stiffness_matrix(self.stiffness, 3, self.obs.dtype)
        return {
            "camera": self.camera,
            "obs": self.obs,
            "pt_w": self.pts_w,
            "sqrt_info": jnp.broadcast_to(s, (n, 3, 3)),
        }


# A flattened-residual variant of the motion-only kernel, so the whole point
# set forms one residual block of dim 3N (reference semantics).
from .graph.core import register_factor  # noqa: E402
from .lie import se3 as _se3  # noqa: E402


@register_factor("reprojection_motion_only_flat")
def _reproj_motion_only_flat(data, T, compute_jacobians=True):
    cam = data["camera"]
    # data arrays are (F, N, ...); T is (F, 4, 4)
    obs, pts, sqrt_info = data["obs"], data["pt_w"], data["sqrt_info"]
    F, N = obs.shape[0], obs.shape[1]
    pt_cam = _se3.act(T[:, None], pts)
    if not compute_jacobians:
        pred = cam.project(pt_cam)
        r = jnp.einsum("fnij,fnj->fni", sqrt_info, pred - obs)
        return r.reshape(F, 3 * N), None
    pred, cam_jac = cam.project(pt_cam, compute_jacobians=True)
    r = jnp.einsum("fnij,fnj->fni", sqrt_info, pred - obs)
    S = jnp.einsum("fnij,fnjk->fnik", sqrt_info, cam_jac)
    J = jnp.einsum("fnij,fnjk->fnik", S, _se3.odot(pt_cam))
    return r.reshape(F, 3 * N), (J.reshape(F, 3 * N, 6),)


class ImuResidual(_ResidualBase):
    """Preintegrated inertial factor (pyslam_tpu/imu.py — beyond-reference;
    Forster on-manifold preintegration).  Parameters:
    [T_i (SE3, T_b_w), T_j (SE3), v_i (3,), v_j (3,), b_i (6,)].

    ``pim`` is a PreintegratedImu from ``imu.preintegrate``; the sqrt
    information defaults to the preintegrated covariance's inverse
    Cholesky factor."""

    factor_kind = "imu_preintegrated"
    param_kinds = ("se3", "se3", "euclidean", "euclidean", "euclidean")

    _PIM_KEYS = (
        "dR", "dv", "dp", "J_Rg", "J_vg", "J_va", "J_pg", "J_pa", "b_lin", "dt",
    )

    def __init__(self, pim, gravity=(0.0, 0.0, -9.81), sqrt_info=None):
        from .imu import sqrt_info_of

        self.pim = pim
        self.sqrt_info = jnp.asarray(
            sqrt_info if sqrt_info is not None else sqrt_info_of(pim)
        )
        self.gravity = jnp.asarray(gravity, self.sqrt_info.dtype)

    def batch_data(self):
        data = {k: jnp.asarray(getattr(self.pim, k)) for k in self._PIM_KEYS}
        data["sqrt_info"] = self.sqrt_info
        data["gravity"] = self.gravity
        return data


class DensePriorResidual(_ResidualBase):
    """The dense Gaussian prior produced by marginalization
    (graph/marginalize.py): r = A @ eta(x) - c over the Markov blanket of
    the removed variables, eta the per-slot left tangent from the frozen
    linearization points.  Constructed by ``Problem.marginalize_parameters``
    (the kernel name is the dynamically registered blanket signature)."""

    def __init__(self, factor_kind, param_kinds, data):
        self.factor_kind = factor_kind
        self.param_kinds = tuple(param_kinds)
        self._data = dict(data)

    def batch_data(self):
        return self._data


__all__ = [
    "QuadraticResidual",
    "PoseResidual",
    "PoseToPoseResidual",
    "PoseToPoseSwitchableResidual",
    "ReprojectionResidual",
    "ReprojectionMotionOnlyBatchResidual",
    "ImuResidual",
    "DensePriorResidual",
]
