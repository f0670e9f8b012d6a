"""Frame-to-frame sparse stereo RANSAC (reference pyslam/pipelines/ransac.py
``FrameToFrameRANSAC`` per SURVEY.md §2.1 — existence flagged [R, low], built
for capability coverage).

Device-first design: the reference-style sequential hypothesize-and-test loop
becomes ONE batched pass — M minimal samples drawn up front, M rigid
transforms estimated by batched Kabsch (vmapped 3x3 SVD), M x N reprojection
error matrices evaluated in a single fused kernel, argmax inlier count, then
an all-inlier weighted refit.  No data-dependent control flow; jit-compiles
once per (N, M) shape.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..lie.groups import SE3


def kabsch(P, Q, w=None):
    """Rigid T with Q ~ R P + t (least squares, batched over leading dims).

    P, Q: (..., N, 3); w: optional (..., N) weights.  Returns (..., 4, 4).
    """
    P = jnp.asarray(P)
    Q = jnp.asarray(Q)
    if w is None:
        w = jnp.ones(P.shape[:-1], P.dtype)
    wsum = jnp.sum(w, axis=-1, keepdims=True)
    cp = jnp.sum(w[..., None] * P, axis=-2) / wsum
    cq = jnp.sum(w[..., None] * Q, axis=-2) / wsum
    Pc = P - cp[..., None, :]
    Qc = Q - cq[..., None, :]
    H = jnp.einsum("...n,...ni,...nj->...ij", w, Pc, Qc)
    U, _, Vt = jnp.linalg.svd(H)
    # right-handed correction: R = V diag(1, 1, det(V U^T)) U^T
    det = jnp.linalg.det(jnp.matmul(U, Vt))
    D = jnp.ones(H.shape[:-2] + (3,), H.dtype).at[..., 2].set(det)
    R = jnp.einsum("...ji,...j,...kj->...ik", Vt, D, U)
    t = cq - jnp.einsum("...ij,...j->...i", R, cp)
    T = jnp.zeros(H.shape[:-2] + (4, 4), H.dtype)
    T = T.at[..., :3, :3].set(R).at[..., :3, 3].set(t).at[..., 3, 3].set(1.0)
    return T


class FrameToFrameRANSAC:
    """Sparse stereo frame-to-frame motion estimation with RANSAC.

    Usage (reference-shaped API):
        ransac = FrameToFrameRANSAC(camera)
        T_21, inlier_mask = ransac.compute_transform(obs_1, obs_2)

    obs_1 / obs_2: (N, 3) matched stereo observations [uL, vL, d] in frames
    1 and 2.  Returns the SE3 estimate T_2_1 (frame-1 points into frame 2)
    and the boolean inlier mask.
    """

    def __init__(
        self,
        camera,
        num_iters: int = 256,
        inlier_thresh: float = 2.0,
        seed: int = 0,
        polish: bool = True,
    ):
        self.camera = camera
        self.num_iters = num_iters
        self.inlier_thresh = inlier_thresh
        self.seed = seed
        self.polish = polish

    def compute_transform(self, obs_1, obs_2):
        obs_1 = jnp.asarray(obs_1)
        obs_2 = jnp.asarray(obs_2)
        key = jax.random.PRNGKey(self.seed)
        T, mask, n_in = _ransac_batched(
            self.camera, obs_1, obs_2, self.num_iters, self.inlier_thresh, key
        )
        if self.polish:
            # pixel-space optimal refinement: motion-only reprojection GN on
            # the inlier set (the Kabsch fit is 3D-3D and ignores the
            # depth-dependent triangulation noise), then re-classify inliers
            # under the unbiased estimate
            T = _polish_motion_only(self.camera, obs_1, obs_2, T, mask)
            mask = _inlier_mask(self.camera, obs_1, obs_2, T, self.inlier_thresh)
        return SE3(T), np.asarray(mask)


from functools import partial


@partial(jax.jit, static_argnames=("camera", "num_iters", "thresh"))
def _ransac_batched(camera, obs_1, obs_2, num_iters, thresh, key):
    N = obs_1.shape[0]
    P1 = camera.triangulate(obs_1)  # (N, 3) frame-1 points
    P2 = camera.triangulate(obs_2)

    # minimal samples: (M, 3) index triples (collisions are harmless — a
    # degenerate sample yields a bad hypothesis that simply loses the vote)
    samples = jax.random.randint(key, (num_iters, 3), 0, N)
    A = P1[samples]  # (M, 3, 3)
    B = P2[samples]
    T = kabsch(A, B)  # (M, 4, 4)

    # score every hypothesis against every correspondence in one pass
    P1h = jnp.einsum("mij,nj->mni", T[:, :3, :3], P1) + T[:, None, :3, 3]
    pred = camera.project(P1h)  # (M, N, 3)
    err = jnp.linalg.norm(pred - obs_2[None], axis=-1)
    valid = camera.is_valid_measurement(obs_2)[None] & (P1h[..., 2] > 0)
    inlier = (err < thresh) & valid
    counts = jnp.sum(inlier, axis=-1)
    best = jnp.argmax(counts)

    # refit on the best hypothesis's inliers (weighted Kabsch)
    w = inlier[best].astype(P1.dtype)
    T_best = kabsch(P1, P2, w=w)
    mask = _inlier_mask(camera, obs_1, obs_2, T_best, thresh)
    return T_best, mask, counts[best]


@partial(jax.jit, static_argnames=("camera", "thresh"))
def _inlier_mask(camera, obs_1, obs_2, T, thresh):
    P1 = camera.triangulate(obs_1)
    P1r = jnp.einsum("ij,nj->ni", T[:3, :3], P1) + T[:3, 3]
    err = jnp.linalg.norm(camera.project(P1r) - obs_2, axis=-1)
    return (err < thresh) & camera.is_valid_measurement(obs_2) & (P1r[..., 2] > 0)


@partial(jax.jit, static_argnames=("camera",))
def _polish_motion_only(camera, obs_1, obs_2, T0, mask):
    import numpy as _np

    from ..graph.core import FactorBatch, FactorGraph, VariableBlock
    from ..losses import L2Loss
    from ..solver import lm as _lm

    N = obs_1.shape[0]
    P1 = camera.triangulate(obs_1)
    batch = FactorBatch.create(
        kind="reprojection_motion_only",
        slots=("pose",),
        indices=(_np.zeros(N, _np.int32),),
        data={
            "camera": camera,
            "obs": obs_2,
            "pt_w": P1,
            "sqrt_info": jnp.broadcast_to(jnp.eye(3, dtype=obs_1.dtype), (N, 3, 3)),
        },
        loss=L2Loss(),
        weight=mask.astype(obs_1.dtype),
    )
    g = FactorGraph({"pose": VariableBlock.create("se3", T0[None])}, [batch])
    solved, _ = _lm.solve(g, _lm.Options(method="lm", max_iters=10))
    return solved.blocks["pose"].values[0]


__all__ = ["FrameToFrameRANSAC", "kabsch"]
