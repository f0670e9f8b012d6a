"""Dense direct visual-odometry pipelines — parity with the reference's
``DenseStereoPipeline`` / ``DenseRGBDPipeline`` (pyslam/pipelines/dense.py per
SURVEY.md §3.3): keyframe-based coarse-to-fine photometric tracking with a
Student-t robust loss and motion-model initialization.

Device-first: each pyramid level's motion-only solve is the generic jitted LM
loop (solver/lm.py) over a single-pose factor graph with the batched
photometric kernel — shapes are static per level, so the whole tracking run
compiles once per level and every subsequent frame is pure device compute.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..graph.core import FactorBatch, FactorGraph, VariableBlock
from ..lie import se3
from ..lie.groups import SE3
from ..losses import TDistributionLoss
from ..solver import lm
from .keyframes import DenseKeyframe, DenseRGBDKeyframe, DenseStereoKeyframe, pyrdown


def _as_mat(T) -> np.ndarray:
    if isinstance(T, SE3):
        return np.asarray(T.mat)
    return np.asarray(T)


from functools import partial  # noqa: E402

import jax  # noqa: E402


@partial(jax.jit, static_argnames=("levels",))
def _device_pyramid(im, levels: int):
    """2x2 average-pool image pyramid on device (matches keyframes.pyrdown)
    — one dispatch for all levels; shared jit cache across pipelines.

    uint8 input is normalized to [0, 1] f32 ON DEVICE: shipping raw bytes
    cuts the host->device frame upload 4x for camera-native images."""
    if im.dtype == jnp.uint8:
        im = im.astype(jnp.float32) * (1.0 / 255.0)
    ims = [im]
    for _ in range(1, levels):
        x = ims[-1]
        H2, W2 = x.shape[0] // 2, x.shape[1] // 2
        ims.append(x[: 2 * H2, : 2 * W2].reshape(H2, 2, W2, 2).mean(axis=(1, 3)))
    return tuple(ims)


@partial(jax.jit, static_argnames=("nu", "kind"))
def _estimate_tdist_scale(data, T_init, nu, kind="photometric_se3"):
    """Fixed-point Student-t scale from the residuals at the initial pose."""
    from ..graph.core import FACTOR_KERNELS

    r, _ = FACTOR_KERNELS[kind](
        data, T_init[None], compute_jacobians=False
    )
    m = data["mask"]
    sigma2 = jnp.sum(m * r * r) / jnp.maximum(jnp.sum(m), 1.0) + 1e-12

    def body(_, s2):
        w = (nu + 1.0) / (nu + r * r / s2)
        return jnp.sum(m * w * r * r) / jnp.maximum(jnp.sum(m), 1.0) + 1e-12

    sigma2 = jax.lax.fori_loop(0, 10, body, sigma2)
    return jnp.sqrt(sigma2)


@partial(jax.jit, static_argnames=("options", "nu", "kind"))
def _track_levels_fused(options, nu, fixed_loss, levels, pyr, stiffness, T_init,
                        kind="photometric_se3"):
    """Coarse-to-fine pyramid tracking in one XLA program.

    ``levels``: per-level (camera, pt_ref, I_ref, mask); ``pyr``: per-level
    track images; ``nu`` not None selects adaptive Student-t (scale frozen
    per level inside the trace), else ``fixed_loss`` is used as-is."""
    from ..graph.core import FactorBatch, FactorGraph, VariableBlock

    from ..utils import pack_corners

    T = T_init
    n_levels = len(levels)
    for lvl in range(n_levels - 1, -1, -1):
        camera, pt_ref, I_ref, mask = levels[lvl]
        data = {
            "camera": camera,
            "pt_ref": pt_ref[None],
            "I_ref": I_ref[None],
            "mask": mask[None],
            "im_track": pyr[lvl][None],
            # corner-packed once per level, OUTSIDE the LM loop: every
            # kernel eval then does one gather instead of four
            "im_track4": pack_corners(pyr[lvl])[None],
            "stiffness": stiffness[None].astype(I_ref.dtype),
        }
        if nu is not None:
            sigma = _estimate_tdist_scale(data, T, nu, kind)
            loss = TDistributionLoss(nu=nu, scale=sigma)
        else:
            loss = fixed_loss
        batch = FactorBatch.create(
            kind=kind,
            slots=("pose",),
            indices=(np.zeros(1, np.int32),),
            data=data,
            loss=loss,
        )
        blocks = {"pose": VariableBlock.create("se3", T[None])}
        solved, _ = lm.solve(FactorGraph(blocks, [batch]), options)
        T = solved.blocks["pose"].values[0]
    return T


@partial(jax.jit, static_argnames=("levels",))
def _device_pyramid_batch(ims, levels: int):
    """Batched (K, H, W) pyramid: one dispatch for all frames and levels."""
    return jax.vmap(lambda im: _device_pyramid(im, levels))(ims)


@partial(jax.jit, static_argnames=("options", "nu", "kind"))
def _track_levels_fused_batch(options, nu, fixed_loss, levels, pyr_b, stiffness,
                              T_init_b, kind="photometric_se3"):
    """K frames' coarse-to-fine solves against ONE keyframe as a single
    vmapped XLA program (throughput mode): the per-frame LM while_loops
    batch into one lock-step loop, the keyframe level data broadcasts, and
    the whole batch pays ONE dispatch latency instead of K."""

    def one(pyr, T0):
        return _track_levels_fused(
            options, nu, fixed_loss, levels, pyr, stiffness, T0, kind
        )

    return jax.vmap(one)(pyr_b, T_init_b)


class _DensePipelineBase:
    """Shared tracking machinery (reference _compute_frame_to_keyframe_pose)."""

    def __init__(
        self,
        camera,
        first_pose=np.eye(4),
        pyrlevels: int = 4,
        keyframe_trans_thresh: float = 3.0,
        keyframe_rot_thresh: float = 0.3,
        loss=None,
        stiffness: float = 1.0 / 0.25,
        min_grad: float = 0.0,
        max_iters_per_level: int = 15,
        depth_stiffness: float | None = None,
        pixel_budget: int | None = 24576,
        affine_illumination: bool = False,
    ):
        self.camera = camera
        self.pyrlevels = pyrlevels
        self.keyframe_trans_thresh = keyframe_trans_thresh
        self.keyframe_rot_thresh = keyframe_rot_thresh
        self.loss = loss if loss is not None else TDistributionLoss(nu=5.0)
        self.stiffness = stiffness
        self.min_grad = min_grad
        self.pixel_budget = pixel_budget
        # DSO-style brightness transfer: per-frame gain/bias eliminated by
        # variable projection inside the kernel (pipelines/photometric.py)
        self._kind = (
            "photometric_affine_se3" if affine_illumination else "photometric_se3"
        )
        # tight per-level stopping: photometric alignment needs the tail
        # iterations (cost decrease per step shrinks fast near the optimum)
        self.options = lm.Options(
            method="lm",
            max_iters=max_iters_per_level,
            min_cost_decrease=0.9999,
            min_update_norm=1e-8,
        )
        self.keyframes: list[DenseKeyframe] = []
        self.T_c_w: list[np.ndarray] = []  # camera-from-world per tracked frame
        self._first_pose = _as_mat(first_pose)
        self._T_last_rel = np.eye(4)  # motion model: last frame-to-frame motion

    # ---- core per-level solve ----

    def prefetch(self, im) -> "PrefetchedFrame":
        """Start the async host->device upload of frame N+1 while frame N's
        solve is still running (jax device transfers are asynchronous:
        ``jnp.asarray`` returns before the bytes land).  Pass the handle to
        ``track`` in place of the image.  bench/vo_overlap.py measures how far
        the device overlaps the copy with the running solve."""
        host = _track_input(im)
        return PrefetchedFrame(host=host, dev=jnp.asarray(host))

    def _track_pyramid(self, im_track) -> list[jnp.ndarray]:
        # device-side pyramid: one jitted dispatch, one host upload — the
        # host-numpy version cost tens of ms per VGA frame on one CPU core.
        # uint8 frames upload raw (4x fewer bytes) and normalize on device.
        im = jnp.asarray(im_track)
        if im.dtype != jnp.uint8:
            im = im.astype(jnp.float32)
        return list(_device_pyramid(im, self.pyrlevels))

    def _level_loss(self, data, T_init):
        """Freeze the Student-t scale per level (Kerl-style IRLS): a loss
        whose scale re-estimates *inside* every cost call is scale-invariant,
        so LM would see no decrease from a uniformly shrinking residual.
        Estimate sigma once at the level's initial pose (one jitted dispatch;
        the scale stays a device scalar — the loss pytree treats it as a
        traced leaf, so no retrace and no host sync)."""
        loss = self.loss
        if not (isinstance(loss, TDistributionLoss) and loss.scale is None):
            return loss
        sigma = _estimate_tdist_scale(data, jnp.asarray(T_init), loss.nu, self._kind)
        return TDistributionLoss(nu=loss.nu, scale=sigma)

    def _solve_level(self, level_data, im_track_l, T_init: np.ndarray) -> np.ndarray:
        blocks = {
            "pose": VariableBlock.create("se3", jnp.asarray(T_init)[None])
        }
        data = {
            "camera": level_data.camera,
            "pt_ref": level_data.pt_ref[None],
            "I_ref": level_data.I_ref[None],
            "mask": level_data.mask[None],
            "im_track": im_track_l[None],
            "stiffness": jnp.asarray([self.stiffness], level_data.I_ref.dtype),
        }
        batch = FactorBatch.create(
            kind=self._kind,
            slots=("pose",),
            indices=(np.zeros(1, np.int32),),
            data=data,
            loss=self._level_loss(data, T_init),
        )
        solved, _ = lm.solve(FactorGraph(blocks, [batch]), self.options)
        return np.asarray(solved.blocks["pose"].values[0])

    def _compute_frame_to_keyframe_pose(
        self, keyframe: DenseKeyframe, im_track: np.ndarray, guess: np.ndarray
    ) -> np.ndarray:
        """Coarse-to-fine photometric alignment: T_track_key.  The whole
        pyramid (scale estimation + per-level LM solves) runs as ONE jitted
        dispatch — per-dispatch latency dominates per-frame cost otherwise."""
        pyr = self._track_pyramid(im_track)
        levels = tuple(
            (lv.camera, lv.pt_ref, lv.I_ref, lv.mask) for lv in keyframe.levels
        )
        nu = (
            self.loss.nu
            if isinstance(self.loss, TDistributionLoss) and self.loss.scale is None
            else None
        )
        # stiffness is constant: upload once (each host->device transfer
        # pays a fixed latency regardless of size)
        if not hasattr(self, "_stiff_dev"):
            self._stiff_dev = jnp.asarray(self.stiffness, jnp.float32)
        T = _track_levels_fused(
            self.options,
            nu,
            self.loss if nu is None else None,
            levels,
            tuple(pyr),
            self._stiff_dev,
            jnp.asarray(guess, jnp.float32),
            self._kind,
        )
        return np.asarray(T)

    def track_batch(self, ims, guesses=None):
        """Offline THROUGHPUT mode: K frames solved against the CURRENT
        keyframe in ONE vmapped dispatch.

        Per-frame latency can be bound by the host's upload and dispatch
        rather than by device compute (bench/vo_overlap.py) — offline batch
        tracking pays that latency ONCE per K frames: the frames upload as one (K, H, W)
        array and the K coarse-to-fine LM solves run lock-step under one
        vmap (the reference's pipelines are offline scripts over
        sequences, so this is its own workload).

        ``ims``: K same-shape intensity frames (list or (K, H, W) array).
        ``guesses``: optional (K, 4, 4) frame-from-keyframe initial
        guesses; defaults to the motion model extrapolated from the last
        tracked frame (guess_k = T_rel^(k+1) · T_last_w · T_key_w^-1).
        Returns a list of K SE3 world poses and appends them to
        ``self.T_c_w``.  No keyframe decisions are made inside the batch —
        segment batches at keyframe boundaries (or raise the thresholds)
        for long sequences."""
        if not self.keyframes:
            raise RuntimeError(
                "track_batch needs an existing keyframe: track() the first "
                "frame (with its depth/right image) before batching"
            )
        ims = [_track_input(im) for im in ims]
        K = len(ims)
        kf = self.keyframes[-1]
        T_key_w_inv = np.linalg.inv(kf.T_w)
        if guesses is None:
            g = []
            T_w = self.T_c_w[-1]
            for _ in range(K):
                T_w = self._T_last_rel @ T_w
                g.append(T_w @ T_key_w_inv)
            guesses = np.stack(g)
        else:
            guesses = np.stack([_as_mat(gk) for gk in guesses])

        pyr_b = _device_pyramid_batch(jnp.asarray(np.stack(ims)), self.pyrlevels)
        levels = tuple(
            (lv.camera, lv.pt_ref, lv.I_ref, lv.mask) for lv in kf.levels
        )
        nu = (
            self.loss.nu
            if isinstance(self.loss, TDistributionLoss) and self.loss.scale is None
            else None
        )
        if not hasattr(self, "_stiff_dev"):
            self._stiff_dev = jnp.asarray(self.stiffness, jnp.float32)
        T_rel = np.asarray(
            _track_levels_fused_batch(
                self.options,
                nu,
                self.loss if nu is None else None,
                levels,
                tuple(pyr_b),
                self._stiff_dev,
                jnp.asarray(guesses, jnp.float32),
                self._kind,
            )
        )
        out = []
        for k in range(K):
            T_w = T_rel[k] @ kf.T_w
            prev = self.T_c_w[-1]
            self._T_last_rel = T_w @ np.linalg.inv(prev)
            self.T_c_w.append(T_w)
            out.append(SE3(T_w))
        return out

    def _compute_frame_to_keyframe_pose_stepwise(
        self, keyframe: DenseKeyframe, im_track: np.ndarray, guess: np.ndarray
    ) -> np.ndarray:
        """Per-level host loop (kept for debugging / level inspection)."""
        pyr = self._track_pyramid(im_track)
        T = guess.copy()
        for lvl in range(self.pyrlevels - 1, -1, -1):
            T = self._solve_level(keyframe.levels[lvl], pyr[lvl], T)
        return T

    # ---- bookkeeping shared by both frontends ----

    def _track_common(self, make_keyframe, im_track, guess):
        if not self.keyframes:
            kf = make_keyframe()
            kf.T_w = self._first_pose
            self.keyframes.append(kf)
            self.T_c_w.append(self._first_pose.copy())
            return SE3(self.T_c_w[-1])

        kf = self.keyframes[-1]
        T_key_w = kf.T_w
        if guess is None:
            # motion model: propagate last frame-to-frame motion
            T_track_w_guess = self._T_last_rel @ self.T_c_w[-1]
            guess_rel = T_track_w_guess @ np.linalg.inv(T_key_w)
        else:
            guess_rel = _as_mat(guess)
        T_track_key = self._compute_frame_to_keyframe_pose(kf, im_track, guess_rel)
        T_track_w = T_track_key @ T_key_w

        prev = self.T_c_w[-1]
        self._T_last_rel = T_track_w @ np.linalg.inv(prev)
        self.T_c_w.append(T_track_w)

        # keyframe decision (reference thresholds, SURVEY.md §3.3) — pure
        # numpy on the single 4x4: an eager se3.log here costs one device
        # dispatch per op
        trans = np.linalg.norm(T_track_key[:3, 3])
        cos_theta = np.clip((np.trace(T_track_key[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        rot = abs(float(np.arccos(cos_theta)))
        if trans > self.keyframe_trans_thresh or rot > self.keyframe_rot_thresh:
            new_kf = make_keyframe()
            new_kf.T_w = T_track_w
            self.keyframes.append(new_kf)
        return SE3(T_track_w)


def _host_float01(im):
    """Keyframe-side normalization (host, once per keyframe): uint8 camera
    frames -> [0, 1] f32; float frames pass through."""
    im = np.asarray(im)
    if im.dtype == np.uint8:
        return im.astype(np.float32) / 255.0
    return im


def _track_input(im):
    """Tracked-frame input prep: keep uint8 RAW (the device pyramid
    normalizes after a 4x-smaller upload); floats become f32 host-side."""
    im = np.asarray(im)
    if im.dtype == np.uint8:
        return im
    return im.astype(np.float32, copy=False)


class PrefetchedFrame:
    """Handle from ``pipeline.prefetch(im)``: the device upload of a FUTURE
    tracked frame, started asynchronously so it can overlap the current
    frame's fused solve (double-buffering the upload latency).
    Carries the host copy too — keyframe creation needs it."""

    __slots__ = ("host", "dev")

    def __init__(self, host, dev):
        self.host = host
        self.dev = dev


class DenseStereoPipeline(_DensePipelineBase):
    """Dense stereo direct VO (reference DenseStereoPipeline).

    ``track(im_left, im_right, guess=None)`` returns the SE3 camera-from-
    world estimate for the frame and updates the internal trajectory
    ``self.T_c_w``.  ``disp`` may inject a precomputed disparity map;
    otherwise ``matcher`` selects the disparity stage: OpenCV "sgbm"/"bm"
    host-side (the reference's behavior) or "plane_sweep" for the on-device
    plane-sweep block matcher (pipelines/stereo_match.py).
    """

    def __init__(self, *args, matcher: str = "sgbm", **kw):
        super().__init__(*args, **kw)
        self.matcher = matcher

    def track(self, im_left, im_right, guess=None, disp=None):
        if isinstance(im_left, PrefetchedFrame):
            host_left, track_in = im_left.host, im_left.dev
        else:
            host_left, track_in = im_left, _track_input(im_left)

        def make_keyframe():
            return DenseStereoKeyframe(
                _host_float01(host_left), _host_float01(im_right), self.camera,
                self.pyrlevels, self.min_grad,
                disp=disp, matcher=self.matcher, pixel_budget=self.pixel_budget,
            )

        return self._track_common(make_keyframe, track_in, guess)


class DenseRGBDPipeline(_DensePipelineBase):
    """Dense RGB-D direct VO (reference DenseRGBDPipeline).

    ``track(im, depth, guess=None)``."""

    def track(self, im, depth, guess=None):
        if isinstance(im, PrefetchedFrame):
            host_im, track_in = im.host, im.dev
        else:
            host_im, track_in = im, _track_input(im)

        def make_keyframe():
            return DenseRGBDKeyframe(
                _host_float01(host_im), depth, self.camera, self.pyrlevels,
                self.min_grad, pixel_budget=self.pixel_budget,
            )

        return self._track_common(make_keyframe, track_in, guess)


__all__ = ["DenseStereoPipeline", "DenseRGBDPipeline", "PrefetchedFrame"]
