"""Dense keyframes — parity with the reference's keyframe classes
(pyslam/pipelines/keyframes.py per SURVEY.md §2.1): per-keyframe image /
disparity / depth pyramids with precomputed 3D points for the photometric
residual.

Device-first: pyramids are plain (H, W) arrays per level; every per-level
product (intensities, triangulated points, validity mask) is precomputed once
as flat static-shaped arrays so each tracking solve is pure device compute
with no per-frame recompilation.  Disparity comes from OpenCV's stereo
matcher (the reference's one OpenCV dependency, SURVEY.md §3.3) but can be
injected precomputed (synthetic data, other matchers).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..sensors import RGBDCamera, StereoCamera


def pyrdown(im: np.ndarray) -> np.ndarray:
    """2x2 average-pool downsample (deterministic, matcher-independent)."""
    H, W = im.shape
    H2, W2 = H // 2, W // 2
    im = im[: 2 * H2, : 2 * W2]
    return im.reshape(H2, 2, W2, 2).mean(axis=(1, 3))


def scale_camera(camera, level: int):
    """Camera intrinsics for pyramid level ``level`` (0 = full resolution).

    Uses the pixel-center-preserving convention c' = (c + 0.5) * s - 0.5.
    """
    s = 0.5**level
    kw = dict(
        cu=(camera.cu + 0.5) * s - 0.5,
        cv=(camera.cv + 0.5) * s - 0.5,
        fu=camera.fu * s,
        fv=camera.fv * s,
        w=int(camera.w * s),
        h=int(camera.h * s),
    )
    if isinstance(camera, StereoCamera):
        return StereoCamera(b=camera.b, **kw)
    return RGBDCamera(**kw)


def compute_disparity(
    im_left: np.ndarray,
    im_right: np.ndarray,
    matcher: str = "sgbm",
    num_disparities: int | None = None,
):
    """Disparity via OpenCV block matching (reference behavior, SURVEY.md
    §3.3) or the on-device plane-sweep matcher (``matcher="plane_sweep"``,
    pipelines/stereo_match.py — one jitted program, runs on device).
    Inputs are float images in [0, 1] or uint8.  Invalid pixels are
    returned as NaN.  ``num_disparities`` defaults to the largest multiple
    of 16 the image width supports (capped at 128)."""
    W = im_left.shape[1]
    if num_disparities is None:
        num_disparities = max(16, min(128, ((W // 3) // 16) * 16))
    if matcher == "plane_sweep":
        from .stereo_match import block_match

        def to_f(im):
            im = np.asarray(im)
            return im.astype(np.float32) / 255.0 if im.dtype == np.uint8 else im

        return np.asarray(
            block_match(to_f(im_left), to_f(im_right), num_disparities=num_disparities)
        ).astype(np.float64)

    import cv2

    def to_u8(im):
        if im.dtype == np.uint8:
            return im
        return np.clip(im * 255.0, 0, 255).astype(np.uint8)

    l8, r8 = to_u8(im_left), to_u8(im_right)
    if matcher == "sgbm":
        m = cv2.StereoSGBM_create(
            minDisparity=0,
            numDisparities=num_disparities,
            blockSize=7,
            P1=8 * 49,
            P2=32 * 49,
            uniquenessRatio=10,
        )
    else:
        m = cv2.StereoBM_create(numDisparities=num_disparities, blockSize=15)
    disp = m.compute(l8, r8).astype(np.float64) / 16.0
    disp[disp <= 0] = np.nan
    return disp


@dataclasses.dataclass
class _Level:
    """Precomputed per-level tracking data (static shapes)."""

    camera: object
    im: jnp.ndarray  # (H, W)
    pt_ref: jnp.ndarray  # (P, 3)
    I_ref: jnp.ndarray  # (P,)
    mask: jnp.ndarray  # (P,) float


class DenseKeyframe:
    """Shared pyramid precompute.  ``depth_or_disp`` follows the camera's
    triangulate convention (disparity for stereo, depth for RGB-D).

    ``pixel_budget`` caps the residual count per level to the highest-
    gradient pixels (DSO-style selection).  The budget is a STATIC shape —
    identical across keyframes — so the per-level tracking solve compiles
    once for a whole run regardless of image content.  Together with the
    fused one-dispatch-per-frame pyramid solve (pipelines/dense.py) this
    keeps VGA RGB-D tracking to one compiled program per level; its speed
    on the H100 is not measured.
    ``pixel_budget=None`` keeps every pixel (reference behavior)."""

    def __init__(
        self, im, depth_or_disp, camera, pyrlevels=4, min_grad=0.0, T_w=None,
        pixel_budget: int | None = 24576, dtype=np.float32,
    ):
        # f32 device arrays by default: photometric tracking accuracy is
        # intensity-noise-limited, so f64 would only cost bandwidth
        self.T_w = T_w  # pose of the world in keyframe coords (set by pipeline)
        self.pyrlevels = pyrlevels
        self.dtype = dtype
        self.levels: list[_Level] = []
        im = np.asarray(im, np.float64)
        dd = np.asarray(depth_or_disp, np.float64)
        for lvl in range(pyrlevels):
            cam_l = scale_camera(camera, lvl)
            if lvl > 0:
                im = pyrdown(im)
                dd = pyrdown(dd)
                if isinstance(camera, StereoCamera):
                    dd = dd / 2.0  # disparity scales with resolution
            H, W = im.shape
            vv, uu = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64), indexing="ij")
            obs = np.stack([uu, vv, dd], axis=-1).reshape(-1, 3)
            finite = np.isfinite(obs[:, 2])
            obs_f = np.where(finite[:, None], obs, [0.0, 0.0, 1.0])
            valid = np.asarray(cam_l.is_valid_measurement(jnp.asarray(obs_f))) & finite
            gy, gx = np.gradient(im)
            gmag = np.sqrt(gx * gx + gy * gy).reshape(-1)
            if min_grad > 0.0:
                valid = valid & (gmag >= min_grad)
            I_flat = im.reshape(-1)
            if pixel_budget is not None and len(obs) > pixel_budget:
                # keep the pixel_budget highest-gradient valid pixels;
                # invalid pixels score -1 so they are only chosen when the
                # level has fewer valid pixels than the budget (then masked)
                score = np.where(valid, gmag, -1.0)
                sel = np.argpartition(score, len(score) - pixel_budget)[-pixel_budget:]
                obs = obs[sel]
                valid = valid[sel]
                I_flat = I_flat[sel]
            pt = np.asarray(cam_l.triangulate(jnp.asarray(np.where(valid[:, None], obs, [0.0, 0.0, 1.0]))))
            self.levels.append(
                _Level(
                    camera=cam_l,
                    im=jnp.asarray(im, dtype),
                    pt_ref=jnp.asarray(pt, dtype),
                    I_ref=jnp.asarray(I_flat, dtype),
                    mask=jnp.asarray(valid.astype(dtype)),
                )
            )


class DenseStereoKeyframe(DenseKeyframe):
    """Stereo keyframe: disparity from OpenCV (or injected), then pyramids
    (reference DenseStereoKeyframe)."""

    def __init__(self, im_left, im_right, camera, pyrlevels=4, min_grad=0.0, disp=None, matcher="sgbm", pixel_budget=24576):
        self.im_left = np.asarray(im_left, np.float64)
        self.im_right = np.asarray(im_right, np.float64)
        if disp is None:
            disp = compute_disparity(self.im_left, self.im_right, matcher)
        super().__init__(self.im_left, disp, camera, pyrlevels, min_grad, pixel_budget=pixel_budget)


class DenseRGBDKeyframe(DenseKeyframe):
    """RGB-D keyframe: depth pyramid (reference DenseRGBDKeyframe)."""

    def __init__(self, im, depth, camera, pyrlevels=4, min_grad=0.0, pixel_budget=24576):
        super().__init__(np.asarray(im, np.float64), depth, camera, pyrlevels, min_grad, pixel_budget=pixel_budget)


__all__ = [
    "DenseKeyframe",
    "DenseStereoKeyframe",
    "DenseRGBDKeyframe",
    "compute_disparity",
    "pyrdown",
    "scale_camera",
]
