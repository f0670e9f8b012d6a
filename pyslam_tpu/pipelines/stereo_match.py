"""On-device stereo block matching — the on-device replacement for the
reference's OpenCV disparity stage (pyslam/pipelines/keyframes.py uses an
OpenCV stereo matcher, SURVEY.md §3.3 "the only OpenCV dependency").

Design (one jitted program, no cost volume in memory):

  * plane sweep over D disparity hypotheses under ``lax.scan`` — the carry
    holds only (H, W) running statistics, so peak memory is O(H*W), not
    O(H*W*D);
  * per hypothesis: SAD over a (2r+1)^2 window via TWO cumulative sums
    (integral image) — O(1) per pixel per window, elementwise only;
  * winner-take-all with subpixel parabola refinement: the scan carries the
    cost at best-1 and best+1 so the 3-point fit needs no second pass;
  * validity: texture (window SAD range), uniqueness (second-best outside
    ±1 of best must exceed ratio; candidates within ±1 of a superseded best
    are not retained — a slightly lenient approximation of OpenCV's rule),
    and border/disparity-range masks — invalid pixels come back NaN (the
    convention keyframes.py expects).

Used as the drop-in ``compute_disparity(matcher="plane_sweep")``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _box_sum(x, r):
    """(H, W) -> windowed sum over (2r+1)^2 via integral image (edge-safe:
    windows are cropped at the borders).

    The static-index gather form was chosen over an edge-padded pure-slice
    variant, which pays two extra padded materializations per hypothesis;
    the two have not been compared on the H100."""
    H, W = x.shape
    ii = jnp.cumsum(jnp.cumsum(x, axis=0), axis=1)
    ii = jnp.pad(ii, ((1, 0), (1, 0)))
    r0 = jnp.clip(jnp.arange(H) - r, 0, H)
    r1 = jnp.clip(jnp.arange(H) + r + 1, 0, H)
    c0 = jnp.clip(jnp.arange(W) - r, 0, W)
    c1 = jnp.clip(jnp.arange(W) + r + 1, 0, W)
    return ii[r1][:, c1] - ii[r0][:, c1] - ii[r1][:, c0] + ii[r0][:, c0]


@partial(jax.jit, static_argnames=("num_disparities", "block_radius"))
def block_match(
    im_left,
    im_right,
    num_disparities: int = 64,
    block_radius: int = 7,
    uniqueness_ratio: float = 1.10,
    texture_threshold: float = 0.5,
):
    """Disparity map (H, W) f32 for a rectified pair; invalid pixels NaN.

    Convention matches OpenCV StereoBM: disparity d means
    left(x, y) ~ right(x - d, y), d in [0, num_disparities)."""
    L = jnp.asarray(im_left, jnp.float32)
    R = jnp.asarray(im_right, jnp.float32)
    H, W = L.shape
    big = jnp.asarray(1e30, jnp.float32)
    cols = jnp.arange(W)

    def sweep(carry, d):
        best_c, best_d, c_bm1, c_bp1, second_c, prev_c = carry
        # right image shifted by d (zero-extended left edge is masked below)
        Rs = jnp.where(cols[None, :] >= d, jnp.roll(R, d, axis=1), 0.0)
        sad = _box_sum(jnp.abs(L - Rs), block_radius)
        sad = jnp.where(cols[None, :] >= d + block_radius, sad, big)

        new_best = sad < best_c
        # parabola neighbors: cost at best-1 is the previous hypothesis's
        # cost when the best is replaced; cost at best+1 arrives on the
        # NEXT hypothesis (d == best_d + 1)
        c_bm1 = jnp.where(new_best, prev_c, c_bm1)
        c_bp1 = jnp.where(new_best, big, c_bp1)
        at_bp1 = (~new_best) & (d == best_d + 1)
        c_bp1 = jnp.where(at_bp1, sad, c_bp1)
        # second-best outside +-1 of the (final) best for uniqueness
        far = jnp.abs(d - best_d) > 1
        second_c = jnp.where((~new_best) & far & (sad < second_c), sad, second_c)
        second_c = jnp.where(new_best & (best_c < second_c) & (d - best_d > 1),
                             best_c, second_c)
        best_d = jnp.where(new_best, d, best_d)
        best_c = jnp.where(new_best, sad, best_c)
        return (best_c, best_d, c_bm1, c_bp1, second_c, sad), None

    init = (
        jnp.full((H, W), big), jnp.full((H, W), -1, jnp.int32),
        jnp.full((H, W), big), jnp.full((H, W), big),
        jnp.full((H, W), big), jnp.full((H, W), big),
    )
    (best_c, best_d, c_bm1, c_bp1, second_c, _), _ = jax.lax.scan(
        sweep, init, jnp.arange(num_disparities, dtype=jnp.int32)
    )

    # subpixel parabola: offset = (c- - c+) / (2 (c- - 2c0 + c+))
    cm, c0, cp = c_bm1, best_c, c_bp1
    interior = (cm < big) & (cp < big)
    denom = cm - 2.0 * c0 + cp
    offset = jnp.where(
        interior & (denom > 1e-12), (cm - cp) / (2.0 * jnp.maximum(denom, 1e-12)), 0.0
    )
    disp = best_d.astype(jnp.float32) + jnp.clip(offset, -0.5, 0.5)

    n_win = _box_sum(jnp.ones((H, W), jnp.float32), block_radius)
    texture = _box_sum(jnp.abs(L - _box_sum(L, block_radius) / n_win), block_radius)
    valid = (
        (best_d >= 0)
        & (best_c < big)
        & (second_c >= best_c * uniqueness_ratio)
        & (texture > texture_threshold)
        & (cols[None, :] >= num_disparities + block_radius)
    )
    return jnp.where(valid, disp, jnp.nan)


__all__ = ["block_match"]
