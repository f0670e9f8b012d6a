"""Camera sensor models — parity with ``pyslam/sensors.py`` (SURVEY.md §1 L2,
§2.1): ``StereoCamera`` and ``RGBDCamera`` with ``project`` / ``triangulate``
(both with analytic 3x3 Jacobians) and validity masks.

Device-first: cameras are frozen pytree dataclasses; ``project``/``triangulate``
broadcast over arbitrary leading batch dims — a (N, 3) point cloud maps to one
fused elementwise pass under jit, no per-point loop.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


def _register(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]

    def flatten(obj):
        return tuple(getattr(obj, n) for n in fields), None

    def unflatten(aux, children):
        return cls(*children)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


@_register
class StereoCamera:
    """Rectified stereo camera.  Observations are ``[u_left, v_left, disparity]``.

    Reference behavior (pyslam/sensors.py StereoCamera per SURVEY.md §2.1):
      project:     p=(x,y,z) -> [fu x/z + cu, fv y/z + cv, fu b / z]
      triangulate: [u,v,d]   -> z = fu b / d, x = (u-cu) z / fu, y = (v-cv) z / fv
    """

    cu: float
    cv: float
    fu: float
    fv: float
    b: float
    w: int = 0
    h: int = 0

    def project(self, pt, compute_jacobians: bool = False):
        pt = jnp.asarray(pt)
        x, y, z = pt[..., 0], pt[..., 1], pt[..., 2]
        one_over_z = 1.0 / z
        obs = jnp.stack(
            [
                self.fu * x * one_over_z + self.cu,
                self.fv * y * one_over_z + self.cv,
                self.fu * self.b * one_over_z,
            ],
            axis=-1,
        )
        if not compute_jacobians:
            return obs
        zero = jnp.zeros_like(x)
        oz2 = one_over_z * one_over_z
        jac = jnp.stack(
            [
                jnp.stack([self.fu * one_over_z, zero, -self.fu * x * oz2], axis=-1),
                jnp.stack([zero, self.fv * one_over_z, -self.fv * y * oz2], axis=-1),
                jnp.stack([zero, zero, -self.fu * self.b * oz2], axis=-1),
            ],
            axis=-2,
        )
        return obs, jac

    def triangulate(self, obs, compute_jacobians: bool = False):
        obs = jnp.asarray(obs)
        u, v, d = obs[..., 0], obs[..., 1], obs[..., 2]
        z = self.fu * self.b / d
        x = (u - self.cu) * z / self.fu
        y = (v - self.cv) * z / self.fv
        pt = jnp.stack([x, y, z], axis=-1)
        if not compute_jacobians:
            return pt
        zero = jnp.zeros_like(u)
        dz_dd = -self.fu * self.b / (d * d)
        jac = jnp.stack(
            [
                jnp.stack([z / self.fu, zero, (u - self.cu) / self.fu * dz_dd], axis=-1),
                jnp.stack([zero, z / self.fv, (v - self.cv) / self.fv * dz_dd], axis=-1),
                jnp.stack([zero, zero, dz_dd], axis=-1),
            ],
            axis=-2,
        )
        return pt, jac

    def is_valid_measurement(self, obs):
        obs = jnp.asarray(obs)
        u, v, d = obs[..., 0], obs[..., 1], obs[..., 2]
        return (
            (d > 0.0)
            & (u >= 0.0)
            & (u < self.w)
            & (v >= 0.0)
            & (v < self.h)
        )


@_register
class RGBDCamera:
    """RGB-D camera.  Observations are ``[u, v, z]``.

    Reference behavior (pyslam/sensors.py RGBDCamera per SURVEY.md §2.1):
      project:     p=(x,y,z) -> [fu x/z + cu, fv y/z + cv, z]
      triangulate: [u,v,z]   -> x = (u-cu) z / fu, y = (v-cv) z / fv
    """

    cu: float
    cv: float
    fu: float
    fv: float
    w: int = 0
    h: int = 0

    def project(self, pt, compute_jacobians: bool = False):
        pt = jnp.asarray(pt)
        x, y, z = pt[..., 0], pt[..., 1], pt[..., 2]
        one_over_z = 1.0 / z
        obs = jnp.stack(
            [
                self.fu * x * one_over_z + self.cu,
                self.fv * y * one_over_z + self.cv,
                z,
            ],
            axis=-1,
        )
        if not compute_jacobians:
            return obs
        zero = jnp.zeros_like(x)
        one = jnp.ones_like(x)
        oz2 = one_over_z * one_over_z
        jac = jnp.stack(
            [
                jnp.stack([self.fu * one_over_z, zero, -self.fu * x * oz2], axis=-1),
                jnp.stack([zero, self.fv * one_over_z, -self.fv * y * oz2], axis=-1),
                jnp.stack([zero, zero, one], axis=-1),
            ],
            axis=-2,
        )
        return obs, jac

    def triangulate(self, obs, compute_jacobians: bool = False):
        obs = jnp.asarray(obs)
        u, v, z = obs[..., 0], obs[..., 1], obs[..., 2]
        x = (u - self.cu) * z / self.fu
        y = (v - self.cv) * z / self.fv
        pt = jnp.stack([x, y, z], axis=-1)
        if not compute_jacobians:
            return pt
        zero = jnp.zeros_like(u)
        one = jnp.ones_like(u)
        jac = jnp.stack(
            [
                jnp.stack([z / self.fu, zero, (u - self.cu) / self.fu], axis=-1),
                jnp.stack([zero, z / self.fv, (v - self.cv) / self.fv], axis=-1),
                jnp.stack([zero, zero, one], axis=-1),
            ],
            axis=-2,
        )
        return pt, jac

    def is_valid_measurement(self, obs):
        obs = jnp.asarray(obs)
        u, v, z = obs[..., 0], obs[..., 1], obs[..., 2]
        return (
            (z > 0.0)
            & (u >= 0.0)
            & (u < self.w)
            & (v >= 0.0)
            & (v < self.h)
        )


__all__ = ["StereoCamera", "RGBDCamera"]
