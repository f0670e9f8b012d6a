"""SO(2) — planar rotation group, functional device-side core.

Capability parity with ``liegroups/numpy/so2.py`` (reference dep; SURVEY.md §1
L0).  Rotations are ``(..., 2, 2)`` arrays; all ops broadcast over leading
batch dimensions.
"""

from __future__ import annotations

import jax.numpy as jnp

DOF = 1


def wedge(phi):
    """(...,) or (..., 1) angle -> (..., 2, 2) skew matrix."""
    phi = jnp.asarray(phi)
    if phi.shape and phi.shape[-1] == 1:
        phi = phi[..., 0]
    zero = jnp.zeros_like(phi)
    return jnp.stack(
        [jnp.stack([zero, -phi], axis=-1), jnp.stack([phi, zero], axis=-1)], axis=-2
    )


def vee(Phi):
    """(..., 2, 2) -> (...,) angle."""
    return Phi[..., 1, 0]


def exp(phi):
    """(...,) angle -> (..., 2, 2) rotation matrix."""
    phi = jnp.asarray(phi)
    if phi.shape and phi.shape[-1] == 1:
        phi = phi[..., 0]
    c, s = jnp.cos(phi), jnp.sin(phi)
    return jnp.stack(
        [jnp.stack([c, -s], axis=-1), jnp.stack([s, c], axis=-1)], axis=-2
    )


def log(R):
    """(..., 2, 2) -> (...,) angle."""
    return jnp.arctan2(R[..., 1, 0], R[..., 0, 0])


def inv(R):
    return jnp.swapaxes(R, -1, -2)


def mul(Ra, Rb):
    return Ra @ Rb


def act(R, p):
    return jnp.einsum("...ij,...j->...i", R, p)


def perturb(R, phi):
    """Left-multiplicative update exp(phi) @ R."""
    return exp(phi) @ R


def identity(dtype=jnp.float32, batch_shape=()):
    return jnp.broadcast_to(jnp.eye(2, dtype=dtype), batch_shape + (2, 2))
