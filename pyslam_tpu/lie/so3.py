"""SO(3) — rotation group, functional device-side core.

Capability parity with the ``liegroups`` dependency of the reference
(``liegroups/numpy/so3.py``; structure per SURVEY.md §1 L0): ``exp``, ``log``,
``wedge``, ``vee``, ``left_jacobian``, ``inv_left_jacobian``, ``inv``,
``perturb``, plus composition helpers.

Design (device-first, not a translation):
  * Rotations are plain ``(..., 3, 3)`` arrays — no objects on the hot path.
    Every function broadcasts over arbitrary leading batch dimensions, so
    factor kernels are natively batched without a vmap layer.
  * All small-angle branches use the select-with-safe-denominator pattern so
    functions are jit-safe and NaN-free under ``jax.grad``/``jax.jacfwd``.
  * Default precision follows the input dtype (f32 on the device, f64 in CPU tests).
"""

from __future__ import annotations

import jax.numpy as jnp

DOF = 3

# Angle below which Taylor series replace the closed forms.  Chosen so the
# dropped term is below dtype epsilon for f32; CPU tests run f64 where the
# series is still ~1e-24 accurate at this cutoff.
_SMALL = 1e-4


def _unsqueeze(x, n=2):
    """Append ``n`` singleton dims (for broadcasting scalars over matrices)."""
    return x.reshape(x.shape + (1,) * n)


def wedge(phi):
    """(..., 3) axis-angle vector -> (..., 3, 3) skew-symmetric matrix."""
    phi = jnp.asarray(phi)
    zero = jnp.zeros_like(phi[..., 0])
    return jnp.stack(
        [
            jnp.stack([zero, -phi[..., 2], phi[..., 1]], axis=-1),
            jnp.stack([phi[..., 2], zero, -phi[..., 0]], axis=-1),
            jnp.stack([-phi[..., 1], phi[..., 0], zero], axis=-1),
        ],
        axis=-2,
    )


def vee(Phi):
    """(..., 3, 3) skew-symmetric matrix -> (..., 3) vector."""
    return jnp.stack([Phi[..., 2, 1], Phi[..., 0, 2], Phi[..., 1, 0]], axis=-1)


def _theta(phi):
    """Rotation angle; floored so sqrt stays differentiable at 0.

    NOTE on epsilons: this jaxlib's f64 is emulated double-float with an f32
    exponent range, so any epsilon that autodiff *squares* must stay >= ~1e-12
    (1e-30**2 underflows to 0 and poisons gradients with inf/NaN).  All
    denominators here therefore use the where-safe pattern (replace by 1.0 in
    the branch that is not selected) rather than additive epsilons.
    """
    theta_sq = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta_sq, 1e-24))
    return theta, theta_sq


def _one_minus_cos(theta):
    """1 - cos(theta) as 2 sin^2(theta/2).

    XLA's f64 ``cos`` has ~5e-11 absolute error near pi (measured on the CPU
    backend), which poisons trace-based formulas; ``sin`` near pi/2 is
    well-conditioned, so this form is accurate over the whole range.
    """
    s = jnp.sin(0.5 * theta)
    return 2.0 * s * s


def exp(phi):
    """Exponential map: (..., 3) -> (..., 3, 3) via Rodrigues' formula."""
    phi = jnp.asarray(phi)
    theta, theta_sq = _theta(phi)
    small = theta_sq < _SMALL**2
    inv_t = 1.0 / jnp.where(small, 1.0, theta)

    # sin(t)/t and (1-cos(t))/t^2 with Taylor fallbacks.
    a = jnp.where(small, 1.0 - theta_sq / 6.0, jnp.sin(theta) * inv_t)
    b = jnp.where(small, 0.5 - theta_sq / 24.0, _one_minus_cos(theta) * inv_t * inv_t)

    W = wedge(phi)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), W.shape)
    return eye + _unsqueeze(a) * W + _unsqueeze(b) * W2


def log(R):
    """Logarithmic map: (..., 3, 3) -> (..., 3) axis-angle.

    Robust over the full angle range, including the theta ~ pi branch (needed
    for sphere2500-class graphs with large relative rotations).
    """
    R = jnp.asarray(R)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    skew = vee(R - jnp.swapaxes(R, -1, -2))  # = 2 sin(theta) * axis
    # sin(theta) recovered from the skew part: exact to rounding even where
    # arccos of the trace is ill-conditioned (theta near 0 or pi).
    sin_theta = 0.5 * jnp.sqrt(jnp.maximum(jnp.sum(skew * skew, axis=-1), 1e-24))
    theta = jnp.arctan2(sin_theta, cos_theta)
    theta_sq = theta * theta

    small = theta < _SMALL
    near_pi = theta > jnp.pi - 1e-3

    # Generic branch: phi = theta / (2 sin theta) * skew; small-angle Taylor
    # for theta/(2 sin theta) ~ 0.5 + theta^2/12.
    factor_generic = jnp.where(
        small,
        0.5 + theta_sq / 12.0,
        theta / (2.0 * jnp.where(small, 1.0, sin_theta)),
    )
    phi_generic = _unsqueeze(factor_generic, 1) * skew

    # Near-pi branch: the skew part degenerates (|skew| -> 0); recover the
    # axis magnitudes from the symmetric part instead:
    #   B = (R + R^T)/2 - cos_theta * I = (1 - cos_theta) aa^T.
    B = 0.5 * (R + jnp.swapaxes(R, -1, -2)) - _unsqueeze(cos_theta) * jnp.eye(3, dtype=R.dtype)
    diag = jnp.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], axis=-1)
    # max(.., tiny) floors the sqrt argument so the *unselected* branch stays
    # differentiable (sqrt'(0) = inf would leak NaN through the final where).
    omc = jnp.where(near_pi, 1.0 - cos_theta, 1.0)  # >= ~2 when selected
    axis_abs = jnp.sqrt(jnp.maximum(diag / _unsqueeze(omc, 1), 1e-12))
    # Sign pattern from row k of B (k = largest component): B_kj = (1-cos) a_k a_j,
    # so with the gauge choice a_k > 0, sign(a_j) = sign(B_kj).
    k = jnp.argmax(axis_abs, axis=-1)
    row_k = jnp.take_along_axis(B, k[..., None, None] * jnp.ones((1, 3), jnp.int32), axis=-2)[
        ..., 0, :
    ]
    axis_pi = axis_abs * jnp.where(row_k >= 0.0, 1.0, -1.0)
    # Resolve the overall sign against the skew part while it still carries
    # sign information; at exactly pi the sign is a gauge freedom (+1 here).
    flip = jnp.sum(axis_pi * skew, axis=-1) < 0.0
    axis_pi = jnp.where(_unsqueeze(flip, 1), -axis_pi, axis_pi)
    phi_pi = _unsqueeze(theta, 1) * axis_pi

    return jnp.where(_unsqueeze(near_pi, 1), phi_pi, phi_generic)


def left_jacobian(phi):
    """Left Jacobian J_l(phi): (..., 3) -> (..., 3, 3).

    J_l = I + (1-cos t)/t^2 W + (t - sin t)/t^3 W^2.
    """
    phi = jnp.asarray(phi)
    theta, theta_sq = _theta(phi)
    small = theta_sq < _SMALL**2
    inv_t = 1.0 / jnp.where(small, 1.0, theta)
    a = jnp.where(small, 0.5 - theta_sq / 24.0, _one_minus_cos(theta) * inv_t * inv_t)
    b = jnp.where(
        small, 1.0 / 6.0 - theta_sq / 120.0, (theta - jnp.sin(theta)) * inv_t * inv_t * inv_t
    )
    W = wedge(phi)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), W.shape)
    return eye + _unsqueeze(a) * W + _unsqueeze(b) * W2


def inv_left_jacobian(phi):
    """Inverse left Jacobian J_l^{-1}(phi): (..., 3) -> (..., 3, 3).

    J_l^{-1} = I - W/2 + (1/t^2 - (1 + cos t)/(2 t sin t)) W^2.
    """
    phi = jnp.asarray(phi)
    theta, theta_sq = _theta(phi)
    small = theta_sq < _SMALL**2
    half = theta * 0.5
    # cot expression: 1/t^2 - cos(t/2)/(2 t sin(t/2)); Taylor: 1/12 + t^2/720.
    inv_t = 1.0 / jnp.where(small, 1.0, theta)
    inv_sin_half = 1.0 / jnp.where(small, 1.0, jnp.sin(half))
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        inv_t * inv_t - 0.5 * jnp.cos(half) * inv_sin_half * inv_t,
    )
    W = wedge(phi)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), W.shape)
    return eye - 0.5 * W + _unsqueeze(cot_term) * W2


def inv(R):
    """Group inverse (transpose)."""
    return jnp.swapaxes(R, -1, -2)


def mul(Ra, Rb):
    """Group composition."""
    return Ra @ Rb


def act(R, p):
    """Rotate points: (..., 3, 3) x (..., 3) -> (..., 3)."""
    return jnp.einsum("...ij,...j->...i", R, p)


def perturb(R, phi):
    """Left-multiplicative update: exp(phi) @ R (the reference's convention,
    pyslam/problem.py ``_update_params`` per SURVEY.md §3.1)."""
    return exp(phi) @ R


def identity(dtype=jnp.float32, batch_shape=()):
    return jnp.broadcast_to(jnp.eye(3, dtype=dtype), batch_shape + (3, 3))
