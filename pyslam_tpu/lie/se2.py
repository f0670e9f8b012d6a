"""SE(2) — planar rigid transforms, functional device-side core.

Capability parity with ``liegroups/numpy/se2.py`` (reference dep; SURVEY.md §1
L0).  Transforms are ``(..., 3, 3)`` homogeneous matrices; tangent vectors are
``xi = [rho_x, rho_y, phi]`` (translation first — the reference's liegroups
convention).  All ops broadcast over leading batch dimensions.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import so2

DOF = 3
_SMALL = 1e-4

_J2 = jnp.array([[0.0, -1.0], [1.0, 0.0]])


def _coeffs(phi, dtype):
    """Scalar series sin(x)/x, (1-cos x)/x, (1-cos x)/x^2, (x-sin x)/x^2."""
    x = phi
    x2 = x * x
    small = x2 < _SMALL**2
    sx = jnp.sin(x)
    # 1 - cos(x) as 2 sin^2(x/2): XLA's cos has ~5e-11 absolute error near pi.
    omc = 2.0 * jnp.square(jnp.sin(0.5 * x))
    a = jnp.where(small, 1.0 - x2 / 6.0, sx / jnp.where(small, 1.0, x))
    b = jnp.where(small, x / 2.0 - x * x2 / 24.0, omc / jnp.where(small, 1.0, x))
    g = jnp.where(small, 0.5 - x2 / 24.0, omc / jnp.where(small, 1.0, x2))
    d = jnp.where(small, x / 6.0 - x * x2 / 120.0, (x - sx) / jnp.where(small, 1.0, x2))
    return a.astype(dtype), b.astype(dtype), g.astype(dtype), d.astype(dtype)


def wedge(xi):
    """(..., 3) -> (..., 3, 3): [[phi*J2, rho], [0, 0]]."""
    xi = jnp.asarray(xi)
    rho, phi = xi[..., :2], xi[..., 2]
    zero = jnp.zeros_like(phi)
    row0 = jnp.stack([zero, -phi, rho[..., 0]], axis=-1)
    row1 = jnp.stack([phi, zero, rho[..., 1]], axis=-1)
    row2 = jnp.stack([zero, zero, zero], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def vee(Xi):
    return jnp.stack([Xi[..., 0, 2], Xi[..., 1, 2], Xi[..., 1, 0]], axis=-1)


def _V(phi, dtype):
    """The 2x2 'translation' Jacobian V(phi) = sin/x I + (1-cos)/x J2."""
    a, b, _, _ = _coeffs(phi, dtype)
    eye = jnp.eye(2, dtype=dtype)
    J = _J2.astype(dtype)
    return a[..., None, None] * eye + b[..., None, None] * J


def exp(xi):
    """Exponential map: (..., 3) -> (..., 3, 3)."""
    xi = jnp.asarray(xi)
    rho, phi = xi[..., :2], xi[..., 2]
    # phi[..., None]: so2.exp's (..., 1)->(...,) squeeze heuristic would
    # otherwise eat a batch axis of exactly one element (phi is already
    # scalar-shaped here); feeding it the trailing dof axis it expects
    # makes the squeeze exact for every batch shape
    R = so2.exp(phi[..., None])
    t = jnp.einsum("...ij,...j->...i", _V(phi, xi.dtype), rho)
    return _assemble(R, t)


def log(T):
    """Logarithmic map: (..., 3, 3) -> (..., 3)."""
    T = jnp.asarray(T)
    R, t = T[..., :2, :2], T[..., :2, 2]
    phi = so2.log(R)
    a, b, _, _ = _coeffs(phi, T.dtype)
    # V^{-1} = 1/(a^2+b^2) [[a, b], [-b, a]]
    denom = a * a + b * b
    Vinv_t = jnp.stack(
        [(a * t[..., 0] + b * t[..., 1]) / denom, (-b * t[..., 0] + a * t[..., 1]) / denom],
        axis=-1,
    )
    return jnp.concatenate([Vinv_t, phi[..., None]], axis=-1)


def _assemble(R, t):
    bottom = jnp.zeros(R.shape[:-2] + (1, 3), R.dtype).at[..., 0, 2].set(1.0)
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def inv(T):
    R, t = T[..., :2, :2], T[..., :2, 2]
    Rt = jnp.swapaxes(R, -1, -2)
    return _assemble(Rt, -jnp.einsum("...ij,...j->...i", Rt, t))


def mul(Ta, Tb):
    return Ta @ Tb


def act(T, p):
    """Transform 2D points: (..., 3, 3) x (..., 2) -> (..., 2)."""
    return jnp.einsum("...ij,...j->...i", T[..., :2, :2], p) + T[..., :2, 2]


def adjoint(T):
    """(..., 3, 3) -> (..., 3, 3) adjoint: [[R, [t_y, -t_x]^T], [0, 1]]."""
    R, t = T[..., :2, :2], T[..., :2, 2]
    col = jnp.stack([t[..., 1], -t[..., 0]], axis=-1)
    top = jnp.concatenate([R, col[..., :, None]], axis=-1)
    bottom = jnp.zeros(T.shape[:-2] + (1, 3), T.dtype).at[..., 0, 2].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def odot(p):
    """(..., 2) point -> (..., 2, 3) matrix s.t. wedge(xi) @ [p;1] = odot(p) @ xi.

    odot(p) = [[1, 0, -p_y], [0, 1, p_x]]  (reference: liegroups SE2.odot).
    """
    p = jnp.asarray(p)
    one = jnp.ones_like(p[..., 0])
    zero = jnp.zeros_like(one)
    row0 = jnp.stack([one, zero, -p[..., 1]], axis=-1)
    row1 = jnp.stack([zero, one, p[..., 0]], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


def left_jacobian(xi):
    """Left Jacobian of SE(2): (..., 3) -> (..., 3, 3).

    Closed form from the nilpotent structure of ad(xi):
    J_l = [[V(phi), (g I + d J2)(-J2 rho)], [0, 1]] with
    g = (1-cos)/phi^2, d = (phi-sin)/phi^2.
    """
    xi = jnp.asarray(xi)
    rho, phi = xi[..., :2], xi[..., 2]
    _, _, g, d = _coeffs(phi, xi.dtype)
    V = _V(phi, xi.dtype)
    J = _J2.astype(xi.dtype)
    Jrho = jnp.einsum("ij,...j->...i", J, rho)
    u = -(g[..., None] * Jrho + d[..., None] * jnp.einsum("ij,...j->...i", J, Jrho))
    top = jnp.concatenate([V, u[..., :, None]], axis=-1)
    bottom = jnp.zeros(xi.shape[:-1] + (1, 3), xi.dtype).at[..., 0, 2].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def inv_left_jacobian(xi):
    """Inverse left Jacobian: block inverse [[V, u],[0,1]]^-1 = [[V^-1, -V^-1 u],[0,1]]."""
    xi = jnp.asarray(xi)
    rho, phi = xi[..., :2], xi[..., 2]
    a, b, g, d = _coeffs(phi, xi.dtype)
    J = _J2.astype(xi.dtype)
    Jrho = jnp.einsum("ij,...j->...i", J, rho)
    u = -(g[..., None] * Jrho + d[..., None] * jnp.einsum("ij,...j->...i", J, Jrho))
    denom = (a * a + b * b)[..., None, None]
    eye = jnp.eye(2, dtype=xi.dtype)
    # V = a I + b J  =>  V^-1 = (a I - b J) / (a^2 + b^2)
    Vinv = (a[..., None, None] * eye - b[..., None, None] * J) / denom
    nu = -jnp.einsum("...ij,...j->...i", Vinv, u)
    top = jnp.concatenate([Vinv, nu[..., :, None]], axis=-1)
    bottom = jnp.zeros(xi.shape[:-1] + (1, 3), xi.dtype).at[..., 0, 2].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def perturb(T, xi):
    """Left-multiplicative update exp(xi) @ T (reference convention)."""
    return exp(xi) @ T


def identity(dtype=jnp.float32, batch_shape=()):
    return jnp.broadcast_to(jnp.eye(3, dtype=dtype), batch_shape + (3, 3))
