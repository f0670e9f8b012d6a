"""SE(3) — rigid transforms, functional device-side core.

Capability parity with ``liegroups/numpy/se3.py`` (reference dep; SURVEY.md §1
L0): ``exp``, ``log``, ``wedge``, ``vee``, ``curlywedge``, ``adjoint``,
``odot``, ``left_jacobian``, ``inv_left_jacobian``, ``inv``, ``perturb``.

Transforms are ``(..., 4, 4)`` homogeneous matrices; tangent vectors are
``xi = [rho (3), phi (3)]`` — translation first, the reference's liegroups
convention.  All ops broadcast over leading batch dimensions, so factor
kernels are natively batched (SURVEY.md §7 "factors are arrays, not objects").
"""

from __future__ import annotations

import jax.numpy as jnp

from . import so3

DOF = 6
_SMALL = 1e-4


def wedge(xi):
    """(..., 6) -> (..., 4, 4): [[phi^, rho], [0, 0]]."""
    xi = jnp.asarray(xi)
    rho, phi = xi[..., :3], xi[..., 3:]
    W = so3.wedge(phi)
    top = jnp.concatenate([W, rho[..., :, None]], axis=-1)
    bottom = jnp.zeros(xi.shape[:-1] + (1, 4), xi.dtype)
    return jnp.concatenate([top, bottom], axis=-2)


def vee(Xi):
    return jnp.concatenate([Xi[..., :3, 3], so3.vee(Xi[..., :3, :3])], axis=-1)


def curlywedge(xi):
    """(..., 6) -> (..., 6, 6) adjoint-algebra matrix [[phi^, rho^], [0, phi^]]."""
    xi = jnp.asarray(xi)
    rho, phi = xi[..., :3], xi[..., 3:]
    P = so3.wedge(phi)
    R = so3.wedge(rho)
    zero = jnp.zeros_like(P)
    top = jnp.concatenate([P, R], axis=-1)
    bottom = jnp.concatenate([zero, P], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def exp(xi):
    """Exponential map: (..., 6) -> (..., 4, 4)."""
    xi = jnp.asarray(xi)
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3.exp(phi)
    t = jnp.einsum("...ij,...j->...i", so3.left_jacobian(phi), rho)
    return _assemble(R, t)


def log(T):
    """Logarithmic map: (..., 4, 4) -> (..., 6)."""
    T = jnp.asarray(T)
    R, t = T[..., :3, :3], T[..., :3, 3]
    phi = so3.log(R)
    rho = jnp.einsum("...ij,...j->...i", so3.inv_left_jacobian(phi), t)
    return jnp.concatenate([rho, phi], axis=-1)


def _assemble(R, t):
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.zeros(R.shape[:-2] + (1, 4), R.dtype).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def inv(T):
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return _assemble(Rt, -jnp.einsum("...ij,...j->...i", Rt, t))


def mul(Ta, Tb):
    return Ta @ Tb


def act(T, p):
    """Transform 3D points: (..., 4, 4) x (..., 3) -> (..., 3)."""
    return jnp.einsum("...ij,...j->...i", T[..., :3, :3], p) + T[..., :3, 3]


def rot(T):
    return T[..., :3, :3]


def trans(T):
    return T[..., :3, 3]


def adjoint(T):
    """(..., 4, 4) -> (..., 6, 6): [[R, t^ R], [0, R]] (for [rho, phi] order)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    tR = so3.wedge(t) @ R
    zero = jnp.zeros_like(R)
    top = jnp.concatenate([R, tR], axis=-1)
    bottom = jnp.concatenate([zero, R], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def odot(p, directional: bool = False):
    """(..., 3) point -> (..., 3, 6) s.t. wedge(xi) @ [p; w] = odot(p) @ xi.

    For a point (w=1): [I3, -p^]; for a direction (w=0): [0, -p^].
    Reference: liegroups SE3.odot (SURVEY.md §3.2 analytic chain rule).
    """
    p = jnp.asarray(p)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=p.dtype), p.shape[:-1] + (3, 3))
    left = jnp.zeros_like(eye) if directional else eye
    return jnp.concatenate([left, -so3.wedge(p)], axis=-1)


def _Q_matrix(rho, phi):
    """Barfoot's Q matrix for the SE(3) left Jacobian (Barfoot Eq. 7.86b)."""
    rx = so3.wedge(rho)
    px = so3.wedge(phi)
    th2 = jnp.sum(phi * phi, axis=-1)
    th = jnp.sqrt(jnp.maximum(th2, 1e-24))
    small = th2 < _SMALL**2
    # reciprocal-multiplication (not division by tiny powers): autodiff of
    # a/b forms b**2, which underflows this backend's f32 exponent range.
    inv_t = 1.0 / jnp.where(small, 1.0, th)
    sth, cth = jnp.sin(th), jnp.cos(th)
    inv3 = inv_t * inv_t * inv_t
    # 0.5*th2 + cth - 1 == 0.5*th2 - (1 - cth), with 1-cth via sin^2(th/2)
    omc = 2.0 * jnp.square(jnp.sin(0.5 * th))

    m2 = jnp.where(small, 1.0 / 6.0 - th2 / 120.0, (th - sth) * inv3)
    m3 = jnp.where(small, 1.0 / 24.0 - th2 / 720.0, (0.5 * th2 - omc) * inv3 * inv_t)
    m4 = jnp.where(
        small,
        1.0 / 120.0 - th2 / 2520.0,
        (th - 1.5 * sth + 0.5 * th * cth) * inv3 * inv_t * inv_t,
    )

    pr = px @ rx
    rp = rx @ px
    t2 = pr + rp + px @ rp
    pp = px @ px
    t3 = pp @ rx + rx @ pp - 3.0 * (pr @ px)
    t4 = (pr @ px) @ px + (pp @ rx) @ px

    def b(c):
        return c[..., None, None]

    return 0.5 * rx + b(m2) * t2 + b(m3) * t3 + b(m4) * t4


def left_jacobian(xi):
    """SE(3) left Jacobian: (..., 6) -> (..., 6, 6) = [[J(phi), Q], [0, J(phi)]]."""
    xi = jnp.asarray(xi)
    rho, phi = xi[..., :3], xi[..., 3:]
    J = so3.left_jacobian(phi)
    Q = _Q_matrix(rho, phi)
    zero = jnp.zeros_like(J)
    top = jnp.concatenate([J, Q], axis=-1)
    bottom = jnp.concatenate([zero, J], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def inv_left_jacobian(xi):
    """Inverse SE(3) left Jacobian: [[Jinv, -Jinv Q Jinv], [0, Jinv]]."""
    xi = jnp.asarray(xi)
    rho, phi = xi[..., :3], xi[..., 3:]
    Jinv = so3.inv_left_jacobian(phi)
    Q = _Q_matrix(rho, phi)
    upper = -Jinv @ Q @ Jinv
    zero = jnp.zeros_like(Jinv)
    top = jnp.concatenate([Jinv, upper], axis=-1)
    bottom = jnp.concatenate([zero, Jinv], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def perturb(T, xi):
    """Left-multiplicative update exp(xi) @ T (the reference's convention,
    pyslam/problem.py ``_update_params`` per SURVEY.md §3.1)."""
    return exp(xi) @ T


def identity(dtype=jnp.float32, batch_shape=()):
    return jnp.broadcast_to(jnp.eye(4, dtype=dtype), batch_shape + (4, 4))


def normalize(T):
    """Re-orthonormalize the rotation block (guards f32 drift over many
    compositions) via symmetric orthogonalization."""
    R = T[..., :3, :3]
    u, _, vt = jnp.linalg.svd(R)
    det = jnp.linalg.det(u @ vt)
    u = u.at[..., :, -1].multiply(jnp.sign(det)[..., None])
    return _assemble(u @ vt, T[..., :3, 3])
