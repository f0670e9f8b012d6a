"""Sim(3) — similarity transforms (rotation + translation + scale).

Beyond-reference capability: the reference's ``liegroups`` dependency stops
at SE(3) (SURVEY.md §1 L0), but monocular SLAM needs Sim(3) pose-graph
optimization to absorb scale drift at loop closure (Strasdat et al., "Scale
Drift-Aware Large Scale Monocular SLAM", RSS 2010 — the ORB-SLAM loop
correction).  This module follows the same functional conventions as
``se3.py`` so the generic prior/between factor kernels and the whole solver
stack work over Sim(3) variable blocks unchanged.

Representation: ``(..., 4, 4)`` matrices ``[[s*R, t], [0, 1]]``.  Tangent
vectors are ``xi = [rho (3), phi (3), sigma (1)]`` — translation first
(matching the se3 convention), log-scale last.

Design notes (device-first):
  * ``exp``/``log`` use the closed-form ``W = a*I + b*phi^ + c*phi^2``
    matrix (the integral of ``e^{sigma*u} * exp(u*phi^)``) with Taylor
    branches for small sigma / small theta — pure branch-free ``jnp.where``
    math, batched over leading axes.
  * ``left_jacobian`` is the entire series sum_n ad^n/(n+1)! (factorial
    convergence — exact to f64 roundoff at any practical argument); its
    inverse exploits the block-triangular structure of ``ad`` so NO
    Bernoulli series (2*pi convergence radius) and NO batched LU solve
    (slow on this backend, CLAUDE.md lessons) is needed: the diagonal
    blocks invert in closed form (W^-1 by 3x3 adjugate, SO(3) J^-1
    closed-form) and the couplings follow by triangular block inversion.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import so3

DOF = 7
_SMALL = 1e-3


def wedge(xi):
    """(..., 7) -> (..., 4, 4): [[sigma*I + phi^, rho], [0, 0]]."""
    xi = jnp.asarray(xi)
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    A = so3.wedge(phi) + sigma[..., None, None] * jnp.eye(3, dtype=xi.dtype)
    top = jnp.concatenate([A, rho[..., :, None]], axis=-1)
    bottom = jnp.zeros(xi.shape[:-1] + (1, 4), xi.dtype)
    return jnp.concatenate([top, bottom], axis=-2)


def vee(Xi):
    Xi = jnp.asarray(Xi)
    A = Xi[..., :3, :3]
    sigma = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    skew = A - sigma[..., None, None] * jnp.eye(3, dtype=Xi.dtype)
    return jnp.concatenate(
        [Xi[..., :3, 3], so3.vee(skew), sigma[..., None]], axis=-1
    )


def _W_coeffs(sigma, theta):
    """Coefficients (a, b, c) of W = int_0^1 e^{sigma*u} exp(u*phi^) du
    = a*I + b*phi^ + c*phi^^2, with Taylor branches for each of the four
    (sigma small?) x (theta small?) regions.  All branches are evaluated on
    guarded denominators so no NaN leaks through jnp.where."""
    sm_s = jnp.abs(sigma) < _SMALL
    sm_t = theta < _SMALL
    # guarded denominators
    s = jnp.where(sm_s, 1.0, sigma)
    th = jnp.where(sm_t, 1.0, theta)
    es = jnp.exp(sigma)
    s2t2 = s * s + th * th
    sth, cth = jnp.sin(th), jnp.cos(th)

    # ---- a = (e^s - 1)/s (theta-independent)
    a = jnp.where(
        sm_s,
        1.0 + sigma / 2.0 + sigma * sigma / 6.0 + sigma**3 / 24.0,
        (es - 1.0) / s,
    )

    # ---- b = int e^{su} sin(u th)/th du ; c = (a - int e^{su} cos(u th) du)/th^2
    b_gen = (th + es * (s * sth - th * cth)) / (th * s2t2)
    c_gen = (a - (es * (s * cth + th * sth) - s) / s2t2) / (th * th)
    # theta -> 0 (sigma general): b = (e^s(s-1)+1)/s^2 ; c = (e^s(s^2-2s+2)-2)/(2 s^3)
    b_t = (es * (s - 1.0) + 1.0) / (s * s)
    c_t = (es * (s * s - 2.0 * s + 2.0) - 2.0) / (2.0 * s**3)
    # sigma -> 0 (theta general): first order in sigma
    omc = 2.0 * jnp.square(jnp.sin(0.5 * th))  # 1 - cos, catastrophic-cancel-free
    b_s = omc / (th * th) + sigma * (sth - th * cth) / th**3
    c_s = (th - sth) / th**3 + sigma * (0.5 - (cth + th * sth - 1.0) / (th * th)) / (
        th * th
    )
    # both small: second-order Taylor
    t2 = theta * theta
    b_ts = 0.5 + sigma / 3.0 - t2 / 24.0 - sigma * t2 / 30.0
    c_ts = 1.0 / 6.0 + sigma / 8.0 - t2 / 120.0 - sigma * t2 / 144.0

    b = jnp.where(sm_s & sm_t, b_ts, jnp.where(sm_t, b_t, jnp.where(sm_s, b_s, b_gen)))
    c = jnp.where(sm_s & sm_t, c_ts, jnp.where(sm_t, c_t, jnp.where(sm_s, c_s, c_gen)))
    return a, b, c


def _W(sigma, phi):
    """(..., ), (..., 3) -> (..., 3, 3) closed-form W matrix."""
    theta = jnp.sqrt(jnp.maximum(jnp.sum(phi * phi, axis=-1), 1e-24))
    a, b, c = _W_coeffs(sigma, theta)
    px = so3.wedge(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), px.shape)
    return a[..., None, None] * eye + b[..., None, None] * px + c[..., None, None] * (
        px @ px
    )


def _inv3(M):
    """Closed-form batched 3x3 inverse (adjugate/det) — no LU (CLAUDE.md:
    XLA's batched small factorizations are slow on this backend)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = jnp.stack(
        [
            jnp.stack([A, -(b * i - c * h), b * f - c * e], axis=-1),
            jnp.stack([B, a * i - c * g, -(a * f - c * d)], axis=-1),
            jnp.stack([C, -(a * h - b * g), a * e - b * d], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


def exp(xi):
    """Exponential map: (..., 7) -> (..., 4, 4) [[e^sigma R, W rho], [0, 1]]."""
    xi = jnp.asarray(xi)
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    R = so3.exp(phi)
    t = jnp.einsum("...ij,...j->...i", _W(sigma, phi), rho)
    return _assemble(jnp.exp(sigma)[..., None, None] * R, t)


def log(S):
    """Logarithmic map: (..., 4, 4) -> (..., 7)."""
    S = jnp.asarray(S)
    sR, t = S[..., :3, :3], S[..., :3, 3]
    s = scale(S)
    sigma = jnp.log(s)
    R = sR / s[..., None, None]
    phi = so3.log(R)
    rho = jnp.einsum("...ij,...j->...i", _inv3(_W(sigma, phi)), t)
    return jnp.concatenate([rho, phi, sigma[..., None]], axis=-1)


def _assemble(sR, t):
    top = jnp.concatenate([sR, t[..., :, None]], axis=-1)
    bottom = jnp.zeros(sR.shape[:-2] + (1, 4), sR.dtype).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def scale(S):
    """Scale factor s = det(s*R)^(1/3)."""
    return jnp.cbrt(jnp.linalg.det(jnp.asarray(S)[..., :3, :3]))


def rot(S):
    """Unit rotation block R (scale divided out)."""
    S = jnp.asarray(S)
    return S[..., :3, :3] / scale(S)[..., None, None]


def trans(S):
    return jnp.asarray(S)[..., :3, 3]


def inv(S):
    S = jnp.asarray(S)
    sR, t = S[..., :3, :3], S[..., :3, 3]
    s2 = jnp.sum(sR[..., 0, :] * sR[..., 0, :], axis=-1)  # (s^2) row norm
    sRinv = jnp.swapaxes(sR, -1, -2) / s2[..., None, None]  # (1/s) R^T
    return _assemble(sRinv, -jnp.einsum("...ij,...j->...i", sRinv, t))


def mul(Sa, Sb):
    return Sa @ Sb


def act(S, p):
    """Similarity-transform 3D points: s R p + t."""
    S = jnp.asarray(S)
    return jnp.einsum("...ij,...j->...i", S[..., :3, :3], p) + S[..., :3, 3]


def adjoint(S):
    """(..., 4, 4) -> (..., 7, 7): [[sR, t^ R, -t], [0, R, 0], [0, 0, 1]]
    (for [rho, phi, sigma] tangent order): S exp(xi) S^-1 = exp(Ad(S) xi)."""
    S = jnp.asarray(S)
    sR, t = S[..., :3, :3], S[..., :3, 3]
    R = rot(S)
    tR = so3.wedge(t) @ R
    z33 = jnp.zeros_like(R)
    z31 = jnp.zeros(S.shape[:-2] + (3, 1), S.dtype)
    row0 = jnp.concatenate([sR, tR, -t[..., :, None]], axis=-1)
    row1 = jnp.concatenate([z33, R, z31], axis=-1)
    row2 = (
        jnp.zeros(S.shape[:-2] + (1, 7), S.dtype).at[..., 0, 6].set(1.0)
    )
    return jnp.concatenate([row0, row1, row2], axis=-2)


def _ad(xi):
    """Algebra adjoint: (..., 7) -> (..., 7, 7)
    [[sigma I + phi^, rho^, -rho], [0, phi^, 0], [0, 0, 0]]."""
    xi = jnp.asarray(xi)
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    A = so3.wedge(phi) + sigma[..., None, None] * jnp.eye(3, dtype=xi.dtype)
    rx = so3.wedge(rho)
    z33 = jnp.zeros_like(A)
    z = jnp.zeros(xi.shape[:-1] + (3, 1), xi.dtype)
    row0 = jnp.concatenate([A, rx, -rho[..., :, None]], axis=-1)
    row1 = jnp.concatenate([z33, so3.wedge(phi), z], axis=-1)
    row2 = jnp.zeros(xi.shape[:-1] + (1, 7), xi.dtype)
    return jnp.concatenate([row0, row1, row2], axis=-2)


_JL_TERMS = 26  # entire series; first dropped term ||ad||^27/28! < 1e-11 at ||ad|| = 4.5


def left_jacobian(xi):
    """Sim(3) left Jacobian J_l(xi) = sum_n ad(xi)^n / (n+1)!  (..., 7, 7).

    The series is entire (factorial convergence), so the fixed
    ``_JL_TERMS``-term Horner sum (26 terms: first dropped term is below
    1e-11 at ||ad|| = 4.5) is exact to f64 roundoff at any argument the
    solver sees; each term is one batched 7x7 matmul (matmul-friendly, no
    data-dependent loop)."""
    xi = jnp.asarray(xi)
    A = _ad(xi)
    eye = jnp.broadcast_to(jnp.eye(7, dtype=xi.dtype), A.shape)
    # Scaled Horner for sum_{n=0..N} A^n/(n+1)!:  H_N = I,
    # H_{k-1} = I + (A H_k)/(k+1)  =>  H_0 = I/1! + A/2! + A^2/3! + ...
    J = eye
    for n in range(_JL_TERMS, 0, -1):
        J = eye + (A @ J) / float(n + 1)
    return J


def inv_left_jacobian(xi):
    """Inverse Sim(3) left Jacobian, exact via block-triangular inversion.

    ad(xi) is block upper-triangular, so J_l = [[P, X, y], [0, Q, 0],
    [0, 0, 1]] with P = W(sigma, phi) (the SAME closed-form W as exp) and
    Q = J_so3(phi).  Then
      J_l^-1 = [[P^-1, -P^-1 X Q^-1, -P^-1 y], [0, Q^-1, 0], [0, 0, 1]]
    with P^-1 by 3x3 adjugate and Q^-1 the closed-form SO(3) inverse left
    Jacobian — no Bernoulli series (which would diverge past |ad| = 2 pi)
    and no batched LU."""
    xi = jnp.asarray(xi)
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    J = left_jacobian(xi)
    X, y = J[..., :3, 3:6], J[..., :3, 6]
    Pinv = _inv3(_W(sigma, phi))
    Qinv = so3.inv_left_jacobian(phi)
    upper = -Pinv @ X @ Qinv
    ncol = -jnp.einsum("...ij,...j->...i", Pinv, y)
    z33 = jnp.zeros_like(Pinv)
    z31 = jnp.zeros(xi.shape[:-1] + (3, 1), xi.dtype)
    row0 = jnp.concatenate([Pinv, upper, ncol[..., :, None]], axis=-1)
    row1 = jnp.concatenate([z33, Qinv, z31], axis=-1)
    row2 = jnp.zeros(xi.shape[:-1] + (1, 7), xi.dtype).at[..., 0, 6].set(1.0)
    return jnp.concatenate([row0, row1, row2], axis=-2)


def perturb(S, xi):
    """Left-multiplicative update exp(xi) @ S (solver convention, as se3)."""
    return exp(xi) @ S


def identity(dtype=jnp.float32, batch_shape=()):
    return jnp.broadcast_to(jnp.eye(4, dtype=dtype), batch_shape + (4, 4))


def normalize(S):
    """Re-orthonormalize the rotation block, preserving scale and
    translation (guards f32 drift over many compositions)."""
    S = jnp.asarray(S)
    s = scale(S)
    R = S[..., :3, :3] / s[..., None, None]
    u, _, vt = jnp.linalg.svd(R)
    det = jnp.linalg.det(u @ vt)
    u = u.at[..., :, -1].multiply(jnp.sign(det)[..., None])
    return _assemble(s[..., None, None] * (u @ vt), S[..., :3, 3])


def from_se3(T, s=1.0):
    """Embed an SE(3) transform (or batch) as Sim(3) with scale s."""
    T = jnp.asarray(T)
    s = jnp.asarray(s, T.dtype)
    return _assemble(s[..., None, None] * T[..., :3, :3], T[..., :3, 3])


def to_se3(S):
    """Project to SE(3) by dropping scale (rotation renormalized)."""
    S = jnp.asarray(S)
    top = jnp.concatenate([rot(S), S[..., :3, 3:4]], axis=-1)
    bottom = jnp.zeros(S.shape[:-2] + (1, 4), S.dtype).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)
