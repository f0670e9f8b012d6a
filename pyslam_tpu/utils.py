"""Numeric utilities — parity with ``pyslam/utils.py`` (SURVEY.md §1 L1):
``invsqrt``, ``stackmul``, ``bilinear_interpolate``; device-side additions;
and the persistent compile-cache placement shared by every entry point.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax.numpy as jnp

CHECKOUT_DIR = Path(__file__).resolve().parent.parent


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets nothing, so the cache can be placed from outside.  Otherwise the
    cache lives in ``<checkout>/.jax_cache`` (git-ignored), a fixed path
    derived from this file's location so that every process of one checkout
    shares it.
    """
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(CHECKOUT_DIR / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def invsqrt(A):
    """Matrix inverse square root of an SPD matrix (or batch): Sigma -> stiffness.

    The reference uses this to turn measurement covariances into residual
    'stiffness' weights (pyslam/utils.py per SURVEY.md §2.1).  Computed via a
    symmetric eigendecomposition; broadcasts over leading batch dims.
    """
    A = jnp.asarray(A)
    if A.ndim == 0:
        return 1.0 / jnp.sqrt(A)
    w, V = jnp.linalg.eigh(A)
    w = jnp.clip(w, 1e-30, None)
    return jnp.einsum("...ik,...k,...jk->...ij", V, 1.0 / jnp.sqrt(w), V)


def stackmul(A, B):
    """Batched matrix multiply over leading dims (reference: pyslam/utils.py).

    XLA lowers this to one batched matmul.
    """
    return jnp.matmul(A, B)


def bilinear_interpolate(im, u, v, compute_gradients: bool = False):
    """Bilinearly sample image ``im`` (H, W) or (H, W, C) at float pixel
    coordinates ``u`` (x / col) and ``v`` (y / row), both (...,).

    Returns values (and, if ``compute_gradients``, the image-space gradients
    d/du and d/dv — needed by the photometric residual's analytic Jacobian,
    reference pyslam/residuals.py PhotometricResidualSE3 per SURVEY.md §2.1).

    Out-of-bounds samples clamp to the border (validity is handled by the
    caller's masks, keeping this kernel branch-free for XLA).
    """
    im = jnp.asarray(im)
    u = jnp.asarray(u)
    v = jnp.asarray(v)
    H, W = im.shape[0], im.shape[1]

    u0 = jnp.clip(jnp.floor(u), 0, W - 2)
    v0 = jnp.clip(jnp.floor(v), 0, H - 2)
    au = jnp.clip(u - u0, 0.0, 1.0)
    av = jnp.clip(v - v0, 0.0, 1.0)
    u0 = u0.astype(jnp.int32)
    v0 = v0.astype(jnp.int32)

    if im.ndim == 3:
        au = au[..., None]
        av = av[..., None]

    f00 = im[v0, u0]
    f01 = im[v0, u0 + 1]
    f10 = im[v0 + 1, u0]
    f11 = im[v0 + 1, u0 + 1]

    top = f00 + au * (f01 - f00)
    bot = f10 + au * (f11 - f10)
    val = top + av * (bot - top)

    if not compute_gradients:
        return val

    grad_u = (f01 - f00) + av * ((f11 - f10) - (f01 - f00))
    grad_v = bot - top
    return val, grad_u, grad_v


def pack_corners(im):
    """(H, W) image -> (H*W, 4) per-pixel corner tuples
    [f(v,u), f(v,u+1), f(v+1,u), f(v+1,u+1)] with edge padding.

    Bilinear sampling via ONE gather from this packed layout replaces the
    four separate corner gathers of ``bilinear_interpolate``: the corner
    gathers were the dominant cost of the dense photometric kernel at VGA.
    Packing itself is elementwise (shifted slices), one pass per image."""
    r = jnp.pad(im, ((0, 1), (0, 1)), mode="edge")
    return jnp.stack(
        [r[:-1, :-1], r[:-1, 1:], r[1:, :-1], r[1:, 1:]], axis=-1
    ).reshape(-1, 4)


def bilinear_interpolate_packed(im4, H, W, u, v, compute_gradients: bool = False):
    """``bilinear_interpolate`` from a ``pack_corners`` layout: one gather.

    im4: (H*W, 4); u, v: (...,) float pixel coords.  Identical arithmetic
    (and therefore bitwise-identical results) to the 4-gather version."""
    u = jnp.asarray(u)
    v = jnp.asarray(v)
    u0 = jnp.clip(jnp.floor(u), 0, W - 2)
    v0 = jnp.clip(jnp.floor(v), 0, H - 2)
    au = jnp.clip(u - u0, 0.0, 1.0)
    av = jnp.clip(v - v0, 0.0, 1.0)
    idx = (v0.astype(jnp.int32) * W + u0.astype(jnp.int32)).reshape(-1)
    quad = im4[idx].reshape(u.shape + (4,))
    f00, f01, f10, f11 = (quad[..., k] for k in range(4))

    top = f00 + au * (f01 - f00)
    bot = f10 + au * (f11 - f10)
    val = top + av * (bot - top)
    if not compute_gradients:
        return val
    grad_u = (f01 - f00) + av * ((f11 - f10) - (f01 - f00))
    grad_v = bot - top
    return val, grad_u, grad_v


def kahan_sum(x, chunk: int = 4096):
    """Compensated (Neumaier) summation of a flat array in its own dtype.

    XLA's reduction is already pairwise/tree (error ~ O(log n) ulp); this
    sequential-over-chunks two-sum drives the error to O(1) ulp of the
    total, for accumulations where f32 tree error would matter (hundreds of
    millions of similarly-signed terms).  Nothing on the current hot paths
    uses this: plain f32 chi2 evaluation has held the f64 gates at
    sphere2500 / M3500 / Venice scales.  It exists for future >1e8-term
    reductions.
    """
    import jax

    x = x.reshape(-1)
    n = x.shape[0]
    pad = (-n) % chunk
    if pad:
        x = jnp.concatenate([x, jnp.zeros(pad, x.dtype)])
    parts = jnp.sum(x.reshape(-1, chunk), axis=1)  # tree-sum within chunks

    def body(carry, p):
        s, c = carry
        t = s + p
        # Neumaier: pick the larger-magnitude operand's rounding error
        c = c + jnp.where(jnp.abs(s) >= jnp.abs(p), (s - t) + p, (p - t) + s)
        return (t, c), None

    (s, c), _ = jax.lax.scan(body, (jnp.zeros((), x.dtype), jnp.zeros((), x.dtype)), parts)
    return s + c
