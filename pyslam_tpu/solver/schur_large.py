"""Venice-scale single-device bundle adjustment: component-major Schur path.

Why this exists: the accelerator the system was first built for padded
every small (6, 3) or (6, 6) block of a per-observation array to a large
memory tile, so at BAL-Venice scale (~1.7k cams, ~1M landmarks, ~5M
observations) the standard path (solver/schur.py) did not fit on one
device.  The H100 has no such padding: there the (M, 6, 6) f32 array is
about 0.67 GB of logical bytes, and whether this layer still earns its
place has not been measured.

This module stores every large per-element quantity COMPONENT-MAJOR —
W as (18, M), Hll as (9, L), gradients as (3, L) — flat vectors with zero
padding waste, and evaluates all block algebra (3x3 closed-form inverses,
W-products, SCHUR_JACOBI diagonal) as unrolled component arithmetic: pure
elementwise passes, no batched-small-matrix layouts anywhere.  Linearization streams over observation chunks under
``lax.scan`` so no (M, m, dof) Jacobian tensor is ever materialized.

Same LM semantics as solve_schur; host-side accept/reject loop.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.core import (
    FACTOR_KERNELS,
    FactorGraph,
    VariableBlock,
    register_closed_kernel,
    retract,
)
from ..solver import lm as _lm
from .linear import pcg_solve


def _ceil_to(x, m):
    return -(-x // m) * m


def _inv33_flat(h):
    """h: (9, L) component-major SPD blocks [h00 h01 h02 h10 .. h22] ->
    inverse in the same layout (adjugate / det, pure elementwise)."""
    a, b, c, d, e, f, g, hh, i = (h[k] for k in range(9))
    co00 = e * i - f * hh
    co01 = c * hh - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * hh - e * g
    co21 = b * g - a * hh
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    inv_det = 1.0 / det
    return jnp.stack(
        [co00, co01, co02, co10, co11, co12, co20, co21, co22]
    ) * inv_det[None]


def _sum_C(vals, bounds):
    """Per-camera sums of a camera-sorted per-observation vector via
    cumsum + boundary differences instead of XLA's segment_sum (chosen
    where scatters were slow; not compared on the H100).
    ``bounds``: (C+1,) start offsets into the sorted array.

    Precision note: the boundary difference subtracts two partial sums whose
    magnitude grows with the GLOBAL total, so f32 relative error on a
    per-camera sum scales like ulp(total)/segment_sum (~1e-4 at Venice
    scale — harmless: converged chi2 is bit-identical to the scatter
    path). Not suitable where exact per-segment summation gates a tight
    parity bound."""
    tot = jnp.concatenate([jnp.zeros(1, vals.dtype), jnp.cumsum(vals)])
    return tot[bounds[1:]] - tot[bounds[:-1]]


def _apply33_flat(h, x):
    """y_i = sum_j h[i,j] x_j with h (9, L), x (3, L)."""
    return jnp.stack(
        [
            h[0] * x[0] + h[1] * x[1] + h[2] * x[2],
            h[3] * x[0] + h[4] * x[1] + h[5] * x[2],
            h[6] * x[0] + h[7] * x[1] + h[8] * x[2],
        ]
    )


@partial(jax.jit, static_argnames=("kind", "loss", "n_chunks", "C", "L", "want_grad", "trails"))
def _linearize_stream(
    kind, loss, n_chunks, C, L, want_grad, trails, poses, lms, obs_data, ci, li, w_pad,
    cam_starts=None, lorder=None, lm_starts=None,
):
    """Streamed linearization over observation chunks.

    Returns (chi2, Hpp (C,6,6), g_p (C,6), Hll (9,L), g_l (3,L), W (18,Mp))
    — or just chi2 when want_grad=False.  Mp = padded observation count;
    padding rows carry w_pad = 0.

    Op-shape rules (bench/matvec_profile.py; see _mv_ops): the gradient
    pass batches the 27 camera-direction reductions of each chunk into ONE
    (27, chunk) cumsum, accumulates them in a flat (27, C) carry unpacked
    once after the scan, and EMITS the 9 landmark-direction rows per
    observation (alongside the 18 W rows) so the landmark reduction is a
    single post-scan batched (Mp, 9) segment_sum instead of 12 scatters
    per chunk (exact — see the precision note at the reduction site)."""
    Mp = ci.shape[0]
    chunk = Mp // n_chunks
    dtype = poses.dtype

    def chunk_args(k):
        sl = lambda x: jax.lax.dynamic_slice_in_dim(x, k * chunk, chunk, axis=0)
        od = {}
        trail_of = dict(trails)
        for kk, v in obs_data.items():
            trail = trail_of[kk]
            # stored component-major (prod(trail), Mp) — slice lanes, then
            # rebuild the (chunk, *trail) view the kernel expects
            c = jax.lax.dynamic_slice_in_dim(v, k * chunk, chunk, axis=-1)
            if trail == ():
                od[kk] = c[0]
            else:
                od[kk] = jnp.moveaxis(c, -1, 0).reshape((chunk,) + trail)
        return od, sl(ci), sl(li), sl(w_pad)

    if not want_grad:

        def body(carry, k):
            od, cck, llk, wk = chunk_args(k)
            r, _ = FACTOR_KERNELS[kind](od, poses[cck], lms[llk], compute_jacobians=False)
            return carry + jnp.sum(loss.loss(r) * wk[:, None]), 0.0

        chi2, _ = jax.lax.scan(body, jnp.zeros((), dtype), jnp.arange(n_chunks))
        return chi2

    # row order of the batched camera reduction: 6 gradient rows then the
    # 21 upper-triangle Hessian rows
    cam_pairs = [(i, j) for i in range(6) for j in range(i, 6)]
    # landmark rows: 3 gradient rows then 6 upper-triangle Hessian rows
    lm_pairs = [(i, j) for i in range(3) for j in range(i, 3)]

    def body(carry, k):
        chi2, cam_acc = carry
        od, cck, llk, wk = chunk_args(k)
        r, (Jc, Jl) = FACTOR_KERNELS[kind](od, poses[cck], lms[llk], compute_jacobians=True)
        w = loss.weight(r) * wk[:, None]
        chi2 = chi2 + jnp.sum(loss.loss(r) * wk[:, None])
        wr = w * r

        def col(J, i):  # (chunk, m) component i; residual dim summed below
            return J[:, :, i]

        # camera rows: ONE (27, chunk) batched cumsum + boundary diff per
        # chunk (the chunk is a contiguous camera range)
        rows = [jnp.sum(col(Jc, i) * wr, axis=1) for i in range(6)] + [
            jnp.sum(col(Jc, i) * w * col(Jc, j), axis=1) for i, j in cam_pairs
        ]
        stack = jnp.stack(rows)  # (27, chunk)
        bnd = jnp.clip(cam_starts - k * chunk, 0, chunk)
        tot = jnp.concatenate(
            [jnp.zeros((27, 1), dtype), jnp.cumsum(stack, axis=1)], axis=1
        )
        cam_acc = cam_acc + (tot[:, bnd[1:]] - tot[:, bnd[:-1]])

        # landmark + coupling rows, emitted per observation: 3 g_l, 6 Hll
        # (symmetric), 18 W
        out = jnp.stack(
            [jnp.sum(col(Jl, i) * wr, axis=1) for i in range(3)]
            + [jnp.sum(col(Jl, i) * w * col(Jl, j), axis=1) for i, j in lm_pairs]
            + [
                jnp.sum(col(Jc, i) * w * col(Jl, j), axis=1)
                for i in range(6)
                for j in range(3)
            ]
        )  # (27, chunk)
        return (chi2, cam_acc), out

    carry0 = (jnp.zeros((), dtype), jnp.zeros((27, C), dtype))
    (chi2, cam_acc), outs = jax.lax.scan(body, carry0, jnp.arange(n_chunks))
    R = jnp.moveaxis(outs, 1, 0).reshape(27, Mp)  # (n_chunks, 27, chunk) ->

    # unpack camera accumulators
    g_p = -cam_acc[:6].T  # (C, 6)
    Hpp = jnp.zeros((C, 6, 6), dtype)
    for k2, (i, j) in enumerate(cam_pairs):
        Hpp = Hpp.at[:, i, j].add(cam_acc[6 + k2])
        if j > i:
            Hpp = Hpp.at[:, j, i].add(cam_acc[6 + k2])

    # landmark reduction: ONE batched (Mp, 9) segment_sum.  NOT a cumsum:
    # per-landmark segments average ~5 observations, so an f32
    # boundary-difference carries ulp(GLOBAL total) error per segment —
    # at Venice scale this flips Hll diagonals negative (non-SPD blocks ->
    # every LM step rejected).  Camera segments are ~2700 obs, which is why
    # cumsum is safe in the camera direction.  One 9-wide scatter replaces
    # the 12-per-chunk scatters of the earlier layout.
    lred = jax.ops.segment_sum(R[:9].T, li, num_segments=L).T  # (9, L)
    g_l = -lred[:3]
    Hll = jnp.zeros((9, L), dtype)
    for k2, (i, j) in enumerate(lm_pairs):
        Hll = Hll.at[3 * i + j].set(lred[3 + k2])
        if j > i:
            Hll = Hll.at[3 * j + i].set(lred[3 + k2])

    W = R[9:]
    return chi2, Hpp, g_p, Hll, g_l, W


@dataclasses.dataclass
class LargeBA:
    """Padded device arrays + static config for the component-major path."""

    kind: str
    loss: object
    C: int
    L: int
    Mp: int
    n_chunks: int
    poses: jnp.ndarray
    lms: jnp.ndarray  # (L, 3)
    free_p: jnp.ndarray  # (C,)
    free_l: jnp.ndarray  # (L,)
    obs_data: dict
    trails: tuple  # static ((key, trailing_shape), ...)
    ci: jnp.ndarray
    li: jnp.ndarray
    w_pad: jnp.ndarray
    cam_starts: jnp.ndarray = None  # (C+1,) camera range bounds
    unary: tuple = ()
    M: int = 0  # real (unpadded) observation count
    # lazily-built co-observation pair tables for the dense-S direct solve
    # (build_dense_pairs); None until linear="dense" first needs them
    pairs: "DensePairs | None" = None
    # lazily-built same-cluster pair tables for the cluster block-Jacobi
    # preconditioner (build_cluster_pairs); keyed by cluster size
    cpairs: "DensePairs | None" = None
    cpairs_G: int = 0
    # dual-order layout: landmark-sort permutation of the (camera-sorted)
    # observation axis, so the S-matvec's landmark-direction reductions run
    # as cumsum + boundary diffs too (see _mv_ops)
    lorder: jnp.ndarray = None  # (Mp,) int32
    ci_l: jnp.ndarray = None  # (Mp,) camera index in landmark order
    lm_starts: jnp.ndarray = None  # (L+1,) landmark range bounds


def prepare_large_ba(
    graph: FactorGraph,
    n_chunks: int = 16,
    pose_name: str = "poses",
    lm_name: str = "landmarks",
) -> LargeBA:
    pb, lb = graph.blocks[pose_name], graph.blocks[lm_name]
    # this path's component-major storage AND its retract are
    # specialized to se3 x 3-dof landmarks ((18, M) W, _inv33) —
    # route_auto guards on dof, but direct callers get a named error
    if pb.kind != "se3" or lb.dof != 3:
        raise ValueError(
            f"{pose_name}/{lm_name} must be se3 poses + 3-dof landmarks "
            f"(got {pb.kind!r} / {lb.dof}-dof); use solve_schur / "
            "solve_auto for other manifolds"
        )
    (fb,) = [b for b in graph.batches if b.slots == (pose_name, lm_name)]
    unary = [b for b in graph.batches if b.slots == (pose_name,)]
    between = [b for b in graph.batches if b.slots == (pose_name, pose_name)]
    assert len(unary) + len(between) + 1 == len(graph.batches), (
        "schur_large supports one pose-landmark batch plus pose-unary and "
        "pose-pose (between) batches"
    )
    M = fb.n
    Mp = _ceil_to(M, n_chunks)
    pad = Mp - M
    # stable-sort observations by CAMERA: all camera-direction reductions
    # become cumsum + boundary differences (_sum_C); the landmark direction
    # keeps scatter-adds, which are collision-free at ~1M segments
    order = np.argsort(np.asarray(fb.indices[0]), kind="stable")

    def pad0(x):
        x = np.asarray(x)[order]
        return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)]) if pad else x

    obs_data, static_data, obs_trails = {}, {}, {}
    for k, v in fb.data.items():
        if hasattr(v, "ndim") and getattr(v, "ndim", 0) >= 1 and v.shape[0] == M:
            # store component-major: (prod(trailing), Mp), like W
            arr = np.asarray(pad0(v))
            obs_data[k] = jnp.asarray(arr.reshape(Mp, -1).T.copy())
            obs_trails[k] = arr.shape[1:]
        else:
            static_data[k] = v
    if static_data:
        # small non-factor-axis values (camera pytree, unbatched sqrt_info)
        # become jaxpr constants via a content-hash-keyed kernel closure
        # (graph.core.register_closed_kernel) — the jitted stream caches
        # compiled code on this name, so the key must identify the DATA
        kname = register_closed_kernel(fb.kind, static_data)
    else:
        kname = fb.kind

    ci_sorted = np.concatenate([
        np.asarray(fb.indices[0], np.int32)[order],
        np.full(pad, pb.n - 1, np.int32),
    ]) if pad else np.asarray(fb.indices[0], np.int32)[order]
    li_sorted = pad0(np.asarray(fb.indices[1], np.int32))
    # landmark-sort permutation of the camera-sorted axis (padding rows have
    # li = 0 and zero weight: they land inside landmark 0's range and
    # contribute exact zeros to its sums)
    lorder = np.argsort(li_sorted, kind="stable").astype(np.int32)
    return LargeBA(
        M=M,
        kind=kname,
        loss=fb.loss,
        C=pb.n,
        L=lb.n,
        Mp=Mp,
        n_chunks=n_chunks,
        poses=jnp.asarray(pb.values),
        lms=jnp.asarray(lb.values),
        free_p=jnp.asarray((~np.asarray(pb.const_mask)).astype(np.asarray(pb.values).dtype)),
        free_l=jnp.asarray((~np.asarray(lb.const_mask)).astype(np.asarray(pb.values).dtype)),
        obs_data=obs_data,
        trails=tuple(sorted(obs_trails.items())),
        ci=jnp.asarray(ci_sorted),
        li=jnp.asarray(li_sorted),
        w_pad=jnp.asarray(pad0(np.asarray(fb.weight))),
        cam_starts=jnp.asarray(
            np.searchsorted(ci_sorted, np.arange(pb.n + 1)).astype(np.int32)
        ),
        lorder=jnp.asarray(lorder),
        ci_l=jnp.asarray(ci_sorted[lorder]),
        lm_starts=jnp.asarray(
            np.searchsorted(li_sorted[lorder], np.arange(lb.n + 1)).astype(np.int32)
        ),
        unary=tuple(
            (u.kind, jnp.asarray(u.indices[0]), dict(u.data), u.loss, u.weight)
            for u in unary
        )
        + tuple(
            # pose-pose between factors: tuple of index arrays marks binary
            (b.kind, (jnp.asarray(b.indices[0]), jnp.asarray(b.indices[1])),
             dict(b.data), b.loss, b.weight)
            for b in between
        ),
    )


def _mv_ops(C, L, Hpp, Hinv, W, ci, li, cam_starts, PP=None, pi=None, pj=None,
            W_l=None, ci_l=None, lm_starts=None):
    """Shared component-major operator closures.  ``PP/pi/pj`` carry the
    (possibly zero-length) pose-pose coupling blocks of between factors.

    Dual-order mode (``W_l/ci_l/lm_starts`` given): ``W_l`` is W's columns
    permuted into LANDMARK-sorted order, so the landmark-direction reduction
    in ``W_T_dot_cam`` is a cumsum + boundary diff like every
    camera-direction one instead of a scatter.

    Op-shape rules, chosen with bench/matvec_profile.py at Mp=5M on the
    accelerator the system was first built for, where each multi-M XLA op
    had a large flat cost, so the win was minimizing op COUNT, not bytes:
    * ONE (Mp, k) padded gather replaces k row gathers;
    * k cumsums are batched as ONE (k, Mp) cumsum(axis=1).
    These rules have not been re-measured on the H100."""

    def W_T_dot_cam(xb):
        """(C, 6) -> (3, L): accumulate W^T x per landmark."""
        if W_l is not None:
            xg = xb[ci_l]  # (Mp, 6): one padded gather
            accs = jnp.stack([
                sum(W_l[3 * i + j] * xg[:, i] for i in range(6))
                for j in range(3)
            ])  # (3, Mp)
            tot = jnp.concatenate(
                [jnp.zeros((3, 1), accs.dtype), jnp.cumsum(accs, axis=1)],
                axis=1,
            )
            return tot[:, lm_starts[1:]] - tot[:, lm_starts[:-1]]
        xg = xb[ci]
        return jnp.stack([
            jax.ops.segment_sum(
                sum(W[3 * i + j] * xg[:, i] for i in range(6)),
                li, num_segments=L,
            )
            for j in range(3)
        ])

    def W_dot_lm(t3):
        tg = t3.T[li]  # (Mp, 3): one padded gather
        accs = jnp.stack([
            W[3 * i] * tg[:, 0] + W[3 * i + 1] * tg[:, 1]
            + W[3 * i + 2] * tg[:, 2]
            for i in range(6)
        ])  # (6, Mp)
        tot = jnp.concatenate(
            [jnp.zeros((6, 1), accs.dtype), jnp.cumsum(accs, axis=1)], axis=1
        )
        return (tot[:, cam_starts[1:]] - tot[:, cam_starts[:-1]]).T

    def matvec(x):
        xb = x.reshape(C, 6)
        y = jnp.einsum("cij,cj->ci", Hpp, xb)
        if PP is not None and PP.shape[0]:
            y = y + jax.ops.segment_sum(
                jnp.einsum("eij,ej->ei", PP, xb[pj]), pi, num_segments=C
            )
            y = y + jax.ops.segment_sum(
                jnp.einsum("eij,ei->ej", PP, xb[pi]), pj, num_segments=C
            )
        t1 = W_T_dot_cam(xb)
        t2 = _apply33_flat(Hinv, t1)
        y = y - W_dot_lm(t2)
        return y.reshape(-1)

    return W_T_dot_cam, W_dot_lm, matvec


@partial(jax.jit, static_argnames=("method", "C", "L", "dual"))
def _schur_prepare(method, C, L, Hpp, g_p, Hll, g_l, W, PP, free_p, free_l, ci, li, pi, pj, cam_starts, lam, lorder=None, dual=False):
    """Mask constants, damp, invert Hll, reduced gradient, SCHUR_JACOBI.
    ``dual=True`` additionally emits W_l — the masked W re-gathered into
    landmark-sorted column order (18 one-dimensional row gathers rather
    than the column gather W[:, lorder], which failed at multi-M scale on
    the accelerator the system was first built for)."""
    dtype = Hpp.dtype
    eye6 = jnp.eye(6, dtype=dtype)
    Hpp = Hpp * free_p[:, None, None] + (1.0 - free_p)[:, None, None] * eye6
    g_p = g_p * free_p[:, None]
    PP = PP * free_p[pi][:, None, None] * free_p[pj][:, None, None]
    dead = ((Hll[0] + Hll[4] + Hll[8]) == 0.0).astype(dtype)
    live = free_l * (1.0 - dead)
    Hll = Hll * live[None] + (1.0 - live)[None] * jnp.asarray(
        [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0], dtype
    )[:, None]
    g_l = g_l * live[None]
    fobs = free_p[ci] * live[li]
    W = W * fobs[None]

    if method == "lm":
        d6 = jnp.maximum(jnp.einsum("nii->ni", Hpp), 1e-12)
        Hpp = Hpp + lam * d6[:, :, None] * eye6
        for k in (0, 4, 8):
            Hll = Hll.at[k].set(Hll[k] * (1.0 + lam))
    Hinv = _inv33_flat(Hll)

    _, W_dot_lm, _ = _mv_ops(C, L, Hpp, Hinv, W, ci, li, cam_starts)
    g_red = g_p - W_dot_lm(_apply33_flat(Hinv, g_l))

    # SCHUR_JACOBI diagonal: batched op shapes (see _mv_ops op-shape rules) —
    # ONE (Mp, 9) padded gather for Hinv per obs (was 9 row gathers) and ONE
    # (21, Mp) cumsum for the 21 upper-triangle reductions (was 21 cumsums)
    Hg = Hinv.T[li]  # (Mp, 9)
    vrows = []
    pairs = []
    for i in range(6):
        u = [
            Hg[:, 3 * j] * W[3 * i] + Hg[:, 3 * j + 1] * W[3 * i + 1]
            + Hg[:, 3 * j + 2] * W[3 * i + 2]
            for j in range(3)
        ]
        for i2 in range(i, 6):
            vrows.append(W[3 * i2] * u[0] + W[3 * i2 + 1] * u[1] + W[3 * i2 + 2] * u[2])
            pairs.append((i, i2))
    vstack = jnp.stack(vrows)  # (21, Mp)
    tot = jnp.concatenate(
        [jnp.zeros((21, 1), vstack.dtype), jnp.cumsum(vstack, axis=1)], axis=1
    )
    accs = tot[:, cam_starts[1:]] - tot[:, cam_starts[:-1]]  # (21, C)
    D = Hpp
    for k, (i, i2) in enumerate(pairs):
        D = D.at[:, i, i2].add(-accs[k])
        if i2 > i:
            D = D.at[:, i2, i].add(-accs[k])
    from .bcsr import sym_block_inv

    Dinv = sym_block_inv(D)
    # one (Mp, 18) padded gather instead of 18 row gathers
    W_l = W.T[lorder].T if dual else W
    # D is returned alongside Dinv: it is the exact block diagonal of the
    # reduced camera system S, which the dense-S direct solve reuses
    return Hpp, Hinv, W, PP, g_l, g_red, Dinv, live, W_l, D


@partial(jax.jit, static_argnames=("C", "L", "S"))
def _pcg_segment(C, L, S, Hpp, Hinv, W, PP, ci, li, pi, pj, cam_starts, Dinv, state,
                 W_l=None, ci_l=None, lm_starts=None):
    """Advance PCG by up to S iterations (the CG loop driven from the host
    in segments, which bounds each program's runtime; used for large CG
    budgets)."""
    _, _, matvec = _mv_ops(C, L, Hpp, Hinv, W, ci, li, cam_starts, PP, pi, pj,
                           W_l, ci_l, lm_starts)

    def precond(r):
        return jnp.einsum("cij,cj->ci", Dinv, r.reshape(C, 6)).reshape(-1)

    def body(state):
        x, r, z, p, rz, it = state
        Ap = matvec(p)
        pAp = jnp.vdot(p, Ap)
        # Breakdown guard: on exact mid-segment convergence rz -> 0 and the
        # alpha/beta divisions would NaN the state — the host tolerance check
        # then never fires and the step gets rejected AT the solution.
        # Freeze the state instead (alpha = beta = 0 keeps x, r, p fixed).
        ok = (rz > 0.0) & (pAp > 0.0)
        alpha = jnp.where(ok, rz / jnp.where(ok, pAp, 1.0), 0.0)
        x = x + alpha * p
        r = jnp.where(ok, r - alpha * Ap, r)
        z = precond(r)
        rz_new = jnp.where(ok, jnp.vdot(r, z), rz)
        beta = jnp.where(ok, rz_new / jnp.where(ok, rz, 1.0), 0.0)
        p = jnp.where(ok, z + beta * p, p)
        return x, r, z, p, rz_new, it + 1

    def cond(state):
        return state[5] < S

    x, r, z, p, rz, it = jax.lax.while_loop(cond, body, state)
    return (x, r, z, p, rz, jnp.zeros_like(it)), jnp.linalg.norm(r)


@partial(jax.jit, static_argnames=("C", "L"))
def _pcg_init(C, L, Hpp, Hinv, W, PP, ci, li, pi, pj, cam_starts, Dinv, b):
    r0 = b  # x0 = 0
    z0 = jnp.einsum("cij,cj->ci", Dinv, r0.reshape(C, 6)).reshape(-1)
    x0 = jnp.zeros_like(b)
    return (x0, r0, z0, z0, jnp.vdot(r0, z0), jnp.zeros((), jnp.int32)), jnp.linalg.norm(r0)


@partial(jax.jit, static_argnames=("C", "L"))
def _backsub_retract(C, L, Hpp, Hinv, W, ci, li, cam_starts, g_l, live, free_p, poses, lms, dx_p_flat,
                     W_l=None, ci_l=None, lm_starts=None):
    W_T_dot_cam, _, _ = _mv_ops(C, L, Hpp, Hinv, W, ci, li, cam_starts,
                                W_l=W_l, ci_l=ci_l, lm_starts=lm_starts)
    # (couplings not needed: back-substitution only uses W and Hll^-1)
    dx_p = dx_p_flat.reshape(C, 6) * free_p[:, None]
    dx_l = _apply33_flat(Hinv, g_l - W_T_dot_cam(dx_p)) * live[None]
    new_poses = retract("se3", poses, dx_p)
    new_lms = lms + dx_l.T
    dx_norm = jnp.sqrt(jnp.sum(dx_p**2) + jnp.sum(dx_l**2))
    return new_poses, new_lms, dx_norm


@dataclasses.dataclass
class DensePairs:
    """Co-observation pair tables for the dense-S direct solve.

    One row per unordered observation pair (a, b), a != b, sharing a
    landmark, oriented so camera(a) <= camera(b).  ``q`` is the flat
    upper-triangle bucket cam_a * C + cam_b; ``w`` zeroes padding rows.
    Host-built once per observation pattern (like the plan itself)."""

    P: int  # padded pair count (multiple of n_pair_chunks)
    n_pair_chunks: int
    pair_a: jnp.ndarray  # (P,) int32 index into the camera-sorted Mp axis
    pair_b: jnp.ndarray  # (P,) int32
    pair_q: jnp.ndarray  # (P,) int32 bucket = cam_a * C + cam_b
    pair_w: jnp.ndarray  # (P,) 1.0 real / 0.0 padding


def build_dense_pairs(plan: LargeBA, n_pair_chunks: int = 4) -> DensePairs:
    """Enumerate co-observation pairs of ``plan``'s graph on the host.

    Venice scale (~4.65M obs, ~5 obs/landmark) yields ~10M pairs in a few
    seconds of vectorized numpy — one-time per observation pattern.  The
    reduced camera system S then assembles on device as
    S = D - sym(sum_pairs T_a W_b^T) with T = W.Hll^-1 (see
    _dense_S_from_parts); D (the a == b terms) comes from _schur_prepare's
    exact SCHUR_JACOBI diagonal."""
    from .schur_sparse import _coobservation_pairs

    M = plan.M or int(plan.Mp)
    ci = np.asarray(plan.ci)[:M]
    li = np.asarray(plan.li)[:M]
    pa, pb, _ = _coobservation_pairs(ci, li, plan.L)
    keep = pa < pb  # one row per unordered pair; symmetrization restores (b, a)
    pa, pb = pa[keep].astype(np.int64), pb[keep].astype(np.int64)
    i, j = ci[pa].astype(np.int64), ci[pb].astype(np.int64)
    swap = i > j
    pa, pb = np.where(swap, pb, pa), np.where(swap, pa, pb)
    q = (np.minimum(i, j) * plan.C + np.maximum(i, j)).astype(np.int32)
    P0 = len(pa)
    P = _ceil_to(max(P0, 1), n_pair_chunks)
    pad = P - P0
    w = np.ones(P, np.float32)
    if pad:
        pa = np.concatenate([pa, np.zeros(pad, np.int64)])
        pb = np.concatenate([pb, np.zeros(pad, np.int64)])
        q = np.concatenate([q, np.zeros(pad, np.int32)])
        w[P0:] = 0.0
    return DensePairs(
        P=P,
        n_pair_chunks=n_pair_chunks,
        pair_a=jnp.asarray(pa.astype(np.int32)),
        pair_b=jnp.asarray(pb.astype(np.int32)),
        pair_q=jnp.asarray(q),
        pair_w=jnp.asarray(w),
    )


def build_cluster_pairs(plan: LargeBA, cluster: int, n_pair_chunks: int = 4) -> DensePairs:
    """Same-cluster subset of the co-observation pairs for the cluster
    block-Jacobi preconditioner: pairs (a, b) with cam(a)//cluster ==
    cam(b)//cluster, bucketed by (cluster_id, local_a, local_b) so one
    segment_sum assembles all (6*cluster, 6*cluster) diagonal blocks of S.
    ``pair_q`` here is q = cid * cluster^2 + la * cluster + lb."""
    from .schur_sparse import _coobservation_pairs

    M = plan.M or int(plan.Mp)
    ci = np.asarray(plan.ci)[:M]
    li = np.asarray(plan.li)[:M]
    pa, pb, _ = _coobservation_pairs(ci, li, plan.L)
    keep = pa < pb
    pa, pb = pa[keep].astype(np.int64), pb[keep].astype(np.int64)
    i, j = ci[pa], ci[pb]
    same = (i // cluster) == (j // cluster)
    pa, pb, i, j = pa[same], pb[same], i[same], j[same]
    swap = i > j
    pa, pb = np.where(swap, pb, pa), np.where(swap, pa, pb)
    ii, jj = np.minimum(i, j), np.maximum(i, j)
    q = (
        (ii // cluster) * cluster * cluster
        + (ii % cluster) * cluster
        + (jj % cluster)
    ).astype(np.int32)
    P0 = len(pa)
    P = _ceil_to(max(P0, 1), n_pair_chunks)
    pad = P - P0
    w = np.ones(P, np.float32)
    if pad:
        pa = np.concatenate([pa, np.zeros(pad, np.int64)])
        pb = np.concatenate([pb, np.zeros(pad, np.int64)])
        q = np.concatenate([q, np.zeros(pad, np.int32)])
        w[P0:] = 0.0
    return DensePairs(
        P=P,
        n_pair_chunks=n_pair_chunks,
        pair_a=jnp.asarray(pa.astype(np.int32)),
        pair_b=jnp.asarray(pb.astype(np.int32)),
        pair_q=jnp.asarray(q),
        pair_w=jnp.asarray(w),
    )


def _T_lane_major(W, Hinv, li):
    """Row-major (Mp, 18) copies of W and T = W·Hll^-1 — the shared input
    of every pair-product assembly (pair gathers must be row gathers).
    T[m, 3i+k] = sum_j W[3i+j, m] * Hinv[li[m]][j, k] (lane arithmetic)."""
    Wr = W.T  # (Mp, 18)
    Hg = Hinv.T[li]  # (Mp, 9) padded gather
    Tr = jnp.stack(
        [
            Wr[:, 3 * i] * Hg[:, k] + Wr[:, 3 * i + 1] * Hg[:, 3 + k]
            + Wr[:, 3 * i + 2] * Hg[:, 6 + k]
            for i in range(6)
            for k in range(3)
        ],
        axis=1,
    )  # (Mp, 18)
    return Wr, Tr


def _pair_products(Wr, Tr, n_pair_chunks, n_buckets,
                   pair_a, pair_b, pair_q, pair_w):
    """Accumulate the 36 block entries T_a W_b^T of every co-observation
    pair into ``pair_q`` buckets: (n_buckets, 36) via one exact
    segment_sum per pair chunk (cumsum boundary-diffs are NOT
    precision-safe at a handful of pairs per bucket — same reasoning as
    the landmark reduction in _linearize_stream).  Shared by the dense-S
    assembly (buckets = C^2 camera pairs) and the cluster block-Jacobi
    preconditioner (buckets = cluster-local pairs)."""
    dtype = Wr.dtype
    P = pair_a.shape[0]
    Pc = P // n_pair_chunks
    acc = jnp.zeros((n_buckets, 36), dtype)
    # unrolled host loop (not lax.scan): avoids double-buffering the
    # bucket carry, and n_pair_chunks is small
    for k in range(n_pair_chunks):
        sl = lambda x: jax.lax.dynamic_slice_in_dim(x, k * Pc, Pc, axis=0)
        pa, pb, q, w = sl(pair_a), sl(pair_b), sl(pair_q), sl(pair_w)
        Tg = Tr[pa]  # (Pc, 18) padded gather
        Wg = Wr[pb]
        blocks = jnp.stack(
            [
                (
                    Tg[:, 3 * i] * Wg[:, 3 * j]
                    + Tg[:, 3 * i + 1] * Wg[:, 3 * j + 1]
                    + Tg[:, 3 * i + 2] * Wg[:, 3 * j + 2]
                )
                * w
                for i in range(6)
                for j in range(6)
            ],
            axis=1,
        )  # (Pc, 36)
        acc = acc + jax.ops.segment_sum(blocks, q, num_segments=n_buckets)
    return acc


def _cluster_precond_factors(C, G, n_pair_chunks, D, PP, pi, pj, W, Hinv, li,
                             pair_a, pair_b, pair_q, pair_w):
    """Cholesky factors of the (6G, 6G) cluster-diagonal blocks of S.

    Same lane-major pair assembly as _dense_S_from_parts (shared
    _pair_products helper), restricted to same-cluster pairs:
    K = ceil(C/G) blocks.  Returns (Lc (K, 6G, 6G), s (K, 6G)) with
    Jacobi equilibration scales s (the f32 Cholesky at 6G ~ a few
    hundred needs the diagonal scaled to 1, same reasoning as the
    dense-S solve).  Cameras past C in the padded last cluster get unit
    diagonal (decoupled; _cluster_apply zero-pads their r-components)."""
    dtype = W.dtype
    K = -(-C // G)
    Cp = K * G

    Wr, Tr = _T_lane_major(W, Hinv, li)
    acc = -_pair_products(Wr, Tr, n_pair_chunks, K * G * G,
                          pair_a, pair_b, pair_q, pair_w)
    # fold D (diag, half weight pre-sym: symmetrization doubles the
    # diagonal bucket) and same-cluster PP couplings
    cam = jnp.arange(Cp, dtype=jnp.int32)
    diag_ids = (cam // G) * G * G + (cam % G) * G + (cam % G)
    Dp = jnp.concatenate(
        [D.reshape(C, 36), jnp.tile(jnp.eye(6, dtype=dtype).reshape(1, 36), (Cp - C, 1))]
    ) if Cp > C else D.reshape(C, 36)
    acc = acc.at[diag_ids].add(0.5 * Dp)
    if PP is not None and PP.shape[0]:
        same = (pi // G) == (pj // G)
        wpp = same.astype(dtype)[:, None]
        qpp = (pi // G) * G * G + (pi % G) * G + (pj % G)
        acc = acc.at[qpp].add(PP.reshape(-1, 36) * wpp)

    # (K*G*G, 36) -> (K, 6G, 6G) then symmetrize
    rows = [acc[:, 6 * r : 6 * r + 6].reshape(K, G, G, 6) for r in range(6)]
    # rows[r][k, a, b, c] = S[k, 6a + r, 6b + c]
    S = jnp.stack(rows, axis=3)  # (K, G, G, 6, 6) with [k, a, b, r, c]
    S = jnp.transpose(S, (0, 1, 3, 2, 4)).reshape(K, 6 * G, 6 * G)
    S = S + jnp.swapaxes(S, 1, 2)
    d = jnp.diagonal(S, axis1=1, axis2=2)
    s = jax.lax.rsqrt(jnp.maximum(d, jnp.asarray(1e-30, dtype)))
    Ss = S * s[:, :, None] * s[:, None, :]
    Lc = jnp.linalg.cholesky(Ss)
    return Lc, s


def _cluster_apply(Lc, s, r, C, G):
    """M^-1 r with the cluster Cholesky factors: batched triangular solves."""
    K = Lc.shape[0]
    rp = jnp.concatenate([r.reshape(C, 6), jnp.zeros((K * G - C, 6), r.dtype)])
    x = rp.reshape(K, 6 * G) * s
    y = jax.scipy.linalg.solve_triangular(Lc, x[:, :, None], lower=True)
    z = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(Lc, 1, 2), y, lower=False
    )[:, :, 0]
    return (z * s).reshape(K * G, 6)[:C].reshape(-1)


def _dense_S_from_parts(C, n_pair_chunks, D, PP, pi, pj, W, Hinv, li,
                        pair_a, pair_b, pair_q, pair_w):
    """Dense reduced camera system S (6C, 6C) from component-major parts.

    Everything stays 2-D to dodge the 21x (8,128)-tile padding of (N,6,6)
    arrays at multi-M scale: per-observation T = W.Hll^-1 and W are
    materialized ROW-major (Mp, 18); each pair-chunk does two (Pc, 18)
    padded gathers, forms the 36 block entries T_a W_b^T as lanes, and one
    exact (Pc, 36) segment_sum accumulates into a (C^2, 36) bucket array
    (per-bucket segments average only a handful of pairs, so the cumsum
    boundary-diff trick is NOT precision-safe here — same reasoning as the
    landmark reduction in _linearize_stream).  The block diagonal D and the
    pose-pose couplings PP are folded into the buckets pre-symmetrization
    (D at half weight: sym doubles the diagonal bucket)."""
    Wr, Tr = _T_lane_major(W, Hinv, li)
    acc = -_pair_products(Wr, Tr, n_pair_chunks, C * C,
                          pair_a, pair_b, pair_q, pair_w)
    diag_ids = jnp.arange(C, dtype=jnp.int32) * (C + 1)
    acc = acc.at[diag_ids].add(0.5 * D.reshape(C, 36))
    if PP is not None and PP.shape[0]:
        acc = acc.at[pi * C + pj].add(PP.reshape(-1, 36))

    # (C^2, 36) -> (6C, 6C): six slice-reshapes sidestep the 4-D
    # (C, C, 6, 6) transpose whose (6, 6) minor tiles would pad 21x
    rows = [acc[:, 6 * r : 6 * r + 6].reshape(C, 6 * C) for r in range(6)]
    S_pre = jnp.stack(rows, axis=1).reshape(6 * C, 6 * C)
    return S_pre + S_pre.T


@partial(jax.jit, static_argnames=("method", "C", "L", "n_pair_chunks"))
def _stale_factor(
    method, C, L, n_pair_chunks,
    Hpp, g_p, Hll, g_l, W, PP, free_p, free_l, ci, li, pi, pj,
    cam_starts, lam, lorder,
    pair_a, pair_b, pair_q, pair_w,
):
    """Equilibrated Cholesky factor of the CURRENT reduced camera system S
    for use as a STALE preconditioner on later iterations: assembly + the
    10k-dof factorization are expensive at Venice scale, but the factor
    then solves S x = r in two triangular solves — so reusing it across
    k LM iterations turns 20 SCHUR_JACOBI CG iterations into ~2-4.
    Returns (Lc, s).

    Cost note: the refresh solve pays _schur_prepare twice (once here,
    once inside the fused PCG program); folding the factor build into the
    fused solve would save it if this path is ever made a default."""
    _Hpp_d, Hinv, W_m, PP_m, _g_l_m, _g_red, _Dinv, _live, _W_l, D = _schur_prepare(
        method, C, L, Hpp, g_p, Hll, g_l, W, PP, free_p, free_l, ci, li, pi, pj,
        cam_starts, lam, lorder=lorder, dual=False,
    )
    S = _dense_S_from_parts(
        C, n_pair_chunks, D, PP_m, pi, pj, W_m, Hinv, li,
        pair_a, pair_b, pair_q, pair_w,
    )
    d = jnp.diagonal(S)
    s = jax.lax.rsqrt(jnp.maximum(d, jnp.asarray(1e-30, S.dtype)))
    Ss = S * s[:, None] * s[None, :]
    Lc = jnp.linalg.cholesky(Ss)
    return Lc, s


@partial(jax.jit, static_argnames=("method", "C", "L", "n_pair_chunks", "dual"))
def _dense_solve_fused(
    method, C, L, n_pair_chunks, dual,
    Hpp, g_p, Hll, g_l, W, PP, poses, lms, free_p, free_l, ci, li, pi, pj,
    cam_starts, lam, lorder, ci_l, lm_starts,
    pair_a, pair_b, pair_q, pair_w,
):
    """Whole DIRECT Schur solve as ONE program: prepare + dense-S assembly
    + Jacobi-equilibrated f32 Cholesky + two triangular solves + back-sub.

    Exact alternative to the PCG path when the camera count is small enough
    for a dense (6C, 6C) reduced system (Venice: C = 1700 -> 416 MB f32 —
    one dense factorization replaces ~20 latency-bound CG matvecs).
    A non-SPD S in f32 yields NaNs; the host LM loop treats a NaN trial
    cost as a rejection, and the resulting lambda increase restores
    SPD-ness — the same recovery path PCG breakdown uses."""
    Hpp_d, Hinv, W_m, PP_m, g_l_m, g_red, _Dinv, live, W_l, D = _schur_prepare(
        method, C, L, Hpp, g_p, Hll, g_l, W, PP, free_p, free_l, ci, li, pi, pj,
        cam_starts, lam, lorder=lorder, dual=dual,
    )
    if not dual:
        W_l = ci_l = lm_starts = None
    S = _dense_S_from_parts(
        C, n_pair_chunks, D, PP_m, pi, pj, W_m, Hinv, li,
        pair_a, pair_b, pair_q, pair_w,
    )
    # Jacobi equilibration: f32 Cholesky at 6C ~ 10k needs the diagonal
    # scaled to 1 (BAL Hessians span ~8 orders of magnitude across
    # rotation/translation/intrinsics columns)
    d = jnp.diagonal(S)
    s = jax.lax.rsqrt(jnp.maximum(d, jnp.asarray(1e-30, S.dtype)))
    Ss = S * s[:, None] * s[None, :]
    Lc = jnp.linalg.cholesky(Ss)
    b = g_red.reshape(-1) * s
    y = jax.scipy.linalg.solve_triangular(Lc, b, lower=True)
    x = jax.scipy.linalg.solve_triangular(Lc.T, y, lower=False)
    dx = x * s
    return _backsub_retract(
        C, L, Hpp_d, Hinv, W_m, ci, li, cam_starts, g_l_m, live, free_p,
        poses, lms, dx, W_l, ci_l, lm_starts,
    )


@partial(jax.jit, static_argnames=("method", "C", "L", "max_iters", "dual",
                                   "cluster", "n_cpair_chunks"))
def _schur_solve_fused(
    method, C, L, max_iters, dual, rtol,
    Hpp, g_p, Hll, g_l, W, PP, poses, lms, free_p, free_l, ci, li, pi, pj,
    cam_starts, lam, lorder, ci_l, lm_starts,
    cluster=0, n_cpair_chunks=0,
    cpair_a=None, cpair_b=None, cpair_q=None, cpair_w=None,
    stale_L=None, stale_s=None,
):
    """Whole Schur solve (prepare + tolerance-checked PCG + back-sub) as ONE
    program: fusing removes the ~7 host<->device round trips per LM
    iteration that the segmented path pays.  The segmented path
    (_pcg_segment) remains for large CG budgets.

    ``cluster`` > 0 selects the camera-cluster block-Jacobi preconditioner
    (dense (6G, 6G) cluster-diagonal blocks of S from same-cluster
    co-observation pairs, batched Cholesky) instead of the per-camera
    SCHUR_JACOBI diagonal."""
    Hpp_d, Hinv, W_m, PP_m, g_l_m, g_red, Dinv, live, W_l, D = _schur_prepare(
        method, C, L, Hpp, g_p, Hll, g_l, W, PP, free_p, free_l, ci, li, pi, pj,
        cam_starts, lam, lorder=lorder, dual=dual,
    )
    if not dual:
        W_l = ci_l = lm_starts = None
    _, _, matvec = _mv_ops(C, L, Hpp_d, Hinv, W_m, ci, li, cam_starts, PP_m,
                           pi, pj, W_l, ci_l, lm_starts)

    if stale_L is not None:

        def precond(r):
            x = r * stale_s
            y = jax.scipy.linalg.solve_triangular(stale_L, x, lower=True)
            z = jax.scipy.linalg.solve_triangular(stale_L.T, y, lower=False)
            return z * stale_s
    elif cluster:
        Lc, sc = _cluster_precond_factors(
            C, cluster, n_cpair_chunks, D, PP_m, pi, pj, W_m, Hinv, li,
            cpair_a, cpair_b, cpair_q, cpair_w,
        )

        def precond(r):
            return _cluster_apply(Lc, sc, r, C, cluster)
    else:

        def precond(r):
            return jnp.einsum("cij,cj->ci", Dinv, r.reshape(C, 6)).reshape(-1)

    b = g_red.reshape(-1)
    z0 = precond(b)
    tol2 = (rtol * jnp.linalg.norm(b)) ** 2

    def body(state):
        x, r, z, p, rz, rn2, it = state
        Ap = matvec(p)
        pAp = jnp.vdot(p, Ap)
        # breakdown guard: see _pcg_segment
        ok = (rz > 0.0) & (pAp > 0.0)
        alpha = jnp.where(ok, rz / jnp.where(ok, pAp, 1.0), 0.0)
        x = x + alpha * p
        r = jnp.where(ok, r - alpha * Ap, r)
        z = precond(r)
        rz_new = jnp.where(ok, jnp.vdot(r, z), rz)
        beta = jnp.where(ok, rz_new / jnp.where(ok, rz, 1.0), 0.0)
        p = jnp.where(ok, z + beta * p, p)
        return x, r, z, p, rz_new, jnp.vdot(r, r), it + 1

    def cond(state):
        return (state[6] < max_iters) & (state[5] > tol2)

    state0 = (jnp.zeros_like(b), b, z0, z0, jnp.vdot(b, z0), jnp.vdot(b, b),
              jnp.zeros((), jnp.int32))
    x = jax.lax.while_loop(cond, body, state0)[0]
    return _backsub_retract(
        C, L, Hpp_d, Hinv, W_m, ci, li, cam_starts, g_l_m, live, free_p,
        poses, lms, x, W_l, ci_l, lm_starts,
    )


def _schur_solve_large(
    method, pcg_rtol, pcg_max_iters, C, L,
    Hpp, g_p, Hll, g_l, W, PP, poses, lms, free_p, free_l, ci, li, pi, pj,
    cam_starts, lam,
    pcg_segment: int = 25,
    lorder=None, ci_l=None, lm_starts=None, dual=False,
    pairs: "DensePairs | None" = None,
    cluster: int = 0,
    cpairs: "DensePairs | None" = None,
    stale=None,
):
    """Host-orchestrated Schur solve: prepare / segmented PCG / back-sub.
    Solves with <= 60 CG iterations run as one fused program
    (_schur_solve_fused); larger budgets fall back to host-driven segments
    to keep single-program runtime bounded.  ``pairs`` selects the dense-S
    direct path (_dense_solve_fused) instead of PCG; ``cluster``/``cpairs``
    select the cluster block-Jacobi PCG preconditioner and ``stale`` a
    prebuilt (Lc, s) stale-S factor preconditioner (fused path only)."""
    if pairs is not None:
        return _dense_solve_fused(
            method, C, L, pairs.n_pair_chunks, dual,
            Hpp, g_p, Hll, g_l, W, PP, poses, lms, free_p, free_l,
            ci, li, pi, pj, cam_starts, lam, lorder, ci_l, lm_starts,
            pairs.pair_a, pairs.pair_b, pairs.pair_q, pairs.pair_w,
        )
    if pcg_max_iters <= 60:
        ck = {}
        if stale is not None:
            ck = dict(stale_L=stale[0], stale_s=stale[1])
        elif cluster and cpairs is not None:
            ck = dict(
                cluster=cluster, n_cpair_chunks=cpairs.n_pair_chunks,
                cpair_a=cpairs.pair_a, cpair_b=cpairs.pair_b,
                cpair_q=cpairs.pair_q, cpair_w=cpairs.pair_w,
            )
        return _schur_solve_fused(
            method, C, L, pcg_max_iters, dual, pcg_rtol,
            Hpp, g_p, Hll, g_l, W, PP, poses, lms, free_p, free_l,
            ci, li, pi, pj, cam_starts, lam, lorder, ci_l, lm_starts,
            **ck,
        )
    Hpp_d, Hinv, W_m, PP_m, g_l_m, g_red, Dinv, live, W_l, _D = _schur_prepare(
        method, C, L, Hpp, g_p, Hll, g_l, W, PP, free_p, free_l, ci, li, pi, pj,
        cam_starts, lam, lorder=lorder, dual=dual,
    )
    if not dual:
        W_l = ci_l = lm_starts = None
    state, r0 = _pcg_init(
        C, L, Hpp_d, Hinv, W_m, PP_m, ci, li, pi, pj, cam_starts, Dinv,
        g_red.reshape(-1),
    )
    tol = pcg_rtol * float(r0)
    done = 0
    while done < pcg_max_iters:
        S = min(pcg_segment, pcg_max_iters - done)
        state, rnorm = _pcg_segment(
            C, L, S, Hpp_d, Hinv, W_m, PP_m, ci, li, pi, pj, cam_starts, Dinv, state,
            W_l, ci_l, lm_starts,
        )
        done += S
        if float(rnorm) <= tol:
            break
    dx_p_flat = state[0]
    return _backsub_retract(
        C, L, Hpp_d, Hinv, W_m, ci, li, cam_starts, g_l_m, live, free_p, poses, lms, dx_p_flat,
        W_l, ci_l, lm_starts,
    )


def _unary_contrib(unary, poses, C, want_grad):
    """Replicated-factor contributions (chi2, Hpp (C,6,6), g_p (C,6),
    couplings) — pose priors AND pose-pose between factors, evaluated
    unchunked (both are C-sized, tiny next to the observation set).
    ``couplings`` is [(PP (E,6,6), pi, pj)] off-diagonal blocks for the
    S matvec (empty without between factors)."""
    dtype = poses.dtype
    chi2 = jnp.zeros((), dtype)
    Hpp = jnp.zeros((C, 6, 6), dtype)
    g_p = jnp.zeros((C, 6), dtype)
    couplings = []
    for ukind, uidx, udata, uloss, uw in unary:
        if isinstance(uidx, tuple):
            pi, pj = uidx
            r, jac = FACTOR_KERNELS[ukind](
                udata, poses[pi], poses[pj], compute_jacobians=want_grad
            )
            chi2 = chi2 + jnp.sum(uloss.loss(r) * uw[:, None])
            if want_grad:
                Ja, Jb = jac
                w = uloss.weight(r) * uw[:, None]
                Hpp = Hpp + jax.ops.segment_sum(
                    jnp.einsum("fmi,fm,fmj->fij", Ja, w, Ja), pi, num_segments=C
                )
                Hpp = Hpp + jax.ops.segment_sum(
                    jnp.einsum("fmi,fm,fmj->fij", Jb, w, Jb), pj, num_segments=C
                )
                g_p = g_p - jax.ops.segment_sum(
                    jnp.einsum("fmi,fm->fi", Ja, w * r), pi, num_segments=C
                )
                g_p = g_p - jax.ops.segment_sum(
                    jnp.einsum("fmi,fm->fi", Jb, w * r), pj, num_segments=C
                )
                couplings.append(
                    (jnp.einsum("fmi,fm,fmj->fij", Ja, w, Jb), pi, pj)
                )
            continue
        r, jac = FACTOR_KERNELS[ukind](udata, poses[uidx], compute_jacobians=want_grad)
        chi2 = chi2 + jnp.sum(uloss.loss(r) * uw[:, None])
        if want_grad:
            (J,) = jac
            w = uloss.weight(r) * uw[:, None]
            Hpp = Hpp + jax.ops.segment_sum(
                jnp.einsum("fmi,fm,fmj->fij", J, w, J), uidx, num_segments=C
            )
            g_p = g_p - jax.ops.segment_sum(
                jnp.einsum("fmi,fm->fi", J, w * r), uidx, num_segments=C
            )
    return chi2, Hpp, g_p, couplings


def solve_schur_large(
    graph: FactorGraph,
    options: _lm.Options = _lm.Options(),
    n_chunks: int = 16,
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    pcg_rtol: float = 1e-4,
    pcg_max_iters: int = 30,
    speculative: bool = True,
    dual_order: bool = True,
    plan: "LargeBA | None" = None,
    linear: str = "pcg",
    n_pair_chunks: int = 4,
    precond: str = "jacobi",
    cluster_size: int = 64,
    stale_refresh: int = 3,
):
    """Venice-scale single-device Schur LM.  Default CG budget: 30 its @
    1e-4 gives chi2 within 0.001% of 100 its @ 1e-6 at Venice scale.
    Returns
    (solved_graph, final_chi2, cost_history).

    ``plan``: a prebuilt ``prepare_large_ba(graph, n_chunks)`` result to
    reuse across solves of the same graph STRUCTURE (sort orders, padding,
    and device uploads depend only on the observation pattern; the plan
    carries the variable VALUES of the graph it was built from, so pass a
    plan built from this same graph).  Building it is one-time per graph,
    like compilation.

    ``dual_order=True`` (default) keeps a second, landmark-sorted copy of
    the coupling block W so BOTH reduction directions of the S-matvec run
    as cumsums instead of scatters (see _mv_ops); costs one 18-row gather
    per LM iteration plus W-sized memory.

    ``linear="dense"`` replaces PCG with an exact direct solve of the
    reduced camera system: dense (6C, 6C) S assembled from host-enumerated
    co-observation pairs, equilibrated f32 Cholesky
    (_dense_solve_fused).  Feasible when C is small enough for a dense S
    (C = 1700 -> 416 MB); the pair tables are built lazily on the plan.

    ``precond="cluster"`` replaces the per-camera SCHUR_JACOBI diagonal
    with camera-cluster block-Jacobi: dense (6G, 6G) cluster-diagonal
    blocks of S (G = ``cluster_size`` consecutive cameras) assembled from
    same-cluster co-observation pairs each iteration, factored with one
    batched Cholesky, applied via batched triangular solves.  Exact on the
    cluster diagonal, so CG needs fewer iterations on camera graphs with
    strong local coupling; pair tables cached on the plan.

    ``precond="stale"`` is the stale-S factor preconditioner: every
    ``stale_refresh`` solves, the CURRENT reduced system S is assembled
    from the co-observation pair tables and Cholesky-factored;
    intermediate iterations precondition CG with that stale factor (two
    triangular solves per CG iteration), which
    collapses the CG iteration count while the factor stays close to the
    fresh system.

    ``speculative=True`` (default) drives the speculative-linearization
    host loop: each iteration pays exactly one gradient linearization (at
    the trial point) instead of a gradient pass at the current point plus a
    cost-only pass at the trial — the trial pass IS the next iteration's
    linearization when the step accepts.  Same iterate sequence; one fewer
    full streaming sweep of the observation set per iteration."""
    lb = plan if plan is not None else prepare_large_ba(
        graph, n_chunks, pose_name, lm_name
    )
    if linear not in ("pcg", "dense"):
        raise ValueError(f"linear must be 'pcg' or 'dense', got {linear!r}")
    if precond not in ("jacobi", "cluster", "stale"):
        raise ValueError(
            f"precond must be 'jacobi', 'cluster' or 'stale', got {precond!r}"
        )
    if linear == "pcg" and precond in ("cluster", "stale") and pcg_max_iters > 60:
        # validate BEFORE the (expensive) pair-table builds below
        raise ValueError(
            f"precond={precond!r} runs in the fused PCG path only "
            "(pcg_max_iters <= 60)"
        )
    pairs = None
    if linear == "dense" or (linear == "pcg" and precond == "stale"):
        # pair tables are part of the observation-pattern plan: lazily
        # build them once and keep them on the plan object so repeated
        # solves (and the prebuilt-plan bench protocol) reuse them
        if lb.pairs is None or lb.pairs.n_pair_chunks != n_pair_chunks:
            lb.pairs = build_dense_pairs(lb, n_pair_chunks)
        pairs = lb.pairs if linear == "dense" else None
    cluster = 0
    cpairs = None
    if linear == "pcg" and precond == "cluster":
        cluster = cluster_size
        if (
            lb.cpairs is None
            or lb.cpairs_G != cluster
            or lb.cpairs.n_pair_chunks != n_pair_chunks
        ):
            lb.cpairs = build_cluster_pairs(lb, cluster, n_pair_chunks)
            lb.cpairs_G = cluster
        cpairs = lb.cpairs
    # stale-S preconditioner state: the factored (Lc, s) of a recent
    # iteration's S, rebuilt every ``stale_refresh`` solves (host closure)
    _stale = {"fac": None, "age": 0}
    use_stale = linear == "pcg" and precond == "stale"
    dtype = np.asarray(lb.poses).dtype

    from .host_loop import host_lm_loop, host_lm_loop_speculative

    def linearize(state):
        poses, lms = state
        chi2, Hpp, g_p, Hll, g_l, W = _linearize_stream(
            lb.kind, lb.loss, lb.n_chunks, lb.C, lb.L, True, lb.trails,
            poses, lms, lb.obs_data, lb.ci, lb.li, lb.w_pad, lb.cam_starts,
            lb.lorder, lb.lm_starts,
        )
        PP = jnp.zeros((0, 6, 6), dtype)
        pi = jnp.zeros(0, jnp.int32)
        pj = jnp.zeros(0, jnp.int32)
        if lb.unary:
            c_u, H_u, g_u, coup = _unary_contrib(lb.unary, poses, lb.C, True)
            chi2 = chi2 + c_u
            Hpp = Hpp + H_u
            g_p = g_p + g_u
            if coup:
                PP = jnp.concatenate([c[0] for c in coup])
                pi = jnp.concatenate([c[1] for c in coup])
                pj = jnp.concatenate([c[2] for c in coup])
        return chi2, Hpp, g_p, Hll, g_l, W, PP, pi, pj

    def solve_from(state, lin, lam):
        poses, lms = state
        _chi2, Hpp, g_p, Hll, g_l, W, PP, pi, pj = lin
        stale = None
        if use_stale:
            if _stale["fac"] is None or _stale["age"] >= stale_refresh:
                _stale["fac"] = _stale_factor(
                    options.method, lb.C, lb.L, lb.pairs.n_pair_chunks,
                    Hpp, g_p, Hll, g_l, W, PP, lb.free_p, lb.free_l,
                    lb.ci, lb.li, pi, pj, lb.cam_starts,
                    jnp.asarray(lam, dtype), lb.lorder,
                    lb.pairs.pair_a, lb.pairs.pair_b, lb.pairs.pair_q,
                    lb.pairs.pair_w,
                )
                _stale["age"] = 0
            _stale["age"] += 1
            stale = _stale["fac"]
        new_poses, new_lms, dx_norm = _schur_solve_large(
            options.method, pcg_rtol, pcg_max_iters, lb.C, lb.L,
            Hpp, g_p, Hll, g_l, W, PP, poses, lms, lb.free_p, lb.free_l,
            lb.ci, lb.li, pi, pj, lb.cam_starts, jnp.asarray(lam, dtype),
            lorder=lb.lorder, ci_l=lb.ci_l, lm_starts=lb.lm_starts,
            dual=dual_order, pairs=pairs, cluster=cluster, cpairs=cpairs,
            stale=stale,
        )
        return (new_poses, new_lms), dx_norm

    if speculative:
        (poses, lms), history, _info = host_lm_loop_speculative(
            linearize, solve_from, (lb.poses, lb.lms), options
        )
    else:

        def lm_step(state, lam):
            lin = linearize(state)
            trial, dx_norm = solve_from(state, lin, lam)
            chi2 = lin[0]
            del lin
            new_poses, new_lms = trial
            cost_new = _linearize_stream(
                lb.kind, lb.loss, lb.n_chunks, lb.C, lb.L, False, lb.trails,
                new_poses, new_lms, lb.obs_data, lb.ci, lb.li, lb.w_pad,
                lb.cam_starts,
            )
            if lb.unary:
                cost_new = cost_new + _unary_contrib(
                    lb.unary, new_poses, lb.C, False
                )[0]
            return trial, chi2, cost_new, dx_norm

        (poses, lms), history, _info = host_lm_loop(
            lm_step, (lb.poses, lb.lms), options
        )

    pb = graph.blocks[pose_name]
    lb_blk = graph.blocks[lm_name]
    new_blocks = dict(graph.blocks)
    new_blocks[pose_name] = VariableBlock(pb.kind, poses, pb.const_mask)
    new_blocks[lm_name] = VariableBlock(lb_blk.kind, lms, lb_blk.const_mask)
    solved = FactorGraph(new_blocks, graph.batches)
    return solved, history[-1], history


__all__ = [
    "solve_schur_large",
    "prepare_large_ba",
    "build_dense_pairs",
    "build_cluster_pairs",
    "DensePairs",
]
