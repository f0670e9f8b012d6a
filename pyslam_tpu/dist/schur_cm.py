"""Component-major landmark-sharded Schur BA — the multi-chip form of
solver/schur_large.py (BASELINE.json config #5 at full Venice scale).

Combines the two designs:

  * per-observation / per-landmark data stored COMPONENT-MAJOR (flat
    vectors; no (N, d, d) tile padding — solver/schur_large.py rationale),
  * landmarks + observations sharded per chip (dist/schur_reduce.py
    layout), camera poses replicated, ONE ``psum`` of a (C, 6) array per
    S-matvec,
  * within each chip's slab observations are camera-sorted, so every
    camera-direction reduction is a local cumsum + boundary difference
    instead of a scatter, followed by the psum;
    the landmark direction keeps chip-local scatter-adds (collision-free).

Linearization streams over observation chunks under ``lax.scan``, so no
(M, m, dof) Jacobian tensor materializes per chip.

CROSSOVER: on the accelerator the system was first built for, this path
beat the block-major sharded path (dist/schur_reduce.py) above ~250k
observations per device and lost below, where the ~15 flat ops per matvec
are each launch-latency bound.  route_auto encodes that crossover
(cm_obs_crossover) alongside the memory gate (slabs whose block layout
does not fit the device).  Neither has been measured on the H100.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..graph.core import (
    FACTOR_KERNELS,
    FactorGraph,
    VariableBlock,
    register_closed_kernel,
    retract,
)
from ..solver import lm as _lm
from ..solver.linear import pcg_solve
from ..solver.schur_large import _apply33_flat, _inv33_flat, _sum_C
from .partitioner import Partition, partition_landmarks


def _ceil_to(x, m):
    return -(-x // m) * m


@dataclasses.dataclass
class ShardedCM:
    """Host-side plan + device arrays (component-major, sharded)."""

    mesh: Mesh
    axis: str
    kind: str
    loss: object
    n_dev: int
    C: int
    L: int
    Lb: int
    Mb: int
    n_chunks: int
    poses: jnp.ndarray  # (C, 4, 4) replicated
    free_p: jnp.ndarray  # (C,)
    lm_slab: jnp.ndarray  # (n*Lb, 3) sharded
    free_l: jnp.ndarray  # (n*Lb,)
    obs_data: dict  # name -> (flatdim, n*Mb) sharded on axis 1
    trails: tuple
    ci: jnp.ndarray  # (n*Mb,)
    li: jnp.ndarray  # (n*Mb,) local slot in owner's slab
    w_pad: jnp.ndarray  # (n*Mb,)
    cam_bounds: jnp.ndarray  # (n, C+1)
    lm_perm: np.ndarray  # original landmark id -> slab position
    unary: tuple = ()  # replicated pose-unary / pose-pose batches


def shard_ba_cm(
    graph: FactorGraph,
    mesh: Mesh,
    n_chunks: int = 8,
    axis: str = "l",
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    partition: Partition | None = None,
) -> ShardedCM:
    n = mesh.shape[axis]
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
    C, L = pb.n, lb.n
    (fb,) = [b for b in graph.batches if b.slots == (pose_name, lm_name)]
    unary_p = [b for b in graph.batches if b.slots == (pose_name,)]
    between_p = [b for b in graph.batches if b.slots == (pose_name, pose_name)]
    assert 1 + len(unary_p) + len(between_p) == len(graph.batches), (
        "schur_cm supports one pose-landmark batch plus pose-unary and "
        "pose-pose batches"
    )

    if partition is None:
        partition = partition_landmarks(None, None, L, n_parts=n)
    part = partition.part

    # landmark slabs (contiguous per device)
    order_l = np.argsort(part, kind="stable")
    counts = np.bincount(part, minlength=n)
    Lb = int(max(1, counts.max()))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(L) - starts[part[order_l]]
    slot_of = np.empty(L, np.int64)
    slot_of[order_l] = part[order_l] * Lb + rank

    lm_vals = np.zeros((n * Lb, 3), np.asarray(lb.values).dtype)
    # safe z!=0 fill for padded slots (see schur_reduce.shard_ba): a
    # zero-point through a projection kernel is inf, and 0 * inf = NaN
    lm_vals[:, -1] = 1.0
    lm_vals[slot_of] = np.asarray(lb.values)
    free_l = np.zeros(n * Lb)
    free_l[slot_of] = (~np.asarray(lb.const_mask)).astype(np.float64)

    # observations: sort by (owner, camera); pad per device to a chunk multiple
    cam_idx = np.asarray(fb.indices[0])
    pt_idx = np.asarray(fb.indices[1])
    owner = part[pt_idx]
    obs_order = np.lexsort((cam_idx, owner))
    ocounts = np.bincount(owner, minlength=n)
    Mb = _ceil_to(int(max(1, ocounts.max())), n_chunks)
    ostarts = np.concatenate([[0], np.cumsum(ocounts)[:-1]])
    orank = np.arange(len(obs_order)) - ostarts[owner[obs_order]]
    dest = owner[obs_order] * Mb + orank

    def pad_obs(arr, fill=0.0):
        arr = np.asarray(arr)
        out = np.full((n * Mb,) + arr.shape[1:], fill, arr.dtype)
        out[dest] = arr[obs_order]
        return out

    ci_pad = pad_obs(cam_idx, fill=C - 1).astype(np.int32)
    li_pad = pad_obs(slot_of[pt_idx] % Lb).astype(np.int32)
    w_pad = pad_obs(np.asarray(fb.weight))
    cam_bounds = np.stack(
        [np.searchsorted(ci_pad[d * Mb : (d + 1) * Mb], np.arange(C + 1)) for d in range(n)]
    ).astype(np.int32)

    obs_data, obs_trails = {}, {}
    static_data = {}
    M = len(cam_idx)
    for k, v in fb.data.items():
        if hasattr(v, "ndim") and getattr(v, "ndim", 0) >= 1 and v.shape[0] == M:
            arr = pad_obs(v)
            obs_data[k] = jnp.asarray(arr.reshape(n * Mb, -1).T.copy())
            obs_trails[k] = arr.shape[1:]
        else:
            static_data[k] = v
    if static_data:
        # content-hash-keyed closure kernel (see graph.core.register_closed_kernel)
        kname = register_closed_kernel(fb.kind, static_data)
    else:
        kname = fb.kind

    return ShardedCM(
        mesh=mesh, axis=axis, kind=kname, loss=fb.loss, n_dev=n, C=C, L=L,
        Lb=Lb, Mb=Mb, n_chunks=n_chunks,
        poses=jnp.asarray(pb.values),
        free_p=jnp.asarray((~np.asarray(pb.const_mask)).astype(np.asarray(pb.values).dtype)),
        lm_slab=jnp.asarray(lm_vals),
        free_l=jnp.asarray(free_l),
        obs_data=obs_data,
        trails=tuple(sorted(obs_trails.items())),
        ci=jnp.asarray(ci_pad),
        li=jnp.asarray(li_pad),
        w_pad=jnp.asarray(w_pad),
        cam_bounds=jnp.asarray(cam_bounds),
        lm_perm=slot_of,
        unary=tuple(
            (u.kind, jnp.asarray(u.indices[0]), dict(u.data), u.loss, u.weight)
            for u in unary_p
        )
        + tuple(
            (b.kind, (jnp.asarray(b.indices[0]), jnp.asarray(b.indices[1])),
             dict(b.data), b.loss, b.weight)
            for b in between_p
        ),
    )


def make_cm_step(sb: ShardedCM, options: _lm.Options, pcg_rtol=1e-4, pcg_max_iters=30):
    """One sharded component-major Schur LM iteration under shard_map."""
    axis = sb.axis
    C, Lb, Mb, n_chunks = sb.C, sb.Lb, sb.Mb, sb.n_chunks
    kind, loss = sb.kind, sb.loss
    free_p = sb.free_p
    trails = sb.trails
    mesh = sb.mesh
    chunk = Mb // n_chunks
    unary = sb.unary

    def _eval_rep(poses, ukind, uidx, udata, want_jac):
        if isinstance(uidx, tuple):  # pose-pose between factor
            return FACTOR_KERNELS[ukind](
                udata, poses[uidx[0]], poses[uidx[1]], compute_jacobians=want_jac
            )
        return FACTOR_KERNELS[ukind](udata, poses[uidx], compute_jacobians=want_jac)

    def _chi2_rep(poses):
        total = jnp.zeros((), poses.dtype)
        for ukind, uidx, udata, uloss, uw in unary:
            r, _ = _eval_rep(poses, ukind, uidx, udata, False)
            total = total + jnp.sum(uloss.loss(r) * uw[:, None])
        return total

    def _rep_contrib(poses, dtype):
        """Replicated Hpp/g_p contributions + pose-pose couplings (see
        dist/schur_reduce.py — identical semantics)."""
        Hpp = jnp.zeros((C, 6, 6), dtype)
        g_p = jnp.zeros((C, 6), dtype)
        couplings = []
        for ukind, uidx, udata, uloss, uw in unary:
            r, jacs = _eval_rep(poses, ukind, uidx, udata, True)
            w = uloss.weight(r) * uw[:, None]
            if isinstance(uidx, tuple):
                Ja, Jb = jacs
                pi, pj = uidx
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
            else:
                (J,) = jacs
                Hpp = Hpp + jax.ops.segment_sum(
                    jnp.einsum("fmi,fm,fmj->fij", J, w, J), uidx, num_segments=C
                )
                g_p = g_p - jax.ops.segment_sum(
                    jnp.einsum("fmi,fm->fi", J, w * r), uidx, num_segments=C
                )
        return Hpp, g_p, couplings

    def chunk_args(od, ci, li, w, k):
        sl = lambda x: jax.lax.dynamic_slice_in_dim(x, k * chunk, chunk, axis=0)
        out = {}
        trail_of = dict(trails)
        for kk, v in od.items():
            c = jax.lax.dynamic_slice_in_dim(v, k * chunk, chunk, axis=-1)
            trail = trail_of[kk]
            out[kk] = c[0] if trail == () else jnp.moveaxis(c, -1, 0).reshape((chunk,) + trail)
        return out, sl(ci), sl(li), sl(w)

    def linearize(poses, lms, od, ci, li, w_pad, bounds, want_grad):
        dtype = poses.dtype

        if not want_grad:
            def body(carry, k):
                odk, cck, llk, wk = chunk_args(od, ci, li, w_pad, k)
                r, _ = FACTOR_KERNELS[kind](odk, poses[cck], lms[llk], compute_jacobians=False)
                return carry + jnp.sum(loss.loss(r) * wk[:, None]), 0.0

            chi2, _ = jax.lax.scan(body, jnp.zeros((), dtype), jnp.arange(n_chunks))
            return chi2

        # batched op shapes per solver/schur_large._linearize_stream: one
        # (27, chunk) camera-direction cumsum per chunk into a flat (27, C)
        # carry; 27 landmark/coupling rows emitted per observation, with the
        # 9 landmark-direction rows reduced by ONE post-scan (Mb, 9)
        # segment_sum (exact — per-landmark segments are too short for
        # boundary-diff precision; see schur_large's reduction-site note)
        cam_pairs = [(i, j) for i in range(6) for j in range(i, 6)]
        lm_pairs = [(i, j) for i in range(3) for j in range(i, 3)]

        def body(carry, k):
            chi2, cam_acc = carry
            odk, cck, llk, wk = chunk_args(od, ci, li, w_pad, k)
            r, (Jc, Jl) = FACTOR_KERNELS[kind](odk, poses[cck], lms[llk], compute_jacobians=True)
            w = loss.weight(r) * wk[:, None]
            chi2 = chi2 + jnp.sum(loss.loss(r) * wk[:, None])
            wr = w * r
            rows = [jnp.sum(Jc[:, :, i] * wr, axis=1) for i in range(6)] + [
                jnp.sum(Jc[:, :, i] * w * Jc[:, :, j], axis=1) for i, j in cam_pairs
            ]
            stack = jnp.stack(rows)  # (27, chunk)
            bnd = jnp.clip(bounds - k * chunk, 0, chunk)
            tot = jnp.concatenate(
                [jnp.zeros((27, 1), dtype), jnp.cumsum(stack, axis=1)], axis=1
            )
            cam_acc = cam_acc + (tot[:, bnd[1:]] - tot[:, bnd[:-1]])
            out = jnp.stack(
                [jnp.sum(Jl[:, :, i] * wr, axis=1) for i in range(3)]
                + [jnp.sum(Jl[:, :, i] * w * Jl[:, :, j], axis=1) for i, j in lm_pairs]
                + [
                    jnp.sum(Jc[:, :, i] * w * Jl[:, :, j], axis=1)
                    for i in range(6) for j in range(3)
                ]
            )  # (27, chunk)
            return (chi2, cam_acc), out

        carry0 = (jnp.zeros((), dtype), jnp.zeros((27, C), dtype))
        (chi2, cam_acc), outs = jax.lax.scan(body, carry0, jnp.arange(n_chunks))
        R = jnp.moveaxis(outs, 1, 0).reshape(27, Mb)

        g_p = -cam_acc[:6].T
        Hpp = jnp.zeros((C, 6, 6), dtype)
        for k2, (i, j) in enumerate(cam_pairs):
            Hpp = Hpp.at[:, i, j].add(cam_acc[6 + k2])
            if j > i:
                Hpp = Hpp.at[:, j, i].add(cam_acc[6 + k2])

        lred = jax.ops.segment_sum(R[:9].T, li, num_segments=Lb).T  # (9, Lb)
        g_l = -lred[:3]
        Hll = jnp.zeros((9, Lb), dtype)
        for k2, (i, j) in enumerate(lm_pairs):
            Hll = Hll.at[3 * i + j].set(lred[3 + k2])
            if j > i:
                Hll = Hll.at[3 * j + i].set(lred[3 + k2])
        return chi2, Hpp, g_p, Hll, g_l, R[9:]

    in_specs = (
        P(),          # poses
        P(axis),      # lm_slab
        jax.tree_util.tree_map(lambda _: P(None, axis), sb.obs_data),
        P(axis),      # ci
        P(axis),      # li
        P(axis),      # w_pad
        P(axis),      # free_l
        P(axis),      # cam_bounds (n, C+1)
        P(),          # lam
    )
    out_specs = (P(), P(axis), P(), P(), P())

    @partial(shard_map, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False)
    def step(poses, lm_slab, od, ci, li, w_pad, free_l, cam_bounds, lam):
        dtype = poses.dtype
        bounds = cam_bounds[0]
        fl = free_l.astype(dtype)
        fp = free_p.astype(dtype)

        chi2, Hpp, g_p, Hll, g_l, W = linearize(
            poses, lm_slab, od, ci, li, w_pad, bounds, True
        )
        chi2 = jax.lax.psum(chi2, axis) + _chi2_rep(poses)
        Hpp = jax.lax.psum(Hpp, axis)
        g_p = jax.lax.psum(g_p, axis)
        H_u, g_u, couplings = _rep_contrib(poses, dtype)
        Hpp = Hpp + H_u
        g_p = g_p + g_u
        couplings = [
            (PP * fp[pi][:, None, None] * fp[pj][:, None, None], pi, pj)
            for PP, pi, pj in couplings
        ]

        # constant / dead handling
        eye6 = jnp.eye(6, dtype=dtype)
        Hpp = Hpp * fp[:, None, None] + (1.0 - fp)[:, None, None] * eye6
        g_p = g_p * fp[:, None]
        dead = ((Hll[0] + Hll[4] + Hll[8]) == 0.0).astype(dtype)
        live = fl * (1.0 - dead)
        Hll = Hll * live[None] + (1.0 - live)[None] * jnp.asarray(
            [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0], dtype
        )[:, None]
        g_l = g_l * live[None]
        fobs = fp[ci] * live[li]
        W = W * fobs[None]

        if options.method == "lm":
            d6 = jnp.maximum(jnp.einsum("nii->ni", Hpp), 1e-12)
            Hpp = Hpp + lam * d6[:, :, None] * eye6
            for k in (0, 4, 8):
                Hll = Hll.at[k].set(Hll[k] * (1.0 + lam))
        Hinv = _inv33_flat(Hll)

        # op-shape rules (solver/schur_large._mv_ops): ONE (Mb, k) padded
        # gather per direction instead of k row gathers; k reductions as
        # ONE (k, Mb) batched cumsum; and — sharding bonus — each direction
        # psums ONE stacked array instead of k separate collectives.
        def W_T_dot_cam(xb):
            xg = xb[ci]  # (Mb, 6): one padded gather
            accs = jnp.stack([
                sum(W[3 * i + j] * xg[:, i] for i in range(6)) for j in range(3)
            ]).T  # (Mb, 3)
            return jax.ops.segment_sum(accs, li, num_segments=Lb).T

        def W_dot_lm(t3):
            tg = t3.T[li]  # (Mb, 3): one padded gather
            accs = jnp.stack([
                W[3 * i] * tg[:, 0] + W[3 * i + 1] * tg[:, 1] + W[3 * i + 2] * tg[:, 2]
                for i in range(6)
            ])  # (6, Mb)
            tot = jnp.concatenate(
                [jnp.zeros((6, 1), dtype), jnp.cumsum(accs, axis=1)], axis=1
            )
            loc = (tot[:, bounds[1:]] - tot[:, bounds[:-1]]).T  # (C, 6)
            return jax.lax.psum(loc, axis)

        g_red = g_p - W_dot_lm(_apply33_flat(Hinv, g_l))

        # SCHUR_JACOBI: one (Mb, 9) Hinv gather + one (21, Mb) cumsum +
        # ONE psum of the stacked (21, C) accumulators
        Hg = Hinv.T[li]  # (Mb, 9)
        vrows, pairs = [], []
        for i in range(6):
            u = [
                Hg[:, 3 * j] * W[3 * i] + Hg[:, 3 * j + 1] * W[3 * i + 1]
                + Hg[:, 3 * j + 2] * W[3 * i + 2]
                for j in range(3)
            ]
            for i2 in range(i, 6):
                vrows.append(W[3 * i2] * u[0] + W[3 * i2 + 1] * u[1] + W[3 * i2 + 2] * u[2])
                pairs.append((i, i2))
        vstack = jnp.stack(vrows)  # (21, Mb)
        tot = jnp.concatenate(
            [jnp.zeros((21, 1), dtype), jnp.cumsum(vstack, axis=1)], axis=1
        )
        accs = jax.lax.psum(tot[:, bounds[1:]] - tot[:, bounds[:-1]], axis)
        D = Hpp
        for k2, (i, i2) in enumerate(pairs):
            D = D.at[:, i, i2].add(-accs[k2])
            if i2 > i:
                D = D.at[:, i2, i].add(-accs[k2])
        from ..solver.bcsr import sym_block_inv

        Dinv = sym_block_inv(D)

        def matvec(x):
            xb = x.reshape(C, 6)
            y = jnp.einsum("cij,cj->ci", Hpp, xb)
            # replicated pose-pose coupling: identical on every device,
            # applied outside the psum (see dist/schur_reduce.py)
            for PP, pi, pj in couplings:
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

        def precond(r):
            return jnp.einsum("cij,cj->ci", Dinv, r.reshape(C, 6)).reshape(-1)

        dx_p, _ = pcg_solve(
            matvec, g_red.reshape(-1), precond=precond, rtol=pcg_rtol,
            max_iters=pcg_max_iters,
        )
        dx_p = dx_p.reshape(C, 6) * fp[:, None]
        tloc = g_l - W_T_dot_cam(dx_p)
        dx_l = _apply33_flat(Hinv, tloc) * live[None]

        dx_norm = jnp.sqrt(jnp.sum(dx_p**2) + jax.lax.psum(jnp.sum(dx_l**2), axis))
        new_poses = retract("se3", poses, dx_p)
        new_lm = lm_slab + dx_l.T
        cost_new = jax.lax.psum(
            linearize(new_poses, new_lm, od, ci, li, w_pad, bounds, False), axis
        ) + _chi2_rep(new_poses)
        return new_poses, new_lm, chi2, cost_new, dx_norm

    return step


def solve_schur_cm(
    graph: FactorGraph,
    mesh: Mesh,
    options: _lm.Options = _lm.Options(),
    n_chunks: int = 8,
    axis: str = "l",
    pose_name: str = "poses",
    lm_name: str = "landmarks",
    partition: Partition | None = None,
    pcg_rtol: float = 1e-4,
    pcg_max_iters: int = 30,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 5,
    resume: bool = False,
):
    """Sharded component-major Schur LM solve.  Returns
    (solved_graph, final_chi2, cost_history).

    Elastic recovery (SURVEY.md §5, same contract as schur_reduce):
    mesh-independent (poses, original-order landmarks, lambda) snapshots on
    accepted iterations; ``resume=True`` restarts from the snapshot on any
    mesh size."""
    sb = shard_ba_cm(graph, mesh, n_chunks, axis, pose_name, lm_name, partition)
    step = jax.jit(make_cm_step(sb, options, pcg_rtol, pcg_max_iters))
    dtype = np.asarray(sb.poses).dtype

    from ..solver.host_loop import host_lm_loop

    if checkpoint_path is not None and not checkpoint_path.endswith(".npz"):
        checkpoint_path = checkpoint_path + ".npz"
    poses0, lm0 = sb.poses, sb.lm_slab
    opts = options
    if resume and checkpoint_path is not None:
        import os

        if os.path.exists(checkpoint_path):
            ck = np.load(checkpoint_path)
            poses0 = jnp.asarray(ck["poses"])
            slab = np.asarray(sb.lm_slab).copy()
            slab[sb.lm_perm] = ck["landmarks"]
            lm0 = jnp.asarray(slab)
            opts = dataclasses.replace(options, lambda_init=float(ck["lam"]))

    def lm_step(state, lam):
        p, l = state
        new_poses, new_lm, chi2, cost_new, dx_norm = step(
            p, l, sb.obs_data, sb.ci, sb.li, sb.w_pad, sb.free_l,
            sb.cam_bounds, jnp.asarray(lam, dtype),
        )
        return (new_poses, new_lm), chi2, cost_new, dx_norm

    def _on_accept(state, lam, n_accepted):
        if checkpoint_path is not None and n_accepted % checkpoint_every == 0:
            np.savez(
                checkpoint_path.removesuffix(".npz"),
                poses=np.asarray(state[0]),
                landmarks=np.asarray(state[1])[sb.lm_perm],
                lam=lam,
            )

    (poses, lm_slab), history, _info = host_lm_loop(
        lm_step, (poses0, lm0), opts, on_accept=_on_accept
    )

    lm_full = np.asarray(lm_slab)[sb.lm_perm]
    pb = graph.blocks[pose_name]
    lb = graph.blocks[lm_name]
    new_blocks = dict(graph.blocks)
    new_blocks[pose_name] = VariableBlock(pb.kind, jnp.asarray(np.asarray(poses)), pb.const_mask)
    new_blocks[lm_name] = VariableBlock(lb.kind, jnp.asarray(lm_full), lb.const_mask)
    solved = FactorGraph(new_blocks, graph.batches)
    return solved, history[-1], history


__all__ = ["solve_schur_cm", "shard_ba_cm", "make_cm_step"]
