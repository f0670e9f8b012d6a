"""GN/LM solver core (the on-device replacement of pyslam/problem.py solve
machinery; SURVEY.md §3.1)."""

import numpy as np

from .assemble import assemble_dense, gradient_and_chi2
from .linear import cholesky_solve, damp_marquardt, pcg_solve
from .lm import (
    Options,
    SolveInfo,
    STATUS_NAMES,
    solve,
    solve_one_iter,
)

__all__ = [
    "Options",
    "SolveInfo",
    "STATUS_NAMES",
    "solve",
    "solve_one_iter",
    "assemble_dense",
    "gradient_and_chi2",
    "cholesky_solve",
    "damp_marquardt",
    "pcg_solve",
]

from .bcsr import BlockPattern, assemble_bcsr, bcsr_matvec, build_pattern, solve_bcsr  # noqa: E402

__all__ += ["BlockPattern", "assemble_bcsr", "bcsr_matvec", "build_pattern", "solve_bcsr"]

from .schur import ba_assemble, solve_schur  # noqa: E402

__all__ += ["ba_assemble", "solve_schur"]

from .schur_sqrt import build_sqrt_plan, solve_schur_sqrt  # noqa: E402
from .schur_sparse import build_schur_sparse_plan, solve_schur_sparse  # noqa: E402
from .sparse_chol import build_chol_plan, solve_sparse_chol  # noqa: E402

__all__ += ["build_sqrt_plan", "solve_schur_sqrt", "build_chol_plan", "solve_sparse_chol",
            "build_schur_sparse_plan", "solve_schur_sparse"]

from .gnc import GNCInfo, solve_gnc  # noqa: E402
from .fixed_lag import FixedLagLandmarkSmoother, FixedLagSmoother  # noqa: E402
from .incremental import IncrementalSmoother  # noqa: E402

__all__ += ["solve_gnc", "GNCInfo", "FixedLagSmoother",
            "FixedLagLandmarkSmoother", "IncrementalSmoother"]

from .bcsr import EllDirect, assemble_ell, build_ell_direct, solve_ell, sym_block_inv  # noqa: E402
from .covariance import (  # noqa: E402
    covariance_block,
    covariance_blocks_direct,
    full_covariance,
    landmark_covariance_block,
    landmark_marginal_covariances,
    marginal_covariances,
    marginal_covariances_direct,
    pose_covariance_block,
    pose_landmark_covariance_block,
    pose_marginal_covariances,
)

__all__ += [
    "EllDirect",
    "assemble_ell",
    "build_ell_direct",
    "solve_ell",
    "sym_block_inv",
    "full_covariance",
    "marginal_covariances",
    "marginal_covariances_direct",
    "covariance_block",
    "covariance_blocks_direct",
    "pose_covariance_block",
    "pose_marginal_covariances",
    "landmark_marginal_covariances",
    "landmark_covariance_block",
    "pose_landmark_covariance_block",
]


def device_memory_budget(mesh=None):
    """Bytes one device of ``mesh`` (default: the first visible device) can
    hold, from its own ``memory_stats()["bytes_limit"]``.  None where the
    device reports no limit (the CPU backend): no memory gate applies."""
    import jax

    dev = jax.devices()[0] if mesh is None else mesh.devices.flat[0]
    stats = dev.memory_stats() or {}
    limit = stats.get("bytes_limit")
    return int(limit) if limit else None


def _over_budget(nbytes, budget):
    return budget is not None and nbytes > budget


def _mono_low_parallax(graph, pose_name, lm_name, max_obs=500_000, spread_thresh=1.4e-3):
    """True when a monocular BA graph's landmark geometry is low-parallax
    (the f32-ill-conditioned regime where the square-root path wins).

    Cheap host check at dispatch time: per-landmark resultant length of the
    unit observation rays — parallax std angle ~ sqrt(2 * (1 - |mean ray|)),
    threshold ~3 degrees.  Stereo/RGB-D (3-dof residuals) return False;
    conditioning never bites when observations carry depth."""
    binary = [fb for fb in graph.batches if fb.slots == (pose_name, lm_name)]
    if len(binary) != 1 or binary[0].n > max_obs:
        return False
    fb = binary[0]
    data = getattr(fb, "data", None)
    obs = None if data is None else data.get("obs")
    if obs is None or obs.ndim != 2 or obs.shape[-1] != 2:
        return False  # not monocular
    pb, lb = graph.blocks[pose_name], graph.blocks[lm_name]
    if pb.kind != "se3":
        return False
    T = np.asarray(pb.values)  # (C, 4, 4) world -> cam
    R, t = T[:, :3, :3], T[:, :3, 3]
    centers = -np.einsum("cji,cj->ci", R, t)
    pts = np.asarray(lb.values)
    ci = np.asarray(fb.indices[0])
    li = np.asarray(fb.indices[1])
    rays = pts[li] - centers[ci]
    rays /= np.maximum(np.linalg.norm(rays, axis=1, keepdims=True), 1e-12)
    s = np.zeros((lb.n, 3))
    np.add.at(s, li, rays)
    cnt = np.bincount(li, minlength=lb.n)
    multi = cnt >= 2
    if not multi.any():
        return False
    spread = 1.0 - np.linalg.norm(s[multi], axis=1) / cnt[multi]
    return bool(np.median(spread) < spread_thresh)


def route_auto(
    graph,
    mesh=None,
    dense_dof_limit: int = 12000,
    dense_hpl_budget_bytes: int = 1 << 30,
    device_hbm_budget_bytes: int | None = None,
    tiny_dof: int = 2000,
    schur_sparse_pair_budget: int = 2_000_000,
    cm_obs_crossover: int = 250_000,
):
    """Name of the solve path ``solve_auto`` picks for this graph (+mesh).

    Single-chip routes: ``dense`` / ``sparse_chol`` / ``ell`` /
    ``schur_dense`` / ``schur_sparse`` (exact multifrontal factorization of
    the reduced camera system — many-poses/few-landmarks graphs with sparse
    co-observation) / ``schur_pcg`` / ``schur_sqrt`` (f32 mono low-parallax
    conditioning) / ``schur_large``.
    Mesh routes (the system, not the user, picks the sharding strategy):
    ``factor_parallel`` (tiny graphs: replicating is free, factor eval
    dominates), ``pose_sharded`` (single-block graphs whose ELL store
    exceeds one device's memory — below that a replicated single-device
    solve_ell is faster), ``schur_reduce`` (camera+landmark), ``schur_cm``
    (camera+landmark whose per-device observation slab exceeds the device's
    memory in the block layout, OR exceeds ``cm_obs_crossover``
    observations per device).

    Memory gates use logical bytes (``d*d*itemsize`` per block) against
    ``device_hbm_budget_bytes``, which defaults to the mesh devices' own
    ``memory_stats()["bytes_limit"]``; where the device reports no limit
    (the CPU), no memory gate applies.  The crossovers
    (``cm_obs_crossover``, ``dense_dof_limit``, the 2M-observation
    ``schur_large`` cut) were tuned on the accelerator the system was first
    built for and have not been measured on the H100.
    """
    blocks = graph.blocks
    kinds = {name: b.kind for name, b in blocks.items()}
    lie_blocks = [n for n, k in kinds.items() if k != "euclidean"]
    euc_blocks = [n for n, k in kinds.items() if k == "euclidean"]
    # BA shape = one lie + one euclidean block AND at least one (pose,
    # landmark) binary batch — a 2-block graph coupled only by other
    # factor arities (e.g. switchable pose graphs: poses + switches via
    # 3-slot factors) is NOT BA and must not enter the Schur routes
    is_ba = (
        len(blocks) == 2
        and len(lie_blocks) == 1
        and len(euc_blocks) == 1
        and any(
            fb.slots == (lie_blocks[0], euc_blocks[0]) for fb in graph.batches
        )
    )
    n_dev = 1 if mesh is None else int(np.prod(list(mesh.shape.values())))

    if mesh is not None and n_dev > 1:
        budget = (
            device_hbm_budget_bytes
            if device_hbm_budget_bytes is not None
            else device_memory_budget(mesh)
        )
        if is_ba:
            pose_name, lm_name = lie_blocks[0], euc_blocks[0]
            binary = [fb for fb in graph.batches if fb.slots == (pose_name, lm_name)]
            n_obs = sum(fb.n for fb in binary)
            # per-device block-layout slab: per observation, its W block
            # plus its Hpp and Hll contributions.  schur_cm's flat
            # component-major layout hardcodes (6, 3)-dof blocks; 9-dof
            # bal_cam9 graphs stay on the dof-generic schur_reduce.
            pb, lb = blocks[pose_name], blocks[lm_name]
            obs_bytes = (
                pb.dof * lb.dof + pb.dof * pb.dof + lb.dof * lb.dof
            ) * pb.values.dtype.itemsize
            obs_per_dev = n_obs // max(n_dev, 1)
            if pb.dof == 6 and (
                _over_budget(obs_per_dev * obs_bytes, budget)
                or obs_per_dev > cm_obs_crossover
            ):
                return "schur_cm"
            return "schur_reduce"
        if len(blocks) == 1:
            if graph.total_dof <= tiny_dof:
                return "factor_parallel"
            blk = next(iter(blocks.values()))
            # symmetric ELL store: nb * K blocks of (d, d); K ~ 1 + avg degree
            n_edges = sum(
                fb.n for fb in graph.batches if len(set(fb.slots)) == 1 and len(fb.slots) == 2
            )
            K_est = 1 + int(np.ceil(2 * n_edges / max(blk.n, 1))) * 2  # max deg ~ 2x avg
            ell_bytes = blk.n * K_est * blk.dof * blk.dof * blk.values.dtype.itemsize
            return "pose_sharded" if _over_budget(ell_bytes, budget) else "ell"
        # Multi-block graphs (VIO pose+vel+bias, sim3+landmark, 3+ blocks):
        # factor_parallel is DP over residual blocks — block-structure-
        # agnostic (SURVEY.md §2.3 DP row) — so it is the documented mesh
        # route up to the dense-solve ceiling (the replicated solve is the
        # same dense Cholesky the single-chip dense path uses).  Beyond
        # that ceiling no sharded path speaks 3+-block structure; warn
        # loudly instead of silently solving replicated.
        if graph.total_dof <= dense_dof_limit:
            return "factor_parallel"
        import warnings

        warnings.warn(
            "route_auto: no sharded path supports this multi-block graph "
            f"({len(blocks)} variable blocks, total_dof={graph.total_dof} > "
            f"dense_dof_limit={dense_dof_limit}); solving REPLICATED on a "
            "single device.  Supported mesh routes: 2-block BA "
            "(schur_reduce/schur_cm), single-block pose graphs "
            "(ell/pose_sharded), any-structure graphs up to "
            "dense_dof_limit (factor_parallel).  See docs/DISTRIBUTED.md.",
            stacklevel=3,
        )
        return "_single"

    if is_ba:
        pose_name, lm_name = lie_blocks[0], euc_blocks[0]
        binary = [fb for fb in graph.batches if fb.slots == (pose_name, lm_name)]
        others = [fb for fb in graph.batches if fb.slots != (pose_name, lm_name)]
        n_obs = sum(fb.n for fb in binary)
        if (
            n_obs > 2_000_000
            and len(binary) == 1
            # schur_large's component-major layout is specialized to
            # (6, 3)-dof camera/landmark blocks ((18, M) W storage);
            # 9-dof bal_cam9 graphs fall through to the generic Schur PCG
            and blocks[pose_name].dof == 6
            and all(
                fb.slots in ((pose_name,), (pose_name, pose_name)) for fb in others
            )
        ):
            return "schur_large"
        pb, lb = blocks[pose_name], blocks[lm_name]
        itemsize = pb.values.dtype.itemsize
        # Conditioning route: in f32, monocular low-parallax geometry
        # squares Jl's condition number through Hll = Jl^T Jl; the
        # square-root (QR) elimination tracks the f64 trajectory far more
        # closely there (tests/test_solve_auto.py).  Stereo/RGB-D
        # observations carry depth, so conditioning never bites — mono
        # 2-dof residuals only.
        if (
            pb.n * pb.dof <= 4096
            and itemsize == 4
            and len(binary) == 1
            and lb.dof == 3
            and all(fb.slots == (pose_name,) for fb in others)
            and _mono_low_parallax(graph, pose_name, lm_name)
        ):
            return "schur_sqrt"
        hpl_bytes = pb.n * pb.dof * lb.n * lb.dof * itemsize
        if pb.n * pb.dof <= 4096 and 2 * hpl_bytes <= dense_hpl_budget_bytes:
            return "schur_dense"
        # SPARSE_SCHUR: beyond the dense ceiling, when the co-observation
        # camera graph is sparse (many poses / few landmarks — Victoria-
        # Park-class 2D landmark SLAM, sliding windows), the reduced S
        # factors EXACTLY through the multifrontal path at O(fill) instead
        # of trusting iterative SCHUR_JACOBI PCG (the M3500 stall lesson).
        # Gate on the co-observation pair count (sum of squared landmark
        # degrees): first the shape-only Cauchy-Schwarz lower bound
        # n_obs^2 / L (no index arrays touched), then the real count.
        pair_budget = min(schur_sparse_pair_budget, 96 * pb.n)
        if (
            n_obs > 0
            and n_obs * n_obs <= pair_budget * max(lb.n, 1)
            and all(
                fb.slots in ((pose_name,), (pose_name, pose_name), (pose_name, lm_name))
                for fb in graph.batches
            )
        ):
            from .schur_sparse import coobservation_stats

            pairs_sq, _ = coobservation_stats(graph, pose_name, lm_name)
            if pairs_sq <= pair_budget:
                return "schur_sparse"
        return "schur_pcg"
    if len(blocks) == 1 and graph.total_dof > dense_dof_limit:
        blk = next(iter(blocks.values()))
        # Stiff 2D graphs need EXACT solves (PCG stalls in a worse basin:
        # M3500 668 vs 622) — beyond the dense ceiling, the multifrontal
        # sparse Cholesky is the exact option.  2D dissection separators
        # stay narrow, so the fill is cheap there; 3D-ish SE(3) graphs keep
        # the ELL PCG default (sphere separators are wide).
        if blk.dof == 3 and blk.kind in ("se2", "euclidean"):
            return "sparse_chol"
        return "ell"
    return "dense"


def solve_auto(
    graph,
    options=None,
    mesh=None,
    dense_dof_limit: int = 12000,
    dense_hpl_budget_bytes: int = 1 << 30,
    device_hbm_budget_bytes: int | None = None,
    schur_sparse_pair_budget: int = 2_000_000,
    cm_obs_crossover: int = 250_000,
):
    """Structure-dispatching solve: picks the right linear-algebra path.

    Single-chip (mesh=None):
    * camera + landmark blocks (one lie + one euclidean block coupled by
      binary factors)  -> Schur complement (dense S for small camera counts,
      implicit PCG otherwise)
    * camera + landmark beyond ~2M observations -> streamed component-major
      Schur (solver/schur_large.py); accepts pose-unary prior batches too
    * single variable block, total dof <= dense_dof_limit -> dense Cholesky
      (exact solves; the most robust choice up to ~10k dof, e.g. M3500)
    * single variable block, larger -> block-sparse ELL + PCG

    With ``mesh``: dispatches among the four sharding strategies by graph
    shape and per-device memory (see ``route_auto``).  Sharded paths run
    the shared host LM loop; the returned info is their cost history.

    Returns (solved_graph, SolveInfo-or-history) matching the path's solver.
    """
    opts = options if options is not None else Options()
    route = route_auto(
        graph,
        mesh=mesh,
        dense_dof_limit=dense_dof_limit,
        dense_hpl_budget_bytes=dense_hpl_budget_bytes,
        device_hbm_budget_bytes=device_hbm_budget_bytes,
        schur_sparse_pair_budget=schur_sparse_pair_budget,
        cm_obs_crossover=cm_obs_crossover,
    )
    blocks = graph.blocks
    kinds = {name: b.kind for name, b in blocks.items()}
    lie_blocks = [n for n, k in kinds.items() if k != "euclidean"]
    euc_blocks = [n for n, k in kinds.items() if k == "euclidean"]

    if route == "factor_parallel":
        from ..dist.factor_parallel import solve_factor_parallel

        solved, _chi2, hist = solve_factor_parallel(graph, mesh, opts)
        return solved, hist
    if route == "pose_sharded":
        from ..dist.pose_sharded import solve_pose_sharded

        solved, _chi2, hist = solve_pose_sharded(graph, mesh, opts)
        return solved, hist
    if route == "schur_reduce":
        from ..dist.schur_reduce import solve_schur_sharded

        solved, _chi2, hist = solve_schur_sharded(
            graph, mesh, opts, pose_name=lie_blocks[0], lm_name=euc_blocks[0]
        )
        return solved, hist
    if route == "schur_cm":
        from ..dist.schur_cm import solve_schur_cm

        solved, _chi2, hist = solve_schur_cm(
            graph, mesh, opts, pose_name=lie_blocks[0], lm_name=euc_blocks[0]
        )
        return solved, hist

    if route == "schur_large":
        from .schur_large import solve_schur_large

        solved, chi2, hist = solve_schur_large(
            graph, opts, pose_name=lie_blocks[0], lm_name=euc_blocks[0]
        )
        return solved, hist
    if route == "sparse_chol":
        from .sparse_chol import solve_sparse_chol

        return solve_sparse_chol(graph, opts)
    if route == "schur_sqrt":
        from .schur_sqrt import solve_schur_sqrt

        return solve_schur_sqrt(
            graph, opts, pose_name=lie_blocks[0], lm_name=euc_blocks[0]
        )
    if route == "schur_sparse":
        from .schur_sparse import solve_schur_sparse

        return solve_schur_sparse(
            graph, opts, pose_name=lie_blocks[0], lm_name=euc_blocks[0]
        )
    if route in ("schur_dense", "schur_pcg"):
        return solve_schur(
            graph,
            opts,
            mode=route.removeprefix("schur_"),
            pose_name=lie_blocks[0],
            lm_name=euc_blocks[0],
        )
    if route == "ell":
        from .bcsr import solve_ell as _solve_ell

        return _solve_ell(graph, opts)
    return solve(graph, opts)


__all__ += ["solve_auto", "route_auto", "device_memory_budget"]


def solve_batched(graphs, options=None):
    """Solve a FLEET of same-structure factor graphs in one vmapped jitted
    LM program — a capability the reference cannot express (its solver is a
    Python loop per problem).  Use cases: Monte-Carlo uncertainty (resampled
    measurements), multi-robot fleets, measurement-hyperparameter sweeps.

    ``graphs``: list of FactorGraphs with identical structure (same blocks,
    batch kinds, factor counts — values/measurements may differ), or a
    single pre-stacked graph pytree with a leading batch axis on every leaf.
    Returns (stacked_solved_values: dict name -> (B, ...), chi2 (B,)).

    The whole batch shares one compilation and runs as one XLA program;
    lax.while_loop under vmap steps until every problem converges.
    """
    import jax
    import jax.tree_util as jtu

    opts = options if options is not None else Options()
    if isinstance(graphs, (list, tuple)):
        stacked = jtu.tree_map(lambda *xs: jax.numpy.stack(xs), *graphs)
    else:
        stacked = graphs

    def _solve_one(g):
        solved, info = solve(g, opts)
        return {n: b.values for n, b in solved.blocks.items()}, info.chi2

    return jax.vmap(_solve_one)(stacked)


__all__ += ["solve_batched"]

from .diff import solve_implicit  # noqa: E402

__all__ += ["solve_implicit"]

from .schur_large import solve_schur_large  # noqa: E402

__all__ += ["solve_schur_large"]

from .host_loop import host_lm_loop  # noqa: E402

__all__ += ["host_lm_loop"]

from .schur_sqrt import solve_schur_sqrt  # noqa: E402

__all__ += ["solve_schur_sqrt"]
