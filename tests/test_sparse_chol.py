"""Sparse direct multifrontal block Cholesky (solver/sparse_chol.py).

The load-bearing claim is EXACTNESS: the multifrontal solve must equal the
dense Cholesky solve (same dx, same converged chi2) while never forming a
(D, D) matrix — the reference's spsolve-everywhere capability (SURVEY.md
§2.1 Problem row, §2.2 spsolve replacement table)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyslam_tpu.graph import build
from pyslam_tpu.io import synth
from pyslam_tpu.solver import Options, solve
from pyslam_tpu.solver.assemble import assemble_dense, unit_diag_where_dead
from pyslam_tpu.solver.bcsr import assemble_ell
from pyslam_tpu.solver.linear import cholesky_solve
from pyslam_tpu.solver.sparse_chol import (
    build_chol_plan,
    solve_sparse_chol,
    sparse_chol_solve,
)


def _linear_solve_check(g, leaf_size, lam=1e-3, rtol=1e-8):
    """One damped linear solve: multifrontal dx == dense dx."""
    plan = build_chol_plan(g, leaf_size=leaf_size)
    He, gr, _ = assemble_ell(g, plan.ell)
    opt = Options(method="lm")
    dx = np.asarray(sparse_chol_solve(plan, He, gr, jnp.asarray(lam, He.dtype), opt))

    H, gd, _ = assemble_dense(g)
    H = unit_diag_where_dead(H)
    d = np.asarray(jnp.einsum("ii->i", H))
    Hd = np.asarray(H) + lam * np.diag(np.maximum(d, 1e-12))
    dx_dense = np.linalg.solve(Hd, np.asarray(gd))
    np.testing.assert_allclose(dx, dx_dense, rtol=rtol, atol=1e-9)


class TestLinearSolveExactness:
    def test_se2_loop_matches_dense(self):
        data = synth.se2_loop(n_poses=60, n_loops=10, seed=3)
        g = build.pose_graph(data, dtype=jnp.float64)
        _linear_solve_check(g, leaf_size=8)

    def test_se3_sphere_matches_dense(self):
        data = synth.se3_sphere(n_poses=150, seed=1)
        g = build.pose_graph(data, dtype=jnp.float64)
        _linear_solve_check(g, leaf_size=16)

    @pytest.mark.parametrize("leaf_size", [4, 32, 1000])
    def test_leaf_size_invariance(self, leaf_size):
        # leaf_size=1000 degenerates to one dense leaf; all must agree
        data = synth.se2_loop(n_poses=40, n_loops=6, seed=9)
        g = build.pose_graph(data, dtype=jnp.float64)
        _linear_solve_check(g, leaf_size=leaf_size)

    def test_constant_poses_inert(self):
        data = synth.se2_loop(n_poses=30, n_loops=4, seed=5)
        g = build.pose_graph(data, dtype=jnp.float64)
        # pose_graph anchors pose 0 as constant: its dx rows must be 0
        plan = build_chol_plan(g, leaf_size=8)
        He, gr, _ = assemble_ell(g, plan.ell)
        dx = np.asarray(
            sparse_chol_solve(plan, He, gr, jnp.asarray(1e-3, He.dtype), Options(method="lm"))
        )
        const = np.asarray(g.blocks["poses"].const_mask)
        assert const[0]
        np.testing.assert_allclose(dx.reshape(-1, 3)[const], 0.0, atol=1e-14)


class TestFullSolve:
    def test_chi2_matches_dense_path(self):
        data = synth.se2_loop(n_poses=80, n_loops=12, seed=2)
        g = build.pose_graph(data, dtype=jnp.float64)
        opts = Options(method="lm", max_iters=30)
        _, info_dense = solve(g, opts)
        _, info_sp = solve_sparse_chol(g, opts, leaf_size=16)
        np.testing.assert_allclose(
            float(info_sp.chi2), float(info_dense.chi2), rtol=1e-8
        )

    def test_stiff_manhattan_exact_optimum(self):
        """M3500-class stiff 2D graph: PCG stalls here (CLAUDE.md: 'exact
        solves matter on stiff 2D graphs'); sparse direct must hit the dense
        optimum exactly — without ever forming (D, D)."""
        data = synth.se2_manhattan(n_poses=600, seed=4)
        g = build.pose_graph(data, dtype=jnp.float64)
        opts = Options(method="lm", max_iters=40)
        _, info_dense = solve(g, opts)
        _, info_sp = solve_sparse_chol(g, opts, leaf_size=32)
        np.testing.assert_allclose(
            float(info_sp.chi2), float(info_dense.chi2), rtol=1e-9
        )

    def test_solve_is_deterministic_and_cache_reuses(self):
        from pyslam_tpu.solver import sparse_chol as sc

        data = synth.se2_loop(n_poses=30, n_loops=3, seed=7)
        g = build.pose_graph(data, dtype=jnp.float64)
        opts = Options(method="lm", max_iters=10)
        _, i1 = solve_sparse_chol(g, opts)
        n = len(sc._CLOSURES)
        _, i2 = solve_sparse_chol(g, opts)
        assert len(sc._CLOSURES) == n
        assert float(i1.chi2) == float(i2.chi2)


class TestPlanStructure:
    def test_root_boundary_empty_and_cols_partition(self):
        data = synth.se3_sphere(n_poses=120, seed=6)
        g = build.pose_graph(data, dtype=jnp.float64)
        plan = build_chol_plan(g, leaf_size=16)
        seen = np.zeros(plan.nb, bool)
        for kpad, bpad, N, cols_idx, bnd_idx, *_ in plan.waves:
            real = cols_idx[cols_idx < plan.nb]
            assert not seen[real].any(), "a variable eliminated twice"
            seen[real] = True
        assert seen.all(), "every variable must be eliminated exactly once"
        # last wave is the root: its boundary must be all padding
        *_, root_wave = plan.waves
        assert (root_wave[4] == plan.nb).all()


class TestSelectedInverse:
    """Takahashi selected inversion (sparse_chol.selected_inverse_marginals):
    ALL marginal blocks in one top-down sweep over the multifrontal factors."""

    def test_all_marginals_equal_dense_inverse(self):
        from pyslam_tpu.solver import full_covariance, solve
        from pyslam_tpu.solver.covariance import marginal_covariances_direct

        data = synth.se2_loop(n_poses=120, n_loops=10, seed=0)
        g = build.pose_graph(data, dtype=jnp.float64)
        solved, _ = solve(g, Options(method="gn", max_iters=25))
        Sig = np.asarray(full_covariance(solved))
        M = np.asarray(marginal_covariances_direct(solved))  # selinv path
        for i in range(0, 120, 7):
            np.testing.assert_allclose(
                M[i], Sig[3 * i : 3 * i + 3, 3 * i : 3 * i + 3], atol=1e-12
            )
        # the anchored pose keeps its unit block (masking convention)
        np.testing.assert_allclose(M[0], np.eye(3), atol=1e-12)

    def test_subset_request_stays_on_column_solves(self):
        from pyslam_tpu.solver import solve
        from pyslam_tpu.solver.covariance import marginal_covariances_direct

        data = synth.se2_loop(n_poses=60, n_loops=6, seed=1)
        g = build.pose_graph(data, dtype=jnp.float64)
        solved, _ = solve(g, Options(method="gn", max_iters=20))
        M_all = np.asarray(marginal_covariances_direct(solved))
        M_sub = np.asarray(
            marginal_covariances_direct(solved, indices=np.array([3, 41]))
        )
        np.testing.assert_allclose(M_sub[0], M_all[3], atol=1e-12)
        np.testing.assert_allclose(M_sub[1], M_all[41], atol=1e-12)

    def test_fill_pair_cross_blocks(self):
        """Within-fill (u, v) cross blocks out of the same sweep (the
        relative-pose-uncertainty use case) equal the dense inverse —
        including the swapped-extraction orientation — and out-of-fill
        pairs raise with the column-solve alternative named."""
        from pyslam_tpu.solver import full_covariance, solve
        from pyslam_tpu.solver.covariance import covariance_blocks_direct

        data = synth.se2_loop(n_poses=80, n_loops=8, seed=0)
        g = build.pose_graph(data, dtype=jnp.float64)
        solved, _ = solve(g, Options(method="gn", max_iters=25))
        Sig = np.asarray(full_covariance(solved))
        pairs = [(5, 6), (6, 5), (20, 21), (40, 41), (10, 10)]
        _, blocks = covariance_blocks_direct(solved, pairs)
        for (u, v), B in zip(pairs, np.asarray(blocks)):
            np.testing.assert_allclose(
                B, Sig[3 * u : 3 * u + 3, 3 * v : 3 * v + 3], atol=1e-12
            )

        # a distant pair on a pure chain is genuinely outside the fill
        data = synth.se2_loop(n_poses=80, n_loops=0, seed=0)
        g = build.pose_graph(data, dtype=jnp.float64)
        solved, _ = solve(g, Options(method="gn", max_iters=25))
        with pytest.raises(ValueError, match="outside the factorization fill"):
            covariance_blocks_direct(solved, [(1, 75)])

    def test_se3_six_dof_marginals(self):
        """dof-generality: the sweep works unchanged on 6-dof SE(3) blocks."""
        from pyslam_tpu.solver import full_covariance, solve
        from pyslam_tpu.solver.covariance import marginal_covariances_direct

        data = synth.se3_sphere(n_poses=60, seed=1)
        g = build.pose_graph(data, dtype=jnp.float64)
        solved, _ = solve(g, Options(method="lm", max_iters=25))
        Sig = np.asarray(full_covariance(solved))
        M = np.asarray(marginal_covariances_direct(solved))
        for i in range(0, 60, 11):
            np.testing.assert_allclose(
                M[i], Sig[6 * i : 6 * i + 6, 6 * i : 6 * i + 6], atol=1e-11
            )

    def test_logdet_matches_dense(self):
        from pyslam_tpu.solver import solve
        from pyslam_tpu.solver.assemble import assemble_dense, unit_diag_where_dead
        from pyslam_tpu.solver.bcsr import assemble_ell
        from pyslam_tpu.solver.sparse_chol import (
            _factorize,
            build_chol_plan,
            factor_logdet,
        )

        data = synth.se2_loop(n_poses=90, n_loops=9, seed=2)
        g = build.pose_graph(data, dtype=jnp.float64)
        solved, _ = solve(g, Options(method="gn", max_iters=20))
        plan = build_chol_plan(solved)
        He, _, _ = assemble_ell(solved, plan.ell)
        ld = float(factor_logdet(plan, _factorize(plan, He)))
        H, _, _ = assemble_dense(solved)
        H = unit_diag_where_dead(H)
        sign, ld_ref = np.linalg.slogdet(np.asarray(H))
        assert sign > 0
        np.testing.assert_allclose(ld, ld_ref, rtol=1e-10)

    def test_out_of_range_pairs_raise_value_error(self):
        from pyslam_tpu.solver import covariance_blocks_direct, solve

        data = synth.se2_loop(n_poses=30, n_loops=3, seed=3)
        g = build.pose_graph(data, dtype=jnp.float64)
        solved, _ = solve(g, Options(method="gn", max_iters=10))
        for bad in [(0, 30), (-1, 5)]:
            with pytest.raises(ValueError, match="out of range"):
                covariance_blocks_direct(solved, [bad])

    def test_factor_reuse_across_queries(self):
        """Online gating reuses one factorization for repeated queries."""
        from pyslam_tpu.solver import covariance_blocks_direct, solve
        from pyslam_tpu.solver.bcsr import assemble_ell
        from pyslam_tpu.solver.sparse_chol import _factorize, build_chol_plan

        data = synth.se2_loop(n_poses=30, n_loops=3, seed=3)
        g = build.pose_graph(data, dtype=jnp.float64)
        solved, _ = solve(g, Options(method="gn", max_iters=10))
        plan = build_chol_plan(solved)
        He, _, _ = assemble_ell(solved, plan.ell)
        factors = _factorize(plan, He)
        _, b1 = covariance_blocks_direct(solved, [(4, 5)], plan=plan, factors=factors)
        _, b2 = covariance_blocks_direct(solved, [(4, 5)])
        np.testing.assert_allclose(np.asarray(b1), np.asarray(b2), atol=1e-13)
