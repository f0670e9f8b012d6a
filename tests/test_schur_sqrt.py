"""Square-root (QR) landmark marginalization (solver/schur_sqrt.py,
PAPERS.md arXiv 2109.02182): must converge to the same chi2 as the
normal-equation Schur path, and beat it in f32 on ill-conditioned
(low-parallax) geometry."""

import jax.numpy as jnp
import numpy as np
import pytest

from pyslam_tpu.graph import build
from pyslam_tpu.graph.core import FactorBatch, FactorGraph
from pyslam_tpu.io import bal, synth
from pyslam_tpu.losses import HuberLoss
from pyslam_tpu.solver import Options, solve_schur
from pyslam_tpu.solver.schur_sqrt import build_sqrt_plan, solve_schur_sqrt


def stereo_graph(dtype=jnp.float64, loss=None, seed=8):
    data = synth.ba_synthetic(n_cams=6, n_pts=40, obs_per_pt=4, seed=seed)
    return build.ba_graph(data, loss=loss, dtype=dtype)


class TestSchurSqrt:
    def test_matches_schur_stereo(self):
        g = stereo_graph()
        opts = Options(method="lm", max_iters=25)
        _, i1 = solve_schur(g, opts, mode="dense")
        _, i2 = solve_schur_sqrt(g, opts)
        np.testing.assert_allclose(float(i2.chi2), float(i1.chi2), rtol=1e-6)

    def test_matches_schur_bal(self):
        data = bal.perturbed(bal.synthetic_bal(n_cams=6, n_pts=50, seed=0))
        g = build.bal_graph(data, dtype=jnp.float64)
        opts = Options(method="lm", max_iters=25)
        _, i1 = solve_schur(g, opts, mode="dense")
        _, i2 = solve_schur_sqrt(g, opts)
        np.testing.assert_allclose(float(i2.chi2), float(i1.chi2), rtol=1e-6)

    def test_robust_loss(self):
        g = stereo_graph(loss=HuberLoss(2.0))
        chi0 = float(g.chi2())
        _, info = solve_schur_sqrt(g, Options(method="lm", max_iters=20))
        assert float(info.chi2) < chi0 * 0.2

    def test_pose_prior_unary(self):
        g = stereo_graph()
        pb = g.blocks["poses"]
        prior = FactorBatch.create(
            kind="prior_se3",
            slots=("poses",),
            indices=(np.array([1], np.int32),),
            data={
                "T_obs": jnp.asarray(np.asarray(pb.values[1:2]), jnp.float64),
                "sqrt_info": 1e2 * jnp.eye(6, dtype=jnp.float64)[None],
            },
            loss=g.batches[0].loss,
        )
        g2 = FactorGraph(dict(g.blocks), [g.batches[0], prior])
        opts = Options(method="lm", max_iters=25)
        _, i1 = solve_schur(g2, opts, mode="dense")
        _, i2 = solve_schur_sqrt(g2, opts)
        np.testing.assert_allclose(float(i2.chi2), float(i1.chi2), rtol=1e-6)

    def test_gauge_anchor_fixed(self):
        g = stereo_graph()
        solved, _ = solve_schur_sqrt(g, Options(method="lm", max_iters=10))
        np.testing.assert_allclose(
            np.asarray(solved.blocks["poses"].values[0]),
            np.asarray(g.blocks["poses"].values[0]),
            atol=1e-12,
        )

    def test_bucketing_covers_all_observed(self):
        g = stereo_graph(seed=3)
        plan = build_sqrt_plan(g)
        covered = np.sort(
            np.concatenate([np.asarray(l) for l, _, _ in plan.buckets])
        )
        pt = np.asarray(g.batches[0].indices[1])
        np.testing.assert_array_equal(covered, np.unique(pt))
        # every observation appears exactly once across buckets
        n_obs = sum(int(np.asarray(m).sum()) for _, _, m in plan.buckets)
        assert n_obs == g.batches[0].n

    def test_f32_low_parallax_monocular(self):
        """Genuinely low-parallax MONOCULAR geometry (clustered cameras,
        bal.synthetic_bal(cam_cluster=...)): the sqrt path must stay within
        ~1e-4 relative of the f64 reference trajectory where the
        normal-equation path deviates at the 1e-3 level (the result is
        mixed across regimes — this asserts only the cluster=0.05
        case)."""
        data = bal.perturbed(
            bal.synthetic_bal(n_cams=6, n_pts=50, seed=0, cam_cluster=0.05),
            seed=1,
        )
        opts = Options(method="lm", max_iters=50)
        g64 = build.bal_graph(data, dtype=jnp.float64)
        _, ref = solve_schur(g64, opts, mode="dense")
        chi_ref = float(ref.chi2)
        g32 = build.bal_graph(data, dtype=jnp.float32)
        _, b = solve_schur_sqrt(g32, opts)
        gap_sqrt = abs(float(b.chi2) - chi_ref) / chi_ref
        assert gap_sqrt < 1e-4
