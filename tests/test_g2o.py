"""g2o I/O (BASELINE.json config #2 path): round-trip fidelity for SE(2) and
SE(3) pose graphs, measurement-convention consistency with the between
factors."""

import jax.numpy as jnp
import numpy as np

from pyslam_tpu.graph import build
from pyslam_tpu.io import g2o, synth
from pyslam_tpu.solver import Options, solve


class TestG2ORoundTrip:
    def test_se2(self, tmp_path):
        data = synth.se2_loop(n_poses=20, n_loops=3, seed=0)
        p = str(tmp_path / "a.g2o")
        g2o.write_g2o(p, data)
        back = g2o.read_g2o(p)
        assert back.dim == 2
        np.testing.assert_allclose(back.T_init, data.T_init, atol=1e-7)
        np.testing.assert_array_equal(back.edges_i, data.edges_i)
        np.testing.assert_array_equal(back.edges_j, data.edges_j)
        np.testing.assert_allclose(back.T_meas, data.T_meas, atol=1e-7)
        # info = sqrt_info^T sqrt_info survives the (upper-triangular) encoding
        info_a = np.einsum("eki,ekj->eij", data.sqrt_info, data.sqrt_info)
        info_b = np.einsum("eki,ekj->eij", back.sqrt_info, back.sqrt_info)
        np.testing.assert_allclose(info_b, info_a, rtol=1e-8, atol=1e-9)

    def test_se3(self, tmp_path):
        data = synth.se3_sphere(n_poses=15, n_loops=3, seed=1)
        p = str(tmp_path / "b.g2o")
        g2o.write_g2o(p, data)
        back = g2o.read_g2o(p)
        assert back.dim == 3
        np.testing.assert_allclose(back.T_init, data.T_init, atol=1e-8)
        np.testing.assert_allclose(back.T_meas, data.T_meas, atol=1e-8)
        info_a = np.einsum("eki,ekj->eij", data.sqrt_info, data.sqrt_info)
        info_b = np.einsum("eki,ekj->eij", back.sqrt_info, back.sqrt_info)
        np.testing.assert_allclose(info_b, info_a, rtol=1e-6, atol=1e-8)

    def test_solve_after_roundtrip_matches(self, tmp_path):
        data = synth.se2_loop(n_poses=25, n_loops=4, seed=3)
        p = str(tmp_path / "c.g2o")
        g2o.write_g2o(p, data)
        back = g2o.read_g2o(p)
        opts = Options(method="lm", max_iters=30)
        _, info_a = solve(build.pose_graph(data, dtype=jnp.float64), opts)
        _, info_b = solve(build.pose_graph(back, dtype=jnp.float64), opts)
        np.testing.assert_allclose(float(info_a.chi2), float(info_b.chi2), rtol=1e-8)


class TestTrajectoryIO:
    def test_tum_roundtrip(self, tmp_path):
        from pyslam_tpu.io import trajectory
        from pyslam_tpu.lie import se3
        import jax.numpy as jnp

        rng = np.random.default_rng(0)
        T = np.asarray(se3.exp(jnp.asarray(rng.normal(0, 0.5, (12, 6)))))
        ts = np.linspace(100.0, 101.1, 12)
        p = str(tmp_path / "traj.tum")
        trajectory.write_tum(p, T, ts)
        ts2, T2 = trajectory.read_tum(p)
        np.testing.assert_allclose(ts2, ts, atol=1e-6)
        np.testing.assert_allclose(T2, T, atol=1e-7)

    def test_kitti_roundtrip(self, tmp_path):
        from pyslam_tpu.io import trajectory
        from pyslam_tpu.lie import se3
        import jax.numpy as jnp

        rng = np.random.default_rng(1)
        T = np.asarray(se3.exp(jnp.asarray(rng.normal(0, 0.5, (9, 6)))))
        p = str(tmp_path / "traj.kitti")
        trajectory.write_kitti(p, T)
        T2 = trajectory.read_kitti(p)
        np.testing.assert_allclose(T2, T, atol=1e-7)

    def test_metrics_on_read_trajectory(self, tmp_path):
        from pyslam_tpu.io import trajectory
        from pyslam_tpu.eval import TrajectoryMetrics

        T = np.tile(np.eye(4), (10, 1, 1))
        T[:, 0, 3] = np.arange(10.0)
        p = str(tmp_path / "a.tum")
        trajectory.write_tum(p, T)
        _, back = trajectory.read_tum(p)
        tm = TrajectoryMetrics(T, back)
        assert float(tm.armse("trans")) < 1e-9


class TestG2OLegacyTags:
    def test_toro_aliases(self, tmp_path):
        # VERTEX2/EDGE2 (TORO) must parse identically to VERTEX_SE2/EDGE_SE2
        data = synth.se2_loop(n_poses=6, n_loops=1, seed=4)
        p1 = str(tmp_path / "modern.g2o")
        g2o.write_g2o(p1, data)
        legacy = open(p1).read().replace("VERTEX_SE2", "VERTEX2").replace(
            "EDGE_SE2", "EDGE2"
        )
        p2 = str(tmp_path / "legacy.g2o")
        open(p2, "w").write(legacy)
        a = g2o.read_g2o(p1)
        b = g2o.read_g2o(p2)
        np.testing.assert_allclose(b.T_init, a.T_init, atol=1e-12)
        np.testing.assert_allclose(b.T_meas, a.T_meas, atol=1e-12)


class TestParityHarness:
    def test_selftest_runs_end_to_end(self, tmp_path):
        """bench/parity.py --selftest contract (VERDICT r2 next #8): write
        real-format dataset files through the io writers, load them back,
        run stand-in + device solver, pass every parity gate."""
        import sys, pathlib

        root = pathlib.Path(__file__).resolve().parents[1]
        sys.path.insert(0, str(root / "bench"))
        try:
            import parity

            rows = parity.selftest(str(tmp_path / "ds"))
        finally:
            sys.path.pop(0)
        assert len(rows) == 4  # manhattan, sphere, landmark, BAL
        assert all(r["parity"] for r in rows)


class TestSim3G2o:
    def test_roundtrip_and_solve(self, tmp_path):
        from pyslam_tpu.graph import build
        from pyslam_tpu.io import synth
        from pyslam_tpu.io.g2o import read_g2o, write_g2o
        from pyslam_tpu.lie import sim3
        from pyslam_tpu.solver import Options, solve

        data = synth.sim3_loop(
            n_poses=40, n_loops=3, scale_drift=0.01, odo_scale_std=0.005, seed=2
        )
        path = str(tmp_path / "sim3.g2o")
        write_g2o(path, data)
        back = read_g2o(path)
        assert back.sqrt_info.shape[-1] == 7
        # geometry round-trips (vertices stored body-to-world in the file)
        np.testing.assert_allclose(back.T_init, data.T_init, atol=1e-6)
        np.testing.assert_allclose(back.T_meas, data.T_meas, atol=1e-6)
        info0 = np.einsum("eij,eik->ejk", data.sqrt_info, data.sqrt_info)
        info1 = np.einsum("eij,eik->ejk", back.sqrt_info, back.sqrt_info)
        np.testing.assert_allclose(info1, info0, atol=1e-4)
        # pose_graph auto-routes 7-dof data to the sim3 builder and solves
        g = build.pose_graph(back, dtype=jnp.float64)
        g2, info = solve(g, Options(method="lm", max_iters=50))
        scales = np.asarray(sim3.scale(g2.blocks["poses"].values))
        assert float(info.chi2) < float(g.chi2()) * 1e-2
        assert scales.max() < 1.6  # drift corrected after loading from file
