"""solve_auto dispatch: the system, not the user,
picks the linear-algebra path AND the sharding strategy.  route_auto is
tested over a graph-shape x mesh-size grid; solve_auto(mesh=...) and
Problem.solve(mesh=...) are driven end-to-end on the 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyslam_tpu.dist import make_mesh
from pyslam_tpu.graph import build
from pyslam_tpu.io import synth
from pyslam_tpu.solver import Options, route_auto, solve_auto


def pose_graph(n=40, dtype=jnp.float64):
    return build.pose_graph(synth.se2_loop(n_poses=n, n_loops=6, seed=3), dtype=dtype)


def ba_graph(dtype=jnp.float64):
    return build.ba_graph(
        synth.ba_synthetic(n_cams=6, n_pts=40, obs_per_pt=4, seed=8), dtype=dtype
    )


class _FakeBatch:
    """Shape-only stand-in so routing thresholds can be tested at Venice /
    pod scale without materializing the graphs."""

    def __init__(self, slots, n):
        self.slots = slots
        self.n = n


class _FakeBlock:
    def __init__(self, kind, n, dof, itemsize=4):
        self.kind = kind
        self.n = n
        self.dof = dof
        self.values = np.zeros((), dtype=np.float32 if itemsize == 4 else np.float64)


class _FakeGraph:
    def __init__(self, blocks, batches):
        self.blocks = blocks
        self.batches = batches

    @property
    def total_dof(self):
        return sum(b.n * b.dof for b in self.blocks.values())


# what JAX reports as one 80 GB H100's bytes_limit (three quarters of it)
H100_BYTES_LIMIT = 60 << 30


def fake_pose_graph(n_poses, d=6, n_edges=None):
    blocks = {"poses": _FakeBlock("se3" if d == 6 else "se2", n_poses, d)}
    batches = [_FakeBatch(("poses", "poses"), n_edges or int(n_poses * 1.5))]
    return _FakeGraph(blocks, batches)


def fake_ba_graph(n_cams, n_pts, n_obs):
    blocks = {
        "poses": _FakeBlock("se3", n_cams, 6),
        "landmarks": _FakeBlock("euclidean", n_pts, 3),
    }
    batches = [_FakeBatch(("poses", "landmarks"), n_obs)]
    return _FakeGraph(blocks, batches)


class TestRouteSingleChip:
    def test_small_pose_graph_dense(self):
        assert route_auto(fake_pose_graph(200)) == "dense"

    def test_large_pose_graph_ell(self):
        assert route_auto(fake_pose_graph(50_000)) == "ell"

    def test_small_ba_dense_schur(self):
        assert route_auto(fake_ba_graph(49, 7_000, 30_000)) == "schur_dense"

    def test_many_camera_ba_pcg(self):
        assert route_auto(fake_ba_graph(5_000, 100_000, 500_000)) == "schur_pcg"

    def test_dubrovnik_class_hpl_gate_pcg(self):
        # few cameras, huge landmark count: dense-S Hpl would OOM
        assert route_auto(fake_ba_graph(300, 3_000_000, 1_500_000)) == "schur_pcg"

    def test_venice_class_schur_large(self):
        assert route_auto(fake_ba_graph(1_700, 1_000_000, 4_650_000)) == "schur_large"


class TestRouteMesh:
    def setup_method(self):
        self.mesh = make_mesh(8, axis_name="x")

    def test_tiny_pose_graph_factor_parallel(self):
        assert route_auto(fake_pose_graph(100), mesh=self.mesh) == "factor_parallel"

    def test_midsize_pose_graph_replicated_ell(self):
        # fits one device comfortably: replicated single-device ELL beats
        # shard_map overhead
        assert route_auto(fake_pose_graph(50_000), mesh=self.mesh) == "ell"

    def test_huge_pose_graph_pose_sharded(self):
        # 50M poses * K=17 * (6, 6) f32 blocks = 122 GB of logical ELL bytes:
        # more than one H100 holds
        g = fake_pose_graph(50_000_000, n_edges=200_000_000)
        assert (
            route_auto(g, mesh=self.mesh, device_hbm_budget_bytes=H100_BYTES_LIMIT)
            == "pose_sharded"
        )

    def test_ba_schur_reduce(self):
        # 600k obs / 8 devices = 75k obs/device: below the component-major
        # speed crossover (250k), block layout is used
        assert route_auto(fake_ba_graph(300, 120_000, 600_000), mesh=self.mesh) == "schur_reduce"

    def test_ba_speed_crossover_schur_cm(self):
        # Venice/8 = 581k obs/device > 250k crossover: component-major is
        # chosen even though the block layout would still fit in memory
        assert route_auto(fake_ba_graph(1_700, 1_000_000, 4_650_000), mesh=self.mesh) == "schur_cm"

    def test_ba_beyond_slab_budget_schur_cm(self):
        g = fake_ba_graph(20_000, 20_000_000, 90_000_000)
        assert route_auto(g, mesh=self.mesh) == "schur_cm"

    def test_single_device_mesh_never_shards(self):
        m1 = make_mesh(1, axis_name="x")
        assert route_auto(fake_pose_graph(50_000), mesh=m1) == "ell"
        assert route_auto(fake_ba_graph(49, 7_000, 30_000), mesh=m1) == "schur_dense"

    def _fake_vio_graph(self, n_kf):
        # 3-block VIO shape: se3 poses + euclidean velocities + biases
        blocks = {
            "poses": _FakeBlock("se3", n_kf, 6),
            "vels": _FakeBlock("euclidean", n_kf, 3),
            "biases": _FakeBlock("euclidean", n_kf, 6),
        }
        batches = [
            _FakeBatch(("poses", "poses", "vels", "vels", "biases"), n_kf - 1),
            _FakeBatch(("biases", "biases"), n_kf - 1),
            _FakeBatch(("poses",), n_kf),
        ]
        return _FakeGraph(blocks, batches)

    def test_multiblock_midsize_routes_factor_parallel(self):
        # factor_parallel is DP over residual blocks —
        # block-structure-agnostic — so 3+-block graphs shard through it
        # up to the dense-solve ceiling (total_dof 15*500 = 7500 < 12000)
        assert (
            route_auto(self._fake_vio_graph(500), mesh=self.mesh)
            == "factor_parallel"
        )

    def test_multiblock_beyond_dense_ceiling_warns(self):
        # beyond the replicated-dense-solve ceiling no sharded path speaks
        # 3+-block structure: must WARN, never silently solve replicated
        g = self._fake_vio_graph(2_000)  # total_dof 30k > 12k
        with pytest.warns(UserWarning, match="multi-block"):
            assert route_auto(g, mesh=self.mesh) == "_single"


class TestSolveAutoMesh:
    def test_tiny_pose_graph_end_to_end(self):
        g = pose_graph(40)
        mesh = make_mesh(8, axis_name="f")
        solved, hist = solve_auto(g, Options(method="lm", max_iters=20), mesh=mesh)
        _, info_ref = solve_auto(g, Options(method="lm", max_iters=20))
        assert abs(float(hist[-1]) - float(info_ref.chi2)) / float(info_ref.chi2) < 1e-5

    def test_ba_routes_schur_reduce_end_to_end(self):
        g = ba_graph()
        mesh = make_mesh(8, axis_name="l")
        # force the sharded route despite the small size by shrinking the
        # budget: exercises the schur_reduce dispatch wiring end to end
        from pyslam_tpu.solver import route_auto as ra

        assert ra(g, mesh=mesh) == "schur_reduce"
        solved, hist = solve_auto(g, Options(method="lm", max_iters=15), mesh=mesh)
        assert float(hist[-1]) < float(g.chi2())

    def test_vio_multiblock_end_to_end(self):
        # a real 3-block (pose+velocity+bias) VIO graph routed through
        # factor_parallel on the 8-device mesh == the single-device solve
        import pyslam_tpu.imu as M
        from pyslam_tpu.solver import route_auto as ra

        d = synth.imu_circle(n_keyframes=8, kf_dt=0.5, imu_rate=100, seed=0)
        rng = np.random.default_rng(1)
        T_prior = np.stack(
            [
                np.asarray(
                    __import__("pyslam_tpu.lie.se3", fromlist=["exp"]).exp(
                        jnp.asarray(rng.normal(size=6) * 2e-3)
                    )
                )
                @ d.T_gt[i]
                for i in range(8)
            ]
        )
        Spp = np.diag([1 / 2e-3] * 6)
        g = M.vio_graph(
            d, T_prior, Spp, T_init=T_prior,
            v_init=np.zeros((8, 3)), b_init=np.zeros((8, 6)),
        )
        mesh = make_mesh(8, axis_name="f")
        assert ra(g, mesh=mesh) == "factor_parallel"
        opts = Options(method="lm", max_iters=40)
        solved, hist = solve_auto(g, opts, mesh=mesh)
        _, info_ref = solve_auto(g, opts)
        np.testing.assert_allclose(
            float(hist[-1]), float(info_ref.chi2), rtol=1e-6
        )

    def test_problem_solve_with_mesh(self):
        from pyslam_tpu import Problem, PoseToPoseResidual, SE2

        data = synth.se2_loop(n_poses=12, n_loops=3, seed=4)
        names = [f"T_{i}" for i in range(12)]
        prob = Problem(Options(method="lm", max_iters=20))
        for k in range(len(data.edges_i)):
            i, j = int(data.edges_i[k]), int(data.edges_j[k])
            prob.add_residual_block(
                PoseToPoseResidual(data.T_meas[k], data.sqrt_info[k]),
                [names[i], names[j]],
            )
        prob.initialize_params(
            {n: SE2(jnp.asarray(T, jnp.float64)) for n, T in zip(names, data.T_init)}
        )
        prob.set_parameters_constant(names[0])
        mesh = make_mesh(8, axis_name="f")
        prob.solve(mesh=mesh)
        cost_sharded = prob.eval_cost()
        prob2 = Problem(Options(method="lm", max_iters=20))
        prob2.residual_blocks = prob.residual_blocks
        prob2.initialize_params(
            {n: SE2(jnp.asarray(T, jnp.float64)) for n, T in zip(names, data.T_init)}
        )
        prob2.set_parameters_constant(names[0])
        prob2.solve()
        np.testing.assert_allclose(cost_sharded, prob2.eval_cost(), rtol=1e-5)


class TestConditioningRoute:
    """f32 mono low-parallax BA graphs must route to the square-root (QR)
    elimination; everywhere else the normal-equation Schur paths are
    used."""

    def _mono(self, cam_cluster):
        from pyslam_tpu.io import bal

        return build.bal_graph(
            bal.perturbed(
                bal.synthetic_bal(n_cams=6, n_pts=50, seed=0, cam_cluster=cam_cluster)
            ),
            dtype=jnp.float32,
        )

    def test_clustered_mono_routes_sqrt(self):
        assert route_auto(self._mono(cam_cluster=0.05)) == "schur_sqrt"

    def test_ring_mono_routes_normal_schur(self):
        assert route_auto(self._mono(cam_cluster=None)) == "schur_dense"

    def test_stereo_never_routes_sqrt(self):
        # stereo observations carry depth: conditioning never bites
        g = build.ba_graph(
            synth.ba_synthetic(n_cams=6, n_pts=40, obs_per_pt=4, seed=8,
                               cam_cluster=0.05),
            dtype=jnp.float32,
        )
        assert route_auto(g) in ("schur_dense", "schur_pcg")

    def test_f64_never_routes_sqrt(self):
        from pyslam_tpu.io import bal

        g = build.bal_graph(
            bal.perturbed(
                bal.synthetic_bal(n_cams=6, n_pts=50, seed=0, cam_cluster=0.05)
            ),
            dtype=jnp.float64,
        )
        assert route_auto(g) == "schur_dense"

    def test_sqrt_route_solves_end_to_end(self):
        g = self._mono(cam_cluster=0.05)
        solved, info = solve_auto(g, Options(method="lm", max_iters=10))
        assert float(info.chi2) < float(g.chi2())


class TestSparseCholRoute:
    def test_large_2d_graph_routes_sparse_chol(self):
        # beyond the dense ceiling, stiff 2D graphs get the exact
        # multifrontal path (PCG stalls in a worse basin there)
        g = fake_pose_graph(20_000, d=3)
        assert route_auto(g) == "sparse_chol"

    def test_large_3d_graph_keeps_ell(self):
        assert route_auto(fake_pose_graph(50_000, d=6)) == "ell"

    def test_sparse_chol_route_end_to_end(self):
        # a real (small-but-forced) dispatch: shrink the dense limit
        data = synth.se2_loop(n_poses=60, n_loops=8, seed=1)
        g = build.pose_graph(data, dtype=jnp.float64)
        assert route_auto(g, dense_dof_limit=100) == "sparse_chol"
        solved, info = solve_auto(
            g, Options(method="lm", max_iters=20), dense_dof_limit=100
        )
        _, info_ref = solve_auto(g, Options(method="lm", max_iters=20))
        np.testing.assert_allclose(float(info.chi2), float(info_ref.chi2), rtol=1e-8)


class TestBal9Routes:
    def test_small_bal9_routes_schur_dense_and_solves(self):
        from pyslam_tpu.io import bal

        data = bal.perturbed(bal.synthetic_bal(n_cams=6, n_pts=60, seed=2))
        g = build.bal_graph(data, dtype=jnp.float64, optimize_intrinsics=True)
        assert route_auto(g) == "schur_dense"
        solved, info = solve_auto(g, Options(method="lm", max_iters=25))
        assert float(info.chi2) < float(g.chi2()) * 0.01

    def test_mesh_bal9_never_routes_schur_cm(self):
        # schur_cm hardcodes (6, 3)-dof blocks; a 9-dof camera graph over
        # a mesh must stay on the dof-generic schur_reduce even when the
        # per-device slab exceeds the budget
        from pyslam_tpu.dist import make_mesh
        from pyslam_tpu.io import bal

        data = bal.perturbed(bal.synthetic_bal(n_cams=6, n_pts=60, seed=2))
        g = build.bal_graph(data, dtype=jnp.float32, optimize_intrinsics=True)
        mesh = make_mesh(8)
        assert route_auto(g, mesh=mesh, device_hbm_budget_bytes=1) == "schur_reduce"


class TestMemoryModel:
    """Memory gates count logical bytes against the device's own limit."""

    def setup_method(self):
        self.mesh = make_mesh(8, axis_name="x")

    def test_cpu_device_reports_no_limit(self):
        from pyslam_tpu.solver import device_memory_budget

        assert device_memory_budget(self.mesh) is None
        assert device_memory_budget() is None

    @pytest.mark.parametrize(
        "n_poses,budget,expected",
        [
            # 1.5M poses, K=17: 1.5M * 17 * 144 B = 3.67 GB of logical bytes.
            # The old (8, 128)-tile model counted 104 GB and sharded it.
            (1_500_000, H100_BYTES_LIMIT, "ell"),
            (1_500_000, 3 << 30, "pose_sharded"),
            # no limit reported (the CPU): no memory gate at any size
            (50_000_000, None, "ell"),
        ],
    )
    def test_pose_graph_logical_bytes(self, n_poses, budget, expected):
        g = fake_pose_graph(n_poses, n_edges=4 * n_poses)
        assert route_auto(g, mesh=self.mesh, device_hbm_budget_bytes=budget) == expected

    def test_ba_slab_logical_bytes(self):
        # 1.6M obs/device at (18 + 36 + 9) * 4 B = 403 MB of slab: a budget
        # just below it forces the component-major layout, just above keeps
        # the block layout (crossover raised out of the way)
        g = fake_ba_graph(300, 1_000_000, 8 * 1_600_000)
        slab = 1_600_000 * (18 + 36 + 9) * 4
        kw = dict(mesh=self.mesh, cm_obs_crossover=10**9)
        assert route_auto(g, device_hbm_budget_bytes=slab - 1, **kw) == "schur_cm"
        assert route_auto(g, device_hbm_budget_bytes=slab, **kw) == "schur_reduce"
        assert route_auto(g, device_hbm_budget_bytes=None, **kw) == "schur_reduce"
