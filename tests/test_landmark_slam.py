"""2D landmark SLAM (Victoria-Park model family; g2o VERTEX_XY/EDGE_SE2_XY).

Covers: bearing-range and relative-position kernel Jacobians vs jax.jacfwd,
bearing wrap-around at the +/-pi boundary, end-to-end solves vs the
independent scipy GN (tests/scipy_ref.py — different algorithms, shared
math only), 2-dof landmarks through the dof-generic Schur routing, and the
g2o landmark-record round-trip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyslam_tpu.graph import build
from pyslam_tpu.graph.core import FACTOR_KERNELS
from pyslam_tpu.io import g2o, synth
from pyslam_tpu.lie import se2
from pyslam_tpu.solver import Options, route_auto, solve_auto

from scipy_ref import solve_landmark_slam_2d


def _rand_poses_landmarks(rng, F):
    T = se2.exp(jnp.asarray(rng.normal(0, 0.5, (F, 3))))
    # keep landmarks away from the observing origin (bearing/range smooth)
    l = jnp.asarray(rng.normal(0, 3.0, (F, 2)))
    body = jax.vmap(se2.act)(T, l)
    far = jnp.linalg.norm(body, axis=1) > 0.5
    l = jnp.where(far[:, None], l, l + 5.0)
    return T, l


@pytest.mark.parametrize("kind", ["landmark_xy_se2", "bearing_range_se2"])
def test_jacobians_vs_autodiff(rng, kind):
    kern = FACTOR_KERNELS[kind]
    F = 7
    T, l = _rand_poses_landmarks(rng, F)
    body = jax.vmap(se2.act)(T, l)
    if kind == "bearing_range_se2":
        obs = jnp.stack(
            [jnp.arctan2(body[:, 1], body[:, 0]), jnp.linalg.norm(body, axis=1)],
            axis=1,
        ) + jnp.asarray(rng.normal(0, 0.05, (F, 2)))
    else:
        obs = body + jnp.asarray(rng.normal(0, 0.1, (F, 2)))
    A = rng.normal(0, 1, (F, 2, 2))
    sqrt_info = jnp.asarray(A @ np.swapaxes(A, 1, 2) + 2 * np.eye(2))
    data = dict(obs=obs, sqrt_info=sqrt_info)

    r, (J_T, J_l) = kern(data, T, l, compute_jacobians=True)
    assert r.shape == (F, 2) and J_T.shape == (F, 2, 3) and J_l.shape == (F, 2, 2)

    def r_of(eps, dl, i):
        Ti = se2.exp(eps[None])[0] @ T[i]
        ri, _ = kern(
            jax.tree_util.tree_map(lambda a: a[i : i + 1], data),
            Ti[None],
            l[i : i + 1] + dl[None],
            compute_jacobians=False,
        )
        return ri[0]

    for i in range(F):
        z3, z2 = jnp.zeros(3), jnp.zeros(2)
        J_T_ad = jax.jacfwd(lambda e: r_of(e, z2, i))(z3)
        J_l_ad = jax.jacfwd(lambda d: r_of(z3, d, i))(z2)
        np.testing.assert_allclose(J_T[i], J_T_ad, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(J_l[i], J_l_ad, rtol=1e-6, atol=1e-8)


def test_bearing_wrap_boundary():
    """A bearing observed at +pi-0.01 predicted at -pi+0.01 must produce a
    0.02 rad residual, not ~2 pi."""
    kern = FACTOR_KERNELS["bearing_range_se2"]
    T = jnp.eye(3, dtype=jnp.float64)[None]
    ang = np.pi - 0.01
    l = jnp.asarray([[2.0 * np.cos(-ang), 2.0 * np.sin(-ang)]])  # pred ~ -pi+0.01
    data = dict(
        obs=jnp.asarray([[np.pi - 0.01, 2.0]]),
        sqrt_info=jnp.broadcast_to(jnp.eye(2, dtype=jnp.float64), (1, 2, 2)),
    )
    r, _ = kern(data, T, l, compute_jacobians=False)
    assert abs(float(r[0, 0])) < 0.03
    assert abs(float(r[0, 1])) < 1e-9


@pytest.mark.parametrize("obs_type", ["bearing_range", "xy"])
def test_solve_matches_scipy_reference(obs_type):
    data = synth.landmark_slam_2d(
        n_poses=40, n_landmarks=25, max_range=8.0, obs_type=obs_type, seed=3
    )
    g = build.landmark_slam_2d(data, dtype=jnp.float64)
    solved, info = solve_auto(g, Options(method="gn", max_iters=25))
    chi2_dev = float(info.chi2) if hasattr(info, "chi2") else float(info[-1])

    _, _, chi2_ref, _ = solve_landmark_slam_2d(data, max_iters=25)
    assert chi2_dev <= chi2_ref * (1 + 1e-6) + 1e-9

    # trajectory actually recovered: body-to-world positions near gt
    T_opt = np.asarray(solved.blocks["poses"].values)
    pos_opt = np.stack([np.linalg.inv(Tk)[:2, 2] for Tk in T_opt])
    pos_gt = np.stack([np.linalg.inv(Tk)[:2, 2] for Tk in data.T_gt])
    pos_init = np.stack([np.linalg.inv(Tk)[:2, 2] for Tk in data.T_init])
    ate_opt = np.sqrt(np.mean(np.sum((pos_opt - pos_gt) ** 2, axis=1)))
    ate_init = np.sqrt(np.mean(np.sum((pos_init - pos_gt) ** 2, axis=1)))
    assert ate_opt < 0.5 * ate_init


def test_routes_through_dof_generic_schur():
    data = synth.landmark_slam_2d(n_poses=30, n_landmarks=20, seed=1)
    g = build.landmark_slam_2d(data)
    assert route_auto(g) == "schur_dense"
    # landmark blocks are 2-dof: the schur_large / schur_sqrt / schur_cm
    # specializations must never capture this shape
    assert g.blocks["landmarks"].dof == 2
    assert g.blocks["poses"].dof == 3


def test_g2o_landmark_roundtrip(tmp_path):
    data = synth.landmark_slam_2d(n_poses=25, n_landmarks=15, obs_type="xy", seed=5)
    path = tmp_path / "lm2d.g2o"
    g2o.write_g2o_landmarks(path, data)
    back = g2o.read_g2o(path)
    assert back.obs_type == "xy"
    np.testing.assert_allclose(back.T_init, data.T_init, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(back.lm_init, data.lm_init, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(back.obs, data.obs, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(back.T_meas, data.T_meas, rtol=1e-6, atol=1e-7)
    # loaded graph solves to the same optimum as the original arrays
    g_orig = build.landmark_slam_2d(data, dtype=jnp.float64)
    g_back = build.landmark_slam_2d(back, dtype=jnp.float64)
    _, info_a = solve_auto(g_orig, Options(method="gn", max_iters=15))
    _, info_b = solve_auto(g_back, Options(method="gn", max_iters=15))
    chi_a = float(info_a.chi2) if hasattr(info_a, "chi2") else float(info_a[-1])
    chi_b = float(info_b.chi2) if hasattr(info_b, "chi2") else float(info_b[-1])
    np.testing.assert_allclose(chi_a, chi_b, rtol=1e-6)


def test_problem_api_wrappers():
    """Reference-style object API: the same landmark-SLAM problem through
    Problem.add_residual_block with the new residual wrappers equals the
    batched graph solve."""
    from pyslam_tpu import (
        SE2,
        BearingRangeResidual,
        Options as POptions,
        PoseToPoseResidual,
        Problem,
    )

    data = synth.landmark_slam_2d(
        n_poses=12, n_landmarks=8, max_range=8.0, obs_type="bearing_range", seed=7
    )
    problem = Problem(POptions(max_iters=20))
    params = {}
    for k in range(len(data.T_init)):
        params[f"T{k}"] = SE2(jnp.asarray(data.T_init[k], jnp.float64))
    for k in range(len(data.lm_init)):
        params[f"l{k}"] = jnp.asarray(data.lm_init[k], jnp.float64)
    for e in range(len(data.edges_i)):
        problem.add_residual_block(
            PoseToPoseResidual(
                jnp.asarray(data.T_meas[e], jnp.float64),
                jnp.asarray(data.sqrt_info[e], jnp.float64),
            ),
            [f"T{data.edges_i[e]}", f"T{data.edges_j[e]}"],
        )
    for m in range(len(data.obs_pose)):
        problem.add_residual_block(
            BearingRangeResidual(
                jnp.asarray(data.obs[m], jnp.float64),
                jnp.asarray(data.obs_sqrt_info[m], jnp.float64),
            ),
            [f"T{data.obs_pose[m]}", f"l{data.obs_lm[m]}"],
        )
    problem.initialize_params(params)
    problem.set_parameters_constant("T0")
    out = problem.solve()

    g = build.landmark_slam_2d(data, dtype=jnp.float64)
    _, info = solve_auto(g, Options(method="lm", max_iters=20))
    np.testing.assert_allclose(
        float(problem.eval_cost()), float(info.chi2), rtol=1e-6
    )


def test_problem_rejects_raw_pose_arrays():
    """A Lie pose passed as a raw array is inferred 'euclidean'; before the
    manifold validation this converged to silent garbage (non-rigid 'pose'
    matrices).  Both the Problem-level and assembly-level checks must fire."""
    from pyslam_tpu import BearingRangeResidual, Problem

    data = synth.landmark_slam_2d(n_poses=4, n_landmarks=3, max_range=8.0, seed=7)
    problem = Problem()
    problem.add_residual_block(
        BearingRangeResidual(jnp.asarray(data.obs[0]), jnp.asarray(data.obs_sqrt_info[0])),
        ["T0", "l0"],
    )
    problem.initialize_params(
        {"T0": jnp.asarray(data.T_init[0]), "l0": jnp.asarray(data.lm_init[0])}
    )
    with pytest.raises(ValueError, match="expects a 'se2' parameter"):
        problem.solve()


def test_gnc_rejects_wrong_associations():
    """Classic robust data association: corrupt a handful of observations'
    landmark associations; GNC must classify exactly those as outliers and
    recover near the clean accuracy."""
    from pyslam_tpu.solver import solve_gnc

    data = synth.landmark_slam_2d(
        n_poses=60, n_landmarks=40, max_range=10.0, obs_type="bearing_range", seed=11
    )
    rng = np.random.default_rng(0)
    M = len(data.obs_pose)
    bad = rng.choice(M, size=6, replace=False)
    obs_lm = np.array(data.obs_lm)
    L = int(obs_lm.max()) + 1
    for m in bad:
        obs_lm[m] = (obs_lm[m] + 1 + rng.integers(L - 1)) % L  # wrong landmark
    import dataclasses

    corrupted = dataclasses.replace(data, obs_lm=obs_lm)

    g = build.landmark_slam_2d(corrupted, dtype=jnp.float64)
    # batch 0 is the landmark-observation batch (build order)
    solved, info = solve_gnc(g, Options(method="lm", max_iters=10), robustify=[0])
    w = np.asarray(info.weights[0])
    flagged = set(np.flatnonzero(w < 0.5).tolist())
    assert set(bad.tolist()) <= flagged  # every planted outlier caught
    # false-rejection rate stays near the TLS confidence floor (measured:
    # 30 extra of 939 at 99% confidence — the 1% chi2 tail plus the bias
    # the corrupted landmarks leak into their other observations)
    assert len(flagged) <= 0.05 * len(data.obs_pose)

    pos = lambda T: np.stack([np.linalg.inv(Tk)[:2, 2] for Tk in np.asarray(T)])
    ate = np.sqrt(
        np.mean(np.sum((pos(solved.blocks["poses"].values) - pos(data.T_gt)) ** 2, 1))
    )
    g_clean = build.landmark_slam_2d(data, dtype=jnp.float64)
    clean, _ = solve_auto(g_clean, Options(method="lm", max_iters=15))
    ate_clean = np.sqrt(
        np.mean(np.sum((pos(clean.blocks["poses"].values) - pos(data.T_gt)) ** 2, 1))
    )
    assert ate < 3 * ate_clean + 0.05


def test_covariances_on_2dof_landmarks():
    """The selective-solve covariance machinery (solver/covariance.py) is
    dof-generic: pose/landmark marginals and cross blocks on a 2-dof
    landmark graph equal the dense inverse."""
    from pyslam_tpu.solver import full_covariance
    from pyslam_tpu.solver.covariance import (
        landmark_marginal_covariances,
        pose_covariance_block,
        pose_marginal_covariances,
    )

    data = synth.landmark_slam_2d(n_poses=15, n_landmarks=10, max_range=9.0, seed=2)
    g = build.landmark_slam_2d(data, dtype=jnp.float64)
    solved, _ = solve_auto(g, Options(method="gn", max_iters=20))
    Sig = np.asarray(full_covariance(solved))
    # canonical (sorted-name) layout: landmarks (10*2) first, then poses
    P = np.asarray(pose_marginal_covariances(solved))
    np.testing.assert_allclose(P[3], Sig[20 + 9 : 20 + 12, 20 + 9 : 20 + 12], rtol=1e-8)
    L = np.asarray(landmark_marginal_covariances(solved, np.arange(10)))
    np.testing.assert_allclose(L[4], Sig[8:10, 8:10], rtol=1e-8)
    B = np.asarray(pose_covariance_block(solved, 2, 5))
    np.testing.assert_allclose(B, Sig[20 + 6 : 20 + 9, 20 + 15 : 20 + 18], rtol=1e-8)


def test_landmark_xyz_se3_jacobians_and_solve():
    """3D relative-position landmark factor: Jacobians vs autodiff, and a
    tiny 3D landmark-SLAM graph (odometry + body-frame landmark positions)
    solved through the Schur routing to the noise floor."""
    from pyslam_tpu.graph.core import FactorBatch, FactorGraph, VariableBlock
    from pyslam_tpu.lie import se3
    from pyslam_tpu.losses import L2Loss

    rng = np.random.default_rng(9)
    kern = FACTOR_KERNELS["landmark_xyz_se3"]
    F = 6
    T = se3.exp(jnp.asarray(rng.normal(0, 0.4, (F, 6))))
    l = jnp.asarray(rng.normal(0, 2.0, (F, 3)))
    data = dict(
        obs=jnp.asarray(rng.normal(0, 2.0, (F, 3))),
        sqrt_info=jnp.asarray(np.tile(np.eye(3) * 5, (F, 1, 1))),
    )
    r, (J_T, J_l) = kern(data, T, l, compute_jacobians=True)

    def r_of(eps, dl, i):
        Ti = se3.exp(eps[None])[0] @ T[i]
        ri, _ = kern(
            jax.tree_util.tree_map(lambda a: a[i : i + 1], data),
            Ti[None], l[i : i + 1] + dl[None], compute_jacobians=False,
        )
        return ri[0]

    for i in range(F):
        z6, z3 = jnp.zeros(6), jnp.zeros(3)
        np.testing.assert_allclose(
            J_T[i], jax.jacfwd(lambda e: r_of(e, z3, i))(z6), rtol=1e-6, atol=1e-9
        )
        np.testing.assert_allclose(
            J_l[i], jax.jacfwd(lambda d: r_of(z6, d, i))(z3), rtol=1e-6, atol=1e-9
        )

    # tiny 3D landmark SLAM: 8 poses on a line, 12 landmarks, noisy obs
    n, L = 8, 12
    T_gt = np.stack([np.eye(4) for _ in range(n)])
    for k in range(n):
        T_gt[k][:3, 3] = [-0.5 * k, 0, 0]  # world-to-body: body at (0.5k,0,0)
    lm_gt = rng.uniform(-1, 1, (L, 3)) + np.array([2.0, 0, 0])
    oi = np.repeat(np.arange(n), L)
    oj = np.tile(np.arange(L), n)
    p_local = np.einsum("mij,mj->mi", T_gt[oi][:, :3, :3], lm_gt[oj]) + T_gt[oi][:, :3, 3]
    obs = p_local + rng.normal(0, 0.01, p_local.shape)
    blocks = {
        "poses": VariableBlock.create(
            "se3",
            jnp.asarray(T_gt + rng.normal(0, 0.0, T_gt.shape), jnp.float64),
            np.eye(n, dtype=bool)[0],
        ),
        "landmarks": VariableBlock.create(
            "euclidean", jnp.asarray(lm_gt + rng.normal(0, 0.2, lm_gt.shape), jnp.float64)
        ),
    }
    batch = FactorBatch.create(
        "landmark_xyz_se3", ("poses", "landmarks"), (oi, oj),
        {"obs": jnp.asarray(obs, jnp.float64),
         "sqrt_info": jnp.asarray(np.tile(np.eye(3) * 100, (len(oi), 1, 1)), jnp.float64)},
        L2Loss(),
    )
    g = FactorGraph(blocks, [batch])
    solved, info = solve_auto(g, Options(method="lm", max_iters=15))
    # noise floor: E[chi2] ~ 0.5 * residual count
    assert float(info.chi2) < 0.75 * len(oi) * 3
    lm_err = np.abs(np.asarray(solved.blocks["landmarks"].values) - lm_gt).max()
    assert lm_err < 0.02
