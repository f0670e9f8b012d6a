"""chip_smoke.py on the CPU: its device check refuses the CPU, and its phase
functions pass their own gates at tiny sizes against float64 solves."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from pyslam_tpu.dist import make_mesh, solve_schur_sharded  # noqa: E402
from pyslam_tpu.graph import build  # noqa: E402
from pyslam_tpu.io import synth  # noqa: E402
from pyslam_tpu.solver import Options, solve_auto  # noqa: E402


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_phase_precision_tiny():
    err_ell, err_mm = chip_smoke.phase_precision(n_poses=40, n=64)
    assert err_ell <= chip_smoke.PRECISION_RTOL
    assert err_mm <= chip_smoke.PRECISION_RTOL


def _f64_chi2(graph, options):
    _, info = solve_auto(graph, options)
    return float(info.chi2)


def test_phase_pose_graph_se3_tiny():
    data = synth.se3_sphere(n_poses=60, seed=0)
    ref = _f64_chi2(
        build.pose_graph(data, dtype=jnp.float64),
        Options(method="lm", max_iters=30, min_cost_decrease=0.999),
    )
    chi2 = chip_smoke.phase_pose_graph_se3(ref, n_poses=60, dense_dof_limit=100)
    assert chi2 <= ref * 1.01


def test_phase_pose_graph_se2_dense_tiny():
    # same data as the phase builds: the g2o round trip, then float64
    import tempfile

    from pyslam_tpu.io import g2o

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "m.g2o")
        g2o.write_g2o(path, synth.se2_manhattan(n_poses=50, seed=1))
        data = g2o.read_g2o(path)
    ref = _f64_chi2(
        build.pose_graph(data, dtype=jnp.float64),
        Options(method="gn", max_iters=30, min_cost_decrease=0.999),
    )
    assert chip_smoke.phase_pose_graph_se2_dense(ref, n_poses=50) <= ref * 1.01


def test_phase_ba_ladybug_tiny():
    data = synth.ba_synthetic(n_cams=4, n_pts=60, seed=0)
    ref = _f64_chi2(build.ba_graph(data, dtype=jnp.float64), Options(method="lm", max_iters=25))
    assert chip_smoke.phase_ba_ladybug(ref, n_cams=4, n_pts=60) <= ref * 1.01


def test_phase_ba_venice_mini_tiny():
    data = synth.ba_synthetic(n_cams=4, n_pts=60, obs_per_pt=6, seed=0)
    _, ref, _ = solve_schur_sharded(
        build.ba_graph(data, dtype=jnp.float64), make_mesh(1, axis_name="l"),
        Options(method="lm", max_iters=15),
    )
    chi2 = chip_smoke.phase_ba_venice_mini(float(ref), n_cams=4, n_pts=60)
    assert chi2 <= float(ref) * 1.001


def test_phase_cards_on_four_cpu_devices():
    assert len(jax.devices()) >= 4
    chip_smoke.phase_cards(4, n_cams=4, n_pts=80, obs_per_pt=4, n_poses=40)


def test_phase_gate_raises():
    with pytest.raises(chip_smoke.PhaseFailed):
        chip_smoke.gate("x", "r", 2.0, 1.0, 1.01, 1, 0.0)
    with pytest.raises(chip_smoke.PhaseFailed):
        chip_smoke.gate("x", "r", float("nan"), 1.0, 1.01, 1, 0.0)
