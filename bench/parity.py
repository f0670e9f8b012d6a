"""Dataset swap-in parity harness (VERDICT r2 next #8).

The canonical datasets (sphere2500.g2o, M3500.g2o, BAL problem files) are
not on disk and there is no network (SURVEY.md §0) — but the io readers
speak the real formats.  The day files appear, exact-reference parity is
one command:

    python bench/parity.py <dir> [--out bench/parity_results.jsonl]

For every ``*.g2o`` in <dir>: load (SE2 or SE3), solve with the pySLAM-CPU
architectural stand-in (per-block python + scipy spsolve, f64) AND with the
auto-dispatched device solver, and emit a parity row (chi2s, walls,
speedup, parity gate at 1%).

For every BAL file (``problem-*.txt`` / ``*.bal``): load, solve with the
device Schur path, and report converged chi2 against the half-pixel-residual
expectation (the stand-in's stereo BA model does not speak BAL's radial
camera, so BAL rows carry the device result + a cost-decrease gate only).

Self-test (no datasets needed): ``--selftest`` writes synthetic
sphere/manhattan g2o files and a synthetic BAL file to a temp dir through
the io WRITERS, then runs the full harness on them — proving the swap-in
path end-to-end today.  tests/test_g2o.py covers reader round-trips.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _parity_g2o(path):
    import jax

    from pyslam_standin import solve_pose_graph_standin
    from pyslam_tpu.graph import build
    from pyslam_tpu.io import g2o
    from pyslam_tpu.solver import Options, route_auto, solve_auto

    data = g2o.read_g2o(path)
    if getattr(data, "obs_type", None) is not None:
        return _parity_landmark_g2o(path, data)
    n = len(data.T_init)
    _, chi2_b, iters_b, wall_b, _ = solve_pose_graph_standin(
        data, max_iters=50 if n <= 1000 else 30
    )
    g = build.pose_graph(data)
    # stiff 2D graphs need exact solves; solve_auto
    # routes by structure, matching the recorded bench configurations
    opts = Options(
        method="gn" if data.dim == 2 else "lm",
        max_iters=30,
        min_cost_decrease=0.999,
    )

    def run():
        s, info = solve_auto(g, opts)
        jax.block_until_ready(s.blocks[next(iter(s.blocks))].values)
        return info

    run()  # compile
    t0 = time.perf_counter()
    info = run()
    wall = time.perf_counter() - t0
    chi2 = float(info.chi2)
    return dict(
        file=os.path.basename(path),
        kind=f"g2o_se{data.dim}",
        n_poses=n,
        route=route_auto(g),
        chi2=chi2,
        baseline_chi2=chi2_b,
        wall_s=wall,
        baseline_wall_s=wall_b,
        speedup=wall_b / wall if wall else None,
        parity=chi2 <= chi2_b * 1.01,
    )


def _parity_landmark_g2o(path, data):
    """2D landmark SLAM files (VERTEX_XY/EDGE_SE2_XY, Victoria-Park
    family): baseline is the independent scipy GN over the full
    pose+landmark system (tests/scipy_ref.py)."""
    import jax

    from pyslam_tpu.graph import build
    from pyslam_tpu.solver import Options, route_auto, solve_auto

    sys.path.insert(
        0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests")
    )
    import scipy_ref

    n = len(data.T_init)
    t0 = time.perf_counter()
    _, _, chi2_b, _ = scipy_ref.solve_landmark_slam_2d(
        data, max_iters=25 if n <= 1000 else 15
    )
    wall_b = time.perf_counter() - t0
    g = build.landmark_slam_2d(data)
    opts = Options(method="lm", max_iters=30)

    def run():
        s, info = solve_auto(g, opts)
        jax.block_until_ready(s.blocks["poses"].values)
        return info

    run()
    t0 = time.perf_counter()
    info = run()
    wall = time.perf_counter() - t0
    chi2 = float(info.chi2)
    return dict(
        file=os.path.basename(path),
        kind="g2o_landmark_se2",
        n_poses=n,
        n_landmarks=len(data.lm_init),
        n_obs=len(data.obs),
        route=route_auto(g),
        chi2=chi2,
        baseline_chi2=float(chi2_b),
        wall_s=wall,
        baseline_wall_s=wall_b,
        speedup=wall_b / wall if wall else None,
        parity=bool(chi2 <= float(chi2_b) * 1.01),
    )


def _parity_bal(path):
    import jax

    from pyslam_tpu.graph import build
    from pyslam_tpu.io import bal
    from pyslam_tpu.solver import Options, solve_auto

    data = bal.read_bal(path)
    g = build.bal_graph(data)
    chi2_0 = float(g.chi2())
    opts = Options(method="lm", max_iters=25)

    def run():
        s, info = solve_auto(g, opts)
        jax.block_until_ready(s.blocks[next(iter(s.blocks))].values)
        return info

    run()
    t0 = time.perf_counter()
    info = run()
    wall = time.perf_counter() - t0
    chi2 = float(info.chi2) if hasattr(info, "chi2") else float(info[-1])
    return dict(
        file=os.path.basename(path),
        kind="bal",
        n_cams=len(data.T),
        n_pts=len(data.pts),
        n_obs=len(data.cam_idx),
        chi2=chi2,
        chi2_initial=chi2_0,
        wall_s=wall,
        parity=chi2 < chi2_0,
    )


def run_dir(directory, out=None):
    rows = []
    g2o_files = sorted(glob.glob(os.path.join(directory, "*.g2o")))
    bal_files = sorted(
        glob.glob(os.path.join(directory, "problem-*.txt"))
        + glob.glob(os.path.join(directory, "*.bal"))
    )
    if not g2o_files and not bal_files:
        print(f"no *.g2o or BAL files found in {directory}", file=sys.stderr)
        return rows
    for p in g2o_files:
        rows.append(_parity_g2o(p))
        print(json.dumps(rows[-1]), flush=True)
    for p in bal_files:
        rows.append(_parity_bal(p))
        print(json.dumps(rows[-1]), flush=True)
    if out:
        with open(out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    assert all(r["parity"] for r in rows), "PARITY FAILURE — see rows above"
    return rows


def selftest(tmpdir):
    """Write synthetic datasets through the io writers, then run the
    harness on the files — the full swap-in path, minus only the files."""
    from pyslam_tpu.io import bal, g2o, synth

    os.makedirs(tmpdir, exist_ok=True)
    g2o.write_g2o(
        os.path.join(tmpdir, "manhattan_mini.g2o"),
        synth.se2_manhattan(n_poses=600, seed=4),
    )
    g2o.write_g2o(
        os.path.join(tmpdir, "sphere_mini.g2o"),
        synth.se3_sphere(n_poses=400, seed=2),
    )
    g2o.write_g2o_landmarks(
        os.path.join(tmpdir, "landmark_mini.g2o"),
        synth.landmark_slam_2d(n_poses=80, n_landmarks=40, obs_type="xy", seed=6),
    )
    bal.write_bal(
        os.path.join(tmpdir, "problem-8-64-mini.txt"),
        bal.perturbed(bal.synthetic_bal(n_cams=8, n_pts=64, seed=3)),
    )
    return run_dir(tmpdir)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("directory", nargs="?", help="dir with *.g2o / BAL files")
    ap.add_argument("--out", default=None)
    ap.add_argument("--selftest", action="store_true")
    args = ap.parse_args()

    import jax

    from pyslam_tpu.utils import enable_compile_cache

    enable_compile_cache()
    if args.selftest:
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            rows = selftest(td)
        print(f"selftest OK: {len(rows)} datasets, all parity gates passed")
        return
    if not args.directory:
        print("usage: python bench/parity.py <dir> | --selftest", file=sys.stderr)
        sys.exit(2)
    run_dir(args.directory, args.out)


if __name__ == "__main__":
    main()
