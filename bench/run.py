"""Full benchmark harness: the BASELINE.json configs (BASELINE.md) and the
later ones, each solved on the device with chi2-parity checks against the
pySLAM-CPU architectural stand-in or a converged reference.

Usage:  python bench/run.py [--configs 1,2,3,4,5] [--out bench/results.jsonl]

Emits one JSON line per config (also appended to --out, git-ignored):
  {"config": ..., "wall_s": ..., "iters": ..., "it_per_s": ...,
   "chi2": ..., "baseline_wall_s": ..., "speedup": ..., "parity": ...,
   "device": ..., "device_kind": ..., "n_devices": ..., "gpu": ...}

chi2 parity is the only gate.  Exits non-zero without a GPU unless
JAX_PLATFORMS=cpu is set (bench/device.py).  The headline metric stays in
bench.py (config #3 only).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "standin_cache.json")


def _cache():
    if os.path.exists(CACHE):
        with open(CACHE) as f:
            return json.load(f)
    return {}


def _cache_put(key, value):
    c = _cache()
    c[key] = value
    with open(CACHE, "w") as f:
        json.dump(c, f)


def _timed(run):
    """Warm wall time of ``run``: one call to compile, one timed.  Each run
    ends in ``jax.block_until_ready`` on the solve's outputs; every solve
    below is one program (or ends in a host readback), so that waits for
    all of its device work."""
    import jax

    jax.block_until_ready(run())  # compile
    t0 = time.perf_counter()
    out = jax.block_until_ready(run())
    return out, time.perf_counter() - t0


def config_1():
    """Small SE(2) loop + Cauchy robust cost (the reference's native scale)."""
    import jax.numpy as jnp

    from pyslam_standin import solve_pose_graph_standin
    from pyslam_tpu.graph import build
    from pyslam_tpu.io import synth
    from pyslam_tpu.losses import CauchyLoss
    from pyslam_tpu.solver import Options, solve

    data = synth.se2_loop(n_poses=100, n_loops=12, seed=0)
    key = "se2_loop_100"
    base = _cache().get(key)
    if base is None:
        _, chi2_b, _, wall_b, _ = solve_pose_graph_standin(data, max_iters=50)
        base = {"chi2": chi2_b, "wall_s": wall_b}
        _cache_put(key, base)
    g = build.pose_graph(data, loss=CauchyLoss(2.0))
    opts = Options(method="lm", max_iters=50)

    def run():
        s, info = solve(g, opts)
        return info

    info, wall = _timed(run)
    # robust cost != L2 chi2; parity is checked on the non-robust L2 graph
    g2 = build.pose_graph(data)
    s2, info2 = solve(g2, opts)
    return dict(
        config="1_se2_loop_cauchy",
        wall_s=wall,
        iters=int(info.iterations),
        chi2=float(info2.chi2),
        baseline_wall_s=base["wall_s"],
        baseline_chi2=base["chi2"],
        parity=float(info2.chi2) <= base["chi2"] * 1.01,
        speedup=base["wall_s"] / wall,
    )


def config_2():
    """M3500-class Manhattan SE(2) graph through the g2o I/O path."""
    import tempfile

    import jax

    from pyslam_standin import solve_pose_graph_standin
    from pyslam_tpu.graph import build
    from pyslam_tpu.io import g2o, synth
    from pyslam_tpu.solver import Options, solve

    data0 = synth.se2_manhattan(n_poses=3500, seed=1)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "m3500.g2o")
        g2o.write_g2o(path, data0)
        data = g2o.read_g2o(path)  # exercise the full g2o round trip
    key = "se2_manhattan_3500"
    base = _cache().get(key)
    if base is None:
        _, chi2_b, _, wall_b, _ = solve_pose_graph_standin(data, max_iters=30)
        base = {"chi2": chi2_b, "wall_s": wall_b}
        _cache_put(key, base)
    g = build.pose_graph(data)
    # exact GN solves matter on this stiff graph (inexact PCG converges to a
    # worse basin, 668 vs 622); D = 10497 dense Cholesky
    opts = Options(method="gn", max_iters=30, min_cost_decrease=0.999)

    def run():
        s, info = solve(g, opts)
        return info

    info, wall = _timed(run)
    chi2 = float(info.chi2)
    return dict(
        config="2_m3500_g2o",
        wall_s=wall,
        iters=int(info.iterations),
        chi2=chi2,
        baseline_wall_s=base["wall_s"],
        baseline_chi2=base["chi2"],
        parity=chi2 <= base["chi2"] * 1.01,
        speedup=base["wall_s"] / wall,
    )


def config_3():
    """sphere2500 SE(3) — the headline (same path as bench.py)."""
    import jax

    from pyslam_standin import solve_pose_graph_standin
    from pyslam_tpu.graph import build
    from pyslam_tpu.io import synth
    from pyslam_tpu.solver import Options
    from pyslam_tpu.solver.bcsr import build_ell_direct, solve_ell

    data = synth.se3_sphere(n_poses=2500, seed=0)
    key = "se3_sphere_2500"
    base = _cache().get(key)
    if base is None:
        _, chi2_b, _, wall_b, _ = solve_pose_graph_standin(data, max_iters=20)
        base = {"chi2": chi2_b, "wall_s": wall_b}
        _cache_put(key, base)
    g = build.pose_graph(data)
    plan = build_ell_direct(g)
    # pcg 3e-6 / 120 reaches the f64 optimum in f32 (see bench.py)
    opts = Options(method="lm", max_iters=30, min_cost_decrease=0.999)

    def run():
        s, info = solve_ell(g, opts, plan=plan, pcg_rtol=3e-6, pcg_max_iters=120)
        return info

    info, wall = _timed(run)
    chi2 = float(info.chi2)
    return dict(
        config="3_sphere2500",
        wall_s=wall,
        iters=int(info.iterations),
        chi2=chi2,
        baseline_wall_s=base["wall_s"],
        baseline_chi2=base["chi2"],
        parity=chi2 <= base["chi2"] * 1.001,
        speedup=base["wall_s"] / wall,
    )


def config_4():
    """BAL-Ladybug-class BA (49 cams / 7k pts): Schur complement path."""
    import jax

    from pyslam_standin import solve_ba_standin
    from pyslam_tpu.graph import build
    from pyslam_tpu.io import synth
    from pyslam_tpu.solver import Options, solve_schur

    data = synth.ba_synthetic(n_cams=49, n_pts=7000, seed=0)
    key = "ba_ladybug_49_7000"
    base = _cache().get(key)
    if base is None:
        chi2_b, _, wall_b, _ = solve_ba_standin(data, max_iters=15)
        base = {"chi2": chi2_b, "wall_s": wall_b}
        _cache_put(key, base)
    g = build.ba_graph(data)
    opts = Options(method="lm", max_iters=25)

    def run():
        # pcg budget 1e-4/30 keeps chi2 within 5.8e-5 of the f64 baseline
        # (gate 1e-2); tuned before the H100, not re-measured there
        s, info = solve_schur(g, opts, mode="pcg", pcg_rtol=1e-4, pcg_max_iters=30)
        return info

    info, wall = _timed(run)
    chi2 = float(info.chi2)
    return dict(
        config="4_bal_ladybug_schur",
        wall_s=wall,
        iters=int(info.iterations),
        chi2=chi2,
        baseline_wall_s=base["wall_s"],
        baseline_chi2=base["chi2"],
        parity=chi2 <= base["chi2"] * 1.01,
        speedup=base["wall_s"] / wall,
    )


def config_5():
    """Venice-mini BA through the landmark-sharded distributed Schur path
    (mesh over all visible devices — the multi-device correctness story is
    tests/test_schur_sharded.py on the 8-way CPU mesh and chip_smoke.py
    --cards 4)."""
    import jax

    from pyslam_tpu.dist import make_mesh, solve_schur_sharded
    from pyslam_tpu.graph import build
    from pyslam_tpu.io import synth
    from pyslam_tpu.solver import Options

    data = synth.ba_synthetic(n_cams=300, n_pts=60000, obs_per_pt=6, seed=0)
    g = build.ba_graph(data)
    mesh = make_mesh(axis_name="l")
    opts = Options(method="lm", max_iters=15)

    def run():
        # pcg budget 1e-4/30: chi2 gap 2.6e-5 of the converged f64
        # reference (gate 1e-3); tuned before the H100
        solved, chi2, hist = solve_schur_sharded(
            g, mesh, opts, pcg_rtol=1e-4, pcg_max_iters=30
        )
        return chi2, hist

    (chi2, hist), wall = _timed(run)
    g_gt = build.ba_graph(data, init="gt")
    chi2_gt = float(g_gt.chi2())
    # true optimality gate: chi2 within 0.1% of the
    # CONVERGED f64 dense-S direct reference (scripts/venice_mini_ref.py,
    # cached), same standard as configs 1-4 — not just below the
    # noise-floor ground-truth chi2
    ref = _cache().get("venice_mini_ref")
    ref_chi2 = ref["chi2"] if ref else None
    chi2_ok = (
        chi2 <= ref_chi2 * 1.001 if ref_chi2 is not None else chi2 <= chi2_gt
    )
    return dict(
        config="5_venice_mini_sharded",
        wall_s=wall,
        iters=len(hist) - 1,
        chi2=chi2,
        chi2_gt=chi2_gt,
        ref_chi2=ref_chi2,
        n_devices=len(mesh.devices.ravel()),
        parity=chi2_ok,
        speedup=None,
    )


def config_6():
    """BAL-Venice-FULL-scale BA (1700 cams / 1M landmarks / ~4.6M
    observations) on a single device via the component-major streamed Schur
    path (solver/schur_large.py).  Minutes of wall including generation +
    compile; run explicitly with --configs 6.  chi2 goes 250.5M -> 1.391M
    (ground-truth chi2 1.74M)."""
    import jax

    from pyslam_tpu.graph import build
    from pyslam_tpu.io import synth
    from pyslam_tpu.solver import Options
    from pyslam_tpu.solver.schur_large import (
        _linearize_stream,
        prepare_large_ba,
        solve_schur_large,
    )

    data = synth.ba_synthetic(n_cams=1700, n_pts=1000000, obs_per_pt=5, seed=0)
    g = build.ba_graph(data)
    # the observation-pattern plan (sorts, padding, device uploads) is
    # one-time per graph structure, like compilation: built inside the
    # warmup timer, reused by the timed solve (solve_schur_large plan=)
    # pcg budget: 12 its keeps chi2 within 2.3e-4 of the converged
    # optimum (gate 1e-3); tuned before the H100, not re-measured there
    common = dict(n_chunks=128, pcg_rtol=1e-4, pcg_max_iters=12)
    # WARMUP: one LM iteration absorbs jit compile; the recorded number is
    # steady-state s/it
    t0 = time.perf_counter()
    plan = prepare_large_ba(g, common["n_chunks"])
    solve_schur_large(g, Options(method="lm", max_iters=1), plan=plan, **common)
    warmup_s = time.perf_counter() - t0
    opts = Options(method="lm", max_iters=10)
    t0 = time.perf_counter()
    _, chi2, hist = solve_schur_large(g, opts, plan=plan, **common)
    wall = time.perf_counter() - t0
    iters = len(hist) - 1
    s_per_it = wall / max(iters, 1)
    lb = prepare_large_ba(build.ba_graph(data, init="gt"), 128)
    chi2_gt = float(
        _linearize_stream(
            lb.kind, lb.loss, 128, lb.C, lb.L, False, lb.trails,
            lb.poses, lb.lms, lb.obs_data, lb.ci, lb.li, lb.w_pad,
        )
    )
    # true optimality gate: chi2 within 0.1% of the recorded
    # run-to-convergence optimum (scripts/venice_full_conv.py, cached);
    # falls back to the noise-floor chi2_gt if the convergence run has not
    # been recorded yet.
    conv = _cache().get("venice_full_conv")
    conv_chi2 = conv["chi2"] if conv else None
    chi2_ok = (
        chi2 <= conv_chi2 * 1.001 if conv_chi2 is not None else chi2 <= chi2_gt
    )
    return dict(
        config="6_venice_full_1chip",
        wall_s=wall,
        warmup_s=warmup_s,
        iters=iters,
        s_per_it=s_per_it,
        chi2=chi2,
        chi2_gt=chi2_gt,
        conv_chi2=conv_chi2,
        parity=chi2_ok,
        speedup=None,
    )


def config_7():
    """Sim(3) scale-drift pose graph (beyond-reference; monocular loop
    closure).  Baseline: the independent scipy GN harness (tests/scipy_ref
    — logm/expm + finite differences + spsolve), the only other solver in
    this environment that speaks Sim(3)."""
    import jax.numpy as jnp

    from pyslam_tpu.graph import build
    from pyslam_tpu.io import synth
    from pyslam_tpu.solver import Options, solve

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))
    import scipy_ref

    data = synth.sim3_loop(
        n_poses=400, n_loops=10, scale_drift=0.005, odo_scale_std=0.005, seed=0
    )
    key = "sim3_loop_400"
    base = _cache().get(key)
    if base is None:
        t0 = time.perf_counter()
        _, chi2_b, _ = scipy_ref.solve_pose_graph(data, max_iters=60)
        base = {"chi2": float(chi2_b), "wall_s": time.perf_counter() - t0,
                "label": "scipy-ref GN (logm/expm + FD jacobians + spsolve)"}
        _cache_put(key, base)
    g = build.sim3_pose_graph(data)
    opts = Options(method="lm", max_iters=50)

    def run():
        s2, info = solve(g, opts)
        return info

    info, wall = _timed(run)
    return dict(
        config="7_sim3_scale_drift_400",
        wall_s=wall,
        iters=int(info.iterations),
        chi2=float(info.chi2),
        baseline_wall_s=base["wall_s"],
        baseline_chi2=base["chi2"],
        parity=float(info.chi2) <= base["chi2"] * 1.01,
        speedup=base["wall_s"] / wall,
    )


def config_8():
    """2D landmark SLAM (Victoria-Park model family, beyond-reference):
    SE(2) trajectory + 2-dof landmarks + bearing-range observations through
    the dof-generic Schur path.  Baseline: the independent scipy GN
    (tests/scipy_ref.solve_landmark_slam_2d — FD Jacobians over the full
    pose+landmark sparse system via spsolve, the reference's architecture
    for this problem class)."""
    import jax.numpy as jnp

    from pyslam_tpu.graph import build
    from pyslam_tpu.io import synth
    from pyslam_tpu.solver import Options, solve_auto

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))
    import scipy_ref

    # odo_rot_std 0.005: the largest drift from which BOTH solvers converge
    # to the ML basin from the raw odometry init (at the generator default
    # 0.01 the 800-pose drift is outside every solver's basin — this bench
    # measures throughput at chi2 parity, not basin escape)
    data = synth.landmark_slam_2d(
        n_poses=800, n_landmarks=250, max_range=10.0, obs_type="bearing_range",
        odo_rot_std=0.005, seed=0
    )
    key = "landmark_slam_800_v2"
    base = _cache().get(key)
    if base is None:
        t0 = time.perf_counter()
        _, _, chi2_b, _ = scipy_ref.solve_landmark_slam_2d(data, max_iters=25)
        base = {"chi2": float(chi2_b), "wall_s": time.perf_counter() - t0,
                "label": "scipy-ref GN (FD jacobians + spsolve, full system)"}
        _cache_put(key, base)
    g = build.landmark_slam_2d(data)
    opts = Options(method="lm", max_iters=30)

    def run():
        s2, info = solve_auto(g, opts)
        return info

    info, wall = _timed(run)
    return dict(
        config="8_landmark_slam_2d_800",
        wall_s=wall,
        iters=int(info.iterations),
        chi2=float(info.chi2),
        baseline_wall_s=base["wall_s"],
        baseline_chi2=base["chi2"],
        parity=float(info.chi2) <= base["chi2"] * 1.01,
        speedup=base["wall_s"] / wall,
    )


CONFIGS = {1: config_1, 2: config_2, 3: config_3, 4: config_4, 5: config_5,
           6: config_6, 7: config_7, 8: config_8}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--out", default=os.path.join(os.path.dirname(os.path.abspath(__file__)), "results.jsonl"))
    args = ap.parse_args()

    from device import device_fields, require_gpu
    from pyslam_tpu.utils import enable_compile_cache

    enable_compile_cache()
    require_gpu()
    labels = device_fields()

    for cid in [int(x) for x in args.configs.split(",")]:
        rec = CONFIGS[cid]()
        rec["it_per_s"] = rec["iters"] / rec["wall_s"] if rec["wall_s"] else None
        rec.update(labels)
        line = json.dumps(rec)
        print(line, flush=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
