"""Headline benchmark: sphere2500-class SE(3) pose graph (BASELINE.json:2,5).

Measures time-to-reference-chi2 of the device solver (block-sparse ELL +
PCG, fully jitted LM) against the pySLAM-CPU architectural stand-in
(bench/pyslam_standin.py — per-block Python loop + scipy bmat/spsolve; the
reference mount is empty, see SURVEY.md §0/§6, so the stand-in is the
measured baseline and is labeled as such).

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N}
where value is the wall-clock speedup (x) over the CPU stand-in for solving
to the same converged chi2 (parity enforced within 0.1%), plus the device
labels of bench/device.py.  Exits non-zero without a GPU unless
JAX_PLATFORMS=cpu is set.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench"))

BASELINE_CACHE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "bench", "baseline_cache.json"
)


def measure_baseline(data, force=False):
    """pySLAM-CPU stand-in wall clock + converged chi2 (cached on disk)."""
    if not force and os.path.exists(BASELINE_CACHE):
        with open(BASELINE_CACHE) as f:
            return json.load(f)
    from pyslam_standin import solve_pose_graph_standin

    _, chi2, iters, wall, per_iter = solve_pose_graph_standin(data, max_iters=20)
    result = {
        "chi2": chi2,
        "wall_s": wall,
        "iters": iters,
        "per_iter_s": per_iter,
        "label": "pyslam-cpu-standin (per-block python + scipy spsolve, f64)",
    }
    with open(BASELINE_CACHE, "w") as f:
        json.dump(result, f)
    return result


def main():
    import jax

    from device import device_fields, require_gpu
    from pyslam_tpu.utils import enable_compile_cache

    enable_compile_cache()
    require_gpu()

    from pyslam_tpu.graph import build
    from pyslam_tpu.io import synth
    from pyslam_tpu.solver import Options
    from pyslam_tpu.solver.bcsr import build_ell_direct, solve_ell

    data = synth.se3_sphere(n_poses=2500, seed=0)
    baseline = measure_baseline(data)  # CPU scipy, cached on disk

    g = build.pose_graph(data)  # f32, the device production path
    plan = build_ell_direct(g)
    opts = Options(method="lm", max_iters=30, min_cost_decrease=0.999)

    def run():
        # direct-to-ELL assembly, slice-damping, closed-form block-Jacobi,
        # inexact-Newton PCG.  rtol 3e-6 / 120 its reaches the f64 optimum
        # (7310.78) in f32; looser CG stops short of it.
        s, info = solve_ell(g, opts, plan=plan, pcg_rtol=3e-6, pcg_max_iters=120)
        # the whole LM solve is one program: waiting for its outputs waits
        # for all of its device work
        jax.block_until_ready((s, info))
        return s, info

    run()  # compile
    t0 = time.perf_counter()
    s, info = run()
    wall = time.perf_counter() - t0

    chi2 = float(info.chi2)
    iters = int(info.iterations)
    # 0.1% gate: the f32 solve reaches the f64 optimum, so the gate needs
    # no slack for CG truncation
    parity = chi2 <= baseline["chi2"] * 1.001
    speedup = baseline["wall_s"] / wall if parity else 0.0

    print(
        json.dumps(
            {
                "metric": "sphere2500_time_to_chi2_speedup_vs_pyslam_cpu_standin",
                "value": round(speedup, 2),
                "unit": "x",
                "vs_baseline": round(speedup, 2),
                **device_fields(),
            }
        )
    )
    # diagnostics on stderr (the driver reads the single stdout line)
    print(
        f"{jax.default_backend()}: {wall*1000:.0f}ms / {iters} LM iters ({iters/wall:.1f} it/s), "
        f"chi2 {chi2:.2f} | baseline[{baseline['label']}]: {baseline['wall_s']:.1f}s, "
        f"chi2 {baseline['chi2']:.2f} | parity: {parity}",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
