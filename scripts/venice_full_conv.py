"""One-time run-to-convergence of the Venice-full config.

Solves the config-6 problem (1700 cams / 1M landmarks / ~4.65M obs) with a
generous LM budget and a tight CG tolerance, records the converged chi2 and
the gradient inf-norm at the solution, appends a
"6_venice_full_convergence" row to bench/results.jsonl, and caches the
converged chi2 in bench/standin_cache.json under "venice_full_conv" —
bench/run.py config_6 gates its (short, speed-measuring) run's chi2 within
0.1% of this converged optimum, the same standard as every other config.

Run on the GPU:
    python scripts/venice_full_conv.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from pyslam_tpu.graph import build
from pyslam_tpu.io import synth
from pyslam_tpu.solver import Options
from pyslam_tpu.solver.schur_large import (
    _linearize_stream,
    prepare_large_ba,
    solve_schur_large,
)
from pyslam_tpu.utils import enable_compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "bench", "standin_cache.json")


def main():
    enable_compile_cache()
    data = synth.ba_synthetic(n_cams=1700, n_pts=1000000, obs_per_pt=5, seed=0)
    g = build.ba_graph(data)
    plan = prepare_large_ba(g, 128)
    # warmup iteration absorbs compile
    common = dict(n_chunks=128, pcg_rtol=1e-6, pcg_max_iters=100, plan=plan)
    solve_schur_large(g, Options(method="lm", max_iters=1), **common)
    t0 = time.perf_counter()
    solved, chi2, hist = solve_schur_large(
        g,
        Options(method="lm", max_iters=25, min_cost_decrease=1.0 - 1e-7),
        **common,
    )
    wall = time.perf_counter() - t0
    iters = len(hist) - 1
    # gradient inf-norm at the solution (one extra linearize) — includes
    # the unary/pose-pose contributions (gauge prior) the observation
    # stream omits (ADVICE r5)
    from pyslam_tpu.solver.schur_large import _unary_contrib

    lb = prepare_large_ba(solved, 128)
    out = _linearize_stream(
        lb.kind, lb.loss, 128, lb.C, lb.L, True, lb.trails,
        lb.poses, lb.lms, lb.obs_data, lb.ci, lb.li, lb.w_pad,
        lb.cam_starts, lb.lorder, lb.lm_starts,
    )
    g_p = out[2]
    if lb.unary:
        _, _, g_u, _ = _unary_contrib(lb.unary, lb.poses, lb.C, True)
        g_p = g_p + g_u
    g_inf = float(
        max(float(jnp.abs(g_p).max()), float(jnp.abs(out[4]).max()))
    )
    row = dict(
        config="6_venice_full_convergence",
        wall_s=round(wall, 2),
        iters=iters,
        chi2=float(chi2),
        grad_inf_norm=g_inf,
        pcg=("1e-6/100"),
        hist_tail=[float(h) for h in hist[-4:]],
        device=__import__("jax").default_backend(),
    )
    print(json.dumps(row), flush=True)
    with open(os.path.join(ROOT, "bench", "results.jsonl"), "a") as f:
        f.write(json.dumps(row) + "\n")
    with open(CACHE) as f:
        c = json.load(f)
    c["venice_full_conv"] = {
        "chi2": float(chi2),
        "iters": iters,
        "grad_inf_norm": g_inf,
        "label": "LM to convergence, pcg 1e-6/100 (scripts/venice_full_conv.py)",
    }
    with open(CACHE, "w") as f:
        json.dump(c, f)
    print("cached under venice_full_conv")


if __name__ == "__main__":
    main()
